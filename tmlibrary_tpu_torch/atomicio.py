"""Crash-consistent file writes: write a sibling temp file, then rename.

Counterpart: ``tmlibrary_tpu/atomicio.py``.  POSIX ``rename(2)`` within
a directory is atomic, so a reader sees the old complete file or the new
one, and a kill mid-write leaves the old one intact.  The temp name
holds the writer's PID and thread, so two processes, or two threads of
one (the serve daemon's lease renewer and its main loop both write the
heartbeat), never share a temp file; the reference's holds the PID only,
and there one thread's rename can take the other's temp file away.  :func:`claim_rename` is the fleet spool's claim arbiter: a
same-filesystem rename that only one host can win.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any


def atomic_write_text(path: Path | str, text: str, fsync: bool = False) -> None:
    """Write ``text`` to ``path`` atomically (temp file + rename); with
    ``fsync`` the payload reaches stable storage before the rename."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        with open(tmp, "w") as f:
            f.write(text)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        # a failure between open and replace must not litter temp files
        if tmp.exists():
            tmp.unlink(missing_ok=True)



def atomic_write_json(path: Path | str, obj: Any,
                      fsync: bool = False, **dumps_kwargs: Any) -> None:
    """:func:`atomic_write_text` for a JSON payload, serialized first so
    a serialization error never leaves a partial file either."""
    atomic_write_text(path, json.dumps(obj, **dumps_kwargs), fsync=fsync)


def claim_rename(src: Path | str, dst: Path | str) -> bool:
    """Atomically move ``src`` to ``dst``; returns whether this caller
    won the move.

    Several hosts polling one spool race to ``rename(2)`` the same file:
    exactly one rename finds the source, every loser gets ``ENOENT``,
    returned here as ``False`` so "someone else claimed it" is a
    decision, not an error.  An existing ``dst`` (a stale copy a crashed
    reaper left) is replaced atomically.
    """
    try:
        os.replace(src, dst)
        return True
    except FileNotFoundError:
        return False
