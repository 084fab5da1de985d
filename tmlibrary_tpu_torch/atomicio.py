"""Crash-consistent file writes: write a sibling temp file, then rename.

Counterpart: ``tmlibrary_tpu/atomicio.py``.  POSIX ``rename(2)`` within
a directory is atomic, so a reader sees the old complete file or the new
one, and a kill mid-write leaves the old one intact.  The temp name
holds the writer's PID, so two processes writing one path never share a
temp file.
"""

from __future__ import annotations

import os
from pathlib import Path


def atomic_write_text(path: Path | str, text: str, fsync: bool = False) -> None:
    """Write ``text`` to ``path`` atomically (temp file + rename); with
    ``fsync`` the payload reaches stable storage before the rename."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
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

