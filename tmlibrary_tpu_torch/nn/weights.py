"""Named U-Net checkpoints: ``.npz`` parameter dicts and content digests.

Counterpart: ``tmlibrary_tpu/nn/weights.py`` (no JAX import there; the
port keeps its own copy).  Checkpoints are flat ``np.savez`` archives
written atomically, and every resolve returns a **content digest**
beside the parameters: sha1 over the sorted names, shapes, dtypes and
raw bytes, 12 hex characters.  The same ``.npz`` gives the same digest
in both packages, so a checkpoint keeps its identity across them.  The
digest joins the pipeline identity
(:func:`tmlibrary_tpu_torch.jterator.pipeline.weight_digests`) and keys
the resident nets of :func:`tmlibrary_tpu_torch.nn.unet.unet_for`.

Weight specs
------------
``seed:<int>[:base=<C>][:depth=<D>][:in=<N>]``
    Deterministic He-normal weights (:func:`~.unet.init_unet_params`),
    byte-identical to the reference's; no file.
``<name>``
    ``<name>.npz`` in the weights directory (``TMX_WEIGHTS_DIR``, else
    ``~/.cache/tmlibrary_tpu/weights``, the reference's directory).
``<path ending in .npz>`` (or containing a path separator)
    That file.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import threading
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import StoreError

#: reserved npz key carrying the JSON-encoded metadata
_META_KEY = "__meta__"

_SEED_SPEC = re.compile(r"^seed:(?P<seed>\d+)(?P<opts>(?::[a-z]+=\d+)*)$")

#: spec -> (file identity, params, digest, config); a file-backed entry
#: keys on (mtime_ns, size), so an overwritten checkpoint re-resolves
_RESOLVE_CACHE: dict = {}
_RESOLVE_LOCK = threading.Lock()
_RESOLVE_CACHE_MAX = 8


def weights_dir() -> Path:
    """The named-checkpoint directory (created on access)."""
    root = os.environ.get("TMX_WEIGHTS_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "tmlibrary_tpu", "weights")
    path = Path(root)
    path.mkdir(parents=True, exist_ok=True)
    return path


def params_digest(params: dict) -> str:
    """Content digest of a parameter dict (12 hex characters)."""
    h = hashlib.sha1()
    for name in sorted(params):
        arr = np.ascontiguousarray(np.asarray(params[name]))
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:12]


def save_weights(name: str, params: dict, meta: dict | None = None,
                 directory: "Path | str | None" = None) -> Path:
    """Write a checkpoint atomically and return its ``.npz`` path; ``meta``
    is embedded as a JSON-encoded ``__meta__`` entry."""
    path = _spec_path(name, directory)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {k: np.asarray(v) for k, v in params.items()}
    if meta:
        payload[_META_KEY] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    tmp = path.with_name(path.name + ".tmp")
    try:
        tmp.write_bytes(buf.getvalue())
        tmp.replace(path)
    except OSError as e:
        tmp.unlink(missing_ok=True)
        raise StoreError(f"cannot write weights '{name}': {e}") from e
    return path


def load_weights(name: str, directory: "Path | str | None" = None) -> tuple[dict, dict]:
    """Load a checkpoint; returns ``(params, meta)``."""
    path = _spec_path(name, directory)
    if not path.exists():
        raise StoreError(f"no such weights checkpoint: {path}")
    try:
        with np.load(path) as npz:
            params = {k: npz[k] for k in npz.files if k != _META_KEY}
            meta = {}
            if _META_KEY in npz.files:
                meta = json.loads(bytes(npz[_META_KEY].tobytes()).decode())
    except (OSError, ValueError) as e:
        raise StoreError(f"cannot read weights '{name}': {e}") from e
    return params, meta


def list_weights(directory: "Path | str | None" = None) -> list[dict]:
    """One row per checkpoint of the weights directory: name, path,
    array and parameter counts, content digest and metadata."""
    root = Path(directory) if directory else weights_dir()
    rows = []
    for path in sorted(root.glob("*.npz")):
        params, meta = load_weights(path.stem, root)
        rows.append({
            "name": path.stem,
            "path": str(path),
            "n_arrays": len(params),
            "n_params": int(sum(np.asarray(v).size for v in params.values())),
            "digest": params_digest(params),
            "meta": meta,
        })
    return rows


def resolve_weights(spec: str):
    """Resolve a weight spec to ``(params, digest, config)``, memoized per
    process (a file-backed entry re-resolves when the file's mtime or
    size changes)."""
    from tmlibrary_tpu_torch.nn import unet

    spec = str(spec).strip()
    if not spec:
        raise StoreError("empty weights spec")
    m = _SEED_SPEC.match(spec)
    path = None if m else _spec_path(spec, None)
    ident = None
    if path is not None:
        try:
            st = path.stat()
            ident = (st.st_mtime_ns, st.st_size)
        except OSError as e:
            raise StoreError(f"no such weights checkpoint: {path}") from e
    with _RESOLVE_LOCK:
        hit = _RESOLVE_CACHE.get(spec)
        if hit is not None and hit[0] == ident:
            return hit[1], hit[2], hit[3]
    if m:
        opts = dict(kv.split("=") for kv in m.group("opts").split(":") if kv)
        config = unet.UNetConfig(
            in_channels=int(opts.get("in", 1)),
            base_channels=int(opts.get("base", 8)),
            depth=int(opts.get("depth", 2)),
        )
        params = unet.init_unet_params(int(m.group("seed")), config)
    else:
        params, _meta = load_weights(spec)
        config = unet.infer_config(params)
    digest = params_digest(params)
    with _RESOLVE_LOCK:
        while len(_RESOLVE_CACHE) >= _RESOLVE_CACHE_MAX:
            _RESOLVE_CACHE.pop(next(iter(_RESOLVE_CACHE)))
        _RESOLVE_CACHE[spec] = (ident, params, digest, config)
    return params, digest, config


def weights_digest(spec: str) -> str:
    """The content digest a spec resolves to."""
    return resolve_weights(spec)[1]


def _spec_path(spec: str, directory: "Path | str | None") -> Path:
    if spec.endswith(".npz") or os.sep in spec:
        p = Path(spec)
        return p if p.suffix == ".npz" else p.with_suffix(".npz")
    root = Path(directory) if directory else weights_dir()
    return root / f"{spec}.npz"
