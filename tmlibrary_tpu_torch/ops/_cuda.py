"""Build and load the port's CUDA kernels.

The sources in ``tmlibrary_tpu_torch/csrc/*.cu`` have a plain C interface
(no PyTorch headers), so each compiles in seconds.  At first use each
source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with ``-O3`` and without ``--use_fast_math`` (fast math
would let divisions and FMA contraction move a watershed band edge).
The objects are linked into one shared library under ``build/kernels/``
at the root of the checkout, named by a digest of the sources, and
loaded with ``ctypes``.  Nothing here runs at import time.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches;
:func:`check` raises :class:`DeviceError` on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from tmlibrary_tpu_torch.errors import DeviceError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "tm_fill_holes": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tm_cc_min_propagate": [_P, _P, _I, _I, _I, _I, _P],
    "tm_watershed_flood": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tm_grouped_stats": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # labels, img, raw_lo, raw_hi, out, B, H, W, M, bins, window, windows, flat, stream
    "tm_intensity_hist": [*[_P] * 5, *[_I] * 8, _P],
    # ..., out, B, H, W, M, L, D, 8 offsets, window, windows, flat, stream
    "tm_glcm_all": [*[_P] * 5, *[_I] * 17, _P],
    # the first designs, for the A/B harness: ..., phases (1 memset, 2 kernel), stream
    "tm_intensity_hist_atomic": [_P, _P, _P, _P, _P, *[_I] * 6, _P],
    "tm_glcm_all_atomic": [_P, _P, _P, _P, _P, *[_I] * 15, _P],
    "tm_distance_transform": [_P, _P, _I, _I, _I, _I, _P],
    "tm_cc3d_min_propagate": [_P, _P, _I, _I, _I, _I, _I, _P],
    "tm_watershed3d_flood": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_LIB: "ctypes.CDLL | None" = None
#: seconds the last build took (0.0 when the library was already built)
last_build_seconds = 0.0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(sources + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise DeviceError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> Path:
    """Compile the kernels (if the digest-named library is missing) and
    return the library path."""
    global last_build_seconds
    sources = _sources()
    lib_path = BUILD_DIR / f"libtmtorch_{_digest(sources)}.so"
    if lib_path.exists():
        last_build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    failures = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
    if failures:
        raise DeviceError("nvcc failed\n" + "\n".join(failures))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise DeviceError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = loaded
    return _LIB


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise DeviceError(f"{name}: CUDA error {code} at launch")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device/contiguity checks before handing pointers to a kernel."""
    for t in tensors:
        if t.device.type != "cuda":
            raise DeviceError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise DeviceError(f"{name}: expected contiguous tensors")
