"""Build and load the port's CUDA kernels.

The sources in ``tmlibrary_tpu_torch/csrc/*.cu`` have a plain C interface
(no PyTorch headers), so each compiles in seconds.  At first use each
source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with ``-O3`` and without ``--use_fast_math`` (fast math
would let divisions and FMA contraction move a watershed band edge).
The objects are linked into one shared library under ``build/kernels/``
at the root of the checkout, named by a digest of the sources, and
loaded with ``ctypes``.  Before ``nvcc`` runs, the kernel-library store
(:mod:`tmlibrary_tpu_torch.aotstore`) is asked for a library of the
same digest for the same torch, CUDA runtime and arch; a
library ``nvcc`` built is exported there.  The first load in a process
is recorded as the program ``cuda_kernels`` in the perf store
(:func:`tmlibrary_tpu_torch.perf.record_compile`).  Nothing here runs at
import time.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches;
:func:`check` raises :class:`DeviceError` on a non-zero code.  A bound
launch adds one to its wrapper's ``.launches`` and to the telemetry
registry's ``tmx_kernel_launches_total{kernel}``, so the snapshot a
process writes (a serve daemon's ``metrics.json``) carries its counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from tmlibrary_tpu_torch import aotstore, perf, telemetry
from tmlibrary_tpu_torch.errors import DeviceError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
#: C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    # mask, out, B, H, W, connectivity, stream
    "tm_fill_holes": [_P, _P, _I, _I, _I, _I, _P],
    # mask, reach, out, B, H, W, connectivity, stream
    "tm_fill_holes_global": [_P, _P, _P, *[_I] * 4, _P],
    # mask, labels, B, H, W, connectivity, phases (1 local, 2 border, 4 flatten), stream
    "tm_cc_min_propagate": [_P, _P, *[_I] * 5, _P],
    # the first design, for the A/B harness: mask, sweeps, labels, B, H, W,
    # connectivity, stream
    "tm_cc_min_propagate_original": [_P, _P, _P, *[_I] * 4, _P],
    # intensity, seeds, mask, scratch, site_route, out, B, H, W, n_levels,
    # connectivity, (on chip) the list capacity, stream
    "tm_watershed_flood": [*[_P] * 6, *[_I] * 6, _P],
    "tm_watershed_flood_global": [*[_P] * 6, *[_I] * 5, _P],
    # labels, box, sums, mins, maxs, channel pointers and site strides (host
    # arrays), B, Z, H, W, C, K, bands, stream
    "tm_grouped_stats": [*[_P] * 7, *[_I] * 7, _P],
    # the first design, for the A/B harness: ..., B, H, W, C, K, phases, stream
    "tm_grouped_stats_original": [*[_P] * 5, *[_I] * 6, _P],
    # labels, img, raw_lo, raw_hi, out, B, H, W, M, bins, window, windows, flat, stream
    "tm_intensity_hist": [*[_P] * 5, *[_I] * 8, _P],
    # ..., out, B, H, W, M, L, D, 8 offsets, window, windows, flat, stream
    "tm_glcm_all": [*[_P] * 5, *[_I] * 17, _P],
    # the first designs, for the A/B harness: ..., phases (1 memset, 2 kernel), stream
    "tm_intensity_hist_atomic": [_P, _P, _P, _P, _P, *[_I] * 6, _P],
    "tm_glcm_all_atomic": [_P, _P, _P, _P, _P, *[_I] * 15, _P],
    # mask, g, out, B, H, W, cap, reach, phases (1 columns, 2 rows), stream
    "tm_distance_transform": [_P, _P, _P, *[_I] * 6, _P],
    # the first design, for the A/B harness: mask, sweeps, out, B, H, W,
    # max_distance, stream
    "tm_distance_transform_original": [_P, _P, _P, *[_I] * 4, _P],
    # mask, labels, B, Z, H, W, connectivity, phases, stream
    "tm_cc3d_min_propagate": [_P, _P, *[_I] * 6, _P],
    # the first design: mask, sweeps, labels, B, Z, H, W, connectivity, stream
    "tm_cc3d_min_propagate_original": [_P, _P, _P, *[_I] * 5, _P],
    # intensity, seeds, mask, band, lists, misc, out, B, Z, H, W, n_levels, stream
    "tm_watershed3d_flood": [*[_P] * 7, *[_I] * 5, _P],
    # intensity, seeds, mask, scratch, out, B, Z, H, W, n_levels, stream
    "tm_watershed3d_flood_global": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, feature, threshold, left, right, missing_left, value, roots, proba,
    # pred, N, F, C, T, write_proba, stream
    "tm_forest_predict": [*[_P] * 10, *[_I] * 5, _P],
    # K, rows, y, offsets, grad, rho, steps, alpha, n, pairs, C, eps,
    # max_iter, stream
    "tm_svm_smo": [*[_P] * 8, _I, _I, _D, _D, _L, _P],
}

_LIB: "ctypes.CDLL | None" = None
#: seconds the last build took (0.0 when the library was already built or
#: was imported from the store)
last_build_seconds = 0.0
#: builds that ran ``nvcc`` in this process
nvcc_builds = 0


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
    """The library path: the digest-named library in :data:`BUILD_DIR`,
    else the one the kernel-library store holds for these sources
    (:func:`aotstore.import_entry`), else compiled with ``nvcc`` and
    exported to the store."""
    global last_build_seconds, nvcc_builds
    sources = _sources()
    digest = _digest(sources)
    lib_path = BUILD_DIR / f"libtmtorch_{digest}.so"
    last_build_seconds = 0.0
    if lib_path.exists() or aotstore.import_entry(
            lib_path, program="cuda_kernels", signature=digest) is not None:
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
    nvcc_builds += 1
    aotstore.export_entry(lib_path, program="cuda_kernels", signature=digest,
                            compile_s=last_build_seconds)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        t0 = time.perf_counter()
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = loaded
        aotstore.note_cold("cuda_kernels")  # the first build or load in this process
        perf.record_compile(program="cuda_kernels", step=None, backend="cuda",
                            compile_s=time.perf_counter() - t0)
    return _LIB


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise DeviceError(f"{name}: CUDA error {code} at launch")


def require_cuda(name: str, *tensors: torch.Tensor, contiguous: bool = True) -> None:
    """Device (and, with ``contiguous``, contiguity) checks before handing
    pointers to a kernel."""
    for t in tensors:
        if t.device.type != "cuda":
            raise DeviceError(f"{name}: expected CUDA tensors, got {t.device}")
        if contiguous and not t.is_contiguous():
            raise DeviceError(f"{name}: expected contiguous tensors")


#: guards the launch counters: the workflow step launches on its engine
#: thread and re-launches an escalated batch on its persist worker
_COUNT_LOCK = threading.Lock()


def bind_launch(name: str, counter, tensors: tuple, *scalars, route: "str | None" = None,
                held: tuple = ()):
    """``launch()``: one call of the C entry point ``tm_<name>`` on the
    pointers of ``tensors`` (the inputs, then the output), the scalars and
    the current stream, adding one to ``counter.launches`` (and, with a
    ``route``, to ``counter.routes[route]``) unless ``counter`` is None; it
    returns the output.  The closure holds ``tensors`` and ``held`` (the
    tensors whose pointers go in a scalar, a host table of pointers), so
    the memory behind every pointer it passes stays theirs for as long as
    ``launch`` lives, whatever the caller keeps."""
    require_cuda(name, *tensors)
    fn = getattr(lib(), f"tm_{name}")
    args = (*(t.data_ptr() for t in tensors), *scalars, stream())
    def launch() -> torch.Tensor:
        if counter is not None:
            with _COUNT_LOCK:
                counter.launches += 1
                if route is not None:
                    counter.routes[route] += 1
            # the same count in the telemetry registry, so a process's
            # snapshot (a serve daemon's metrics.json) reports it
            telemetry.get_registry().counter("tmx_kernel_launches_total",
                                             kernel=counter.__name__).inc()
            perf.note_kernel_launch(counter.__name__, tensors)  # a counted call's bytes
        check(f"tm_{name}", fn(*args))
        return tensors[-1]

    launch.held = tuple(held)
    return launch
