"""Host C++ of the port: the convex-hull pixel counts behind
``Morphology_solidity``.

Counterpart: ``tmlibrary_tpu/native.py`` ``hull_pixel_counts_host`` and
``solidity_host`` (``:323-392``), backed there by ``tm_hull_pixel_counts``
in ``native/tmnative.cpp``.  Hulls are ragged per object, so, as in the
JAX package, solidity is measured on the host from the exported label
images and joined into the morphology features when a batch persists.

The port keeps its own copy of the C++ (``csrc/host/hull.cpp``).  At
first use it is compiled with the host compiler (``c++``/``g++`` on the
``PATH``, else ``nvcc``) into ``build/host/`` at the root of the
checkout, named by a digest of the source and flags, and bound with
``ctypes``.  One call takes a batch of sites and counts each object's
hull pixels and its pixels (:func:`hull_and_area_counts`); the step
calls :func:`solidity_batch` once per family and batch.  A failed build
raises :class:`BuildError`; nothing falls back to
:func:`hull_pixel_counts_numpy`, the plain version that the tests hold
the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from tmlibrary_tpu_torch.errors import BuildError

HOST_SRC = Path(__file__).resolve().parent / "csrc" / "host" / "hull.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"
FLAGS = ("-O3", "-std=c++17", "-shared")

_LIB: "ctypes.CDLL | None" = None
_LOCK = threading.Lock()


def _compiler() -> list[str]:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return [found, *FLAGS, "-fPIC"]
    from tmlibrary_tpu_torch.ops._cuda import _nvcc
    from tmlibrary_tpu_torch.errors import DeviceError

    try:
        return [_nvcc(), *FLAGS, "-Xcompiler", "-fPIC"]
    except DeviceError as e:
        raise BuildError(f"no host compiler for {HOST_SRC.name}: {e}") from None


def build() -> Path:
    """Compile ``hull.cpp`` (if its digest-named library is missing) and
    return the library path."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + HOST_SRC.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libtmhost_{digest}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*_compiler(), "-o", str(tmp), str(HOST_SRC)]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)} failed:\n{done.stdout}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded host library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                loaded = ctypes.CDLL(str(build()))
            except OSError as e:
                raise BuildError(f"host library failed to load: {e}") from None
            fn = loaded.tm_hull_pixel_counts_batch
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_void_p, *[ctypes.c_int32] * 4, ctypes.c_void_p,
                           ctypes.c_void_p]
            _LIB = loaded
        return _LIB


def hull_and_area_counts(stack: np.ndarray, max_label: int) -> tuple[np.ndarray, np.ndarray]:
    """``(hull, area)``, each ``(B, max_label)`` int32, of a ``(B, H, W)``
    stack of sites in one call (the library works without the
    interpreter's lock): ``hull[b, l - 1]`` counts the pixel centres
    inside or on the convex hull of object ``l``'s pixel centres in site
    ``b`` (its own pixel count when it has one or two pixels or is
    collinear), ``area[b, l - 1]`` its pixels; 0 when absent; ids outside
    ``[1, max_label]`` are skipped."""
    stack = np.ascontiguousarray(stack, np.int32)
    if stack.ndim != 3:
        raise ValueError(f"hull_and_area_counts: expected (B, H, W) sites, got {stack.shape}")
    b, h, w = stack.shape
    hull = np.zeros((b, max(int(max_label), 0)), np.int32)
    area = np.zeros_like(hull)
    if max_label <= 0 or stack.size == 0:
        return hull, area
    rc = lib().tm_hull_pixel_counts_batch(stack.ctypes.data, b, h, w, int(max_label),
                                          hull.ctypes.data, area.ctypes.data)
    if rc < 0:
        raise ValueError("tm_hull_pixel_counts_batch: invalid arguments")
    return hull, area


def hull_pixel_counts(labels: np.ndarray, max_label: int) -> np.ndarray:
    """``(max_label,)`` int32 hull counts of one ``(H, W)`` site (the
    reference's ``hull_pixel_counts_host``)."""
    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError(f"hull_pixel_counts: expected an (H, W) site, got {labels.shape}")
    return hull_and_area_counts(labels[None], max_label)[0][0]


def _monotone_chain(points: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Andrew's monotone chain over (x, y) points sorted by (x, y): the
    counter-clockwise hull vertices, collinear points popped."""

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in points:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in reversed(points):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return lower[:-1] + upper[:-1]


def hull_pixel_counts_numpy(labels: np.ndarray, max_label: int) -> np.ndarray:
    """The plain version of :func:`hull_pixel_counts`: pixels grouped by
    label with one stable ``argsort``; each object's hull is the chain
    over the first and last pixel of each of its rows (the hull of those
    is the hull of all its pixels), rasterised over its bounding box."""
    labels = np.asarray(labels)
    out = np.zeros(int(max_label), np.int32)
    if max_label <= 0 or labels.size == 0:
        return out
    w = labels.shape[1]
    flat = labels.ravel()
    idx = np.flatnonzero((flat >= 1) & (flat <= max_label))
    order = np.argsort(flat[idx], kind="stable")
    idx, lab = idx[order], flat[idx][order]
    bounds = np.searchsorted(lab, np.arange(1, max_label + 2))
    ys, xs = idx // w, idx % w
    for l in np.unique(lab).tolist():
        s, e = bounds[l - 1], bounds[l]
        n = int(e - s)
        if n <= 2:
            out[l - 1] = n
            continue
        y, x = ys[s:e], xs[s:e]  # row-major: rows ascending, x ascending within a row
        first = np.r_[True, y[1:] != y[:-1]]
        last = np.r_[y[1:] != y[:-1], True]
        ends = first | last
        hull = _monotone_chain(sorted(zip(x[ends].tolist(), y[ends].tolist())))
        if len(hull) <= 2:
            out[l - 1] = n
            continue
        gy, gx = np.mgrid[y.min():y.max() + 1, x.min():x.max() + 1]
        inside = np.ones(gy.shape, bool)
        for i in range(len(hull)):
            (x0, y0), (x1, y1) = hull[i], hull[(i + 1) % len(hull)]
            inside &= (x1 - x0) * (gy - y0) - (y1 - y0) * (gx - x0) >= 0
        out[l - 1] = int(inside.sum())
    return out


def _ratio(areas, hull: np.ndarray) -> np.ndarray:
    """Area over hull count in float64, cast to float32; 0 where the hull
    is empty (``solidity_host``'s expression)."""
    areas = np.asarray(areas, np.float64)
    hull = hull.astype(np.float64)
    return np.where(hull > 0, areas / np.maximum(hull, 1.0), 0.0).astype(np.float32)


def solidity(labels: np.ndarray, max_label: int, areas: "np.ndarray | None" = None
             ) -> np.ndarray:
    """Per-object solidity of one ``(H, W)`` site, area over hull pixel
    count, as ``(max_label,)`` float32: the ratio taken in float64, absent
    labels 0, ids outside ``[1, max_label]`` dropped from both counts.
    ``areas`` (pixel counts of ids ``1..max_label``) replaces the
    library's own count when given."""
    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError(f"solidity: expected an (H, W) site, got {labels.shape}")
    hull, own = hull_and_area_counts(labels[None], max_label)
    return _ratio(own[0] if areas is None else areas, hull[0])


def solidity_batch(stack: np.ndarray, max_label: int) -> np.ndarray:
    """:func:`solidity` of every site of a ``(B, H, W)`` stack, as
    ``(B, max_label)`` float32, in one library call."""
    return _ratio(*hull_and_area_counts(stack, max_label)[::-1])
