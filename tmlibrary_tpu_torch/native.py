"""Host C++ of the port: the convex-hull pixel counts behind
``Morphology_solidity``, the TIFF reader behind imextract, the spatial
layout's boundary trace and mosaic accumulators, the Douglas-Peucker
simplification behind ``export --simplify``, and the codecs of the
microscope containers: Zstandard (CZI zstd0/zstd1 subblocks), JPEG (CZI
JPEG subblocks, ``.jpg`` site files and JPEG-in-TIFF), libtiff's SGILog
codec (LogL and LogLuv TIFF pages), and HDF5's lookup3 checksum and
h5py's LZF filter (:mod:`tmlibrary_tpu_torch.io.hdf5`).

Counterpart: ``tmlibrary_tpu/native.py`` ``hull_pixel_counts_host`` and
``solidity_host`` (``:323-392``), ``tiff_info``, ``tiff_read``,
``tiff_read_page``, ``lzw_decode`` and ``packbits_decode``
(``:413-590``), ``trace_boundary_host`` (``:275``),
``mosaic_intensity_host`` and ``mosaic_morph_host`` (``:1162-1260``),
``simplify_polygon_host`` (``:627``),
backed there by ``native/tmnative.cpp``; the codecs stand in for the
``zstandard`` and ``cv2`` calls of ``tmlibrary_tpu/readers.py``
(``_czi_zstd_plane``, ``CZIReader._jpeg_plane``) and
``workflow/steps/imextract.py``, which the card's machine does not have.  Hulls are
ragged per object, so, as in the JAX package, solidity is measured on
the host from the exported label images and joined into the morphology
features when a batch persists.

The port keeps its own copy of the C++ (``csrc/host/hull.cpp``,
``csrc/host/tiff.cpp``, ``csrc/host/mosaic.cpp``,
``csrc/host/simplify.cpp``, ``csrc/host/zstd.cpp``,
``csrc/host/jpeg.cpp``, ``csrc/host/hdf5.cpp``, ``csrc/host/raster.cpp``
and ``csrc/host/luv.cpp``).  At first use they are compiled with the host
compiler (``c++``/``g++`` on the ``PATH``, else ``nvcc``) into one
library in ``build/host/`` at the root of the checkout, named by a
digest of the sources and flags (imported from the kernel-library
store, :mod:`tmlibrary_tpu_torch.aotstore`, when it holds that digest,
and exported there after a build), and bound with ``ctypes``.  One call
takes a batch of sites and counts each object's hull pixels and its
pixels (:func:`hull_and_area_counts`); the step calls
:func:`solidity_batch` once per family and batch.  The TIFF functions
return None for a file the C++ reader declines by its own header checks
(BigTIFF, deflate, tiles, colour), where the JAX package goes on to its
Python reader too.  The codec functions raise
:class:`~tmlibrary_tpu_torch.errors.MetadataError` on a stream they
cannot decode, with the reason.  A failed build raises :class:`BuildError`; nothing
falls back to :func:`hull_pixel_counts_numpy`, :func:`_lzw_decode_py`,
:func:`_packbits_decode_py` or :func:`simplify_keep_numpy`, the plain versions that the tests hold the
library against.
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

import numpy as np

from tmlibrary_tpu_torch.errors import BuildError

HOST_SRC = Path(__file__).resolve().parent / "csrc" / "host" / "hull.cpp"
TIFF_SRC = HOST_SRC.with_name("tiff.cpp")
MOSAIC_SRC = HOST_SRC.with_name("mosaic.cpp")
SIMPLIFY_SRC = HOST_SRC.with_name("simplify.cpp")
ZSTD_SRC = HOST_SRC.with_name("zstd.cpp")
JPEG_SRC = HOST_SRC.with_name("jpeg.cpp")
HDF5_SRC = HOST_SRC.with_name("hdf5.cpp")
RASTER_SRC = HOST_SRC.with_name("raster.cpp")
LUV_SRC = HOST_SRC.with_name("luv.cpp")
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


def _sources() -> tuple[Path, ...]:
    return (HOST_SRC, TIFF_SRC, MOSAIC_SRC, SIMPLIFY_SRC, ZSTD_SRC, JPEG_SRC, HDF5_SRC,
            RASTER_SRC, LUV_SRC)


def source_digest() -> str:
    """The digest that names the library: its flags and sources."""
    return hashlib.sha256(
        " ".join(FLAGS).encode() + b"".join(src.read_bytes() for src in _sources())
    ).hexdigest()[:16]


def build() -> Path:
    """Compile ``hull.cpp``, ``tiff.cpp``, ``mosaic.cpp``, ``simplify.cpp``,
    ``zstd.cpp``, ``jpeg.cpp``, ``hdf5.cpp``, ``raster.cpp`` and ``luv.cpp``
    into one library (if its digest-named file is missing) and return the library
    path."""
    digest = source_digest()
    path = BUILD_DIR / f"libtmhost_{digest}.so"
    from tmlibrary_tpu_torch import aotstore

    if path.exists() or aotstore.import_entry(
            path, program="host_library", signature=digest) is not None:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*_compiler(), "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)} failed:\n{done.stdout}")
    os.replace(tmp, path)
    aotstore.export_entry(path, program="host_library", signature=digest,
                            compile_s=time.perf_counter() - t0)
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
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            for fname, args in (("tm_lzw_decode", [ptr, i64, ptr, i64]),
                                ("tm_packbits_decode", [ptr, i64, ptr, i64]),
                                ("tm_tiff_info", [ctypes.c_char_p, ptr]),
                                ("tm_tiff_read", [ctypes.c_char_p, i32, ptr, i32, i32]),
                                ("tm_tiff_read2", [ctypes.c_char_p, i32, ptr, i64, ptr]),
                                ("tm_trace_boundary", [ptr, i32, i32, i32, ptr, i32]),
                                ("tm_mosaic_intensity", [ptr, ptr, i64, i32, ptr, ptr, ptr,
                                                         ptr]),
                                ("tm_mosaic_morph", [ptr, i32, i32, i32, *[ptr] * 7]),
                                ("tm_simplify_polygon", [ptr, i32, ctypes.c_double, ptr]),
                                ("tm_jpeg_decode", [ptr, i64, ptr, ptr, i32]),
                                ("tm_jpeg_header", [ptr, i64, ptr, i32]),
                                ("tm_png_unfilter", [ptr, i64, i64, i32, ptr]),
                                ("tm_bmp_rle", [ptr, i64, i32, i32, i32, ptr])):
                fn = getattr(loaded, fname)
                fn.restype = ctypes.c_int32
                fn.argtypes = args
            for fname, args in (("tm_zstd_frame_content_size", [ptr, i64]),
                                ("tm_zstd_decompress", [ptr, i64, ptr, i64, i32]),
                                ("tm_zstd_compress", [ptr, i64, ptr, i64]),
                                ("tm_lzf_decompress", [ptr, i64, ptr, i64]),
                                ("tm_lzf_compress", [ptr, i64, ptr, i64]),
                                ("tm_jpeg_encode", [ptr, i32, i32, i32, i32, ptr, i64]),
                                ("tm_sgilog_decode", [ptr, i64, i32, i64, i64, ptr])):
                fn = getattr(loaded, fname)
                fn.restype = i64
                fn.argtypes = args
            fn = loaded.tm_lookup3
            fn.restype = ctypes.c_uint32
            fn.argtypes = [ptr, i64, ctypes.c_uint32]
            fn = loaded.tm_bgr2gray_f32
            fn.restype = None
            fn.argtypes = [ptr, i64, i64, i32, ptr]
            for fname, args in (("tm_unpack_bits", [ptr, i64, i64, i64, i32, ptr]),
                                ("tm_xyz2bgr", [ptr, i64, i64, ptr]),
                                ("tm_sgilog_luminances", [ptr, ptr]),
                                ("tm_tiff_ycbcr", [ptr, ptr, ptr, i64, ptr, ptr, ptr]),
                                ("tm_tiff_cielab", [ptr, i64, i32, ptr, ptr])):
                fn = getattr(loaded, fname)
                fn.restype = None
                fn.argtypes = args
            fn = loaded.tm_bgr2gray_int
            fn.restype = None
            fn.argtypes = [ptr, i64, i64, i32, i32, ptr]
            for fname in ("tm_zstd_error", "tm_jpeg_error"):
                getattr(loaded, fname).restype = ctypes.c_char_p
            _LIB = loaded
            from tmlibrary_tpu_torch import aotstore

            aotstore.note_cold("host_library")  # the first build or load in this process
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


# ------------------------------------------------------- mosaic host passes
def trace_boundary(labels: np.ndarray, label: int, max_pts: int = 1 << 16) -> np.ndarray:
    """Moore boundary trace of object ``label`` in an ``(H, W)`` label
    image: ``(K, 2)`` int32 ``(y, x)`` vertices, clockwise from its first
    pixel in scan order; empty when the label is absent."""
    labels = np.ascontiguousarray(labels, np.int32)
    h, w = labels.shape
    while True:
        buf = np.empty((max_pts, 2), np.int32)
        n = lib().tm_trace_boundary(labels.ctypes.data, h, w, int(label), buf.ctypes.data,
                                    max_pts)
        if n < 0:
            raise ValueError("tm_trace_boundary: invalid arguments")
        if n <= max_pts:
            return buf[:n].copy()
        max_pts = n  # truncated: again with the exact size


# ---------------------------------------------------- polygon simplification
def simplify_keep_numpy(contour: np.ndarray, tolerance: float) -> np.ndarray:
    """The plain version of ``tm_simplify_polygon``: the (K,) bool mask of
    the vertices Douglas-Peucker keeps, with the same split of the ring
    at vertex 0 and its farthest vertex and the same order of ranges."""
    n = len(contour)
    keep = np.zeros(n, bool)
    if n <= 2:
        keep[:] = True
        return keep
    pts = np.asarray(contour, np.float64)
    tol2 = tolerance * tolerance

    def dist2(i, a, b_pt):
        ay, ax = pts[a]
        dy, dx = b_pt[0] - ay, b_pt[1] - ax
        len2 = dy * dy + dx * dx
        ey, ex = pts[i, 0] - ay, pts[i, 1] - ax
        if len2 == 0.0:
            return ey * ey + ex * ex
        cross = dx * ey - dy * ex
        return cross * cross / len2

    far_i = int(((pts - pts[0]) ** 2).sum(axis=1)[1:].argmax()) + 1
    keep[0] = keep[far_i] = True
    stack = [(0, far_i), (far_i, n)]  # b == n: the chord ends at vertex 0
    while stack:
        a, b = stack.pop()
        b_pt = pts[0] if b == n else pts[b]
        worst, worst_d = -1, tol2
        for i in range(a + 1, b):
            d = dist2(i, a, b_pt)
            if d > worst_d:
                worst_d, worst = d, i
        if worst >= 0:
            keep[worst] = True
            stack.append((a, worst))
            stack.append((worst, b))
    return keep


def simplify_keep(contour: np.ndarray, tolerance: float) -> np.ndarray:
    """The (K,) bool mask of the vertices ``tm_simplify_polygon`` keeps."""
    contour = np.ascontiguousarray(contour, np.int32)
    if contour.ndim != 2 or contour.shape[1] != 2:
        raise ValueError(f"simplify_keep: expected (K, 2) vertices, got {contour.shape}")
    keep = np.zeros(len(contour), np.uint8)
    if lib().tm_simplify_polygon(contour.ctypes.data, len(contour), float(tolerance),
                                 keep.ctypes.data) < 0:
        raise ValueError("tm_simplify_polygon: invalid arguments")
    return keep.astype(bool)


def simplify_polygon_host(contour: np.ndarray, tolerance: float) -> np.ndarray:
    """Douglas-Peucker simplification of a closed ``(K, 2)`` ``(y, x)``
    contour ring to a perpendicular-distance tolerance in pixels, as the
    JAX package's ``simplify_polygon_host`` (``native.py:627-682``): a
    tolerance of 0 or a ring of 3 vertices or fewer is returned as it
    is; a ring that collapses to its two split vertices gets back the
    vertex farthest from their chord, and one left without area is
    returned unsimplified."""
    contour = np.ascontiguousarray(contour, np.int32)
    if tolerance <= 0 or len(contour) <= 3:
        return contour
    out = contour[simplify_keep(contour, tolerance)]
    if len(out) >= 3:
        return out
    pts = contour.astype(np.float64)
    far = int(((pts - pts[0]) ** 2).sum(axis=1).argmax())
    d = pts[far] - pts[0]
    len2 = max(float(d @ d), 1e-9)
    cross = np.abs(d[1] * (pts[:, 0] - pts[0, 0]) - d[0] * (pts[:, 1] - pts[0, 1])) / np.sqrt(len2)
    cross[0] = cross[far] = -1.0
    picked = contour[sorted({0, far, int(cross.argmax())})]
    if len(picked) < 3:
        return contour
    a, b, c = picked[:3].astype(np.float64)
    if abs((b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])) < 1e-12:
        return contour
    return picked


def mosaic_intensity(labels: np.ndarray, vals: np.ndarray, count: int):
    """``(sum, sum of squares, min, max)`` of ``vals`` per label of a label
    mosaic, each ``(count + 1,)`` float64 with index 0 the background."""
    labels = np.ascontiguousarray(labels, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    out = [np.empty(count + 1) for _ in range(4)]
    rc = lib().tm_mosaic_intensity(labels.ctypes.data, vals.ctypes.data, labels.size,
                                   int(count), *(a.ctypes.data for a in out))
    if rc != 0:
        raise ValueError(f"mosaic_intensity: label outside [0, {count}]")
    return tuple(out)


def mosaic_morph(labels: np.ndarray, count: int):
    """``(area, cy_sum, cx_sum, ymin, ymax, xmin, xmax)`` per label of a
    label mosaic, each ``(count + 1,)`` (index 0 the background; absent
    labels keep the ``h, -1, w, -1`` box sentinels)."""
    labels = np.ascontiguousarray(labels, np.int32)
    h, w = labels.shape
    out = [np.empty(count + 1, dt) for dt in (np.int64, np.float64, np.float64,
                                                np.int64, np.int64, np.int64, np.int64)]
    rc = lib().tm_mosaic_morph(labels.ctypes.data, h, w, int(count),
                               *(a.ctypes.data for a in out))
    if rc != 0:
        raise ValueError(f"mosaic_morph: label outside [0, {count}]")
    return tuple(out)


# -------------------------------------------------------------- tiff reader
def tiff_info(path) -> "tuple[int, int, int, int] | None":
    """``(n_pages, height, width, bits)`` of page 0 of a TIFF the C++
    reader handles, else None."""
    out = np.zeros(4, np.int32)
    if lib().tm_tiff_info(str(path).encode(), out.ctypes.data) != 0:
        return None
    return tuple(int(v) for v in out)


def tiff_read(path, page: int, height: int, width: int) -> "np.ndarray | None":
    """Page ``page`` of a grayscale TIFF as ``(height, width)`` uint16
    (8-bit samples widened), or None when the C++ reader declines the
    file (not classic TIFF, not strips, not 8/16-bit grayscale, another
    codec, another shape)."""
    out = np.empty((height, width), np.uint16)
    rc = lib().tm_tiff_read(str(path).encode(), int(page), out.ctypes.data,
                            int(height), int(width))
    return out if rc == 0 else None


def bgr2gray_int(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_BGR2GRAY)`` of an ``(H, W, 3|4)``
    uint8 or uint16 image, cv2's 15-bit weights rounded
    (``tm_bgr2gray_int``)."""
    img = np.ascontiguousarray(image)
    h, w, scn = img.shape
    out = np.empty((h, w), img.dtype)
    lib().tm_bgr2gray_int(img.ctypes.data, h, w, scn, img.dtype.itemsize, out.ctypes.data)
    return out


def bgr2gray_f32(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_BGR2GRAY)`` of an ``(H, W, 3|4)``
    float32 image, bit for bit as this repo's OpenCV build rounds it
    (``tm_bgr2gray_f32``)."""
    img = np.ascontiguousarray(image, np.float32)
    h, w, scn = img.shape
    out = np.empty((h, w), np.float32)
    lib().tm_bgr2gray_f32(img.ctypes.data, h, w, scn, out.ctypes.data)
    return out


#: per-thread scratch for tiff_read_page, grown on demand
_TIFF_SCRATCH = threading.local()


def tiff_read_page(path, page: int) -> "np.ndarray | None":
    """Page ``page`` of a grayscale TIFF at its own size, uint8 or uint16
    as stored, from one load of the file (``tm_tiff_read2``); None when
    the C++ reader declines the file."""
    scratch = getattr(_TIFF_SCRATCH, "buf", None)
    if scratch is None:
        scratch = _TIFF_SCRATCH.buf = np.empty(2048 * 2048, np.uint16)
    hwb = np.zeros(3, np.int32)
    for _ in range(2):
        rc = lib().tm_tiff_read2(str(path).encode(), int(page), scratch.ctypes.data,
                                 scratch.shape[0], hwb.ctypes.data)
        if rc == 0:
            h, w = int(hwb[0]), int(hwb[1])
            out = scratch[: h * w].reshape(h, w)
            return out.astype(np.uint8) if int(hwb[2]) == 8 else out.copy()
        if rc != -2:
            return None
        scratch = _TIFF_SCRATCH.buf = np.empty(int(hwb[0]) * int(hwb[1]), np.uint16)
    return None


def _strip_call(fn, src: bytes, expect: int) -> "bytes | None":
    buf = np.frombuffer(src, np.uint8)
    out = np.empty(expect, np.uint8)
    rc = fn(buf.ctypes.data, len(src), out.ctypes.data, expect)
    return out.tobytes() if rc == 1 else None


def lzw_decode(src: bytes, expect: int) -> "bytes | None":
    """A TIFF LZW strip decoded to exactly ``expect`` bytes (None on
    corrupt input or short output)."""
    return _strip_call(lib().tm_lzw_decode, src, expect)


def packbits_decode(src: bytes, expect: int) -> "bytes | None":
    """A PackBits strip decoded to exactly ``expect`` bytes (None on
    corrupt input or short output)."""
    return _strip_call(lib().tm_packbits_decode, src, expect)


def _lzw_decode_py(src: bytes, expect: int) -> "bytes | None":
    """The plain version of :func:`lzw_decode`: TIFF LZW (MSB-first codes,
    256 Clear, 257 EOI, early code-width change) with a sliding bit
    accumulator fed byte by byte."""
    table: list[bytes] = []

    def reset():
        table.clear()
        table.extend(bytes([i]) for i in range(256))
        table.extend((b"", b""))  # 256 Clear, 257 EOI

    reset()
    out = bytearray()
    width = 9
    prev: "bytes | None" = None
    acc = nbits = 0
    pos = 0
    n = len(src)
    while len(out) < expect:
        while nbits < width and pos < n:
            acc = (acc << 8) | src[pos]
            pos += 1
            nbits += 8
        if nbits < width:
            break
        nbits -= width
        code = (acc >> nbits) & ((1 << width) - 1)
        acc &= (1 << nbits) - 1
        if code == 257:
            break
        if code == 256:
            reset()
            width = 9
            prev = None
            continue
        if code < len(table):
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
        else:
            return None  # corrupt stream
        out += entry
        if prev is not None:
            table.append(prev + entry[:1])
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
        prev = entry
    # the final entry can overrun expect; the library truncates too
    return bytes(out[:expect]) if len(out) >= expect else None


def _packbits_decode_py(src: bytes, expect: int) -> "bytes | None":
    """The plain version of :func:`packbits_decode`."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n and len(out) < expect:
        c = src[i]
        i += 1
        if c < 128:
            cnt = c + 1
            if i + cnt > n:
                return None
            out += src[i:i + cnt]
            i += cnt
        elif c != 128:
            if i >= n:
                return None
            out += bytes([src[i]]) * (257 - c)
            i += 1
    # a run can cross the expect boundary; truncate like the library
    return bytes(out[:expect]) if len(out) >= expect else None


# ------------------------------------------------------------------ codecs
def _buffer(src) -> np.ndarray:
    return np.frombuffer(src, np.uint8) if len(src) else np.zeros(1, np.uint8)


def zstd_frame_content_size(src: bytes) -> int:
    """The content size the first Zstandard frame of ``src`` declares: -1
    when it declares none, 0 for a skippable frame (``zstandard.
    frame_content_size``); :class:`MetadataError` when the header is
    malformed."""
    from tmlibrary_tpu_torch.errors import MetadataError

    size = lib().tm_zstd_frame_content_size(_buffer(src).ctypes.data, len(src))
    if size == -2:
        raise MetadataError("error when determining content size")
    return int(size)


def zstd_decompress(src: bytes, expect: int, all_frames: bool = True) -> bytes:
    """Decode Zstandard ``src`` into at most ``expect`` bytes: every frame
    back to back (skippable frames skipped), or with ``all_frames=False``
    the first frame only and what follows ignored, as ``zstandard.
    ZstdDecompressor().decompress`` does.  A frame declaring more than
    ``expect`` bytes is refused before it is decoded; one declaring none
    is capped at ``expect``.  A malformed stream raises
    :class:`MetadataError` with the decoder's reason."""
    from tmlibrary_tpu_torch.errors import MetadataError

    out = np.empty(max(int(expect), 1), np.uint8)
    n = lib().tm_zstd_decompress(_buffer(src).ctypes.data, len(src), out.ctypes.data,
                                 int(expect), int(bool(all_frames)))
    if n < 0:
        raise MetadataError(f"decompression error: {lib().tm_zstd_error().decode()}")
    return out[:n].tobytes()


def zstd_compress(data: bytes) -> bytes:
    """One Zstandard frame of ``data`` with its content size."""
    src = _buffer(data)
    cap = len(data) + len(data) // 8 + 1024
    out = np.empty(cap, np.uint8)
    n = lib().tm_zstd_compress(src.ctypes.data, len(data), out.ctypes.data, cap)
    if n < 0 or n > cap:
        raise ValueError(f"zstd_compress failed: {lib().tm_zstd_error().decode()}")
    return out[:n].tobytes()


def lookup3(data, initval: int = 0) -> int:
    """Jenkins' lookup3 ``hashlittle`` of ``data``, HDF5's metadata
    checksum (``H5_checksum_lookup3``) and name hash."""
    return int(lib().tm_lookup3(_buffer(data).ctypes.data, len(data), initval))


def lzf_decompress(src: bytes, expect: int) -> bytes:
    """Decode an LZF stream (h5py's ``lzf`` filter) into at most
    ``expect`` bytes; :class:`MetadataError` for a damaged stream or one
    that decodes past ``expect``."""
    from tmlibrary_tpu_torch.errors import MetadataError

    out = np.empty(max(int(expect), 1), np.uint8)
    n = lib().tm_lzf_decompress(_buffer(src).ctypes.data, len(src), out.ctypes.data,
                                int(expect))
    if n == -2:
        raise MetadataError(f"LZF stream decodes past its {expect} bytes")
    if n < 0:
        raise MetadataError("damaged LZF stream")
    return out[:n].tobytes()


def lzf_compress(data: bytes) -> "bytes | None":
    """``data`` as an LZF stream, or None when the stream would not be
    shorter (h5py's filter then stores the chunk as it is)."""
    if not data:
        return None
    out = np.empty(len(data), np.uint8)
    n = lib().tm_lzf_compress(_buffer(data).ctypes.data, len(data), out.ctypes.data,
                              len(data) - 1)
    return out[:n].tobytes() if n > 0 else None


#: how :func:`jpeg_decode_array` turns the components into colour: as
#: libjpeg guesses the colour space from the JFIF and Adobe markers and
#: the component ids (then CMYK and YCCK into BGR as cv2 does), YCbCr
#: whatever they say (TIFF's JPEG tiles under ``JPEGCOLORMODE_RGB``), or
#: the components as stored (a TIFF's RGB or CMYK JPEG)
JPEG_GUESS, JPEG_YCC, JPEG_RAW = 0, 1, 2

#: the SOF markers the decoder reads, by what they declare
JPEG_PROCESSES = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
                  0xC3: "lossless", 0xC9: "arithmetic-coded sequential",
                  0xCA: "arithmetic-coded progressive"}


def jpeg_info(src: bytes, mode: int = JPEG_GUESS) -> "tuple[int, int, int]":
    """``(height, width, channels)`` of what :func:`jpeg_decode_array`
    returns (the stream's markers are read up to its first SOS): 1 channel
    for one component, else 3 (the component count in ``JPEG_RAW``);
    :class:`MetadataError` for a stream the decoder refuses there."""
    from tmlibrary_tpu_torch.errors import MetadataError

    hwc = np.zeros(3, np.int32)
    if lib().tm_jpeg_decode(_buffer(src).ctypes.data, len(src), None, hwc.ctypes.data,
                            int(mode)) != 0:
        raise MetadataError(lib().tm_jpeg_error().decode())
    return int(hwc[0]), int(hwc[1]), int(hwc[2])


def jpeg_header(src: bytes, mode: int = JPEG_GUESS) -> dict:
    """A stream's frame: ``height``, ``width``, ``components``, ``sof``
    (its SOF marker), ``process`` (:data:`JPEG_PROCESSES`), ``precision``
    and each component's ``(horizontal, vertical)`` ``sampling``;
    :class:`MetadataError` for a stream the decoder refuses up to its
    first SOS."""
    from tmlibrary_tpu_torch.errors import MetadataError

    info = np.zeros(14, np.int32)
    if lib().tm_jpeg_header(_buffer(src).ctypes.data, len(src), info.ctypes.data,
                            int(mode)) != 0:
        raise MetadataError(lib().tm_jpeg_error().decode())
    sof = int(info[12])
    return {"height": int(info[0]), "width": int(info[1]), "components": int(info[2]),
            "sof": sof, "process": JPEG_PROCESSES[sof], "precision": int(info[13]),
            "sampling": [(int(info[4 + 2 * c]), int(info[5 + 2 * c]))
                         for c in range(int(info[2]))]}


def jpeg_sampling(src: bytes, mode: int = JPEG_GUESS) -> "list[tuple[int, int]]":
    """Each component's ``(horizontal, vertical)`` sampling factors
    (:func:`jpeg_header`)."""
    return jpeg_header(src, mode)["sampling"]


def jpeg_dimensions(src: bytes) -> "tuple[int, int]":
    """``(height, width)`` of a JPEG (:func:`jpeg_info`)."""
    return jpeg_info(src)[:2]


def jpeg_decode(src: bytes) -> "tuple[int, int, bytes]":
    """``(height, width, pixels)`` of a grey JPEG, the pixels row-major
    uint8 as libjpeg decodes them; colour streams raise here (use
    :func:`jpeg_decode_array`)."""
    img = jpeg_decode_array(src)
    if img.ndim != 2:
        from tmlibrary_tpu_torch.errors import MetadataError

        raise MetadataError("jpeg_decode: a colour stream (use jpeg_decode_array)")
    return (*img.shape, img.tobytes())


def jpeg_decode_array(src: bytes, mode: int = JPEG_GUESS) -> np.ndarray:
    """A JPEG as libjpeg-turbo decodes it for ``cv2.imdecode(...,
    IMREAD_UNCHANGED)``: baseline, extended or progressive, Huffman or
    arithmetic-coded, or lossless at 2-8 bits (:data:`JPEG_PROCESSES`), of
    1, 3 or 4 components: ``(H, W)`` uint8 for grey, ``(H, W, 3)`` BGR for
    colour (fancy upsampling, ``jdcolor.c``'s YCbCr tables, a progressive
    stream that stops early block-smoothed, CMYK and YCCK as cv2 turns
    them into BGR; ``mode`` as :data:`JPEG_GUESS`).  What cv2 reads no
    image of (hierarchical, 12- and 16-bit, 2-component, fractional
    sampling, lossless streams that need a colour conversion) and damaged
    headers raise :class:`MetadataError` naming the reason."""
    from tmlibrary_tpu_torch.errors import MetadataError

    h, w, c = jpeg_info(src, mode)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    hwc = np.zeros(3, np.int32)
    if lib().tm_jpeg_decode(_buffer(src).ctypes.data, len(src), out.ctypes.data,
                            hwc.ctypes.data, int(mode)) != 0:
        raise MetadataError(lib().tm_jpeg_error().decode())
    return out


def jpeg_encode(image: np.ndarray, quality: int = 95) -> bytes:
    """A grey ``(H, W)`` or BGR ``(H, W, 3)`` uint8 image as a baseline
    JPEG, byte for byte as ``cv2.imencode(".jpg", image,
    [IMWRITE_JPEG_QUALITY, quality])`` writes it (libjpeg-turbo's integer
    forward DCT, the Annex K tables at libjpeg's ``quality`` scaling,
    colour as YCbCr 4:2:0; 95 is cv2's default)."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"jpeg_encode: expected an (H, W) or (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else 3
    n = lib().tm_jpeg_encode(img.ctypes.data, h, w, nc, int(quality), None, 0)
    if n < 0:
        raise ValueError(f"jpeg_encode failed: {lib().tm_jpeg_error().decode()}")
    out = np.empty(n, np.uint8)
    lib().tm_jpeg_encode(img.ctypes.data, h, w, nc, int(quality), out.ctypes.data, n)
    return out.tobytes()


# ------------------------------------------------------------ raster loops
def png_unfilter(raw, h: int, stride: int, bpp: int) -> np.ndarray:
    """``(h, stride)`` bytes of ``h`` PNG rows of ``1 + stride`` bytes
    (the filter type first) with their filters undone; ``bpp`` is the
    filter's byte distance.  Raises ``ValueError`` naming the first row
    of an unknown filter type."""
    src = np.frombuffer(raw, np.uint8, h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    rc = lib().tm_png_unfilter(src.ctypes.data, h, stride, max(1, int(bpp)), out.ctypes.data)
    if rc < 0:
        y = -rc - 1
        raise ValueError(f"row {y} has unknown filter type {src[y * (stride + 1)]}")
    return out


def unpack_bits(packed: np.ndarray, rows: int, row_bytes: int, n: int, bits: int) -> np.ndarray:
    """``(rows, n)`` uint16 samples of ``bits`` bits (1-16), packed most
    significant bit first in rows of ``row_bytes`` bytes."""
    src = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    if src.size < rows * row_bytes:
        raise ValueError(f"unpack_bits: {src.size} bytes for {rows} rows of {row_bytes}")
    out = np.empty((rows, n), np.uint16)
    lib().tm_unpack_bits(src.ctypes.data, rows, row_bytes, n, int(bits), out.ctypes.data)
    return out


def bmp_rle(src: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """The ``(height, width)`` palette indices of a BMP RLE4 (``bits`` 4)
    or RLE8 stream, rows in the file's order, as OpenCV walks the stream
    (``csrc/host/raster.cpp``).  Raises ``ValueError`` when the stream
    ends early or a run leaves its row."""
    data = np.frombuffer(src, np.uint8)
    out = np.empty((height, width), np.uint8)
    if lib().tm_bmp_rle(data.ctypes.data, data.size, width, height, bits, out.ctypes.data) < 0:
        raise ValueError("a run past its row or an RLE stream that ends early")
    return out


def tiff_ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, luma, refbw) -> np.ndarray:
    """8-bit YCbCr samples (equal shapes) to ``shape + (3,)`` RGB bytes as
    libtiff's ``TIFFYCbCrtoRGB`` converts them for ``TIFFReadRGBA*``, its
    tables from ``luma`` (YCbCrCoefficients) and ``refbw``
    (ReferenceBlackWhite)."""
    planes = [np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr)]
    lu = np.asarray(luma, np.float32)
    rb = np.asarray(refbw, np.float32)
    out = np.empty(planes[0].shape + (3,), np.uint8)
    lib().tm_tiff_ycbcr(*(p.ctypes.data for p in planes), planes[0].size, lu.ctypes.data,
                        rb.ctypes.data, out.ctypes.data)
    return out


def tiff_cielab_to_rgb(lab: np.ndarray, white=None) -> np.ndarray:
    """``(..., 3)`` CIELab samples (uint8 L with int8 a, b as stored, or
    16-bit) to RGB bytes as libtiff's ``TIFFReadRGBA*`` converts them (sRGB
    display, the white point ``white`` = (x, y), D50 by default)."""
    lab = np.ascontiguousarray(lab)
    bits = 8 if lab.dtype.itemsize == 1 else 16
    lab = lab.view(np.uint8 if bits == 8 else np.uint16)
    if white is None:  # libtiff's default: D50
        d50 = np.float32([96.4250, 100.0, 82.4680])
        total = d50[0] + d50[1] + d50[2]
        white = np.float32([d50[0] / total, d50[1] / total])
    wp = np.asarray(white, np.float32)
    out = np.empty(lab.shape[:-1] + (3,), np.uint8)
    lib().tm_tiff_cielab(lab.ctypes.data, lab.size // 3, bits, wp.ctypes.data, out.ctypes.data)
    return out


# ---------------------------------------------------------------- SGILog
#: :func:`sgilog_decode`'s kinds: LogL16 and LogLuv32 (compression 34676),
#: LogLuv24 (34677)
SGILOG_L16, SGILOG_LUV32, SGILOG_LUV24 = 0, 1, 2


def sgilog_decode(chunk, kind: int, width: int, rows: int) -> np.ndarray:
    """``rows`` rows of ``width`` pixels of one SGILog strip or tile as
    libtiff's ``tif_luv.c`` hands them to cv2: LogL16 as ``(rows, width)``
    uint8 grey (``SGILOGDATAFMT_8BIT``), LogLuv32 and LogLuv24 as
    ``(rows, width, 3)`` float32 X, Y, Z (``SGILOGDATAFMT_FLOAT``).
    Raises ``ValueError`` naming the first row the data runs out in."""
    data = np.frombuffer(bytes(chunk), np.uint8)
    out = np.empty((rows, width) if kind == SGILOG_L16 else (rows, width, 3),
                   np.uint8 if kind == SGILOG_L16 else np.float32)
    n = lib().tm_sgilog_decode(data.ctypes.data, data.size, int(kind), int(width), int(rows),
                               out.ctypes.data)
    if n < 0:
        raise ValueError(f"SGILog data ends in row {-1 - n} of {rows}")
    return out


def xyz_to_bgr(xyz: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(xyz, COLOR_XYZ2BGR)`` of an ``(H, W, 3)`` float32
    image, float for float (each row's first multiple of 4 pixels summed as
    cv2's vector loop sums them, the rest as its scalar loop does)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    out = np.empty_like(xyz)
    lib().tm_xyz2bgr(xyz.ctypes.data, xyz.shape[0], xyz.shape[1], out.ctypes.data)
    return out


def sgilog_luminances() -> "tuple[np.ndarray, np.ndarray]":
    """The luminances the SGILog decoder takes from the host's ``exp``:
    LogL16's 32,768 (by code) and LogL10's 1,024, float64."""
    l16, l10 = np.empty(32768), np.empty(1024)
    lib().tm_sgilog_luminances(l16.ctypes.data, l10.ctypes.data)
    return l16, l10
