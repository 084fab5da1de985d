"""imextract: extract pixel planes into the canonical store.

Counterpart: ``tmlibrary_tpu/workflow/steps/imextract.py`` (reference
``tmlib/workflow/imextract/api.py`` ``ImageExtractor``): the planes of
metaconfig's file mapping, read on the host and written as contiguous
site stacks in batches of ``batch_size`` files.

A plane is read in the JAX package's order (:meth:`ImageExtractor._read_plane`):
a microscope container by the page its metaconfig handler wrote
(:func:`~tmlibrary_tpu_torch.readers.read_container_plane`: ND2, CZI,
LIF, DV, STK, LSM, OIF/OIB, FLEX, OME-NGFF), then the C++ TIFF reader (:func:`~tmlibrary_tpu_torch.native.tiff_read`),
then the Python TIFF reader for what it declines (BigTIFF, deflate
strips), then the PNG codec (:mod:`~tmlibrary_tpu_torch.io.png`, colour
converted to grey as cv2 converts it).  Where the JAX package hands any
other file to ``cv2``, the port raises
:class:`~tmlibrary_tpu_torch.errors.MetadataError` naming the file and
its format.  The decode thread pool is sized by the JAX package's default
rule unless ``TMX_INGEST_WORKERS`` pins it (anything unparseable or
below 1 gives the default); ``TMX_INGEST_THROTTLE_MS`` sleeps that long
in the worker before each plane read, a cold source's latency that the
pool overlaps (the ingest bench's cold rows).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np

from tmlibrary_tpu_torch import native
from tmlibrary_tpu_torch.errors import MetadataError
from tmlibrary_tpu_torch.io import png
from tmlibrary_tpu_torch.readers import read_container_plane, read_tiff_page, read_tiff_page_py
from tmlibrary_tpu_torch.utils import create_partitions
from tmlibrary_tpu_torch.workflow.api import Step
from tmlibrary_tpu_torch.workflow.args import Argument, ArgumentCollection
from tmlibrary_tpu_torch.workflow.registry import register_step

#: leading bytes -> the format named when the port cannot read a file
_MAGIC = ((b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"II+\0", "BigTIFF"),
          (b"MM\0+", "BigTIFF"), (png.SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"),
          (b"BM", "BMP"), (b"GIF8", "GIF"))


def _unreadable(path: str, page: "int | None") -> MetadataError:
    """The error for a file no reader of the port takes: its format by
    its leading bytes, and for a TIFF the Python reader's reason."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError as e:
        return MetadataError(f"cannot read image {path}: {e}")
    fmt = next((name for magic, name in _MAGIC if head.startswith(magic)), None)
    if fmt is None:
        return MetadataError(f"cannot read image {path}: unknown format "
                             f"(leading bytes {head.hex()})")
    why = ""
    if fmt in ("TIFF", "BigTIFF"):
        try:
            read_tiff_page(path, page or 0)
        except Exception as e:  # the reason the reader declined it
            why = f": {e}"
    return MetadataError(f"cannot read image {path}: a {fmt} file the port's readers do not "
                         f"decode{why}")


@register_step("imextract")
class ImageExtractor(Step):
    batch_args = ArgumentCollection(
        Argument("batch_size", int, default=64, help="files per batch"),
    )

    def create_batches(self, args):
        from tmlibrary_tpu_torch.workflow.steps.metaconfig import MetadataConfigurator

        mapping = MetadataConfigurator(self.store, device=self.device).load_mapping()
        return [
            {"files": chunk}
            for chunk in create_partitions(mapping, args["batch_size"])
        ]

    @staticmethod
    def _read_plane(path: str, page: "int | None", height: int, width: int) -> np.ndarray:
        """One grayscale plane: a container, the C++ TIFF reader, the
        Python TIFF reader (``.tif``/``.tiff``), the PNG codec, in that
        order; anything else raises :class:`MetadataError`.  Sleeps
        ``TMX_INGEST_THROTTLE_MS`` first where it is set."""
        throttle = os.environ.get("TMX_INGEST_THROTTLE_MS")
        if throttle:
            time.sleep(float(throttle) / 1e3)
        container = read_container_plane(path, page or 0)
        if container is not None:
            return container

        img = native.tiff_read(path, page or 0, height, width)
        if img is not None:
            return img

        if path.lower().endswith((".tif", ".tiff")):
            img = read_tiff_page_py(path, page or 0)
            if img is not None:
                return img

        if png.is_png(path):
            if page:
                raise MetadataError(f"cannot read page {page} of {path}: a PNG has one")
            img = png.read(path)
            return png.to_gray(img) if img.ndim == 3 else img
        raise _unreadable(path, page)

    def run_batch(self, batch: dict) -> dict:
        exp = self.store.experiment
        # group by target plane so each plane's sites write in one slice
        by_plane: dict[tuple, list[dict]] = {}
        for f in batch["files"]:
            key = (f["cycle"], f["channel"], f["tpoint"], f["zplane"])
            by_plane.setdefault(key, []).append(f)

        # plane decode is IO and decompression bound, and the TIFF library
        # and zlib release the interpreter's lock: a thread pool reads a
        # batch's files concurrently, sized for overlapping storage stalls
        # (a floor of 4 even on one core), as in the JAX package, unless
        # TMX_INGEST_WORKERS pins it (the bench's one-worker denominator)
        try:
            workers = int(os.environ.get("TMX_INGEST_WORKERS", ""))
        except ValueError:
            workers = 0
        if workers < 1:
            workers = max(4, min(8, os.cpu_count() or 1))
        n_written = 0
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            # every decode submitted up front, then drained and written
            # group by group
            futures = {
                (key, i): pool.submit(
                    self._read_plane, f["path"], f.get("page"),
                    exp.site_height, exp.site_width,
                )
                for key, files in by_plane.items()
                for i, f in enumerate(files)
            }
            for key, files in by_plane.items():
                cycle, channel, tpoint, zplane = key
                pixels = []
                indices = []
                for i, f in enumerate(files):
                    img = futures[(key, i)].result()
                    if img.shape != (exp.site_height, exp.site_width):
                        raise MetadataError(
                            f"{f['path']}: shape {img.shape} != site shape "
                            f"({exp.site_height}, {exp.site_width})"
                        )
                    pixels.append(np.asarray(img, np.uint16))
                    indices.append(f["site_index"])
                self.store.write_sites(
                    np.stack(pixels), indices,
                    cycle=cycle, channel=channel, tpoint=tpoint, zplane=zplane,
                )
                n_written += len(files)
        return {"n_written": n_written}
