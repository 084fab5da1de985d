"""Image classes: thin metadata wrappers over tensors.

Counterpart: ``tmlibrary_tpu/models/image.py`` (reference
``tmlib/image.py``): ``Image``, ``ChannelImage``
(``correct``/``align``/``clip``/``scale``/``smooth``),
``SegmentationImage`` (label image and polygons),
``IllumstatsContainer`` and ``PyramidTile``.  The pixel buffer is a
tensor on the CPU or the card; every method delegates to the port's ops
(:mod:`~tmlibrary_tpu_torch.ops.image_ops`,
:mod:`~tmlibrary_tpu_torch.ops.smooth`,
:mod:`~tmlibrary_tpu_torch.ops.polygons`) and returns a new instance on
the same device.  An image is one ``(H, W)`` plane, as in the reference;
the methods whose ops take batches also take ``(B, H, W)``.  The
reference's pytree registration (``tree_flatten``/``tree_unflatten``) is
JAX's and has no counterpart.  ``PyramidTile.encode_png`` writes through
the port's PNG codec (:mod:`~tmlibrary_tpu_torch.io.png`), whose bytes
may differ from cv2's and whose decoded pixels do not.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tmlibrary_tpu_torch.ops import image_ops
from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth, median_smooth


@dataclasses.dataclass
class Image:
    """A pixel plane plus site metadata (reference ``tmlib.image.Image``)."""

    array: torch.Tensor
    metadata: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.array, torch.Tensor):
            self.array = torch.as_tensor(np.asarray(self.array))

    @property
    def shape(self) -> tuple:
        return tuple(self.array.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.array.dtype

    def _like(self, array: torch.Tensor) -> "Image":
        return type(self)(array, dict(self.metadata))

    def extract(self, y: int, x: int, height: int, width: int) -> "Image":
        return self._like(image_ops.extract(self.array, y, x, height, width))

    def insert(self, patch: "Image", y: int, x: int) -> "Image":
        return self._like(image_ops.insert(self.array, patch.array, y, x))

    def pad(self, top: int, bottom: int, left: int, right: int, value=0) -> "Image":
        return self._like(image_ops.pad(self.array, top, bottom, left, right, value))

    def numpy(self) -> np.ndarray:
        return self.array.detach().cpu().numpy()

    @classmethod
    def join(cls, tiles: "list[Image] | torch.Tensor", grid_rows: int, grid_cols: int) -> "Image":
        """A row-major grid of equally sized tiles as one mosaic
        (reference ``tmlib.image.Image.join``); the metadata is the first
        tile's."""
        if isinstance(tiles, (list, tuple)):
            if not tiles:
                raise ValueError("Image.join requires at least one tile")
            meta = dict(tiles[0].metadata)
            stack = torch.stack([t.array for t in tiles])
        else:
            meta = {}
            stack = torch.as_tensor(tiles)
        return cls(image_ops.join_grid(stack, grid_rows, grid_cols), meta)


class ChannelImage(Image):
    """Intensity image of one channel at one site
    (reference ``tmlib.image.ChannelImage``)."""

    def correct(self, stats: "IllumstatsContainer") -> "ChannelImage":
        """Illumination-correct against corilla statistics."""
        dev = self.array.device
        return self._like(image_ops.correct_illumination(
            self.array, torch.as_tensor(stats.mean_log, device=dev),
            torch.as_tensor(stats.std_log, device=dev)))

    def align(self, dy, dx, window: "tuple[int, int, int, int] | None" = None) -> "ChannelImage":
        """Shift by ``(dy, dx)`` (one per site of a batch), zero-filling,
        then crop ``window`` (top, bottom, left, right) when given."""
        plane = self.array.dim() == 2
        img = self.array[None] if plane else self.array
        dev = img.device
        dy = torch.as_tensor(dy, device=dev).to(torch.int64).reshape(-1)
        dx = torch.as_tensor(dx, device=dev).to(torch.int64).reshape(-1)
        shifts = torch.stack([dy.expand(img.shape[0]), dx.expand(img.shape[0])], dim=1)
        out = image_ops.align(img, shifts, window)
        return self._like(out[0] if plane else out)

    def clip(self, lower, upper) -> "ChannelImage":
        return self._like(image_ops.clip_values(self.array, lower, upper))

    def scale(self, lower, upper) -> "ChannelImage":
        return self._like(image_ops.rescale(self.array, lower, upper))

    def smooth(self, sigma: float = 1.0, method: str = "gaussian") -> "ChannelImage":
        if method == "gaussian":
            return self._like(gaussian_smooth(self.array, sigma))
        if method == "median":
            return self._like(median_smooth(self.array, int(sigma)))
        raise ValueError(f"unknown smoothing method '{method}'")


class SegmentationImage(Image):
    """Labelled object image (reference ``tmlib.image.SegmentationImage``):
    0 is background, 1..N the objects."""

    @property
    def n_objects(self) -> torch.Tensor:
        """The largest label of the plane (of each site of a batch)."""
        return self.array.amax(dim=(-2, -1))

    def labels_host(self) -> np.ndarray:
        return self.numpy()

    def extract_polygons(self) -> list[tuple[int, np.ndarray]]:
        """``[(label, (K, 2) y/x contour)]`` of an ``(H, W)`` plane, traced
        on the host (:func:`~tmlibrary_tpu_torch.ops.polygons.labels_to_polygons`)."""
        from tmlibrary_tpu_torch.ops.polygons import labels_to_polygons

        return labels_to_polygons(self.labels_host())


@dataclasses.dataclass
class IllumstatsContainer:
    """Per-channel illumination statistics in the log10 domain (corilla's):
    per-pixel mean and std over all sites of a channel, the intensity
    percentiles and the site count.  ``mean_log``/``std_log`` are numpy
    arrays or tensors."""

    mean_log: Any
    std_log: Any
    percentiles: dict[float, float]
    n: int

    def smooth(self, sigma: float = 5.0) -> "IllumstatsContainer":
        """Pre-smooth the statistic fields (the reference smooths stats
        before applying them so single-pixel noise doesn't amplify)."""

        def field(a):
            return gaussian_smooth(torch.as_tensor(a), sigma)

        return IllumstatsContainer(
            mean_log=field(self.mean_log),
            std_log=field(self.std_log),
            percentiles=self.percentiles,
            n=self.n,
        )

    @classmethod
    def from_store(cls, d: dict[str, Any]) -> "IllumstatsContainer":
        pct_keys = d.get("percentile_keys")
        pct_vals = d.get("percentile_values")
        percentiles = (
            {float(k): float(v) for k, v in zip(pct_keys, pct_vals)}
            if pct_keys is not None
            else {}
        )
        return cls(
            mean_log=np.asarray(d["mean_log"]),
            std_log=np.asarray(d["std_log"]),
            percentiles=percentiles,
            n=int(d["n"]),
        )

    def to_store(self) -> dict[str, np.ndarray]:
        def host(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        keys = sorted(self.percentiles)
        return {
            "mean_log": host(self.mean_log),
            "std_log": host(self.std_log),
            "percentile_keys": np.asarray(keys, np.float64),
            "percentile_values": np.asarray([self.percentiles[k] for k in keys]),
            "n": np.asarray(self.n),
        }


class PyramidTile:
    """A 256x256 display tile (reference ``tmlib.image.PyramidTile``)."""

    TILE_SIZE = 256

    def __init__(self, array):
        if tuple(array.shape) != (self.TILE_SIZE, self.TILE_SIZE):
            raise ValueError(f"tile must be {self.TILE_SIZE}px square, got "
                             f"{tuple(array.shape)}")
        self.array = array

    def encode_png(self) -> bytes:
        """8-bit greyscale PNG bytes; other dtypes are clipped to 0..255
        first."""
        from tmlibrary_tpu_torch.io import png

        arr = self.array
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.asarray(arr)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return png.encode(arr)
