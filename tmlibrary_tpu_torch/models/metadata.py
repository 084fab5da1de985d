"""Typed metadata records for images, statistics files and pyramid tiles.

Counterpart: ``tmlibrary_tpu/models/metadata.py`` (reference
``tmlib/metadata.py`` ``ImageMetadata``, ``ChannelImageMetadata``,
``IllumstatsImageMetadata``, ``PyramidTileMetadata`` and
``ImageFileMapping``, plus ``tmlib/models/channel.py``'s
``ChannelLayer``): plain dataclasses that serialize to and from the JSON
dicts the store and the steps' output directories hold, the same dicts
in both packages.  Pixel data never lives here.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ImageMetadata:
    """Positional coordinates of one pixel plane
    (reference ``tmlib.metadata.ImageMetadata``)."""

    plate: int = 0
    well: str = ""
    site_y: int = 0
    site_x: int = 0
    tpoint: int = 0
    zplane: int = 0
    cycle: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ImageMetadata":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ChannelImageMetadata(ImageMetadata):
    """Channel plane provenance + processing flags
    (reference ``tmlib.metadata.ChannelImageMetadata``)."""

    channel: str = ""
    is_corrected: bool = False
    is_aligned: bool = False
    is_clipped: bool = False
    bit_depth: int = 16


@dataclasses.dataclass
class IllumstatsImageMetadata:
    """Provenance of one illumination-statistics file
    (reference ``tmlib.metadata.IllumstatsImageMetadata``)."""

    channel: str = ""
    cycle: int = 0
    n_sites: int = 0
    is_smoothed: bool = False

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "IllumstatsImageMetadata":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class PyramidTileMetadata:
    """Zoom-pyramid tile address (reference
    ``tmlib.metadata.PyramidTileMetadata`` / ``tmlib/models/tile.py``
    ``ChannelLayerTile``): ``(level, row, col)`` within a channel layer."""

    level: int
    row: int
    col: int
    channel: str = ""

    def filename(self) -> str:
        """Zoomify-style relative path used by the illuminati step's output
        layout (``pyramids/<channel>/<level>/<row>_<col>.png``)."""
        return f"{self.channel}/{self.level}/{self.row}_{self.col}.png"


@dataclasses.dataclass
class ChannelLayer:
    """Zoom-level descriptor for one channel's pyramid (reference
    ``tmlib/models/channel.py`` ``ChannelLayer``): mosaic size, tile size,
    number of levels and per-level grid shape — everything a slippy-map
    viewer needs to address tiles without scanning the directory."""

    channel: str
    height: int
    width: int
    tile_size: int = 256
    max_zoom: int = 0

    def grid(self, level: int) -> tuple[int, int]:
        """(rows, cols) of the tile grid at zoomify ``level`` — level
        ``max_zoom`` is full resolution, each level below ceil-halves the
        mosaic exactly as the illuminati downsample chain does
        (``pyramid_levels``: ``(h+1)//2`` per level), matching the
        ``pyramids/<channel>/<level>/`` directory numbering."""
        shift = self.max_zoom - level
        if shift < 0:
            raise ValueError(f"level {level} exceeds max_zoom {self.max_zoom}")
        h, w = self.height, self.width
        for _ in range(shift):
            h, w = (h + 1) // 2, (w + 1) // 2
        return (
            -(-h // self.tile_size),
            -(-w // self.tile_size),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ChannelLayer":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ImageFileMapping:
    """Source-file → store-coordinate mapping produced by metaconfig and
    consumed by imextract (reference ``tmlib.metadata.ImageFileMapping``).

    ``series``/``plane`` address the plane inside the source file (multi-page
    TIFF / vendor container); the remaining fields are canonical store
    coordinates.
    """

    path: str
    site_index: int
    channel: int
    tpoint: int = 0
    zplane: int = 0
    cycle: int = 0
    series: int = 0
    plane: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ImageFileMapping":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
