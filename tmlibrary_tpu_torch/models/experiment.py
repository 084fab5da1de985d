"""Experiment manifest: the structural data model.

Counterpart: ``tmlibrary_tpu/models/experiment.py``, the same classes
and the same ``manifest.json`` in both directions.  Reference parity:
``tmlib/models/experiment.py``, ``plate.py``, ``well.py``,
``site.py``, ``channel.py``, ``acquisition.py``, ``cycle.py`` — SQLAlchemy
models over PostgreSQL in the reference; a JSON-serializable manifest here.

The canonical index hierarchy (matching the reference's object model) is::

    Experiment
      └─ Plate (name)
          └─ Well (row, column)              # e.g. 16 x 24 = 384-well
              └─ Site (y, x in well grid)    # acquisition site
    Experiment.channels   (name, wavelength) # shared across plates
    Experiment.cycles     (index)            # multiplexing acquisition rounds
    Experiment.tpoints / zplanes             # time series / z-stacks

Every pixel plane is addressed by the tuple
``(plate, well, site, cycle, channel, tpoint, zplane)``.  Sites share a fixed
``(height, width)`` per experiment — this is what makes the site axis a clean
batch dimension on the device.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator

from tmlibrary_tpu_torch.errors import MetadataError


@dataclasses.dataclass(frozen=True)
class Channel:
    """A fluorescence channel (reference: ``tmlib/models/channel.py``)."""

    index: int
    name: str
    wavelength: str | None = None
    bit_depth: int = 16


@dataclasses.dataclass(frozen=True)
class Site:
    """An acquisition site within a well (reference: ``tmlib/models/site.py``).

    ``y``/``x`` are the site's grid coordinates inside its well.
    """

    y: int
    x: int


@dataclasses.dataclass(frozen=True)
class Well:
    """A well within a plate (reference: ``tmlib/models/well.py``).

    ``row``/``column`` are zero-based plate-grid coordinates; ``name`` is the
    conventional label (e.g. ``"A01"``).
    """

    row: int
    column: int
    sites: tuple[Site, ...]

    @property
    def name(self) -> str:
        if self.row >= 26:
            # double-letter rows for >26-row plates (e.g. 1536-well)
            first = chr(ord("A") + self.row // 26 - 1)
            second = chr(ord("A") + self.row % 26)
            prefix = first + second
        else:
            prefix = chr(ord("A") + self.row)
        return f"{prefix}{self.column + 1:02d}"


@dataclasses.dataclass(frozen=True)
class Plate:
    """A multi-well plate (reference: ``tmlib/models/plate.py``)."""

    name: str
    wells: tuple[Well, ...]


@dataclasses.dataclass(frozen=True)
class SiteRef:
    """Fully-qualified site address — the unit of per-site work.

    The linear enumeration of ``SiteRef``s is the batching axis: the
    reference partitions this list into GC3Pie jobs
    (``create_run_batches``); the port partitions it into device batches.
    """

    plate: str
    well_row: int
    well_column: int
    site_y: int
    site_x: int

    def as_tuple(self) -> tuple:
        return (self.plate, self.well_row, self.well_column, self.site_y, self.site_x)


@dataclasses.dataclass
class Experiment:
    """Top-level experiment manifest (reference: ``tmlib/models/experiment.py``).

    Unlike the reference (ORM rows in the main DB + a per-experiment
    Citus-sharded DB), the manifest is a plain JSON document stored at the
    experiment root; pixel data lives next to it in the
    :class:`~tmlibrary_tpu_torch.models.store.ExperimentStore`.
    """

    name: str
    plates: list[Plate]
    channels: list[Channel]
    site_height: int
    site_width: int
    n_cycles: int = 1
    n_tpoints: int = 1
    n_zplanes: int = 1

    # ------------------------------------------------------------------ axes
    def sites(self) -> Iterator[SiteRef]:
        """Enumerate all sites in canonical (plate, well, site) order."""
        for plate in self.plates:
            for well in plate.wells:
                for site in well.sites:
                    yield SiteRef(plate.name, well.row, well.column, site.y, site.x)

    @property
    def n_sites(self) -> int:
        return sum(len(w.sites) for p in self.plates for w in p.wells)

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def channel_index(self, name: str) -> int:
        for ch in self.channels:
            if ch.name == name:
                return ch.index
        raise MetadataError(f"no channel named '{name}'")

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "site_height": self.site_height,
            "site_width": self.site_width,
            "n_cycles": self.n_cycles,
            "n_tpoints": self.n_tpoints,
            "n_zplanes": self.n_zplanes,
            "channels": [dataclasses.asdict(c) for c in self.channels],
            "plates": [
                {
                    "name": p.name,
                    "wells": [
                        {
                            "row": w.row,
                            "column": w.column,
                            "sites": [[s.y, s.x] for s in w.sites],
                        }
                        for w in p.wells
                    ],
                }
                for p in self.plates
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Experiment":
        return cls(
            name=d["name"],
            site_height=d["site_height"],
            site_width=d["site_width"],
            n_cycles=d.get("n_cycles", 1),
            n_tpoints=d.get("n_tpoints", 1),
            n_zplanes=d.get("n_zplanes", 1),
            channels=[Channel(**c) for c in d["channels"]],
            plates=[
                Plate(
                    name=p["name"],
                    wells=tuple(
                        Well(
                            row=w["row"],
                            column=w["column"],
                            sites=tuple(Site(y=s[0], x=s[1]) for s in w["sites"]),
                        )
                        for w in p["wells"]
                    ),
                )
                for p in d["plates"]
            ],
        )

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: Path) -> "Experiment":
        return cls.from_dict(json.loads(Path(path).read_text()))


def grid_experiment(
    name: str = "demo",
    n_plates: int = 1,
    well_rows: int = 2,
    well_cols: int = 2,
    sites_per_well: tuple[int, int] = (2, 2),
    channel_names: tuple[str, ...] = ("DAPI",),
    site_shape: tuple[int, int] = (256, 256),
    n_cycles: int = 1,
    n_tpoints: int = 1,
    n_zplanes: int = 1,
) -> Experiment:
    """Build a regular-grid experiment manifest (test/demo helper)."""
    sites = tuple(
        Site(y=sy, x=sx)
        for sy in range(sites_per_well[0])
        for sx in range(sites_per_well[1])
    )
    plates = [
        Plate(
            name=f"plate{p:02d}",
            wells=tuple(
                Well(row=r, column=c, sites=sites)
                for r in range(well_rows)
                for c in range(well_cols)
            ),
        )
        for p in range(n_plates)
    ]
    channels = [Channel(index=i, name=n) for i, n in enumerate(channel_names)]
    return Experiment(
        name=name,
        plates=plates,
        channels=channels,
        site_height=site_shape[0],
        site_width=site_shape[1],
        n_cycles=n_cycles,
        n_tpoints=n_tpoints,
        n_zplanes=n_zplanes,
    )
