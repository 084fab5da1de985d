"""On-disk experiment store.

Counterpart: ``tmlibrary_tpu/models/store.py``, with the same on-disk
layout, so a store written by either package opens in the other and its
pixel stacks, label stacks, illumination statistics and shift tables
read back byte for byte:

- **pixels**: one memory-mapped ``.npy`` per (cycle, channel, tpoint,
  zplane) holding ALL sites stacked on axis 0 in canonical site order,
  ``(n_sites, H, W)`` uint16.  A batch of sites is one (fancy-indexed)
  slice instead of many small file opens.
- **illumination statistics**: one ``.npz`` per (cycle, channel)
  (mean/variance in the log10 domain, percentiles, sample count).
- **segmentations**: per mapobject type, an ``(n_sites, H, W)`` int32
  label stack.
- **alignment**: per cycle, an ``(n_sites, 2)`` int32 shift array, plus
  the experiment-wide intersection window (``intersection.json``).
- **features**: per mapobject type, one Parquet shard per batch
  (``<shard>.parquet``), written and read by the port's own codec
  (:mod:`tmlibrary_tpu_torch.io.parquet`; the target machine has no
  ``pandas`` or ``pyarrow``).  The shards are what the JAX package's
  ``DataFrame.to_parquet`` writes for the same rows: the same columns in
  the same order, no index, NaN features as nulls, so either package
  reads the other's.  :meth:`ExperimentStore.read_features` returns the
  concatenated columns as a dict of numpy arrays.

Everything is addressed through the manifest's canonical site
enumeration (:meth:`tmlibrary_tpu_torch.models.experiment.Experiment.sites`).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from tmlibrary_tpu_torch.errors import StoreError
from tmlibrary_tpu_torch.io import parquet
from tmlibrary_tpu_torch.models.experiment import Experiment, SiteRef

PIXEL_DTYPE = np.uint16
LABEL_DTYPE = np.int32


class ExperimentStore:
    """Filesystem-backed store for one experiment."""

    MANIFEST = "manifest.json"

    def __init__(self, root: Path, experiment: Experiment):
        self.root = Path(root)
        self.experiment = experiment
        self._site_index: dict[tuple, int] = {
            ref.as_tuple(): i for i, ref in enumerate(experiment.sites())
        }
        self._lock = threading.Lock()
        #: path -> (memmap, inode at open time); see _open_stack
        self._open_stacks: dict[Path, tuple[np.memmap, int]] = {}

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, root: Path, experiment: Experiment) -> "ExperimentStore":
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        experiment.save(root / cls.MANIFEST)
        for sub in (
            "images",
            "illumstats",
            "segmentations",
            "features",
            "alignment",
            "pyramids",
            "workflow",
            "tools",
        ):
            (root / sub).mkdir(exist_ok=True)
        return cls(root, experiment)

    @classmethod
    def open(cls, root: Path) -> "ExperimentStore":
        root = Path(root)
        manifest = root / cls.MANIFEST
        if not manifest.exists():
            raise StoreError(f"no experiment store at {root}")
        return cls(root, Experiment.load(manifest))

    # ----------------------------------------------------------- site lookup
    def site_linear_index(self, ref: SiteRef) -> int:
        try:
            return self._site_index[ref.as_tuple()]
        except KeyError:
            raise StoreError(f"site {ref} not in experiment manifest") from None

    @property
    def n_sites(self) -> int:
        return len(self._site_index)

    # ---------------------------------------------------------------- pixels
    def _plane_path(self, cycle: int, channel: int, tpoint: int, zplane: int) -> Path:
        return (
            self.root
            / "images"
            / f"cycle{cycle:02d}_channel{channel:02d}_t{tpoint:03d}_z{zplane:03d}.npy"
        )

    def _open_stack(self, path: Path, dtype, write: bool) -> np.memmap:
        """Open (or create, when writing) an ``(n_sites, H, W)`` site stack,
        guarding against shape mismatches from stale files written under a
        different manifest.

        The cache is validated against the file's current inode: a step's
        ``delete_previous_output`` may rmtree the directory while a memmap
        from an earlier run is still cached, and the open mapping keeps the
        unlinked inode alive — without the check, re-run writes would land
        in the deleted file and silently never appear on disk."""
        with self._lock:
            cached = self._open_stacks.get(path)
            if cached is not None:
                mm, ino = cached
                if write == (mm.mode in ("r+", "w+")):
                    try:
                        if path.stat().st_ino == ino:
                            return mm
                    except OSError:
                        pass  # deleted out from under the cache: reopen
                self._open_stacks.pop(path, None)
            exp = self.experiment
            shape = (self.n_sites, exp.site_height, exp.site_width)
            # inode is captured BEFORE the open: if the file is replaced
            # in the stat->open window, the recorded (old) inode mismatches
            # the path on the next call and we spuriously reopen — fail
            # safe.  stat-after-open would pin the replacement's inode to
            # the old mapping and silently lose writes under the same race.
            try:
                ino = path.stat().st_ino
            except OSError:
                ino = -1  # about to be created below
            if not path.exists():
                if not write:
                    raise StoreError(f"pixel plane missing: {path.name}")
                mm = np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)
                ino = path.stat().st_ino
            else:
                mm = np.lib.format.open_memmap(path, mode="r+" if write else "r")
                if mm.shape != shape or mm.dtype != dtype:
                    raise StoreError(
                        f"site stack {path.name} has shape {mm.shape} dtype "
                        f"{mm.dtype}, expected {shape} {np.dtype(dtype)}"
                    )
            self._open_stacks[path] = (mm, ino)
            return mm

    def _check_batch(self, arr: np.ndarray, site_indices: Sequence[int], what: str) -> None:
        exp = self.experiment
        expected = (len(site_indices), exp.site_height, exp.site_width)
        if arr.shape != expected:
            raise StoreError(
                f"{what} batch shape {arr.shape} does not match {expected} "
                f"({len(site_indices)} site indices x site shape)"
            )

    def _open_plane(
        self, cycle: int, channel: int, tpoint: int, zplane: int, write: bool
    ) -> np.memmap:
        return self._open_stack(
            self._plane_path(cycle, channel, tpoint, zplane), PIXEL_DTYPE, write
        )

    def write_sites(
        self,
        pixels: np.ndarray,
        site_indices: Sequence[int],
        cycle: int = 0,
        channel: int = 0,
        tpoint: int = 0,
        zplane: int = 0,
    ) -> None:
        """Write a batch of site planes; ``pixels`` is ``(B, H, W)`` uint16."""
        pixels = np.asarray(pixels)
        self._check_batch(pixels, site_indices, "pixels")
        mm = self._open_plane(cycle, channel, tpoint, zplane, write=True)
        mm[np.asarray(site_indices)] = pixels.astype(PIXEL_DTYPE, copy=False)

    def read_sites(
        self,
        site_indices: Sequence[int] | None = None,
        cycle: int = 0,
        channel: int = 0,
        tpoint: int = 0,
        zplane: int = 0,
    ) -> np.ndarray:
        """Read a batch of site planes as ``(B, H, W)`` uint16 (host array)."""
        mm = self._open_plane(cycle, channel, tpoint, zplane, write=False)
        if site_indices is None:
            return np.asarray(mm)
        return np.asarray(mm[np.asarray(site_indices)])

    def has_plane(
        self, cycle: int = 0, channel: int = 0, tpoint: int = 0, zplane: int = 0
    ) -> bool:
        return self._plane_path(cycle, channel, tpoint, zplane).exists()

    # ------------------------------------------------------------ illumstats
    def _illumstats_path(self, cycle: int, channel: int) -> Path:
        return self.root / "illumstats" / f"cycle{cycle:02d}_channel{channel:02d}.npz"

    def write_illumstats(
        self, stats: Mapping[str, np.ndarray], cycle: int = 0, channel: int = 0
    ) -> None:
        path = self._illumstats_path(cycle, channel)
        np.savez(path, **{k: np.asarray(v) for k, v in stats.items()})

    def read_illumstats(self, cycle: int = 0, channel: int = 0) -> dict[str, np.ndarray]:
        path = self._illumstats_path(cycle, channel)
        if not path.exists():
            raise StoreError(f"illumination statistics missing: {path.name}")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def has_illumstats(self, cycle: int = 0, channel: int = 0) -> bool:
        return self._illumstats_path(cycle, channel).exists()

    # --------------------------------------------------------- segmentations
    def _labels_path(self, objects_name: str, tpoint: int, zplane: int) -> Path:
        return (
            self.root
            / "segmentations"
            / f"{objects_name}_t{tpoint:03d}_z{zplane:03d}.npy"
        )

    def write_labels(
        self,
        labels: np.ndarray,
        site_indices: Sequence[int],
        objects_name: str,
        tpoint: int = 0,
        zplane: int = 0,
    ) -> None:
        labels = np.asarray(labels)
        self._check_batch(labels, site_indices, "labels")
        path = self._labels_path(objects_name, tpoint, zplane)
        mm = self._open_stack(path, LABEL_DTYPE, write=True)
        mm[np.asarray(site_indices)] = labels.astype(LABEL_DTYPE, copy=False)

    def read_labels(
        self,
        site_indices: Sequence[int] | None = None,
        objects_name: str = "objects",
        tpoint: int = 0,
        zplane: int = 0,
    ) -> np.ndarray:
        path = self._labels_path(objects_name, tpoint, zplane)
        if not path.exists():
            raise StoreError(f"label stack missing: {path.name}")
        mm = self._open_stack(path, LABEL_DTYPE, write=False)
        if site_indices is None:
            return np.asarray(mm)
        return np.asarray(mm[np.asarray(site_indices)])

    def has_labels(self, objects_name: str, tpoint: int = 0, zplane: int = 0) -> bool:
        return self._labels_path(objects_name, tpoint, zplane).exists()

    def list_objects(self) -> list[str]:
        names = set()
        for p in (self.root / "segmentations").glob("*_t*_z*.npy"):
            names.add(p.name.rsplit("_t", 1)[0])
        return sorted(names)

    # -------------------------------------------------------------- features
    def features_dir(self, objects_name: str) -> Path:
        d = self.root / "features" / objects_name
        d.mkdir(parents=True, exist_ok=True)
        return d

    def append_features(self, objects_name: str, table: Mapping[str, np.ndarray],
                        shard: str) -> Path:
        """Write one Parquet shard of the (objects x features) table, in
        the table's column order.

        ``table`` maps column name to a 1-D array (every column one row
        per object); ``shard`` names the shard (the batch id) so re-runs
        overwrite idempotently rather than duplicating."""
        path = self.features_dir(objects_name) / f"{shard}.parquet"
        try:
            return parquet.write_table(path, table)
        except parquet.ParquetError as e:
            raise StoreError(f"feature shard '{shard}': {e}") from None

    def read_features(self, objects_name: str) -> dict[str, np.ndarray]:
        """Every shard's columns concatenated in shard-name order, as a
        dict of numpy arrays in the first shard's column order."""
        shards = sorted(self.features_dir(objects_name).glob("*.parquet"))
        if not shards:
            raise StoreError(f"no feature shards for '{objects_name}'")
        parts = [parquet.read_table(p) for p in shards]
        names = list(parts[0])
        for p, part in zip(shards, parts):
            if list(part) != names:
                raise StoreError(f"feature shard {p.name} has columns {list(part)}, "
                                 f"expected {names}")
        return {k: np.concatenate([part[k] for part in parts]) for k in names}

    # ------------------------------------------------------------- alignment
    def write_shifts(self, shifts: np.ndarray, cycle: int) -> None:
        """``shifts``: (n_sites, 2) int32 (dy, dx) of this cycle vs cycle 0."""
        np.save(self.root / "alignment" / f"shifts_cycle{cycle:02d}.npy", shifts)

    def read_shifts(self, cycle: int) -> np.ndarray:
        path = self.root / "alignment" / f"shifts_cycle{cycle:02d}.npy"
        if not path.exists():
            raise StoreError(f"shifts missing for cycle {cycle}")
        return np.load(path)

    def has_shifts(self, cycle: int) -> bool:
        return (self.root / "alignment" / f"shifts_cycle{cycle:02d}.npy").exists()

    def write_intersection(self, window: Mapping[str, int]) -> None:
        (self.root / "alignment" / "intersection.json").write_text(json.dumps(dict(window)))

    def read_intersection(self) -> dict[str, int]:
        path = self.root / "alignment" / "intersection.json"
        if not path.exists():
            raise StoreError("intersection window missing")
        return json.loads(path.read_text())

    # --------------------------------------------------------------- weights
    @property
    def weights_dir(self) -> Path:
        """The experiment's model checkpoints (``.npz`` parameter dicts,
        :mod:`tmlibrary_tpu_torch.nn.weights`); a pipeline names one by
        path in its ``weights`` constant."""
        d = self.root / "weights"
        d.mkdir(exist_ok=True)
        return d

    def stage_weights(self, name: str, params: Mapping[str, np.ndarray],
                      meta: Mapping | None = None) -> Path:
        """Save a checkpoint into the experiment and return its ``.npz``
        path (usable as a module's ``weights`` spec)."""
        from tmlibrary_tpu_torch.nn import weights as nn_weights

        return nn_weights.save_weights(name, dict(params), meta=dict(meta) if meta else None,
                                       directory=self.weights_dir)

    # --------------------------------------------------------------- ledger
    @property
    def workflow_dir(self) -> Path:
        d = self.root / "workflow"
        d.mkdir(exist_ok=True)
        return d

    @property
    def tools_dir(self) -> Path:
        """Tool requests, their results and the query cache (``queries/``)."""
        d = self.root / "tools"
        d.mkdir(exist_ok=True)
        return d
