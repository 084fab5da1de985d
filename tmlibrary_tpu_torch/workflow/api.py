"""Step API base: plan / run / collect.

Counterpart: ``tmlibrary_tpu/workflow/api.py`` (reference
``tmlib/workflow/api.py`` ``ClusterRoutines``): every step implements
``create_batches`` (plan), ``run_batch`` (per-batch work), ``collect``
(merge) and ``delete_previous_output`` (idempotent re-runs); batch
descriptions are ``workflow/<step>/batch_NNN.json`` files in the store,
the same files the JAX package writes.

A port step runs its device work on ``device``: ``"cuda"`` unless the
caller passes ``"cpu"`` (:func:`~tmlibrary_tpu_torch.device.resolve_device`,
which raises :class:`~tmlibrary_tpu_torch.errors.DeviceError` when the
card is absent)."""

from __future__ import annotations

import abc
import contextlib
import json
import logging
import shutil
from pathlib import Path
from typing import Any

import torch

from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import JobDescriptionError
from tmlibrary_tpu_torch.models.store import ExperimentStore
from tmlibrary_tpu_torch.parallel import distributed
from tmlibrary_tpu_torch.workflow.args import ArgumentCollection

logger = logging.getLogger(__name__)


class Step(abc.ABC):
    """Base class for workflow steps (reference ``ClusterRoutines``)."""

    #: set by @register_step
    name: str = "step"
    #: override with the step's typed arguments
    batch_args: ArgumentCollection = ArgumentCollection()
    #: whether every rank of a process group runs the step's batches
    #: (their collectives pair up; only rank 0 writes), rather than rank 0
    #: alone
    collective: bool = False

    def __init__(self, store: ExperimentStore, device: "str | torch.device" = "cuda"):
        self.store = store
        self.device = resolve_device(device)

    # ------------------------------------------------------------- locations
    @property
    def step_dir(self) -> Path:
        d = self.store.workflow_dir / self.name
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _batch_path(self, index: int) -> Path:
        return self.step_dir / f"batch_{index:03d}.json"

    # ----------------------------------------------------------------- plan
    @abc.abstractmethod
    def create_batches(self, args: dict[str, Any]) -> list[dict]:
        """Plan run batches from resolved arguments (reference
        ``create_run_batches``).  Each batch must be JSON-serializable."""

    def init(self, args: dict[str, Any] | None = None) -> list[dict]:
        """Resolve args, plan batches, persist them (CLI verb ``init``)."""
        resolved = self.batch_args.resolve(args)
        self.delete_previous_output()
        batches = self.create_batches(resolved)
        for old in self.step_dir.glob("batch_*.json"):
            old.unlink()
        for i, batch in enumerate(batches):
            batch = dict(batch)
            batch["index"] = i
            batch["args"] = resolved
            self._batch_path(i).write_text(json.dumps(batch))
        logger.info("%s: planned %d batches", self.name, len(batches))
        return batches

    def load_batch(self, index: int) -> dict:
        path = self._batch_path(index)
        if not path.exists():
            raise JobDescriptionError(
                f"no batch {index} for step '{self.name}' — run init first"
            )
        return json.loads(path.read_text())

    def list_batches(self) -> list[int]:
        return sorted(
            int(p.stem.split("_")[1]) for p in self.step_dir.glob("batch_*.json")
        )

    # ------------------------------------------------------------------ run
    @abc.abstractmethod
    def run_batch(self, batch: dict) -> dict:
        """Execute one batch; return a JSON-serializable result summary
        (reference ``run_job``)."""

    def run(self, index: int) -> dict:
        batch = self.load_batch(index)
        with self.capture_logs(f"batch_{index:03d}"):
            result = self.run_batch(batch)
        return result or {}

    @contextlib.contextmanager
    def capture_logs(self, name: str):
        """Capture framework logging to ``<step_dir>/logs/<name>.log`` for
        the duration (reference parity: per-job stdout/stderr files in the
        experiment workflow dir, surfaced by the ``log`` CLI verb —
        SURVEY.md §6 observability row).  Rank 0 alone writes the file."""
        if not distributed.is_writer():
            yield
            return
        log_dir = self.step_dir / "logs"
        log_dir.mkdir(parents=True, exist_ok=True)
        # mode="w": each capture is one run — appending would interleave a
        # re-run's lines with the previous (possibly failed) run's
        handler = logging.FileHandler(log_dir / f"{name}.log", mode="w")
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
        handler.setLevel(logging.DEBUG)
        # the package logger's level (WARNING at default CLI verbosity)
        # filters records before any handler sees them — open it to DEBUG
        # for the capture window so the file gets the full INFO trail,
        # while pinning the existing console handlers to the previous
        # effective level so terminal verbosity is unchanged
        pkg = logging.getLogger("tmlibrary_tpu_torch")
        prev_level = pkg.level
        effective = pkg.getEffectiveLevel()
        pinned = [(h, h.level) for h in pkg.handlers]
        for h, _ in pinned:
            h.setLevel(max(h.level, effective))
        pkg.setLevel(logging.DEBUG)
        pkg.addHandler(handler)
        try:
            yield
        finally:
            pkg.removeHandler(handler)
            handler.close()
            for h, lvl in pinned:
                h.setLevel(lvl)
            pkg.setLevel(prev_level)

    # -------------------------------------------------------------- collect
    def collect(self, results: list[dict] | None = None) -> dict:
        """Merge phase after all batches ran (reference ``collect_job``).
        Default: nothing to merge.

        Steps that declare a ``results`` parameter receive the batch
        result summaries that survived the run, so a merge that assumes
        completeness can check instead of silently producing a short
        table."""
        return {}

    # ----------------------------------------------------------- idempotence
    def delete_previous_output(self) -> None:
        """Remove this step's previous outputs so re-runs are idempotent
        (reference ``delete_previous_job_output``).  Default: nothing."""

    # ------------------------------------------------------------- utilities
    def _clear_dir(self, path: Path) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
