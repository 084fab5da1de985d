"""Tool base, registry, results and the request manager.

Counterpart: ``tmlibrary_tpu/tools/base.py``.  A tool reads one object
type's features through the feature store and returns a
:class:`ToolResult`: one row per object (the identity columns and a
``value``), attributes and plots.  A result is saved in the reference's
layout -- ``values.parquet`` (written by
:func:`~tmlibrary_tpu_torch.io.parquet.write_table`) and ``result.json``
-- so either package loads what the other saved.  ``values`` is a dict
of 1-D numpy arrays in column order (no pandas).

Tools run on a device (``Tool(store, device="cuda")``, the card unless
``cpu`` is asked for).  :class:`ToolRequestManager` records a request's
lifecycle in ``<store>/tools/<request>/request.json`` (``submitted`` ->
``running`` -> ``done`` | ``failed``) with the device it runs on;
:meth:`ToolRequestManager.submit_async` runs it as a detached
``tmx-torch tool run-request`` process.  ``request.json`` and
``result.json`` are replaced by rename (:mod:`~tmlibrary_tpu_torch.atomicio`),
so a reader polling a request that another process runs sees the old
state or the new one, never a half-written file.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Type

import numpy as np

from tmlibrary_tpu_torch.atomicio import atomic_write_text
from tmlibrary_tpu_torch.errors import RegistryError
from tmlibrary_tpu_torch.io import parquet
from tmlibrary_tpu_torch.models.store import ExperimentStore

_TOOLS: dict[str, Type["Tool"]] = {}


def register_tool(name: str):
    def deco(cls):
        cls.name = name
        _TOOLS[name] = cls
        return cls

    return deco


def get_tool(name: str) -> Type["Tool"]:
    try:
        return _TOOLS[name]
    except KeyError:
        raise RegistryError(f"no tool '{name}' registered (have: {sorted(_TOOLS)})") from None


def list_tools() -> list[str]:
    return sorted(_TOOLS)


def n_rows(values: dict) -> int:
    return len(next(iter(values.values()))) if values else 0


@dataclasses.dataclass
class ToolResult:
    """Per-object result layer: ``values`` holds one row per object (the
    identity columns and ``value``: a class id, cluster id or continuous
    value)."""

    tool: str
    objects_name: str
    layer_type: str  # "categorical" | "continuous"
    values: dict
    attributes: dict[str, Any] = dataclasses.field(default_factory=dict)
    plots: list["Plot"] = dataclasses.field(default_factory=list)

    def label_layer(self) -> "LabelLayer":
        """The viewer layer of this result."""
        if self.layer_type == "continuous":
            return ContinuousLabelLayer(self.objects_name, self.values)
        classes = self.attributes.get("classes")
        if classes is not None:
            return SupervisedClassifierLabelLayer(self.objects_name, self.values, classes)
        return ScalarLabelLayer(self.objects_name, self.values)

    def save(self, directory) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        parquet.write_table(d / "values.parquet", self.values)
        atomic_write_text(d / "result.json", json.dumps({
            "tool": self.tool,
            "objects_name": self.objects_name,
            "layer_type": self.layer_type,
            "attributes": self.attributes,
            "n_objects": n_rows(self.values),
            "plots": [{"type": p.type, "figure": p.figure} for p in self.plots],
        }, default=str))

    @classmethod
    def load(cls, directory) -> "ToolResult":
        """Inverse of :meth:`save` (the serving path of cached queries)."""
        d = Path(directory)
        meta = json.loads((d / "result.json").read_text())
        return cls(
            tool=meta["tool"],
            objects_name=meta["objects_name"],
            layer_type=meta["layer_type"],
            values=parquet.read_table(d / "values.parquet"),
            attributes=meta.get("attributes", {}),
            plots=[Plot(type=p["type"], figure=p["figure"]) for p in meta.get("plots", [])],
        )


@dataclasses.dataclass(eq=False)
class LabelLayer:
    """Viewer overlay mapping each object to a display value; ``mapping``
    holds the columns site_index, label and value."""

    objects_name: str
    mapping: dict
    type: str = "generic"

    def value_range(self) -> tuple[float, float]:
        v = np.asarray(self.mapping["value"])
        return float(v.min()), float(v.max())

    def export_site_values(self, store, directory, tpoint: int = 0, zplane: int = 0
                           ) -> list[Path]:
        """For every site holding mapped objects, ``<directory>/site_<n>.npz``
        with the site's label image (int32) and ``values`` (float32: each
        object's pixels carry its mapped value, background and unmapped
        objects NaN).  Returns the written paths."""
        out_dir = Path(directory)
        out_dir.mkdir(parents=True, exist_ok=True)
        written = []
        sites = np.asarray(self.mapping["site_index"])
        labels_col = np.asarray(self.mapping["label"], np.int64)
        values = np.asarray(self.mapping["value"], np.float32)
        for site_index in np.unique(sites):
            if site_index < 0:
                continue  # spatial-layout mosaic rows have no site frame
            mine = sites == site_index
            labels = store.read_labels([int(site_index)], self.objects_name,
                                       tpoint=tpoint, zplane=zplane)[0]
            lut = np.full(max(int(labels.max()), int(labels_col[mine].max())) + 1,
                          np.nan, np.float32)
            lut[labels_col[mine]] = values[mine]
            path = out_dir / f"site_{int(site_index):05d}.npz"
            np.savez_compressed(path, labels=np.asarray(labels, np.int32), values=lut[labels])
            written.append(path)
        return written


class ScalarLabelLayer(LabelLayer):
    """Discrete per-object values."""

    def __init__(self, objects_name: str, mapping: dict):
        super().__init__(objects_name, mapping, type="scalar")

    def unique_values(self) -> list:
        return sorted(np.unique(np.asarray(self.mapping["value"])).tolist())


class SupervisedClassifierLabelLayer(ScalarLabelLayer):
    """Predicted class per object, with the class names."""

    def __init__(self, objects_name: str, mapping: dict, classes: list[str]):
        super().__init__(objects_name, mapping)
        self.type = "supervised"
        self.classes = list(classes)


class ContinuousLabelLayer(LabelLayer):
    """Continuous per-object values (heatmaps, scores)."""

    def __init__(self, objects_name: str, mapping: dict):
        super().__init__(objects_name, mapping, type="continuous")


@dataclasses.dataclass
class Plot:
    """A serializable figure attached to a result: a JSON spec and its
    type tag."""

    type: str
    figure: dict[str, Any]

    def to_json(self) -> str:
        return json.dumps({"type": self.type, "figure": self.figure})

    @classmethod
    def from_json(cls, s: str) -> "Plot":
        d = json.loads(s)
        return cls(type=d["type"], figure=d["figure"])


class Tool(abc.ABC):
    """One analysis tool, run on ``device``."""

    name: str = "tool"

    def __init__(self, store: ExperimentStore, device: str = "cuda"):
        self.store = store
        self.device = device

    def feature_store(self, objects_name: str):
        """The experiment's feature store for ``objects_name`` (built on
        first touch, appended or rebuilt when the shards change)."""
        from tmlibrary_tpu_torch.analytics.store import FeatureStore

        return FeatureStore.ensure(self.store, objects_name)

    def load_feature_matrix(self, objects_name: str, features: list[str] | None = None
                            ) -> tuple[dict, np.ndarray, list[str]]:
        """(identity, standardized (N, F) float32 matrix, feature names),
        through the feature store."""
        return self.feature_store(objects_name).standardized(features)

    @abc.abstractmethod
    def process(self, payload: dict[str, Any]) -> ToolResult:
        """Handle one tool request."""


class ToolRequestManager:
    """Tool requests with a persisted lifecycle, run on ``device``."""

    def __init__(self, store: ExperimentStore, device: str = "cuda"):
        self.store = store
        self.device = device

    def _request_dir(self, request_id: str) -> Path:
        return self.store.tools_dir / request_id

    def _write_state(self, request_id: str, **updates: Any) -> dict:
        path = self._request_dir(request_id) / "request.json"
        state = json.loads(path.read_text()) if path.exists() else {}
        state.update(updates)
        atomic_write_text(path, json.dumps(state, default=str, sort_keys=True))
        return state

    def create_request(self, tool_name: str, payload: dict[str, Any]) -> str:
        get_tool(tool_name)  # unknown tools fail at submit, not in the job
        base = f"{tool_name}_{int(time.time() * 1000):x}"
        request_id = base
        for attempt in range(1, 1000):
            try:  # same-millisecond submissions must not share a dir
                self._request_dir(request_id).mkdir(parents=True, exist_ok=False)
                break
            except FileExistsError:
                request_id = f"{base}_{attempt}"
        self._write_state(request_id, tool=tool_name, payload=payload, state="submitted",
                          submitted_at=time.time(), device=str(self.device))
        return request_id

    def submit(self, tool_name: str, payload: dict[str, Any]) -> ToolResult:
        """Create the request, run it here and return the result."""
        return self.run_request(self.create_request(tool_name, payload))

    def submit_async(self, tool_name: str, payload: dict[str, Any]) -> str:
        """Run the request as a detached ``tmx-torch tool run-request``
        process (its output in ``<request>/tool.log``) and return its id."""
        request_id = self.create_request(tool_name, payload)
        with open(self._request_dir(request_id) / "tool.log", "w") as log:
            subprocess.Popen(
                [sys.executable, "-m", "tmlibrary_tpu_torch.cli", "tool", "run-request",
                 "--root", str(self.store.root), "--request", request_id,
                 "--device", str(self.device)],
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
            )
        return request_id

    def run_request(self, request_id: str) -> ToolResult:
        """Execute one submitted request on the device it records,
        updating its state."""
        req = json.loads((self._request_dir(request_id) / "request.json").read_text())
        self._write_state(request_id, state="running", started_at=time.time())
        try:
            tool = get_tool(req["tool"])(self.store, device=req.get("device", self.device))
            result = tool.process(req["payload"])
            result.save(self._request_dir(request_id))
        except Exception as exc:
            self._write_state(request_id, state="failed", finished_at=time.time(),
                              error=f"{type(exc).__name__}: {exc}")
            raise
        self._write_state(request_id, state="done", finished_at=time.time(),
                          layer_type=result.layer_type, n_objects=n_rows(result.values))
        return result

    def status(self, request_id: str) -> dict:
        path = self._request_dir(request_id) / "request.json"
        if not path.exists():
            # bare result dirs (no lifecycle record) report as done
            if (self._request_dir(request_id) / "result.json").exists():
                return {"request": request_id, "state": "done"}
            raise RegistryError(f"no tool request '{request_id}'")
        return {"request": request_id, **json.loads(path.read_text())}

    def list_requests(self) -> list[dict]:
        """Every request with its lifecycle state (the payload left out)."""
        out = []
        for d in sorted(self.store.tools_dir.iterdir()):
            meta = d / "request.json"
            if meta.exists():
                entry = {"request": d.name, **json.loads(meta.read_text())}
                entry.pop("payload", None)
                out.append(entry)
            elif (d / "result.json").exists():
                out.append({"request": d.name, "state": "done"})
        return out

    def list_results(self) -> list[dict]:
        out = []
        for d in sorted(self.store.tools_dir.iterdir()):
            meta = d / "result.json"
            if meta.exists():
                out.append({"request": d.name, **json.loads(meta.read_text())})
        return out
