"""Pipeline project management.

Counterpart: ``tmlibrary_tpu/jterator/project.py`` (reference
``tmlib/workflow/jterator/project.py``): the ``Project``
class owns a pipeline project directory on disk: the ``.pipe.yaml``
description plus one ``handles/<name>.handles.yaml`` per module instance,
and supports creating a skeleton project, adding/removing modules (with
auto-generated handle templates), renaming, and round-tripping the files
the reference's UI edits.

Handle templates are generated by introspecting the registered module's
Python signature (the reference ships static ``.handles.yaml`` templates
alongside each jtmodule): parameters without defaults become array input
handles (type inferred from the parameter name — ``mask`` → BinaryImage,
``label``/``objects`` → LabelImage, else IntensityImage), defaulted
parameters become typed constants, and output handles come from each
module's declared return keys.

The port reads and writes the project's files through
:mod:`tmlibrary_tpu_torch.yamlio` (the card's machine has no ``yaml``),
with the bytes the reference's ``yaml.safe_dump(..., sort_keys=False)``
writes, so a project written by either package loads in the other.
"""

from __future__ import annotations

import inspect
import shutil
from pathlib import Path
from typing import Any

from tmlibrary_tpu_torch import yamlio
from tmlibrary_tpu_torch.errors import PipelineDescriptionError
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.handles import (
    HandleCollection,
    InputHandle,
    OutputHandle,
)

PIPE_FILENAME = "pipeline.pipe.yaml"
HANDLES_DIR = "handles"
HANDLES_SUFFIX = ".handles.yaml"

#: module → list of (return_key, handle_type) output templates.  Modules not
#: listed fall back to a single IntensityImage output named after their
#: (single) return key.
_OUTPUT_SPECS: dict[str, list[tuple[str, str]]] = {
    "smooth": [("smoothed_image", "IntensityImage")],
    "threshold_manual": [("mask", "BinaryImage")],
    "threshold_otsu": [("mask", "BinaryImage")],
    "threshold_adaptive": [("mask", "BinaryImage")],
    "label": [("label_image", "LabelImage")],
    "fill": [("filled_mask", "BinaryImage")],
    "filter": [("filtered_label_image", "LabelImage")],
    "register_objects": [("objects", "SegmentedObjects")],
    "invert": [("inverted_image", "IntensityImage")],
    "rescale": [("rescaled_image", "IntensityImage")],
    "mask": [("masked_image", "IntensityImage")],
    "combine_masks": [("combined_mask", "BinaryImage")],
    "segment_primary": [("objects", "SegmentedObjects")],
    "detect_blobs": [("objects", "SegmentedObjects"),
                     ("centers", "LabelImage")],
    "segment_secondary": [("objects", "SegmentedObjects")],
    "segment_volume": [("objects", "SegmentedObjects")],
    "measure_intensity": [("measurements", "Measurement")],
    "measure_morphology": [("measurements", "Measurement")],
    "measure_texture": [("measurements", "Measurement")],
    "measure_zernike": [("measurements", "Measurement")],
    "measure_volume": [("measurements", "Measurement")],
    "project": [("projected_image", "IntensityImage")],
    "morphology": [("output_mask", "BinaryImage")],
    "filter_edges": [("filtered_image", "IntensityImage")],
    "separate_clumps": [("separated_label_image", "LabelImage")],
    "generate_volume_image": [("volume_image", "IntensityImage"),
                              ("depth_image", "IntensityImage"),
                              ("focus_image", "IntensityImage")],
    "expand_or_shrink": [("expanded_image", "LabelImage")],
    "expand": [("expanded_image", "LabelImage")],
    "shrink": [("shrunken_image", "LabelImage")],
    "clip": [("clipped_image", "IntensityImage")],
    "combine_channels": [("combined_image", "IntensityImage")],
    "mip": [("mip_image", "IntensityImage")],
}


def _array_type_for(param: str) -> str:
    low = param.lower()
    if "mask" in low:
        return "BinaryImage"
    if "label" in low or "objects" in low or "seed" in low:
        return "LabelImage"
    if "zstack" in low or "volume" in low:
        return "IntensityImage"
    return "IntensityImage"


def _constant_type_for(value: Any) -> str:
    if isinstance(value, bool):
        return "Boolean"
    if isinstance(value, (int, float)):
        return "Numeric"
    if isinstance(value, str):
        return "Character"
    if isinstance(value, (list, tuple)):
        return "Sequence"
    return "Character"


def _module_param_names(module: str, backend: str = "tpu") -> set[str]:
    """All keyword-bindable parameter names of a registered module —
    including optional None-default knobs the template omits."""
    from tmlibrary_tpu_torch.jterator.modules import get_module

    sig = inspect.signature(get_module(module, backend=backend))
    return {
        name
        for name, p in sig.parameters.items()
        if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
    }


def handles_template(module: str, backend: str = "tpu") -> HandleCollection:
    """Generate a default :class:`HandleCollection` for a registered module
    by introspecting its signature (reference: the static
    ``.handles.yaml`` template each jtmodule ships)."""
    from tmlibrary_tpu_torch.jterator.modules import get_module, get_module_version

    fn = get_module(module, backend=backend)
    sig = inspect.signature(fn)
    inputs: list[InputHandle] = []
    for name, p in sig.parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.default is inspect.Parameter.empty:
            inputs.append(
                InputHandle(name=name, type=_array_type_for(name), key=name)
            )
        elif p.default is not None:
            inputs.append(
                InputHandle(
                    name=name,
                    type=_constant_type_for(p.default),
                    value=list(p.default)
                    if isinstance(p.default, tuple)
                    else p.default,
                )
            )
        # None defaults are optional knobs — omitted from the template
    outputs = []
    for key, typ in _OUTPUT_SPECS.get(module, [(f"{module}_out", "IntensityImage")]):
        if typ == "SegmentedObjects":
            outputs.append(
                OutputHandle(name=key, type=typ, key=module, objects=module)
            )
        elif typ == "Measurement":
            outputs.append(OutputHandle(name=key, type=typ, objects="objects"))
        else:
            outputs.append(OutputHandle(name=key, type=typ, key=key))
    return HandleCollection(
        module=module,
        version=get_module_version(module, backend=backend),
        backend=backend,
        input=inputs,
        output=outputs,
    )


class Project:
    """A pipeline project directory: ``pipeline.pipe.yaml`` + ``handles/``.

    Reference: ``tmlib/workflow/jterator/project.py`` ``Project`` (create /
    remove / update of pipeline and handle files inside an experiment's
    jterator project folder).
    """

    def __init__(self, directory: Path):
        self.directory = Path(directory)

    # ------------------------------------------------------------ properties
    @property
    def pipe_path(self) -> Path:
        return self.directory / PIPE_FILENAME

    @property
    def handles_dir(self) -> Path:
        return self.directory / HANDLES_DIR

    @property
    def exists(self) -> bool:
        return self.pipe_path.exists()

    # -------------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, directory: Path, description: str = "") -> "Project":
        """Create a skeleton project (empty pipeline, handles dir)."""
        proj = cls(directory)
        if proj.exists:
            raise PipelineDescriptionError(
                f"project already exists at {proj.directory}"
            )
        proj.directory.mkdir(parents=True, exist_ok=True)
        proj.handles_dir.mkdir(exist_ok=True)
        proj._write_pipe(
            {
                "description": description,
                "input": {"channels": []},
                "pipeline": [],
                "output": {"objects": []},
            }
        )
        return proj

    def remove(self) -> None:
        """Delete the whole project directory (reference
        ``Project.remove``)."""
        shutil.rmtree(self.directory)

    # ------------------------------------------------------------------- io
    def _read_pipe(self) -> dict:
        if not self.exists:
            raise PipelineDescriptionError(f"no project at {self.directory}")
        return yamlio.load(self.pipe_path) or {}

    def _write_pipe(self, d: dict) -> None:
        yamlio.dump(d, self.pipe_path)

    # ---------------------------------------------------------------- channels
    def add_channel(self, name: str, correct: bool = True, align: bool = False,
                    zstack: bool = False) -> None:
        d = self._read_pipe()
        channels = d.setdefault("input", {}).setdefault("channels", [])
        if any(c["name"] == name for c in channels):
            raise PipelineDescriptionError(f"channel '{name}' already declared")
        entry: dict[str, Any] = {"name": name, "correct": correct, "align": align}
        if zstack:
            entry["zstack"] = True
        channels.append(entry)
        self._write_pipe(d)

    def add_output_objects(self, name: str, as_polygons: bool = True) -> None:
        d = self._read_pipe()
        objs = d.setdefault("output", {}).setdefault("objects", [])
        if any(o["name"] == name for o in objs):
            return
        objs.append({"name": name, "as_polygons": as_polygons})
        self._write_pipe(d)

    # ---------------------------------------------------------------- modules
    def module_names(self) -> list[str]:
        """Instance names (handle file stems) in pipeline order."""
        d = self._read_pipe()
        out = []
        for item in d.get("pipeline", []) or []:
            h = item.get("handles")
            if isinstance(h, str):
                out.append(Path(h).name.removesuffix(HANDLES_SUFFIX))
        return out

    def handles_path(self, instance: str) -> Path:
        return self.handles_dir / f"{instance}{HANDLES_SUFFIX}"

    def add_module(
        self,
        module: str,
        instance: str | None = None,
        position: int | None = None,
        backend: str = "tpu",
        **constants: Any,
    ) -> HandleCollection:
        """Append (or insert at ``position``) a module instance: generates
        its handles file from the signature template, overriding constant
        values with ``constants``."""
        instance = instance or module
        d = self._read_pipe()  # validate the project exists before writing
        if self.handles_path(instance).exists():
            raise PipelineDescriptionError(
                f"module instance '{instance}' already in project"
            )
        hc = handles_template(module, backend=backend)
        if constants:
            # validate against the full module signature: optional knobs
            # with None defaults are legal overrides even though the
            # template omits them
            known = _module_param_names(module, backend)
            unknown = set(constants) - known
            if unknown:
                raise PipelineDescriptionError(
                    f"unknown constants for module '{module}': {sorted(unknown)}"
                )

            def _override(h: InputHandle) -> InputHandle:
                if h.name not in constants:
                    return h
                if h.is_array:  # array handles rebind their store key
                    return InputHandle(name=h.name, type=h.type,
                                       key=str(constants[h.name]))
                return InputHandle(name=h.name, type=h.type,
                                   value=constants[h.name])

            hc.input = [_override(h) for h in hc.input]
            # None-default knobs aren't in the template — append them
            templated = {h.name for h in hc.input}
            for name in sorted(set(constants) - templated):
                hc.input.append(
                    InputHandle(
                        name=name,
                        type=_constant_type_for(constants[name]),
                        value=constants[name],
                    )
                )
        self.handles_dir.mkdir(exist_ok=True)
        hc.save(self.handles_path(instance))
        pipeline = d.setdefault("pipeline", [])
        entry = {"handles": f"{HANDLES_DIR}/{instance}{HANDLES_SUFFIX}",
                 "active": True}
        if position is None:
            pipeline.append(entry)
        else:
            pipeline.insert(position, entry)
        self._write_pipe(d)
        return hc

    def remove_module(self, instance: str) -> None:
        d = self._read_pipe()
        rel = f"{HANDLES_DIR}/{instance}{HANDLES_SUFFIX}"
        pipeline = [
            item for item in d.get("pipeline", []) or []
            if item.get("handles") != rel
        ]
        if len(pipeline) == len(d.get("pipeline", []) or []):
            raise PipelineDescriptionError(
                f"module instance '{instance}' not in pipeline"
            )
        d["pipeline"] = pipeline
        self._write_pipe(d)
        p = self.handles_path(instance)
        if p.exists():
            p.unlink()

    def set_active(self, instance: str, active: bool) -> None:
        """Enable/disable a module without removing its handles file."""
        d = self._read_pipe()
        rel = f"{HANDLES_DIR}/{instance}{HANDLES_SUFFIX}"
        for item in d.get("pipeline", []) or []:
            if item.get("handles") == rel:
                item["active"] = active
                self._write_pipe(d)
                return
        raise PipelineDescriptionError(f"module instance '{instance}' not in pipeline")

    def update_handles(self, instance: str, hc: HandleCollection) -> None:
        """Rewrite one instance's handles file (reference: the UI's
        save-handles endpoint)."""
        if not self.handles_path(instance).exists():
            raise PipelineDescriptionError(
                f"module instance '{instance}' not in project"
            )
        hc.save(self.handles_path(instance))

    def get_handles(self, instance: str) -> HandleCollection:
        return HandleCollection.load(self.handles_path(instance))

    # -------------------------------------------------------------- pipeline
    def description(self) -> PipelineDescription:
        """Parse the project into a validated
        :class:`PipelineDescription`."""
        desc = PipelineDescription.load(self.pipe_path)
        desc.validate()
        return desc
