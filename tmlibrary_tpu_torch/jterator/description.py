"""Pipeline description (the ``.pipe.yaml`` file).

Counterpart: ``tmlibrary_tpu/jterator/description.py`` (reference
``tmlib/workflow/jterator/description.py``).  Same schema and validation.
``yaml`` is imported only on the file-reading path, so
:meth:`PipelineDescription.from_dict` works on hosts without PyYAML.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from tmlibrary_tpu_torch.errors import PipelineDescriptionError
from tmlibrary_tpu_torch.jterator.handles import HandleCollection


@dataclasses.dataclass(frozen=True)
class ChannelInput:
    name: str
    correct: bool = True
    align: bool = False
    #: load the channel as a (Z, H, W) z-stack volume instead of one plane
    zstack: bool = False


@dataclasses.dataclass(frozen=True)
class ObjectInput:
    """A previously-segmented object type loaded from the store."""

    name: str


@dataclasses.dataclass(frozen=True)
class ObjectOutput:
    name: str
    as_polygons: bool = True


def _read_yaml(path: Path):
    import yaml

    return yaml.safe_load(Path(path).read_text())


@dataclasses.dataclass
class PipelineDescription:
    """Parsed ``.pipe.yaml`` plus its resolved handle collections."""

    description: str
    channels: list[ChannelInput]
    objects_in: list[ObjectInput]
    modules: list[HandleCollection]
    objects_out: list[ObjectOutput]

    @classmethod
    def from_dict(cls, d: dict, base_dir: Path | None = None) -> "PipelineDescription":
        inp = d.get("input", {}) or {}
        channels = [
            ChannelInput(
                name=c["name"],
                correct=bool(c.get("correct", True)),
                align=bool(c.get("align", False)),
                zstack=bool(c.get("zstack", False)),
            )
            for c in inp.get("channels", []) or []
        ]
        objects_in = [ObjectInput(name=o["name"]) for o in inp.get("objects", []) or []]
        modules: list[HandleCollection] = []
        for item in d.get("pipeline", []) or []:
            if not item.get("active", True):
                continue
            if "handles" in item and isinstance(item["handles"], str):
                if base_dir is None:
                    raise PipelineDescriptionError(
                        "handles given as a path but no base_dir provided"
                    )
                hpath = base_dir / item["handles"]
                if not hpath.exists():
                    raise PipelineDescriptionError(f"handles file missing: {hpath}")
                hd = _read_yaml(hpath)
            elif "handles" in item:
                hd = item["handles"]  # inline dict
            else:
                raise PipelineDescriptionError("pipeline item needs 'handles'")
            if not isinstance(hd, dict):
                raise PipelineDescriptionError(
                    f"handles for {item.get('source') or item.get('handles')!r}"
                    f" must be a mapping, got {type(hd).__name__}"
                    " (empty or malformed handles file?)"
                )
            # reference compat: upstream .pipe.yaml names the module via
            # ``source: [python/jtmodules/]<name>.py``; an explicit
            # ``module`` in the handles dict still wins
            if "module" not in hd and item.get("source"):
                src = str(item["source"]).replace("\\", "/").rsplit("/", 1)[-1]
                stem, dot, ext = src.rpartition(".")
                if dot and ext.lower() in ("m", "r", "jl"):
                    raise PipelineDescriptionError(
                        f"non-Python module source '{item['source']}': "
                        "Matlab/R bridges are out of scope"
                    )
                hd = {**hd, "module": stem if dot else src}
            modules.append(HandleCollection.from_dict(hd))
        out = d.get("output", {}) or {}
        objects_out = [
            ObjectOutput(name=o["name"], as_polygons=bool(o.get("as_polygons", True)))
            for o in out.get("objects", []) or []
        ]
        if not modules:
            raise PipelineDescriptionError("pipeline has no active modules")
        return cls(
            description=d.get("description", ""),
            channels=channels,
            objects_in=objects_in,
            modules=modules,
            objects_out=objects_out,
        )

    @classmethod
    def load(cls, pipe_path: Path) -> "PipelineDescription":
        pipe_path = Path(pipe_path)
        return cls.from_dict(_read_yaml(pipe_path), base_dir=pipe_path.parent)

    def validate(self) -> None:
        """Check store-key dataflow: every module input key must be produced
        by an earlier module or be an input channel/object."""
        available = {c.name for c in self.channels} | {o.name for o in self.objects_in}
        for mod in self.modules:
            for name, key in mod.array_inputs().items():
                if key not in available:
                    raise PipelineDescriptionError(
                        f"module '{mod.module}' input '{name}' reads key "
                        f"'{key}' which no upstream produces "
                        f"(available: {sorted(available)})"
                    )
            for h in mod.output:
                if h.key:
                    available.add(h.key)
                if h.type == "SegmentedObjects" and h.objects:
                    available.add(h.objects)
        produced_objects = {
            h.objects
            for mod in self.modules
            for h in mod.output
            if h.type == "SegmentedObjects"
        }
        for obj in self.objects_out:
            if obj.name not in produced_objects:
                raise PipelineDescriptionError(
                    f"output objects '{obj.name}' never registered by any module"
                )
