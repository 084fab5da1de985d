"""Typed module-I/O handles.

Counterpart: ``tmlibrary_tpu/jterator/handles.py`` (reference
``tmlib/workflow/jterator/handles.py``).  Same handle types, same
dataclasses, same dict form; ``validate_array`` checks torch dtypes.  Handles describe how a module's keyword arguments bind to the
pipeline store (``key``) or to constants (``value``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tmlibrary_tpu_torch.errors import HandleError

#: handle type names that bind pipeline-store arrays
IMAGE_TYPES = {"IntensityImage", "BinaryImage", "LabelImage"}
OBJECT_TYPES = {"SegmentedObjects"}
#: handle type names that bind constants
CONSTANT_TYPES = {"Numeric", "Scalar", "Character", "Boolean", "Sequence"}
#: output-only types
MEASUREMENT_TYPES = {"Measurement"}
#: plotting is host-side only in the reference; ignored on the device path
IGNORED_TYPES = {"Plot", "Figure"}

VALID_INPUT_TYPES = IMAGE_TYPES | OBJECT_TYPES | CONSTANT_TYPES | IGNORED_TYPES
VALID_OUTPUT_TYPES = IMAGE_TYPES | OBJECT_TYPES | MEASUREMENT_TYPES | IGNORED_TYPES

_UNSIGNED = {torch.uint8, torch.uint16, torch.uint32, torch.uint64}


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _check_intensity(name: str, arr: torch.Tensor) -> None:
    if not (arr.dtype in _UNSIGNED or arr.dtype.is_floating_point):
        raise HandleError(
            f"IntensityImage '{name}' expects unsigned-int or float pixels, "
            f"got {arr.dtype}"
        )


def _check_label(name: str, arr: torch.Tensor) -> None:
    if not _is_integer(arr.dtype):
        raise HandleError(
            f"LabelImage '{name}' expects integer labels, got {arr.dtype}"
        )


def _check_binary(name: str, arr: torch.Tensor) -> None:
    if not (arr.dtype == torch.bool or _is_integer(arr.dtype)):
        raise HandleError(
            f"BinaryImage '{name}' expects bool/integer mask, got {arr.dtype}"
        )


#: per-type array validators (reference: per-class setter checks)
_ARRAY_CHECKS = {
    "IntensityImage": _check_intensity,
    "LabelImage": _check_label,
    "BinaryImage": _check_binary,
    "SegmentedObjects": _check_label,
}


@dataclasses.dataclass(frozen=True)
class InputHandle:
    """Binds one module kwarg to a store entry or constant."""

    name: str
    type: str
    key: str | None = None  # pipeline-store key (array input)
    value: Any = None  # constant

    def __post_init__(self):
        if self.type not in VALID_INPUT_TYPES:
            raise HandleError(f"invalid input handle type '{self.type}'")
        if self.type in CONSTANT_TYPES:
            if self.value is None:
                raise HandleError(f"constant handle '{self.name}' needs a value")
        elif self.type in IMAGE_TYPES | OBJECT_TYPES:
            if not self.key:
                raise HandleError(f"image handle '{self.name}' needs a key")

    @property
    def is_constant(self) -> bool:
        return self.type in CONSTANT_TYPES

    @property
    def is_array(self) -> bool:
        return self.type in IMAGE_TYPES | OBJECT_TYPES

    def validate_array(self, arr: torch.Tensor) -> None:
        """dtype check at bind time: a wrong-kind pixel array is refused
        here instead of failing deep inside a module."""
        check = _ARRAY_CHECKS.get(self.type)
        if check is not None:
            check(self.name, arr)


@dataclasses.dataclass(frozen=True)
class OutputHandle:
    """Binds one module output to a store entry / object registry / features.

    - image types: ``key`` names the store entry written.
    - ``SegmentedObjects``: ``key`` names the label-image store entry AND
      ``objects`` names the registered object type.
    - ``Measurement``: ``objects`` names the object type the per-object
      values attach to; ``channel`` optionally records the intensity source.
    """

    name: str
    type: str
    key: str | None = None
    objects: str | None = None
    channel: str | None = None

    def __post_init__(self):
        if self.type not in VALID_OUTPUT_TYPES:
            raise HandleError(f"invalid output handle type '{self.type}'")
        if self.type in IMAGE_TYPES and not self.key:
            raise HandleError(f"image output '{self.name}' needs a key")
        if self.type in OBJECT_TYPES and not (self.key and self.objects):
            raise HandleError(
                f"objects output '{self.name}' needs both key and objects"
            )
        if self.type in MEASUREMENT_TYPES and not self.objects:
            raise HandleError(f"measurement output '{self.name}' needs objects")


@dataclasses.dataclass
class HandleCollection:
    """All handles of one module instance + backend/version metadata."""

    module: str  # registered module name (e.g. "smooth")
    version: str | None = None
    backend: str = "tpu"
    input: list[InputHandle] = dataclasses.field(default_factory=list)
    output: list[OutputHandle] = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "HandleCollection":
        inputs = [
            InputHandle(
                name=h["name"],
                type=h["type"],
                key=h.get("key"),
                value=h.get("value"),
            )
            for h in d.get("input", [])
        ]
        outputs = [
            OutputHandle(
                name=h["name"],
                type=h["type"],
                key=h.get("key"),
                objects=h.get("objects"),
                channel=h.get("channel"),
            )
            for h in d.get("output", [])
        ]
        if "module" not in d:
            raise HandleError("handle collection needs a 'module' name")
        return cls(
            module=d["module"],
            version=d.get("version"),
            backend=d.get("backend", "tpu"),
            input=inputs,
            output=outputs,
        )

    def constants(self) -> dict[str, Any]:
        return {h.name: h.value for h in self.input if h.is_constant}

    def array_inputs(self) -> dict[str, str]:
        """kwarg name → store key for array inputs."""
        return {h.name: h.key for h in self.input if h.is_array}
