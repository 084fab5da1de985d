"""Typed step-argument system.

Counterpart: ``tmlibrary_tpu/workflow/args.py``, the same descriptors, so
a step's ``to_schema()`` and a resolved ``batch_*.json`` read the same in
both packages.  Reference parity: ``tmlib/workflow/args.py`` — ``Argument`` descriptors
(type, default, choices, help) grouped into ``BatchArguments`` /
``SubmissionArguments`` per step, introspected to build both the CLI and
the server's UI forms.  Here the same descriptors drive argparse and the
workflow-description YAML; "submission" arguments (cores/memory/walltime)
have no meaning without a cluster scheduler and are dropped.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Argument:
    """One typed step argument."""

    name: str
    type: type
    default: Any = None
    help: str = ""
    choices: tuple | None = None
    required: bool = False


class ArgumentCollection:
    """A step's argument set; builds argparse options and validates dicts."""

    def __init__(self, *args: Argument):
        self._args = {a.name: a for a in args}

    def __iter__(self):
        return iter(self._args.values())

    def names(self) -> list[str]:
        return list(self._args)

    def to_schema(self) -> list[dict]:
        """JSON-able description of every argument (name, type, default,
        choices, help) — the introspection surface the reference uses to
        render per-step UI forms (``tmlib/workflow/args.py`` exposes the
        same metadata to tmserver)."""
        return [
            {
                "name": a.name,
                "type": a.type.__name__,
                "default": a.default,
                "required": a.required,
                "help": a.help,
                "choices": list(a.choices) if a.choices else None,
            }
            for a in self._args.values()
        ]

    def add_to_parser(self, parser: argparse.ArgumentParser) -> None:
        for a in self._args.values():
            kwargs: dict[str, Any] = {"help": a.help, "default": a.default}
            if a.type is bool:
                kwargs["action"] = argparse.BooleanOptionalAction
            else:
                kwargs["type"] = a.type
            if a.choices:
                kwargs["choices"] = list(a.choices)
            if a.required:
                kwargs["required"] = True
            parser.add_argument(f"--{a.name.replace('_', '-')}", dest=a.name, **kwargs)

    def resolve(self, given: dict[str, Any] | None) -> dict[str, Any]:
        """Merge ``given`` over defaults, rejecting unknown keys and
        validating choices."""
        given = dict(given or {})
        out: dict[str, Any] = {}
        for a in self._args.values():
            if a.name in given:
                val = given.pop(a.name)
                if val is not None and a.type is not bool:
                    val = a.type(val)
                if a.choices and val not in a.choices:
                    raise ValueError(
                        f"argument '{a.name}' must be one of {a.choices}, got {val!r}"
                    )
                out[a.name] = val
            elif a.required:
                raise ValueError(f"argument '{a.name}' is required")
            else:
                out[a.name] = a.default
        if given:
            raise ValueError(f"unknown arguments: {sorted(given)}")
        return out
