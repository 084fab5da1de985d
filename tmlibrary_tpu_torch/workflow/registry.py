"""Step registry of the port.

Counterpart: ``tmlibrary_tpu/workflow/registry.py``; the port's steps
register here, apart from the JAX package's.  Reference parity: ``tmlib/workflow/__init__.py`` — ``register_step_api`` /
``get_step_api`` / ``get_step_args``: steps self-register under their CLI
name so the workflow engine and CLI can instantiate them by name.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Type

from tmlibrary_tpu_torch.errors import RegistryError

if TYPE_CHECKING:
    from tmlibrary_tpu_torch.workflow.api import Step

_STEPS: dict[str, Type["Step"]] = {}


def register_step(name: str):
    def deco(cls):
        cls.name = name
        _STEPS[name] = cls
        return cls

    return deco


def get_step(name: str) -> Type["Step"]:
    _ensure_loaded()
    try:
        return _STEPS[name]
    except KeyError:
        raise RegistryError(
            f"no step '{name}' registered (have: {sorted(_STEPS)})"
        ) from None


def list_steps() -> list[str]:
    _ensure_loaded()
    return sorted(_STEPS)


def _ensure_loaded() -> None:
    """Import the built-in step modules so their decorators run."""
    from tmlibrary_tpu_torch.workflow import steps  # noqa: F401
