"""Workflow steps and engine of the port.

Counterpart: ``tmlibrary_tpu/workflow/``: the step API
(:mod:`~tmlibrary_tpu_torch.workflow.api`), typed arguments, the step
registry, the pipelined executor, the work-aware schedule and the
``Workflow`` engine with its run ledger
(:mod:`~tmlibrary_tpu_torch.workflow.engine`).
"""

from tmlibrary_tpu_torch.workflow.registry import get_step, list_steps, register_step

__all__ = ["get_step", "list_steps", "register_step"]
