"""Workflow steps of the port.

Counterpart: ``tmlibrary_tpu/workflow/``: the step API
(:mod:`~tmlibrary_tpu_torch.workflow.api`), typed arguments, the step
registry, the pipelined executor and the work-aware schedule.  The
``Workflow`` engine with its run ledger is not ported yet: each step is
driven through its own verbs (``init``, ``run``/``run_batches_pipelined``,
``collect``).
"""

from tmlibrary_tpu_torch.workflow.registry import get_step, list_steps, register_step

__all__ = ["get_step", "list_steps", "register_step"]
