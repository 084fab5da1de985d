"""Built-in workflow steps of the port: ``corilla`` (illumination
statistics), ``align`` (cycle registration) and ``jterator`` (image
analysis, sites layout).  Importing this package registers them."""

from tmlibrary_tpu_torch.workflow.steps import align, corilla, jterator  # noqa: F401
