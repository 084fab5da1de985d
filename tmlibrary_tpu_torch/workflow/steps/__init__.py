"""Built-in workflow steps of the port, the canonical workflow's five
and ``align``: ``metaconfig`` (metadata from the microscope's files),
``imextract`` (planes into the store), ``corilla`` (illumination
statistics), ``align`` (cycle registration), ``illuminati`` (pyramid
tiles) and ``jterator`` (image analysis, sites layout).  Importing this
package registers them."""

from tmlibrary_tpu_torch.workflow.steps import (  # noqa: F401
    align,
    corilla,
    illuminati,
    imextract,
    jterator,
    metaconfig,
)
