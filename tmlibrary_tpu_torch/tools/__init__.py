"""Analysis tools over the feature store.

Counterpart: ``tmlibrary_tpu/tools/``: the ``Tool`` registry
(``classification``, ``clustering``, ``heatmap``, and the analytics
plane's ``knn``, ``pca``, ``embedding``, ``spatial``), ``ToolResult`` and
``ToolRequestManager``.  Tools run on the card unless ``cpu`` is asked
for.
"""

from tmlibrary_tpu_torch.tools.base import (
    Tool,
    ToolRequestManager,
    ToolResult,
    get_tool,
    list_tools,
    register_tool,
)
from tmlibrary_tpu_torch.tools import classification, clustering, heatmap  # noqa: F401
from tmlibrary_tpu_torch.analytics import tools as _analytics_tools  # noqa: F401,E402
# ^ registers knn/pca/embedding/spatial so every consumer of the registry
#   (tmx-torch tool, tmx-torch query) sees them

__all__ = [
    "Tool",
    "ToolResult",
    "ToolRequestManager",
    "register_tool",
    "get_tool",
    "list_tools",
]
