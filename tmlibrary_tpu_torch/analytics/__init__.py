"""The analytics plane of the port: feature store, kNN/IVF, PCA, spectral
embedding, spatial statistics and digest-cached queries.

Counterpart: ``tmlibrary_tpu/analytics/``.  A columnar, content-digested
feature store over the jterator Parquet shards (``store.py``), brute-force
and IVF kNN, randomized PCA and the kNN-graph spectral embedding
(``ops.py``, ``index.py``), integral-image spatial statistics
(``spatial.py``), four registered tools (``tools.py``) and the query path
behind ``tmx-torch query`` (``query.py``).  The reference leaves all of it
to XLA; the port runs it in PyTorch on the card (no kernel of its own),
with JAX's random draws reproduced in ``rng.py``.
"""

from tmlibrary_tpu_torch.analytics import ops, spatial  # noqa: F401
from tmlibrary_tpu_torch.analytics import tools as _tools  # noqa: F401 (registers)
from tmlibrary_tpu_torch.analytics.query import (  # noqa: F401
    QUERY_TOOLS,
    canonical_payload,
    query_key,
    run_query,
)
from tmlibrary_tpu_torch.analytics.store import FeatureStore  # noqa: F401

__all__ = [
    "FeatureStore",
    "run_query",
    "query_key",
    "canonical_payload",
    "QUERY_TOOLS",
    "ops",
    "spatial",
]
