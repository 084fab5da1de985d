"""The parallel layer on ``torch.distributed``: a mesh of ranks, halo
exchange over a spatially sharded mosaic, distributed connected
components and watershed, the sharded Welford and all-to-all resharding.

Counterpart: ``tmlibrary_tpu/parallel/``.  JAX runs one process over a
mesh of devices (``shard_map``, ``ppermute``, ``psum``); PyTorch runs one
process per card, so the port's mesh is the first ``n`` ranks of a
process group (NCCL on the card, gloo on the CPU) and the reference's
collectives become ``all_gather``, ``all_reduce`` and ``all_to_all`` on
the blocks' edge bands and small tables.  At one rank every sharded
function calls the single-device op on the whole image.
"""

from tmlibrary_tpu_torch.parallel.distributed import initialize
from tmlibrary_tpu_torch.parallel.halo import sharded_gaussian_smooth
from tmlibrary_tpu_torch.parallel.mesh import Mesh, shard_batch, site_mesh, spatial_mesh
from tmlibrary_tpu_torch.parallel.reshard import rows_to_sites, sites_to_rows
from tmlibrary_tpu_torch.parallel.stats import sharded_channel_stats

__all__ = [
    "Mesh",
    "initialize",
    "rows_to_sites",
    "shard_batch",
    "sharded_channel_stats",
    "sharded_gaussian_smooth",
    "site_mesh",
    "sites_to_rows",
    "spatial_mesh",
]
