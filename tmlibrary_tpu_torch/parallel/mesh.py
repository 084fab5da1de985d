"""The port's device mesh: the first ``n`` ranks of the process group.

Counterpart: ``tmlibrary_tpu/parallel/mesh.py:25-93``.  The reference
builds a ``jax.sharding.Mesh`` over the visible devices and shards the
leading (site) axis of every pixel stack over it.  Here each rank is one
device: a :class:`Mesh` names the first ``size`` ranks of the default
group, laid out as ``(n,)`` (one axis) or ``(rows, cols)``, and a rank
holds its own slice of the leading axis (:func:`shard_batch`) or its own
block of an image (:meth:`Mesh.block`).  Ranks beyond ``size`` are not
members: they skip the work, and a subgroup keeps them out of the
collectives.  Without a process group the only mesh is ``(1,)``.

``balanced_shard_order`` lives in
:mod:`tmlibrary_tpu_torch.workflow.schedule`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from tmlibrary_tpu_torch.errors import ShardingError
from tmlibrary_tpu_torch.parallel import distributed

#: subgroups by size, created collectively (every rank asks for the same
#: sizes in the same order, as it runs the same code)
_GROUPS: dict[int, object] = {}


def _group(size: int):
    """The process group of ranks ``0 .. size - 1`` (None: the default)."""
    world = distributed.world_size()
    if size == world:
        return None
    if size not in _GROUPS:
        _GROUPS[size] = dist.new_group(list(range(size)))
    return _GROUPS[size]


@dataclass(frozen=True)
class Mesh:
    """``shape`` ranks (``(n,)`` or ``(rows, cols)``); rank ``r`` sits at
    ``divmod(r, cols)``; ``group`` is their process group (None: the
    default group)."""

    shape: tuple[int, ...]
    group: object = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rank(self) -> int:
        return distributed.rank()

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def grid(self) -> tuple[int, int]:
        """``(rows, cols)``: a one-axis mesh is ``(n, 1)``."""
        return (self.shape[0], self.shape[1] if len(self.shape) > 1 else 1)

    def coords(self, rank: int | None = None) -> tuple[int, int]:
        """``(row, col)`` of ``rank`` (default: this rank)."""
        return divmod(self.rank if rank is None else rank, self.grid[1])

    def rank_at(self, row: int, col: int) -> int | None:
        """The rank at ``(row, col)``, None outside the mesh."""
        nr, nc = self.grid
        if 0 <= row < nr and 0 <= col < nc:
            return row * nc + col
        return None

    def check_divides(self, h: int, w: int) -> None:
        nr, nc = self.grid
        if h % nr or w % nc:
            raise ShardingError(f"image {h}x{w} not divisible by mesh {nr}x{nc}")

    def block_slices(self, h: int, w: int, rank: int | None = None) -> tuple[slice, slice]:
        """Rows and columns of ``rank``'s block of an ``(h, w)`` image."""
        self.check_divides(h, w)
        nr, nc = self.grid
        bh, bw = h // nr, w // nc
        r, c = self.coords(rank)
        return slice(r * bh, (r + 1) * bh), slice(c * bw, (c + 1) * bw)

    def block(self, image):
        """This rank's block of a full ``(..., h, w)`` image."""
        ys, xs = self.block_slices(*image.shape[-2:])
        return image[..., ys, xs]


def _mesh(shape: tuple[int, ...]) -> Mesh:
    size = int(np.prod(shape))
    world = distributed.world_size()
    if size < 1 or size > world:
        raise ShardingError(f"requested {size} devices, only {world} ranks in the group")
    return Mesh(tuple(int(s) for s in shape), _group(size))


def site_mesh(n_devices: int | None = None) -> Mesh:
    """A one-axis mesh over the first ``n_devices`` ranks (default: all)."""
    return _mesh((distributed.world_size() if n_devices is None else int(n_devices),))


def spatial_mesh(rows: int, cols: int = 1) -> Mesh:
    """A ``rows x cols`` mesh for a mosaic's blocks; ``cols=1`` shards the
    rows only, as the reference's one-axis ``("rows",)`` mesh."""
    return _mesh((rows,) if cols == 1 else (rows, cols))


def shard_batch(array, mesh: Mesh):
    """This rank's contiguous slice of a ``(B, ...)`` batch.  ``B`` must
    divide by the mesh size (the workflow pads batches upstream)."""
    n = mesh.size
    if array.shape[0] % n != 0:
        raise ShardingError(f"batch axis {array.shape[0]} not divisible by mesh size {n}")
    per = array.shape[0] // n
    return array[mesh.rank * per:(mesh.rank + 1) * per]
