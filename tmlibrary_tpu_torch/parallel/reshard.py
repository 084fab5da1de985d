"""All-to-all resharding between the site axis and the row axis.

Counterpart: ``tmlibrary_tpu/parallel/reshard.py:30-79``.  With ``n``
ranks, :func:`sites_to_rows` turns this rank's ``(B/n, H, W)`` sites into
every site's row band ``rank``, ``(B, H/n, W)``; :func:`rows_to_sites`
is the exact inverse.  One ``all_to_all`` each, as the reference's
``lax.all_to_all``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tmlibrary_tpu_torch.errors import ShardingError
from tmlibrary_tpu_torch.parallel.mesh import Mesh


def _check(b: int, h: int, n: int) -> None:
    if b % n:
        raise ShardingError(f"site axis {b} not divisible by mesh size {n}")
    if h % n:
        raise ShardingError(f"row axis {h} not divisible by mesh size {n}")


def _all_to_all(chunks: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    dev = chunks[0].device
    gloo = dist.get_backend(mesh.group) == "gloo"
    send = [c.contiguous().cpu() if gloo else c.contiguous() for c in chunks]
    recv = [torch.empty_like(c) for c in send]
    dist.all_to_all(recv, send, group=mesh.group)
    return [r.to(dev) for r in recv]


def sites_to_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(B/n, H, W)`` sites of this rank -> ``(B, H/n, W)``: every site's
    row band of this rank."""
    n = mesh.size
    _check(block.shape[0] * n, block.shape[1], n)
    if n == 1:
        return block
    return torch.cat(_all_to_all(list(block.chunk(n, dim=1)), mesh), dim=0)


def rows_to_sites(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(B, H/n, W)`` row bands of this rank -> ``(B/n, H, W)``: this
    rank's sites, whole."""
    n = mesh.size
    _check(block.shape[0], block.shape[1] * n, n)
    if n == 1:
        return block
    return torch.cat(_all_to_all(list(block.chunk(n, dim=0)), mesh), dim=1)
