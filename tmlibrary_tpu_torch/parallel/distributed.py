"""The process group: bootstrap, rank slices, gathers and barriers.

Counterpart: ``tmlibrary_tpu/parallel/distributed.py:41-182``.  JAX runs
one process over a mesh of devices; PyTorch runs one process per card,
so the port's "cluster" is a ``torch.distributed`` process group: NCCL
on the card, gloo on the CPU.

- :func:`initialize` starts the group from explicit arguments or from
  ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``, ``LOCAL_RANK``); with neither it is a single-process
  no-op, so every entry point works unchanged without a group.
- :func:`local_site_slice` is the data plane: each rank reads only its
  contiguous range of sites.
- :func:`host_local_to_global` concatenates every rank's local batch in
  rank order (on every rank); :func:`global_to_host_local` is the
  inverse, this rank's rows.
- :func:`sync_hosts` is a barrier; :func:`broadcast_object` sends rank
  0's plan (a picklable object) to every rank.

The collective helpers below move a tensor to the CPU for a gloo group
and back, so callers hand them tensors on their own device.  The
reference's ``pod_mesh`` (a DCN/ICI hybrid layout) and
``parallel/compat.py`` (a JAX-version shim) have no counterpart: a
process group has no slice topology to lay out.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from tmlibrary_tpu_torch.errors import ShardingError

logger = logging.getLogger(__name__)


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: "str | torch.device" = "cuda",
) -> bool:
    """Start the process group; True when more than one rank runs.

    Without arguments the group comes from ``torchrun``'s environment;
    with no ``WORLD_SIZE`` (or ``WORLD_SIZE=1``) nothing starts.  The
    backend is NCCL for ``device="cuda"`` (each rank takes the card
    ``LOCAL_RANK``) and gloo for ``"cpu"``.  A partial configuration
    raises :class:`ShardingError` rather than running every rank alone
    over all sites."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if not world_size or world_size <= 1:
        logger.info("single-process run (no process group configured)")
        return False
    if rank is None:
        raise ShardingError(f"WORLD_SIZE={world_size} but no RANK: refusing to run "
                            "every process over all sites")
    if init_method is None:
        if not os.environ.get("MASTER_ADDR") or not os.environ.get("MASTER_PORT"):
            raise ShardingError(f"WORLD_SIZE={world_size} but MASTER_ADDR/MASTER_PORT "
                                "are not set: pass init_method or launch with torchrun")
        init_method = "env://"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    logger.info("process group up: rank %d of %d (%s)", rank, world_size, backend)
    return True


def shutdown() -> None:
    """Destroy the process group, when one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_writer() -> bool:
    """Whether this rank writes to the store: rank 0 only."""
    return rank() == 0


def clamp_devices(n_devices: int) -> int:
    """A step's ``n_devices`` argument against the group: 0 means every
    rank, and a request beyond the group shrinks to it (the reference
    clamps to ``len(jax.devices())`` the same way)."""
    n = int(n_devices or 0) or world_size()
    return max(1, min(n, world_size()))


def local_site_slice(n_sites: int, process_id: int | None = None,
                     n_processes: int | None = None) -> slice:
    """The contiguous site range this rank owns: ``ceil(n_sites / n)``
    sites each, the last rank the rest."""
    pid = rank() if process_id is None else process_id
    n = world_size() if n_processes is None else n_processes
    per = -(-n_sites // n)
    return slice(min(n_sites, pid * per), min(n_sites, (pid + 1) * per))


# ------------------------------------------------------------- collectives
def _gloo(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape everywhere), in rank order, on
    ``t``'s device."""
    dev = t.device
    src = t.contiguous()
    if _gloo(group) and src.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(dev) for p in parts]


def gather_to(t: torch.Tensor, dst: int = 0, group=None) -> "list[torch.Tensor] | None":
    """Every rank's ``t`` (same shape everywhere) in rank order on rank
    ``dst``, on ``t``'s device; None on the other ranks."""
    dev = t.device
    src = t.contiguous()
    if _gloo(group) and src.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))] \
        if rank() == dst else None
    dist.gather(src, parts, dst=dst, group=group)
    return None if parts is None else [p.to(dev) for p in parts]


def all_gather_rows(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` in rank order where only the leading dimension
    may differ between ranks (padded for the gather, trimmed after)."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [int(s) for s in all_gather(n, group)]
    top = max(sizes)
    padded = torch.zeros((top,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    padded[: t.shape[0]] = t
    return [p[:s] for p, s in zip(all_gather(padded, group), sizes)]


def all_reduce(t: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """``t`` reduced over the group (``op``: a ``dist.ReduceOp``, sum by
    default), returned on ``t``'s device."""
    op = dist.ReduceOp.SUM if op is None else op
    dev = t.device
    buf = t.detach().clone()
    if _gloo(group) and buf.is_cuda:
        buf = buf.cpu()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(dev)


def max_over_ranks(value: int, device: "torch.device | str" = "cpu", group=None) -> int:
    """The largest ``value`` over the ranks of the group."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    return int(all_reduce(t, dist.ReduceOp.MAX, group)[0])


def any_rank(flag: bool, device: "torch.device | str" = "cpu", group=None) -> bool:
    """Whether ``flag`` holds on any rank of the group."""
    return bool(max_over_ranks(1 if flag else 0, device, group))


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank; ``obj`` itself
    without a group."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def host_local_to_global(local_batch: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's local batch concatenated in rank order, on every rank
    (the reference assembles one globally sharded array)."""
    if world_size() == 1:
        return local_batch
    return torch.cat(all_gather_rows(local_batch, group), dim=0)


def global_to_host_local(global_batch: torch.Tensor, n_sites: int | None = None) -> torch.Tensor:
    """This rank's rows of a global batch (:func:`local_site_slice`)."""
    n = global_batch.shape[0] if n_sites is None else n_sites
    return global_batch[local_site_slice(n)]


def sync_hosts(name: str = "barrier") -> None:
    """Barrier over every rank (the reference waits for all jobs of a step
    before the next step starts)."""
    if world_size() > 1:
        logger.debug("sync_hosts: %s", name)
        dist.barrier()
