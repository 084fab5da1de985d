"""3-D (z-stack) segmentation: CUDA kernels, their plain versions and the
ops around them.

Counterpart: ``tmlibrary_tpu/ops/volume.py`` (``shift3d``,
``connected_components_3d`` with its scipy-order compaction,
``propagate_labels_3d``, ``watershed_from_seeds_3d``, ``volume_features``) and the TPU kernels
``cc3d_min_propagate`` (``_cc3d_kernel``) and ``watershed3d_flood``
(``_watershed3d_kernel``) of ``tmlibrary_tpu/ops/pallas_kernels.py``.
The Hopper kernels are ``tmlibrary_tpu_torch/csrc/{cc3d_min_propagate,
watershed3d_flood}.cu`` (design and bounds in each source's header).

Volumes are batches ``(B, Z, H, W)``.  The wrappers dispatch on the
tensor's device as in :mod:`.kernels`: a CPU tensor goes to the
``*_plain`` version, a CUDA tensor to the kernel, which launches or
raises.  Each wrapper counts its kernel launches in ``.launches``.
The 3-D flood has two routes, picked by :func:`watershed3d_plan` before
the launch: ``"cluster"`` (the frontier flood, one thread-block cluster
a volume) and ``"global"`` (the first design, for more than 254 levels);
its wrapper counts launches by route in ``.routes``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tmlibrary_tpu_torch.ops._cuda import bind_launch
from tmlibrary_tpu_torch.ops._exact import div, sqrt
from tmlibrary_tpu_torch.ops.kernels import (
    BIG, CC_PHASES, FloodPlan, _fixpoint, watershed_levels,
)
from tmlibrary_tpu_torch.ops.label import compact_roots
from tmlibrary_tpu_torch.ops.measure import grouped_sums


def neighbor_shifts_3d(connectivity: int) -> list[tuple[int, int, int]]:
    """Offsets of the 6 (faces), 18 (faces and edges) or 26 (full cube)
    neighbourhood."""
    if connectivity not in (6, 18, 26):
        raise ValueError("3-D connectivity must be 6, 18 or 26")
    out = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nonzero = (dz != 0) + (dy != 0) + (dx != 0)
                if nonzero == 0 or (connectivity == 6 and nonzero > 1):
                    continue
                if connectivity == 18 and nonzero == 3:
                    continue
                out.append((dz, dy, dx))
    return out


def shift3d(arr: torch.Tensor, dz: int, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., z, y, x] = arr[..., z + dz, y + dy, x + dx]`` with
    ``fill`` at exposed borders, over the last three axes."""
    z, h, w = arr.shape[-3:]
    if arr.dtype == torch.bool:
        return shift3d(arr.to(torch.uint8), dz, dy, dx, int(fill)).to(torch.bool)
    r = max(abs(dz), abs(dy), abs(dx), 1)
    padded = F.pad(arr, (r, r, r, r, r, r), value=fill)
    return padded[..., r + dz : r + dz + z, r + dy : r + dy + h, r + dx : r + dx + w]


def _check_volumes(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    if len(shape) != 4:
        raise ValueError(f"{name}: expected (B, Z, H, W) volumes, got {tuple(shape)}")
    for t in tensors[1:]:
        if t.shape != shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(shape)}")
    if shape[1] * shape[2] * shape[3] >= BIG:
        raise ValueError(f"{name}: volume too large for int32 linear labels")


# --------------------------------------------------- 3-D CC min-propagate
def cc3d_min_propagate_plain(mask: torch.Tensor, connectivity: int = 26) -> torch.Tensor:
    """Synchronous neighbour-min propagation of linear indices, each step
    followed by one pointer jump (a label is always the index of a voxel
    of the same component, so ``lab[lab[p]]`` is one too)."""
    mask = mask.to(torch.bool)
    b = mask.shape[0]
    n = mask[0].numel()
    linear = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(mask.shape[1:])
    big = torch.full((), BIG, dtype=torch.int32, device=mask.device)
    shifts = neighbor_shifts_3d(connectivity)

    def step(lab):
        new = lab
        for s in shifts:
            new = torch.minimum(new, shift3d(lab, *s, BIG))
        flat = torch.where(mask, new, big).reshape(b, n)
        jumped = flat.gather(1, torch.clamp(flat, max=n - 1).to(torch.int64))
        return torch.where(mask, jumped.reshape(mask.shape), big)

    return _fixpoint(step, torch.where(mask, linear.expand(mask.shape), big))


def cc3d_min_propagate_launcher(mask: torch.Tensor, connectivity: int = 26,
                                phases: int = CC_PHASES, counter=None):
    """``launch()`` of the union-find kernel on ``(B, Z, H, W)`` CUDA
    masks, returning the labels (``phases`` as in
    :func:`.kernels.cc_min_propagate_launcher`)."""
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    b, z, h, w = mask.shape
    return bind_launch("cc3d_min_propagate", counter, (mask, out), b, z, h, w, connectivity,
                       phases)


def cc3d_min_propagate(mask: torch.Tensor, connectivity: int = 26) -> torch.Tensor:
    """Converged min-linear-index labels of ``(B, Z, H, W)`` masks;
    background holds ``BIG``."""
    _check_volumes("cc3d_min_propagate", mask)
    neighbor_shifts_3d(connectivity)  # validates before dispatch
    if mask.device.type == "cpu":
        return cc3d_min_propagate_plain(mask, connectivity)
    return cc3d_min_propagate_launcher(mask, connectivity, counter=cc3d_min_propagate)()


cc3d_min_propagate.launches = 0


# ---------------------------------------------------------- 3-D watershed
def _cube_max(lab: torch.Tensor) -> torch.Tensor:
    """Max over each voxel's 3x3x3 cube (itself included), 0 beyond the
    volume: three separable passes of a 3-wide max."""
    for dims in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        lab = torch.maximum(lab, torch.maximum(
            shift3d(lab, *dims, 0), shift3d(lab, *(-d for d in dims), 0)))
    return lab


def propagate_labels_3d(labels: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Grow labels through ``allowed`` voxels of ``(..., Z, H, W)``
    volumes until nothing changes (reference ``volume.py:171``): each
    step, every unlabelled allowed voxel adopts the largest label of its
    26 neighbours (0 beyond the volume), all voxels at once."""
    labels = labels.to(torch.int32)
    grow = allowed.to(torch.bool)
    return _fixpoint(lambda lab: torch.where((lab == 0) & grow, _cube_max(lab), lab), labels)


def watershed3d_flood_plain(
    intensity: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor, n_levels: int = 16
) -> torch.Tensor:
    """Level-ordered Jacobi flooding over the 26-neighbourhood: unlabeled
    allowed voxels adopt the max neighbour label (the cube max, which is
    the neighbours' max where the voxel holds 0), each level to
    convergence, then a mop-up."""
    intensity = intensity.to(torch.float32)
    seeds = seeds.to(torch.int32)
    mask = mask.to(torch.bool) | (seeds > 0)
    levels = watershed_levels(intensity, mask, n_levels)

    def flood(labels, allowed):
        def step(lab):
            return torch.where((lab == 0) & allowed, _cube_max(lab), lab)

        return _fixpoint(step, labels)

    labels = seeds
    for i in range(n_levels):
        labels = flood(labels, mask & (intensity >= levels[:, i, None, None, None]))
    labels = flood(labels, mask)  # mop up below the lowest level
    return torch.where(mask, labels, torch.zeros_like(labels))


#: the cluster route holds each voxel's band (first eligible level, the
#: mop-up, or never) in one byte
W3_MAX_LEVELS = 254


def watershed3d_plan(n_levels: int) -> FloodPlan:
    """The 3-D flood's route: ``"cluster"`` (one thread-block cluster a
    volume, state and two frontier lists as long as the volume in global
    memory, so any size and seed id) up to :data:`W3_MAX_LEVELS` levels;
    else ``"global"``, the first design."""
    return FloodPlan("global" if n_levels > W3_MAX_LEVELS else "cluster")


def watershed3d_flood_launcher(intensity, seeds, mask, n_levels: int = 16,
                               plan: "FloodPlan | None" = None, counter=None):
    """``launch()`` of the 3-D flood kernel on ``(B, Z, H, W)`` CUDA
    volumes by ``plan`` (default :func:`watershed3d_plan`), returning the
    labels; it counts in ``counter``'s record."""
    plan = plan or watershed3d_plan(n_levels)
    intensity = intensity.to(torch.float32).contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty_like(seeds)
    b, z, h, w = intensity.shape
    if plan.route == "cluster":
        band = torch.empty(seeds.shape, dtype=torch.uint8, device=seeds.device)
        lists = torch.empty((b, 2, z * h * w), dtype=torch.int32, device=seeds.device)
        misc = torch.empty((b, 32), dtype=torch.int32, device=seeds.device)
        return bind_launch("watershed3d_flood", counter,
                           (intensity, seeds, mask, band, lists, misc, out), b, z, h, w,
                           n_levels, route="cluster")
    return bind_launch("watershed3d_flood_global", counter,
                       (intensity, seeds, mask, torch.empty_like(seeds), out), b, z, h, w,
                       n_levels, route="global")


def watershed3d_flood(
    intensity: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor, n_levels: int = 16
) -> torch.Tensor:
    """Level-ordered watershed flooding of ``(B, Z, H, W)`` volumes over
    the 26-neighbourhood; seeds keep their labels, output is zero outside
    ``mask | seeds > 0``."""
    _check_volumes("watershed3d_flood", intensity, seeds, mask)
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    if intensity.device.type == "cpu":
        return watershed3d_flood_plain(intensity, seeds, mask, n_levels)
    return watershed3d_flood_launcher(intensity, seeds, mask, n_levels,
                                      counter=watershed3d_flood)()


watershed3d_flood.launches = 0
watershed3d_flood.routes = {"cluster": 0, "global": 0}


# ------------------------------------------------------------ ops on top
def connected_components_3d(
    mask: torch.Tensor, connectivity: int = 26
) -> tuple[torch.Tensor, torch.Tensor]:
    """Label 3-D connected components of ``(B, Z, H, W)`` masks at
    ``connectivity`` 6, 18 or 26: int32 labels 1..N in scipy scan order
    and the ``(B,)`` counts."""
    mask = mask.to(torch.bool)
    return compact_roots(mask, cc3d_min_propagate(mask, connectivity))


def watershed_from_seeds_3d(
    intensity: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor, n_levels: int = 16
) -> torch.Tensor:
    """3-D level-ordered flooding of ``seeds`` through ``mask`` (the same
    scheme as the 2-D watershed, 26-neighbourhood)."""
    return watershed3d_flood(
        intensity.to(torch.float32), seeds.to(torch.int32), mask.to(torch.bool),
        n_levels=n_levels,
    )


def volume_stat_channels(
    labels: torch.Tensor, intensity: torch.Tensor
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``(B, Z, H, W)`` labels and the six channels :func:`volume_features`
    sums (1, z, y, x, v, v²); the first four are one ``(Z, H, W)`` volume
    each, broadcast over the batch without a copy."""
    labels = labels.to(torch.int32)
    img = intensity.to(torch.float32)
    b, z, h, w = labels.shape
    grid = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=labels.device) for n in (z, h, w)),
        indexing="ij",
    )
    shared = [torch.ones((z, h, w), device=labels.device), *(g.contiguous() for g in grid)]
    return labels, [c.expand(b, z, h, w) for c in shared] + [img, img * img]


def volume_features(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int
) -> dict[str, torch.Tensor]:
    """Per-object voxel count, centroid and intensity statistics of
    ``(B, Z, H, W)`` label volumes, each ``(B, max_objects)``.  The six
    channels go to ONE :func:`~tmlibrary_tpu_torch.ops.measure.grouped_sums`
    pass over the volumes on the reduction strategy in effect (on
    ``"fused"`` one ``grouped_stats`` launch, in row-major voxel
    order, the reference's scatter order)."""
    sums = grouped_sums(*volume_stat_channels(labels, intensity), max_objects)
    vol = sums[..., 0]
    safe = torch.clamp(vol, min=1.0)
    total = sums[..., 4]
    mean = div(total, safe)
    var = torch.clamp(div(sums[..., 5], safe) - mean * mean, min=0.0)
    present = vol > 0

    def m(v):
        return torch.where(present, v, 0.0)

    return {
        "Volume_voxels": vol,
        "Volume_centroid_z": m(div(sums[..., 1], safe)),
        "Volume_centroid_y": m(div(sums[..., 2], safe)),
        "Volume_centroid_x": m(div(sums[..., 3], safe)),
        "Volume_intensity_mean": m(mean),
        "Volume_intensity_sum": total,
        "Volume_intensity_std": m(sqrt(var)),
    }
