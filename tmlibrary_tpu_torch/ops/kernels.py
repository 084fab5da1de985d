"""The label-propagation fixpoints: CUDA kernels and their plain versions.

Counterpart: ``tmlibrary_tpu/ops/pallas_kernels.py`` — the TPU kernels
``fill_holes_flood`` (``_fill_kernel``), ``cc_min_propagate``
(``_cc_kernel``), ``watershed_flood`` (``_watershed_kernel``) and
``distance_transform`` (``_distance_kernel``).  The Hopper kernels are
in ``tmlibrary_tpu_torch/csrc/{fill_holes,cc_min_propagate,
watershed_flood,distance_transform}.cu`` (design and bounds in each
source's header).  The 3-D fixpoints are in :mod:`.volume`.

Every function here takes a batch of sites ``(B, H, W)``.  The wrapper
dispatches on the tensor's device: a CPU tensor goes to the ``*_plain``
version (synchronous PyTorch steps to the same fixpoint), a CUDA tensor
to the kernel, which launches or raises — there is no fallback from one
to the other.  Each wrapper counts its kernel launches in ``.launches``.

The two 2-D floods have two routes each, picked from the shapes (and
the level count) before the launch, never after a failure:
``"onchip"``, the site in one block's shared memory, and ``"global"``,
the first design's planes in global memory, for sites that do not fit
(:func:`watershed_plan`, :func:`fill_plan`).  Their wrappers also count
launches by route in ``.routes``.  The distance transform has one route
for any site (two passes over every SM).  ``*_launcher`` builds a
launch (on a given plan), for the A/B harness and the chip smoke.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tmlibrary_tpu_torch.ops._cuda import bind_launch
from tmlibrary_tpu_torch.ops._exact import div

#: sentinel for "no label yet" in min-propagation (same value as the JAX
#: package's ``pallas_kernels.BIG``)
BIG = 2**30

#: plain-version propagation steps between convergence checks (the
#: fixpoints are idempotent, so extra steps cannot change a label)
CHUNK = 8


def neighbor_shifts(connectivity: int) -> list[tuple[int, int]]:
    if connectivity == 4:
        return [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        return [
            (-1, -1), (-1, 0), (-1, 1),
            (0, -1), (0, 1),
            (1, -1), (1, 0), (1, 1),
        ]
    raise ValueError("connectivity must be 4 or 8")


def shift_with_fill(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., y, x] = arr[..., y + dy, x + dx]`` with ``fill`` at exposed
    borders, over the last two axes.  Pads by the shift's own reach (the
    reference pads by one pixel, so its shifts beyond 1 land short)."""
    h, w = arr.shape[-2:]
    if arr.dtype == torch.bool:
        return shift_with_fill(arr.to(torch.uint8), dy, dx, int(fill)).to(torch.bool)
    r = max(abs(dy), abs(dx), 1)
    padded = F.pad(arr, (r, r, r, r), value=fill)
    return padded[..., r + dy : r + dy + h, r + dx : r + dx + w]


def _fixpoint(step, state: torch.Tensor) -> torch.Tensor:
    """Run ``step`` until a chunk of steps changes nothing."""
    while True:
        new = state
        for _ in range(CHUNK):
            new = step(new)
        if torch.equal(new, state):
            return new
        state = new


def _check_sites(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    if len(shape) != 3:
        raise ValueError(f"{name}: expected (B, H, W) sites, got {tuple(shape)}")
    for t in tensors[1:]:
        if t.shape != shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(shape)}")
    if shape[1] * shape[2] >= BIG:
        raise ValueError(f"{name}: site too large for int32 linear labels")


# ------------------------------------------------------ routes of the floods
#: shared memory one block can use on Hopper (the on-chip floods keep a
#: site there)
SMEM_BYTES = 227 * 1024
#: the on-chip watershed holds labels in 16 bits (0xFFFF marks a pixel
#: claimed in the current step), a pixel index of its frontier lists in 16
#: bits and each pixel's band in one byte (255: never eligible)
WS_MAX_ID, WS_MAX_PIXELS, WS_MAX_LEVELS = 65534, 65536, 254
#: static shared memory of the on-chip watershed (levels, reductions, counts)
WS_STATIC_BYTES = 2048


@dataclass(frozen=True)
class FloodPlan:
    """How a flood kernel runs a batch: ``route`` ``"onchip"`` (a site in
    one block's shared memory) or ``"global"`` (the first design's planes
    in global memory); ``cap``, the length of each of the on-chip watershed's two
    frontier lists."""

    route: str
    cap: int = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def watershed_plan(shape, n_levels: int, cap: "int | None" = None) -> FloodPlan:
    """The watershed's route for ``(..., H, W)`` sites: on chip when a site
    has at most :data:`WS_MAX_PIXELS` pixels and ``n_levels`` is at most
    :data:`WS_MAX_LEVELS`, with frontier lists as long as the rest of
    shared memory allows (a shorter ``cap`` makes steps overflow into
    scans of the site, which give the same labels); else global."""
    h, w = shape[-2:]
    n = h * w
    if n > WS_MAX_PIXELS or n_levels > WS_MAX_LEVELS:
        return FloodPlan("global")
    room = (SMEM_BYTES - WS_STATIC_BYTES - 2 * _round_up(n, 8) - _round_up(n, 16)) // 4
    if cap is None:
        cap = max(1, min(room, n))
    if not 1 <= cap <= room:
        raise ValueError(f"watershed_plan: cap must be in [1, {room}], got {cap}")
    return FloodPlan("onchip", cap)


def fill_plane_bytes(h: int, w: int) -> int:
    """Shared memory of the on-chip fill: four bit planes (background and
    reached, row-major and transposed) over the site padded to 32x32
    tiles."""
    return 4 * 4 * 32 * (_round_up(h, 32) // 32) * (_round_up(w, 32) // 32)


def fill_plan(shape) -> FloodPlan:
    """The fill's route for ``(..., H, W)`` sites: on chip when its bit
    planes fit one block's shared memory (up to 672x672), else global."""
    h, w = shape[-2:]
    return FloodPlan("onchip" if fill_plane_bytes(h, w) <= SMEM_BYTES else "global")


# -------------------------------------------------------------- fill holes
def fill_holes_flood_plain(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Border flood through ``connectivity``-connected background; what the
    flood never reached is filled."""
    mask = mask.to(torch.bool)
    bg = ~mask
    border = torch.zeros_like(mask)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    shifts = neighbor_shifts(connectivity)

    def step(reach):
        new = reach
        for dy, dx in shifts:
            new = new | shift_with_fill(reach, dy, dx, False)
        return new & bg

    reach = _fixpoint(step, bg & border)
    return mask | (bg & ~reach)


def fill_holes_launcher(mask: torch.Tensor, connectivity: int = 4,
                        plan: "FloodPlan | None" = None, counter=None):
    """``launch()`` of the fill kernel on ``(B, H, W)`` CUDA masks by
    ``plan`` (default :func:`fill_plan`), returning the filled masks; it
    counts in ``counter``'s record."""
    plan = plan or fill_plan(mask.shape)
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty_like(mask)
    b, h, w = mask.shape
    if plan.route == "onchip":
        return bind_launch("fill_holes", counter, (mask, out), b, h, w, connectivity,
                           route="onchip")
    reach = torch.empty(mask.shape, dtype=torch.uint8, device=mask.device)
    return bind_launch("fill_holes_global", counter, (mask, reach, out), b, h, w,
                       connectivity, route="global")


def fill_holes_flood(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Filled ``(B, H, W)`` bool masks (scipy ``binary_fill_holes`` at
    background connectivity 4)."""
    _check_sites("fill_holes_flood", mask)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if mask.device.type == "cpu":
        return fill_holes_flood_plain(mask, connectivity)
    return fill_holes_launcher(mask, connectivity, counter=fill_holes_flood)()


fill_holes_flood.launches = 0
fill_holes_flood.routes = {"onchip": 0, "global": 0}


# ------------------------------------------------------- CC min-propagate
#: phases of the union-find kernels (``csrc/cc_union_find.cuh``): local
#: unions in shared memory, unions across tile borders, flatten
CC_LOCAL, CC_BORDER, CC_FLATTEN = 1, 2, 4
CC_PHASES = CC_LOCAL | CC_BORDER | CC_FLATTEN


def cc_min_propagate_plain(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Synchronous neighbour-min propagation of linear indices."""
    mask = mask.to(torch.bool)
    b, h, w = mask.shape
    linear = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    big = torch.full((), BIG, dtype=torch.int32, device=mask.device)
    shifts = neighbor_shifts(connectivity)

    def step(lab):
        new = lab
        for dy, dx in shifts:
            new = torch.minimum(new, shift_with_fill(lab, dy, dx, BIG))
        return torch.where(mask, new, big)

    return _fixpoint(step, torch.where(mask, linear.expand(b, h, w), big))


def cc_min_propagate_launcher(mask: torch.Tensor, connectivity: int = 8,
                              phases: int = CC_PHASES, counter=None):
    """``launch()`` of the union-find kernel on ``(B, H, W)`` CUDA masks,
    returning the labels: the phases in ``phases`` (all three by default;
    fewer leave the labels unfinished, for the A/B harness's split), one
    C call; it counts in ``counter``'s record."""
    mask = mask.to(torch.bool).contiguous()
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    b, h, w = mask.shape
    return bind_launch("cc_min_propagate", counter, (mask, out), b, h, w, connectivity, phases)


def cc_min_propagate(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Converged min-linear-index labels of ``(B, H, W)`` masks; background
    holds ``BIG``."""
    _check_sites("cc_min_propagate", mask)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if mask.device.type == "cpu":
        return cc_min_propagate_plain(mask, connectivity)
    return cc_min_propagate_launcher(mask, connectivity, counter=cc_min_propagate)()


cc_min_propagate.launches = 0


# --------------------------------------------------------------- watershed
def watershed_levels(
    intensity: torch.Tensor, mask: torch.Tensor, n_levels: int
) -> torch.Tensor:
    """``(B, n_levels)`` descending thresholds ``hi - span * (i+1) / n``,
    float32 left to right, from the masked min/max of each site."""
    b = intensity.shape[0]
    inf = torch.full((), float("inf"), device=intensity.device)
    lo = torch.where(mask, intensity, inf).reshape(b, -1).amin(dim=1)
    hi = torch.where(mask, intensity, -inf).reshape(b, -1).amax(dim=1)
    return levels_from_range(lo, hi, n_levels)


def levels_from_range(lo: torch.Tensor, hi: torch.Tensor, n_levels: int) -> torch.Tensor:
    """:func:`watershed_levels` from the ``(B,)`` masked minima and maxima
    (the sharded watershed reduces them over the ranks first)."""
    span = torch.clamp(hi - lo, min=1e-6)
    steps = torch.arange(1, n_levels + 1, dtype=torch.float32, device=lo.device)
    return hi[:, None] - div(span[:, None] * steps[None, :], n_levels)


def watershed_flood_plain(
    intensity: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 32,
    connectivity: int = 8,
) -> torch.Tensor:
    """Level-ordered Jacobi flooding: unlabeled allowed pixels adopt the
    max neighbour label, each level to convergence, then a mop-up."""
    intensity = intensity.to(torch.float32)
    seeds = seeds.to(torch.int32)
    mask = mask.to(torch.bool) | (seeds > 0)
    levels = watershed_levels(intensity, mask, n_levels)
    shifts = neighbor_shifts(connectivity)

    def flood(labels, allowed):
        def step(lab):
            neigh = torch.zeros_like(lab)
            for dy, dx in shifts:
                neigh = torch.maximum(neigh, shift_with_fill(lab, dy, dx, 0))
            return torch.where((lab == 0) & allowed, neigh, lab)

        return _fixpoint(step, labels)

    labels = seeds
    for i in range(n_levels):
        labels = flood(labels, mask & (intensity >= levels[:, i, None, None]))
    labels = flood(labels, mask)  # mop up below the lowest level
    return torch.where(mask, labels, torch.zeros_like(labels))


def watershed_flood_launcher(
    intensity: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 32,
    connectivity: int = 8,
    plan: "FloodPlan | None" = None,
    counter=None,
):
    """``launch()`` of the watershed kernel on ``(B, H, W)`` CUDA sites by
    ``plan`` (default :func:`watershed_plan`), returning the labels; it
    counts in ``counter``'s record.  ``launch.site_routes`` is the
    ``(B,)`` int32 route each site took at the last launch: 0 on chip, 1
    global (on the on-chip route, a site whose largest seed id exceeds
    :data:`WS_MAX_ID`)."""
    plan = plan or watershed_plan(intensity.shape, n_levels)
    intensity = intensity.to(torch.float32).contiguous()
    seeds = seeds.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    b, h, w = intensity.shape
    site_routes = torch.empty(b, dtype=torch.int32, device=seeds.device)
    tensors = (intensity, seeds, mask, torch.empty_like(seeds), site_routes,
               torch.empty_like(seeds))
    if plan.route == "onchip":
        launch = bind_launch("watershed_flood", counter, tensors, b, h, w, n_levels,
                             connectivity, plan.cap, route="onchip")
    else:
        launch = bind_launch("watershed_flood_global", counter, tensors, b, h, w, n_levels,
                             connectivity, route="global")
    launch.site_routes = site_routes
    return launch


def watershed_flood(
    intensity: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 32,
    connectivity: int = 8,
) -> torch.Tensor:
    """Level-ordered watershed flooding of ``(B, H, W)`` sites; seeds keep
    their labels, output is zero outside ``mask | seeds > 0``."""
    _check_sites("watershed_flood", intensity, seeds, mask)
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    if intensity.device.type == "cpu":
        return watershed_flood_plain(intensity, seeds, mask, n_levels, connectivity)
    launch = watershed_flood_launcher(intensity, seeds, mask, n_levels, connectivity,
                                      counter=watershed_flood)
    watershed_flood.site_routes = launch.site_routes
    return launch()


watershed_flood.launches = 0
watershed_flood.routes = {"onchip": 0, "global": 0}
#: ``(B,)`` route of each site at the last launch (0 on chip, 1 global)
watershed_flood.site_routes = None


# ------------------------------------------------------- distance transform
#: the reference sums ones in float32, which stop growing at 2**24: no
#: distance or cap beyond it is written
CAP_LIMIT = 2**24
#: ``phases`` of the distance kernel (``csrc/distance_transform.cu``): the
#: column pass, the row pass
DT_COLUMNS, DT_ROW_PASS = 1, 2
DT_PHASES = DT_COLUMNS | DT_ROW_PASS


def binary_dilate(mask: torch.Tensor, connectivity: int = 8, iterations: int = 1) -> torch.Tensor:
    """Dilation of ``(B, H, W)`` masks; out-of-image neighbours count as
    background (reference ``label.binary_dilate``)."""
    mask = mask.to(torch.bool)
    shifts = neighbor_shifts(connectivity)
    for _ in range(iterations):
        out = mask
        for dy, dx in shifts:
            out = out | shift_with_fill(mask, dy, dx, False)
        mask = out
    return mask


def binary_erode(mask: torch.Tensor, connectivity: int = 8, iterations: int = 1) -> torch.Tensor:
    """Erosion of ``(B, H, W)`` masks; out-of-image neighbours count as
    foreground (reference ``label.binary_erode``)."""
    mask = mask.to(torch.bool)
    shifts = neighbor_shifts(connectivity)
    for _ in range(iterations):
        out = mask
        for dy, dx in shifts:
            out = out & shift_with_fill(mask, dy, dx, True)
        mask = out
    return mask


def distance_transform_plain(mask: torch.Tensor, max_distance: int = 64) -> torch.Tensor:
    """Erosion counting: each foreground pixel counts 1 plus one per
    8-connected erosion it survives, at most ``max_distance`` erosions,
    stopping once every site has eroded away."""
    cur = mask.to(torch.bool)
    dist = cur.to(torch.float32)
    for _ in range(max_distance):
        if not bool(cur.any()):
            break
        cur = binary_erode(cur)
        dist = dist + cur.to(torch.float32)
    return dist


@dataclass(frozen=True)
class DistanceReach:
    """What the distance kernel is handed for ``(..., H, W)`` sites:
    ``cap``, the value of a foreground pixel whose D passes
    ``max_distance`` (``max_distance + 1``, at most 2**24); ``reach`` =
    ``min(cap, max(H, W))``, the sentinel for "no background in reach"
    (no in-image D reaches ``max(H, W)``), at which the column pass
    saturates g; and the scratch g's row ``pitch`` (W rounded up to 16
    entries) and ``dtype``, the narrowest that holds ``reach`` (8 bits, 16
    past 255, 32 past 65,535; storage only, never read in PyTorch)."""

    cap: int
    reach: int
    pitch: int
    dtype: torch.dtype


def distance_reach(shape, max_distance: int) -> DistanceReach:
    h, w = shape[-2:]
    cap = min(max_distance, CAP_LIMIT - 1) + 1
    reach = min(cap, max(h, w))
    dtype = torch.uint8 if reach <= 255 else torch.int16 if reach <= 65535 else torch.int32
    return DistanceReach(cap, reach, _round_up(w, 16), dtype)


def distance_transform_launcher(mask: torch.Tensor, max_distance: int = 64, counter=None,
                                phases: int = DT_PHASES):
    """``launch()`` of the distance kernel on ``(B, H, W)`` CUDA masks,
    returning the distances: the column pass into a scratch g, then the
    row pass (``phases`` picks either alone, for the A/B harness); it
    counts in ``counter``'s record."""
    mask = mask.to(torch.bool).contiguous()
    b, h, w = mask.shape
    r = distance_reach(mask.shape, max_distance)
    g = torch.empty((b, h, r.pitch), dtype=r.dtype, device=mask.device)
    out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
    return bind_launch("distance_transform", counter, (mask, g, out), b, h, w, r.cap, r.reach,
                       phases)


def distance_transform(mask: torch.Tensor, max_distance: int = 64) -> torch.Tensor:
    """Capped chessboard distance to the background of ``(B, H, W)``
    masks, float32: ``min(D, max_distance + 1)`` for a foreground pixel
    whose nearest in-image background pixel is ``D`` away (pixels beyond
    the image count as foreground), 0 on the background; any
    ``max_distance >= 0``, as the reference."""
    _check_sites("distance_transform", mask)
    if max_distance < 0:
        raise ValueError("max_distance must be >= 0")
    if mask.device.type == "cpu":
        return distance_transform_plain(mask, max_distance)
    return distance_transform_launcher(mask, max_distance, counter=distance_transform)()


distance_transform.launches = 0
