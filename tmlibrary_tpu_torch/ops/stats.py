"""Online illumination statistics (corilla's numeric core).

Counterpart: ``tmlibrary_tpu/ops/stats.py`` (``welford_init``,
``welford_update``, ``welford_scan``, ``welford_merge``,
``welford_finalize``) and the numeric order of the corilla step
(``tmlibrary_tpu/workflow/steps/corilla.py:105-146``), reference
``tmlib/workflow/corilla/stats.py`` ``OnlineStatistics``: a per-pixel
Welford mean and variance of ``log10(1 + raw)`` over every site of a
channel, shifted by each pixel's first sample, beside an exact
65,536-bin raw-intensity histogram from which the percentiles are read.

The semantics are the reference's, step for step: a float32 ``n``; each
site's counts (:func:`~tmlibrary_tpu_torch.ops.histogram.histogram_fixed_bins`,
exact integers) added to a float32 ``hist``; ``var = m2 / max(n, 1)``;
percentiles by ``searchsorted`` (left) on the float32 cumulative sum in
XLA-CPU's order, clipped to ``[0, 65535]``.  The scan is sequential, site
by site: a parallel (Chan) tree would round differently.  ``n``, the
histogram and the percentiles are therefore bit-exact against the
reference; the log-domain fields differ by the ulps of ``log10`` between
libraries and devices and are held by ``chip_smoke.STATS_TIERS``.

Every tensor of a state may carry leading axes ``lead`` (``n`` is
``lead``-shaped, the fields ``(*lead, H, W)``, the histogram
``(*lead, HIST_BINS)``): with a channel axis one step folds one site of
every channel, the ``vmap`` over channels of ``bench.py:2031-2033``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.ops import _exact
from tmlibrary_tpu_torch.ops.histogram import histogram_fixed_bins
from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth

HIST_BINS = 65536  # exact for uint16 pixel data
PERCENTILES = (0.1, 1.0, 50.0, 99.0, 99.9)


class WelfordState(NamedTuple):
    """Per-pixel running statistics and the raw-intensity histogram.

    ``mean``/``m2`` track the log-domain values shifted by ``offset``
    (each pixel's first sample), so a nearly flat channel keeps its
    variance in float32; the physical mean is ``offset + mean``."""

    n: torch.Tensor  # lead-shaped float32: sites seen
    mean: torch.Tensor  # (*lead, H, W) float32: running mean minus offset
    m2: torch.Tensor  # (*lead, H, W) float32: sum of squared deviations
    offset: torch.Tensor  # (*lead, H, W) float32: the first sample
    hist: torch.Tensor  # (*lead, HIST_BINS) float32: raw-intensity counts


def _fields(t: torch.Tensor) -> torch.Tensor:
    """A lead-shaped tensor broadcast against ``(*lead, H, W)`` fields."""
    return t[..., None, None]


def welford_init(
    shape: tuple[int, int], device: "str | torch.device" = "cuda", lead: tuple = ()
) -> WelfordState:
    """The empty state for ``(H, W)`` sites; ``lead=(C,)`` for ``C``
    channels folded together."""
    dev = resolve_device(device)
    lead = tuple(lead)

    def zeros(*s):
        return torch.zeros(lead + s, dtype=torch.float32, device=dev)

    return WelfordState(n=zeros(), mean=zeros(*shape), m2=zeros(*shape),
                        offset=zeros(*shape), hist=zeros(HIST_BINS))


def welford_update(state: WelfordState, raw: torch.Tensor) -> WelfordState:
    """Fold one site ``(*lead, H, W)`` of raw uint16-range intensities:
    mean and variance of ``log10(1 + raw)``, the histogram of ``raw``."""
    raw_f = raw.to(torch.float32)
    x = torch.log10(1.0 + raw_f)
    offset = torch.where(_fields(state.n == 0), x, state.offset)
    xs = x - offset
    n = state.n + 1.0
    delta = xs - state.mean
    mean = state.mean + delta / _fields(n)
    m2 = state.m2 + delta * (xs - mean)
    idx = raw_f.clamp(0, HIST_BINS - 1).to(torch.int32)
    lead = tuple(state.n.shape)
    counts = histogram_fixed_bins(idx.reshape((-1,) + tuple(idx.shape[-2:])), HIST_BINS)
    hist = state.hist + counts.reshape(lead + (HIST_BINS,))
    return WelfordState(n=n, mean=mean, m2=m2, offset=offset, hist=hist)


def welford_scan(stack: torch.Tensor, init: WelfordState | None = None) -> WelfordState:
    """Fold a ``(*lead, S, H, W)`` stack site by site, in site order."""
    if init is None:
        init = welford_init(tuple(stack.shape[-2:]), stack.device, lead=tuple(stack.shape[:-3]))
    state = init
    for s in range(stack.shape[-3]):
        state = welford_update(state, stack[..., s, :, :])
    return state


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan et al.'s combination of two disjoint-sample states; ``b`` is
    re-expressed in the surviving frame first (``m2`` is shift-invariant).
    Exact when either side is empty: ``b.n / n`` is then 0.0 or 1.0."""
    n = a.n + b.n
    safe_n = torch.clamp(n, min=1.0)
    offset = torch.where(_fields(a.n > 0), a.offset, b.offset)
    b_mean = b.mean + (b.offset - offset)
    delta = b_mean - a.mean
    mean = a.mean + delta * _fields(b.n / safe_n)
    m2 = a.m2 + b.m2 + delta * delta * _fields(a.n * b.n / safe_n)
    return WelfordState(n=n, mean=mean, m2=m2, offset=offset, hist=a.hist + b.hist)


def welford_finalize(
    state: WelfordState, percentile_qs: tuple[float, ...] = PERCENTILES
) -> dict[str, torch.Tensor]:
    """Log-domain mean, std and variance fields and exact raw-intensity
    percentiles (the smallest intensity whose cumulative count reaches
    ``q * total``), every entry with the state's leading axes."""
    lead = tuple(state.n.shape)
    dev = state.n.device
    var = state.m2 / _fields(torch.clamp(state.n, min=1.0))
    cum = _exact.cumsum_xla_cpu(state.hist)
    total = torch.clamp(cum[..., -1], min=1.0)
    keys = torch.tensor(percentile_qs, dtype=torch.float32, device=dev)
    targets = _exact.div(keys, 100.0) * total[..., None]
    values = torch.searchsorted(cum, targets.contiguous(), side="left").to(torch.float32)
    return {
        "mean_log": state.offset + state.mean,
        "std_log": _exact.sqrt(torch.clamp(var, min=0.0)),
        "var_log": var,
        "n": state.n,
        "percentile_keys": keys.expand(lead + keys.shape),
        "percentile_values": torch.clamp(values, 0, HIST_BINS - 1),
        "hist": state.hist,
    }


def corilla_statistics(
    stack: torch.Tensor, chunk_size: int = 32, smooth_sigma: float = 0.0,
    percentile_qs: tuple[float, ...] = PERCENTILES,
) -> dict[str, torch.Tensor]:
    """One corilla channel job's numbers over a ``(*lead, S, H, W)`` stack,
    in the step's order: :func:`welford_scan` over chunks of
    ``chunk_size`` sites, :func:`welford_merge` in chunk order,
    :func:`welford_finalize`, then, when ``smooth_sigma > 0``, a Gaussian
    of ``mean_log`` and ``std_log``.  The store reads, the prefetch and
    the QC session of the step are not here."""
    chunk = max(int(chunk_size), 1)
    state = None
    for start in range(0, stack.shape[-3], chunk):
        part = welford_scan(stack[..., start : start + chunk, :, :])
        state = part if state is None else welford_merge(state, part)
    if state is None:
        state = welford_init(tuple(stack.shape[-2:]), stack.device, lead=tuple(stack.shape[:-3]))
    out = welford_finalize(state, percentile_qs)
    if smooth_sigma > 0:
        out["mean_log"] = gaussian_smooth(out["mean_log"], smooth_sigma)
        out["std_log"] = gaussian_smooth(out["std_log"], smooth_sigma)
    return out


def state_from_numpy(state, device: "str | torch.device" = "cuda") -> WelfordState:
    """Carry a reference state across: any object with numpy-convertible
    ``n, mean, m2, offset, hist`` (the JAX package's ``WelfordState``)
    becomes the port's on ``device``, so a half scanned by either package
    merges with a half scanned by the other."""
    dev = resolve_device(device)
    return WelfordState(*(
        torch.from_numpy(np.array(getattr(state, f), dtype=np.float32)).to(dev)
        for f in WelfordState._fields))
