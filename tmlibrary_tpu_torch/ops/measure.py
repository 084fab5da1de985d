"""Per-object feature measurement.

Counterpart: ``tmlibrary_tpu/ops/measure.py`` on its fused strategy
(reference: ``jtlib/features/{intensity,morphology,texture,zernike}.py``):
every grouped reduction is one :func:`grouped_stats` pass, the quantile
histogram is :func:`intensity_hist` and the Haralick co-occurrences are
:func:`glcm_all`.  Every function takes a batch of sites ``(B, H, W)`` and
returns ``(B, max_objects)`` per feature; rows past a site's object count
are padding and must be masked by the caller using the object count.

Expression trees follow the reference operation by operation, so the
features built from exact sums, counts and IEEE ``+ - * / sqrt`` equal
it bit for bit.  Divisions by a constant go through ``_exact.div`` (CUDA
divides by a Python scalar through its reciprocal).  ``log``, ``exp``,
``atan2``, ``sin`` and ``cos`` differ by ulps between the CPU and the
card, so the Haralick and Zernike families and the morphology angle
carry a stated tolerance.
"""

from __future__ import annotations

import math

import torch

from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.ops._exact import div
from tmlibrary_tpu_torch.ops.fused_measure import (
    glcm_all,
    grouped_stats,
    intensity_hist,
    masked_bounds,
    quantize,
)
from tmlibrary_tpu_torch.ops.kernels import shift_with_fill


# ----------------------------------------------------------- grouped helpers
def grouped_sums(labels, channels, max_objects: int) -> torch.Tensor:
    """Per-object sums of several pixel channels → ``(B, M, C)``
    (reference ``grouped_sums``, ``measure.py:50``, fused path)."""
    return grouped_stats(labels, channels, max_objects)[0]


def grouped_minmax(labels, values, max_objects: int):
    """Per-object ``(min, max)`` of one channel, each ``(B, M)``; absent
    objects ``(+inf, -inf)`` (reference ``measure.py:208``)."""
    _, mn, mx = grouped_stats(labels, [values], max_objects)
    return mn[..., 0], mx[..., 0]


def grouped_minmax_multi(labels, values: list, max_objects: int):
    """Per-object ``(min, max)`` of several channels, each ``(B, M, C)``
    (reference ``measure.py:270``)."""
    _, mn, mx = grouped_stats(labels, values, max_objects)
    return mn, mx


def lookup_by_label(labels: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[b, y, x] = table[b, labels[b, y, x]]`` with ``table`` of shape
    ``(B, M + 1, C)`` (row 0 = background) → ``(B, H, W, C)``; ids are
    clipped into the table (reference ``measure.py:154``, a gather)."""
    b, rows, c = table.shape
    idx = labels.reshape(b, -1).to(torch.int64).clamp(0, rows - 1)
    out = table.gather(1, idx[..., None].expand(-1, -1, c))
    return out.reshape(*labels.shape, c)


def _grid(labels: torch.Tensor):
    h, w = labels.shape[-2:]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=labels.device),
        torch.arange(w, dtype=torch.float32, device=labels.device),
        indexing="ij",
    )
    return yy.expand(labels.shape), xx.expand(labels.shape)


# ------------------------------------------------------------------ intensity
def intensity_features(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int
) -> dict[str, torch.Tensor]:
    """max, mean, min, sum, std per object (reference ``measure.py:397``):
    count, sum, sum of squares, min and max from ONE :func:`grouped_stats`
    pass over channels ``[1, v, v²]``."""
    img = intensity.to(torch.float32)
    sums, mns, mxs = grouped_stats(
        labels.to(torch.int32), [torch.ones_like(img), img, img * img], max_objects
    )
    count, total, sq = sums[..., 0], sums[..., 1], sums[..., 2]
    mn, mx = mns[..., 1], mxs[..., 1]
    safe_n = torch.clamp(count, min=1.0)
    mean = total / safe_n
    var = torch.clamp(sq / safe_n - mean * mean, min=0.0)
    present = count > 0
    zero = torch.zeros_like(mean)
    return {
        "Intensity_max": torch.where(present, mx, zero),
        "Intensity_mean": mean,
        "Intensity_min": torch.where(present, mn, zero),
        "Intensity_sum": total,
        "Intensity_std": torch.sqrt(var),
    }


def quantize_per_object(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int, levels: int,
    bounds: "tuple[torch.Tensor, torch.Tensor] | None" = None,
) -> torch.Tensor:
    """Per-object gray-level stretch to ``[0, levels - 1]`` (mahotas
    ``stretch``; reference ``measure.py:806``) → int32 ``(B, H, W)``.
    ``bounds`` is a raw per-object ``(min, max)`` the caller already
    holds; otherwise one :func:`grouped_minmax` pass computes it."""
    img = intensity.to(torch.float32)
    if bounds is None:
        bounds = grouped_minmax(labels, img, max_objects)
    lo_full, span_full = masked_bounds(*bounds)
    return quantize(labels, img, lo_full, span_full, levels).to(torch.int32)


def intensity_quantiles(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int,
    qs: tuple[float, ...] = (0.25, 0.5, 0.75), bins: int = 256,
) -> dict[str, torch.Tensor]:
    """Per-object nearest-rank quantiles read off a ``bins``-bucket
    histogram of each object's own gray range (reference
    ``measure.py:460``, fused path ``:496-505``): ``Intensity_p25``,
    ``Intensity_median``, ``Intensity_p75`` by default."""
    img = intensity.to(torch.float32)
    raw_lo, raw_hi = grouped_minmax(labels, img, max_objects)
    lo_full, span_full = masked_bounds(raw_lo, raw_hi)
    counts = intensity_hist(labels, img, max_objects, bins, (raw_lo, raw_hi))
    return _quantiles_from_counts(
        counts, lo_full[:, 1:], span_full[:, 1:], raw_hi >= raw_lo, qs, bins)


def _quantiles_from_counts(counts, lo, span, present, qs, bins):
    """Nearest-rank quantiles from ``(B, M, bins)`` integer counts (exact
    cumulative sums in any order below 2^24)."""
    cdf = torch.cumsum(counts, dim=-1)
    total = torch.clamp(cdf[..., -1:], min=1.0)
    ramp = torch.arange(bins, dtype=torch.float32, device=counts.device)
    centers = lo[..., None] + div(ramp * span[..., None], float(bins - 1))
    out: dict[str, torch.Tensor] = {}
    for q in qs:
        reached = cdf >= q * total
        # first bucket where the CDF reaches q * n (the CDF is monotone;
        # an absent object reaches none and is masked below)
        idx = (~reached).sum(dim=-1, keepdim=True).clamp(max=bins - 1)
        val = centers.gather(-1, idx)[..., 0]
        name = "Intensity_median" if q == 0.5 else f"Intensity_p{int(round(q * 100)):02d}"
        out[name] = torch.where(present, val, 0.0)
    return out


# ----------------------------------------------------------------- morphology
def morphology_features(labels: torch.Tensor, max_objects: int) -> dict[str, torch.Tensor]:
    """Area, centroid, bounding box and extent, 4-neighbour boundary
    perimeter, equivalent diameter, form factor and the second-moment
    ellipse (reference ``measure.py:569``): all seven per-object sums
    and the bounding box from ONE 7-channel :func:`grouped_stats` pass."""
    labels = labels.to(torch.int32)
    yy, xx = _grid(labels)
    boundary = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        boundary = boundary | (shift_with_fill(labels, dy, dx, 0) != labels)
    boundary = boundary & (labels > 0)
    chans = [torch.ones_like(yy), yy, xx, yy * yy, xx * xx, yy * xx,
             boundary.to(torch.float32)]
    sums, mins_all, maxs_all = grouped_stats(labels, chans, max_objects)
    mins, maxs = mins_all[..., 1:3], maxs_all[..., 1:3]
    area = sums[..., 0]
    safe_a = torch.clamp(area, min=1.0)
    cy = sums[..., 1] / safe_a
    cx = sums[..., 2] / safe_a
    perimeter = sums[..., 6]

    present = area > 0
    zero = torch.zeros_like(area)
    bbox_h = torch.where(present, maxs[..., 0] - mins[..., 0] + 1.0, zero)
    bbox_w = torch.where(present, maxs[..., 1] - mins[..., 1] + 1.0, zero)
    extent = area / torch.clamp(bbox_h * bbox_w, min=1.0)

    # central second moments -> ellipse fit (regionprops math, +1/12 for
    # a pixel as a unit square)
    mu_yy = sums[..., 3] / safe_a - cy * cy + 1.0 / 12.0
    mu_xx = sums[..., 4] / safe_a - cx * cx + 1.0 / 12.0
    mu_yx = sums[..., 5] / safe_a - cy * cx
    d = mu_yy - mu_xx
    common = torch.sqrt(torch.clamp(d * d + 4.0 * (mu_yx * mu_yx), min=0.0))
    l1 = (mu_yy + mu_xx + common) / 2.0
    l2 = torch.clamp((mu_yy + mu_xx - common) / 2.0, min=1e-12)
    major = 4.0 * torch.sqrt(torch.clamp(l1, min=0.0))
    minor = 4.0 * torch.sqrt(torch.clamp(l2, min=0.0))
    eccentricity = torch.sqrt(torch.clamp(1.0 - l2 / torch.clamp(l1, min=1e-12), 0.0, 1.0))
    # major-axis angle from the +x (column) axis in (-pi/2, pi/2]
    orientation = 0.5 * torch.atan2(2.0 * mu_yx, mu_xx - mu_yy)
    equivalent_diameter = torch.sqrt(div(4.0 * area, math.pi))
    form_factor = (4.0 * math.pi) * area / torch.clamp(perimeter * perimeter, min=1.0)

    def m(v):
        return torch.where(present, v, zero)

    return {
        "Morphology_area": area,
        "Morphology_centroid_y": m(cy),
        "Morphology_centroid_x": m(cx),
        "Morphology_bbox_height": bbox_h,
        "Morphology_bbox_width": bbox_w,
        "Morphology_extent": m(extent),
        "Morphology_perimeter": perimeter,
        "Morphology_equivalent_diameter": m(equivalent_diameter),
        "Morphology_form_factor": m(form_factor),
        "Morphology_major_axis_length": m(major),
        "Morphology_minor_axis_length": m(minor),
        "Morphology_eccentricity": m(eccentricity),
        "Morphology_orientation": m(orientation),
    }


# -------------------------------------------------------------------- texture
def haralick_features(
    labels: torch.Tensor, intensity: torch.Tensor, max_objects: int,
    levels: int = 32, distance: int = 1, quantization: str = "object",
) -> dict[str, torch.Tensor]:
    """The 13 Haralick features averaged over the 4 directions
    ``(0,d), (d,0), (d,d), (d,-d)`` (reference ``measure.py:839``, fused
    path ``:901-909``): each object's own gray range stretched into
    ``levels`` buckets, all four GLCMs from one :func:`glcm_all` pass.

    Only ``quantization="object"`` and ``distance=1`` are ported: the
    reference's ``shift_with_fill`` pads by one pixel, so its pairs at a
    distance above 1 are not the pairs at that distance."""
    if quantization != "object":
        raise NotSupportedError(f"haralick quantization '{quantization}' is not ported")
    if distance != 1:
        raise NotSupportedError("haralick distance other than 1 is not ported")
    img = intensity.to(torch.float32)
    d = distance
    offsets = [(0, d), (d, 0), (d, d), (d, -d)]
    bounds = grouped_minmax(labels, img, max_objects)
    glcms = glcm_all(labels, img, max_objects, levels, offsets, bounds)

    dev = img.device
    i_vec = torch.arange(levels, dtype=torch.float32, device=dev)
    i_idx = i_vec[:, None]
    j_idx = i_vec[None, :]
    eps = 1e-10
    k_sum = torch.arange(2 * levels - 1, dtype=torch.float32, device=dev)
    k_diff = i_vec
    ii = torch.arange(levels, device=dev)
    sum_idx = (ii[:, None] + ii[None, :]).reshape(-1)
    diff_idx = (ii[:, None] - ii[None, :]).abs().reshape(-1)

    def xlogx(v):
        return v * torch.log(v + eps)

    acc: dict[str, torch.Tensor] = {}
    for glcm in glcms:
        total = torch.clamp(glcm.sum(dim=(-2, -1), keepdim=True), min=eps)
        p = glcm / total  # (B, M, L, L)
        px = p.sum(dim=-1)
        py = p.sum(dim=-2)
        mu_x = (px * i_vec).sum(dim=-1)
        mu_y = (py * i_vec).sum(dim=-1)
        dev_x = i_vec - mu_x[..., None]
        dev_y = i_vec - mu_y[..., None]
        sd_x = torch.sqrt(torch.clamp((px * (dev_x * dev_x)).sum(dim=-1), min=0.0))
        sd_y = torch.sqrt(torch.clamp((py * (dev_y * dev_y)).sum(dim=-1), min=0.0))

        asm = (p * p).sum(dim=(-2, -1))
        ij = i_idx - j_idx
        contrast = (p * (ij * ij)).sum(dim=(-2, -1))
        di = i_idx - mu_x[..., None, None]
        dj = j_idx - mu_y[..., None, None]
        corr_num = (p * di * dj).sum(dim=(-2, -1))
        correlation = corr_num / torch.clamp(sd_x * sd_y, min=eps)
        variance = (p * (di * di)).sum(dim=(-2, -1))
        idm = (p / (1.0 + ij * ij)).sum(dim=(-2, -1))
        entropy = -xlogx(p).sum(dim=(-2, -1))

        p_flat = p.reshape(*p.shape[:-2], -1)
        p_sum = p_flat.new_zeros(*p.shape[:-2], 2 * levels - 1).index_add_(-1, sum_idx, p_flat)
        p_diff = p_flat.new_zeros(*p.shape[:-2], levels).index_add_(-1, diff_idx, p_flat)

        sum_avg = (p_sum * k_sum).sum(dim=-1)
        sum_entropy = -xlogx(p_sum).sum(dim=-1)
        ks = k_sum - sum_entropy[..., None]  # Haralick's definition
        sum_var = (p_sum * (ks * ks)).sum(dim=-1)
        diff_avg = (p_diff * k_diff).sum(dim=-1)
        kd = k_diff - diff_avg[..., None]
        diff_var = (p_diff * (kd * kd)).sum(dim=-1)
        diff_entropy = -xlogx(p_diff).sum(dim=-1)

        hx = -xlogx(px).sum(dim=-1)
        hy = -xlogx(py).sum(dim=-1)
        pxpy = px[..., :, None] * py[..., None, :]
        hxy1 = -(p * torch.log(pxpy + eps)).sum(dim=(-2, -1))
        hxy2 = -xlogx(pxpy).sum(dim=(-2, -1))
        imc1 = (entropy - hxy1) / torch.clamp(torch.maximum(hx, hy), min=eps)
        imc2 = torch.sqrt(torch.clamp(1.0 - torch.exp(-2.0 * (hxy2 - entropy)), 0.0, 1.0))

        feats = {
            "Texture_angular_second_moment": asm,
            "Texture_contrast": contrast,
            "Texture_correlation": correlation,
            "Texture_sum_of_squares_variance": variance,
            "Texture_inverse_difference_moment": idm,
            "Texture_sum_average": sum_avg,
            "Texture_sum_variance": sum_var,
            "Texture_sum_entropy": sum_entropy,
            "Texture_entropy": entropy,
            "Texture_difference_variance": diff_var,
            "Texture_difference_entropy": diff_entropy,
            "Texture_info_measure_corr_1": imc1,
            "Texture_info_measure_corr_2": imc2,
        }
        for k, v in feats.items():
            acc[k] = acc.get(k, 0.0) + v / len(offsets)
    return acc


# -------------------------------------------------------------------- zernike
def _zernike_coeffs(degree: int) -> list[tuple[int, int, list[float]]]:
    """Static ``(n, m, radial coefficients)`` for ``n <= degree``,
    ``m >= 0``, ``n - m`` even; coefficient k applies to ``rho^(n-2k)``
    (reference ``measure.py:1007``)."""
    out = []
    for n in range(degree + 1):
        for m_ in range(n % 2, n + 1, 2):
            coeffs = [
                (-1) ** k * math.factorial(n - k)
                / (math.factorial(k) * math.factorial((n + m_) // 2 - k)
                   * math.factorial((n - m_) // 2 - k))
                for k in range((n - m_) // 2 + 1)
            ]
            out.append((n, m_, coeffs))
    return out


def zernike_features(
    labels: torch.Tensor, max_objects: int, degree: int = 9, patch: "int | None" = None
) -> dict[str, torch.Tensor]:
    """Zernike moment magnitudes ``|Z_nm|`` per object (reference
    ``measure.py:1186``, device formulation ``method="xla"``): every pixel
    carries its own object's unit-disk coordinates by label lookups of the
    centroid and radius, the basis is evaluated per pixel in float32, and
    all ``(n, m)`` projections reduce in one grouped sum over the 2K
    channels (``grouped_stats`` splits them into launches of 8).
    ``patch`` is accepted and ignored, as in the reference."""
    del patch
    labels = labels.to(torch.int32)
    yy, xx = _grid(labels)
    b = labels.shape[0]
    sums = grouped_sums(labels, [torch.ones_like(yy), yy, xx], max_objects)
    area, sy, sx = sums[..., 0], sums[..., 1], sums[..., 2]
    safe_a = torch.clamp(area, min=1.0)
    cy = sy / safe_a
    cx = sx / safe_a

    zero1 = area.new_zeros((b, 1))
    cen_pix = lookup_by_label(
        labels, torch.stack([torch.cat([zero1, cy], 1), torch.cat([zero1, cx], 1)], -1))
    dy = yy - cen_pix[..., 0]
    dx = xx - cen_pix[..., 1]
    r2 = dy * dy + dx * dx
    _, r2_max = grouped_minmax(labels, r2, max_objects)
    r_obj = torch.sqrt(torch.clamp(torch.where(area > 0, r2_max, 1.0), min=1.0))
    r_pix = lookup_by_label(labels, torch.cat([area.new_ones((b, 1)), r_obj], 1)[..., None])
    # rho > 1 is impossible by construction (r_pix is the object's max
    # radius); the clamp keeps the rim pixel at rho = 1 exactly
    rho = torch.clamp(torch.sqrt(r2) / r_pix[..., 0], max=1.0)
    theta = torch.atan2(dy, dx)
    fgf = (labels > 0).to(torch.float32)

    rho_pow = [torch.ones_like(rho)]
    for _ in range(degree):
        rho_pow.append(rho_pow[-1] * rho)
    cos_m = [torch.ones_like(theta)]
    sin_m = [torch.zeros_like(theta)]
    for m_ in range(1, degree + 1):
        cos_m.append(torch.cos(m_ * theta))
        sin_m.append(torch.sin(m_ * theta))

    table = _zernike_coeffs(degree)
    chans: list[torch.Tensor] = []
    for n, m_, coeffs in table:
        radial = torch.zeros_like(rho)
        for k, c in enumerate(coeffs):
            radial = radial + float(c) * rho_pow[n - 2 * k]
        chans.append(radial * cos_m[m_] * fgf)
        chans.append(radial * sin_m[m_] * fgf)

    proj = grouped_sums(labels, chans, max_objects)  # (B, M, 2K)
    out: dict[str, torch.Tensor] = {}
    for idx, (n, m_, _) in enumerate(table):
        re = proj[..., 2 * idx]
        im = proj[..., 2 * idx + 1]
        mag = div(torch.sqrt(re * re + im * im) * float(n + 1), math.pi) / safe_a
        out[f"Zernike_{n}_{m_}"] = torch.where(area > 0, mag, 0.0)
    return out
