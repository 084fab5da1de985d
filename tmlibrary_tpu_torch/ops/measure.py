"""Per-object feature measurement.

Counterpart: ``tmlibrary_tpu/ops/measure.py`` on its fused strategy
(reference: ``jtlib/features/{intensity,morphology,texture,zernike,
point_pattern}.py``): every grouped reduction is one :func:`grouped_stats`
pass, the quantile histogram is :func:`intensity_hist` and the Haralick
co-occurrences are :func:`glcm_all` (a ``bincount`` of the pairs under
the global quantisation).  Every function takes a batch of sites ``(B, H, W)`` and
returns ``(B, max_objects)`` per feature; rows past a site's object count
are padding and must be masked by the caller using the object count.

Expression trees follow the reference operation by operation, so the
features built from exact sums, counts and IEEE ``+ - * / sqrt`` equal
it bit for bit.  Divisions by a constant go through ``_exact.div`` (CUDA
divides by a Python scalar through its reciprocal), square roots of the
exact-tier features through ``_exact.sqrt`` (PyTorch's CPU root is an
ulp off on some inputs).  ``log``, ``exp``,
``atan2``, ``sin`` and ``cos`` differ by ulps between the CPU and the
card, so the Haralick and Zernike families and the morphology angle
carry a stated tolerance.
"""

from __future__ import annotations

import math

import torch

from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.ops._exact import div, sqrt
from tmlibrary_tpu_torch.ops.fused_measure import (
    glcm_all,
    glcm_counts,
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
        "Intensity_std": sqrt(var),
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
    common = sqrt(torch.clamp(d * d + 4.0 * (mu_yx * mu_yx), min=0.0))
    l1 = (mu_yy + mu_xx + common) / 2.0
    l2 = torch.clamp((mu_yy + mu_xx - common) / 2.0, min=1e-12)
    major = 4.0 * sqrt(torch.clamp(l1, min=0.0))
    minor = 4.0 * sqrt(torch.clamp(l2, min=0.0))
    eccentricity = sqrt(torch.clamp(1.0 - l2 / torch.clamp(l1, min=1e-12), 0.0, 1.0))
    # major-axis angle from the +x (column) axis in (-pi/2, pi/2]
    orientation = 0.5 * torch.atan2(2.0 * mu_yx, mu_xx - mu_yy)
    equivalent_diameter = sqrt(div(4.0 * area, math.pi))
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
    ``(0,d), (d,0), (d,d), (d,-d)`` (reference ``measure.py:839``).

    ``quantization="object"`` (fused path ``:901-909``) stretches each
    object's own gray range into ``levels`` buckets and takes all four
    GLCMs from one :func:`glcm_all` pass.  ``"global"`` (``:917-923``)
    quantises each site by its own range,
    ``clip(int((v - lo) / max(hi - lo, 1e-6) * levels), 0, levels - 1)``,
    and counts the pairs in plain PyTorch (:func:`glcm_counts`), as the
    reference does outside its kernel.

    Only ``distance=1`` is ported: the reference's ``shift_with_fill``
    pads by one pixel, so its pairs at a distance above 1 are not the
    pairs at that distance."""
    if quantization not in ("object", "global"):
        raise ValueError(f"unknown quantization '{quantization}'")
    if distance != 1:
        raise NotSupportedError("haralick distance other than 1 is not ported")
    img = intensity.to(torch.float32)
    d = distance
    offsets = [(0, d), (d, 0), (d, d), (d, -d)]
    if quantization == "object":
        bounds = grouped_minmax(labels, img, max_objects)
        glcms = glcm_all(labels, img, max_objects, levels, offsets, bounds)
    else:
        glcms = glcm_counts(labels, quantize_global(img, levels), max_objects, levels, offsets)

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


def quantize_global(img: torch.Tensor, levels: int) -> torch.Tensor:
    """Each site's pixels of ``(B, H, W)`` into ``levels`` buckets of the
    site's own range: ``clip(int((v - lo) / max(hi - lo, 1e-6) *
    levels), 0, levels - 1)`` (a true division by a tensor, truncation
    toward zero) → int64."""
    b = (slice(None), None, None)
    flat = img.reshape(img.shape[0], -1)
    lo, hi = flat.amin(dim=1), flat.amax(dim=1)
    span = torch.clamp(hi - lo, min=1e-6)
    q = ((img - lo[b]) / span[b] * levels).to(torch.int32)
    return torch.clamp(q, 0, levels - 1).to(torch.int64)


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
    channels (one ``grouped_stats`` launch for up to 32).
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


# -------------------------------------------------------------- point pattern
#: pixels per chunk of the border-distance min (the reference's
#: ``_GLCM_CHUNK``): at 64 sites and 256 points a chunk's distances take
#: 537 MB
BORDER_CHUNK = 1 << 13


def point_pattern_features(
    parent_labels: torch.Tensor, point_labels: torch.Tensor, max_parents: int,
    max_points: int,
) -> dict[str, torch.Tensor]:
    """Point-pattern statistics of child point objects (spots) within
    parent objects (reference ``measure.py:1305``, ``jtlib/features/
    point_pattern.py``), ``(B, max_parents)`` each: the points whose
    centroid pixel (rounded half to even) lies in the parent, their
    count and density, nearest-neighbour distances among them, the
    Clark–Evans index, and their distances to the parent's centroid and
    to the nearest label-boundary pixel (a pixel whose 4-neighbour, or
    the image edge, differs).  Centroids come from two
    :func:`grouped_sums` passes; nearest neighbours from a ``(B, P, P)``
    distance matrix; the border distance is an exact Euclidean min over
    the boundary pixels, in chunks of :data:`BORDER_CHUNK` pixels; each
    parent aggregates over a ``(B, P, M)`` mask.  Rows of absent parents
    are zero."""
    parents = parent_labels.to(torch.int32)
    points = point_labels.to(torch.int32)
    b, h, w = parents.shape
    dev = parents.device
    yy, xx = _grid(parents)
    ones = torch.ones_like(yy)

    psums = grouped_sums(points, [ones, yy, xx], max_points)  # (B, P, 3)
    p_present = psums[..., 0] > 0
    safe_pn = torch.clamp(psums[..., 0], min=1.0)
    py = psums[..., 1] / safe_pn
    px = psums[..., 2] / safe_pn

    gsums = grouped_sums(parents, [ones, yy, xx], max_parents)  # (B, M, 3)
    area = gsums[..., 0]
    safe_a = torch.clamp(area, min=1.0)
    g_cy = gsums[..., 1] / safe_a
    g_cx = gsums[..., 2] / safe_a

    # each point's owner: the parent under its rounded centroid
    iy = torch.clamp(torch.round(py).to(torch.int64), 0, h - 1)
    ix = torch.clamp(torch.round(px).to(torch.int64), 0, w - 1)
    owner = parents.reshape(b, -1).gather(1, iy * w + ix)
    owner = torch.where(p_present, owner, torch.zeros_like(owner))  # (B, P)

    inf = torch.tensor(float("inf"), device=dev)
    dy = py[:, :, None] - py[:, None, :]
    dx = px[:, :, None] - px[:, None, :]
    eye = torch.eye(max_points, dtype=torch.bool, device=dev)
    pair_ok = (owner[:, :, None] == owner[:, None, :]) & (owner[:, :, None] > 0) & ~eye
    nn = sqrt(torch.where(pair_ok, dy * dy + dx * dx, inf).amin(dim=-1))
    has_nn = torch.isfinite(nn)
    nn = torch.where(has_nn, nn, 0.0)

    oi = torch.clamp(owner - 1, 0, max_parents - 1).to(torch.int64)
    cy = py - g_cy.gather(1, oi)
    cx = px - g_cx.gather(1, oi)
    cdist = sqrt(cy * cy + cx * cx)

    boundary = torch.zeros(parents.shape, dtype=torch.bool, device=dev)
    for sy, sx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        boundary = boundary | (shift_with_fill(parents, sy, sx, -1) != parents)
    # (py - y)² + (px - x)² of every boundary pixel, rows of pixels at a time
    ry = py[:, :, None] - torch.arange(h, dtype=torch.float32, device=dev)
    rx = px[:, :, None] - torch.arange(w, dtype=torch.float32, device=dev)
    ry, rx = ry * ry, rx * rx
    best = torch.full((b, max_points), float("inf"), device=dev)
    rows = max(1, BORDER_CHUNK // w)
    for r0 in range(0, h, rows):
        d2 = ry[:, :, r0 : r0 + rows, None] + rx[:, :, None, :]
        d2 = torch.where(boundary[:, None, r0 : r0 + rows], d2, inf)
        best = torch.minimum(best, d2.amin(dim=(-2, -1)))
    bdist = sqrt(best)

    assign = owner[:, :, None] == torch.arange(1, max_parents + 1, device=dev)  # (B, P, M)

    def _agg(vals, valid):
        sel = assign & valid[:, :, None]
        n = sel.sum(dim=1).to(torch.float32)
        s = torch.where(sel, vals[:, :, None], 0.0).sum(dim=1)
        sq = torch.where(sel, (vals * vals)[:, :, None], 0.0).sum(dim=1)
        safe_n = torch.clamp(n, min=1.0)
        mean = s / safe_n
        var = torch.clamp(sq / safe_n - mean * mean, min=0.0)
        return n, mean, sqrt(var)

    n_pts = assign.sum(dim=1).to(torch.float32)
    n_nn, nn_mean, nn_std = _agg(nn, has_nn)
    _, cd_mean, cd_std = _agg(cdist, p_present)
    _, bd_mean, bd_std = _agg(bdist, p_present)

    density = n_pts / safe_a
    # Clark–Evans: the observed mean NN distance over 0.5 / sqrt(density),
    # its expectation under complete spatial randomness (a true division:
    # PyTorch's ``0.5 / t`` multiplies by the reciprocal)
    expected_nn = torch.full_like(density, 0.5) / sqrt(torch.clamp(density, min=1e-12))
    clark_evans = torch.where(n_nn > 0, nn_mean / expected_nn, 0.0)

    present = area > 0
    zero = torch.zeros_like(area)

    def m(v):
        return torch.where(present, v, zero)

    return {
        "PointPattern_count": m(n_pts),
        "PointPattern_density": m(density),
        "PointPattern_nn_dist_mean": m(nn_mean),
        "PointPattern_nn_dist_std": m(nn_std),
        "PointPattern_clark_evans": m(clark_evans),
        "PointPattern_centroid_dist_mean": m(cd_mean),
        "PointPattern_centroid_dist_std": m(cd_std),
        "PointPattern_border_dist_mean": m(bd_mean),
        "PointPattern_border_dist_std": m(bd_std),
    }
