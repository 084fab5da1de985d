"""Per-site pixel preprocessing: illumination correction and alignment.

Counterpart: ``tmlibrary_tpu/ops/image_ops.py:21-101,121-152``
(``correct_illumination``, ``shift_image``, ``crop_window``, ``align``,
``clip_values``, ``rescale``, ``join_grid``, ``make_batch_prep``), reference ``tmlib/image.py``
``ChannelImage.correct``/``align`` and ``Image.join``.  Images are
batches ``(B, H, W)``; shifts are per site.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.ops._exact import div

UINT16_MAX = 65535.0


def correct_illumination(
    img: torch.Tensor, mean_log: torch.Tensor, std_log: torch.Tensor
) -> torch.Tensor:
    """Illumination correction in the log10 domain against corilla's
    per-pixel statistics ``mean_log``/``std_log`` (each ``(H, W)``):

    corrected = 10 ** ((log10(1+img) - mean_log) / std_log * mean(std_log)
                       + mean(mean_log)) - 1, clipped to the uint16 range.

    Evaluated in float64 and rounded once to float32, so the card and the
    CPU agree: in float32 their ``log10`` and ``pow`` differ by ulps and
    the field means by summation order, which moved Otsu thresholds and
    labels between the two.  The reference evaluates it in float32; the
    port is within :data:`chip_smoke.CORRECTION_TIER` of it.
    """
    img_d = img.to(torch.float64)
    mean_d = mean_log.to(torch.float64)
    std_d = std_log.to(torch.float64)
    log_img = torch.log10(1.0 + img_d)
    std_safe = torch.where(std_d > 1e-6, std_d, torch.ones_like(std_d))
    z = (log_img - mean_d) / std_safe
    # true divisions by the pixel count, made on the device (no copy)
    count = torch.full((), std_d.numel(), dtype=torch.float64, device=std_d.device)
    corrected_log = z * (std_d.sum() / count) + mean_d.sum() / count
    corrected = torch.pow(10.0, corrected_log) - 1.0
    return torch.clamp(corrected, 0.0, UINT16_MAX).to(torch.float32)


def shift_image(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Translate each site by its integer ``(dy, dx)`` (``shifts`` is
    ``(B, 2)``), zero-filling exposed borders."""
    b, h, w = img.shape
    dy = shifts[:, 0].to(torch.int64)[:, None, None]
    dx = shifts[:, 1].to(torch.int64)[:, None, None]
    rows = torch.arange(h, device=img.device)[None, :, None]
    cols = torch.arange(w, device=img.device)[None, None, :]
    src_r, src_c = rows - dy, cols - dx
    valid = (src_r >= 0) & (src_r < h) & (src_c >= 0) & (src_c < w)
    index = (src_r % h) * w + (src_c % w)
    out = img.reshape(b, -1).gather(1, index.expand(b, h, w).reshape(b, -1))
    out = out.reshape(b, h, w)
    return torch.where(valid, out, torch.zeros_like(out))


def crop_window(
    img: torch.Tensor, top: int, bottom: int, left: int, right: int
) -> torch.Tensor:
    """Crop the inter-cycle intersection window (static offsets) of the
    last two axes."""
    h, w = img.shape[-2:]
    return img[..., top : h - bottom, left : w - right]


def align(
    img: torch.Tensor,
    shifts: torch.Tensor,
    window: tuple[int, int, int, int] | None = None,
) -> torch.Tensor:
    """Shift then (optionally) crop."""
    out = shift_image(img, shifts)
    if window is not None:
        out = crop_window(out, *window)
    return out


def clip_values(img: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """Clip to ``[lower, upper]`` (reference ``ChannelImage.clip``)."""
    return torch.clamp(img, lower, upper)


def rescale(img: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """Linear stretch of ``[lower, upper]`` to ``[0, 1]`` float32, clipped:
    a true division by ``max(upper - lower, 1e-6)``, taken in Python and
    rounded to float32, as the reference's scalar arithmetic."""
    span = max(float(upper) - float(lower), 1e-6)
    return torch.clamp(div(img.to(torch.float32) - lower, span), 0.0, 1.0)


def join_grid(tiles: torch.Tensor, grid_rows: int, grid_cols: int) -> torch.Tensor:
    """Stitch a ``(grid_rows * grid_cols, H, W)`` stack, row-major, into
    one mosaic (illuminati's level 0)."""
    n, h, w = tiles.shape
    if n != grid_rows * grid_cols:
        raise ValueError(f"{n} tiles do not fill a {grid_rows}x{grid_cols} grid")
    return (tiles.reshape(grid_rows, grid_cols, h, w).permute(0, 2, 1, 3)
            .reshape(grid_rows * h, grid_cols * w))


def make_batch_prep(mean_log: "torch.Tensor | None", std_log: "torch.Tensor | None",
                    window: "tuple[int, int, int, int] | None", apply_shift: bool = True):
    """``prep(stack (B, H, W), shifts (B, 2)) -> (B, H', W') float32``:
    illumination correction against corilla's ``mean_log``/``std_log``
    fields of the channel (none when they are None), then each site's
    shift (when ``apply_shift``), then the intersection crop ``window``
    (top, bottom, left, right; none when None) -- the site preparation
    that illuminati stitches from, each part optional as in the
    reference."""

    def prep(stack: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
        out = stack.to(torch.float32)
        if mean_log is not None:
            out = correct_illumination(out, mean_log, std_log)
        if apply_shift:
            out = shift_image(out, shifts)
        if window is not None:
            out = crop_window(out, *window)
        return out

    return prep
