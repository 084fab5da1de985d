"""Per-site pixel preprocessing: illumination correction and alignment.

Counterpart: ``tmlibrary_tpu/ops/image_ops.py:21-86``
(``correct_illumination``, ``shift_image``, ``crop_window``, ``align``),
reference ``tmlib/image.py`` ``ChannelImage.correct``/``align``.  Images
are batches ``(B, H, W)``; shifts are per site.
"""

from __future__ import annotations

import torch

UINT16_MAX = 65535.0


def correct_illumination(
    img: torch.Tensor, mean_log: torch.Tensor, std_log: torch.Tensor
) -> torch.Tensor:
    """Illumination correction in the log10 domain against corilla's
    per-pixel statistics ``mean_log``/``std_log`` (each ``(H, W)``):

    corrected = 10 ** ((log10(1+img) - mean_log) / std_log * mean(std_log)
                       + mean(mean_log)) - 1, clipped to the uint16 range.
    """
    img_f = img.to(torch.float32)
    mean_log = mean_log.to(torch.float32)
    std_log = std_log.to(torch.float32)
    log_img = torch.log10(1.0 + img_f)
    std_safe = torch.where(std_log > 1e-6, std_log, torch.ones_like(std_log))
    z = (log_img - mean_log) / std_safe
    corrected_log = z * torch.mean(std_log) + torch.mean(mean_log)
    corrected = torch.pow(10.0, corrected_log) - 1.0
    return torch.clamp(corrected, 0.0, UINT16_MAX)


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
