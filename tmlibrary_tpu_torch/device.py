"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``.  A
request for the card on a host without one raises :class:`DeviceError`;
nothing drops to the CPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from tmlibrary_tpu_torch.errors import DeviceError


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise DeviceError(f"unsupported device {str(device)!r}")
    return dev
