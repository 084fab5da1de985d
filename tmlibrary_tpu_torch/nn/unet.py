"""The flow-field U-Net of the DL segmenters, in PyTorch.

Counterpart: ``tmlibrary_tpu/nn/unet.py``.  The same architecture, the
same flat ``{name: (kh, kw, cin, cout) | (cout,)}`` float32 parameter
dict (an ``.npz``, :mod:`.weights`) and the same head: per pixel the flow
``(dy, dx)`` toward the cell's centre and a cell-probability logit.
:func:`params_from_numpy` carries a parameter dict into a :class:`UNet`
(HWIO kernels to OIHW); its forward pass is the reference's
``unet_apply`` on a batch ``(B, C, H, W)``::

    enc0:  conv3x3(in->C) . conv3x3(C->C)              skip s0
    lvl i: conv3x3 stride 2(c->2c) . conv3x3 . conv3x3 skip s_i
    dec i: upsample x2 . conv3x3(2c->c) . concat(s_{i-1}) . conv3x3(2c->c)
    head:  conv1x1(C->3)

How each step matches XLA's:

- ``"SAME"`` padding at stride 2 on an even input pads 0 before and 1
  after, so the ``down{i}`` convolutions pad ``(0, 1, 0, 1)``
  explicitly; the stride-1 3x3 convolutions pad 1 on each side.
- The input is edge-padded (``replicate``) to a multiple of
  ``2**depth`` and the head cropped back; the x2 upsample duplicates
  pixels; the skip is concatenated after the upsampled map.
- The bias is added after the convolution, as the reference adds it.
- Float32 throughout: on the card the convolutions run under
  ``cudnn.flags(allow_tf32=False, deterministic=True, benchmark=False)``
  whatever the caller's global flags say.
- Batch invariance: the forward pass runs the sites in calls of
  :data:`CHUNK` sites, the last call padded with zero sites, so every
  convolution is called with one shape whatever the batch size.  A
  site's head therefore does not depend on the batch it came in (the
  bucket router and escalation re-launch sites in other batches).

The convolutions are left to PyTorch: the reference leaves them to
``lax.conv_general_dilated``, outside any Pallas kernel.  Between XLA-CPU,
PyTorch's CPU and cuDNN they sum in different orders, so the head agrees
within a tier, not bit for bit (``tests/test_torch_nn.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F

from tmlibrary_tpu_torch.ops import _exact

#: output channels of the head: (flow_dy, flow_dx, cellprob_logit)
OUT_CHANNELS = 3

#: sites per convolution call (the last call of a batch is padded to it)
CHUNK = 8


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture hyperparameters."""

    in_channels: int = 1
    base_channels: int = 8
    depth: int = 2

    def level_channels(self, level: int) -> int:
        return self.base_channels * (1 << level)


def infer_config(params: dict) -> UNetConfig:
    """The architecture of a parameter dict, from its shapes."""
    w0 = np.asarray(params["enc0/conv1/w"])
    depth = 0
    while f"down{depth + 1}/w" in params:
        depth += 1
    return UNetConfig(in_channels=int(w0.shape[2]), base_channels=int(w0.shape[3]),
                      depth=depth)


def _he_std(kh: int, kw: int, cin: int) -> float:
    return float(np.sqrt(2.0 / (kh * kw * cin)))


def init_unet_params(seed: int, config: UNetConfig | None = None) -> dict[str, np.ndarray]:
    """Deterministic He-normal initialization, host numpy float32, drawn
    from ``np.random.default_rng(seed)`` in the reference's order: the
    same (seed, config) gives byte-identical arrays in both packages."""
    cfg = config or UNetConfig()
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}

    def conv(name: str, kh: int, kw: int, cin: int, cout: int) -> None:
        params[f"{name}/w"] = rng.normal(
            0.0, _he_std(kh, kw, cin), size=(kh, kw, cin, cout)).astype(np.float32)
        params[f"{name}/b"] = np.zeros((cout,), np.float32)

    c = cfg.base_channels
    conv("enc0/conv1", 3, 3, cfg.in_channels, c)
    conv("enc0/conv2", 3, 3, c, c)
    for i in range(1, cfg.depth + 1):
        conv(f"down{i}", 3, 3, c, 2 * c)
        c *= 2
        conv(f"enc{i}/conv1", 3, 3, c, c)
        conv(f"enc{i}/conv2", 3, 3, c, c)
    for i in range(cfg.depth, 0, -1):
        conv(f"up{i}", 3, 3, c, c // 2)
        c //= 2
        conv(f"dec{i}", 3, 3, 2 * c, c)
    conv("head", 1, 1, c, OUT_CHANNELS)
    return params


class UNet(torch.nn.Module):
    """The U-Net with its weights as buffers (``"<layer>/w"`` OIHW and
    ``"<layer>/b"`` per layer name, ``/`` spelled ``__``); ``forward``
    maps ``(B, C, H, W)`` float32 images to ``(B, 3, H, W)`` heads."""

    def __init__(self, config: UNetConfig, weights: dict[str, torch.Tensor]):
        super().__init__()
        self.config = config
        for name, t in weights.items():
            self.register_buffer(name.replace("/", "__"), t)

    def _conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        w = getattr(self, f"{name}/w".replace("/", "__"))
        b = getattr(self, f"{name}/b".replace("/", "__"))
        k = w.shape[-1]
        if stride == 2:
            # XLA's SAME at stride 2 on an even size: 0 before, 1 after
            y = F.conv2d(F.pad(x, (0, 1, 0, 1)), w, stride=2)
        else:
            y = F.conv2d(x, w, padding=k // 2)
        return y + b[None, :, None, None]

    def _forward_chunk(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        skips = []
        x = F.relu(self._conv(x, "enc0/conv1"))
        x = F.relu(self._conv(x, "enc0/conv2"))
        for i in range(1, cfg.depth + 1):
            skips.append(x)
            x = F.relu(self._conv(x, f"down{i}", stride=2))
            x = F.relu(self._conv(x, f"enc{i}/conv1"))
            x = F.relu(self._conv(x, f"enc{i}/conv2"))
        for i in range(cfg.depth, 0, -1):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = F.relu(self._conv(x, f"up{i}"))
            x = torch.cat([x, skips[i - 1]], dim=1)
            x = F.relu(self._conv(x, f"dec{i}"))
        return self._conv(x, "head")

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = image.to(torch.float32)
        b, _, h, w = x.shape
        mult = 1 << self.config.depth
        ph, pw = (-h) % mult, (-w) % mult
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="replicate")
        pad = (-b) % CHUNK
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        with _float32_convolutions(x.device):
            heads = [self._forward_chunk(c) for c in x.split(CHUNK)]
        return torch.cat(heads)[:b, :, :h, :w]


#: serializes the cuDNN flag scope: the flags are process-global, and the
#: pipelined executor can launch from two threads (dispatch, escalation)
_CUDNN_LOCK = threading.Lock()


@contextlib.contextmanager
def _float32_convolutions(device: torch.device):
    """On the card: cuDNN in IEEE float32 (no TF32), deterministic, no
    autotuning, under a lock; on the CPU: nothing."""
    if device.type != "cuda":
        yield
        return
    with _CUDNN_LOCK, torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        yield


def params_from_numpy(params: dict, device: "str | torch.device" = "cpu") -> UNet:
    """A :class:`UNet` on ``device`` carrying ``params`` (the reference's
    HWIO kernels transposed to OIHW, ``(cout,)`` biases)."""
    config = infer_config(params)
    weights = {}
    for name, arr in params.items():
        a = np.asarray(arr, np.float32)
        if name.endswith("/w"):
            a = a.transpose(3, 2, 0, 1)
        weights[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return UNet(config, weights).eval()


#: (digest, device) -> resident UNet
_NETS: dict[tuple[str, str], UNet] = {}
_NETS_LOCK = threading.Lock()
_NETS_MAX = 8


def unet_for(spec: str, device: torch.device) -> tuple[UNet, str]:
    """``(net, digest)`` for a weight spec on ``device``: resolved once per
    (content digest, device) and kept resident, so a batch never re-reads
    the ``.npz`` or copies the weights again."""
    from tmlibrary_tpu_torch.nn.weights import resolve_weights

    params, digest, _config = resolve_weights(spec)
    key = (digest, str(device))
    with _NETS_LOCK:
        net = _NETS.get(key)
        if net is None:
            while len(_NETS) >= _NETS_MAX:
                _NETS.pop(next(iter(_NETS)))
            net = _NETS[key] = params_from_numpy(params, device)
    return net, digest


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """Per-site standardization of ``(B, H, W)`` images (population std),
    the reference's ``(img - mean) / (std + 1e-6)``.  Each mean is a
    float64 sum rounded to float32, times the float32 reciprocal of the
    pixel count (how XLA-CPU evaluates ``jnp.mean``): the same on both
    devices, and within ulps of XLA-CPU, whose summation order it does not
    reproduce."""
    img = image.to(torch.float32)
    # filled on the device: no host-to-device copy
    inv_n = torch.full((), 1.0 / img[0].numel(), dtype=torch.float32, device=img.device)

    def site_mean(x):
        return x.to(torch.float64).sum(dim=(-2, -1)).to(torch.float32) * inv_n

    mean = site_mean(img)[:, None, None]
    centered = img - mean
    std = _exact.sqrt(site_mean(centered * centered))[:, None, None]
    return centered / (std + 1e-6)


# --------------------------------------------------------------- cost model
def unet_flops(config: UNetConfig, h: int, w: int) -> int:
    """Forward-pass FLOPs (2 kh kw cin cout per output pixel, every conv
    at its level's resolution), the reference's count."""
    mult = 1 << config.depth
    h = h + ((-h) % mult)
    w = w + ((-w) % mult)
    total = 0

    def conv(pixels: int, kh: int, kw: int, cin: int, cout: int) -> int:
        return 2 * pixels * kh * kw * cin * cout

    c = config.base_channels
    px = h * w
    total += conv(px, 3, 3, config.in_channels, c)
    total += conv(px, 3, 3, c, c)
    for _ in range(config.depth):
        px //= 4
        total += conv(px, 3, 3, c, 2 * c)
        c *= 2
        total += 2 * conv(px, 3, 3, c, c)
    for _ in range(config.depth):
        px *= 4
        total += conv(px, 3, 3, c, c // 2)
        c //= 2
        total += conv(px, 3, 3, 2 * c, c)
    total += conv(px, 1, 1, c, OUT_CHANNELS)
    return int(total)


def unet_io_bytes(config: UNetConfig, h: int, w: int) -> int:
    """Least memory traffic of one forward pass: the input read once, the
    head written once and the parameters read once (activations kept on
    chip), the reference's count."""
    cfg = config
    n_params = 0
    c = cfg.base_channels
    n_params += 3 * 3 * cfg.in_channels * c + c + 3 * 3 * c * c + c
    for _ in range(cfg.depth):
        n_params += 3 * 3 * c * 2 * c + 2 * c
        c *= 2
        n_params += 2 * (3 * 3 * c * c + c)
    for _ in range(cfg.depth):
        n_params += 3 * 3 * c * (c // 2) + c // 2
        c //= 2
        n_params += 3 * 3 * 2 * c * c + c
    n_params += c * OUT_CHANNELS + OUT_CHANNELS
    return 4 * (h * w * cfg.in_channels + h * w * OUT_CHANNELS + n_params)
