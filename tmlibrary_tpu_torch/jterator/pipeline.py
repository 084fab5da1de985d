"""The jterator pipeline engine — the hot path.

Counterpart: ``tmlibrary_tpu/jterator/pipeline.py:300-565`` (reference
``tmlib/workflow/jterator/api.py`` ``ImageAnalysisPipeline.run_job``):
per site, correct and align the channel images, run the module chain
binding handles through a pipeline store, register segmented objects and
collect measurements.

The JAX package traces the chain for ONE site and gets the site axis from
``vmap``.  The port runs eagerly with an explicit leading site axis
``(B, H, W)`` through every op and kernel (``torch.func.vmap`` cannot map
the data-dependent fixpoint loops), so :meth:`build_site_fn` already
takes a batch.  Object-indexed outputs are padded to ``max_objects`` per
site; rows past a site's object count are padding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import NotSupportedError, PipelineError
from tmlibrary_tpu_torch.jterator import modules as module_registry
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.ops import image_ops


@dataclasses.dataclass
class SiteResult:
    """One batch's pipeline output; every leaf has a leading site axis."""

    objects: dict[str, Any]  # objects name -> (B, H, W) int32 labels
    counts: dict[str, Any]  # objects name -> (B,) int32
    measurements: dict[str, dict[str, Any]]  # objects -> feature -> (B, M)


class ImageAnalysisPipeline:
    """Run a :class:`PipelineDescription` over batches of sites.

    Parameters
    ----------
    description:
        Parsed pipeline + handles.
    max_objects:
        Per-site object capacity (measurement padding).
    device:
        ``"cuda"`` (the default) or ``"cpu"``.  Asking for the card on a
        host without one raises :class:`~tmlibrary_tpu_torch.errors.DeviceError`.
    """

    def __init__(
        self,
        description: PipelineDescription,
        max_objects: int = 256,
        device: "str | torch.device" = "cuda",
    ):
        description.validate()
        self.description = description
        self.max_objects = max_objects
        self.device = resolve_device(device)

    # ------------------------------------------------------------- site fn
    def build_site_fn(self) -> Callable[[dict[str, torch.Tensor]], SiteResult]:
        """``fn({store key: (B, H, W) tensor}) -> SiteResult``."""
        desc = self.description
        max_objects = self.max_objects

        def site_fn(initial_store: dict[str, torch.Tensor]) -> SiteResult:
            store: dict[str, Any] = dict(initial_store)
            objects: dict[str, torch.Tensor] = {}
            measurements: dict[str, dict[str, torch.Tensor]] = {}

            for mod in desc.modules:
                fn = module_registry.get_module(mod.module, mod.backend)
                kwargs = dict(mod.constants())
                for kwname, key in mod.array_inputs().items():
                    if key in store:
                        kwargs[kwname] = store[key]
                    elif key in objects:
                        kwargs[kwname] = objects[key]
                    else:
                        raise PipelineError(
                            f"module '{mod.module}' input key '{key}' missing"
                        )
                for h in mod.input:
                    if h.is_array and h.name in kwargs:
                        h.validate_array(kwargs[h.name])
                if "max_objects" not in kwargs and module_registry.module_accepts(
                    mod.module, mod.backend, "max_objects"
                ):
                    kwargs["max_objects"] = max_objects
                try:
                    outs = fn(**kwargs)
                except TypeError as e:
                    raise PipelineError(
                        f"module '{mod.module}' called with invalid arguments: {e}"
                    ) from e
                if not isinstance(outs, dict):
                    raise PipelineError(
                        f"module '{mod.module}' must return a dict of outputs"
                    )
                for h in mod.output:
                    if h.type in ("Plot", "Figure"):
                        continue
                    if h.name not in outs:
                        raise PipelineError(
                            f"module '{mod.module}' did not return output "
                            f"'{h.name}' (returned: {sorted(outs)})"
                        )
                    val = outs[h.name]
                    if h.type == "SegmentedObjects":
                        labels = val.to(torch.int32)
                        objects[h.objects] = labels
                        if h.key:
                            store[h.key] = labels
                    elif h.type == "Measurement":
                        if not isinstance(val, dict):
                            raise PipelineError(
                                f"measurement output '{h.name}' of "
                                f"'{mod.module}' must be a dict of features"
                            )
                        tgt = measurements.setdefault(h.objects, {})
                        for feat, arr in val.items():
                            name = f"{feat}_{h.channel}" if h.channel else feat
                            tgt[name] = arr.to(torch.float32)
                    else:
                        store[h.key] = val

            counts = {
                name: lab.reshape(lab.shape[0], -1).amax(dim=1).to(torch.int32)
                for name, lab in objects.items()
            }
            wanted = {o.name for o in desc.objects_out} or set(objects)
            return SiteResult(
                objects={k: v for k, v in objects.items() if k in wanted},
                counts={k: v for k, v in counts.items() if k in wanted},
                measurements={k: v for k, v in measurements.items() if k in wanted},
            )

        return site_fn

    # ------------------------------------------------------- preprocessing
    def build_preprocess_fn(
        self, window: tuple[int, int, int, int] | None = None
    ) -> Callable:
        """Per-batch channel preprocessing: illumination correction + cycle
        alignment.  ``fn(raw: {ch: (B, H, W)}, stats: {ch: (mean_log,
        std_log)}, shifts: (B, 2)) -> {ch: (B, H', W') float32}``; a
        channel absent from ``stats`` is not corrected."""
        desc = self.description

        def preprocess(raw, stats, shifts):
            out: dict[str, torch.Tensor] = {}
            for ch in desc.channels:
                if ch.zstack:
                    raise NotSupportedError("z-stack channels are not ported yet")
                img = raw[ch.name].to(torch.float32)
                if ch.correct and ch.name in stats:
                    mean_log, std_log = stats[ch.name]
                    img = image_ops.correct_illumination(img, mean_log, std_log)
                if ch.align:
                    img = image_ops.align(img, shifts, window)
                elif window is not None:
                    img = image_ops.crop_window(img, *window)
                out[ch.name] = img
            return out

        return preprocess

    # ------------------------------------------------------------ batch fn
    def build_batch_fn(
        self, window: tuple[int, int, int, int] | None = None
    ) -> Callable:
        """preprocess ∘ site_fn over a batch of sites.

        Signature: ``fn(raw: {ch: (B,H,W)}, stats: {ch: (mean_log,
        std_log)}, shifts: (B,2)) -> SiteResult`` with a leading batch
        axis on every leaf.  Inputs are moved to the pipeline's device."""
        site_fn = self.build_site_fn()
        preprocess = self.build_preprocess_fn(window)
        device = self.device

        def batch_fn(raw, stats, shifts) -> SiteResult:
            raw = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
            stats = {
                k: tuple(torch.as_tensor(a, device=device) for a in pair)
                for k, pair in stats.items()
            }
            shifts = torch.as_tensor(shifts, device=device)
            images = preprocess(raw, stats, shifts)
            # loaded objects pass through, cropped like the pixel channels
            for key, val in raw.items():
                if key not in images:
                    if window is not None and val.dim() == 3:
                        val = image_ops.crop_window(val, *window)
                    images[key] = val
            return site_fn(images)

        return batch_fn


def from_jax_inputs(
    raw: dict, stats: dict, shifts, device: "str | torch.device" = "cuda"
) -> tuple[dict, dict, torch.Tensor]:
    """Carry the JAX batch function's inputs across: numpy arrays of
    ``raw {ch: (B,H,W)}``, corilla's ``stats {ch: (mean_log, std_log)}``
    and ``shifts (B, 2)`` become tensors on ``device``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dev)

    return (
        {k: tensor(v) for k, v in raw.items()},
        {k: (tensor(m), tensor(s)) for k, (m, s) in stats.items()},
        tensor(np.asarray(shifts, np.int32)),
    )


def site_result_to_numpy(result: SiteResult) -> SiteResult:
    """The same result with every leaf as a host numpy array."""

    def host(t):
        return t.detach().cpu().numpy()

    return SiteResult(
        objects={k: host(v) for k, v in result.objects.items()},
        counts={k: host(v) for k, v in result.counts.items()},
        measurements={
            o: {f: host(v) for f, v in feats.items()}
            for o, feats in result.measurements.items()
        },
    )
