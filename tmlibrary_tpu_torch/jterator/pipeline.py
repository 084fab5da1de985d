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
takes a batch.  A z-stack channel is a batch of volumes ``(B, Z, H, W)``
and its objects are label volumes.  Object-indexed outputs are padded
to ``max_objects`` per site; rows past a site's object count are
padding.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable

import numpy as np
import torch

from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import PipelineError
from tmlibrary_tpu_torch.jterator import modules as module_registry
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.ops import image_ops
from tmlibrary_tpu_torch.ops import qc as qc_ops
from tmlibrary_tpu_torch.ops import reduction

#: QC pseudo-channel of the modules' diagnostic streams (the ``__qc__*``
#: outputs, ``modules.MODULE_QC_PREFIX``): the jterator step routes this
#: key into the QC session's feature sketches
MODEL_QC_KEY = "__model__"


@dataclasses.dataclass
class SiteResult:
    """One batch's pipeline output; every leaf has a leading site axis."""

    objects: dict[str, Any]  # objects name -> (B, H, W) or (B, Z, H, W) int32 labels
    counts: dict[str, Any]  # objects name -> (B,) int32
    measurements: dict[str, dict[str, Any]]  # objects -> feature -> (B, M)
    #: objects name -> (B,) int32 objects found before the capacity clip,
    #: for the objects whose module reports it (``modules.FOUND``)
    found: dict[str, Any] = dataclasses.field(default_factory=dict)


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
    def build_site_fn(
        self, collect_diagnostics: bool = False
    ) -> Callable[[dict[str, torch.Tensor]], SiteResult]:
        """``fn({store key: (B, H, W) tensor}) -> SiteResult``.

        ``collect_diagnostics=True`` also gathers the module outputs named
        ``modules.MODULE_QC_PREFIX + <stat>`` (the DL segmenters' sample
        streams) and the function returns ``(SiteResult, {stat: (B, k)
        float32})``; the default build leaves them unread.  Either way the
        ``SiteResult`` is the same."""
        desc = self.description
        max_objects = self.max_objects
        prefix = module_registry.MODULE_QC_PREFIX

        def site_fn(initial_store: dict[str, torch.Tensor]) -> SiteResult:
            store: dict[str, Any] = dict(initial_store)
            objects: dict[str, torch.Tensor] = {}
            found: dict[str, torch.Tensor] = {}
            measurements: dict[str, dict[str, torch.Tensor]] = {}
            diagnostics: dict[str, torch.Tensor] = {}

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
                if collect_diagnostics:
                    for k, v in outs.items():
                        if k.startswith(prefix):
                            diagnostics[k[len(prefix):]] = v.to(torch.float32)
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
                        if h.name + module_registry.FOUND in outs:
                            found[h.objects] = outs[h.name + module_registry.FOUND].to(
                                torch.int32)
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
            result = SiteResult(
                objects={k: v for k, v in objects.items() if k in wanted},
                counts={k: v for k, v in counts.items() if k in wanted},
                measurements={k: v for k, v in measurements.items() if k in wanted},
                found={k: v for k, v in found.items() if k in wanted},
            )
            if collect_diagnostics:
                return result, diagnostics
            return result

        return site_fn

    # ------------------------------------------------------- preprocessing
    def build_preprocess_fn(
        self, window: tuple[int, int, int, int] | None = None
    ) -> Callable:
        """Per-batch channel preprocessing: illumination correction + cycle
        alignment.  ``fn(raw: {ch: (B, H, W)}, stats: {ch: (mean_log,
        std_log)}, shifts: (B, 2)) -> {ch: (B, H', W') float32}``; a
        channel absent from ``stats`` is not corrected.  A z-stack
        channel ``(B, Z, H, W)`` is neither corrected nor aligned; the
        window crops its last two axes."""
        desc = self.description

        def preprocess(raw, stats, shifts):
            out: dict[str, torch.Tensor] = {}
            for ch in desc.channels:
                img = raw[ch.name].to(torch.float32)
                if ch.zstack:
                    # volumes skip correction and alignment; the window
                    # still crops their last two axes, so every channel
                    # shares one frame
                    if window is not None:
                        img = image_ops.crop_window(img, *window)
                    out[ch.name] = img
                    continue
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
        self, window: tuple[int, int, int, int] | None = None, qc: bool = False,
        reduction_strategy: "str | None" = None,
    ) -> Callable:
        """preprocess ∘ site_fn over a batch of sites.

        Signature: ``fn(raw: {ch: (B,H,W)}, stats: {ch: (mean_log,
        std_log)}, shifts: (B,2)) -> SiteResult`` with a leading batch
        axis on every leaf.  Inputs are moved to the pipeline's device.

        ``qc=True`` also computes the per-site image QC statistics
        (:func:`~tmlibrary_tpu_torch.ops.qc.site_qc_stats`) of every
        channel's RAW images, before correction and alignment, and the
        function returns ``(SiteResult, {channel: {metric: (B,)}})``.  The
        statistics only read the inputs, so the ``SiteResult`` is the same
        with QC on and off.  The modules' diagnostic streams (the DL
        segmenters' ``(B, 64)`` flow-magnitude and probability samples)
        join the statistics under the :data:`MODEL_QC_KEY` pseudo-channel,
        ``{stat: (B, k)}``, where the description has such a module.

        ``reduction_strategy`` (``None`` is ``"auto"``) is resolved once,
        here (:func:`~tmlibrary_tpu_torch.ops.reduction.resolve_reduction_strategy`
        on the pipeline's backend), and every call runs in a
        :func:`~tmlibrary_tpu_torch.ops.reduction.strategy_scope` of the
        resolved name, so the function runs the strategy it was built
        with whatever the settings say later; the name is the function's
        ``reduction_strategy`` attribute.  The reference pins the request
        (None when nothing asks), the port the resolved name: its
        ``auto`` is ``"fused"``, and GLCM follows the pin."""
        strategy = reduction.resolve_reduction_strategy(reduction_strategy or "auto",
                                                        self.device.type)
        site_fn = self.build_site_fn(collect_diagnostics=qc)
        preprocess = self.build_preprocess_fn(window)
        device = self.device
        channels = [ch.name for ch in self.description.channels]

        def batch_fn(raw, stats, shifts) -> SiteResult:
            with reduction.strategy_scope(strategy):
                return run(raw, stats, shifts)

        def run(raw, stats, shifts):
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
            if not qc:
                return site_fn(images)
            result, diagnostics = site_fn(images)
            qc_stats = {ch: qc_ops.site_qc_stats(raw[ch]) for ch in channels}
            if diagnostics:
                qc_stats[MODEL_QC_KEY] = diagnostics
            return result, qc_stats

        batch_fn.reduction_strategy = strategy
        return batch_fn

    def build_sharded_batch_fn(
        self, mesh, window: tuple[int, int, int, int] | None = None, qc: bool = False,
        reduction_strategy: "str | None" = None,
    ) -> Callable:
        """:meth:`build_batch_fn` over a mesh of ranks (the reference's
        ``build_sharded_batch_fn``, ``tmlibrary_tpu/jterator/pipeline.py:567``):
        every member rank is called with the whole batch, pads its site
        axis to a multiple of the mesh size with copies of site 0 (the
        reference's padding lanes), runs its contiguous slice through the
        batch function and gathers every rank's slice, so each member
        returns the whole batch's result.  The pipeline runs per site, so
        the result equals one device's.  A mesh of one rank is the batch
        function itself."""
        batched = self.build_batch_fn(window, qc=qc, reduction_strategy=reduction_strategy)
        if mesh.size == 1:
            return batched
        from tmlibrary_tpu_torch.parallel import distributed
        from tmlibrary_tpu_torch.parallel.mesh import shard_batch

        def lanes(t):
            t = torch.as_tensor(t)
            pad = -t.shape[0] % mesh.size
            if pad:
                t = torch.cat([t, t[:1].expand((pad,) + tuple(t.shape[1:]))])
            return shard_batch(t, mesh)

        def gather(tree, n: int):
            if isinstance(tree, SiteResult):
                return SiteResult(*(gather(getattr(tree, f.name), n)
                                    for f in dataclasses.fields(SiteResult)))
            if isinstance(tree, tuple):
                return tuple(gather(x, n) for x in tree)
            if isinstance(tree, dict):
                return {k: gather(tree[k], n) for k in sorted(tree)}
            flag = tree.dtype == torch.bool
            parts = distributed.all_gather(tree.to(torch.uint8) if flag else tree, mesh.group)
            out = torch.cat(parts)[:n]
            return out.to(torch.bool) if flag else out

        def sharded(raw, stats, shifts):
            n = int(torch.as_tensor(shifts).shape[0])
            out = batched({k: lanes(v) for k, v in raw.items()}, stats, lanes(shifts))
            return gather(out, n)

        sharded.reduction_strategy = batched.reduction_strategy
        return sharded


def weight_digests(description: PipelineDescription) -> tuple[tuple[str, str, str], ...]:
    """``(module, weights spec, content digest)`` of every module that binds
    a ``weights`` constant (the DL segmenters), in pipeline order; a
    file-backed checkpoint re-digests when the file changes
    (``tmlibrary_tpu/jterator/pipeline.py:84``)."""
    out = []
    for mod in description.modules:
        spec = dict(mod.constants()).get("weights")
        if isinstance(spec, str) and spec:
            from tmlibrary_tpu_torch.nn import weights as nn_weights

            out.append((mod.module, spec, nn_weights.weights_digest(spec)))
    return tuple(out)


def pipeline_identity(description: PipelineDescription, qc: bool = False) -> tuple:
    """What besides the description and the capacity splits a built
    pipeline (the reference's ``program_digest_extras``, ``:146-168``):
    the QC gate, which changes what the batch function returns, and the
    weight digests, so a checkpoint overwritten under the same name never
    reuses a pipeline built on the old weights.  The reference's
    trace-shaping environment knobs have no meaning in the port."""
    extras: tuple = (("qc", bool(qc)),)
    digests = weight_digests(description)
    if digests:
        extras += (("weights", digests),)
    return extras


def description_digest(description: PipelineDescription) -> str:
    """Short content digest of a pipeline description: the identity two
    runs share when they run the same pipeline
    (``tmlibrary_tpu/jterator/pipeline.py:181``).  It scopes the bucket
    router's history (:func:`tmlibrary_tpu_torch.capacity.routing_key`)."""
    blob = json.dumps(dataclasses.asdict(description), sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


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
        found={k: host(v) for k, v in result.found.items()},
    )
