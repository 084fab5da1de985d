"""Module registry and the ported module implementations.

Counterpart: ``tmlibrary_tpu/jterator/modules.py:34-344`` (reference: the
external ``jtmodules`` package).  Modules register under a name and a
``backend`` key; the descriptions written for the JAX package name
``backend: tpu`` (the default), so the port registers its twins under
the same key and an unchanged ``.pipe`` description runs on either
package.

Module contract: ``fn(**kwargs) -> dict`` mapping output-handle names to
tensors (or, for ``Measurement`` outputs, to ``{feature: (B, max_objects)
tensor}`` dicts).  Array kwargs are ``(B, H, W)`` batches; everything
else is a constant from the handle description.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

from tmlibrary_tpu_torch.errors import NotSupportedError, RegistryError
from tmlibrary_tpu_torch.ops import label as label_ops
from tmlibrary_tpu_torch.ops import smooth as smooth_ops
from tmlibrary_tpu_torch.ops import threshold as threshold_ops

#: name -> backend -> (fn, version)
_REGISTRY: dict[str, dict[str, tuple[Callable, str]]] = {}


def register_module(name: str, version: str = "0.1.0", backend: str = "tpu"):
    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(name, {})[backend] = (fn, version)
        return fn

    return deco


def get_module(name: str, backend: str = "tpu") -> Callable:
    try:
        return _REGISTRY[name][backend][0]
    except KeyError:
        have = {n: list(b) for n, b in _REGISTRY.items()}
        raise RegistryError(
            f"no module '{name}' for backend '{backend}' (registered: {have})"
        ) from None


def module_accepts(name: str, backend: str, kwarg: str) -> bool:
    fn = get_module(name, backend)
    params = inspect.signature(fn).parameters
    return kwarg in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


# --------------------------------------------------------------------------
# module implementations
# --------------------------------------------------------------------------


@register_module("smooth")
def smooth(intensity_image, method: str = "gaussian", sigma: float = 2.0, size: int = 3):
    """Smoothing (reference ``jtmodules/smooth.py``); only the gaussian
    method is ported."""
    if method != "gaussian":
        raise NotSupportedError(f"smooth method '{method}' is not ported yet")
    return {"smoothed_image": smooth_ops.gaussian_smooth(intensity_image, sigma)}


@register_module("threshold_manual")
def threshold_manual(intensity_image, threshold: float = 0.0):
    """Reference ``jtmodules/threshold_manual.py``."""
    return {"mask": threshold_ops.threshold_manual(intensity_image, threshold)}


@register_module("threshold_otsu")
def threshold_otsu(intensity_image, correction_factor: float = 1.0, bins: int = 256):
    """Reference ``jtmodules/threshold_otsu.py``."""
    return {
        "mask": threshold_ops.threshold_otsu(
            intensity_image, bins=bins, correction_factor=correction_factor
        )
    }


@register_module("label")
def label(mask, connectivity: int = 8):
    """Reference ``jtmodules/label.py``."""
    return {"label_image": label_ops.label(mask, connectivity)}


@register_module("fill")
def fill(mask):
    """Reference ``jtmodules/fill.py`` (fill holes in binary mask)."""
    return {"filled_mask": label_ops.fill_holes(mask)}


@register_module("segment_primary")
def segment_primary(
    intensity_image,
    threshold_method: str = "otsu",
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    smooth_sigma: float = 1.0,
    fill: bool = True,
    min_area: int = 0,
    max_area: int | None = None,
    declump: bool = False,
    max_objects: int = 256,
):
    """Reference ``jtmodules/segment_primary.py`` (nuclei)."""
    from tmlibrary_tpu_torch.ops.segment_primary import segment_primary as _sp

    labels, _count = _sp(
        intensity_image,
        threshold_method=threshold_method,
        threshold_value=threshold_value,
        correction_factor=correction_factor,
        smooth_sigma=smooth_sigma,
        fill=fill,
        min_area=min_area,
        max_area=max_area,
        declump=declump,
        max_objects=max_objects,
    )
    return {"objects": labels}


@register_module("segment_secondary")
def segment_secondary(
    primary_label_image,
    intensity_image,
    method: str = "watershed",
    threshold_method: str = "otsu",
    threshold_value: float = 0.0,
    correction_factor: float = 1.0,
    n_levels: int = 32,
):
    """Reference ``jtmodules/segment_secondary.py`` (cells grown from
    nuclei seeds, same label ids as seeds)."""
    from tmlibrary_tpu_torch.ops.segment_secondary import watershed_from_seeds

    img = intensity_image.to(torch.float32)
    if threshold_method == "otsu":
        mask = threshold_ops.threshold_otsu(img, correction_factor=correction_factor)
    elif threshold_method == "manual":
        mask = threshold_ops.threshold_manual(img, threshold_value)
    else:
        raise ValueError(f"unknown threshold method '{threshold_method}'")
    if method != "watershed":
        raise ValueError(f"unknown secondary method '{method}'")
    labels = watershed_from_seeds(img, primary_label_image, mask, n_levels=n_levels)
    return {"objects": labels}


@register_module("measure_intensity")
def measure_intensity(
    objects_image, intensity_image, max_objects: int = 256, quantiles: bool = False
):
    """Reference ``jtmodules/measure_intensity.py``; ``quantiles=True``
    adds the per-object p25/median/p75."""
    from tmlibrary_tpu_torch.ops.measure import intensity_features, intensity_quantiles

    feats = intensity_features(objects_image, intensity_image, max_objects)
    if quantiles:
        feats.update(intensity_quantiles(objects_image, intensity_image, max_objects))
    return {"measurements": feats}


@register_module("measure_morphology")
def measure_morphology(objects_image, max_objects: int = 256):
    """Reference ``jtmodules/measure_morphology.py``."""
    from tmlibrary_tpu_torch.ops.measure import morphology_features

    return {"measurements": morphology_features(objects_image, max_objects)}


@register_module("measure_texture")
def measure_texture(
    objects_image, intensity_image, levels: int = 32, distance: int = 1,
    max_objects: int = 256,
):
    """Reference ``jtmodules/measure_texture.py`` (Haralick); only
    ``distance=1`` is ported."""
    from tmlibrary_tpu_torch.ops.measure import haralick_features

    return {"measurements": haralick_features(
        objects_image, intensity_image, max_objects, levels=levels, distance=distance)}


@register_module("measure_zernike")
def measure_zernike(objects_image, degree: int = 9, patch: int = 64, max_objects: int = 256):
    """Reference ``jtmodules/measure_zernike.py``; ``patch`` is accepted
    and ignored, as in the reference."""
    from tmlibrary_tpu_torch.ops.measure import zernike_features

    return {"measurements": zernike_features(
        objects_image, max_objects, degree=degree, patch=patch)}
