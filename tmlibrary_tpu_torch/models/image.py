"""Illumination statistics container.

Counterpart: ``tmlibrary_tpu/models/image.py:139-188``
(``IllumstatsContainer``; reference ``tmlib.image.IllumstatsContainer``).
The store form is numpy both ways; :meth:`IllumstatsContainer.smooth`
goes through the port's :func:`~tmlibrary_tpu_torch.ops.smooth.gaussian_smooth`.
``ChannelImage`` and ``SegmentationImage`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tmlibrary_tpu_torch.ops.smooth import gaussian_smooth


@dataclasses.dataclass
class IllumstatsContainer:
    """Per-channel illumination statistics in the log10 domain (corilla's):
    per-pixel mean and std over all sites of a channel, the intensity
    percentiles and the site count.  ``mean_log``/``std_log`` are numpy
    arrays or tensors."""

    mean_log: Any
    std_log: Any
    percentiles: dict[float, float]
    n: int

    def smooth(self, sigma: float = 5.0) -> "IllumstatsContainer":
        """Pre-smooth the statistic fields (the reference smooths stats
        before applying them so single-pixel noise doesn't amplify)."""

        def field(a):
            return gaussian_smooth(torch.as_tensor(a), sigma)

        return IllumstatsContainer(
            mean_log=field(self.mean_log),
            std_log=field(self.std_log),
            percentiles=self.percentiles,
            n=self.n,
        )

    @classmethod
    def from_store(cls, d: dict[str, Any]) -> "IllumstatsContainer":
        pct_keys = d.get("percentile_keys")
        pct_vals = d.get("percentile_values")
        percentiles = (
            {float(k): float(v) for k, v in zip(pct_keys, pct_vals)}
            if pct_keys is not None
            else {}
        )
        return cls(
            mean_log=np.asarray(d["mean_log"]),
            std_log=np.asarray(d["std_log"]),
            percentiles=percentiles,
            n=int(d["n"]),
        )

    def to_store(self) -> dict[str, np.ndarray]:
        def host(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        keys = sorted(self.percentiles)
        return {
            "mean_log": host(self.mean_log),
            "std_log": host(self.std_log),
            "percentile_keys": np.asarray(keys, np.float64),
            "percentile_values": np.asarray([self.percentiles[k] for k in keys]),
            "n": np.asarray(self.n),
        }
