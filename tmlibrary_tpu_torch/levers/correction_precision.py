"""Why illumination correction runs in float64: the reference's float32
evaluation of ``image_ops.correct_illumination`` against the port's
float64 one, the card against the CPU.

On 128 sites of phase 5's store (config 3's DAPI and Actin at 256x256,
rolled within +-40, corrected with corilla's statistics computed on the
card), for each evaluation: the corrected pixels that differ between the
card and the CPU and the largest difference, the sites whose Otsu cut on
Actin differs, and the label pixels of config 3 (corrected, aligned and
cropped as in the jterator step) that differ between the card and the
CPU.

Run on a card from the root of a checkout:
``python3 -m tmlibrary_tpu_torch.levers.correction_precision``.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from tmlibrary_tpu_torch import benchmarks
from tmlibrary_tpu_torch.jterator.description import PipelineDescription
from tmlibrary_tpu_torch.jterator.pipeline import ImageAnalysisPipeline
from tmlibrary_tpu_torch.ops import image_ops, stats, threshold

SITES, SIZE, MAX_DRIFT, SEED = 128, 256, 40, 0


def correct_float32(img, mean_log, std_log):
    """The reference's evaluation (``tmlibrary_tpu/ops/image_ops.py:39-45``)
    in float32."""
    img_f = img.to(torch.float32)
    log_img = torch.log10(1.0 + img_f)
    std_safe = torch.where(std_log > 1e-6, std_log, torch.ones_like(std_log))
    z = (log_img - mean_log) / std_safe
    corrected_log = z * torch.mean(std_log) + torch.mean(mean_log)
    return torch.clamp(torch.pow(10.0, corrected_log) - 1.0, 0.0, image_ops.UINT16_MAX)


def main() -> int:
    if not torch.cuda.is_available():
        print("correction_precision: needs a CUDA card")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    data = benchmarks.synthetic_cell_painting_batch(SITES, size=SIZE, seed=SEED)
    drift = np.random.default_rng(SEED + 8).integers(-MAX_DRIFT, MAX_DRIFT + 1, (SITES, 2))
    chans = {ch: np.stack([np.roll(s, tuple(d), axis=(0, 1))
                           for s, d in zip(data[ch].astype(np.uint16), drift)])
             for ch in ("DAPI", "Actin")}
    fields = {}
    for ch, x in chans.items():
        out = stats.corilla_statistics(torch.from_numpy(x).cuda())
        fields[ch] = (out["mean_log"], out["std_log"])
    pipe = dict(benchmarks.CELL_PAINTING_PIPE)
    pipe["input"] = {"channels": [{"name": ch, "correct": True, "align": True}
                                  for ch in ("DAPI", "Actin")]}
    desc = PipelineDescription.from_dict(pipe)
    shifts = torch.from_numpy((-drift).astype(np.int32))
    window = (MAX_DRIFT,) * 4
    shipped = image_ops.correct_illumination
    print(f"correction_precision: {SITES} sites of {SIZE}x{SIZE}, DAPI and Actin, on {card}")
    for name, fn in (("float32 (the reference's)", correct_float32), ("float64 (shipped)", shipped)):
        differ, largest = 0, 0.0
        for ch, x in chans.items():
            xs = torch.from_numpy(x.astype(np.float32))
            mean_log, std_log = fields[ch]
            a = fn(xs.cuda(), mean_log, std_log).cpu()
            b = fn(xs, mean_log.cpu(), std_log.cpu())
            differ += int((a != b).sum())
            largest = max(largest, float((a - b).abs().max()))
        xa = torch.from_numpy(chans["Actin"].astype(np.float32))
        cuts = (threshold.otsu_value(fn(xa.cuda(), *fields["Actin"])).cpu()
                != threshold.otsu_value(fn(xa, *(f.cpu() for f in fields["Actin"]))))
        image_ops.correct_illumination = fn
        try:
            labels = {}
            for dev in ("cuda", "cpu"):
                batch_fn = ImageAnalysisPipeline(desc, 256, device=dev).build_batch_fn(window)
                st = {ch: (m.to(dev), s.to(dev)) for ch, (m, s) in fields.items()}
                raw = {ch: torch.from_numpy(x) for ch, x in chans.items()}
                labels[dev] = {k: v.cpu() for k, v in batch_fn(raw, st, shifts).objects.items()}
        finally:
            image_ops.correct_illumination = shipped
        flips = {k: int((labels["cuda"][k] != labels["cpu"][k]).sum()) for k in labels["cpu"]}
        print(f"  {name}: corrected pixels differing card vs cpu {differ} of "
              f"{2 * xa.numel()} (largest {largest:.4g}); Actin Otsu cuts differing on "
              f"{int(cuts.sum())} of {SITES} sites; label pixels differing {flips}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
