"""The sliding-window protocol's quality cost on a trained model (port of
the JAX package's root ``tools/window_drift.py``).

``VideoPredictor.vfp_windowed`` re-bases each window's time origin. On a
horizon that fits ``max_T`` directly (SMMNIST 5 → 10 with max_T 15) this
tool evaluates VFP both ways:

- direct: one in-range window, target times P..P+F-1;
- windowed: forced through windows of ``F // 2`` frames
  (``vfp_windowed(chunk=F // 2)``): the predictions of the first window
  become the re-based context of the second;

and reports per-timestep PSNR/SSIM for both (the JAX tool's JSON keys),
an upper bound on what a protocol that has no in-range alternative (KTH
10 → 20) pays per extra window.

    python -m npvp_tpu_torch.tools.window_drift --config_path <yaml> \\
        [--max_batches N] [--out <json>] [--dtype bfloat16] \\
        [--device cpu] [--out_dir DIR] [--override k=v ...]

The JSON goes to ``--out`` when given, else to ``window_drift.json`` under
``--out_dir`` (default ``runs/<run-name>/``). ``--dtype`` defaults to
float32, the JAX tool's parity path.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import sys

import numpy as np
import torch

from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.data.loader import DataModule
from npvp_tpu_torch.eval.metrics import clip_metrics
from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.nn.layers import Rng
from npvp_tpu_torch.tools._cli import DTYPES, add_run_args, run_dir
from npvp_tpu_torch.train.common import build_argparser, load_cli_config


def drift(cfg, max_batches: int, dtype, device) -> dict:
    """Per-timestep PSNR/SSIM of direct and windowed VFP over the first
    ``max_batches`` test batches, and the mean drifts."""
    dm = DataModule(cfg)
    vp = VideoPredictor.from_checkpoints(
        cfg, cfg.Predictor.resume_AE_ckpt, cfg.Predictor.ckpt_save_dir,
        dtype=dtype, device=device)
    P = cfg.Dataset.test_num_past_frames
    F = cfg.Dataset.test_num_future_frames
    if P + F > cfg.Predictor.max_T:
        raise ValueError("the direct path must fit max_T for the "
                         f"comparison: {P} + {F} > {cfg.Predictor.max_T}")
    mean, std = dm.renorm.mean, dm.renorm.std
    sums = {k: np.zeros(F) for k in
            ("PSNR_direct", "PSNR_windowed", "SSIM_direct", "SSIM_windowed")}
    count = 0
    base = Rng(cfg.Env.rand_seed)
    loader = dm.test_loader()
    for bi, batch in enumerate(itertools.islice(iter(loader), max_batches)):
        # both ways draw from one seed: the drift is the windowing alone
        direct = vp.vfp(batch["past"], F,
                        generator=base.fold(bi).generator(vp.device))
        windowed = vp.vfp_windowed(
            batch["past"], F, generator=base.fold(bi).generator(vp.device),
            chunk=max(1, F // 2))
        gt = torch.as_tensor(batch["future"], dtype=torch.float32,
                             device=vp.device)
        for name, pred in (("direct", direct), ("windowed", windowed)):
            per = clip_metrics(pred.float(), gt, mean, std)
            sums[f"PSNR_{name}"] += per["PSNR"].sum(0).cpu().numpy()
            sums[f"SSIM_{name}"] += per["SSIM"].sum(0).cpu().numpy()
        count += direct.shape[0]
        print(f"batch {bi}: n={count}", flush=True)
    loader.close()

    results = {k: (v / max(count, 1)).tolist() for k, v in sums.items()}
    results["n_sequences"] = count
    for metric in ("PSNR", "SSIM"):
        results[f"{metric}_drift_mean"] = float(np.mean(
            np.array(results[f"{metric}_direct"])
            - np.array(results[f"{metric}_windowed"])))
    # the drift that matters: the second window's frames (re-based context)
    h = F // 2
    results["PSNR_drift_second_window"] = float(np.mean(
        np.array(results["PSNR_direct"][h:])
        - np.array(results["PSNR_windowed"][h:])))
    return results


def main(argv=None):
    ap = build_argparser("sliding-window drift measurement")
    ap.add_argument("--max_batches", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", default="float32", choices=list(DTYPES))
    add_run_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_cli_config(args)
    results = drift(cfg, args.max_batches, DTYPES[args.dtype], device)
    text = json.dumps(results, indent=2)
    print(text)
    out = (pathlib.Path(args.out) if args.out
           else run_dir(cfg, args.out_dir) / "window_drift.json")
    out.write_text(text)


if __name__ == "__main__":
    main(sys.argv[1:])
