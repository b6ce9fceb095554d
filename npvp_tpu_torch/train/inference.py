"""Inference CLI: the five tasks of a trained unified model on test batches
(port of ``npvp_tpu/train/inference.py``): per-task time, PSNR/SSIM where
ground truth exists, and GIF strips.

    python -m npvp_tpu_torch.train.inference --config_path <yaml> \\
        [--tasks VFP VPE VFI VRC HVRC] [--batches N] [--gif_dir DIR] \\
        [--random_init] [--override Env.platform=cpu ...]

The splits are the demo splits of the reference notebook (boundary VFI,
prefix-context HVRC, VRC seeded per batch), not the metric protocol of
``npvp_tpu_torch.eval.evaluate``: the two CLIs' numbers do not compare.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from npvp_tpu_torch.core.metrics import save_clip_gifs
from npvp_tpu_torch.data.loader import DataModule
from npvp_tpu_torch.eval.metrics import psnr, ssim
from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.nn.layers import Rng
from npvp_tpu_torch.train.common import (build_argparser, config_device,
                                         load_cli_config)


def task_split(task: str, P: int, T: int, seed: int = 0):
    """(to, tp) index arrays of a within-clip task on the leading ``T``
    frames with a nominal context of ``P`` frames, clamped so that every
    task keeps a target inside the trained range."""
    if task == "VPE":
        Pe = min(P, T - 1)
        return np.arange(T - Pe, T), np.arange(T - Pe)
    if task == "VFI":
        k = max(1, min(P // 2, (T - 1) // 2))
        return (np.concatenate([np.arange(k), np.arange(T - k, T)]),
                np.arange(k, T - k))
    if task == "VRC":
        perm = np.random.default_rng(seed).permutation(T)
        Pe = min(P, T - 1)
        return np.sort(perm[:Pe]), np.sort(perm[Pe:])
    if task == "HVRC":
        Pe = min(P, T - 1)
        return (np.arange(Pe, dtype=np.float32),
                np.arange(Pe - 1, T - 1) + 0.5)
    raise ValueError(f"unknown task {task!r}")


def run_tasks(cfg, vp: VideoPredictor, dm: DataModule, tasks,
              num_batches: int = 2, gif_dir=None, seed: int = 0) -> dict:
    """Each task over the first ``num_batches`` test batches → {task:
    {avg_time_s, steady_time_s, batch_size, PSNR, SSIM, gif}}. A call is
    timed up to ``torch.cuda.synchronize()`` on the card (the model, not a
    host copy of its output); batch ``bi`` draws NPVP-S noise from
    ``Rng(seed).fold(bi)``."""
    d = cfg.Dataset
    batches = []
    for b in dm.test_loader():
        batches.append(b)
        if len(batches) >= num_batches:
            break
    if not batches:
        raise RuntimeError(
            f"the test loader of Dataset.name={d.name!r} gave no batch: "
            "check that batch_size <= the test-set size")
    P, F = d.test_num_past_frames, d.test_num_future_frames
    # within-clip tasks take the leading max_T frames; VFP covers the whole
    # horizon, through the sliding windows beyond max_T
    T = min(P + F, cfg.Predictor.max_T)
    cuda = vp.device.type == "cuda"
    unit = dm.renorm

    def timed(fn, *args, **kw):
        if cuda:
            torch.cuda.synchronize(vp.device)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if cuda:
            torch.cuda.synchronize(vp.device)
        return out, time.perf_counter() - t0

    def scores(pred, gt):
        p = torch.from_numpy(unit(pred.float().cpu().numpy()))
        g = torch.from_numpy(unit(np.asarray(gt, np.float32)))
        return ([float(psnr(p[:, t], g[:, t])) for t in range(p.shape[1])],
                [float(ssim(p[:, t], g[:, t])) for t in range(p.shape[1])])

    results = {}
    for task in tasks:
        times, s_psnr, s_ssim = [], [], []
        gif = None
        for bi, batch in enumerate(batches):
            full = np.concatenate([batch["past"], batch["future"]], axis=1)
            gen = Rng(seed).fold(bi).generator(vp.device)
            if task == "VFP":
                obs, tp = full[:, :P], np.arange(P, P + F)
                pred, dt = timed(vp.vfp, obs, F, generator=gen)
            else:
                to, tp = task_split(task, P, T, seed=bi)
                obs = full[:, to.astype(int)]
                pred, dt = timed(vp.predict, obs, to, tp, generator=gen)
            times.append(dt)
            gt = None if task == "HVRC" else full[:, tp.astype(int)]
            if gt is not None:  # integer targets: ground truth exists
                a, b = scores(pred, gt)
                s_psnr += a
                s_ssim += b
            if gif is None and gif_dir is not None:
                clips = {"observed": unit(obs[0]),
                         "pred": unit(pred[0].float().cpu().numpy())}
                if gt is not None:
                    clips["gt"] = unit(gt[0])
                gif = str(Path(gif_dir) / f"{task}.gif")
                save_clip_gifs(gif, clips)
        entry = {"avg_time_s": float(np.mean(times)),
                 "steady_time_s": float(np.min(times)),
                 "batch_size": batches[0]["past"].shape[0]}
        if s_psnr:
            entry["PSNR"] = float(np.mean(s_psnr))
            entry["SSIM"] = float(np.mean(s_ssim))
        if gif:
            entry["gif"] = gif
        results[task] = entry
    return results


def main(argv=None):
    parser = build_argparser("NPVP inference, the five tasks (PyTorch port)")
    parser.add_argument("--tasks", nargs="*",
                        default=["VFP", "VPE", "VFI", "VRC", "HVRC"])
    parser.add_argument("--batches", type=int, default=2)
    parser.add_argument("--gif_dir", type=str, default=None)
    parser.add_argument("--random_init", action="store_true",
                        help="random weights (pipeline smoke / timing only)")
    args = parser.parse_args(argv)
    cfg = load_cli_config(args)
    device = config_device(cfg)
    if args.random_init:
        vp = VideoPredictor.from_random_init(cfg, device=device)
    else:
        vp = VideoPredictor.from_checkpoints(
            cfg, cfg.Predictor.resume_AE_ckpt, cfg.Predictor.ckpt_save_dir,
            device=device)
    results = run_tasks(cfg, vp, DataModule(cfg), args.tasks, args.batches,
                        args.gif_dir)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main(sys.argv[1:])
