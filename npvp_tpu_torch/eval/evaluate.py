"""Evaluation CLI: per-timestep PSNR/SSIM/MSE (and FVD) on a test set (port
of ``npvp_tpu/eval/evaluate.py``).

    python -m npvp_tpu_torch.eval.evaluate --config_path <yaml> \\
        [--task VFP|VPE|VFI|VRC|HVRC] [--num_samples N] [--baseline] \\
        [--max_batches N] [--gif_dir DIR] [--out FILE] \\
        [--override Env.platform=cpu ...]

Tasks are choices of time coordinates:

- **VFP** (default): observe the test past, predict the whole test future;
  horizons beyond ``max_T`` take the sliding-window protocol
  (``VideoPredictor.vfp_windowed``).
- **VPE / VFI / VRC / HVRC**: on the leading ``max_T`` frames of each test
  clip; HVRC's fractional targets have no ground truth, so its metrics
  cover its integer targets.

NPVP-S takes best-of-N (``--num_samples N``): N latent draws per sequence,
the best sample chosen per sequence and per metric. The draw of batch
``bi``, sample ``s`` comes from a generator seeded by
``Rng(Env.rand_seed).fold(bi).fold(s)``. The metrics of a batch are one
batched pass over all its frames on the device, with the renormalisation
folded in.
"""

from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from npvp_tpu_torch.core.config import Config
from npvp_tpu_torch.core.metrics import save_clip_gifs
from npvp_tpu_torch.data.loader import DataModule
from npvp_tpu_torch.eval.metrics import clip_metrics, to_unit_range
from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.nn.layers import Rng
from npvp_tpu_torch.train.common import (build_argparser, config_device,
                                         load_cli_config)

TASKS = ("VFP", "VPE", "VFI", "VRC", "HVRC")
HIGHER_BETTER = {"PSNR": True, "SSIM": True, "MSE": False}


def _task_split(task: str, cfg: Config, seed: int = 0):
    """(to_list, tp_list, metric_tp_indices) of a non-VFP task on the
    leading max_T frames; ``metric_tp_indices`` selects the targets that
    have ground truth (integer times)."""
    p, d = cfg.Predictor, cfg.Dataset
    S = p.max_T
    P = min(d.test_num_past_frames, S - 1)
    if task == "VPE":
        to = np.arange(S - P, S, dtype=np.float32)
        tp = np.arange(S - P, dtype=np.float32)
    elif task == "VFI":
        cp, cf = (P + 1) // 2, P // 2
        to = np.concatenate([np.arange(cp), np.arange(S - cf, S)]
                            ).astype(np.float32)
        tp = np.arange(cp, S - cf, dtype=np.float32)
    elif task == "VRC":
        perm = np.random.default_rng(seed).permutation(S)
        to = np.sort(perm[:P]).astype(np.float32)
        tp = np.sort(perm[P:]).astype(np.float32)
    elif task == "HVRC":
        perm = np.random.default_rng(seed).permutation(S)
        to = np.sort(perm[:P]).astype(np.float32)
        ints = np.sort(perm[P:]).astype(np.float32)
        halves = (ints[:-1] + 0.5)[ints[:-1] + 0.5 <= S]
        tp = np.sort(np.concatenate([ints, halves.astype(np.float32)]))
    else:
        raise ValueError(f"unknown task {task!r}")
    metric_idx = np.where(tp == np.round(tp))[0]
    return to, tp, metric_idx


def best_of(scores):
    """Best-of-N: ``scores`` is one {metric: (N, T) array} per latent draw;
    → ({metric: (N, T) scores of the draw whose sequence mean is best for
    that metric}, {metric: (N,) index of that draw})."""
    chosen, best = {}, {}
    for name, higher in HIGHER_BETTER.items():
        stacked = np.stack([s[name] for s in scores])      # (S, N, T)
        seq_mean = stacked.mean(axis=2)                      # (S, N)
        best[name] = (np.argmax(seq_mean, axis=0) if higher
                      else np.argmin(seq_mean, axis=0))      # (N,)
        chosen[name] = stacked[best[name], np.arange(stacked.shape[1])]
    return chosen, best


def evaluate(cfg: Config, fvd_i3d_ckpt: Optional[str] = None,
             max_batches: Optional[int] = None, random_init: bool = False,
             task: str = "VFP", num_samples: int = 1,
             baseline: bool = False, gif_dir: Optional[str] = None,
             gif_sequences: int = 4, ae_ceiling: bool = False,
             dtype=torch.float32, exec_mode: Optional[str] = None,
             device="cuda", sprites=None) -> dict:
    """The per-timestep metrics of ``task`` over the test loader, from the
    checkpoints that ``Predictor.resume_AE_ckpt`` and
    ``Predictor.ckpt_save_dir`` name (or random weights).

    ``baseline`` adds ``<metric>_baseline`` rows (each target copies the
    nearest observed frame); ``ae_ceiling`` adds ``<metric>_ae_ceiling``
    rows (the frozen AE's reconstruction of the ground truth, the
    predictor's ceiling); ``gif_dir`` writes GT | prediction GIFs (the
    PSNR-best draw) of the first ``gif_sequences`` sequences of the first
    batch. ``dtype``/``exec_mode`` default to fp32 and the plain path;
    bf16 and "pallas" measure the serving numerics on the same protocol.
    ``sprites`` optionally maps "test" to an SMMNIST sprite bank."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
    dm = DataModule(cfg, sprites)
    d, p = cfg.Dataset, cfg.Predictor
    if random_init:
        vp = VideoPredictor.from_random_init(cfg, dtype,
                                             exec_mode=exec_mode,
                                             device=device)
    else:
        vp = VideoPredictor.from_checkpoints(
            cfg, p.resume_AE_ckpt, p.ckpt_save_dir, dtype=dtype,
            exec_mode=exec_mode, device=device)
    if not p.stochastic:
        num_samples = 1

    if task == "VFP":
        num_future = d.test_num_future_frames
        metric_idx = np.arange(num_future)
        obs_t = np.arange(d.test_num_past_frames, dtype=np.float32)
        tgt_t = d.test_num_past_frames + np.arange(num_future,
                                                   dtype=np.float32)

        def predict_and_gt(batch, gen):
            pred = vp.vfp(batch["past"], num_future, generator=gen)
            return pred, batch["future"]

        def observed(batch):
            return batch["past"]
    else:
        clip_len = d.test_num_past_frames + d.test_num_future_frames
        if clip_len < p.max_T:
            raise ValueError(
                f"task {task} evaluates the leading max_T={p.max_T} frames "
                f"but test clips are only {clip_len} long; increase "
                "Dataset.test_num_{past,future}_frames")
        to, tp, metric_idx = _task_split(task, cfg, seed=cfg.Env.rand_seed)
        obs_t, tgt_t = to, tp[metric_idx]

        def leading(batch):
            return np.concatenate([batch["past"], batch["future"]],
                                  axis=1)[:, :p.max_T]

        def predict_and_gt(batch, gen):
            clip = leading(batch)
            pred = vp.predict(clip[:, to.astype(int)], to, tp, generator=gen)
            return pred, clip[:, tp[metric_idx].astype(int)]

        def observed(batch):
            return leading(batch)[:, to.astype(int)]

    # the copy-nearest-observed-frame baseline: each target repeats the
    # closest observed frame
    nearest = np.argmin(np.abs(obs_t[None, :] - tgt_t[:, None]), axis=1)
    renorm = dm.renorm

    def per_clip(pred, gt):
        return {k: v.cpu().numpy() for k, v in clip_metrics(
            pred, gt, renorm.mean, renorm.std).items()}

    T_m = len(metric_idx)
    totals = {k: np.zeros(T_m) for k in HIGHER_BETTER}
    base_totals = {k: np.zeros(T_m) for k in HIGHER_BETTER}
    ceil_totals = {k: np.zeros(T_m) for k in HIGHER_BETTER}
    count = 0
    fvd = None
    fake_feats, real_feats = [], []
    if fvd_i3d_ckpt is not None:
        from npvp_tpu_torch.eval.fvd import FVD

        fvd = FVD.from_checkpoint(fvd_i3d_ckpt, device=vp.device)
    test_loader = dm.test_loader()
    loader = (test_loader if max_batches is None
              else itertools.islice(iter(test_loader), max_batches))
    base_rng = Rng(cfg.Env.rand_seed)
    for bi, batch in enumerate(loader):
        scores, preds = [], []
        for s in range(num_samples):
            gen = base_rng.fold(bi).fold(s).generator(vp.device)
            pred, gt = predict_and_gt(batch, gen)
            pred = pred[:, torch.as_tensor(metric_idx, device=pred.device)]
            gt = torch.as_tensor(gt, dtype=torch.float32, device=pred.device)
            if gif_dir is not None and bi == 0:
                preds.append(pred.float().cpu().numpy())
            if s == 0 and fvd is not None:
                # 400-d I3D features per batch (one draw per sequence),
                # never the raw frames
                fake_feats.append(fvd.features(
                    to_unit_range(pred, renorm.mean, renorm.std)))
                real_feats.append(fvd.features(
                    to_unit_range(gt, renorm.mean, renorm.std)))
            scores.append(per_clip(pred, gt))
        chosen, best = best_of(scores)
        for name in HIGHER_BETTER:
            totals[name] += chosen[name].sum(axis=0)
        n = chosen["PSNR"].shape[0]
        if preds:
            gt_np = gt.cpu().numpy()
            for i in range(min(gif_sequences, n)):
                save_clip_gifs(Path(gif_dir) / f"{task}_seq{i}.gif",
                               {"gt": gt_np[i],
                                "pred": preds[best["PSNR"][i]][i]},
                               renorm=renorm)
        if baseline:
            base = np.asarray(observed(batch), np.float32)[:, nearest]
            for name, v in per_clip(torch.as_tensor(base, device=vp.device),
                                    gt).items():
                base_totals[name] += v.sum(axis=0)
        if ae_ceiling:
            for name, v in per_clip(vp.reconstruct(gt), gt).items():
                ceil_totals[name] += v.sum(axis=0)
        count += n
    test_loader.close()

    results = {"task": task, "num_samples": num_samples}
    rows = [("", totals)] + [(tag, t) for tag, t, on in (
        ("_baseline", base_totals, baseline),
        ("_ae_ceiling", ceil_totals, ae_ceiling)) if on]
    for tag, tot in rows:
        for name in HIGHER_BETTER:
            per_t = tot[name] / max(count, 1)
            results[f"{name}{tag}_per_t"] = per_t.tolist()
            results[f"{name}{tag}"] = float(per_t.mean())
    if fvd is not None:
        from npvp_tpu_torch.eval.fvd import frechet_distance

        results["FVD"] = frechet_distance(np.concatenate(fake_feats),
                                          np.concatenate(real_feats))
    return results


def main(argv=None):
    parser = build_argparser("NPVP evaluation (PyTorch port)")
    parser.add_argument("--task", type=str, default="VFP", choices=TASKS)
    parser.add_argument("--num_samples", type=int, default=1,
                        help="best-of-N latent draws (NPVP-S only)")
    parser.add_argument("--i3d_ckpt", type=str, default=None,
                        help="converted I3D weights (.pkl) for FVD")
    parser.add_argument("--baseline", action="store_true",
                        help="add copy-nearest-observed-frame metric rows")
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--gif_dir", type=str, default=None,
                        help="write GT | prediction GIFs of the first batch")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    cfg = load_cli_config(args)
    results = evaluate(cfg, args.i3d_ckpt, args.max_batches, task=args.task,
                       num_samples=args.num_samples, baseline=args.baseline,
                       gif_dir=args.gif_dir, device=config_device(cfg))
    text = json.dumps(results, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main(sys.argv[1:])
