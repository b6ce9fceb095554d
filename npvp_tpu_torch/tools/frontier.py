"""Speed/quality frontier: serving-time depth reduction on trained weights
(port of the JAX package's root ``tools/frontier.py``).

Each variant serves the same full weights archive at a cut depth: only
the first K of the decoder's NAR blocks and/or of the EVT-former's blocks
run (the archive's later ``layer_{K..}`` blocks are left unread, as flax
leaves them; ``tools/weights.py``), keeping the shared final norm. For
each variant, in one process:

- throughput: the serving protocol of the JAX package's ``bench.py``
  (batch 64, the config's own VFP task, ``freeze_task``, bf16 and the
  attention kernel): every variant warmed before any timing, then timed
  round-robin over the variants, each call ended by a synchronize;
  per-variant least seconds a batch, frames/s, the per-round speedup
  against ``full``, and each kernel's launches a forward;
- quality: the five-task protocol (``eval.evaluate``, copy baseline on
  ``full``) at ``--max_batches``, per-task PSNR/SSIM deltas against
  ``full``.

    python -m npvp_tpu_torch.tools.frontier \\
        --config_path npvp_tpu_torch/configs/config_SMMNIST_Unified_NPVP-D.yaml \\
        --override Predictor.ckpt_save_dir=<weights.npz> \\
          Predictor.resume_AE_ckpt=<weights_stage1.npz> \\
        --variants full L6 L4 L4evt2 --quality --max_batches 10 \\
        [--dtype bfloat16] [--device cpu] [--out_dir DIR]

``--dtype`` sets the quality pass's numerics (default float32, the JAX
tool's parity path); ``--out_dir`` defaults to ``runs/frontier``.
"""

from __future__ import annotations

import copy
import json
import pathlib
import sys
import time

import numpy as np
import torch

from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.eval.evaluate import evaluate
from npvp_tpu_torch.kernels import temporal_attention as ta
from npvp_tpu_torch.tools._cli import DTYPES, add_run_args, predictor_maker
from npvp_tpu_torch.train.common import build_argparser, load_cli_config

# variant name -> Predictor config changes (depth only: one archive serves
# every variant)
VARIANTS = {
    "full": {},
    "L6": {"transformer_layers": 6},
    "L4": {"transformer_layers": 4},
    "L2": {"transformer_layers": 2},
    "evt2": {"evt_former_num_layers": 2},
    "L6evt2": {"transformer_layers": 6, "evt_former_num_layers": 2},
    "L4evt2": {"transformer_layers": 4, "evt_former_num_layers": 2},
    "L2evt1": {"transformer_layers": 2, "evt_former_num_layers": 1},
}


def variant_cfg(cfg, name):
    c = copy.deepcopy(cfg)
    for k, v in VARIANTS[name].items():
        setattr(c.Predictor, k, v)
    return c.validate()


def bench_variants(cfg, names, make, blocks=6, n=20, device="cuda"):
    """Round-robin serving throughput (predicted frames/s) per variant;
    ``make`` is ``tools._cli.predictor_maker``'s."""
    device = resolve_device(device)
    d = cfg.Dataset
    # the config's own VFP task (SMMNIST: 5 observed -> 10 predicted)
    n_past, n_fut = d.test_num_past_frames, d.test_num_future_frames
    obs_t, tgt_t = np.arange(n_past), np.arange(n_past, n_past + n_fut)
    preds = {name: make(torch.bfloat16, "pallas", variant_cfg(cfg, name))
             .freeze_task(obs_t, tgt_t) for name in names}
    batch = 64
    frames = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (batch, n_past, d.img_size, d.img_size, d.img_channels),
        np.float32), device=device)
    gen = torch.Generator(device=device)

    def call(name, seed):
        out = preds[name](frames, generator=gen.manual_seed(seed))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    launches = {}
    for name in names:  # warm every variant before any timing
        before = dict(ta.LAUNCHES)
        call(name, 0)
        launches[name] = {k: ta.LAUNCHES[k] - before[k] for k in before}
        print(f"[frontier] {name} warmed (kernel launches a forward: "
              f"{launches[name]})", file=sys.stderr, flush=True)

    times = {name: [] for name in names}
    for r in range(blocks):
        for name in names:  # round-robin: each round samples every variant
            t0 = time.perf_counter()
            for i in range(n):
                call(name, r * n + i)
            times[name].append((time.perf_counter() - t0) / n)
    res = {}
    for name in names:
        # the ratio is taken within each round: the same card conditions
        per_round = [times[names[0]][r] / times[name][r]
                     for r in range(blocks)]
        sec = float(np.min(times[name]))
        res[name] = {
            "sec_per_batch_min": sec,
            "fps": batch * len(tgt_t) / sec,
            "speedup_vs_full_median": float(np.median(per_round)),
            "speedup_vs_full_rounds": [round(x, 3) for x in per_round],
            "launches_per_forward": launches[name],
        }
    return res


def quality_variants(cfg, names, tasks, max_batches, num_samples, make,
                     cache_path=None, dtype=torch.float32):
    """Per-variant, per-task PSNR/SSIM/MSE (and the copy baseline on the
    first variant); ``make`` is ``tools._cli.predictor_maker``'s.
    ``cache_path``: finished (variant, task) cells are kept there after
    every evaluation and skipped when the tool runs again."""
    res = {}
    if cache_path and cache_path.exists():
        res = json.loads(cache_path.read_text())
        done = sum(len(v) for v in res.values())
        print(f"[frontier] resuming quality pass: {done} cached cell(s)",
              file=sys.stderr, flush=True)
    for name in names:
        c = variant_cfg(cfg, name)
        res.setdefault(name, {})
        todo = [task for task in tasks if task not in res[name]]
        vp = make(dtype, None, c) if todo else None
        for task in todo:
            r = evaluate(c, max_batches=max_batches, task=task,
                         num_samples=num_samples,
                         baseline=(name == names[0]), vp=vp)
            res[name][task] = {k: r[k] for k in
                               ("PSNR", "SSIM", "MSE") if k in r}
            if name == names[0]:
                for k in ("PSNR_baseline", "SSIM_baseline"):
                    if k in r:
                        res[name][task][k] = r[k]
            if cache_path:
                cache_path.write_text(json.dumps(res, indent=1))
            print(f"[frontier] {name} {task}: "
                  f"PSNR {r['PSNR']:.2f} SSIM {r['SSIM']:.4f}",
                  file=sys.stderr, flush=True)
    return res


def to_markdown(rep):
    names = rep["variants"]
    lines = ["# Serving depth/quality frontier", "",
             f"config `{rep['config']}` · weights "
             f"`{rep['weights']}` · protocol: fps = batch-64 config VFP task "
             "freeze_task bf16+pallas, interleaved round-robin "
             f"({rep.get('fps_blocks', 0)} rounds); quality = "
             + ("fp32 parity path"
                if rep.get("quality_dtype", "float32") == "float32"
                else f"{rep['quality_dtype']} path")
             + f", max_batches={rep.get('max_batches')}, best-of-"
             f"{rep.get('num_samples')} latent samples", ""]
    fps = rep.get("fps") or {}
    qual = rep.get("quality") or {}
    tasks = rep.get("tasks", [])
    nan = float("nan")
    hdr = "| variant | layers | fps | speedup |"
    sep = "|---|---|---|---|"
    for t in tasks:
        hdr += f" {t} PSNR | Δ |"
        sep += "---|---|"
    lines += [hdr, sep]
    for name in names:
        muts = VARIANTS[name]
        depth = (f"{muts.get('transformer_layers', 8)}+"
                 f"{muts.get('evt_former_num_layers', 4)}")
        f = fps.get(name, {})
        row = (f"| {name} | {depth} | {f.get('fps', nan):.0f} | "
               f"{f.get('speedup_vs_full_median', nan):.2f}× |")
        for t in tasks:
            q = qual.get(name, {}).get(t, {})
            q0 = qual.get(names[0], {}).get(t, {})
            p = q.get("PSNR", nan)
            dp = p - q0.get("PSNR", nan)
            row += f" {p:.2f} | {dp:+.2f} |"
        lines.append(row)
    if qual:
        base = qual.get(names[0], {})
        brow = [f"{t}: {base.get(t, {}).get('PSNR_baseline', nan):.2f}"
                for t in tasks]
        lines += ["", "Copy-nearest-observed-frame baseline PSNR — "
                  + ", ".join(brow) + ". A variant whose PSNR approaches "
                  "the baseline has stopped modeling dynamics."]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = build_argparser("serving depth/quality frontier")
    ap.add_argument("--variants", nargs="+", default=["full", "L6", "L4"],
                    choices=list(VARIANTS))
    ap.add_argument("--fps_blocks", type=int, default=6)
    ap.add_argument("--fps_calls", type=int, default=20,
                    help="timed calls a variant in each round")
    ap.add_argument("--no_fps", action="store_true")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--tasks", nargs="+",
                    default=["VFP", "VPE", "VFI", "VRC", "HVRC"])
    ap.add_argument("--max_batches", type=int, default=10)
    ap.add_argument("--num_samples", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=list(DTYPES))
    add_run_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_cli_config(args)
    names = args.variants
    if names[0] != "full":
        names = ["full"] + [n for n in names if n != "full"]

    rep = {"config": args.config_path,
           "weights": str(cfg.Predictor.ckpt_save_dir),
           "variants": names, "tasks": args.tasks if args.quality else [],
           "max_batches": args.max_batches, "num_samples": args.num_samples,
           "fps_blocks": args.fps_blocks, "quality_dtype": args.dtype}
    out_dir = pathlib.Path(args.out_dir or "runs/frontier")
    out_dir.mkdir(parents=True, exist_ok=True)
    # one read of the archive serves every variant
    make = predictor_maker(cfg, device)
    if not args.no_fps:
        rep["fps"] = bench_variants(cfg, names, make, blocks=args.fps_blocks,
                                    n=args.fps_calls, device=device)
    if args.quality:
        rep["quality"] = quality_variants(
            cfg, names, args.tasks, args.max_batches, args.num_samples,
            make, cache_path=out_dir / "frontier_quality_partial.json",
            dtype=DTYPES[args.dtype])
    (out_dir / "frontier.json").write_text(json.dumps(rep, indent=1))
    (out_dir / "frontier.md").write_text(to_markdown(rep))
    print(f"wrote {out_dir}/frontier.json and frontier.md")


if __name__ == "__main__":
    main(sys.argv[1:])
