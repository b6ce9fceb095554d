"""Five-task quality report for a trained checkpoint (port of the JAX
package's root ``tools/quality_report.py``).

Runs the evaluation protocol (``npvp_tpu_torch.eval.evaluate``) for every
task on the checkpoints that the config names, with best-of-N latent
sampling for stochastic models, the copy-nearest-observed-frame baseline
rows and the frozen-AE ceiling rows, and writes ``quality.json`` and
``quality.md`` (the JAX tool's keys and tables) under ``--out_dir``
(default ``runs/<run-name>/``).

    python -m npvp_tpu_torch.tools.quality_report --config_path <yaml> \\
        [--num_samples N] [--max_batches N] [--tasks VFP VPE ...] \\
        [--random_init] [--dtype bfloat16] [--device cpu] \\
        [--out_dir DIR] [--override k=v ...]

``--dtype`` (default float32, the JAX tool's parity path) and
``Predictor.exec_mode`` (``--override Predictor.exec_mode=pallas``: the
attention kernel) pick the serving numerics.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.eval.evaluate import TASKS, evaluate
from npvp_tpu_torch.tools._cli import (DTYPES, add_run_args,
                                       predictor_maker, run_dir)
from npvp_tpu_torch.train.common import build_argparser, load_cli_config

def to_markdown(report: dict) -> str:
    run = report["run"]
    lines = [
        f"# Quality report — {run}",
        "",
        f"config `{report['config']}` · best-of-{report['num_samples']} "
        "latent samples · base = copy nearest observed frame · ceil = "
        "frozen-AE GT reconstruction (the predictor's quality ceiling)"
        + (" · **RANDOM INIT (no training)**" if report["random_init"]
           else ""),
        "",
        "| task | PSNR | PSNR base | PSNR ceil | SSIM | SSIM base "
        "| SSIM ceil | MSE | MSE base |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    nan = float("nan")
    for task, r in report["tasks"].items():
        lines.append(
            f"| {task} | {r['PSNR']:.2f} | "
            f"{r.get('PSNR_baseline', nan):.2f} | "
            f"{r.get('PSNR_ae_ceiling', nan):.2f} | "
            f"{r['SSIM']:.4f} | {r.get('SSIM_baseline', nan):.4f} |"
            f" {r.get('SSIM_ae_ceiling', nan):.4f} |"
            f" {r['MSE']:.5f} | {r.get('MSE_baseline', nan):.5f} |")
    for task, r in report["tasks"].items():
        per_t = r.get("PSNR_per_t")
        if per_t:
            lines += ["", f"## {task} per-timestep PSNR", "",
                      "| t | PSNR | baseline |", "|---|---|---|"]
            base = r.get("PSNR_baseline_per_t") or [nan] * len(per_t)
            for i, (a, b) in enumerate(zip(per_t, base)):
                lines.append(f"| {i} | {a:.2f} | {b:.2f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = build_argparser("five-task quality report")
    ap.add_argument("--tasks", nargs="+", default=list(TASKS))
    ap.add_argument("--num_samples", type=int, default=5)
    ap.add_argument("--max_batches", type=int, default=None)
    ap.add_argument("--random_init", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=list(DTYPES))
    add_run_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_cli_config(args)
    out_dir = run_dir(cfg, args.out_dir)

    report = {"config": args.config_path,
              "run": pathlib.Path(cfg.Predictor.ckpt_save_dir).name,
              "num_samples": args.num_samples,
              "random_init": bool(args.random_init),
              "max_batches": args.max_batches, "tasks": {}}
    nan = float("nan")
    # one predictor serves every task
    vp = predictor_maker(cfg, device, args.random_init)(DTYPES[args.dtype])
    for task in args.tasks:
        t0 = time.time()
        res = evaluate(cfg, max_batches=args.max_batches, task=task,
                       num_samples=args.num_samples, baseline=True,
                       gif_dir=str(out_dir / "gifs"), ae_ceiling=True,
                       vp=vp)
        res["eval_wall_s"] = round(time.time() - t0, 1)
        report["tasks"][task] = res
        print(f"{task}: PSNR {res['PSNR']:.2f} (baseline "
              f"{res.get('PSNR_baseline', nan):.2f})  SSIM "
              f"{res['SSIM']:.4f} (baseline "
              f"{res.get('SSIM_baseline', nan):.4f})", flush=True)

    (out_dir / "quality.json").write_text(json.dumps(report, indent=2))
    (out_dir / "quality.md").write_text(to_markdown(report))
    print(f"wrote {out_dir}/quality.json and quality.md")


if __name__ == "__main__":
    main(sys.argv[1:])
