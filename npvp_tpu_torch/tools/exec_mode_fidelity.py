"""Serving-numerics fidelity on a trained checkpoint (port of the JAX
package's root ``tools/exec_mode_fidelity.py``).

The evaluation protocol's PSNR/SSIM/MSE for each serving configuration of
one checkpoint, against the fp32 arm. Modes, by the JAX tool's names:
fp32 (dtype float32) and bf16 (bfloat16), both on the config's
``Predictor.exec_mode`` ("xla", the plain PyTorch path, in the shipped
YAMLs); pallas (bfloat16 with the hand-written attention kernel); int8
(dynamic int8 projections and feed-forward products). Every mode reads
the same checkpoint, the same test clips and the same latent draws, so the
deltas are the numerics alone. Writes ``exec_mode_fidelity.{json,md}``
under ``--out_dir`` (default ``runs/<run-name>/``).

    python -m npvp_tpu_torch.tools.exec_mode_fidelity --config_path <yaml> \\
        [--modes fp32 bf16 pallas int8] [--task VFP] [--max_batches N] \\
        [--device cpu] [--out_dir DIR] [--override k=v ...]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.eval.evaluate import evaluate
from npvp_tpu_torch.tools._cli import add_run_args, predictor_maker, run_dir
from npvp_tpu_torch.train.common import build_argparser, load_cli_config

# mode -> (dtype, exec_mode); None keeps the config's exec_mode
MODES = {
    "fp32": (torch.float32, None),
    "bf16": (torch.bfloat16, None),
    "pallas": (torch.bfloat16, "pallas"),
    "int8": (torch.bfloat16, "int8"),
}


def to_markdown(report: dict) -> str:
    ref = report["modes"].get("fp32")
    lines = [f"# Exec-mode fidelity — {report['run']} ({report['task']}, "
             f"best-of-{report['num_samples']})", "",
             "| mode | PSNR (dB) | ΔPSNR vs fp32 | SSIM | ΔSSIM |",
             "|---|---|---|---|---|"]
    for mode, row in report["modes"].items():
        dp = f"{row['PSNR'] - ref['PSNR']:+.3f}" if ref else "—"
        ds = f"{row['SSIM'] - ref['SSIM']:+.4f}" if ref else "—"
        lines.append(f"| {mode} | {row['PSNR']:.3f} | {dp} | "
                     f"{row['SSIM']:.4f} | {ds} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = build_argparser("serving exec-mode fidelity on a trained ckpt")
    ap.add_argument("--modes", nargs="+", default=list(MODES),
                    choices=list(MODES))
    ap.add_argument("--task", default="VFP")
    ap.add_argument("--num_samples", type=int, default=1)
    ap.add_argument("--max_batches", type=int, default=None)
    ap.add_argument("--random_init", action="store_true")
    add_run_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_cli_config(args)
    out_dir = run_dir(cfg, args.out_dir)

    report = {"config": args.config_path,
              "run": pathlib.Path(cfg.Predictor.ckpt_save_dir).name,
              "task": args.task, "num_samples": args.num_samples,
              "max_batches": args.max_batches, "modes": {}}
    make = predictor_maker(cfg, device, args.random_init)
    for mode in args.modes:
        t0 = time.time()
        res = evaluate(cfg, task=args.task, num_samples=args.num_samples,
                       max_batches=args.max_batches,
                       vp=make(*MODES[mode]))
        row = {"PSNR": float(res["PSNR"]), "SSIM": float(res["SSIM"]),
               "MSE": float(res["MSE"]), "seconds": time.time() - t0}
        report["modes"][mode] = row
        print(f"{mode}: PSNR={row['PSNR']:.3f} SSIM={row['SSIM']:.4f} "
              f"({row['seconds']:.0f}s)", flush=True)

    (out_dir / "exec_mode_fidelity.json").write_text(
        json.dumps(report, indent=2))
    (out_dir / "exec_mode_fidelity.md").write_text(to_markdown(report))
    print(f"wrote {out_dir}/exec_mode_fidelity.{{json,md}}")


if __name__ == "__main__":
    main(sys.argv[1:])
