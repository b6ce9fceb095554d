"""Export trained weights to one compressed ``.npz`` in the JAX package's
artifact format (port of ``npvp_tpu/tools/export_weights.py``'s CLI).

The archive holds the evaluation state of the frozen AE and the predictor
(parameters and running statistics, no optimizer moments) under flax's
names and layouts, float16 where the values allow
(:func:`npvp_tpu_torch.tools.weights.save_weights`). Either package reads
it: ``VideoPredictor.from_weights(cfg, "weights.npz")`` here, and the same
call of ``npvp_tpu.models.inference.VideoPredictor`` in JAX.

    python -m npvp_tpu_torch.tools.export_weights --config_path <yaml> \\
        --out results/<run>/weights.npz [--ae_ckpt DIR|.npz] \\
        [--pred_ckpt DIR] [--ae_only] [--best]
"""

from __future__ import annotations

import sys
from pathlib import Path

from npvp_tpu_torch.core.checkpoint import CheckpointManager
from npvp_tpu_torch.core.config import load_config
from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.models.predictor import build_predictor
from npvp_tpu_torch.nn.resnet_ae import build_ae
from npvp_tpu_torch.tools.weights import load_flax, load_weights, save_weights
from npvp_tpu_torch.train.common import build_argparser, config_device


def _restore(module, directory, monitor: str, best: bool) -> int:
    """``module`` from a port checkpoint directory (its latest or best
    step) in place; returns the step."""
    mngr = CheckpointManager(directory, monitor=monitor, mode="min")
    step = mngr.best_step() if best else mngr.latest_step()
    module.load_state_dict(mngr.load(step)["model"])
    return int(step)


def main(argv=None):
    parser = build_argparser("export trained weights to a committable npz "
                             "(PyTorch port)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--ae_ckpt", default=None,
                        help="port checkpoint dir or .npz archive "
                             "(default cfg.Predictor.resume_AE_ckpt)")
    parser.add_argument("--pred_ckpt", default=None,
                        help="port checkpoint dir (default "
                             "cfg.Predictor.ckpt_save_dir)")
    parser.add_argument("--ae_only", action="store_true",
                        help="export the stage-1 AE only")
    parser.add_argument("--best", action="store_true",
                        help="export the best-metric step instead of latest")
    args = parser.parse_args(argv)
    cfg = load_config(args.config_path, overrides=args.override)
    ae_src = args.ae_ckpt or cfg.Predictor.resume_AE_ckpt
    pred_src = args.pred_ckpt or cfg.Predictor.ckpt_save_dir

    ae = build_ae(cfg)
    if str(ae_src).endswith(".npz"):
        ae_vars, _, ae_meta = load_weights(ae_src)
        load_flax(ae, ae_vars)
        ae_step = int(ae_meta.get("ae_step", 0))
    else:
        ae_step = _restore(ae, ae_src, "L1_loss_valid", args.best)
    predictor, pred_step = None, 0
    if not args.ae_only:
        predictor = build_predictor(cfg)
        pred_step = _restore(predictor, pred_src, "loss_val", args.best)

    meta = {"config_path": args.config_path, "ae_step": ae_step,
            "pred_step": pred_step}
    save_weights(args.out, ae, predictor, meta)
    size = Path(args.out).stat().st_size / 1e6
    print(f"wrote {args.out}: {size:.1f} MB, meta={meta}")
    if not args.ae_only:
        # the archive must reload into a working predictor
        VideoPredictor.from_weights(cfg, args.out,
                                    device=config_device(cfg))
        print("reload OK")


if __name__ == "__main__":
    main(sys.argv[1:])
