"""Export a model to a self-contained serving bundle (port of
``npvp_tpu/tools/export_serving.py``).

CLI front-end for :meth:`VideoPredictor.export_task`: loads the stage-1 and
stage-2 checkpoints that the config names (or random weights), specialises
the forward to one task shape and writes ``program.pt2``
(``torch.export``, weights inside) and ``meta.json``. The program runs on
the device it was exported on (``Env.platform``, the card when unset).
Serve with::

    from npvp_tpu_torch.models.inference import VideoPredictor  # the ops
    fn = VideoPredictor.serve_exported("bundle_dir")
    pred = fn(observed_frames)                          # (N, TP, H, W, C)

Example::

    python -m npvp_tpu_torch.tools.export_serving \\
        --config_path npvp_tpu_torch/configs/config_SMMNIST_Unified_NPVP-S.yaml \\
        --task VFP --batch_size 8 --out bundles/smmnist_vfp
"""

from __future__ import annotations

import sys

import numpy as np

from npvp_tpu_torch.models.coords import task_time_lists
from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.train.common import (build_argparser, config_device,
                                         load_cli_config)


def main(argv=None):
    parser = build_argparser("NPVP serving-bundle export (PyTorch port)")
    parser.add_argument("--task", default="VFP",
                        help="VFP | VPE | VFI (canonical index lists), or "
                             "use --to_list/--tp_list for arbitrary times")
    parser.add_argument("--to_list", nargs="*", type=float, default=None,
                        help="observed times (overrides --task)")
    parser.add_argument("--tp_list", nargs="*", type=float, default=None,
                        help="target times (overrides --task)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--out", required=True)
    parser.add_argument("--random_init", action="store_true",
                        help="random weights (artifact-format smoke only)")
    args = parser.parse_args(argv)
    cfg = load_cli_config(args)

    if (args.to_list is None) != (args.tp_list is None):
        parser.error("--to_list and --tp_list must be given together")
    if args.to_list is not None:
        to_list, tp_list = args.to_list, args.tp_list
    else:
        d = cfg.Dataset
        to, tp = task_time_lists(args.task, d.test_num_past_frames,
                                 d.test_num_future_frames,
                                 context_p=d.test_num_past_frames // 2,
                                 context_f=d.test_num_past_frames // 2)
        to_list, tp_list = np.asarray(to).tolist(), np.asarray(tp).tolist()

    device = config_device(cfg)
    if args.random_init:
        vp = VideoPredictor.from_random_init(cfg, device=device)
    else:
        vp = VideoPredictor.from_checkpoints(
            cfg, cfg.Predictor.resume_AE_ckpt, cfg.Predictor.ckpt_save_dir,
            device=device)
    vp.export_task(args.out, to_list, tp_list, args.batch_size)
    print(f"exported task to={to_list} tp={tp_list} "
          f"batch={args.batch_size} device={device.type} -> {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
