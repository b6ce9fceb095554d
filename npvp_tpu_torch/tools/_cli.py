"""What the port's report tools share beyond the trainers' flags
(``train/common.py``): ``--device`` and ``--out_dir``, the run directory,
the ``--dtype`` names, and the predictors that serve one checkpoint in
several numerics."""

from __future__ import annotations

import pathlib

import torch

from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.tools.weights import load_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_run_args(ap, out_dir: bool = True) -> None:
    """The flags every report tool of the port adds to the JAX tool's:
    ``--device`` (default cuda, which raises without a card) and
    ``--out_dir``."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda raises without a card)")
    if out_dir:
        ap.add_argument("--out_dir", default=None)


def run_dir(cfg, out_dir) -> pathlib.Path:
    """``out_dir``, or ``runs/<name of Predictor.ckpt_save_dir>``; made."""
    run = pathlib.Path(cfg.Predictor.ckpt_save_dir).name
    path = pathlib.Path(out_dir or f"runs/{run}")
    path.mkdir(parents=True, exist_ok=True)
    return path


def predictor_maker(cfg, device, random_init: bool = False):
    """→ ``make(dtype, exec_mode=None, cfg=cfg)``: a ``VideoPredictor`` of
    the checkpoints that ``cfg`` names (as ``eval.evaluate`` loads them),
    or of random weights. A weights archive is read once, here, for every
    predictor made; ``make``'s ``cfg`` may cut the depth."""
    p = cfg.Predictor
    if random_init:
        def make(dtype, exec_mode=None, cfg=cfg):
            return VideoPredictor.from_random_init(
                cfg, dtype, exec_mode=exec_mode, device=device)
    elif str(p.ckpt_save_dir).endswith(".npz"):
        ae_vars, pred_vars, _ = load_weights(p.ckpt_save_dir)

        def make(dtype, exec_mode=None, cfg=cfg):
            return VideoPredictor.from_variables(
                cfg, ae_vars, pred_vars, dtype, exec_mode, device)
    else:
        def make(dtype, exec_mode=None, cfg=cfg):
            return VideoPredictor.from_checkpoints(
                cfg, p.resume_AE_ckpt, p.ckpt_save_dir, dtype=dtype,
                exec_mode=exec_mode, device=device)
    return make
