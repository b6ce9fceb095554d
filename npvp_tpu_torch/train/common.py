"""Shared trainer plumbing (port of ``npvp_tpu/train/common.py``): the CLI,
seeding, and the device. ``Env.platform`` picks the torch device: "cpu"
asks for the CPU, unset means the card ("cuda"), which raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from npvp_tpu_torch.core.config import Config, load_config
from npvp_tpu_torch.core.device import resolve_device


def build_argparser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--override", nargs="*", default=[], action="extend",
                        help="Group.key=value config overrides; the flag may "
                             "repeat and the lists accumulate")
    parser.add_argument("--smoke", action="store_true",
                        help="a dev set of two batches and one epoch")
    return parser


def load_cli_config(args) -> Config:
    cfg = load_config(args.config_path, overrides=args.override)
    if args.smoke:
        cfg.Dataset.dev_set_size = 2 * cfg.Dataset.batch_size
        cfg.AE.epochs = 1
        cfg.Predictor.epochs = 1
    return cfg


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.Env.compute_dtype == "bfloat16"
            else torch.float32)


def setup(cfg: Config) -> torch.device:
    """Seed numpy and torch from ``Env.rand_seed`` and return the device of
    ``Env.platform`` ("cpu", or the card when unset)."""
    np.random.seed(cfg.Env.rand_seed)
    torch.manual_seed(cfg.Env.rand_seed)
    platform = cfg.Env.platform or "cuda"
    return resolve_device({"gpu": "cuda"}.get(platform, platform))
