"""Shared trainer plumbing (port of ``npvp_tpu/train/common.py``): the CLI,
seeding, and the device. ``Env.platform`` picks the torch device: "cpu"
asks for the CPU, unset means the card ("cuda"), which raises without one.
The trainers name, once at start, the JAX-only ``Env`` fields that a config
sets and the port does not honour (mesh, FSDP, sequence parallelism,
profiler, NaN checks, multi-step dispatch).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from npvp_tpu_torch.core.checkpoint import CheckpointManager
from npvp_tpu_torch.core.config import Config, load_config
from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.core.train_state import TrainState
from npvp_tpu_torch.tools.weights import load_flax, load_weights


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


def config_device(cfg: Config) -> torch.device:
    """The torch device of ``Env.platform``: "cpu", or the card when
    unset."""
    platform = cfg.Env.platform or "cuda"
    return resolve_device({"gpu": "cuda"}.get(platform, platform))


def unhonoured_env_fields(cfg: Config) -> list:
    """``Env`` fields set away from their defaults that only the JAX
    package reads."""
    e = cfg.Env
    mesh = tuple(tuple(axis) for axis in e.mesh_shape)
    set_fields = {"fsdp": e.fsdp, "mesh_shape": mesh != (("data", -1),),
                  "sequence_parallel": e.sequence_parallel,
                  "profile_dir": e.profile_dir is not None,
                  "debug_nans": e.debug_nans,
                  "steps_per_dispatch": e.steps_per_dispatch > 1}
    return [name for name, on in set_fields.items() if on]


def setup(cfg: Config) -> torch.device:
    """Seed numpy and torch from ``Env.rand_seed``, name the set ``Env``
    fields the port ignores, and return the device of ``Env.platform``."""
    ignored = unhonoured_env_fields(cfg)
    if ignored:
        print("Env fields set but not honoured by the PyTorch port: "
              + ", ".join(f"{k}={getattr(cfg.Env, k)!r}" for k in ignored))
    np.random.seed(cfg.Env.rand_seed)
    torch.manual_seed(cfg.Env.rand_seed)
    return config_device(cfg)


def restore_state(state: TrainState, src, half: str) -> TrainState:
    """A resume checkpoint into ``state`` in place: a port checkpoint
    directory (its latest step) or file in full, or a weights archive
    (``.npz``): its ``half`` ("ae" or "pred") with its saved step and fresh
    optimizer moments (the archive holds none), as JAX's
    ``warm_start_state``."""
    if str(src).endswith(".npz"):
        ae_vars, pred_vars, meta = load_weights(src)
        load_flax(state.model, ae_vars if half == "ae" else pred_vars)
        state.step = int(meta.get(f"{half}_step", 0))
    elif Path(src).is_dir():
        CheckpointManager(src).restore(state)
    else:
        state.load_state_dict(torch.load(src, map_location="cpu"))
    return state
