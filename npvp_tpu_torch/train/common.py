"""Shared trainer plumbing (port of ``npvp_tpu/train/common.py``): the CLI,
seeding, the device, the profiler window and the NaN checks.
``Env.platform`` picks the torch device: "cpu" asks for the CPU, unset
means the card ("cuda"), which raises without one. ``Env.profile_dir``
traces train steps 10-14 with ``torch.profiler`` (:class:`StepProfiler`);
``Env.debug_nans`` turns on autograd's anomaly detection and makes every
train step check its losses (:func:`check_finite`). The trainers name,
once at start, the JAX-only ``Env`` fields that a config sets and the port
does not honour (mesh, FSDP, sequence parallelism, multi-step dispatch).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

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
                  "steps_per_dispatch": e.steps_per_dispatch > 1}
    return [name for name, on in set_fields.items() if on]


def setup(cfg: Config) -> torch.device:
    """Seed numpy and torch from ``Env.rand_seed``, set autograd's anomaly
    detection to ``Env.debug_nans``, name the set ``Env`` fields the port
    ignores, and return the device of ``Env.platform``."""
    ignored = unhonoured_env_fields(cfg)
    if ignored:
        print("Env fields set but not honoured by the PyTorch port: "
              + ", ".join(f"{k}={getattr(cfg.Env, k)!r}" for k in ignored))
    torch.autograd.set_detect_anomaly(cfg.Env.debug_nans)
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


def check_finite(metrics: Dict[str, torch.Tensor], step: int) -> None:
    """Raise ``FloatingPointError`` naming the first metric of train step
    ``step`` that is NaN or infinite (``Env.debug_nans``; it waits for the
    device)."""
    for name, value in metrics.items():
        value = torch.as_tensor(value).detach()
        if not bool(torch.isfinite(value).all()):
            raise FloatingPointError(
                f"train step {step}: {name} = {float(value)} is not finite "
                "(Env.debug_nans)")


class StepProfiler:
    """A ``torch.profiler`` trace of train steps ``start_step`` …
    ``start_step + num_steps − 1`` into ``profile_dir`` (the JAX trainers'
    ``jax.profiler`` window): the trainers call :meth:`maybe_start_profiler`
    before every train step and :meth:`stop_profiler` at teardown, which
    closes a window that a short run left open. The trace is written as
    ``<profile_dir>/trace_steps_<first>-<last>.json``, the steps it holds
    (Chrome trace format, readable by Perfetto)."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 5):
        self.profile_dir = profile_dir
        self.start_step, self.num_steps = start_step, num_steps
        self._prof = None
        self._steps = (0, 0)  # first and last step inside the open window

    def maybe_start_profiler(self, step: int) -> Optional[str]:
        """Open the window before step ``start_step``, close it before step
        ``start_step + num_steps``; → "started", "stopped" or None."""
        if self.profile_dir is None:
            return None
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._steps = (step, step)
            return "started"
        if self._prof is None:
            return None
        if step == self.start_step + self.num_steps:
            self.stop_profiler()
            return "stopped"
        self._steps = (self._steps[0], step)
        return None

    def stop_profiler(self) -> Optional[Path]:
        """Close an open window and write its trace; → the trace's path."""
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace_steps_{}-{}.json".format(*self._steps)
        prof.export_chrome_trace(str(path))
        return path
