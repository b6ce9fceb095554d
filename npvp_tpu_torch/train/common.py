"""Shared trainer plumbing (port of ``npvp_tpu/train/common.py``): the CLI,
seeding, the device, the process group and its mesh, the profiler window
and the NaN checks. ``Env.platform`` picks the torch device: "cpu" asks
for the CPU, unset means the card ("cuda"), which raises without one.
Under ``torchrun`` (or in a process that has joined a group already) the
trainers run on the group: ``Env.mesh_shape`` lays the ranks out as a
(data, model) mesh, the model replicated over the data axis in DDP, or
fully sharded with ``Env.fsdp`` (:func:`parallelize_state`); each
process's device is ``cuda:LOCAL_RANK``.

    torchrun --nproc_per_node=4 -m npvp_tpu_torch.train.stage2_predictor \
        --config_path <yaml> --override "Env.mesh_shape=[[data,2],[model,2]]" \
        Env.fsdp=true

``Env.sequence_parallel`` splits the VidHRFormer stacks' activations on H
over the mesh's model axis (``core.sequence_parallel``):

    torchrun --nproc_per_node=4 -m npvp_tpu_torch.train.stage2_predictor \
        --config_path <yaml> --override "Env.mesh_shape=[[data,2],[model,2]]" \
        Env.sequence_parallel=true

``Env.profile_dir`` traces train steps 10-14 with ``torch.profiler``
(:class:`StepProfiler`); ``Env.debug_nans`` turns on autograd's anomaly
detection and makes every train step check its losses
(:func:`check_finite`).
"""

from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from npvp_tpu_torch.core import distributed as D
from npvp_tpu_torch.core import tracing
from npvp_tpu_torch.core.checkpoint import CheckpointManager
from npvp_tpu_torch.core.config import Config, load_config
from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.core.sequence_parallel import enable_sequence_parallel
from npvp_tpu_torch.core.tensor_parallel import shard_tensor_parallel
from npvp_tpu_torch.core.train_state import TrainState
from npvp_tpu_torch.nn.layers import sync_batchnorm
from npvp_tpu_torch.tools.weights import warm_start_state


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


def setup(cfg: Config):
    """Seed numpy and torch from ``Env.rand_seed``, set autograd's anomaly
    detection to ``Env.debug_nans``, join the process group when there is
    one, set sequence parallelism on its mesh as ``Env.sequence_parallel``
    says (off without a group), and return (device, mesh): the device of
    ``Env.platform`` (``cuda:LOCAL_RANK`` on a group) and the (data, model)
    ``DeviceMesh`` of ``Env.mesh_shape``, or None for a run of one process
    that no launcher started."""
    torch.autograd.set_detect_anomaly(cfg.Env.debug_nans)
    np.random.seed(cfg.Env.rand_seed)
    torch.manual_seed(cfg.Env.rand_seed)
    device = config_device(cfg)
    enable_sequence_parallel(None)
    if not D.maybe_init_distributed(device.type):
        return device, None
    axes = dict(tuple(a) for a in cfg.Env.mesh_shape)
    mesh = D.make_mesh(axes.get("data", -1), axes.get("model", 1),
                       cfg.Dataset.batch_size, device.type)
    if (cfg.Predictor.param_free_norm_type in ("batch", "syncbatch")
            and D.axis(mesh, D.DATA_AXIS) is not None):
        raise ValueError("param_free_norm_type "
                         f"{cfg.Predictor.param_free_norm_type!r} takes "
                         "batch statistics, which the port does not "
                         "gather over the data axis")
    if cfg.Env.sequence_parallel:
        enable_sequence_parallel(mesh)
    return D.local_device(device.type), mesh


def data_split(mesh):
    """(process_index, process_count) of this rank on the data axis: how
    the loaders split the global batch."""
    shard = D.axis(mesh, D.DATA_AXIS)
    return (0, 1) if shard is None else (shard.rank, shard.size)


def parallelize_state(state: TrainState, mesh, fsdp: bool, units=(),
                      tensor_parallel: bool = True) -> TrainState:
    """``state`` (a one-process state: fresh, or restored from a
    checkpoint) laid out over ``mesh``, in place: the model split over the
    model axis (``tensor_parallel``), its BatchNorms given the data axis,
    then wrapped in DDP or, with ``fsdp``, fully sharded unit by unit
    (``units(model)``: the modules that FSDP shards before the root); the
    optimizer moved onto the new parameters; the state's weights and
    moments cut into this rank's pieces. Without a mesh the
    state is returned as it is."""
    if mesh is None:
        return state
    full = state.state_dict()  # copied: the wrapping may reuse storage
    full = dict(full, model={k: v.detach().clone()
                             for k, v in full["model"].items()},
                optimizer=copy.deepcopy(full["optimizer"]))
    model = state.module
    shards = (shard_tensor_parallel(model, mesh) if tensor_parallel
              else shard_tensor_parallel(model, None))
    sync_batchnorm(model, D.axis(mesh, D.DATA_AXIS))
    state.model = D.wrap_data_parallel(model, mesh, fsdp,
                                       units(model) if units else ())
    params, start = list(model.parameters()), 0
    for group in state.optimizer.param_groups:  # the same order, new tensors
        n = len(group["params"])
        group["params"] = params[start:start + n]
        start += n
    state.optimizer.state.clear()
    state.shards = shards
    state.load_state_dict(full)
    return state


def run_train_chunk(state: TrainState, step, chunk, mesh, meters,
                    on_step, loader) -> None:
    """``Env.steps_per_dispatch``: run ``step(batch)`` (one train step,
    → this rank's metrics) over the batches of ``chunk``, then fetch the
    metrics: the data axis's means of all of them in one all-reduce, into
    ``meters`` with the loader's ``data_wait_ms``, and ``on_step("train",
    step_number, metrics)`` for each."""
    out = [step(batch) for batch in chunk]
    flat = D.all_mean({f"{i}/{k}": v for i, m in enumerate(out)
                       for k, v in m.items()}, mesh)
    first = state.step - len(out) + 1
    for i, m in enumerate(out):
        metrics = {k: flat[f"{i}/{k}"] for k in m}
        metrics["data_wait_ms"] = loader.last_wait_ms
        meters.update(metrics)
        if on_step is not None:
            on_step("train", first + i, metrics)


def train_chunks(loader, K: int, state: TrainState, max_steps, profiler):
    """The loader's batches in chunks of ``K`` (fewer at the end of the
    epoch or at ``max_steps``), opening the profiler window at the step
    each batch will run as."""
    chunk = []
    for batch in loader:
        profiler.maybe_start_profiler(state.step + len(chunk))
        chunk.append(batch)
        if len(chunk) == K or (max_steps is not None
                               and state.step + len(chunk) >= max_steps):
            yield chunk
            chunk = []
            if max_steps is not None and state.step >= max_steps:
                return
    if chunk:
        yield chunk


def restore_state(state: TrainState, src, half: str) -> TrainState:
    """A resume checkpoint into ``state`` in place: a port checkpoint
    directory (its latest step) or file in full, or a weights archive
    (``.npz``): its ``half`` ("ae" or "pred") with its saved step and fresh
    optimizer moments (the archive holds none), as JAX's
    ``warm_start_state``."""
    if str(src).endswith(".npz"):
        warm_start_state(state, src, half)
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
    (Chrome trace format, readable by Perfetto). The window turns the
    program's tracing (``core.tracing``) on, so the trace holds the spans
    of the steps, the predictor's sublayers and the loader's wait; a window
    that turned it on turns it off after, and drops the records it kept
    (the trace holds them)."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 5):
        self.profile_dir = profile_dir
        self.start_step, self.num_steps = start_step, num_steps
        self._prof = None
        self._steps = (0, 0)  # first and last step inside the open window
        self._traced = False  # whether the window turned tracing on

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
            self._traced = not tracing.enabled()
            tracing.enable()
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
        if self._traced:
            tracing.disable()
            tracing.take()
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace_steps_{}-{}.json".format(*self._steps)
        prof.export_chrome_trace(str(path))
        return path
