"""Stage-1 trainer: the frame autoencoder with an L1 reconstruction loss
(port of ``npvp_tpu/train/stage1_ae.py``).

    python -m npvp_tpu_torch.train.stage1_ae \\
        --config_path npvp_tpu_torch/configs/config_SMMNIST_Autoencoder.yaml \\
        --smoke [--override Env.platform=cpu ...]

A step reconstructs ``concat(past, future)`` with the AE in training mode
(its BatchNorms normalise with the batch's statistics and move their running
ones by flax's rule), takes the L1 against the input and an Adam(0.5, 0.999)
update. Each epoch ends with a validation pass in eval mode, a checkpoint
(the best 5 by ``L1_loss_valid`` kept) and, every ``AE.log_per_epochs``
epochs under ``Env.visual_callback``, a GT | reconstruction GIF. The
checkpoint directory is what a stage-2 config names in
``Predictor.resume_AE_ckpt``. ``AE.resume_ckpt`` resumes from such a
directory (model, optimizer and step) or warm-starts from a weights archive
(``.npz``: parameters, statistics and step, fresh optimizer moments).

Each train step's metrics carry ``data_wait_ms``, the time the step waited
for its batch on the loader's prefetch queue. ``Env.profile_dir`` traces
steps 10-14; ``Env.debug_nans`` checks each step's L1 before its backward
pass.

``Env.steps_per_dispatch = K`` runs K steps before their metrics are
fetched, with the losses of K = 1. On a process group (``torchrun``) the AE
is replicated over the data axis in DDP, or fully sharded with
``Env.fsdp`` (encoder and decoder as units), never split over a model axis
(JAX's ``tp=False``); its BatchNorms take the global batch's statistics,
the metrics are the global batch's means, and rank 0 alone logs and writes
checkpoints and GIFs.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from npvp_tpu_torch.core import distributed as D
from npvp_tpu_torch.core.checkpoint import CheckpointManager
from npvp_tpu_torch.core.config import Config
from npvp_tpu_torch.core.metrics import (AverageMeters, MetricsLogger,
                                         save_clip_gifs)
from npvp_tpu_torch.core.optim import make_ae_optimizer
from npvp_tpu_torch.core.train_state import TrainState, param_count
from npvp_tpu_torch.data.loader import DataModule
from npvp_tpu_torch.nn.losses import l1_loss
from npvp_tpu_torch.nn.resnet_ae import FrameAutoEncoder, build_ae
from npvp_tpu_torch.tools.weights import random_init
from npvp_tpu_torch.train.common import (StepProfiler, build_argparser,
                                         check_finite, compute_dtype,
                                         data_split, load_cli_config,
                                         parallelize_state, restore_state,
                                         run_train_chunk, setup,
                                         train_chunks)


def init_state(cfg: Config, ae: FrameAutoEncoder) -> TrainState:
    """Random weights from ``Env.rand_seed`` and Adam(0.5, 0.999) at
    ``AE.AE_lr``; the AE is on its device already."""
    random_init(ae, cfg.Env.rand_seed)
    lr = cfg.AE.AE_lr
    return TrainState(ae, make_ae_optimizer(ae.parameters(), lr),
                      lambda step: lr)


class Steps(NamedTuple):
    train: Callable     # (state, batch) -> {"L1_loss_train"}
    eval: Callable      # (state, batch) -> {"L1_loss_valid"}
    vis: Callable       # (state, batch) -> reconstructed clips
    place: Callable     # numpy batch -> tensors on the device


def make_steps(device, debug_nans: bool = False) -> Steps:
    """The steps on ``device``; ``debug_nans`` checks each train step's L1
    before its backward pass."""

    def clips(batch):
        return torch.cat([batch["past"], batch["future"]], dim=1)

    def train_step(state: TrainState, batch):
        x = clips(batch)
        state.model.train()
        rec, _ = state.model(x)
        loss = l1_loss(rec, x)
        if debug_nans:
            check_finite({"L1_loss_train": loss}, state.step)
        loss.backward()
        state.apply_gradients()
        return {"L1_loss_train": loss.detach()}

    def vis_step(state: TrainState, batch):
        state.module.eval()
        with torch.no_grad():
            return state.module(clips(batch))[0]

    def eval_step(state: TrainState, batch):
        return {"L1_loss_valid": l1_loss(vis_step(state, batch),
                                         clips(batch))}

    def place(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    return Steps(train_step, eval_step, vis_step, place)


def train(cfg: Config, max_steps: Optional[int] = None, sprites=None,
          on_step: Optional[Callable] = None) -> TrainState:
    """Train for ``AE.epochs`` epochs (or ``max_steps`` steps), validating,
    checkpointing and drawing a GIF as the module docstring says.
    ``sprites`` optionally maps "train"/"test" to SMMNIST sprite banks;
    ``on_step(kind, index, metrics)`` is called after every "train" and
    "eval" step."""
    device, mesh = setup(cfg)
    main_rank = D.is_main_process()
    a = cfg.AE
    ae = build_ae(cfg, compute_dtype(cfg)).to(device)
    dm = DataModule(cfg, sprites, *data_split(mesh))
    train_loader, val_loader = dm.train_loader(), dm.val_loader()
    state = init_state(cfg, ae)
    if main_rank:
        print(f"AE parameters: {param_count(ae) / 1e6:.2f}M | "
              f"device={device} | mesh={mesh}")
    start_epoch = a.start_epoch
    if a.resume_ckpt:
        restore_state(state, a.resume_ckpt, "ae")
        start_epoch = state.step // max(1, dm.len_train_loader or 1)
    state = parallelize_state(
        state, mesh, cfg.Env.fsdp, lambda m: [m.encoder, m.decoder],
        tensor_parallel=False)

    ckpt = CheckpointManager(a.ckpt_save_dir, max_to_keep=5,
                             monitor="L1_loss_valid", mode="min",
                             writer=main_rank)
    logger = MetricsLogger(a.tensorboard_save_dir) if main_rank else None
    steps = make_steps(device, cfg.Env.debug_nans)
    if main_rank:
        cfg.save(f"{a.ckpt_save_dir}/config.json")
    profiler = StepProfiler(cfg.Env.profile_dir if main_rank else None)
    K = max(1, cfg.Env.steps_per_dispatch)
    try:
        for epoch in range(start_epoch, a.epochs):
            train_loader.set_epoch(epoch)
            meters = AverageMeters()
            for chunk in train_chunks(train_loader, K, state, max_steps,
                                      profiler):
                run_train_chunk(
                    state, lambda b: steps.train(state, steps.place(b)),
                    chunk, mesh, meters, on_step, train_loader)
            val_meters = AverageMeters()
            for vi, batch in enumerate(val_loader):
                metrics = D.all_mean(steps.eval(state, steps.place(batch)),
                                     mesh)
                val_meters.update(metrics)
                if on_step is not None:
                    on_step("eval", vi, metrics)
            scalars = {**meters.averages(), **val_meters.averages()}
            if main_rank:
                logger.log_scalars(state.step, scalars)
                print(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.5f}" for k, v in scalars.items()))
            ckpt.save(state.step, state, metrics={
                "L1_loss_valid": scalars.get("L1_loss_valid", 0.0)})
            if (cfg.Env.visual_callback
                    and epoch % max(1, a.log_per_epochs) == 0):
                batch = next(iter(val_loader))
                rec = steps.vis(state, steps.place(batch))
                if main_rank:
                    save_clip_gifs(
                        Path(a.tensorboard_save_dir) / f"epoch_{epoch}.gif",
                        {"gt": np.concatenate([batch["past"][0],
                                               batch["future"][0]]),
                         "rec": rec[0].float().cpu().numpy()},
                        renorm=dm.renorm)
            if max_steps is not None and state.step >= max_steps:
                break
        ckpt.wait()  # the last checkpoint whole before returning
    finally:
        profiler.stop_profiler()
        if logger is not None:
            logger.close()
        train_loader.close()
        val_loader.close()
        # a run that ends in an exception still leaves whole files
        ckpt.close()
    return state


def main(argv=None):
    args = build_argparser(
        "NPVP stage-1 autoencoder training (PyTorch port)").parse_args(argv)
    cfg = load_cli_config(args)
    train(cfg, max_steps=20 if args.smoke else None)


if __name__ == "__main__":
    main(sys.argv[1:])
