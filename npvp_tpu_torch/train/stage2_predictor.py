"""Stage-2 trainer: the NP predictor over a frozen stage-1 autoencoder
(port of ``npvp_tpu/train/stage2_predictor.py``).

    python -m npvp_tpu_torch.train.stage2_predictor \\
        --config_path npvp_tpu/configs/config_SMMNIST_Unified_NPVP-S.yaml \\
        --smoke [--override Env.platform=cpu ...]

Each step runs the frozen AE's encode, the predictor's forward and backward
(training mode: dropout, DropPath, the posterior latent for NPVP-S), the
frozen AE's decode (gradients flow through it into the predicted features),
the L1 and feature-L1 losses plus β·KL, then the clip of the decoder's
gradients and AdamW with cosine warm restarts. Three modes: ``pairs`` (VFP),
``vfi`` (fixed interpolation split) and ``rand_context`` (the unified
model: full-``max_T`` clips with per-batch masks).

The eval step runs the predictor in eval mode under ``torch.no_grad()``,
where ``exec_mode: pallas`` sends its attention to the hand-written kernel.
Step ``s`` draws its noise from ``Rng(Env.rand_seed).fold(s)``, as JAX draws
from ``fold_in(base_rng, s)``; ``Env.steps_per_dispatch`` > 1 still runs the
steps one by one, which JAX's scan over a chunk of steps equals by
construction.

Every ``Predictor.log_per_epochs`` epochs, under ``Env.visual_callback``,
one validation clip and its prediction (eval mode, so the kernel serves it
under ``exec_mode: pallas``) go into ``<tensorboard_save_dir>/epoch_<e>.gif``.

Each train step's metrics carry ``data_wait_ms``, the time the step waited
for its batch on the loader's prefetch queue (logged per epoch as
``data_wait_ms_train``). ``Env.profile_dir`` traces steps 10-14;
``Env.debug_nans`` checks each step's losses before its backward pass.

Not ported yet: the GAN steps, FSDP and the device mesh (the trainer names
such ``Env`` fields when a config sets them).
"""

from __future__ import annotations

import copy
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from npvp_tpu_torch.core.checkpoint import CheckpointManager, load_model_state
from npvp_tpu_torch.core.config import Config
from npvp_tpu_torch.core.metrics import (AverageMeters, MetricsLogger,
                                         save_clip_gifs)
from npvp_tpu_torch.core.optim import (is_decoder_param,
                                       make_predictor_optimizer,
                                       predictor_schedule)
from npvp_tpu_torch.core.train_state import TrainState, param_count
from npvp_tpu_torch.data.loader import DataModule
from npvp_tpu_torch.models.coords import (coordinate_grid,
                                          full_coordinate_volume,
                                          spatial_index_lists,
                                          task_time_lists)
from npvp_tpu_torch.models.predictor import NPPredictor, build_predictor
from npvp_tpu_torch.nn.layers import Rng
from npvp_tpu_torch.nn.losses import kl_divergence, l1_loss
from npvp_tpu_torch.nn.resnet_ae import FrameAutoEncoder, build_ae
from npvp_tpu_torch.tools.weights import load_trained, random_init
from npvp_tpu_torch.train.common import (StepProfiler, build_argparser,
                                         check_finite, compute_dtype,
                                         load_cli_config, restore_state,
                                         setup)


def load_frozen_ae(cfg: Config, dtype, device) -> FrameAutoEncoder:
    """The stage-1 AE from ``Predictor.resume_AE_ckpt`` (a weights archive
    ``.npz`` through the flax bridge, else a port checkpoint directory or
    file), in eval mode, its parameters frozen."""
    ae = load_trained(build_ae(cfg, dtype), cfg.Predictor.resume_AE_ckpt,
                      "ae")
    return ae.to(device).eval().requires_grad_(False)


def build_coords(cfg: Config, test: bool = False, device="cpu"):
    """Observed/target coordinate grids of the configured static task, and
    their frame counts."""
    p, d = cfg.Predictor, cfg.Dataset
    h, w = spatial_index_lists(p.max_H, p.max_W)
    num_past = d.test_num_past_frames if test else d.num_past_frames
    num_future = d.test_num_future_frames if test else d.num_future_frames
    if p.VFI:
        to, tp = task_time_lists("VFI", num_past, num_future,
                                 p.context_num_p, p.context_num_f)
    else:
        to, tp = task_time_lists("VFP", num_past, num_future)
    grid = lambda t: coordinate_grid(t, h, w, p.max_T, p.max_H,  # noqa
                                     p.max_W, device=device)
    return grid(to), grid(tp), len(to), len(tp)


def init_predictor_state(cfg: Config, predictor: NPPredictor,
                         steps_per_epoch: int) -> TrainState:
    """Random weights from ``Env.rand_seed`` and the stage-2 optimizer; the
    predictor is on its device already."""
    p = cfg.Predictor
    random_init(predictor, cfg.Env.rand_seed)
    return TrainState(
        predictor, make_predictor_optimizer(predictor.parameters(),
                                            p.predictor_lr),
        predictor_schedule(p.predictor_lr, p.use_cosine_scheduler,
                           p.scheduler_eta_min,
                           p.scheduler_T0 * max(1, steps_per_epoch)),
        p.max_grad_norm, is_decoder_param)


def merge_det_init(det_state: dict, sto_state: dict) -> dict:
    """A stochastic model's state dict initialised from a deterministic
    one: every entry present in both with one shape is taken from
    ``det_state``."""
    return {k: (det_state[k] if k in det_state
                and det_state[k].shape == v.shape else v)
            for k, v in sto_state.items()}


class Steps(NamedTuple):
    train: Callable     # (state, batch, rng) -> metrics
    eval: Callable      # (state, batch, rng) -> metrics with "_val" keys
    place: Callable     # numpy batch -> tensors on the device


def make_steps(cfg: Config, ae: FrameAutoEncoder, mode: str,
               device) -> Steps:
    p = cfg.Predictor
    stochastic = p.stochastic

    def encode(frames):
        with torch.no_grad():
            return ae.encode(frames)

    def losses(out, pred_frames, frames, feats, mask):
        img_l1 = l1_loss(pred_frames, frames, mask=mask)
        pf_l1 = l1_loss(out.pred_features, feats, lam=p.lam_PF_L1,
                        mask=mask)
        metrics = {"Image_L1": img_l1, "PF_L1": pf_l1}
        loss = img_l1 + pf_l1
        if stochastic:
            kl = kl_divergence(out.mu_o, out.logvar_o, out.mu_p,
                               out.logvar_p, p.KL_beta)
            metrics["KL_loss"] = kl
            loss = loss + kl
        return loss, {"loss": loss, **metrics}

    if mode == "rand_context":
        coords = full_coordinate_volume(p.max_T, p.max_H, p.max_W, device)

        def forward(model, batch, rng):
            feats = encode(batch["clip"])
            out = model(feats, coords, coords,
                        target_feats_gt=feats if stochastic else None,
                        obs_mask=batch["obs_mask"],
                        tgt_mask=batch["tgt_mask"], rng=rng)
            return losses(out, ae.decode(out.pred_features), batch["clip"],
                          feats, batch["tgt_mask"])
    else:
        oc, tc, _, _ = build_coords(cfg, device=device)

        def forward(model, batch, rng):
            past, future = encode(batch["past"]), encode(batch["future"])
            out = model(past, oc, tc,
                        target_feats_gt=future if stochastic else None,
                        rng=rng)
            return losses(out, ae.decode(out.pred_features),
                          batch["future"], future, None)

    def train_step(state: TrainState, batch, rng: Rng):
        state.model.train()
        loss, metrics = forward(state.model, batch, rng)
        if cfg.Env.debug_nans:
            check_finite(metrics, state.step)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(state: TrainState, batch, rng: Rng):
        state.model.eval()
        with torch.no_grad():
            _, metrics = forward(state.model, batch, rng)
        return {k + "_val": v for k, v in metrics.items()}

    def place(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    return Steps(train_step, eval_step, place)


def train(cfg: Config, max_steps: Optional[int] = None, sprites=None,
          on_step: Optional[Callable] = None) -> TrainState:
    """Train for ``Predictor.epochs`` epochs (or ``max_steps`` steps),
    validating and checkpointing after each epoch. ``sprites`` optionally
    maps "train"/"test" to SMMNIST sprite banks; ``on_step(kind, index,
    metrics)`` is called after every "train" and "eval" step, for timing."""
    device = setup(cfg)
    dtype = compute_dtype(cfg)
    p = cfg.Predictor
    ae = load_frozen_ae(cfg, dtype, device)
    predictor = build_predictor(cfg, dtype).to(device)
    dm = DataModule(cfg, sprites)
    mode = dm.predictor_mode()
    train_loader, val_loader = dm.train_loader(mode), dm.val_loader(mode)
    state = init_predictor_state(cfg, predictor, dm.len_train_loader or 1)
    if p.init_det_ckpt_for_vae:
        src = str(p.init_det_ckpt_for_vae)
        if src.endswith(".npz"):
            # an NPVP-D weights archive: its tree fits a deterministic
            # predictor, whose state dict then fills the shared entries
            det_cfg = copy.deepcopy(cfg)
            det_cfg.Predictor.stochastic = False
            det_state = load_trained(build_predictor(det_cfg), src,
                                     "pred").state_dict()
        else:
            det_state = load_model_state(src)
        # parameters only: the running statistics keep their init, as JAX
        # merges ``params`` alone
        params = dict(predictor.named_parameters())
        predictor.load_state_dict(merge_det_init(
            {k: v for k, v in det_state.items() if k in params},
            predictor.state_dict()))
    print(f"Predictor parameters: {param_count(predictor) / 1e6:.2f}M | "
          f"mode={mode} | device={device}")

    ckpt = CheckpointManager(p.ckpt_save_dir,
                             max_to_keep=p.ckpt_max_keep or p.epochs,
                             monitor="loss_val", mode="min")
    start_epoch = p.start_epoch
    if p.resume_ckpt:
        restore_state(state, p.resume_ckpt, "pred")
        start_epoch = state.step // max(1, dm.len_train_loader or 1)

    logger = MetricsLogger(p.tensorboard_save_dir)
    steps = make_steps(cfg, ae, mode, device)
    cfg.save(f"{p.ckpt_save_dir}/config.json")
    base_rng = Rng(cfg.Env.rand_seed)
    profiler = StepProfiler(cfg.Env.profile_dir)
    try:
        for epoch in range(start_epoch, p.epochs):
            train_loader.set_epoch(epoch)
            meters = AverageMeters()
            for batch in train_loader:
                profiler.maybe_start_profiler(state.step)
                metrics = steps.train(state, steps.place(batch),
                                      base_rng.fold(state.step))
                metrics["data_wait_ms"] = train_loader.last_wait_ms
                meters.update(metrics)
                if on_step is not None:
                    on_step("train", state.step, metrics)
                if max_steps is not None and state.step >= max_steps:
                    break
            val_meters = AverageMeters()
            val_rng = base_rng.fold(10 ** 9 + epoch)
            for vi, batch in enumerate(val_loader):
                metrics = steps.eval(state, steps.place(batch),
                                     val_rng.fold(vi))
                val_meters.update(metrics)
                if on_step is not None:
                    on_step("eval", vi, metrics)
            scalars = {**{k + "_train": v
                          for k, v in meters.averages().items()},
                       **val_meters.averages()}
            logger.log_scalars(state.step, scalars)
            print(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.5f}" for k, v in scalars.items()))
            stopped = max_steps is not None and state.step >= max_steps
            if (epoch % max(1, p.ckpt_per_epochs) == 0
                    or epoch == p.epochs - 1 or stopped):
                ckpt.save(state.step, state,
                          metrics={"loss_val": scalars.get("loss_val", 0.0)})
            if (cfg.Env.visual_callback
                    and epoch % max(1, p.log_per_epochs) == 0):
                try:
                    visual_callback(cfg, predictor, ae, steps.place(
                        next(iter(val_loader))), mode, dm.renorm, epoch)
                except Exception:  # a picture must never end a run
                    print("visual callback failed:")
                    traceback.print_exc(file=sys.stdout)
            if stopped:
                break
    finally:
        profiler.stop_profiler()
        logger.close()
        train_loader.close()
        val_loader.close()
    return state


def visual_callback(cfg: Config, predictor: NPPredictor,
                    ae: FrameAutoEncoder, batch, mode: str, renorm,
                    epoch: int) -> Path:
    """GT | prediction GIF of the first clip of ``batch`` (on the device),
    the predictor in eval mode with its latent drawn from ``Rng(epoch)``;
    → the GIF's path."""
    p = cfg.Predictor
    predictor.eval()
    with torch.no_grad():
        if mode == "rand_context":
            coords = full_coordinate_volume(p.max_T, p.max_H, p.max_W,
                                            batch["clip"].device)
            out = predictor(ae.encode(batch["clip"]), coords, coords,
                            obs_mask=batch["obs_mask"],
                            tgt_mask=batch["tgt_mask"], rng=Rng(epoch))
            gt = batch["clip"][0]
        else:
            oc, tc, _, _ = build_coords(cfg, device=batch["past"].device)
            out = predictor(ae.encode(batch["past"]), oc, tc,
                            rng=Rng(epoch))
            gt = torch.cat([batch["past"][0], batch["future"][0]])
        pred = ae.decode(out.pred_features)[0]
    path = Path(p.tensorboard_save_dir) / f"epoch_{epoch}.gif"
    save_clip_gifs(path, {"gt": gt.float().cpu().numpy(),
                          "pred": pred.float().cpu().numpy()}, renorm=renorm)
    return path


def write_random_ae(cfg: Config, directory) -> Path:
    """A stage-1 checkpoint file of random AE weights from
    ``Env.rand_seed``, for smoke runs without a trained AE."""
    path = Path(directory) / "random_ae.pt"
    ae = random_init(build_ae(cfg), cfg.Env.rand_seed)
    torch.save({"model": ae.state_dict()}, path)
    return path


def main(argv=None):
    args = build_argparser(
        "NPVP stage-2 predictor training (PyTorch port)").parse_args(argv)
    cfg = load_cli_config(args)
    with tempfile.TemporaryDirectory() as tmp:
        if args.smoke and not Path(cfg.Predictor.resume_AE_ckpt).exists():
            print(f"--smoke: no stage-1 checkpoint at "
                  f"{cfg.Predictor.resume_AE_ckpt!r}; the frozen AE has "
                  "random weights")
            cfg.Predictor.resume_AE_ckpt = str(write_random_ae(cfg, tmp))
        train(cfg, max_steps=10 if args.smoke else None)


if __name__ == "__main__":
    main(sys.argv[1:])
