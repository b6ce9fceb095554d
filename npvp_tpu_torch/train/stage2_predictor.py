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
from ``fold_in(base_rng, s)``. ``Env.steps_per_dispatch = K`` runs K steps
before their metrics are fetched (one all-reduce of the K steps' metrics
on a group), as JAX's scan over a chunk of K steps; the losses are those
of K = 1.

On a process group (``torchrun``; ``train.common.setup``) the predictor is
split over the mesh's model axis, then replicated over its data axis in DDP
or fully sharded (``Env.fsdp``; :func:`fsdp_units`); each rank loads its
rows of the global batch and draws their noise as the one-process run
does, the EventEncoders' BatchNorms take the global batch's statistics,
and the metrics are the global batch's means. The eval step calls the
model itself, not DDP's forward. Rank 0 alone logs, writes checkpoints
(the one-process files, gathered) and GIFs; every rank takes the same best
checkpoint.

Every ``Predictor.log_per_epochs`` epochs, under ``Env.visual_callback``,
one validation clip and its prediction (eval mode, so the kernel serves it
under ``exec_mode: pallas``) go into ``<tensorboard_save_dir>/epoch_<e>.gif``.

Each train step's metrics carry ``data_wait_ms``, the time the step waited
for its batch on the loader's prefetch queue (logged per epoch as
``data_wait_ms_train``). ``Env.profile_dir`` traces steps 10-14;
``Env.debug_nans`` checks each step's losses before its backward pass.
With ``Env.sequence_parallel`` on a mesh whose model axis is > 1, the
VidHRFormer stacks run on H shards over the model axis
(``core.sequence_parallel``).

:func:`make_gan_steps` is the adversarial step (a PatchGAN discriminator
on the predicted frames), which, as in the JAX package, no entry point
calls.
"""

from __future__ import annotations

import copy
import math
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from npvp_tpu_torch.core import distributed as D
from npvp_tpu_torch.core.checkpoint import CheckpointManager, load_model_state
from npvp_tpu_torch.core.config import Config
from npvp_tpu_torch.core.metrics import (AverageMeters, MetricsLogger,
                                         save_clip_gifs)
from npvp_tpu_torch.core.sequence_parallel import sp_axis
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
from npvp_tpu_torch.nn.neural_process import NRMLP, EventEncoder
from npvp_tpu_torch.nn.resnet_ae import FrameAutoEncoder, build_ae
from npvp_tpu_torch.nn.vidhrformer import VidHRFormerDecoderNAR
from npvp_tpu_torch.tools.weights import load_trained, random_init
from npvp_tpu_torch.train.common import (StepProfiler, build_argparser,
                                         check_finite, compute_dtype,
                                         data_split, load_cli_config,
                                         parallelize_state, restore_state,
                                         run_train_chunk, setup,
                                         train_chunks)


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


def fsdp_units(predictor: NPPredictor) -> list:
    """The modules that FSDP shards as units before the root: the NAR
    decoder (its layers' cross-attention projections are read together, by
    the hoist of its eval path), each EventEncoder and the NRMLP; the root
    holds the EVT-Former and the final norm. A unit's backward hooks change
    the order in which autograd sums the gradients of activations that
    several units read (the memory, the positional terms): as units, the
    decoder's or the EVT-Former's blocks parted the gradients from the
    one-process run by an ulp, which bf16 training grows; this layout
    keeps them equal at one rank."""
    return [m for m in predictor.modules()
            if isinstance(m, (VidHRFormerDecoderNAR, EventEncoder, NRMLP))]


class Steps(NamedTuple):
    train: Callable     # (state, batch, rng) -> metrics
    eval: Callable      # (state, batch, rng) -> metrics with "_val" keys
    place: Callable     # numpy batch -> tensors on the device
    # (model, batch, rng) -> (loss, metrics, predicted frames, real frames)
    forward: Callable


def make_steps(cfg: Config, ae: FrameAutoEncoder, mode: str,
               device, mesh=None) -> Steps:
    """The train and eval steps of ``mode``. With a ``mesh`` a step takes
    this rank's rows of the global batch (``core.distributed
    .shard_batch``) and the one-process run's ``rng``, and returns this
    rank's metrics (the trainer averages them over the data axis)."""
    p = cfg.Predictor
    data = D.axis(mesh, D.DATA_AXIS)

    def rows(rng: Rng, batch) -> Rng:
        if data is None:
            return rng
        n = next(v.shape[0] for k, v in batch.items()
                 if not k.endswith("_mask"))
        return rng.for_rows(data.rank, data.size, n)
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
        return loss, {"loss": loss, **metrics}, pred_frames, frames

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
        loss, metrics, *_ = forward(state.model, batch, rows(rng, batch))
        if cfg.Env.debug_nans:
            check_finite(metrics, state.step)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    def eval_step(state: TrainState, batch, rng: Rng):
        state.module.eval()
        with torch.no_grad():
            _, metrics, *_ = forward(state.module, batch, rows(rng, batch))
        return {k + "_val": v for k, v in metrics.items()}

    def place(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    return Steps(train_step, eval_step, place,
                 lambda model, batch, rng: forward(model, batch,
                                                   rows(rng, batch)))


def make_gan_steps(cfg: Config, ae: FrameAutoEncoder, mode: str,
                   device):
    """The adversarial stage-2 step (JAX's ``make_gan_steps``, the
    reference's deprecated ``training_step_gan``): a PatchGAN on the
    frames, time folded into the batch, its depth ``min(3, log2(img) −
    3)``. → (train_step, eval_step, place, init_discriminator):

    - ``init_discriminator(seed)``: the discriminator's state, random
      weights from ``seed``, AdamW with the predictor's rate and schedule
      and no clip; it runs in float32 whatever the compute dtype;
    - ``train_step(state_g, state_d, batch, rng)`` → metrics: the
      predictor's training-mode forward; the discriminator's update on the
      detached predictions, then the real frames (its BatchNorms' running
      statistics moved by the fake batch, then the real one); the
      predictor's update on its losses plus ``lam_gan``·the adversarial
      loss of the updated discriminator in eval mode. JAX runs the
      predictor's forward twice with one key and keeps the second's
      statistics; one forward gives the same frames and statistics;
    - ``eval_step``: the plain one, where the attention kernel serves."""
    from npvp_tpu_torch.nn.discriminator import PatchDiscriminator, gan_loss

    p = cfg.Predictor
    base = make_steps(cfg, ae, mode, device)
    n_layers = min(3, max(1, int(math.log2(cfg.Dataset.img_size)) - 3))
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731

    def init_discriminator(seed: int) -> TrainState:
        disc = random_init(PatchDiscriminator(
            cfg.Dataset.img_channels, p.ndf, n_layers), seed).to(device)
        return TrainState(
            disc, make_predictor_optimizer(disc.parameters(),
                                           p.predictor_lr),
            predictor_schedule(p.predictor_lr, p.use_cosine_scheduler,
                               p.scheduler_eta_min, p.scheduler_T0))

    def train_step(state_g: TrainState, state_d: TrainState, batch,
                   rng: Rng):
        state_g.model.train()
        loss, metrics, frames, real = base.forward(state_g.model, batch, rng)
        disc = state_d.model.train()
        loss_d_fake = gan_loss(disc(flat(frames.detach())), False,
                               lam=p.lam_gan)
        loss_d_real = gan_loss(disc(flat(real)), True, lam=p.lam_gan)
        loss_d = loss_d_fake + loss_d_real
        loss_d.backward()
        state_d.apply_gradients()
        disc.eval().requires_grad_(False)
        try:
            adv = gan_loss(disc(flat(frames)), True, lam=p.lam_gan)
        finally:
            disc.requires_grad_(True)
        loss = loss + adv
        loss.backward()
        state_g.apply_gradients()
        metrics = dict(metrics, loss=loss, loss_G_gan=adv, loss_D=loss_d,
                       loss_D_fake=loss_d_fake, loss_D_real=loss_d_real)
        return {k: v.detach() for k, v in metrics.items()}

    return train_step, base.eval, base.place, init_discriminator


def train(cfg: Config, max_steps: Optional[int] = None, sprites=None,
          on_step: Optional[Callable] = None) -> TrainState:
    """Train for ``Predictor.epochs`` epochs (or ``max_steps`` steps),
    validating and checkpointing after each epoch. ``sprites`` optionally
    maps "train"/"test" to SMMNIST sprite banks; ``on_step(kind, index,
    metrics)`` is called after every "train" and "eval" step, for timing
    (with ``Env.steps_per_dispatch`` K > 1, for the K train steps of a
    chunk once they have all run)."""
    device, mesh = setup(cfg)
    main_rank = D.is_main_process()
    dtype = compute_dtype(cfg)
    p = cfg.Predictor
    ae = load_frozen_ae(cfg, dtype, device)
    predictor = build_predictor(cfg, dtype).to(device)
    dm = DataModule(cfg, sprites, *data_split(mesh))
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
    if main_rank:
        sp = sp_axis(torch.zeros(1, 1, p.max_H)) is not None
        print(f"Predictor parameters: {param_count(predictor) / 1e6:.2f}M "
              f"| mode={mode} | device={device} | mesh={mesh} | "
              f"sequence_parallel={sp}")

    ckpt = CheckpointManager(p.ckpt_save_dir,
                             max_to_keep=p.ckpt_max_keep or p.epochs,
                             monitor="loss_val", mode="min",
                             writer=main_rank)
    start_epoch = p.start_epoch
    if p.resume_ckpt:
        restore_state(state, p.resume_ckpt, "pred")
        start_epoch = state.step // max(1, dm.len_train_loader or 1)
    state = parallelize_state(state, mesh, cfg.Env.fsdp, fsdp_units)

    logger = MetricsLogger(p.tensorboard_save_dir) if main_rank else None
    steps = make_steps(cfg, ae, mode, device, mesh)
    if main_rank:
        cfg.save(f"{p.ckpt_save_dir}/config.json")
    base_rng = Rng(cfg.Env.rand_seed)
    profiler = StepProfiler(cfg.Env.profile_dir if main_rank else None)
    K = max(1, cfg.Env.steps_per_dispatch)
    try:
        for epoch in range(start_epoch, p.epochs):
            train_loader.set_epoch(epoch)
            meters = AverageMeters()
            for chunk in train_chunks(train_loader, K, state, max_steps,
                                      profiler):
                run_train_chunk(
                    state, lambda b: steps.train(state, steps.place(b),
                                                 base_rng.fold(state.step)),
                    chunk, mesh, meters, on_step, train_loader)
            val_meters = AverageMeters()
            val_rng = base_rng.fold(10 ** 9 + epoch)
            for vi, batch in enumerate(val_loader):
                metrics = D.all_mean(steps.eval(state, steps.place(batch),
                                                val_rng.fold(vi)), mesh)
                val_meters.update(metrics)
                if on_step is not None:
                    on_step("eval", vi, metrics)
            scalars = {**{k + "_train": v
                          for k, v in meters.averages().items()},
                       **val_meters.averages()}
            if main_rank:
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
                    # every rank runs the forward (its collectives); rank 0
                    # writes the picture
                    visual_callback(cfg, state.module, ae, steps.place(
                        next(iter(val_loader))), mode, dm.renorm, epoch,
                        mesh)
                except Exception:  # a picture must never end a run
                    print("visual callback failed:")
                    traceback.print_exc(file=sys.stdout)
            if stopped:
                break
    finally:
        profiler.stop_profiler()
        if logger is not None:
            logger.close()
        train_loader.close()
        val_loader.close()
    return state


def visual_callback(cfg: Config, predictor: NPPredictor,
                    ae: FrameAutoEncoder, batch, mode: str, renorm,
                    epoch: int, mesh=None) -> Optional[Path]:
    """GT | prediction GIF of the first clip of ``batch`` (on the device),
    the predictor in eval mode with its latent drawn from ``Rng(epoch)``;
    → the GIF's path. On a mesh every rank runs the forward on its rows
    (the first of rank 0's is the global batch's first) and rank 0 writes
    the GIF; the others return None."""
    p = cfg.Predictor
    data = D.axis(mesh, D.DATA_AXIS)
    rng = Rng(epoch)
    if data is not None:
        n = batch["clip" if mode == "rand_context" else "past"].shape[0]
        rng = rng.for_rows(data.rank, data.size, n)
    predictor.eval()
    with torch.no_grad():
        if mode == "rand_context":
            coords = full_coordinate_volume(p.max_T, p.max_H, p.max_W,
                                            batch["clip"].device)
            out = predictor(ae.encode(batch["clip"]), coords, coords,
                            obs_mask=batch["obs_mask"],
                            tgt_mask=batch["tgt_mask"], rng=rng)
            gt = batch["clip"][0]
        else:
            oc, tc, _, _ = build_coords(cfg, device=batch["past"].device)
            out = predictor(ae.encode(batch["past"]), oc, tc, rng=rng)
            gt = torch.cat([batch["past"][0], batch["future"][0]])
        pred = ae.decode(out.pred_features)[0]
    if not D.is_main_process():
        return None
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
