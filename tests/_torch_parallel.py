"""Ranks of the port's parallel tests (imports no JAX: every rank is a
spawned process that imports this module).

:func:`spawn` starts ``world`` processes on the CPU, each joined to a gloo
group through a file in the test's directory (no TCP port, so that test
files run side by side), and runs one scenario function in each; rank 0
writes what the test compares with ``torch.save``. The scenarios are also
called in the test's own process without a mesh: the one-process run that
every parallel run must equal at the same global batch.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from npvp_tpu_torch.core import distributed as D
from npvp_tpu_torch.core.checkpoint import CheckpointManager
from npvp_tpu_torch.models.coords import full_coordinate_volume
from npvp_tpu_torch.models.inference import VideoPredictor
from npvp_tpu_torch.models.predictor import build_predictor
from npvp_tpu_torch.nn import layers as tl
from npvp_tpu_torch.nn.resnet_ae import build_ae
from npvp_tpu_torch.train import stage2_predictor as s2
from npvp_tpu_torch.train.common import parallelize_state
from npvp_tpu_torch.tools.weights import random_init


def _entry(rank, world, init_file, out_dir, scenarios):
    torch.set_num_threads(1)
    D.maybe_init_distributed("cpu", init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    try:
        for i, (fn, kwargs) in enumerate(scenarios):
            result = fn(**kwargs)
            if rank == 0:
                torch.save(result, Path(out_dir) / f"{i}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spawn(tmp_path, world: int, scenarios) -> list:
    """Run ``scenarios`` — (function, keyword arguments) pairs, each
    function called with ``mesh_shape`` among them — one after another in
    ``world`` gloo ranks; → rank 0's results."""
    tmp_path = Path(tmp_path)
    init = tmp_path / f"pg_{world}"
    torch.multiprocessing.start_processes(
        _entry, args=(world, str(init), str(tmp_path), scenarios),
        nprocs=world, join=True, start_method="spawn")
    return [torch.load(tmp_path / f"{i}.pt", weights_only=False)
            for i in range(len(scenarios))]


def _mesh(mesh_shape):
    return None if mesh_shape is None else D.make_mesh(
        *mesh_shape, device_type="cpu")


def _models(cfg, ae_sd, pred_sd):
    ae = build_ae(cfg)
    ae.load_state_dict(ae_sd)
    predictor = build_predictor(cfg)
    predictor.load_state_dict(pred_sd)
    return ae.eval().requires_grad_(False), predictor


def train_scenario(cfg, ae_sd, pred_sd, batches, mesh_shape=None,
                   fsdp=False, zero_latent=False, ckpt_dir=None):
    """Stage-2 train steps over the global ``batches`` (one each), then an
    eval step and an eval forward on the first: → the data axis's mean
    metrics of every step, the clip's norm at every update, the gradients
    of the first update (after the clip, in the one-process layout), the
    eval metrics and predicted features, and the state in the one-process
    layout. ``zero_latent`` draws NPVP-S's latent noise as zeros (the JAX
    package's noise cannot be drawn in torch); ``ckpt_dir`` saves a
    checkpoint after the steps."""
    mesh = _mesh(mesh_shape)
    normal = tl.Rng.normal
    if zero_latent:
        tl.Rng.normal = lambda self, shape, device, split=None: torch.zeros(
            shape, device=device)
    try:
        ae, predictor = _models(cfg, ae_sd, pred_sd)
        state = s2.init_predictor_state(cfg, predictor, 3)
        predictor.load_state_dict(pred_sd)  # init drew random weights
        state = parallelize_state(state, mesh, fsdp, s2.fsdp_units)
        grads = {}

        def capture(optimizer, args, kwargs):
            if not grads:
                for name, p in state.module.named_parameters():
                    full = (state.shards.full(name, p.grad)
                            if state.shards else p.grad)
                    grads[name] = full.detach().clone()

        state.optimizer.register_step_pre_hook(capture)
        steps = s2.make_steps(cfg, ae, "rand_context", "cpu", mesh)
        metrics, norms = [], []
        for i, batch in enumerate(batches):
            local = steps.place(D.shard_batch(mesh, batch))
            m = D.all_mean(steps.train(state, local, tl.Rng(i)), mesh)
            metrics.append({k: float(v) for k, v in m.items()})
            norms.append(float(state.grad_norm))
        local = steps.place(D.shard_batch(mesh, batches[0]))
        evals = D.all_mean(steps.eval(state, local, tl.Rng(99)), mesh)
        features = _eval_features(cfg, state, ae, local, mesh)
        full = state.state_dict()
        if ckpt_dir is not None:
            CheckpointManager(ckpt_dir, writer=D.is_main_process()).save(
                state.step, state, metrics={"loss_val": evals["loss_val"]})
    finally:
        tl.Rng.normal = normal
    return dict(metrics=metrics, norms=norms, grads=grads,
                evals={k: float(v) for k, v in evals.items()},
                features=features, model=full["model"],
                optimizer=full["optimizer"])


def _eval_features(cfg, state, ae, batch, mesh):
    """The predictor's eval-mode output on a rand-context batch (this
    rank's rows), gathered into the global batch's."""
    p = cfg.Predictor
    coords = full_coordinate_volume(p.max_T, p.max_H, p.max_W, "cpu")
    module = state.module.eval()
    data = D.axis(mesh, D.DATA_AXIS)
    rng = tl.Rng(7)
    if data is not None:
        rng = rng.for_rows(data.rank, data.size, batch["clip"].shape[0])
    with torch.no_grad():
        out = module(ae.encode(batch["clip"]), coords, coords,
                     obs_mask=batch["obs_mask"], tgt_mask=batch["tgt_mask"],
                     rng=rng)
    return D.gather_rows(mesh, out.pred_features)


def serve_scenario(cfg, ae_sd, pred_sd, frames, stream, odd,
                   mesh_shape=None):
    """``VideoPredictor`` (fp32, the CPU) sharded on the mesh: ``predict``,
    a ``freeze_task`` call, ``predict_stream`` and a batch that the data
    axis does not divide (with the warnings it raised)."""
    ae, predictor = _models(cfg, ae_sd, pred_sd)
    vp = VideoPredictor(cfg, ae, predictor, device="cpu")
    mesh = _mesh(mesh_shape)
    if mesh is not None:
        vp.shard(mesh)
    to, tp = [0, 1, 2, 3], [4, 5, 6]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = dict(predict=vp.predict(frames, to, tp),
                   frozen=vp.freeze_task(to, tp)(frames),
                   stream=vp.predict_stream(stream, to, tp),
                   odd=vp.predict(odd, to, tp))
    out["warnings"] = [str(w.message) for w in caught]
    return out


def stage1_scenario(cfg, ae_sd, batches, mesh_shape=None, fsdp=False):
    """Stage-1 train steps of the AE over the global ``batches`` (dicts of
    past and future clips): → the data axis's mean L1 of every step, the
    gradients of the first update in the one-process layout, and the
    BatchNorms' running statistics after the first step."""
    from npvp_tpu_torch.train import stage1_ae as s1

    mesh = _mesh(mesh_shape)
    ae = build_ae(cfg)
    state = s1.init_state(cfg, ae)
    ae.load_state_dict(ae_sd)
    state = parallelize_state(state, mesh, fsdp,
                              lambda m: [m.encoder, m.decoder],
                              tensor_parallel=False)
    grads = {}

    def capture(optimizer, args, kwargs):
        if not grads:
            for name, p in state.module.named_parameters():
                grads[name] = state.shards.full(name, p.grad).detach() \
                    .clone() if state.shards else p.grad.detach().clone()

    state.optimizer.register_step_pre_hook(capture)
    steps = s1.make_steps("cpu")
    losses, stats = [], None
    for b in batches:
        losses.append(float(D.all_mean(steps.train(state, steps.place(
            D.shard_batch(mesh, b))), mesh)["L1_loss_train"]))
        if stats is None:  # the statistics of the first step's batch
            stats = {k: v.clone() for k, v in state.module.state_dict()
                     .items() if k.endswith(("running_mean", "running_var"))}
    return dict(losses=losses, grads=grads, stats=stats)


# -- what the tests compare ----------------------------------------------

# parameters of two runs of the port after 2 AdamW steps at lr 1e-3: Adam
# divides each gradient by its own root mean square, so an element whose
# gradient is near zero moves by up to lr, and sums taken over ranks in
# another order move it by a part of lr; 2 % of lr, where a wrong gradient
# (a rank-local statistic, another noise draw) moves many elements by ~lr
PARAM_ATOL = 0.02 * 1e-3

T = 8  # tiny_config's max_T
OBS = [np.array([1, 0, 1, 1, 0, 0, 1, 0], bool),
       np.array([0, 1, 1, 0, 0, 1, 0, 0], bool)]


def batches(seed=7):
    rng = np.random.default_rng(seed)
    return [{"clip": rng.uniform(0, 1, (4, T, 32, 32, 1)).astype(np.float32),
             "obs_mask": obs, "tgt_mask": ~obs} for obs in OBS]


def port_weights(cfg, seed):
    ae = random_init(build_ae(cfg), seed)
    return ae.state_dict(), random_init(build_predictor(cfg),
                                        seed + 1).state_dict()


def close(got, want, atol, rtol=0.0, what=""):
    for key in want:
        np.testing.assert_allclose(
            np.asarray(got[key], np.float64), np.asarray(want[key],
                                                         np.float64),
            atol=atol, rtol=rtol, err_msg=f"{what} {key}")


def assert_states(got, want, atol=1e-5):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        stat = key.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(
            got[key].numpy(), w.numpy(), atol=1e-6 if stat else atol,
            rtol=1e-5 if stat else 0.0, err_msg=key)


def assert_runs_equal(got, want):
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        assert sorted(g) == sorted(w)
        close(g, w, atol=1e-7, rtol=1e-5, what="loss")
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    close({k: v.numpy() for k, v in got["grads"].items()},
           {k: v.numpy() for k, v in want["grads"].items()}, atol=1e-5,
           what="grad")
    close(got["evals"], want["evals"], atol=1e-7, rtol=1e-5, what="eval")
    np.testing.assert_allclose(got["features"].numpy(),
                               want["features"].numpy(), atol=1e-5)
    assert_states(got["model"], want["model"], atol=PARAM_ATOL)


def assert_serving(got, want):
    for key in ("predict", "frozen", "stream", "odd"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-5, err_msg=key)
