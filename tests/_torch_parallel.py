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

import contextlib
import warnings
from pathlib import Path

import numpy as np
import torch

from npvp_tpu_torch.core import distributed as D
from npvp_tpu_torch.core.checkpoint import CheckpointManager
from npvp_tpu_torch.core.sequence_parallel import (halo_rows,
                                                   sequence_parallel,
                                                   sp_param)
from npvp_tpu_torch.core.tensor_parallel import shard_tensor_parallel
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
                   fsdp=False, zero_latent=False, ckpt_dir=None, sp=False):
    """Stage-2 train steps over the global ``batches`` (one each), then an
    eval step and an eval forward on the first: → the data axis's mean
    metrics of every step, the clip's norm at every update, the gradients
    of the first update (after the clip, in the one-process layout), the
    eval metrics and predicted features, and the state in the one-process
    layout. ``zero_latent`` draws NPVP-S's latent noise as zeros (the JAX
    package's noise cannot be drawn in torch); ``ckpt_dir`` saves a
    checkpoint after the steps; ``sp`` runs it all under sequence
    parallelism on the mesh."""
    mesh = _mesh(mesh_shape)
    with sequence_parallel(mesh if sp else None):
        return _train(cfg, ae_sd, pred_sd, batches, mesh, fsdp, zero_latent,
                      ckpt_dir)


def _train(cfg, ae_sd, pred_sd, batches, mesh, fsdp, zero_latent,
           ckpt_dir):
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


@contextlib.contextmanager
def count_splits():
    """Inside the context the stacks count themselves when they run on H
    shards; → the counter, a one-entry list."""
    from npvp_tpu_torch.nn import vidhrformer as vf

    seen, sp_axis = [0], vf.sp_axis

    def counted(x):
        sp = sp_axis(x)
        seen[0] += sp is not None
        return sp

    vf.sp_axis = counted
    try:
        yield seen
    finally:
        vf.sp_axis = sp_axis


def sp_forward_scenario(model_kw, state, inputs, mesh_shape=None,
                        train=False):
    """A port ``NPPredictor(**model_kw)`` with the ``state`` weights, split
    over the mesh's model axis, run under sequence parallelism on its rows
    of the global ``inputs`` (``obs``, ``oc``, ``tc``, NPVP-S's ``eps``):
    in eval mode, or in training mode (its generic path) with the
    gradients of Σ features² gathered into the one-process layout. → the
    global features, the gradients, and how many stacks ran on H
    shards."""
    from npvp_tpu_torch.models.predictor import NPPredictor

    mesh = _mesh(mesh_shape)
    model = NPPredictor(**model_kw)
    model.load_state_dict(state)
    model.train(train)
    shards = shard_tensor_parallel(model, mesh)
    # the EventEncoders' training-mode statistics: the global batch's
    tl.sync_batchnorm(model, D.axis(mesh, D.DATA_AXIS))
    rows = lambda t: D.shard_batch(mesh, t)  # noqa: E731
    eps = inputs.get("eps")
    with sequence_parallel(mesh), torch.set_grad_enabled(train), \
            count_splits() as seen:
        out = model(rows(inputs["obs"]), inputs["oc"], inputs["tc"],
                    None if eps is None else rows(eps))
        feats = D.gather_rows(mesh, out.pred_features.detach())
        grads, data = {}, D.axis(mesh, D.DATA_AXIS)
        if train:
            (out.pred_features ** 2).sum().backward()
            for name, p in model.named_parameters():
                g = shards.full(name, p.grad).clone()
                if data is not None:  # the rows' sum over the data axis
                    torch.distributed.all_reduce(g, group=data.group)
                grads[name] = g
    return dict(features=feats.detach(), grads=grads, splits=seen[0])


def sp_pieces_scenario(x, g, norm_state, mesh_shape=None):
    """MlpDWBN's two cross-shard pieces on this rank's rows of the whole
    (B, H, W, C) ``x`` (one model axis, no data axis): the halo-padded
    depthwise 3×3 conv and the (H, W, C) LayerNorm, forward and the
    gradients of Σ out·g (``g``'s rows) against ``x``, the conv's and the
    norm's parameters. Without a mesh, the whole-tensor ops. → outputs and
    gradients, whole (rows gathered, parameter gradients as summed)."""
    import torch.nn.functional as F

    mesh = _mesh(mesh_shape)
    sp = D.axis(mesh, D.MODEL_AXIS)
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(x.shape[-1], x.shape[-1], 3, padding=1,
                           groups=x.shape[-1])
    norm = tl.LayerNormHWC(x.shape[1:])
    norm.load_state_dict(norm_state)
    h = x.shape[1] // (sp.size if sp else 1)
    r = sp.rank if sp else 0
    xs = x[:, r * h:(r + 1) * h].clone().requires_grad_(True)
    gs = g[:, r * h:(r + 1) * h]
    if sp is None:
        y = F.conv2d(xs.permute(0, 3, 1, 2), conv.weight, conv.bias,
                     padding=1, groups=conv.groups).permute(0, 2, 3, 1)
    else:
        y = F.conv2d(halo_rows(xs, sp).permute(0, 3, 1, 2),
                     sp_param(conv.weight, sp), sp_param(conv.bias, sp),
                     padding=(0, 1), groups=conv.groups).permute(0, 2, 3, 1)
    z = norm(y, sp)
    (z * gs).sum().backward()
    out = {"conv": y, "norm": z, "x_grad": xs.grad}
    if sp is not None:
        out = {k: _gather_h_rows(v, sp) for k, v in out.items()}
        out.update(_reduce_scatter_both_ways(x, g, sp))
    params = {"conv.weight": conv.weight.grad, "conv.bias": conv.bias.grad,
              "norm.weight": norm.weight.grad, "norm.bias": norm.bias.grad}
    return {**{k: v.detach() for k, v in out.items()}, **params}


def _reduce_scatter_both_ways(x, g, sp):
    """``reduce_scatter_h`` of the partials (rank + 1)·x on H (gloo's form:
    an all-reduce and a slice) with this rank's gradient of Σ out·g (the
    whole g), and the same sum in NCCL's form (a tensor reduce-scatter,
    run here on gloo): → the gathered outputs and the gradient."""
    from npvp_tpu_torch.core import sequence_parallel as spm

    part = (x[:, None] * (sp.rank + 1)).requires_grad_(True)
    y = spm.reduce_scatter_h(part, sp)
    n = y.shape[2]
    (y * g[:, None].narrow(2, sp.rank * n, n)).sum().backward()
    tensor = spm._reduce_scatter_rows(part.detach(), sp)
    return {"rs_gloo": _gather_h_rows(y, sp, 2),
            "rs_tensor": _gather_h_rows(tensor, sp, 2),
            "rs_grad": part.grad}


def _gather_h_rows(v, sp, dim=1):
    parts = [torch.empty_like(v) for _ in range(sp.size)]
    torch.distributed.all_gather(parts, v.detach().contiguous(),
                                 group=sp.group)
    return torch.cat(parts, dim)


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


# -- GPipe ------------------------------------------------------------------

def mlp(params, h):
    """JAX's test block: tanh(h·w + b)."""
    return torch.tanh(h @ params["w"] + params["b"])


def pipeline_mlp_scenario(layers, x, stages, data=1):
    """``pipeline_apply`` of the MLP stack ``layers`` (dicts of w, b) over
    the (M, B, D) microbatches ``x`` on a ``data`` × ``stages`` mesh (PP×DP
    with ``data`` > 1)."""
    from npvp_tpu_torch.core.pipeline import (make_pipeline_mesh,
                                              pipeline_apply,
                                              stack_layer_params)

    mesh = make_pipeline_mesh(stages, data, "cpu")
    return pipeline_apply(mlp, stack_layer_params(layers), x, mesh=mesh,
                          data_axis="data" if data > 1 else None)


def pipeline_blocks_scenario(block_args, states, inputs, stages):
    """The decoder blocks (``VidHRFormerBlockDecNAR(*block_args)`` with the
    ``states``) in eval mode through a ``stages``-stage pipeline: the whole
    target as one microbatch, and 2 microbatches of the batch with the
    event query and memory carried in each microbatch. → both outputs."""
    from torch.func import functional_call

    from npvp_tpu_torch.core.pipeline import (make_pipeline_mesh,
                                              pipeline_apply,
                                              stack_layer_params)
    from npvp_tpu_torch.nn.vidhrformer import VidHRFormerBlockDecNAR

    block = VidHRFormerBlockDecNAR(*block_args).eval()
    q, m, mem_pos, tgt_pos, tgt0 = (inputs[k] for k in (
        "query_evt", "memory", "mem_pos", "tgt_pos", "tgt0"))
    mesh = make_pipeline_mesh(stages, 1, "cpu")
    stacked = stack_layer_params(states)

    def whole(params, tgt):
        return functional_call(block, params, (tgt, q, m, mem_pos, tgt_pos))

    def per_mb(params, pack):
        tgt, qq, mm = pack
        return (functional_call(block, params,
                                (tgt, qq, mm, mem_pos, tgt_pos)), qq, mm)

    N = tgt0.shape[0]
    pack = (tgt0.reshape((N, 1) + tgt0.shape[1:]),
            q.reshape((N, 1) + q.shape[1:]), m.reshape((N, 1) + m.shape[1:]))
    return dict(whole=pipeline_apply(whole, stacked, tgt0[None],
                                     mesh=mesh)[0],
                microbatched=pipeline_apply(per_mb, stacked, pack,
                                            mesh=mesh)[0][:, 0])
