"""Stage-2 training in the port against the JAX package, fp32 on the CPU at
the tiny test size, dropout and DropPath at 0 where the two are compared:

- one and two ``make_steps`` train steps of NPVP-D in ``pairs`` and
  ``rand_context`` modes from the same flax variables and batches: losses
  (rtol 1e-5), the updated parameters (atol 1e-5) and batch statistics
  (atol 1e-6), compared through the flax → torch bridge;
- NPVP-S in masked training mode: outputs, prior and posterior μ/log σ²,
  the KL, the gradients and the EventEncoders' updated statistics;
- masked mode ≡ static mode, and no target frame leaks into a prediction;
- the schedules, the decoder-only clip and AdamW against optax;
- BatchNorm in training mode against flax; dropout, DropPath and their
  masks under ``remat``; the kernel's gate; checkpoints; the trainer and its
  CLI on the CPU.
"""

import functools
import json

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import port_config, random_variables, tiny_config  # noqa: E402

from npvp_tpu_torch.core import optim as topt  # noqa: E402
from npvp_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from npvp_tpu_torch.kernels import temporal_attention as tta  # noqa: E402
from npvp_tpu_torch.models.coords import full_coordinate_volume  # noqa: E402
from npvp_tpu_torch.models.predictor import build_predictor  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.nn import vidhrformer as tv  # noqa: E402
from npvp_tpu_torch.nn.losses import kl_divergence  # noqa: E402
from npvp_tpu_torch.nn.resnet_ae import build_ae  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax, random_init  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402

T = 8          # tiny_config's max_T
OBS = [np.array([1, 0, 1, 1, 0, 0, 1, 0], bool),
       np.array([0, 1, 1, 0, 0, 1, 0, 0], bool)]


def _cfg(mode="rand_context", stochastic=False, layers=2):
    """tiny_config for training: batch 2, fp32, no dropout, a rate large
    enough and a clip tight enough that both show in two steps; ``layers``
    EVT-Former and decoder layers."""
    cfg = tiny_config(stochastic)
    d, p = cfg.Dataset, cfg.Predictor
    p.transformer_layers = p.evt_former_num_layers = layers
    d.batch_size, cfg.Env.compute_dtype = 2, "float32"
    p.dropout = p.drop_path = 0.0
    p.exec_mode = "xla"
    p.rand_context = mode == "rand_context"
    p.min_lo, p.max_lo = 2, 6
    p.predictor_lr, p.max_grad_norm, p.scheduler_T0 = 1e-3, 0.05, 1
    return cfg.validate()


def _batches(mode):
    rng = np.random.default_rng(7)
    out = []
    for obs in OBS:
        clip = rng.uniform(0, 1, (2, T, 32, 32, 1)).astype(np.float32)
        out.append({"past": clip[:, :4], "future": clip[:, 4:]}
                   if mode == "pairs" else
                   {"clip": clip, "obs_mask": obs, "tgt_mask": ~obs})
    return out


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(cfg, seed):
    from npvp_tpu.models.predictor import build_predictor as jbuild
    from npvp_tpu.train.stage1_ae import build_ae as jbuild_ae

    d, p = cfg.Dataset, cfg.Predictor
    ae = jbuild_ae(cfg, jnp.float32)
    ae_vars = random_variables(ae.init, jax.random.key(0), np.zeros(
        (1, 2, d.img_size, d.img_size, d.img_channels)), seed=seed)
    pred = jbuild(cfg, jnp.float32)
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc0 = np.zeros((2 * p.max_H * p.max_W, 3))
    rngs = {k: jax.random.key(i) for i, k in enumerate(
        ("params", "latent", "dropout", "droppath"))}
    init = functools.partial(pred.init, num_target=2,
                             target_feats_gt=feats0, train=True)
    pred_vars = random_variables(init, rngs, feats0, oc0, oc0, seed=seed + 1)
    return ae, ae_vars, pred, pred_vars


def _jax_steps(cfg, mode, ae, ae_vars, pred, pred_vars, batches=None):
    """The JAX trainer's steps over ``batches`` (default: this file's two);
    → (metrics per step, final variables)."""
    from npvp_tpu.core.mesh import make_mesh
    from npvp_tpu.core.optim import make_predictor_optimizer
    from npvp_tpu.core.train_state import TrainState
    from npvp_tpu.train.stage2_predictor import make_steps

    p = cfg.Predictor
    tx = make_predictor_optimizer(p.predictor_lr, p.max_grad_norm,
                                  p.use_cosine_scheduler,
                                  p.scheduler_eta_min, p.scheduler_T0 * 3)
    params = jax.tree.map(jnp.asarray, pred_vars["params"])
    state = TrainState.create(apply_fn=pred.apply, params=params,
                              batch_stats=pred_vars["batch_stats"], tx=tx)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    train_step, _, place, *_ = make_steps(cfg, pred, ae, ae_vars, mesh, mode)
    metrics = []
    for i, batch in enumerate(batches or _batches(mode)):
        state, m = train_step(state, place(batch), jax.random.key(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {"params": _np_tree(state.params),
                     "batch_stats": _np_tree(state.batch_stats)}


def _port_model(cfg, ae_vars, pred_vars, **kw):
    tcfg = port_config(cfg)
    ae = load_flax(build_ae(tcfg), ae_vars).eval().requires_grad_(False)
    return tcfg, ae, load_flax(build_predictor(tcfg, **kw), pred_vars)


@pytest.fixture(scope="module", params=["pairs", "rand_context"])
def two_steps(request):
    """Both trainers' two steps of NPVP-D from one set of variables (one
    layer each side: the JAX compile of a step is the cost)."""
    mode = request.param
    cfg = _cfg(mode, layers=1)
    ae, ae_vars, pred, pred_vars = _jax_model(cfg, seed=20)
    want, want_vars = _jax_steps(cfg, mode, ae, ae_vars, pred, pred_vars)
    tcfg, tae, tpred = _port_model(cfg, ae_vars, pred_vars)
    state = s2.init_predictor_state(tcfg, tpred, 3)
    load_flax(tpred, pred_vars)  # init drew random weights over them
    steps = s2.make_steps(tcfg, tae, mode, "cpu")
    got = [{k: float(v) for k, v in steps.train(
        state, steps.place(b), tl.Rng(i)).items()}
        for i, b in enumerate(_batches(mode))]
    return dict(want=want, got=got, want_vars=want_vars, state=state,
                tcfg=tcfg)


def test_train_step_losses_match_jax(two_steps):
    assert two_steps["state"].step == 2
    for want, got in zip(two_steps["want"], two_steps["got"]):
        assert sorted(got) == sorted(want) == ["Image_L1", "PF_L1", "loss"]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)


def test_train_step_updates_match_jax(two_steps):
    """Parameters after two AdamW steps (the second one clipped) atol 1e-5,
    the EventEncoder's running statistics atol 1e-6."""
    ref = load_flax(build_predictor(two_steps["tcfg"]),
                    two_steps["want_vars"]).state_dict()
    got = two_steps["state"].model.state_dict()
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        stat = key.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 if stat else 1e-5, err_msg=key)
    assert any(k.startswith("evt_posterior") and k.endswith("running_var")
               for k in ref)


def _masked_inputs(p):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, T, p.max_H, p.max_W, p.embed_dim)
                                ).astype(np.float32)
    weight = rng.standard_normal(feats.shape).astype(np.float32)
    return feats, weight


@pytest.fixture(scope="module")
def stochastic_masked():
    """NPVP-S in masked training mode: JAX (``sample_latent=False``) and the
    port (``eps = 0``) on one set of variables, loss Σ w·out + KL."""
    from npvp_tpu.models.coords import full_coordinate_volume as jvol
    from npvp_tpu.nn.losses import kl_divergence as jkl

    cfg = _cfg(stochastic=True, layers=1)
    p = cfg.Predictor
    _, _, pred, pred_vars = _jax_model(cfg, seed=30)
    feats, weight = _masked_inputs(p)
    om, tm = OBS[0], ~OBS[0]
    coords = jvol(T, p.max_H, p.max_W).reshape(-1, 3)

    def loss_fn(params):
        out, mut = pred.apply(
            {"params": params, "batch_stats": pred_vars["batch_stats"]},
            feats, coords, coords, T, target_feats_gt=feats, obs_mask=om,
            tgt_mask=tm, train=True, sample_latent=False,
            rngs={k: jax.random.key(0) for k in ("latent", "dropout",
                                                  "droppath")},
            mutable=["batch_stats"])
        kl = jkl(out.mu_o, out.logvar_o, out.mu_p, out.logvar_p, 1.0)
        return jnp.sum(out.pred_features * weight) + kl, (out, kl, mut)

    (_, (out, kl, mut)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(pred_vars["params"])

    tcfg = port_config(cfg)
    port = load_flax(build_predictor(tcfg), pred_vars).train()
    t = torch.from_numpy
    tcoords = full_coordinate_volume(T, p.max_H, p.max_W)
    zeros = torch.zeros((2, p.max_H, p.max_W, p.embed_dim))
    got = port(t(feats), tcoords, tcoords, zeros, target_feats_gt=t(feats),
               obs_mask=t(om), tgt_mask=t(tm), eps_post=zeros)
    got_kl = kl_divergence(got.mu_o, got.logvar_o, got.mu_p, got.logvar_p,
                           1.0)
    ((got.pred_features * t(weight)).sum() + got_kl).backward()
    return dict(out=out, kl=kl, mut=mut, grads=grads, got=got, got_kl=got_kl,
                port=port, tcfg=tcfg, pred_vars=pred_vars)


def _close(got, want, atol=1e-4, rtol=1e-4, **kw):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               **kw)


def test_stochastic_masked_forward_and_kl_match_jax(stochastic_masked):
    r = stochastic_masked
    for name in ("pred_features", "mu_o", "logvar_o", "mu_p", "logvar_p"):
        _close(getattr(r["got"], name), getattr(r["out"], name),
               err_msg=name)
    _close(r["got_kl"], r["kl"], atol=0, rtol=1e-4)


def test_stochastic_masked_gradients_match_jax(stochastic_masked):
    """Every parameter's gradient, atol 1e-4 of its largest magnitude (at
    least 1e-4), rtol 1e-3."""
    r = stochastic_masked
    ref = dict(load_flax(build_predictor(r["tcfg"]), {
        "params": _np_tree(r["grads"]),
        "batch_stats": r["pred_vars"]["batch_stats"]}).named_parameters())
    for name, param in r["port"].named_parameters():
        want = ref[name].detach().numpy()
        assert param.grad is not None, name
        _close(param.grad, want, atol=1e-4 * max(1.0, np.abs(want).max()),
               rtol=1e-3, err_msg=name)


def test_event_encoder_statistics_match_flax(stochastic_masked):
    """One masked training forward of NPVP-S moves the running statistics
    of both EventEncoders (the prior on the observed coding, the posterior
    on the target coding; the EVT-Former holds no BatchNorm) as flax's
    ``mutable=["batch_stats"]`` does."""
    r = stochastic_masked
    ref = load_flax(build_predictor(r["tcfg"]), {
        "params": r["pred_vars"]["params"],
        "batch_stats": _np_tree(r["mut"]["batch_stats"])}).state_dict()
    got = r["port"].state_dict()
    before = load_flax(build_predictor(r["tcfg"]),
                       r["pred_vars"]).state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert {k.split(".")[0] for k in stats} == {"evt_prior", "evt_posterior"}
    for key in stats:
        _close(got[key], ref[key].numpy(), atol=1e-6, rtol=0, err_msg=key)
        assert not torch.equal(got[key], before[key]), key


@pytest.mark.parametrize("exec_mode", ["xla", "pallas"])
def test_masked_mode_equals_static_mode(exec_mode):
    """Observe frames 0-2 and predict 3-7: the full-``max_T`` masked run
    gives the static run's outputs at the target times (eval mode; the
    kernel's plain twin with the masks in "pallas")."""
    from npvp_tpu_torch.models.coords import (coordinate_grid,
                                              spatial_index_lists)

    cfg = port_config(_cfg())
    p = cfg.Predictor
    torch.manual_seed(0)
    model = random_init(build_predictor(cfg, exec_mode=exec_mode), 4)
    model.eval()
    feats = torch.from_numpy(_masked_inputs(p)[0])
    h, w = spatial_index_lists(p.max_H, p.max_W)
    grid = lambda t: coordinate_grid(t, h, w, T, p.max_H, p.max_W)  # noqa
    obs = torch.arange(T) < 3
    vol = full_coordinate_volume(T, p.max_H, p.max_W)
    with torch.no_grad():
        static = model(feats[:, :3], grid(np.arange(3)),
                       grid(np.arange(3, T))).pred_features
        masked = model(feats, vol, vol, obs_mask=obs,
                       tgt_mask=~obs).pred_features
    _close(masked[:, 3:], static, atol=2e-4, rtol=0)


def test_masked_mode_no_target_leakage():
    """Changing the target frames of the input changes no prediction (eval
    and training mode, NPVP-D)."""
    cfg = port_config(_cfg())
    p = cfg.Predictor
    model = random_init(build_predictor(cfg), 5)
    feats = torch.from_numpy(_masked_inputs(p)[0])
    obs = torch.from_numpy(OBS[0])
    moved = feats.clone()
    moved[:, ~obs] += 50.0
    vol = full_coordinate_volume(T, p.max_H, p.max_W)
    for train in (False, True):
        model.train(train)
        outs = []
        for x in (feats, moved):
            torch.manual_seed(0)
            with torch.no_grad():
                outs.append(model(x, vol, vol, obs_mask=obs,
                                  tgt_mask=~obs).pred_features)
        _close(outs[1], outs[0], atol=1e-5, rtol=0,
               err_msg=f"train={train}")
    model.eval()
    with torch.no_grad():
        a = model(feats, vol, vol, obs_mask=obs, tgt_mask=~obs)
        b = model(moved, vol, vol, obs_mask=obs, tgt_mask=~obs)
    _close(b.pred_features, a.pred_features, atol=1e-5, rtol=0)


def test_schedules_match_optax():
    from npvp_tpu.core import optim as jopt

    cos_t = topt.cosine_warm_restarts(1e-3, 1e-7, 7)
    cos_j = jopt.cosine_warm_restarts(1e-3, 1e-7, 7)
    noam_t, noam_j = (topt.noam_schedule(512, 2.0, 10),
                      jopt.noam_schedule(512, 2.0, 10))
    steps = np.arange(3 * 7 + 2)  # three cycles and a restart
    _close(np.array([cos_t(int(s)) for s in steps]),
           [float(cos_j(jnp.asarray(s))) for s in steps], atol=0, rtol=1e-6)
    _close(np.array([noam_t(int(s)) for s in steps]),
           [float(noam_j(jnp.asarray(s))) for s in steps], atol=0,
           rtol=1e-6)
    assert cos_t(0) == 1e-3 and cos_t(7) == 1e-3


def _named_grads(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = {"decoder.layer_0.w": (3, 4), "decoder.norm.b": (4,),
              "evt_prior.w": (5,), "nrmlp.B": (2, 3)}
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _flax_tree(flat):
    tree = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_decoder_clip_matches_optax(scale):
    """The global norm over, and the scale applied to, the decoder's
    gradients only; below the bound nothing changes."""
    from npvp_tpu.core.optim import clip_subtree_by_global_norm as jclip

    grads = _named_grads(1, scale)
    params = {k: torch.nn.Parameter(torch.zeros(v.shape))
              for k, v in grads.items()}
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    topt.clip_subtree_by_global_norm(params.items(), 1.0,
                                     topt.is_decoder_param)
    tx = jclip(1.0, lambda path: "/decoder/" in path)
    want, _ = tx.update(_flax_tree(grads), tx.init(None))
    for k, p in params.items():
        node = want
        for part in k.split("."):
            node = node[part]
        _close(p.grad, node, atol=0, rtol=1e-6, err_msg=k)


def test_adamw_with_schedule_and_clip_matches_optax():
    """Three updates of the stage-2 optimizer against optax's chain."""
    import optax

    from npvp_tpu.core.optim import make_predictor_optimizer as jmake
    from npvp_tpu_torch.core.train_state import TrainState

    start = _named_grads(2, 1.0)
    module = torch.nn.Module()
    for k, v in start.items():  # nested names, as a model's
        *parents, leaf = k.split(".")
        node = module
        for p in parents:
            if not hasattr(node, p):
                node.add_module(p, torch.nn.Module())
            node = getattr(node, p)
        node.register_parameter(leaf, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    sched = topt.predictor_schedule(1e-2, True, 1e-4, 2)
    state = TrainState(module, topt.make_predictor_optimizer(
        module.parameters(), 1e-2), sched, 0.5, topt.is_decoder_param)
    tx = jmake(1e-2, 0.5, True, 1e-4, 2)
    jparams = _flax_tree(start)
    opt_state = tx.init(jparams)
    for i in range(3):
        grads = _named_grads(10 + i, 1.0)
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        state.apply_gradients()
        upd, opt_state = tx.update(_flax_tree(grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    assert state.step == 3
    for name, p in module.named_parameters():
        node = jparams
        for part in name.split("."):
            node = node[part]
        _close(p, node, atol=1e-6, rtol=0, err_msg=name)


def test_batchnorm_training_matches_flax():
    """Batch statistics (biased variance) normalise, and two updates move
    the running statistics with momentum 0.9, as flax does."""
    from npvp_tpu.nn.layers import BatchNorm as JBN

    rng = np.random.default_rng(0)
    xs = [rng.normal(1.0, 2.0, (4, 3, 3, 6)).astype(np.float32)
          for _ in range(2)]
    mod = JBN(use_running_average=False)
    variables = random_variables(mod.init, jax.random.key(0), xs[0])
    port = load_flax(tl.BatchNorm(6), variables).train()
    jvars = variables
    for x in xs:
        want, mut = mod.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
        jvars = {"params": variables["params"], **mut}
        _close(port(torch.from_numpy(x)), want, atol=1e-5, rtol=1e-5)
    _close(port.running_mean, jvars["batch_stats"]["mean"], atol=1e-6,
           rtol=0)
    _close(port.running_var, jvars["batch_stats"]["var"], atol=1e-6, rtol=0)
    port.eval()
    before = port.running_var.clone()
    port(torch.from_numpy(xs[0]))
    assert torch.equal(port.running_var, before)


def test_dropout_and_drop_path_scale_and_share():
    x = torch.ones(4000, 8)
    rng = tl.Rng(3)
    drop = tl.dropout(x, 0.25, True, rng.fold("a"))
    scaled = torch.tensor(1.0 / 0.75).item()  # in float32
    assert set(torch.unique(drop).tolist()) == {0.0, scaled}
    assert abs((drop == 0).float().mean().item() - 0.25) < 0.02
    assert torch.equal(tl.dropout(x, 0.25, True, rng.fold("a")), drop)
    assert not torch.equal(tl.dropout(x, 0.25, True, rng.fold("b")), drop)
    assert tl.dropout(x, 0.25, False, None) is x
    dp = tl.DropPath(0.25)
    y = dp(x, rng)
    per_sample = y[:, 0]
    assert torch.equal(y, per_sample[:, None].expand_as(y))  # whole samples
    assert set(torch.unique(per_sample).tolist()) == {0.0, scaled}
    assert abs((per_sample == 0).float().mean().item() - 0.25) < 0.03
    assert dp.eval()(x) is x and tl.DropPath(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Rng"):
        tl.DropPath(0.25).train()(x)


def test_remat_draws_the_same_masks():
    """Dropout and DropPath at 0.3 in a two-layer stack: with ``remat`` the
    recomputed blocks draw the masks of the first pass, so outputs and
    gradients equal the plain stack's."""
    C, H = 32, 4
    kw = dict(window_size=2, dropout=0.3, drop_path=0.3, dim_feedforward=64,
              ffn_hidden_ratio=2, spatial=(H, H))
    plain = tv.VidHRFormerEncoder(2, C, 4, **kw)
    remat = tv.VidHRFormerEncoder(2, C, 4, remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(3, 3, H, H, C, generator=torch.Generator().manual_seed(0))
    beta = torch.randn(3 * H * H, C) * 0.3
    outs, grads = [], []
    for stack in (plain, remat):
        out = stack.train()(x, beta, torch.zeros_like(beta), rng=tl.Rng(9))
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in stack.parameters()])
    assert not torch.equal(outs[0], plain.eval()(x, beta, 0 * beta))
    torch.testing.assert_close(outs[1], outs[0], atol=0, rtol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-5)


def test_kernel_serves_eval_mode_only(monkeypatch):
    """exec_mode "pallas": a training forward (with grad) reaches the
    kernel wrapper no time, an eval forward under ``torch.no_grad()`` at
    every attention call site: for NPVP-S 2 EVT-Former layers × 2 calls for
    each of the two codings and 2 decoder layers × 3; an eval forward whose
    inputs need a gradient takes the plain path, and its gradients flow."""
    calls = []
    real = tta.temporal_attention
    monkeypatch.setattr(tta, "temporal_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = port_config(_cfg(stochastic=True))
    p = cfg.Predictor
    model = random_init(build_predictor(cfg, exec_mode="pallas"), 6)
    feats = torch.from_numpy(_masked_inputs(p)[0])
    vol = full_coordinate_volume(T, p.max_H, p.max_W)
    obs = torch.from_numpy(OBS[1])
    run = lambda: model(feats, vol, vol, target_feats_gt=feats,  # noqa
                        obs_mask=obs, tgt_mask=~obs, rng=tl.Rng(0))
    run().pred_features.sum().backward()
    assert calls == []
    model.eval()
    with torch.no_grad():
        run()
    assert len(calls) == 2 * 2 + 2 * 2 + 2 * 3
    calls.clear()
    run().pred_features.sum().backward()  # under grad: the plain path
    assert calls == []
    assert all(p.grad is not None for p in model.decoder.parameters())


def _trainer_cfg(tmp_path, stochastic=True):
    cfg = _cfg("rand_context", stochastic)
    p = cfg.Predictor
    cfg.Dataset.dev_set_size, cfg.Env.platform = 4, "cpu"
    p.dropout = p.drop_path = 0.1  # the shipped rates
    p.epochs, p.exec_mode = 2, "pallas"
    p.ckpt_save_dir = str(tmp_path / "ckpt")
    p.tensorboard_save_dir = str(tmp_path / "log")
    tcfg = port_config(cfg)
    tcfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(tcfg, tmp_path))
    return tcfg


def test_trainer_runs_on_the_cpu(tmp_path):
    """``train`` with ``Env.platform=cpu``: two epochs of two steps, each
    validated (the eval step through the kernel wrapper) and checkpointed,
    finite losses, the resolved config beside the checkpoints."""
    cfg = _trainer_cfg(tmp_path)
    seen = []
    state = s2.train(cfg, on_step=lambda kind, i, m: seen.append(
        (kind, {k: float(v) for k, v in m.items()})))
    assert state.step == 4
    assert [k for k, _ in seen] == ["train"] * 2 + ["eval"] * 2 + [
        "train"] * 2 + ["eval"] * 2
    assert all(np.isfinite(list(m.values())).all() for _, m in seen)
    assert "KL_loss_val" in seen[2][1]
    log = [json.loads(line) for line in
           (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [2, 4] and "loss_val" in log[0]
    ckpt = CheckpointManager(tmp_path / "ckpt")
    assert ckpt.latest_step() == 4
    assert (tmp_path / "ckpt" / "config.json").exists()
    cfg.Env.platform = None  # unset means the card, which is absent here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            s2.train(cfg, max_steps=1)


def test_cli_smoke_on_the_cpu(tmp_path, capsys):
    cfg = _trainer_cfg(tmp_path, stochastic=False)
    cfg.Predictor.resume_AE_ckpt = str(tmp_path / "absent")
    cfg.save(tmp_path / "cfg.json")
    s2.main(["--config_path", str(tmp_path / "cfg.json"), "--smoke",
             "--override", "Env.platform=cpu"])
    out = capsys.readouterr().out
    assert "random weights" in out and "epoch 0:" in out
    assert CheckpointManager(tmp_path / "ckpt").latest_step() == 2


def test_checkpoint_round_trip_gives_the_same_next_step(tmp_path):
    """Save after one step; the next step from the restored state (a fresh
    model and optimizer) gives bit-identical losses and parameters."""
    cfg = _trainer_cfg(tmp_path)
    ae = s2.load_frozen_ae(cfg, torch.float32, "cpu")
    steps = s2.make_steps(cfg, ae, "rand_context", "cpu")
    batches = [steps.place(b) for b in _batches("rand_context")]

    def fresh():
        return s2.init_predictor_state(cfg, build_predictor(cfg), 3)

    state = fresh()
    steps.train(state, batches[0], tl.Rng(0))
    mngr = CheckpointManager(tmp_path / "rt", max_to_keep=1)
    mngr.save(state.step, state)
    want = steps.train(state, batches[1], tl.Rng(1))
    other = fresh()
    steps.train(other, batches[0], tl.Rng(5))  # a different history
    mngr.restore(other)
    assert other.step == 1
    got = steps.train(other, batches[1], tl.Rng(1))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_retention_keeps_the_best(tmp_path):
    class Holder:
        def state_dict(self):
            return {"step": 0}

    mngr = CheckpointManager(tmp_path, max_to_keep=2, monitor="loss_val")
    for step, loss in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 0.5)):
        mngr.save(step, Holder(), {"loss_val": loss})
    mngr.wait()  # the files are written in the background
    assert sorted(p.name for p in tmp_path.glob("*.pt")) == [
        "step_00000002.pt", "step_00000004.pt"]
    again = CheckpointManager(tmp_path, max_to_keep=2, monitor="loss_val")
    assert again.best_step() == 4 and again.latest_step() == 4
    latest = CheckpointManager(tmp_path / "latest", max_to_keep=2)
    for step in (1, 2, 3):
        latest.save(step, Holder())
    assert latest.latest_step() == 3 and not latest.path(1).exists()


def test_merge_det_init():
    det = {"a": torch.ones(2), "b": torch.ones(3)}
    sto = {"a": torch.zeros(2), "b": torch.zeros(4), "c": torch.zeros(1)}
    merged = s2.merge_det_init(det, sto)
    assert torch.equal(merged["a"], det["a"])
    assert merged["b"] is sto["b"] and merged["c"] is sto["c"]
