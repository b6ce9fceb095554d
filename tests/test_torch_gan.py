"""The adversarial stage-2 path of the port against the JAX package, fp32 on
the CPU at the tiny test size:

- ``PatchDiscriminator`` from flax variables: logits in eval and training
  mode (atol 1e-5) and the running statistics it moves (atol 1e-6);
- ``gan_loss`` in every mode, value and gradient (atol 1e-6), and the
  unknown mode's error;
- ``gradient_penalty`` with JAX's interpolation weights: value (rtol
  1e-5) and its gradient in the discriminator's parameters (atol 1e-5 ·
  the largest), and JAX's closed-form case;
- one ``make_gan_steps`` step of NPVP-D (dropout 0, pairs and
  rand_context) against JAX's from the same variables: every metric (rtol
  1e-5), the gradients that reach each update before its clip (atol
  1e-4 · the largest + rtol 1e-3, ``test_torch_train.py``'s bound; JAX's
  jitted step hands them out through a debug callback), the predictor's
  and the discriminator's updated parameters (atol 1e-5) and running
  statistics (atol 1e-6).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_train import (  # noqa: E402
    _batches, _cfg, _jax_model, _np_tree, _port_model)

from npvp_tpu_torch.nn import discriminator as td  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402
from npvp_tpu_torch.train import stage2_predictor as s2  # noqa: E402


def _flax_disc(seed=0, ndf=8, n_layers=3, size=32):
    from npvp_tpu.nn.discriminator import PatchDiscriminator

    disc = PatchDiscriminator(ndf=ndf, n_layers=n_layers)
    x = np.random.default_rng(seed).standard_normal(
        (4, size, size, 1)).astype(np.float32)
    variables = disc.init(jax.random.key(seed), x)
    # non-trivial running statistics, so that eval mode reads them
    stats = jax.tree.map(lambda a: np.random.default_rng(seed + 1).uniform(
        0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    variables = {"params": _np_tree(variables["params"]),
                 "batch_stats": stats}
    port = load_flax(td.PatchDiscriminator(1, ndf, n_layers), variables)
    return disc, variables, port, x


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_patch_discriminator_matches_flax():
    disc, variables, port, x = _flax_disc()
    want = np.asarray(disc.apply(variables, x))
    got = port.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (4, 2, 2, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    want, mutated = disc.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    ref = _state(load_flax(td.PatchDiscriminator(1, 8, 3), {
        "params": variables["params"],
        "batch_stats": _np_tree(mutated["batch_stats"])}))
    for k, v in _state(port).items():
        if "running" in k:
            np.testing.assert_allclose(v, ref[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    from npvp_tpu.nn.discriminator import gan_loss

    logits = np.random.default_rng(2).standard_normal(
        (3, 4, 4, 1)).astype(np.float32) * 3
    f = lambda x: gan_loss(x, real, mode, lam=0.5)  # noqa: E731
    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = td.gan_loss(t, real, mode, lam=0.5)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)


def test_gan_loss_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="hinge"):
        td.gan_loss(torch.zeros(2), True, "hinge")


def test_gradient_penalty_matches_jax():
    from npvp_tpu.nn.discriminator import gradient_penalty

    disc, variables, port, x = _flax_disc(seed=4)
    rng = np.random.default_rng(5)
    real = rng.standard_normal(x.shape).astype(np.float32)
    fake = rng.standard_normal(x.shape).astype(np.float32)
    key = jax.random.key(6)
    t = np.array(jax.random.uniform(key, (4, 1, 1, 1)))

    def jax_gp(params):
        return gradient_penalty(lambda y: disc.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, y),
            real, fake, key)

    want, want_g = jax.value_and_grad(jax_gp)(variables["params"])
    port.eval()
    got = td.gradient_penalty(port, torch.from_numpy(real),
                              torch.from_numpy(fake), torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    ref = load_flax(td.PatchDiscriminator(1, 8, 3), {
        "params": _np_tree(want_g), "batch_stats": variables["batch_stats"]})
    ref = dict(ref.named_parameters())
    top = max(float(np.abs(np.asarray(g)).max())
              for g in jax.tree.leaves(want_g))
    for name, p in port.named_parameters():
        # a bias that only shifts the critic has no path to the penalty:
        # autograd leaves its gradient None where JAX gives zeros
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), ref[name].detach().numpy(),
                                   atol=1e-5 * top, err_msg=name)
    # JAX's closed form: critic Σ2x has gradient norm 2·√16 a sample
    critic = lambda y: (2.0 * y).sum((1, 2, 3))  # noqa: E731
    gp = td.gradient_penalty(critic, torch.ones(4, 4, 4, 1),
                             torch.zeros(4, 4, 4, 1), torch.rand(4, 1, 1, 1))
    assert float(gp) == pytest.approx((2.0 * 4 - 1) ** 2 * 10.0, rel=1e-4)


def _jax_gan_step(cfg, mode, ae, ae_vars, pred, pred_vars, batch,
                  monkeypatch):
    """JAX's step, with each update's gradients taken as
    ``TrainState.apply_gradients`` receives them (a host callback in the
    jitted step): → the discriminator's initial variables, the metrics,
    the variables after the step and the gradients, name → tree
    ("d", "g")."""
    from npvp_tpu.core.mesh import make_mesh
    from npvp_tpu.core.optim import make_predictor_optimizer
    from npvp_tpu.core.train_state import TrainState
    from npvp_tpu.train.stage2_predictor import make_gan_steps

    grads, apply = {}, TrainState.apply_gradients

    def keep(tree):
        grads["d" if "conv0" in tree else "g"] = _np_tree(tree)

    def capture(self, g, *a, **kw):
        jax.debug.callback(keep, g)
        return apply(self, g, *a, **kw)

    monkeypatch.setattr(TrainState, "apply_gradients", capture)

    p = cfg.Predictor
    tx = make_predictor_optimizer(p.predictor_lr, p.max_grad_norm,
                                  p.use_cosine_scheduler,
                                  p.scheduler_eta_min, p.scheduler_T0 * 3)
    state_g = TrainState.create(
        apply_fn=pred.apply, params=jax.tree.map(jnp.asarray,
                                                 pred_vars["params"]),
        batch_stats=pred_vars["batch_stats"], tx=tx)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    train_step, _, place, init_disc = make_gan_steps(cfg, pred, ae, ae_vars,
                                                     mesh, mode)
    state_d = init_disc(jax.random.key(1))
    d_vars = {"params": _np_tree(state_d.params),
              "batch_stats": _np_tree(state_d.batch_stats)}
    state_g, state_d, metrics = train_step(state_g, state_d, place(batch),
                                           jax.random.key(0))
    jax.effects_barrier()
    return d_vars, {k: float(v) for k, v in metrics.items()}, {
        "g": {"params": _np_tree(state_g.params),
              "batch_stats": _np_tree(state_g.batch_stats)},
        "d": {"params": _np_tree(state_d.params),
              "batch_stats": _np_tree(state_d.batch_stats)}}, grads


def _assert_state(port_module, ref_module, what):
    ref = _state(ref_module)
    for k, v in _state(port_module).items():
        stat = "running" in k
        np.testing.assert_allclose(v, ref[k], atol=1e-6 if stat else 1e-5,
                                   rtol=1e-5 if stat else 0.0,
                                   err_msg=f"{what} {k}")


def _assert_grads(got, want_module, what):
    """``got`` (name → gradient) against JAX's gradients carried into the
    port's layout by the weight bridge (``want_module``)."""
    want = {k: v.detach().numpy() for k, v in want_module.named_parameters()}
    top = max(np.abs(w).max() for w in want.values())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4 * max(
            1.0, top), rtol=1e-3, err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", ["pairs", "rand_context"])
def test_gan_step_matches_jax(mode, monkeypatch):
    cfg = _cfg(mode, layers=1)
    cfg.Predictor.use_gan, cfg.Predictor.ndf = True, 4
    ae, ae_vars, pred, pred_vars = _jax_model(cfg, seed=30)
    batch = _batches(mode)[0]
    d_vars, want, after, jax_grads = _jax_gan_step(
        cfg, mode, ae, ae_vars, pred, pred_vars, batch, monkeypatch)
    tcfg, tae, tpred = _port_model(cfg, ae_vars, pred_vars)
    state_g = s2.init_predictor_state(tcfg, tpred, 3)
    load_flax(tpred, pred_vars)  # init drew random weights over them
    train_step, eval_step, place, init_d = s2.make_gan_steps(
        tcfg, tae, mode, "cpu")
    state_d = init_d(0)
    assert state_d.model.n_layers == 2  # min(3, log2(32) - 3)
    load_flax(state_d.model, d_vars)
    grads, apply = [], type(state_g).apply_gradients

    def capture(state):
        grads.append({k: p.grad.detach().clone()
                      for k, p in state.module.named_parameters()})
        apply(state)

    monkeypatch.setattr(type(state_g), "apply_gradients", capture)
    got = train_step(state_g, state_d, place(batch), tl.Rng(0))
    assert state_g.step == state_d.step == 1
    assert sorted(got) == sorted(want) == sorted(
        ["loss", "Image_L1", "PF_L1", "loss_G_gan", "loss_D", "loss_D_fake",
         "loss_D_real"])
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    jax_d, jax_g = jax_grads["d"], jax_grads["g"]
    _assert_grads(grads[0], load_flax(td.PatchDiscriminator(1, 4, 2), {
        "params": jax_d, "batch_stats": d_vars["batch_stats"]}),
        "discriminator gradient")
    _assert_grads(grads[1], _port_model(cfg, ae_vars, {
        "params": jax_g, "batch_stats": pred_vars["batch_stats"]})[2],
        "predictor gradient")
    _, ref_ae, ref_g = _port_model(cfg, ae_vars, after["g"])
    _assert_state(tpred, ref_g, "predictor")
    ref_d = load_flax(td.PatchDiscriminator(1, 4, 2), after["d"])
    _assert_state(state_d.model, ref_d, "discriminator")
    # the eval step is the plain one
    val = eval_step(state_g, place(batch), tl.Rng(1))
    assert sorted(val) == ["Image_L1_val", "PF_L1_val", "loss_val"]
