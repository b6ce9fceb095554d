"""Port parity: the frame autoencoder (nn/resnet_ae.py), the coordinate grids
(models/coords.py) and the neural-process modules (nn/neural_process.py)
against npvp_tpu on the same (random) flax variables, fp32, atol/rtol
1e-4."""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import port_config, random_variables, tiny_config  # noqa: E402

from npvp_tpu.models import coords as jc  # noqa: E402
from npvp_tpu.nn import neural_process as jnp_mod  # noqa: E402
from npvp_tpu.nn import resnet_ae as jae  # noqa: E402
from npvp_tpu_torch.models import coords as tc  # noqa: E402
from npvp_tpu_torch.nn import neural_process as tnp_mod  # noqa: E402
from npvp_tpu_torch.nn import resnet_ae as tae  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


def test_autoencoder_encode_decode():
    from npvp_tpu.train.stage1_ae import build_ae

    cfg = tiny_config()
    ae = build_ae(cfg, jnp.float32)
    frames = np.tanh(_x(2, 3, 32, 32, 1))
    variables = random_variables(ae.init, jax.random.key(0), frames)
    # one jit (one compile) instead of an eager compile per op
    feats, rec = jax.jit(lambda v, x: ae.apply(v, x))(variables, frames)[::-1]
    port = load_flax(tae.build_ae(port_config(cfg)), variables).eval()
    with torch.no_grad():
        got_feats = port.encode(torch.from_numpy(frames))
        got_rec = port.decode(torch.from_numpy(np.array(feats)))
    assert got_feats.shape == (2, 3, 4, 4, 32)
    _close(got_feats, feats)
    _close(got_rec, rec)


def test_non_local_attention_2d():
    x = _x(2, 8, 8, 16)
    mod = jae.NonLocalAttention2D()
    variables = random_variables(mod.init, jax.random.key(0), x)
    want = mod.apply(variables, jnp.asarray(x))
    port = load_flax(tae.NonLocalAttention2D(16), variables).eval()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want)


def test_coordinate_grid_and_task_lists():
    h, w = jc.spatial_index_lists(4, 5)
    t = np.array([0.0, 1.5, 7.25], np.float32)
    want = jc.coordinate_grid(jnp.asarray(t), h, w, 8, 4, 5)
    th, tw = tc.spatial_index_lists(4, 5)
    np.testing.assert_array_equal(np.asarray(tc.coordinate_grid(
        t, th, tw, 8, 4, 5)), np.asarray(want))
    with pytest.raises(ValueError, match="coordinates must lie"):
        tc.coordinate_grid([9.0], th, tw, 8, 4, 5)
    for task in ("VFP", "VPE", "VFI"):
        for a, b in zip(tc.task_time_lists(task, 5, 10, 2, 3),
                        jc.task_time_lists(task, 5, 10, 2, 3)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("fuse", ["Add", "SPADE"])
def test_nrmlp(fuse):
    coords = np.random.default_rng(0).random((40, 3)).astype(np.float32)
    mod = jnp_mod.NRMLP(out_channels=24, fuse_method=fuse)
    variables = random_variables(mod.init, jax.random.key(0), coords)
    beta, gamma = mod.apply(variables, jnp.asarray(coords))
    port = load_flax(tnp_mod.NRMLP(24, fuse_method=fuse), variables)
    with torch.no_grad():
        got_beta, got_gamma = port(torch.from_numpy(coords))
    _close(got_beta, beta)
    _close(got_gamma, gamma)


@pytest.mark.parametrize("norm", ["layer", "instance", "batch"])
def test_pos_feat_fuse(norm):
    x, beta, gamma = _x(2, 3, 4, 4, 8), _x(48, 8, seed=1), _x(48, 8, seed=2)
    want = jnp_mod.pos_feat_fuse(jnp.asarray(x), jnp.asarray(beta),
                                 jnp.asarray(gamma), norm)
    got = tnp_mod.pos_feat_fuse(torch.from_numpy(x), torch.from_numpy(beta),
                                torch.from_numpy(gamma), norm)
    _close(got, want)


@pytest.mark.parametrize("stochastic,inject", [(False, False), (True, False),
                                               (True, True)])
def test_event_encoder(stochastic, inject, monkeypatch):
    """sample=False (z = mu) and an injected eps through the flax rng."""
    x = _x(2, 4, 4, 32)
    eps = _x(2, 4, 4, 32, seed=5)
    mod = jnp_mod.EventEncoder(16, stochastic=stochastic)
    variables = random_variables(mod.init, {"params": jax.random.key(0),
                                            "latent": jax.random.key(1)}, x)
    if inject:
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=None: jnp.asarray(eps))
    want = mod.apply(variables, jnp.asarray(x), sample=inject,
                     rngs={"latent": jax.random.key(2)})
    port = load_flax(tnp_mod.EventEncoder(32, 16, stochastic=stochastic),
                     variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   torch.from_numpy(eps) if inject else None)
    if not stochastic:
        _close(got, want)
        return
    for g, w in zip(got, want):
        _close(g, w)
