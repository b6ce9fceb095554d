"""Port parity: npvp_tpu_torch/nn/layers.py against npvp_tpu/nn/layers.py on
the same (random) flax variables, fp32 on the CPU, atol/rtol 1e-4."""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import random_variables  # noqa: E402

from npvp_tpu.nn import layers as jl  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_product_attention(masked):
    q, k, v = _x(2, 3, 5, 4, 8), _x(2, 3, 7, 4, 8, seed=1), _x(2, 3, 7, 4, 8,
                                                               seed=2)
    mask = None
    if masked:
        mask = np.random.default_rng(3).random((5, 7)) > 0.4
        mask[:, 0] = True
        mask[1] = False  # a fully masked row stays finite (finfo.min)
    want = jl.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask))
    got = tl.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got, want)


def test_multi_head_attention():
    q, kv = _x(2, 6, 32), _x(2, 9, 32, seed=1)
    mod = jl.MultiHeadAttention(32, 4)
    variables = random_variables(mod.init, jax.random.key(0), q, kv, kv)
    want = mod.apply(variables, jnp.asarray(q), jnp.asarray(kv),
                     jnp.asarray(kv))
    port = load_flax(tl.MultiHeadAttention(32, 4), variables)
    got = port(torch.from_numpy(q), torch.from_numpy(kv),
               torch.from_numpy(kv))
    _close(got, want)


@pytest.mark.parametrize("kind", ["batch", "token", "hwc"])
def test_norms(kind):
    x = _x(3, 4, 5, 6) * 2 + 0.5
    mod, port = {
        "batch": (jl.BatchNorm(), tl.BatchNorm(6)),
        "token": (jl.TokenLayerNorm(epsilon=1e-5), tl.TokenLayerNorm(6, 1e-5)),
        "hwc": (jl.LayerNormHWC(), tl.LayerNormHWC((4, 5, 6))),
    }[kind]
    variables = random_variables(mod.init, jax.random.key(0), x)
    want = mod.apply(variables, jnp.asarray(x))
    _close(load_flax(port, variables).eval()(torch.from_numpy(x)), want)


def test_fp32_moments_and_reflect_pad():
    x = _x(2, 3, 5, 4) + 3.0
    mean_j, var_j = jl.fp32_moments(jnp.asarray(x), (1, 2, 3))
    mean_t, var_t = tl.fp32_moments(torch.from_numpy(x), (1, 2, 3))
    _close(mean_t, mean_j)
    _close(var_t, var_j)
    _close(tl.reflect_pad_2d(torch.from_numpy(x), 2),
           jl.reflect_pad_2d(jnp.asarray(x), 2))


@pytest.mark.parametrize("kernel,stride,padding,groups,bias,act", [
    (3, 1, "TORCH_SAME", 1, False, "relu"),
    (3, 2, "TORCH_SAME", 1, True, "relu"),   # symmetric pad at stride 2
    (7, 1, "VALID", 1, False, None),
    (3, 1, "TORCH_SAME", 8, False, "relu"),  # depthwise
])
def test_conv_bn_act(kernel, stride, padding, groups, bias, act):
    x = _x(2, 9, 9, 8)
    from flax import linen as fnn

    mod = jl.ConvBNAct(8, (kernel, kernel), strides=(stride, stride),
                       padding=padding, use_bias=bias,
                       feature_group_count=groups,
                       activation=fnn.relu if act else None)
    variables = random_variables(mod.init, jax.random.key(0), x)
    want = mod.apply(variables, jnp.asarray(x))
    port = tl.ConvBNAct(8, 8, kernel, stride, padding, bias, act, groups)
    _close(load_flax(port, variables).eval()(torch.from_numpy(x)), want)
