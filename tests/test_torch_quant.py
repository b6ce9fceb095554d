"""Port parity of the int8 serving path: npvp_tpu_torch/nn/quant.py and the
``exec_mode="int8"`` branches of the predictor against npvp_tpu's, on the
CPU.

- ``quantize_rowwise``/``quantize_colwise`` are bit-equal to JAX's on the
  same float32 input (the same abs-max, division, round-half-to-even and
  clip), the static scale included.
- ``int8_contract`` is within one LSB × scale of JAX's: the int32 sums are
  exact in both, and the float32 rescale takes the same two products.
- Modules and whole predictors: a float32 value that differs by one ULP
  between the packages (sums taken in another order before a later
  quantization) can round to the neighbouring int8 step. One such flip
  moves a product by ``scale_x · |w|`` (≈ (amax / 127) · |w|, ~1e-2 at
  these sizes) and spreads through the attention and the norms after it.
  So modules are held at atol 2e-2, and whole predictors, where a flip in
  an early layer reaches every output, at max |d| ≤ 0.1 with a mean |d|
  under 2 % of the mean |output|: the int8 path's own drift from float32
  is larger (tests/test_quant.py holds JAX's under 5 %). Without a flip
  the packages agree to ~1e-6.
"""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import (port_config, random_variables,  # noqa: E402
                            tiny_config)

import npvp_tpu.nn.quant as jq  # noqa: E402
import npvp_tpu_torch.nn.quant as tq  # noqa: E402
from npvp_tpu.nn import layers as jl  # noqa: E402
from npvp_tpu.nn import vidhrformer as jv  # noqa: E402
from npvp_tpu_torch.kernels import temporal_attention as tta  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402
from npvp_tpu_torch.nn import vidhrformer as tv  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402

C, NH = 32, 4
MODULE_ATOL = 2e-2


def _x(*shape, seed=0, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=MODULE_ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("static", [None, 0.02])
@pytest.mark.parametrize("n_contract", [1, 2])
def test_quantize_bit_equal(monkeypatch, static, n_contract):
    monkeypatch.setattr(jq, "STATIC_ACT_SCALE", static)
    monkeypatch.setattr(tq, "STATIC_ACT_SCALE", static)
    x = _x(5, 7, 6, 4, scale=2.0)
    x[0, 0] = 0.0  # an all-zero row takes the floor of the scale
    for name in ("quantize_rowwise", "quantize_colwise"):
        if name == "quantize_colwise" and static is not None:
            continue  # weights never take the static scale
        jqv, js = getattr(jq, name)(jnp.asarray(x), n_contract)
        tqv, ts = getattr(tq, name)(_t(x), n_contract)
        assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_contract", [1, 2])
def test_int8_contract_within_one_lsb(n_contract):
    x = _x(3, 5, 4, 8, seed=1, scale=1.5)
    w = _x(*((4, 8)[-n_contract:] + (6,)), seed=2)
    want = np.asarray(jq.int8_contract(jnp.asarray(x), jnp.asarray(w),
                                       n_contract, out_dtype=jnp.float32))
    got = tq.int8_contract(_t(x), _t(w), n_contract,
                           out_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    sx = tq.quantize_rowwise(_t(x), n_contract)[1].numpy()
    sw = tq.quantize_colwise(_t(w), n_contract)[1].numpy()
    lsb = sx.reshape(sx.shape[:x.ndim - n_contract] + (1,)) * sw.reshape(-1)
    assert (np.abs(got - want) <= lsb).all()
    # and the product itself is the float one within the int8 grain
    exact = np.tensordot(x, w, n_contract)
    assert np.abs(got - exact).max() < 0.05 * np.abs(exact).max()


def test_int8_contract_passes_gradient_through_the_scales():
    """Rounding has no gradient, so under autograd only the scales carry
    one, as ``jax.grad`` finds in the JAX package."""
    x, w = _x(4, 8, seed=3), _x(8, 5, seed=4)
    jgrad = jax.grad(lambda a: jq.int8_contract(
        a, jnp.asarray(w), out_dtype=jnp.float32).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    tq.int8_contract(xt, _t(w), out_dtype=torch.float32).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5)


@pytest.mark.parametrize("self_attention", [True, False])
def test_multi_head_attention_int8(self_attention):
    """Fused q/k projection (q is k) and separate projections, int8."""
    q, kv = _x(2, 6, C), _x(2, 6 if self_attention else 5, C, seed=1)
    k = q if self_attention else kv
    mod = jl.MultiHeadAttention(C, NH, quant=True)
    variables = random_variables(mod.init, jax.random.key(0), q, k, kv)
    port = load_flax(tl.MultiHeadAttention(C, NH, quant=True), variables)
    jqq = jnp.asarray(q)
    want = mod.apply(variables, jqq, jqq if self_attention else
                     jnp.asarray(kv), jnp.asarray(kv))
    tqq = _t(q)
    _close(port(tqq, tqq if self_attention else _t(kv), _t(kv)), want)


@pytest.mark.parametrize("affine", [False, True])
def test_spatial_window_attention_int8(affine):
    N, T, H, W = 2, 3, 6, 10
    x, beta = _x(N, T, H, W, C), _x(T * H * W, C, seed=1, scale=0.3)
    evt = _x(N, 1, H, W, C, seed=2)
    mod = jv.SpatialWindowAttention(C, NH, exec_mode="int8")
    variables = random_variables(mod.init, jax.random.key(0), x, x)
    port = load_flax(tv.SpatialWindowAttention(C, NH, exec_mode="int8"),
                     variables)
    if not affine:
        want = jax.jit(mod.apply)(variables, jnp.asarray(x), jnp.asarray(x))
        _close(port(_t(x), _t(x)), want)
        return
    want = jax.jit(mod.apply)(variables, jnp.asarray(x), jnp.asarray(x),
                     pos_beta=jnp.asarray(beta), evt=jnp.asarray(evt))
    _close(port(_t(x), _t(x), pos_beta=_t(beta), evt=_t(evt)), want)


@pytest.mark.parametrize("cross", [False, True])
def test_temporal_attention_int8(cross):
    """The affine path, temporal self-attention (q/k/v in one product) and
    cross-attention (q, and k/v over the memory)."""
    N, T, To, H, W = 2, 3, 4, 4, 4
    q, mem = _x(N, T, H, W, C), _x(N, To, H, W, C, seed=1)
    beta, mbeta = _x(T * H * W, C, seed=2), _x(To * H * W, C, seed=3)
    evt = _x(N, 1, H, W, C, seed=4)
    allow = (np.ones((T, To), bool) if cross
             else np.asarray(jv.encoder_temporal_allow(T)))
    mod = jv.TemporalAttention(C, NH, exec_mode="int8")
    k = mem if cross else q
    variables = random_variables(mod.init, jax.random.key(0), q, k, k)
    port = load_flax(tv.TemporalAttention(C, NH, exec_mode="int8"),
                     variables)
    jqq = jnp.asarray(q)
    jk = jnp.asarray(mem) if cross else jqq
    want = mod.apply(variables, jqq, jk, jk, jnp.asarray(allow),
                     pos_beta_q=jnp.asarray(beta),
                     pos_beta_kv=jnp.asarray(mbeta) if cross else None,
                     evt_q=jnp.asarray(evt) if cross else None)
    tqq = _t(q)
    tk = _t(mem) if cross else tqq
    got = port(tqq, tk, tk, _t(allow), pos_beta_q=_t(beta),
               pos_beta_kv=_t(mbeta) if cross else None,
               evt_q=_t(evt) if cross else None)
    _close(got, want)


def test_mlp_dwbn_int8():
    x = _x(2, 3, 4, 4, C)
    mod = jv.MlpDWBN(64, C, exec_mode="int8")
    variables = random_variables(mod.init, jax.random.key(0), x)
    port = load_flax(tv.MlpDWBN(C, 64, C, (4, 4), quant=True), variables)
    _close(port(_t(x)), jax.jit(mod.apply)(variables, jnp.asarray(x)))


def test_decoder_stack_int8():
    """Two NAR decoder blocks on the affine path, int8: the decoder FFN,
    both MlpDWBNs and the cross-attention over the memory (hoisted into
    one product for all layers in the port, one per layer in JAX)."""
    N, T, To, H, W = 2, 3, 4, 4, 4
    evt, mem = _x(N, 1, H, W, C, seed=4), _x(N, To, H, W, C, seed=2)
    beta = _x(T * H * W, C, seed=1, scale=0.3)
    mbeta = _x(To * H * W, C, seed=3, scale=0.3)
    mem_pos = (mbeta, np.zeros_like(mbeta))
    tgt_pos = (beta, np.zeros_like(beta))
    kw = dict(window_size=2, ffn_hidden_ratio=2, dim_feedforward=64,
              affine_posfuse=True, exec_mode="int8")
    dec = jv.VidHRFormerDecoderNAR(2, C, NH, dropout=0.0, drop_path=0.0,
                                   **kw)
    variables = random_variables(dec.init, jax.random.key(0), evt, mem,
                                 mem_pos, tgt_pos)
    port = load_flax(tv.VidHRFormerDecoderNAR(2, C, NH, spatial=(4, 4),
                                              **kw), variables).eval()
    j = lambda a: tuple(jnp.asarray(b) for b in a)  # noqa: E731
    t = lambda a: tuple(_t(b) for b in a)  # noqa: E731
    want = jax.jit(dec.apply)(variables, jnp.asarray(evt), jnp.asarray(mem),
                     j(mem_pos), j(tgt_pos))
    with torch.no_grad():
        got = port(_t(evt), _t(mem), t(mem_pos), t(tgt_pos))
    _close(got, want)


def _predictors(stochastic, seed):
    from npvp_tpu.models.predictor import build_predictor as jbuild

    from npvp_tpu_torch.models.predictor import build_predictor

    cfg = tiny_config(stochastic)
    p = cfg.Predictor
    jpred = jbuild(cfg, jnp.float32, exec_mode="int8")
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc0 = np.zeros((2 * p.max_H * p.max_W, 3))
    init = lambda *a: jpred.init(  # noqa: E731
        *a, num_target=2, target_feats_gt=feats0 if stochastic else None)
    variables = random_variables(init, {"params": jax.random.key(1),
                                        "latent": jax.random.key(2)},
                                 feats0, oc0, oc0, seed=seed)
    port = load_flax(build_predictor(port_config(cfg), exec_mode="int8"),
                     variables).eval()
    return cfg, jpred, variables, port


def _coords(cfg, times):
    from npvp_tpu.models.coords import coordinate_grid, spatial_index_lists

    p = cfg.Predictor
    h, w = spatial_index_lists(p.max_H, p.max_W)
    return np.asarray(coordinate_grid(jnp.asarray(times, jnp.float32), h, w,
                                      p.max_T, p.max_H, p.max_W))


@pytest.mark.parametrize("stochastic", [False, True])
def test_predictor_int8_matches_jax(monkeypatch, stochastic):
    """NPVP-D and NPVP-S built with exec_mode="int8" against JAX's int8
    predictor on the same weights, features and latent noise; the
    tolerance is the module docstring's."""
    cfg, jpred, variables, port = _predictors(stochastic, seed=5)
    rng = np.random.default_rng(0)
    feats = np.abs(rng.standard_normal((2, 3, 4, 4, 32))).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    oc, tc = _coords(cfg, np.arange(3)), _coords(cfg, np.arange(3, 6))
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: (
                            jnp.asarray(eps) if tuple(shape) == eps.shape
                            else real(key, shape, dtype)))
    want = np.asarray(jpred.apply(
        variables, jnp.asarray(feats), jnp.asarray(oc), jnp.asarray(tc), 3,
        rngs={"latent": jax.random.key(0)}).pred_features)
    monkeypatch.setattr(tta, "temporal_attention", None)  # int8: no kernel
    with torch.no_grad():
        got = port(_t(feats), _t(oc), _t(tc),
                   _t(eps) if stochastic else None).pred_features.numpy()
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert d.max() <= 0.1 and d.mean() < 0.02 * np.abs(want).mean(), (
        d.max(), d.mean())


def test_int8_drift_from_float32():
    """The port's int8 predictor drifts < 5 % in feature space from its
    float32 path on one parameter set (tests/test_quant.py's bound for
    JAX's)."""
    from npvp_tpu_torch.models.predictor import build_predictor

    cfg, _, variables, port8 = _predictors(False, seed=7)
    port32 = load_flax(build_predictor(port_config(cfg), exec_mode="xla"),
                       variables).eval()
    feats = np.abs(_x(2, 3, 4, 4, 32, seed=3, scale=1.0))
    oc, tc = _coords(cfg, np.arange(3)), _coords(cfg, np.arange(3, 6))
    with torch.no_grad():
        a, b = (m(_t(feats), _t(oc), _t(tc)).pred_features
                for m in (port32, port8))
    rel = float((a - b).abs().mean() / (a.abs().mean() + 1e-9))
    assert 0 < rel < 0.05, rel


@pytest.mark.cuda
def test_int8_matmul_pads_for_the_card():
    """On the card ``torch._int_mm`` takes M > 16 and K, N multiples of 8;
    smaller and ragged operands are padded with zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(0)
    for M, K, N in ((5, 12, 7), (17, 8, 8), (300, 36, 20)):
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
        got = tq.int8_matmul(a.cuda(), b.cuda()).cpu()
        assert torch.equal(got, a.int() @ b.int())
