"""Port parity: npvp_tpu_torch/nn/vidhrformer.py against
npvp_tpu/nn/vidhrformer.py (fp32, atol/rtol 1e-4), and, as
tests/test_affine_attention.py does for JAX, the port's affine-fused path
against its generic path on one parameter set."""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import random_variables  # noqa: E402

from npvp_tpu.kernels import temporal_attention as jta  # noqa: E402
from npvp_tpu.nn import vidhrformer as jv  # noqa: E402
from npvp_tpu_torch.nn import vidhrformer as tv  # noqa: E402
from npvp_tpu_torch.tools.weights import load_flax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
C, NH = 32, 4


def _x(*shape, seed=0, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    want = want.detach() if torch.is_tensor(want) else want
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("H,W", [(8, 8), (6, 10)])
def test_window_partition_roundtrip(H, W):
    x = _x(3, H, W, 5)
    got = tv.window_partition(_t(x), 4)
    _close(got, jv.window_partition(jnp.asarray(x), 4))
    _close(tv.window_reverse(got, 4, 3, H, W), x)


def test_encoder_temporal_allow():
    np.testing.assert_array_equal(tv.encoder_temporal_allow(5).numpy(),
                                  np.asarray(jv.encoder_temporal_allow(5)))
    obs = np.array([True, False, True, True, False])
    np.testing.assert_array_equal(
        tv.encoder_temporal_allow(5, _t(obs)).numpy(),
        np.asarray(jv.encoder_temporal_allow(5, jnp.asarray(obs))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_dwbn_and_gelu(dtype):
    x = _x(2, 3, 4, 4, C)
    mod = jv.MlpDWBN(64, C)
    variables = random_variables(mod.init, jax.random.key(0), x)
    if dtype == "float32":
        port = load_flax(tv.MlpDWBN(C, 64, C, (4, 4)), variables)
        _close(port(_t(x)), mod.apply(variables, jnp.asarray(x)))
    # exact GELU in fp32, tanh GELU in bf16, as the JAX package picks
    y = np.linspace(-4, 4, 101).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jv._gelu_for(jdt)(jnp.asarray(y))
    _close(tv._gelu_for(tdt)(_t(y)), want, atol=1e-6)


def _swa_args(H, W, with_evt):
    N, T = 2, 3
    x, beta = _x(N, T, H, W, C), _x(T * H * W, C, seed=1, scale=0.3)
    evt = _x(N, 1, H, W, C, seed=2) if with_evt else None
    return x, beta, evt


@pytest.mark.parametrize("H,W,with_evt", [(8, 8, False), (6, 10, True)])
def test_spatial_window_attention(H, W, with_evt):
    """Generic and affine paths against JAX, with center-padded windows."""
    x, beta, evt = _swa_args(H, W, with_evt)
    mod = jv.SpatialWindowAttention(C, NH)
    variables = random_variables(mod.init, jax.random.key(0), x, x)
    port = load_flax(tv.SpatialWindowAttention(C, NH), variables)
    _close(port(_t(x), _t(x)), mod.apply(variables, jnp.asarray(x),
                                         jnp.asarray(x)))
    want = mod.apply(variables, jnp.asarray(x), jnp.asarray(x),
                     pos_beta=jnp.asarray(beta),
                     evt=None if evt is None else jnp.asarray(evt))
    got = port(_t(x), _t(x), pos_beta=_t(beta),
               evt=None if evt is None else _t(evt))
    _close(got, want)


@pytest.mark.parametrize("cross", [False, True])
def test_temporal_attention(cross):
    """Generic (masked) and affine paths, self- and cross-attention."""
    N, T, To, H, W = 2, 3, 4, 4, 4
    q = _x(N, T, H, W, C)
    mem = _x(N, To, H, W, C, seed=1)
    beta, mbeta = _x(T * H * W, C, seed=2), _x(To * H * W, C, seed=3)
    evt = _x(N, 1, H, W, C, seed=4)
    k = mem if cross else q
    allow = (np.ones((T, To), bool) if cross
             else np.asarray(jv.encoder_temporal_allow(T)))
    mod = jv.TemporalAttention(C, NH)
    variables = random_variables(mod.init, jax.random.key(0), q, k, k)
    port = load_flax(tv.TemporalAttention(C, NH), variables)
    want = mod.apply(variables, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(k), jnp.asarray(allow))
    _close(port(_t(q), _t(k), _t(k), _t(allow)), want)
    jk = jnp.asarray(q) if not cross else jnp.asarray(mem)
    jq = jnp.asarray(q)
    want = mod.apply(variables, jq, jq if not cross else jk,
                     jq if not cross else jk, jnp.asarray(allow),
                     pos_beta_q=jnp.asarray(beta),
                     pos_beta_kv=jnp.asarray(mbeta) if cross else None,
                     evt_q=jnp.asarray(evt) if cross else None)
    tq = _t(q)
    tk = tq if not cross else _t(mem)
    got = port(tq, tk, tk, _t(allow), pos_beta_q=_t(beta),
               pos_beta_kv=_t(mbeta) if cross else None,
               evt_q=_t(evt) if cross else None)
    _close(got, want)


def _enc_args(H, W):
    N, T = 2, 3
    x = _x(N, T, H, W, C)
    beta = _x(T * H * W, C, seed=1, scale=0.3)
    return x, beta, np.zeros_like(beta)


def _dec_args(H, W):
    N, T, To = 2, 3, 4
    x = _x(N, T, H, W, C)
    mem = _x(N, To, H, W, C, seed=2)
    beta = _x(T * H * W, C, seed=1, scale=0.3)
    mbeta = _x(To * H * W, C, seed=3, scale=0.3)
    evt = _x(N, 1, H, W, C, seed=4)
    return (x, evt, mem, (mbeta, np.zeros_like(mbeta)),
            (beta, np.zeros_like(beta)))


def _tree_t(args):
    return tuple(tuple(_t(b) for b in a) if isinstance(a, tuple) else _t(a)
                 for a in args)


def _tree_j(args):
    return tuple(tuple(jnp.asarray(b) for b in a) if isinstance(a, tuple)
                 else jnp.asarray(a) for a in args)


@pytest.mark.parametrize("affine", [False, True])
def test_encoder_block(affine):
    args = _enc_args(4, 4)
    mod = jv.VidHRFormerBlockEnc(C, NH, window_size=2, dropout=0.0,
                                 drop_path=0.0, dim_feedforward=64,
                                 ffn_hidden_ratio=2, affine_posfuse=affine)
    variables = random_variables(mod.init, jax.random.key(0), *args)
    port = load_flax(tv.VidHRFormerBlockEnc(
        C, NH, window_size=2, ffn_hidden_ratio=2, dim_feedforward=64,
        affine_posfuse=affine, spatial=(4, 4)), variables).eval()
    _close(port(*_tree_t(args)), mod.apply(variables, *_tree_j(args)))


@pytest.mark.parametrize("affine", [False, True])
def test_decoder_block(affine):
    args = _dec_args(4, 4)
    mod = jv.VidHRFormerBlockDecNAR(C, NH, window_size=2, dropout=0.0,
                                    drop_path=0.0, dim_feedforward=64,
                                    ffn_hidden_ratio=2,
                                    affine_posfuse=affine)
    variables = random_variables(mod.init, jax.random.key(0), *args)
    port = load_flax(tv.VidHRFormerBlockDecNAR(
        C, NH, window_size=2, ffn_hidden_ratio=2, dim_feedforward=64,
        affine_posfuse=affine, spatial=(4, 4)), variables).eval()
    _close(port(*_tree_t(args)), mod.apply(variables, *_tree_j(args)))


@pytest.mark.parametrize("fuse", [True, False])
def test_stacks_with_kernel_match_jax_pallas(monkeypatch, fuse):
    """Encoder and decoder stacks on the affine path with exec_mode="pallas":
    the port (kernel wrapper → plain twin on the CPU, the output projection
    always fused) against JAX (the Pallas kernel in interpret mode,
    BLOCK_SITES shrunk so it engages), both of JAX's FUSE_OPROJ settings;
    the decoder includes the cross-layer k/v hoist."""
    monkeypatch.setattr(jta, "BLOCK_SITES", 8)
    monkeypatch.setattr(jta, "FUSE_OPROJ", fuse)
    kw = dict(window_size=2, ffn_hidden_ratio=2, dim_feedforward=64,
              affine_posfuse=True, exec_mode="pallas")
    x, beta, gamma = _enc_args(4, 4)
    enc = jv.VidHRFormerEncoder(2, C, NH, dropout=0.0, drop_path=0.0, **kw)
    variables = random_variables(enc.init, jax.random.key(0), x, beta, gamma)
    port = load_flax(tv.VidHRFormerEncoder(2, C, NH, spatial=(4, 4), **kw),
                     variables).eval()
    with torch.no_grad():  # the kernel has no backward
        got = port(_t(x), _t(beta), _t(gamma))
    _close(got, jax.jit(enc.apply)(variables, x, beta, gamma))

    _, evt, mem, mpos, tpos = _dec_args(4, 4)
    dec = jv.VidHRFormerDecoderNAR(2, C, NH, dropout=0.0, drop_path=0.0,
                                   **kw)
    dargs = (evt, mem, mpos, tpos)
    variables = random_variables(dec.init, jax.random.key(1), *dargs)
    port = load_flax(tv.VidHRFormerDecoderNAR(2, C, NH, spatial=(4, 4),
                                              **kw), variables).eval()
    with torch.no_grad():
        got = port(*_tree_t(dargs))
    _close(got, jax.jit(dec.apply)(variables, *_tree_j(dargs)))


@pytest.mark.parametrize("H,W", [(8, 8), (6, 6), (6, 10)])
def test_port_enc_block_affine_equals_generic(H, W):
    args = _tree_t(_enc_args(H, W))
    torch.manual_seed(0)
    mk = lambda af: tv.VidHRFormerBlockEnc(  # noqa: E731
        C, NH, dim_feedforward=64, affine_posfuse=af, spatial=(H, W)).eval()
    generic, affine = mk(False), mk(True)
    affine.load_state_dict(generic.state_dict())
    _close(affine(*args), generic(*args), atol=2e-5, rtol=0)


@pytest.mark.parametrize("H,W", [(8, 8), (6, 6)])
def test_port_dec_block_affine_equals_generic(H, W):
    args = _tree_t(_dec_args(H, W))
    torch.manual_seed(0)
    mk = lambda af: tv.VidHRFormerBlockDecNAR(  # noqa: E731
        C, NH, dim_feedforward=64, affine_posfuse=af, spatial=(H, W)).eval()
    generic, affine = mk(False), mk(True)
    affine.load_state_dict(generic.state_dict())
    _close(affine(*args), generic(*args), atol=3e-5, rtol=0)


def test_port_decoder_cross_kv_hoist_equals_generic():
    _, evt, mem, mpos, tpos = _tree_t(_dec_args(8, 8))
    torch.manual_seed(0)
    mk = lambda af: tv.VidHRFormerDecoderNAR(  # noqa: E731
        2, C, NH, dim_feedforward=64, affine_posfuse=af, spatial=(8, 8)).eval()
    generic, affine = mk(False), mk(True)
    affine.load_state_dict(generic.state_dict())
    _close(affine(evt, mem, mpos, tpos), generic(evt, mem, mpos, tpos),
           atol=2e-5, rtol=0)
