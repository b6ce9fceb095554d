"""The temporal-attention kernel's plain twin against the JAX Pallas kernel
(run in interpret mode, as tests/test_temporal_kernel.py runs it), with the
cases of that file: unmasked with Tq ≠ Tk, masked, fused versus separate
output projection, and a site count not divisible by a block. The port
takes wo as ``nn.Linear.weight`` (C, H·D), the transpose of the JAX
kernel's (H·D, C): the helpers transpose once when they hand JAX weights to
the port. A fully masked query row, and the CUDA kernel's packing of whole
sites into 64-row tiles with -inf between sites, are held against the
reference per site. The CUDA kernel itself is held against the twin in
tests/test_torch_kernel_cuda.py (on the card only)."""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from npvp_tpu.kernels.temporal_attention import \
    allow_to_bias as jax_allow_to_bias  # noqa: E402
from npvp_tpu.kernels.temporal_attention import \
    temporal_attention as jax_kernel  # noqa: E402
from npvp_tpu.nn.layers import scaled_dot_product_attention  # noqa: E402
from npvp_tpu_torch.kernels import temporal_attention as ta  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, Tq, Tk, nh, hd, C=None, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    HD = nh * hd
    arr = lambda *s, sc=1.0: (sc * rng.standard_normal(s)  # noqa: E731
                              ).astype(np.float32)
    q, k, v = arr(B, Tq, HD), arr(B, Tk, HD), arr(B, Tk, HD)
    allow = None
    if masked:
        allow = rng.random((Tq, Tk)) > 0.4
        allow[:, 0] = True
    wo = arr(HD, C, sc=0.1) if C else None
    bo = arr(C) if C else None
    return q, k, v, allow, wo, bo


def _port(q, k, v, allow, wo, bo, nh, device="cpu", dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a).to(  # noqa
        device=device, dtype=dtype)
    bias = None if allow is None else ta.allow_to_bias(
        torch.from_numpy(allow).to(device))
    bo_t = None if bo is None else torch.from_numpy(bo).to(device)
    wo_t = None if wo is None else t(np.ascontiguousarray(wo.T))
    return ta.temporal_attention(t(q), t(k), t(v), bias, num_heads=nh,
                                 wo=wo_t, bo=bo_t)


def _jax(q, k, v, allow, wo, bo, nh, block_sites):
    bias = None if allow is None else jax_allow_to_bias(jnp.asarray(allow))
    kw = {} if wo is None else dict(wo=jnp.asarray(wo), bo=jnp.asarray(bo))
    return np.asarray(jax_kernel(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), bias, num_heads=nh,
                                 block_sites=block_sites, **kw))


@pytest.mark.parametrize("masked,Tq,Tk,C", [
    (False, 5, 7, None),   # unmasked, Tq ≠ Tk
    (True, 6, 6, None),    # masked
    (False, 5, 7, 48),     # fused output projection
    (True, 6, 6, 48),      # fused and masked
])
def test_twin_matches_jax_pallas_kernel(masked, Tq, Tk, C):
    args = _inputs(8, Tq, Tk, 4, 16, C, seed=Tq, masked=masked)
    got = _port(*args, nh=4)
    np.testing.assert_allclose(got.numpy(), _jax(*args, nh=4, block_sites=4),
                               **TOL)


def test_twin_fused_equals_separate_projection():
    q, k, v, allow, wo, bo = _inputs(8, 5, 7, 4, 16, 48, seed=3)
    fused = _port(q, k, v, None, wo, bo, nh=4)
    sep = _port(q, k, v, None, None, None, nh=4).numpy() @ wo + bo
    np.testing.assert_allclose(fused.numpy(), sep, **TOL)


def test_ragged_site_count():
    """Any B: 6 sites (not a multiple of a block of 4) against the JAX
    plain attention, which the Pallas kernel refuses for such B."""
    q, k, v, allow, wo, bo = _inputs(6, 4, 5, 2, 8, seed=9, masked=True)
    got = _port(q, k, v, allow, None, None, nh=2)
    h = lambda a, T: jnp.asarray(a).reshape(6, T, 2, 8)  # noqa: E731
    want = scaled_dot_product_attention(h(q, 4), h(k, 5), h(v, 5),
                                        jnp.asarray(allow)[None, None])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(6, 4, 16), **TOL)


def _jax_per_site(q, k, v, allow, nh):
    """The JAX package's plain attention, every site on its own."""
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    h = lambda a, T: jnp.asarray(a).reshape(B, T, nh, HD // nh)  # noqa: E731
    want = scaled_dot_product_attention(h(q, Tq), h(k, Tk), h(v, Tk),
                                        jnp.asarray(allow)[None, None])
    return np.asarray(want).reshape(B, Tq, HD)


@pytest.mark.parametrize("Tq,Tk,row", [(4, 5, 2), (6, 6, 0)])
def test_fully_masked_row_matches_reference_per_site(Tq, Tk, row):
    """A query row whose keys are all masked is uniform over its own site's
    keys, as in npvp_tpu.nn.layers (finfo.min, not -inf, on masked keys)."""
    q, k, v, allow, _, _ = _inputs(6, Tq, Tk, 2, 8, seed=Tq, masked=True)
    allow[row] = False
    got = _port(q, k, v, allow, None, None, nh=2).numpy()
    np.testing.assert_allclose(got, _jax_per_site(q, k, v, allow, 2), **TOL)
    np.testing.assert_allclose(got[:, row], v.mean(axis=1), **TOL)


def _packed_tiles(q, k, v, allow, nh, rows=64):
    """The CUDA kernel's tiling, in numpy: S = rows // max(Tq, Tk) whole
    sites per tile, the last tile padded with zero rows; per head the
    tile's (rows, rows) logits with each site's bias on its diagonal block,
    -inf between sites and past the last packed key, 0 on the rows past the
    last packed query."""
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    hd = HD // nh
    S = rows // max(Tq, Tk)
    tiles = -(-B // S)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((tiles * S - B,) + a.shape[1:], a.dtype)])
    bias = np.where(allow, 0.0, np.finfo(np.float32).min).astype(np.float32)
    mb = np.zeros((rows, rows), np.float32)
    mb[:S * Tq] = -np.inf
    for s in range(S):
        mb[s * Tq:(s + 1) * Tq, s * Tk:(s + 1) * Tk] = bias
    out = np.zeros((tiles, rows, HD), np.float32)
    for t, sl in enumerate(range(0, tiles * S, S)):
        qt, kt, vt = (np.zeros((rows, HD), np.float32) for _ in range(3))
        qt[:S * Tq] = pad(q)[sl:sl + S].reshape(S * Tq, HD)
        kt[:S * Tk] = pad(k)[sl:sl + S].reshape(S * Tk, HD)
        vt[:S * Tk] = pad(v)[sl:sl + S].reshape(S * Tk, HD)
        for h in range(nh):
            c = slice(h * hd, (h + 1) * hd)
            lg = qt[:, c] @ kt[:, c].T / np.sqrt(hd) + mb
            e = np.exp(lg - lg.max(-1, keepdims=True))
            out[t, :, c] = (e / e.sum(-1, keepdims=True)) @ vt[:, c]
    return out[:, :S * Tq].reshape(tiles * S, Tq, HD)[:B]


@pytest.mark.parametrize("B,Tq,Tk,masked_row", [
    (13, 10, 10, None),   # 6 sites in 60 of 64 rows, ragged last tile
    (7, 20, 20, None),    # T = max_T of the KTH configs
    (8, 1, 20, None),     # one query over 20 keys
    (12, 10, 10, 3),      # a query row whose keys are all masked
    (5, 16, 16, 0),       # 4 windows of 16 tokens, ragged last tile
])
def test_packed_tiles_equal_per_site_attention(B, Tq, Tk, masked_row):
    q, k, v, allow, _, _ = _inputs(B, Tq, Tk, 2, 8, seed=B, masked=True)
    if masked_row is not None:
        allow[masked_row] = False
    want = _port(q, k, v, allow, None, None, nh=2).numpy()
    np.testing.assert_allclose(_packed_tiles(q, k, v, allow, 2), want,
                               **TOL)


def test_wo_operand_casts_each_weight_once():
    w = torch.nn.Linear(8, 4).weight
    assert ta.wo_operand(w, torch.float32) is w
    cast = ta.wo_operand(w, torch.bfloat16)
    assert cast.dtype == torch.bfloat16 and cast.is_contiguous()
    assert ta.wo_operand(w, torch.bfloat16) is cast
    with torch.no_grad():
        w.mul_(2.0)  # an in-place update makes a new copy
    fresh = ta.wo_operand(w, torch.bfloat16)
    assert fresh is not cast
    torch.testing.assert_close(fresh, w.detach().to(torch.bfloat16))


def test_allow_to_bias():
    allow = np.array([[True, False], [False, True]])
    np.testing.assert_array_equal(
        ta.allow_to_bias(torch.from_numpy(allow)).numpy(),
        np.asarray(jax_allow_to_bias(jnp.asarray(allow))))
