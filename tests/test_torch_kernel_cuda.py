"""The CUDA temporal-attention kernel against its plain PyTorch twin, on the
card: the cases of tests/test_torch_kernel.py at card sizes (masked and
unmasked, Tq ≠ Tk, fused and attention-only, ragged site counts) and the
edges of the bf16 kernel's 64-row tiles of whole sites (unused rows, T = 20,
one query over 20 keys, a query row whose keys are all masked, C ≠ H·D, a
last tile of one site), the shapes and masks of the stage-2 trainer's eval
step at the SMMNIST config (T = 15, per-batch observed/target masks), fp32
(tol 1e-4) and bf16 (tol 2e-2), with heads of 64 as the bf16 kernel takes
them; and the wrapper's refusal of inputs that need a gradient. Every test is marked ``cuda`` and skips
without an NVIDIA GPU: a CUDA kernel has no CPU mode. No jax here, so the
file runs where only torch is installed:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest
"""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from npvp_tpu_torch.kernels import temporal_attention as ta  # noqa: E402


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
        if masked == "row":  # the first query row sees no key
            allow[0] = False
    wo = arr(C, HD, sc=0.1) if C else None
    bo = arr(C) if C else None
    return q, k, v, allow, wo, bo


def _port(q, k, v, allow, wo, bo, nh, device, dtype):
    t = lambda a: None if a is None else torch.from_numpy(a).to(  # noqa
        device=device, dtype=dtype)
    bias = None if allow is None else ta.allow_to_bias(
        torch.from_numpy(allow).to(device))
    bo_t = None if bo is None else torch.from_numpy(bo).to(device)
    return ta.temporal_attention(t(q), t(k), t(v), bias, num_heads=nh,
                                 wo=t(wo), bo=bo_t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Tq,Tk,masked,C", [
    (64, 10, 10, True, 64),      # 6 sites in 60 of 64 rows, C ≠ H·D
    (67, 10, 7, False, 64),      # Tq ≠ Tk
    (33, 16, 16, False, None),   # windows of 16
    (5, 1, 20, True, None),      # one query over 20 keys
    (7, 1, 20, True, 96),        # the same, fused
    (40, 20, 20, True, 96),      # T = 20, the KTH configs' max_T
    (30, 10, 10, "row", 256),    # a query row whose keys are all masked
    (30, 16, 16, "row", None),
    (13, 10, 10, True, 520),     # a last tile of one site; C past 512
    (13, 10, 10, False, None)])
def test_cuda_kernel_matches_twin(cuda, dtype, tol, B, Tq, Tk, masked, C):
    args = _inputs(B, Tq, Tk, 4, 64, C, seed=B, masked=masked)
    before = dict(ta.LAUNCHES)
    got = _port(*args, nh=4, device=cuda, dtype=dtype)
    torch.cuda.synchronize()
    key = "attn" if C is None else "oproj"
    assert ta.LAUNCHES[key] == before[key] + 1
    t = lambda a: None if a is None else torch.from_numpy(a).to(  # noqa
        device=cuda, dtype=dtype)
    q, k, v, allow, wo, bo = args
    bias = None if allow is None else ta.allow_to_bias(
        torch.from_numpy(allow).to(cuda))
    want = ta.temporal_attention_plain(
        t(q), t(k), t(v), bias, num_heads=4, wo=t(wo),
        bo=None if bo is None else torch.from_numpy(bo).to(cuda))
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_kernel_casts_an_fp32_weight_once(cuda):
    """A bf16 call with nn.Linear's fp32 weight: the kernel reads one cached
    bf16 copy, and agrees with the twin."""
    q, k, v, allow, wo, bo = _inputs(24, 10, 10, 2, 64, 128, seed=5,
                                     masked=True)
    lin = torch.nn.Linear(128, 128).to(cuda)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(wo))
    t = lambda a: torch.from_numpy(a).to(cuda, torch.bfloat16)  # noqa
    bias = ta.allow_to_bias(torch.from_numpy(allow).to(cuda))
    kw = dict(num_heads=2, wo=lin.weight, bo=lin.bias)
    with torch.no_grad():  # the weight requires grad; the kernel has no VJP
        got = ta.temporal_attention(t(q), t(k), t(v), bias, **kw)
        again = ta.temporal_attention(t(q), t(k), t(v), bias, **kw)
        want = ta.temporal_attention_plain(t(q), t(k), t(v), bias, **kw)
    assert ta.wo_operand(lin.weight, torch.bfloat16) is ta.wo_operand(
        lin.weight, torch.bfloat16)
    torch.testing.assert_close(got, again, atol=0, rtol=0)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_input(cuda):
    q = torch.zeros(4, 65, 8, device=cuda)
    with pytest.raises(ValueError, match="unsupported shape"):
        ta.temporal_attention(q, q, q, num_heads=2)
    with pytest.raises(ValueError, match="dtype"):
        ta.temporal_attention(q.half()[:, :4], q.half()[:, :4],
                              q.half()[:, :4], num_heads=2)
    h32 = torch.zeros(4, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported shape"):  # heads of 32
        ta.temporal_attention(h32, h32, h32, num_heads=2)


# the stage-2 eval step at the SMMNIST config (batch 8, max_T 15, 8 × 8
# sites, 8 heads of 64): windows, the EVT-Former's temporal attention with
# the observed frames' allow matrix, the decoder's self-attention over the
# target frames, and its cross-attention over the observed ones
OBS15 = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0], bool)


def _eval_allow(kind):
    from npvp_tpu_torch.nn.vidhrformer import encoder_temporal_allow

    obs = torch.from_numpy(OBS15)
    if kind == "encoder":
        return encoder_temporal_allow(15, obs)
    if kind == "decoder_self":
        return (~obs)[None, :].expand(15, 15)
    return obs[None, :].expand(15, 15)  # cross


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("B,T,kind", [(480, 16, None),
                                      (512, 15, "encoder"),
                                      (512, 15, "decoder_self"),
                                      (512, 15, "cross")])
def test_cuda_kernel_at_eval_step_shapes(cuda, dtype, tol, fuse, B, T, kind):
    q, k, v, _, wo, bo = _inputs(B, T, T, 8, 64, 512 if fuse else None,
                                 seed=B + T)
    t = lambda a: None if a is None else torch.from_numpy(a).to(  # noqa
        device=cuda, dtype=dtype)
    bias = None if kind is None else ta.allow_to_bias(
        _eval_allow(kind).to(cuda))
    kw = dict(num_heads=8, wo=t(wo),
              bo=None if bo is None else torch.from_numpy(bo).to(cuda))
    got = ta.temporal_attention(t(q), t(k), t(v), bias, **kw)
    want = ta.temporal_attention_plain(t(q), t(k), t(v), bias, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_autograd(cuda):
    """The kernel has no backward: inputs that need a gradient raise rather
    than come back without one; under no_grad the same call runs."""
    q = torch.randn(8, 10, 128, device=cuda, requires_grad=True)
    lin = torch.nn.Linear(128, 128).to(cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ta.temporal_attention(q, q, q, num_heads=2)
    x = q.detach()
    with pytest.raises(RuntimeError, match="no backward"):
        ta.temporal_attention(x, x, x, num_heads=2, wo=lin.weight,
                              bo=lin.bias)
    with torch.no_grad():
        out = ta.temporal_attention(x, x, x, num_heads=2, wo=lin.weight,
                                    bo=lin.bias)
    assert out.shape == (8, 10, 128) and not out.requires_grad
