"""The CUDA temporal-attention kernel against its plain PyTorch twin, on the
card: the cases of tests/test_torch_kernel.py at card sizes (masked and
unmasked, Tq ≠ Tk, fused and attention-only, ragged site counts) and the
edges of the bf16 kernel's 64-row tiles of whole sites (unused rows, T = 20,
one query over 20 keys, a query row whose keys are all masked, C ≠ H·D, a
last tile of one site), fp32 (tol 1e-4) and bf16 (tol 2e-2), with heads of
64 as the bf16 kernel takes them. Every test is marked ``cuda`` and skips
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
