"""The CUDA LayerNorm kernel against its plain PyTorch twin, on the card, at
the shapes the main path hands it: batch 64 (640 rows of 131072 and of
32768, the conv FFN's (H, W, C) norms over the hidden width and over C;
40960 rows of 512, the token norms) and batch 1 (10 rows of each long
length, 640 of 512), plus a ragged long row and a short row that fills no
lane; fp32 and bf16 in and out, with and without the GELU epilogue. The
launch counter steps by one a call, and a shape the kernel does not take
raises. Every test is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode. No jax here:

    python -m pytest tests/test_torch_layer_norm_cuda.py -m cuda --noconftest

Tolerances. fp32 out: 1e-5 + 1e-5·|y| — the kernel sums each row in
another order than PyTorch's reductions (tree of shuffles and, for long
rows, of blocks), fuses x·a + c into one FMA and takes rsqrtf; with rows
of 10⁵ elements and a mean of 0.5 next to a spread of 2 the statistics
agree to a few 1e-7 relative. bf16 out: one bf16 ulp of the output (at
most 2^-7 of it) plus 1e-5: both round a value once, and the fp32 gaps
above move it across a rounding boundary at most once.
"""

import pytest

torch = pytest.importorskip("torch")

from npvp_tpu_torch.kernels import layer_norm as ln  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(rows, affine, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (0.5 + 2 * torch.randn((rows, *affine), generator=g, device=dev))
    w = 1 + 0.3 * torch.randn(affine, generator=g, device=dev)
    b = 0.2 * torch.randn(affine, generator=g, device=dev)
    return x.to(dtype), w, b


SHAPES = [(640, (8, 8, 2048)),    # batch 64, the hidden (H, W, C) norms
          (640, (8, 8, 512)),     # batch 64, the FFN's output norm
          (40960, (512,)),        # batch 64, the token norms
          (10, (8, 8, 2048)),     # batch 1
          (10, (8, 8, 512)),
          (640, (512,)),
          (33, (3, 5, 1800)),     # a long row split unevenly: 2 blocks
          (7, (40,))]             # a short row that fills no lane


@pytest.mark.cuda
@pytest.mark.parametrize("rows,affine", SHAPES)
@pytest.mark.parametrize("dtype,out_dtype", [(F32, F32), (BF16, BF16),
                                             (F32, BF16), (BF16, F32)])
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu"])
def test_kernel_matches_twin(cuda, rows, affine, dtype, out_dtype, act):
    x, w, b = _inputs(rows, affine, dtype, cuda, seed=rows)
    with torch.no_grad():
        got = ln.layer_norm(x, w, b, eps=1e-5, out_dtype=out_dtype, act=act)
        want = ln.layer_norm_plain(x, w, b, 1e-5, out_dtype, act)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == x.shape
    got, want = got.float(), want.float()
    rel = 2 ** -7 if out_dtype == BF16 else 1e-5
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-5 + rel * want.abs()).all()), (
        (got - want).abs().max().item())


@pytest.mark.cuda
def test_launch_counter_steps_by_one(cuda):
    before = dict(ln.LAUNCHES)
    for affine, key in (((8, 8, 512), "hwc"), ((512,), "token")):
        x, w, b = _inputs(4, affine, BF16, cuda)
        with torch.no_grad():
            ln.layer_norm(x, w, b, eps=1e-5, out_dtype=BF16)
        before[key] += 1
        assert ln.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["length", "ragged", "long", "strided",
                                  "dtype", "grad"])
def test_refused_inputs_raise(cuda, case):
    x, w, b = _inputs(4, (8, 8, 512), BF16, cuda)
    if case == "length":  # rows of 12 bf16: not a whole 16-byte vector
        x, w, b = _inputs(4, (12,), BF16, cuda)
    elif case == "ragged":  # the affine matches no trailing axes
        w, b = w[:4], b[:4]
    elif case == "long":  # a row past a cluster of 16 blocks
        x, w, b = _inputs(1, (ln.MAX_LEN + 8,), BF16, cuda)
    elif case == "strided":
        x = x.transpose(1, 2)
    elif case == "dtype":
        x = x.half()
    if case == "grad":
        w.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ln.layer_norm(x, w, b, eps=1e-5, out_dtype=BF16)
        return
    with pytest.raises(ValueError), torch.no_grad():
        ln.layer_norm(x, w, b, eps=1e-5, out_dtype=BF16)
