"""The CUDA decoder-tail kernel against its plain PyTorch twin, on the card,
at the shapes the published AEs hand it: Cityscapes (1280 frames of
128×128, C_in 32 → 3, Tanh), KTH (640 frames of 64×64, 64 → 1, Tanh),
BAIR's (64 → 3, Tanh) and SMMNIST's (64 → 1, Sigmoid), plus ragged frames
that fill no tile; running statistics and biases away from their init
values; border and corner pixels on their own; the prologue (BatchNorm
affine, ReLU) and the reflected coordinates bit-equal; whole decodes on the
kernel path against the twin path; the wrapper's refusals. Every test is
marked ``cuda`` and skips without an NVIDIA GPU: a CUDA kernel has no CPU
mode. No jax here:

    python -m pytest tests/test_torch_decoder_head_cuda.py -m cuda --noconftest

Tolerance. The kernel makes the twin's roundings; only the order of the
head's fp32 sum differs (tensor-core fragments against cuDNN's). Where the
two fp32 sums fall on either side of a bf16 rounding boundary, the rounded
convolution ``c`` differs by one ulp, at most 2^-7·|c|; adding the bias
and rounding again moves that by at most one ulp of ``v = c + bias``,
2^-7·|v|; Tanh and Sigmoid do not stretch a gap (slopes ≤ 1); the last
rounding of an output in (−1, 1) adds at most 2^-8. Hence
|kernel − twin| ≤ 2^-7·(|c| + |v|) + 2^-8 + 2^-12 element for element,
the 2^-12 for the sums' own order gap where ``c`` is a cancellation near 0.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from npvp_tpu_torch.kernels import decoder_head as dh  # noqa: E402

BF16 = torch.bfloat16

# (frames, H, W, C_in, C_out, out_layer)
PUBLISHED = [(1280, 128, 128, 32, 3, "Tanh"),    # Cityscapes, KITTI
             (640, 64, 64, 64, 1, "Tanh"),       # KTH
             (48, 64, 64, 64, 3, "Tanh"),        # BAIR
             (48, 64, 64, 64, 1, "Sigmoid")]     # SMMNIST
RAGGED = [(3, 37, 45, 32, 3, "Tanh"), (2, 13, 70, 64, 1, "Sigmoid"),
          (5, 4, 4, 32, 1, "Tanh"), (2, 9, 131, 64, 3, "Tanh")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(N, H, W, C, co, dev, seed=0):
    """y as a transposed convolution's output; the BatchNorm's (a, b) from
    running statistics, weight and bias away from their init values, cast
    to bf16 as ``BatchNorm.scale_shift`` casts them; the head's weight and
    bias in bf16 at its init scale."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    y = (0.3 + r(N, H, W, C)).to(BF16)
    mean, var = 0.2 * r(C), 1 + 0.3 * torch.rand((C,), generator=g,
                                                 device=dev)
    weight, bias = 1 + 0.2 * r(C), 0.3 * r(C)
    a = weight * torch.rsqrt(var + 1e-5)
    b = bias - mean * a
    head = (r(co, C, 7, 7) / (49 * C) ** 0.5).to(BF16)
    return y, a.to(BF16), b.to(BF16), head, (0.2 * r(co)).to(BF16)


def _gap_and_bound(got, args, out_layer):
    """|kernel − twin| and the module docstring's bound, elementwise."""
    y, a, b, w, c = args
    x = dh.reflect_pad_2d(torch.relu(y * a + b), 3).permute(0, 3, 1, 2)
    conv = F.conv2d(x, w).permute(0, 2, 3, 1).float()
    v = (conv.to(BF16) + c).float()
    want = dh.decoder_head_plain(y, a, b, w, c, out_layer).float()
    gap = (got.float() - want).abs()
    return gap, 2 ** -7 * (conv.abs() + v.abs()) + 2 ** -8 + 2 ** -12


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,co,out_layer", PUBLISHED + RAGGED)
def test_kernel_against_twin(cuda, N, H, W, C, co, out_layer):
    args = _inputs(N, H, W, C, co, cuda, seed=N + H + C)
    before = dict(dh.LAUNCHES)
    with torch.no_grad():
        got = dh.decoder_head(*args, out_layer)
        torch.cuda.synchronize()
        assert got.shape == (N, H, W, co) and got.is_contiguous()
        assert dh.LAUNCHES.get(H * W, 0) == before.get(H * W, 0) + 1
        # the twin's temporaries at Cityscapes' size: a quarter at a time
        for s in range(0, N, max(1, N // 4)):
            part = tuple(t[s:s + max(1, N // 4)] if i == 0 else t
                         for i, t in enumerate(args))
            gap, bound = _gap_and_bound(got[s:s + max(1, N // 4)], part,
                                        out_layer)
            assert bool((gap <= bound).all()), float((gap - bound).max())
            # border rows and columns (reflected taps) and the corners on
            # their own
            for rows, cols in ((slice(0, 3), slice(None)),
                               (slice(-3, None), slice(None)),
                               (slice(None), slice(0, 3)),
                               (slice(None), slice(-3, None)),
                               (slice(0, 3), slice(0, 3)),
                               (slice(-3, None), slice(-3, None))):
                assert bool((gap[:, rows, cols]
                             <= bound[:, rows, cols]).all())


def _one_hot_heads(C, co, dev):
    """Heads that copy one input channel from one tap each: at k = 0..48,
    output channel o reads channel (7k + 5o) % C from tap (k // 7,
    (k + 2o) % 7); → (head, [(channel, kh, kw) of each o])."""
    for k in range(49):
        w = torch.zeros((co, C, 7, 7), device=dev)
        taps = [((7 * k + 5 * o) % C, k // 7, (k + 2 * o) % 7)
                for o in range(co)]
        for o, (ci, kh, kw) in enumerate(taps):
            w[o, ci, kh, kw] = 1.0
        yield w.to(BF16), taps


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,co", [(4, 16, 70, 32, 3),
                                        (3, 11, 35, 64, 1)])
def test_prologue_and_reflection_bit_equal(cuda, N, H, W, C, co):
    """A head that copies one channel from one tap, with a zero bias, makes
    each output the Tanh of one BatchNorm'd, ReLU'd input pixel at a
    reflected coordinate (its sums hold one nonzero term: exact in any
    order). Held bit for bit against the eager ops on a reflect-padded
    copy, read by indexing (no convolution), at every one of the 49 taps,
    borders and corners included."""
    y, a, b, _, _ = _inputs(N, H, W, C, co, cuda, seed=3)
    zero = torch.zeros((co,), device=cuda, dtype=BF16)
    padded = dh.reflect_pad_2d(torch.relu(y * a + b), 3)
    with torch.no_grad():
        for w, taps in _one_hot_heads(C, co, cuda):
            got = dh.decoder_head(y, a, b, w, zero, "Tanh")
            want = torch.stack([torch.tanh(
                padded[:, kh:kh + H, kw:kw + W, ci])
                for ci, kh, kw in taps], -1)
            assert torch.equal(got, want), taps


@pytest.mark.cuda
def test_the_op_is_the_kernel(cuda):
    args = _inputs(6, 32, 32, 64, 1, cuda, seed=9)
    with torch.no_grad():
        got = torch.ops.npvp.decoder_head(*args, "Sigmoid")
        want = dh.launch(*args, "Sigmoid")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_the_wrapper_refuses(cuda):
    y, a, b, w, c = _inputs(2, 8, 8, 32, 3, cuda)
    with pytest.raises(ValueError, match="dtype"):
        dh.decoder_head(y.float(), a, b, w, c, "Tanh")
    wide = torch.cat([y, y], -1)[..., :32]
    with pytest.raises(ValueError, match="contiguous"):
        dh.decoder_head(wide, a, b, w, c, "Tanh")
    with pytest.raises(ValueError, match="shape"):
        dh.decoder_head(y[..., :16].contiguous(), a[:16].contiguous(),
                        b[:16].contiguous(), w[:, :16].contiguous(), c,
                        "Tanh")
    with pytest.raises(ValueError, match="shape"):
        dh.decoder_head(y, a, b, w, c, "ReLU")
    with pytest.raises(RuntimeError, match="no backward"):
        dh.decoder_head(y, a, b, w.float().requires_grad_().to(BF16), c,
                        "Tanh")


def _decoder(name, dev):
    """The config's AE (port YAML, exec_mode pallas) in bf16 on random
    weights, every BatchNorm's running statistics away from their init."""
    from pathlib import Path

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.nn import resnet_ae as tae
    from npvp_tpu_torch.nn.layers import BatchNorm
    from npvp_tpu_torch.tools.weights import random_init

    path = (Path(tae.__file__).resolve().parents[1] / "configs"
            / f"config_{name}.yaml")
    cfg = load_config(path, ["Predictor.exec_mode=pallas"])
    ae = random_init(tae.build_ae(cfg, BF16), 11)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in ae.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    return ae.to(dev).eval().requires_grad_(False), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name,clips", [("Cityscapes_VFP_NPVP-S", 8),
                                        ("KTH_Unified_NPVP-S", 8),
                                        ("SMMNIST_Unified_NPVP-S", 4)])
def test_whole_decode_on_the_kernel_path(cuda, name, clips):
    """One launch a decode; the frames within the tolerance's bound for
    outputs of Tanh or Sigmoid, whose slope is at most 1 (and below 2^-4
    where |v| > 2): 2^-6 + 2^-8 + 2^-12."""
    ae, cfg = _decoder(name, cuda)
    size, down = cfg.Dataset.img_size, cfg.AE.n_downsampling
    g = torch.Generator(device=cuda).manual_seed(13)
    feats = torch.relu(torch.randn(
        (clips, 10, size >> down, size >> down, cfg.AE.ngf << down),
        generator=g, device=cuda))
    before = dict(dh.LAUNCHES)
    with torch.no_grad():
        got = ae.decode(feats).float()
        launched = dh.LAUNCHES.get(size * size, 0) - before.get(
            size * size, 0)
        ae.decoder.exec_mode = "xla"
        want = ae.decode(feats).float()
    assert launched == 1
    assert got.shape == want.shape == (clips, 10, size, size,
                                       cfg.Dataset.img_channels)
    assert float((got - want).abs().max()) <= 2 ** -6 + 2 ** -8 + 2 ** -12
