"""The CUDA non-local attention kernel against its plain PyTorch twin, on the
card, at every level the AEs hand it: (H·W, C) = (64², 64), (32², 128),
(16², 256), (8², 512), i.e. (a, dv) = (8, 32) .. (64, 256); an odd batch,
odd and ragged images (a key count that is no multiple of 16, a query
count that fills no tile), logits that reach |50|, the whole Cityscapes and
KTH encodes on the kernel path against the twin path, and the wrapper's
refusals. Every test is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode. No jax here:

    python -m pytest tests/test_torch_nonlocal_attention_cuda.py -m cuda --noconftest

Tolerances. The kernel makes the twin's roundings but one: it rounds each
exp to bf16 and divides the fp32 P·V sum by the row sum, where the twin
rounds each divided weight to bf16. Each way a weight is off by at most
half a bf16 ulp, 2^-8 of itself, and each output is rounded once (2^-8 of
itself), so where the two see the same bf16 logits they differ by at most
2^-6·max|v| (max over the image's values; the twin's P·V runs with
cuBLAS' reduced-precision bf16 reductions off, so that it too sums in
fp32). Where the logits are exact in fp32 (q and k on a grid of quarters:
every partial sum is exact, whatever its order) both round the same
logits, and that bound holds element for element at logits that reach
|50|, where one bf16 ulp of a logit moves its weight by ~28 %: a kernel
that kept fp32 logits, or rounded them elsewhere, moves weights by up to
~13 % there. Where the logits are not exact, tensor cores and cuBLAS sum
them in other orders and a rare logit rounds to the neighbouring bf16
value (~1e-5 of them at the first level of a random test): there at most
1e-3 of the elements may pass the bound, none by more than 0.1·max|v|
(one weight off by e^(ulp), ~6 % at |logit| < 16).
"""

import pytest

torch = pytest.importorskip("torch")

from npvp_tpu_torch.kernels import nonlocal_attention as nla  # noqa: E402

BF16 = torch.bfloat16

# (images, H, W, C): the four levels of the AEs
LEVELS = [(6, 64, 64, 64), (6, 32, 32, 128), (6, 16, 16, 256),
          (6, 8, 8, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    # fp32 sums in the twin's P·V; a float32 encode without TF32
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = mm.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32
    mm.allow_bf16_reduced_precision_reduction = cudnn.allow_tf32 = False
    yield torch.device("cuda")
    mm.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = flags


def _qkv(N, H, W, C, dev, seed=0, exact=False):
    """(N, H, W, 2a + dv) bf16 with a = C/8, dv = C/2. ``exact``: q and k
    on a grid of quarters (q in [-6, 6], k in [-2, 2]), so that every logit
    is exact in fp32 and rows reach |logit| >= 50."""
    a, dv = C // 8, C // 2
    g = torch.Generator(device=dev).manual_seed(seed)
    if exact:
        q = torch.randint(-24, 25, (N, H, W, a), generator=g, device=dev) / 4
        k = torch.randint(-8, 9, (N, H, W, a), generator=g, device=dev) / 4
        v = torch.randn((N, H, W, dv), generator=g, device=dev)
        return torch.cat([q, k, v], -1).to(BF16), a
    return torch.randn((N, H, W, 2 * a + dv), generator=g,
                       device=dev).to(BF16), a


def _vmax(qkv, a):
    """Each image's largest |v| (it bounds the pooled ones)."""
    return qkv[..., 2 * a:].float().abs().amax(dim=(1, 2, 3))[
        :, None, None, None]


def _run(qkv, a):
    with torch.no_grad():
        got = nla.nonlocal_attention(qkv, a)
        want = nla.nonlocal_attention_plain(qkv, a)
    torch.cuda.synchronize()
    return got.float(), want.float()


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C", LEVELS)
def test_exact_logits_reaching_50(cuda, N, H, W, C):
    qkv, a = _qkv(N, H, W, C, cuda, seed=C, exact=True)
    q, k = qkv[..., :a].float(), qkv[..., a:2 * a].float()
    reach = torch.einsum("nhwa,nija->nhwij", q[:1], nla.max_pool_2x2(k[:1]))
    assert reach.abs().max() >= 50
    got, want = _run(qkv, a)
    assert bool(((got - want).abs() <= 2 ** -6 * _vmax(qkv, a)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C", LEVELS + [(5, 32, 32, 128),
                                              (3, 10, 6, 64),
                                              (2, 7, 9, 256),
                                              (4, 2, 2, 512)])
def test_kernel_against_twin(cuda, N, H, W, C):
    """The levels, an odd batch, a ragged 10×6 (15 keys, 60 queries), an
    odd 7×9 (12 keys, edges dropped) and one key."""
    qkv, a = _qkv(N, H, W, C, cuda, seed=N * H + C)
    before = dict(nla.LAUNCHES)
    got, want = _run(qkv, a)
    assert nla.LAUNCHES.get(H * W, 0) == before.get(H * W, 0) + 1
    gap, vmax = (got - want).abs(), _vmax(qkv, a)
    assert gap.shape == (N, H, W, C // 2)
    assert float((gap > 2 ** -6 * vmax).float().mean()) <= 1e-3
    assert bool((gap <= 0.1 * vmax).all())


@pytest.mark.cuda
def test_the_op_is_the_kernel(cuda):
    qkv, a = _qkv(3, 16, 16, 256, cuda, seed=9)
    with torch.no_grad():
        got = torch.ops.npvp.nonlocal_attention(qkv, a)
        want = nla.launch(qkv, a)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_the_wrapper_refuses(cuda):
    qkv, a = _qkv(2, 8, 8, 64, cuda)
    with pytest.raises(ValueError, match="dtype"):
        nla.nonlocal_attention(qkv.float(), a)
    wide = torch.cat([qkv, qkv], -1)[..., :qkv.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        nla.nonlocal_attention(wide, a)
    with pytest.raises(ValueError, match="shape"):
        nla.nonlocal_attention(qkv, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        nla.nonlocal_attention(qkv.float().requires_grad_().to(BF16), a)


def _encoders(name, dev):
    """The config's AE (port YAML, exec_mode pallas) in bf16 and in fp32 on
    one set of random weights with open gates and batch statistics away
    from their init."""
    from pathlib import Path

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.nn import resnet_ae as tae
    from npvp_tpu_torch.tools.weights import random_init

    path = (Path(tae.__file__).resolve().parents[1] / "configs"
            / f"config_{name}.yaml")
    cfg = load_config(path, ["Predictor.exec_mode=pallas"])
    ae32 = random_init(tae.build_ae(cfg, torch.float32), 11)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in ae32.modules():
            if isinstance(m, tae.NonLocalAttention2D):
                m.gamma.fill_(0.5)
                c = m.bn.running_mean.numel()
                m.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.bn.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    ae16 = tae.build_ae(cfg, BF16)
    ae16.load_state_dict(ae32.state_dict())
    return ([m.to(dev).eval().requires_grad_(False) for m in (ae16, ae32)],
            cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name,frames,calls", [
    ("Cityscapes_VFP_NPVP-S", 2, {4096: 1, 1024: 1, 256: 1, 64: 3}),
    ("KTH_Unified_NPVP-S", 4, {1024: 1, 256: 1, 64: 2})])
def test_whole_encode_on_the_kernel_path(cuda, name, frames, calls):
    """The kernel path's encode is no further from the fp32 encode than the
    twin path's, within a quarter (both round at the same places but one,
    each within half a bf16 ulp), and one call an attention."""
    from npvp_tpu_torch.nn import resnet_ae as tae

    (ae, ae32), cfg = _encoders(name, cuda)
    d = cfg.Dataset
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.rand((3, frames, d.img_size, d.img_size, d.img_channels),
                   generator=g, device=cuda) * 2 - 1
    before = dict(nla.LAUNCHES)
    with torch.no_grad():
        got = ae.encode(x).float()
        delta = {k: nla.LAUNCHES[k] - before.get(k, 0) for k in nla.LAUNCHES
                 if nla.LAUNCHES[k] != before.get(k, 0)}
        for m in ae.modules():
            if isinstance(m, tae.NonLocalAttention2D):
                m.exec_mode = "xla"
        twin = ae.encode(x).float()
        exact = ae32.encode(x)
    assert delta == calls
    err_kernel = float((got - exact).norm() / exact.norm())
    err_twin = float((twin - exact).norm() / exact.norm())
    assert err_kernel <= 1.25 * err_twin + 1e-4, (err_kernel, err_twin)
    assert float((got - twin).norm() / twin.norm()) < 2 * err_twin + 1e-4
