"""The LayerNorm kernel's twin and call sites, on the CPU
(``npvp_tpu_torch/kernels/layer_norm.py``; the kernel itself runs on the
card, ``tests/test_torch_layer_norm_cuda.py``; its op, wrapper and the
kernel-path rule with the other kernels' in
``tests/test_torch_kernel_seam.py``):

- the plain twin is the norms' eager code (and the GELU after
  ``LayerNormHWC``) bit for bit in float32, and within bf16 rounding of it
  in bfloat16, where the twin rounds once and the eager code at each step;
- the call sites: a forward of the flagship's structure (8 decoder and 4
  EVT-Former layers, NPVP-S, at a tiny width) in eval mode under
  ``exec_mode "pallas"`` hands 60 ``LayerNormHWC`` and 66
  ``TokenLayerNorm`` calls to the wrapper (whose CPU side is the twin),
  with outputs bit-equal to the eager norms' in float32; a
  sequence-parallel shard keeps the eager norm.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from npvp_tpu_torch.core.config import Config  # noqa: E402
from npvp_tpu_torch.kernels import layer_norm as ln  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.nn import layers as tl  # noqa: E402

BF16 = torch.bfloat16


def _norm(kind, dtype, exec_mode="xla", seed=0):
    """A norm in eval mode with random affine parameters, and an input."""
    g = torch.Generator().manual_seed(seed)
    if kind == "token":
        mod, shape = tl.TokenLayerNorm(24, 1e-5, dtype, exec_mode), (3, 5, 24)
    else:
        mod, shape = tl.LayerNormHWC((4, 2, 8), exec_mode=exec_mode), (
            6, 4, 2, 8)
    with torch.no_grad():
        mod.weight.copy_(1 + 0.3 * torch.randn(mod.weight.shape, generator=g))
        mod.bias.copy_(0.2 * torch.randn(mod.bias.shape, generator=g))
    # a mean away from 0, so the affine's two terms do not cancel
    x = 0.5 + 2 * torch.randn(shape, generator=g)
    return mod.eval(), x.to(dtype)


CASES = [("token", None), ("hwc", None), ("hwc", "gelu_tanh"),
         ("hwc", "gelu")]


@pytest.mark.parametrize("kind,act", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_twin_is_the_eager_norm(kind, act, dtype):
    mod, x = _norm(kind, dtype)
    with torch.no_grad():
        eager = mod(x)
        if act is not None:  # as MlpDWBN applies it off the kernel path
            eager = F.gelu(eager, approximate="tanh" if act == "gelu_tanh"
                           else "none")
        out_dtype = mod.dtype if kind == "token" else x.dtype
        twin = ln.layer_norm_plain(x, mod.weight, mod.bias, mod.eps,
                                   out_dtype, act or "none")
    assert twin.dtype == eager.dtype == out_dtype
    if dtype == torch.float32:
        assert torch.equal(twin, eager)
        return
    # bf16: the eager code rounds a, b, x·a and the sum (and the GELU's
    # input); the twin rounds once. Bound: a few bf16 ulps (2^-8) of the
    # affine's terms |x·a| + |b|.
    with torch.no_grad():
        exact = ln.layer_norm_plain(x, mod.weight, mod.bias, mod.eps,
                                    torch.float32)
        dims = tuple(range(-mod.weight.dim(), 0))
        xf = x.float()
        inv = torch.rsqrt(xf.var(dims, unbiased=False, keepdim=True) + 1e-5)
        scale = (xf * inv * mod.weight).abs() + (
            mod.bias - xf.mean(dims, keepdim=True) * inv * mod.weight).abs()
    gap = (twin.float() - eager.float()).abs()
    assert bool((gap <= 2 ** -6 * scale + 2 ** -8 * exact.abs()).all())
    assert gap.max() > 0  # the two roundings differ somewhere


@pytest.fixture
def counted(monkeypatch):
    """Every call of the wrapper, counted by the norm that made it."""
    calls = collections.Counter()
    real = ln.layer_norm

    def counting(x, weight, bias, **kw):
        calls["token" if weight.dim() == 1 else "hwc"] += 1
        return real(x, weight, bias, **kw)

    monkeypatch.setattr(ln, "layer_norm", counting)
    return calls


def _flagship_structure(exec_mode):
    """KTH Unified NPVP-S's structure (8 decoder and 4 EVT-Former layers,
    stochastic, 10 → 10 frames) at the tiny test width, float32."""
    cfg = Config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.img_size, d.img_channels = 32, 1
    d.num_past_frames = d.num_future_frames = 10
    a.ngf, a.n_downsampling, a.num_res_blocks = 4, 3, 1
    p.embed_dim, p.num_heads, p.window_size = 32, 4, 2
    p.transformer_layers, p.evt_former_num_layers = 8, 4
    p.dim_feedforward, p.evt_hidden_channels = 64, 16
    p.Spatial_FFN_hidden_ratio = 2
    p.max_T, p.max_H, p.max_W = 20, 4, 4
    p.stochastic, p.exec_mode = True, exec_mode
    cfg.Env.compute_dtype = "float32"
    vp = VideoPredictor.from_random_init(cfg.validate(), torch.float32,
                                         seed=5, device="cpu")
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():  # norms away from their identity init
        for m in vp.predictor.modules():
            if isinstance(m, (tl.TokenLayerNorm, tl.LayerNormHWC)):
                m.weight.mul_(1 + 0.2 * torch.randn(m.weight.shape,
                                                    generator=g))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=g))
    frames = torch.rand((1, 10, 32, 32, 1), generator=g)
    eps = torch.randn((1, 4, 4, 32), generator=g)
    return vp, frames, eps


def test_flagship_forward_calls_the_wrapper_126_times(counted):
    """The kernel path on the CPU against the same model with its norms in
    ``exec_mode "xla"`` (the eager norms; every other module unchanged)."""
    vp, frames, eps = _flagship_structure("pallas")
    fn = vp.freeze_task(np.arange(10), np.arange(10, 20))
    launches = dict(ln.LAUNCHES)
    got = fn(frames, eps=eps)
    assert dict(counted) == {"hwc": 60, "token": 66}
    assert ln.LAUNCHES == launches  # the CPU launches nothing
    for m in vp.predictor.modules():
        if isinstance(m, (tl.TokenLayerNorm, tl.LayerNormHWC)):
            m.exec_mode = "xla"
    counted.clear()
    want = fn(frames, eps=eps)  # the eager norms
    assert not counted
    assert torch.equal(got, want)


def test_a_sequence_parallel_shard_keeps_the_eager_norm(counted,
                                                       monkeypatch):
    """The norms' condition beside ``kernel_path``: a pallas norm in eval
    mode goes to the wrapper, but on a sequence-parallel shard (here an axis
    of one rank, whose sum over the shards is the identity) it keeps the
    eager code, whose statistics are summed over the shards; in training
    mode ``kernel_path`` is shut."""
    from npvp_tpu_torch.core.distributed import AxisShard

    monkeypatch.setattr(tl, "all_reduce_sum", lambda x, shard: x)
    for kind in ("token", "hwc"):
        mod, x = _norm(kind, torch.float32, exec_mode="pallas")
        with torch.no_grad():
            assert tl.kernel_path(mod, x)
            got = mod(x)
            assert counted[kind] == 1
            sharded = mod(x, sp=AxisShard(None, 0, 1))
            assert counted[kind] == 1
            mod.exec_mode = "xla"
            want = mod(x)
        assert torch.equal(got, want)
        torch.testing.assert_close(sharded, want, atol=1e-6, rtol=0)
        mod.exec_mode = "pallas"
        assert not tl.kernel_path(mod.train(), x)
