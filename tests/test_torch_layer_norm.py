"""The LayerNorm kernel's wrapper, op and call sites, on the CPU
(``npvp_tpu_torch/kernels/layer_norm.py``; the kernel itself runs on the
card, ``tests/test_torch_layer_norm_cuda.py``):

- the plain twin is the norms' eager code (and the GELU after
  ``LayerNormHWC``) bit for bit in float32, and within bf16 rounding of it
  in bfloat16, where the twin rounds once and the eager code at each step;
- the op's CPU implementation is the twin, its fake implementation gives
  the output's shape and dtype, and ``torch.export`` keeps the op in the
  graph; the wrapper refuses inputs that need a gradient;
- the call sites: a forward of the flagship's structure (8 decoder and 4
  EVT-Former layers, NPVP-S, at a tiny width) in eval mode under
  ``exec_mode "pallas"`` hands 60 ``LayerNormHWC`` and 66
  ``TokenLayerNorm`` calls to the wrapper, with outputs bit-equal to the
  eager norms' in float32; in training mode, under ``xla`` and ``int8``
  and on a sequence-parallel shard it is never called.

The tests reach the wrapper on the CPU by adding "cpu" to
``layer_norm.DEVICES`` (the CUDA-only gate of the call sites).
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


def test_op_cpu_and_fake_implementations():
    from torch._subclasses.fake_tensor import FakeTensorMode

    mod, x = _norm("hwc", BF16)
    with torch.no_grad():
        got = torch.ops.npvp.layer_norm(x, mod.weight, mod.bias, 1e-5,
                                        torch.float32, "gelu_tanh")
        want = ln.layer_norm_plain(x, mod.weight, mod.bias, 1e-5,
                                   torch.float32, "gelu_tanh")
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        fw, fb = mode.from_tensor(mod.weight), mode.from_tensor(mod.bias)
        out = torch.ops.npvp.layer_norm(fx, fw, fb, 1e-5, torch.float32,
                                        "none")
    assert tuple(out.shape) == tuple(x.shape)
    assert out.dtype == torch.float32


def test_wrapper_refuses_autograd():
    mod, x = _norm("token", torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        ln.layer_norm(x, mod.weight, mod.bias, eps=1e-5,
                      out_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        ln.layer_norm(x.requires_grad_(), mod.weight.detach(),
                      mod.bias.detach(), eps=1e-5, out_dtype=torch.float32)


@pytest.fixture
def counted(monkeypatch):
    """The call sites' gate opened to the CPU, and every call of the
    wrapper counted by the norm that made it."""
    calls = collections.Counter()
    real = ln.layer_norm

    def counting(x, weight, bias, **kw):
        calls["token" if weight.dim() == 1 else "hwc"] += 1
        return real(x, weight, bias, **kw)

    monkeypatch.setattr(ln, "DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(ln, "layer_norm", counting)
    return calls


def test_export_keeps_the_op(counted):
    from npvp_tpu_torch.nn.vidhrformer import MlpDWBN

    mlp = MlpDWBN(8, 16, 8, (4, 2), exec_mode="pallas").eval()
    x = torch.randn(2, 3, 4, 2, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        program = torch.export.export(mlp, (x,))
        want = mlp(x)
    calls = [n for n in program.graph.nodes
             if n.op == "call_function" and "layer_norm" in str(n.target)]
    assert len(calls) == 3
    assert torch.equal(program.module()(x), want)


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


def test_flagship_forward_calls_the_wrapper_126_times(counted, monkeypatch):
    vp, frames, eps = _flagship_structure("pallas")
    fn = vp.freeze_task(np.arange(10), np.arange(10, 20))
    launches = dict(ln.LAUNCHES)
    got = fn(frames, eps=eps)
    assert dict(counted) == {"hwc": 60, "token": 66}
    assert ln.LAUNCHES == launches  # the CPU launches nothing
    monkeypatch.setattr(ln, "DEVICES", ("cuda",))
    counted.clear()
    want = fn(frames, eps=eps)  # the eager norms
    assert not counted
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["train", "xla", "int8"])
def test_the_wrapper_is_never_called_off_the_kernel_path(counted, mode):
    vp, frames, eps = _flagship_structure("xla" if mode == "xla" else
                                          "int8" if mode == "int8" else
                                          "pallas")
    if mode == "train":
        vp.predictor.train().requires_grad_(True)
        feats = vp.ae.encode(frames)
        from npvp_tpu_torch.models.coords import coordinate_grid

        oc, tc = (coordinate_grid(np.arange(a, a + 10), vp.h_list,
                                  vp.w_list, 20, 4, 4) for a in (0, 10))
        out = vp.predictor(feats, oc, tc, eps, rng=tl.Rng(1))
        out.pred_features.sum().backward()
    else:
        vp.predict(frames, np.arange(10), np.arange(10, 20), eps=eps)
    assert not counted


def test_a_sequence_parallel_shard_keeps_the_eager_norm(counted):
    """The gate the norms consult before the wrapper: open for a pallas
    norm in eval mode (the CPU let in), shut for any sequence-parallel
    axis, whose statistics are summed over the shards in the eager code."""
    for kind in ("token", "hwc"):
        mod, x = _norm(kind, torch.float32, exec_mode="pallas")
        assert tl.norm_kernel_path(mod, x, None)
        assert not tl.norm_kernel_path(mod, x, object())
        assert not tl.norm_kernel_path(mod.train(), x, None)
