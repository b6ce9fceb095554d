"""The non-local attention kernel's twin and call site, on the CPU
(``npvp_tpu_torch/kernels/nonlocal_attention.py``; the kernel itself runs on
the card, ``tests/test_torch_nonlocal_attention_cuda.py``; its op, wrapper
and the kernel-path rule with the other kernels' in
``tests/test_torch_kernel_seam.py``):

- the plain twin, which the module's eager path calls, is the module's
  former eager code bit for bit, at one width per (a, dv) class, in float32
  and bfloat16;
- the shapes the kernel takes, and its side raising on the others;
- the call site: a width the kernel does not take reaches the wrapper too
  (whose CPU side is the twin); a Cityscapes-structured encode makes 6
  calls a window and a KTH-structured one 4, with outputs bit-equal to the
  twin's; a stage-2 train step makes none under "xla" and some under
  "pallas";
- ``build_ae`` reads ``cfg.Predictor.exec_mode``, ``VideoPredictor``'s
  override reaches the AE, and the state dict is the same whatever the mode.
"""

import collections

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from npvp_tpu_torch.core.config import Config  # noqa: E402
from npvp_tpu_torch.kernels import nonlocal_attention as nla  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.nn import resnet_ae as tae  # noqa: E402
from npvp_tpu_torch.nn.layers import linear  # noqa: E402
from npvp_tpu_torch.tools.weights import random_init  # noqa: E402

BF16 = torch.bfloat16


def _former_eager_forward(mod, x):
    """``NonLocalAttention2D.forward`` as it was before the kernel, inlined
    (pool, einsums and softmax written out)."""
    a, dt = mod.attn_dim, mod.dtype
    w3 = torch.cat([mod.wq.weight, mod.wk.weight, mod.wv.weight])
    b3 = torch.cat([mod.wq.bias, mod.wk.bias, mod.wv.bias])
    qkv = F.linear(x.to(dt), w3.to(dt), b3.to(dt))
    q, k, v = qkv[..., :a], qkv[..., a:2 * a], qkv[..., 2 * a:]

    def pool(t):
        return F.max_pool2d(t.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

    k, v = pool(k), pool(v)
    logits = torch.einsum("nhwa,nija->nhwij", q.float(),
                          k.float()).to(x.dtype)
    lmax = logits.amax(dim=(-2, -1), keepdim=True)
    e = torch.exp((logits - lmax).float())
    weights = (e / e.sum(dim=(-2, -1), keepdim=True)).to(logits.dtype)
    out = torch.einsum("nhwij,nijv->nhwv", weights, v)
    out = torch.relu(mod.bn(linear(out, mod.out_proj, dt)))
    return x + mod.gamma.to(x.dtype) * out


def _module(channels, dtype, exec_mode="xla", seed=0):
    """A NonLocalAttention2D in eval mode with an open gate and batch
    statistics away from their init, frozen."""
    mod = random_init(tae.NonLocalAttention2D(channels, dtype=dtype,
                                              exec_mode=exec_mode), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        mod.gamma.fill_(0.75)
        mod.bn.running_mean.copy_(0.1 * torch.randn(channels, generator=g))
        mod.bn.running_var.copy_(1 + 0.2 * torch.rand(channels, generator=g))
    return mod.eval().requires_grad_(False)


def _input(shape, dtype, seed=0, scale=2.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dtype)


# one width per (a, dv) class: C = 64, 128, 256, 512 -> (8, 32) .. (64, 256)
WIDTHS = [(64, (2, 8, 8)), (128, (3, 6, 6)), (256, (1, 4, 6)),
          (512, (2, 4, 4))]


@pytest.mark.parametrize("channels,nhw", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_twin_is_the_former_eager_code(channels, nhw, dtype):
    mod = _module(channels, dtype)
    x = _input((*nhw, channels), dtype)
    with torch.no_grad():
        got = mod(x)
        want = _former_eager_forward(mod, x)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


def test_twin_keeps_an_odd_edge_out_of_the_keys():
    """The 2×2 pool drops an odd last row or column, as ``F.max_pool2d``
    does: 5×7 queries over 2×3 keys."""
    a, dv = 8, 32
    qkv = _input((2, 5, 7, 2 * a + dv), BF16, seed=3)
    out = nla.nonlocal_attention_plain(qkv, a)
    assert tuple(out.shape) == (2, 5, 7, dv)
    v = qkv[..., 2 * a:].float()
    pooled = torch.stack([v[:, :4:2, :6:2], v[:, 1:4:2, :6:2],
                          v[:, :4:2, 1:6:2], v[:, 1:4:2, 1:6:2]]).amax(0)
    # each output row is a convex combination of the 6 pooled values
    lo = pooled.amin(dim=(1, 2))[:, None, None]
    hi = pooled.amax(dim=(1, 2))[:, None, None]
    assert bool((out.float() >= lo - 0.02 * hi.abs()).all())
    assert bool((out.float() <= hi + 0.02 * hi.abs()).all())


@pytest.mark.parametrize("shape,attn_dim,ok", [
    ((256, 64, 64, 48), 8, True),       # Cityscapes' first level
    ((640, 32, 32, 96), 16, True),      # KTH's first level
    ((4, 16, 16, 192), 32, True),
    ((4, 8, 8, 384), 64, True),
    ((4, 2, 2, 384), 64, True),         # one pooled key
    ((4, 8, 8, 12), 2, False),          # a tiny width: a = 2
    ((4, 8, 8, 48 + 64), 24, False),    # a = 24
    ((4, 8, 8, 16 + 96), 8, False),     # dv = 96
    ((4, 1, 8, 48), 8, False),          # no pooled key
    ((4, 128, 128, 48), 8, False),      # 4096 keys: beyond shared memory
    ((8, 8, 48), 8, False)])
def test_the_kernel_takes_every_level_of_the_three_aes(shape, attn_dim, ok):
    assert nla.takes(shape, attn_dim) is ok


@pytest.fixture
def counted(monkeypatch):
    """Every call of the wrapper, counted by its query count H·W."""
    calls = collections.Counter()
    real = nla.nonlocal_attention

    def counting(qkv, attn_dim):
        calls[qkv.shape[1] * qkv.shape[2]] += 1
        return real(qkv, attn_dim)

    monkeypatch.setattr(nla, "nonlocal_attention", counting)
    return calls


def test_a_width_the_kernel_does_not_take_reaches_the_wrapper(counted):
    """The kernel path does not look at the shape: a = 2 (C = 16) on it
    goes to the wrapper, whose CPU side is the twin."""
    mod = _module(16, BF16, exec_mode="pallas")
    x = _input((2, 4, 4, 16), BF16)
    with torch.no_grad():
        got = mod(x)
        want = _former_eager_forward(mod, x)
    assert dict(counted) == {16: 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,attn_dim", [
    ((2, 4, 4, 12), 2),            # a = 2
    ((2, 4, 4, 16 + 96), 8),       # dv = 96
    ((2, 1, 8, 48), 8)])           # no pooled key
def test_the_kernel_side_raises_on_a_shape_it_does_not_take(shape,
                                                            attn_dim):
    """``launch`` refuses the shape before it touches a device: no silent
    eager path."""
    qkv = _input(shape, BF16)
    launches = dict(nla.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported shape"):
        nla.launch(qkv, attn_dim)
    assert nla.LAUNCHES == launches


def _ae_config(kind, exec_mode):
    """The AE structure of Cityscapes VFP NPVP-S (ngf 32, 4 downsamplings,
    3 res blocks, colour) or KTH NPVP-S (ngf 64, 3 downsamplings, 2 res
    blocks, grey) at their widths on small frames, and exec_mode."""
    cfg = Config()
    d, a = cfg.Dataset, cfg.AE
    if kind == "cityscapes":
        d.img_size, d.img_channels = 32, 3
        a.ngf, a.n_downsampling, a.num_res_blocks = 32, 4, 3
    else:
        d.img_size, d.img_channels = 32, 1
        a.ngf, a.n_downsampling, a.num_res_blocks = 64, 3, 2
    cfg.Predictor.exec_mode = exec_mode
    return cfg


@pytest.mark.parametrize("kind,calls", [
    ("cityscapes", {256: 1, 64: 1, 16: 1, 4: 3}),
    ("kth", {256: 1, 64: 1, 16: 2})])
def test_an_encode_calls_the_wrapper_once_an_attention(counted, kind, calls):
    """A window's encode of 2 context frames: 6 calls for Cityscapes'
    encoder (three downsampling blocks, three res blocks), 4 for KTH's."""
    ae = random_init(tae.build_ae(_ae_config(kind, "pallas"), BF16), 2)
    for m in ae.modules():
        if isinstance(m, tae.NonLocalAttention2D):
            m.gamma.data.fill_(0.5)
    ae.eval().requires_grad_(False)
    c = 3 if kind == "cityscapes" else 1
    frames = _input((1, 2, 32, 32, c), torch.float32, seed=4, scale=0.5)
    with torch.no_grad():
        got = ae.encode(frames)
    assert dict(counted) == calls
    for m in ae.modules():
        if isinstance(m, tae.NonLocalAttention2D):
            m.exec_mode = "xla"
    with torch.no_grad():
        want = ae.encode(frames)
    assert torch.equal(got, want)


def _nonlocal_modes(ae):
    return {m.exec_mode for m in ae.modules()
            if isinstance(m, tae.NonLocalAttention2D)}


def test_build_ae_reads_the_configs_exec_mode():
    for mode in ("xla", "pallas", "int8"):
        cfg = _ae_config("kth", mode)
        assert _nonlocal_modes(tae.build_ae(cfg)) == {mode}
        assert _nonlocal_modes(tae.build_ae(cfg, exec_mode="xla")) == {"xla"}


def test_the_predictors_override_reaches_the_ae():
    cfg = Config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.img_size, d.img_channels = 16, 1
    d.num_past_frames = d.num_future_frames = 2
    a.ngf, a.n_downsampling, a.num_res_blocks = 4, 2, 1
    p.embed_dim, p.num_heads, p.window_size = 16, 4, 2
    p.transformer_layers = p.evt_former_num_layers = 1
    p.dim_feedforward, p.evt_hidden_channels = 32, 8
    p.Spatial_FFN_hidden_ratio = 2
    p.max_T, p.max_H, p.max_W = 4, 4, 4
    p.exec_mode = "xla"
    cfg.validate()
    vp = VideoPredictor.from_random_init(cfg, torch.float32,
                                         exec_mode="pallas", device="cpu")
    assert _nonlocal_modes(vp.ae) == {"pallas"}
    vp = VideoPredictor.from_random_init(cfg, torch.float32, device="cpu")
    assert _nonlocal_modes(vp.ae) == {"xla"}


def test_the_state_dict_is_the_same_in_every_mode():
    want = list(tae.build_ae(_ae_config("cityscapes", "xla")).state_dict())
    got = list(tae.build_ae(_ae_config("cityscapes", "pallas")).state_dict())
    assert got == want
    assert not [k for k in got if "exec_mode" in k]
    assert sorted(_module(64, BF16, "pallas").state_dict()) == [
        "bn.bias", "bn.running_mean", "bn.running_var", "bn.weight", "gamma",
        "out_proj.bias", "out_proj.weight", "wk.bias", "wk.weight",
        "wq.bias", "wq.weight", "wv.bias", "wv.weight"]


@pytest.mark.parametrize("mode,called", [("xla", False), ("pallas", True)])
def test_a_stage2_train_step(counted, mode, called):
    """A bf16 stage-2 train step at widths the kernel takes (AE ngf 32, two
    downsamplings: attentions at C 64 and 128): under ``exec_mode "xla"``,
    SMMNIST Unified NPVP-S's, the frozen AE never reaches the wrapper;
    under "pallas" its eval-mode encodes do (nothing needs a gradient)."""
    import numpy as np

    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = Config()
    d, a, p = cfg.Dataset, cfg.AE, cfg.Predictor
    d.img_size, d.img_channels = 16, 1
    d.num_past_frames = d.num_future_frames = 4
    d.batch_size, cfg.Env.compute_dtype = 2, "bfloat16"
    a.ngf, a.n_downsampling, a.num_res_blocks = 32, 2, 1
    p.embed_dim, p.num_heads, p.window_size = 128, 4, 2
    p.transformer_layers = p.evt_former_num_layers = 1
    p.dim_feedforward, p.evt_hidden_channels = 64, 16
    p.Spatial_FFN_hidden_ratio = 2
    p.max_T, p.max_H, p.max_W = 8, 4, 4
    p.rand_context, p.min_lo, p.max_lo = True, 2, 6
    p.exec_mode = mode
    cfg.validate()
    ae = random_init(tae.build_ae(cfg, BF16), 3).eval().requires_grad_(False)
    steps = s2.make_steps(cfg, ae, "rand_context", torch.device("cpu"))
    state = s2.init_predictor_state(cfg, build_predictor(cfg, BF16), 1)
    rng = np.random.default_rng(5)
    obs = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    batch = steps.place({"clip": rng.uniform(0, 1, (2, 8, 16, 16, 1)).astype(
        np.float32), "obs_mask": obs, "tgt_mask": ~obs})
    launches = dict(nla.LAUNCHES)
    steps.train(state, batch, Rng(0))
    assert bool(counted) is called
    if called:
        assert set(counted) == {64, 16}
    assert nla.LAUNCHES == launches
