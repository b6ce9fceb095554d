"""The AE's variants in the port against npvp_tpu's, fp32 on the CPU:

- ``learn_3d`` (temporal conv1d, BatchNorm, 1-D non-local attention in
  every factorized block): encode/decode in eval mode (atol 1e-4); one
  train step of the port's stage-1 trainer from the same variables, the
  gates closed as flax initialises them: the loss (rtol 1e-5), the
  gradients (tests/test_torch_stage1.py's bound) and every BatchNorm's
  running statistics after it (atol 1e-6, rtol 1e-5); with every gate
  open, the gradients in float64 (atol 1e-5 of the largest);
- the decoder's ``s2d_head`` and ``subpixel`` forms against JAX's on the
  same variables (atol 1e-4) and against the port's direct head and
  ConvTranspose on the same weights (atol 1e-5: one function, sums taken
  in another order); the warning and the direct head where the padded
  frame side is not 2 mod 4;
- ``npvp_tpu_torch.nn.upsample`` against ``npvp_tpu.nn.upsample``.
"""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import (port_config, random_variables,  # noqa: E402
                            tiny_config)

from npvp_tpu.nn import resnet_ae as jae  # noqa: E402
from npvp_tpu.nn import upsample as jup  # noqa: E402
from npvp_tpu_torch.nn import resnet_ae as tae  # noqa: E402
from npvp_tpu_torch.nn import upsample as tup  # noqa: E402
from npvp_tpu_torch.tools.weights import (load_flax, random_init,  # noqa
                                          to_flax)

TOL = dict(atol=1e-4, rtol=0)
KW = dict(img_channels=1, ngf=4, n_downsampling=2, num_res_blocks=1)


def _clip(n=2, t=3, size=16, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, t, size, size, 1)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_learn_3d_encode_decode_matches_jax():
    x = _clip()
    mod = jae.FrameAutoEncoder(learn_3d=True, **KW)
    variables = random_variables(mod.init, jax.random.key(0), x, seed=1)
    assert "temporal_conv" in variables["params"]["encoder"]["res_attn_0"]
    port = load_flax(tae.FrameAutoEncoder(learn_3d=True, **KW),
                     variables).eval()
    want_rec, want_feats = mod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        rec, feats = port(_t(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), **TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), **TOL)


def test_learn_3d_random_init_and_build():
    """``build_ae`` takes ``AE.learn_3d`` and ``AE.s2d_head``; the random
    init gives the temporal attention's gate zero, as flax's does."""
    cfg = port_config(tiny_config())
    cfg.AE.learn_3d = cfg.AE.s2d_head = True
    ae = random_init(tae.build_ae(cfg), 0)
    assert ae.decoder.s2d_head
    blocks = [m for m in ae.modules()
              if isinstance(m, tae.Factorized3DConvAttn)]
    assert blocks and all(b.learn_3d for b in blocks)
    assert all(float(b.attn1d.gamma.detach()) == 0.0 for b in blocks)
    assert all(b.temporal_conv.weight.std() > 0 for b in blocks)


def _learn_3d_setup(seed):
    """A tiny learn_3d AE config (batch 2, fp32), its JAX module, random
    variables and a clip of 8 frames."""
    cfg = tiny_config()
    cfg.Dataset.batch_size, cfg.Env.compute_dtype = 2, "float32"
    cfg.AE.learn_3d = True
    cfg.validate()
    mod = jae.FrameAutoEncoder(img_channels=1, ngf=cfg.AE.ngf,
                               n_downsampling=cfg.AE.n_downsampling,
                               num_res_blocks=cfg.AE.num_res_blocks,
                               learn_3d=True)
    clip = np.random.default_rng(5).uniform(0, 1, (2, 8, 32, 32, 1)).astype(
        np.float32)
    variables = random_variables(mod.init, jax.random.key(0), clip,
                                 seed=seed)
    return cfg, mod, variables, clip


def _jax_l1_step(mod, variables, clip, dtype=jnp.float32):
    """JAX's L1 loss, gradients and BatchNorm update in training mode."""
    from npvp_tpu.nn.losses import l1_loss as jl1

    cast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), t)

    @jax.jit
    def step(params):
        def loss_fn(params):
            (rec, _), mut = mod.apply(
                {"params": params,
                 "batch_stats": cast(variables["batch_stats"])},
                jnp.asarray(clip, dtype), train=True,
                mutable=["batch_stats"])
            return jl1(rec, jnp.asarray(clip, dtype)), mut["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss, stats), grads = step(cast(variables["params"]))
    return float(loss), jax.tree.map(np.asarray, stats), jax.tree.map(
        np.asarray, grads)


def test_learn_3d_train_step_matches_jax():
    """One step of the port's stage-1 trainer on a learn_3d AE whose gates
    start at zero, as flax initialises them: the loss, the gradients every
    update receives (the temporal conv's, its BatchNorm's and the gates'
    included; tests/test_torch_stage1.py's bound) and every BatchNorm's
    running statistics after the step, against JAX's from the same
    variables."""
    from npvp_tpu_torch.train import stage1_ae as s1

    cfg, mod, variables, clip = _learn_3d_setup(seed=2)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 0 if "gamma" in jax.tree_util.keystr(path)
        else v, variables)
    loss, stats, grads = _jax_l1_step(mod, variables, clip)

    tcfg = port_config(cfg)
    model = tae.build_ae(tcfg)
    state = s1.init_state(tcfg, model)
    load_flax(model, variables)
    captured = {}
    apply = state.apply_gradients

    def capture():  # the gradients the trainer's update receives
        captured.update({n: p.grad.clone()
                         for n, p in model.named_parameters()})
        apply()

    state.apply_gradients = capture
    steps = s1.make_steps("cpu")
    got = float(steps.train(state, steps.place(
        {"past": clip[:, :4], "future": clip[:, 4:]}))["L1_loss_train"])
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    want_grads = dict(load_flax(tae.build_ae(tcfg), {
        "params": grads, "batch_stats": variables["batch_stats"]}
    ).named_parameters())
    assert float(captured["encoder.res_attn_0.temporal_conv.weight"]
                 .abs().max()) > 0
    assert float(captured["encoder.res_attn_0.attn1d.gamma"].abs()) > 0
    for name, g in captured.items():
        want = want_grads[name].detach().numpy()
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-3,
            atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=name)
    want_stats = to_flax(load_flax(tae.build_ae(tcfg), {
        "params": variables["params"], "batch_stats": stats}))
    got_stats = to_flax(model)
    leaves = jax.tree_util.tree_leaves_with_path(want_stats["batch_stats"])
    assert any("temporal_bn" in jax.tree_util.keystr(p) for p, _ in leaves)
    for path, want in leaves:
        node = got_stats["batch_stats"]
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, want, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_learn_3d_gradients_with_open_gates_match_jax(monkeypatch):
    """With every attention gate open, the gradients of the whole learn_3d
    AE (the 1-D attention's projections included) against JAX's, both in
    float64 with float64 BatchNorm statistics: atol 1e-5 of the model's
    largest gradient (the logits and softmax sums stay float32 in both).
    In float32 the two packages' batch statistics, E[x²] − E[x]² over
    features whose mean dwarfs their spread, keep only a few digits, and
    their gradients part by up to ~1 % (both packages alike), which is
    rounding, not the function."""
    import npvp_tpu.nn.layers as jl

    import npvp_tpu_torch.nn.layers as tl

    def jax_moments(x, axes, keepdims=True):
        x = x.astype(jnp.float64)
        mean = jnp.mean(x, axis=axes, keepdims=keepdims)
        return mean, jnp.maximum(jnp.mean(x * x, axis=axes,
                                          keepdims=keepdims) - mean ** 2, 0)

    def port_moments(x, dims, keepdim=True):
        x = x.double()
        mean = x.mean(dim=dims, keepdim=keepdim)
        return mean, torch.clamp((x * x).mean(dim=dims, keepdim=keepdim)
                                 - mean * mean, min=0.0)

    monkeypatch.setattr(jl, "fp32_moments", jax_moments)
    monkeypatch.setattr(tl, "fp32_moments", port_moments)
    cfg, _, variables, clip = _learn_3d_setup(seed=3)
    a = cfg.AE
    with jax.enable_x64(True):
        mod = jae.FrameAutoEncoder(img_channels=1, ngf=a.ngf,
                                   n_downsampling=a.n_downsampling,
                                   num_res_blocks=a.num_res_blocks,
                                   learn_3d=True, dtype=jnp.float64)
        _, _, grads = _jax_l1_step(mod, variables, clip, jnp.float64)
    model = load_flax(tae.FrameAutoEncoder(
        1, a.ngf, a.n_downsampling, a.num_res_blocks, learn_3d=True,
        dtype=torch.float64), variables).double().train()
    x = torch.from_numpy(clip).double()
    (model(x)[0] - x).abs().mean().backward()
    flat = jax.tree_util.tree_leaves_with_path(grads)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(to_flax(_grads_of(model)))}
    assert "attn1d" in " ".join(got)
    largest = max(np.abs(g).max() for _, g in flat)
    for path, g in flat:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got["['params']" + key], g, rtol=0,
                                   atol=1e-5 * largest, err_msg=key)


def _grads_of(model):
    """A float64 copy of ``model`` whose parameters hold their gradients."""
    import copy

    out = copy.deepcopy(model)
    with torch.no_grad():
        for (_, p), (_, q) in zip(out.named_parameters(),
                                  model.named_parameters()):
            p.copy_(q.grad)
    return out


def _decoder_pair(variant, size=4, n_down=2, seed=3):
    """A JAX ResnetDecoder with ``variant`` set, its variables, the port's
    decoder with the same variant and the port's plain decoder on them."""
    feats = np.abs(np.random.default_rng(seed).standard_normal(
        (2, 3, size, size, 4 * 2 ** n_down))).astype(np.float32)
    mod = jae.ResnetDecoder(out_channels=1, ngf=4, n_downsampling=n_down,
                            **{variant: True})
    variables = random_variables(mod.init, jax.random.key(0), feats,
                                 seed=seed)
    port = load_flax(tae.ResnetDecoder(1, 4, n_down, **{variant: True}),
                     variables).eval()
    plain = load_flax(tae.ResnetDecoder(1, 4, n_down), variables).eval()
    return feats, mod, variables, port, plain


@pytest.mark.parametrize("variant", ["s2d_head", "subpixel"])
def test_decoder_variant_matches_jax_and_its_direct_form(variant):
    feats, mod, variables, port, plain = _decoder_pair(variant)
    want = np.asarray(mod.apply(variables, jnp.asarray(feats)))
    with torch.no_grad():
        got, direct = port(_t(feats)), plain(_t(feats))
    assert got.shape == (2, 3, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


def test_s2d_head_warns_and_takes_the_direct_head():
    """One upsampling of 3×3 features gives frames of 6, padded to 12,
    which is not 2 mod 4 (frames a multiple of 4 pad to 2 mod 4): the
    direct head runs, loudly, in both packages."""
    feats, mod, variables, port, plain = _decoder_pair("s2d_head", size=3,
                                                       n_down=1)
    with pytest.warns(UserWarning, match="not 2 mod 4"):
        with torch.no_grad():
            got = port(_t(feats))
    with torch.no_grad():
        np.testing.assert_array_equal(got.numpy(), plain(_t(feats)).numpy())
    with pytest.warns(UserWarning, match="not 2 mod 4"):
        want = np.asarray(mod.apply(variables, jnp.asarray(feats)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("H,W,I,O", [(8, 8, 16, 8), (5, 7, 4, 6)])
def test_subpixel_conv_transpose_matches_jax(H, W, I, O):
    """The flax kernel (3, 3, O, I) is the port's ConvTranspose2d weight
    (I, O, 3, 3) transposed."""
    rng = np.random.default_rng(H)
    x = rng.standard_normal((2, H, W, I)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, O, I)).astype(np.float32)
    want = jup.subpixel_conv_transpose_3x3_s2(jnp.asarray(x),
                                              jnp.asarray(kernel))
    got = tup.subpixel_conv_transpose_3x3_s2(
        _t(x), _t(kernel.transpose(3, 2, 0, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_subpixel_conv_same_matches_jax(factor):
    rng = np.random.default_rng(factor)
    x = rng.standard_normal((2, 14, 18, 5)).astype(np.float32)
    kernel = rng.standard_normal((7, 7, 5, 3)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    want = jup.subpixel_conv_same(jnp.asarray(x), jnp.asarray(kernel),
                                  jnp.asarray(bias), factor)
    got = tup.subpixel_conv_same(_t(x), _t(kernel.transpose(3, 2, 0, 1)),
                                 _t(bias), factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        tup.subpixel_conv_same(_t(x[:, :13]), _t(kernel.transpose(
            3, 2, 0, 1)), factor=factor)
