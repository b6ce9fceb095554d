"""The port's model tools against npvp_tpu's, on the CPU:

- the weights writer (``npvp_tpu_torch.tools.weights.save_weights``): the
  archive the port writes equals, key by key, the one JAX writes from the
  same variables, and each package serves the other's archive with the
  same outputs (fp32, atol 1e-4); float16 storage and the float32 kept for
  large magnitudes; ``warm_start_state``; the export CLI;
- the reference-checkpoint converter (``npvp_tpu_torch.tools.
  torch_converter``): its leaf helpers against torch's layers (atol 1e-5,
  LayerNorm 1e-4), a Lightning checkpoint holding an object of a class
  that is not installed, and whole models from a synthetic state dict in
  the reference's key names (``_torch_helpers.reference_*_state_dict``):
  the JAX converter gives those variables back exactly, the port's
  converter gives what JAX's does, and the port's AE, NPVP-D and NPVP-S on
  the converted weights match JAX's forwards at atol 1e-4.
"""

import pickle
import sys
import types

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import (port_config, random_variables,  # noqa: E402
                            reference_ae_state_dict, reference_i3d_state_dict,
                            reference_predictor_state_dict, tiny_config)

from npvp_tpu.tools import export_weights as jw  # noqa: E402
from npvp_tpu.tools import torch_converter as jc  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.tools import torch_converter as tc  # noqa: E402
from npvp_tpu_torch.tools import weights as tw  # noqa: E402

TOL = dict(atol=1e-4, rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb), set(fa) ^ set(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, (k, fa[k].shape, fb[k].shape)
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _jax_vars(cfg, seed):
    """Random AE and predictor variables of ``cfg`` (JAX modules)."""
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.train.stage1_ae import build_ae

    d, p = cfg.Dataset, cfg.Predictor
    ae = build_ae(cfg, jnp.float32)
    ae_vars = random_variables(ae.init, jax.random.key(0), np.zeros(
        (1, 2, d.img_size, d.img_size, d.img_channels)), seed=seed)
    pred = build_predictor(cfg, jnp.float32, exec_mode="xla")
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc0 = np.zeros((2 * p.max_H * p.max_W, 3))
    init = lambda *a: pred.init(  # noqa: E731
        *a, num_target=2,
        target_feats_gt=feats0 if p.stochastic else None)
    pred_vars = random_variables(
        init, {"params": jax.random.key(1), "latent": jax.random.key(2)},
        feats0, oc0, oc0, seed=seed + 1)
    return ae_vars, pred_vars


def _small(stochastic):
    """tiny_config with one EVT-Former and one decoder layer: the whole
    model, at half the compile time of JAX's forward."""
    cfg = tiny_config(stochastic)
    cfg.Predictor.transformer_layers = 1
    cfg.Predictor.evt_former_num_layers = 1
    return cfg.validate()


def _frames(n=2, t=3, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, t, 32, 32, 1)).astype(np.float32)


def _vfp(vp, frames, eps, jax_side, monkeypatch=None):
    """VFP 3 → 2 of a JAX or port VideoPredictor with injected noise."""
    if jax_side:
        if eps is not None:
            real = jax.random.normal
            monkeypatch.setattr(jax.random, "normal",
                                lambda key, shape, dtype=jnp.float32: (
                                    jnp.asarray(eps)
                                    if tuple(shape) == eps.shape
                                    else real(key, shape, dtype)))
        return np.asarray(vp.vfp(frames, 2))
    return vp.vfp(frames, 2, eps=eps).numpy()


# -- the weights writer ------------------------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
def test_port_archive_equals_jax_archive(tmp_path, stochastic):
    """save_weights of the port's modules writes the JAX writer's archive
    from the same variables: the same keys, dtypes and values, the same
    meta."""
    cfg = tiny_config(stochastic)
    ae_vars, pred_vars = _jax_vars(cfg, seed=50 + stochastic)
    vp = VideoPredictor.from_variables(port_config(cfg), ae_vars, pred_vars,
                                       dtype=torch.float32, device="cpu")
    meta = {"ae_step": 3, "pred_step": 9}
    tw.save_weights(tmp_path / "port.npz", vp.ae, vp.predictor, meta)
    jw.save_weights(tmp_path / "jax.npz", ae_vars, pred_vars, meta)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stochastic", [False, True])
def test_archives_cross_between_packages(tmp_path, monkeypatch, stochastic):
    """An archive the port writes serves in JAX's
    ``VideoPredictor.from_weights`` with the port's outputs, and one JAX
    writes serves in the port's with JAX's (VFP 3 → 2, fp32)."""
    from npvp_tpu.models.inference import VideoPredictor as JaxVP

    cfg = _small(stochastic)
    ae_vars, pred_vars = _jax_vars(cfg, seed=60 + stochastic)
    port = VideoPredictor.from_variables(port_config(cfg), ae_vars,
                                         pred_vars, dtype=torch.float32,
                                         device="cpu")
    tw.save_weights(tmp_path / "port.npz", port.ae, port.predictor)
    jw.save_weights(tmp_path / "jax.npz", ae_vars, pred_vars)
    frames = _frames()
    eps = (np.random.default_rng(1).standard_normal((2, 4, 4, 32))
           .astype(np.float32) if stochastic else None)
    from_port = JaxVP.from_weights(cfg, tmp_path / "port.npz",
                                   dtype=jnp.float32, exec_mode="xla")
    from_jax = VideoPredictor.from_weights(port_config(cfg),
                                           tmp_path / "jax.npz",
                                           dtype=torch.float32,
                                           device="cpu")
    # both read float16-stored weights; the port reads its own archive too
    own = VideoPredictor.from_weights(port_config(cfg),
                                      tmp_path / "port.npz",
                                      dtype=torch.float32, device="cpu")
    want = _vfp(own, frames, eps, False)
    np.testing.assert_allclose(
        _vfp(from_port, frames, eps, True, monkeypatch), want, **TOL)
    np.testing.assert_allclose(_vfp(from_jax, frames, eps, False), want,
                               **TOL)


def test_large_magnitude_arrays_stay_float32(tmp_path):
    """Values at or past float16's reach are stored float32 and round-trip
    exactly; the rest are stored float16 (tests/test_export_weights.py's
    case, through the port's modules)."""
    from npvp_tpu_torch.nn.resnet_ae import build_ae

    cfg = port_config(tiny_config())
    ae = tw.random_init(build_ae(cfg), 0)
    with torch.no_grad():
        ae.decoder.up0_bn.running_var[:2] = torch.tensor([1e5, 2e5])
    tw.save_weights(tmp_path / "w.npz", ae, None)
    ae_vars, pred_vars, _ = tw.load_weights(tmp_path / "w.npz")
    assert pred_vars == {"params": {}, "batch_stats": {}}
    np.testing.assert_array_equal(
        ae_vars["batch_stats"]["decoder"]["up0_bn"]["var"],
        ae.decoder.up0_bn.running_var.numpy())
    with np.load(tmp_path / "w.npz") as data:
        assert data["vars/ae/batch_stats/decoder/up0_bn/var"].dtype == \
            np.float32
        assert data["vars/ae/params/decoder/head/kernel"].dtype == \
            np.float16
    # and JAX's reader takes the AE-only archive
    jae, jpred, _ = jw.load_weights(tmp_path / "w.npz")
    _assert_trees_equal(jae, ae_vars)


def test_to_flax_inverts_load_flax():
    """to_flax(load_flax(m, v)) == v, every leaf, for the AE (learn_3d) and
    NPVP-S."""
    cfg = tiny_config(stochastic=True)
    cfg.AE.learn_3d = True
    ae_vars, pred_vars = _jax_vars(cfg, seed=70)
    vp = VideoPredictor.from_variables(port_config(cfg), ae_vars, pred_vars,
                                       dtype=torch.float32, device="cpu")
    _assert_trees_equal(tw.to_flax(vp.ae), ae_vars)
    _assert_trees_equal(tw.to_flax(vp.predictor), pred_vars)


def test_warm_start_state(tmp_path):
    """The archive's half and its step into a fresh train state, the
    optimizer's moments fresh; a shape that differs fails naming the
    archive (JAX's ``warm_start_state``)."""
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = port_config(tiny_config())
    src = tw.random_init(build_predictor(cfg), 4)
    tw.save_weights(tmp_path / "w.npz", None, src, {"pred_step": 4200})
    state = s2.init_predictor_state(cfg, build_predictor(cfg), 1)
    assert tw.warm_start_state(state, tmp_path / "w.npz", "pred") is state
    assert state.step == 4200 and not state.optimizer.state
    want = tw.load_flax(build_predictor(cfg), tw.load_weights(
        tmp_path / "w.npz")[1]).state_dict()
    for key, value in want.items():
        assert torch.equal(state.model.state_dict()[key], value), key
    cfg.Predictor.embed_dim = cfg.Predictor.num_heads * 4
    other = s2.init_predictor_state(cfg, build_predictor(cfg), 1)
    with pytest.raises(ValueError, match="w.npz.*config mismatch"):
        tw.warm_start_state(other, tmp_path / "w.npz", "pred")


def test_export_weights_cli(tmp_path, capsys):
    """The CLI: the AE from an archive, the predictor from a port checkpoint
    directory (its best step); the archive reloads in both packages."""
    from npvp_tpu.tools.export_weights import load_weights as jload

    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.resnet_ae import build_ae
    from npvp_tpu_torch.tools.export_weights import main
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = port_config(tiny_config())
    ae = tw.random_init(build_ae(cfg), 1)
    tw.save_weights(tmp_path / "ae.npz", ae, None, {"ae_step": 5})
    mngr = CheckpointManager(tmp_path / "pred", monitor="loss_val")
    for step, loss in ((7, 0.5), (8, 0.9)):
        state = s2.init_predictor_state(cfg, tw.random_init(
            build_predictor(cfg), step), 1)
        state.step = step
        mngr.save(step, state, {"loss_val": loss})
    mngr.close()  # the files are written in the background
    cfg.save(tmp_path / "cfg.json")
    main(["--config_path", str(tmp_path / "cfg.json"), "--out",
          str(tmp_path / "out.npz"), "--ae_ckpt", str(tmp_path / "ae.npz"),
          "--pred_ckpt", str(tmp_path / "pred"), "--best", "--override",
          "Env.platform=cpu"])
    assert "reload OK" in capsys.readouterr().out
    ae_vars, pred_vars, meta = jload(tmp_path / "out.npz")
    assert (meta["ae_step"], meta["pred_step"]) == (5, 7)
    best = tw.random_init(build_predictor(cfg), 7)
    _assert_trees_equal(pred_vars, tw.load_weights(tmp_path / "out.npz")[1])
    np.testing.assert_allclose(
        pred_vars["params"]["final_norm"]["scale"],
        best.final_norm.weight.detach().numpy(), atol=1e-3)


# -- the reference-checkpoint converter ---------------------------------------

def t2n(x):
    return x.detach().cpu().numpy()


def test_conv2d_kernel_conversion():
    from npvp_tpu_torch.nn.layers import conv_nhwc

    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 8, 8)
    expect = t2n(conv(x)).transpose(0, 2, 3, 1)
    kernel = tc.conv2d_kernel(conv.weight)
    np.testing.assert_array_equal(kernel, jc.conv2d_kernel(conv.weight))
    port = tw.load_flax(torch.nn.Conv2d(3, 8, 3, padding=1),
                        {"params": {"kernel": kernel,
                                    "bias": tc._np(conv.bias)}})
    got = conv_nhwc(x.permute(0, 2, 3, 1), port, torch.float32)
    np.testing.assert_allclose(t2n(got), expect, atol=1e-5)


def test_conv_transpose2d_kernel_conversion():
    """ConvTranspose2d(k3, s2, p1, op1), the decoder's upsampling: the
    converted kernel drives the port's ConvTranspose and its sub-pixel
    form to torch's output."""
    from npvp_tpu_torch.nn.upsample import subpixel_conv_transpose_3x3_s2

    torch.manual_seed(0)
    conv = torch.nn.ConvTranspose2d(4, 6, 3, stride=2, padding=1,
                                    output_padding=1, bias=False)
    x = torch.randn(2, 4, 8, 8)
    expect = t2n(conv(x)).transpose(0, 2, 3, 1)
    kernel = tc.conv_transpose2d_kernel(conv.weight)
    np.testing.assert_array_equal(kernel,
                                  jc.conv_transpose2d_kernel(conv.weight))
    port = tw.load_flax(torch.nn.ConvTranspose2d(4, 6, 3, 2, 1, 1,
                                                 bias=False),
                        {"params": {"kernel": kernel}})
    got = subpixel_conv_transpose_3x3_s2(x.permute(0, 2, 3, 1), port.weight)
    np.testing.assert_allclose(t2n(got), expect, atol=1e-5)


def test_mha_packed_conversion():
    from npvp_tpu_torch.nn.layers import MultiHeadAttention

    torch.manual_seed(0)
    C, heads, L, N = 16, 4, 6, 3
    mha = torch.nn.MultiheadAttention(C, heads, dropout=0.0)
    q, kv = torch.randn(L, N, C), torch.randn(L, N, C)
    expect = t2n(mha(q, q, kv)[0]).transpose(1, 0, 2)  # (N, L, C)
    params = tc.mha_params(mha.state_dict(), "", heads)
    _assert_trees_equal(params, jc.mha_params(mha.state_dict(), "", heads))
    port = tw.load_flax(MultiHeadAttention(C, heads), {"params": params})
    got = port(q.transpose(0, 1), q.transpose(0, 1), kv.transpose(0, 1))
    np.testing.assert_allclose(t2n(got), expect, atol=1e-5)


def test_layernorm_chw_conversion():
    from npvp_tpu_torch.nn.layers import LayerNormHWC

    torch.manual_seed(0)
    C, H, W = 6, 4, 4
    ln = torch.nn.LayerNorm((C, H, W))
    with torch.no_grad():
        ln.weight.normal_()
        ln.bias.normal_()
    x = torch.randn(3, C, H, W)
    expect = t2n(ln(x)).transpose(0, 2, 3, 1)
    port = tw.load_flax(LayerNormHWC((H, W, C)), {"params": {
        "scale": tc.layernorm_chw(ln.weight),
        "bias": tc.layernorm_chw(ln.bias)}})
    got = port(x.permute(0, 2, 3, 1))
    np.testing.assert_allclose(t2n(got), expect, atol=1e-4)


def _lightning_ckpt(path, state_dict):
    """A Lightning-style checkpoint whose hyper-parameters are objects of
    classes from a module that is gone when it is read, as a checkpoint of
    the authors' training runs is where pytorch_lightning and their config
    classes are not installed."""
    mod = types.ModuleType("lit_run_classes")

    class AttributeDict(dict):
        pass

    class RunConfig:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    for cls in (AttributeDict, RunConfig):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[mod.__name__] = mod
    try:
        hp = AttributeDict(cfg=RunConfig(ngf=4, lr=1e-4), name="LitAE")
        torch.save({"state_dict": {f"module.{k}": v
                                   for k, v in state_dict.items()},
                    "hyper_parameters": hp, "epoch": 3,
                    "callbacks": {RunConfig: RunConfig(best=0.1)}}, path)
    finally:
        del sys.modules[mod.__name__]


def test_lightning_checkpoint_without_its_classes(tmp_path):
    """The state dict comes back (``module.`` prefixes stripped) although
    the checkpoint's classes are not importable: plain ``torch.load``
    cannot read it."""
    sd = {"w.weight": torch.randn(3, 2), "w.bias": torch.randn(3)}
    _lightning_ckpt(tmp_path / "a.ckpt", sd)
    with pytest.raises(Exception):
        torch.load(tmp_path / "a.ckpt", weights_only=False)
    got = tc.load_lightning_state_dict(str(tmp_path / "a.ckpt"))
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k])


@pytest.mark.parametrize("learn_3d", [False, True])
def test_ae_conversion_round_trip(tmp_path, learn_3d):
    """Random AE variables → the reference's state dict → JAX's converter
    gives them back exactly; the port's converter, reading the Lightning
    file, gives JAX's result; the port's AE on it matches JAX's forward."""
    from npvp_tpu.nn.resnet_ae import FrameAutoEncoder as JaxAE

    from npvp_tpu_torch.nn.resnet_ae import FrameAutoEncoder

    kw = dict(img_channels=1, ngf=4, n_downsampling=2, num_res_blocks=1,
              learn_3d=learn_3d)
    jae = JaxAE(**kw)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 16, 16, 1)).astype(
        np.float32)
    variables = random_variables(jae.init, jax.random.key(0), x,
                                 seed=80 + learn_3d)
    sd = reference_ae_state_dict(variables, 2, 1, learn_3d)
    _assert_trees_equal(jc.convert_ae(sd, 2, 1, learn_3d), variables)
    _lightning_ckpt(tmp_path / "ae.ckpt", sd)
    cfg = port_config(tiny_config())
    cfg.AE.n_downsampling, cfg.AE.num_res_blocks = 2, 1
    cfg.AE.learn_3d = learn_3d
    got = tc.convert_lightning_ae(str(tmp_path / "ae.ckpt"), cfg)
    _assert_trees_equal(got, variables)
    port = tw.load_flax(FrameAutoEncoder(**kw), got).eval()
    want_rec, want_feats = jae.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        rec, feats = port(torch.from_numpy(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), **TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), **TOL)


@pytest.mark.parametrize("stochastic", [False, True])
def test_predictor_conversion_round_trip(tmp_path, monkeypatch, stochastic):
    """A LitPredictor state dict (the predictor behind ``predictor.`` and
    the frozen AE beside it) → JAX's converter gives the variables back
    exactly, the port's gives JAX's, and the port's VideoPredictor on the
    converted weights matches JAX's on the source variables (NPVP-D and
    NPVP-S, VFP 3 → 2, fp32)."""
    from npvp_tpu.models.inference import VideoPredictor as JaxVP
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.train.stage1_ae import build_ae

    cfg = _small(stochastic)
    ae_vars, pred_vars = _jax_vars(cfg, seed=90 + stochastic)
    a, p = cfg.AE, cfg.Predictor
    sd = reference_predictor_state_dict(pred_vars, prefix="predictor.")
    sd.update(reference_ae_state_dict(ae_vars, a.n_downsampling,
                                      a.num_res_blocks))
    want_pred, want_ae = jc.convert_predictor(
        jc.strip_prefix(sd, "predictor"), p.num_heads,
        p.evt_former_num_layers, p.transformer_layers, 1, p.stochastic,
        p.fuse_method), jc.convert_ae(sd, a.n_downsampling,
                                      a.num_res_blocks)
    _assert_trees_equal(want_pred, pred_vars)
    _assert_trees_equal(want_ae, ae_vars)
    _lightning_ckpt(tmp_path / "pred.ckpt", sd)
    pcfg = port_config(cfg)
    got_pred, got_ae = tc.convert_lightning_predictor(
        str(tmp_path / "pred.ckpt"), pcfg)
    _assert_trees_equal(got_pred, want_pred)
    _assert_trees_equal(got_ae, want_ae)
    port = VideoPredictor.from_variables(pcfg, got_ae, got_pred,
                                         dtype=torch.float32, device="cpu")
    jvp = JaxVP(cfg, build_ae(cfg, jnp.float32), ae_vars,
                build_predictor(cfg, jnp.float32, exec_mode="xla"),
                pred_vars)
    frames = _frames(seed=3)
    eps = (np.random.default_rng(4).standard_normal((2, 4, 4, 32))
           .astype(np.float32) if stochastic else None)
    np.testing.assert_allclose(_vfp(port, frames, eps, False),
                               _vfp(jvp, frames, eps, True, monkeypatch),
                               **TOL)


def test_i3d_conversion_matches_jax():
    from npvp_tpu.eval.i3d import InceptionI3d

    i3d = InceptionI3d()
    variables = random_variables(i3d.init, jax.random.key(0),
                                 np.zeros((1, 8, 32, 32, 3)), seed=95)
    sd = reference_i3d_state_dict(variables)
    want = jc.convert_i3d(sd)
    _assert_trees_equal(want, variables)
    _assert_trees_equal(tc.convert_i3d(sd), want)


def test_converter_cli(tmp_path):
    """``--kind ae`` writes the pickled tree that ``load_flax`` takes;
    ``--kind i3d_tf`` without tensorflow fails with a clear message."""
    from npvp_tpu_torch.nn.resnet_ae import build_ae

    cfg = port_config(tiny_config())
    src = tw.random_init(build_ae(cfg), 3)
    sd = reference_ae_state_dict(tw.to_flax(src), cfg.AE.n_downsampling,
                                 cfg.AE.num_res_blocks)
    _lightning_ckpt(tmp_path / "ae.ckpt", sd)
    cfg.save(tmp_path / "cfg.json")
    tc.main(["--kind", "ae", "--ckpt", str(tmp_path / "ae.ckpt"),
             "--config_path", str(tmp_path / "cfg.json"), "--out",
             str(tmp_path / "ae.pkl")])
    got = tw.load_flax(build_ae(cfg), pickle.loads(
        (tmp_path / "ae.pkl").read_bytes()))
    for key, value in src.state_dict().items():
        assert torch.equal(got.state_dict()[key], value), key



def test_converter_cli_without_tensorflow(tmp_path, monkeypatch):
    """``--kind i3d_tf`` where tensorflow cannot be imported (the card's
    hosts) fails with a clear message."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(SystemExit, match="needs the tensorflow"):
        tc.main(["--kind", "i3d_tf", "--ckpt", str(tmp_path / "x"),
                 "--out", str(tmp_path / "i3d.pkl")])


def test_tf_hub_i3d_conversion_matches_jax():
    """TF-hub variable names (the Mixed_5b branch-2 suffix swap included)
    → the same tree as JAX's converter."""
    rng = np.random.default_rng(0)
    names = {
        "RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w:0": (7, 7, 7, 3, 4),
        "RGB/inception_i3d/Conv3d_1a_7x7/batch_norm/beta:0": (4,),
        "RGB/inception_i3d/Conv3d_1a_7x7/batch_norm/moving_mean:0": (4,),
        "RGB/inception_i3d/Conv3d_1a_7x7/batch_norm/moving_variance:0":
            (4,),
        "RGB/inception_i3d/Mixed_3b/Branch_1/Conv3d_0a_1x1/conv_3d/w:0":
            (1, 1, 1, 4, 2),
        "RGB/inception_i3d/Mixed_3b/Branch_0/Conv3d_0a_1x1/conv_3d/w:0":
            (1, 1, 1, 4, 2),
        "RGB/inception_i3d/Mixed_5b/Branch_2/Conv3d_0a_3x3/conv_3d/w:0":
            (3, 3, 3, 2, 2),
        "RGB/inception_i3d/Logits/Conv3d_0c_1x1/conv_3d/w:0":
            (1, 1, 1, 2, 5),
        "RGB/inception_i3d/Logits/Conv3d_0c_1x1/conv_3d/b:0": (5,)}
    tf_vars = {n: rng.standard_normal(s).astype(np.float32)
               for n, s in names.items()}
    for n in names:
        assert tc.tf_hub_i3d_name(n) == jc.tf_hub_i3d_name(n)
    _assert_trees_equal(tc.convert_tf_hub_i3d(tf_vars),
                        jc.convert_tf_hub_i3d(tf_vars))
