"""The rest of the port's ``VideoPredictor`` against the JAX package's, fp32
on the CPU at the tiny test size:

- ``vfp_windowed`` (NPVP-D, and NPVP-S with one injected noise per window)
  against JAX's, at the default window and at a smaller ``chunk``: atol
  1e-4; ``vfp`` past ``max_T`` takes it;
- ``predict_stream`` against JAX's (NPVP-D) and against one ``predict``
  call per batch (NPVP-S, the same noise or the same generator): atol 1e-4;
- ``from_checkpoints`` on the directories (and files) that the two
  trainers write: outputs equal those of the in-memory models.
"""

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import port_config, random_variables, tiny_config  # noqa: E402

from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402


def _jax_predictor(cfg, seed):
    from npvp_tpu.models.inference import VideoPredictor as JaxVP
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.train.stage1_ae import build_ae

    d, p = cfg.Dataset, cfg.Predictor
    ae = build_ae(cfg, jnp.float32)
    ae_vars = random_variables(ae.init, jax.random.key(0), np.zeros(
        (1, 2, d.img_size, d.img_size, d.img_channels)), seed=seed)
    pred = build_predictor(cfg, jnp.float32, exec_mode="xla")
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    init = lambda *a: pred.init(  # noqa: E731
        *a, num_target=2,
        target_feats_gt=feats0 if p.stochastic else None)
    pred_vars = random_variables(
        init, {"params": jax.random.key(1), "latent": jax.random.key(2)},
        feats0, np.zeros((2 * p.max_H * p.max_W, 3)),
        np.zeros((2 * p.max_H * p.max_W, 3)), seed=seed + 1)
    port = VideoPredictor.from_variables(
        port_config(cfg), ae_vars, pred_vars, dtype=torch.float32,
        device="cpu")
    return JaxVP(cfg, ae, ae_vars, pred, pred_vars), port


def _frames(n, t, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, t, 32, 32, 1)).astype(np.float32)


def _noise(count, seed=1):
    return [np.random.default_rng(seed + i).standard_normal(
        (2, 4, 4, 32)).astype(np.float32) for i in range(count)]


def _injected(monkeypatch, eps_list):
    """JAX's EventEncoder draws with ``jax.random.normal``: hand it the
    next entry of ``eps_list`` at each draw of the latent's shape (eagerly,
    under ``jax.disable_jit``, so that every window draws anew)."""
    real = jax.random.normal
    queue = list(eps_list)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: (
                            jnp.asarray(queue.pop(0))
                            if tuple(shape) == eps_list[0].shape
                            else real(key, shape, dtype or jnp.float32)))
    return queue


@pytest.mark.parametrize("stochastic,chunk", [(False, None), (False, 2),
                                              (True, None)])
def test_vfp_windowed_matches_jax(monkeypatch, stochastic, chunk):
    """Observe 3 frames of a max_T = 8 model, predict 9: two windows of 5
    (or five of 2), each re-based to times 0..2."""
    jvp, port = _jax_predictor(tiny_config(stochastic), seed=30 + stochastic)
    frames = _frames(2, 3)
    windows = -(-9 // (chunk or 5))
    eps = _noise(windows) if stochastic else None
    if stochastic:
        queue = _injected(monkeypatch, eps)
        with jax.disable_jit():
            want = np.asarray(jvp.vfp_windowed(frames, 9, chunk=chunk))
        assert not queue  # one draw per window
    else:
        want = np.asarray(jvp.vfp_windowed(frames, 9, chunk=chunk))
    got = port.vfp_windowed(frames, 9, eps=eps, chunk=chunk)
    assert got.shape == (2, 9, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if chunk is None:  # vfp past max_T takes the windows
        torch.testing.assert_close(port.vfp(frames, 9, eps=eps), got,
                                   atol=0, rtol=0)


def test_windows_draw_from_one_generator():
    """NPVP-S without ``eps``: window w draws the w-th noise of the one
    generator."""
    vp = VideoPredictor.from_random_init(port_config(tiny_config(True)),
                                         torch.float32, seed=4, device="cpu")
    frames = _frames(2, 3)
    gen = torch.Generator().manual_seed(11)
    eps = [torch.randn((2, 4, 4, 32), generator=gen) for _ in range(2)]
    want = vp.vfp_windowed(frames, 9, eps=eps)
    got = vp.vfp_windowed(frames, 9,
                          generator=torch.Generator().manual_seed(11))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_predict_stream_matches_jax_and_predict():
    """Three batches: NPVP-D against JAX's ``predict_stream`` and against
    one ``predict`` each; NPVP-S against ``predict`` with the same noise and
    with the same generator drawn in batch order."""
    jvp, port = _jax_predictor(tiny_config(False), seed=40)
    stream = np.stack([_frames(2, 3, seed=s) for s in range(3)])
    to, tp = [0.0, 1.0, 3.0], [2.0, 4.5, 6.0, 7.0]
    want = np.asarray(jvp.predict_stream(stream, to, tp))
    got = port.predict_stream(stream, to, tp)
    assert got.shape == (3, 2, 4, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    for s in range(3):
        torch.testing.assert_close(got[s], port.predict(stream[s], to, tp),
                                   atol=1e-6, rtol=0)

    vp = VideoPredictor.from_random_init(port_config(tiny_config(True)),
                                         torch.float32, seed=5, device="cpu")
    eps = _noise(3)
    got = vp.predict_stream(stream, to, tp, eps=eps)
    gen = torch.Generator().manual_seed(3)
    drawn = vp.predict_stream(stream, to, tp, generator=gen)
    gen = torch.Generator().manual_seed(3)
    for s in range(3):
        torch.testing.assert_close(
            got[s], vp.predict(stream[s], to, tp, eps=eps[s]), atol=1e-6,
            rtol=0)
        torch.testing.assert_close(
            drawn[s], vp.predict(stream[s], to, tp, generator=gen),
            atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="observed at"):
        vp.predict_stream(stream, to[:2], tp)


def test_from_checkpoints_reads_the_trainers_directories(tmp_path):
    """Stage 1 then stage 2 (NPVP-S, static VFP) at the tiny size write
    their checkpoint directories; ``from_checkpoints`` on them (and on one
    checkpoint file each) serves what the in-memory models serve; an
    ``.npz`` predictor path is a weights archive."""
    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.train import stage1_ae as s1
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = port_config(tiny_config(True))
    a, p, d = cfg.AE, cfg.Predictor, cfg.Dataset
    cfg.Env.platform, cfg.Env.compute_dtype = "cpu", "float32"
    cfg.Env.visual_callback = False
    d.batch_size, d.dev_set_size = 2, 4
    a.epochs, p.epochs = 1, 1
    a.ckpt_save_dir = p.resume_AE_ckpt = str(tmp_path / "ae")
    a.tensorboard_save_dir = str(tmp_path / "ae_log")
    p.ckpt_save_dir = str(tmp_path / "pred")
    p.tensorboard_save_dir = str(tmp_path / "pred_log")
    ae_state = s1.train(cfg)
    pred_state = s2.train(cfg)
    memory = VideoPredictor(cfg, ae_state.model, pred_state.model, "cpu")
    frames = _frames(2, 4)
    eps = _noise(1)[0]
    want = memory.vfp(frames, 4, eps=eps)
    files = [CheckpointManager(tmp_path / k).path(2) for k in ("ae", "pred")]
    for ae_src, pred_src in ((tmp_path / "ae", tmp_path / "pred"), files):
        vp = VideoPredictor.from_checkpoints(cfg, ae_src, pred_src,
                                             torch.float32, device="cpu")
        torch.testing.assert_close(vp.vfp(frames, 4, eps=eps), want,
                                   atol=0, rtol=0)
    with pytest.raises(FileNotFoundError):
        VideoPredictor.from_checkpoints(cfg, tmp_path / "ae",
                                        tmp_path / "absent.pt",
                                        torch.float32, device="cpu")


def test_from_checkpoints_takes_a_weights_archive(tmp_path):
    from npvp_tpu.tools.export_weights import save_weights

    cfg = tiny_config(False)
    jvp, port = _jax_predictor(cfg, seed=50)
    save_weights(tmp_path / "w.npz", jvp.ae_vars, jvp.predictor_vars)
    vp = VideoPredictor.from_checkpoints(port_config(cfg), "unused",
                                         tmp_path / "w.npz", torch.float32,
                                         device="cpu")
    frames = _frames(2, 4)
    # the archive stores float16 where a value fits it
    np.testing.assert_allclose(vp.vfp(frames, 4).numpy(),
                               port.vfp(frames, 4).numpy(), atol=2e-2)
    np.testing.assert_allclose(vp.vfp(frames, 4).numpy(),
                               VideoPredictor.from_weights(
                                   port_config(cfg), tmp_path / "w.npz",
                                   torch.float32, device="cpu").vfp(
                                       frames, 4).numpy(), atol=0)
