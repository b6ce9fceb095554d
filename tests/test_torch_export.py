"""Serving bundles, on the CPU (the kernels' ops under ``torch.export``, one
node a call, are held in ``tests/test_torch_kernel_seam.py``):

- ``VideoPredictor.export_task`` → ``serve_exported`` (NPVP-D and NPVP-S,
  exec_mode pallas, fp32): bit-equal to the port's ``freeze_task`` with the
  same noise, a request larger than the static batch chunked and its last
  chunk zero-padded; the bundle refuses another device;
- the NPVP-D bundle against the JAX package's ``serve_exported`` on the
  same weights (atol 1e-4; NPVP-D draws no noise, so the two random
  streams do not matter);
- the export CLI.
"""

import json

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import (port_config, random_variables,  # noqa: E402
                            tiny_config)

from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402

TO, TP = np.arange(3), np.arange(3, 6)


def _small(stochastic):
    """tiny_config with one EVT-Former and one decoder layer (a trace
    costs time by the op)."""
    cfg = tiny_config(stochastic)
    cfg.Predictor.transformer_layers = 1
    cfg.Predictor.evt_former_num_layers = 1
    return cfg.validate()


def _vp(stochastic, seed=0):
    cfg = port_config(_small(stochastic))
    return VideoPredictor.from_random_init(cfg, dtype=torch.float32,
                                           seed=seed, exec_mode="pallas",
                                           device="cpu")


def _frames(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, 3, 32, 32, 1)).astype(np.float32)


@pytest.mark.parametrize("stochastic", [False, True])
def test_bundle_is_bit_equal_to_freeze_task(tmp_path, stochastic):
    """A request of 4 + 2 clips on a bundle of batch 4: the first chunk
    equals ``freeze_task`` on the first 4 clips with the caller's noise,
    the second ``freeze_task`` on the last 2 padded with zero clips and
    zero noise; without noise the first chunk draws as ``freeze_task``
    does. The program calls the kernel's op at each of the forward's 5
    attention sites (2 windows, the EVT-Former's temporal attention, the
    decoder's and its cross-attention); a bundle refuses another
    device."""
    vp = _vp(stochastic, seed=3)
    vp.export_task(tmp_path / "b", TO, TP, 4)
    meta = json.loads((tmp_path / "b" / "meta.json").read_text())
    assert meta["batch_size"] == 4 and meta["to_list"] == [0.0, 1.0, 2.0]
    assert meta["frames_shape"] == [4, 3, 32, 32, 1]
    assert meta["exec_mode"] == "pallas" and meta["device"] == "cpu"
    assert (meta["eps_shape"] is not None) == stochastic
    program = torch.export.load(tmp_path / "b" / "program.pt2")
    assert sum(n.op == "call_function"
               and "npvp.temporal_attention" in str(n.target)
               for n in program.graph.nodes) == 5
    serve = VideoPredictor.serve_exported(tmp_path / "b", device="cpu")
    frames = _frames(6)
    eps = (np.random.default_rng(1).standard_normal((6, 4, 4, 32))
           .astype(np.float32) if stochastic else None)
    fn = vp.freeze_task(TO, TP)
    want0 = fn(frames[:4], eps=None if eps is None else eps[:4])
    got = serve(frames, eps)
    assert got.shape == (6, 3, 32, 32, 1)
    assert torch.equal(got[:4], want0)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((2,) + a.shape[1:], np.float32)])
    want1 = fn(pad(frames[4:]), eps=None if eps is None else pad(eps[4:]))
    assert torch.equal(got[4:], want1[:2])
    if stochastic:
        assert torch.equal(serve(frames[:4]), fn(frames[:4]))
    meta = tmp_path / "b" / "meta.json"
    meta.write_text(meta.read_text().replace('"cpu"', '"cuda"'))
    with pytest.raises(ValueError, match="exported for cuda"):
        VideoPredictor.serve_exported(tmp_path / "b", device="cpu")


def test_bundle_matches_jax_serve_exported(tmp_path):
    """NPVP-D: the port's bundle and the JAX package's on the same weights
    serve the same frames (atol 1e-4), 5 clips on a batch of 2."""
    from npvp_tpu.models.inference import VideoPredictor as JaxVP
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.train.stage1_ae import build_ae

    cfg = _small(False)
    d, p = cfg.Dataset, cfg.Predictor
    ae = build_ae(cfg, jnp.float32)
    ae_vars = random_variables(ae.init, jax.random.key(0), np.zeros(
        (1, 2, d.img_size, d.img_size, d.img_channels)), seed=11)
    pred = build_predictor(cfg, jnp.float32, exec_mode="xla")
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc0 = np.zeros((2 * p.max_H * p.max_W, 3))
    pred_vars = random_variables(
        lambda *a: pred.init(*a, num_target=2), {"params": jax.random.key(1)},
        feats0, oc0, oc0, seed=12)
    JaxVP(cfg, ae, ae_vars, pred, pred_vars).export_task(
        str(tmp_path / "jax"), TO, TP, 2, platforms=("cpu",))
    port = VideoPredictor.from_variables(port_config(cfg), ae_vars,
                                         pred_vars, dtype=torch.float32,
                                         exec_mode="pallas", device="cpu")
    port.export_task(tmp_path / "port", TO, TP, 2)
    frames = _frames(5, seed=2)
    want = np.asarray(JaxVP.serve_exported(str(tmp_path / "jax"))(frames))
    got = VideoPredictor.serve_exported(tmp_path / "port",
                                        device="cpu")(frames)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_export_serving_cli(tmp_path, capsys):
    from npvp_tpu_torch.tools.export_serving import main

    cfg = port_config(_small(True))
    cfg.Dataset.test_num_past_frames = cfg.Dataset.test_num_future_frames = 2
    cfg.save(tmp_path / "cfg.json")
    main(["--config_path", str(tmp_path / "cfg.json"), "--task", "VFP",
          "--batch_size", "2", "--out", str(tmp_path / "b"),
          "--random_init", "--override", "Env.platform=cpu",
          "Env.compute_dtype=float32"])
    assert "exported task" in capsys.readouterr().out
    serve = VideoPredictor.serve_exported(tmp_path / "b", device="cpu")
    assert serve.meta["to_list"] == [0.0, 1.0]
    assert serve.meta["tp_list"] == [2.0, 3.0]
    out = serve(np.zeros((3, 2, 32, 32, 1), np.float32))
    assert out.shape == (3, 2, 32, 32, 1) and bool(torch.isfinite(
        out.float()).all())
