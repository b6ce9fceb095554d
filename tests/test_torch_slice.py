"""The port's serving slice as a whole: ``VideoPredictor`` (AE encode → NP
predictor with the kernel path → AE decode) against the JAX package's
``VideoPredictor`` on the same flax variables and, for NPVP-S, the same
injected latent noise (fp32, atol 1e-3); its exec modes, tasks, config and
device rules; and the golden fixture that ``chip_smoke.py`` reads."""

import dataclasses
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]


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
    # with target features flax also creates NPVP-S's posterior
    init = lambda *a: pred.init(  # noqa: E731
        *a, num_target=2,
        target_feats_gt=feats0 if p.stochastic else None)
    pred_vars = random_variables(
        init, {"params": jax.random.key(1), "latent": jax.random.key(2)},
        feats0,
        np.zeros((2 * p.max_H * p.max_W, 3)),
        np.zeros((2 * p.max_H * p.max_W, 3)), seed=seed + 1)
    return JaxVP(cfg, ae, ae_vars, pred, pred_vars), ae_vars, pred_vars


@pytest.mark.parametrize("stochastic", [False, True])
def test_slice_matches_jax(monkeypatch, stochastic):
    cfg = tiny_config(stochastic)
    jvp, ae_vars, pred_vars = _jax_predictor(cfg, seed=10 + stochastic)
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (2, 3, 32, 32, 1)).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: (
        jnp.asarray(eps) if tuple(shape) == eps.shape
        else real(key, shape, dtype or jnp.float32)))
    want = np.asarray(jvp.vpe(frames, 5))          # observe 5..7, predict 0..4
    port = VideoPredictor.from_variables(
        port_config(cfg), ae_vars, pred_vars, dtype=torch.float32,
        device="cpu")
    got = port.vpe(frames, 5, eps=eps if stochastic else None)
    assert got.shape == (2, 5, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_kernel_exec_mode_matches_plain_mode():
    """exec_mode="pallas" (the kernel wrappers) ≡ "xla" (plain attention
    and eager norms) on one parameter set."""
    cfg = port_config(tiny_config(True))
    frames = np.random.default_rng(1).uniform(-1, 1, (2, 4, 32, 32, 1))
    outs = [VideoPredictor.from_random_init(
        cfg, torch.float32, seed=3, exec_mode=mode, device="cpu").vfp(
            frames, 4) for mode in ("xla", "pallas")]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=2e-5)


def test_tasks_freeze_and_reconstruct():
    cfg = port_config(tiny_config(True))
    vp = VideoPredictor.from_random_init(cfg, torch.float32, device="cpu")
    frames = np.random.default_rng(2).uniform(-1, 1, (2, 4, 32, 32, 1))
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    vfp = vp.vfp(frames, 3, generator=gen())
    frozen = vp.freeze_task(np.arange(4), np.arange(4, 7))
    np.testing.assert_array_equal(frozen(frames, generator=gen()).numpy(),
                                  vfp.numpy())
    assert vp.vfi(frames, 2, 2, 3).shape == (2, 3, 32, 32, 1)
    assert vp.vrc(frames, [0, 2, 5, 7], [1, 3]).shape == (2, 2, 32, 32, 1)
    assert vp.hvrc(frames, [0, 2, 4, 6], [0.5, 6.75]).shape == (
        2, 2, 32, 32, 1)
    # beyond max_T (4 + 5 > 8): the sliding windows, out-of-range chunks
    # refused
    long = vp.vfp(frames, 5, generator=gen())
    assert long.shape == (2, 5, 32, 32, 1)
    np.testing.assert_array_equal(
        long.numpy(), vp.vfp_windowed(frames, 5, generator=gen()).numpy())
    for chunk in (0, 5):
        with pytest.raises(ValueError, match="window horizon"):
            vp.vfp_windowed(frames, 5, chunk=chunk)
    with pytest.raises(ValueError, match="frozen task"):
        frozen(frames[:, :3])
    rec = vp.reconstruct(frames)
    with torch.no_grad():
        feats = vp.ae.encode(torch.as_tensor(frames, dtype=torch.float32))
        torch.testing.assert_close(rec, vp.ae.decode(feats))


def test_device_rule():
    from npvp_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        VideoPredictor.from_random_init(port_config(tiny_config()))


def test_config_copy_reads_every_yaml():
    import __graft_entry__
    from npvp_tpu.core import config as jcfg
    from npvp_tpu_torch.core import config as tcfg

    for path in sorted((ROOT / "npvp_tpu" / "configs").glob("*.yaml")):
        over = ["Predictor.exec_mode=pallas", "Dataset.batch_size=3"]
        assert (tcfg.load_config(path, over).to_dict()
                == jcfg.load_config(path, over).to_dict()), path.name
    assert (dataclasses.asdict(tcfg.flagship_config())
            == dataclasses.asdict(__graft_entry__._flagship_config()))
    with pytest.raises(KeyError):
        tcfg.apply_overrides(tcfg.Config(), ["Predictor.nope=1"])


def test_golden_fixture_is_fresh():
    """Regenerates the fixture's arrays with JAX; the committed file must
    hold the same (weights exactly, outputs within 1e-5) and stay under
    1 MiB."""
    import make_torch_golden as mk

    assert mk.GOLDEN.stat().st_size < 1 << 20
    fresh = mk.golden_arrays()
    with np.load(mk.GOLDEN) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for key, value in fresh.items():
            if key == "__meta__":
                assert bytes(stored[key]) == bytes(value)
                continue
            np.testing.assert_allclose(stored[key].astype(np.float32), value,
                                       atol=0 if key.startswith("vars/")
                                       else 1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("tag", ["d", "s"])
def test_port_matches_golden(tag):
    from npvp_tpu_torch.tools.golden import load_golden

    g = load_golden()
    vp = VideoPredictor.from_variables(
        g["cfg"][tag], g["ae_vars"], g["pred_vars"][tag],
        dtype=torch.float32, exec_mode="pallas", device="cpu")
    eps = g["eps"] if tag == "s" else None
    got = {"vfp": vp.vfp(g["frames"], 2, eps=eps),
           "hvrc": vp.hvrc(g["frames"], g["hvrc_to"], g["hvrc_tp"], eps=eps)}
    for task, out in got.items():
        np.testing.assert_allclose(out.numpy(), g[f"{task}_{tag}"],
                                   atol=1e-4, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("run", ["SMMNIST_Unified_NPVP-D",
                                 "SMMNIST_Unified_NPVP-S"])
def test_trained_weights_match_jax(monkeypatch, run):
    """Trained weights archive (untracked; restore it from git history) →
    port and JAX give the same VFP frames, fp32, NPVP-S with one injected
    latent noise."""
    npz = ROOT / "results" / run / "weights.npz"
    if not npz.exists():
        pytest.skip(f"{npz} is not on disk")
    from npvp_tpu.core.config import load_config
    from npvp_tpu.models.inference import VideoPredictor as JaxVP

    cfg = load_config(ROOT / "npvp_tpu" / "configs" / f"config_{run}.yaml")
    p = cfg.Predictor
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (1, 5, 64, 64, 1)).astype(np.float32)
    eps = rng.standard_normal((1, p.max_H, p.max_W, p.embed_dim)).astype(
        np.float32)
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: (
        jnp.asarray(eps) if tuple(shape) == eps.shape
        else real(key, shape, dtype or jnp.float32)))
    want = np.asarray(JaxVP.from_weights(cfg, npz, dtype=jnp.float32,
                                         exec_mode="xla").vfp(frames, 10))
    port = VideoPredictor.from_weights(port_config(cfg), npz,
                                       dtype=torch.float32, device="cpu")
    got = port.vfp(frames, 10, eps=eps if p.stochastic else None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
