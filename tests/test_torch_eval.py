"""The port's evaluation chain against the JAX package's, fp32 on the CPU
at the tiny test size, on one NPVP-D weights archive written by
``npvp_tpu.tools.export_weights.save_weights`` and the same SMMNIST test
clips:

- ``psnr``, ``mse_score``, ``ssim`` and ``pred_ave_metrics``: rtol 1e-5;
- ``evaluate`` for the five tasks (VFP past ``max_T`` through the sliding
  windows), with the copy baseline and the AE ceiling: per-timestep PSNR
  atol 1e-3 dB, SSIM and MSE rtol 1e-4; the VRC/HVRC splits exactly;
  best-of-N on stub scores; NPVP-S best-of-2 with GIFs;
- the inference CLI's ``task_split`` exactly and ``run_tasks`` at the same
  tolerances, its GIFs;
- the GIF writer: PIL (where the sandbox has it) decodes its frames to the
  quantised input exactly, with the frame count, duration and loop.
"""

import json

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_helpers import port_config, random_variables, tiny_config  # noqa: E402

from npvp_tpu_torch.core.metrics import (gif_frame_count, gif_quantise,  # noqa: E402
                                         save_clip_gifs)
from npvp_tpu_torch.data import loader as tload  # noqa: E402
from npvp_tpu_torch.data import smmnist as tsm  # noqa: E402
from npvp_tpu_torch.eval import evaluate as tev  # noqa: E402
from npvp_tpu_torch.eval import metrics as tm  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.train import inference as tinf  # noqa: E402

SPRITES = tsm.default_sprite_bank(16, per_digit=3, seed=11)
TASKS = ("VFP", "VPE", "VFI", "VRC", "HVRC")


def _images(seed, shape=(3, 16, 20, 2)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", ["psnr", "mse_score", "ssim"])
def test_metrics_match_jax(name):
    from npvp_tpu.eval import metrics as jm

    x, y = _images(0)
    for mean_flag in (False, True):
        got = getattr(tm, name)(torch.from_numpy(x), torch.from_numpy(y),
                                mean_flag=mean_flag).numpy()
        want = np.asarray(getattr(jm, name)(jnp.asarray(x), jnp.asarray(y),
                                            mean_flag=mean_flag))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_pred_ave_metrics_and_clip_metrics_match_jax():
    """The per-timestep protocol over a two-batch loader, and the fused
    per-clip pass (renormalisation folded in) against per-frame calls."""
    from npvp_tpu.eval import metrics as jm

    rng = np.random.default_rng(1)
    batches = [{"future": rng.uniform(-0.2, 1.2, (2, 3, 16, 16, 1)).astype(
        np.float32)} for _ in range(2)]
    preds = [b["future"] + rng.normal(0, 0.1, b["future"].shape).astype(
        np.float32) for b in batches]
    predict = lambda b: preds[next(i for i, c in enumerate(batches)  # noqa
                                   if c is b)]
    renorm = lambda x: np.clip(x, 0, 1)  # noqa: E731
    for name in ("psnr", "ssim", "mse_score"):
        got = tm.pred_ave_metrics(predict, batches, getattr(tm, name),
                                  renorm, 3)
        want = jm.pred_ave_metrics(predict, batches, getattr(jm, name),
                                   renorm, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    fused = tm.clip_metrics(torch.from_numpy(preds[0]),
                            batches[0]["future"], 0.0, 1.0)
    for key, fn in (("PSNR", tm.psnr), ("SSIM", tm.ssim),
                    ("MSE", tm.mse_score)):
        for t in range(3):
            want = fn(torch.from_numpy(renorm(preds[0][:, t])),
                      torch.from_numpy(renorm(batches[0]["future"][:, t])),
                      mean_flag=False)
            torch.testing.assert_close(fused[key][:, t], want, rtol=1e-6,
                                       atol=0)


def _eval_cfg(stochastic=False):
    cfg = tiny_config(stochastic)
    cfg.Dataset.batch_size, cfg.Dataset.num_workers = 2, 1
    cfg.Predictor.exec_mode = "xla"
    return cfg.validate()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """An NPVP-D weights archive of random flax variables, and the config
    that names it."""
    from npvp_tpu.models.predictor import build_predictor
    from npvp_tpu.tools.export_weights import save_weights
    from npvp_tpu.train.stage1_ae import build_ae

    cfg = _eval_cfg()
    p = cfg.Predictor
    ae_vars = random_variables(build_ae(cfg, jnp.float32).init,
                               jax.random.key(0),
                               np.zeros((1, 2, 32, 32, 1)), seed=60)
    pred = build_predictor(cfg, jnp.float32)
    feats0 = np.zeros((1, 2, p.max_H, p.max_W, p.embed_dim))
    oc = np.zeros((2 * p.max_H * p.max_W, 3))
    pred_vars = random_variables(
        lambda *a: pred.init(*a, num_target=2), {"params": jax.random.key(1)},
        feats0, oc, oc, seed=61)
    path = tmp_path_factory.mktemp("w") / "weights.npz"
    save_weights(path, ae_vars, pred_vars)
    cfg.Predictor.ckpt_save_dir = cfg.Predictor.resume_AE_ckpt = str(path)
    return cfg


@pytest.fixture
def shared_clips(monkeypatch):
    """Both packages' data modules render the test clips from one sprite
    bank, on the per-index path (both packages' native renderers, where
    built, draw from another stream)."""
    from npvp_tpu.data import loader as jload
    from npvp_tpu.data import native_bindings

    from npvp_tpu_torch.data import native_bindings as tnb

    real = jload.StochasticMovingMNIST

    def with_sprites(*a, **kw):
        ds = real(*a, **kw)
        ds.sprites, ds._length = SPRITES, len(SPRITES)
        return ds

    monkeypatch.setattr(jload, "StochasticMovingMNIST", with_sprites)
    monkeypatch.setattr(native_bindings, "synth_moving_sprites_batch",
                        lambda *a, **k: None)
    monkeypatch.setattr(tnb, "native_available", lambda: False)
    return {"train": SPRITES, "test": SPRITES}


def _close_rows(got, want, keys):
    for key in keys:
        for metric, kw in (("PSNR", dict(atol=1e-3, rtol=0)),
                           ("SSIM", dict(atol=0, rtol=1e-4)),
                           ("MSE", dict(atol=0, rtol=1e-4))):
            name = f"{metric}{key}_per_t"
            np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                       **kw)
            assert got[f"{metric}{key}"] == pytest.approx(
                float(np.mean(got[name])))


@pytest.mark.parametrize("task", TASKS)
def test_evaluate_matches_jax(archive, shared_clips, task):
    """One test batch of two 15-frame clips; VFP predicts 10 frames from 5
    with max_T = 8, so it runs four windows of 3."""
    from npvp_tpu.eval.evaluate import evaluate as jevaluate

    kw = dict(max_batches=1, task=task, baseline=True, ae_ceiling=True)
    want = jevaluate(archive, **kw)
    got = tev.evaluate(port_config(archive), device="cpu",
                       sprites=shared_clips, **kw)
    assert set(got) == set(want)
    assert got["task"] == task and got["num_samples"] == 1
    _close_rows(got, want, ("", "_baseline", "_ae_ceiling"))


@pytest.mark.parametrize("task", ["VRC", "HVRC", "VPE", "VFI"])
def test_task_splits_equal_jax(task):
    from npvp_tpu.eval.evaluate import _task_split as jsplit
    from npvp_tpu.train.inference import task_split as jtask

    cfg = tiny_config()
    for seed in (0, 3047):
        for got, want in zip(tev._task_split(task, port_config(cfg), seed),
                             jsplit(task, cfg, seed)):
            np.testing.assert_array_equal(got, want)
    for P, T, seed in ((5, 8, 0), (10, 8, 1), (3, 15, 2)):
        for got, want in zip(tinf.task_split(task, P, T, seed),
                             jtask(task, P, T, seed)):
            np.testing.assert_array_equal(got, want)


def test_best_of_picks_per_sequence_and_metric():
    """Two draws of two sequences: each sequence takes, for each metric,
    the draw with the best mean over time (higher PSNR/SSIM, lower MSE)."""
    a = {"PSNR": np.array([[10.0, 12.0], [30.0, 30.0]]),
         "SSIM": np.array([[0.5, 0.5], [0.1, 0.3]]),
         "MSE": np.array([[4.0, 2.0], [1.0, 1.0]])}
    b = {"PSNR": np.array([[20.0, 0.0], [31.0, 31.0]]),
         "SSIM": np.array([[0.4, 0.7], [0.2, 0.1]]),
         "MSE": np.array([[1.0, 1.0], [5.0, 0.0]])}
    chosen, best = tev.best_of([a, b])
    np.testing.assert_array_equal(best["PSNR"], [0, 1])
    np.testing.assert_array_equal(best["SSIM"], [1, 0])
    np.testing.assert_array_equal(best["MSE"], [1, 0])
    np.testing.assert_array_equal(chosen["PSNR"], [[10, 12], [31, 31]])
    np.testing.assert_array_equal(chosen["SSIM"], [[0.4, 0.7], [0.1, 0.3]])
    np.testing.assert_array_equal(chosen["MSE"], [[1, 1], [1, 1]])


def test_evaluate_best_of_two_with_gifs(tmp_path):
    """NPVP-S, random weights: best-of-2 is at least as good as one draw on
    the means; GIFs of the first batch."""
    cfg = port_config(_eval_cfg(stochastic=True))
    cfg.Env.platform = "cpu"
    sprites = {"train": SPRITES, "test": SPRITES}
    kw = dict(max_batches=1, task="VFI", random_init=True, device="cpu",
              sprites=sprites)
    one = tev.evaluate(cfg, num_samples=1, **kw)
    two = tev.evaluate(cfg, num_samples=2, gif_dir=str(tmp_path), **kw)
    assert two["num_samples"] == 2
    assert two["PSNR"] >= one["PSNR"] and two["MSE"] <= one["MSE"]
    for i in range(2):
        assert gif_frame_count(tmp_path / f"VFI_seq{i}.gif") > 0


def test_evaluate_and_inference_clis(archive, tmp_path, capsys):
    """Both CLIs on the archive, on the CPU: the evaluation's JSON (printed
    and written), the five tasks' timings and GIFs."""
    cfg = port_config(archive)
    cfg.save(tmp_path / "cfg.json")
    common = ["--config_path", str(tmp_path / "cfg.json"), "--override",
              "Env.platform=cpu"]
    tev.main(common + ["--task", "VPE", "--max_batches", "1", "--baseline",
                       "--gif_dir", str(tmp_path / "eval_gifs"), "--out",
                       str(tmp_path / "r.json")])
    written = json.loads((tmp_path / "r.json").read_text())
    assert written["task"] == "VPE" and np.isfinite(written["PSNR"])
    assert "PSNR_baseline" in written
    assert json.loads(capsys.readouterr().out) == written
    assert gif_frame_count(tmp_path / "eval_gifs" / "VPE_seq0.gif") > 0
    tinf.main(common + ["--batches", "1", "--gif_dir",
                        str(tmp_path / "gifs")])
    out = json.loads(capsys.readouterr().out)
    assert sorted(out) == sorted(TASKS)
    for task in TASKS:
        assert gif_frame_count(tmp_path / "gifs" / f"{task}.gif") > 0


def test_run_tasks_matches_jax(archive, shared_clips, tmp_path):
    from npvp_tpu.data.loader import DataModule as JDM
    from npvp_tpu.models.inference import VideoPredictor as JVP
    from npvp_tpu.train.inference import run_tasks as jrun

    jvp = JVP.from_weights(archive, archive.Predictor.ckpt_save_dir,
                           dtype=jnp.float32)
    want = jrun(archive, jvp, JDM(archive), TASKS, num_batches=1)
    cfg = port_config(archive)
    vp = VideoPredictor.from_checkpoints(
        cfg, cfg.Predictor.resume_AE_ckpt, cfg.Predictor.ckpt_save_dir,
        torch.float32, device="cpu")
    got = tinf.run_tasks(cfg, vp, tload.DataModule(cfg, shared_clips), TASKS,
                         num_batches=1, gif_dir=str(tmp_path))
    for task in TASKS:
        assert set(got[task]) == set(want[task]) | {"gif"}
        assert got[task]["batch_size"] == 2 and got[task]["avg_time_s"] > 0
        assert gif_frame_count(got[task]["gif"]) > 0
        if task == "HVRC":
            assert "PSNR" not in got[task]
            continue
        assert got[task]["PSNR"] == pytest.approx(want[task]["PSNR"],
                                                  abs=1e-3)
        assert got[task]["SSIM"] == pytest.approx(want[task]["SSIM"],
                                                  rel=1e-4)


@pytest.mark.parametrize("channels", [1, 3])
def test_gif_decodes_to_the_quantised_frames(tmp_path, channels):
    """``save_clip_gifs`` pads the shorter clip with its last frame, joins
    the strips on the width, renormalises and clips; PIL reads back every
    frame of the writer's own palette exactly, 12 hundredths of a second
    each, looping."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(channels)
    a = rng.uniform(-0.3, 1.3, (5, 24, 20, channels)).astype(np.float32)
    b = rng.uniform(0, 1, (3, 24, 20, channels)).astype(np.float32)
    renorm = lambda x: x * 0.9 + 0.05  # noqa: E731
    path = tmp_path / "clips.gif"
    save_clip_gifs(path, {"a": a, "b": b}, renorm=renorm, duration_ms=125)
    b = np.concatenate([b, np.repeat(b[-1:], 2, axis=0)])
    strip = np.concatenate([np.clip(renorm(a), 0, 1), np.clip(renorm(b), 0,
                                                               1)], axis=2)
    idx, palette = gif_quantise((strip * 255).astype(np.uint8))
    want = palette[idx]
    assert gif_frame_count(path) == 5
    with Image.open(path) as im:
        assert im.info["loop"] == 0 and im.size == (40, 24)
        for t in range(5):
            im.seek(t)
            assert im.info["duration"] == 120
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          want[t])
        with pytest.raises(EOFError):
            im.seek(5)
