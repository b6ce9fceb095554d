"""The port's report tools (``npvp_tpu_torch/tools/{quality_report,
exec_mode_fidelity,window_drift,convergence_report}.py``) against the JAX
package's root tools of the same names, on the CPU at the tiny test size:
both read one NPVP-D weights archive written by the JAX package's
``save_weights`` (through ``Predictor.ckpt_save_dir`` and
``resume_AE_ckpt``) and the same SMMNIST test clips, and run at
``num_samples 1`` (the port's latent stream is its own):

- ``quality_report`` (per task, the JSON's rows: PSNR atol 1e-3 dB, SSIM
  and MSE rtol 1e-4; the markdown's table shape; GIFs);
- ``exec_mode_fidelity``'s fp32 and bf16 arms at the same tolerances, and
  the port's four arms (pallas on the kernel's plain twin here) finite,
  with the pallas arm within 0.01 dB of the bf16 arm;
- ``window_drift``'s per-timestep PSNR/SSIM at those tolerances;
- ``convergence_report``: the same JSON from the same logs, written in the
  lines the port's trainers print, and the committed reports of the trained
  NPVP-D run from its committed logs.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread per test worker, not one per core
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from _torch_reports import (close_rows, finite, jax_tool,  # noqa: E402
                            report_config, share_clips)

from npvp_tpu_torch.tools import convergence_report as tconv  # noqa: E402
from npvp_tpu_torch.tools import exec_mode_fidelity as tfid  # noqa: E402
from npvp_tpu_torch.tools import quality_report as tqr  # noqa: E402
from npvp_tpu_torch.tools import window_drift as twd  # noqa: E402


@pytest.fixture(scope="module")
def config_yaml(tmp_path_factory):
    return report_config(tmp_path_factory.mktemp("reports"))


@pytest.fixture
def shared_clips(monkeypatch):
    share_clips(monkeypatch)


def _both(tool, args, out_dir, jax_args=None, port_args=()):
    """One run of the JAX tool and one of the port's, on the same clips;
    → their JSON reports."""
    with pytest.MonkeyPatch.context() as mp:
        share_clips(mp)
        jax_tool(tool).main((jax_args or args)
                            + ["--out_dir", str(out_dir / "jax")])
        TOOLS[tool].main(args + list(port_args)
                         + ["--out_dir", str(out_dir / "port"),
                            "--device", "cpu"])
    name = {"quality_report": "quality"}.get(tool, tool)
    return tuple(json.loads((out_dir / d / f"{name}.json").read_text())
                 for d in ("port", "jax"))


TOOLS = {"quality_report": tqr, "exec_mode_fidelity": tfid}


@pytest.fixture(scope="module")
def quality_runs(config_yaml, tmp_path_factory):
    """Both quality reports of VFP and HVRC, one run of each tool."""
    out = tmp_path_factory.mktemp("quality")
    got, want = _both("quality_report", [
        "--config_path", str(config_yaml), "--tasks", "VFP", "HVRC",
        "--max_batches", "1", "--num_samples", "1"], out)
    return got, want, out


@pytest.mark.parametrize("task", ["VFP", "HVRC"])
def test_quality_report_matches_jax(quality_runs, task):
    got, want, out = quality_runs
    assert set(got) == set(want) and list(got["tasks"]) == ["VFP", "HVRC"]
    for key in ("config", "run", "num_samples", "random_init",
                "max_batches"):
        assert got[key] == want[key], key
    g, w = got["tasks"][task], want["tasks"][task]
    assert set(g) == set(w)
    close_rows(g, w, ("", "_baseline", "_ae_ceiling"))
    assert finite(got)
    md = [(out / d / "quality.md").read_text().splitlines()
          for d in ("port", "jax")]
    assert len(md[0]) == len(md[1]) and md[0][:2] == md[1][:2]
    assert [line.count("|") for line in md[0]] == [
        line.count("|") for line in md[1]]
    gifs = [sorted(p.name for p in (out / d / "gifs").glob(f"{task}_*"))
            for d in ("port", "jax")]
    assert gifs[0] == gifs[1] == [f"{task}_seq{i}.gif" for i in range(2)]


@pytest.fixture(scope="module")
def fidelity_runs(config_yaml, tmp_path_factory):
    """JAX's fp32 and bf16 arms and the port's four arms, one run each."""
    args = ["--config_path", str(config_yaml), "--max_batches", "1"]
    out = tmp_path_factory.mktemp("fidelity")
    got, want = _both("exec_mode_fidelity", args, out,
                      jax_args=args + ["--modes", "fp32", "bf16"])
    return got, want, out


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_exec_mode_fidelity_matches_jax(fidelity_runs, mode):
    got, want, _ = fidelity_runs
    assert set(got) == set(want) and list(want["modes"]) == ["fp32", "bf16"]
    for key in ("config", "run", "task", "num_samples", "max_batches"):
        assert got[key] == want[key], key
    # random weights give an SSIM near 0.019, where rtol 1e-4 asks for
    # 2e-6. The packages round their bf16 products in different places:
    # their bf16 frames differ by about one bf16 step (mean |d| 1e-3 at
    # values near 0.25), and the SSIMs by 3.4e-5. The bf16 arm's SSIM is
    # held at atol 1e-4, rtol 1e-4 of an SSIM near 1 (a trained model's).
    close_rows(got["modes"][mode], want["modes"][mode], ("",),
               **({} if mode == "fp32" else {"ssim": dict(atol=1e-4,
                                                          rtol=0)}))
    assert set(got["modes"][mode]) == set(want["modes"][mode])


def test_exec_mode_fidelity_four_arms(fidelity_runs):
    """The port's four arms on one archive: finite, the pallas arm (the
    kernel's plain twin on the CPU) within 0.01 dB of the bf16 arm, and
    the markdown's deltas against fp32."""
    rep, _, out = fidelity_runs
    assert list(rep["modes"]) == ["fp32", "bf16", "pallas", "int8"]
    assert finite(rep)
    modes = rep["modes"]
    assert abs(modes["pallas"]["PSNR"] - modes["bf16"]["PSNR"]) < 0.01
    md = (out / "port" / "exec_mode_fidelity.md").read_text().splitlines()
    assert md[4].startswith("| fp32 |") and "+0.000" in md[4]
    assert len(md) == 8


def test_window_drift_matches_jax(config_yaml, shared_clips, tmp_path):
    args = ["--config_path", str(config_yaml), "--max_batches", "1"]
    jax_tool("window_drift").main(args + ["--out", str(tmp_path / "j.json")])
    twd.main(args + ["--out_dir", str(tmp_path / "port"), "--device",
                     "cpu"])
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "port" / "window_drift.json").read_text())
    assert set(got) == set(want)
    assert got["n_sequences"] == want["n_sequences"] == 2
    for way in ("direct", "windowed"):
        np.testing.assert_allclose(got[f"PSNR_{way}"], want[f"PSNR_{way}"],
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(got[f"SSIM_{way}"], want[f"SSIM_{way}"],
                                   atol=0, rtol=1e-4)
    for key in ("PSNR_drift_mean", "PSNR_drift_second_window"):
        assert got[key] == pytest.approx(want[key], abs=2e-3)
    assert got["SSIM_drift_mean"] == pytest.approx(want["SSIM_drift_mean"],
                                                   abs=1e-4)


def _trainer_log(path, epochs, start=0, scale=1.0):
    """Lines as the port's stage-2 trainer prints them
    (``epoch N: key=val`` at five decimals), with a line of other output
    between epochs."""
    lines = []
    for e in range(start, start + epochs):
        scalars = {"loss_train": scale * 2.0 / (1 + 0.1 * e),
                   "loss_val": scale / (1 + 0.05 * e) + 0.01 * (e % 3)}
        lines.append(f"epoch {e}: " + " ".join(
            f"{k}={v:.5f}" for k, v in scalars.items()))
        lines.append(f"step {e * 10}: saved")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("logs", ["one", "continued"])
def test_convergence_report_matches_jax(tmp_path, logs):
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    _trainer_log(a, 130)
    paths = [str(a)]
    if logs == "continued":  # a run continued from epoch 120, replaying it
        _trainer_log(b, 60, start=120, scale=0.9)
        paths.append(str(b))
    args = paths + ["--stride", "13"]
    jax_tool("convergence_report").main(args + ["--out",
                                                str(tmp_path / "j.md")])
    tconv.main(args + ["--out_dir", str(tmp_path / "port"), "--device",
                       "cpu"])
    want = (tmp_path / "j.json").read_text()
    got = (tmp_path / "port" / "convergence_loss_val.json").read_text()
    assert got == want
    rep = json.loads(got)
    assert rep["epochs"] == (180 if logs == "continued" else 130)
    md = [(tmp_path / "port" / "convergence_loss_val.md").read_text()
          .splitlines(), (tmp_path / "j.md").read_text().splitlines()]
    assert len(md[0]) == len(md[1])
    assert [x for x, y in zip(*md) if x != y] == [md[0][2]]  # the source


RESULTS = Path(__file__).resolve().parents[1] / "results" / \
    "SMMNIST_Unified_NPVP-D"


@pytest.mark.parametrize("stage,metric,logs", [
    ("stage1", "L1_loss_valid", ["train_log_stage1.txt"]),
    ("stage2", "loss_val", ["train_log_stage2.txt", "train_log_stage2b.txt"]),
])
def test_convergence_report_of_the_committed_logs(tmp_path, stage, metric,
                                                  logs):
    """The trained NPVP-D run's committed logs give the committed
    ``convergence_<stage>.json`` (written by the JAX package's tool)."""
    tconv.main([str(RESULTS / name) for name in logs]
               + ["--metric", metric, "--out", str(tmp_path / "c.md"),
                  "--device", "cpu"])
    assert (tmp_path / "c.json").read_text() == (
        RESULTS / f"convergence_{stage}.json").read_text()


def test_convergence_report_of_a_port_trainer_log(config_yaml,
                                                  shared_clips, tmp_path,
                                                  capsys):
    """The port's stage-2 trainer's own epoch lines, as it prints them:
    two epochs of two steps over the archive's AE."""
    import contextlib
    import io

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = load_config(config_yaml, [
        "Dataset.dev_set_size=4", "Predictor.epochs=2", "Env.platform=cpu",
        "Env.compute_dtype=float32", "Env.visual_callback=false",
        f"Predictor.ckpt_save_dir={tmp_path / 'ckpt'}",
        f"Predictor.tensorboard_save_dir={tmp_path / 'tb'}"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        s2.train(cfg)
    log = tmp_path / "train.log"
    log.write_text(out.getvalue())
    rows = tconv.parse_log(log)
    assert sorted(rows) == [0, 1] and "loss_val" in rows[1]
    tconv.main([str(log), "--stride", "1", "--device", "cpu"])
    md = capsys.readouterr().out
    assert "Best epoch" in md and "| 1 |" in md
