"""Serving a full weights archive at a cut depth, the frontier tool and the
memory report of the port (``npvp_tpu_torch/tools/{weights,frontier,
memory_report}.py``) against the JAX package's, on the CPU:

- ``VideoPredictor.from_weights`` on a config with fewer decoder or
  EVT-former layers than the JAX-written archive gives JAX's frames
  (fp32, atol 1e-4); a leftover leaf outside the trailing blocks still
  raises ``KeyError``;
- ``frontier``'s quality part (``--no_fps --quality``) equals JAX's per
  variant (PSNR atol 1e-3 dB, SSIM and MSE rtol 1e-4), and its
  throughput part runs on the port (launches a forward: 0 on the CPU,
  where the kernel's plain twin serves);
- ``memory_report``'s replicated and TP rows equal the MB/device JAX's tool
  prints at data 4 and model 2. Its FSDP rows are FSDP2's rule (every
  parameter on dimension 0): JAX shards only leaves of 2^15 elements or
  more, on a free dimension the data axis divides. The port's predictor
  under JAX's rule gives JAX's rows, so that rule is the whole difference.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_reports import (close_rows, finite, jax_tool,  # noqa: E402
                            report_config, share_clips)

from npvp_tpu_torch.core.config import load_config  # noqa: E402
from npvp_tpu_torch.models.inference import VideoPredictor  # noqa: E402
from npvp_tpu_torch.tools import frontier as tfront  # noqa: E402
from npvp_tpu_torch.tools import memory_report as tmem  # noqa: E402
from npvp_tpu_torch.tools.weights import load_weights  # noqa: E402


@pytest.fixture(scope="module")
def deep_yaml(tmp_path_factory):
    """The tiny config at 4 decoder and 2 EVT-former layers, and its
    JAX-written archive."""
    return report_config(tmp_path_factory.mktemp("frontier"),
                         transformer_layers=4)


@pytest.fixture
def shared_clips(monkeypatch):
    share_clips(monkeypatch)


@pytest.mark.parametrize("cut", [{"transformer_layers": 2},
                                 {"evt_former_num_layers": 1}],
                         ids=["decoder", "evt_former"])
def test_cut_depth_serves_a_full_archive_as_jax(deep_yaml, cut):
    from npvp_tpu.core.config import load_config as jload_config
    from npvp_tpu.models.inference import VideoPredictor as JVP

    jcfg, cfg = jload_config(deep_yaml), load_config(deep_yaml)
    for c in (jcfg, cfg):
        for k, v in cut.items():
            setattr(c.Predictor, k, v)
        c.validate()
    npz = cfg.Predictor.ckpt_save_dir
    past = np.random.default_rng(3).uniform(
        0, 1, (2, 4, 32, 32, 1)).astype(np.float32)
    want = np.asarray(JVP.from_weights(jcfg, npz, dtype=jnp.float32).vfp(
        jnp.asarray(past), 4))
    vp = VideoPredictor.from_weights(cfg, npz, torch.float32, device="cpu")
    stack = (vp.predictor.decoder if "transformer_layers" in cut
             else vp.predictor.evt_former_stack)
    assert stack.num_layers == next(iter(cut.values()))
    got = vp.vfp(past, 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("leaf", ["decoder/stray", "decoder/layer_1/stray"])
def test_a_stray_leftover_leaf_still_raises(deep_yaml, leaf):
    """A leaf outside every trailing block: beside the stack, or in a
    block that the cut config keeps (layer 1 of 2)."""
    cfg = load_config(deep_yaml, ["Predictor.transformer_layers=2"])
    ae_vars, pred_vars, _ = load_weights(cfg.Predictor.ckpt_save_dir)
    node = pred_vars["params"]
    *path, name = leaf.split("/")
    for p in path:
        node = node[p]
    node[name] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="not used by the module"):
        VideoPredictor.from_variables(cfg, ae_vars, pred_vars,
                                      torch.float32, device="cpu")


def test_frontier_quality_matches_jax(deep_yaml, shared_clips, tmp_path):
    args = ["--config_path", str(deep_yaml), "--variants", "full",
            "L2evt1", "--no_fps", "--quality", "--tasks", "VFP",
            "--max_batches", "1"]
    jax_tool("frontier").main(args + ["--out_dir", str(tmp_path / "jax")])
    tfront.main(args + ["--out_dir", str(tmp_path / "port"), "--device",
                        "cpu"])
    want = json.loads((tmp_path / "jax" / "frontier.json").read_text())
    got = json.loads((tmp_path / "port" / "frontier.json").read_text())
    assert set(got) - set(want) == {"quality_dtype"}
    assert got["variants"] == want["variants"] == ["full", "L2evt1"]
    for name in got["variants"]:
        assert set(got["quality"][name]) == {"VFP"}
        assert set(got["quality"][name]["VFP"]) == set(
            want["quality"][name]["VFP"])
        close_rows(got["quality"][name]["VFP"], want["quality"][name]["VFP"],
                   ("", "_baseline"))
    # the cut variant differs from the full model
    assert got["quality"]["L2evt1"]["VFP"]["PSNR"] != pytest.approx(
        got["quality"]["full"]["VFP"]["PSNR"], abs=1e-3)
    md = [(tmp_path / d / "frontier.md").read_text().splitlines()
          for d in ("port", "jax")]
    assert len(md[0]) == len(md[1]) == 10


def test_frontier_throughput_on_the_port(deep_yaml, tmp_path):
    tfront.main(["--config_path", str(deep_yaml), "--variants", "full",
                 "L2evt1", "--fps_blocks", "2", "--fps_calls", "1",
                 "--out_dir", str(tmp_path), "--device", "cpu"])
    rep = json.loads((tmp_path / "frontier.json").read_text())
    assert rep["variants"] == ["full", "L2evt1"] and "quality" not in rep
    assert finite(rep["fps"])
    for name, row in rep["fps"].items():
        assert row["fps"] == pytest.approx(64 * 4 / row["sec_per_batch_min"])
        assert len(row["speedup_vs_full_rounds"]) == 2
        # the plain twin serves
        assert row["launches_per_forward"] == {"oproj": 0, "attn": 0}
    assert rep["fps"]["full"]["speedup_vs_full_median"] == 1.0
    assert "| L2evt1 |" in (tmp_path / "frontier.md").read_text()


def _jax_rule_mb(predictor, data, model, tp):
    """MB a rank of the port's train state under JAX's FSDP rule
    (``npvp_tpu/core/mesh.py`` ``_with_fsdp``): leaves of at least 2^15
    elements, sharded on a dimension that TP left free and the data axis
    divides."""
    from npvp_tpu_torch.core.tensor_parallel import tensor_parallel_plan

    plan = tensor_parallel_plan(predictor, model) if tp else {}
    total = 0
    for name, p in predictor.named_parameters():
        shape, nbytes = list(p.shape), p.numel() * p.element_size()
        tp_dim = plan.get(name)
        if tp_dim is not None:
            nbytes //= model
        free = [d for d in range(len(shape)) if d != tp_dim
                and shape[d] >= data and shape[d] % data == 0]
        if math.prod(shape) >= 2 ** 15 and free:
            nbytes //= data
        total += 3 * nbytes
    total += sum(b.numel() * b.element_size()
                 for b in predictor.buffers())
    return total / 2 ** 20


def test_memory_report_matches_jax(capsys):
    jax_tool("memory_report").main(["--data", "4", "--model", "2"])
    want = {line.split("  ")[1].strip(): float(line.split()[-2])
            for line in capsys.readouterr().out.splitlines()
            if line.endswith("MB/device")}
    tmem.main(["--data", "4", "--model", "2", "--device", "cpu"])
    printed = {line.split("  ")[1].strip(): float(line.split()[-2])
               for line in capsys.readouterr().out.splitlines()
               if line.endswith("MB/device")}
    rows = dict(tmem.rows(4, 2))
    assert list(printed) == list(want) == list(rows)
    for name in ("replicated (plain DP)", "TP over model=2"):
        assert printed[name] == want[name], name
    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.models.predictor import build_predictor

    with torch.device("meta"):
        predictor = build_predictor(flagship_config(), torch.bfloat16)
    for name, tp in (("FSDP over data=4", False), ("TP + FSDP", True)):
        # the stated difference: FSDP2's rule shards the small leaves too
        assert rows[name] < want[name]
        assert round(_jax_rule_mb(predictor, 4, 2, tp), 1) == want[name]
        assert rows[name] == pytest.approx(
            tmem.state_bytes(predictor, 4, 2, fsdp=True, tp=tp) / 2 ** 20)
