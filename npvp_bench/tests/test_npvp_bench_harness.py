"""The harness: cells found by name from files, nothing that it runs
importing JAX or the JAX package, no result without a card, and
``correct`` that comes out false when the timed path is broken
underneath (the harness driven on the CPU at a tiny size)."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from npvp_bench import harness
from npvp_bench.tests._tiny import ROOT, tiny_context

BENCH = ROOT / "npvp_bench"
# sound runs at float32 read ~1e-6 here (see the reference's tests)
TIGHT = {"frames_rel_rms": 1e-3, "frames_max_abs": 1e-3}
TIGHT_TRAIN = {"loss_gap": 1e-3, "grad_norm_gap": 1e-3,
               "update_norm_gap": 1e-3, "timed_loss_gap": 1e-3,
               "timed_grad_norm_gap": 1e-3, "timed_update_norm_gap": 1e-3}


def _run(ctx, root=ROOT):
    m = harness.load_json(root / "BENCHMARK.json")
    return harness.run_cell(m, ctx, root)


# ---------------------------------------------------------- data-driven


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "npvp_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_found_by_name_from_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "npvp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)
    bench = tmp_path / "npvp_bench"
    cfg = tiny_context("kth_serve_vfp_b64").config
    (bench / "configs" / "tiny_model.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "vfp_b64.json").read_text())
    traffic.update(batch=3, warmup_requests=1, trace_requests=1,
                   check={"fraction": 1.0, "max": 2})
    (bench / "traffic" / "tiny_vfp.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny_cell.json").write_text(json.dumps(TIGHT))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(rec):\n    return rec['requests']\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_model", "source": "test",
                         "file": "npvp_bench/configs/tiny_model.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny_cell", "config": "tiny_model",
                           "traffic": "tiny_vfp", "chips": 1,
                           "why": "test"})
    m["end_to_end"].append({"name": "requests_done", "unit": "requests",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["tiny_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    ctx = harness.make_context(m, "tiny_cell", 3, 0.5, False, "cpu",
                               time.time(), root=tmp_path)
    result = _run(ctx, tmp_path)
    assert result["correct"], result["checks"]
    assert result["metrics"]["requests_done"]["value"] >= 1
    # the metrics with a ``workloads`` list name only the cells they have
    assert "setup_s" in result["metrics"]
    assert "frames_per_s" not in result["metrics"]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name,reader", [
    ("mfu.serve", "mfu.py"), ("mfu.train", "mfu.py"),
    ("frames_per_s.b1", "frames_per_s.py"), ("peak_gib", "peak_gib.py"),
    ("frames_per_s.b1_host", "frames_per_s.py"),
    ("request_ms_p90.b1_host", "request_ms_p90.py"),
    ("dispatch_ms.train", "dispatch_ms.py")])
def test_metrics_of_one_quantity_share_a_reader(name, reader):
    module = harness.metric_reader(BENCH, name)
    assert module.__file__ == str(BENCH / "metrics" / reader)


def test_a_metric_file_of_its_own_comes_before_the_shared_one(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "rate.py").write_text(
        "def read(rec):\n    return 1.0\n")
    (tmp_path / "metrics" / "rate.b1.py").write_text(
        "def read(rec):\n    return 2.0\n")
    assert harness.metric_reader(tmp_path, "rate.b1").read({}) == 2.0
    assert harness.metric_reader(tmp_path, "rate.b64").read({}) == 1.0


@pytest.mark.parametrize("workload", ["kth_serve_vfp_b64",
                                      "kth_serve_mixed_b1",
                                      "smmnist_train_b8"])
def test_the_profiler_runs_after_the_window(workload, monkeypatch):
    """A traced run profiles only once its window has closed: the
    profiler leaves every later launch slower, and the window's host
    times would carry that."""
    from npvp_bench import trace as T

    events = []
    close, before = T.Pace.close, T.TracePlan.before
    monkeypatch.setattr(T.Pace, "close", lambda self: (
        events.append("window closed"), close(self))[1])
    monkeypatch.setattr(T.TracePlan, "before", lambda self, i: (
        events.append("profiled item"), before(self, i))[1])
    limits = TIGHT_TRAIN if workload.startswith("smmnist") else TIGHT
    result = _run(tiny_context(workload, seconds=0.3, trace=True,
                               limits=limits))
    assert result["correct"], result["checks"]
    assert events[0] == "window closed" and "profiled item" in events
    assert any(m.startswith("mfu.") for m in result["metrics"])


def test_every_metric_moves_what_its_cells_report():
    """A per-layer metric's ``moves`` is an end-to-end metric that each of
    its cells reports, and every cell reports ``setup_s``, another
    end-to-end metric and a per-layer one."""
    m = harness.load_json(ROOT / "BENCHMARK.json")
    for cell in m["workloads"]:
        e2e = {x["name"] for x in harness.cell_metrics(m, cell["name"],
                                                      False)}
        layer = harness.cell_metrics(m, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell["name"]
        for x in layer:
            assert x["moves"] in e2e, (cell["name"], x["name"])


# -------------------------------------------------------------- isolation


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "npvp_tpu")]
    assert not bad, bad


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    assert run.forbidden_modules(["npvp_tpu_torch.models", "jaxtyping",
                                  "flaxen", "torch"]) == []
    assert run.forbidden_modules(["npvp_tpu.core", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "npvp_tpu"]


PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/npvp_bench")
import run
from npvp_bench import harness
from npvp_bench.tests._tiny import tiny_context, manifest
for w in ("kth_serve_vfp_b64", "kth_serve_mixed_b1", "smmnist_train_b8"):
    for trace in (False, True):
        ctx = tiny_context(w, seconds=0.3, trace=trace)
        harness.run_cell(manifest(), ctx)
print(json.dumps(run.forbidden_modules()))
"""


def test_nothing_the_runs_load_imports_jax():
    """Every module that a run of each driver loads, the port's included,
    followed transitively by the interpreter itself."""
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "kth_serve_vfp_b64", "--seed",
                          "2147483999", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


# ----------------------------------------------------------------- faults


@pytest.mark.parametrize("workload", ["kth_serve_vfp_b64",
                                      "kth_serve_mixed_b1"])
def test_a_sound_served_run_is_correct(workload):
    result = _run(tiny_context(workload, limits=TIGHT, seconds=0.5))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", ["kth_serve_vfp_b64",
                                      "kth_serve_mixed_b1"])
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch):
    from npvp_tpu_torch.nn import resnet_ae

    decode = resnet_ae.FrameAutoEncoder.decode

    def altered(self, feats):
        out = decode(self, feats).clone()
        out[0, 0] += 0.05  # one predicted frame of the first clip
        return out

    monkeypatch.setattr(resnet_ae.FrameAutoEncoder, "decode", altered)
    result = _run(tiny_context(workload, limits=TIGHT, seconds=0.5))
    assert not result["correct"], result["checks"]


def test_a_sound_train_run_is_correct():
    result = _run(tiny_context("smmnist_train_b8", limits=TIGHT_TRAIN,
                               seconds=0.5))
    assert result["correct"], result["checks"]


# A fault planted from the step with this train-state step count on: 0
# breaks every step; 4 breaks only the window's (the tiny traffic runs 3
# checked steps and 1 warm-up step in set-up), as a change that switches
# in after warm-up would, such as a captured graph replayed from then on.
FROM_STEP = {"every step": 0, "window steps only": 4}


@pytest.mark.parametrize("where", list(FROM_STEP))
def test_a_step_that_leaves_the_state_unchanged(where, monkeypatch):
    from npvp_tpu_torch.core.train_state import TrainState

    apply = TrainState.apply_gradients

    def unchanged(self):
        if self.step < FROM_STEP[where]:
            return apply(self)
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)
    result = _run(tiny_context("smmnist_train_b8", limits=TIGHT_TRAIN,
                               seconds=0.5))
    assert not result["correct"]
    checks = result["checks"]
    assert checks["timed_update_norm_gap"]["value"] == pytest.approx(1)
    if where == "every step":
        assert checks["update_norm_gap"]["value"] == pytest.approx(1)
    else:
        assert checks["update_norm_gap"]["value"] <= 1e-3, checks


@pytest.mark.parametrize("where", list(FROM_STEP))
def test_half_of_the_batch_left_out(where, monkeypatch):
    from npvp_tpu_torch.train import stage2_predictor as s2

    make_steps = s2.make_steps

    def halved(*args, **kw):
        steps = make_steps(*args, **kw)

        def train(state, batch, rng):
            if state.step < FROM_STEP[where]:
                return steps.train(state, batch, rng)
            n = batch["clip"].shape[0] // 2
            return steps.train(state, {k: (v[:n] if v.dim() > 1 else v)
                                       for k, v in batch.items()}, rng)

        return steps._replace(train=train)

    monkeypatch.setattr(s2, "make_steps", halved)
    result = _run(tiny_context("smmnist_train_b8", limits=TIGHT_TRAIN,
                               seconds=0.5, batch=4))
    assert not result["correct"], result["checks"]
    assert (result["checks"]["timed_grad_norm_gap"]["value"]
            > TIGHT_TRAIN["timed_grad_norm_gap"]), result["checks"]
