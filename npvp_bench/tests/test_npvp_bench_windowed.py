"""The windowed serving cell, driven through the harness on the CPU at a
tiny size: its record and readers, ``correct`` that comes out false when
the rollout or an answer is broken, the reading of the port's spans from
a trace, and the limits' faults of ``calibrate_more.py``."""

import copy
import time

import pytest
import torch

from npvp_bench import harness, spans
from npvp_bench.tests._tiny import ROOT, TINY, manifest
from npvp_bench.tests.test_npvp_bench_yardstick import _Event

BENCH = ROOT / "npvp_bench"
CITY = "cityscapes_serve_vfp"
# sound float32 runs read ~1e-6 here, as the other tiny cells do
TIGHT = {"frames_rel_rms": 1e-3, "frames_max_abs": 1e-3}
TINY_TRAFFIC = {"batch": 2, "warmup_requests": 1, "trace_requests": 1,
                "check": {"fraction": 0.5, "max": 2}, "reference_block": 1}


def tiny(workload, seconds=0.5, trace=False, limits=None, seed=2 ** 31 + 7):
    ctx = harness.make_context(manifest(), workload, seed, seconds, trace,
                               "cpu", time.time())
    ctx.config = copy.deepcopy(ctx.config)
    for group, values in TINY.items():
        ctx.config["config"][group].update(values)
    ctx.config["config"]["Env"]["compute_dtype"] = "float32"
    ctx.traffic = dict(ctx.traffic, **TINY_TRAFFIC)
    ctx.limits = dict(limits or TIGHT)
    return ctx


def _run(ctx):
    return harness.run_cell(manifest(), ctx)


# ------------------------------------------------------------- windowed


def test_a_windowed_run_counts_every_predicted_frame_and_is_correct():
    ctx = tiny(CITY, trace=True)
    drv = harness.load_module(BENCH / "drivers" / "serve_windowed.py",
                              "npvp_bench_driver_serve_windowed")
    rec = drv.run(ctx)
    assert rec["correct"], rec["checks"]
    assert rec["frames"] == rec["requests"] * 2 * 28
    # three windows a request, each with its encoder's four non-local
    # attentions (the tiny AE's 1 + the Cityscapes config's 3 res blocks)
    got = rec["spans"]
    assert len(got["npvp.serve.request"]) == 1
    assert len(got["npvp.serve.window"]) == 3
    assert len(got["npvp.ae.nonlocal"]) == 3 * 4
    reqs = drv.Requests(ctx, "cpu")
    assert reqs.windows == 3
    assert rec["flops"] == rec["requests"] * drv.request_flops(ctx, reqs)
    for name in ("window_ms.city", "nonlocal_ms.city", "mfu.city",
                 "enqueue_ms.city"):
        assert harness.metric_reader(BENCH, name).read(rec) is not None


def test_the_cells_metrics_in_a_traced_line():
    result = _run(tiny(CITY, trace=True))
    assert result["correct"], result["checks"]
    assert {"window_ms.city", "nonlocal_ms.city", "mfu.city",
            "enqueue_ms.city"} <= set(result["metrics"])
    e2e = _run(tiny(CITY))["metrics"]
    assert {"frames_per_s", "request_ms_p90", "setup_s"} <= set(e2e)


def test_only_the_traced_stretch_turns_the_programs_spans_on(monkeypatch):
    from npvp_tpu_torch.core import tracing

    turned_on = []
    enable = tracing.enable
    monkeypatch.setattr(tracing, "enable", lambda: (turned_on.append(1),
                                                    enable())[1])
    assert _run(tiny(CITY))["correct"]
    assert turned_on == [] and not tracing.enabled()
    assert _run(tiny(CITY, trace=True))["correct"]
    assert turned_on == [1] and not tracing.enabled()
    assert tracing.take() == []


def test_a_rollout_that_hands_on_the_wrong_frames(monkeypatch):
    """Every window observing the request's own frames in place of the
    newest decoded ones: the first window is right, the rest are not."""
    from npvp_tpu_torch.models import inference

    def stale(self, past, num_future, eps=None, generator=None,
              chunk=None):
        P = past.shape[1]
        chunk = self.cfg.Predictor.max_T - P
        outs = [self.predict(past, list(range(P)),
                             list(range(P, P + chunk)), eps=eps[w])
                for w in range(-(-num_future // chunk))]
        return torch.cat(outs, dim=1)[:, :num_future]

    monkeypatch.setattr(inference.VideoPredictor, "vfp_windowed", stale)
    result = _run(tiny(CITY))
    assert not result["correct"], result["checks"]


def test_an_answer_altered_in_the_last_window(monkeypatch):
    from npvp_tpu_torch.models import inference

    windowed = inference.VideoPredictor.vfp_windowed

    def altered(self, *args, **kw):
        out = windowed(self, *args, **kw).clone()
        out[0, -1] += 0.05  # the last predicted frame of the first clip
        return out

    monkeypatch.setattr(inference.VideoPredictor, "vfp_windowed", altered)
    assert not _run(tiny(CITY))["correct"]


def test_the_windowed_entry_refuses_other_tasks():
    ctx = tiny(CITY)
    drv = harness.load_module(BENCH / "drivers" / "serve_windowed.py",
                              "npvp_bench_driver_serve_windowed")
    traffic = dict(ctx.traffic, tasks=[{"name": "VFP", "observe": [0, 2],
                                        "predict": list(range(3, 10))}])
    with pytest.raises(ValueError):
        drv.caller(None, traffic, None)


def test_the_limits_faults_fail_where_they_break_the_rollout():
    """``calibrate_more.py``'s faults on the reference: a broken hand-over
    leaves the first window exact and fails the later ones; half the
    clips answered with the other half's frames fails."""
    cal = harness.load_module(BENCH / "calibrate_more.py",
                              "npvp_bench_calibrate_more")
    drv = harness.load_module(BENCH / "drivers" / "serve_windowed.py",
                              "npvp_bench_driver_serve_windowed")
    from npvp_bench.reference import windowed

    ctx = tiny(CITY)
    got = cal.readings(drv, ctx, ["half_batch", "stale_context"])
    assert windowed.rollout is cal.ROLLOUT
    stale = got["stale_context"]
    assert stale["compared_requests"] == 2
    first, *later = stale["by_window"]
    assert len(later) == 2 and first == (0.0, 0.0)
    for gaps in later:
        assert all(g > TIGHT[k] for g, k in zip(gaps, TIGHT))
    assert got["half_batch"]["frames_rel_rms"] > TIGHT["frames_rel_rms"]


# ---------------------------------------------------------- the readers


def test_span_device_time():
    ev = [_Event("npvp.serve.window", 0, 40, annotation=True),
          _Event("npvp.serve.window", 50, 90, annotation=True),
          _Event("npvp.ae.nonlocal", 1, 9, annotation=True),
          _Event("cudaLaunchKernel", 2, 3, corr=1),
          _Event("cudaLaunchKernel", 10, 11, corr=2),
          _Event("cudaLaunchKernel", 60, 61, corr=3),
          _Event("conv_a", 20, 30, cuda=True, corr=1),
          _Event("gemm_b", 32, 38, cuda=True, corr=2),
          _Event("elementwise_c", 70, 75, cuda=True, corr=3),
          _Event("other_d", 25, 50, cuda=True, corr=9)]
    got = spans.span_device_s(ev)
    # the first window launched both of its kernels: 10 + 6 ns; a kernel
    # that outlasts the last of them is not counted
    assert got["npvp.serve.window"] == pytest.approx([16e-9, 5e-9])
    assert got["npvp.ae.nonlocal"] == pytest.approx([10e-9])


def test_the_readers_of_the_new_metrics():
    read = lambda name, rec: harness.metric_reader(  # noqa: E731
        BENCH, name).read(rec)
    rec = {"spans": {"npvp.serve.window": [0.1, 0.3, 0.2],
                     "npvp.ae.nonlocal": [0.01] * 6,
                     "npvp.serve.request": [0.6, 0.6]}}
    assert read("window_ms.city", rec) == pytest.approx(200)
    assert read("nonlocal_ms.city", rec) == pytest.approx(30)
    # a parent without the spans or a trace: nothing, no error
    for name in ("window_ms.city", "nonlocal_ms.city"):
        assert read(name, {"spans": {"npvp.ae.encode": [1.0]}}) is None
