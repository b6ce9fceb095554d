"""The port's spans (``npvp_tpu_torch.core.tracing``) beside the benchmark:
a profiler trace that also holds the program's ``npvp.`` annotations reads
the same in every field and metric that the benchmark takes from it, and
an untraced run never turns the program's tracing on."""

import pytest

from npvp_bench import harness
from npvp_bench import trace as T
from npvp_bench.tests._tiny import ROOT, manifest, tiny_context
from npvp_bench.tests.test_npvp_bench_yardstick import _Event

SHAPES = [[2, 3, 4], [2, 3, 4], [2, 3, 4], [], [4, 4], [4], []]


def _events(with_spans: bool):
    ev = [_Event("bench.request.call", 0, 100, annotation=True),
          _Event("bench.predictor", 10, 60, annotation=True),
          _Event("cudaLaunchKernel", 12, 13, corr=7),
          _Event("cudaLaunchKernel", 20, 21, corr=8),
          _Event("cudaLaunchKernel", 70, 71, corr=9),
          _Event("npvp::temporal_attention", 19, 25, shapes=SHAPES),
          _Event("gemm_a", 15, 35, cuda=True, corr=7),
          _Event("temporal_attention_hopper", 30, 50, cuda=True, corr=8),
          _Event("unlinked_elementwise", 51, 55, cuda=True, corr=0),
          _Event("elementwise_b", 80, 90, cuda=True, corr=9),
          _Event("Memcpy DtoH", 90, 95, cuda=True, corr=10)]
    if with_spans:  # the program's spans, inside and across the ranges
        ev += [_Event("npvp.serve.request", 1, 99, annotation=True),
               _Event("npvp.predictor", 11, 59, annotation=True),
               _Event("npvp.predictor.encoder", 11, 19, annotation=True),
               _Event("npvp.predictor.decoder", 19, 59, annotation=True),
               _Event("npvp.ae.decode", 62, 98, annotation=True)]
    return ev


def _fields(t):
    return {k: getattr(t, k) for k in (
        "window_s", "busy_s", "kernel_s", "by_category_s", "top_kernels",
        "range_device_s", "range_counts", "op_shapes", "kernel_by_name_s",
        "kernel_counts", "idle_by_range_s")}


def test_the_programs_spans_leave_every_field_and_reading_unchanged():
    plain = T.summarize(_events(False), 100e-9, ["npvp::temporal_attention"])
    spans = T.summarize(_events(True), 100e-9, ["npvp::temporal_attention"])
    assert _fields(spans) == _fields(plain)
    assert T.breakdown(spans, spans) == T.breakdown(plain, plain)
    read = 0
    for m in manifest()["per_layer"]:
        reader = harness.metric_reader(ROOT / "npvp_bench", m["name"])
        recs = [{"trace": t, "device_trace": t, "compute_dtype": "bfloat16",
                 "flops": 1e9, "window_s": 1.0} for t in (plain, spans)]
        try:
            got = [reader.read(r) for r in recs]
        except (KeyError, TypeError):  # a reader of the window's record
            continue
        assert got[0] == got[1], m["name"]
        read += got[0] is not None
    assert read >= 3  # idle share, ae and predictor ms at least


@pytest.mark.parametrize("workload", ["kth_serve_vfp_b64",
                                      "kth_serve_mixed_b1",
                                      "smmnist_train_b8"])
def test_an_untraced_run_never_turns_the_programs_tracing_on(workload,
                                                            monkeypatch):
    from npvp_tpu_torch.core import tracing

    turned_on = []
    enable = tracing.enable
    monkeypatch.setattr(tracing, "enable", lambda: (turned_on.append(1),
                                                    enable())[1])
    tracing.disable()
    tracing.take()
    result = harness.run_cell(manifest(), tiny_context(workload,
                                                       seconds=0.3))
    assert result["correct"]
    assert turned_on == [] and not tracing.enabled()
    assert tracing.take() == []
