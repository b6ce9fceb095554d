"""The decoder tail's per-layer metric, ``head_ms.city``: its reader on a
record, and on a traced run of the windowed cell at a tiny size on the CPU
(one ``npvp.ae.head`` span a window's decode, whichever path the tail
takes)."""

import pytest

from npvp_bench import harness
from npvp_bench.tests.test_npvp_bench_windowed import BENCH, CITY, tiny


def read(rec):
    return harness.metric_reader(BENCH, "head_ms.city").read(rec)


def test_the_reader_sums_the_spans_a_request():
    rec = {"spans": {"npvp.ae.head": [0.002] * 6,
                     "npvp.serve.request": [0.6, 0.6]}}
    assert read(rec) == pytest.approx(6.0)


@pytest.mark.parametrize("spans", [
    {"npvp.ae.decode": [1.0], "npvp.serve.request": [0.6]},  # a parent
    {"npvp.ae.head": [0.002]},                                # no request
    {}])
def test_a_record_without_the_spans_reads_nothing(spans):
    assert read({"spans": spans}) is None
    assert read({}) is None


def test_a_traced_windowed_run_reports_it():
    drv = harness.load_module(BENCH / "drivers" / "serve_windowed.py",
                              "npvp_bench_driver_serve_windowed")
    rec = drv.run(tiny(CITY, trace=True))
    assert rec["correct"], rec["checks"]
    got = rec["spans"]
    assert len(got["npvp.ae.head"]) == 3 * len(got["npvp.serve.request"])
    assert read(rec) is not None and read(rec) >= 0
    assert "head_ms.city" in [m["name"] for m in harness.cell_metrics(
        harness.load_json(BENCH.parent / "BENCHMARK.json"), CITY, True)]
