"""The controls of ``correct``: a program below its stated precision must
read worse than the program as configured. The control is the reference
computed in float8 in the program's place (the program's own int8 serving
path reads within 1.1-2.4 times the bfloat16 program on the card, too
close to set a limit from: ``PERF.md``), and for training also the
reference with half of each batch left out, in the set-up steps replayed
from the seed's weights and in the window step replayed from the
program's state. On the CPU at a tiny size the
controls read at least three times what the bfloat16 program does; on the
card (``-m cuda``) at the cells' own sizes the program passes its limits
and every control fails one of them:

    python -m pytest npvp_bench/tests -m cuda
"""

import copy
import time

import pytest
import torch

from npvp_bench import check, harness
from npvp_bench.tests._tiny import ROOT, manifest, tiny_context

calibrate = harness.load_module(ROOT / "npvp_bench" / "calibrate.py",
                                "npvp_bench_calibrate")


def _driver(ctx):
    kind = ctx.traffic["driver"]
    return harness.load_module(ROOT / "npvp_bench" / "drivers" /
                               f"{kind}.py", f"npvp_bench_driver_{kind}")


def _readings(ctx, arms):
    drv = _driver(ctx)
    fn = (calibrate.serve_readings if ctx.traffic["driver"] == "serve"
          else calibrate.train_readings)
    return fn(drv, copy.copy(ctx), arms)


@pytest.mark.parametrize("workload,number,controls", [
    ("kth_serve_vfp_b64", "frames_rel_rms", ["fp8"]),
    ("smmnist_train_b8", "grad_norm_gap", ["fp8", "half_batch"]),
    ("smmnist_train_b8", "timed_grad_norm_gap", ["half_batch"])])
def test_controls_read_worse_than_the_program_on_the_cpu(workload, number,
                                                         controls):
    ctx = tiny_context(workload, dtype="bfloat16", seconds=0.3, batch=4)
    if ctx.traffic["driver"] == "serve":
        ctx.traffic = dict(ctx.traffic, check={"fraction": 1.0, "max": 2})
    readings = _readings(ctx, ["program"] + controls)
    for arm in controls:
        assert readings[arm][number] >= 3 * readings["program"][number], arm


@pytest.mark.cuda
@pytest.mark.parametrize("workload,controls", [
    ("kth_serve_vfp_b64", ["fp8"]),
    ("kth_serve_mixed_b1", ["fp8"]),
    ("smmnist_train_b8", ["fp8", "half_batch"])])
def test_controls_fail_the_limits_on_the_card(workload, controls):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx = harness.make_context(manifest(), workload, 2147483777, 3.0, False,
                               "cuda", time.time())
    if ctx.traffic["driver"] == "serve":
        ctx.traffic = dict(ctx.traffic, check=dict(ctx.traffic["check"],
                                                   fraction=1.0))
    readings = _readings(ctx, ["program"] + controls)
    ok, rows = check.judge(readings["program"], ctx.limits)
    assert ok, rows
    for arm in controls:
        ok, rows = check.judge(readings[arm], ctx.limits)
        assert not ok, (arm, rows)
