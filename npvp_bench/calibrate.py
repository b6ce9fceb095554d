"""Readings that the limits of ``limits/<workload>.json`` are set from: the
program's numbers on many seeds, and its controls' on a few, in one
process at the cell's own size.

    python3 npvp_bench/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        --control-seeds 7 8 9 [--seconds 4]

Serving cells: each seed runs a short window of the cell's traffic and
compares as many requests as a full run does (``check.max``); the control
is the reference computed in float8 (``reference/model.py``'s
``set_precision("fp8")``) on the same requests, against the float32
reference. Training cells: each seed runs the loop's checked set-up steps
and its window up to the checked window step; the controls are the
reference in float8 and the reference with half of each batch left out,
the mean taken over the rest, each put in the program's place. Prints one
JSON line a reading.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from npvp_bench import harness  # noqa: E402

CONTROLS = {"serve": ["fp8"], "train": ["fp8", "half_batch"]}


def serve_readings(drv, ctx, arms):
    """{arm: numbers} for ``arms`` (``program``, ``fp8``) on one seed."""
    reqs = drv.Requests(ctx, ctx.device)
    if "program" in arms:
        vp = drv.build_program(ctx, ctx.device)
        kept = drv.window(ctx, vp, reqs, ctx.device, ctx.seconds)["kept"]
        del vp
        harness.free_device()
    else:
        kept = dict.fromkeys(range(ctx.traffic["check"]["max"]))
    ref = drv.reference_outputs(ctx, reqs, ctx.device, list(kept))
    out = {}
    if "program" in arms:
        out["program"] = drv.compare(kept, ref)
    if "fp8" in arms:
        low = drv.reference_outputs(ctx, reqs, ctx.device, list(kept), "fp8")
        out["fp8"] = drv.compare(low, ref)
    return out


def train_readings(drv, ctx, arms):
    """{arm: numbers} for ``arms`` (``program``, ``fp8``, ``half_batch``)
    on one seed: the program runs in every case, since the controls replay
    its batches, step seeds and state."""
    _, program, inputs = drv.run_program(ctx, ctx.device)
    harness.free_device()
    ref = drv.reference_numbers(ctx, ctx.device, inputs)
    out = {}
    for arm in arms:
        if arm == "program":
            out[arm] = drv.compare(program, ref)
        else:
            low = drv.reference_numbers(
                ctx, ctx.device, inputs,
                precision="fp8" if arm == "fp8" else "fp32",
                half=arm == "half_batch")
            out[arm] = drv.compare(low, ref)
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=None)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    base = harness.make_context(manifest, args.workload, 0, args.seconds,
                                False, "cuda", time.time())
    kind = base.traffic["driver"]
    drv = harness.load_module(ROOT / "npvp_bench" / "drivers" / f"{kind}.py",
                              f"npvp_bench_driver_{kind}")
    readings = serve_readings if kind == "serve" else train_readings
    controls = args.controls or CONTROLS[kind]
    if kind == "serve":  # compare as many requests as a full run does
        base.traffic = dict(base.traffic, check=dict(
            base.traffic["check"], fraction=1.0))
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        arms = (["program"] if seed in args.seeds else []) + (
            controls if seed in args.control_seeds else [])
        ctx = copy.copy(base)
        ctx.seed, ctx.seconds, ctx.start_time = seed, args.seconds, time.time()
        t0 = time.time()
        for arm, values in readings(drv, ctx, arms).items():
            print(json.dumps({"workload": args.workload, "arm": arm,
                              "seed": seed, "seconds": time.time() - t0,
                              **values}), flush=True)
        harness.free_device()
    print(f"card: {harness.power_limit()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
