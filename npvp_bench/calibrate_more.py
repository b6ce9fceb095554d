"""Readings for the limits of the windowed serving cell, whose driver
(``serve_windowed``) ``calibrate.py``'s command line does not pick (it
knows ``serve`` and ``train``), through its own reading functions:
``calibrate.serve_readings`` (the program, and the reference in float8 as
the control), and two faults computed on the reference:

- ``half_batch``: half of each request's clips answered with the other
  half's frames;
- ``stale_context``: every window after the first observing the
  request's own frames again in place of the newest decoded ones (a
  broken hand-over between windows); its gaps are also given a window.

    python3 npvp_bench/calibrate_more.py --workload <name> --seeds 1 2 3 \\
        --control-seeds 7 8 [--controls fp8 half_batch stale_context] \\
        [--seconds 4]

Prints one JSON line a reading.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from npvp_bench import calibrate, harness  # noqa: E402
from npvp_bench.reference import windowed  # noqa: E402

CONTROLS = ["fp8", "half_batch", "stale_context"]
ROLLOUT = windowed.rollout


def half_batch(ref):
    """The reference's frames of the first half of each request's clips
    given for both halves."""
    return {i: torch.cat([r[:r.shape[0] // 2]] * 2) for i, r in ref.items()}


def stale_rollout(ae, pred, frames, num_future, eps, max_T, max_H, max_W,
                  block=None):
    """``windowed.rollout`` with every window observing ``frames``: each
    window is the rollout's first window, with its own prior sample."""
    chunk = max_T - frames.shape[1]
    outs = [ROLLOUT(ae, pred, frames, chunk,
                    None if eps is None else [eps[w]], max_T, max_H, max_W,
                    block)
            for w in range(-(-num_future // chunk))]
    return torch.cat(outs, dim=1)[:, :num_future]


def stale_context(drv, ctx, reqs, indices):
    """The reference's frames of requests ``indices`` through
    :func:`stale_rollout`."""
    windowed.rollout = stale_rollout
    try:
        return drv.reference_outputs(ctx, reqs, ctx.device, indices)
    finally:
        windowed.rollout = ROLLOUT


def readings(drv, ctx, arms):
    """{arm: numbers} for ``arms`` (``program`` and :data:`CONTROLS`) on
    one seed."""
    read = [a for a in arms if a in ("program", "fp8")]
    out = calibrate.serve_readings(drv, ctx, read) if read else {}
    faults = [a for a in arms if a in ("half_batch", "stale_context")]
    if not faults:
        return out
    reqs = drv.Requests(ctx, ctx.device)
    indices = list(range(ctx.traffic["check"]["max"]))
    ref = drv.reference_outputs(ctx, reqs, ctx.device, indices)
    if "half_batch" in faults:
        out["half_batch"] = drv.compare(half_batch(ref), ref)
    if "stale_context" in faults:
        stale = stale_context(drv, ctx, reqs, indices)
        out["stale_context"] = dict(
            drv.compare(stale, ref),
            by_window=drv.window_gaps(stale, ref, reqs.chunk))
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=CONTROLS,
                    choices=CONTROLS)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    base = harness.make_context(manifest, args.workload, 0, args.seconds,
                                False, "cuda", time.time())
    kind = base.traffic["driver"]
    if kind != "serve_windowed":
        raise SystemExit(f"{args.workload}: driver {kind!r} is "
                         "calibrate.py's")
    drv = harness.load_module(ROOT / "npvp_bench" / "drivers" / f"{kind}.py",
                              f"npvp_bench_driver_{kind}")
    # compare as many requests as a full run does
    base.traffic = dict(base.traffic, check=dict(base.traffic["check"],
                                                 fraction=1.0))
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        arms = (["program"] if seed in args.seeds else []) + (
            args.controls if seed in args.control_seeds else [])
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
