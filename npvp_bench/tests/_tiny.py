"""Tiny cells for the CPU tests: the shipped configurations cut to a few
channels and layers, short traffic, the harness driven on the CPU."""

from __future__ import annotations

import copy
import time
from pathlib import Path

from npvp_bench import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"Dataset": {"img_size": 32},
        "AE": {"ngf": 8, "n_downsampling": 2},
        "Predictor": {"embed_dim": 32, "num_heads": 2,
                      "transformer_layers": 2, "evt_former_num_layers": 1,
                      "evt_hidden_channels": 16, "dim_feedforward": 64}}
TINY_TRAFFIC = {"vfp_b64": {"batch": 2, "warmup_requests": 1,
                            "trace_requests": 1,
                            "check": {"fraction": 0.5, "max": 2}},
                "mixed_b1": {"warmup_requests": 2, "trace_requests": 2,
                             "check": {"fraction": 0.5, "max": 4}},
                "rand_context_b8": {"warmup_steps": 1, "trace_steps": 1,
                                    "window_step": {"lo": 2, "hi": 3}}}


def manifest() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_context(workload: str, seed: int = 12345, seconds: float = 1.0,
                 trace: bool = False, limits=None, dtype="float32",
                 batch: int = 2) -> harness.Context:
    """The cell's context on the CPU at a tiny size."""
    m = manifest()
    cell = harness.find_cell(m, workload)
    ctx = harness.make_context(m, workload, seed, seconds, trace, "cpu",
                               time.time())
    ctx.config = copy.deepcopy(ctx.config)
    for group, values in TINY.items():
        ctx.config["config"][group].update(values)
    ctx.config["config"]["Env"]["compute_dtype"] = dtype
    ctx.config["config"]["Dataset"]["batch_size"] = batch
    ctx.traffic = dict(ctx.traffic, **TINY_TRAFFIC[cell["traffic"]])
    if limits is not None:
        ctx.limits = dict(limits)
    return ctx
