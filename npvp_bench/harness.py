"""One run of one cell: find its files by name, run its driver, read its
metrics, and build the result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. The harness reads

- ``configs/<config>.json``: the configuration as it is run (``config``:
  the port's groups and values) and where it comes from;
- ``traffic/<traffic>.json``: the ``driver`` that runs it and the mix's
  parameters;
- ``drivers/<driver>.py``: ``run(ctx) -> record``, the window loop;
- ``metrics/<metric>.py``: ``read(record) -> float | None``, the reader
  of each metric of the manifest that the cell reports; where there is no
  such file, ``metrics/<the name up to its first dot>.py``, the reader
  that metrics of one quantity share (``mfu.serve`` and ``mfu.train`` are
  read by ``mfu.py``: they differ in the cells that report them and in the
  end-to-end metric that they move, not in how they are read);
- ``limits/<workload>.json``: the limit of each number compared.

Adding a cell, a configuration, a traffic mix or a metric is adding such
files (and entries in ``BENCHMARK.json``); no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module from its file, under a private name."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Context:
    """What a driver gets: the run's arguments and the cell's files."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    limits: Dict[str, float]
    start_time: float       # time.time() when the run's process started

    @property
    def model_config(self) -> dict:
        return self.config["config"]


def find_cell(manifest: dict, workload: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(manifest: dict, workload: str, trace: bool):
    """The manifest's metrics that this cell reports in this mode: the
    end-to-end ones with ``trace`` off, the per-layer ones with it on; a
    metric without ``workloads`` is every cell's."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def make_context(manifest: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device: str, start_time: float,
                 root: Path = ROOT) -> Context:
    cell = find_cell(manifest, workload)
    bench = root / "npvp_bench"
    limits = load_json(bench / "limits" / f"{workload}.json")
    return Context(workload, seed, seconds, trace, device,
                   load_json(bench / "configs" / f"{cell['config']}.json"),
                   load_json(bench / "traffic" / f"{cell['traffic']}.json"),
                   {k: float(v) for k, v in limits.items()}, start_time)


def metric_reader(bench: Path, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or else the
    shared ``metrics/<name up to its first dot>.py``."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "npvp_bench_metric_"
                       + path.stem.replace(".", "_"))


def run_cell(manifest: dict, ctx: Context, root: Path = ROOT) -> dict:
    """Run the cell's driver and return the result line's object."""
    bench = root / "npvp_bench"
    kind = ctx.traffic["driver"]
    driver = load_module(bench / "drivers" / f"{kind}.py",
                         f"npvp_bench_driver_{kind}")
    rec = driver.run(ctx)
    rec.setdefault("compute_dtype", ctx.model_config["Env"]["compute_dtype"])
    if ctx.trace:
        from npvp_bench.trace import describe
        log("device stretch " + describe(rec.get("device_trace")))
        log("host stretch " + describe(rec.get("trace")))
    metrics = {}
    for m in cell_metrics(manifest, ctx.workload, ctx.trace):
        value = metric_reader(bench, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": rec["device"]}
    if ctx.trace and rec.get("breakdown"):
        result["breakdown"] = rec["breakdown"]
    result["checks"] = rec["checks"]
    return result


def synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free_device() -> None:
    """Return what freed tensors held to the device."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(peak_bytes: int, trace_summary=None) -> dict:
    """The result line's ``device``: the card, the count, the process's
    peak of allocated bytes and, traced, the busy and window seconds."""
    import torch

    info = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if torch.cuda.is_available() else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if trace_summary is not None:
        info["busy_s"] = trace_summary.busy_s
        info["window_s"] = trace_summary.window_s
    return info


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def stamp(ctx: Context, what: str) -> None:
    """Log the seconds since the run's process started, at a point of
    set-up."""
    log(f"set-up: {what} at {time.time() - ctx.start_time:.3f} s")


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
