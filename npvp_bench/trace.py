"""The benchmark's own tracing: named host ranges around the calls into the
program's layers, and the reduction of a ``torch.profiler`` window to
device busy time, device time per range, kernel categories, per-call
shapes of one op, and idle gaps named by the range open on the host.

Everything stays in memory: the profiler's events are read once when the
window closes and reduced to a :class:`TraceSummary` of plain numbers.
"""

from __future__ import annotations

import contextlib
import gc
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

RANGE_PREFIX = "bench."
GPU_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def activity(ev) -> str:
    """The kineto activity type of a profiler event (``kernel``,
    ``gpu_memcpy``, ``gpu_memset``, ``cuda_runtime``, ``user_annotation``,
    ``cpu_op``, ...), worked out from its device and name where the
    installed torch does not give it."""
    f = getattr(ev, "activity_type", None)
    if f is not None:
        return f()
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    if _RUNTIME.match(name):
        return "cuda_runtime"
    return "cpu_op"


def category(kernel_name: str) -> str:
    """The kernel's category, by name (the sorting of the port's
    ``chip_smoke.py`` ``profile()``)."""
    low = kernel_name.lower()
    if "temporal_attention" in low:
        return "temporal_attention kernel"
    if any(s in low for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "winograd", "implicit")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: float
    by_category_s: Dict[str, float]
    top_kernels: List[Tuple[str, float, int]]
    range_device_s: Dict[str, float]      # range name → device s inside it
    range_counts: Dict[str, int]
    op_shapes: Dict[str, List[list]]      # op name → input shapes per call
    kernel_by_name_s: Dict[str, float] = field(default_factory=dict)
    kernel_counts: Dict[str, int] = field(default_factory=dict)
    idle_by_range_s: Dict[str, float] = field(default_factory=dict)

    def kernels_matching(self, word: str) -> Tuple[float, int]:
        """(device s, launches) of the kernels whose name holds ``word``."""
        s = sum(v for k, v in self.kernel_by_name_s.items() if word in k)
        n = sum(v for k, v in self.kernel_counts.items() if word in k)
        return s, n


class Ranges:
    """Named host ranges: ``with ranges("bench.x"):`` and forward hooks
    that open one around a module's forward. Ranges are profiler
    annotations, so they cost nothing while no profiler runs."""

    def __init__(self):
        self._open: List = []
        self._hooks: List = []

    @staticmethod
    def __call__(name: str):
        return torch.autograd.profiler.record_function(name)

    def hook(self, module: torch.nn.Module, name: str) -> None:
        def pre(mod, args, kwargs=None):
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self._open.append(rf)

        def post(mod, args, out):
            self._open.pop().__exit__(None, None, None)

        self._hooks.append(module.register_forward_pre_hook(pre))
        self._hooks.append(module.register_forward_hook(post))

    def remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks.clear()


class Stretch:
    """One profiled stretch of a window, between two synchronises: device
    activity only (``host=False``: kernels, copies and sets, at little
    cost to the host), or with the host's ops, their input shapes and the
    benchmark's ranges (``host=True``), which slow a host-bound loop.
    The events are reduced by :meth:`summary`, after the window."""

    def __init__(self, host: bool):
        self.host = host
        self.wall_s = 0.0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = ([ProfilerActivity.CUDA] if cuda else []) + (
            [ProfilerActivity.CPU] if self.host or not cuda else [])
        self._prof = profile(activities=acts, record_shapes=self.host)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def summary(self, ops_with_shapes=("npvp::temporal_attention",)):
        return summarize(self._prof.profiler.kineto_results.events(),
                         self.wall_s, ops_with_shapes)


class TracePlan:
    """The traced run's two stretches over its items (requests or steps),
    after its window: items ``first`` … ``first + n − 1`` with device
    activity only, the next ``n`` with the host's ops and ranges.
    ``before(i)`` and ``after(i)`` bracket item ``i``; ``hook``/``unhook``
    open and close the ranges that forward hooks give."""

    def __init__(self, on: bool, first: int, n: int, sync, hook=None,
                 unhook=None):
        self.on, self.first, self.n, self.sync = on, first, n, sync
        self.hook, self.unhook = hook, unhook
        self.device, self.host = Stretch(False), Stretch(True)
        self._open = None

    def host_ranges(self, i: int) -> bool:
        return self.on and self.first + self.n <= i < self.first + 2 * self.n

    def before(self, i: int) -> None:
        if not self.on or i not in (self.first, self.first + self.n):
            return
        self.sync()
        self._open = self.device if i == self.first else self.host
        if self._open is self.host and self.hook is not None:
            self.hook()
        self._open.start()

    def after(self, i: int) -> None:
        if self._open is not None and i in (self.first + self.n - 1,
                                            self.first + 2 * self.n - 1):
            self.finish()

    def finish(self) -> None:
        """Close the open stretch."""
        if self._open is None:
            return
        self.sync()
        self._open.stop()
        if self._open is self.host and self.unhook is not None:
            self.unhook()
        self._open = None

    def summaries(self):
        """(device stretch, host stretch) summaries; None for one that did
        not run."""
        if not self.on:
            return None, None
        return tuple(st.summary() if st._prof is not None else None
                     for st in (self.device, self.host))


def summarize(events, window_s: float, ops_with_shapes=()) -> TraceSummary:
    gpu, ranges, launches, ops = [], [], {}, {n: [] for n in ops_with_shapes}
    for ev in events:
        act = activity(ev)
        if act in GPU_ACTIVITIES:
            gpu.append((ev.start_ns(), ev.end_ns(), ev.name(),
                        ev.correlation_id(), act))
        elif act == "user_annotation" and ev.name().startswith(RANGE_PREFIX):
            ranges.append((ev.start_ns(), ev.end_ns(), ev.name()))
        elif act in ("cuda_runtime", "cuda_driver"):
            launches[ev.correlation_id()] = ev.start_ns()
        elif act == "cpu_op" and ev.name() in ops:
            ops[ev.name()].append([list(s) for s in ev.shapes()])
    busy = union_length([(s, e) for s, e, *_ in gpu]) / 1e9
    kernels = [g for g in gpu if g[4] == "kernel"]
    by_cat, by_name, counts = {}, {}, {}
    for s, e, name, _, _ in kernels:
        d = (e - s) / 1e9
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        counts[name] = counts.get(name, 0) + 1
    top = sorted(((n, by_name[n], counts[n]) for n in by_name),
                 key=lambda x: -x[1])[:10]
    # device time of each range: the kernels launched (by correlation)
    # while it was open, extended to every kernel that ran between the
    # first and the last of them (a launch the tracer could not correlate
    # still lies between its neighbours on the one stream)
    range_dev, range_n = {}, {}
    ranges.sort()
    for rs, re_, name in ranges:
        mine = [(s, e) for s, e, _, corr, act in kernels
                if rs <= launches.get(corr, -1) <= re_]
        range_n[name] = range_n.get(name, 0) + 1
        if not mine:
            continue
        lo, hi = min(s for s, _ in mine), max(e for _, e in mine)
        d = sum(e - s for s, e, *_ in kernels if lo <= s and e <= hi) / 1e9
        range_dev[name] = range_dev.get(name, 0.0) + d
    # idle gaps, named by the innermost benchmark range open on the host
    idle = {}
    if gpu:
        lo = min(s for s, *_ in gpu)
        hi = max(e for _, e, *_ in gpu)
        for gs, ge in gaps([(s, e) for s, e, *_ in gpu], lo, hi):
            mid = (gs + ge) / 2
            open_ = [r for r in ranges if r[0] <= mid <= r[1]]
            name = (max(open_, key=lambda r: r[0])[2] if open_
                    else "outside the benchmark's ranges")
            idle[name] = idle.get(name, 0.0) + (ge - gs) / 1e9
        # the host time before the first and after the last device op
        edge = window_s - (hi - lo) / 1e9
        if edge > 0:
            idle["window edges (host only)"] = edge
    return TraceSummary(window_s=window_s, busy_s=busy,
                        kernel_s=sum(by_cat.values()),
                        by_category_s=by_cat, top_kernels=top,
                        range_device_s=range_dev, range_counts=range_n,
                        op_shapes=ops, kernel_by_name_s=by_name,
                        kernel_counts=counts, idle_by_range_s=idle)


def breakdown(device: Optional[TraceSummary],
              host: Optional[TraceSummary]) -> Optional[dict]:
    """The result line's ``breakdown``: the ten device operations that took
    most time in the device-only stretch (category: kernel name), and the
    ten largest idle shares of the host stretch by the range open on the
    host, in seconds as measured."""
    if device is None and host is None:
        return None
    ops = [] if device is None else [[f"{category(n)}: {n[:160]}", s]
                                     for n, s, _ in device.top_kernels]
    idle = [] if host is None else sorted(
        ([k, v] for k, v in host.idle_by_range_s.items()),
        key=lambda kv: -kv[1])[:10]
    return {"device_ops": ops[:10], "idle_gaps": idle}


def stolen_s() -> float:
    """CPU seconds that the machine's hypervisor gave to others, summed over
    its CPUs (``/proc/stat``'s ``steal``); NaN where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


class Pace:
    """The window's pace by stretches of ``seconds``, for the run's log: in
    each stretch the items finished, the main thread's and the process's
    CPU seconds, the CPU seconds stolen from the machine, and the garbage
    collector's passes and seconds, so that a slow stretch shows what it
    goes with. ``tick(elapsed)`` as each item finishes, ``close()`` at the
    end of the window."""

    NAMES = ("items", "main thread cpu s", "process cpu s", "stolen cpu s",
             "gc passes", "gc s")

    def __init__(self, seconds: float = 5.0):
        self.seconds = seconds
        self.rows: List[tuple] = []
        self._gc_n, self._gc_s, self._gc_t0 = 0, 0.0, None
        gc.callbacks.append(self._on_gc)
        self._index, self._count, self._mark = 0, 0, self._sample()

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._gc_n += 1
            self._gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def _sample(self) -> tuple:
        return (time.thread_time(), time.process_time(), stolen_s(),
                self._gc_n, self._gc_s)

    def _next_stretch(self) -> None:
        now = self._sample()
        self.rows.append((self._count,) + tuple(
            b - a for a, b in zip(self._mark, now)))
        self._mark, self._count = now, 0
        self._index += 1

    def tick(self, elapsed: float) -> None:
        while elapsed >= (self._index + 1) * self.seconds:
            self._next_stretch()
        self._count += 1

    def close(self) -> None:
        """End the last (partial) stretch and stop listening to the
        collector."""
        self._next_stretch()
        gc.callbacks.remove(self._on_gc)

    def describe(self) -> str:
        cols = list(zip(*self.rows)) if self.rows else [()] * len(self.NAMES)
        return "; ".join(f"{name} {[round(v, 3) for v in col]}"
                         for name, col in zip(self.NAMES, cols))


def span(ranges: Ranges, name: str, on: bool):
    """``ranges(name)`` when ``on``, else a context that does nothing."""
    return ranges(name) if on else contextlib.nullcontext()


def idle_share(rec) -> Optional[float]:
    """% of the device-only stretch in which no operation ran on the
    device."""
    t = rec.get("device_trace")
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def range_ms_per(rec, names, per: str) -> Optional[float]:
    """Device ms inside the ranges ``names`` for each ``per`` range."""
    t = rec.get("trace")
    if t is None or not t.range_counts.get(per):
        return None
    found = [t.range_device_s[n] for n in names if n in t.range_device_s]
    if not found:
        return None
    return 1e3 * sum(found) / t.range_counts[per]


def kernel_roofline(rec, op: str, kernel_word: str) -> Optional[float]:
    """% of the roofline reached by the kernel behind ``op``: the least
    time of every traced call (from its shapes) over the device time of
    the kernels whose name holds ``kernel_word``. Nothing when the trace
    holds no such kernel, or not one kernel a call."""
    from npvp_bench.flops import attention_call_from_shapes, bound_s

    t = rec.get("trace")
    if t is None:
        return None
    calls = t.op_shapes.get(op) or []
    kernel_s, launches = t.kernels_matching(kernel_word)
    if not calls or kernel_s <= 0 or launches != len(calls):
        return None
    itemsize = 2 if rec.get("compute_dtype") == "bfloat16" else 4
    least = sum(bound_s(*attention_call_from_shapes(s, itemsize),
                        rec.get("compute_dtype", "float32"))
                for s in calls)
    return 100.0 * least / kernel_s


def describe(t: Optional[TraceSummary]) -> str:
    """One line of the traced stretch's numbers, for the run's log."""
    if t is None:
        return "trace: none"
    cats = {k: round(v * 1e3, 3) for k, v in sorted(
        t.by_category_s.items(), key=lambda kv: -kv[1])}
    rng = {k: round(v * 1e3, 3) for k, v in t.range_device_s.items()}
    ops = {k: len(v) for k, v in t.op_shapes.items()}
    return (f"trace: window {t.window_s * 1e3:.3f} ms, busy "
            f"{t.busy_s * 1e3:.3f} ms, kernels {t.kernel_s * 1e3:.3f} ms "
            f"({sum(t.kernel_counts.values())} launches) by category {cats}"
            f"; device ms by range {rng}, ranges {t.range_counts}; op calls"
            f" {ops}")
