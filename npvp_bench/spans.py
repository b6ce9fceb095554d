"""A reading of a profiler trace that ``trace.py``'s summary does not keep:
the device time of each instance of the port's own spans
(``npvp_tpu_torch.core.tracing``, names ``npvp.``).

A span's device time is counted as ``trace.py`` counts a benchmark range:
the kernels launched while it was open on the host, extended to every
kernel that ran between the first and the last of them.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List

import torch

from npvp_bench import trace as T

PREFIX = "npvp."


def _kernels_and_launches(events):
    kernels, launches, spans = [], {}, []
    for ev in events:
        act = T.activity(ev)
        if act == "kernel":
            kernels.append((ev.start_ns(), ev.end_ns(), ev.name(),
                            ev.correlation_id()))
        elif act in ("cuda_runtime", "cuda_driver"):
            launches[ev.correlation_id()] = ev.start_ns()
        elif act == "user_annotation" and ev.name().startswith(PREFIX):
            spans.append((ev.start_ns(), ev.end_ns(), ev.name()))
    return kernels, launches, spans


def span_device_s(events) -> Dict[str, List[float]]:
    """{span name: device seconds of each of its instances} of the ``npvp.``
    spans in ``events`` (a profiler's events, the host's ops and the
    device's kernels both recorded). A span that launched nothing reads
    0."""
    kernels, launches, spans = _kernels_and_launches(events)
    kernels.sort()
    starts = [k[0] for k in kernels]
    # the kernels by launch time, for the ones each span launched
    by_launch = sorted((launches[c], s, e) for s, e, _, c in kernels
                       if c in launches)
    launch_t = [b[0] for b in by_launch]
    out: Dict[str, List[float]] = {}
    for rs, re_, name in sorted(spans):
        mine = by_launch[bisect.bisect_left(launch_t, rs):
                         bisect.bisect_right(launch_t, re_)]
        d = 0.0
        if mine:
            lo, hi = min(m[1] for m in mine), max(m[2] for m in mine)
            d = sum(e - s for s, e, *_ in kernels[
                bisect.bisect_left(starts, lo):bisect.bisect_right(
                    starts, hi)] if e <= hi) / 1e9
        out.setdefault(name, []).append(d)
    return out


def record(run: Callable[[], None], sync: Callable[[], None]):
    """Run ``run()`` under a profiler of the host's ops and the device,
    with the port's tracing on for it alone (its spans enter the trace);
    → :func:`span_device_s` of the trace."""
    from torch.profiler import ProfilerActivity, profile

    from npvp_tpu_torch.core import tracing

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    sync()
    prof = profile(activities=acts)
    tracing.enable()
    try:
        with prof:
            run()
            sync()
    finally:
        tracing.disable()
        tracing.take()
    return span_device_s(prof.profiler.kineto_results.events())
