"""Serving beyond the predictor's horizon: one client in a closed loop, each
request a batch of clips through ``VideoPredictor.vfp``, which rolls the
prediction forward in windows of ``max_T − P`` frames
(``vfp_windowed``): each window is AE encode, the predictor and AE
decode, and its decoded frames are the next window's context.

The traffic file is ``drivers/serve.py``'s, with ``entry`` ``windowed``,
one task observing 0..P−1 and predicting P..P+F−1, and
``reference_block`` (the clips that the reference computes at a time).
Request ``i`` draws its frames and its first window's prior sample as
``serve.py`` draws them from ``(seed, i)``, and one more prior sample for
each further window, on the device. The window loop, its ranges and
forward hooks, the program and the comparison are ``serve.py``'s; the
plain reference runs the same rollout (``reference/windowed.py``).

A traced run profiles one more stretch after ``serve.py``'s two:
``trace_requests`` requests with the port's own spans turned on for that
stretch alone, each span's device time read by ``npvp_bench/spans.py``.
"""

from __future__ import annotations

import statistics
from pathlib import Path

import torch

from npvp_bench import check, harness, spans
from npvp_bench import trace as T
from npvp_bench import weights as W
from npvp_bench.harness import (device_info, free_device, log, stamp,
                                synchronize)

# serve.py's requests, program, window loop and comparison, in a copy of
# the module of its own whose ``caller`` is this module's: serve.py's
# knows the ``freeze`` and ``predict`` entries only
S = harness.load_module(Path(__file__).with_name("serve.py"),
                        "npvp_bench_driver_serve_for_windows")
build_program, window, compare = S.build_program, S.window, S.compare


class Requests(S.Requests):
    """``serve.py``'s requests, with a prior sample for every window of
    the rollout: ``windows`` of ``chunk`` = ``max_T − P`` frames, each
    observing ``P``."""

    def __init__(self, ctx, device):
        super().__init__(ctx, device)
        (task,) = ctx.traffic["tasks"]
        self.P = len(task["observe"])
        self.chunk = ctx.model_config["Predictor"]["max_T"] - self.P
        self.windows = -(-len(task["predict"]) // self.chunk)

    def tensors(self, i, n_obs, tag="request"):
        frames, first = super().tensors(i, n_obs, tag)
        if first is None:
            return frames, None
        g = W.generator(self.ctx.seed, self.device, tag, "windows", i)
        return frames, [first] + [
            torch.randn(self.eps_shape, generator=g, device=self.device)
            for _ in range(self.windows - 1)]


def caller(vp, traffic, reqs):
    """``call(to, tp, frames, eps)`` through ``VideoPredictor.vfp``."""
    if traffic["entry"] != "windowed":
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    (task,) = traffic["tasks"]
    P, F = len(task["observe"]), len(task["predict"])
    if (list(task["observe"]) != list(range(P))
            or list(task["predict"]) != list(range(P, P + F))):
        raise ValueError("the windowed entry observes 0..P-1 and predicts "
                         "P..P+F-1")
    return lambda to, tp, frames, eps: vp.vfp(frames, len(tp), eps=eps)


S.caller = caller


def reference_outputs(ctx, reqs, device, indices, precision="fp32"):
    """The plain reference's rollout for requests ``indices``, float32 with
    TF32 off, from weights and inputs drawn anew from the seed."""
    from npvp_bench.reference import model as R
    from npvp_bench.reference.windowed import rollout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = ctx.model_config["Predictor"]
    ae, pred = R.build(ctx.model_config, device=device)
    for module, tag in ((ae, "ae"), (pred, "predictor")):
        module.load_state_dict(W.draw(W.state_specs(module), ctx.seed,
                                      device, tag))
    ae.eval(), pred.eval()
    out = {}
    R.set_precision(precision)
    try:
        with torch.no_grad():
            for i in indices:
                _, to, tp, _ = reqs.spec(i)
                frames, eps = reqs.tensors(i, len(to))
                out[i] = rollout(ae, pred, frames, len(tp), eps, p["max_T"],
                                 p["max_H"], p["max_W"],
                                 ctx.traffic["reference_block"])
    finally:
        R.set_precision("fp32")
    return out


def window_gaps(kept, ref, chunk: int):
    """[(worst relative RMS gap, worst largest gap)] of each window's
    frames over the compared requests."""
    out = []
    for i, prog in kept.items():
        prog = prog.to(ref[i].device)
        for w, lo in enumerate(range(0, prog.shape[1], chunk)):
            gaps = check.frames_gaps(prog[:, lo:lo + chunk],
                                     ref[i][:, lo:lo + chunk])
            if w == len(out):
                out.append(gaps)
            else:
                out[w] = tuple(max(a, b) for a, b in zip(out[w], gaps))
    return out


def span_stretch(ctx, vp, reqs, device, first: int):
    """Device seconds of each instance of the port's spans over the
    traffic's ``trace_requests`` requests from ``first`` on."""
    call = caller(vp, ctx.traffic, reqs)

    def serve():
        for j in range(first, first + ctx.traffic["trace_requests"]):
            _, to, tp, _ = reqs.spec(j)
            frames, eps = reqs.tensors(j, len(to))
            call(to, tp, frames, eps)

    return spans.record(serve, lambda: synchronize(device))


def request_flops(ctx, reqs) -> int:
    """Reference FLOPs of one request: every window's served forward."""
    from npvp_bench import flops

    P = reqs.P
    return reqs.windows * flops.serve_forward_flops(
        ctx.model_config, reqs.batch, list(range(P)),
        list(range(P, P + reqs.chunk)))


def run(ctx):
    device = ctx.device
    reqs = Requests(ctx, device)
    stamp(ctx, "driver started")
    vp = build_program(ctx, device)
    stamp(ctx, "program built")
    rec = window(ctx, vp, reqs, device, ctx.seconds)
    lat = rec["latency_ms"]
    if len(lat) >= 2:
        log(f"window: {rec['requests']} requests in {rec['window_s']:.3f}"
            f" s, latency quartiles {statistics.quantiles(lat, n=4)} ms")
        log(f"window pace: {rec['pace']}")
    if ctx.trace:
        rec["spans"] = span_stretch(
            ctx, vp, reqs, device,
            rec["requests"] + 2 * ctx.traffic["trace_requests"])
        log("device ms of the port's spans (count, total): " + str({
            k: (len(v), round(1e3 * sum(v), 3))
            for k, v in sorted(rec["spans"].items())}))
    del vp
    free_device()
    ref = reference_outputs(ctx, reqs, device, list(rec["kept"]))
    values = compare(rec["kept"], ref)
    log("gaps by window (relative RMS, largest): "
        + str(window_gaps(rec["kept"], ref, reqs.chunk)))
    del ref
    correct, rows = check.judge(values, ctx.limits)
    for line in check.lines(rows):
        log(line)
    log(f"compared {values['compared_requests']} requests of "
        f"{rec['requests']}")
    if ctx.trace:
        rec["flops"] = rec["requests"] * request_flops(ctx, reqs)
    rec.update(correct=correct, checks=rows, attempted=rec["requests"],
               failed=0,
               device=device_info(rec["process_peak_bytes"],
                                  rec["device_trace"]),
               breakdown=T.breakdown(rec["device_trace"], rec["trace"]))
    rec["kept"] = None
    return rec
