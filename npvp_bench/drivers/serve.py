"""Serving: one client in a closed loop, each request a batch of clips and
one task (observed and target times), through the port's serving API.

The traffic file gives ``batch`` (clips a request), ``entry`` (``freeze``:
one task frozen once with ``VideoPredictor.freeze_task`` and called per
request; ``predict``: ``VideoPredictor.predict`` with each request's
times), ``tasks`` (each with either fixed ``observe`` / ``predict``
times or a ``random_split`` of ``observe`` of ``of`` times; each block of
as many requests as there are tasks holds every task once, in an order
drawn from the seed),
``warmup_requests``, ``trace_requests`` (the requests of each profiled
stretch of a traced run, after the window) and ``check`` (``fraction`` of the requests
compared with the reference, at most ``max``; request 0 always).

Request ``i`` takes its task from its block's order, draws the task's
random times from ``(seed, i)``, and its frames (uniform over the AE's
output range) and the prior's noise on the device from the same pair, so
the same seed gives the same requests and every seed the same work.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from npvp_bench import check
from npvp_bench import trace as T
from npvp_bench import weights as W
from npvp_bench.harness import (device_info, free_device, log, stamp,
                                synchronize)


# ------------------------------------------------------------- requests


def task_block(traffic: dict, seed: int, block):
    """The tasks of block ``block`` of requests: every task of the mix
    once, in an order drawn from the seed, so that every seed sends the
    same mix of tasks."""
    rng = np.random.default_rng(W.sub_seed(seed, "block", block))
    return list(rng.permutation(len(traffic["tasks"])))


def task_times(task: dict, rng: np.random.Generator):
    """(observed times, target times) of ``task``, its random parts drawn
    from ``rng``."""
    if "random_split" in task:
        n, of = task["random_split"]["observe"], task["random_split"]["of"]
        perm = rng.permutation(of)
        to, tp = np.sort(perm[:n]), np.sort(perm[n:])
    else:
        to, tp = task["observe"], task["predict"]
    return np.asarray(to, np.float32), np.asarray(tp, np.float32)


class Requests:
    """Request ``i``'s task, frames and noise, from ``(seed, i)``."""

    def __init__(self, ctx, device):
        self.ctx, self.device = ctx, device
        cfg = ctx.model_config
        d, p = cfg["Dataset"], cfg["Predictor"]
        self.batch = ctx.traffic["batch"]
        self.size, self.channels = d["img_size"], d["img_channels"]
        self.tanh = cfg["AE"]["out_layer"] == "Tanh"
        self.eps_shape = ((self.batch, p["max_H"], p["max_W"],
                           p["embed_dim"]) if p["stochastic"] else None)
        self.check = ctx.traffic["check"]
        self.block = len(ctx.traffic["tasks"])

    def spec(self, i, tag="request"):
        traffic = self.ctx.traffic
        block = task_block(traffic, self.ctx.seed, (tag, i // self.block))
        task = traffic["tasks"][block[i % self.block]]
        rng = np.random.default_rng(W.sub_seed(self.ctx.seed, tag, i))
        to, tp = task_times(task, rng)
        checked = i == 0 or rng.random() < self.check["fraction"]
        return task["name"], to, tp, checked

    def tensors(self, i, n_obs, tag="request"):
        g = W.generator(self.ctx.seed, self.device, tag, "tensors", i)
        frames = torch.rand((self.batch, n_obs, self.size, self.size,
                             self.channels), generator=g, device=self.device)
        if self.tanh:
            frames = frames * 2.0 - 1.0
        eps = (None if self.eps_shape is None else
               torch.randn(self.eps_shape, generator=g, device=self.device))
        return frames, eps


# -------------------------------------------------------------- program


def build_program(ctx, device):
    """The port's ``VideoPredictor`` with the benchmark's weights: modules
    built on the meta device, allocated on ``device``, every tensor drawn
    there from the seed."""
    from npvp_tpu_torch.core.config import from_dict
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.resnet_ae import build_ae

    cfg = from_dict(ctx.model_config).validate()
    dtype = (torch.bfloat16 if cfg.Env.compute_dtype == "bfloat16"
             else torch.float32)
    with torch.device("meta"):
        ae = build_ae(cfg, dtype)
        pred = build_predictor(cfg, dtype)
    ae, pred = ae.to_empty(device=device), pred.to_empty(device=device)
    for module, tag in ((ae, "ae"), (pred, "predictor")):
        module.load_state_dict(W.draw(W.state_specs(module), ctx.seed,
                                      device, tag))
    return VideoPredictor(cfg, ae, pred, device=device)


def caller(vp, traffic, reqs):
    """``call(to, tp, frames, eps)`` through the traffic's entry."""
    if traffic["entry"] == "freeze":
        if len(traffic["tasks"]) != 1:
            raise ValueError("entry 'freeze' serves one task")
        _, to, tp, _ = reqs.spec(0)
        fn = vp.freeze_task(to, tp)
        return lambda to, tp, frames, eps: fn(frames, eps=eps)
    if traffic["entry"] == "predict":
        return lambda to, tp, frames, eps: vp.predict(frames, to, tp,
                                                      eps=eps)
    raise ValueError(f"unknown entry {traffic['entry']!r}")


def window(ctx, vp, reqs, device, seconds):
    """The closed loop for ``seconds``: every request timed from its call
    to its outputs after a synchronise; the checked requests' outputs kept
    on the host. A traced run profiles its stretches after the window has
    closed, since the profiler leaves every later launch slower. Returns
    the window's record."""
    call = caller(vp, ctx.traffic, reqs)
    traffic = ctx.traffic
    for i in range(traffic["warmup_requests"]):
        _, to, tp, _ = reqs.spec(i, "warmup")
        frames, eps = reqs.tensors(i, len(to), "warmup")
        call(to, tp, frames, eps)
    synchronize(device)
    cuda = torch.device(device).type == "cuda"
    setup_s = time.time() - ctx.start_time
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ranges = T.Ranges()

    def serve(i, host=False):
        name, to, tp, checked = reqs.spec(i)
        with T.span(ranges, "bench.request.inputs", host):
            frames, eps = reqs.tensors(i, len(to))
        with T.span(ranges, "bench.request.call", host):
            t_call = time.perf_counter()
            out = call(to, tp, frames, eps)
            t_ret = time.perf_counter()
        with T.span(ranges, "bench.request.wait", host):
            synchronize(device)
        return name, to, tp, checked, out, t_call, t_ret

    latencies, enqueue, kept, shapes, tasks = [], [], {}, [], []
    pace = T.Pace()
    frames_done = 0
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while time.perf_counter() - t_start < seconds:
        name, to, tp, checked, out, t_call, t_ret = serve(i)
        t_end = time.perf_counter()
        pace.tick(t_end - t_start)
        latencies.append((t_end - t_call) * 1e3)
        enqueue.append((t_ret - t_call) * 1e3)
        frames_done += reqs.batch * len(tp)
        shapes.append((len(to), len(tp)))
        tasks.append(name)
        if checked and len(kept) < reqs.check["max"]:
            kept[i] = out.detach().to("cpu")
        i += 1
    pace.close()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    def hook():
        ranges.hook(vp.ae.encoder, "bench.ae.encode")
        ranges.hook(vp.predictor, "bench.predictor")
        ranges.hook(vp.ae.decoder, "bench.ae.decode")

    n = traffic["trace_requests"]
    plan = T.TracePlan(ctx.trace, i, n, lambda: synchronize(device), hook,
                       ranges.remove_hooks)
    if ctx.trace:  # requests after the window's, timed by nothing
        for j in range(i, i + 2 * n):
            plan.before(j)
            serve(j, plan.host_ranges(j))
            plan.after(j)
    device_trace, host_trace = plan.summaries()
    return {"setup_s": setup_s, "window_s": t_end - t_start,
            "requests": i, "frames": frames_done, "latency_ms": latencies,
            "enqueue_ms": enqueue, "shapes": shapes, "tasks": tasks,
            "pace": pace.describe(), "kept": kept,
            "peak_bytes": window_peak,
            "process_peak_bytes": max(setup_peak, window_peak),
            "trace": host_trace, "device_trace": device_trace}


# ------------------------------------------------------------ reference


def reference_outputs(ctx, reqs, device, indices, precision="fp32"):
    """The plain reference's frames for requests ``indices``, float32 with
    TF32 off, from weights and inputs drawn anew from the seed."""
    from npvp_bench.reference import model as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ctx.model_config
    p = cfg["Predictor"]
    ae, pred = R.build(cfg, device=device)
    for module, tag in ((ae, "ae"), (pred, "predictor")):
        module.load_state_dict(W.draw(W.state_specs(module), ctx.seed,
                                      device, tag))
    ae.eval(), pred.eval()
    grid = lambda t: R.coordinate_grid(t, p["max_T"], p["max_H"],  # noqa
                                       p["max_W"], device)
    out = {}
    R.set_precision(precision)
    try:
        with torch.no_grad():
            for i in indices:
                _, to, tp, _ = reqs.spec(i)
                frames, eps = reqs.tensors(i, len(to))
                feats = pred(ae.encode(frames), grid(to), grid(tp),
                             eps).pred_features
                out[i] = ae.decode(feats)
    finally:
        R.set_precision("fp32")
    return out


def compare(kept, ref):
    rel = abs_ = 0.0
    for i, prog in kept.items():
        r, a = check.frames_gaps(prog.to(ref[i].device), ref[i])
        rel, abs_ = max(rel, r), max(abs_, a)
    return {"frames_rel_rms": rel, "frames_max_abs": abs_,
            "compared_requests": len(kept)}


def flops_per_request(ctx, shapes):
    """Reference FLOPs of each request shape (observed, target frames) met
    in the window."""
    from npvp_bench import flops

    cfg = ctx.model_config
    counts = {}
    for n_obs, n_tp in set(shapes):
        counts[(n_obs, n_tp)] = flops.serve_forward_flops(
            cfg, ctx.traffic["batch"], list(range(n_obs)),
            list(range(n_obs, n_obs + n_tp)))
    return counts


def run(ctx):
    device = ctx.device
    reqs = Requests(ctx, device)
    stamp(ctx, "driver started")
    vp = build_program(ctx, device)
    stamp(ctx, "program built")
    rec = window(ctx, vp, reqs, device, ctx.seconds)
    lat = rec["latency_ms"]
    if len(lat) >= 2:
        by_task = {}
        for name, ms in zip(rec["tasks"], lat):
            by_task.setdefault(name, []).append(ms)
        log(f"window: {rec['requests']} requests in {rec['window_s']:.3f}"
            f" s, latency quartiles {statistics.quantiles(lat, n=4)} ms, "
            f"median by task " + str({k: round(statistics.median(v), 3)
                                      for k, v in by_task.items()}))
        log(f"window pace: {rec['pace']}")
    del vp
    free_device()
    ref = reference_outputs(ctx, reqs, device, list(rec["kept"]))
    values = compare(rec["kept"], ref)
    del ref
    correct, rows = check.judge(values, ctx.limits)
    for line in check.lines(rows):
        log(line)
    log(f"compared {values['compared_requests']} requests of "
        f"{rec['requests']}")
    if ctx.trace:
        counts = flops_per_request(ctx, rec["shapes"])
        rec["flops"] = sum(counts[s] for s in rec["shapes"])
    rec.update(correct=correct, checks=rows, attempted=rec["requests"],
               failed=0,
               device=device_info(rec["process_peak_bytes"],
                                  rec["device_trace"]),
               breakdown=T.breakdown(rec["device_trace"], rec["trace"]))
    rec["kept"] = None
    return rec
