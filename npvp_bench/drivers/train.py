"""Training: stage-2 train steps of the predictor over a frozen AE, driven
as the port's trainer drives its inner loop: ``train_chunks`` over the
data module's train loader in the traffic's ``mode``, each chunk through
``run_train_chunk`` with ``make_steps(...).train``. No validation pass,
checkpoint or picture falls in the window.

The traffic file gives ``mode`` (``rand_context``), ``checked_steps``
(the first steps of the loop, run in set-up and replayed by the reference
from the seed's weights), ``warmup_steps`` (further set-up steps),
``window_step`` (``lo``, ``hi``: the range from which the seed draws the
step of the window that is checked) and ``trace_steps`` (the steps of
each profiled stretch of a traced run, after the window). The data stream, the step seeds,
the checked window step and the weights come from the run's seed.

The checked window step is replayed by the reference from the program's
own state: just before it the predictor's state dict, AdamW's moments and
the step count are copied to the host, and again just after it; the clock
of the window stops while they are copied.
"""

from __future__ import annotations

import copy
import statistics
import time

import torch

from npvp_bench import check
from npvp_bench import trace as T
from npvp_bench import weights as W
from npvp_bench.harness import (device_info, free_device, log, stamp,
                                synchronize)

BETA1 = 0.9  # AdamW's first-moment decay in the port's stage-2 optimizer


def port_config(ctx):
    """The port's ``Config`` of the cell, its data stream seeded from the
    run's seed."""
    from npvp_tpu_torch.core.config import from_dict

    cfg = from_dict(copy.deepcopy(ctx.model_config)).validate()
    cfg.Env.rand_seed = W.sub_seed(ctx.seed, "data") & 0x7FFFFFFF
    return cfg


def build_program(ctx, device):
    """(cfg, state, steps, loader): the frozen AE and the predictor with
    the benchmark's weights, the port's train state and steps, and the
    train loader."""
    from npvp_tpu_torch.core.optim import (is_decoder_param,
                                           make_predictor_optimizer,
                                           predictor_schedule)
    from npvp_tpu_torch.core.train_state import TrainState
    from npvp_tpu_torch.data import native_bindings
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.resnet_ae import build_ae
    from npvp_tpu_torch.train.common import compute_dtype
    from npvp_tpu_torch.train.stage2_predictor import make_steps

    cfg = port_config(ctx)
    dtype = compute_dtype(cfg)
    with torch.device("meta"):
        ae, pred = build_ae(cfg, dtype), build_predictor(cfg, dtype)
    ae, pred = ae.to_empty(device=device), pred.to_empty(device=device)
    for module, tag in ((ae, "ae"), (pred, "predictor")):
        module.load_state_dict(W.draw(W.state_specs(module), ctx.seed,
                                      device, tag))
    ae.eval().requires_grad_(False)
    native_bindings.native_available()  # built before the loader's clock
    dm = DataModule(cfg)
    loader = dm.train_loader(ctx.traffic["mode"])
    p = cfg.Predictor
    state = TrainState(
        pred, make_predictor_optimizer(pred.parameters(), p.predictor_lr),
        predictor_schedule(p.predictor_lr, p.use_cosine_scheduler,
                           p.scheduler_eta_min,
                           p.scheduler_T0 * max(1, dm.len_train_loader)),
        p.max_grad_norm, is_decoder_param)
    steps = make_steps(cfg, ae, ctx.traffic["mode"], torch.device(device))
    return cfg, state, steps, loader, dm.len_train_loader


def leaf_norms(tensors):
    """{name: float norm} of a dict of tensors, read in one transfer."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def window_step(ctx) -> int:
    """The index in the window of the step that is checked, drawn from the
    seed in the traffic's ``window_step`` range."""
    lo, hi = ctx.traffic["window_step"]["lo"], ctx.traffic["window_step"]["hi"]
    return lo + W.sub_seed(ctx.seed, "window_step") % (hi - lo + 1)


def snapshot(state, moments):
    """The predictor's state dict, the step count and AdamW's ``moments``
    of every parameter, copied to the host."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    opt = state.optimizer.state
    snap = {"state": {k: host(v) for k, v in
                      state.module.state_dict().items()},
            "step": state.step}
    for m in moments:  # none before the optimizer's first step
        snap[m] = {k: host(opt[p][m]) if m in opt.get(p, {})
                   else torch.zeros_like(p, device="cpu")
                   for k, p in state.module.named_parameters()}
    return snap


def snapshot_numbers(before, after):
    """Per-leaf norms of the checked window step's gradient as AdamW took
    it, ``(m_after − β1·m_before) / (1 − β1)``, and of the change that it
    made, from the host copies around it."""
    grads, change = {}, {}
    for k, m in after["exp_avg"].items():
        g = (m.double() - BETA1 * before["exp_avg"][k].double()) / (1 - BETA1)
        grads[k] = float(torch.linalg.vector_norm(g))
        change[k] = float(torch.linalg.vector_norm(
            after["state"][k].double() - before["state"][k].double()))
    return grads, change


def run_program(ctx, device):
    """Set-up (the checked steps, then warm-up), then the window; returns
    the record, the program's numbers and what the reference needs."""
    from npvp_tpu_torch.core.metrics import AverageMeters
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train.common import (StepProfiler, run_train_chunk,
                                             train_chunks)

    traffic = ctx.traffic
    stamp(ctx, "driver started")
    cfg, state, steps, loader, steps_per_epoch = build_program(ctx, device)
    stamp(ctx, "program built")
    base_rng = Rng(W.sub_seed(ctx.seed, "steps"))
    n_checked = traffic["checked_steps"]
    k_window = window_step(ctx)
    # the train state's step count at the checked steps
    wanted = set(range(n_checked)) | {
        n_checked + traffic["warmup_steps"] + k_window}
    captured, dispatch, waits, losses = {}, [], [], []

    def step(batch):
        rng = base_rng.fold(state.step)
        if state.step in wanted:
            captured[state.step] = ({k: v.copy() for k, v in batch.items()},
                                    rng.seed)
        placed = steps.place(batch)
        t0 = time.perf_counter()
        metrics = steps.train(state, placed, rng)
        dispatch.append(time.perf_counter() - t0)
        return metrics

    def on_step(kind, index, metrics):
        waits.append(metrics["data_wait_ms"])
        losses.append(float(metrics["loss"]))

    def epochs():
        """The loader's chunks of one step, epoch after epoch, as the
        trainer's epoch loop draws them (without its validation)."""
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from train_chunks(loader, 1, state, None,
                                    StepProfiler(None))
            epoch += 1

    meters = AverageMeters()
    chunks = epochs()
    params = dict(state.module.named_parameters())
    grad_norms = change_norms = None
    for _ in range(n_checked):
        run_train_chunk(state, step, next(chunks), None, meters, on_step,
                        loader)
        if state.step == 1:
            # an optimizer that never stepped holds no moment: nothing
            opt = state.optimizer.state
            grad_norms = leaf_norms({
                k: opt[v].get("exp_avg", torch.zeros_like(v)) / (1 - BETA1)
                for k, v in params.items()})
    start = W.draw([(k, v.shape) for k, v in params.items()], ctx.seed,
                   device, "predictor")
    change_norms = leaf_norms({k: params[k].detach() - start[k]
                               for k in params})
    del start
    stamp(ctx, f"{n_checked} checked steps run")
    for _ in range(traffic["warmup_steps"]):
        run_train_chunk(state, step, next(chunks), None, meters, on_step,
                        loader)
    synchronize(device)
    cuda = torch.device(device).type == "cuda"
    setup_s = time.time() - ctx.start_time
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ranges = T.Ranges()
    n0 = len(dispatch)
    paused = 0.0

    def copied(moments):
        """A host copy of the state, the clock stopped while it is made."""
        nonlocal paused
        synchronize(device)
        t0 = time.perf_counter()
        snap = snapshot(state, moments)
        paused += time.perf_counter() - t0
        return snap

    def train_step(host=False):
        with T.span(ranges, "bench.data", host):
            chunk = next(chunks)
        with T.span(ranges, "bench.train_step", host):
            run_train_chunk(state, step, chunk, None, meters, on_step,
                            loader)

    pace = T.Pace()
    t_start = time.perf_counter()
    n = 0
    while (time.perf_counter() - t_start - paused < ctx.seconds
           or n <= k_window):
        if n == k_window:
            before = copied(("exp_avg", "exp_avg_sq"))
        train_step()
        if n == k_window:
            after = copied(("exp_avg",))
            timed_loss = losses[-1]
        n += 1
        pace.tick(time.perf_counter() - t_start - paused)
    synchronize(device)
    t_end = time.perf_counter()
    pace.close()
    n1 = len(dispatch)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    # a traced run profiles steps after the window's: the profiler leaves
    # every later launch slower
    plan = T.TracePlan(ctx.trace, n, traffic["trace_steps"],
                       lambda: synchronize(device))
    if ctx.trace:
        for j in range(n, n + 2 * traffic["trace_steps"]):
            plan.before(j)
            train_step(plan.host_ranges(j))
            plan.after(j)
    chunks.close()
    loader.close()
    rec = {"setup_s": setup_s, "window_s": t_end - t_start - paused,
           "steps": n, "clips": n * cfg.Dataset.batch_size,
           "dispatch_ms": [1e3 * d for d in dispatch[n0:n1]],
           "batch_wait_ms": waits[n0:n1], "peak_bytes": window_peak,
           "process_peak_bytes": max(setup_peak, window_peak),
           "batch": cfg.Dataset.batch_size}
    rec["device_trace"], rec["trace"] = plan.summaries()
    if len(rec["dispatch_ms"]) >= 2:
        log(f"window: {n} steps in {rec['window_s']:.3f} s, dispatch ms "
            f"quartiles {statistics.quantiles(rec['dispatch_ms'], n=4)}; "
            f"step {k_window} checked, the clock stopped {paused:.3f} s "
            f"for its host copies")
        log(f"window pace: {pace.describe()}")
    timed_grads, timed_change = snapshot_numbers(before, after)
    del after
    program = {
        "setup": {"losses": losses[:n_checked], "grad_norms": grad_norms,
                  "change_norms": change_norms},
        "timed": {"losses": [timed_loss], "grad_norms": timed_grads,
                  "change_norms": timed_change}}
    inputs = {"setup": [captured[s] for s in range(n_checked)],
              "timed": (before,) + captured[max(wanted)],
              "steps_per_epoch": steps_per_epoch}
    return rec, program, inputs


def reference_trainer(ctx, device, steps_per_epoch, state=None):
    """The reference's trainer over the seed's weights, or over the
    program's ``state`` (a host snapshot: the predictor's state dict,
    AdamW's moments and the step count) where one is given."""
    from npvp_bench.reference import model as R
    from npvp_bench.reference.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ctx.model_config
    ae, pred = R.build(cfg, device=device)
    ae.load_state_dict(W.draw(W.state_specs(ae), ctx.seed, device, "ae"))
    if state is None:
        pred.load_state_dict(W.draw(W.state_specs(pred), ctx.seed, device,
                                    "predictor"))
    else:
        pred.load_state_dict({k: v.to(device)
                              for k, v in state["state"].items()})
    trainer = Trainer(cfg, ae, pred, steps_per_epoch)
    if state is not None:
        trainer.t = state["step"]
        for k in trainer.params:
            trainer.m[k].copy_(state["exp_avg"][k])
            trainer.v[k].copy_(state["exp_avg_sq"][k])
    return trainer


def replay(trainer, steps, precision, half):
    """The reference's losses of ``steps`` ((batch, step seed) pairs) and
    its per-leaf norms of the first step's gradient, computed in
    ``precision``; ``half`` leaves out half of every batch, the mean taken
    over the rest."""
    from npvp_bench.reference import model as R

    device = next(iter(trainer.params.values())).device
    losses, grad_norms = [], None
    R.set_precision(precision)
    try:
        for batch, seed in steps:
            placed = {k: torch.from_numpy(
                v[:v.shape[0] // 2] if half and v.ndim > 1 else v).to(device)
                for k, v in batch.items()}
            losses.append(trainer.step(placed, seed)["loss"])
            if grad_norms is None:
                grad_norms = leaf_norms(trainer.grads)
    finally:
        R.set_precision("fp32")
    return losses, grad_norms


def reference_numbers(ctx, device, inputs, precision="fp32", half=False):
    """The reference's numbers, in the program's layout: the checked
    set-up steps from the seed's weights, the checked window step from the
    program's state before it."""
    spe = inputs["steps_per_epoch"]
    trainer = reference_trainer(ctx, device, spe)
    losses, grad_norms = replay(trainer, inputs["setup"], precision, half)
    start = W.draw([(k, v.shape) for k, v in trainer.params.items()],
                   ctx.seed, device, "predictor")
    setup = {"losses": losses, "grad_norms": grad_norms,
             "change_norms": leaf_norms({k: p.detach() - start[k]
                                         for k, p in trainer.params.items()})}
    del trainer, start
    free_device()
    before, batch, seed = inputs["timed"]
    trainer = reference_trainer(ctx, device, spe, before)
    losses, grad_norms = replay(trainer, [(batch, seed)], precision, half)
    timed = {"losses": losses, "grad_norms": grad_norms,
             "change_norms": leaf_norms({
                 k: p.detach() - before["state"][k].to(device)
                 for k, p in trainer.params.items()})}
    del trainer
    free_device()
    return {"setup": setup, "timed": timed}


def compare_steps(program, reference, prefix=""):
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(program["losses"], reference["losses"])]
    g_ref = reference["grad_norms"]
    med = statistics.median(g_ref.values())
    moved = lambda k: g_ref[k] >= 1e-3 * med  # noqa: E731
    grad, grad_leaf = check.leaf_gap(program["grad_norms"], g_ref)
    update, update_leaf = check.leaf_gap(program["change_norms"],
                                         reference["change_norms"], moved)
    return {prefix + "loss_gap": max(gaps) if gaps else float("nan"),
            prefix + "grad_norm_gap": grad,
            prefix + "update_norm_gap": update,
            prefix + "grad_norm_gap_leaf": grad_leaf,
            prefix + "update_norm_gap_leaf": update_leaf}


def compare(program, reference):
    """The numbers compared: the set-up steps' under their own names, the
    window step's with ``timed_`` before them."""
    return {**compare_steps(program["setup"], reference["setup"]),
            **compare_steps(program["timed"], reference["timed"], "timed_")}


def run(ctx):
    device = ctx.device
    rec, program, inputs = run_program(ctx, device)
    free_device()
    reference = reference_numbers(ctx, device, inputs)
    values = compare(program, reference)
    correct, rows = check.judge(values, ctx.limits)
    for line in check.lines(rows):
        log(line)
    log(f"losses of the checked steps: program "
        f"{program['setup']['losses']}, reference "
        f"{reference['setup']['losses']}; of the window step: program "
        f"{program['timed']['losses']}, reference "
        f"{reference['timed']['losses']}; worst leaves: " + ", ".join(
            f"{k} {v}" for k, v in values.items() if k.endswith("_leaf"))
        + "; not compared: " + ", ".join(
            f"{k} {v!r}" for k, v in values.items()
            if k not in ctx.limits and not k.endswith("_leaf")))
    if ctx.trace:
        from npvp_bench import flops
        rec["flops"] = rec["steps"] * flops.train_step_flops(
            ctx.model_config, rec["batch"])
    rec.update(correct=correct, checks=rows, attempted=rec["steps"],
               failed=0,
               device=device_info(rec["process_peak_bytes"],
                                  rec["device_trace"]),
               breakdown=T.breakdown(rec["device_trace"], rec["trace"]))
    return rec
