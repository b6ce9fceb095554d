#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``npvp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2]

Builds the temporal-attention kernel from ``npvp_tpu_torch/kernels/csrc``
with nvcc, then runs five phases (all of them by default; ``--phases``
picks some, for a short check), each printing its own lines:

1. environment: the card's name and power limit, torch, CUDA, nvcc, the
   kernel's build time, ptxas' registers and spills, and the dynamic shared
   memory of one block of each variant;
2. kernel against its plain PyTorch twin at the flagship call-site shapes,
   a ragged site count, Tq ≠ Tk and a query row whose keys are all masked,
   fp32 (tol 1e-4) and bf16 (tol 2e-2), both variants (fused output
   projection, attention only);
3. the golden fixture: the port in fp32 with the kernel launched against
   the JAX package's committed outputs (NPVP-D and NPVP-S, VFP and
   fractional-time HVRC), atol 1e-4;
4. flagship serving (KTH Unified NPVP-S at full width, random weights from
   a seed, batch 64, VFP 10→10, bf16) through ``VideoPredictor.freeze_task``:
   launches per forward, kernel path against the plain path, ms per
   forward, predicted frames/s, peak memory; then a profiler breakdown;
5. per call site and variant: kernel, plain twin and library (SDPA, plus
   F.linear when fused) times beside the least time the card could take
   (bytes or FLOP bound), kernel ÷ bound, and whether the kernel beats the
   library call;
6. stage-2 training at full width (SMMNIST Unified NPVP-S, bf16, random
   frozen AE weights from a seed written to a checkpoint): 20 train steps
   and one validation pass of 20 eval steps through
   ``npvp_tpu_torch.train.stage2_predictor.train`` with the kernel in the
   eval step: ms per train and eval step, clips/s, peak memory, kernel
   launches per step (40 per eval step, none in a train step), finite
   losses, the eval losses against the plain path (within 2e-2), a
   checkpoint round trip that gives the same next step, and a profiler
   breakdown of one train step.

Any failure exits non-zero; without CUDA it exits non-zero at once. The last
three lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s and tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# flagship call sites: (name, sites B, Tq, Tk, mask, calls per forward)
# window: 64 clips × 10 frames × 4 windows of 4×4 tokens; temporal and
# cross: 64 × 8×8 sites over T = 10; the encoder's temporal attention
# hides the last frame.
SITES = [("window", 2560, 16, 16, None, 12),
         ("temporal_enc", 4096, 10, 10, "hide_last", 4),
         ("temporal_dec", 4096, 10, 10, None, 8),
         ("cross", 4096, 10, 10, None, 8)]
# the stage-2 trainer's eval step at the SMMNIST config (batch 8, max_T 15,
# one split of 7 observed frames): windows of the EVT-Former's two codings
# and of the decoder, the EVT-Former's temporal attention with the observed
# frames' allow matrix (each coding, so 8), the decoder's self-attention
# over the target frames and its cross-attention over the observed ones
EVAL_SITES = [("window_T15", 480, 16, 16, None, 16),
              ("temporal_enc_T15", 512, 15, 15, "obs_encoder", 8),
              ("temporal_dec_T15", 512, 15, 15, "tgt_self", 8),
              ("cross_T15", 512, 15, 15, "obs_cross", 8)]
OBS15 = [1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0]
EXTRA = [("ragged", 4099, 10, 10, "hide_last"),
         ("tq_ne_tk", 1000, 10, 7, "random"),
         ("masked_row", 4096, 10, 10, "masked_row")]
NH, HD = 8, 512


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_environment(torch, ta):
    print(nvidia_smi_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x {torch.cuda.device_count()}")
    nvcc = subprocess.run([ta.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    lib = ta.build()
    print(f"kernel build: {ta.BUILD_INFO.get('seconds', 0.0):.1f} s -> "
          f"{Path(lib).relative_to(HERE)}")
    for line in ta.BUILD_INFO.get("ptxas", []):
        print("  " + line)
    for name, _, Tq, Tk, _, _ in SITES[:2]:
        for fuse in (True, False):
            print(f"dynamic shared memory per block, bf16 "
                  f"{'fused' if fuse else 'attention only'} {name} "
                  f"(Tq={Tq}, Tk={Tk}): "
                  f"{ta.smem_bytes(Tq, Tk, HD, NH, torch.bfloat16, fuse)} B")


def make_inputs(torch, B, Tq, Tk, mask, dtype, fuse, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    q, k, v = rnd(B, Tq, HD), rnd(B, Tk, HD), rnd(B, Tk, HD)
    bias = None
    if mask is not None:
        from npvp_tpu_torch.kernels.temporal_attention import allow_to_bias
        from npvp_tpu_torch.nn.vidhrformer import encoder_temporal_allow

        obs = torch.tensor(OBS15, dtype=torch.bool, device=dev)
        if mask == "hide_last":
            allow = encoder_temporal_allow(Tq, device=dev)
        elif mask == "obs_encoder":
            allow = encoder_temporal_allow(Tq, obs, device=dev)
        elif mask in ("tgt_self", "obs_cross"):
            allow = (~obs if mask == "tgt_self" else obs)[None].expand(Tq, Tk)
        else:
            allow = torch.rand((Tq, Tk), generator=g, device=dev) > 0.4
            allow[:, 0] = True
            if mask == "masked_row":  # query 3 sees no key
                allow[3] = False
        bias = allow_to_bias(allow)
    wo = bo = None
    if fuse:  # (C, H·D), nn.Linear's weight
        wo = (rnd(HD, HD) / HD ** 0.5).to(dtype)
        bo = rnd(HD) * 0.1
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), bias=bias,
                wo=wo, bo=bo)


def phase_kernel_vs_plain(torch, ta):
    """Returns the largest bf16 error of each variant."""
    worst = {"oproj": 0.0, "attn": 0.0}
    cases = [(n, B, Tq, Tk, m) for n, B, Tq, Tk, m, _ in SITES + EVAL_SITES
             ] + EXTRA
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for variant in ("oproj", "attn"):
            for name, B, Tq, Tk, mask in cases:
                x = make_inputs(torch, B, Tq, Tk, mask, dtype,
                                variant == "oproj", seed=B + Tk)
                args = (x["q"], x["k"], x["v"], x["bias"])
                kw = dict(num_heads=NH, wo=x["wo"], bo=x["bo"])
                got = ta.temporal_attention(*args, **kw).float()
                want = ta.temporal_attention_plain(*args, **kw).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                ok = bool((err <= tol + tol * want.abs()).all()) and bool(
                    torch.isfinite(got).all())
                dt = str(dtype).replace("torch.", "")
                print(f"{variant:5s} {dt:8s} {name:12s} B={B} Tq={Tq} "
                      f"Tk={Tk} mask={mask}: max|d|={err.max().item():.3e} "
                      f"(tol {tol}+{tol}|x|) {'ok' if ok else 'FAIL'}")
                check(ok, f"{variant} {dt} {name} disagrees with the twin")
                if dtype == torch.bfloat16:
                    worst[variant] = max(worst[variant], err.max().item())
    return worst


def phase_golden(torch, ta):
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.tools.golden import load_golden

    g = load_golden()
    for tag in ("d", "s"):
        vp = VideoPredictor.from_variables(
            g["cfg"][tag], g["ae_vars"], g["pred_vars"][tag],
            dtype=torch.float32, exec_mode="pallas", device="cuda")
        eps = g["eps"] if tag == "s" else None
        for task in ("vfp", "hvrc"):
            before = ta.LAUNCHES["oproj"]
            out = (vp.vfp(g["frames"], 2, eps=eps) if task == "vfp" else
                   vp.hvrc(g["frames"], g["hvrc_to"], g["hvrc_tp"], eps=eps))
            out = out.float().cpu().numpy()
            want = g[f"{task}_{tag}"]
            err = float(abs(out - want).max())
            launches = ta.LAUNCHES["oproj"] - before
            ok = out.shape == want.shape and err <= 1e-4 and launches > 0
            print(f"NPVP-{tag.upper()} {task} fp32: max|d|={err:.3e} vs the "
                  f"JAX golden (atol 1e-4), {launches} kernel launches "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"golden NPVP-{tag.upper()} {task} failed")


def time_forwards(torch, fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_flagship(torch, ta):
    import numpy as np

    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.models.inference import VideoPredictor

    cfg = flagship_config()
    p, d = cfg.Predictor, cfg.Dataset
    t0 = time.perf_counter()
    kernel_vp = VideoPredictor.from_random_init(
        cfg, torch.bfloat16, seed=0, exec_mode="pallas", device="cuda")
    plain_vp = VideoPredictor.from_random_init(
        cfg, torch.bfloat16, seed=0, exec_mode="xla", device="cuda")
    print(f"KTH Unified NPVP-S (embed {p.embed_dim}, "
          f"{p.transformer_layers} + {p.evt_former_num_layers} layers), "
          f"random init: {time.perf_counter() - t0:.1f} s; batch 64, "
          f"VFP 10->10, bf16")
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.rand((64, 10, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device="cuda") * 2 - 1
    eps = torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                      device="cuda")
    to, tp = np.arange(10), np.arange(10, 20)
    runs = {"kernel_oproj": (kernel_vp.freeze_task(to, tp), True),
            "kernel_attn": (kernel_vp.freeze_task(to, tp), False),
            "plain": (plain_vp.freeze_task(to, tp), True)}

    def forward(name):
        fn, fuse = runs[name]
        ta.FUSE_OPROJ = fuse
        try:
            return fn(frames, eps=eps)
        finally:
            ta.FUSE_OPROJ = True

    outs, launches = {}, {}
    for name in runs:
        forward(name)  # warm-up: cuDNN and cuBLAS choose their kernels
        for key in ta.LAUNCHES:
            ta.LAUNCHES[key] = 0
        outs[name] = forward(name)
        torch.cuda.synchronize()
        launches[name] = dict(ta.LAUNCHES)
        print(f"{name:12s}: one forward -> kernel launches {launches[name]}")
    check(launches["kernel_oproj"] == {"oproj": 32, "attn": 0},
          "the fused kernel must serve all 32 attention calls")
    check(launches["kernel_attn"] == {"oproj": 0, "attn": 32},
          "the attention-only kernel must serve all 32 attention calls")
    check(launches["plain"] == {"oproj": 0, "attn": 0},
          "the plain path launched a kernel")
    shape = (64, 10, d.img_size, d.img_size, d.img_channels)
    for name, out in outs.items():
        check(tuple(out.shape) == shape and bool(torch.isfinite(
            out.float()).all()), f"{name}: bad output {tuple(out.shape)}")
    for name in ("kernel_oproj", "kernel_attn"):
        diff = (outs[name].float() - outs["plain"].float()).abs()
        print(f"{name} vs plain outputs: max|d|={diff.max().item():.3e} "
              f"mean|d|={diff.mean().item():.3e}")
        check(diff.max().item() < 0.1, f"{name} departs from the plain path")

    blocks = {name: [] for name in runs}
    order = ["plain", "kernel_oproj", "kernel_attn"]
    for r in range(3):
        for name in (order if r % 2 == 0 else order[::-1]):
            blocks[name].append(time_forwards(torch, lambda: forward(name),
                                              5))
    serving = {}
    for name, ms in blocks.items():
        med = statistics.median(ms)
        serving[name] = {"ms_per_forward": med,
                         "frames_per_s": 640 / (med / 1e3),
                         "ms_blocks_of_5": ms}
        print(f"{name:12s}: {med:.2f} ms/forward (blocks of 5: "
              f"{[round(m, 2) for m in ms]}), "
              f"{640 / (med / 1e3):.1f} predicted frames/s")
    torch.cuda.reset_peak_memory_stats()
    forward("kernel_oproj")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"peak memory {peak:.2f} GiB (kernel_oproj forward)")
    print("serving " + json.dumps({**serving, "peak_gib": peak}))
    profile(torch, lambda: forward("kernel_oproj"))
    return launches, serving


def profile(torch, fn, what="forward"):
    """Device time of one call of ``fn`` (``what``) by kernel category
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cats, kernels = {}, {}
    total = 0.0
    for ev in pr.key_averages():
        # kernels only: the aten ops that launch them carry the same time
        if (not str(getattr(ev, "device_type", "")).endswith("CUDA")
                or getattr(ev, "is_user_annotation", False)):
            continue  # an annotation spans kernels counted on their own
        dev_us = (getattr(ev, "self_device_time_total", None)
                  or getattr(ev, "self_cuda_time_total", 0.0) or 0.0)
        if dev_us <= 0:
            continue
        name = ev.key
        low = name.lower()
        cat = ("temporal_attention kernel" if "temporal_attention" in low
               else "convolution (cuDNN)" if any(s in low for s in (
                   "conv", "cudnn", "fprop", "dgrad", "winograd",
                   "implicit"))
               else "matmul (cuBLAS)" if any(s in low for s in (
                   "gemm", "nvjet", "cutlass", "xmma"))
               else "reduction" if "reduce" in low
               else "elementwise" if "elementwise" in low
               else "other")
        cats[cat] = cats.get(cat, 0.0) + dev_us / 1e3
        kernels[name] = (dev_us / 1e3, ev.count)
        total += dev_us / 1e3
    if total <= 0:
        print("profiler: no device time recorded")
        return
    print(f"profiled {what}: wall {wall:.2f} ms (under the profiler), "
          f"device kernel time {total:.2f} ms, idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {ms:9.3f} ms {100 * ms / total:5.1f}%")
    print("  top kernels:")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")
    print("profile " + json.dumps({"of": what, "wall_ms": wall,
                                   "device_ms": total,
                                   "by_category_ms": cats}))


def time_call(torch, fn, n=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_per_call(torch, ta):
    """Per call site, bf16: kernel, twin and library ms and the bound,
    summed over a flagship forward and over a stage-2 eval step."""
    import torch.nn.functional as F

    dtype = torch.bfloat16
    totals = {}
    for path, sites in (("forward", SITES), ("eval_step", EVAL_SITES)):
        totals[path] = {v: dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                bound_ms=0.0, by={"bytes": 0.0, "ops": 0.0},
                                per_call=[])
                        for v in ("oproj", "attn")}
        for name, B, Tq, Tk, mask, calls in sites:
            for variant in ("oproj", "attn"):
                acc = totals[path][variant]
                fuse = variant == "oproj"
                x = make_inputs(torch, B, Tq, Tk, mask, dtype, fuse)
                args = (x["q"], x["k"], x["v"], x["bias"])
                kw = dict(num_heads=NH, wo=x["wo"], bo=x["bo"])
                hd = HD // NH
                heads = lambda t: t.view(  # noqa: E731
                    B, -1, NH, hd).transpose(1, 2)
                allow = None if x["bias"] is None else x["bias"] == 0

                def library():
                    ctx = F.scaled_dot_product_attention(
                        heads(x["q"]), heads(x["k"]), heads(x["v"]),
                        attn_mask=allow).transpose(1, 2).reshape(B, Tq, HD)
                    return (F.linear(ctx, x["wo"], x["bo"].to(dtype))
                            if fuse else ctx)

                saved = dict(ta.LAUNCHES)
                k_ms = time_call(torch, lambda: ta.temporal_attention(
                    *args, **kw))
                ta.LAUNCHES.update(saved)  # timing is not the path's run
                p_ms = time_call(torch, lambda: ta.temporal_attention_plain(
                    *args, **kw), n=5)
                l_ms = time_call(torch, library)
                C = HD
                nbytes = 2 * (B * Tq * HD + 2 * B * Tk * HD + B * Tq * C)
                flops = 4 * B * Tq * Tk * HD
                if fuse:
                    nbytes += 2 * HD * C + 4 * C
                    flops += 2 * B * Tq * HD * C
                if x["bias"] is not None:
                    nbytes += 4 * Tq * Tk
                t_bytes = nbytes / PEAK_BYTES_S * 1e3
                t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
                bound = max(t_bytes, t_ops)
                print(f"{variant:5s} {name:16s} B={B} T={Tq}x{Tk}: kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                      f"{l_ms:.4f} ms, bound {bound:.4f} ms (bytes "
                      f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
                      f"kernel/bound {k_ms / bound:.2f}, kernel/library "
                      f"{k_ms / l_ms:.3f}, "
                      f"{'beats' if k_ms < l_ms else 'LOSES TO'} the "
                      f"library; {calls}/{path}")
                acc["per_call"].append(dict(site=name, ms=k_ms,
                                            plain_ms=p_ms, library_ms=l_ms,
                                            bound_ms=bound))
                acc["ms"] += calls * k_ms
                acc["plain_ms"] += calls * p_ms
                acc["library_ms"] += calls * l_ms
                acc["bound_ms"] += calls * bound
                acc["by"]["bytes"] += calls * t_bytes
                acc["by"]["ops"] += calls * t_ops
    return totals


def phase_training(torch, ta):
    """Stage-2 training of SMMNIST Unified NPVP-S at full width."""
    import tempfile
    import types

    import numpy as np

    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    steps_wanted = 20
    yaml = HERE / "npvp_tpu" / "configs" / \
        "config_SMMNIST_Unified_NPVP-S.yaml"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(yaml, [
            "Predictor.exec_mode=pallas", "Predictor.epochs=1",
            f"Predictor.ckpt_save_dir={tmp}/ckpt",
            f"Predictor.tensorboard_save_dir={tmp}/log",
            f"Dataset.dev_set_size={8 * steps_wanted}"])
        p, d = cfg.Predictor, cfg.Dataset
        cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp))
        print(f"SMMNIST Unified NPVP-S (embed {p.embed_dim}, "
              f"{p.transformer_layers} + {p.evt_former_num_layers} layers, "
              f"max_T {p.max_T}), batch {d.batch_size}, "
              f"{cfg.Env.compute_dtype}, exec_mode {p.exec_mode}, "
              f"dropout {p.dropout}, drop_path {p.drop_path}")
        record = {"train": [], "eval": []}
        clock = [0.0, 0]

        def on_step(kind, index, metrics):
            torch.cuda.synchronize()
            now, launched = time.perf_counter(), sum(ta.LAUNCHES.values())
            loss = float(metrics["loss" if kind == "train" else "loss_val"])
            record[kind].append(dict(ms=(now - clock[0]) * 1e3, loss=loss,
                                     launches=launched - clock[1]))
            check(np.isfinite(loss), f"{kind} step {index}: loss {loss}")
            clock[:] = [time.perf_counter(), sum(ta.LAUNCHES.values())]

        for key in ta.LAUNCHES:
            ta.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = clock[0] = time.perf_counter()
        state = s2.train(cfg, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ta.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr, ev = record["train"], record["eval"]
        check(len(tr) == steps_wanted and state.step == steps_wanted,
              f"{len(tr)} train steps, state.step {state.step}")
        check(len(ev) >= 1, "no eval step ran")
        check(all(r["launches"] == 0 for r in tr),
              "a train step launched the kernel")
        check(all(r["launches"] == 40 for r in ev),
              f"eval steps launched {[r['launches'] for r in ev]}, not 40")
        check(launches["oproj"] == 40 * len(ev) and launches["attn"] == 0,
              f"launches {launches}")
        train_ms = statistics.median(r["ms"] for r in tr[3:])
        eval_ms = statistics.median(r["ms"] for r in ev[1:] or ev)
        print(f"train(): {len(tr)} train steps + {len(ev)} eval steps in "
              f"{wall:.1f} s (set-up included); train step "
              f"{train_ms:.2f} ms median after 3 warm-up steps "
              f"({d.batch_size / (train_ms / 1e3):.1f} clips/s), first "
              f"three {[round(r['ms'], 1) for r in tr[:3]]} ms; eval step "
              f"{eval_ms:.2f} ms median; peak memory {peak:.2f} GiB")
        print(f"kernel launches: {[r['launches'] for r in tr]} per train "
              f"step, {[r['launches'] for r in ev]} per eval step; "
              f"{launches}")
        print(f"losses: train {[round(r['loss'], 4) for r in tr]}, eval "
              f"{[round(r['loss'], 4) for r in ev]}")

        # the eval step with the kernel against the plain path, one state
        saved = dict(ta.LAUNCHES)
        dev = next(state.model.parameters()).device
        dtype = s2.compute_dtype(cfg)
        ae = s2.load_frozen_ae(cfg, dtype, dev)
        steps = s2.make_steps(cfg, ae, "rand_context", dev)
        dm = DataModule(cfg)
        batch = steps.place(next(iter(dm.val_loader("rand_context"))))
        plain = build_predictor(cfg, dtype, exec_mode="xla").to(dev)
        plain.load_state_dict(state.model.state_dict())
        got = steps.eval(state, batch, Rng(123))
        want = steps.eval(types.SimpleNamespace(model=plain), batch,
                          Rng(123))
        # each metric within 1e-3 of its own size (some are near 1e-2, so
        # the 2e-2 outer bound alone could not fail on them)
        diffs = {k: abs(float(got[k]) - float(want[k])) for k in want}
        bound = {k: min(2e-2, 1e-3 * abs(float(want[k])) + 1e-5)
                 for k in want}
        print("eval losses, kernel vs plain: " + ", ".join(
            f"{k} {float(got[k]):.6f} vs {float(want[k]):.6f} "
            f"(|d| {diffs[k]:.2e}, tol {bound[k]:.2e})" for k in want))
        far = [k for k in want if not diffs[k] <= bound[k]]
        check(not far, f"kernel eval departs from plain in {far}")

        # checkpoint round trip: the next step from a restored state
        train_batch = steps.place(next(iter(dm.train_loader("rand_context"))))
        mngr = CheckpointManager(Path(tmp) / "roundtrip", max_to_keep=1)
        mngr.save(state.step, state)
        next_loss = float(steps.train(state, train_batch, Rng(7))["loss"])
        fresh = s2.init_predictor_state(
            cfg, build_predictor(cfg, dtype).to(dev), steps_wanted)
        mngr.restore(fresh)
        again = float(steps.train(fresh, train_batch, Rng(7))["loss"])
        print(f"checkpoint round trip: next-step loss {next_loss!r} vs "
              f"{again!r} after restore "
              f"({'bit-identical' if next_loss == again else 'DIFFERENT'})")
        check(abs(next_loss - again) <= 1e-6 * abs(next_loss),
              "the restored state takes a different next step")
        profile(torch, lambda: steps.train(fresh, train_batch, Rng(8)),
                "train step")
        profile(torch, lambda: steps.eval(fresh, batch, Rng(9)),
                "eval step")
        ta.LAUNCHES.update(saved)  # comparison launches are not the path's
    result = {"train_ms": train_ms, "eval_ms": eval_ms,
              "clips_per_s": d.batch_size / (train_ms / 1e3),
              "peak_gib": peak, "launches": launches,
              "eval_launches_per_step": {
                  k: v // len(ev) for k, v in launches.items()},
              "train_steps": len(tr), "eval_steps": len(ev)}
    print("training " + json.dumps(result))
    return result


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", help="comma-separated phase numbers "
                        "(1-6) for a short check; the default runs all and "
                        "prints the record")
    args = parser.parse_args(argv)
    picked = (None if args.phases is None
              else {int(p) for p in args.phases.split(",")})
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    try:
        import npvp_tpu_torch
        from npvp_tpu_torch.kernels import temporal_attention as ta
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    if Path(npvp_tpu_torch.__file__).resolve().parents[1] != HERE:
        print("chip_smoke: npvp_tpu_torch was imported from elsewhere",
              file=sys.stderr)
        return 1
    # fp32 parity needs full-precision matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    results = {}
    phases = [("environment", phase_environment),
              ("kernel vs plain", phase_kernel_vs_plain),
              ("golden", phase_golden),
              ("flagship serving", phase_flagship),
              ("per-call timing", phase_per_call),
              ("stage-2 training", phase_training)]
    if picked is not None:
        phases = [ph for i, ph in enumerate(phases, 1) if i in picked]
    for name, fn in phases:
        print(f"\n== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            results[name] = fn(torch, ta)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            print(f"-- {name}: FAILED", flush=True)
            return 1
        print(f"-- {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(f"\nchip_smoke: all phases ok in "
          f"{time.perf_counter() - t_start:.1f} s")
    if picked is not None:
        return 0  # a short check: no record, no result line

    worst = results["kernel vs plain"]
    launches, _ = results["flagship serving"]
    per_forward = results["per-call timing"]["forward"]
    per_eval = results["per-call timing"]["eval_step"]
    training = results["stage-2 training"]
    replaces = {"oproj": "npvp_tpu/kernels/temporal_attention.py:136",
                "attn": "npvp_tpu/kernels/temporal_attention.py:127"}
    run_of = {"oproj": "kernel_oproj", "attn": "kernel_attn"}
    kernels = []
    for v in ("oproj", "attn"):
        acc = per_forward[v]
        kernels.append({
            "name": f"temporal_attention[{v}]", "route": "cuda",
            "source": "npvp_tpu_torch/kernels/csrc/temporal_attention.cu",
            "replaces": replaces[v], "launches": launches[run_of[v]][v],
            "max_abs_err": worst[v], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["by"]["bytes"] >= acc["by"]["ops"]
                         else "operations"),
            "library_ms": acc["library_ms"],
            "eval_step": {
                "launches": training["eval_launches_per_step"][v],
                **{k: per_eval[v][k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms")},
                "times": "per stage-2 eval step (SMMNIST, batch 8, T = 15):"
                         " the sum over its 40 calls, bf16"},
            "times": "per flagship forward: the sum over its 32 calls, bf16",
            "per_call": acc["per_call"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
