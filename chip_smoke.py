#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``npvp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2]

Builds the temporal-attention kernel from ``npvp_tpu_torch/kernels/csrc``
with nvcc, then runs eight phases (all of them by default; ``--phases``
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
   launches per step (40 per eval step, none in a train step, 32 for the
   epoch's GIF, which is checked), finite losses, the eval losses against
   the plain path (within 1e-3 of their size plus 1e-5, under 2e-2), a
   checkpoint round trip that gives the same next step, and a profiler
   breakdown of one train step;
7. stage-1 AE training at full width (the SMMNIST AE config as it stands:
   ngf 64, 3 downsamplings, clips of 15 at batch 8, bf16): 20 steps and one
   validation pass through ``npvp_tpu_torch.train.stage1_ae.train``, then
   its ``--smoke`` CLI: ms per train and eval step, peak memory, finite and
   falling L1, a checkpoint round trip whose next step is bit-identical, the
   epoch's GIF (header and frame count), and a profiler breakdown of one
   train step;
8. the chain on phase 7's AE checkpoint directory: stage-2 training of
   SMMNIST Unified NPVP-S at full width (4 steps, its GIF), then
   ``evaluate`` of the five tasks, best-of-2 over 2 test batches in bf16
   with the kernel and with the plain path (each task's PSNR within
   0.01 dB, SSIM and MSE within 1e-3 of their size plus 1e-5, launches =
   predictor forwards × 32), the
   evaluation and inference CLIs with GIFs, ``vfp_windowed`` at the
   flagship shapes (batch 64, 10 → 20 with max_T 20: two windows),
   ``predict_stream`` of 4 batches against 4 ``freeze_task`` calls with the
   same noise (equal), and I3D features of predicted and real clips
   (random weights from a seed). ``--phases 8`` runs phase 7 first.

Any failure exits non-zero; without CUDA it exits non-zero at once. The last
three lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = HERE / "npvp_tpu" / "configs"
# phase 7 trains the AE into WORK["dir"]/ae; phase 8 reads it there
WORK = {}

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
        # and one eval-mode forward (32 launches) for the GIF of epoch 0
        check(launches["oproj"] == 40 * len(ev) + 32
              and launches["attn"] == 0, f"launches {launches}")
        check_gif(Path(tmp) / "log" / "epoch_0.gif", p.max_T)
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
              "eval_launches_per_step": {"oproj": ev[0]["launches"],
                                         "attn": 0},
              "train_steps": len(tr), "eval_steps": len(ev)}
    print("training " + json.dumps(result))
    return result


def reset_launches(ta):
    for key in ta.LAUNCHES:
        ta.LAUNCHES[key] = 0


def check_gif(path, frames=None):
    """Frames of a GIF89a file (its header and blocks read back); fails
    unless there are ``frames`` of them, or any when None."""
    from npvp_tpu_torch.core.metrics import gif_frame_count

    n = gif_frame_count(path)
    check(n == frames if frames is not None else n > 0,
          f"{path}: {n} frames, not {frames}")
    return n


def phase_stage1(torch, ta):
    """Stage-1 AE training at full width, then its --smoke CLI."""
    import numpy as np

    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.train import stage1_ae as s1

    steps_wanted, work = 20, WORK["dir"]
    yaml = CONFIGS / "config_SMMNIST_Autoencoder.yaml"
    cfg = load_config(yaml, [
        "AE.epochs=1", "AE.log_per_epochs=1",
        f"AE.ckpt_save_dir={work}/ae",
        f"AE.tensorboard_save_dir={work}/ae_log",
        f"Dataset.dev_set_size={8 * steps_wanted}"])
    a, d = cfg.AE, cfg.Dataset
    print(f"SMMNIST AE (ngf {a.ngf}, {a.n_downsampling} downsamplings, "
          f"{a.num_res_blocks} res blocks, {d.img_size}x{d.img_size}x"
          f"{d.img_channels}), clips of "
          f"{d.num_past_frames + d.num_future_frames}, batch {d.batch_size}, "
          f"{cfg.Env.compute_dtype}")
    record = {"train": [], "eval": []}
    clock = [0.0]

    def on_step(kind, index, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        loss = float(next(iter(metrics.values())))
        record[kind].append(dict(ms=(now - clock[0]) * 1e3, loss=loss))
        check(np.isfinite(loss), f"{kind} step {index}: L1 {loss}")
        clock[0] = time.perf_counter()

    reset_launches(ta)
    torch.cuda.reset_peak_memory_stats()
    t0 = clock[0] = time.perf_counter()
    state = s1.train(cfg, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr, ev = record["train"], record["eval"]
    check(len(tr) == steps_wanted and state.step == steps_wanted,
          f"{len(tr)} train steps, state.step {state.step}")
    check(len(ev) >= 1, "no eval step ran")
    check(sum(ta.LAUNCHES.values()) == 0, "the AE launched the kernel")
    losses = [r["loss"] for r in tr]
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"the L1 did not fall: {losses}")
    train_ms = statistics.median(r["ms"] for r in tr[3:])
    eval_ms = statistics.median(r["ms"] for r in ev[1:] or ev)
    print(f"train(): {len(tr)} train + {len(ev)} eval steps in {wall:.1f} s "
          f"(set-up included); train step {train_ms:.2f} ms median after 3 "
          f"warm-up steps ({d.batch_size / (train_ms / 1e3):.1f} clips/s), "
          f"first three {[round(r['ms'], 1) for r in tr[:3]]} ms; eval step "
          f"{eval_ms:.2f} ms median; peak memory {peak:.2f} GiB")
    print(f"L1: train {[round(v, 4) for v in losses]}, eval "
          f"{[round(r['loss'], 4) for r in ev]}")
    frames = d.num_past_frames + d.num_future_frames
    gif = Path(a.tensorboard_save_dir) / "epoch_0.gif"
    print(f"GIF {gif.name}: GIF89a, {check_gif(gif, frames)} frames, "
          f"{gif.stat().st_size} bytes")
    mngr = CheckpointManager(a.ckpt_save_dir, monitor="L1_loss_valid")
    check(mngr.latest_step() == steps_wanted, "no checkpoint of the run")

    # checkpoint round trip: the next step from a restored state
    dev = next(state.model.parameters()).device
    steps = s1.make_steps(dev)
    batch = steps.place(next(iter(DataModule(cfg).train_loader())))
    rt = CheckpointManager(Path(work) / "ae_roundtrip", max_to_keep=1)
    rt.save(state.step, state)
    want = float(steps.train(state, batch)["L1_loss_train"])
    fresh = s1.init_state(cfg, s1.build_ae(cfg, s1.compute_dtype(cfg)).to(
        dev))
    rt.restore(fresh)
    got = float(steps.train(fresh, batch)["L1_loss_train"])
    print(f"checkpoint round trip: next-step L1 {want!r} vs {got!r} after "
          f"restore ({'bit-identical' if want == got else 'DIFFERENT'})")
    check(want == got, "the restored state takes a different next step")
    profile(torch, lambda: steps.train(fresh, batch), "stage-1 train step")

    t0 = time.perf_counter()
    s1.main(["--config_path", str(yaml), "--smoke", "--override",
             f"AE.ckpt_save_dir={work}/ae_cli",
             f"AE.tensorboard_save_dir={work}/ae_cli_log"])
    cli_s = time.perf_counter() - t0
    check(CheckpointManager(f"{work}/ae_cli").latest_step() == 2,
          "the --smoke CLI wrote no checkpoint of step 2")
    check_gif(Path(work) / "ae_cli_log" / "epoch_0.gif", frames)
    print(f"stage1_ae --smoke CLI: 2 steps, a checkpoint and a GIF in "
          f"{cli_s:.1f} s")
    result = {"train_ms": train_ms, "eval_ms": eval_ms,
              "clips_per_s": d.batch_size / (train_ms / 1e3),
              "peak_gib": peak, "first_l1": losses[0], "last_l1": losses[-1],
              "train_steps": len(tr), "eval_steps": len(ev)}
    print("stage1 " + json.dumps(result))
    return result


def _stage2_over_ae(torch, ta, np):
    """Stage 2 (SMMNIST Unified NPVP-S, full width, 4 steps) over phase 7's
    AE directory; → its config."""
    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.train import stage2_predictor as s2

    work = WORK["dir"]
    cfg = load_config(CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml", [
        "Predictor.exec_mode=pallas", "Predictor.epochs=1",
        f"Predictor.resume_AE_ckpt={work}/ae",
        f"Predictor.ckpt_save_dir={work}/pred",
        f"Predictor.tensorboard_save_dir={work}/pred_log",
        "Dataset.dev_set_size=32"])
    frozen = s2.load_frozen_ae(cfg, torch.float32, "cpu").state_dict()
    trained = CheckpointManager(f"{work}/ae").load()["model"]
    check(all(torch.equal(v, trained[k]) for k, v in frozen.items()),
          "the frozen AE is not phase 7's checkpoint")
    losses = []
    t0 = time.perf_counter()
    state = s2.train(cfg, on_step=lambda kind, i, m: losses.append(
        float(m["loss" if kind == "train" else "loss_val"])))
    torch.cuda.synchronize()
    check(state.step == 4 and len(losses) == 8 and np.isfinite(losses).all(),
          f"stage 2: step {state.step}, losses {losses}")
    check_gif(Path(work) / "pred_log" / "epoch_0.gif", cfg.Predictor.max_T)
    print(f"stage 2 over phase 7's AE ({work}/ae): 4 train + 4 eval steps "
          f"in {time.perf_counter() - t0:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, GIF of epoch 0 decoded")
    return cfg


def _evaluate_arms(torch, ta, np, cfg):
    """The five tasks, best-of-2 over 2 test batches, bf16, kernel and plain
    arms; → per task its launches, seconds and predicted frames/s."""
    from npvp_tpu_torch.eval.evaluate import _task_split, evaluate

    d, p = cfg.Dataset, cfg.Predictor
    batches, samples = 2, 2
    kw = dict(max_batches=batches, num_samples=samples, baseline=True,
              ae_ceiling=True, dtype=torch.bfloat16, device="cuda")
    evaluate(cfg, task="VFP", **{**kw, "max_batches": 1},
             exec_mode="pallas")  # warm-up: cuDNN and cuBLAS choose
    out = {}
    for task in ("VFP", "VPE", "VFI", "VRC", "HVRC"):
        if task == "VFP":
            P, n_tgt = d.test_num_past_frames, d.test_num_future_frames
            windows = -(-n_tgt // (p.max_T - P)) if P + n_tgt > p.max_T \
                else 1
        else:
            windows = 1
            n_tgt = len(_task_split(task, cfg, cfg.Env.rand_seed)[1])
        forwards = batches * samples * windows
        res, secs, launches = {}, {}, {}
        for arm in ("pallas", "xla"):
            reset_launches(ta)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[arm] = evaluate(cfg, task=task, exec_mode=arm, **kw)
            torch.cuda.synchronize()
            secs[arm] = time.perf_counter() - t0
            launches[arm] = dict(ta.LAUNCHES)
        check(launches["pallas"] == {"oproj": 32 * forwards, "attn": 0},
              f"{task}: kernel launches {launches['pallas']}, not 32 x "
              f"{forwards} forwards")
        check(launches["xla"] == {"oproj": 0, "attn": 0},
              f"{task}: the plain arm launched the kernel")
        # each task's metric (its mean over the targets): PSNR within
        # 0.01 dB, SSIM and MSE within 1e-3 of their own size plus 1e-5
        # (phase 6's form: the SSIM of a model four steps into training is
        # near 0); the per-target gaps are printed beside
        worst = {}
        for metric in ("PSNR", "SSIM", "MSE"):
            for tag in ("", "_baseline", "_ae_ceiling"):
                key = f"{metric}{tag}"
                got, want = res["pallas"][key], res["xla"][key]
                per_t = np.asarray(res["pallas"][key + "_per_t"])
                check(np.isfinite(per_t).all(), f"{task} {key}: {per_t}")
                err = abs(got - want)
                if not tag:
                    worst[metric] = float(err)
                    worst[metric + "_per_t"] = float(np.abs(
                        per_t - np.asarray(res["xla"][key + "_per_t"])).max())
                bound = 0.01 if metric == "PSNR" else 1e-3 * abs(want) + 1e-5
                check(err <= bound, f"{task} {key}: kernel {got} vs plain "
                      f"{want} (|d| {err:.3e} > {bound:.3e})")
        frames = batches * samples * d.batch_size * n_tgt
        out[task] = dict(launches=launches["pallas"]["oproj"],
                         forwards=forwards, seconds=secs,
                         frames_per_s={a: frames / s for a, s in
                                       secs.items()},
                         PSNR=res["pallas"]["PSNR"],
                         PSNR_plain=res["xla"]["PSNR"],
                         SSIM=res["pallas"]["SSIM"], worst=worst)
        print(f"evaluate {task:4s} bf16 best-of-{samples}, {batches} "
              f"batches: kernel {secs['pallas']:.2f} s "
              f"({out[task]['frames_per_s']['pallas']:.1f} predicted "
              f"frames/s), plain {secs['xla']:.2f} s; "
              f"{launches['pallas']['oproj']} kernel launches = {forwards} "
              f"forwards x 32; PSNR {res['pallas']['PSNR']:.4f} vs "
              f"{res['xla']['PSNR']:.4f} dB (|d| {worst['PSNR']:.2e}, per-t "
              f"max {worst['PSNR_per_t']:.2e}), SSIM "
              f"{res['pallas']['SSIM']:.5f} (|d| {worst['SSIM']:.2e}), "
              f"MSE {res['pallas']['MSE']:.3f} (|d| {worst['MSE']:.2e})")
    return out


def _clis(torch, ta, cfg_path, work):
    from npvp_tpu_torch.eval import evaluate as ev
    from npvp_tpu_torch.train import inference as inf

    # the saved config names phase 8's checkpoints and exec_mode pallas
    t0 = time.perf_counter()
    reset_launches(ta)
    ev.main(["--config_path", str(cfg_path), "--task", "VFI",
             "--num_samples", "2", "--max_batches", "1", "--gif_dir",
             f"{work}/eval_gifs", "--out", f"{work}/eval.json"])
    check(ta.LAUNCHES["oproj"] == 2 * 32, f"evaluate CLI: {ta.LAUNCHES}")
    check(json.loads(Path(f"{work}/eval.json").read_text())["task"] == "VFI",
          "evaluate CLI wrote no result")
    gifs = sorted(Path(f"{work}/eval_gifs").glob("*.gif"))
    check(len(gifs) == 4, f"evaluate CLI GIFs: {gifs}")
    for gif in gifs:
        check_gif(gif)
    reset_launches(ta)
    inf.main(["--config_path", str(cfg_path), "--batches", "1",
              "--gif_dir", f"{work}/inf_gifs"])
    check(ta.LAUNCHES["oproj"] == 5 * 32, f"inference CLI: {ta.LAUNCHES}")
    for task in ("VFP", "VPE", "VFI", "VRC", "HVRC"):
        check_gif(Path(f"{work}/inf_gifs/{task}.gif"))
    print(f"evaluate and inference CLIs on phase 8's checkpoints: "
          f"{time.perf_counter() - t0:.1f} s, 4 + 5 GIFs decoded, the "
          "kernel served both")


def _flagship_window_stream_fvd(torch, ta, np):
    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.eval.fvd import FVD
    from npvp_tpu_torch.models.inference import VideoPredictor

    cfg = flagship_config()
    p, d = cfg.Predictor, cfg.Dataset
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                         exec_mode="pallas", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (64, 10, d.img_size, d.img_size, d.img_channels)
    past = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
    eps = [torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                       device="cuda") for _ in range(4)]
    out = {}

    # sliding windows: 10 observed -> 20 predicted with max_T 20
    vp.vfp(past, 20, eps=eps[:2])  # warm-up
    reset_launches(ta)
    pred = vp.vfp(past, 20, eps=eps[:2])
    torch.cuda.synchronize()
    check(ta.LAUNCHES == {"oproj": 64, "attn": 0},
          f"vfp_windowed: launches {ta.LAUNCHES}, not 2 windows x 32")
    check(tuple(pred.shape) == (64, 20) + shape[2:]
          and bool(torch.isfinite(pred.float()).all()), "vfp_windowed output")
    ms = statistics.median(time_forwards(torch, lambda: vp.vfp(
        past, 20, eps=eps[:2]), 3) for _ in range(3))
    out["vfp_windowed"] = dict(ms=ms, frames_per_s=64 * 20 / (ms / 1e3))
    print(f"vfp_windowed flagship, batch 64, 10 -> 20 (2 windows), bf16, "
          f"kernel: {ms:.2f} ms, {64 * 20 / (ms / 1e3):.1f} predicted "
          "frames/s, 64 launches")

    # a stream of 4 batches against 4 frozen-task calls, the same noise
    stream = torch.rand((4,) + shape, generator=gen, device="cuda") * 2 - 1
    to, tp = np.arange(10), np.arange(10, 20)
    frozen = vp.freeze_task(to, tp)
    vp.predict_stream(stream, to, tp, eps=eps)  # warm-up
    reset_launches(ta)
    got = vp.predict_stream(stream, to, tp, eps=eps)
    torch.cuda.synchronize()
    check(ta.LAUNCHES == {"oproj": 4 * 32, "attn": 0},
          f"predict_stream: launches {ta.LAUNCHES}")
    want = torch.stack([frozen(stream[s], eps=eps[s]) for s in range(4)])
    diff = (got.float() - want.float()).abs().max().item()
    print(f"predict_stream S=4 vs 4 freeze_task calls, same eps: max|d| "
          f"{diff!r} (atol 0)")
    check(diff == 0.0, "predict_stream departs from freeze_task")
    ms_stream = statistics.median(time_forwards(
        torch, lambda: vp.predict_stream(stream, to, tp, eps=eps), 2)
        for _ in range(3)) / 4

    def frozen_all():
        for s in range(4):
            frozen(stream[s], eps=eps[s])

    ms_frozen = statistics.median(time_forwards(torch, frozen_all, 2)
                                  for _ in range(3)) / 4
    out["stream"] = dict(ms_per_batch=ms_stream,
                         frozen_ms_per_batch=ms_frozen)
    print(f"predict_stream {ms_stream:.2f} ms per batch, freeze_task "
          f"{ms_frozen:.2f} ms per batch (batch 64, VFP 10 -> 10, bf16)")

    # I3D features of 16 predicted and 16 real clips (random weights)
    fvd = FVD(torch.bfloat16, device="cuda").init_random(0)
    fake, real = (got[0, :16].float() + 1) / 2, (stream[0, :16] + 1) / 2
    fvd.features(fake)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ff, fr = fvd.features(fake), fvd.features(real)
    i3d_ms = (time.perf_counter() - t0) * 1e3 / 2
    check(ff.shape == fr.shape == (16, 400) and np.isfinite(ff).all()
          and np.isfinite(fr).all(), "I3D features")
    out["i3d_ms_per_16_clips"] = i3d_ms
    print(f"I3D features, 16 clips of 10 frames at 224x224, bf16, random "
          f"weights: {i3d_ms:.1f} ms per 16 clips (host copy included)")
    return out


def phase_chain(torch, ta):
    """Stage 2 over phase 7's AE, evaluation and serving with the kernel."""
    import numpy as np

    cfg = _stage2_over_ae(torch, ta, np)
    evals = _evaluate_arms(torch, ta, np, cfg)
    cfg_path = Path(WORK["dir"]) / "stage2.json"
    cfg.save(cfg_path)
    _clis(torch, ta, cfg_path, WORK["dir"])
    serving = _flagship_window_stream_fvd(torch, ta, np)
    result = {"evaluate": evals, **serving}
    print("chain " + json.dumps(result))
    return result


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", help="comma-separated phase numbers "
                        "(1-8) for a short check; the default runs all and "
                        "prints the record")
    args = parser.parse_args(argv)
    picked = (None if args.phases is None
              else {int(p) for p in args.phases.split(",")})
    if picked is not None and 8 in picked:
        picked.add(7)  # phase 8 trains stage 2 over phase 7's AE
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
              ("stage-2 training", phase_training),
              ("stage-1 training", phase_stage1),
              ("chain: stage 2, evaluation, serving", phase_chain)]
    if picked is not None:
        phases = [ph for i, ph in enumerate(phases, 1) if i in picked]
    WORK["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
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
    finally:
        shutil.rmtree(WORK["dir"], ignore_errors=True)
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
            "evaluate": {
                task: {k: v[k] for k in ("launches", "forwards")}
                for task, v in results["chain: stage 2, evaluation, "
                                       "serving"]["evaluate"].items()}
            if v == "oproj" else None,
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
