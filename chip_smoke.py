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
   library call.

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

        if mask == "hide_last":
            allow = encoder_temporal_allow(Tq, device=dev)
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
    cases = [(n, B, Tq, Tk, m) for n, B, Tq, Tk, m, _ in SITES] + EXTRA
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


def profile(torch, fn):
    """Device time of one forward by kernel category (torch.profiler)."""
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
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
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
    print(f"profiled forward: wall {wall:.2f} ms (under the profiler), "
          f"device kernel time {total:.2f} ms, idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {ms:9.3f} ms {100 * ms / total:5.1f}%")
    print("  top kernels:")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")
    print("profile " + json.dumps({"wall_ms": wall, "device_ms": total,
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
    """Per call site, bf16: kernel, twin and library ms and the bound."""
    import torch.nn.functional as F

    dtype = torch.bfloat16
    per_forward = {v: dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                           bound_ms=0.0, by={"bytes": 0.0, "ops": 0.0},
                           per_call=[])
                   for v in ("oproj", "attn")}
    for name, B, Tq, Tk, mask, calls in SITES:
        for variant in ("oproj", "attn"):
            fuse = variant == "oproj"
            x = make_inputs(torch, B, Tq, Tk, mask, dtype, fuse)
            args = (x["q"], x["k"], x["v"], x["bias"])
            kw = dict(num_heads=NH, wo=x["wo"], bo=x["bo"])
            hd = HD // NH
            heads = lambda t: t.view(B, -1, NH, hd).transpose(1, 2)  # noqa
            allow = None if x["bias"] is None else x["bias"] == 0

            def library():
                ctx = F.scaled_dot_product_attention(
                    heads(x["q"]), heads(x["k"]), heads(x["v"]),
                    attn_mask=allow).transpose(1, 2).reshape(B, Tq, HD)
                return (F.linear(ctx, x["wo"], x["bo"].to(dtype)) if fuse
                        else ctx)

            saved = dict(ta.LAUNCHES)
            k_ms = time_call(torch, lambda: ta.temporal_attention(*args,
                                                                  **kw))
            ta.LAUNCHES.update(saved)  # timing launches are not the path's
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
            print(f"{variant:5s} {name:12s} B={B} T={Tq}x{Tk}: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"{l_ms:.4f} ms, bound {bound:.4f} ms (bytes "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
                  f"kernel/bound {k_ms / bound:.2f}, kernel/library "
                  f"{k_ms / l_ms:.3f}, "
                  f"{'beats' if k_ms < l_ms else 'LOSES TO'} the library; "
                  f"{calls}/forward")
            acc = per_forward[variant]
            acc["per_call"].append(dict(site=name, ms=k_ms, plain_ms=p_ms,
                                        library_ms=l_ms, bound_ms=bound))
            acc["ms"] += calls * k_ms
            acc["plain_ms"] += calls * p_ms
            acc["library_ms"] += calls * l_ms
            acc["bound_ms"] += calls * bound
            acc["by"]["bytes"] += calls * t_bytes
            acc["by"]["ops"] += calls * t_ops
    return per_forward


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", help="comma-separated phase numbers "
                        "(1-5) for a short check; the default runs all and "
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
              ("per-call timing", phase_per_call)]
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
    per_forward = results["per-call timing"]
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
