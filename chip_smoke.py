#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``npvp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2]

Builds the temporal-attention, LayerNorm, non-local attention and
decoder-tail kernels from ``npvp_tpu_torch/kernels/csrc`` with nvcc, then
runs eighteen phases
(all of them by default; ``--phases`` picks some, for a short check), each
printing its own lines:

1. environment: the card's name and power limit, torch, CUDA, nvcc, the
   kernels' build times, ptxas' registers and spills, and the dynamic
   shared memory of one block of each attention variant;
2. kernel against its plain PyTorch twin at the flagship call-site shapes,
   the stage-2 eval steps' shapes (SMMNIST T = 15; Cityscapes Tq 10 over
   Tk 2 and T 2; KITTI T 4/5 at 1024 sites; KTH rand-context T = 20), a
   ragged site count, Tq ≠ Tk and a query row whose keys are all masked,
   fp32 (tol 1e-4) and bf16 (tol 2e-2), both variants (fused output
   projection, attention only); then the LayerNorm kernel against its twin
   at the flagship's and batch 1's norm shapes, fp32 and bf16, with and
   without the GELU (tests/test_torch_layer_norm_cuda.py's tolerances);
3. the golden fixture: the port in fp32 with the kernel launched against
   the JAX package's committed outputs (NPVP-D and NPVP-S, VFP and
   fractional-time HVRC), atol 1e-4;
4. flagship serving (KTH Unified NPVP-S at full width, random weights from
   a seed, batch 64, VFP 10→10, bf16) through ``VideoPredictor.freeze_task``:
   launches per forward (32 attention, 60 + 66 LayerNorm), kernel path
   against the plain path, ms per forward, predicted frames/s, peak
   memory; then a profiler breakdown;
5. per call site and variant: kernel, plain twin and library (SDPA, plus
   F.linear when fused) times beside the least time the card could take
   (bytes or FLOP bound), kernel ÷ bound, and whether the kernel beats the
   library call, summed over a flagship forward, a SMMNIST eval step and a
   Cityscapes VFP eval step;
6. stage-2 training at full width (SMMNIST Unified NPVP-S, bf16, random
   frozen AE weights from a seed written to a checkpoint): 10 train steps
   and one validation pass of 10 eval steps through
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
   epoch's GIF (header and frame count), a profiler breakdown of one
   train step, and the 20 steps again with the clips fetched on the
   loader's worker processes (the pool forced; SMMNIST's cheap first batch
   otherwise keeps them in the producer thread);
8. the chain on phase 7's AE checkpoint directory: stage-2 training of
   SMMNIST Unified NPVP-S at full width (4 steps, its GIF), then
   ``evaluate`` of the five tasks, best-of-2 over 1 test batch in bf16
   with the kernel and with the plain path (each task's PSNR within
   0.01 dB, SSIM and MSE within 1e-3 of their size plus 1e-5, launches =
   predictor forwards × 32), the
   evaluation and inference CLIs with GIFs, ``vfp_windowed`` at the
   flagship shapes (batch 64, 10 → 20 with max_T 20: two windows),
   ``predict_stream`` of 4 batches against 4 ``freeze_task`` calls with the
   same noise (equal), and I3D features of predicted and real clips
   (random weights from a seed). ``--phases 8`` runs phase 7 first;
9. the frame-folder data layer and the new models: seeded PNG trees in the
   KTH, Cityscapes, KITTI and BAIR layouts (every filter type present, every
   file read back bit-equal) and a MovingMNIST npz; the loader alone on
   KTH (batch 8 × 20 frames) and Cityscapes (batch 8 × 12) at 1 worker and
   at the config's count (equal batches; ms per batch; decode ms per frame
   split into inflate and unfilter); KTH Unified NPVP-S as its YAML stands
   (the flagship) trained 6 steps and validated from PNG folders through
   ``stage2_predictor.train`` (step ms, clips/s, peak memory, 40 launches per
   eval step and none per train step, the eval losses against the plain
   path, the wait for each batch), then again with the frames decoded in
   the loader's producer thread (num_workers 1); the Cityscapes AE (128×128×3, ngf 32,
   4 downsamplings, 3 residual blocks) trained 10 steps, VFP NPVP-S over it
   4 steps, then ``evaluate`` VFP 2 → 28 windowed with the kernel and the
   plain path (PSNR within 0.01 dB, launches = forwards × 32) and the call
   shapes of its eval step; one KITTI (batch 16, resized) and one BAIR and
   MovingMNIST batch through ``DataModule``;
10. serving options and model tools at the flagship width (batch 64, VFP
   10→10, bf16): ``exec_mode="int8"`` through ``freeze_task`` (no kernel
   launch; feature drift under 5 % and PSNR over 40 dB against the kernel
   path, tests/test_quant.py's limits; ms per forward beside the kernel
   path's); ``export_task`` → ``serve_exported`` (bit-equal to
   ``freeze_task``, 32 launches through the op per chunk, 64 + 17 clips
   chunked and padded, ms per batch served and live, the bundle's size),
   and the kernel through its torch op against its launch function called
   directly (a forward each way, host µs per call); three stage-1 steps of
   a ``learn_3d`` SMMNIST AE and the decoder's ``s2d_head`` and
   ``subpixel`` forms against the direct ones (fp32 1e-4, bf16 0.1);
   ``save_weights`` → ``from_weights`` (bit-equal to the live model with
   float16-rounded weights); a synthetic flagship LitPredictor checkpoint
   through the converter (bit-equal forward).

11. parallelism (``npvp_tpu_torch.core.distributed``, tensor parallelism,
   DDP/FSDP, ``VideoPredictor.shard``): (a) SMMNIST Unified NPVP-S as its
   YAML stands, 4 train steps and a validation pass through
   ``stage2_predictor.train`` without a process group, in DDP and with
   ``Env.fsdp`` on an NCCL group of one rank (losses within phase 6's
   bound of the plain arm's, 40 launches per eval step, ms per step, peak
   memory; the FSDP checkpoint restored in one process gives the same eval
   losses); (b) the fused kernel on each head shard of model 2 and 4 at the
   flagship's window, temporal and cross shapes, wo's columns and bo on
   shard 0 alone, the shards' sum against the full launch and the twin
   (bf16 2e-2), ms per shard against the full launch; (c) two ranks on the
   card over gloo: the flagship through ``VideoPredictor.shard`` at data 2
   and at model 2 (batch 64, VFP 10→10) against one device's
   ``freeze_task`` (max|d| < 0.1, 32 launches a forward per rank), and 2
   stage-2 steps at data 2 against the one-process run at batch 16
   (phase 6's bound); over NCCL with FSDP where the host has two cards,
   else one line says it was not run.
12. sequence and pipeline parallelism, the dry run and the adversarial
   steps (``core.sequence_parallel``, ``core.pipeline``,
   ``tools.dryrun_multichip``, ``make_gan_steps``): (a) the fused kernel
   at the shapes sequence parallelism gives it at model 2 (whole sites, 4
   heads, wo's columns, no bias) against its twin, ms a launch; then on
   two ranks sharing the card over gloo: the flagship served through
   ``VideoPredictor.shard`` at model 2 under ``sequence_parallel(mesh)``
   against one device (max|d| < 0.1, 32 launches a forward per rank, ms
   a forward); (b) 2 steps of SMMNIST Unified NPVP-S at model 2 with
   sequence parallelism (1 without, for the peak) against one process at
   batch 8 (phase 6's bound), peak GiB a rank, the eval step's 40
   launches, and the SP spans and collectives of one profiled step; (c)
   GPipe of the flagship's 8 decoder blocks at 2 stages × 4 microbatches
   against the sequential stack on the same microbatches (bf16 2e-2, 48
   launches a rank); (d)
   ``dryrun_multichip(4)`` (4 ranks on the card over gloo: its three OK
   lines); (e) 5 adversarial steps of SMMNIST Unified NPVP-S at full
   width (finite losses, ms a step, peak), its eval step's 40 launches
   against the plain path.
13. SMMNIST as the JAX package draws it and the config generator
   (``data/native_bindings.py``, ``StochasticMovingMNIST.get_batch``,
   ``configs/generate.py``): the C++ data library built with the host's
   g++ (its version and build seconds); its stream against the numpy twin
   on 64 test clips (bit-equal); the SMMNIST test loader alone (batch 8, an
   epoch) on the stream and clip by clip, ms a batch; 4 eval steps of
   SMMNIST Unified NPVP-S as its YAML stands (full width, bf16, random
   weights from ``Env.rand_seed``) on the test loader's batches with no
   dev cut, so the clips come from the stream: 40 launches a step, each
   loss within phase 6's bound of the plain path's, ms a step; the
   generator's YAMLs written to a temporary directory, each loaded through
   ``Config`` and equal to the committed one.
14. the report tools (``npvp_tpu_torch/tools/{quality_report,
   exec_mode_fidelity,window_drift,frontier,convergence_report,
   memory_report}.py``) through their ``main``, on random-weight archives
   (``save_weights``, seeded) of SMMNIST Unified NPVP-D and -S at full
   width and the seeded SMMNIST test split, 2 batches of 8 an evaluation,
   bf16 with the kernel: the quality report of the five tasks of NPVP-D
   (best-of-1) and of VFP of NPVP-S (best-of-2; launches = batches x
   draws x 32 a call);
   the four exec-mode arms (the pallas arm's PSNR within 0.01 dB of the
   bf16 arm's, its 64 launches the only ones; then the arms' predicted
   frames and the predictor's features on one test batch: the pallas
   arm's frames within phase 4's max|d| < 0.1 of the bf16 arm's, and its
   features' mean |d| to the bf16 arm's at most twice the fp32 arm's);
   window drift (3 forwards a batch); the
   frontier of ``full``, ``L4`` and ``L4evt2`` served from one archive
   (32 / 20 / 16 launches a forward, frames/s round-robin, VFP quality);
   the convergence report of a three-epoch stage-1 log; the memory report
   at data 4 and model 2 beside ``torch.cuda.memory_allocated`` after
   phase 6's train state. Launches are counted for each kernel, in each
   tool and in each ``evaluate`` call it makes (the attention-only kernel
   none); every number the tools write is finite; each tool's wall
   seconds are printed.
15. checkpoints on the card (``core/checkpoint.py``): phase 6's
   configuration, 3 epochs of 2 train and 2 eval steps with a save every
   epoch, once with the write on the training thread (the synchronous
   comparison arm, kept only here) and once through the asynchronous
   ``CheckpointManager``, under deterministic algorithms: each arm's
   stall in ``save`` on the training thread, the background write's ms,
   the MiB a file and the epochs' wall seconds; the asynchronous stall
   below the synchronous one; the two arms' files equal tensor for tensor,
   bit for bit; the last asynchronous file restored into a fresh state
   gives the eval loss of the state that wrote it; 40 launches an eval
   step; a background write into a path that is a file raises at
   ``wait()``.
16. the LayerNorm kernel per flagship forward (batch 64 and batch 1, bf16):
   the norms' calls as one forward makes them (60 ``hwc``, 66 ``token``),
   each call shape timed on the device alone (CUDA-graph replays) for the
   kernel, the plain twin, the library (``F.layer_norm`` + ``F.gelu``,
   which the port never calls) and a copy of its input (the card's
   practical streaming rate), beside its byte bound (input and output
   once, the affine once), summed over the forward.
17. the non-local attention kernel (the AE's ``NonLocalAttention2D``,
   bf16): its calls in a Cityscapes window's encode (128 clips x 2 frames:
   6, at 64², 32², 16² and three at 8²) and in a KTH batch-64 forward (4),
   each on the call's own ``qkv``: the kernel held to its twin (at most
   1e-3 of the elements beyond 2^-6 of their image's max|v|, none beyond
   0.1 of it), kernel ms (CUDA-graph replays), the twin's and the
   library's (``F.scaled_dot_product_attention`` with scale 1 on the pooled
   k and v, which the port never calls) ms and gap to the twin, and the
   bound (bytes and FLOPs), summed over the forward; logits exact in fp32
   that reach |50| at the four levels, where the kernel stays within
   2^-6·max|v| of its twin element for element; a Cityscapes encode with
   open gates on the kernel path, the twin path and the library, each
   against fp32 (the kernel path held as close as the twin path); a
   Cityscapes window's encode on the kernel path and on the twin path (ms,
   peak memory); no launch in a SMMNIST Unified NPVP-S train step as its
   YAML stands (exec_mode xla).
18. the decoder-tail kernel (the AE decoder's last BatchNorm and ReLU,
   reflect pad, 7x7 head, bias and activation, bf16): its one call in a
   Cityscapes window's decode (128 clips x 10 frames, 1280 x 128² x 32 ->
   3; three in a 2 -> 28 request) and in a KTH batch-64 forward (640 x
   64² x 64 -> 1), each on the call's own input with the BatchNorms'
   statistics and the head's bias away from their init: the kernel held to its twin by the CUDA tests' bound,
   kernel ms (CUDA-graph replays), the twin's ms (the former eager tail)
   and the library's (cuDNN's convolution alone on the padded input, which
   the port no longer calls), beside the bound (bytes and FLOPs); a
   Cityscapes window's decode on the kernel and the twin path (ms, peak
   memory, the profiled kernels of each); no launch in a SMMNIST Unified
   NPVP-S train step as its YAML stands (exec_mode xla).

The phases run in a child process; this one exits with its code once every
process the run started has ended (see ``supervise``). Any failure exits
non-zero; without CUDA it exits non-zero at once. After the phases one
line gives each phase's seconds; the last three lines are the kernels'
JSON record, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = HERE / "npvp_tpu_torch" / "configs"
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
# the stage-2 eval step of the Cityscapes VFP NPVP-S config (batch 8, 2
# observed and 10 target frames, both codings): windows of the observed and
# target codings and of the decoder, the encoder's temporal attention over 2
# and over 10 frames, the decoder's over 10, cross-attention 10 over 2
CITY_EVAL_SITES = [("window_obs_T2", 64, 16, 16, None, 4),
                   ("window_tgt_T10", 320, 16, 16, None, 12),
                   ("temporal_enc_T2", 512, 2, 2, "hide_last", 4),
                   ("temporal_enc_T10", 512, 10, 10, "hide_last", 4),
                   ("temporal_dec_T10", 512, 10, 10, None, 8),
                   ("cross_10x2", 512, 10, 2, None, 8)]
# the KITTI (batch 16, 4 → 5) and KTH rand-context (batch 8, T = 20) eval
# steps' temporal shapes, held against the twin in phase 2
NEW_TEMPORAL = [("kitti_enc_T4", 1024, 4, 4, "hide_last"),
                ("kitti_cross_5x4", 1024, 5, 4, None),
                ("kitti_dec_T5", 1024, 5, 5, None),
                ("kth_enc_T20", 512, 20, 20, "obs_encoder"),
                ("kth_dec_T20", 512, 20, 20, "tgt_self"),
                ("kth_cross_T20", 512, 20, 20, "obs_cross"),
                ("city_window_obs", 64, 16, 16, None),
                ("city_last_window_8x2", 512, 8, 2, None)]
OBS20 = [1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 0, 1]
EXTRA = [("ragged", 4099, 10, 10, "hide_last"),
         ("tq_ne_tk", 1000, 10, 7, "random"),
         ("masked_row", 4096, 10, 10, "masked_row")]
NH, HD = 8, 512


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# set in the process that runs the phases, by the one that supervises it
CHILD_ENV = "NPVP_CHIP_SMOKE_PHASES"


def _descendants():
    """{pid: command line} of the live processes below this one."""
    children = {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            fields = (entry / "stat").read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry.name))
    found, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), ()):
            try:
                cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            except OSError:
                continue
            found[pid] = cmd.replace(b"\0", b" ").decode(errors="replace")
            todo.append(pid)
    return found


def _reap():
    """Collect the exit status of every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _wait_for_descendants(seconds, sig=None):
    """Send ``sig`` (if any) to every process below this one, then wait up
    to ``seconds`` for them to end; → {pid: command line} of those left."""
    if sig is not None:
        for pid in _descendants():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
    deadline = time.monotonic() + seconds
    while True:
        _reap()
        left = _descendants()
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def supervise(argv) -> int:
    """Run the phases in a child process and return its exit code once
    every process it started has ended too.

    The loaders' worker pools, ``multiprocessing``'s fork server and its
    resource tracker outlive the process that started them until they see
    it gone. This process is their subreaper (Linux ``PR_SET_CHILD_SUBREAPER``),
    so each of them ends up below it: it gives them ten seconds to end on
    their own, then SIGTERM, then SIGKILL, and names on stderr each one it
    had to signal. SIGTERM or SIGINT sent here goes to the child."""
    import ctypes
    import signal

    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0,  # PR_SET_CHILD_SUBREAPER
          f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              *argv], env={**os.environ, CHILD_ENV: "1"})

    def forward(signum, frame):
        child.send_signal(signum)

    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, forward)
    code = child.wait()

    def named(procs):
        return "; ".join(f"{pid} {cmd[:120]}"
                         for pid, cmd in sorted(procs.items()))

    t0 = time.monotonic()
    outlived = _descendants()
    left = _wait_for_descendants(10.0)
    if outlived:
        print(f"chip_smoke: {len(outlived)} process(es) outlived the run; "
              f"{len(outlived) - len(left)} ended on their own within "
              f"{time.monotonic() - t0:.2f} s: {named(outlived)}",
              file=sys.stderr)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        if not left:
            break
        print(f"chip_smoke: {sig.name} to {len(left)} process(es) left "
              f"running: {named(left)}", file=sys.stderr)
        left = _wait_for_descendants(5.0, sig)
    if left:
        print(f"chip_smoke: processes {sorted(left)} would not stop",
              file=sys.stderr)
        return code or 1
    return code


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
    from npvp_tpu_torch.kernels._nvcc import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    from npvp_tpu_torch.kernels import decoder_head as dh
    from npvp_tpu_torch.kernels import layer_norm as ln
    from npvp_tpu_torch.kernels import nonlocal_attention as nla

    for what, mod in (("kernel", ta), ("layer-norm kernel", ln),
                      ("non-local kernel", nla), ("decoder-tail kernel", dh)):
        lib = mod.LIB.build()
        print(f"{what} build: {mod.LIB.info.get('seconds', 0.0):.1f} s -> "
              f"{Path(lib).relative_to(HERE)}")
        for line in mod.LIB.info.get("ptxas", []):
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

        obs = torch.tensor(OBS20[:Tq], dtype=torch.bool, device=dev)
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
    cases = [(n, B, Tq, Tk, m) for n, B, Tq, Tk, m, _ in
             SITES + EVAL_SITES + CITY_EVAL_SITES[1:]] + EXTRA + NEW_TEMPORAL
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
    worst["layer_norm"] = layer_norm_vs_plain(torch)
    return worst


# the norms' (rows, trailing shape, GELU, calls a flagship forward) at batch
# 64, 10 frames: the conv FFN's (H, W, C) norms over the hidden width (two
# of each of its 20 MLPs) and over C, each with the GELU after it, and the
# token norms over C (4 an encoder block, 6 a decoder block, the final
# norm twice)
NORMS = [("hwc_hidden", 640, (8, 8, 2048), "gelu_tanh", 40),
         ("hwc_out", 640, (8, 8, 512), "gelu_tanh", 20),
         ("token", 40960, (512,), "none", 66)]


def norm_inputs(torch, rows, affine, dtype, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.5 + 2 * torch.randn((rows, *affine), generator=g, device=dev)
    w = 1 + 0.3 * torch.randn(affine, generator=g, device=dev)
    b = 0.2 * torch.randn(affine, generator=g, device=dev)
    return x.to(dtype), w, b


def layer_norm_vs_plain(torch):
    """The LayerNorm kernel against its twin at batch 64's and batch 1's
    norm shapes; returns the largest bf16 error."""
    from npvp_tpu_torch.kernels import layer_norm as ln

    worst = 0.0
    cases = [(n, r, a) for n, r, a, _, _ in NORMS] + [
        (n + "_b1", r // 64, a) for n, r, a, _, _ in NORMS]
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        for act in ("none", "gelu_tanh" if dtype == torch.bfloat16
                    else "gelu"):
            for name, rows, affine in cases:
                x, w, b = norm_inputs(torch, rows, affine, dtype, rows)
                with torch.no_grad():
                    got = ln.layer_norm(x, w, b, eps=1e-5, out_dtype=dtype,
                                        act=act).float()
                    want = ln.layer_norm_plain(x, w, b, 1e-5, dtype,
                                               act).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                ok = bool((err <= 1e-5 + rel * want.abs()).all()) and bool(
                    torch.isfinite(got).all())
                dt = str(dtype).replace("torch.", "")
                print(f"layer_norm {dt:8s} {name:14s} {rows} x "
                      f"{tuple(affine)} act={act}: max|d|="
                      f"{err.max().item():.3e} (tol 1e-5+{rel:.3g}|x|) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"layer_norm {dt} {name} disagrees with the twin")
                if dtype == torch.bfloat16:
                    worst = max(worst, err.max().item())
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
    runs = {"kernel_oproj": kernel_vp.freeze_task(to, tp),
            "plain": plain_vp.freeze_task(to, tp)}

    def forward(name):
        return runs[name](frames, eps=eps)

    from npvp_tpu_torch.kernels import layer_norm as ln

    outs, launches, norms = {}, {}, {}
    for name in runs:
        forward(name)  # warm-up: cuDNN and cuBLAS choose their kernels
        for counter in (ta.LAUNCHES, ln.LAUNCHES):
            for key in counter:
                counter[key] = 0
        outs[name] = forward(name)
        torch.cuda.synchronize()
        launches[name], norms[name] = dict(ta.LAUNCHES), dict(ln.LAUNCHES)
        print(f"{name:12s}: one forward -> kernel launches {launches[name]}, "
              f"layer-norm launches {norms[name]}")
    check(launches["kernel_oproj"] == {"oproj": 32, "attn": 0},
          "the fused kernel must serve all 32 attention calls")
    check(launches["plain"] == {"oproj": 0, "attn": 0},
          "the plain path launched a kernel")
    check(norms["kernel_oproj"] == {"hwc": 60, "token": 66},
          "the layer-norm kernel must serve all 126 norms")
    check(norms["plain"] == {"hwc": 0, "token": 0},
          "the plain path launched the layer-norm kernel")
    shape = (64, 10, d.img_size, d.img_size, d.img_channels)
    for name, out in outs.items():
        check(tuple(out.shape) == shape and bool(torch.isfinite(
            out.float()).all()), f"{name}: bad output {tuple(out.shape)}")
    diff = (outs["kernel_oproj"].float() - outs["plain"].float()).abs()
    print(f"kernel_oproj vs plain outputs: max|d|={diff.max().item():.3e} "
          f"mean|d|={diff.mean().item():.3e}")
    check(diff.max().item() < 0.1, "the kernel path departs from the plain "
          "path")

    blocks = {name: [] for name in runs}
    order = ["plain", "kernel_oproj"]
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
    WORK["serving"] = serving
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


def time_graph(torch, fn, n=20):
    """ms a call of ``fn`` on the device alone: ``n`` calls captured in one
    CUDA graph and replayed, so that no host time between launches counts."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def phase_per_call(torch, ta):
    """Per call site, bf16: kernel, twin and library ms and the bound,
    summed over a flagship forward and over a stage-2 eval step."""
    import torch.nn.functional as F

    dtype = torch.bfloat16
    totals = {}
    for path, sites in (("forward", SITES), ("eval_step", EVAL_SITES),
                        ("eval_step_cityscapes", CITY_EVAL_SITES)):
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

    import numpy as np

    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    steps_wanted = 10
    yaml = CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml"
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
        from npvp_tpu_torch.kernels import layer_norm as ln

        record = {"train": [], "eval": []}
        clock = [0.0, 0, 0]

        def on_step(kind, index, metrics):
            torch.cuda.synchronize()
            now, launched = time.perf_counter(), sum(ta.LAUNCHES.values())
            normed = sum(ln.LAUNCHES.values())
            loss = float(metrics["loss" if kind == "train" else "loss_val"])
            record[kind].append(dict(ms=(now - clock[0]) * 1e3, loss=loss,
                                     launches=launched - clock[1],
                                     norm_launches=normed - clock[2]))
            check(np.isfinite(loss), f"{kind} step {index}: loss {loss}")
            clock[:] = [time.perf_counter(), sum(ta.LAUNCHES.values()),
                        sum(ln.LAUNCHES.values())]

        for counter in (ta.LAUNCHES, ln.LAUNCHES):
            for key in counter:
                counter[key] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = clock[0] = time.perf_counter()
        state = s2.train(cfg, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        WORK["phase6_allocated"] = torch.cuda.memory_allocated()
        launches = dict(ta.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr, ev = record["train"], record["eval"]
        check(len(tr) == steps_wanted and state.step == steps_wanted,
              f"{len(tr)} train steps, state.step {state.step}")
        check(len(ev) >= 1, "no eval step ran")
        check(all(r["launches"] == 0 for r in tr),
              "a train step launched the kernel")
        check(all(r["norm_launches"] == 0 for r in tr),
              "a train step launched the layer-norm kernel")
        check(all(r["norm_launches"] > 0 for r in ev),
              "an eval step ran its norms off the layer-norm kernel")
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
              f"{launches}; layer-norm launches "
              f"{[r['norm_launches'] for r in tr]} per train step, "
              f"{[r['norm_launches'] for r in ev]} per eval step")
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
        eval_kernel_vs_plain(torch, cfg, state, steps, batch)

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


def eval_kernel_vs_plain(torch, cfg, state, steps, batch):
    """One eval step with the kernel against the plain path from the same
    state: each loss within 1e-3 of its own size plus 1e-5, never more than
    2e-2 (some are near 1e-2, so the outer bound alone could not fail on
    them)."""
    import types

    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train.common import compute_dtype

    dev = next(state.model.parameters()).device
    plain = build_predictor(cfg, compute_dtype(cfg), exec_mode="xla").to(dev)
    plain.load_state_dict(state.model.state_dict())
    got = steps.eval(state, batch, Rng(123))
    want = steps.eval(types.SimpleNamespace(model=plain, module=plain), batch,
                      Rng(123))
    diffs = {k: abs(float(got[k]) - float(want[k])) for k in want}
    bound = {k: min(2e-2, 1e-3 * abs(float(want[k])) + 1e-5) for k in want}
    print("eval losses, kernel vs plain: " + ", ".join(
        f"{k} {float(got[k]):.6f} vs {float(want[k]):.6f} "
        f"(|d| {diffs[k]:.2e}, tol {bound[k]:.2e})" for k in want))
    far = [k for k in want if not diffs[k] <= bound[k]]
    check(not far, f"kernel eval departs from plain in {far}")
    return max(diffs.values())


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
    # the same 20 steps with the clips fetched on the loader's worker
    # processes: SMMNIST's first batch is cheap, so the loader renders in
    # its producer thread unless the pool is forced
    from npvp_tpu_torch.data import loader

    cfg.AE.ckpt_save_dir = f"{work}/ae_pool"
    cfg.AE.tensorboard_save_dir = f"{work}/ae_pool_log"
    threshold, loader.POOL_MIN_FETCH_MS = loader.POOL_MIN_FETCH_MS, 0.0
    try:
        _, rec, _, pool_peak, pool_wall = _timed_train(
            torch, ta, np, s1.train, cfg,
            {"train": "L1_loss_train", "eval": "L1_loss_valid"})
    finally:
        loader.POOL_MIN_FETCH_MS = threshold
    on_pool = _summary(d, rec, pool_peak, pool_wall,
                       f"stage-1 train() with the clips fetched on "
                       f"{min(d.num_workers, d.batch_size)} worker "
                       "processes (the pool forced)")
    result = {"train_ms": train_ms, "eval_ms": eval_ms,
              "clips_per_s": d.batch_size / (train_ms / 1e3),
              "peak_gib": peak, "first_l1": losses[0], "last_l1": losses[-1],
              "train_steps": len(tr), "eval_steps": len(ev),
              "fetch_on_pool": on_pool}
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
    """The five tasks, best-of-2 over 1 test batch, bf16, kernel and plain
    arms; → per task its launches, seconds and predicted frames/s."""
    from npvp_tpu_torch.eval.evaluate import _task_split, evaluate

    d, p = cfg.Dataset, cfg.Predictor
    batches, samples = 1, 2
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


# -- phase 9: the frame-folder data layer and the new models ----------------

def smoke_config(name, overrides=()):
    """``npvp_tpu_torch/configs/config_<name>.yaml`` as it stands, with
    ``overrides`` (run directories, data directories, step counts)."""
    from npvp_tpu_torch.core.config import load_config

    return load_config(CONFIGS / f"config_{name}.yaml", list(overrides))


def _build_and_read_back(builder, kw):
    """One job of :func:`_build_trees`, in a worker process: write a tree
    with ``npvp_tpu_torch.data.synthetic.<builder>(**kw)``, then read every
    PNG back (one wavefront a folder) and hold it bit-equal to the array
    written; → (files, filter types seen)."""
    import numpy as np

    from npvp_tpu_torch.data import png
    from npvp_tpu_torch.data import synthetic

    written = getattr(synthetic, builder)(**kw)
    folders, kinds = {}, set()
    for path, arr in written.items():
        if path.suffix == ".png":
            folders.setdefault(path.parent, []).append((path, arr))
    for folder, items in folders.items():
        items.sort(key=lambda kv: kv[0])
        got = png.read_pngs([p for p, _ in items], "RGB")
        check(np.array_equal(got, np.stack([a for _, a in items])),
              f"{folder}: a PNG does not read back as written")
        kinds |= set(png.inflate(png.read_chunks(items[0][0].read_bytes()))[
            :, 0].tolist())
    return len(written), kinds


def _build_trees(root):
    """Seeded trees in each dataset's layout, written and read back on 8
    worker processes; → {dataset: number of files}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    kth = ("boxing", "handclapping", "handwaving", "walking_no_empty")
    jobs = [("KTH", "kth_tree", dict(root=root / "KTH", persons=(p,),
                                     actions=kth, frames=100, seed=p))
            for p in (1, 2, 3, 5, 17)]  # train 1-3, val 5, test 17
    # Cityscapes: train 16 sequences a city, val 4, test 4, 30 frames each
    jobs += [("Cityscapes", "cityscapes_tree", dict(
        root=root / "Cityscapes", sequences={split: n}, frames=30,
        seed=10 + i, cities=cities)) for i, (split, n, cities) in enumerate(
            (("train", 16, ("aachen",)), ("train", 16, ("bochum",)),
             ("val", 4, ("aachen", "bochum")),
             ("test", 4, ("aachen", "bochum"))))]
    jobs += [("KITTI", "kitti_tree", dict(root=root / "KITTI", drives=16,
                                          frames=18, seed=20)),
             ("BAIR", "bair_tree", dict(root=root / "BAIR",
                                        examples={"train": 10, "test": 4},
                                        frames=30, seed=21)),
             ("MovingMNIST", "moving_mnist_npz", dict(
                 root=root / "MovingMNIST", frames=20, clips=16, seed=22))]
    t0 = time.perf_counter()
    counts, kinds = {}, set()
    with ProcessPoolExecutor(8, multiprocessing.get_context("spawn")) as pool:
        done = pool.map(_build_and_read_back, [b for _, b, _ in jobs],
                        [kw for _, _, kw in jobs])
        for (name, _, _), (files, used) in zip(jobs, done):
            counts[name] = counts.get(name, 0) + files
            kinds |= used
    check(kinds == {0, 1, 2, 3, 4}, f"filter types present: {kinds}")
    print(f"trees: {counts} files written, and every PNG read back "
          f"bit-equal, in {time.perf_counter() - t0:.1f} s on 8 processes; "
          f"filter types {sorted(kinds)}")
    return counts


def _decode_split(np, paths):
    """Per-frame ms of read + inflate and of unfilter (one wavefront per
    clip) over clips ``paths``."""
    from npvp_tpu_torch.data import png

    inflate_s = unfilter_s = 0.0
    frames = 0
    for clip in paths:
        t0 = time.perf_counter()
        chunks = [png.read_chunks(Path(p).read_bytes(), str(p)) for p in clip]
        rows = np.stack([png.inflate(c) for c in chunks])
        t1 = time.perf_counter()
        png.unfilter(rows, chunks[0].header.bpp)
        unfilter_s += time.perf_counter() - t1
        inflate_s += t1 - t0
        frames += len(clip)
    return inflate_s * 1e3 / frames, unfilter_s * 1e3 / frames


def _loader_alone(np, cfg, mode, clips, batches=9):
    """The train loader on its own at 1 worker and at the config's count:
    ms a batch over ``batches`` batches after the first (which starts the
    worker pool), equal batches, and the decode split over ``clips``."""
    from npvp_tpu_torch.data.loader import DataModule

    d = cfg.Dataset
    configured, out, seen, first = d.num_workers, {}, {}, {}
    for workers in (1, configured):
        d.num_workers = workers
        loader = DataModule(cfg).train_loader(mode)
        it = iter(loader)
        t0 = time.perf_counter()
        seen[workers] = [next(it)]
        first[workers] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        seen[workers] += [next(it) for _ in range(batches)]
        out[workers] = (time.perf_counter() - t0) * 1e3 / batches
        it.close()
        loader.close()
    for a, b in zip(seen[1], seen[configured]):
        check(all(np.array_equal(a[k], b[k]) for k in a),
              f"{d.name}: batches differ between 1 and {configured} workers")
    inflate_ms, unfilter_ms = _decode_split(np, clips)
    frames = d.batch_size * (d.num_past_frames + d.num_future_frames)
    print(f"{d.name} loader alone, batch {d.batch_size} x "
          f"{d.num_past_frames + d.num_future_frames} frames ({frames} "
          f"PNGs): {out[1]:.1f} ms a batch at 1 worker (the producer "
          f"thread), {out[configured]:.1f} ms at num_workers {configured} "
          f"({min(configured, d.batch_size)} processes), over {batches} "
          f"batches after the first (the first {first[1]:.0f} and "
          f"{first[configured]:.0f} ms, pool start included); batches "
          f"equal; decode "
          f"{inflate_ms:.3f} ms a frame to read and inflate, "
          f"{unfilter_ms:.3f} ms to unfilter")
    return {"ms_per_batch": {str(k): v for k, v in out.items()},
            "first_batch_ms": {str(k): v for k, v in first.items()},
            "inflate_ms_per_frame": inflate_ms,
            "unfilter_ms_per_frame": unfilter_ms, "frames_per_batch": frames}


def _timed_train(torch, ta, np, train_fn, cfg, loss_key):
    """Run ``train_fn(cfg, on_step=...)``; → (state, per-step records,
    launches, peak GiB, wall s). Each record holds ms (host clock, ended by
    a synchronize), loss, kernel launches and the wait for the batch."""
    record = {"train": [], "eval": []}
    clock = [0.0, 0]

    def on_step(kind, index, metrics):
        torch.cuda.synchronize()
        now, launched = time.perf_counter(), sum(ta.LAUNCHES.values())
        loss = float(metrics[loss_key[kind]])
        record[kind].append(dict(
            ms=(now - clock[0]) * 1e3, loss=loss,
            launches=launched - clock[1],
            wait_ms=float(metrics.get("data_wait_ms", 0.0))))
        check(np.isfinite(loss), f"{kind} step {index}: loss {loss}")
        clock[:] = [time.perf_counter(), sum(ta.LAUNCHES.values())]

    reset_launches(ta)
    torch.cuda.reset_peak_memory_stats()
    t0 = clock[0] = time.perf_counter()
    state = train_fn(cfg, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, record, dict(ta.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2 ** 30, wall)


def _summary(d, record, peak, wall, what):
    tr, ev = record["train"], record["eval"]
    train_ms = statistics.median(r["ms"] for r in tr[3:] or tr)
    eval_ms = statistics.median(r["ms"] for r in ev[1:] or ev)
    waits = [r["wait_ms"] for r in tr[1:]]
    out = {"train_ms": train_ms, "eval_ms": eval_ms,
           "clips_per_s": d.batch_size / (train_ms / 1e3), "peak_gib": peak,
           "train_steps": len(tr), "eval_steps": len(ev),
           "wait_ms_median": statistics.median(waits) if waits else 0.0,
           "wait_ms_max": max(waits) if waits else 0.0,
           "first_wait_ms": tr[0]["wait_ms"],
           "losses": [r["loss"] for r in tr]}
    print(f"{what}: {len(tr)} train + {len(ev)} eval steps in {wall:.1f} s "
          f"(set-up included); train step {train_ms:.2f} ms median after 3 "
          f"warm-up steps ({out['clips_per_s']:.1f} clips/s), first three "
          f"{[round(r['ms'], 1) for r in tr[:3]]} ms; eval step "
          f"{eval_ms:.2f} ms; peak memory {peak:.2f} GiB; wait for the "
          f"batch {out['wait_ms_median']:.2f} ms median, "
          f"{out['wait_ms_max']:.2f} max after the first "
          f"({out['first_wait_ms']:.1f}); losses "
          f"{[round(r['loss'], 4) for r in tr]}")
    return out


def _kth_flagship(torch, ta, np, root, work):
    """KTH Unified NPVP-S as its YAML stands, from PNG folders: 6 train
    steps and the validation pass through ``stage2_predictor.train``."""
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    cfg = smoke_config("KTH_Unified_NPVP-S", [
        f"Dataset.dir={root}/KTH", "Predictor.exec_mode=pallas",
        "Predictor.epochs=1", f"Predictor.ckpt_save_dir={work}/kth",
        f"Predictor.tensorboard_save_dir={work}/kth_log",
        "Dataset.dev_set_size=48"])
    p, d = cfg.Predictor, cfg.Dataset
    cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, work))
    print(f"KTH Unified NPVP-S (embed {p.embed_dim}, {p.transformer_layers} "
          f"+ {p.evt_former_num_layers} layers, max_T {p.max_T}, "
          f"rand_context), batch {d.batch_size}, {cfg.Env.compute_dtype}, "
          f"exec_mode {p.exec_mode}, {d.num_workers} loader workers, "
          f"frames 160x120 RGB PNG -> 64x64 grey")
    state, record, launches, peak, wall = _timed_train(
        torch, ta, np, s2.train, cfg, {"train": "loss", "eval": "loss_val"})
    tr, ev = record["train"], record["eval"]
    check(len(tr) == 6 and state.step == 6,
          f"{len(tr)} train steps, state.step {state.step}")
    check(len(ev) >= 1, "no eval step ran")
    check(all(r["launches"] == 0 for r in tr),
          "a train step launched the kernel")
    check(all(r["launches"] == 40 for r in ev),
          f"eval steps launched {[r['launches'] for r in ev]}, not 40")
    check(launches == {"oproj": 40 * len(ev) + 32, "attn": 0},
          f"launches {launches} (40 per eval step and 32 for the GIF)")
    check_gif(Path(work) / "kth_log" / "epoch_0.gif", p.max_T)
    out = _summary(d, record, peak, wall, "KTH train()")
    print(f"kernel launches: {[r['launches'] for r in tr]} per train step, "
          f"{[r['launches'] for r in ev]} per eval step; {launches}")
    saved = dict(ta.LAUNCHES)
    dev = next(state.model.parameters()).device
    ae = s2.load_frozen_ae(cfg, s2.compute_dtype(cfg), dev)
    steps = s2.make_steps(cfg, ae, "rand_context", dev)
    dm = DataModule(cfg)
    batch = steps.place(next(iter(dm.val_loader("rand_context"))))
    out["eval_max_abs_diff"] = eval_kernel_vs_plain(torch, cfg, state, steps,
                                                    batch)
    train_batch = steps.place(next(iter(dm.train_loader("rand_context"))))
    profile(torch, lambda: steps.train(state, train_batch, Rng(8)),
            "KTH stage-2 train step")
    ta.LAUNCHES.update(saved)
    out["launches"] = launches

    # the same run with the frames decoded in the producer thread, beside
    # the training loop (num_workers 1), in this call and on this card
    cfg.Dataset.num_workers = 1
    cfg.Predictor.ckpt_save_dir = f"{work}/kth_thread"
    cfg.Predictor.tensorboard_save_dir = f"{work}/kth_thread_log"
    _, record, _, peak, wall = _timed_train(
        torch, ta, np, s2.train, cfg, {"train": "loss", "eval": "loss_val"})
    out["decode_in_thread"] = _summary(
        d, record, peak, wall, "KTH train() with decode in the producer "
        "thread (num_workers 1)")
    ta.LAUNCHES.update(saved)
    return out


def _cityscapes_chain(torch, ta, np, root, work):
    """The Cityscapes AE, VFP NPVP-S over it, and ``evaluate`` 2 → 28."""
    import collections

    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.eval.evaluate import evaluate
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage1_ae as s1
    from npvp_tpu_torch.train import stage2_predictor as s2

    out = {}
    cfg1 = smoke_config("Cityscapes_Autoencoder", [
        f"Dataset.dir={root}/Cityscapes", "AE.epochs=1",
        f"AE.ckpt_save_dir={work}/city_ae",
        f"AE.tensorboard_save_dir={work}/city_ae_log",
        "Dataset.dev_set_size=80"])
    a, d = cfg1.AE, cfg1.Dataset
    print(f"Cityscapes AE (ngf {a.ngf}, {a.n_downsampling} downsamplings, "
          f"{a.num_res_blocks} res blocks, {d.img_size}x{d.img_size}x"
          f"{d.img_channels}), clips of "
          f"{d.num_past_frames + d.num_future_frames}, batch {d.batch_size}, "
          f"{cfg1.Env.compute_dtype}")
    state, record, launches, peak, wall = _timed_train(
        torch, ta, np, s1.train, cfg1,
        {"train": "L1_loss_train", "eval": "L1_loss_valid"})
    check(state.step == 10 and launches == {"oproj": 0, "attn": 0},
          f"AE: step {state.step}, launches {launches}")
    out["ae"] = _summary(d, record, peak, wall, "Cityscapes AE train()")

    cfg2 = smoke_config("Cityscapes_VFP_NPVP-S", [
        f"Dataset.dir={root}/Cityscapes", "Predictor.exec_mode=pallas",
        "Predictor.epochs=1", f"Predictor.resume_AE_ckpt={work}/city_ae",
        f"Predictor.ckpt_save_dir={work}/city_pred",
        f"Predictor.tensorboard_save_dir={work}/city_pred_log",
        "Dataset.dev_set_size=32"])
    p, d = cfg2.Predictor, cfg2.Dataset
    print(f"Cityscapes VFP NPVP-S (embed {p.embed_dim}, pairs "
          f"{d.num_past_frames} -> {d.num_future_frames}, max_T {p.max_T}) "
          f"over that AE")
    state, record, launches, peak, wall = _timed_train(
        torch, ta, np, s2.train, cfg2,
        {"train": "loss", "eval": "loss_val"})
    ev = record["eval"]
    check(state.step == 4 and all(r["launches"] == 0 for r in
                                  record["train"]),
          f"VFP: step {state.step}, launches per train step")
    check(all(r["launches"] == 40 for r in ev) and launches == {
        "oproj": 40 * len(ev) + 32, "attn": 0}, f"VFP launches {launches}")
    out["vfp"] = _summary(d, record, peak, wall, "Cityscapes VFP train()")
    out["vfp"]["launches"] = launches

    saved = dict(ta.LAUNCHES)
    dev = next(state.model.parameters()).device
    ae = s2.load_frozen_ae(cfg2, s2.compute_dtype(cfg2), dev)
    steps = s2.make_steps(cfg2, ae, "pairs", dev)
    batch = steps.place(next(iter(DataModule(cfg2).val_loader())))
    shapes = collections.Counter()
    launch = ta.temporal_attention

    def spy(q, k, v, bias=None, **kw):
        shapes[(q.shape[0], q.shape[1], k.shape[1], bias is not None)] += 1
        return launch(q, k, v, bias, **kw)

    ta.temporal_attention = spy
    try:
        out["vfp"]["eval_max_abs_diff"] = eval_kernel_vs_plain(
            torch, cfg2, state, steps, batch)
    finally:
        ta.temporal_attention = launch
    declared = collections.Counter()
    for _, B, Tq, Tk, mask, calls in CITY_EVAL_SITES:
        declared[(B, Tq, Tk, mask is not None)] += calls
    print(f"eval-step kernel calls (B, Tq, Tk, masked): {dict(shapes)}")
    check(shapes == declared, f"the eval step's calls {dict(shapes)} are "
          f"not CITY_EVAL_SITES {dict(declared)}")
    train_batch = steps.place(next(iter(DataModule(cfg2).train_loader())))
    profile(torch, lambda: steps.train(state, train_batch, Rng(8)),
            "Cityscapes stage-2 train step")
    ta.LAUNCHES.update(saved)

    # evaluate VFP 2 -> 28 past max_T 12: three windows a batch
    P, F = d.test_num_past_frames, d.test_num_future_frames
    windows = -(-F // (p.max_T - P))
    kw = dict(task="VFP", max_batches=1, num_samples=1,
              dtype=torch.bfloat16, device="cuda")
    evaluate(cfg2, exec_mode="pallas", **kw)  # warm-up
    res, secs, launched = {}, {}, {}
    for arm in ("pallas", "xla"):
        reset_launches(ta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[arm] = evaluate(cfg2, exec_mode=arm, **kw)
        torch.cuda.synchronize()
        secs[arm] = time.perf_counter() - t0
        launched[arm] = dict(ta.LAUNCHES)
    gap = abs(res["pallas"]["PSNR"] - res["xla"]["PSNR"])
    per_t = np.asarray(res["pallas"]["PSNR_per_t"])
    check(per_t.shape == (F,) and np.isfinite(per_t).all(),
          f"PSNR per target: {per_t}")
    check(launched["pallas"] == {"oproj": 32 * windows, "attn": 0},
          f"evaluate launches {launched['pallas']}, not {windows} windows "
          "x 32")
    check(launched["xla"] == {"oproj": 0, "attn": 0},
          "the plain arm launched the kernel")
    check(gap <= 0.01, f"PSNR kernel {res['pallas']['PSNR']} vs plain "
          f"{res['xla']['PSNR']}")
    frames = d.batch_size * F
    print(f"evaluate VFP {P} -> {F} (windowed, {windows} windows), batch "
          f"{d.batch_size}, bf16: kernel {secs['pallas']:.2f} s "
          f"({frames / secs['pallas']:.1f} predicted frames/s), plain "
          f"{secs['xla']:.2f} s; {launched['pallas']['oproj']} launches; "
          f"PSNR {res['pallas']['PSNR']:.4f} vs {res['xla']['PSNR']:.4f} dB "
          f"(|d| {gap:.2e}), SSIM {res['pallas']['SSIM']:.5f} over 3 "
          "channels")
    out["evaluate"] = {"windows": windows,
                       "launches": launched["pallas"]["oproj"],
                       "seconds": secs, "PSNR": res["pallas"]["PSNR"],
                       "PSNR_plain": res["xla"]["PSNR"], "PSNR_gap": gap}
    return out


def _one_batch_each(np, root):
    """One train batch of KITTI (batch 16, resized), BAIR and MovingMNIST
    through ``DataModule``: shapes and normalised ranges."""
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.data.transforms import DATASET_STATS

    out = {}
    for name, yaml, extra in (
            ("KITTI", "KITTI_VFP_NPVP-S", []),
            ("BAIR", "BAIR_VFP_NPVP-S", []),
            ("MovingMNIST", "SMMNIST_VFP_NPVP-S",
             ["Dataset.name=MovingMNIST"])):
        cfg = smoke_config(yaml, [f"Dataset.dir={root}/{name}"] + extra)
        d = cfg.Dataset
        t0 = time.perf_counter()
        batch = next(iter(DataModule(cfg).train_loader()))
        ms = (time.perf_counter() - t0) * 1e3
        S, C = d.img_size, d.img_channels
        want = {"past": (d.batch_size, d.num_past_frames, S, S, C),
                "future": (d.batch_size, d.num_future_frames, S, S, C)}
        stats = DATASET_STATS[d.name]
        lo = (0 - np.asarray(stats["mean"])) / np.asarray(stats["std"])
        hi = (1 - np.asarray(stats["mean"])) / np.asarray(stats["std"])
        for key, shape in want.items():
            x = batch[key]
            check(x.shape == shape and x.dtype == np.float32,
                  f"{name} {key}: {x.shape} {x.dtype}, not {shape}")
            check(bool(np.isfinite(x).all()
                       and (x >= lo - 1e-5).all() and (x <= hi + 1e-5).all()),
                  f"{name} {key}: values outside [{lo}, {hi}]")
        print(f"{name}: one train batch past {batch['past'].shape}, future "
              f"{batch['future'].shape}, values in [{batch['past'].min():.3f},"
              f" {batch['past'].max():.3f}] within the normalised range, "
              f"{ms:.0f} ms")
        out[name] = {"ms": ms, "past": list(batch["past"].shape)}
    return out


def phase_data_models(torch, ta):
    """The frame-folder data layer and the new models on the card."""
    import numpy as np

    from npvp_tpu_torch.data import datasets as D

    work = Path(WORK["dir"])
    root = work / "data"
    out = {"trees": _build_trees(root)}
    kth = smoke_config("KTH_Unified_NPVP-S", [f"Dataset.dir={root}/KTH"])
    city = smoke_config("Cityscapes_Autoencoder",
                        [f"Dataset.dir={root}/Cityscapes"])
    out["loader"] = {
        "KTH": _loader_alone(np, kth, "rand_context",
                             D.kth_clips(root / "KTH", 20, [1])[:4]),
        "Cityscapes": _loader_alone(np, city, "pairs", D.cityscapes_clips(
            root / "Cityscapes" / "train", 12)[:4])}
    out["kth"] = _kth_flagship(torch, ta, np, root, work)
    out["cityscapes"] = _cityscapes_chain(torch, ta, np, root, work)
    out["one_batch"] = _one_batch_each(np, root)
    print("data_models " + json.dumps(out))
    return out


# -- phase 10: serving options and model tools -----------------------------

def _psnr(a, b):
    """PSNR in dB between two Tanh outputs (peak-to-peak 2)."""
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(4.0 / mse)


def _blocks(torch, fns, n=3, rounds=2):
    """Median ms per call of each of ``fns`` (name → callable), timed in
    blocks of ``n`` in turns (a, b, b, a)."""
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(time_forwards(torch, fns[name], n))
    return {name: statistics.median(ms) for name, ms in times.items()}


def _int8_forward(torch, ta, np, vps, frames, eps, to, tp):
    """(a) exec_mode int8 against the bf16 kernel path: launches, drift,
    PSNR and ms per forward."""
    runs = {m: vp.freeze_task(to, tp) for m, vp in vps.items()}
    outs, seen = {}, {}
    for mode, fn in runs.items():
        fn(frames, eps=eps)  # warm-up
        reset_launches(ta)
        outs[mode] = fn(frames, eps=eps)
        torch.cuda.synchronize()
        launches = seen[mode] = dict(ta.LAUNCHES)
        print(f"{mode}: one forward -> kernel launches {launches}")
        check(launches == ({"oproj": 32, "attn": 0} if mode == "pallas"
                           else {"oproj": 0, "attn": 0}),
              f"{mode}: unexpected launches {launches}")
    feats = {}
    with torch.inference_mode():
        for mode, vp in vps.items():
            f = vp.ae.encode(frames)
            feats[mode] = vp.predictor(f, vp._coords(to), vp._coords(tp),
                                       eps).pred_features.float()
    a, b = feats["pallas"], feats["int8"]
    drift = float((a - b).abs().mean() / (a.abs().mean() + 1e-9))
    psnr = _psnr(outs["pallas"], outs["int8"])
    ok = bool(torch.isfinite(outs["int8"].float()).all())
    print(f"int8 vs bf16 kernel path: feature drift {drift:.4f} (limit "
          f"0.05, tests/test_quant.py's), output PSNR {psnr:.2f} dB (limit "
          f"40 dB, tests/test_quant.py's)")
    check(ok and drift < 0.05 and psnr > 40.0, "int8 drifts too far")
    ms = _blocks(torch, {m: (lambda fn=fn: fn(frames, eps=eps))
                         for m, fn in runs.items()})
    phase4 = WORK.get("serving", {}).get("kernel_oproj", {})
    print(f"ms per forward: int8 {ms['int8']:.2f} "
          f"({640 / (ms['int8'] / 1e3):.1f} frames/s), bf16 kernel path "
          f"{ms['pallas']:.2f} ({640 / (ms['pallas'] / 1e3):.1f} frames/s)"
          + (f"; phase 4 kernel_oproj {phase4['ms_per_forward']:.2f}"
             if phase4 else ""))
    return {"int8_ms": ms["int8"], "pallas_ms": ms["pallas"],
            "int8_frames_per_s": 640 / (ms["int8"] / 1e3),
            "phase4_kernel_oproj_ms": phase4.get("ms_per_forward"),
            "feature_drift": drift, "psnr_db": psnr, "launches": seen}


def _op_overhead(torch, ta, fn, frames, eps):
    """The kernel through its torch op against its launch function called
    directly: a flagship forward each way, and host µs per call at a small
    shape (64 windows of 16 tokens, where the card waits on the host)."""
    via_op = ta.temporal_attention

    def direct(q, k, v, bias=None, *, num_heads, wo=None, bo=None):
        return ta.launch(q, k, v, bias, wo, bo, num_heads)

    def forward(use_op):
        ta.temporal_attention = via_op if use_op else direct
        try:
            return fn(frames, eps=eps)
        finally:
            ta.temporal_attention = via_op

    check(torch.equal(forward(True), forward(False)),
          "the op and the direct launch give different forwards")
    ms = _blocks(torch, {"op": lambda: forward(True),
                         "direct": lambda: forward(False)}, n=3, rounds=4)
    x = make_inputs(torch, 64, 16, 16, None, torch.bfloat16, True)
    args = (x["q"], x["k"], x["v"], None)
    saved = dict(ta.LAUNCHES)
    host = {}
    for name, call in (("op", lambda: via_op(*args, num_heads=NH,
                                             wo=x["wo"], bo=x["bo"])),
                       ("direct", lambda: ta.launch(*args, x["wo"],
                                                    x["bo"], NH))):
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            call()
        host[name] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    ta.LAUNCHES.update(saved)
    print(f"kernel through the op vs direct: forward {ms['op']:.2f} vs "
          f"{ms['direct']:.2f} ms; host {host['op']:.1f} vs "
          f"{host['direct']:.1f} us per call (64 windows, bf16, fused)")
    return {"forward_op_ms": ms["op"], "forward_direct_ms": ms["direct"],
            "host_us_per_call_op": host["op"],
            "host_us_per_call_direct": host["direct"]}


def _export_bundle(torch, ta, np, vp, frames, eps, to, tp):
    """(b) export_task → serve_exported under exec_mode pallas."""
    from npvp_tpu_torch.models.inference import VideoPredictor

    bundle = Path(WORK["dir"]) / "bundle"
    t0 = time.perf_counter()
    vp.export_task(bundle, to, tp, 64)
    export_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in bundle.iterdir())
    t0 = time.perf_counter()
    serve = VideoPredictor.serve_exported(bundle)
    load_s = time.perf_counter() - t0
    live = vp.freeze_task(to, tp)
    serve(frames, eps)  # warm-up
    reset_launches(ta)
    served = serve(frames, eps)
    torch.cuda.synchronize()
    launches = dict(ta.LAUNCHES)
    want = live(frames, eps=eps)
    check(launches == {"oproj": 32, "attn": 0},
          f"served chunk: launches {launches}, not 32 through the op")
    check(torch.equal(served, want), "the bundle's output is not "
          "freeze_task's")
    g = torch.Generator(device="cuda").manual_seed(2)
    extra = torch.rand((17,) + tuple(frames.shape[1:]), generator=g,
                       device="cuda") * 2 - 1
    extra_eps = torch.randn((17,) + tuple(eps.shape[1:]), generator=g,
                            device="cuda")
    reset_launches(ta)
    big = serve(torch.cat([frames, extra]), torch.cat([eps, extra_eps]))
    torch.cuda.synchronize()
    launches81 = dict(ta.LAUNCHES)
    pad = lambda t: torch.cat([t, t.new_zeros((47,) + t.shape[1:])])  # noqa
    tail = live(pad(extra), eps=pad(extra_eps))[:17]
    check(launches81 == {"oproj": 64, "attn": 0} and big.shape[0] == 81
          and torch.equal(big[:64], want) and torch.equal(big[64:], tail),
          f"a request of 64 + 17 clips: launches {launches81}, or rows "
          "that are not freeze_task's")
    ms = _blocks(torch, {"served": lambda: serve(frames, eps),
                         "live": lambda: live(frames, eps=eps)})
    print(f"bundle: export {export_s:.1f} s, load {load_s:.1f} s, "
          f"{size / 2 ** 20:.1f} MiB on disk; served output bit-equal to "
          f"freeze_task, 32 launches a chunk; 64 + 17 clips in 2 chunks "
          f"(64 launches), rows bit-equal; ms per batch of 64: served "
          f"{ms['served']:.2f}, live {ms['live']:.2f}")
    overhead = _op_overhead(torch, ta, live, frames, eps)
    shutil.rmtree(bundle)
    return {"export_s": export_s, "load_s": load_s, "bundle_mib":
            size / 2 ** 20, "launches_per_chunk": launches["oproj"],
            "launches_81": launches81["oproj"], "served_ms": ms["served"],
            "live_ms": ms["live"], "op": overhead}


def _ae_variants(torch, ta, np):
    """(c) three stage-1 steps of a learn_3d AE, and the decoder's
    s2d_head and subpixel forms against the direct ones."""
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.nn.resnet_ae import ResnetDecoder
    from npvp_tpu_torch.tools.weights import random_init
    from npvp_tpu_torch.train import stage1_ae as s1

    work = WORK["dir"]
    cfg = load_config(CONFIGS / "config_SMMNIST_Autoencoder.yaml", [
        "AE.learn_3d=true", "AE.epochs=1", "AE.log_per_epochs=1",
        f"AE.ckpt_save_dir={work}/ae3d",
        f"AE.tensorboard_save_dir={work}/ae3d_log",
        "Dataset.dev_set_size=24"])
    _, rec, launches, peak, wall = _timed_train(
        torch, ta, np, s1.train, cfg,
        {"train": "L1_loss_train", "eval": "L1_loss_valid"})
    check(len(rec["train"]) == 3 and sum(launches.values()) == 0,
          f"learn_3d: {len(rec['train'])} steps, launches {launches}")
    tr = rec["train"]
    out = {"learn_3d": {"step_ms": [r["ms"] for r in tr],
                        "last_step_ms": tr[-1]["ms"], "peak_gib": peak,
                        "losses": [r["loss"] for r in tr]}}
    print(f"learn_3d stage-1 (SMMNIST AE, batch 8 x 15 frames, bf16): 3 "
          f"steps {[round(r['ms'], 2) for r in tr]} ms (the last after 2 "
          f"warm-up), peak {peak:.2f} GiB, {wall:.1f} s with set-up; L1 "
          f"{[round(r['loss'], 4) for r in tr]}")

    a = cfg.AE
    gen = torch.Generator(device="cuda").manual_seed(3)
    feats = torch.rand((8, 15, 8, 8, a.ngf * 2 ** a.n_downsampling),
                       generator=gen, device="cuda")
    tol = {torch.float32: 1e-4, torch.bfloat16: 0.1}
    for dtype in (torch.float32, torch.bfloat16):
        make = lambda **kw: ResnetDecoder(  # noqa: E731
            1, a.ngf, a.n_downsampling, dtype=dtype, **kw).cuda().eval()
        direct = random_init(make(), 5)
        dt = str(dtype).replace("torch.", "")
        with torch.inference_mode():
            want = direct(feats).float()
            for kw in ({"s2d_head": True}, {"subpixel": True}):
                variant = make(**kw)
                variant.load_state_dict(direct.state_dict())
                got = variant(feats).float()
                err = float((got - want).abs().max())
                ms = _blocks(torch, {"variant": lambda: variant(feats),
                                     "direct": lambda: direct(feats)})
                name = next(iter(kw))
                out[f"{name}_{dt}"] = {"max_abs_err": err, "ms":
                                       ms["variant"], "direct_ms":
                                       ms["direct"]}
                print(f"{name} {dt}: max|d| {err:.3e} against the direct "
                      f"form (tol {tol[dtype]}); decode of 120 frames "
                      f"{ms['variant']:.2f} ms vs {ms['direct']:.2f} ms")
                check(err <= tol[dtype], f"{name} {dt} departs from the "
                      "direct form")
    return out


def _weights_round_trip(torch, np, vp, frames, eps, to, tp, cfg):
    """(d) save_weights → from_weights at flagship width: the served
    outputs equal those of the live model with its weights rounded as the
    archive stores them (float16 where every |x| < 60000)."""
    import copy

    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.tools.weights import save_weights

    path = Path(WORK["dir"]) / "weights.npz"
    t0 = time.perf_counter()
    save_weights(path, vp.ae, vp.predictor, {"ae_step": 0, "pred_step": 0})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = VideoPredictor.from_weights(cfg, path, exec_mode="pallas")
    load_s = time.perf_counter() - t0
    rounded = copy.deepcopy(vp)
    with torch.no_grad():
        for module in (rounded.ae, rounded.predictor):
            for t in list(module.parameters()) + list(module.buffers()):
                if t.is_floating_point() and float(t.abs().max()) < 60000:
                    t.copy_(t.half().float())
    got = loaded.freeze_task(to, tp)(frames, eps=eps)
    want = rounded.freeze_task(to, tp)(frames, eps=eps)
    live = vp.freeze_task(to, tp)(frames, eps=eps)
    fp16 = float((got.float() - live.float()).abs().max())
    size = path.stat().st_size / 2 ** 20
    print(f"weights archive: {size:.1f} MiB, save {save_s:.1f} s, "
          f"from_weights {load_s:.1f} s; outputs bit-equal to the live "
          f"model's with float16-rounded weights: {torch.equal(got, want)}; "
          f"max|d| {fp16:.3e} against the unrounded live model")
    check(torch.equal(got, want), "from_weights does not serve the archive")
    path.unlink()
    return {"mib": size, "save_s": save_s, "load_s": load_s,
            "max_abs_vs_unrounded": fp16}


def _lightning_file(torch, path, state_dict):
    """A Lightning-style checkpoint whose hyper-parameters are objects of a
    class from a module that is gone when it is read."""
    import types

    mod = types.ModuleType("lit_run_classes")

    class AttributeDict(dict):
        pass

    AttributeDict.__module__ = mod.__name__
    AttributeDict.__qualname__ = "AttributeDict"
    mod.AttributeDict = AttributeDict
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"state_dict": state_dict, "epoch": 399,
                    "hyper_parameters": AttributeDict(lr=1e-4)}, path)
    finally:
        del sys.modules[mod.__name__]


def _converter(torch, vp, frames, eps, to, tp, cfg):
    """(e) a synthetic flagship-size LitPredictor checkpoint (the
    predictor behind ``predictor.``, the frozen AE beside it) in the
    reference's key names → the converter → the same forward."""
    sys.path.insert(0, str(HERE / "tests"))
    from _torch_helpers import (reference_ae_state_dict,
                                reference_predictor_state_dict)

    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.tools.torch_converter import \
        convert_lightning_predictor
    from npvp_tpu_torch.tools.weights import to_flax

    path = Path(WORK["dir"]) / "predictor.ckpt"
    a = cfg.AE
    sd = reference_predictor_state_dict(to_flax(vp.predictor),
                                        prefix="predictor.")
    sd.update(reference_ae_state_dict(to_flax(vp.ae), a.n_downsampling,
                                      a.num_res_blocks, a.learn_3d))
    _lightning_file(torch, path, sd)
    size = path.stat().st_size / 2 ** 20
    t0 = time.perf_counter()
    pred_vars, ae_vars = convert_lightning_predictor(str(path), cfg)
    convert_s = time.perf_counter() - t0
    converted = VideoPredictor.from_variables(cfg, ae_vars, pred_vars,
                                              exec_mode="pallas")
    got = converted.freeze_task(to, tp)(frames, eps=eps)
    want = vp.freeze_task(to, tp)(frames, eps=eps)
    print(f"converter: a {size:.1f} MiB LitPredictor checkpoint "
          f"({len(sd)} tensors, an object of a class not installed) "
          f"converted in {convert_s:.1f} s; forward bit-equal to the "
          f"source model's: {torch.equal(got, want)}")
    check(torch.equal(got, want), "the converted model's forward differs")
    path.unlink()
    return {"ckpt_mib": size, "tensors": len(sd), "convert_s": convert_s}


def phase_serving_tools(torch, ta):
    """int8 serving, bundles, the AE variants, the weights writer and the
    converter at the flagship width."""
    import numpy as np

    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.models.inference import VideoPredictor

    cfg = flagship_config()
    p, d = cfg.Predictor, cfg.Dataset
    vps = {m: VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                              exec_mode=m)
           for m in ("pallas", "int8")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.rand((64, 10, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device="cuda") * 2 - 1
    eps = torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                      device="cuda")
    to, tp = np.arange(10), np.arange(10, 20)
    out = {}
    for name, step in (
            ("int8", lambda: _int8_forward(torch, ta, np, vps, frames, eps,
                                           to, tp)),
            ("export", lambda: _export_bundle(torch, ta, np, vps["pallas"],
                                              frames, eps, to, tp)),
            ("ae_variants", lambda: _ae_variants(torch, ta, np)),
            ("weights", lambda: _weights_round_trip(
                torch, np, vps["pallas"], frames, eps, to, tp, cfg)),
            ("converter", lambda: _converter(torch, vps["pallas"], frames,
                                             eps, to, tp, cfg))):
        t0 = time.perf_counter()
        out[name] = step()
        print(f"({name}: {time.perf_counter() - t0:.1f} s)")
    print("serving_tools " + json.dumps(out))
    return out


# phase 11 (b): the flagship's three attention call sites, the kernel run
# on each tensor-parallel head shard
TP_SITES = [("window", 2560, 16, 16, None),
            ("temporal", 4096, 10, 10, "hide_last"),
            ("cross", 4096, 10, 10, None)]


def _loss_bound(want):
    """Phase 6's bound on an eval loss: 1e-3 of its size plus 1e-5, never
    above 2e-2."""
    return min(2e-2, 1e-3 * abs(want) + 1e-5)


def _largest_gap(got, want):
    """The largest |got − want| over matching lists of metric dicts, and
    whether each is within :func:`_loss_bound`; prints each metric's
    largest gap beside its bound."""
    gap, ok, by = 0.0, len(got) == len(want), {}
    for g, w in zip(got, want):
        for k, v in w.items():
            d = abs(float(g[k]) - float(v))
            gap = max(gap, d)
            ok = ok and d <= _loss_bound(float(v))
            if d >= by.get(k, (-1.0,))[0]:
                by[k] = (d, _loss_bound(float(v)))
    print("    largest gap per metric (bound): " + ", ".join(
        f"{k} {d:.2e} ({b:.2e})" for k, (d, b) in by.items()))
    return gap, ok


def _one_rank_arms(torch, ta):
    """(a): SMMNIST Unified NPVP-S as its YAML stands, 4 train steps and a
    validation pass through ``stage2_predictor.train`` without a group,
    then on an NCCL group of one rank in DDP and with ``Env.fsdp``."""
    import torch.distributed as dist

    import numpy as np

    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    tmp = Path(WORK["dir"]) / "parallel"
    tmp.mkdir(parents=True, exist_ok=True)
    yaml = CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml"

    def config(arm):
        return load_config(yaml, [
            "Predictor.exec_mode=pallas", "Predictor.epochs=1",
            f"Predictor.ckpt_save_dir={tmp}/{arm}/ckpt",
            f"Predictor.tensorboard_save_dir={tmp}/{arm}/log",
            "Dataset.dev_set_size=32", "Env.visual_callback=false",
            f"Env.fsdp={'true' if arm == 'fsdp' else 'false'}"])

    ae_path = str(s2.write_random_ae(config("plain"), tmp))
    arms = {}
    # the arms compute the same function; cuDNN's and cuBLAS's
    # nondeterministic algorithms alone would part their losses
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    for arm in ("plain", "ddp", "fsdp"):
        cfg = config(arm)
        cfg.Predictor.resume_AE_ckpt = ae_path
        record = {"train": [], "eval": [], "ms": [], "launches": []}
        clock = [0.0, 0]

        def on_step(kind, index, metrics):
            torch.cuda.synchronize()
            now, launched = time.perf_counter(), sum(ta.LAUNCHES.values())
            record[kind].append({k: float(v) for k, v in metrics.items()
                                 if k != "data_wait_ms"})
            if kind == "train":
                record["ms"].append((now - clock[0]) * 1e3)
            else:
                record["launches"].append(launched - clock[1])
            clock[:] = [time.perf_counter(), sum(ta.LAUNCHES.values())]

        t_arm = time.perf_counter()
        if arm != "plain":
            dist.init_process_group(
                "nccl", init_method=f"file://{tmp}/pg_{arm}", rank=0,
                world_size=1, device_id=torch.device("cuda:0"))
        try:
            reset_launches(ta)
            torch.cuda.reset_peak_memory_stats()
            clock[0] = time.perf_counter()
            state = s2.train(cfg, on_step=on_step)
            torch.cuda.synchronize()
        finally:
            if arm != "plain":
                dist.destroy_process_group()
        record["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        record["kind"] = type(state.model).__name__
        record["wall_s"] = time.perf_counter() - t_arm
        check(len(record["train"]) == 4 and state.step == 4,
              f"{arm}: {len(record['train'])} train steps")
        check(len(record["eval"]) >= 1 and all(
            n == 40 for n in record["launches"]),
            f"{arm}: eval steps launched {record['launches']}, not 40")
        check(all(np.isfinite(list(m.values())).all()
                  for m in record["train"] + record["eval"]),
              f"{arm}: a loss is not finite")
        arms[arm] = record
        if arm == "plain":
            plain_state = state  # the FSDP checkpoint is restored into it
        del state
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    out = {}
    for arm, r in arms.items():
        print(f"(a) {arm}: train losses "
              f"{[round(m['loss'], 6) for m in r['train']]}, eval "
              f"{[round(m['loss_val'], 6) for m in r['eval']]}")
    bad = []
    for arm, r in arms.items():
        line = {"module": r["kind"],
                "train_ms": statistics.median(r["ms"][3:]),
                "peak_gib": r["peak_gib"],
                "eval_launches": r["launches"]}
        if arm != "plain":
            tg, tok = _largest_gap(r["train"], arms["plain"]["train"])
            eg, eok = _largest_gap(r["eval"], arms["plain"]["eval"])
            line.update(train_gap=tg, eval_gap=eg)
            if not (tok and eok):
                bad.append(f"{arm} departs from the plain arm: train gap "
                           f"{tg:.3e}, eval gap {eg:.3e}")
        out[arm] = line
        print(f"(a) {arm:5s} ({r['kind']}): "
              + (f"largest gap to plain train {line['train_gap']:.3e} eval "
                 f"{line['eval_gap']:.3e}; " if arm != "plain" else "")
              + f"{line['train_ms']:.2f} ms/train step (median after 3), "
              f"{r['wall_s']:.1f} s in train(), "
              f"peak {line['peak_gib']:.2f} GiB, launches per eval step "
              f"{r['launches']}")

    check(not bad, "; ".join(bad))
    # the FSDP arm's checkpoint in the plain arm's one-process state
    saved = dict(ta.LAUNCHES)
    cfg = config("fsdp")
    cfg.Predictor.resume_AE_ckpt = ae_path
    dtype, dev = s2.compute_dtype(cfg), torch.device("cuda")
    state = CheckpointManager(tmp / "fsdp" / "ckpt").restore(plain_state)
    steps = s2.make_steps(cfg, s2.load_frozen_ae(cfg, dtype, dev),
                          "rand_context", dev)
    val_rng = Rng(cfg.Env.rand_seed).fold(10 ** 9)
    got = [{k: float(v) for k, v in steps.eval(
        state, steps.place(b), val_rng.fold(vi)).items()}
        for vi, b in zip(range(2), DataModule(cfg).val_loader(
            "rand_context"))]
    gap, ok = _largest_gap(got, arms["fsdp"]["eval"][:2])
    print(f"(a) the FSDP arm's checkpoint restored in one process: eval "
          f"losses {[round(m['loss_val'], 5) for m in got]}, largest gap "
          f"{gap:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, "the FSDP checkpoint restores to other eval losses")
    ta.LAUNCHES.update(saved)
    out["fsdp_restore_gap"] = gap
    return out


def _tp_shard_kernel(torch, ta):
    """(b): the fused kernel on each head shard of model 2 and 4, with its
    columns of wo and bo on shard 0 alone; the partials' sum against the
    full fused launch and the plain twin (phase 2's bf16 bound)."""
    dtype, tol, out, launched = torch.bfloat16, 2e-2, {}, 0
    for name, B, Tq, Tk, mask in TP_SITES:
        x = make_inputs(torch, B, Tq, Tk, mask, dtype, True, seed=B + Tk)
        full_kw = dict(num_heads=NH, wo=x["wo"], bo=x["bo"])
        args = (x["q"], x["k"], x["v"], x["bias"])
        full = ta.temporal_attention(*args, **full_kw).float()
        plain = ta.temporal_attention_plain(*args, **full_kw).float()
        saved = dict(ta.LAUNCHES)
        full_ms = time_call(torch, lambda: ta.temporal_attention(
            *args, **full_kw))
        ta.LAUNCHES.update(saved)
        for M in (2, 4):
            cols = HD // M
            shards = []
            for m in range(M):
                sl = slice(m * cols, (m + 1) * cols)
                shards.append(((x["q"][..., sl].contiguous(),
                                x["k"][..., sl].contiguous(),
                                x["v"][..., sl].contiguous(), x["bias"]),
                               dict(num_heads=NH // M,
                                    wo=x["wo"][:, sl].contiguous(),
                                    bo=x["bo"] if m == 0 else None)))
            before = ta.LAUNCHES["oproj"]
            total = sum(ta.temporal_attention(*a, **kw).float()
                        for a, kw in shards)
            torch.cuda.synchronize()
            launched += ta.LAUNCHES["oproj"] - before
            errs = {}
            for ref_name, ref in (("full", full), ("plain", plain)):
                err = (total - ref).abs()
                errs[ref_name] = err.max().item()
                check(bool((err <= tol + tol * ref.abs()).all()),
                      f"{name} model={M}: shards' sum vs {ref_name} "
                      f"max|d|={errs[ref_name]:.3e}")
            saved = dict(ta.LAUNCHES)
            shard_ms = [time_call(torch, lambda a=a, kw=kw:
                                  ta.temporal_attention(*a, **kw))
                        for a, kw in shards]
            ta.LAUNCHES.update(saved)
            out[f"{name}_model{M}"] = dict(
                max_abs_vs_full=errs["full"], max_abs_vs_plain=errs["plain"],
                shard_ms=shard_ms, full_ms=full_ms)
            print(f"(b) {name:8s} B={B} T={Tq}x{Tk} model={M}: {NH // M} "
                  f"heads (HD {HD // M}) per shard; sum of shards vs full "
                  f"max|d|={errs['full']:.3e}, vs plain "
                  f"{errs['plain']:.3e} (tol {tol}+{tol}|x|); shard ms "
                  f"{[round(t, 4) for t in shard_ms]} (sum "
                  f"{sum(shard_ms):.4f}) vs full {full_ms:.4f}")
    out["launches"] = launched
    return out


def _serve_two(torch, ta, D, rank, dev):
    """(c) serving: the flagship through ``VideoPredictor.shard`` at data
    2 × model 1 and data 1 × model 2 against one device's
    ``freeze_task``."""
    import numpy as np

    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.resnet_ae import build_ae

    cfg = flagship_config()
    p, d = cfg.Predictor, cfg.Dataset
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.rand((64, 10, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device=dev) * 2 - 1
    eps = torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                      device=dev)
    to, tp = np.arange(10), np.arange(10, 20)

    one = VideoPredictor.from_random_init(
        cfg, torch.bfloat16, seed=0, exec_mode="pallas", device=dev)
    # rank 0 compares; the reference forward also warms both ranks up
    want = one.freeze_task(to, tp)(frames, eps=eps).float()
    weights = [m.state_dict() for m in (one.ae, one.predictor)]

    def model():  # the same weights, not yet split
        ae = build_ae(cfg, torch.bfloat16)
        pred = build_predictor(cfg, torch.bfloat16, exec_mode="pallas")
        ae.load_state_dict(weights[0])
        pred.load_state_dict(weights[1])
        return VideoPredictor(cfg, ae, pred, device=dev)

    out = {}
    for data, mdl in ((2, 1), (1, 2)):
        vp = model().shard(D.make_mesh(data, mdl, device_type="cuda"))
        fn = vp.freeze_task(to, tp)  # the reference forward warmed up
        reset_launches(ta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(frames, eps=eps).float()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ta.LAUNCHES)
        diff = (got - want).abs()
        tag = f"data{data}_model{mdl}"
        out[tag] = dict(max_abs=diff.max().item(),
                        mean_abs=diff.mean().item(), launches=launches,
                        ms_per_forward=ms, shape=list(got.shape))
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(got).all()), f"{tag}: bad output")
        check(launches == {"oproj": 32, "attn": 0},
              f"{tag}: rank {rank} launched {launches}, not 32")
        check(out[tag]["max_abs"] < 0.1,
              f"{tag}: max|d| {out[tag]['max_abs']:.3e} to one device")
    return out


def _train_two(torch, ta, D, rank, dev, tmp, fsdp):
    """(c) training: 2 stage-2 steps of SMMNIST Unified NPVP-S at data 2
    (8 rows a rank) against the one-process run at batch 16 (rank 0)."""
    import torch.distributed as dist

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2
    from npvp_tpu_torch.train.common import parallelize_state

    cfg = load_config(CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml", [
        "Predictor.exec_mode=pallas", "Dataset.batch_size=16",
        "Dataset.dev_set_size=64"])
    ae_dir = Path(tmp) / f"ae{rank}"
    ae_dir.mkdir(parents=True, exist_ok=True)
    cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, ae_dir))
    dtype = s2.compute_dtype(cfg)
    ae = s2.load_frozen_ae(cfg, dtype, dev)
    loader = DataModule(cfg).train_loader("rand_context")
    batches = [b for _, b in zip(range(2), loader)]
    loader.close()
    base = Rng(cfg.Env.rand_seed)

    def run(mesh):
        state = s2.init_predictor_state(
            cfg, build_predictor(cfg, dtype).to(dev), 4)
        state = parallelize_state(state, mesh, fsdp, s2.fsdp_units)
        steps = s2.make_steps(cfg, ae, "rand_context", dev, mesh)
        losses, ms = [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = D.all_mean(steps.train(state, steps.place(
                D.shard_batch(mesh, b)), base.fold(i)), mesh)
            losses.append({k: float(v) for k, v in m.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if mesh is None:
            return losses, ms, peak
        # one more step under the profiler: the time of the collectives
        local = steps.place(D.shard_batch(mesh, batches[0]))
        prof = _collectives(torch, lambda: D.all_mean(steps.train(
            state, local, base.fold(99)), mesh))
        return losses, ms, peak, prof

    want = None
    if rank == 0:  # the one-process run, alone on the card
        torch.cuda.reset_peak_memory_stats(dev)
        want = run(None)
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    got = run(D.make_mesh(2, 1, 16, "cuda"))
    if rank != 0:
        return None
    gap, ok = _largest_gap(got[0], want[0])
    check(ok, f"data 2{' + FSDP' if fsdp else ''}: losses depart from the "
              f"one-process run by {gap:.3e}")
    return dict(losses=[m["loss"] for m in got[0]],
                one_process_losses=[m["loss"] for m in want[0]],
                largest_gap=gap, ms=got[1], one_process_ms=want[1],
                peak_gib=got[2], one_process_peak_gib=want[2],
                profiled_step=dict(wall_ms=got[3][0], collectives=got[3][1]))


COLLECTIVE_WORDS = ("gloo", "nccl", "all_reduce", "allreduce", "all_gather",
                    "allgather", "reduce_scatter", "broadcast", "memcpy")


def _collectives(torch, fn, words=COLLECTIVE_WORDS):
    """Wall ms of one call of ``fn`` under torch.profiler and the host and
    device ms of its collective events (and of the copies gloo makes
    between the card and the host), by name: the events whose name holds
    one of ``words``."""
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    found = {}
    for ev in pr.key_averages():
        if not any(w in ev.key.lower() for w in words):
            continue
        dev = (getattr(ev, "device_time_total", None)
               or getattr(ev, "cuda_time_total", 0.0) or 0.0)
        found[ev.key] = dict(count=ev.count,
                             host_ms=ev.cpu_time_total / 1e3,
                             device_ms=dev / 1e3)
    return wall, found


def _rank_main(rank, world, tmp, backend, fsdp):
    """One rank of (c): gloo ranks share card 0, NCCL ranks take one card
    each."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from npvp_tpu_torch.core import distributed as D
    from npvp_tpu_torch.kernels import temporal_attention as ta

    index = rank if backend == "nccl" else 0
    torch.cuda.set_device(index)
    dev = torch.device(f"cuda:{index}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.maybe_init_distributed("cuda", backend=backend,
                             init_method=f"file://{tmp}/pg_{backend}",
                             rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"serving": _serve_two(torch, ta, D, rank, dev)}
        t1 = time.perf_counter()
        out["training"] = _train_two(torch, ta, D, rank, dev, tmp, fsdp)
        out["seconds"] = {"serving": t1 - t0,
                          "training": time.perf_counter() - t1}
        if rank == 0:
            torch.save(out, Path(tmp) / f"{backend}.pt")
    finally:
        dist.destroy_process_group()


def _two_ranks(torch, ta):
    """(c): two ranks on the one card over gloo (NCCL refuses two ranks on
    one device); over NCCL with FSDP where the host has two cards."""
    import torch.multiprocessing as mp

    tmp = Path(WORK["dir"]) / "two_ranks"
    tmp.mkdir(parents=True, exist_ok=True)
    runs = [("gloo", False)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", True))
    out = {}
    for backend, fsdp in runs:
        t0 = time.perf_counter()
        mp.start_processes(_rank_main, args=(2, str(tmp), backend, fsdp),
                           nprocs=2, join=True, start_method="spawn")
        res = torch.load(tmp / f"{backend}.pt", weights_only=False)
        where = ("both on cuda:0" if backend == "gloo"
                 else "cuda:0 and cuda:1")
        for tag, r in res["serving"].items():
            print(f"(c) {backend}, 2 ranks {where}: serving {tag}, batch 64 "
                  f"VFP 10->10: max|d|={r['max_abs']:.3e} mean|d|="
                  f"{r['mean_abs']:.3e} to one device's freeze_task (bound "
                  f"0.1), launches per rank per forward {r['launches']}, "
                  f"{r['ms_per_forward']:.2f} ms/forward")
        t = res["training"]
        print(f"(c) {backend}{' + FSDP' if fsdp else ''}: 2 stage-2 steps "
              f"at data 2 (8 rows a rank): losses "
              f"{[round(x, 5) for x in t['losses']]} vs one process at "
              f"batch 16 {[round(x, 5) for x in t['one_process_losses']]}, "
              f"largest gap {t['largest_gap']:.3e}; ms/step "
              f"{[round(x, 1) for x in t['ms']]} vs "
              f"{[round(x, 1) for x in t['one_process_ms']]}; peak "
              f"{t['peak_gib']:.2f} GiB a rank vs "
              f"{t['one_process_peak_gib']:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s (rank 0: serving "
              f"{res['seconds']['serving']:.1f} s, training "
              f"{res['seconds']['training']:.1f} s)")
        prof = t["profiled_step"]
        print(f"(c) {backend}: one train step under torch.profiler: "
              f"{prof['wall_ms']:.1f} ms wall on rank 0; collectives "
              f"and their copies: " + "; ".join(
                  f"{k} x{v['count']} host {v['host_ms']:.2f} ms device "
                  f"{v['device_ms']:.2f} ms"
                  for k, v in sorted(prof["collectives"].items())))
        out[backend] = res
    if len(runs) == 1:
        print(f"(c) NCCL over two cards with FSDP: not run, this host has "
              f"{torch.cuda.device_count()} CUDA device")
    return out


def phase_parallel(torch, ta):
    """Phase 11: (a) one NCCL rank, plain/DDP/FSDP; (b) the kernel at
    tensor-parallel head shards; (c) two ranks on the card."""
    out, t0 = {}, time.perf_counter()
    for key, part in (("one_rank", _one_rank_arms),
                      ("tp_shards", _tp_shard_kernel),
                      ("two_ranks", _two_ranks)):
        out[key] = part(torch, ta)
        print(f"-- phase 11 {key}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
    return out


# -- phase 12: sequence and pipeline parallelism, the dry run, GAN ----------

# the fused kernel as sequence parallelism calls it at model 2 (phase 11's
# sites: whole, H gathered), 4 local heads of 64, wo's local columns, no
# bias (added after the reduce-scatter)
SP_WORDS = COLLECTIVE_WORDS + ("sequence_parallel",)


def _sp_kernel(torch, ta):
    """(a) the fused kernel at the shapes sequence parallelism gives it at
    model 2 against its twin (phase 2's bf16 bound), ms a launch beside the
    full launch."""
    dtype, tol, out = torch.bfloat16, 2e-2, {}
    for name, B, Tq, Tk, mask in TP_SITES:
        x = make_inputs(torch, B, Tq, Tk, mask, dtype, True, seed=B + Tq)
        cols = slice(HD // 2, HD)  # model rank 1's heads
        args = (x["q"][..., cols].contiguous(), x["k"][..., cols].contiguous(),
                x["v"][..., cols].contiguous(), x["bias"])
        kw = dict(num_heads=NH // 2, wo=x["wo"][:, cols].contiguous(),
                  bo=None)
        got = ta.temporal_attention(*args, **kw).float()
        want = ta.temporal_attention_plain(*args, **kw).float()
        err = (got - want).abs()
        check(bool((err <= tol + tol * want.abs()).all()),
              f"SP {name}: kernel vs twin max|d|={err.max().item():.3e}")
        saved = dict(ta.LAUNCHES)
        ms = time_call(torch, lambda: ta.temporal_attention(*args, **kw))
        plain_ms = time_call(torch, lambda: ta.temporal_attention_plain(
            *args, **kw))
        full = dict(num_heads=NH, wo=x["wo"], bo=x["bo"])
        full_ms = time_call(torch, lambda: ta.temporal_attention(
            x["q"], x["k"], x["v"], x["bias"], **full))
        ta.LAUNCHES.update(saved)
        out[name] = dict(max_abs=err.max().item(), ms=ms, plain_ms=plain_ms,
                         full_ms=full_ms)
        print(f"(a) kernel at the SP shape {name} B={B} T={Tq}x{Tk}, "
              f"{NH // 2} heads (HD {HD // 2}), no bias: vs twin max|d|="
              f"{err.max().item():.3e} (tol {tol}+{tol}|x|); {ms:.4f} ms a "
              f"launch (twin {plain_ms:.4f}, full launch {full_ms:.4f})")
    return out


def _sp_serve(torch, ta, D, rank, dev):
    """(a) the flagship through ``VideoPredictor.shard`` at model 2 under
    sequence parallelism against one device's ``freeze_task``."""
    import numpy as np

    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.core.sequence_parallel import sequence_parallel
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.resnet_ae import build_ae

    cfg = flagship_config()
    p, d = cfg.Predictor, cfg.Dataset
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.rand((64, 10, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device=dev) * 2 - 1
    eps = torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                      device=dev)
    to, tp = np.arange(10), np.arange(10, 20)
    one = VideoPredictor.from_random_init(
        cfg, torch.bfloat16, seed=0, exec_mode="pallas", device=dev)
    want = one.freeze_task(to, tp)(frames, eps=eps).float()
    ae = build_ae(cfg, torch.bfloat16)
    pred = build_predictor(cfg, torch.bfloat16, exec_mode="pallas")
    ae.load_state_dict(one.ae.state_dict())
    pred.load_state_dict(one.predictor.state_dict())
    del one
    mesh = D.make_mesh(1, 2, device_type="cuda")
    fn = VideoPredictor(cfg, ae, pred, device=dev).shard(mesh).freeze_task(
        to, tp)
    ms = []
    with sequence_parallel(mesh):
        fn(frames, eps=eps)  # warm-up
        for _ in range(1):
            reset_launches(ta)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(frames, eps=eps).float()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(ta.LAUNCHES)
    diff = (got - want).abs()
    out = dict(max_abs=diff.max().item(), mean_abs=diff.mean().item(),
               launches=launches, ms_per_forward=ms)
    check(tuple(got.shape) == tuple(want.shape)
          and bool(torch.isfinite(got).all()), "SP serving: bad output")
    check(launches == {"oproj": 32, "attn": 0},
          f"SP serving: rank {rank} launched {launches}, not 32")
    check(out["max_abs"] < 0.1,
          f"SP serving: max|d| {out['max_abs']:.3e} to one device")
    return out


def _sp_train(torch, ta, D, rank, dev, tmp):
    """(b) 2 stage-2 steps of SMMNIST Unified NPVP-S (its YAML as it
    stands) at model 2 with sequence parallelism (and 1 without, for the
    peak memory), against one process at the same global batch (rank 0);
    the eval step's launches; a profiled SP step."""
    import torch.distributed as dist

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.core.sequence_parallel import sequence_parallel
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2
    from npvp_tpu_torch.train.common import parallelize_state

    cfg = load_config(CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml", [
        "Predictor.exec_mode=pallas", "Dataset.dev_set_size=64"])
    ae_dir = Path(tmp) / f"sp_ae{rank}"
    ae_dir.mkdir(parents=True, exist_ok=True)
    cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, ae_dir))
    dtype = s2.compute_dtype(cfg)
    ae = s2.load_frozen_ae(cfg, dtype, dev)
    loader = DataModule(cfg).train_loader("rand_context")
    batches = [b for _, b in zip(range(2), loader)]
    loader.close()
    base = Rng(cfg.Env.rand_seed)

    def run(mesh, sp, n_steps=2):
        state = s2.init_predictor_state(
            cfg, build_predictor(cfg, dtype).to(dev), 4)
        state = parallelize_state(state, mesh, False, s2.fsdp_units)
        steps = s2.make_steps(cfg, ae, "rand_context", dev, mesh)
        place = lambda b: steps.place(D.shard_batch(mesh, b))  # noqa
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms = [], []
        with sequence_parallel(mesh if sp else None):
            for i, b in enumerate(batches[:n_steps]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = D.all_mean(steps.train(state, place(b), base.fold(i)),
                               mesh)
                losses.append({k: float(v) for k, v in m.items()})
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            reset_launches(ta)
            ev = steps.eval(state, place(batches[0]), base.fold(50))
            torch.cuda.synchronize()
            launches = dict(ta.LAUNCHES)
            out = dict(losses=losses, ms=ms, peak_gib=peak,
                       eval={k: float(v) for k, v in ev.items()},
                       eval_launches=launches)
            if sp:
                local = place(batches[0])
                out["profiled_step"] = _collectives(
                    torch, lambda: steps.train(state, local, base.fold(99)),
                    SP_WORDS)
        del state
        torch.cuda.empty_cache()
        return out

    want = run(None, False) if rank == 0 else None
    dist.barrier()
    mesh = D.make_mesh(1, 2, cfg.Dataset.batch_size, "cuda")
    tp_only = run(mesh, False, n_steps=1)  # its peak, for comparison
    got = run(mesh, True)
    check(got["eval_launches"] == {"oproj": 40, "attn": 0},
          f"SP eval step: rank {rank} launched {got['eval_launches']}")
    if rank != 0:
        return None
    for tag, r in (("model 2", tp_only), ("model 2 + SP", got)):
        gap, ok = _largest_gap(r["losses"], want["losses"][:len(
            r["losses"])])
        r["largest_gap"] = gap
        check(ok, f"{tag}: losses depart from one process by {gap:.3e}")
    return dict(one_process=want, model2=tp_only, model2_sp=got)


def _gpipe(torch, ta, rank, dev):
    """(c) the flagship's 8 decoder blocks (eval mode, the fused kernel)
    at 2 stages × 4 microbatches of 16 rows against the sequential stack
    on one rank, run on the same microbatches (cuBLAS picks its
    algorithms by shape, so the stack on the batch of 64 rounds bf16
    otherwise: that gap is printed too)."""
    import torch.distributed as dist
    from torch.func import functional_call

    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.core.pipeline import (make_pipeline_mesh,
                                              pipeline_apply,
                                              stack_layer_params)
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.tools.weights import random_init

    cfg = flagship_config()
    p = cfg.Predictor
    pred = random_init(build_predictor(cfg, torch.bfloat16, "pallas"), 3)
    blocks = [getattr(pred.decoder, f"layer_{i}").to(dev).eval()
              for i in range(p.transformer_layers)]
    gen = torch.Generator(device=dev).manual_seed(5)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
    N, T, H, W, C = 64, 10, p.max_H, p.max_W, p.embed_dim
    tgt0, memory, query = (rand(N, T, H, W, C), rand(N, T, H, W, C),
                           rand(N, 1, H, W, C))
    mem_pos = (rand(T * H * W, C), rand(T * H * W, C))
    tgt_pos = (rand(T * H * W, C), rand(T * H * W, C))
    out = {}
    if rank == 0:
        with torch.no_grad():
            def sequential(rows=slice(None)):
                h = tgt0[rows]
                for b in blocks:
                    h = b(h, query[rows], memory[rows], mem_pos, tgt_pos)
                return h
            want64 = sequential().float()
            want = torch.cat([sequential(slice(i, i + 16)).float()
                              for i in range(0, N, 16)])
            out["sequential_ms"] = time_forwards(torch, sequential, 2)
    dist.barrier()

    def apply_block(params, pack):
        tgt, q, m = pack
        return (functional_call(blocks[0], params,
                                (tgt, q, m, mem_pos, tgt_pos)), q, m)

    mesh = make_pipeline_mesh(2, 1, "cuda")
    pack = tuple(t.reshape((4, 16) + tuple(t.shape[1:]))
                 for t in (tgt0, query, memory))
    stacked = stack_layer_params(blocks)
    ms = []
    for _ in range(1):
        reset_launches(ta)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_apply(apply_block, stacked, pack, mesh=mesh)[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(ta.LAUNCHES)
    # 4 microbatches x 4 blocks a stage x 3 attention calls
    check(launches == {"oproj": 48, "attn": 0},
          f"GPipe: rank {rank} launched {launches}, not 48")
    if rank == 0:
        got = got.reshape(want.shape).float()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()) and bool(
            (err <= 2e-2 + 2e-2 * want.abs()).all()),
            f"GPipe vs sequential max|d| {err.max().item():.3e}")
        out.update(max_abs=err.max().item(), mean_abs=err.mean().item(),
                   max_abs_batch64=(got - want64).abs().max().item(),
                   mean_abs_batch64=(got - want64).abs().mean().item())
    out.update(pipeline_ms=ms, launches=launches)
    return out


def _rank12_main(rank, world, tmp):
    """One of phase 12's two ranks, both on card 0 over gloo."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from npvp_tpu_torch.core import distributed as D
    from npvp_tpu_torch.kernels import temporal_attention as ta

    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.maybe_init_distributed("cuda", backend="gloo",
                             init_method=f"file://{tmp}/pg12", rank=rank,
                             world_size=world)
    try:
        out, t0 = {}, time.perf_counter()
        for key, part in (
                ("serving", lambda: _sp_serve(torch, ta, D, rank, dev)),
                ("training", lambda: _sp_train(torch, ta, D, rank, dev,
                                               tmp)),
                ("gpipe", lambda: _gpipe(torch, ta, rank, dev))):
            out[key] = part()
            out[f"{key}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        if rank == 0:
            torch.save(out, Path(tmp) / "phase12.pt")
    finally:
        dist.destroy_process_group()


def _two_ranks12(torch):
    import torch.multiprocessing as mp

    tmp = Path(WORK["dir"]) / "phase12"
    tmp.mkdir(parents=True, exist_ok=True)
    mp.start_processes(_rank12_main, args=(2, str(tmp)), nprocs=2,
                       join=True, start_method="spawn")
    res = torch.load(tmp / "phase12.pt", weights_only=False)
    s = res["serving"]
    print(f"(a) gloo, 2 ranks on cuda:0: serving at model 2 with sequence "
          f"parallelism, batch 64 VFP 10->10: max|d|={s['max_abs']:.3e} "
          f"mean|d|={s['mean_abs']:.3e} to one device's freeze_task (bound "
          f"0.1), launches per rank per forward {s['launches']}, ms/forward "
          f"{[round(x, 2) for x in s['ms_per_forward']]} "
          f"({res['serving_s']:.1f} s)")
    t = res["training"]
    one = t["one_process"]
    for tag in ("model2", "model2_sp"):
        r = t[tag]
        print(f"(b) {tag}: {len(r['losses'])} steps of SMMNIST Unified "
              f"NPVP-S at batch 8: "
              f"losses {[round(m['loss'], 6) for m in r['losses']]} vs one "
              f"process {[round(m['loss'], 6) for m in one['losses']]}, "
              f"largest gap {r['largest_gap']:.3e} (bound "
              f"{_loss_bound(one['losses'][0]['loss']):.2e}); ms/step "
              f"{[round(x, 1) for x in r['ms']]} vs "
              f"{[round(x, 1) for x in one['ms']]}; peak {r['peak_gib']:.2f}"
              f" GiB a rank vs {one['peak_gib']:.2f} GiB; eval step "
              f"launches {r['eval_launches']}")
    wall, found = t["model2_sp"]["profiled_step"]
    print(f"(b) one SP train step under torch.profiler: {wall:.1f} ms wall "
          "on rank 0; spans and collectives: " + "; ".join(
              f"{k} x{v['count']} host {v['host_ms']:.2f} ms device "
              f"{v['device_ms']:.2f} ms" for k, v in sorted(found.items())))
    print(f"    ({res['training_s']:.1f} s)")
    g = res["gpipe"]
    print(f"(c) GPipe, 8 flagship decoder blocks at 2 stages x 4 "
          f"microbatches of 16: max|d|={g['max_abs']:.3e} mean|d|="
          f"{g['mean_abs']:.3e} to the sequential stack on the same "
          f"microbatches (bound 2e-2+2e-2|x|), max|d|="
          f"{g['max_abs_batch64']:.3e} mean|d|={g['mean_abs_batch64']:.3e}"
          f" to the stack on the batch of 64; "
          f"{[round(x, 1) for x in g['pipeline_ms']]} ms vs "
          f"{g['sequential_ms']:.1f} ms sequential on one rank; launches "
          f"per rank {g['launches']} ({res['gpipe_s']:.1f} s)")
    return res


def _gan_steps(torch, ta):
    """(e) 5 adversarial steps of SMMNIST Unified NPVP-S at full width
    (``make_gan_steps``), then its eval step with the kernel against the
    plain path."""
    import types

    import numpy as np

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    tmp = Path(WORK["dir"]) / "gan"
    tmp.mkdir(parents=True, exist_ok=True)
    cfg = load_config(CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml", [
        "Predictor.exec_mode=pallas", "Predictor.use_gan=true",
        "Dataset.dev_set_size=64"])
    cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp))
    dev, dtype = torch.device("cuda"), s2.compute_dtype(cfg)
    ae = s2.load_frozen_ae(cfg, dtype, dev)
    state_g = s2.init_predictor_state(
        cfg, build_predictor(cfg, dtype).to(dev), 5)
    train_step, eval_step, place, init_d = s2.make_gan_steps(
        cfg, ae, "rand_context", dev)
    state_d = init_d(cfg.Env.rand_seed + 1)
    loader = DataModule(cfg).train_loader("rand_context")
    batches = [place(b) for _, b in zip(range(5), loader)]
    loader.close()
    base = Rng(cfg.Env.rand_seed)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ta)
    record = []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in train_step(state_g, state_d, b,
                                                 base.fold(i)).items()}
        torch.cuda.synchronize()
        record.append(dict(m, ms=(time.perf_counter() - t0) * 1e3))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(dict(ta.LAUNCHES) == {"oproj": 0, "attn": 0},
          f"a GAN train step launched the kernel {dict(ta.LAUNCHES)}")
    check(all(np.isfinite([v for k, v in m.items()]).all() for m in record),
          "a GAN loss is not finite")
    reset_launches(ta)
    eval_step(state_g, batches[0], Rng(7))
    torch.cuda.synchronize()
    launches = dict(ta.LAUNCHES)
    check(launches == {"oproj": 40, "attn": 0},
          f"the GAN eval step launched {launches}, not 40")
    gap = eval_kernel_vs_plain(torch, cfg, state_g,
                               types.SimpleNamespace(eval=eval_step),
                               batches[0])
    keys = ("loss", "loss_G_gan", "loss_D", "loss_D_fake", "loss_D_real")
    for i, m in enumerate(record):
        print(f"(e) GAN step {i}: " + ", ".join(
            f"{k} {m[k]:.5f}" for k in keys) + f", {m['ms']:.1f} ms")
    ms = statistics.median(m["ms"] for m in record[2:])
    print(f"(e) discriminator of {state_d.model.n_layers} + 2 convs (ndf "
          f"{cfg.Predictor.ndf}); {ms:.1f} ms a step (median after 2), "
          f"peak {peak:.2f} GiB; eval step launches {launches}, kernel vs "
          f"plain eval losses within {gap:.2e}")
    return dict(steps=record, ms=ms, peak_gib=peak, eval_launches=launches,
                eval_gap=gap)


def phase_sequence_pipeline(torch, ta):
    """Phase 12: (a) the kernel at SP shapes, and with (b) and (c) on two
    ranks sharing the card: SP serving, SP training, GPipe; (d) the dry
    run on four ranks; (e) the adversarial steps."""
    from npvp_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    out, t0 = {}, time.perf_counter()
    for key, part in (
            ("sp_kernel", lambda: _sp_kernel(torch, ta)),
            ("two_ranks", lambda: _two_ranks12(torch)),
            ("dryrun", lambda: dryrun_multichip(4)),
            ("gan", lambda: _gan_steps(torch, ta))):
        out[key] = part()
        print(f"-- phase 12 {key}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
    return out


# -- phase 13: SMMNIST as the JAX package draws it, the config generator ---

def _stream_vs_twin(np, nb, ds, n=64):
    """The dataset's C++ batch stream against its numpy twin on ``n`` clips
    (bit-equal), ms each."""
    ids = np.arange(n)
    t0 = time.perf_counter()
    got = ds.get_batch(ids)
    stream_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = nb.synth_moving_sprites_reference(
        ds.sprites, ds.seq_len, ds.image_size, ds.num_digits,
        ds.deterministic, ids.astype(np.uint64) * 2 + int(ds._train))
    twin_ms = (time.perf_counter() - t0) * 1e3
    check(got.shape == want.shape == (n, 15, 64, 64, 1),
          f"stream {got.shape}, twin {want.shape}")
    differ = int((got != want).sum())
    print(f"C++ stream vs numpy twin, {n} test clips (15 x 64 x 64): "
          f"{differ} of {got.size} values differ; {stream_ms:.2f} ms "
          f"stream, {twin_ms:.2f} ms twin")
    check(differ == 0, "the C++ stream departs from its numpy twin")
    return {"clips": n, "values_differing": differ, "stream_ms": stream_ms,
            "twin_ms": twin_ms}


def _loader_ms(np, nb, cfg):
    """ms per test batch of the SMMNIST loader alone (batch 8, one epoch),
    on the C++ stream and clip by clip."""
    from npvp_tpu_torch.data.loader import DataModule

    out = {}
    available = nb.native_available
    for path in ("stream", "per_index"):
        if path == "per_index":
            nb.native_available = lambda: False
        try:
            loader = DataModule(cfg).test_loader("rand_context")
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            out[path] = (time.perf_counter() - t0) * 1e3 / n
        finally:
            nb.native_available = available
    print(f"SMMNIST test loader alone, batch {cfg.Dataset.batch_size}, "
          f"{n} batches: {out['stream']:.3f} ms a batch on the C++ stream, "
          f"{out['per_index']:.3f} ms clip by clip")
    return {"batches": n, **{f"{k}_ms_per_batch": v for k, v in out.items()}}


def _stream_eval_steps(torch, ta, np, cfg, tmp, n_steps=4):
    """SMMNIST Unified NPVP-S eval steps at full width on the test loader's
    first batches (no dev cut: the C++ stream), random weights from
    ``Env.rand_seed``; 40 launches a step; each loss against the plain
    path's on the same batch and noise (phase 6's bound)."""
    import types

    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2
    from npvp_tpu_torch.train.common import config_device

    p, d = cfg.Predictor, cfg.Dataset
    cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp))
    dev, dtype = config_device(cfg), s2.compute_dtype(cfg)
    ae = s2.load_frozen_ae(cfg, dtype, dev)
    state = s2.init_predictor_state(
        cfg, build_predictor(cfg, dtype).to(dev), 1)
    steps = s2.make_steps(cfg, ae, "rand_context", dev)
    dm = DataModule(cfg)
    check(hasattr(dm.dataset("test"), "get_batch"), "no batch stream")
    print(f"SMMNIST Unified NPVP-S (embed {p.embed_dim}, "
          f"{p.transformer_layers} + {p.evt_former_num_layers} layers, "
          f"max_T {p.max_T}), batch {d.batch_size}, {cfg.Env.compute_dtype},"
          f" exec_mode {p.exec_mode}, test split without a dev cut "
          f"({len(dm.dataset('test'))} clips)")
    loader = dm.test_loader("rand_context")
    batches = []
    for batch in loader:
        batches.append(steps.place(batch))
        if len(batches) == n_steps + 1:
            break
    steps.eval(state, batches[0], Rng(99))  # warm-up: cuDNN, cuBLAS choose
    torch.cuda.synchronize()
    reset_launches(ta)
    got, per_step, ms = [], [], []
    for k, batch in enumerate(batches[1:]):
        before = sum(ta.LAUNCHES.values())
        t0 = time.perf_counter()
        got.append({key: float(v) for key, v in
                    steps.eval(state, batch, Rng(100 + k)).items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(sum(ta.LAUNCHES.values()) - before)
    launches = dict(ta.LAUNCHES)
    check(per_step == [40] * n_steps and launches["attn"] == 0,
          f"eval steps launched {per_step}, {launches}: not 40 fused each")
    check(all(np.isfinite(list(g.values())).all() for g in got),
          f"eval losses {got}")
    plain = build_predictor(cfg, dtype, exec_mode="xla").to(dev)
    plain.load_state_dict(state.model.state_dict())
    arm = types.SimpleNamespace(model=plain, module=plain)
    worst = 0.0
    for k, batch in enumerate(batches[1:]):
        want = {key: float(v) for key, v in
                steps.eval(arm, batch, Rng(100 + k)).items()}
        gaps = {key: abs(got[k][key] - want[key]) for key in want}
        bound = {key: min(2e-2, 1e-3 * abs(want[key]) + 1e-5)
                 for key in want}
        print(f"eval step {k} on stream batch {k + 1}: {ms[k]:.2f} ms, "
              f"{per_step[k]} launches; kernel vs plain " + ", ".join(
                  f"{key} {got[k][key]:.6f} vs {want[key]:.6f} (|d| "
                  f"{gaps[key]:.2e}, tol {bound[key]:.2e})" for key in want))
        far = [key for key in want if not gaps[key] <= bound[key]]
        check(not far, f"eval step {k}: kernel departs from plain in {far}")
        worst = max(worst, *gaps.values())
    eval_ms = statistics.median(ms)
    print(f"eval step on stream-drawn test clips: {eval_ms:.2f} ms median "
          f"of {[round(m, 2) for m in ms]}; launches {launches}")
    return {"eval_ms": eval_ms, "eval_ms_all": ms, "launches": launches,
            "launches_per_step": per_step, "max_loss_gap": worst}


def _generated_configs(tmp):
    """The generator into a temporary directory; each YAML loads through
    the port's Config and equals the committed one byte for byte."""
    from npvp_tpu_torch.configs import generate
    from npvp_tpu_torch.core.config import load_config

    paths = generate.write_configs(Path(tmp) / "configs")
    for path in paths:
        load_config(path)
        check(path.read_bytes() == (CONFIGS / path.name).read_bytes(),
              f"{path.name} differs from the committed YAML")
    print(f"config generator: {len(paths)} YAMLs written to a temporary "
          f"directory, each loaded through Config and equal to "
          f"npvp_tpu_torch/configs/")
    return len(paths)


def phase_smmnist_stream(torch, ta):
    """The C++ data library, the SMMNIST batch stream through the loader
    and the fused kernel, and the config generator."""
    import numpy as np

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data import native_bindings as nb
    from npvp_tpu_torch.data.smmnist import StochasticMovingMNIST

    nb.build()  # raises with the compiler's output
    check(nb.native_available(), "the C++ data library does not load")
    info = nb.BUILD_INFO
    print(f"C++ data library: {info.get('compiler', 'built earlier')}, "
          f"{' '.join(nb.CXX_FLAGS)}; built in "
          f"{info.get('seconds', float('nan')):.2f} s (at its first use in "
          f"this run) -> {Path(info['library']).relative_to(HERE)}")
    result = {"build_s": info.get("seconds"),
              "compiler": info.get("compiler")}
    result["stream"] = _stream_vs_twin(np, nb,
                                       StochasticMovingMNIST(train=False))
    yaml = CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(yaml, ["Predictor.exec_mode=pallas"])
        check(cfg.Dataset.dev_set_size is None, "the YAML cuts the split")
        result["loader"] = _loader_ms(np, nb, cfg)
        result["eval"] = _stream_eval_steps(torch, ta, np, cfg, tmp)
        result["configs"] = _generated_configs(tmp)
    print("smmnist_stream " + json.dumps(result))
    return result


# -- phase 14: the report tools on the card ---------------------------------

# kernel launches a forward of the frontier's variants: encoder layers x 2
# plus decoder layers x 3
FRONTIER_LAUNCHES = {"full": 32, "L4": 20, "L4evt2": 16}
# the pallas arm's predicted features (the AE decoder's input) may sit
# from the bf16 arm's at most this many times the fp32 arm's mean |d|: a
# correct kernel sits at 0.885 of it on an H100, a kernel with q halved at
# 5.8 and one without its mask at 4.6 (random weights flatten the decoded
# frames, where those faults move less than bf16 does)
FEATURES_RATIO = 2


def _finite_json(tree, where):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _finite_json(v, f"{where}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _finite_json(v, f"{where}[{i}]")
    else:
        check(not isinstance(tree, float) or math.isfinite(tree),
              f"{where} = {tree}")


def _write_archives(torch, work):
    """Random-weight archives (seeded) of SMMNIST Unified NPVP-D and -S at
    full width, through the port's ``save_weights``; the two are written
    in two threads (compression holds no lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.tools.weights import save_weights

    def write(v):
        yaml = CONFIGS / f"config_SMMNIST_Unified_NPVP-{v}.yaml"
        cfg = load_config(yaml)
        t0 = time.perf_counter()
        vp = VideoPredictor.from_random_init(cfg, torch.float32, seed=14,
                                             device="cuda")
        path = Path(work) / f"SMMNIST_Unified_NPVP-{v}" / "weights.npz"
        save_weights(path, vp.ae, vp.predictor, {"seed": 14})
        return cfg, dict(yaml=yaml, npz=path, s=time.perf_counter() - t0,
                         mib=path.stat().st_size / 2 ** 20)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        written = dict(zip(("D", "S"), pool.map(write, ("D", "S"))))
    wall = time.perf_counter() - t0
    out = {}
    for v, (cfg, a) in written.items():
        p = cfg.Predictor
        out[v] = a
        print(f"archive NPVP-{v}: embed {p.embed_dim}, "
              f"{p.evt_former_num_layers} EVT-former + "
              f"{p.transformer_layers} decoder layers, {a['mib']:.1f} MiB, "
              f"written in {a['s']:.1f} s")
    print(f"both archives in {wall:.1f} s")
    return out


def _stage1_log(torch, work):
    """Three epochs of two stage-1 steps (the SMMNIST AE config at full
    width), the trainer's output kept as its log."""
    import contextlib
    import io

    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.train import stage1_ae as s1

    cfg = load_config(CONFIGS / "config_SMMNIST_Autoencoder.yaml", [
        "AE.epochs=3", "Env.visual_callback=false",
        f"AE.ckpt_save_dir={work}/conv_ae",
        f"AE.tensorboard_save_dir={work}/conv_ae_log",
        "Dataset.dev_set_size=16"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        s1.train(cfg)
    log = Path(work) / "stage1.log"
    log.write_text(out.getvalue())
    return log


def _fidelity_frames(torch, ta, arch):
    """The exec-mode arms' outputs themselves, on the first test batch of
    8 clips (NPVP-D: no latent draw): the predicted frames and the
    predictor's features (the AE decoder's input) of the pallas arm
    against the bf16 arm's, beside the fp32 arm's distance from bf16."""
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.tools.weights import load_weights

    cfg = load_config(arch["D"]["yaml"])
    loader = DataModule(cfg).test_loader()
    batch = next(iter(loader))
    loader.close()
    ae_vars, pred_vars, _ = load_weights(arch["D"]["npz"])
    saved = dict(ta.LAUNCHES)
    reset_launches(ta)
    got = {"frames": {}, "features": {}}
    for arm, dtype, mode in (("fp32", torch.float32, None),
                             ("bf16", torch.bfloat16, None),
                             ("pallas", torch.bfloat16, "pallas")):
        vp = VideoPredictor.from_variables(cfg, ae_vars, pred_vars, dtype,
                                           mode, "cuda")
        hook = vp.predictor.register_forward_hook(
            lambda m, i, o, arm=arm: got["features"].__setitem__(
                arm, o.pred_features.float()))
        got["frames"][arm] = vp.vfp(
            batch["past"], cfg.Dataset.test_num_future_frames).float()
        hook.remove()
        del vp
    launched = dict(ta.LAUNCHES)
    ta.LAUNCHES.update(saved)
    out = {"launches": launched,  # the pallas arm's forward alone
           "finite": all(bool(torch.isfinite(t).all())
                         for arms in got.values() for t in arms.values())}
    for what, arms in got.items():
        d = {arm: (arms[arm] - arms["bf16"]).abs()
             for arm in ("pallas", "fp32")}
        out[what] = {arm: dict(max_abs=x.max().item(),
                               mean_abs=x.mean().item())
                     for arm, x in d.items()}
        r = out[what]
        print(f"exec-mode {what} {tuple(arms['bf16'].shape)}, first test "
              f"batch: pallas vs bf16 max|d|={r['pallas']['max_abs']:.3e} "
              f"mean|d|={r['pallas']['mean_abs']:.3e}; fp32 vs bf16 "
              f"max|d|={r['fp32']['max_abs']:.3e} "
              f"mean|d|={r['fp32']['mean_abs']:.3e}; ratio of the means "
              f"{r['pallas']['mean_abs'] / r['fp32']['mean_abs']:.3f}"
              + (f" (bound {FEATURES_RATIO})" if what == "features"
                 else ""))
    return out


def phase_reports(torch, ta):
    """The six report tools of ``npvp_tpu_torch/tools`` on the card, on
    random-weight archives of SMMNIST Unified NPVP-D and -S at full width
    and the seeded SMMNIST test split, bf16 with the kernel."""
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.tools import (convergence_report,
                                      exec_mode_fidelity, frontier,
                                      memory_report, quality_report,
                                      window_drift)

    work = Path(WORK["dir"]) / "reports"
    arch = _write_archives(torch, work)
    walls, launches, per_call, reports = {}, {}, {}, {}
    calls = []

    def counted(evaluate):
        def each_call(*a, **kw):
            before = dict(ta.LAUNCHES)
            res = evaluate(*a, **kw)
            calls.append({k: ta.LAUNCHES[k] - before[k] for k in before})
            return res
        return each_call

    def run(key, tool, argv, out_json):
        """``tool.main(argv)``; its kernel launches, in all and for each
        ``evaluate`` call it makes."""
        reset_launches(ta)
        calls.clear()
        evaluate = getattr(tool, "evaluate", None)
        if evaluate is not None:
            tool.evaluate = counted(evaluate)
        t0 = time.perf_counter()
        try:
            tool.main([str(a) for a in argv])
        finally:
            if evaluate is not None:
                tool.evaluate = evaluate
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        launches[key] = dict(ta.LAUNCHES)
        per_call[key] = list(calls)
        if out_json is not None:
            reports[key] = json.loads(Path(out_json).read_text())
            _finite_json(reports[key], key)
        return reports.get(key)

    def oproj(n):
        return {"oproj": n, "attn": 0}

    def common(v, pallas=True):
        a = arch[v]
        return (["--config_path", a["yaml"], "--device", "cuda",
                 "--override", f"Predictor.ckpt_save_dir={a['npz']}",
                 f"Predictor.resume_AE_ckpt={a['npz']}"]
                + (["Predictor.exec_mode=pallas"] if pallas else []))

    mb = 2  # test batches of 8 clips an evaluation
    # NPVP-D on the five tasks, NPVP-S best-of-2 on VFP
    for v, samples, tasks in (("D", 1, quality_report.TASKS),
                              ("S", 2, ("VFP",))):
        key = f"quality_{v}"
        rep = run(key, quality_report, common(v) + [
            "--max_batches", mb, "--num_samples", samples, "--dtype",
            "bfloat16", "--tasks", *tasks, "--out_dir", work / key],
            work / key / "quality.json")
        check(list(rep["tasks"]) == list(tasks),
              f"{key}: tasks {list(rep['tasks'])}")
        want = [oproj(mb * samples * 32)] * len(tasks)
        check(per_call[key] == want,
              f"{key}: launches a call {per_call[key]}, not {want}")
    # the fp32 and bf16 arms on the config's plain path, pallas on the
    # kernel, int8 on its own products
    rep = run("fidelity", exec_mode_fidelity, common("D", pallas=False) + [
        "--max_batches", mb, "--out_dir", work / "fidelity"],
        work / "fidelity" / "exec_mode_fidelity.json")
    modes = rep["modes"]
    gap = abs(modes["pallas"]["PSNR"] - modes["bf16"]["PSNR"])
    want = [oproj(mb * 32 if m == "pallas" else 0) for m in modes]
    check(per_call["fidelity"] == want,
          f"exec_mode_fidelity: launches an arm {per_call['fidelity']}, "
          f"not {want} (the pallas arm alone)")
    print("exec_mode_fidelity: " + "; ".join(
        f"{k} PSNR {r['PSNR']:.4f} SSIM {r['SSIM']:.5f}"
        for k, r in modes.items()) + f"; |pallas - bf16| {gap:.5f} dB "
        "(bound 0.01)")
    frames = _fidelity_frames(torch, ta, arch)
    check(gap <= 0.01, f"pallas arm {gap:.4f} dB from the bf16 arm")
    check(frames["finite"], "exec-mode outputs: not finite")
    check(frames["launches"] == oproj(32),
          f"exec-mode outputs: {frames['launches']} launches, not 32")
    check(frames["frames"]["pallas"]["max_abs"] < 0.1,
          f"pallas arm's frames max|d| "
          f"{frames['frames']['pallas']['max_abs']:.3e} to the bf16 arm's")
    r = frames["features"]
    check(r["pallas"]["mean_abs"] <= FEATURES_RATIO * r["fp32"]["mean_abs"],
          f"pallas arm's features mean|d| {r['pallas']['mean_abs']:.3e} to "
          f"the bf16 arm's, over {FEATURES_RATIO} x the fp32 arm's "
          f"{r['fp32']['mean_abs']:.3e}")
    run("window_drift", window_drift, common("D") + [
        "--max_batches", mb, "--dtype", "bfloat16", "--out",
        work / "window_drift.json"], work / "window_drift.json")
    # direct (1 forward) and windowed (2) a batch
    check(launches["window_drift"] == oproj(mb * 3 * 32),
          f"window_drift: {launches['window_drift']} launches")
    rep = run("frontier", frontier, common("D") + [
        "--variants", *FRONTIER_LAUNCHES, "--fps_blocks", 2,
        "--fps_calls", 2, "--quality", "--tasks", "VFP", "--max_batches",
        mb, "--dtype", "bfloat16", "--out_dir", work / "frontier"],
        work / "frontier" / "frontier.json")
    fps = {k: r["launches_per_forward"] for k, r in rep["fps"].items()}
    check(fps == {k: oproj(n) for k, n in FRONTIER_LAUNCHES.items()},
          f"frontier launches a forward {fps}, not {FRONTIER_LAUNCHES}")
    want = [oproj(mb * n) for n in FRONTIER_LAUNCHES.values()]
    check(per_call["frontier"] == want,
          f"frontier quality: launches a variant {per_call['frontier']}")
    t0 = time.perf_counter()
    log = _stage1_log(torch, work)
    stage1_s = time.perf_counter() - t0
    rep = run("convergence", convergence_report, [
        log, "--metric", "L1_loss_valid", "--stride", 1, "--device", "cuda",
        "--out", work / "convergence.md"], work / "convergence.json")
    check(rep["epochs"] == 3, f"convergence: {rep['epochs']} epochs")
    run("memory", memory_report, ["--data", 4, "--model", 2, "--device",
                                  "cuda"], None)
    rows = dict(memory_report.rows(4, 2))
    cfg6 = load_config(CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml")
    with torch.device("meta"):
        pred6 = build_predictor(cfg6, torch.bfloat16)
    own6 = memory_report.state_bytes(pred6, 1, 1, fsdp=False, tp=False)
    alloc6 = WORK.get("phase6_allocated")

    print("report tools, wall s: " + json.dumps(
        {k: round(v, 2) for k, v in walls.items()})
          + f" (the stage-1 log's 6 steps: {stage1_s:.1f} s)")
    print(f"kernel launches per evaluate call ({mb} test batches of 8): "
          f"NPVP-D best-of-1 {per_call['quality_D']}, NPVP-S best-of-2 "
          f"{per_call['quality_S']}, exec-mode arms {per_call['fidelity']}, "
          f"frontier variants {per_call['frontier']}; window_drift "
          f"{launches['window_drift']} in {mb} batches")
    print(f"frontier on {nvidia_smi_line()}: " + "; ".join(
        f"{k} {r['fps']:.1f} frames/s ({r['sec_per_batch_min'] * 1e3:.2f} "
        f"ms a batch of 64, speedup {r['speedup_vs_full_median']:.3f}, "
        f"launches a forward {r['launches_per_forward']})"
        for k, r in reports["frontier"]["fps"].items()))
    print(f"memory_report (data 4, model 2): replicated "
          f"{rows['replicated (plain DP)']:.1f} MB (flagship); the same "
          f"count for phase 6's config {own6 / 2 ** 20:.1f} MB; "
          "torch.cuda.memory_allocated after phase 6's train state: "
          + (f"{alloc6 / 2 ** 20:.1f} MB" if alloc6 is not None
             else "phase 6 not run"))
    result = dict(walls=walls, launches=launches, per_call=per_call,
                  frontier_launches=fps, fidelity_gap_db=gap,
                  fidelity_frames=frames,
                  memory_mb=rows, phase6_config_mb=own6 / 2 ** 20,
                  phase6_allocated_mb=(None if alloc6 is None
                                       else alloc6 / 2 ** 20),
                  archives={v: {"mib": a["mib"], "s": a["s"]}
                            for v, a in arch.items()})
    print("reports " + json.dumps(result))
    return result


CKPT_EPOCHS, CKPT_STEPS = 3, 2


def _same_tree(a, b, where=""):
    """The first place where two loaded checkpoints differ (tensors bit
    for bit, with their dtypes and shapes), or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return f"{where}: keys {list(a)[:4]}... vs {list(b)[:4]}..."
        return next((d for k in a if (d := _same_tree(
            a[k], b[k], f"{where}/{k}")) is not None), None)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{where}: {len(a)} vs {len(b)} items"
        return next((d for i, (x, y) in enumerate(zip(a, b)) if (
            d := _same_tree(x, y, f"{where}/{i}")) is not None), None)
    if hasattr(a, "dtype") and hasattr(b, "dtype") and hasattr(a, "shape"):
        import torch

        if a.dtype != b.dtype or a.shape != b.shape:
            return f"{where}: {a.dtype}{tuple(a.shape)} vs {b.dtype}" \
                   f"{tuple(b.shape)}"
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max().item()
            return f"{where}: values differ, max|d| {d:.3e}"
        return None
    return None if a == b else f"{where}: {a!r} vs {b!r}"


def phase_checkpoints(torch, ta):
    """Checkpoints on the card: phase 6's configuration trained a few
    short epochs with a save every epoch, once with the write on the
    training thread (the synchronous comparison arm) and once through the
    asynchronous ``CheckpointManager``."""
    import numpy as np

    from npvp_tpu_torch.core.checkpoint import CheckpointManager
    from npvp_tpu_torch.core.config import load_config
    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    class SyncWrite(CheckpointManager):
        """The synchronous comparison arm: the card's tensors saved while
        the training thread waits."""

        def _to_host(self, tree):
            return tree

        def save(self, step, state, metrics=None):
            t0 = time.perf_counter()
            started = super().save(step, state, metrics)
            self.wait()
            if started:
                self.history[-1]["save_ms"] = (time.perf_counter() - t0) * 1e3
            return started

    tmp = Path(WORK["dir"]) / "checkpoints"
    tmp.mkdir(parents=True, exist_ok=True)
    yaml = CONFIGS / "config_SMMNIST_Unified_NPVP-S.yaml"

    def config(arm):
        return load_config(yaml, [
            "Predictor.exec_mode=pallas", f"Predictor.epochs={CKPT_EPOCHS}",
            "Predictor.ckpt_per_epochs=1",
            f"Predictor.ckpt_save_dir={tmp}/{arm}/ckpt",
            f"Predictor.tensorboard_save_dir={tmp}/{arm}/log",
            f"Dataset.dev_set_size={8 * CKPT_STEPS}",
            "Env.visual_callback=false"])

    t0 = time.perf_counter()
    ae_path = str(s2.write_random_ae(config("sync"), tmp))
    print(f"random AE checkpoint written ({time.perf_counter() - t0:.1f} s)")
    # the two arms must train alike for their files to be compared bit for
    # bit; cuDNN's and cuBLAS's nondeterministic algorithms would part them
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    arms, made = {}, []
    try:
        for arm, cls in (("sync", SyncWrite), ("async", CheckpointManager)):
            t_arm = time.perf_counter()
            cfg = config(arm)
            cfg.Predictor.resume_AE_ckpt = ae_path
            marks, launches = [], []
            clock = [0]

            def on_step(kind, index, metrics):
                torch.cuda.synchronize()
                count = sum(ta.LAUNCHES.values())
                if kind == "eval":
                    launches.append(count - clock[0])
                    if index == CKPT_STEPS - 1:  # the epoch's last step
                        marks.append(time.perf_counter())
                check(np.isfinite(float(metrics[
                    "loss" if kind == "train" else "loss_val"])),
                    f"{arm}: a {kind} loss is not finite")
                clock[0] = sum(ta.LAUNCHES.values())

            def make(*args, **kwargs):
                made.append(cls(*args, **kwargs))
                return made[-1]

            s2.CheckpointManager = make
            reset_launches(ta)
            t0 = time.perf_counter()
            try:
                state = s2.train(cfg, on_step=on_step)
            finally:
                s2.CheckpointManager = CheckpointManager
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = dict(ta.LAUNCHES)
            hist = made[-1].history
            check(len(hist) == CKPT_EPOCHS, f"{arm}: {len(hist)} saves")
            check(all(n == 40 for n in launches),
                  f"{arm}: eval steps launched {launches}, not 40")
            check(total["oproj"] == 40 * len(launches)
                  and total["attn"] == 0, f"{arm}: launches {total}")
            arms[arm] = {
                "save_ms": [h["save_ms"] for h in hist],
                "write_ms": [h["write_ms"] for h in hist],
                "mib": [h["bytes"] / 2 ** 20 for h in hist],
                "epoch_s": [b - a for a, b in zip(marks, marks[1:])],
                "train_s": wall, "eval_launches": launches,
                "steps": [h["step"] for h in hist]}
            if arm == "async":
                last = made[-1].latest_step()
                written = state
            else:
                del state
            torch.cuda.empty_cache()
            arms[arm]["arm_s"] = time.perf_counter() - t_arm
    finally:
        torch.use_deterministic_algorithms(False)
    for arm, r in arms.items():
        print(f"{arm:5s}: save stall {[round(x, 1) for x in r['save_ms']]} "
              f"ms on the training thread, write "
              f"{[round(x, 1) for x in r['write_ms']]} ms, "
              f"{r['mib'][0]:.1f} MiB a file, epochs "
              f"{[round(x, 2) for x in r['epoch_s']]} s after the first, "
              f"{r['train_s']:.1f} s in train() of {r['arm_s']:.1f} s in "
              f"the arm, eval launches "
              f"{r['eval_launches']}")
    sync, asyn = arms["sync"], arms["async"]
    check(sync["steps"] == asyn["steps"], "the arms saved other steps")
    check(statistics.median(asyn["save_ms"])
          < statistics.median(sync["save_ms"]),
          "the asynchronous save stalls the training thread no less")

    # the two arms' files, tensor for tensor
    t0 = time.perf_counter()
    files = {arm: Path(f"{tmp}/{arm}/ckpt") for arm in arms}
    for step in sync["steps"]:
        name = f"step_{step:08d}.pt"
        got, want = (torch.load(files[arm] / name, map_location="cpu",
                                mmap=True) for arm in ("async", "sync"))
        diff = _same_tree(got, want)
        check(diff is None, f"{name}: the arms' files differ at {diff}")
    print(f"files of steps {sync['steps']}: the arms' are equal tensor for "
          f"tensor, bit for bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()

    # the last asynchronous file restored into a fresh state
    cfg = config("async")
    cfg.Predictor.resume_AE_ckpt = ae_path
    dtype = s2.compute_dtype(cfg)
    dev = next(written.model.parameters()).device
    saved = dict(ta.LAUNCHES)
    steps = s2.make_steps(cfg, s2.load_frozen_ae(cfg, dtype, dev),
                          "rand_context", dev)
    batch = steps.place(next(iter(DataModule(cfg).val_loader(
        "rand_context"))))
    want = float(steps.eval(written, batch, Rng(15))["loss_val"])
    fresh = s2.init_predictor_state(
        cfg, build_predictor(cfg, dtype).to(dev), CKPT_STEPS)
    CheckpointManager(files["async"]).restore(fresh, last)
    got = float(steps.eval(fresh, batch, Rng(15))["loss_val"])
    print(f"step {last} restored into a fresh state: eval loss {got!r} vs "
          f"{want!r} from the state that wrote it "
          f"({time.perf_counter() - t0:.1f} s)")
    check(want > 0 and fresh.step == last and got == want,
          "the restored state gives another eval loss (or none to compare)")
    ta.LAUNCHES.update(saved)  # comparison launches are not the path's
    del written, fresh

    # a write that fails in the background surfaces at wait()
    broken = CheckpointManager(tmp / "broken")
    shutil.rmtree(broken.directory)
    broken.directory.write_text("a file where the directory was")
    holder = type("Holder", (), {"state_dict": lambda self: {
        "w": torch.ones(4, device=dev)}})()
    check(broken.save(1, holder), "the broken save did not start")
    try:
        broken.wait()
        raised = None
    except Exception as e:  # whatever the write raised, it surfaced
        raised = e
    print(f"a write into a path that is a file: wait() raised "
          f"{type(raised).__name__}: {raised}")
    check(raised is not None, "the failed background write did not surface")
    broken.close()
    return arms


def phase_layer_norm(torch, ta):
    """The LayerNorm kernel per flagship forward (batch 64 and batch 1,
    bf16): each call shape of one forward timed for the kernel, the twin
    and the library beside its byte bound, summed over the forward."""
    import numpy as np
    import torch.nn.functional as F

    from npvp_tpu_torch.core.config import flagship_config
    from npvp_tpu_torch.kernels import layer_norm as ln
    from npvp_tpu_torch.models.inference import VideoPredictor

    cfg = flagship_config()
    p, d = cfg.Predictor, cfg.Dataset
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                         exec_mode="pallas", device="cuda")
    fn = vp.freeze_task(np.arange(10), np.arange(10, 20))
    result = {}
    for batch in (64, 1):
        gen = torch.Generator(device="cuda").manual_seed(batch)
        frames = torch.rand((batch, 10, d.img_size, d.img_size,
                             d.img_channels), generator=gen,
                            device="cuda") * 2 - 1
        eps = torch.randn((batch, p.max_H, p.max_W, p.embed_dim),
                          generator=gen, device="cuda")
        calls, real = {}, ln.launch

        def recording(x, weight, bias, eps, out_dtype, act="none"):
            key = (x.numel() // weight.numel(), tuple(weight.shape),
                   x.dtype, out_dtype, act, eps)
            calls[key] = calls.get(key, 0) + 1
            return real(x, weight, bias, eps, out_dtype, act)

        ln.launch = recording
        try:
            fn(frames, eps=eps)
            torch.cuda.synchronize()
        finally:
            ln.launch = real
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                     copy_ms=0.0, launches={"hwc": 0, "token": 0},
                     per_call=[])
        for (rows, affine, dtype, out_dtype, act, e), n in calls.items():
            x, w, b = norm_inputs(torch, rows, affine, dtype)
            wl, bl = w.to(dtype), b.to(dtype)
            approx = "tanh" if act == "gelu_tanh" else "none"

            def library():
                y = F.layer_norm(x, affine, wl, bl, e)
                return y if act == "none" else F.gelu(y, approximate=approx)

            saved = dict(ln.LAUNCHES)
            out = torch.empty_like(x)
            with torch.no_grad():
                k_ms = time_graph(torch, lambda: ln.launch(
                    x, w, b, e, out_dtype, act))
                p_ms = time_graph(torch, lambda: ln.layer_norm_plain(
                    x, w, b, e, out_dtype, act), n=5)
                l_ms = time_graph(torch, library)
                c_ms = time_graph(torch, lambda: out.copy_(x))
            ln.LAUNCHES.update(saved)  # timing is not the path's run
            L = w.numel()
            nbytes = rows * L * (x.element_size()
                                 + torch.empty((), dtype=out_dtype)
                                 .element_size()) + 2 * 4 * L
            bound = nbytes / PEAK_BYTES_S * 1e3
            kind = "token" if len(affine) == 1 else "hwc"
            print(f"batch {batch} {kind:5s} {rows} x {affine} "
                  f"{str(dtype)[6:]}->{str(out_dtype)[6:]} act={act}: "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"{l_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB), a copy of x {c_ms:.4f} ms; "
                  f"kernel/bound {k_ms / bound:.2f}, {n}/forward")
            total["launches"][kind] += n
            total["ms"] += n * k_ms
            total["plain_ms"] += n * p_ms
            total["library_ms"] += n * l_ms
            total["bound_ms"] += n * bound
            total["copy_ms"] += n * c_ms
            total["per_call"].append(dict(
                rows=rows, affine=list(affine), act=act, calls=n, ms=k_ms,
                plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                copy_ms=c_ms))
        check(total["launches"] == {"hwc": 60, "token": 66},
              f"batch {batch}: norms {total['launches']}, not 60 + 66")
        print(f"batch {batch}: layer-norm kernel {total['ms']:.3f} ms a "
              f"forward against its byte bound {total['bound_ms']:.3f} ms "
              f"({total['ms'] / total['bound_ms']:.2f}x); plain twin "
              f"{total['plain_ms']:.3f} ms, library {total['library_ms']:.3f}"
              f" ms, copies of the inputs {total['copy_ms']:.3f} ms")
        result[f"b{batch}"] = total
    print("layer_norm " + json.dumps({k: {key: v[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "copy_ms", "launches")}
        for k, v in result.items()}))
    return result


def _nonlocal_calls(torch, fn):
    """The non-local attention kernel's calls as ``fn`` makes them: each
    call's ``qkv`` (a copy) and ``attn_dim``."""
    from npvp_tpu_torch.kernels import nonlocal_attention as nla

    calls, real = [], nla.launch

    def recording(qkv, attn_dim):
        calls.append((qkv.clone(), attn_dim))
        return real(qkv, attn_dim)

    nla.launch = recording
    try:
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
    finally:
        nla.launch = real
    return calls


def _nonlocal_library(torch, qkv, a):
    """The library's attention on the kernel's input, as a yardstick the
    port never calls: ``F.scaled_dot_product_attention`` with scale 1 on q
    and the 2x2-pooled k and v; (N, H, W, dv)."""
    import torch.nn.functional as F

    from npvp_tpu_torch.kernels import nonlocal_attention as nla

    N, H, W, C3 = qkv.shape
    dv, keys = C3 - 2 * a, (H // 2) * (W // 2)
    q = qkv[..., :a].reshape(N, 1, H * W, a)
    k = nla.max_pool_2x2(qkv[..., a:2 * a]).reshape(N, 1, keys, a)
    v = nla.max_pool_2x2(qkv[..., 2 * a:]).reshape(N, 1, keys, dv)
    return F.scaled_dot_product_attention(q, k, v, scale=1.0).reshape(
        N, H, W, dv)


def _nonlocal_twin(torch, qkv, a):
    """The twin with its P·V summed in fp32 (cuBLAS' reduced-precision bf16
    reductions off), as the CUDA tests' bound assumes."""
    from npvp_tpu_torch.kernels import nonlocal_attention as nla

    mm = torch.backends.cuda.matmul
    flag = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        return nla.nonlocal_attention_plain(qkv, a)
    finally:
        mm.allow_bf16_reduced_precision_reduction = flag


def _nonlocal_gap(torch, got, want, qkv, a):
    """(largest |got - want| over its image's max|v|, share of elements
    beyond 2^-6 of it): the CUDA tests' measure. Where the kernel and the
    twin round the same bf16 logits they differ by at most 2^-6·max|v| (the
    one reordering: the kernel divides the P·V sum by the row sum where the
    twin rounds each divided weight)."""
    vmax = qkv[..., 2 * a:].float().abs().amax(dim=(1, 2, 3))[
        :, None, None, None]
    rel = (got.float() - want.float()).abs() / vmax
    return float(rel.max()), float((rel > 2 ** -6).float().mean())


def _nonlocal_timing(torch, calls, what):
    """Each call of a forward timed for the kernel (CUDA-graph replays),
    its twin, and the library (SDPA with scale 1 on the pooled k and v,
    which the port never calls), beside its bound (bytes: qkv read and the
    output written once; FLOPs: Q·K^T and P·V); the kernel held to its
    twin by the CUDA tests' tolerance (at most 1e-3 of the elements beyond
    2^-6·max|v| of their image, none beyond 0.1·max|v|: tensor cores and
    cuBLAS sum the logits in other orders, and a rare logit rounds to the
    neighbouring bf16 value), the library's gap read beside it; summed
    over the forward."""
    from npvp_tpu_torch.kernels import nonlocal_attention as nla

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 launches=0, max_abs=0.0, max_rel=0.0, share_over=0.0,
                 library_max_rel=0.0, library_share_over=0.0, per_call=[])
    for qkv, a in calls:
        N, H, W, C3 = qkv.shape
        dv, keys = C3 - 2 * a, (H // 2) * (W // 2)
        saved = dict(nla.LAUNCHES)
        with torch.no_grad():
            got = nla.launch(qkv, a)
            want = _nonlocal_twin(torch, qkv, a)
            lib = _nonlocal_library(torch, qkv, a)
            gap = float((got.float() - want.float()).abs().max())
            vmax = float(qkv[..., 2 * a:].float().abs().max())
            rel, over = _nonlocal_gap(torch, got, want, qkv, a)
            lib_rel, lib_over = _nonlocal_gap(torch, lib, want, qkv, a)
            del got, want, lib
            k_ms = time_graph(torch, lambda: nla.launch(qkv, a))
            p_ms = time_call(torch, lambda: nla.nonlocal_attention_plain(
                qkv, a), n=3)
            l_ms = time_call(torch, lambda: _nonlocal_library(torch, qkv, a),
                             n=10)
        nla.LAUNCHES.clear()
        nla.LAUNCHES.update(saved)  # timing is not the path's run
        nbytes = N * H * W * (C3 + dv) * 2
        flops = 2 * N * H * W * keys * (a + dv)
        bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["bfloat16"])
        bound *= 1e3
        print(f"{what} {N} x {H}x{W} (a {a}, dv {dv}, {keys} keys): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.1f} GFLOP), kernel/bound {k_ms / bound:.2f}, "
              f"{N * H * W * keys / 1e9:.3f} G logits; max|d| to the twin "
              f"{gap:.3e} (max|v| {vmax:.3g}); over its image's max|v|: "
              f"kernel max {rel:.3e}, share beyond 2^-6 {over:.2e}; "
              f"library max {lib_rel:.3e}, share beyond 2^-6 {lib_over:.2e}")
        check(over <= 1e-3 and rel <= 0.1,
              f"{what} {H}x{W}: the kernel is off its twin by up to "
              f"{rel:.3e} of max|v| ({over:.2e} of the elements beyond "
              f"2^-6): tolerance 1e-3 beyond 2^-6, none beyond 0.1")
        total["launches"] += 1
        total["ms"] += k_ms
        total["plain_ms"] += p_ms
        total["library_ms"] += l_ms
        total["bound_ms"] += bound
        total["max_abs"] = max(total["max_abs"], gap)
        total["max_rel"] = max(total["max_rel"], rel)
        total["share_over"] = max(total["share_over"], over)
        total["library_max_rel"] = max(total["library_max_rel"], lib_rel)
        total["library_share_over"] = max(total["library_share_over"],
                                          lib_over)
        total["per_call"].append(dict(
            shape=[N, H, W, C3], attn_dim=a, ms=k_ms, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=bound, max_abs=gap, max_v=vmax,
            max_rel=rel, share_over=over, library_max_rel=lib_rel,
            library_share_over=lib_over))
    print(f"{what}: non-local kernel {total['ms']:.3f} ms against its bound "
          f"{total['bound_ms']:.3f} ms; plain twin {total['plain_ms']:.3f} "
          f"ms, library {total['library_ms']:.3f} ms; max|d| "
          f"{total['max_abs']:.3e}; over max|v|: kernel "
          f"{total['max_rel']:.3e}, library {total['library_max_rel']:.3e}")
    return total


def _nonlocal_exact(torch):
    """The rounding contract where it bites: q and k on a grid of quarters
    (every logit exact in fp32, whatever the order of its sums) at the four
    levels of the AEs (6 images each), so that rows reach |logit| >= 50,
    where one bf16 ulp of a logit moves its weight by ~28 %. The kernel
    rounds the same logits as its twin and stays within 2^-6·max|v| of it
    element for element; the library (fp32 logits) is read beside it."""
    from npvp_tpu_torch.kernels import nonlocal_attention as nla

    out = []
    gen = torch.Generator(device="cuda").manual_seed(23)
    for H, C in ((64, 64), (32, 128), (16, 256), (8, 512)):
        a, dv = C // 8, C // 2
        q = torch.randint(-24, 25, (6, H, H, a), generator=gen,
                          device="cuda") / 4
        k = torch.randint(-8, 9, (6, H, H, a), generator=gen,
                          device="cuda") / 4
        v = torch.randn((6, H, H, dv), generator=gen, device="cuda")
        qkv = torch.cat([q, k, v], -1).to(torch.bfloat16)
        with torch.no_grad():
            reach = float(torch.einsum(
                "nhwa,nija->nhwij", qkv[:1, ..., :a].float(),
                nla.max_pool_2x2(qkv[:1, ..., a:2 * a]).float()).abs().max())
            want = _nonlocal_twin(torch, qkv, a)
            rel, over = _nonlocal_gap(torch, nla.launch(qkv, a), want, qkv,
                                      a)
            lib_rel, lib_over = _nonlocal_gap(
                torch, _nonlocal_library(torch, qkv, a), want, qkv, a)
        print(f"exact logits {H}x{H} (a {a}, dv {dv}), max|logit| {reach:g}: "
              f"over max|v|, kernel max {rel:.3e} (share beyond 2^-6 "
              f"{over:.2e}), library max {lib_rel:.3e} (share beyond 2^-6 "
              f"{lib_over:.2e})")
        check(reach >= 50, f"exact logits {H}x{H} reach only {reach}")
        check(rel <= 2 ** -6, f"exact logits {H}x{H}: the kernel is off its "
              f"twin by {rel:.3e} of max|v|, beyond 2^-6")
        out.append(dict(H=H, channels=C, max_logit=reach, max_rel=rel,
                        library_max_rel=lib_rel,
                        library_share_over=lib_over))
    return out


def _nonlocal_encode_paths(torch, clips):
    """A Cityscapes encode (``clips`` x 2 frames at 128²) on the kernel
    path, the twin path and the library in the kernel's place, each against
    the fp32 encode on the same weights (random, with the attentions' gates
    open and their batch statistics away from their init, so that the
    attentions reach the output), by relative norm; held as the CUDA tests
    hold it: the kernel path no further from fp32 than the twin path
    within a quarter, and within twice that of the twin path."""
    from npvp_tpu_torch.kernels import nonlocal_attention as nla
    from npvp_tpu_torch.nn import resnet_ae as tae
    from npvp_tpu_torch.tools.weights import random_init

    cfg = smoke_config("Cityscapes_VFP_NPVP-S", ["Predictor.exec_mode=pallas"])
    d = cfg.Dataset
    ae32 = random_init(tae.build_ae(cfg, torch.float32), 11)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in ae32.modules():
            if isinstance(m, tae.NonLocalAttention2D):
                m.gamma.fill_(0.5)
                c = m.bn.running_mean.numel()
                m.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.bn.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    ae16 = tae.build_ae(cfg, torch.bfloat16)
    ae16.load_state_dict(ae32.state_dict())
    ae16, ae32 = (m.to("cuda").eval().requires_grad_(False)
                  for m in (ae16, ae32))
    modules = [m for m in ae16.modules()
               if isinstance(m, tae.NonLocalAttention2D)]
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand((clips, 2, d.img_size, d.img_size, d.img_channels),
                   generator=gen, device="cuda") * 2 - 1
    mm = torch.backends.cuda.matmul
    flag = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    real = nla.launch
    try:
        with torch.no_grad():
            paths = {"kernel": ae16.encode(x).float()}
            for m in modules:
                m.exec_mode = "xla"
            paths["twin"] = ae16.encode(x).float()
            for m in modules:
                m.exec_mode = "pallas"
            nla.launch = lambda qkv, a: _nonlocal_library(torch, qkv, a)
            paths["library"] = ae16.encode(x).float()
            nla.launch = real
            exact = ae32.encode(x)
    finally:
        nla.launch = real
        mm.allow_bf16_reduced_precision_reduction = flag

    def rel(u, w):
        return float((u - w).norm() / w.norm())

    errs = {k: rel(v, exact) for k, v in paths.items()}
    kt = rel(paths["kernel"], paths["twin"])
    print(f"Cityscapes encode ({clips} x 2 frames, gates open) against fp32, "
          f"relative norm: kernel path {errs['kernel']:.4e}, twin path "
          f"{errs['twin']:.4e}, library in the kernel's place "
          f"{errs['library']:.4e}; kernel path against twin path {kt:.4e}, "
          f"library against twin path "
          f"{rel(paths['library'], paths['twin']):.4e}")
    check(errs["kernel"] <= 1.25 * errs["twin"] + 1e-4,
          f"the kernel path's encode is {errs['kernel']:.4e} from fp32, the "
          f"twin path's {errs['twin']:.4e}")
    check(kt < 2 * errs["twin"] + 1e-4,
          f"the kernel path's encode is {kt:.4e} from the twin path's")
    return dict(rel_to_fp32=errs, kernel_to_twin=kt,
                library_to_twin=rel(paths["library"], paths["twin"]))


def phase_nonlocal(torch, ta):
    """The non-local attention kernel at the main path's shapes: its calls
    in a Cityscapes window's encode (128 clips x 2 frames) and in a KTH
    batch-64 forward, held to the twin and timed against it, the library
    and the bound; the rounding contract at exact logits that reach |50|;
    a Cityscapes encode with open gates on the kernel path held against
    the twin path and fp32; a Cityscapes window's encode on the kernel and
    the twin path (ms, peak memory); no launch in a SMMNIST Unified NPVP-S train step as its YAML
    stands (exec_mode xla)."""
    import numpy as np

    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.kernels import nonlocal_attention as nla
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.nn.resnet_ae import NonLocalAttention2D
    from npvp_tpu_torch.train import stage2_predictor as s2

    result = {}
    cfg = smoke_config("Cityscapes_VFP_NPVP-S", ["Predictor.exec_mode=pallas"])
    d = cfg.Dataset
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    frames = torch.rand((128, 2, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device="cuda") * 2 - 1
    nla.LAUNCHES.clear()
    calls = _nonlocal_calls(torch, lambda: vp.ae.encode(frames))
    window = dict(nla.LAUNCHES)
    print(f"Cityscapes window encode (128 x 2 frames): launches {window}")
    check(window == {4096: 1, 1024: 1, 256: 1, 64: 3},
          f"a Cityscapes window's encode made {window}, not 6 calls")
    result["cityscapes"] = _nonlocal_timing(torch, calls, "Cityscapes")
    result["cityscapes"]["launches_per_window"] = sum(window.values())
    del calls
    result["exact_logits"] = _nonlocal_exact(torch)
    result["encode_paths"] = _nonlocal_encode_paths(torch, 16)
    modules = [m for m in vp.ae.modules()
               if isinstance(m, NonLocalAttention2D)]
    encode = {}
    for mode in ("pallas", "xla", "pallas", "xla"):
        for m in modules:
            m.exec_mode = mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            ms = time_call(torch, lambda: vp.ae.encode(frames), n=5)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        encode.setdefault(mode, []).append((ms, peak))
    for mode, runs in encode.items():
        print(f"Cityscapes window encode on the "
              f"{'kernel' if mode == 'pallas' else 'twin'} path: "
              f"{[round(ms, 3) for ms, _ in runs]} ms, peak above the "
              f"weights {[round(g, 3) for _, g in runs]} GiB")
    result["cityscapes"]["encode_ms"] = {
        ("kernel" if k == "pallas" else "twin"): min(ms for ms, _ in v)
        for k, v in encode.items()}
    result["cityscapes"]["encode_peak_gib"] = {
        ("kernel" if k == "pallas" else "twin"): max(g for _, g in v)
        for k, v in encode.items()}
    del vp, modules
    torch.cuda.empty_cache()

    cfg = smoke_config("KTH_Unified_NPVP-S", ["Predictor.exec_mode=pallas"])
    p, d = cfg.Predictor, cfg.Dataset
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                         device="cuda")
    fn = vp.freeze_task(np.arange(10), np.arange(10, 20))
    frames = torch.rand((64, 10, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device="cuda") * 2 - 1
    eps = torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                      device="cuda")
    nla.LAUNCHES.clear()
    calls = _nonlocal_calls(torch, lambda: fn(frames, eps=eps))
    forward = dict(nla.LAUNCHES)
    print(f"KTH forward (batch 64, 10 -> 10): launches {forward}")
    check(forward == {1024: 1, 256: 1, 64: 2},
          f"a KTH forward made {forward}, not 4 calls")
    result["kth"] = _nonlocal_timing(torch, calls, "KTH")
    result["kth"]["launches_per_forward"] = sum(forward.values())
    del calls, vp, fn
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke_config("SMMNIST_Unified_NPVP-S", [
            f"Predictor.ckpt_save_dir={tmp}/ckpt",
            f"Predictor.tensorboard_save_dir={tmp}/log",
            "Dataset.dev_set_size=8"])
        cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp))
        dtype, dev = s2.compute_dtype(cfg), torch.device("cuda")
        ae = s2.load_frozen_ae(cfg, dtype, dev)
        steps = s2.make_steps(cfg, ae, "rand_context", dev)
        state = s2.init_predictor_state(
            cfg, build_predictor(cfg, dtype).to(dev), 1)
        batch = steps.place(next(iter(DataModule(cfg).train_loader(
            "rand_context"))))
        before = sum(nla.LAUNCHES.values())
        steps.train(state, batch, Rng(1))
        torch.cuda.synchronize()
        train = sum(nla.LAUNCHES.values()) - before
    print(f"SMMNIST Unified NPVP-S train step (exec_mode "
          f"{cfg.Predictor.exec_mode}): {train} non-local launches")
    check(train == 0, f"a SMMNIST train step made {train} non-local calls")
    result["smmnist_train_step_launches"] = train
    print("nonlocal " + json.dumps({
        **{k: {key: result[k][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs", "max_rel",
            "share_over", "library_max_rel", "library_share_over",
            "launches")} for k in ("cityscapes", "kth")},
        "exact_logits": result["exact_logits"],
        "encode_paths": result["encode_paths"]}))
    return result


def _head_calls(torch, fn):
    """The decoder-tail kernel's calls as ``fn`` makes them: each call's
    arguments (``y`` copied)."""
    from npvp_tpu_torch.kernels import decoder_head as dh

    calls, real = [], dh.launch

    def recording(y, *args):
        calls.append((y.clone(), *args))
        return real(y, *args)

    dh.launch = recording
    try:
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
    finally:
        dh.launch = real
    return calls


def _head_gap(torch, got, call):
    """(largest |kernel - twin|, largest gap over the CUDA tests' bound
    2^-7·(|c| + |v|) + 2^-8 + 2^-12, share of elements not bit-equal):
    ``c`` the twin's rounded convolution, ``v`` = c + bias rounded; a
    quarter of the frames at a time, for the twin's temporaries."""
    import torch.nn.functional as F

    from npvp_tpu_torch.kernels import decoder_head as dh

    y, a, b, w, c, act = call
    step = max(1, y.shape[0] // 4)
    gap = ratio = unequal = 0.0
    for s in range(0, y.shape[0], step):
        part = (y[s:s + step], a, b, w, c, act)
        x = dh.reflect_pad_2d(torch.relu(part[0] * a + b), 3)
        conv = F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
        v = (conv + c).float()
        d = (got[s:s + step].float()
             - dh.decoder_head_plain(*part).float()).abs()
        bound = 2 ** -7 * (conv.float().abs() + v.abs()) + 2 ** -8 + 2 ** -12
        gap = max(gap, float(d.max()))
        ratio = max(ratio, float((d / bound).max()))
        unequal += float((d > 0).float().sum())
    return gap, ratio, unequal / got.numel()


def _head_timing(torch, call, what):
    """One call of the kernel held to its twin by the CUDA tests' bound and
    timed (CUDA-graph replays) beside its bound (bytes: y read and the
    output written once; FLOPs of the 7x7 head), the plain twin (the former
    eager tail) and the library: cuDNN's convolution alone on the padded
    input, which the port no longer calls."""
    import torch.nn.functional as F

    from npvp_tpu_torch.kernels import decoder_head as dh

    y, a, b, w, c, act = call
    N, H, W, C = y.shape
    co = w.shape[0]
    saved = dict(dh.LAUNCHES)
    with torch.no_grad():
        gap, ratio, unequal = _head_gap(torch, dh.launch(*call), call)
        k_ms = time_graph(torch, lambda: dh.launch(*call))
        p_ms = time_call(torch, lambda: dh.decoder_head_plain(*call), n=5)
        xp = dh.reflect_pad_2d(torch.relu(y * a + b), 3).permute(0, 3, 1, 2)
        l_ms = time_call(torch, lambda: F.conv2d(xp, w, c), n=5)
        del xp
    dh.LAUNCHES.clear()
    dh.LAUNCHES.update(saved)  # timing is not the path's run
    nbytes = N * H * W * (C + co) * 2
    flops = 2 * N * H * W * C * co * 49
    bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["bfloat16"])
    print(f"{what} {N} x {H}x{W}, {C} -> {co} ({act}): kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, library (cuDNN conv alone) {l_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB, "
          f"{flops / 1e12:.3f} TFLOP), kernel/bound {k_ms / bound:.2f}; "
          f"max|d| to the twin {gap:.3e}, largest gap over its bound "
          f"{ratio:.3f}, share not bit-equal {unequal:.2e}")
    check(ratio <= 1.0, f"{what}: the kernel is off its twin by {ratio:.3f} "
          "of the CUDA tests' bound")
    return dict(shape=[N, H, W, C, co], out_layer=act, ms=k_ms,
                plain_ms=p_ms, library_ms=l_ms, bound_ms=bound, max_abs=gap,
                gap_over_bound=ratio, share_unequal=unequal)


def _perturb_tail(torch, decoder, seed):
    """Every BatchNorm's running statistics and the head's bias away from
    their init values."""
    from npvp_tpu_torch.nn.layers import BatchNorm

    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in decoder.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g,
                                                       device="cuda"))
                m.running_var.copy_(1 + 0.2 * torch.rand(c, generator=g,
                                                         device="cuda"))
        h = decoder.head.bias
        h.copy_(0.2 * torch.randn(h.shape, generator=g, device="cuda"))


def phase_decoder_head(torch, ta):
    """The decoder-tail kernel at the main path's shapes: its call in a
    Cityscapes window's decode (128 clips x 10 frames; three a request) and
    in a KTH batch-64 forward, held to the twin and timed against it, the library
    and the bound; a window's decode on the kernel and the twin path (ms,
    peak memory, profiled kernels); no launch in a SMMNIST Unified NPVP-S
    train step as its YAML stands (exec_mode xla)."""
    import numpy as np

    from npvp_tpu_torch.data.loader import DataModule
    from npvp_tpu_torch.kernels import decoder_head as dh
    from npvp_tpu_torch.models.inference import VideoPredictor
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.train import stage2_predictor as s2

    result = {}
    cfg = smoke_config("Cityscapes_VFP_NPVP-S", ["Predictor.exec_mode=pallas"])
    p = cfg.Predictor
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                         device="cuda")
    dec = vp.ae.decoder
    _perturb_tail(torch, dec, 18)
    gen = torch.Generator(device="cuda").manual_seed(18)
    feats = torch.relu(torch.randn((128, 10, p.max_H, p.max_W, p.embed_dim),
                                   generator=gen, device="cuda"))
    dh.LAUNCHES.clear()
    calls = _head_calls(torch, lambda: vp.ae.decode(feats))
    window = dict(dh.LAUNCHES)
    print(f"Cityscapes window decode (128 x 10 frames): launches {window}; "
          f"y contiguous as the decoder hands it: "
          f"{calls[0][0].is_contiguous()}")
    check(window == {128 * 128: 1},
          f"a Cityscapes window's decode made {window}, not 1 call")
    result["cityscapes"] = _head_timing(torch, calls[0], "Cityscapes")
    result["cityscapes"]["launches_per_window"] = sum(window.values())
    del calls
    frames = torch.rand((128, 2, 128, 128, 3), generator=gen,
                        device="cuda") * 2 - 1
    eps = [torch.randn((128, p.max_H, p.max_W, p.embed_dim), generator=gen,
                       device="cuda") for _ in range(3)]
    dh.LAUNCHES.clear()
    with torch.no_grad():
        vp.vfp(frames, 28, eps=eps)
    torch.cuda.synchronize()
    request = dict(dh.LAUNCHES)
    print(f"Cityscapes request (128 clips, 2 -> 28, three windows): "
          f"launches {request}")
    check(request == {128 * 128: 3},
          f"a Cityscapes request made {request}, not 3 calls")
    result["cityscapes"]["launches_per_request"] = sum(request.values())
    del frames, eps
    decode = {}
    for mode in ("pallas", "xla", "pallas", "xla"):
        dec.exec_mode = mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            ms = time_call(torch, lambda: vp.ae.decode(feats), n=5)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        decode.setdefault(mode, []).append((ms, peak))
    for mode, runs in decode.items():
        print(f"Cityscapes window decode on the "
              f"{'kernel' if mode == 'pallas' else 'twin'} path: "
              f"{[round(ms, 3) for ms, _ in runs]} ms, peak above the "
              f"weights {[round(g, 3) for _, g in runs]} GiB")
    result["cityscapes"]["decode_ms"] = {
        ("kernel" if k == "pallas" else "twin"): min(ms for ms, _ in v)
        for k, v in decode.items()}
    result["cityscapes"]["decode_peak_gib"] = {
        ("kernel" if k == "pallas" else "twin"): max(g for _, g in v)
        for k, v in decode.items()}
    for mode in ("xla", "pallas"):
        dec.exec_mode = mode
        with torch.no_grad():
            profile(torch, lambda: vp.ae.decode(feats),
                    f"Cityscapes window decode, "
                    f"{'kernel' if mode == 'pallas' else 'twin'} path")
    del vp, dec, feats
    torch.cuda.empty_cache()

    cfg = smoke_config("KTH_Unified_NPVP-S", ["Predictor.exec_mode=pallas"])
    p, d = cfg.Predictor, cfg.Dataset
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16, seed=0,
                                         device="cuda")
    _perturb_tail(torch, vp.ae.decoder, 19)
    fn = vp.freeze_task(np.arange(10), np.arange(10, 20))
    frames = torch.rand((64, 10, d.img_size, d.img_size, d.img_channels),
                        generator=gen, device="cuda") * 2 - 1
    eps = torch.randn((64, p.max_H, p.max_W, p.embed_dim), generator=gen,
                      device="cuda")
    dh.LAUNCHES.clear()
    calls = _head_calls(torch, lambda: fn(frames, eps=eps))
    forward = dict(dh.LAUNCHES)
    print(f"KTH forward (batch 64, 10 -> 10): launches {forward}")
    check(forward == {64 * 64: 1}, f"a KTH forward made {forward}, not 1")
    result["kth"] = _head_timing(torch, calls[0], "KTH")
    result["kth"]["launches_per_forward"] = sum(forward.values())
    del calls, vp, fn
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke_config("SMMNIST_Unified_NPVP-S", [
            f"Predictor.ckpt_save_dir={tmp}/ckpt",
            f"Predictor.tensorboard_save_dir={tmp}/log",
            "Dataset.dev_set_size=8"])
        cfg.Predictor.resume_AE_ckpt = str(s2.write_random_ae(cfg, tmp))
        dtype, dev = s2.compute_dtype(cfg), torch.device("cuda")
        ae = s2.load_frozen_ae(cfg, dtype, dev)
        steps = s2.make_steps(cfg, ae, "rand_context", dev)
        state = s2.init_predictor_state(
            cfg, build_predictor(cfg, dtype).to(dev), 1)
        batch = steps.place(next(iter(DataModule(cfg).train_loader(
            "rand_context"))))
        before = sum(dh.LAUNCHES.values())
        steps.train(state, batch, Rng(1))
        torch.cuda.synchronize()
        train = sum(dh.LAUNCHES.values()) - before
    print(f"SMMNIST Unified NPVP-S train step (exec_mode "
          f"{cfg.Predictor.exec_mode}): {train} decoder-tail launches")
    check(train == 0, f"a SMMNIST train step made {train} decoder-tail calls")
    result["smmnist_train_step_launches"] = train
    print("decoder_head " + json.dumps(result))
    return result


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", help="comma-separated phase numbers "
                        "(1-18) for a short check; the default runs all and "
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
              ("chain: stage 2, evaluation, serving", phase_chain),
              ("data layer and new models", phase_data_models),
              ("serving options and tools", phase_serving_tools),
              ("parallelism", phase_parallel),
              ("sequence and pipeline parallelism, dry run, GAN",
               phase_sequence_pipeline),
              ("SMMNIST stream, config generator", phase_smmnist_stream),
              ("report tools", phase_reports),
              ("checkpoints", phase_checkpoints),
              ("layer-norm kernel", phase_layer_norm),
              ("non-local attention kernel", phase_nonlocal),
              ("decoder-tail kernel", phase_decoder_head)]
    if picked is not None:
        phases = [ph for i, ph in enumerate(phases, 1) if i in picked]
    WORK["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    seconds = {}
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
            seconds[name] = round(time.perf_counter() - t0, 1)
            print(f"-- {name}: ok ({seconds[name]:.1f} s)", flush=True)
    finally:
        shutil.rmtree(WORK["dir"], ignore_errors=True)
    print(f"\nchip_smoke: all phases ok in "
          f"{time.perf_counter() - t_start:.1f} s")
    print("phase seconds " + json.dumps(seconds))
    if picked is not None:
        return 0  # a short check: no record, no result line

    worst = results["kernel vs plain"]
    launches, _ = results["flagship serving"]
    per_forward = results["per-call timing"]["forward"]
    per_eval = results["per-call timing"]["eval_step"]
    per_city = results["per-call timing"]["eval_step_cityscapes"]
    training = results["stage-2 training"]
    new = results["data layer and new models"]
    tools = results["serving options and tools"]
    par = results["parallelism"]
    sp_pp = results["sequence and pipeline parallelism, dry run, GAN"]
    two12 = sp_pp["two_ranks"]
    stream = results["SMMNIST stream, config generator"]
    reports = results["report tools"]
    ckpts = results["checkpoints"]
    replaces = {"oproj": "npvp_tpu/kernels/temporal_attention.py:136",
                "attn": "npvp_tpu/kernels/temporal_attention.py:127"}
    kernels = []
    for v in ("oproj", "attn"):
        acc = per_forward[v]
        kernels.append({
            "name": f"temporal_attention[{v}]", "route": "cuda",
            "source": "npvp_tpu_torch/kernels/csrc/temporal_attention.cu",
            "replaces": replaces[v], "launches": launches["kernel_oproj"][v],
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
            "eval_step_cityscapes": {
                **{k: per_city[v][k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms")},
                "times": "per Cityscapes VFP NPVP-S eval step (batch 8, "
                         "2 -> 10): the sum over its 40 calls, bf16"},
            "launches_phase9": {
                "kth_train": new["kth"]["launches"][v],
                "cityscapes_vfp_train": new["cityscapes"]["vfp"][
                    "launches"][v],
                "cityscapes_evaluate_2_to_28": (
                    new["cityscapes"]["evaluate"]["launches"]
                    if v == "oproj" else 0)},
            "launches_phase10": {
                "served_bundle_chunk": (tools["export"]["launches_per_chunk"]
                                        if v == "oproj" else 0),
                "int8_forward": tools["int8"]["launches"]["int8"][v]},
            "launches_phase11": {
                "tp_shards": (par["tp_shards"]["launches"]
                              if v == "oproj" else 0),
                "eval_step_one_rank": {
                    arm: (par["one_rank"][arm]["eval_launches"][0]
                          if v == "oproj" else 0)
                    for arm in ("plain", "ddp", "fsdp")},
                "sharded_serving_forward_per_rank": {
                    tag: r["launches"][v] for tag, r in
                    par["two_ranks"]["gloo"]["serving"].items()}},
            "tp_shards": ({k: {"shard_ms": r["shard_ms"],
                               "full_ms": r["full_ms"]}
                           for k, r in par["tp_shards"].items()
                           if k != "launches"} if v == "oproj" else None),
            "launches_phase12": {
                "sp_serving_forward_per_rank":
                    two12["serving"]["launches"][v],
                "sp_eval_step_per_rank":
                    two12["training"]["model2_sp"]["eval_launches"][v],
                "gpipe_call_per_rank": two12["gpipe"]["launches"][v],
                "gan_eval_step": sp_pp["gan"]["eval_launches"][v]},
            "launches_phase13": {
                "smmnist_stream_eval_steps": stream["eval"]["launches"][v]},
            "launches_phase14": {
                "evaluate_call_npvp_d":
                    reports["per_call"]["quality_D"][0][v],
                "evaluate_call_npvp_s_best_of_2":
                    reports["per_call"]["quality_S"][0][v],
                "evaluate_call_pallas_arm":
                    reports["per_call"]["fidelity"][2][v],
                "frontier_forward": {
                    k: r[v] for k, r in reports["frontier_launches"].items()},
                "window_drift_2_batches":
                    reports["launches"]["window_drift"][v]},
            "launches_phase15": {
                f"eval_step_{arm}_save": (r["eval_launches"][0]
                                          if v == "oproj" else 0)
                for arm, r in ckpts.items()},
            "sp_shards": ({k: {key: r[key] for key in
                               ("ms", "plain_ms", "full_ms", "max_abs")}
                           for k, r in sp_pp["sp_kernel"].items()}
                          if v == "oproj" else None),
            "times": "per flagship forward: the sum over its 32 calls, bf16",
            "per_call": acc["per_call"]})
    norms = results["layer-norm kernel"]
    kernels.append({
        "name": "layer_norm", "route": "cuda",
        "source": "npvp_tpu_torch/kernels/csrc/layer_norm.cu",
        "replaces": None, "launches": norms["b64"]["launches"],
        "max_abs_err": worst["layer_norm"],
        **{k: norms["b64"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms")},
        "bound_by": "bytes",
        "batch_1": {k: norms["b1"][k] for k in ("ms", "plain_ms",
                                                "bound_ms", "library_ms")},
        "times": "per flagship forward: the sum over its 126 calls, bf16",
        "per_call": norms["b64"]["per_call"]})
    nl = results["non-local attention kernel"]
    city, kth = nl["cityscapes"], nl["kth"]
    kernels.append({
        "name": "nonlocal_attention", "route": "cuda",
        "source": "npvp_tpu_torch/kernels/csrc/nonlocal_attention.cu",
        "replaces": None, "launches": city["launches_per_window"],
        "max_abs_err": max(city["max_abs"], kth["max_abs"]),
        **{k: city[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "encode_ms": city["encode_ms"],
        "encode_peak_gib": city["encode_peak_gib"],
        "kth_forward": {"launches": kth["launches_per_forward"],
                        **{k: kth[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")}},
        "smmnist_train_step_launches":
            nl["smmnist_train_step_launches"],
        "exact_logits": nl["exact_logits"],
        "encode_paths": nl["encode_paths"],
        "times": "per Cityscapes window's encode (128 clips x 2 frames): "
                 "the sum over its 6 calls, bf16",
        "per_call": city["per_call"] + kth["per_call"]})
    tail = results["decoder-tail kernel"]
    city, kth = tail["cityscapes"], tail["kth"]
    kernels.append({
        "name": "decoder_head", "route": "cuda",
        "source": "npvp_tpu_torch/kernels/csrc/decoder_head.cu",
        "replaces": None, "launches": city["launches_per_window"],
        "max_abs_err": max(city["max_abs"], kth["max_abs"]),
        **{k: city[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "decode_ms": city["decode_ms"],
        "decode_peak_gib": city["decode_peak_gib"],
        "kth_forward": {"launches": kth["launches_per_forward"],
                        **{k: kth[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")}},
        "smmnist_train_step_launches": tail["smmnist_train_step_launches"],
        "times": "per Cityscapes window's decode (128 clips x 10 frames): "
                 "its one call, bf16"})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]) if os.environ.get(CHILD_ENV)
             else supervise(sys.argv[1:]))
