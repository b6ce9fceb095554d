"""The multi-card dry run (port of ``dryrun_multichip`` in
``__graft_entry__.py``): on ``n`` ranks, one stage-2 train step of the
flagship's widths and depth over a data × model mesh with sequence
parallelism and FSDP, then the serving path on the same mesh, then GPipe
over the 8 decoder blocks.

    python -m npvp_tpu_torch.tools.dryrun_multichip [--n 8] [--device cpu]

Ranks use card ``rank % device_count`` (gloo when ranks share a card or run
on the CPU, NCCL when each rank has a card of its own) and join one group
through a file in a temporary directory. Rank 0 prints one OK line per
part:

- train: KTH Unified NPVP-S at embed 512, 8 heads, 8 + 4 layers, bf16,
  with 32×32 frames, T 4, ``max_H``/``max_W`` 4 and a global batch of 2n,
  on data n/2 × model 2 (n even and ≥ 4; else data n), one rand-context
  step with ``Env.sequence_parallel`` and ``Env.fsdp``: a finite loss. At
  ``max_H`` 4 and model 2 each shard holds 2 rows of a 4-row window;
- serving: ``VideoPredictor.shard(mesh)`` → ``freeze_task(arange(2),
  arange(2, 4))`` → predict inside ``sequence_parallel(mesh)``: shape and
  finite;
- pipeline (n ≥ 4 and n/2 stages dividing the 8 blocks): the decoder's 8
  blocks at n/2 stages × data 2 over 2 microbatches against the
  sequential stack on every rank.

``embed_dim`` (a multiple of 128) narrows the widths for a quick run on
the CPU: ngf, the EventEncoder's and the FFN's widths and the number of
heads (of 64, what the bf16 kernel takes) with it.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def dryrun_config(n: int, embed_dim: int = 512):
    """The flagship's widths and depth (embed 512, 8 heads, 8 + 4 layers)
    in bf16, with 32×32 frames, T 4, ``max_H``/``max_W`` 4 and batch 2n:
    ``__graft_entry__.py:96-118``; ``embed_dim`` scales the widths."""
    from npvp_tpu_torch.core.config import flagship_config

    cfg = flagship_config()
    d, p, a = cfg.Dataset, cfg.Predictor, cfg.AE
    d.img_size, d.num_past_frames, d.num_future_frames = 32, 2, 2
    d.batch_size = 2 * n
    p.max_T, p.min_lo, p.max_lo = 4, 1, 3
    p.max_H = p.max_W = 4
    p.transformer_layers, p.evt_former_num_layers = 8, 4
    p.embed_dim, p.num_heads = embed_dim, embed_dim // 64  # heads of 64
    p.evt_hidden_channels = embed_dim // 2
    p.dim_feedforward = 2 * embed_dim
    # the AE's feature width is the predictor's: ngf · 2^3 = embed_dim
    a.ngf, a.n_downsampling, a.num_res_blocks = embed_dim // 8, 3, 1
    cfg.Env.compute_dtype = "bfloat16"
    cfg.Env.sequence_parallel = cfg.Env.fsdp = True
    return cfg.validate()


def _train(cfg, mesh, dev):
    from npvp_tpu_torch.core import distributed as D
    from npvp_tpu_torch.models.predictor import build_predictor
    from npvp_tpu_torch.nn.layers import Rng
    from npvp_tpu_torch.nn.resnet_ae import build_ae
    from npvp_tpu_torch.tools.weights import random_init
    from npvp_tpu_torch.train import stage2_predictor as s2
    from npvp_tpu_torch.train.common import compute_dtype, parallelize_state

    dtype, d, T = compute_dtype(cfg), cfg.Dataset, cfg.Predictor.max_T
    ae = random_init(build_ae(cfg, dtype), 0).to(dev).eval()
    ae.requires_grad_(False)
    state = s2.init_predictor_state(
        cfg, build_predictor(cfg, dtype).to(dev), steps_per_epoch=10)
    state = parallelize_state(state, mesh, cfg.Env.fsdp, s2.fsdp_units)
    steps = s2.make_steps(cfg, ae, "rand_context", dev, mesh)
    batch = {"clip": np.random.default_rng(0).random(
        (d.batch_size, T, d.img_size, d.img_size, d.img_channels),
        np.float32),
        "obs_mask": np.array([True, True, False, False]),
        "tgt_mask": np.array([False, False, True, True])}
    metrics = D.all_mean(steps.train(state, steps.place(
        D.shard_batch(mesh, batch)), Rng(1)), mesh)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    return loss


def _serve(cfg, mesh, dev):
    from npvp_tpu_torch.core.sequence_parallel import sequence_parallel
    from npvp_tpu_torch.models.inference import VideoPredictor

    d = cfg.Dataset
    vp = VideoPredictor.from_random_init(cfg, torch.bfloat16,
                                         exec_mode="pallas", device=dev)
    predict = vp.shard(mesh).freeze_task(np.arange(2), np.arange(2, 4))
    frames = np.random.default_rng(1).random(
        (d.batch_size, 2, d.img_size, d.img_size, d.img_channels),
        np.float32)
    with sequence_parallel(mesh):
        out = predict(frames,
                      generator=torch.Generator(dev).manual_seed(2))
    want = (d.batch_size, 2, d.img_size, d.img_size, d.img_channels)
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        raise ValueError(f"serving gave {tuple(out.shape)}, not {want}, "
                         "or a value that is not finite")


def _pipeline(cfg, stages: int, dev) -> float:
    """The decoder's 8 blocks (generic path, eval mode) at ``stages`` ×
    data 2 over 2 microbatches of the batch-4 inputs (one row a rank);
    → max |pipeline − sequential stack| on the same rows, which must be
    within bf16's rounding (cuBLAS picks its algorithms by shape, so the
    stack is run on each row alone, as the pipeline runs it)."""
    from torch.func import functional_call

    from npvp_tpu_torch.core.pipeline import (make_pipeline_mesh,
                                              pipeline_apply,
                                              stack_layer_params)
    from npvp_tpu_torch.nn.vidhrformer import VidHRFormerBlockDecNAR
    from npvp_tpu_torch.tools.weights import random_init

    p = cfg.Predictor
    C, L, H, W, To, TP = (p.embed_dim, p.transformer_layers, p.max_H,
                          p.max_W, 2, 2)
    blocks = [random_init(VidHRFormerBlockDecNAR(
        C, p.num_heads, p.window_size, 0.0, 0.0, 4, p.dim_feedforward,
        "layer", spatial=(H, W), dtype=torch.bfloat16), i).to(dev).eval()
        for i in range(L)]
    rng = np.random.default_rng(7)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    query_evt, memory = f32(4, 1, H, W, C), f32(4, To, H, W, C)
    mem_pos = (f32(To * H * W, C), f32(To * H * W, C))
    tgt_pos = (f32(TP * H * W, C), f32(TP * H * W, C))
    tgt0 = f32(4, TP, H, W, C)
    block = blocks[0]

    def apply_block(params, pack):
        tgt, q, m = pack
        return (functional_call(block, params,
                                (tgt, q, m, mem_pos, tgt_pos)), q, m)

    with torch.no_grad():
        rows = []
        for n in range(tgt0.shape[0]):
            h = tgt0[n:n + 1]
            for b in blocks:
                h = b(h, query_evt[n:n + 1], memory[n:n + 1], mem_pos,
                      tgt_pos)
            rows.append(h)
        want = torch.cat(rows)
    pack = (tgt0.reshape(2, 2, TP, H, W, C),
            query_evt.reshape(2, 2, 1, H, W, C),
            memory.reshape(2, 2, To, H, W, C))
    mesh = make_pipeline_mesh(stages, 2, dev.type)
    got = pipeline_apply(apply_block, stack_layer_params(blocks), pack,
                         mesh=mesh, data_axis="data")[0]
    got = got.reshape(want.shape).float()
    if not bool(torch.isfinite(got).all()):
        raise ValueError("the pipeline gave a value that is not finite")
    err = (got - want.float()).abs()
    if not bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()):
        raise ValueError(f"pipeline vs sequential max|d| "
                         f"{err.max().item():.3e}")
    return err.max().item()


def _rank(rank: int, n: int, device: str, embed_dim: int, init: str):
    from npvp_tpu_torch.core import distributed as D

    if device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(1)
    else:
        cards = torch.cuda.device_count()
        os.environ["LOCAL_RANK"] = str(rank % cards)  # the group's device
        dev = torch.device(f"cuda:{rank % cards}")
        backend = "nccl" if cards >= n else "gloo"
    D.maybe_init_distributed(dev.type, backend=backend,
                             init_method=f"file://{init}", rank=rank,
                             world_size=n)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        cfg = dryrun_config(n, embed_dim)
        model = 2 if n % 2 == 0 and n >= 4 else 1
        mesh = D.make_mesh(n // model, model, cfg.Dataset.batch_size,
                           dev.type)
        from npvp_tpu_torch.core.sequence_parallel import sequence_parallel

        with sequence_parallel(mesh):
            loss = _train(cfg, mesh, dev)
        say(f"dryrun_multichip({n}): mesh={{'data': {n // model}, "
            f"'model': {model}}} sequence_parallel fsdp loss={loss:.4f} "
            "train OK", flush=True)
        _serve(cfg, mesh, dev)
        say(f"dryrun_multichip({n}): serving shard→freeze_task→predict "
            "under sequence_parallel OK", flush=True)
        stages, L = n // 2, cfg.Predictor.transformer_layers
        if n >= 4 and L % stages == 0:
            err = _pipeline(cfg, stages, dev)
            say(f"dryrun_multichip({n}): PP×DP GPipe (depth {L}, {stages} "
                f"stages × data 2, width {cfg.Predictor.embed_dim}) "
                f"max|d| to the sequential stack {err:.3e} OK", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda",
                     embed_dim: int = 512) -> None:
    """Run the dry run on ``n`` ranks (spawned processes) on ``device``
    ("cuda": card ``rank % device_count``; "cpu"); raises if a rank
    fails."""
    import torch.multiprocessing as mp

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip on cuda needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(n, device, embed_dim,
                                        str(Path(tmp) / "pg")),
                           nprocs=n, join=True, start_method="spawn")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--embed_dim", type=int, default=512)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.embed_dim)


if __name__ == "__main__":
    main()
