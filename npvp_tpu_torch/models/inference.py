"""Serving API: one model for the five tasks (port of
``npvp_tpu/models/inference.py``).

A task is only a choice of observed/target time lists:

- VFP  — observe 0..P-1, generate P..P+F-1 (future prediction)
- VPE  — observe the tail, generate the head (past extrapolation)
- VFI  — observe both ends, generate the middle (interpolation)
- VRC  — any observed/target split (random completion)
- HVRC — fractional target times (continuous temporal super-resolution)

The pipeline is AE encode → NP predictor → AE decode, run eagerly under
``torch.inference_mode``. NPVP-S draws its latent noise from a
``torch.Generator`` (seeded 0 unless the caller passes one) or takes it as
``eps``; the windows of ``vfp_windowed`` and the batches of
``predict_stream`` draw from one generator in their order, or take ``eps``
as a sequence with one entry each. ``export_task`` writes one task's
forward as a serving bundle (``torch.export``), which ``serve_exported``
runs without the model code.

``shard(mesh)`` serves on several cards (one process each, on a process
group): the predictor's heads and FFN widths split over the mesh's model
axis, the AE replicated. Every ``predict*`` call then takes the global
batch on every rank; each data rank runs its rows (``r::data``) with the
noise the one-process call draws for them, and all of them return the
global output. Calls made inside ``core.sequence_parallel
.sequence_parallel(mesh)`` (or after ``enable_sequence_parallel(mesh)``)
also split the VidHRFormer stacks' activations on H over the model axis.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from npvp_tpu_torch.core import distributed as D
from npvp_tpu_torch.core.config import Config
from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.core.tensor_parallel import shard_tensor_parallel
from npvp_tpu_torch.models.coords import coordinate_grid, spatial_index_lists
from npvp_tpu_torch.models.predictor import NPPredictor, build_predictor
from npvp_tpu_torch.nn.resnet_ae import FrameAutoEncoder, build_ae
from npvp_tpu_torch.tools.weights import (load_flax, load_trained,
                                          load_weights, random_init)


class _FrozenTask(nn.Module):
    """One task's forward, frames (and NPVP-S's noise) → predicted frames,
    with the coordinate grids held as buffers: the module that
    ``export_task`` exports."""

    def __init__(self, ae, predictor, oc, tc):
        super().__init__()
        self.ae, self.predictor = ae, predictor
        self.register_buffer("oc", oc)
        self.register_buffer("tc", tc)

    def forward(self, frames, eps=None):
        out = self.predictor(self.ae.encode(frames), self.oc, self.tc, eps)
        return self.ae.decode(out.pred_features)


class VideoPredictor:
    """Frozen AE + NP predictor with a continuous-time query API."""

    def __init__(self, cfg: Config, ae: FrameAutoEncoder,
                 predictor: NPPredictor, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # frozen: serving trains nothing (and the kernel's cached wo casts
        # of frozen weights need no check of their values)
        self.ae = ae.to(self.device).eval().requires_grad_(False)
        self.predictor = predictor.to(self.device).eval().requires_grad_(
            False)
        self.h_list, self.w_list = spatial_index_lists(cfg.Predictor.max_H,
                                                       cfg.Predictor.max_W)
        self.mesh = None

    # -- construction --------------------------------------------------------
    @classmethod
    def _build(cls, cfg, dtype, exec_mode):
        return build_ae(cfg, dtype), build_predictor(cfg, dtype, exec_mode)

    @classmethod
    def from_random_init(cls, cfg: Config, dtype=torch.bfloat16,
                         seed: int = 0, exec_mode: Optional[str] = None,
                         device="cuda") -> "VideoPredictor":
        """Random weights from ``seed``, for benchmarks and smoke runs."""
        ae, predictor = cls._build(cfg, dtype, exec_mode)
        return cls(cfg, random_init(ae, seed), random_init(predictor,
                                                           seed + 1), device)

    @classmethod
    def from_variables(cls, cfg: Config, ae_vars: dict, pred_vars: dict,
                       dtype=torch.bfloat16, exec_mode: Optional[str] = None,
                       device="cuda") -> "VideoPredictor":
        """From flax variable trees (nested dicts of numpy arrays)."""
        ae, predictor = cls._build(cfg, dtype, exec_mode)
        load_flax(ae, ae_vars)
        load_flax(predictor, pred_vars)
        return cls(cfg, ae, predictor, device)

    @classmethod
    def from_checkpoints(cls, cfg: Config, ae_ckpt_dir, predictor_ckpt_dir,
                         dtype=torch.bfloat16,
                         exec_mode: Optional[str] = None,
                         device="cuda") -> "VideoPredictor":
        """From the port's trainers' checkpoints: each a
        ``CheckpointManager`` directory (its latest step) or one ``.pt``
        file (an AE may also be a weights archive). A predictor path ending
        in ``.npz`` is a weights archive holding both halves
        (:meth:`from_weights`)."""
        if str(predictor_ckpt_dir).endswith(".npz"):
            return cls.from_weights(cfg, predictor_ckpt_dir, dtype,
                                    exec_mode, device)
        ae, predictor = cls._build(cfg, dtype, exec_mode)
        load_trained(ae, ae_ckpt_dir, "ae")
        load_trained(predictor, predictor_ckpt_dir, "pred")
        return cls(cfg, ae, predictor, device)

    @classmethod
    def from_weights(cls, cfg: Config, npz_path, dtype=torch.bfloat16,
                     exec_mode: Optional[str] = None,
                     device="cuda") -> "VideoPredictor":
        """From a weights archive written by
        ``npvp_tpu/tools/export_weights.py``."""
        ae_vars, pred_vars, _ = load_weights(npz_path)
        return cls.from_variables(cfg, ae_vars, pred_vars, dtype, exec_mode,
                                  device)

    def shard(self, mesh) -> "VideoPredictor":
        """Serve on ``mesh`` (``core.distributed.make_mesh``; every rank
        calls this and then every ``predict*`` call alike): the predictor's
        attention heads and FFN hidden widths split over the model axis,
        the AE replicated, each call's batch split over the data axis. A
        batch that the data axis does not divide runs whole on every rank,
        with a warning. Returns self (the split is in place)."""
        if self.mesh is not None:
            raise ValueError("the predictor is sharded already")
        shard_tensor_parallel(self.predictor, mesh)
        self.mesh = mesh
        return self

    # -- core ---------------------------------------------------------------
    def _coords(self, t_list) -> torch.Tensor:
        p = self.cfg.Predictor
        return coordinate_grid(t_list, self.h_list, self.w_list, p.max_T,
                               p.max_H, p.max_W, device=self.device)

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)

    def _generator(self, generator):
        """``generator``, or a fresh one seeded 0."""
        return generator if generator is not None else (
            torch.Generator(device=self.device).manual_seed(0))

    def _eps(self, n: int, eps, generator):
        """Latent noise for NPVP-S: ``eps`` as given, else drawn from
        ``generator`` (a fresh one seeded 0 by default)."""
        if not self.cfg.Predictor.stochastic:
            return None
        if eps is not None:
            return torch.as_tensor(eps, dtype=torch.float32,
                                   device=self.device)
        p = self.cfg.Predictor
        return torch.randn((n, p.max_H, p.max_W, p.embed_dim),
                           generator=self._generator(generator),
                           device=self.device)

    def _run(self, frames, oc, tc, eps, generator):
        with torch.inference_mode():
            frames = self._frames(frames)
            eps = self._eps(frames.shape[0], eps, generator)
            data = D.axis(self.mesh, D.DATA_AXIS)
            if data is not None and frames.shape[0] % data.size:
                warnings.warn(
                    f"batch size {frames.shape[0]} does not divide the data "
                    f"axis ({data.size} ranks); every rank runs the whole "
                    "batch: data parallelism is lost for this call",
                    stacklevel=3)
                data = None
            if data is not None:
                frames = frames[data.rank::data.size]
                eps = None if eps is None else eps[data.rank::data.size]
            out = self.predictor(self.ae.encode(frames), oc, tc, eps)
            pred = self.ae.decode(out.pred_features)
            return pred if data is None else D.gather_rows(self.mesh, pred)

    def predict(self, observed_frames, to_list: Sequence[float],
                tp_list: Sequence[float], eps=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """observed_frames (N, To, H, W, C) observed at times ``to_list`` →
        (N, TP, H, W, C) frames at ``tp_list`` (fractional times allowed)."""
        if observed_frames.shape[1] != len(to_list):
            raise ValueError(f"{observed_frames.shape[1]} frames observed at "
                             f"{len(to_list)} times")
        return self._run(observed_frames, self._coords(to_list),
                         self._coords(tp_list), eps, generator)

    def freeze_task(self, to_list: Sequence[float],
                    tp_list: Sequence[float]):
        """A callable ``fn(observed_frames, eps=None, generator=None)`` for a
        task served repeatedly: its coordinate grids are built once, on the
        device."""
        oc, tc = self._coords(to_list), self._coords(tp_list)
        n_obs = len(to_list)

        def predict_frozen(observed_frames, eps=None, generator=None):
            if observed_frames.shape[1] != n_obs:
                raise ValueError(f"frozen task observes {n_obs} frames, got "
                                 f"{observed_frames.shape[1]}")
            return self._run(observed_frames, oc, tc, eps, generator)

        return predict_frozen

    # -- serving bundles -----------------------------------------------------
    def export_task(self, path, to_list: Sequence[float],
                    tp_list: Sequence[float], batch_size: int) -> None:
        """Write the task's forward (``freeze_task``'s) as a serving bundle
        in directory ``path``: ``program.pt2`` (``torch.export`` of the
        model with its weights, its coordinate grids as constants) and
        ``meta.json`` (the task's times, the static batch, the frames' and
        the noise's shapes, device, dtype and exec_mode). The program takes
        ``batch_size`` clips of ``len(to_list)`` frames, float32 on this
        predictor's device, and for NPVP-S the latent noise (batch_size,
        max_H, max_W, embed_dim) as a plain tensor. The attention kernel
        stays in it as the op ``npvp::temporal_attention``. A bundle holds
        one device's program: a sharded predictor raises."""
        if self.mesh is not None:
            raise ValueError("export_task of a sharded VideoPredictor: a "
                             "serving bundle runs on one device")
        d, p = self.cfg.Dataset, self.cfg.Predictor
        oc, tc = self._coords(to_list), self._coords(tp_list)
        frames_shape = (batch_size, len(to_list), d.img_size, d.img_size,
                        d.img_channels)
        eps_shape = ((batch_size, p.max_H, p.max_W, p.embed_dim)
                     if p.stochastic else None)
        args = (torch.zeros(frames_shape, device=self.device),)
        if eps_shape is not None:
            args += (torch.zeros(eps_shape, device=self.device),)
        with torch.no_grad():
            program = torch.export.export(
                _FrozenTask(self.ae, self.predictor, oc, tc).eval(), args)
        out = Path(path)
        out.mkdir(parents=True, exist_ok=True)
        torch.export.save(program, out / "program.pt2")
        (out / "meta.json").write_text(json.dumps({
            "to_list": [float(t) for t in to_list],
            "tp_list": [float(t) for t in tp_list],
            "batch_size": batch_size, "frames_shape": list(frames_shape),
            "eps_shape": None if eps_shape is None else list(eps_shape),
            "device": self.device.type,
            "dtype": str(self.predictor.dtype).replace("torch.", ""),
            "exec_mode": self.predictor.exec_mode}))

    @staticmethod
    def serve_exported(path, device="cuda"):
        """Load a bundle written by :meth:`export_task` and return
        ``fn(observed_frames, eps=None, generator=None) -> (N, TP, H, W,
        C)``, which runs the exported program alone: no model modules, no
        config. It needs torch and, for a bundle holding the attention
        kernel, the op registered first: ``import
        npvp_tpu_torch.kernels.temporal_attention`` (this module does).

        The program's batch is static: a request of N clips runs in chunks
        of that batch, the last one padded with zeros whose rows are
        dropped (clips are independent: the norms use frozen statistics).
        NPVP-S: ``eps`` (N, max_H, max_W, embed_dim) gives each clip its
        noise, so the first chunk takes the caller's ``eps`` as given;
        without it each chunk draws (batch, ...) from ``generator`` (a
        fresh one seeded 0), the first chunk exactly as ``freeze_task``
        draws for a batch of that size."""
        out_dir = Path(path)
        meta = json.loads((out_dir / "meta.json").read_text())
        dev = resolve_device(device)
        if dev.type != meta["device"]:
            raise ValueError(f"{path}: bundle exported for "
                             f"{meta['device']}, asked to serve on "
                             f"{dev.type}")
        program = torch.export.load(out_dir / "program.pt2").module()
        shape = tuple(meta["frames_shape"])
        eps_shape = meta["eps_shape"] and tuple(meta["eps_shape"])
        B = shape[0]

        def pad(t):  # to the program's batch, with zero rows
            return t if t.shape[0] == B else torch.cat(
                [t, t.new_zeros((B - t.shape[0],) + t.shape[1:])])

        def serve(observed_frames, eps=None, generator=None):
            frames = torch.as_tensor(observed_frames, dtype=torch.float32,
                                     device=dev)
            if frames.shape[1:] != shape[1:]:
                raise ValueError(f"exported task takes frames (N,)+"
                                 f"{shape[1:]}, got {tuple(frames.shape)}")
            if eps is not None:
                eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
            gen = (generator if generator is not None else
                   torch.Generator(device=dev).manual_seed(0))
            outs = []
            with torch.inference_mode():
                for i in range(0, frames.shape[0], B):
                    chunk = frames[i:i + B]
                    args = (pad(chunk),)
                    if eps_shape is not None:
                        args += (pad(eps[i:i + B]) if eps is not None else
                                 torch.randn(eps_shape, generator=gen,
                                             device=dev),)
                    outs.append(program(*args)[:chunk.shape[0]])
            return outs[0] if len(outs) == 1 else torch.cat(outs)

        serve.meta = meta
        return serve

    # -- the five tasks ------------------------------------------------------
    def vfp(self, past_frames, num_future: int, eps=None, generator=None):
        """Future prediction; horizons beyond ``max_T`` take the
        sliding-window protocol (:meth:`vfp_windowed`, whose ``eps`` is one
        entry per window)."""
        P = past_frames.shape[1]
        if P + num_future > self.cfg.Predictor.max_T:
            return self.vfp_windowed(past_frames, num_future, eps, generator)
        return self.predict(past_frames, np.arange(P),
                            np.arange(P, P + num_future), eps, generator)

    def vfp_windowed(self, past_frames, num_future: int, eps=None,
                     generator: Optional[torch.Generator] = None,
                     chunk: Optional[int] = None) -> torch.Tensor:
        """Sliding-window future prediction for horizons beyond ``max_T``.

        Each window observes the last P frames at times re-based to
        0..P-1 and predicts the next ``chunk`` frames (by default the most
        that fit, ``max_T − P``); its predictions roll into the next
        window's context. NPVP-S draws each window's noise from the one
        ``generator`` in window order, or takes ``eps[w]`` for window w."""
        P = past_frames.shape[1]
        max_chunk = self.cfg.Predictor.max_T - P
        chunk = max_chunk if chunk is None else chunk
        if not 0 < chunk <= max_chunk:
            raise ValueError(f"window horizon {chunk} outside (0, "
                             f"{max_chunk}] for context {P} with "
                             f"max_T={self.cfg.Predictor.max_T}")
        gen = self._generator(generator)
        oc, tc = self._coords(np.arange(P)), self._coords(
            np.arange(P, P + chunk))
        ctx = self._frames(past_frames)
        preds = []
        for w in range(-(-num_future // chunk)):
            out = self._run(ctx, oc, tc, None if eps is None else eps[w],
                            gen)
            preds.append(out)
            ctx = torch.cat([ctx, out.float()], dim=1)[:, -P:]
        return torch.cat(preds, dim=1)[:, :num_future]

    def vpe(self, future_frames, num_past: int, eps=None, generator=None):
        F = future_frames.shape[1]
        return self.predict(future_frames, np.arange(num_past, num_past + F),
                            np.arange(num_past), eps, generator)

    def vfi(self, boundary_frames, context_p: int, context_f: int,
            num_interpolate: int, eps=None, generator=None):
        total = context_p + context_f + num_interpolate
        to = np.concatenate([np.arange(context_p),
                             np.arange(total - context_f, total)])
        return self.predict(boundary_frames, to,
                            np.arange(context_p, total - context_f), eps,
                            generator)

    def vrc(self, observed_frames, observed_times, target_times, eps=None,
            generator=None):
        return self.predict(observed_frames, observed_times, target_times,
                            eps, generator)

    def hvrc(self, observed_frames, observed_times, target_times, eps=None,
             generator=None):
        """Continuous generation: ``target_times`` may be fractional."""
        return self.predict(observed_frames, observed_times, target_times,
                            eps, generator)

    def reconstruct(self, frames) -> torch.Tensor:
        """AE round trip."""
        with torch.inference_mode():
            rec, _ = self.ae(self._frames(frames))
            return rec

    def predict_stream(self, frames_stream, to_list: Sequence[float],
                       tp_list: Sequence[float], eps=None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """Serve a stream of batches: (S, N, To, H, W, C) observed at
        ``to_list`` → (S, N, TP, H, W, C) at ``tp_list``. The stream moves
        to the device once, the coordinate grids are built once, and each
        batch's prediction is written into one preallocated output, so no
        batch waits on a host copy. NPVP-S draws each batch's noise from
        the one ``generator`` in stream order, or takes ``eps[s]``."""
        if frames_stream.shape[2] != len(to_list):
            raise ValueError(f"{frames_stream.shape[2]} frames observed at "
                             f"{len(to_list)} times")
        oc, tc = self._coords(to_list), self._coords(tp_list)
        gen = self._generator(generator)
        stream = self._frames(frames_stream)
        out = None
        for s in range(stream.shape[0]):
            pred = self._run(stream[s], oc, tc,
                             None if eps is None else eps[s], gen)
            if out is None:
                out = pred.new_empty((stream.shape[0],) + pred.shape)
            out[s] = pred
        return out
