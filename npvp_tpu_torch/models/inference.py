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
``eps``. Not ported yet: ``shard``, ``export_task``/``serve_exported``,
``predict_stream`` and the sliding-window ``vfp_windowed``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from npvp_tpu_torch.core.config import Config
from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.models.coords import coordinate_grid, spatial_index_lists
from npvp_tpu_torch.models.predictor import NPPredictor, build_predictor
from npvp_tpu_torch.nn.resnet_ae import FrameAutoEncoder, build_ae
from npvp_tpu_torch.tools.weights import load_flax, load_weights, random_init


class VideoPredictor:
    """Frozen AE + NP predictor with a continuous-time query API."""

    def __init__(self, cfg: Config, ae: FrameAutoEncoder,
                 predictor: NPPredictor, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ae = ae.to(self.device).eval()
        self.predictor = predictor.to(self.device).eval()
        self.h_list, self.w_list = spatial_index_lists(cfg.Predictor.max_H,
                                                       cfg.Predictor.max_W)

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
    def from_weights(cls, cfg: Config, npz_path, dtype=torch.bfloat16,
                     exec_mode: Optional[str] = None,
                     device="cuda") -> "VideoPredictor":
        """From a weights archive written by
        ``npvp_tpu/tools/export_weights.py``."""
        ae_vars, pred_vars, _ = load_weights(npz_path)
        return cls.from_variables(cfg, ae_vars, pred_vars, dtype, exec_mode,
                                  device)

    # -- core ---------------------------------------------------------------
    def _coords(self, t_list) -> torch.Tensor:
        p = self.cfg.Predictor
        return coordinate_grid(t_list, self.h_list, self.w_list, p.max_T,
                               p.max_H, p.max_W, device=self.device)

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)

    def _eps(self, n: int, eps, generator):
        """Latent noise for NPVP-S: ``eps`` as given, else drawn from
        ``generator`` (a fresh one seeded 0 by default)."""
        if not self.cfg.Predictor.stochastic:
            return None
        if eps is not None:
            return torch.as_tensor(eps, dtype=torch.float32,
                                   device=self.device)
        p = self.cfg.Predictor
        gen = generator if generator is not None else (
            torch.Generator(device=self.device).manual_seed(0))
        return torch.randn((n, p.max_H, p.max_W, p.embed_dim),
                           generator=gen, device=self.device)

    def _run(self, frames, oc, tc, eps, generator):
        with torch.inference_mode():
            frames = self._frames(frames)
            feats = self.ae.encode(frames)
            out = self.predictor(feats, oc, tc,
                                 self._eps(frames.shape[0], eps, generator))
            return self.ae.decode(out.pred_features)

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

    # -- the five tasks ------------------------------------------------------
    def vfp(self, past_frames, num_future: int, eps=None, generator=None):
        """Future prediction within the trained time range (horizons beyond
        ``max_T`` need the sliding-window protocol, not ported yet)."""
        P = past_frames.shape[1]
        if P + num_future > self.cfg.Predictor.max_T:
            raise NotImplementedError(
                f"VFP horizon {P}+{num_future} exceeds max_T="
                f"{self.cfg.Predictor.max_T}; the sliding-window protocol "
                "is not ported yet")
        return self.predict(past_frames, np.arange(P),
                            np.arange(P, P + num_future), eps, generator)

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
