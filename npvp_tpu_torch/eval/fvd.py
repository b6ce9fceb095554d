"""Fréchet Video Distance (port of ``npvp_tpu/eval/fvd.py``): videos in
[0, 1] → the shorter side resized to 224 and centre-cropped, scaled to
[−1, 1] → the I3D's 400-d features → the Fréchet distance between Gaussian
fits of two feature sets (scipy on the host: a 400 × 400 matrix).

The repository holds no Kinetics I3D weights and nothing is fetched: FVD
reads a converted checkpoint (``.pkl`` of a flax variable tree of numpy
arrays, through the weight bridge) or takes random weights from a seed,
which exercise the pipeline but give no meaningful distance.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path
import numpy as np
import torch
import torch.nn.functional as F

from npvp_tpu_torch.core.device import resolve_device
from npvp_tpu_torch.eval.i3d import InceptionI3d
from npvp_tpu_torch.tools.weights import load_flax, random_init


def preprocess_videos(videos, target: int = 224,
                      device="cpu") -> torch.Tensor:
    """(N, T, H, W, C) in [0, 1] (numpy or a tensor) → (N, T, target,
    target, 3) fp32 in [−1, 1]: grey to RGB, a bilinear resize of the
    shorter side to ``target`` with half-pixel centres (``align_corners``
    False), a centre crop of the longer side."""
    x = torch.as_tensor(videos, device=device).float()
    if x.shape[-1] == 1:
        x = x.expand(x.shape[:-1] + (3,))
    N, T, H, W, C = x.shape
    if (H, W) != (target, target):
        scale = target / min(H, W)
        th, tw = ((target, math.ceil(W * scale)) if H < W
                  else (math.ceil(H * scale), target))
        y = F.interpolate(x.reshape(N * T, H, W, C).permute(0, 3, 1, 2),
                          size=(th, tw), mode="bilinear",
                          align_corners=False)
        h0, w0 = (th - target) // 2, (tw - target) // 2
        x = y[:, :, h0:h0 + target, w0:w0 + target].permute(
            0, 2, 3, 1).reshape(N, T, target, target, C)
    return x * 2.0 - 1.0


class FVD:
    """I3D features of videos and their Fréchet distance."""

    def __init__(self, dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.model = InceptionI3d(dtype=dtype).to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path, dtype=torch.bfloat16,
                        device="cuda") -> "FVD":
        """Converted I3D weights: a pickled flax variable tree whose leaves
        are numpy arrays."""
        path = Path(path)
        if path.suffix != ".pkl":
            raise ValueError(f"{path}: expected a .pkl converted I3D "
                             "checkpoint (a flax variable tree of numpy "
                             "arrays)")
        fvd = cls(dtype, device)
        load_flax(fvd.model, pickle.loads(path.read_bytes()))
        return fvd

    def init_random(self, seed: int = 0) -> "FVD":
        """Random weights from ``seed``: tests and timing only, the
        distances mean nothing."""
        random_init(self.model, seed)
        return self

    def features(self, videos, batch_size: int = 8) -> np.ndarray:
        """(N, T, H, W, C) in [0, 1] → (N, 400) float32 features."""
        feats = []
        with torch.inference_mode():
            for i in range(0, videos.shape[0], batch_size):
                x = preprocess_videos(videos[i:i + batch_size],
                                      device=self.device)
                feats.append(self.model(x).cpu().numpy())
        return np.concatenate(feats, axis=0)

    def __call__(self, fake_videos, real_videos,
                 batch_size: int = 8) -> float:
        return frechet_distance(self.features(fake_videos, batch_size),
                                self.features(real_videos, batch_size))


def frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two feature sets."""
    import scipy.linalg

    mu1, mu2 = feats1.mean(axis=0), feats2.mean(axis=0)
    cov1 = np.cov(feats1, rowvar=False)
    cov2 = np.cov(feats2, rowvar=False)
    m = np.square(mu1 - mu2).sum()
    sqrt_cc = scipy.linalg.sqrtm(np.dot(cov1, cov2))
    return float(m + np.trace(cov1 + cov2 - 2.0 * np.real(sqrt_cc)))
