"""Clip transforms (port of ``npvp_tpu/data/transforms.py``).

A clip is a float32 (T, H, W, C) array, in [0, 1] until normalised.
Transforms are callables composed by :class:`Compose`; the random ones
(:class:`RandomTransform`) take the loader's per-sample generator and make
the same draws, in the same order, as the JAX package's, so both give the
same clips. :class:`Resize` is a numpy bilinear resize with OpenCV's
``INTER_LINEAR`` sampling (the JAX package resizes with ``cv2``), so no
image library is needed. Per-dataset normalisation constants live in
:data:`DATASET_STATS` (reference utils/dataset.py:33-60).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


class RandomTransform:
    """Marker base class: :class:`Compose` passes these the per-sample
    generator."""


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        for t in self.transforms:
            clip = t(clip, rng) if isinstance(t, RandomTransform) else t(clip)
        return clip


def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: for each output index,
    the two source indices and their float32 weights, sampling at
    ``(dst + 0.5)·src/dst − 0.5``; a sample left of the first pixel or on
    or past the last one takes that pixel alone."""
    scale = 1.0 / (dst / src)  # OpenCV's double-precision scale
    pos = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    frac[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    past = i0 >= src - 1
    frac[past] = 0.0
    i0[past] = src - 1
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, (np.float32(1) - frac), frac


class Resize:
    """Bilinear resize to ``size`` (H, W), rows then columns as OpenCV
    does on float32 images."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        H, W = self.size
        if clip.shape[1] == H and clip.shape[2] == W:
            return clip
        clip = np.asarray(clip, np.float32)
        x0, x1, wx0, wx1 = _linear_taps(clip.shape[2], W)
        y0, y1, wy0, wy1 = _linear_taps(clip.shape[1], H)
        rows = (clip[:, :, x0] * wx0[:, None] + clip[:, :, x1]
                * wx1[:, None])                           # (T, h, W, C)
        return (rows[:, y0] * wy0[:, None, None]
                + rows[:, y1] * wy1[:, None, None])


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        H, W = self.size
        h0 = (clip.shape[1] - H) // 2
        w0 = (clip.shape[2] - W) // 2
        return clip[:, h0:h0 + H, w0:w0 + W]


class Crop:
    """Fixed-corner crop (reference VidCrop)."""

    def __init__(self, h0: int, w0: int, size: Tuple[int, int]):
        self.h0, self.w0, self.size = h0, w0, size

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        H, W = self.size
        return clip[:, self.h0:self.h0 + H, self.w0:self.w0 + W]


class Pad:
    def __init__(self, pad_h: int, pad_w: int):
        self.pad_h, self.pad_w = pad_h, pad_w

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return np.pad(clip, ((0, 0), (self.pad_h, self.pad_h),
                             (self.pad_w, self.pad_w), (0, 0)))


class RandomHorizontalFlip(RandomTransform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip, rng):
        if rng is not None and rng.random() < self.p:
            return clip[:, :, ::-1]
        return clip


class RandomVerticalFlip(RandomTransform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip, rng):
        if rng is not None and rng.random() < self.p:
            return clip[:, ::-1]
        return clip


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return (clip - self.mean) / self.std


class ReNormalize:
    """Model range → [0, 1], for metrics and pictures (reference
    VidReNormalize, utils/dataset.py:860-886)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip):
        return np.clip(np.asarray(clip, np.float32) * self.std + self.mean,
                       0.0, 1.0)


# channel statistics measured by the reference (utils/dataset.py:33-60)
DATASET_STATS = {
    "KTH": {"mean": 0.6013795, "std": 2.7570653},
    "KITTI": {"mean": (0.44812047, 0.47147775, 0.4677183),
              "std": (1.5147436, 1.5871466, 1.5925455)},
    "BAIR": {"mean": (0.61749697, 0.6050092, 0.52180636),
             "std": (2.1824553, 2.1553133, 1.9115673)},
    "Cityscapes": {"mean": (0.31604213, 0.35114038, 0.3104223),
                   "std": (1.2172801, 1.3219808, 1.2082524)},
    "SMMNIST": {"mean": 0.0, "std": 1.0},
    "MovingMNIST": {"mean": 0.0, "std": 1.0},
}


def build_transforms(name: str, train: bool):
    """(transform, renorm) of a dataset's pipeline (reference
    utils/dataset.py:33-60); "CityScapes" names Cityscapes."""
    name = "Cityscapes" if name == "CityScapes" else name
    if name not in DATASET_STATS:
        raise ValueError(f"unknown dataset {name!r}")
    stats = DATASET_STATS[name]
    norm = Normalize(stats["mean"], stats["std"])
    renorm = ReNormalize(stats["mean"], stats["std"])
    flips = [RandomHorizontalFlip(0.5), RandomVerticalFlip(0.5)] if train \
        else []
    steps = {"KTH": [CenterCrop((120, 120)), Resize((64, 64))] + flips
             + [norm],
             "KITTI": [Resize((128, 128))] + flips + [norm],
             "BAIR": flips + [norm],
             "Cityscapes": [norm]}.get(name, [])
    return Compose(steps), renorm


def mean_std_compute(clips_iter, channels: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass channel mean and std over an iterator of clips (reference
    utils/dataset.py:902-951)."""
    count = 0
    s = np.zeros(channels, np.float64)
    s2 = np.zeros(channels, np.float64)
    for clip in clips_iter:
        flat = clip.reshape(-1, channels).astype(np.float64)
        count += flat.shape[0]
        s += flat.sum(axis=0)
        s2 += (flat ** 2).sum(axis=0)
    mean = s / count
    std = np.sqrt(s2 / count - mean ** 2)
    return mean.astype(np.float32), std.astype(np.float32)
