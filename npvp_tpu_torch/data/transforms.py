"""Clip transforms (port of ``npvp_tpu/data/transforms.py``, SMMNIST
only): a clip is a float32 (T, H, W, C) array; SMMNIST's pipeline is the
identity and its renormaliser clips to [0, 1]. The frame-folder datasets'
pipelines (crops, resizes, flips, normalisation) come with their loaders."""

from __future__ import annotations

import numpy as np

# per-dataset channel statistics (reference utils/dataset.py:33-60)
DATASET_STATS = {"SMMNIST": {"mean": 0.0, "std": 1.0}}


class Compose:
    def __init__(self, transforms=()):
        self.transforms = list(transforms)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            clip = t(clip)
        return clip


class ReNormalize:
    """Model range → [0, 1], for metrics and pictures."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip):
        return np.clip(np.asarray(clip, np.float32) * self.std + self.mean,
                       0.0, 1.0)


def build_transforms(name: str, train: bool):
    """(transform, renorm) of a dataset's pipeline."""
    del train  # SMMNIST is not augmented
    if name not in DATASET_STATS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to PyTorch yet (ROADMAP.md, "
            "queue 1: Data, item 11); SMMNIST is")
    stats = DATASET_STATS[name]
    return Compose(), ReNormalize(stats["mean"], stats["std"])
