"""Seeded frame-folder trees in each dataset's on-disk layout, written with
the port's PNG writer, for tests and smoke runs on hosts that hold neither
the real frames nor an image library.

Frames are smooth moving patterns plus noise (uint8), and row ``r`` of
frame ``i`` is stored with PNG filter ``(r + i) % 5``, so every filter type
appears in every tree. Each builder returns ``{path: array written}``, for
a read-back check.

Layouts (as the reference's loaders expect them):

- KTH: ``<root>/<action>/person<XX>_<action>_d<Y>/frame_<k>.png``, RGB
  160×120 as ffmpeg extracts the videos;
- BAIR: ``<root>/{train,test}/<example>/<k>.png``, RGB 64×64;
- Cityscapes: ``<root>/{train,val,test}/<city>/<city>_<seq>_<frame>
  _leftImg8bit.png``, RGB;
- KITTI: ``<root>/<drive>/<k>.png``, RGB, any size (resized on load);
- MovingMNIST: ``<root>/moving-mnist-{train,valid,test}.npz``, (T, N, H, W)
  uint8.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from npvp_tpu_torch.data import png


def moving_frames(rng: np.random.Generator, n: int, size: Tuple[int, int],
                  channels: int = 3) -> np.ndarray:
    """(n, H, W, channels) uint8: a drifting colour gradient and a moving
    blob over mild noise."""
    H, W = size
    y, x = np.mgrid[:H, :W].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, channels).astype(np.float32)
    cy, cx = rng.uniform(0.2, 0.8, 2) * (H, W)
    vy, vx = rng.uniform(-2, 2, 2)
    out = np.empty((n, H, W, channels), np.uint8)
    for i in range(n):
        base = 110 + 60 * np.sin((x + 3 * i) / 17.0 + y / 23.0 + phase[
            :, None, None])                                  # (C, H, W)
        blob = 90 * np.exp(-((y - cy - vy * i) ** 2 + (x - cx - vx * i) ** 2)
                           / (2 * (0.08 * min(H, W)) ** 2))
        noise = rng.normal(0, 6, (channels, H, W))
        out[i] = np.clip(base + blob + noise, 0, 255).transpose(1, 2, 0)
    return out


def write_frames(folder: Path, frames: np.ndarray, name: str
                 ) -> Dict[Path, np.ndarray]:
    """Frames as PNGs ``folder/name.format(k)``; → {path: frame}."""
    folder.mkdir(parents=True, exist_ok=True)
    written = {}
    for i, frame in enumerate(frames):
        path = folder / name.format(i)
        rows = frame.shape[0]
        png.write_png(path, frame, filters=(np.arange(rows) + i) % 5)
        written[path] = frame
    return written


def kth_tree(root, persons: Sequence[int], actions: Sequence[str],
             frames: int, seed: int = 0, size: Tuple[int, int] = (120, 160),
             scenarios: int = 1) -> Dict[Path, np.ndarray]:
    rng = np.random.default_rng(seed)
    written = {}
    for action in actions:
        for pid in persons:
            for d in range(1, scenarios + 1):
                folder = Path(root) / action / f"person{pid:02d}_{action}_d{d}"
                written.update(write_frames(folder, moving_frames(
                    rng, frames, size), "frame_{:04d}.png"))
    return written


def bair_tree(root, examples: Dict[str, int], frames: int, seed: int = 0,
              size: int = 64) -> Dict[Path, np.ndarray]:
    """``examples`` maps "train"/"test" to the number of example folders."""
    rng = np.random.default_rng(seed)
    written = {}
    for split, n in examples.items():
        for j in range(n):
            written.update(write_frames(
                Path(root) / split / f"example_{j:05d}",
                moving_frames(rng, frames, (size, size)), "{:02d}.png"))
    return written


def cityscapes_tree(root, sequences: Dict[str, int], frames: int,
                    seed: int = 0, size: int = 128,
                    cities: Sequence[str] = ("aachen", "bochum")
                    ) -> Dict[Path, np.ndarray]:
    """``sequences`` maps a split to its number of sequences per city."""
    rng = np.random.default_rng(seed)
    written = {}
    for split, n in sequences.items():
        for city in cities:
            for s in range(n):
                seq = f"{s:06d}"
                written.update(write_frames(
                    Path(root) / split / city,
                    moving_frames(rng, frames, (size, size)),
                    f"{city}_{seq}_{{:06d}}_leftImg8bit.png"))
    return written


def kitti_tree(root, drives: int, frames: int, seed: int = 0,
               size: Tuple[int, int] = (125, 414)) -> Dict[Path, np.ndarray]:
    rng = np.random.default_rng(seed)
    written = {}
    for j in range(drives):
        written.update(write_frames(
            Path(root) / f"2011_09_26_drive_{j:04d}_sync",
            moving_frames(rng, frames, size), "{:010d}.png"))
    return written


def moving_mnist_npz(root, frames: int, clips: int, seed: int = 0,
                     size: int = 64) -> Dict[Path, np.ndarray]:
    rng = np.random.default_rng(seed)
    written = {}
    for split in ("train", "valid", "test"):
        arr = moving_frames(rng, frames * clips, (size, size), 1)[..., 0]
        arr = arr.reshape(clips, frames, size, size).transpose(1, 0, 2, 3)
        path = Path(root) / f"moving-mnist-{split}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, arr)
        written[path] = arr
    return written
