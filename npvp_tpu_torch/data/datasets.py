"""Frame-folder clip datasets: KTH, BAIR, Cityscapes, KITTI, and the npz
MovingMNIST (port of ``npvp_tpu/data/datasets.py``).

A dataset is a list of clips, each a list of frame paths, plus a
transform. Frames are PNGs decoded by the port's own reader
(:mod:`npvp_tpu_torch.data.png`), bit-equal to PIL's decode, so no image
library is needed. The split conventions are the reference's, so that
benchmark protocols line up. ``__getitem__(idx, rng)`` takes the loader's
per-sample generator, which the random flips draw from.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from npvp_tpu_torch.data import png

KTH_ACTIONS = ["boxing", "handclapping", "handwaving", "jogging_no_empty",
               "running_no_empty", "walking_no_empty"]


def _png_mode(color_mode: str) -> str:
    return "L" if color_mode == "grey_scale" else "RGB"


def _unit(frames: np.ndarray, color_mode: str) -> np.ndarray:
    """uint8 frames (..., H, W) or (..., H, W, 3) → float32 (..., H, W, C)
    in [0, 1]."""
    arr = frames.astype(np.float32) / 255.0
    return arr[..., None] if color_mode == "grey_scale" else arr


def load_frame(path, color_mode: str = "grey_scale") -> np.ndarray:
    """Decode one frame to float32 (H, W, C) in [0, 1]."""
    return _unit(png.read_png(path, _png_mode(color_mode)), color_mode)


class ClipDataset:
    """Generic clip dataset over lists of frame paths (reference
    utils/dataset.py:517-594): ``__getitem__`` returns the decoded,
    transformed clip (T, H, W, C); past/future or rand-context splitting
    happens in the batch loader. The frames of a clip are unfiltered in one
    wavefront (:func:`png.read_pngs`)."""

    def __init__(self, clips: Sequence[Sequence[Path]], transform,
                 color_mode: str = "grey_scale"):
        self.clips = list(clips)
        self.transform = transform
        self.color_mode = color_mode

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        clip = _unit(png.read_pngs(self.clips[idx],
                                   _png_mode(self.color_mode)),
                     self.color_mode)
        return self.transform(clip, rng) if self.transform else clip


def chunk_into_clips(img_files: List[Path], clip_length: int,
                     center_remainder: bool = True) -> List[List[Path]]:
    """Consecutive non-overlapping clips of a sorted frame list; the
    remainder is dropped evenly from both ends (KTH, reference
    utils/dataset.py:329-339) or from the end."""
    n = len(img_files) // clip_length
    rem = len(img_files) % clip_length
    start = rem // 2 if center_remainder else 0
    files = img_files[start:start + n * clip_length]
    return [files[i * clip_length:(i + 1) * clip_length] for i in range(n)]


def kth_clips(root, clip_length: int, person_ids: Sequence[int],
              actions: Sequence[str] = tuple(KTH_ACTIONS)
              ) -> List[List[Path]]:
    """KTH frame folders ``action/personXX_action_dY`` of the given persons
    (reference split: 1-16 train, 17-25 test, val person 5;
    utils/dataset.py:296-304); ``.avi`` entries are skipped."""
    root = Path(root).absolute()
    folders = []
    for action in actions:
        action_path = root / action
        if not action_path.is_dir():
            continue
        folders.extend(p for p in action_path.iterdir()
                       if p.is_dir() and ".avi" not in p.name)
    clips = []
    for folder in sorted(folders):
        pid = int(folder.name.strip().split("_")[0][-2:])
        if pid not in person_ids:
            continue
        clips.extend(chunk_into_clips(sorted(folder.glob("*")), clip_length))
    return clips


def folder_clips(root, clip_length: int,
                 stride: Optional[int] = None) -> List[List[Path]]:
    """One clip stream per subfolder (BAIR: train/test folders of
    per-example frame folders; reference utils/dataset.py:362-400):
    consecutive clips, or windows every ``stride`` frames."""
    root = Path(root).absolute()
    clips = []
    for folder in sorted(p for p in root.iterdir() if p.is_dir()):
        files = sorted(folder.glob("*"))
        if stride is None:
            clips.extend(chunk_into_clips(files, clip_length,
                                          center_remainder=False))
        else:
            for s in range(0, len(files) - clip_length + 1, stride):
                clips.append(files[s:s + clip_length])
    return clips


def cityscapes_clips(root, clip_length: int) -> List[List[Path]]:
    """Cityscapes sequences grouped by (city, sequence id), file stems
    ``city_seq_frame*`` (reference utils/dataset.py:420-443); a clip never
    crosses sequences."""
    root = Path(root).absolute()
    clips = []
    for city_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        by_seq = {}
        for f in sorted(city_dir.glob("*")):
            parts = f.stem.split("_")
            if len(parts) < 3:
                continue
            by_seq.setdefault(parts[1], []).append(f)
        for files in by_seq.values():
            clips.extend(chunk_into_clips(sorted(files), clip_length,
                                          center_remainder=False))
    return clips


def kitti_clips(root, clip_length: int,
                test_folder_ids: Sequence[int] = (10, 11, 12, 13),
                train: bool = True) -> List[List[Path]]:
    """KITTI drive folders split by their index in sorted order, the test
    folders named by ``test_folder_ids`` (reference
    utils/dataset.py:445-514)."""
    root = Path(root).absolute()
    folders = sorted(p for p in root.iterdir() if p.is_dir())
    clips = []
    for i, folder in enumerate(folders):
        if train == (i in test_folder_ids):
            continue
        clips.extend(chunk_into_clips(sorted(folder.glob("*")), clip_length,
                                      center_remainder=False))
    return clips


class MovingMNISTNpz:
    """Legacy npz MovingMNIST (reference utils/dataset.py:596-670): the
    archive's first array, (T, N, H, W) in [0, 255]."""

    def __init__(self, npz_path, clip_length: int, transform=None):
        data = np.load(str(npz_path))
        arr = data[data.files[0]] if hasattr(data, "files") else data
        self.frames = np.asarray(arr, np.float32) / 255.0  # (T, N, H, W)
        self.clip_length = clip_length
        self.transform = transform

    def __len__(self):
        return self.frames.shape[1]

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        clip = self.frames[:self.clip_length, idx, :, :, None]
        return self.transform(clip, rng) if self.transform else clip


class SubsetDataset:
    """Fixed-index subset (the ``dev_set_size`` cut and the BAIR/KITTI
    train/val splits)."""

    def __init__(self, base, indices: Sequence[int]):
        self.base, self.indices = base, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx, rng=None):
        return self.base.__getitem__(self.indices[idx], rng)


class ConcatDataset:
    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        self._offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx, rng=None):
        part = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.parts[part].__getitem__(idx - int(self._offsets[part]),
                                            rng)
