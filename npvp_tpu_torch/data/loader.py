"""Batch loader and data module (port of ``npvp_tpu/data/loader.py``, one
process, no thread pool).

Batches are fixed-shape numpy dicts:

- ``pairs``: (past, future) clips, for VFP training;
- ``vfi``: boundary and middle frames by fixed index lists;
- ``rand_context``: the full clip plus per-batch boolean (T,)
  ``obs_mask``/``tgt_mask``, one random split per batch.

Epoch ``e`` shuffles with ``SeedSequence([seed, e])`` and draws each
batch's split from ``SeedSequence([seed + 7, e, 0])``, in the order of the
JAX loader (split point, then permutation), so both loaders yield the same
batches from the same dataset as the JAX loader's process 0.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from npvp_tpu_torch.data.smmnist import StochasticMovingMNIST
from npvp_tpu_torch.data.transforms import build_transforms


class SubsetDataset:
    """Fixed-index subset (``dev_set_size`` truncation)."""

    def __init__(self, base, indices: Sequence[int]):
        self.base, self.indices = base, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.base[self.indices[idx]]


class ConcatDataset:
    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        self._offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        part = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.parts[part][idx - int(self._offsets[part])]


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 num_past: int, num_future: int, mode: str = "pairs",
                 min_lo: int = 1, max_lo: Optional[int] = None,
                 to_idx: Optional[Sequence[int]] = None,
                 tp_idx: Optional[Sequence[int]] = None, seed: int = 0,
                 drop_last: bool = True):
        if mode not in ("pairs", "vfi", "rand_context"):
            raise ValueError(f"unknown mode {mode!r}")
        self.dataset, self.batch_size, self.shuffle = (dataset, batch_size,
                                                       shuffle)
        self.num_past, self.num_future = num_past, num_future
        self.clip_length = num_past + num_future
        self.mode, self.min_lo = mode, min_lo
        self.max_lo = max_lo if max_lo is not None else self.clip_length - 1
        self.to_idx = None if to_idx is None else np.asarray(to_idx)
        self.tp_idx = None if tp_idx is None else np.asarray(tp_idx)
        self.seed, self.drop_last = seed, drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = np.random.default_rng(np.random.SeedSequence(
                [self.seed, self.epoch])).permutation(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _make_batch(self, sample_ids, batch_rng) -> Dict[str, np.ndarray]:
        clip = np.stack([self.dataset[int(i)] for i in sample_ids]
                        ).astype(np.float32)               # (N, T, H, W, C)
        if self.mode == "pairs":
            return {"past": clip[:, :self.num_past],
                    "future": clip[:, self.num_past:]}
        if self.mode == "vfi":
            return {"past": clip[:, self.to_idx],
                    "future": clip[:, self.tp_idx]}
        T = self.clip_length
        lo = int(batch_rng.integers(self.min_lo, self.max_lo + 1))
        obs_mask = np.zeros(T, bool)
        obs_mask[batch_rng.permutation(T)[:lo]] = True
        return {"clip": clip, "obs_mask": obs_mask, "tgt_mask": ~obs_mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batch_rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed + 7, self.epoch, 0]))
        for b in range(len(self)):
            yield self._make_batch(
                idx[b * self.batch_size:(b + 1) * self.batch_size], batch_rng)


class DataModule:
    """Config → SMMNIST train/val/test datasets and loaders: ``phase:
    deploy`` merges train and val, ``dev_set_size`` truncates train and val,
    and ``len_train_loader`` is kept for the per-batch rate schedule. Other
    datasets raise ``NotImplementedError`` (their loaders are not ported)."""

    def __init__(self, cfg, sprites: Optional[Dict[str, np.ndarray]] = None):
        self.cfg = cfg
        self.sprites = sprites or {}
        self.train_transform, self.renorm = build_transforms(
            cfg.Dataset.name, True)
        self.test_transform, _ = build_transforms(cfg.Dataset.name, False)
        self.len_train_loader: Optional[int] = None
        self._built = {}

    def _frames(self, split: str):
        d = self.cfg.Dataset
        if split == "test":
            return d.test_num_past_frames, d.test_num_future_frames
        return d.num_past_frames, d.num_future_frames

    def _build_split(self, split: str):
        d = self.cfg.Dataset
        past, future = self._frames(split)
        train = split != "test"
        return StochasticMovingMNIST(
            train=train, num_past_frames=past, num_future_frames=future,
            image_size=d.img_size,
            transform=(self.train_transform if split == "train"
                       else self.test_transform),
            sprites=self.sprites.get("train" if train else "test"))

    def dataset(self, split: str):
        if split not in self._built:
            ds = self._build_split(split)
            d = self.cfg.Dataset
            if split == "train" and d.phase == "deploy":
                ds = ConcatDataset([ds, self._build_split("val")])
            if d.dev_set_size is not None and split in ("train", "val"):
                ds = SubsetDataset(ds, np.arange(min(d.dev_set_size,
                                                     len(ds))))
            self._built[split] = ds
        return self._built[split]

    def _loader(self, split: str, mode: str) -> BatchLoader:
        cfg, d, p = self.cfg, self.cfg.Dataset, self.cfg.Predictor
        num_past, num_future = self._frames(split)
        to_idx = tp_idx = None
        if mode == "vfi":
            total = num_past + num_future
            to_idx = (list(range(p.context_num_p))
                      + list(range(total - p.context_num_f, total)))
            tp_idx = list(range(p.context_num_p, total - p.context_num_f))
        return BatchLoader(
            self.dataset(split), d.batch_size, shuffle=(split == "train"),
            num_past=num_past, num_future=num_future, mode=mode,
            min_lo=p.min_lo, max_lo=p.max_lo, to_idx=to_idx, tp_idx=tp_idx,
            seed=cfg.Env.rand_seed + {"train": 0, "val": 1, "test": 2}[split],
            drop_last=(split != "test"))

    def predictor_mode(self) -> str:
        p = self.cfg.Predictor
        if p.rand_context:
            return "rand_context"
        return "vfi" if p.VFI else "pairs"

    def train_loader(self, mode: Optional[str] = None) -> BatchLoader:
        loader = self._loader("train", mode or "pairs")
        self.len_train_loader = len(loader)
        return loader

    def val_loader(self, mode: Optional[str] = None) -> BatchLoader:
        return self._loader("val", mode or "pairs")

    def test_loader(self, mode: Optional[str] = None) -> BatchLoader:
        return self._loader("test", mode or "pairs")
