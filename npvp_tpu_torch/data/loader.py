"""Batch loader and per-dataset data module (port of
``npvp_tpu/data/loader.py`` for one training process).

Batches are fixed-shape numpy dicts:

- ``pairs``: (past, future) clips, for VFP training;
- ``vfi``: boundary and middle frames by fixed index lists;
- ``rand_context``: the full clip plus per-batch boolean (T,)
  ``obs_mask``/``tgt_mask``, one random split per batch.

Epoch ``e`` shuffles with ``SeedSequence([seed, e])``; sample ``i`` of it
is fetched with its own generator ``SeedSequence([seed, e, i])``, which the
random flips draw from, so a batch does not depend on the number of
workers; each batch's split comes from ``SeedSequence([seed + 7, e, 0])``
(split point, then permutation). These are the JAX loader's streams (its
process 0), so both loaders yield the same batches from the same data.

A producer thread assembles the batches ``prefetch`` ahead of the consumer.
It fetches a loader's first batch itself, timed; if that took at least
``POOL_MIN_FETCH_MS`` and ``num_workers`` > 1, the later batches are
fetched on a pool of worker processes, else in the producer thread. Every
fetch in the trainer's process holds the interpreter lock the training loop
needs: PNG decode is thousands of small numpy calls, and decoding in the
trainer's process made a KTH train step on an H100 host 1.6-2× slower
than on worker processes, while SMMNIST's cheap rendering is slower to ship
through a pool than to do in the thread (``PERF.md``). The pool has ``min(num_workers, batch_size)``
processes (one batch is in flight at a time), each given the dataset
once; it serves the loader's later epochs too, and
:meth:`BatchLoader.close` stops it (so does collecting the loader).
Workers are forked from ``multiprocessing``'s fork server, a
single-threaded process that has imported this module: safe beside
threads, as ``spawn`` is, but far quicker to start, and free of torch. As
with any such pool, a script that iterates the loader guards its entry
point with ``if __name__ == "__main__":``.

A failure in the producer reaches the consumer as ``RuntimeError("data
producer failed at epoch …")`` after the batches that came before it; it
is never swallowed. ``last_wait_ms`` is how long the consumer waited on
the queue for the batch it was last given: near zero while the loader
keeps ahead.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from npvp_tpu_torch.data import datasets as D
from npvp_tpu_torch.data.datasets import ConcatDataset, SubsetDataset
from npvp_tpu_torch.data.smmnist import StochasticMovingMNIST
from npvp_tpu_torch.data.transforms import build_transforms

# A batch that takes less than this to fetch in the producer thread is not
# worth a worker pool: SMMNIST's batches (a few ms to render) made the
# stage-1 step slower through a pool than in the thread, KTH's PNG batches
# (~0.5 s) made the stage-2 step faster (PERF.md, PR 7).
POOL_MIN_FETCH_MS = 20.0


def _fetch(dataset, seed: int, epoch: int, i: int) -> np.ndarray:
    """Sample ``i`` of ``epoch`` drawn with its own generator."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, i]))
    return dataset.__getitem__(i, rng)


# the dataset of a fetch worker process, given once by its initializer
_WORKER = {}


def _init_worker(dataset) -> None:
    _WORKER["dataset"] = dataset


def _fetch_in_worker(seed: int, epoch: int, i: int) -> np.ndarray:
    return _fetch(_WORKER["dataset"], seed, epoch, i)


def _worker_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 num_past: int, num_future: int, mode: str = "pairs",
                 min_lo: int = 1, max_lo: Optional[int] = None,
                 to_idx: Optional[Sequence[int]] = None,
                 tp_idx: Optional[Sequence[int]] = None, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = True,
                 prefetch: int = 2):
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
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.epoch = 0
        self.last_wait_ms = 0.0
        self._use_pool: Optional[bool] = None  # decided by the first batch
        self._pool: Optional[ProcessPoolExecutor] = None

    def _workers(self) -> Optional[ProcessPoolExecutor]:
        workers = min(self.num_workers, self.batch_size)
        if not self._use_pool or workers <= 1:
            return None
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                workers, _worker_context(), _init_worker, (self.dataset,))
        return self._pool

    def close(self) -> None:
        """Stop the worker processes (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

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

    def _make_batch(self, sample_ids, batch_rng, pool
                    ) -> Dict[str, np.ndarray]:
        ids = [int(i) for i in sample_ids]
        if pool is None:
            clips = [_fetch(self.dataset, self.seed, self.epoch, i)
                     for i in ids]
        else:
            clips = list(pool.map(_fetch_in_worker, [self.seed] * len(ids),
                                  [self.epoch] * len(ids), ids))
        clip = np.stack(clips).astype(np.float32)          # (N, T, H, W, C)
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
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = object()
        failure: list = []
        done = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone away."""
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(len(self)):
                    ids = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    t0 = time.perf_counter()
                    batch = self._make_batch(ids, batch_rng, self._workers())
                    if self._use_pool is None:
                        self._use_pool = ((time.perf_counter() - t0) * 1e3
                                          >= POOL_MIN_FETCH_MS)
                    if not put(batch):
                        return
            except BaseException as exc:  # handed to the consumer below
                failure.append(exc)
                self.close()  # a pool may be broken: the next epoch restarts
            finally:
                put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.last_wait_ms = (time.perf_counter() - t0) * 1e3
                if item is stop:
                    break
                yield item
        finally:
            done.set()  # a consumer that stops early releases the producer
            thread.join()
        if failure:
            raise RuntimeError(
                f"data producer failed at epoch {self.epoch}") from failure[0]


class DataModule:
    """Config → train/val/test datasets and loaders for every dataset of
    the shipped configs (reference LitDataModule, utils/dataset.py:25-160):
    the per-dataset transform pipelines and splits, ``phase: deploy``
    merging train and val, the ``dev_set_size`` cut of train and val, and
    ``len_train_loader`` for the per-batch rate schedule. ``sprites``
    optionally maps "train"/"test" to SMMNIST sprite banks."""

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
        L = past + future
        name = "Cityscapes" if d.name == "CityScapes" else d.name
        tf = self.train_transform if split == "train" else self.test_transform
        if name == "SMMNIST":
            train = split != "test"
            return StochasticMovingMNIST(
                train=train, num_past_frames=past, num_future_frames=future,
                image_size=d.img_size, transform=tf,
                sprites=self.sprites.get("train" if train else "test"))
        if name == "MovingMNIST":
            fname = {"train": "moving-mnist-train.npz",
                     "val": "moving-mnist-valid.npz",
                     "test": "moving-mnist-test.npz"}[split]
            return D.MovingMNISTNpz(Path(d.dir) / fname, L, tf)
        if name == "KTH":
            persons = {"train": [p for p in range(1, 17) if p != 5],
                       "val": [5],
                       "test": list(range(17, 26))}[split]
            return D.ClipDataset(D.kth_clips(d.dir, L, persons), tf,
                                 "grey_scale")
        if name == "BAIR":
            sub = "test" if split == "test" else "train"
            ds = D.ClipDataset(D.folder_clips(Path(d.dir) / sub, L), tf,
                               "RGB")
            if split == "test":
                return ds
            cut = int(len(ds) * 0.95)
            perm = np.random.default_rng(2021).permutation(len(ds))
            return SubsetDataset(ds, perm[:cut] if split == "train"
                                   else perm[cut:])
        if name == "Cityscapes":
            return D.ClipDataset(D.cityscapes_clips(Path(d.dir) / split, L),
                                 tf, "RGB")
        if name == "KITTI":
            ds = D.ClipDataset(D.kitti_clips(d.dir, L,
                                             train=(split != "test")),
                               tf, "RGB")
            if split == "test":
                return ds
            cut = int(len(ds) * 0.95)
            return SubsetDataset(ds, np.arange(cut) if split == "train"
                                   else np.arange(cut, len(ds)))
        raise ValueError(f"unknown dataset {name!r}")

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
            num_workers=d.num_workers, drop_last=(split != "test"))

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
