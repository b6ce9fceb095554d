"""Checkpoints of the port over ``torch.save`` (port of
``npvp_tpu/core/checkpoint.py``, an Orbax manager): one file per saved step,
``max_to_keep`` retention, and with ``monitor`` the best steps by that
metric kept (``mode`` 'min' or 'max'), else the latest. An index file beside
them records each step's metrics; the trainer saves the resolved config in
the same directory.

Under data or tensor parallelism every rank calls :meth:`save` (the
state's ``state_dict`` gathers the whole model, a collective) and keeps
the index, so that every rank sees the same best step; only the writer
(rank 0) writes. The files are the one-process run's, and restore at any
rank count."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

INDEX = "checkpoints.json"


def _write_atomic(path: Path, save) -> None:
    tmp = path.with_name(path.name + ".tmp")
    save(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 5,
                 monitor: Optional[str] = None, mode: str = "min",
                 writer: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).absolute()
        self.writer = writer
        if writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep, self.monitor, self.mode = max_to_keep, monitor, mode
        index = self.directory / INDEX
        self._index = ({int(k): v for k, v in json.loads(
            index.read_text()).items()} if index.exists() else {})

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.pt"

    def _rank(self, step: int):
        """Sort key of retention: the best first."""
        if self.monitor is None:
            return -step
        value = float(self._index[step][self.monitor])
        return value if self.mode == "min" else -value

    def save(self, step: int, state, metrics: Optional[dict] = None) -> None:
        """Write ``state.state_dict()`` for ``step`` and drop the
        checkpoints past ``max_to_keep``."""
        saved = state.state_dict()
        if self.writer:
            _write_atomic(self.path(step), lambda p: torch.save(saved, p))
        self._index[int(step)] = {k: float(v)
                                  for k, v in (metrics or {}).items()}
        for old in sorted(self._index, key=self._rank)[self.max_to_keep:]:
            if self.writer:
                self.path(old).unlink(missing_ok=True)
            del self._index[old]
        if self.writer:
            _write_atomic(self.directory / INDEX, lambda p: p.write_text(
                json.dumps(self._index, indent=1)))

    def latest_step(self) -> Optional[int]:
        return max(self._index, default=None)

    def best_step(self) -> Optional[int]:
        return min(self._index, key=self._rank, default=None)

    def load(self, step: Optional[int] = None, map_location="cpu",
             mmap: bool = False) -> dict:
        """The saved state dict of ``step`` (the latest by default);
        ``mmap`` maps the file and reads a tensor when it is used."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          mmap=mmap)

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (the latest by default) into ``state`` in place and
        return it."""
        state.load_state_dict(self.load(step))
        return state


def load_model_state(path, map_location="cpu") -> dict:
    """A model's state dict from a checkpoint directory (its latest step)
    or from one checkpoint file; the file is mapped, so the optimizer's
    state beside the model is never read."""
    path = Path(path)
    saved = (CheckpointManager(path).load(map_location=map_location,
                                          mmap=True)
             if path.is_dir() else torch.load(path, map_location=map_location,
                                              mmap=True))
    return saved["model"]
