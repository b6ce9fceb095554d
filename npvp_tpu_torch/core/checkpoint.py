"""Checkpoints of the port over ``torch.save`` (port of
``npvp_tpu/core/checkpoint.py``, an asynchronous Orbax manager): one file per
saved step, ``save_interval_steps`` and ``max_to_keep`` as Orbax applies
them, and with ``monitor`` the best steps by that metric kept (``mode``
'min' or 'max'), else the latest. An index file beside them records each
step's metrics; the trainer saves the resolved config in the same
directory.

:meth:`CheckpointManager.save` gathers the state on the calling thread,
copies it into host memory (pinned buffers, reused from save to save, filled
on a side stream) and returns; one background thread writes the file, drops
the checkpoints past ``max_to_keep`` and rewrites the index. At most one
write is in flight: the next ``save`` waits for it, as do :meth:`wait`,
:meth:`close` and every read. An exception of the background write is
raised again at the next of those calls.

Under data or tensor parallelism every rank calls :meth:`save` (the
state's ``state_dict`` gathers the whole model, a collective) and keeps
the index, so that every rank sees the same best step; only the writer
(rank 0) copies and writes. The files are the one-process run's, and
restore at any rank count."""

from __future__ import annotations

import copy
import json
import os
import threading
import time
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
                 save_interval_steps: int = 1,
                 monitor: Optional[str] = None, mode: str = "min",
                 writer: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be at least 1, got "
                             f"{save_interval_steps}")
        self.directory = Path(directory).absolute()
        self.writer = writer
        if writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep, self.monitor, self.mode = max_to_keep, monitor, mode
        self.save_interval_steps = save_interval_steps
        index = self.directory / INDEX
        self._index = ({int(k): v for k, v in json.loads(
            index.read_text()).items()} if index.exists() else {})
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._host: list = []  # host buffers, one a tensor of the state
        self._streams: dict = {}
        # one record a save started: step, save_ms (the caller's time in
        # save), then, once written, write_ms and bytes (the file's size)
        self.history: list = []

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.pt"

    def _rank(self, step: int):
        """Sort key of retention: the best first."""
        if self.monitor is None:
            return -step
        value = float(self._index[step][self.monitor])
        return value if self.mode == "min" else -value

    def should_save(self, step: int) -> bool:
        """Orbax's rule: a step past the latest kept one that is a multiple
        of ``save_interval_steps``, or any such step while none is kept."""
        latest = max(self._index, default=None)
        if latest is not None and step <= latest:
            return False
        return step % self.save_interval_steps == 0 or not self._index

    def save(self, step: int, state, metrics: Optional[dict] = None) -> bool:
        """Start saving ``state.state_dict()`` for ``step`` and drop the
        checkpoints past ``max_to_keep``; → whether a save was started.
        Returns once the state is in host memory; the write goes on in the
        background."""
        t0 = time.perf_counter()
        self.wait()
        step = int(step)
        if not self.should_save(step):
            return False
        saved = state.state_dict()
        self._index[step] = {k: float(v) for k, v in (metrics or {}).items()}
        drop = sorted(self._index, key=self._rank)[self.max_to_keep:]
        for old in drop:
            del self._index[old]
        record = {"step": step}
        self.history.append(record)
        if self.writer:
            saved = self._to_host(saved)
            self._thread = threading.Thread(
                target=self._background, name=f"checkpoint-{step}",
                args=(record, step, saved, drop, dict(self._index)))
            self._thread.start()
        record["save_ms"] = (time.perf_counter() - t0) * 1e3
        return True

    def _to_host(self, tree):
        """``tree`` with every tensor copied into this manager's host
        buffers (pinned for a CUDA tensor, the copies on a side stream and
        waited for) and every other leaf deep-copied, so that updates of
        the live state after ``save`` returns do not reach the file."""
        count, used = 0, {}

        def walk(node):
            nonlocal count
            if isinstance(node, torch.Tensor):
                buf = self._buffer(count, node)
                count += 1
                if not node.is_cuda:
                    return buf.copy_(node)
                stream = used.get(node.device)
                if stream is None:
                    if node.device not in self._streams:
                        self._streams[node.device] = torch.cuda.Stream(
                            node.device)
                    stream = used[node.device] = self._streams[node.device]
                    # the copies read what the caller's stream wrote
                    stream.wait_stream(torch.cuda.current_stream(node.device))
                with torch.cuda.stream(stream):
                    return buf.copy_(node, non_blocking=True)
            if isinstance(node, dict):
                return type(node)((k, walk(v)) for k, v in node.items())
            if type(node) in (list, tuple):
                return type(node)(walk(v) for v in node)
            return copy.deepcopy(node)

        host = walk(tree)
        for stream in used.values():
            event = torch.cuda.Event()
            event.record(stream)
            event.synchronize()
        del self._host[count:]
        return host

    def _buffer(self, i: int, like: torch.Tensor) -> torch.Tensor:
        """Host buffer ``i`` shaped as ``like``: the one of the last save
        when it fits, else a new one (pinned when ``like`` is on the card)."""
        pinned = like.is_cuda
        if i < len(self._host):
            buf = self._host[i]
            if (buf.shape == like.shape and buf.dtype == like.dtype
                    and buf.is_pinned() == pinned):
                return buf
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=pinned)
        if i < len(self._host):
            self._host[i] = buf
        else:
            self._host.append(buf)
        return buf

    def _background(self, record, step, saved, drop, index) -> None:
        try:
            t0 = time.perf_counter()
            path = self.path(step)
            _write_atomic(path, lambda p: torch.save(saved, p))
            record["bytes"] = path.stat().st_size
            for old in drop:
                self.path(old).unlink(missing_ok=True)
            _write_atomic(self.directory / INDEX, lambda p: p.write_text(
                json.dumps(index, indent=1)))
            record["write_ms"] = (time.perf_counter() - t0) * 1e3
        except BaseException as e:  # raised again on the caller's thread
            self._error = e

    def wait(self) -> None:
        """Wait for the write in flight; raise its exception, if it had
        one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        """Wait for the write in flight and free the host buffers."""
        try:
            self.wait()
        finally:
            self._host, self._streams = [], {}

    def latest_step(self) -> Optional[int]:
        self.wait()
        return max(self._index, default=None)

    def best_step(self) -> Optional[int]:
        self.wait()
        return min(self._index, key=self._rank, default=None)

    def load(self, step: Optional[int] = None, map_location="cpu",
             mmap: bool = False) -> dict:
        """The saved state dict of ``step`` (the latest by default);
        ``mmap`` maps the file and reads a tensor when it is used."""
        self.wait()
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
