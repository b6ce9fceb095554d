"""Spans of the port's layers, kept in memory.

    from npvp_tpu_torch.core import tracing

    with tracing.span("npvp.predictor.decoder"):
        out = self.decoder(...)

Each layer opens its span in its own code (the serving call, the AE, the
predictor's sublayers, the train step's phases, the loader). One switch,
off by default, decides what a span does; it is set by a call only
(:func:`enable`, :func:`disable`), never by an environment variable or a
config key.

- **Off**: :func:`span` returns one shared context that does nothing: a
  function call and one global check, no clock read, no allocation, no
  ``record_function``.
- **On**: each span records a :class:`Span` when it closes: its name, its
  id, the id of the span open around it on its thread (``parent``) and of
  the outermost one (``root``: the spans of one request or one step share
  it), its thread, its start and end, and the CPU time of its thread
  inside it. Start and end are ``time.time_ns()``: the clock of the
  ``torch.profiler``'s events, which kineto gives on the Unix epoch, so a
  span lines up with the device trace. The thread CPU time comes in the
  steps of the host's thread clock (``time.thread_time_ns``), which some
  virtualised hosts count in 10 ms ticks: a mean over many spans holds
  there, a single short span does not. Only while a profiler runs on the
  span's thread does the span also open a ``record_function`` of its
  name, so that it enters the profiler's trace (a ``StepProfiler``
  window's Chrome trace shows the spans so).

:func:`take` returns the records kept and clears them; the newest
:data:`CAP` are kept. Every name starts with :data:`PREFIX`.

This module imports nothing of torch until tracing is turned on: the data
loader's worker processes import the loader, which opens spans, without
torch.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable, List, NamedTuple, Optional

PREFIX = "npvp."
CAP = 1_000_000  # records kept: an operator's long run cannot grow it more


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]    # the span open around it on its thread
    root: int                # the outermost span open on its thread
    thread: int              # threading.get_ident() of its thread
    start_ns: int            # time.time_ns(), the profiler's clock
    end_ns: int
    thread_cpu_ns: int       # its thread's CPU time inside it


_on = False
_records: collections.deque = collections.deque(maxlen=CAP)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
# bound by enable(), so that this module imports torch only when it is on
_profiling: Optional[Callable[[], bool]] = None
_record_function = None


class _Off:
    """The span while tracing is off. Entering and leaving it call
    ``"".format``, a builtin that takes any arguments and returns ``""``
    (false, so an exception passes through): cheaper than a method written
    in Python."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _On:
    """One span while tracing is on; records itself when it closes."""

    __slots__ = ("name", "id", "parent", "root", "start", "cpu", "rf")

    def __init__(self, name: str):
        if not name.startswith(PREFIX):
            raise ValueError(f"span {name!r} does not start with {PREFIX!r}")
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent, self.root = ((stack[-1].id, stack[0].id) if stack
                                  else (None, self.id))
        stack.append(self)
        self.rf = None
        if _profiling():
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        self.cpu = time.thread_time_ns()
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        cpu = time.thread_time_ns() - self.cpu
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        _local.stack.pop()
        record = Span(self.name, self.id, self.parent, self.root,
                      threading.get_ident(), self.start, end, cpu)
        with _lock:
            _records.append(record)
        return False


def span(name: str):
    """The context of span ``name`` (which starts with ``npvp.``)."""
    if _on:
        return _On(name)
    return _OFF


def enable() -> None:
    """Turn tracing on (for every thread of the process)."""
    global _on, _profiling, _record_function
    import torch

    _profiling = torch.autograd._profiler_enabled
    _record_function = torch.autograd.profiler.record_function
    _on = True


def disable() -> None:
    """Turn tracing off; spans still open record themselves as they close."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> List[Span]:
    """The records kept (in the order the spans closed), cleared."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out
