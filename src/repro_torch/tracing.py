"""The port's tracer: recorded host spans and profiler-only regions.

Two entry points:

* ``span(name, **attrs)`` — a recorded span. Entering and leaving it read
  ``time.perf_counter_ns()``; on leaving, the span itself goes into a
  bounded in-memory ring as one record: its name, start and end (ns), its
  attributes (``step``, ``node``, ``rows``...), the span that encloses it
  on the same thread (``parent``, None at the top) and its ``id``, the
  count of records made before it. ``span.seconds`` is its duration: the
  port's reports take their wall times from it.
* ``region(name)`` — a profiler-only range. It costs one attribute read
  and records nothing unless a ``torch.profiler`` is recording. It goes
  below the work call, where host times mean nothing because kernels run
  asynchronously.

While a profiler records, a span and a region also open a profiler range
of their name, so they sit on the profiler's timeline, on the same clock
as the card's kernels. The range is a plain host range (the profiler's
function scope): it draws no annotation on the device's timeline, so a
reduction of the trace that treats every device event as work sees the
kernels alone. With no profiler recording, no range is opened.

The ring holds :data:`CAPACITY` records; past that the oldest goes and
``dropped()`` counts it. ``spans()`` returns the records, oldest first;
``clear()`` empties the ring and restarts the count.

The spans, from the entry points down:

  train.step > train.batch, train.sync, pipeline.drain
  serve.run > serve.round > serve.work > serve.decode, serve.sync;
              serve.round > pipeline.drain
  cluster.step > cluster.work, pipeline.drain
  pipeline.drain > pipeline.{detect,notice,agree,plan,apply}
  pipeline.apply > repair.{shrink,substitute}, pipeline.reshard
  repair.splice, checkpoint.{save,snapshot}, compile, dryrun.cell

and the regions: model.attention, model.ssd, model.mlp,
model.moe.{route,dispatch,experts,combine,shared}, model.loss, optim.clip,
optim.adamw. A layer's mixer runs under model.attention or model.ssd (a
hybrid layer's under both; under a layer pattern, an "A" layer's under the
first and an "M" layer's under the second), and a shared expert under
model.moe.shared.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

CAPACITY = 65536

_clock = time.perf_counter_ns
_ids = itertools.count()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_NULL = contextlib.nullcontext()


class _Open(threading.local):
    """The innermost open span of each thread."""
    top = None


_open = _Open()


class span:
    """A recorded span (module docstring); a context manager that returns
    itself, and afterwards its record."""

    __slots__ = ("name", "attrs", "parent", "id", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        innermost = _open
        self.parent = innermost.top
        innermost.top = self
        if _profiler._is_profiler_enabled:
            self._range = rng = _RecordFunctionFast(self.name)
            rng.__enter__()
        else:
            self._range = None
        self.start_ns = _clock()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.end_ns = _clock()
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
        _open.top = self.parent
        # ``next`` and ``append`` are atomic: no lock
        self.id = next(_ids)
        _ring.append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def region(name: str):
    """A profiler-only range (module docstring): a range of ``name`` while
    a profiler records, else a context that does nothing."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NULL


def spans() -> list[span]:
    """The recorded spans, oldest (by end) first."""
    return list(_ring)


def dropped() -> int:
    """Records the full ring let go: every record made less those it holds
    (exact while no span is ending on another thread)."""
    ring = _ring
    return ring[-1].id + 1 - len(ring) if ring else 0


def clear() -> None:
    """Empty the ring and restart the count."""
    global _ids
    _ids = itertools.count()
    _ring.clear()
