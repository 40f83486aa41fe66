"""Spans of the decode path, kept only while a torch profiler collects.

``span(name)`` marks a stage of the program. While a ``torch.profiler``
(or ``torch.autograd.profiler``) is collecting, it opens a
``torch.profiler.record_function("span:" + name)`` range, so the stage
shows in the profiler's trace on the clock the device's operations carry,
and keeps a ``Record`` (name, picture number, start, end on ``clock``) in
a bounded buffer that ``records()`` reads. ``wait`` records an interval
that is not a nested call, such as an output's wait in a queue, from a
``stamp()`` taken where the wait began.

With no profiler collecting, a span site costs one check of torch's own
flag (``torch.autograd.profiler._is_profiler_enabled``, which torch sets
when a profiler starts and clears when it stops) and returns a shared
no-op context: no clock read, no ``record_function``, no allocation.

The buffer is the process's, as the profiler is: a span records the
picture number given to it, or else that of the innermost open span
that has one. Spans are opened from one thread.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "span:"
KEPT = 1 << 15                # records kept; the oldest go first
clock = time.perf_counter     # the host clock of the records


class Record(NamedTuple):
    name: str
    picture: int | None
    start: float
    end: float


_records: collections.deque = collections.deque(maxlen=KEPT)
_open: list = []              # picture numbers of the open spans
_OFF = contextlib.nullcontext()


def records() -> tuple:
    """The records kept, oldest first."""
    return tuple(_records)


def span(name: str, picture: int | None = None):
    """The context of stage ``name`` of picture ``picture``: recorded
    while a profiler collects, a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name, picture)


@contextlib.contextmanager
def _recorded(name: str, picture: int | None):
    if picture is None and _open:
        picture = _open[-1]
    _open.append(picture)
    try:
        start = clock()
        with torch.profiler.record_function(PREFIX + name):
            yield
        _records.append(Record(name, picture, start, clock()))
    finally:
        _open.pop()


def stamp() -> float | None:
    """``clock()`` while a profiler collects, else None: where a wait
    that ``wait`` records begins."""
    return clock() if _profiler._is_profiler_enabled else None


def wait(name: str, picture: int | None, since: float | None) -> None:
    """Record ``name`` of ``picture`` from ``since`` (a ``stamp()``) to
    now, when both ends fall while a profiler collects."""
    if since is not None and _profiler._is_profiler_enabled:
        _records.append(Record(name, picture, since, clock()))
