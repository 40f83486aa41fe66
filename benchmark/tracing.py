"""The traced run: spans around the program's callables, the profiler over
the window, and the reduction of both to what the per-layer metrics read.

A span wraps a callable where its caller looks it up (``module``,
``attribute``, a dotted attribute for a method) and records, on the host
clock, when each call began and ended; while the profiler runs it is also
a user annotation in the trace (``span:<name>``), which labels the
device's idle gaps. The profiler (``torch.profiler``, CPU and CUDA
activities) runs from the window's opening to its close; the device's
operations are read from its raw events.
"""

from __future__ import annotations

import functools
import importlib

import torch

from loop import clock

MARK = "span:"


class Spans:
    """Each named span's (start, end) on ``clock``."""

    def __init__(self):
        self.calls: dict = {}
        self.undo: list = []

    def wrap(self, name: str, module: str, attribute: str) -> None:
        """Span every call of ``module.attribute`` made through that
        name."""
        owner = importlib.import_module(module)
        *path, leaf = attribute.split(".")
        for part in path:
            owner = getattr(owner, part)
        self.wrap_on(name, owner, leaf)

    def wrap_on(self, name: str, owner, leaf: str) -> None:
        """Span every call of ``owner.leaf`` (a module, a class or an
        object)."""
        fn = getattr(owner, leaf)
        calls = self.calls.setdefault(name, [])
        label = MARK + name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = clock()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            calls.append((t0, clock()))
            return out

        setattr(owner, leaf, spanned)
        self.undo.append((owner, leaf, fn))

    def restore(self) -> None:
        for owner, leaf, fn in reversed(self.undo):
            setattr(owner, leaf, fn)
        self.undo = []

    def within(self, name: str, t0: float, t1: float) -> list:
        """The calls of span ``name`` made wholly within [t0, t1]."""
        return [(a, b) for a, b in self.calls.get(name, ())
                if t0 <= a and b <= t1]


class Profile:
    """``torch.profiler`` over the window. ``start`` at the window's
    opening, ``stop`` at its close; ``reduce`` then reads the raw events."""

    def __init__(self, on_card: bool = True):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.acts = acts
        self.on_card = on_card
        self.prof = torch.profiler.profile(activities=acts)
        self.host = (None, None)        # the window on the host clock

    def warm(self) -> None:
        """Start and stop a profiler once, in the set-up, so that the
        window's start does not pay the tracer's first start."""
        with torch.profiler.profile(activities=self.acts):
            torch.zeros(1).add_(1)

    def start(self) -> None:
        self.prof.start()
        with torch.profiler.record_function("bench.window.open"):
            pass
        self.host = (clock(), None)

    def stop(self) -> None:
        with torch.profiler.record_function("bench.window.close"):
            pass
        self.host = (self.host[0], clock())
        if self.on_card:
            torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self) -> "Trace":
        return Trace(self.prof.profiler.kineto_results.events(), self.host)


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else 1000 * int(getattr(
        e, f"{what}_us")())


class Trace:
    """The device's operations in the traced window: ``ops`` (name, start
    ns, duration ns), clipped to the window's markers; ``spans`` the host
    spans' annotations (name, start ns, end ns); ``window_s`` the window's
    length; ``busy_s`` the seconds in which an operation ran."""

    def __init__(self, events, host):
        cuda = torch.autograd.DeviceType.CUDA
        self.ops, self.spans, marks = [], [], {}
        for e in events:
            name = e.name()
            start, dur = _ns(e, "start"), _ns(e, "duration")
            on_card = e.device_type() == cuda
            if e.is_user_annotation() or name.startswith(MARK):
                # a span or a mark; the card's mirror of one is no operation
                if on_card:
                    continue
                if name.startswith(MARK):
                    self.spans.append((name[len(MARK):], start, start + dur))
                elif name.startswith("bench.window."):
                    marks[name] = start
            elif on_card:
                self.ops.append((name, start, dur))
        lo = marks.get("bench.window.open",
                       min((s for _n, s, _d in self.ops), default=0))
        hi = marks.get("bench.window.close",
                       max((s + d for _n, s, d in self.ops), default=lo))
        self.host = host
        self.ops = [(n, max(s, lo), min(s + d, hi) - max(s, lo))
                    for n, s, d in self.ops if s + d > lo and s < hi]
        self.window_s = (hi - lo) / 1e9
        merged = _merge([(s, s + d) for _n, s, d in self.ops])
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        self.gaps = _gaps(merged, lo, hi)

    def device_ms(self, match) -> tuple:
        """(launches, device ms) of the operations whose name ``match``
        accepts."""
        hits = [d for n, _s, d in self.ops if match(n)]
        return len(hits), sum(hits) / 1e6

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` operations that took most device time, by name."""
        total: dict = {}
        for n, _s, d in self.ops:
            total[n] = total.get(n, 0) + d
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, d / 1e9] for n, d in top]

    def idle_by_span(self, k: int = 10) -> list:
        """The device's idle time in the window, by the innermost host span
        open at each gap's middle ("host, no span" when none is), the
        ``k`` largest."""
        spans = sorted(self.spans, key=lambda s: s[1])
        total: dict = {}
        for a, b in self.gaps:
            mid = (a + b) // 2
            label, width = "host, no span", None
            for name, s, e in spans:
                if s > mid:
                    break
                if e >= mid and (width is None or e - s < width):
                    label, width = name, e - s
            total[label] = total.get(label, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, d / 1e9] for n, d in top]


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _gaps(merged: list, lo: int, hi: int) -> list:
    gaps, at = [], lo
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps
