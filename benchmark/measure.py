"""What a run measured, and the arithmetic the metrics share.

``Run`` holds a finished run: the cell, its configuration and traffic,
the window's stamps, the spans and the trace (traced runs), and the
reference's coded pictures. The per-layer metrics (``metrics/<name>.py``)
and the kernels' counts (``kernels/<kernel>.py``) are found by name and
read it. The peaks are the published ones of one NVIDIA H100 SXM (data
sheet, dense): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores, against which the kernels' integer operations are counted.
"""

from __future__ import annotations

import importlib.util
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_RATE = 3.35e12           # bytes/s
OP_RATE = 67e12              # operations/s


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (``metrics`` or
    ``kernels``), loaded by its path: a name may hold dots."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str) -> list:
    """Every module of ``<kind>/``, by name."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(".py") and not f.startswith("_"))


def nearest_rank(values: list, p: float) -> float:
    """The p-th percentile by nearest rank: the smallest value with at
    least p % of the values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(p / 100 * len(s)), 1) - 1]


class Run:
    """A finished run, as the metrics read it."""

    def __init__(self, cell, config, traffic, window, spans=None,
                 trace=None, coded=None, codec=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.coding = config["coding"]
        self.window = window
        self.spans, self.trace = spans, trace
        self.coded, self.codec = coded, codec

    # --- the stamps ---------------------------------------------------------

    def in_window(self) -> list:
        """The indices of the pictures completed in the window."""
        w = self.window
        return [i for i in range(len(w.done)) if w.in_window(i)]

    def latency_ms(self, i: int) -> float:
        """Picture i's latency: from its last input byte handed over (paced:
        from when it was due) to its output complete."""
        w = self.window
        start = w.due[i] if self.traffic.get("rate") else w.handed[i]
        return 1e3 * (w.done[i] - start)

    def traced_window(self) -> list:
        """The indices of the pictures completed in the traced window."""
        t0, t1 = self.trace.host
        return [i for i, t in enumerate(self.window.done) if t0 < t <= t1]

    # --- spans --------------------------------------------------------------

    def span_ms(self, name: str):
        """Mean host ms of a call of span ``name`` in the traced window;
        None when it was not called there."""
        if self.spans is None or self.trace is None:
            return None
        t0, t1 = self.trace.host
        calls = self.spans.within(name, t0, t1)
        if not calls:
            return None
        return 1e3 * sum(b - a for a, b in calls) / len(calls)

    # --- the trace ----------------------------------------------------------

    def device_ms_per_picture(self, match):
        """Device ms a picture of the operations ``match`` accepts; None
        when none ran in the traced window."""
        if self.trace is None:
            return None
        launches, ms = self.trace.device_ms(match)
        pictures = len(self.traced_window())
        if not launches or not pictures:
            return None
        return ms / pictures

    def roofline(self, kernels: list):
        """Percent of the roofline of ``kernels`` (names of
        ``kernels/``) over the traced window: the sum over their launches
        of the least time the chip could take, max(bytes / MEM_RATE,
        operations / OP_RATE), over the sum of their device time. None
        when none of them ran."""
        if self.trace is None or not self.coded:
            return None
        bound_s, device_ms = 0.0, 0.0
        for name in kernels:
            k = load("kernels", name)
            launches, ms = self.trace.device_ms(k.matches)
            if not launches:
                continue
            nbytes, nops = k.count(self)
            per_picture = max(nbytes / MEM_RATE, nops / OP_RATE)
            bound_s += per_picture * launches / k.launches(self)
            device_ms += ms
        if device_ms == 0:
            return None
        return 100.0 * 1e3 * bound_s / device_ms

    def kernels_run(self) -> list:
        """The kernels of ``kernels/`` that ran in the traced window."""
        if self.trace is None:
            return []
        return [n for n in names("kernels")
                if self.trace.device_ms(load("kernels", n).matches)[0]]

    def idle_percent(self):
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1 - self.trace.busy_s / self.trace.window_s)

    # --- the reference's pictures, for the kernels' counts -----------------

    def mean_over_pictures(self, fn) -> float:
        """The mean of ``fn(coded picture)`` over the distinct pictures."""
        return sum(fn(c) for c in self.coded) / len(self.coded)

    def plane_samples(self) -> list:
        """Samples of each padded plane."""
        return [h * w for h, w in self.codec.padded]
