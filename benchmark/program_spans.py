"""The program's own records of a traced run (``vc2tpu_torch.core.trace``),
which the ``program_span`` metrics read: the port's spans, kept while the
profiler collects, on the host clock of the harness's stamps. A program
without that module keeps none, and a metric that reads them then finds
nothing."""

from __future__ import annotations


def mean_ms(run, name: str):
    """Mean host ms of the program's records ``name`` held wholly within
    the traced window (``run.trace.host``); None when there are none."""
    if run.trace is None:
        return None
    try:
        from vc2tpu_torch.core import trace
    except ImportError:
        return None
    t0, t1 = run.trace.host
    ms = [r.end - r.start for r in trace.records()
          if r.name == name and t0 <= r.start and r.end <= t1]
    return 1e3 * sum(ms) / len(ms) if ms else None
