"""The decode path's spans (``vc2tpu_torch.core.trace``) on the CPU, HQ
and LD at 64x32: with no profiler a span site is one flag check (no
record, no ``record_function``, no clock read); under
``torch.profiler`` every picture gives each ``dec.*`` span once, nested as
the stages run, and one ``dec.fifo`` wait per output; the buffer of
records stays bounded. The decode's bytes stay the golden's either way."""

import io
import os
import time

import pytest
import torch

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import trace

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = ["cbr_legall_d2", "ld_legall_d2"]
STAGES = ("dec.upload", "dec.unpack", "dec.inverse", "dec.format")
# an LD picture's: its LL grids from the lanes between unpack and inverse
LD_STAGES = ("dec.upload", "dec.unpack", "dec.ld_dc", "dec.inverse",
             "dec.format")
LD_SCAN = ("dec.ld_read",)     # the LD header walk, inside the scan


def _stages(case):
    return LD_STAGES if case.startswith("ld") else STAGES


def _once(case):
    return ("dec.scan", "dec.issue", *_stages(case), "dec.fifo",
            "dec.copy_back", "dec.to_bytes") + (
        LD_SCAN if case.startswith("ld") else ())
CPU = [torch.profiler.ProfilerActivity.CPU]


def _decode(case):
    with open(os.path.join(GOLDEN, case + ".vc2"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, case + ".dec.16p2"), "rb") as f:
        want = f.read()
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu").run(data) == 0
    assert sink.getvalue() == want


def _since(t0):
    return [r for r in trace.records() if r.start >= t0]


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_keeps_nothing(case, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span did work with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "clock", refuse)
    t0 = time.perf_counter()
    _decode(case)
    assert not _since(t0)
    assert trace.span("dec.scan") is trace.span("dec.issue", 7)
    assert trace.stamp() is None


@pytest.mark.parametrize("case", CASES)
def test_profiled_decode_spans_each_picture(case):
    t0 = trace.clock()
    with torch.profiler.profile(activities=CPU) as prof:
        _decode(case)
    got = _since(t0)
    pictures = sorted({r.picture for r in got})
    assert len(pictures) == 2 and None not in pictures
    for name in _once(case):
        assert sorted(r.picture for r in got if r.name == name) == pictures
    at = {(r.name, r.picture): r for r in got}
    for p in pictures:
        scan, issue = at["dec.scan", p], at["dec.issue", p]
        stages = [at[name, p] for name in _stages(case)]
        assert scan.end <= issue.start <= stages[0].start
        for a, b in zip(stages, stages[1:]):
            assert a.end <= b.start
        assert stages[-1].end <= issue.end
        fifo = at["dec.fifo", p]
        copy, to_bytes = at["dec.copy_back", p], at["dec.to_bytes", p]
        assert issue.end <= fifo.start <= fifo.end <= copy.start
        assert copy.end <= to_bytes.start
    # the profiler's own trace, on its clock: each span a picture, and the
    # stages inside an issue
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            marks.setdefault(e.name()[len(trace.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(marks) == sorted(n for n in _once(case) if n != "dec.fifo")
    assert all(len(v) == len(pictures) for v in marks.values())
    for name in _stages(case):
        for a, b in marks[name]:
            assert any(lo <= a and b <= hi for lo, hi in marks["dec.issue"])
    for name in set(LD_SCAN) & set(marks):
        for a, b in marks[name]:
            assert any(lo <= a and b <= hi for lo, hi in marks["dec.scan"])


def test_records_stay_bounded():
    with torch.profiler.profile(activities=CPU):
        since = trace.stamp()
        for i in range(trace.KEPT + 10):
            trace.wait("dec.fifo", i, since)
    kept = trace.records()
    assert len(kept) == trace.KEPT
    assert [r.picture for r in kept[-2:]] == [trace.KEPT + 8, trace.KEPT + 9]
