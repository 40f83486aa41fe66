"""The program's own spans (``vc2tpu_torch.core.trace``) read by the
``program_span`` metrics in traced runs on the CPU: the four ``decode.*``
metrics of the closed cell and ``live.fifo_wait_ms`` of the paced cell
are reported, beside the outside metrics they leave in place, and the
breakdown labels the device's idle time with the program's spans."""

from __future__ import annotations

import time

import torch

from tiny import drive

DECODE = ("decode.scan_ms", "decode.issue_ms", "decode.copy_back_ms",
          "decode.to_bytes_ms")


def test_closed_cell_reports_the_program_spans():
    rc, result, err = drive("hq1080.decode", "decode", trace=1)
    assert rc == 0, err
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    for name in DECODE:
        assert metrics[name] > 0, name
    # the program's span holds the call the outside span wraps
    assert metrics["decode.scan_ms"] >= metrics["decode.host_scan_ms"] > 0


def test_paced_cell_reports_the_fifo_wait():
    rc, result, err = drive("hq1080.decode.live", "decode", trace=1,
                            loop="paced")
    assert rc == 0, err
    assert result["correct"]
    assert result["metrics"]["live.fifo_wait_ms"]["value"] > 0
    assert result["metrics"]["live.held_pictures"]["value"] > 0


def test_breakdown_names_a_program_span(monkeypatch):
    """On the CPU the traced window is one idle gap, labelled by the span
    open at its middle: the first picture decoded under the profiler
    sleeps inside ``dec.inverse`` for 2 s, four times the window's
    0.5 s, so that middle falls in the sleep however long the rest takes
    (no picture then completes inside the window: nothing is sampled, so
    ``correct`` is not asked for)."""
    from vc2tpu_torch.wavelet import bands

    real = bands.inverse_lanes
    slept = []

    def slow(*args, **kwargs):
        if torch.autograd.profiler._is_profiler_enabled and not slept:
            slept.append(True)
            time.sleep(2.0)
        return real(*args, **kwargs)

    monkeypatch.setattr(bands, "inverse_lanes", slow)
    rc, result, err = drive("hq1080.decode", "decode", trace=1, seconds=0.5)
    assert rc == 0, err
    assert slept
    labels = [name for name, _s in result["breakdown"]["idle_gaps"]]
    assert labels[0] == "dec.inverse", labels
