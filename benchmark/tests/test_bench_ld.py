"""The LD cell, ``ld1080.decode``, on the CPU: its manifest entries report
``decode_fps`` and its per-layer metrics from ``BENCHMARK.json`` itself; a
tiny traced LD cell reads the LD scan's two phases (``dec.ld_read``,
``dec.ld_dc``) and leaves the kernel's roofline out, never reporting 0;
and a program without those spans (an older commit) leaves the two
metrics out without raising."""

from __future__ import annotations

import contextlib

import run
from tiny import drive

PHASES = ("ld.scan_read_ms", "ld.scan_dc_ms")


def test_manifest_cell_reports_its_metrics():
    manifest, cell, config, traffic = run.cell_of("ld1080.decode")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ld_1080p50", "decode_closed", 1)
    assert config["coding"]["mode"] == "LD" and traffic["loop"] == "closed"
    e2e = {m["name"] for m in run.reported(manifest["end_to_end"], cell)}
    assert e2e == {"decode_fps", "setup_s"}
    layers = {m["name"] for m in run.reported(manifest["per_layer"], cell,
                                              e2e)}
    assert layers == {*PHASES, "decode.scan_ms", "decode.device_idle",
                      "ld_unpack_roofline"}


def test_traced_ld_cell_reads_the_scan_phases():
    rc, result, err = drive("ld1080.decode", "decode", "LD", trace=1)
    assert rc == 0, err
    assert result["correct"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    for name in (*PHASES, "decode.scan_ms"):
        assert metrics[name] > 0, name
    # no device on the CPU: the kernel's roofline finds nothing
    assert "ld_unpack_roofline" not in metrics


def test_program_without_the_phases_leaves_them_out(monkeypatch):
    from vc2tpu_torch.core import trace
    from vc2tpu_torch.slices import ld

    class Older:
        """``core.trace`` as the LD scan saw it before its split: the
        scan's phases open no span."""

        @staticmethod
        def span(name, picture=None):
            if name in ("dec.ld_read", "dec.ld_dc"):
                return contextlib.nullcontext()
            return trace.span(name, picture)

    monkeypatch.setattr(ld, "trace", Older)
    rc, result, err = drive("ld1080.decode", "decode", "LD", trace=1)
    assert rc == 0, err
    assert result["correct"]
    assert not set(PHASES) & set(result["metrics"])
    assert result["metrics"]["decode.scan_ms"]["value"] > 0
