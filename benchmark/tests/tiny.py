"""A cell at a test's size, run on the CPU through the whole harness: the
port's CLI with ``--device cpu`` (its plain versions) in the window."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


# the encode cell's metrics, which BENCHMARK.json leaves out (PERF.md, Open
# questions): the harness measures an encode all the same
ENCODE_METRICS = [
    {"name": "encode_fps", "unit": "pictures/s", "better": "higher",
     "bound": 0.25, "source": "host_clock", "workloads": ["hq1080.encode"]},
    {"name": "encode_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": ["hq1080.encode"]}]


# cells the harness runs that BENCHMARK.json leaves out (PERF.md, Open
# questions), each with the cell whose end-to-end metrics it reports
STAND_INS = {"ld1080.decode": "hq1080.decode"}


def config(mode: str = "HQ_CBR") -> dict:
    coding = {"width": 64, "height": 32, "chroma": "4:2:2", "depth_bits": 10,
              "bytes_per_sample": 2, "frame_rate": 6, "mode": mode,
              "kernel": "LeGall", "wavelet_depth": 2, "slice_units": [1, 2],
              "compressed_bytes": 2048, "slice_scalar": 1,
              "slice_prefix": 0}
    flags = ["--device", "cpu", "-x", "64", "-y", "32", "-f", "4:2:2", "-l",
             "10", "-n", "2", "-r", "6", "-p", "-k", "LeGall", "-d", "2",
             "-u", "1", "-a", "2", "-m", mode, "-s", "2048"]
    if mode == "HQ_CBR":
        flags += ["-S", "1"]
    return {"coding": coding, "encode_flags": flags,
            "decode_flags": ["--device", "cpu"]}


def traffic(name: str, **change) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        t = json.load(f)
    t.update(warmup=3, sample_every=1, **change)
    return t


def drive(cell_name: str, direction: str, mode: str = "HQ_CBR",
          seconds: float = 1.5, trace: int = 0, cli_module=None,
          seed: int = 2**31 + 5, loop: str = "closed", cfg=None):
    """Run a tiny cell through ``run.measure`` on the CPU; returns (exit
    code, the result line or None, standard error)."""
    import run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["end_to_end"] += ENCODE_METRICS
    for m in manifest["end_to_end"]:
        if STAND_INS.get(cell_name) in m.get("workloads", ()):
            m["workloads"].append(cell_name)
    name = f"{direction}_{'paced50' if loop == 'paced' else 'closed'}"
    t = traffic(name, **({"rate": 20} if loop == "paced" else {}))
    cell = {"name": cell_name, "chips": 1}
    args = argparse.Namespace(workload=cell_name, seed=seed, seconds=seconds,
                              trace=trace)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.measure(args, manifest, cell, cfg or config(mode), t,
                         torch.device("cpu"), cli_module=cli_module)
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
