"""Time the encode CLI of several checkouts in turns on the card.

    python vc2tpu_torch/testdata/encode_turns.py ROOT [ROOT ...]

Writes ``make_1080p.make_sequence``'s distinct seeded 1080p 4:2:2 10-bit
pictures to a temporary planar file, then runs each checkout's
``vc2tpu_torch.cli.encode_stream.run`` over it in HQ ConstQ (-q 40), HQ
CBR (-S 2 -s 829440) and HQ CBR with -F 16384, one process a turn: the
roots in the order given, then reversed, ``--rounds`` times (A B B A for
two roots and one round). Each process builds or loads its checkout's
kernels, encodes the file once to warm up and then ``--reps`` times, and
prints its ms a picture; the script prints every sample, the medians and
the card's name and power limit. Compare commits only within one run: a
checkout unpacked with ``git archive`` into a git-ignored directory is a
root like any other.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARGS = ["-x", "1920", "-y", "1080", "-f", "4:2:2", "-l", "10", "-n", "2",
        "-k", "LeGall", "-d", "2", "-u", "2", "-a", "2"]
MODES = {"constq": ["-m", "HQ_ConstQ", "-q", "40"],
         "cbr": ["-m", "HQ_CBR", "-S", "2", "-s", "829440"],
         "cbr_fragments": ["-m", "HQ_CBR", "-S", "2", "-s", "829440",
                           "-F", "16384"]}


def time_root(root: str, src: str, pictures: int, reps: int) -> dict:
    """In this process: ms a picture of ``root``'s encode CLI over ``src``
    in each mode, ``reps`` runs after a warm-up."""
    sys.path.insert(0, root)
    from vc2tpu_torch.cli import encode_stream

    out = src + f".{os.getpid()}.vc2"
    times = {}
    for mode, extra in MODES.items():
        args = encode_stream.build_parser().parse_args(
            ARGS + extra + [src, out])
        if encode_stream.run(args) != 0:
            raise RuntimeError(f"{root}: the {mode} encode failed")
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            encode_stream.run(args)
            ts.append(1e3 * (time.perf_counter() - t0) / pictures)
        times[mode] = ts
    os.remove(out)
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--pictures", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--time-root", default=None, help=argparse.SUPPRESS)
    p.add_argument("--src", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.time_root:
        print(json.dumps(time_root(a.time_root, a.src, a.pictures, a.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("encode_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import make_1080p

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(r) for r in a.roots]
    order = []
    for _ in range(a.rounds):
        order += roots + roots[::-1]
    samples = {r: {m: [] for m in MODES} for r in roots}
    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(work, "sequence.16p2")
        make_1080p.make_sequence(src, a.pictures)
        for turn, root in enumerate(order):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), root,
                 "--time-root", root, "--src", src, "--pictures",
                 str(a.pictures), "--reps", str(a.reps)],
                capture_output=True, text=True, cwd=root)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            got = json.loads(res.stdout.strip().splitlines()[-1])
            for mode, ts in got.items():
                samples[root][mode] += ts
                print(f"turn {turn} {root} {mode}: "
                      + " ".join(f"{t:.3f}" for t in ts) + " ms a picture")
    for mode in MODES:
        for root in roots:
            ts = samples[root][mode]
            print(f"encode CLI {mode}, {a.pictures} pictures: {root}: median "
                  f"{statistics.median(ts):.3f} ms a picture, min "
                  f"{min(ts):.3f}, max {max(ts):.3f} ({len(ts)} runs; "
                  f"{card})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
