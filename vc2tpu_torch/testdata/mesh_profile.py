"""Where the 8K mesh encode's and decode's time goes on one card, on the
band form (the entry points' mesh route) and on the mesh's in-place route.

    python vc2tpu_torch/testdata/mesh_profile.py [--rounds N]

BASELINE config #5 (8K HQ CBR, 7680x4320 4:2:2 10-bit, LeGall depth 2,
-u 1 -a 2) over a 1x4 mesh of card 0: ``ShardedEncoder.encode_batch`` of
one seeded picture in host memory and ``Decoder(mesh=)`` of its stream,
each through the band form and through ``chip_smoke.inplace_mesh_route``,
first checked to the same bytes. Prints the ms a picture of each,
sampled in turns (band, in-place, in-place, band) over ``--rounds``
rounds; then, for one more run of each, the card's time by kernel and
copy (``torch.profiler``) and the host's time by function (``cProfile``,
own time), each the largest entries; and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOP = 8                   # entries printed of each profile
NAME = 72                 # characters kept of a kernel's name


def device_table(torch, fn) -> list:
    """(name, ms) of the card's kernels and copies in one call of ``fn``,
    largest first, and their total."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # the card's own events: kernels and copies, not the host ops that
        # launched them, nor the profiler's buffers
        if us and str(e.device_type).endswith("CUDA") \
                and not e.key.startswith("Activity Buffer"):
            rows.append((e.key[:NAME], us / 1e3))
    rows.sort(key=lambda r: -r[1])
    return rows[:TOP] + [("total", sum(ms for _k, ms in rows))]


def host_table(fn) -> list:
    """(function, ms of its own time) of one call of ``fn``, largest
    first, and the total."""
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{os.path.basename(k[0])}:{k[1]}({k[2]})", v[2] * 1e3)
                   for k, v in stats.items()), key=lambda r: -r[1])
    return rows[:TOP] + [("total", sum(ms for _k, ms in rows))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.pipeline.sharded import ShardedEncoder
    from vc2tpu_torch.shard import multihost
    from vc2tpu_torch.shard.mesh import make_mesh

    if not torch.cuda.is_available():
        print("mesh_profile.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    inplace_encoder, inplace_decoder = cs.inplace_mesh_route()
    cfg = multihost.harness_config("8k")
    pics = multihost.harness_frames(cfg, 1, seed=1)
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    want = Encoder(cfg, device=dev).encode_picture(pics[0])
    stream = multihost.harness_stream(cfg, [want])
    ref = io.BytesIO()
    cs.check(Decoder(sink=ref, device=dev).run(stream) == 0, "8K decode")
    encoders = (ShardedEncoder(cfg, mesh), inplace_encoder(cfg, mesh))
    for e in encoders:
        got = e.encode_batch(pics)[0]
        cs.check(got.payload == want.payload
                 and np.array_equal(got.q_indices, want.q_indices),
                 f"{type(e).__name__}: the 8K encode differs")
    for cls in (Decoder, inplace_decoder):
        sink = io.BytesIO()
        cs.check(cls(sink=sink, mesh=mesh).run(stream) == 0
                 and sink.getvalue() == ref.getvalue(),
                 f"{cls.__name__}: the 8K decode differs")

    def sync(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    runs = {}
    for label, e in zip(("band form", "in-place route"), encoders):
        runs["encode", label] = sync(lambda e=e: e.encode_batch(pics))
    for label, cls in zip(("band form", "in-place route"),
                          (Decoder, inplace_decoder)):
        runs["decode", label] = sync(
            lambda cls=cls: cls(sink=io.BytesIO(), mesh=mesh).run(stream))
    card = cs.card_line()
    for way in ("encode", "decode"):
        fns = [runs[way, "band form"], runs[way, "in-place route"]]
        samples = ([], [])
        for fn in fns:
            fn()
        for _ in range(args.rounds):
            for k in (0, 1, 1, 0):
                t0 = time.perf_counter()
                fns[k]()
                samples[k].append(1e3 * (time.perf_counter() - t0))
        for label, ts in zip(("band form", "in-place route"), samples):
            print(f"8K CBR {way} over 1x4, {label}: median "
                  f"{statistics.median(ts):.3f} ms a picture, min "
                  f"{min(ts):.3f}, max {max(ts):.3f} ({len(ts)} runs in "
                  f"turns; {card})")
    for (way, label), fn in runs.items():
        for kind, rows in (("card", device_table(torch, fn)),
                           ("host", host_table(fn))):
            print(f"8K CBR {way} over 1x4, {label}, {kind} ms by entry: "
                  + "; ".join(f"{k} {ms:.3f}" for k, ms in rows))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
