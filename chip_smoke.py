#!/usr/bin/env python3
"""Drive the vc2tpu_torch port on one CUDA card, check it and time it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the last line is then not printed):

1. build both CUDA kernels from ``vc2tpu_torch/csrc`` with nvcc (timed);
2. hold the lift kernel against its plain PyTorch version, all seven
   wavelets forward and inverse: one plane at the 1080p planes and
   sub-lattices, a shape that is not a tile multiple and tiny planes; the
   three 1080p 4:2:2 planes in one launch, read in place from their
   stride-2 sub-lattices and at stride 1 under a compact overlay, as the
   inverse runs them; and narrow planes at strides 2 and 4 whose widths
   take the 4-byte paths (integer ==);
3. hold the unpack kernel against its plain version on the 1080p fixtures'
   payloads (every CTA's byte window staged in shared memory), on a
   fixture payload cut short (regions past the payload end), on a seeded
   random-bytes payload whose CTAs span more than a window (peeks from
   device memory) and on lanes too many for the shared tile (integer ==);
4. the main path: reset the launch counters, decode the committed 1080p
   HQ fixtures (``vc2tpu_torch/testdata``) with ``Decoder()`` and check each
   output's SHA-256 against the JAX package's decode, and the counters
   (lift: 2 launches a picture, one a level for the three planes; unpack:
   1); then decode every non-fragmented HQ golden of ``tests/golden``
   byte-identically;
5. times on the card: end-to-end frames/s, the per-stage breakdown of one
   1080p picture, and each kernel's time beside its bound and its plain
   version's time.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. A kernel's
``ms`` is one picture's launches timed with CUDA events as the host issues
them, so it counts the wrapper's time to issue a launch where that is
longer than the card's to run it; ``device_ms`` is the card's time alone:
the card sleeps while the host queues the launches
(``time_device(queued=True)``).
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
OP_RATE = 67e12           # H100 SXM non-tensor fp32 op/s; no higher for int32
REPS = 7                  # samples of a stage or kernel time
E2E_REPS = 40             # end-to-end samples: p75 has 10 samples beyond it
KERNEL_INNER = 20         # back-to-back calls in one queued kernel sample
# lift check shapes: the 1080p 4:2:2 planes and their level-1 sub-lattices,
# a plane that is not a multiple of any tile, and tiny planes
LIFT_SHAPES = [(1080, 1920), (1080, 960), (540, 960), (540, 480), (130, 194),
               (2, 2), (4, 8), (16, 16), (32, 64)]
# planes of one launch: the 1080p 4:2:2 picture, and narrow planes whose
# level widths are not multiples of 4 at stride 2 or 4
LEVEL_PLANES = [(1080, 1920), (1080, 960), (1080, 960)]
SMALL_PLANES = [(136, 200), (136, 104), (8, 8)]
RANDOM_ROWS = 64800       # slices of the random-bytes unpack check (1080p)
TESTDATA = os.path.join(ROOT, "vc2tpu_torch", "testdata")
GOLDEN = os.path.join(ROOT, "tests", "golden")


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / MEM_RATE, nops / OP_RATE
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms(torch) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    return 1e7 / a.elapsed_time(b)


def time_device(torch, fn, inner: int = 1, reps: int = REPS,
                queued: bool = False) -> float:
    """Median ms of one call of ``fn``, by CUDA events around ``inner``
    back-to-back calls, after a warm-up. The events also count the time
    the card waits for the host to issue the work. With ``queued`` the card
    first sleeps (twice the host's time to issue the calls, plus 1 ms)
    while the host issues them, so the events time the device's work
    alone."""
    fn()
    torch.cuda.synchronize()
    cycles = 0
    if queued:
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        cycles = int((2 * host_ms + 1) * sleep_cycles_per_ms(torch))
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return statistics.median(ts)


def host_samples(fn, reps: int = REPS) -> list:
    """ms of each of ``reps`` calls of ``fn`` (which ends in a host sync),
    after a warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return ts


def time_host(fn, reps: int = REPS) -> float:
    return statistics.median(host_samples(fn, reps))


def device_busy(torch, fn):
    """(device-busy ms, wall ms, {kernel name: ms}) of one call of ``fn``
    under torch.profiler: the union of the intervals of the device events
    (kernels and copies) the trace holds. None when it holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall, by_name


def max_err(torch, a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def pictures_of(stream: bytes, device):
    """(decoder, byte offset, located picture) for every HQ picture of a
    stream, via the Decoder's host half (``locate_picture``)."""
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader

    dec = Decoder(sink=io.BytesIO(), device=device)
    out = []
    pos = 0
    while pos + 13 <= len(stream):
        rd = StreamReader(stream[pos:])
        du, next_off, _prev = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            dec.hdr = rd.read_sequence_header()
            dec._major_version = rd.major_version
        elif du == DataUnitType.HQ_PICTURE:
            _end, job = dec.locate_picture(stream[pos:], True)
            out.append((dec, pos, job))
        if next_off == 0:
            break
        pos += next_off
    return out


def kernel_times(torch, job, dev) -> dict:
    """Times of one 1080p picture's lift launches and unpack launch at the
    main path's shapes: ``*_ms`` as the host issues them (the lift's levels
    once; the unpack 10 times back to back), ``*_device_ms`` queued (the
    device's time alone), ``*_plain_ms`` of the plain versions."""
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import lifting, matrices

    pre, geo = job.pre, job.geo
    kernel, depth = pre.wavelet_kernel, pre.depth
    ly = geo.luma_slice[0] * geo.luma_slice[1]
    lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
    clen = fields[1:].contiguous()
    dstart = du.hq_component_offsets(clen, pre.slice_prefix, job.start)
    lanes = du.unpack_hq(pay, dstart, clen, ly, lc)
    planes = pipe.dequantise_planes(lanes, fields[0],
                                    matrices.quant_matrix(kernel, depth),
                                    depth, geo)
    def lift_picture(fn):
        def run():
            coarse = None
            for level in range(depth - 1, -1, -1):
                coarse = fn(planes, kernel, True, 1 << level, coarse)
        return run

    lift = lift_picture(lifting.lift_levels)

    def unpack():
        return du.unpack_hq(pay, dstart, clen, ly, lc)

    return {
        "lift_ms": time_device(torch, lift),
        "lift_device_ms": time_device(torch, lift, KERNEL_INNER, queued=True),
        "lift_plain_ms": time_device(
            torch, lift_picture(lifting.lift_levels_plain)),
        "unpack_ms": time_device(torch, unpack, 10),
        "unpack_device_ms": time_device(torch, unpack, KERNEL_INNER,
                                        queued=True),
        "unpack_plain_ms": time_device(
            torch, lambda: du.unpack_hq_plain(pay, dstart, clen, ly, lc)),
        "plane_samples": [p.numel() for p in planes],
    }


def main(argv) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.core import build
    from vc2tpu_torch.core.config import PictureGeometry, WaveletKernel
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.slices.hq import scan_hq_slice_offsets
    from vc2tpu_torch.stream.dataunit import StreamReader
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import lifting, matrices

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    libs = build.build(lifting.kernel_source(), du.kernel_source())
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{[os.path.basename(p) for p in libs]}")

    # 2. lift kernel against its plain version
    rng = np.random.default_rng(2042)
    lift_err = 0
    n_cmp = 0
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for shape in LIFT_SHAPES:
            x = rng.integers(-(1 << 20), (1 << 20) + 1, shape)
            x.flat[::7] = rng.choice([-(1 << 20), (1 << 20), -(1 << 20) + 3,
                                      (1 << 20) - 5], x.flat[::7].shape)
            xt = torch.as_tensor(x.astype(np.int32), device=dev)
            for invert in (False, True):
                got = lifting.lift_level(xt, kernel, invert)
                want = lifting.lift_level_plain(xt, kernel, invert)
                torch.cuda.synchronize()
                err = max_err(torch, got, want)
                check(err == 0, f"lift_level {kernel.name} {shape} "
                                f"invert={invert}: max |err| {err}")
                lift_err = max(lift_err, err)
                n_cmp += 1
    # several planes in one launch, strided input, overlays
    def rand_plane(shape):
        return torch.as_tensor(rng.integers(-(1 << 20), (1 << 20) + 1, shape)
                               .astype(np.int32), device=dev)

    level_cases = [("1080p 4:2:2", LEVEL_PLANES, 2, False),
                   ("1080p 4:2:2", LEVEL_PLANES, 1, True),
                   ("narrow", SMALL_PLANES, 2, False),
                   ("narrow", SMALL_PLANES, 2, True),
                   ("narrow", SMALL_PLANES, 4, True)]
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for label, shapes, stride, with_overlay in level_cases:
            planes = [rand_plane(sh) for sh in shapes]
            overlays = ([rand_plane((h // (2 * stride), w // (2 * stride)))
                         for h, w in shapes] if with_overlay else None)
            for invert in (False, True):
                got = lifting.lift_levels(planes, kernel, invert, stride,
                                          overlays)
                want = lifting.lift_levels_plain(planes, kernel, invert,
                                                 stride, overlays)
                torch.cuda.synchronize()
                err = max(max_err(torch, g, w) for g, w in zip(got, want))
                check(err == 0, f"lift_levels {kernel.name} {label} stride "
                                f"{stride} overlay={with_overlay} invert="
                                f"{invert}: max |err| {err}")
                lift_err = max(lift_err, err)
                n_cmp += 1
    print(f"lift kernel == plain: {n_cmp} cases, max |err| {lift_err}")

    # 3. unpack kernel against its plain version
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        fixtures = json.load(f)["streams"]
    streams = {}
    for key, v in fixtures.items():
        with open(os.path.join(TESTDATA, v["stream"]), "rb") as f:
            streams[key] = f.read()
    unpack_cases = []
    for key, data in streams.items():
        for _dec, _pos, job in pictures_of(data, dev):
            pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
            clen = fields[1:].contiguous()
            dstart = du.hq_component_offsets(clen, job.pre.slice_prefix,
                                             job.start)
            ly = job.geo.luma_slice[0] * job.geo.luma_slice[1]
            lc = job.geo.chroma_slice[0] * job.geo.chroma_slice[1]
            unpack_cases.append((key, pay, dstart, clen, ly, lc))
    key, pay, dstart, clen, ly, lc = unpack_cases[0]
    unpack_cases.append(("cut_short", pay[:-200].clone(), dstart, clen, ly,
                         lc))
    n = RANDOM_ROWS
    pay = torch.as_tensor(rng.integers(0, 256, 1 << 20, dtype=np.uint8),
                          device=dev)
    starts = np.sort(rng.integers(0, (1 << 20) - 64, 3 * n)).reshape(3, n)
    lens = rng.integers(0, 64, (3, n))
    unpack_cases.append(("random_bytes", pay,
                         torch.as_tensor(starts.astype(np.int32), device=dev),
                         torch.as_tensor(lens.astype(np.int32), device=dev),
                         32, 16))
    # lanes too many for the shared tile: written straight to device memory
    starts = np.sort(rng.integers(0, (1 << 16) - 64, 3 * 96)).reshape(3, 96)
    unpack_cases.append(("wide_lanes", pay[:1 << 16].clone(),
                         torch.as_tensor(starts.astype(np.int32), device=dev),
                         torch.as_tensor(rng.integers(0, 64, (3, 96))
                                         .astype(np.int32), device=dev),
                         16384, 8192))
    unpack_err = 0
    n_staged = n_global = n_direct = 0
    for key, pay, dstart, clen, ly, lc in unpack_cases:
        s, lanes_staged = du.unpack_plan(ly, lc)
        # each CTA's branch, as the kernel reports it (1: window staged)
        staged = torch.full((-(-dstart.shape[1] // s),), 2,
                            dtype=torch.uint8, device=dev)
        got = du.unpack_hq(pay, dstart, clen, ly, lc, staged=staged)
        want = du.unpack_hq_plain(pay, dstart, clen, ly, lc)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        check(err == 0, f"unpack_hq {key}: max |err| {err}")
        check(int(staged.max().item()) <= 1,
              f"unpack_hq {key}: a CTA left its branch flag unset")
        unpack_err = max(unpack_err, err)
        k_staged = int(staged.sum().item())
        n_staged += k_staged
        n_global += staged.numel() - k_staged
        n_direct += not lanes_staged
        print(f"  unpack {key}: {staged.numel()} CTAs, "
              f"{staged.numel() - k_staged} peek from device memory, "
              f"lanes staged in shared memory: {lanes_staged}")
    check(n_staged > 0 and n_global > 0 and n_direct > 0,
          "the unpack cases miss the staged or the device-memory branch")
    print(f"unpack kernel == plain: {len(unpack_cases)} payloads, "
          f"max |err| {unpack_err}")

    # 4. the main path: decode the 1080p fixtures through Decoder(); the
    # counts are zeroed just before it and read just after
    n_pictures = sum(len(pictures_of(d, dev)) for d in streams.values())
    lifting.lift_levels.launches = 0
    du.unpack_hq.launches = 0
    for key, data in streams.items():
        sink = io.BytesIO()
        check(Decoder(sink=sink).run(data) == 0, f"decode {key} failed")
        digest = hashlib.sha256(sink.getvalue()).hexdigest()
        check(digest == fixtures[key]["decoded_sha256"],
              f"{key}: decoded SHA-256 {digest} differs from the JAX "
              f"package's {fixtures[key]['decoded_sha256']}")
    launches = {"lift_level": lifting.lift_levels.launches,
                "hq_unpack": du.unpack_hq.launches}
    print(f"main path: {n_pictures} 1080p pictures, SHA-256 equal to the "
          f"JAX package's decode; launches {launches}")
    check(launches["lift_level"] == 2 * n_pictures,
          f"lift_level launched {launches['lift_level']} times, "
          f"expected {2 * n_pictures}")
    check(launches["hq_unpack"] == n_pictures,
          f"hq_unpack launched {launches['hq_unpack']} times")

    with open(os.path.join(GOLDEN, "meta.json")) as f:
        cases = [c[0] for c in json.load(f)["cases"]
                 if not c[0].startswith("ld") and c[0] != "cbr_fragmented"]
    for case in cases:
        sink = io.BytesIO()
        with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
            check(Decoder(sink=sink).run(f.read()) == 0, f"golden {case}")
        with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
            check(sink.getvalue() == f.read(),
                  f"golden {case}: output differs from the reference's")
    print(f"goldens: {len(cases)} HQ cases byte-identical on the card")

    # 5. times
    for key, data in streams.items():
        def decode_once():
            Decoder(sink=io.BytesIO()).run(data)
        ts = sorted(host_samples(decode_once, E2E_REPS))
        ms, p75 = statistics.median(ts), ts[int(0.75 * len(ts)) - 1]
        print(f"end to end {key}: median {ms:.3f} ms/picture = "
              f"{1e3 / ms:.2f} fps, p75 {p75:.3f} ms, min {ts[0]:.3f}, "
              f"max {ts[-1]:.3f} ({len(ts)} runs after a warm-up; {card})")
        prof = device_busy(torch, decode_once)
        if prof is None:
            print(f"device busy {key}: not measured (the profiler trace "
                  "holds no device events)")
            continue
        busy, wall, by_name = prof
        print(f"device busy {key}: {busy:.3f} ms of a {wall:.3f} ms "
              f"profiled decode, idle share {1 - busy / wall:.3f} ({card})")
        for nm, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"  device time {nm[:70]}: {t:.4f} ms")

    # per-stage breakdown of one 1080p ConstQ picture
    window = streams["constq_1080p"]
    dec, offset, job = pictures_of(window, dev)[0]
    hdr, pre, geo = dec.hdr, job.pre, job.geo
    kernel, depth = pre.wavelet_kernel, pre.depth
    qmatrix = matrices.quant_matrix(kernel, depth)
    out_geom = PictureGeometry.of(job.pic_h, hdr.width, hdr.chroma_format)
    ly = geo.luma_slice[0] * geo.luma_slice[1]
    lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    stages = {}
    unit = window[offset:]

    def parse_only():
        rd = StreamReader(bytes(unit))
        rd.major_version = dec._major_version
        rd.r.seek(13)
        rd.read_picture_number()
        rd.read_preamble(True)

    stages["host: stream parse (picture header, preamble)"] = time_host(
        parse_only)
    stages["host: chain scan"] = time_host(
        lambda: scan_hq_slice_offsets(unit, geo.n_slices, pre.slice_prefix,
                                      pre.slice_size_scalar, job.start))

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
        ev[1].record()
        clen = fields[1:]
        dstart = du.hq_component_offsets(clen, pre.slice_prefix, job.start)
        ev[2].record()
        lanes = du.unpack_hq(pay, dstart, clen, ly, lc)
        ev[3].record()
        planes = pipe.dequantise_planes(lanes, fields[0], qmatrix, depth, geo)
        ev[4].record()
        planes = lifting.inverse_planes(planes, kernel, depth)
        ev[5].record()
        words = pipe.format_planes(planes, out_geom, hdr.bitdepth)
        ev[6].record()
        host = words.cpu()
        ev[7].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(7)], host

    staged()
    rows = [staged()[0] for _ in range(REPS)]
    labels = ["device: H2D (payload + slice fields)",
              "device: component offsets",
              "device: unpack kernel",
              "device: dequantise + lanes_to_plane",
              "device: inverse_planes (2 lift launches)",
              "device: crop + format",
              "device: D2H copy of the output bytes"]
    for i, lab in enumerate(labels):
        stages[lab] = statistics.median(r[i] for r in rows)

    times = kernel_times(torch, job, dev)
    stages[f"device: of which the lift launches ({depth}, host-issued)"] = (
        times["lift_ms"])
    for lab, ms in stages.items():
        print(f"stage {lab}: {ms:.4f} ms ({card})")
    print(f"kernel times: {json.dumps(times)} ({card})")

    # kernel table: time, plain time, bound
    # each level's samples read once and written once
    level_sizes = [n >> (2 * level) for n in times["plane_samples"]
                   for level in range(depth)]
    lift_bytes = sum(8 * n for n in level_sizes)
    lift_ops = 0
    for n in level_sizes:
        for (_t, _s, taps, _a, _sh) in lifting.ladder(kernel, True):
            lift_ops += 2 * (n // 2) * (2 * len(taps) + 3)
        lift_ops += 2 * n                            # rounded unshift
    lift_bound, lift_by = bound_ms(lift_bytes, lift_ops)

    key, pay, dstart, clen, ly_, lc_ = unpack_cases[0]
    check(key == "constq_1080p", "fixture order")
    lanes = du.unpack_hq(pay, dstart, clen, ly_, lc_)
    nrows = 3 * dstart.shape[1]
    unpack_bytes = (int(clen.sum().item()) + 8 * nrows
                    + 4 * sum(t.numel() for t in lanes))
    ndata = sum(int(torch.floor(torch.log2(t.abs().double() + 1)).sum().item())
                for t in lanes)
    unpack_ops = 20 * sum(t.numel() for t in lanes) + 3 * ndata
    unpack_bound, unpack_by = bound_ms(unpack_bytes, unpack_ops)

    kernels = [
        {"name": "lift_level", "route": "cuda",
         "source": "vc2tpu_torch/csrc/lift_level.cu",
         "replaces": "vc2tpu/wavelet/pallas_lift.py:235",
         "launches": launches["lift_level"], "max_abs_err": lift_err,
         "ms": times["lift_ms"], "device_ms": times["lift_device_ms"],
         "plain_ms": times["lift_plain_ms"], "bound_ms": lift_bound,
         "bound_by": lift_by, "library_ms": None},
        {"name": "hq_unpack", "route": "cuda",
         "source": "vc2tpu_torch/csrc/hq_unpack.cu",
         "replaces": "vc2tpu/vlc/device_unpack.py:107",
         "launches": launches["hq_unpack"], "max_abs_err": unpack_err,
         "ms": times["unpack_ms"], "device_ms": times["unpack_device_ms"],
         "plain_ms": times["unpack_plain_ms"],
         "bound_ms": unpack_bound, "bound_by": unpack_by,
         "library_ms": None},
    ]
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms per 1080p picture "
              f"(device alone {k['device_ms']:.4f} ms), bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, launches {k['launches']} ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
