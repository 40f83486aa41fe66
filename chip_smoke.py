#!/usr/bin/env python3
"""Drive the vc2tpu_torch port on one CUDA card, check it and time it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the last line is then not printed):

1. build the nine CUDA kernels (eight sources: ``band_lift.cu`` holds the
   band route's two), the host chain scan and the host LD scan from
   ``vc2tpu_torch/csrc`` (nvcc and the host C++ compiler, all at once;
   timed);
2. hold the lift kernel against its plain PyTorch version, all seven
   wavelets forward and inverse: one plane at the 1080p planes and
   sub-lattices, a shape that is not a tile multiple and tiny planes; the
   three 1080p 4:2:2 planes in one launch, read in place from their
   stride-2 sub-lattices and at stride 1 under a compact overlay, as the
   inverse runs them; narrow planes at strides 2 and 4 whose widths take
   the 4-byte paths; and ``forward_planes`` of three 1080p 4:2:2 planes
   against the same on the CPU (integer ==); hold the band route's two
   kernels (``wavelet.bands.inverse_lanes`` and ``forward_lanes``) against
   their plain versions (integer ==): the 1080p 4:2:2 LeGall depth-2 slice
   grid, all seven wavelets at depths 1-3, slice grids whose bands are not
   powers of two (-u 1 -a 2 at 1080p, 12-row slices, 4:2:0, 4:4:4), lanes
   and samples over the whole int32 range at q 116-119 (LeGall, Daub97),
   with and without LD LL grids, from int16 and int32 samples; and the
   edges of their run-major copies: tiles that split 64 x 64 slices, runs
   that start off a 16-byte boundary, the 8K geometry (far more tiles
   than resident CTAs) and the 1080p grid with a q a slice at 0-119;
3. hold the unpack kernel against its plain version on the 1080p fixtures'
   payloads (every CTA's byte window staged in shared memory), on a
   fixture payload cut short (regions past the payload end), on a seeded
   random-bytes payload whose CTAs span more than a window (peeks from
   device memory) and on lanes too many for the shared tile (integer ==);
   the native chain scan against the Python loop on the HQ fixtures;
   hold the LD unpack kernel against its plain version (integer ==) on the
   1080p LD fixture, that payload cut short, seeded random slices with
   every lead bit offset 0-31, empty U/V regions, luma regions past their
   slice and a ragged last CTA, slices too far apart to stage, lanes too
   many for the shared tile (slices near and far apart) and payloads of
   0x00 and 0xFF runs (the 64-bit clamp, zero runs past the bound); every
   branch of the kernel reached; the native LD scan (header fields and the
   LL DC-prediction recurrence) against its Python twin on the fixture;
4. hold the pack kernel against its plain version (bytes, totals, flags
   and the quantised lanes equal): fused, on the 1080p ConstQ transform
   lanes, at every q 0-119 over values up to +-(2^31 - 1) and INT_MIN,
   on slice counts that leave a ragged last tile and on slices served by
   groups of 16 threads; from quantised lanes, on the 1080p ConstQ lanes,
   seeded random lanes with codes longer than 32 bits, all-zero slices,
   prefix 3 / scalar 2, a CBR fill, slices larger than the kernel's
   window and a case for each flag; a flagged call and a short buffer,
   with guard bytes after the buffer that must stay untouched; ``quant``
   on the card against ``quant`` on the CPU; hold the CBR search kernel
   against its plain version (integer == on the q indices, and its flag
   above 119): the 1080p CBR transform lanes at the fixture's budgets,
   at x0.25 and x4, at scalar 1 and at prefix 3 / scalar 2 (with the
   fused pack at the searched indices), seeded lanes up to +-(2^29 - 1),
   all-zero slices, budgets no q meets, slices whose climb runs past 3
   steps, a ragged slice count, slices too large for the registers (a
   warp reading them from device memory) and slices taken by groups of
   4, 8, 16 and 32 threads (ragged runs, 2-lane slices, 4:4:4); and the
   groups' redux.sync on their own masks against shuffles; hold the LD
   rate control's body table kernel against its plain version on every
   case below (every slice and trial), and the LD rate control against
   its plain version (integer == on q and the three LL lane sets; the
   plain version on the card for the 1080p lanes, on the host CPU for the
   rest): the 1080p LD transform lanes at the fixture's budgets,
   at x0.25 and x4, and with all-zero bodies, seeded grids (Haar1, LeGall
   and DD97 at depths 1-3, coefficients up to +-(2^29 - 1) and up to
   +-(2^31 - 1)) of a single slice, a single row, a single column and 7 x
   11 slices, budgets no q meets, more rows than the card runs at once
   (the row ticket), 64 x 64 slices (LL 8 x 8, body entries past the int16
   range), body lanes that are 0 by index 111 and not at the wrapped 119,
   4:4:4, 4:2:0 and 4:2:2 at -u 1 (both fixed-shape kernels and the
   generic one); its q on the 1080p picture against
   the q indices the LD scan reads from ``ld_1080p.vc2``; hold the LD pack
   kernel against its plain version (the buffer [flags | payload] byte
   for byte, and its quantised lanes): on the 1080p LD transform lanes,
   and, with a quant matrix that quantises every body lane at index 0
   (the identity), on the 1080p quantised lanes, seeded lanes with codes
   longer than 32 bits, all-zero slices, a FLAG_LD_FIT case, a ragged
   last CTA, the U/V bound inside a code, slices the luma codes overrun,
   63 / 21 lanes (chunks of unequal lengths), no LL lanes, 1024 / 512
   lanes (chunks too long to hold) and slices over several windows (short
   and long codes), and with guard bytes after its payload that must stay
   untouched;
5. the main paths, each with the launch counters zeroed just before it and
   read just after: decode each committed 1080p HQ fixture
   (``vc2tpu_torch/testdata``) ``REPEAT`` times over in one stream with
   one ``Decoder()``, so that the first picture decodes eagerly, the
   second is captured in a CUDA graph and the rest replay it (every
   picture's SHA-256 against the JAX package's decode; one capture,
   ``REPEAT - 1`` replays; band_inverse 2 launches a picture, unpack 1,
   lift_level 0, by the counters, and by the kernels in the profiler's
   device trace, where the chain's run before its capture adds one
   picture's launches); decode the 1080p LD fixture likewise (ld_unpack
   1, ld_dc 1, band_inverse 2, lift_level 0, hq_unpack 0); encode the 1080p ConstQ input
   (``make_1080p.make_input``) with the encode CLI (bytes equal to
   ``constq_1080p.vc2``, its decode at the
   recorded SHA-256; band_forward 2, lift_level 0, pack 1); encode the
   same input as HQ CBR (bytes equal to ``cbr_1080p.vc2``; band_forward 2,
   cbr 1, pack 1), and again with ``-F 16384``, whose fragments
   ``Decoder()`` decodes to the recorded SHA-256; encode the same input as
   LD (bytes equal to ``ld_1080p.vc2``; band_forward 2, ld_rate 1, ld_pack
   1, hq_pack 0, hq_cbr 0; one synchronisation from the forward lift to
   the result's read, counted by PyTorch's sync debug mode); then
   every golden of ``tests/golden``, HQ and LD (``cbr_fragmented`` and
   ``ld_fragmented`` among them), decodes, the three decoder taps of
   ``constq_legall_d2``, ``cbr_fragmented``, ``ld_legall_d2`` and
   ``ld_fragmented`` equal the port's on the CPU, ``decode_frame`` decodes
   the HQ Packaged golden, and every golden and encoder tap (ConstQ, CBR
   and LD) encodes, byte-identically;
6. times on the card: the host cost of the device guard a launch runs
   in, end-to-end HQ and LD decode, ConstQ, CBR and LD encode (in turns)
   and fragmented decode frames/s; the band route (the entry points')
   against the in-place route (``inplace_route``: dequantise,
   lanes_to_plane and lift_level to decode, forward_planes and
   plane_to_lanes to encode; first checked to the same bytes), end to end
   in turns (band, in-place, in-place, band) for the three 1080p fixture
   decodes and the ConstQ encode; the per-stage breakdown of one 1080p
   picture each way on both routes (a "cbr search" stage in the CBR
   encode, a "rate control" stage in the LD encode; the LD decode's host
   header walk, and the host scan with its LL recurrence that the mesh
   route keeps), the device's idle share, each kernel's time beside its
   bound and its plain version's time (the LD DC prediction's beside its
   chain bound: the grid's anti-diagonals at DC_CELL_CHAIN dependent
   instructions of INT_LATENCY cycles), and the LD rate control's
   dependent step (the kernel on one row and on one column of the
   picture's slices), its bound by the dependent chain (the steps times
   the deepest LL block's cells at LL_CELL_CHAIN dependent instructions
   of INT_LATENCY cycles) and its body table kernel alone;
7. the encode CLI's one-picture pipeline: 16 distinct seeded 1080p
   4:2:2 10-bit pictures (``make_1080p.make_sequence``) through the CLI's
   ``run`` in ConstQ ``-q 40``, CBR ``-S 2 -s 829440`` and CBR with ``-F
   16384``, each stream equal to the plain per-picture loop's
   (``plain_encode``; band_forward 2, hq_pack 1, hq_cbr 1 launches a
   picture);
   ``Encoder.encode_picture_async``'s dispatch with no synchronisation;
   ms a picture of the pipelined CLI and the plain loop in ConstQ and CBR
   (and of the file's read alone), in turns;
8. the multi-device paths on the one card, every mesh ``[cuda:0] * n``:
   the in-place halo lift against the unsharded lift (7 wavelets at depth
   2, Fidelity also at 3, over 2 and 4 bands and over the thinnest bands
   the JAX package takes, whose margins reach two bands away; ``depth``
   launches each way) and one ``lift_levels`` call of 50 planes (2
   launches); the band form (``halo.forward_bands_local``,
   ``inverse_bands_local``) over 2 and 4 bands of the card against the
   single-device band route and the plain versions (the same wavelets and
   depths, 4:2:2 and 4:2:0 grids and the thinnest bands, LD grids as band
   0; ``depth`` launches of each kernel a band); the 1080p ConstQ and CBR
   pictures through the encode CLI over a 1x3 mesh (bytes equal to the
   fixtures; band_forward 6, lift_level 0, hq_cbr 3, hq_pack 3), the CBR
   one with ``-F 16384`` (equal to the single-device fragments) and the
   LD one over ``1x2`` (equal to ``ld_1080p.vc2``; ``LDEncoder(mesh=)``'s
   in-place halo lift: lift_level 2, ld_rate 1, ld_pack 1), each decoded
   with ``Decoder(mesh=)`` to the recorded SHA-256 (over 1x3: hq_unpack
   3 a picture, or LD's one unpack on the first device, ld_unpack 1 and
   ld_dc 1; band_inverse 6, lift_level 0; LD also over 1x2, whose 135
   slice rows do not divide: ld_unpack 1, ld_dc 1 and the in-place halo
   inverse, lift_level 2); 8K
   HQ CBR (BASELINE config #5, 1080 x 960 slices) over 1x4 and 2x4
   meshes (two pictures; band_forward 2 a band) against the
   single-device ``Encoder`` (q indices, payloads, streams)
   and, over 1x4, the decode against ``Decoder()`` (band_inverse 8); the
   per-band balance, the 8K times (one card, the bands on one device: not
   a scaling figure); the band form against the mesh's in-place route
   (``inplace_mesh_route``, first checked to the same bytes) in turns
   (band, in-place, in-place, band): the 1080p ConstQ and CBR decodes and
   the ConstQ encode over 1x3, the 8K CBR encode and decode over 1x4; two
   processes sharing the card (gloo on 127.0.0.1, a 2x1 mesh, 1080p CBR)
   against one device; the dry run on a 2x2 mesh; then a row split over
   two processes sharing the card (1x2 at 1080p, a band each; 1x4 at 8K,
   two bands each, with the in-place halo lift over the split row for
   every wavelet at depths 1-3) against one device. It runs after the
   times, so that what the 8K runs leave in the process does not weigh on
   them.

Each phase prints its time.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. A kernel's
``ms`` is one picture's launches timed with CUDA events as the host issues
them (the pack's launch with its one synchronisation), so it counts the
wrapper's time to issue a launch where that is longer than the card's to
run it; ``device_ms`` is the card's time alone: the card sleeps while the
host queues the launches (``time_device(queued=True)``).
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
FRAGMENT = 16384          # -F of the fragmented 1080p CBR encode
REPEAT = 4                # pictures of each main-path decode's stream
# the decode's kernels, counted in the profiler's device trace
TRACED = ("hq_unpack_kernel", "ld_unpack_kernel", "ld_dc_kernel",
          "band_level_kernel")
SEQ_PICTURES = 16         # distinct pictures of the encode pipeline's input
PIPE_REPS = 5             # timed runs of each encode over that input
# (harness size, bands) of the rows split over two processes on the card
SPLIT_ROWS = (("1080p", 2), ("8k", 4))
# the LD rate control's dependent chain, from csrc/ld_rate.cu: the
# dependent integer instructions of one LL cell (the prediction's mean and
# edge select 8, the difference and its magnitude 2, the exact quotient
# and its correction 12, the sign 2, the rescale 11, the sum 1), and the
# least latency between two dependent integer instructions on Hopper
LL_CELL_CHAIN = 34
# csrc/ld_dc.cu's dependent instructions a cell: the sum of three, the
# rounding's sign, the division by 3 (multiply-high, shift, sign), the term
DC_CELL_CHAIN = 7
INT_LATENCY = 4           # cycles


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_hz() -> float:
    """The card's highest SM clock, Hz (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


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
    alone; ``fn`` must then not synchronise."""
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


def stage_times(torch, fn, route: str, reps: int = REPS) -> dict:
    """Median ms of each device stage of ``fn(mark)``, which calls
    ``mark(label)`` after each stage: CUDA-event intervals between
    consecutive marks (the host's issue gaps included), after a warm-up.
    A stage that both routes run is labelled with ``route`` too."""
    def once():
        marks = []

        def mark(label):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((label, e))

        mark(None)
        fn(mark)
        torch.cuda.synchronize()
        return [(label, a.elapsed_time(b))
                for (_, a), (label, b) in zip(marks, marks[1:])]

    once()
    rows = [once() for _ in range(reps)]
    out = {}
    for i, (label, _ms) in enumerate(rows[0]):
        if "route" not in label:
            label = f"{label} [{route}]"
        out[label] = statistics.median(r[i][1] for r in rows)
    return out


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


def report_busy(torch, label: str, fn, card: str):
    prof = device_busy(torch, fn)
    if prof is None:
        print(f"device busy {label}: not measured (the profiler trace "
              "holds no device events)")
        return
    busy, wall, by_name = prof
    print(f"device busy {label}: {busy:.3f} ms of a {wall:.3f} ms "
          f"profiled run, idle share {1 - busy / wall:.3f} ({card})")
    for nm, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  device time {nm[:70]}: {t:.4f} ms")


def print_rate(label: str, ts: list, card: str, note: str = "") -> float:
    ts = sorted(ts)
    ms, p75 = statistics.median(ts), ts[int(0.75 * len(ts)) - 1]
    print(f"end to end {label}: median {ms:.3f} ms/picture = "
          f"{1e3 / ms:.2f} fps, p75 {p75:.3f} ms, min {ts[0]:.3f}, "
          f"max {ts[-1]:.3f} ({len(ts)} runs after a warm-up{note}; {card})")
    return ms


def report_rate(label: str, fn, card: str) -> float:
    return print_rate(label, host_samples(fn, E2E_REPS), card)


def report_rates_in_turns(runs: dict, card: str, pictures: int = 1,
                          reps: int = E2E_REPS) -> dict:
    """End-to-end rates of several functions, each over ``pictures``
    pictures, sampled in turns (one call of each per round, ``reps``
    rounds after a warm-up), so the host's drift over the run falls on
    all of them alike."""
    samples = {label: [] for label in runs}
    for fn in runs.values():
        fn()
    for _ in range(reps):
        for label, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            samples[label].append(1e3 * (time.perf_counter() - t0)
                                  / pictures)
    return {label: print_rate(label, ts, card, ", in turns")
            for label, ts in samples.items()}


def report_routes_in_turns(pairs: dict, card: str,
                           reps: int = E2E_REPS // 2) -> None:
    """End-to-end ms of the same work on the band route and on the
    in-place route, ``pairs`` {label: (band fn, in-place fn)}, sampled in
    turns: each round runs band, in-place, in-place, band (``reps`` rounds
    after a warm-up), so both routes meet the host's drift alike."""
    for label, fns in pairs.items():
        for fn in fns:
            fn()
        samples = ([], [])
        for _ in range(reps):
            for k in (0, 1, 1, 0):
                t0 = time.perf_counter()
                fns[k]()
                samples[k].append(1e3 * (time.perf_counter() - t0))
        for route, ts in zip(("band route", "in-place route"), samples):
            print_rate(f"{label}, {route}", ts, card,
                       ", in turns band / in-place / in-place / band")


def inplace_route():
    """(Decoder, Encoder) subclasses that take the in-place route, the
    entry points' route before the band route: dequantise, lanes_to_plane
    and one lift_level launch a level to decode; widen to int32,
    forward_planes and plane_to_lanes to encode (ConstQ). Reachable from
    this script only, to time the two routes in turns."""
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.core.config import PictureGeometry
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.pipeline import encoder as enc_mod
    from vc2tpu_torch.wavelet import lifting, matrices

    class InplaceDecoder(Decoder):
        def _decode_picture(self, job):
            pre, geo = job.pre, job.geo
            qm = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
            if job.ld is not None:
                lanes, q, grids = pipe.unpack_ld_payload(
                    job.payload, job.ld, geo, qm, pre.depth,
                    device=self.device)
                planes = pipe.dequantise_ld_planes(lanes, q, grids, qm,
                                                   pre.depth, geo)
            else:
                lanes, q = pipe.unpack_payload(
                    job.payload, job.q_idx, job.cbytes, geo, pre.slice_prefix,
                    start=job.start, device=self.device)
                planes = pipe.dequantise_planes(lanes, q, qm, pre.depth, geo)
            planes = lifting.inverse_planes(planes, pre.wavelet_kernel,
                                            pre.depth)
            out = PictureGeometry.of(job.pic_h, self.hdr.width,
                                     self.hdr.chroma_format)
            self._cur_picnum = job.picnum
            self._emit_words(pipe.format_planes(planes, out,
                                                self.hdr.bitdepth))

    class InplaceEncoder(enc_mod.Encoder):
        def _analyse(self, picture):
            cfg, d = self.cfg, self.cfg.wavelet_depth
            check(self.budgets is None, "the in-place route encodes ConstQ")
            planes = enc_mod.upload_picture(picture, cfg.bytes_per_sample,
                                            self.device, self.staging)
            lanes = enc_mod.planes_to_lanes(
                enc_mod.analyse(planes, cfg.kernel, d), self.geo, d)
            return lanes, self.q_indices(), None

    return InplaceDecoder, InplaceEncoder


def inplace_mesh_route():
    """(ShardedEncoder, ShardedDecoder, Decoder) subclasses that take the
    mesh's in-place route, the sharded paths' route before the band form:
    each band's rows and halo margins widened to int32 and padded, the
    in-place halo forward lift (``halo.forward_blocks``, one lift_level
    launch a level for every band of a device) and plane_to_lanes to
    encode; each band's own slices unpacked, dequantise_planes and the
    in-place halo inverse lift (``halo.inverse_bands``) to decode (HQ).
    Reachable from this script only, to time the two mesh routes in
    turns."""
    import numpy as np
    import torch

    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.pipeline import sharded
    from vc2tpu_torch.pipeline.decoder import dequantise_planes
    from vc2tpu_torch.shard import halo
    from vc2tpu_torch.slices import layout
    from vc2tpu_torch.slices.hq import SliceGeometry
    from vc2tpu_torch.vlc import device_pack, device_unpack

    class InplaceShardedEncoder(sharded.ShardedEncoder):
        def _launch(self, pictures):
            cfg, geo, d = self.cfg, self.geo, self.cfg.wavelet_depth
            check(self.data == 1 and all(map(all, self.mine)),
                  "the in-place mesh route runs 1xS meshes of one process")
            geos = [halo.band_rows(h, self.space, halo.margin(cfg.kernel, d))
                    for h, _w in self.padded]
            blocks = []
            for pic in pictures:
                blocks += sharded.upload_blocks(pic, cfg.bytes_per_sample,
                                                self.mesh.row(0), geos,
                                                self.padded)
            out = halo.forward_blocks(blocks, geos * len(pictures),
                                      cfg.kernel, d)
            ys_local = geo.y_slices // self.space
            jobs = []
            for b in range(len(pictures)):
                row = []
                for s, dev in enumerate(self.mesh.row(0)):
                    lanes = [layout.plane_to_lanes(out[3 * b + c][s],
                                                   ys_local, geo.x_slices, d)
                             for c in range(3)]
                    qm_y, qm_c = self._qm[dev]
                    budgets = self._budgets.get((dev, s))
                    scratch = None
                    if budgets is None:
                        q = torch.full((self.n_loc,), cfg.q_index,
                                       dtype=torch.int32, device=dev)
                    else:
                        scratch = device_pack.pack_scratch(
                            self.n_loc, lanes[0].shape[1], lanes[1].shape[1],
                            dev)
                        q = sharded.cbr.cbr_quant_indices(
                            *lanes, qm_y, qm_c, budgets, cfg.slice_scalar,
                            flags=scratch[1:2])
                    buf, status, _ = device_pack.quant_pack_hq_queued(
                        *lanes, q, qm_y, qm_c, cfg.slice_prefix,
                        cfg.slice_scalar, slice_sizes=budgets,
                        scratch=scratch)
                    row.append((q, buf, status))
                jobs.append(row)
            return jobs

    class InplaceShardedDecoder(sharded.ShardedDecoder):
        def decode_payload_device(self, payload, q_idx, dstart, cbytes,
                                  prefix=None, scalar=None, start=0):
            geo, space = self.geo, self.space
            (pl_h, pl_w), (pc_h, pc_w) = geo.padded_luma, geo.padded_chroma
            local = SliceGeometry(geo.y_slices // space, geo.x_slices,
                                  (pl_h // space, pl_w),
                                  (pc_h // space, pc_w), geo.luma_slice,
                                  geo.chroma_slice)
            self._check()
            data = np.frombuffer(payload, np.uint8)
            dstart = np.asarray(dstart, np.int64)
            cbytes = np.asarray(cbytes, np.int64)
            q_idx = np.asarray(q_idx).ravel()
            planes = []
            for s, dev in enumerate(self.devs):
                sl = slice(s * self.n_loc, (s + 1) * self.n_loc)
                lo = int(dstart[0, sl.start])
                hi = min(max(int((dstart[:, sl] + cbytes[:, sl]).max(
                    initial=lo)), lo), data.size)
                fields = np.concatenate([q_idx[None, sl], dstart[:, sl] - lo,
                                         cbytes[:, sl]]).astype(np.int32)
                pay = torch.from_numpy(data[lo:hi].copy()).to(dev)
                f = torch.from_numpy(fields).to(dev)
                lanes = device_unpack.unpack_hq(pay, f[1:4], f[4:7], self.ly,
                                                self.lc)
                planes.append(dequantise_planes(lanes, f[0], self.qmatrix,
                                                self.depth, local))
            out = halo.inverse_bands([[b[c] for b in planes]
                                      for c in range(3)],
                                     self.kernel, self.depth)
            first = self.devs[0]
            return tuple(torch.cat([t.to(first) for t in p]) for p in out)

    class InplaceMeshDecoder(Decoder):
        def _sharded_decoder(self, pre, geo):
            sdec = super()._sharded_decoder(pre, geo)
            if sdec is not None and not isinstance(sdec,
                                                   InplaceShardedDecoder):
                sdec = InplaceShardedDecoder(pre.wavelet_kernel, pre.depth,
                                             geo, self.mesh)
                self._sdec_cache[pre.wavelet_kernel, pre.depth, geo] = sdec
            return sdec

    return InplaceShardedEncoder, InplaceMeshDecoder


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


def decode_repeated(torch, data: bytes, digest: str, zero_counts, counts,
                    label: str) -> tuple:
    """``data``, a one-picture stream, ``REPEAT`` times over through one
    ``Decoder()``, under torch.profiler: every picture at SHA-256
    ``digest``, one graph captured and ``REPEAT - 1`` pictures replayed
    (``pipeline.replay``). Returns (the launch counters, zeroed just
    before the decode and read just after; {kernel of ``TRACED``: its
    launches in the profiler's device trace, the chain's run before the
    capture among them})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vc2tpu_torch.cli.decode_stream import Decoder

    class Digests:
        def __init__(self):
            self.got = []

        def write(self, b):
            self.got.append(hashlib.sha256(bytes(b)).hexdigest())
            return len(b)

    sink = Digests()
    dec = Decoder(sink=sink)
    zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rc = dec.run(data * REPEAT)
        torch.cuda.synchronize()
    launched = counts()
    check(rc == 0, f"decode {label} failed")
    check(sink.got == [digest] * REPEAT,
          f"{label}: decoded SHA-256s {sink.got} differ from the JAX "
          f"package's {digest}")
    check((dec.graph_captures, dec.graph_replays) == (1, REPEAT - 1),
          f"{label}: {dec.graph_captures} graphs captured and "
          f"{dec.graph_replays} pictures replayed, expected 1 and "
          f"{REPEAT - 1}")
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    traced = {k: sum(bool(re.search(rf"(^|\W){k}[(<]", n)) for n in names)
              for k in TRACED}
    return launched, traced


def fragments_of(stream: bytes) -> int:
    """The number of HQ fragment data units of a stream."""
    from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader

    n, pos = 0, 0
    while pos + 13 <= len(stream):
        du, next_off, _prev = StreamReader(stream[pos:]).read_data_unit()
        n += du == DataUnitType.HQ_FRAGMENT
        if next_off == 0:
            break
        pos += next_off
    return n


def golden_encode_args(meta: dict, case: str, tap: str | None) -> tuple:
    """(argv, input path, reference path) of a golden encode: the JAX
    package's golden test's command line."""
    _, inp, extra = next(c for c in meta["cases"] if c[0] == case)
    m = meta["inputs"][inp]
    argv = ["-x", str(m["width"]), "-y", str(m["height"]), "-f", m["fmt"],
            "-l", str(m["depth"]), "-n", "2", *extra]
    ref = f"{case}.vc2" if tap is None else f"{case}.{tap.lower()}.raw"
    if tap is not None:
        argv += ["-o", tap]
    return argv, os.path.join(GOLDEN, f"{inp}.16p2"), os.path.join(GOLDEN,
                                                                   ref)


def run_encode_cli(argv, src: str, out: str, mesh=None) -> bytes:
    """The encode CLI's run of ``argv``, over ``mesh`` (a ``Mesh``, as
    ``--mesh`` builds one) where given."""
    from vc2tpu_torch.cli import encode_stream

    args = encode_stream.build_parser().parse_args(argv + [src, out])
    args.mesh = mesh
    check(encode_stream.run(args) == 0, f"encode {' '.join(argv)} failed")
    with open(out, "rb") as f:
        return f.read()


def check_lift(torch, np, rng, dev) -> int:
    from vc2tpu_torch.core.config import WaveletKernel
    from vc2tpu_torch.wavelet import lifting

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

    def rand_plane(shape, span=1 << 20):
        return torch.as_tensor(rng.integers(-span, span + 1, shape)
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
        # the encoder's transform: both levels of three 1080p planes of
        # 10-bit samples, against the plain route on the CPU
        planes = [rand_plane(sh, 512) for sh in LEVEL_PLANES]
        got = lifting.forward_planes(planes, kernel, 2)
        want = lifting.forward_planes([p.cpu() for p in planes], kernel, 2)
        err = max(max_err(torch, g.cpu(), w) for g, w in zip(got, want))
        check(err == 0, f"forward_planes {kernel.name} 1080p 4:2:2: max "
                        f"|err| {err}")
        lift_err = max(lift_err, err)
        n_cmp += 1
    print(f"lift kernel == plain: {n_cmp} cases (7 of them forward_planes "
          f"at 1080p), max |err| {lift_err}")
    return lift_err


def slice_grid(ys: int, xs: int, luma: tuple, chroma: tuple):
    """A ``SliceGeometry`` of ys x xs slices of the given luma and chroma
    slice sizes."""
    from vc2tpu_torch.slices.hq import SliceGeometry

    return SliceGeometry(ys, xs, (ys * luma[0], xs * luma[1]),
                         (ys * chroma[0], xs * chroma[1]), luma, chroma)


def check_bands(torch, np, rng, dev) -> tuple:
    """Both band kernels (csrc/band_lift.cu) against their plain versions
    (integer ==): the 1080p 4:2:2 LeGall depth-2 geometry (depth launches
    each way), all seven wavelets at depths 1-3 on small grids, slice grids
    whose bands' sub-blocks are not powers of two (-u 1 -a 2 at 1080p,
    12-row slices, 4:2:0 with 24 / 12 columns, 4:4:4 at depth 3), and
    lanes and samples over the whole int32 range with half the slices at
    q 116-119 (LeGall, Daub97); slices larger than a tile, runs that start
    off a 16-byte boundary, the 8K geometry (many tiles a CTA) and the
    1080p geometry with a q a slice; the inverse from the lanes alone and
    with LD LL grids, the forward from int16 and from int32 samples whose
    planes pad. Returns (inverse max |err|, forward max |err|, cases)."""
    from vc2tpu_torch.core.config import WaveletKernel
    from vc2tpu_torch.wavelet import bands, matrices

    errs = [0, 0]
    n_cmp = 0

    def case(geo, kernel, depth, lim=2000, q_hi=60, wrap=False):
        nonlocal n_cmp
        qm = matrices.quant_matrix(kernel, depth)
        comps = (geo.luma_slice, geo.chroma_slice, geo.chroma_slice)
        pads = (geo.padded_luma, geo.padded_chroma, geo.padded_chroma)
        lanes = [torch.as_tensor(rng.integers(-lim, lim, (geo.n_slices, h * w))
                                 .astype(np.int32), device=dev)
                 for h, w in comps]
        q = rng.integers(0, q_hi, geo.n_slices).astype(np.int32)
        if wrap:
            q[::2] = rng.integers(116, 120, len(q[::2]))
        q = torch.as_tensor(q, device=dev)
        n0 = (bands.inverse_lanes.launches, bands.forward_lanes.launches)
        grids = [torch.as_tensor(rng.integers(-1 << 14, 1 << 14,
                                              (h >> depth, w >> depth))
                                 .astype(np.int32), device=dev)
                 for h, w in pads]
        for ll in (None, grids):
            got = bands.inverse_lanes(lanes, q, qm, geo, kernel, depth, ll)
            want = bands.inverse_lanes_plain(lanes, q, qm, geo, kernel, depth,
                                             ll)
            torch.cuda.synchronize()
            err = max(max_err(torch, g, w) for g, w in zip(got, want))
            check(err == 0, f"band_inverse {kernel.name} d{depth} "
                            f"{geo.luma_slice}/{geo.chroma_slice} ll="
                            f"{ll is not None}: max |err| {err}")
            errs[0] = max(errs[0], err)
            n_cmp += 1
        cut = 1 if depth == 1 else 3          # rows and columns the pad adds
        for dtype, span in ((torch.int16, 512), (torch.int32, lim)):
            planes = [torch.as_tensor(rng.integers(-span, span,
                                                   (h - cut, w - 1)),
                                      device=dev).to(dtype) for h, w in pads]
            got = bands.forward_lanes(planes, kernel, depth, geo)
            want = bands.forward_lanes_plain(planes, kernel, depth, geo)
            torch.cuda.synchronize()
            err = max(max_err(torch, g, w) for g, w in zip(got, want))
            check(err == 0, f"band_forward {kernel.name} d{depth} "
                            f"{geo.luma_slice}/{geo.chroma_slice} {dtype}: "
                            f"max |err| {err}")
            errs[1] = max(errs[1], err)
            n_cmp += 1
        return (bands.inverse_lanes.launches - n0[0],
                bands.forward_lanes.launches - n0[1])

    launches = case(slice_grid(135, 240, (8, 8), (8, 4)), WaveletKernel.LeGall,
                    2)
    check(launches == (4, 4), f"the 1080p band kernels launched {launches} "
                              "times for two pictures each way, expected 4")
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for depth in (1, 2, 3):
            side = 8 << max(depth - 1, 0)
            case(slice_grid(3, 5, (side, 16), (side, 8)), kernel, depth)
    for ys, xs, luma, chroma, depth in ((270, 240, (4, 8), (4, 4), 2),
                                        (3, 5, (12, 24), (12, 12), 2),
                                        (4, 3, (16, 24), (8, 12), 2),
                                        (2, 3, (24, 40), (24, 40), 3)):
        for kernel in (WaveletKernel.DD137, WaveletKernel.Fidelity):
            case(slice_grid(ys, xs, luma, chroma), kernel, depth)
    for kernel in (WaveletKernel.LeGall, WaveletKernel.Daub97):
        case(slice_grid(4, 6, (24, 40), (24, 16)), kernel, 3,
             lim=(1 << 31) - 1, q_hi=120, wrap=True)
    # the edges of the run-major design: slices of 64 x 64 at depth 1,
    # whose 32-row sub-blocks every tile splits; runs that start off a
    # 16-byte boundary (6 x 10 slices at depth 1: LL is 15 lanes, so the
    # LD grids' runs start at lane 15); the 8K geometry (BASELINE config
    # #5, -u 1 -a 2: 4536 tiles at its finest level, far more than the
    # CTAs the card holds, so every CTA walks many tiles); the 1080p
    # geometry with a q a slice over 0-119, half of them 116-119 (CBR-like)
    for geo, depth in ((slice_grid(2, 3, (64, 64), (64, 32)), 1),
                       (slice_grid(5, 7, (6, 10), (6, 6)), 1)):
        for kernel in (WaveletKernel.LeGall, WaveletKernel.Fidelity):
            case(geo, kernel, depth)
    case(slice_grid(1080, 960, (4, 8), (4, 4)), WaveletKernel.LeGall, 2)
    case(slice_grid(135, 240, (8, 8), (8, 4)), WaveletKernel.LeGall, 2,
         q_hi=120, wrap=True)
    print(f"band kernels == plain: {n_cmp} cases (1080p LeGall d2; 7 "
          "wavelets at depths 1-3; -u 1 -a 2 at 1080p, 12-row, 4:2:0 and "
          "4:4:4 slice grids; int32-wrapping lanes at q 116-119 and "
          "samples; LD grids; int16 and int32 samples; tiles that split "
          "64 x 64 slices; runs off a 16-byte boundary; the 8K geometry; "
          "1080p with a q a slice at 0-119), max |err| "
          f"{errs[0]} / {errs[1]}")
    return errs[0], errs[1], n_cmp


def check_unpack(torch, np, rng, dev, streams):
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.slices.hq import (scan_hq_slice_offsets,
                                        scan_hq_slice_offsets_plain)
    from vc2tpu_torch.vlc import device_unpack as du

    unpack_cases = []
    for key, data in streams.items():
        for _dec, pos, job in pictures_of(data, dev):
            unit = data[pos:]
            args = (job.geo.n_slices, job.pre.slice_prefix,
                    job.pre.slice_size_scalar, job.start)
            native = scan_hq_slice_offsets(unit, *args)
            plain = scan_hq_slice_offsets_plain(unit, *args)
            check(all(np.array_equal(a, b) for a, b in
                      zip(native[:3], plain[:3])) and native[3] == plain[3],
                  f"{key}: the native chain scan differs from the Python "
                  "loop")
            pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
            clen = fields[1:].contiguous()
            dstart = du.hq_component_offsets(clen, job.pre.slice_prefix,
                                             job.start)
            ly = job.geo.luma_slice[0] * job.geo.luma_slice[1]
            lc = job.geo.chroma_slice[0] * job.geo.chroma_slice[1]
            unpack_cases.append((key, pay, dstart, clen, ly, lc))
    print(f"native chain scan == Python loop on {len(unpack_cases)} "
          "fixture pictures")
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
    return unpack_err, unpack_cases


def ld_picture_of(stream: bytes, device):
    """(decoder, byte offset, located picture) of the first LD picture of a
    stream, via the Decoder's host half (``locate_picture``, which runs the
    native header walk)."""
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader

    dec = Decoder(sink=io.BytesIO(), device=device)
    pos = 0
    while pos + 13 <= len(stream):
        rd = StreamReader(stream[pos:])
        du, next_off, _prev = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            dec.hdr = rd.read_sequence_header()
            dec._major_version = rd.major_version
        elif du == DataUnitType.LD_PICTURE:
            return dec, pos, dec.locate_picture(stream[pos:], False)[1]
        pos += next_off
    raise RuntimeError("chip_smoke: the stream holds no LD picture")


def ld_random_fields(np, rng, n: int, nbytes: int, far: bool = False,
                     runs: bool = False):
    """(payload, fields int32 [4, N]) of seeded LD slices: the first 64
    slices (all, when fewer) start at every lead bit offset 0-31 in turn,
    a fifth of the U/V
    regions are empty, a third of the luma lengths run past the slice; with
    ``far`` the slices spread over the whole payload, so a CTA's window is
    too large to stage; with ``runs`` the payload is runs of 0x00 bytes
    (codes with no terminator in 64 bits, the clamp) and 0xFF bytes (runs
    of zero codes, across the bound)."""
    payload = rng.integers(0, 256, nbytes, dtype=np.uint8)
    if runs:
        payload = np.concatenate([
            np.full(rng.integers(1, 40), rng.choice([0, 0xFF, 0x3C]),
                    np.uint8) for _ in range(nbytes // 20)])[:nbytes]
        nbytes = len(payload)
    s_bits = np.sort(rng.integers(0, 8 * (nbytes - 64), n))
    if not far:
        k = min(n, 64)
        s_bits[:k] = 8 * 64 + np.arange(k)
    len_bits = rng.integers(0, 10, n)
    y_bits = rng.integers(0, 260, n)
    y_bits[::3] = rng.integers(1000, 4000, len(y_bits[::3]))
    uv_bits = rng.integers(0, 260, n)
    uv_bits[::5] = 0
    return payload, np.stack([s_bits, len_bits, y_bits, uv_bits]).astype(
        np.int32)


def check_ld(torch, np, rng, dev, stream: bytes):
    """The LD unpack kernel against its plain version (integer ==), the
    native header walk and LD scan against the scan's Python twin, and the
    LL grids the DC kernel computes from the fixture's lanes against the
    twin's. Returns the max |err| of the unpack and of the DC kernel."""
    from vc2tpu_torch.quant import ld_dc
    from vc2tpu_torch.slices import layout
    from vc2tpu_torch.slices import ld as slices_ld
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import matrices

    _dec, offset, job = ld_picture_of(stream, dev)
    pre, geo = job.pre, job.geo
    sizes = layout.slice_bytes_map(
        geo.y_slices, geo.x_slices,
        pre.slice_bytes_numerator * geo.n_slices
        // pre.slice_bytes_denominator, 1).ravel()
    qm = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
    # job.ld is the native header walk's, from locate_picture
    plain = slices_ld.ld_scan_plain(stream[offset:], sizes, geo, pre.depth,
                                    qm, job.start)
    native = slices_ld.ld_scan(stream[offset:], sizes, geo, pre.depth, qm,
                               job.start)
    check(all(np.array_equal(plain.q, s.q)
              and np.array_equal(plain.fields, s.fields)
              and plain.end == s.end for s in (job.ld, native))
          and all(np.array_equal(a, b)
                  for a, b in zip(plain.grids, native.grids)),
          "the native header walk or LD scan differs from its Python twin")
    print(f"native header walk and LD scan == Python twin on the 1080p LD "
          f"fixture ({job.geo.n_slices} slices, LL grids "
          f"{[g.shape for g in plain.grids]})")
    ly = geo.luma_slice[0] * geo.luma_slice[1]
    lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    pay = torch.as_tensor(np.array(job.payload), device=dev)
    fields = torch.as_tensor(job.ld.fields, device=dev)
    grids = ld_dc.ll_grids(
        du.unpack_ld(pay, fields, ly, lc),
        torch.as_tensor(job.ld.q, device=dev),
        ld_dc.plan(geo, pre.depth, tuple(int(v) for v in qm), pay.device))
    dc_err = max(max_err(torch, g, torch.as_tensor(w, device=dev))
                 for g, w in zip(grids, plain.grids))
    check(dc_err == 0, f"ld_dc on the 1080p LD fixture: max |err| {dc_err}")
    print(f"ld_dc kernel == Python twin's LL grids on the 1080p LD fixture, "
          f"max |err| {dc_err}")

    def t(a):
        return torch.as_tensor(a, device=dev)

    cases = [("1080p LD fixture", pay, fields, ly, lc),
             ("1080p LD fixture cut short", pay[:-2000].clone(), fields, ly,
              lc)]
    for name, n, nbytes, far, runs, lanes in (
            ("random: leads 0-31, empty U/V, long luma, ragged", 4099,
             1 << 17, False, False, (16, 8)),
            ("random: slices too far apart to stage", 256, 1 << 20, True,
             False, (16, 8)),
            ("random: lanes too many for the tile", 40, 1 << 12, False,
             False, (20000, 10000)),
            ("random: lanes too many for the tile, slices far apart", 40,
             1 << 20, True, False, (20000, 10000)),
            ("runs of 0x00 and 0xFF: the clamp, zero runs past the bound",
             2000, 1 << 16, False, True, (64, 32))):
        payload, f = ld_random_fields(np, rng, n, nbytes, far, runs)
        cases.append((name, t(payload), t(f), *lanes))
    err, n_staged, n_global, n_direct, n_direct_global = 0, 0, 0, 0, 0
    for name, pay_c, f_c, ly_c, lc_c in cases:
        s, lanes_staged = du.ld_unpack_plan(ly_c, lc_c)
        staged = torch.full((-(-f_c.shape[1] // s),), 2, dtype=torch.uint8,
                            device=dev)
        got = du.unpack_ld(pay_c, f_c, ly_c, lc_c, staged=staged)
        want = du.unpack_ld_plain(pay_c, f_c, ly_c, lc_c)
        torch.cuda.synchronize()
        e = max(max_err(torch, g, w) for g, w in zip(got, want))
        check(e == 0, f"unpack_ld {name}: max |err| {e}")
        check(int(staged.max().item()) <= 1,
              f"unpack_ld {name}: a CTA left its branch flag unset")
        err = max(err, e)
        k = int(staged.sum().item())
        n_staged += k
        n_global += staged.numel() - k
        n_direct += not lanes_staged
        n_direct_global += (not lanes_staged) * (staged.numel() - k)
        print(f"  ld_unpack {name}: {f_c.shape[1]} slices, {staged.numel()} "
              f"CTAs, {staged.numel() - k} peek from device memory, lanes "
              f"staged in shared memory: {lanes_staged}")
    check(n_staged > 0 and n_global > 0 and n_direct > 0
          and n_direct_global > 0,
          "the LD unpack cases miss a branch: the window staged or read "
          "from device memory, the lanes in the tile or not")
    print(f"ld_unpack kernel == plain: {len(cases)} cases, max |err| {err}")
    return err, dc_err


def fixture_lanes(dev, picture, key: str):
    """(encoder, transform planes, transform lanes) of a 1080p fixture's
    picture on the card, with the fixture's recorded flags."""
    from vc2tpu_torch.cli import encode_stream
    from vc2tpu_torch.pipeline import encoder as enc_mod

    args = encode_stream.build_parser().parse_args(
        fixture_encode_args(key) + ["in", "out"])
    enc = enc_mod.Encoder(encode_stream.config_from_args(args), device=dev)
    cfg, d = enc.cfg, enc.cfg.wavelet_depth
    planes = enc_mod.upload_picture(picture, cfg.bytes_per_sample, dev)
    transform = enc_mod.analyse(planes, cfg.kernel, d)
    return enc, transform, enc_mod.planes_to_lanes(transform, enc.geo, d)


def encode_1080p_lanes(dev, picture):
    """(encoder, transform lanes, quantised lanes, q indices, transform
    planes) of the 1080p ConstQ fixture's picture on the card; the
    quantised lanes by ``quantise`` (torch ops), for the pack's cases."""
    from vc2tpu_torch.pipeline import encoder as enc_mod

    enc, transform, tlanes = fixture_lanes(dev, picture, "constq_1080p")
    q_idx = enc.q_indices()
    qlanes = enc_mod.quantise(tlanes, q_idx, enc.qmatrix,
                              enc.cfg.wavelet_depth, enc.geo)
    return enc, tlanes, qlanes, q_idx, transform


def fixture_encode_args(key: str) -> list:
    """The encode flags ``fixtures_1080p.json`` records for a fixture."""
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        cmd = json.load(f)["streams"][key]["encode"]
    return cmd[cmd.index("vc2tpu.cli.encode_stream") + 1:-2]


def climb_lanes(np, rng, n_luma: int, n_chroma: int):
    """Slices whose one non-zero lane is lane 0 (every magnitude 1-3999,
    seeded signs, budgets 5-8 bytes, seeded order): among them the hill
    climb runs past the JAX package's batched prefix of 3 steps."""
    mags, budgets = np.meshgrid(np.arange(1, 4000), np.arange(5, 9),
                                indexing="ij")
    order = rng.permutation(mags.size)
    y = np.zeros((mags.size, n_luma), np.int32)
    y[:, 0] = (mags.ravel() * rng.choice([-1, 1], mags.size))[order]
    chroma = np.zeros((mags.size, n_chroma), np.int32)
    return [y, chroma, chroma.copy()], budgets.ravel()[order].astype(np.int32)


def check_cbr(torch, np, rng, dev, enc, tlanes):
    """The CBR search kernel against its plain version, integer == on the
    q indices, and the flag it sets above 119; the fused pack at the
    searched indices against its plain version. Returns (max |err|,
    number of cases, the 1080p case's longest climb)."""
    from vc2tpu_torch.rdo import cbr
    from vc2tpu_torch.slices import layout
    from vc2tpu_torch.vlc import device_pack as dp

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    geo, scalar = enc.geo, enc.cfg.slice_scalar
    ly, lc = tlanes[0].shape[1], tlanes[1].shape[1]

    def budgets(total, scalar_, ys=geo.y_slices, xs=geo.x_slices):
        return t(layout.slice_bytes_map(ys, xs, int(total), scalar_).ravel())

    def rand_lanes(n, span, zero_frac, lengths=(ly, lc, lc)):
        out = []
        for length in lengths:
            v = rng.integers(-span, span + 1, (n, length))
            v[rng.random((n, length)) < zero_frac] = 0
            out.append(t(v.astype(np.int32)))
        return out

    pic = enc.picture_bytes
    n = 5000
    wild = rand_lanes(n, (1 << 29) - 1, 0.3)
    wild[0][::7, 1] = (1 << 29) - 1
    wild[1][::11, 2] = -((1 << 29) - 1)
    zeros = [torch.zeros_like(x) for x in wild]
    mixed = rand_lanes(n, 1 << 12, 0.5)
    for x in mixed:
        x[::3] = 0                                  # all-zero slices
    climb, climb_budgets = climb_lanes(np, rng, ly, lc)
    climb = [t(x) for x in climb]
    ragged = [x[:333].contiguous() for x in tlanes]
    wide = rand_lanes(64, 1 << 16, 0.5, (2048, 1024, 1024))
    qm_wide = (t(rng.integers(0, 8, 2048).astype(np.int32)),
               t(rng.integers(0, 8, 1024).astype(np.int32)))
    check(cbr.group_plan(2048, 1024) == 0, "the wide case is held")

    def shaped(n_, shape, span=1 << 12):
        lanes_ = rand_lanes(n_, span, 0.4, shape)
        qm_ = (t(rng.integers(0, 8, shape[0]).astype(np.int32)),
               t(rng.integers(0, 8, shape[1]).astype(np.int32)))
        return lanes_, qm_

    ragged_group, qm_ragged = shaped(3001, (65, 33, 33))
    tiny, qm_tiny = shaped(n, (2, 1, 1))
    group8, qm_8 = shaped(n, (32, 16, 16))
    yuv444, qm_444 = shaped(n, (64, 64, 64))
    streamed, qm_streamed = shaped(500, (129, 10, 10))
    check((cbr.group_plan(65, 33), cbr.group_plan(2, 1),
           cbr.group_plan(32, 16), cbr.group_plan(64, 64),
           cbr.group_plan(129, 10), cbr.group_plan(ly, lc))
          == (32, 4, 8, 32, 0, 16), "the CBR cases miss a group size")
    cases = [  # name, lanes, budgets, scalar, pack prefix (None: no pack),
        # the quant matrix entries of the lanes (None: the encoder's)
        ("1080p CBR lanes, the fixture's budgets", tlanes, enc.budgets,
         scalar, enc.cfg.slice_prefix),
        ("1080p CBR lanes, budgets x0.25", tlanes,
         budgets(pic // 4, scalar), scalar, None),
        ("1080p CBR lanes, budgets x4", tlanes, budgets(4 * pic, scalar),
         scalar, None),
        ("1080p CBR lanes, scalar 1", tlanes, budgets(pic, 1), 1, 0),
        ("1080p CBR lanes, prefix 3 scalar 2", tlanes, budgets(pic, 2), 2, 3),
        ("random lanes up to +-(2^29 - 1), scalar 3", wild,
         budgets(n * 300, 3, 1, n), 3, None),
        ("all-zero slices", zeros, budgets(n * 20, 1, 1, n), 1, None),
        ("every third slice all zero", mixed, budgets(n * 40, 2, 1, n), 2,
         None),
        ("budgets no q meets (q 127)", wild, t(np.full(n, 5, np.int32)), 1,
         None),
        ("climbs past 3 steps", climb, t(climb_budgets), 1, None),
        ("ragged: 333 slices", ragged,
         enc.budgets[:333].contiguous(), scalar, None),
        ("slices too large for the registers (lanes from device memory)",
         wide, budgets(64 * 6000, 4, 1, 64), 4, None, qm_wide),
        ("ragged runs: 65 and 33 lanes, groups of 32", ragged_group,
         budgets(3001 * 50, 1, 1, 3001), 1, None, qm_ragged),
        ("tiny slices: 2 and 1 lanes, groups of 4", tiny,
         budgets(n * 8, 1, 1, n), 1, None, qm_tiny),
        ("32 and 16 lanes, groups of 8", group8, budgets(n * 20, 3, 1, n),
         3, None, qm_8),
        ("4:4:4 slices, groups of 32", yuv444, budgets(n * 60, 1, 1, n), 1,
         None, qm_444),
        ("129 and 10 lanes, a warp from device memory", streamed,
         budgets(500 * 100, 2, 1, 500), 2, None, qm_streamed),
    ]
    n_cases, longest, no_fit = 0, {}, None
    for name, lanes, sizes, scalar_, prefix, *qm in cases:
        qm = qm[0] if qm else enc.qm
        flags = torch.zeros(1, dtype=torch.int64, device=dev)
        before = cbr.cbr_quant_indices.launches
        got = cbr.cbr_quant_indices(*lanes, *qm, sizes, scalar_, flags=flags)
        want = cbr.cbr_quant_indices_plain(*lanes, *qm, sizes, scalar_)
        torch.cuda.synchronize()
        check(cbr.cbr_quant_indices.launches == before + 1,
              f"cbr {name}: the kernel was not launched once")
        check(bool(torch.equal(got, want)),
              f"cbr {name}: {int((got != want).sum())} q indices differ")
        over = bool((want > 119).any())
        check(int(flags.item()) == (dp.FLAG_QMAX if over else 0),
              f"cbr {name}: flags {int(flags.item())}, q above 119: {over}")
        best = cbr.bisect_plain(*lanes, *qm, sizes, scalar_)
        longest[name] = int((want.to(torch.int64) - best).max())
        if name.startswith("budgets no q meets"):
            no_fit = want
        n_cases += 1
        line = (f"  cbr {name}: {got.numel()} q indices equal, q "
                f"{int(want.min())}-{int(want.max())}, longest climb "
                f"{longest[name]}, group "
                f"{cbr.group_plan(lanes[0].shape[1], lanes[1].shape[1])}")
        if prefix is not None:
            scratch = dp.pack_scratch(got.numel(), ly, lc, dev)
            buf, pflags, _ = dp.quant_pack_hq(*lanes, got, *enc.qm, prefix,
                                              scalar_, sizes, scratch=scratch)
            pwant, wflags, _ = dp.quant_pack_hq_plain(*lanes, want, *enc.qm,
                                                      prefix, scalar_, sizes)
            check(pflags == wflags == 0 and bool(torch.equal(buf, pwant)),
                  f"cbr {name}: the pack at the searched indices differs "
                  f"(flags {pflags}, plain {wflags})")
            line += f"; pack with prefix {prefix}: {buf.numel()} bytes equal"
        print(line)
    check(bool((no_fit == 127).all()), "the no-fit case has a slice that "
                                       "fits")
    check(longest["climbs past 3 steps"] > 3,
          "the climb case climbs no more than 3 steps")
    # the groups' redux.sync on their own masks against shuffles
    lib = cbr._lib()
    x = rng.integers(-(1 << 20), 1 << 20, 4096).astype(np.int32)
    src = t(x)
    for g in (4, 8, 16, 32):
        out = torch.empty((4096 // g, 4), dtype=torch.int32, device=dev)
        check(lib.hq_cbr_reduce_check_launch(
            src.data_ptr(), out.data_ptr(), 4096, g,
            torch.cuda.current_stream().cuda_stream) == 0,
            "the reduction check did not launch")
        got = out.cpu().numpy()
        groups = x.reshape(-1, g)
        check(np.array_equal(got[:, 0], groups.sum(1))
              and np.array_equal(got[:, 1], got[:, 0])
              and np.array_equal(got[:, 2], groups.max(1))
              and np.array_equal(got[:, 3], got[:, 2]),
              f"redux.sync on groups of {g} differs from the shuffles")
    print(f"cbr search kernel == plain: {n_cases} cases, q indices equal; "
          "redux.sync on groups of 4-32 == shuffles")
    return 0, n_cases, longest[cases[0][0]]


def ld_fixture_lanes(dev, picture):
    """(LD encoder, transform lanes) of the 1080p LD fixture's picture on
    the card, with the fixture's recorded flags."""
    from vc2tpu_torch.cli import encode_stream
    from vc2tpu_torch.pipeline import encoder as enc_mod
    from vc2tpu_torch.pipeline.ld import LDEncoder

    args = encode_stream.build_parser().parse_args(
        fixture_encode_args("ld_1080p") + ["in", "out"])
    enc = LDEncoder(encode_stream.config_from_args(args), device=dev)
    cfg, d = enc.cfg, enc.cfg.wavelet_depth
    planes = enc_mod.upload_picture(picture, cfg.bytes_per_sample, dev)
    transform = enc_mod.analyse(planes, cfg.kernel, d)
    return enc, enc_mod.planes_to_lanes(transform, enc.geo, d)


def ld_rate_grid(torch, np, rng, dev, kernel, depth, luma, chroma, grid,
                 span, budgets):
    """The arguments of ``ld_rate_control`` for seeded lanes of slices
    ``luma`` / ``chroma`` (height, width) at ``depth`` in a ``grid`` of
    (rows, columns), values up to +-span (a third zero; span None: every
    |v| in [171e6, 2e8], 0 by index 111 and not at the wrapped index 119,
    with a quant matrix of 0), budgets drawn from [lo, hi) bytes."""
    from vc2tpu_torch.rdo import ld as rdo_ld
    from vc2tpu_torch.slices import layout
    from vc2tpu_torch.wavelet import matrices

    ts, n = 1 << depth, grid[0] * grid[1]
    qmatrix = matrices.quant_matrix(kernel, depth)
    lanes, bands = [], []
    for h, w in (luma, chroma, chroma):
        _, band = layout.lane_order(h, w, depth)
        bands.append(tuple(int(c) for c in np.bincount(
            band, minlength=3 * depth + 1)))
        if span is None:
            v = rng.integers(171_000_000, 200_000_001, (n, h * w)) \
                * rng.choice([-1, 1], (n, h * w))
            qmatrix = np.zeros_like(qmatrix)
        else:
            v = rng.integers(-span, span + 1, (n, h * w))
            v[rng.random(v.shape) < 0.3] = 0
        lanes.append(torch.as_tensor(v.astype(np.int32), device=dev))
    avail = rdo_ld.avail_bits(rng.integers(*budgets, n))
    return (*lanes, qmatrix, bands[0], bands[1],
            torch.as_tensor(avail, device=dev), grid,
            (luma[0] // ts, luma[1] // ts), (chroma[0] // ts, chroma[1] // ts))


def check_ld_rate(torch, np, rng, dev, enc, tlanes, fixture_q):
    """The LD rate control kernel against its plain version, integer == on
    q and the three LL lane sets, and its q on the fixture's picture
    against the q indices the LD scan reads from ``ld_1080p.vc2``. The
    plain version runs on the card for the 1080p lanes (its time at the
    fixture's budgets is the kernel line's ``plain_ms``) and on the host
    CPU for the other cases, where its small per-diagonal ops cost less.
    Returns (max |err|,
    number of cases, the plain version's ms, the kernel's result on the
    fixture's picture)."""
    from vc2tpu_torch.core.config import WaveletKernel as K
    from vc2tpu_torch.rdo import ld as rdo_ld
    from vc2tpu_torch.slices import layout

    geo = enc.geo
    grid = (geo.y_slices, geo.x_slices)

    def at_budget(lanes, avail):
        return (*lanes, enc.qmatrix, enc.band_sizes_y, enc.band_sizes_c,
                avail, grid, enc.ll_y, enc.ll_c)

    def scaled(factor):
        b = layout.slice_bytes_map(*grid, int(enc.picture_bytes * factor), 1)
        return torch.as_tensor(rdo_ld.avail_bits(b), device=dev)

    nll = (enc.ll_y[0] * enc.ll_y[1], enc.ll_c[0] * enc.ll_c[1])
    zero_bodies = [x.clone() for x in tlanes]
    for x, k in zip(zero_bodies, (nll[0], nll[1], nll[1])):
        x[:, k:] = 0
    big = (1 << 29) - 1
    # more rows than the card runs at once (the generic kernel, LL 1 x 1)
    resident = rdo_ld.resident_rows(64, 64, (1, 1), (1, 1))
    cases = [  # name, arguments; the plain version on the card (the
        # first case's time is the kernel line's plain_ms)
        ("1080p LD lanes, the fixture's budgets",
         at_budget(tlanes, enc.avail_device), True),
        ("1080p LD lanes, budgets x0.25", at_budget(tlanes, scaled(0.25)),
         True),
        ("1080p LD lanes, budgets x4", at_budget(tlanes, scaled(4)), True),
        ("1080p LD lanes, all-zero bodies",
         at_budget(zero_bodies, enc.avail_device), True),
        ("Haar1 depth 1, a single slice", ld_rate_grid(
            torch, np, rng, dev, K.Haar1, 1, (4, 4), (4, 2), (1, 1), big,
            (6, 50)), False),
        ("LeGall depth 2, a single row of 240", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 2, (8, 8), (8, 4), (1, 240), big,
            (8, 64)), False),
        ("DD97 depth 3, a single column of 135", ld_rate_grid(
            torch, np, rng, dev, K.DD97, 3, (8, 16), (8, 8), (135, 1), big,
            (8, 64)), False),
        ("LeGall depth 2, 7 x 11 slices", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 2, (8, 8), (8, 4), (7, 11), big,
            (30, 400)), False),
        ("budgets no q meets", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 2, (8, 8), (8, 4), (9, 13),
            (1 << 28) - 1, (2, 3)), False),
        (f"{resident + 64} rows of one slice, {resident} resident",
         ld_rate_grid(torch, np, rng, dev, K.LeGall, 3, (8, 8), (8, 8),
                      (resident + 64, 1), 3000, (8, 80)), False),
        ("LeGall depth 3, 64 x 64 slices (LL 8 x 8)", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 3, (64, 64), (64, 32), (5, 6),
            3000, (300, 4000)), False),
        ("LeGall depth 2, lanes up to +-(2^31 - 1)", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 2, (8, 8), (8, 4), (6, 10),
            (1 << 31) - 1, (30, 600)), False),
        ("body lanes 0 by index 111, non-zero at the wrapped 119",
         ld_rate_grid(torch, np, rng, dev, K.LeGall, 2, (8, 8), (8, 4),
                      (5, 7), None, (6, 400)), False),
        ("4:4:4, 6 x 9 slices", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 2, (8, 8), (8, 8), (6, 9), 3000,
            (8, 80)), False),
        ("4:2:0, 6 x 9 slices", ld_rate_grid(
            torch, np, rng, dev, K.DD97, 2, (8, 8), (4, 4), (6, 9), 3000,
            (8, 80)), False),
        ("4:2:2 at -u 1, 12 x 20 slices", ld_rate_grid(
            torch, np, rng, dev, K.LeGall, 2, (4, 8), (4, 4), (12, 20), 3000,
            (4, 40)), False),
    ]
    int16_past = False
    for name, args, on_card in cases:     # the body table on its own
        before = rdo_ld.body_table.launches
        got = rdo_ld.body_table(*args[:6])
        torch.cuda.synchronize()
        check(rdo_ld.body_table.launches == before + 1,
              f"ld_rate body table {name}: the kernel was not launched once")
        if on_card:
            want = rdo_ld.body_table_plain(*args[:6])
        else:
            want = rdo_ld.body_table_plain(*[a.cpu() for a in args[:3]],
                                           *args[3:6])
        check(bool(torch.equal(got.cpu(), want.cpu())),
              f"ld_rate body table {name}: "
              f"{int((got.cpu() != want.cpu()).sum())} entries differ")
        int16_past = int16_past or int(want.max()) > (1 << 15) - 1
    check(int16_past, "no body table case has entries past the int16 range")
    print(f"ld_rate body table kernel == plain: {len(cases)} cases, every "
          "slice and trial 0-127 equal")
    plain_ms, fixture, paths = None, None, set()
    for name, args, on_card in cases:
        before = rdo_ld.ld_rate_control.launches
        got = rdo_ld.ld_rate_control(*args)
        torch.cuda.synchronize()
        check(rdo_ld.ld_rate_control.launches == before + 1,
              f"ld_rate {name}: the kernel was not launched once")
        t0 = time.perf_counter()
        if on_card:
            want = rdo_ld.ld_rate_control_plain(*args)
            torch.cuda.synchronize()
        else:
            want = rdo_ld.ld_rate_control_plain(*[
                a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
        secs = time.perf_counter() - t0
        if fixture is None:     # the first case: the fixture's budgets
            plain_ms, fixture = 1e3 * secs, got
        for g, w, part in zip(got, want, ("q", "LL y", "LL u", "LL v")):
            check(bool(torch.equal(g.cpu(), w.cpu())),
                  f"ld_rate {name}: {part} differs in "
                  f"{int((g.cpu() != w.cpu()).sum())} places")
        q = want[0].cpu()
        fixed = rdo_ld.fixed_shape(args[0].shape[1], args[1].shape[1],
                                   args[8], args[9])
        paths.add((tuple(args[8]), tuple(args[9])) if fixed else None)
        print(f"  ld_rate {name}: {q.numel()} slices in a {args[7]} grid "
              f"equal, q {int(q.min())}-{int(q.max())} ({int((q == 127).sum())}"
              f" at 127), {'fixed-shape' if fixed else 'generic'} kernel; "
              f"plain {'on the card' if on_card else 'on the CPU'} "
              f"{secs:.1f} s")
        if name.startswith("budgets no q meets"):
            check(int((q == 127).sum()) > q.numel() // 2,
                  "the no-fit case has too few slices at q 127")
    check(paths == {((2, 2), (2, 1)), ((1, 2), (1, 1)), None},
          "the ld_rate cases miss a fixed-shape or the generic kernel")
    check(np.array_equal(fixture[0].cpu().numpy(), fixture_q),
          "the rate control's q on the 1080p picture differs from the q "
          "indices of ld_1080p.vc2")
    print(f"ld_rate kernel == plain: {len(cases)} cases, q and LL lanes "
          f"equal; its q on the 1080p picture == the {fixture_q.size} q "
          "indices the LD scan reads from ld_1080p.vc2")
    return 0, len(cases), plain_ms, fixture


def check_ld_pack(torch, np, rng, dev, enc, tlanes, rate):
    """The LD pack kernel against its plain version, the buffer [flags |
    payload] byte for byte and the quantised lanes: on the 1080p picture's
    transform lanes with the rate control's LL lanes, and on seeded lanes
    with every quant matrix entry 127, so each body lane is quantised at
    index 0, where quant is the identity, and the kernel packs them as they
    are; its stores bounded by the buffer. Returns (max |err|, number of
    cases, the 1080p picture's quantised lanes)."""
    from vc2tpu_torch.vlc import device_pack as dp
    from vc2tpu_torch.vlc import golomb

    q, *ll = rate
    got, kept = dp.quant_pack_ld(*tlanes, ll, q, *enc.qm, enc.sizes,
                                 enc.starts, enc.payload_bytes,
                                 keep_lanes=True)
    want, want_kept = dp.quant_pack_ld_plain(*tlanes, ll, q, *enc.qm,
                                             enc.sizes, keep_lanes=True)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, want))
          and all(bool(torch.equal(a, b)) for a, b in zip(kept, want_kept)),
          "ld_pack 1080p: the buffer or the quantised lanes differ")
    check(dp.ld_result(got)[0] == 0, "ld_pack 1080p: flags set")
    print(f"  ld_pack 1080p LD transform lanes: {got.numel()} bytes and the "
          "quantised lanes equal")

    def lanes_of(n, span, zero_frac, ly=64, lc=32):
        out = []
        for length, s in ((ly, span), (lc, span >> 1), (lc, span >> 1)):
            v = rng.integers(-s, s + 1, (n, length))
            v[rng.random((n, length)) < zero_frac] = 0
            out.append(torch.as_tensor(v.astype(np.int32), device=dev))
        return out

    def fitting(lanes, slack=2):
        need = (golomb.truncated_bits(lanes[0]) + golomb.truncated_bits(
            golomb.interleave(lanes[1], lanes[2]))).cpu().numpy()
        return torch.as_tensor(((need + 31) // 8 + rng.integers(
            0, slack + 1, need.size)).astype(np.int32), device=dev)

    def as_is(lanes, q_, nll=(4, 2)):
        """quant_pack_ld's arguments that pack ``lanes`` unchanged."""
        ll = [x[:, :k].contiguous() for x, k in zip(lanes, (nll[0], nll[1],
                                                           nll[1]))]
        qm = [torch.full((x.shape[1],), 127, dtype=torch.int32, device=dev)
              for x in lanes[:2]]
        return ll, q_, *qm

    def cut_sizes(lanes, overrun):
        """Slice bytes whose U/V bound falls 1-12 bits before the end of
        the last non-zero U/V code (inside a code or between codes); with
        ``overrun``, bytes that the luma codes alone overrun."""
        y_used = golomb.truncated_bits(lanes[0]).cpu().numpy()
        uv_used = golomb.truncated_bits(golomb.interleave(
            lanes[1], lanes[2])).cpu().numpy()
        sizes = np.maximum((7 + y_used) // 8, 1)
        if overrun:
            sizes = np.maximum(sizes - 1 - (y_used > 48), 1)
        else:
            need = 7 + y_used + uv_used - rng.integers(1, 13, y_used.size)
            for _ in range(3):   # len_bits grows with the size: settle it
                len_bits = np.array([max(8 * int(x) - 8, 0).bit_length()
                                     for x in sizes])
                sizes = np.maximum((need - len_bits) // 8, 1)
        return torch.as_tensor(sizes.astype(np.int32), device=dev)

    n = enc.geo.n_slices
    q_rand = torch.as_tensor(rng.integers(0, 128, n).astype(np.int32),
                             device=dev)
    rand = lanes_of(n, 1 << 20, 0.5)
    rand[0][::97, 5] = (1 << 30) + 12345            # codes of 62 bits
    rand[1][::89, 3] = -(1 << 31)                   # |INT_MIN|: 64 bits
    small = lanes_of(n, 40, 0.5)
    cut = fitting(small).cpu().numpy()
    cut[::7] = np.maximum(cut[::7] - 4, 2)
    zeros = [torch.zeros_like(x) for x in rand]
    ragged = [x[:333].contiguous() for x in small]
    chunky = lanes_of(1001, 40, 0.5, 63, 21)          # chunks of 15-16 lanes
    wide = lanes_of(300, 40, 0.5, 1024, 512)          # not held: read again
    part = [x[:3000].contiguous() for x in small]
    long_ = lanes_of(3000, 1 << 16, 0.5)
    cases = [  # name, lanes, q, sizes, expected flags, LL lanes
        ("1080p LD quantised lanes", list(kept), q, enc.sizes, 0, (4, 2)),
        ("random, codes over 32 bits", rand, q_rand, fitting(rand), 0,
         (4, 2)),
        ("all-zero slices", zeros, q_rand, enc.sizes, 0, (4, 2)),
        ("flag LD_FIT", small, q_rand, torch.as_tensor(cut, device=dev),
         dp.FLAG_LD_FIT, (4, 2)),
        ("ragged: 333 slices", ragged, q_rand[:333].contiguous(),
         fitting(ragged), 0, (4, 2)),
        ("U/V bound inside a code", small, q_rand, cut_sizes(small, False),
         dp.FLAG_LD_FIT, (4, 2)),
        ("luma codes overrun their slice", small, q_rand,
         cut_sizes(small, True), dp.FLAG_LD_FIT, (4, 2)),
        ("63 / 21 lanes: chunks of unequal lengths", chunky,
         q_rand[:1001].contiguous(), fitting(chunky), 0, (3, 1)),
        ("no LL lanes", small, q_rand, fitting(small), 0, (0, 0)),
        ("1024 / 512 lanes: chunks too long to hold", wide,
         q_rand[:300].contiguous(), fitting(wide), 0, (4, 2)),
        ("slices over several windows", part, q_rand[:3000].contiguous(),
         fitting(part) + 300, 0, (4, 2)),
        ("slices over several windows, long codes", long_,
         q_rand[:3000].contiguous(), fitting(long_) + 300, 0, (4, 2)),
    ]
    for name, lanes, q_, sizes, flags, nll in cases:
        got, got_kept = dp.quant_pack_ld(*lanes, *as_is(lanes, q_, nll),
                                         sizes, keep_lanes=True)
        want = dp.pack_ld_plain(*lanes, q_, sizes)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)), f"ld_pack {name}: the buffers "
                                            "differ")
        check(all(bool(torch.equal(a, b)) for a, b in zip(got_kept, lanes)),
              f"ld_pack {name}: the lanes at index 0 changed")
        check(dp.ld_result(got)[0] == flags, f"ld_pack {name}: flags "
                                             f"{dp.ld_result(got)[0]}")
        print(f"  ld_pack {name}: {got.numel()} bytes equal, flags {flags}, "
              f"{dp.ld_group_size(lanes[0].shape[1], lanes[1].shape[1])} "
              "threads a slice")
    guard = 4096
    sizes = fitting(small)
    total = int(sizes.sum())
    buf = torch.full((4 + total + guard,), 0xA5, dtype=torch.uint8,
                     device=dev)
    ll, q_, qm_y, qm_c = as_is(small, q_rand)
    dp.launch_ld_pack(small, ll, q_, (qm_y, qm_c), sizes,
                      dp._ld_starts(sizes), total, out=buf)
    want = dp.pack_ld_plain(*small, q_rand, sizes)
    torch.cuda.synchronize()
    check(bool(torch.equal(buf[:4 + total], want))
          and bool((buf[4 + total:] == 0xA5).all()),
          "ld_pack into a larger buffer differs or stored past its payload")
    print(f"  ld_pack bounded by its payload: {guard} guard bytes untouched")
    print(f"ld_pack kernel == plain: {len(cases) + 2} cases, bytes, flags "
          "and quantised lanes equal")
    return 0, len(cases) + 2, kept


def count_syncs(torch, fn) -> int:
    """The synchronising CUDA calls that ``fn`` makes (PyTorch's sync debug
    mode warns at each)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def tiles_of(dp, n: int, ly: int, lc: int) -> str:
    per = dp.THREADS // dp.group_size(ly, lc)
    return (f"{-(-n // per)} tiles of {per} slices, the last "
            f"{n - per * (-(-n // per) - 1)}")


def check_pack(torch, np, rng, dev, enc, tlanes, qlanes, q_1080p, transform):
    """The pack kernel against its plain version: fused (transform lanes
    quantised in the kernel) and from quantised lanes; its stores bounded
    by the buffer; quant on the card against quant on the CPU. Returns
    (max |err|, number of cases)."""
    from vc2tpu_torch.quant.quantiser import quant
    from vc2tpu_torch.slices import layout
    from vc2tpu_torch.vlc import device_pack as dp

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    def lanes_of(n, span, zero_frac, lengths=(32, 16, 16)):
        out = []
        for length, s in zip(lengths, (span, span >> 2, span >> 2)):
            v = rng.integers(-s, s + 1, (n, length))
            v[rng.random((n, length)) < zero_frac] = 0
            out.append(t(v.astype(np.int32)))
        return out

    def same(name, got, want, got_flags, want_flags, expected):
        check(got_flags == want_flags == expected,
              f"{name}: flags {got_flags}, plain {want_flags}, expected "
              f"{expected}")
        check(got.shape == want.shape and bool(torch.equal(got, want)),
              f"{name}: buffers differ ({got.numel()} and {want.numel()} "
              "bytes)")

    n_cases = 0
    # fused: transform lanes in, quantised in the kernel
    full = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    n = 1200                                 # every q 0-119, 10 slices each
    wild = [rng.integers(full[0], full[1], (n, length), dtype=np.int64,
                         endpoint=True).astype(np.int32)
            for length in (32, 16, 16)]
    wild[0][::3, 0] = full[0]
    wild[0][1::3, 1] = full[1]
    wild[1][::5, 2] = -(1 << 30)
    wild[2][::7, 3] = (1 << 30) - 1
    wild[2][rng.random(wild[2].shape) < 0.3] = 0
    qm_wild = (t(rng.integers(0, 12, 32).astype(np.int32)),
               t(rng.integers(0, 12, 16).astype(np.int32)))
    q_wild = t((np.arange(n) % 120).astype(np.int32))
    qm_1080p = enc.qm
    mid = lanes_of(50, 1 << 12, 0.4, (256, 128, 128))
    mid_qm = (t(rng.integers(0, 8, 256).astype(np.int32)),
              t(rng.integers(0, 8, 128).astype(np.int32)))
    fused = [  # name, lanes, q, qm, prefix, scalar, CBR budgets
        ("1080p ConstQ transform lanes", tlanes, q_1080p, qm_1080p, 0, 1,
         None),
        ("q 0-119, |v| up to 2^31, INT_MIN", [t(w) for w in wild], q_wild,
         qm_wild, 0, 64, None),
        ("ragged: 321 slices", [x[:321].contiguous() for x in tlanes],
         q_1080p[:321].contiguous(), qm_1080p, 2, 3, None),
        ("ragged: 3 slices", [x[:3].contiguous() for x in tlanes],
         q_1080p[:3].contiguous(), qm_1080p, 0, 1, None),
        ("groups of 16 threads, 50 slices", mid,
         t(rng.integers(0, 60, 50).astype(np.int32)), mid_qm, 1, 4, None),
    ]
    for name, lanes, q, qm, prefix, scalar, sizes in fused:
        got, got_flags, kept = dp.quant_pack_hq(*lanes, q, *qm, prefix,
                                                scalar, sizes,
                                                keep_lanes=True)
        want, plain_flags, want_kept = dp.quant_pack_hq_plain(
            *lanes, q, *qm, prefix, scalar, sizes, keep_lanes=True)
        torch.cuda.synchronize()
        same(f"quant_pack_hq {name}", got, want, got_flags, plain_flags, 0)
        check(all(bool(torch.equal(a, b)) for a, b in zip(kept, want_kept)),
              f"quant_pack_hq {name}: quantised lanes differ")
        n_cases += 1
        ly, lc = lanes[0].shape[1], lanes[1].shape[1]
        print(f"  pack (fused) {name}: {got.numel()} bytes and the "
              f"quantised lanes equal; {tiles_of(dp, q.numel(), ly, lc)}")

    # quantised lanes in
    n = 64800
    rand = lanes_of(n, 1 << 20, 0.5)
    rand[0][::97, 5] = (1 << 30) + 12345           # codes of 62 bits
    rand[0][::101, 7] = -(1 << 30) - 1
    rand[1][::89, 3] = -(1 << 31)                  # |INT_MIN|: 64 bits
    q_rand = t(rng.integers(0, 120, n).astype(np.int32))
    small = lanes_of(n, 40, 0.6)
    tiny = lanes_of(n, 8, 0.7)
    zeros = [torch.zeros_like(x) for x in rand]
    m = 64
    big = [t(rng.integers(-(1 << 24), 1 << 24, (m, length)).astype(np.int32))
           for length in (2048, 1024, 1024)]
    q_m = t(np.zeros(m, np.int32))
    budgets = layout.slice_bytes_map(270, 240, 270 * 240 * 40, 2).ravel()
    wide = layout.slice_bytes_map(270, 240, 270 * 240 * 400, 1).ravel()
    tight = layout.slice_bytes_map(270, 240, 270 * 240 * 8, 1).ravel()
    cases = [  # name, lanes, q, prefix, scalar, CBR budgets, expected flags
        ("1080p ConstQ lanes", qlanes, q_1080p, 0, 1, None, 0),
        ("random, codes over 32 bits", rand, q_rand, 0, 8, None, 0),
        ("all-zero slices", zeros, q_rand, 0, 1, None, 0),
        ("prefix 3 scalar 2", small, q_rand, 3, 2, None, 0),
        ("CBR fill", tiny, q_rand, 1, 2, t(budgets), 0),
        ("slices over the window, lanes read twice", big, q_m, 1, 256, None,
         0),
        ("flag SCALAR", big, q_m, 0, 8, None, dp.FLAG_SCALAR),
        ("flag QINDEX", small, q_rand + 200, 0, 1, None, dp.FLAG_QINDEX),
        ("flag CBR_FIT", rand, q_rand, 0, 1, t(tight), dp.FLAG_CBR_FIT),
        ("flag VLEN", small, q_rand, 0, 1, t(wide), dp.FLAG_VLEN),
    ]
    for name, lanes, q, prefix, scalar, sizes, want_flags in cases:
        got, got_flags = dp.pack_hq(*lanes, q, prefix, scalar, sizes)
        want, plain_flags = dp.pack_hq_plain(*lanes, q, prefix, scalar,
                                             sizes)
        torch.cuda.synchronize()
        same(f"pack_hq {name}", got, want, got_flags, plain_flags,
             want_flags)
        n_cases += 1
        tiles = tiles_of(dp, q.numel(), lanes[0].shape[1], lanes[1].shape[1])
        print(f"  pack {name}: {got.numel()} bytes equal, flags "
              f"{got_flags}; {tiles}")

    # stores bounded by the buffer: guard bytes after it stay untouched
    guard = 4096
    n = 256                 # three flagged tiles push the fourth past it
    bounded = lanes_of(n, 40, 0.5, (64, 32, 32))
    for x in bounded:
        x[:192] = -(1 << 31)
    q = t(np.full(n, 30, np.int32))
    cap = dp.payload_capacity(n, 64, 32, 0, 1, False)
    buf = torch.full((4 * n + cap + guard,), 0xA5, dtype=torch.uint8,
                     device=dev)
    _out, scratch = dp.launch_pack(bounded, q, 0, 1, out=buf[:4 * n + cap])
    flags, total = scratch[1:3].tolist()
    check(flags == dp.FLAG_SCALAR and total > cap,
          f"guard case: flags {flags}, payload {total} of {cap} bytes")
    check(bool((buf[4 * n + cap:] == 0xA5).all()),
          "a flagged pack stored past its buffer")
    # an unflagged pack into a buffer too short: its first bytes, no more
    want, _f = dp.pack_hq_plain(*qlanes, q_1080p, 0, 1)
    cut = want.numel() - 1000
    buf = torch.full((cut + guard,), 0xA5, dtype=torch.uint8, device=dev)
    dp.launch_pack(qlanes, q_1080p, 0, 1, out=buf[:cut])
    torch.cuda.synchronize()
    check(bool(torch.equal(buf[:cut], want[:cut]))
          and bool((buf[cut:] == 0xA5).all()),
          "a pack into a short buffer differs or stored past it")
    n_cases += 2
    print(f"  pack bounded by its buffer: a flagged call ({total} bytes "
          f"into {cap}) and a short buffer, {guard} guard bytes untouched")
    print(f"pack kernel == plain: {n_cases} cases, bytes, totals, flags "
          "and quantised lanes equal")
    # quant at every adjusted index, 1080p transform samples
    for plane in transform:
        v = plane.reshape(-1)[:1 << 20]
        q = t(rng.integers(0, 120, v.numel()).astype(np.int32))
        got = quant(v, q)
        want = quant(v.cpu(), q.cpu())
        check(torch.equal(got.cpu(), want), "quant on the card differs from "
                                            "the CPU")
    print("quant on the card == quant on the CPU: the 1080p transform's "
          "three planes, q 0-119")
    return 0, n_cases


def check_halo_lift(torch, np, rng, dev) -> tuple:
    """The in-place halo lift (``shard.halo``) over row bands of one card
    against the unsharded lift, both ways: every wavelet at depth 2
    (Fidelity also at 3) over 2 and 4 bands and over 4 of the thinnest
    bands the JAX package takes (Fidelity's reach two bands away);
    ``depth`` launches each way. Then one ``lift_levels`` call of more
    planes than a launch takes (two launches) against the plain version,
    and the band form (``check_band_form``). Returns (cases, max abs
    error, ``check_band_form``'s result)."""
    from vc2tpu_torch.core.config import WaveletKernel
    from vc2tpu_torch.shard import halo
    from vc2tpu_torch.shard.mesh import make_mesh
    from vc2tpu_torch.wavelet import lifting

    cases, err = 0, 0
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for depth in (2, 3) if kernel == WaveletKernel.Fidelity else (2,):
            thin = (1 << depth) * max(1, halo.halo_width(kernel))
            for rows, cols, space in ((1088, 1920, 2), (1088, 960, 4),
                                      (4 * thin, 48, 4)):
                x = torch.from_numpy(rng.integers(
                    -(1 << 20), (1 << 20) + 1, (rows, cols)).astype(
                    np.int32)).to(dev)
                mesh = make_mesh(1, space, devices=[dev] * space)
                fwd = lifting.forward_plane(x, kernel, depth)
                for fn, src, ref in (
                        (halo.sharded_forward_plane, x, fwd),
                        (halo.sharded_inverse_plane, fwd,
                         lifting.inverse_plane(fwd, kernel, depth))):
                    n0 = lifting.lift_levels.launches
                    got = fn(src, mesh, kernel, depth)
                    check(dev.type != "cuda"
                          or lifting.lift_levels.launches - n0 == depth,
                          f"halo lift {kernel.name} d{depth}: "
                          f"{lifting.lift_levels.launches - n0} launches")
                    err = max(err, max_err(torch, got, ref))
                    check(torch.equal(got, ref),
                          f"halo lift {kernel.name} d{depth} {rows}x{cols} "
                          f"over {space} bands differs from the unsharded")
                    cases += 1
    check(halo.margin(WaveletKernel.Fidelity, 2) > 16,
          "the thin Fidelity case does not reach two bands away")
    planes = [torch.from_numpy(rng.integers(-512, 512, (64, 64 + 8 * i))
                               .astype(np.int32)).to(dev) for i in range(50)]
    n0 = lifting.lift_levels.launches
    got = lifting.lift_levels(planes, WaveletKernel.DD137)
    check(dev.type != "cuda" or lifting.lift_levels.launches - n0 == 2,
          "lift_levels of 50 planes is not two launches")
    for g, w in zip(got, lifting.lift_levels_plain(planes,
                                                   WaveletKernel.DD137)):
        check(torch.equal(g, w), "lift_levels of 50 planes differs from "
                                 "its plain version")
    return cases, err, check_band_form(torch, np, rng, dev)


def check_band_form(torch, np, rng, dev) -> tuple:
    """The band form (``halo.forward_bands_local``, ``inverse_bands_local``)
    over row bands of one card against the single-device band route
    (``bands.forward_lanes`` / ``inverse_lanes``) of the whole picture and
    against the plain versions, both ways (the inverse also with LD
    grids): every wavelet at depth 2 (Fidelity also at 3) over 2 bands of
    a 1088 x 1920 4:2:2 slice grid (the 1080p fixtures' 8 x 8 slices at
    depth 2), 4 bands of a 1088 x 1920 4:2:0 one
    and 4 of the thinnest 4:2:2 bands the JAX package takes (Fidelity's
    margin reaching bands away); int16 samples 3 rows and columns short
    of the grid; ``depth`` launches of each kernel a band. Returns (cases,
    max abs error of the forward and of the inverse against the plain
    versions)."""
    from vc2tpu_torch.core.config import WaveletKernel
    from vc2tpu_torch.shard import halo
    from vc2tpu_torch.wavelet import bands, matrices

    cases, err = 0, [0, 0]
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for depth in (2, 3) if kernel == WaveletKernel.Fidelity else (2,):
            ts, thin = 1 << depth, max(1, halo.halo_width(kernel))
            wide = (slice_grid(136, 240, (8, 8), (8, 4)) if depth == 2
                    else slice_grid(136, 120, (8, 16), (8, 8)))
            grids = ((wide, 2),
                     (slice_grid(68, 120, (16, 16), (8, 8)), 4),
                     (slice_grid(4 * thin, 6, (ts, 2 * ts), (ts, ts)), 4))
            for geo, n in grids:
                comps = (geo.luma_slice, geo.chroma_slice, geo.chroma_slice)
                pads = (geo.padded_luma, geo.padded_chroma,
                        geo.padded_chroma)
                planes = [torch.from_numpy(rng.integers(
                    -512, 512, (h - 3, w - 3)).astype(np.int16)).to(dev)
                    for h, w in pads]
                lanes = [torch.from_numpy(rng.integers(
                    -2000, 2000, (geo.n_slices, h * w)).astype(np.int32)
                    ).to(dev) for h, w in comps]
                q = torch.from_numpy(rng.integers(0, 60, geo.n_slices)
                                     .astype(np.int32)).to(dev)
                lls = [torch.from_numpy(rng.integers(
                    -1 << 14, 1 << 14, (h >> depth, w >> depth)).astype(
                    np.int32)).to(dev) for h, w in pads]
                qm = matrices.quant_matrix(kernel, depth)
                f0 = bands.forward_lanes.launches
                i0 = bands.inverse_lanes.launches
                got_f, got_i, got_ld = [[], [], []], [[], [], []], \
                    [[], [], []]
                xs, sh = geo.x_slices, [c[0] for c in comps]
                for s, (a, _r0, _r1, b) in enumerate(
                        halo.band_blocks(geo, n, kernel, depth)):
                    blk = [p[a * h:b * h] for p, h in zip(planes, sh)]
                    for c, t in enumerate(halo.forward_bands_local(
                            blk, kernel, depth, geo, s, n)):
                        got_f[c].append(t)
                    sl = slice(a * xs, b * xs)
                    for got, ll in ((got_i, None), (got_ld, [
                            g[a * h >> depth:b * h >> depth]
                            for g, h in zip(lls, sh)])):
                        for c, t in enumerate(halo.inverse_bands_local(
                                [x[sl] for x in lanes], q[sl], qm, kernel,
                                depth, geo, s, n, ll)):
                            got[c].append(t)
                label = (f"band form {kernel.name} d{depth} over {n} bands "
                         f"of {geo.y_slices} x {geo.x_slices} slices")
                check(dev.type != "cuda"
                      or (bands.forward_lanes.launches - f0 == depth * n
                          and bands.inverse_lanes.launches - i0
                          == 2 * depth * n), f"{label}: launches")
                for way, got, route, plain in (
                        (0, got_f, bands.forward_lanes(planes, kernel, depth,
                                                    geo),
                         bands.forward_lanes_plain(planes, kernel, depth,
                                                   geo)),
                        (1, got_i, bands.inverse_lanes(lanes, q, qm, geo,
                                                    kernel, depth),
                         bands.inverse_lanes_plain(lanes, q, qm, geo, kernel,
                                                   depth)),
                        (1, got_ld, bands.inverse_lanes(lanes, q, qm, geo,
                                                     kernel, depth, lls),
                         bands.inverse_lanes_plain(lanes, q, qm, geo, kernel,
                                                   depth, lls))):
                    for g, r, p in zip(got, route, plain):
                        g = torch.cat(g)
                        err[way] = max(err[way], max_err(torch, g, p))
                        check(torch.equal(g, r) and torch.equal(g, p),
                              f"{label} differs from the single-device band "
                              "route or its plain version")
                cases += 1
    return cases, err[0], err[1]


def sharded_phase(torch, np, dev, streams, fixtures, src_1080p, frag_stream,
                  work, zero_counts, counts, card) -> dict:
    """The multi-device paths on the one card, every mesh ``[dev] * n``
    (bands share the card and its stream): the 1080p fixtures through the
    encode CLI over such a mesh and ``Decoder(mesh=)``, the 8K config #5
    encode and decode against one device, the two-process harness and the
    dry run. Returns the launch counts of each sharded path."""
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.pipeline.sharded import ShardedEncoder
    from vc2tpu_torch.shard import dryrun, multihost
    from vc2tpu_torch.shard.mesh import make_mesh

    paths = {}

    def mesh(data, space):
        return make_mesh(data, space, devices=[dev] * (data * space))

    def decode(stream, key, path, want, **kw):
        zero_counts()
        sink = io.BytesIO()
        check(Decoder(sink=sink, **kw).run(stream) == 0, f"{path} failed")
        paths[path] = counts()
        digest = hashlib.sha256(sink.getvalue()).hexdigest()
        check(digest == fixtures[key]["decoded_sha256"],
              f"{path}: SHA-256 {digest} differs from the recorded one")
        check_counts(path, want)

    def check_counts(path, want):
        for k, n in want.items():
            check(paths[path][k] == n, f"{path}: {k} launched "
                                       f"{paths[path][k]} times, expected {n}")

    # the 1080p fixtures: 135 slice rows over 3 bands
    out = os.path.join(work, "mesh.vc2")
    # the HQ paths take the band form: band_forward or band_inverse depth
    # launches a band, no lift_level
    for key, want in (("constq_1080p", {"lift_level": 0, "band_forward": 6,
                                        "hq_pack": 3, "hq_cbr": 0}),
                      ("cbr_1080p", {"lift_level": 0, "band_forward": 6,
                                     "hq_pack": 3, "hq_cbr": 3})):
        zero_counts()
        stream = run_encode_cli(fixture_encode_args(key), src_1080p, out,
                                mesh(1, 3))
        path = f"mesh_encode_{key}"
        paths[path] = counts()
        check(stream == streams[key], f"{path} differs from {key}.vc2")
        check_counts(path, want)
        decode(stream, key, f"mesh_decode_{key}",
               {"hq_unpack": 3, "band_inverse": 6, "lift_level": 0},
               mesh=mesh(1, 3))
    zero_counts()
    fs = run_encode_cli(fixture_encode_args("cbr_1080p")
                        + ["-F", str(FRAGMENT)], src_1080p, out, mesh(1, 3))
    paths["mesh_encode_fragments"] = counts()
    check(fs == frag_stream, "the -F mesh encode differs from one device's")
    check_counts("mesh_encode_fragments",
                 {"lift_level": 0, "band_forward": 6, "hq_cbr": 3,
                  "hq_pack": 3})
    decode(fs, "cbr_1080p", "mesh_decode_fragments",
           {"hq_unpack": 3, "band_inverse": 6, "lift_level": 0},
           mesh=mesh(1, 3))
    # LD: the analysis over 2 bands (1080 rows, the in-place halo lift);
    # the decode, the unpack and LL grids on the first device, then over 3
    # bands (the band form), and over 2, where the 135 slice rows do not
    # divide: the in-place halo inverse over the 2 bands
    zero_counts()
    ld = run_encode_cli(fixture_encode_args("ld_1080p"), src_1080p, out,
                        mesh(1, 2))
    paths["mesh_encode_ld"] = counts()
    check(ld == streams["ld_1080p"], "the LD mesh encode differs from "
                                     "ld_1080p.vc2")
    check_counts("mesh_encode_ld", {"lift_level": 2, "band_forward": 0,
                                    "ld_rate": 1, "ld_pack": 1})
    decode(ld, "ld_1080p", "mesh_decode_ld",
           {"ld_unpack": 1, "ld_dc": 1, "band_inverse": 6, "lift_level": 0},
           mesh=mesh(1, 3))
    decode(ld, "ld_1080p", "mesh_decode_ld_1x2",
           {"ld_unpack": 1, "ld_dc": 1, "band_inverse": 0, "lift_level": 2},
           mesh=mesh(1, 2))
    print("mesh 1080p: ConstQ and CBR encoded over 1x3 (and -F "
          f"{FRAGMENT}), LD over 1x2, bytes equal to the fixtures; decoded "
          "over 1x3 (LD also 1x2) to the recorded SHA-256; launches "
          + json.dumps({k: v for k, v in paths.items()}))

    # BASELINE config #5: 8K HQ CBR, 1080 x 960 slices
    cfg8 = multihost.harness_config("8k")
    pics = multihost.harness_frames(cfg8, 2, seed=1)
    enc8 = Encoder(cfg8, device=dev)
    want8 = [enc8.encode_picture(p) for p in pics]
    for data, space in ((1, 4), (2, 4)):
        senc = ShardedEncoder(cfg8, mesh(data, space))
        zero_counts()
        got = senc.encode_batch(pics[:data])
        path = f"mesh_encode_8k_{data}x{space}"
        paths[path] = counts()
        check_counts(path, {"lift_level": 0,
                            "band_forward": 2 * data * space,
                            "hq_cbr": data * space, "hq_pack": data * space})
        for g, w in zip(got, want8):
            check(np.array_equal(g.q_indices, w.q_indices)
                  and np.array_equal(g.slice_totals, w.slice_totals)
                  and g.payload == w.payload,
                  f"{path} differs from the single-device encode")
        check(multihost.harness_stream(cfg8, got)
              == multihost.harness_stream(cfg8, want8[:data]),
              f"{path}: the stream differs")
        for line in dryrun.balance_lines(f"8K {data}x{space}", senc):
            print(line)
    stream8 = multihost.harness_stream(cfg8, want8[:1])
    ref8 = io.BytesIO()
    check(Decoder(sink=ref8, device=dev).run(stream8) == 0, "8K decode")
    zero_counts()
    got8 = io.BytesIO()
    mesh8 = mesh(1, 4)
    dec8 = Decoder(sink=got8, mesh=mesh8)
    check(dec8.run(stream8) == 0, "8K mesh decode")
    paths["mesh_decode_8k_1x4"] = counts()
    check(got8.getvalue() == ref8.getvalue(),
          "the 8K mesh decode differs from the single-device decode")
    check_counts("mesh_decode_8k_1x4", {"hq_unpack": 4, "band_inverse": 8,
                                        "lift_level": 0})
    senc8 = ShardedEncoder(cfg8, mesh8)
    senc8.encode_batch(pics[:1])
    for line in dryrun.balance_lines("8K 1x4", senc8,
                                     dec8.sharded_decoders()[0]):
        print(line)

    def timed(label, fn):
        ts = host_samples(fn, 3)
        print(f"8K CBR {label}: median {statistics.median(ts):.3f} ms a "
              f"picture, min {min(ts):.3f}, max {max(ts):.3f} (3 runs after "
              f"a warm-up; pictures in host memory; {card})")

    def sync(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    timed("encode, one card, 4 shards on one device (ShardedEncoder 1x4)",
          sync(lambda: senc8.encode_batch(pics[:1])))
    timed("encode, one card, one device (Encoder)",
          sync(lambda: enc8.encode_picture(pics[0])))
    timed("decode, one card, 4 shards on one device (Decoder(mesh=1x4))",
          sync(lambda: Decoder(sink=io.BytesIO(), mesh=mesh8).run(stream8)))
    timed("decode, one card, one device (Decoder)",
          sync(lambda: Decoder(sink=io.BytesIO(), device=dev).run(stream8)))
    print("8K: these are times on one card; no scaling is claimed")

    # the band form against the mesh's in-place route over the same
    # meshes, in turns, each first checked to the same bytes
    from vc2tpu_torch.cli import encode_stream
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat

    InplaceSharded, InplaceMeshDecoder = inplace_mesh_route()
    mesh13 = mesh(1, 3)
    pairs = {}
    for key in ("constq_1080p", "cbr_1080p"):
        sink = io.BytesIO()
        check(InplaceMeshDecoder(sink=sink, mesh=mesh13).run(streams[key])
              == 0 and hashlib.sha256(sink.getvalue()).hexdigest()
              == fixtures[key]["decoded_sha256"],
              f"the in-place 1x3 decode of {key} differs")
        pairs[f"mesh 1x3 decode {key}"] = tuple(
            sync(lambda cls=cls, st=streams[key]: cls(
                sink=io.BytesIO(), mesh=mesh13).run(st))
            for cls in (Decoder, InplaceMeshDecoder))
    cfg_q = encode_stream.config_from_args(encode_stream.build_parser()
                                           .parse_args(fixture_encode_args(
                                               "constq_1080p")
                                               + [src_1080p, out]))
    with open(src_1080p, "rb") as f:
        pic_q = PlanarReader(f, cfg_q.geometry, SampleFormat(
            word_width=2, bit_depth=cfg_q.luma_depth)).read_frame()
    encoders = (ShardedEncoder(cfg_q, mesh13), InplaceSharded(cfg_q, mesh13))
    got_b, got_i = (e.encode_batch([pic_q])[0] for e in encoders)
    check(got_b.payload == got_i.payload
          and np.array_equal(got_b.q_indices, got_i.q_indices),
          "the in-place 1x3 ConstQ encode differs from the band form's")
    pairs["mesh 1x3 encode constq_1080p"] = tuple(
        sync(lambda e=e: e.encode_batch([pic_q])) for e in encoders)
    report_routes_in_turns(pairs, card)
    inplace8 = InplaceSharded(cfg8, mesh8)
    check(inplace8.encode_batch(pics[:1])[0].payload == want8[0].payload,
          "the in-place 1x4 8K encode differs from one device's")
    sink = io.BytesIO()
    check(InplaceMeshDecoder(sink=sink, mesh=mesh8).run(stream8) == 0
          and sink.getvalue() == ref8.getvalue(),
          "the in-place 1x4 8K decode differs from one device's")
    report_routes_in_turns({
        "mesh 1x4 encode 8K CBR": (
            sync(lambda: senc8.encode_batch(pics[:1])),
            sync(lambda: inplace8.encode_batch(pics[:1]))),
        "mesh 1x4 decode 8K CBR": tuple(
            sync(lambda cls=cls: cls(sink=io.BytesIO(), mesh=mesh8).run(
                stream8)) for cls in (Decoder, InplaceMeshDecoder))},
        card, reps=5)
    print("mesh routes: the band form (the entry points') and the in-place "
          "route (inplace_mesh_route) in turns over the same meshes of one "
          "card; no gain is claimed")

    # two processes sharing the card, gloo on 127.0.0.1, 2x1 globally
    t0 = time.perf_counter()
    mh = os.path.join(work, "mh.vc2")
    multihost.launch(mh, world=2, device=str(dev), space=1, size="1080p",
                     fragment_length=FRAGMENT, timeout=300)
    cfg = multihost.harness_config("1080p")
    enc = Encoder(cfg, device=dev)
    encoded = [enc.encode_picture(p)
               for p in multihost.harness_frames(cfg, 2)]
    frag = multihost.harness_stream(cfg, encoded, FRAGMENT)
    with open(mh, "rb") as f:
        check(f.read() == multihost.harness_stream(cfg, encoded),
              "the two-process stream differs from one device's")
    with open(mh + ".frag", "rb") as f:
        check(f.read() == frag, "the two-process fragments differ")
    sink = io.BytesIO()
    check(Decoder(sink=sink, device=dev).run(frag) == 0, "decode")
    with open(mh + ".dec", "rb") as f:
        check(f.read() == sink.getvalue(),
              "the two-process decode differs from one device's")
    print(f"two processes on one card (gloo, 2x1 mesh, 1080p CBR): stream, "
          f"-F {FRAGMENT} stream and decode equal one device's "
          f"({time.perf_counter() - t0:.1f} s)")
    dryrun.dryrun_multichip([dev] * 4, fast=True)
    return paths


def plain_encode(argv, src: str, out: str) -> bytes:
    """The plain per-picture loop over ``src`` (the encode CLI's HQ Stream
    output without its pipeline): read a picture, ``encode_picture``,
    write its data unit to ``out``; returns the stream."""
    from vc2tpu_torch.cli import encode_stream
    from vc2tpu_torch.core.config import Profile
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.stream.dataunit import PicturePreamble, StreamWriter
    from vc2tpu_torch.stream.headers import SequenceHeader

    cfg = encode_stream.config_from_args(
        encode_stream.build_parser().parse_args(argv + [src, out]))
    enc = Encoder(cfg)
    geo, g = enc.geo, cfg.geometry
    fmt = SampleFormat(word_width=cfg.bytes_per_sample,
                       bit_depth=cfg.luma_depth)
    pre = PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=geo.x_slices, slices_y=geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)
    with open(src, "rb") as f, open(out, "wb") as o:
        w = StreamWriter(o)
        w.fragment_length = cfg.fragment_length
        w.start_sequence()
        w.write_sequence_header(SequenceHeader(
            profile=Profile.PROFILE_HQ, height=g.luma_height,
            width=g.luma_width, chroma_format=cfg.chroma_format,
            interlace=cfg.interlaced, frame_rate=cfg.frame_rate,
            top_field_first=cfg.top_field_first, bitdepth=cfg.luma_depth))
        reader = PlanarReader(f, g, fmt)
        k = 0
        while (pic := reader.read_frame()) is not None:
            e = enc.encode_picture(pic)
            w.write_picture(k, pre, e.payload, slice_sizes=e.slice_totals)
            k += 1
        w.end_sequence()
    with open(out, "rb") as f:
        return f.read()


def pipeline_phase(torch, work, zero_counts, counts, card) -> dict:
    """The encode CLI's one-picture pipeline over ``SEQ_PICTURES`` distinct
    seeded 1080p pictures (``make_1080p.make_sequence``) in ConstQ, CBR
    and CBR with fragments: the stream equals the plain per-picture loop's
    (``plain_encode``), with band_forward 2, hq_pack 1 (and hq_cbr 1)
    launches a picture; ``Encoder.encode_picture_async`` dispatches with no
    synchronisation; ms a picture of the pipelined CLI in turns with the
    plain loop (and the file's read alone). Returns the launch counts of
    each run."""
    import make_1080p
    from vc2tpu_torch.cli import encode_stream
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat

    src = os.path.join(work, "sequence.16p2")
    make_1080p.make_sequence(src, SEQ_PICTURES)
    out = os.path.join(work, "sequence.vc2")
    paths = {}
    runs = {"constq": fixture_encode_args("constq_1080p"),
            "cbr": fixture_encode_args("cbr_1080p"),
            "cbr_fragments": fixture_encode_args("cbr_1080p")
            + ["-F", str(FRAGMENT)]}
    for mode, argv in runs.items():
        want = plain_encode(argv, src, out)
        zero_counts()
        got = run_encode_cli(argv, src, out)
        path = f"encode_pipeline_{mode}"
        paths[path] = counts()
        check(got == want, f"{path}: the pipelined stream differs from the "
                           "per-picture encode_picture stream")
        for k, n in (("band_forward", 2), ("lift_level", 0), ("hq_pack", 1),
                     ("hq_cbr", 0 if mode == "constq" else 1)):
            check(paths[path][k] == n * SEQ_PICTURES,
                  f"{path}: {k} launched {paths[path][k]} times, expected "
                  f"{n * SEQ_PICTURES}")
    print(f"encode pipeline: {SEQ_PICTURES} distinct 1080p pictures in "
          f"ConstQ, CBR and CBR -F {FRAGMENT}, streams equal to the "
          f"per-picture loop's; launches {json.dumps(paths)}")

    # the dispatch alone, in the steady state (both staging slots made)
    from vc2tpu_torch.pipeline.encoder import Encoder

    args = encode_stream.build_parser().parse_args(runs["cbr"] + [src, out])
    cfg = encode_stream.config_from_args(args)
    with open(src, "rb") as f:
        reader = PlanarReader(f, cfg.geometry, SampleFormat(
            word_width=2, bit_depth=cfg.luma_depth))
        pics = [reader.read_frame() for _ in range(2)]
    enc = Encoder(cfg)
    want = [enc.encode_picture(p).payload for p in pics]
    handles = []
    syncs = count_syncs(torch, lambda: handles.append(
        enc.encode_picture_async(pics[1])))
    handles.append(enc.encode_picture_async(pics[0]))
    check(syncs == 0, f"encode_picture_async synchronised {syncs} times")
    check([h().payload for h in handles] == [want[1], want[0]],
          "the async handles differ from encode_picture")
    print(f"encode pipeline: encode_picture_async's dispatch synchronised "
          f"{syncs} times (PyTorch's sync debug mode)")

    def read_alone():
        with open(src, "rb") as f:
            reader = PlanarReader(f, cfg.geometry, SampleFormat(
                word_width=2, bit_depth=cfg.luma_depth))
            while reader.read_frame() is not None:
                pass

    # the fragments' time is their writer's Python loop on both sides
    # (PERF.md §6); vc2tpu_torch/testdata/encode_turns.py times them
    for mode in ("constq", "cbr"):
        argv = runs[mode]
        turns = {f"encode pipeline {mode}: plain per-picture loop":
                 lambda a=argv: plain_encode(a, src, out),
                 f"encode pipeline {mode}: pipelined CLI":
                 lambda a=argv: run_encode_cli(a, src, out)}
        if mode == "constq":
            turns["encode pipeline: the read alone (PlanarReader over the "
                  "file)"] = read_alone
        report_rates_in_turns(turns, card, pictures=SEQ_PICTURES,
                              reps=PIPE_REPS)
    return paths


def split_row_phase(torch, np, dev, work, card) -> None:
    """Two gloo processes sharing the card hold one row of the mesh
    (``SPLIT_ROWS``): 1x2 (a band each) over the 1080p harness, 1x4 (two
    bands each) over the 8K config #5 picture with the halo check; the
    stream, the fragments and the decode equal one device's, and the 1x4
    run's halo lift over the split row equals the unsharded lift (every
    wavelet, depths 1-3)."""
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.core.config import WaveletKernel
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.shard import multihost
    from vc2tpu_torch.wavelet import lifting

    for size, space in SPLIT_ROWS:
        t0 = time.perf_counter()
        mh = os.path.join(work, f"row_{size}_{space}.vc2")
        multihost.launch(mh, world=2, device=str(dev), space=space, data=1,
                         size=size, fragment_length=FRAGMENT, timeout=300,
                         check_halo=space == 4)
        secs = time.perf_counter() - t0
        cfg = multihost.harness_config(size)
        encoded = [Encoder(cfg, device=dev).encode_picture(
            multihost.harness_frames(cfg, 1)[0])]
        frag = multihost.harness_stream(cfg, encoded, FRAGMENT)
        with open(mh, "rb") as f:
            check(f.read() == multihost.harness_stream(cfg, encoded),
                  f"the {size} split-row stream differs from one device's")
        with open(mh + ".frag", "rb") as f:
            check(f.read() == frag, f"the {size} split-row fragments differ")
        sink = io.BytesIO()
        check(Decoder(sink=sink, device=dev).run(frag) == 0, "decode")
        with open(mh + ".dec", "rb") as f:
            check(f.read() == sink.getvalue(),
                  f"the {size} split-row decode differs from one device's")
        print(f"split row: two processes on one card (gloo), a 1x{space} "
              f"mesh of {space // 2} band(s) each, {size} CBR: stream, -F "
              f"{FRAGMENT} stream and decode equal one device's "
              f"({secs:.1f} s, {card})")
    bands = {}
    for rank in (0, 1):
        with np.load(f"{mh}.halo{rank}.npz") as z:
            bands.update({k: z[k] for k in z.files})
    cases = 0
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for depth in (1, 2, 3):
            planes = multihost.halo_planes(kernel, depth, 4)
            fwd = lifting.forward_planes(planes, kernel, depth)
            for p, (x, f) in enumerate(zip(planes, fwd)):
                for kind, want in (("f", f), ("i", x)):
                    got = np.concatenate([
                        bands[f"{kernel.name}_{depth}_{p}_{kind}_{s}"]
                        for s in range(4)])
                    check(np.array_equal(got, want.numpy()),
                          f"split-row halo lift {kernel.name} d{depth} "
                          f"plane {p} ({kind}) differs")
                cases += 1
    print(f"split row: the halo lift over 4 bands of two processes on the "
          f"card, {cases} planes (7 wavelets x depths 1-3 x 2 heights), "
          "forward and back, equal to the unsharded lift on the CPU")


def main(argv) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from vc2tpu_torch.cli import decode_frame
    from vc2tpu_torch.cli.decode_stream import Decoder
    from vc2tpu_torch.core import build
    from vc2tpu_torch.core import device as devices
    from vc2tpu_torch.core.config import ColourFormat, PictureGeometry
    from vc2tpu_torch.core.intmath import rationalise
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.core.config import DecOutput
    from vc2tpu_torch.pipeline import encoder as enc_mod
    from vc2tpu_torch.quant import ld_dc
    from vc2tpu_torch.rdo import cbr
    from vc2tpu_torch.rdo import ld as rdo_ld
    from vc2tpu_torch.slices import hq as slices_hq
    from vc2tpu_torch.slices import layout
    from vc2tpu_torch.slices import ld as slices_ld
    from vc2tpu_torch.stream.dataunit import (PicturePreamble, StreamReader,
                                              StreamWriter)
    from vc2tpu_torch.vlc import device_pack as dp
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import bands, lifting, matrices

    sys.path.insert(0, TESTDATA)
    import make_1080p

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    libs = build.build(lifting.kernel_source(), bands.kernel_source(),
                       du.kernel_source(),
                       dp.kernel_source(), cbr.kernel_source(),
                       du.ld_kernel_source(), rdo_ld.kernel_source(),
                       dp.ld_kernel_source(), ld_dc.kernel_source(),
                       slices_hq.scan_source(), slices_ld.scan_source())
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{[os.path.basename(p) for p in libs]}")
    t_last = [t0]

    def phase_done(label: str):
        now = time.perf_counter()
        print(f"phase {label}: {now - t_last[0]:.1f} s")
        t_last[0] = now

    phase_done("1 build")

    # 2. lift kernel (and forward_planes) against its plain version
    rng = np.random.default_rng(2042)
    lift_err = check_lift(torch, np, rng, dev)
    band_inverse_err, band_forward_err, _n_band = check_bands(torch, np, rng,
                                                              dev)
    phase_done("2 lift and band kernels")

    # 3. unpack kernels against their plain versions; the native scans
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        fixtures = json.load(f)["streams"]
    streams = {}
    for key, v in fixtures.items():
        with open(os.path.join(TESTDATA, v["stream"]), "rb") as f:
            streams[key] = f.read()
    hq_streams = {k: v for k, v in streams.items() if not k.startswith("ld")}
    unpack_err, unpack_cases = check_unpack(torch, np, rng, dev, hq_streams)
    ld_err, ld_dc_err = check_ld(torch, np, rng, dev, streams["ld_1080p"])
    phase_done("3 unpack")

    # 4. pack kernel against its plain version, quant on the card
    work = tempfile.TemporaryDirectory()
    src_1080p = os.path.join(work.name, "hd.16p2")
    make_1080p.make_input(src_1080p)
    with open(src_1080p, "rb") as f:
        input_1080p = f.read()
    fmt = SampleFormat(word_width=2, bit_depth=10)
    geometry = PictureGeometry.of(1080, 1920, ColourFormat.CF422)

    def read_picture():
        return PlanarReader(io.BytesIO(input_1080p), geometry,
                            fmt).read_frame()

    picture_1080p = read_picture()
    encoder, tlanes_1080p, lanes_1080p, q_1080p, transform = (
        encode_1080p_lanes(dev, picture_1080p))
    pack_err, _n_pack = check_pack(torch, np, rng, dev, encoder, tlanes_1080p,
                                   lanes_1080p, q_1080p, transform)
    cbr_encoder, _tr, cbr_tlanes = fixture_lanes(dev, picture_1080p,
                                                 "cbr_1080p")
    cbr_err, _n_cbr, cbr_climb = check_cbr(torch, np, rng, dev, cbr_encoder,
                                           cbr_tlanes)
    # the LD rate control and pack kernels against their plain versions
    ld_encoder, ld_tlanes = ld_fixture_lanes(dev, picture_1080p)
    ld_fixture_job = ld_picture_of(streams["ld_1080p"], dev)[2]
    ld_rate_err, _n_rate, ld_rate_plain_ms, ld_rate_1080p = check_ld_rate(
        torch, np, rng, dev, ld_encoder, ld_tlanes, ld_fixture_job.ld.q)
    ld_pack_err, _n_ld_pack, ld_qlanes = check_ld_pack(
        torch, np, rng, dev, ld_encoder, ld_tlanes, ld_rate_1080p)
    phase_done("4 pack, cbr search, ld rate control and ld pack")

    # 5. the main paths; the counts are zeroed just before each and read
    # just after
    def zero_counts():
        lifting.lift_levels.launches = 0
        bands.inverse_lanes.launches = 0
        bands.forward_lanes.launches = 0
        du.unpack_hq.launches = 0
        dp.pack_hq.launches = 0
        cbr.cbr_quant_indices.launches = 0
        du.unpack_ld.launches = 0
        ld_dc.ll_grids.launches = 0
        rdo_ld.ld_rate_control.launches = 0
        dp.quant_pack_ld.launches = 0

    def counts():
        return {"lift_level": lifting.lift_levels.launches,
                "band_inverse": bands.inverse_lanes.launches,
                "band_forward": bands.forward_lanes.launches,
                "hq_unpack": du.unpack_hq.launches,
                "hq_pack": dp.pack_hq.launches,
                "hq_cbr": cbr.cbr_quant_indices.launches,
                "ld_unpack": du.unpack_ld.launches,
                "ld_dc": ld_dc.ll_grids.launches,
                "ld_rate": rdo_ld.ld_rate_control.launches,
                "ld_pack": dp.quant_pack_ld.launches}

    # each fixture's picture REPEAT times over through one Decoder(): the
    # first decodes eagerly, the second is captured in a CUDA graph and
    # replayed, the rest replay, the main path's own route
    decode_launches = dict.fromkeys(counts(), 0)
    decode_traced = dict.fromkeys(TRACED, 0)
    n_pictures = 0
    for key, data in hq_streams.items():
        launched, traced = decode_repeated(
            torch, data, fixtures[key]["decoded_sha256"], zero_counts,
            counts, key)
        n_pictures += REPEAT
        for k in decode_launches:
            decode_launches[k] += launched[k]
        for k in decode_traced:
            decode_traced[k] += traced[k]
    print(f"main path decode: {n_pictures} 1080p pictures ({REPEAT} of each "
          f"fixture, one Decoder a fixture: 1 eager, 1 captured, "
          f"{REPEAT - 1} replays), SHA-256 equal to the JAX package's "
          f"decode; launches {decode_launches}; in the device trace "
          f"{decode_traced}")
    # the device runs each fixture's chain once more than the counters
    # count: as it is, before its capture
    n_runs = n_pictures + len(hq_streams)
    check(decode_launches["band_inverse"] == 2 * n_pictures
          and decode_traced["band_level_kernel"] == 2 * n_runs,
          f"band_inverse launched {decode_launches['band_inverse']} times "
          f"({decode_traced['band_level_kernel']} in the device trace) in "
          f"the decode, expected {2 * n_pictures} ({2 * n_runs})")
    check(decode_launches["hq_unpack"] == n_pictures
          and decode_traced["hq_unpack_kernel"] == n_runs
          and decode_launches["ld_unpack"] == 0
          and decode_launches["lift_level"] == 0
          and decode_traced["ld_unpack_kernel"] == 0,
          f"the HQ decode launched {decode_launches} ({decode_traced} in "
          "the device trace)")

    # the slice's main path: the 1080p LD decode, likewise
    ld_launches, ld_traced = decode_repeated(
        torch, streams["ld_1080p"], fixtures["ld_1080p"]["decoded_sha256"],
        zero_counts, counts, "ld_1080p")
    print(f"main path LD decode: the 1080p LD picture {REPEAT} times, "
          f"SHA-256 equal to the JAX package's decode; launches "
          f"{ld_launches}; in the device trace {ld_traced}")
    for k, kernel, want in (("ld_unpack", "ld_unpack_kernel", 1),
                            ("ld_dc", "ld_dc_kernel", 1),
                            ("band_inverse", "band_level_kernel", 2),
                            ("lift_level", None, 0),
                            ("hq_unpack", "hq_unpack_kernel", 0)):
        check(ld_launches[k] == want * REPEAT and (
            kernel is None or ld_traced[kernel] == want * (REPEAT + 1)),
            f"{k} launched {ld_launches[k]} times (in the device trace "
            f"{ld_traced}) in the LD decode, expected {want * REPEAT} "
            f"({want * (REPEAT + 1)})")

    out_1080p = os.path.join(work.name, "constq_1080p.vc2")
    zero_counts()
    stream = run_encode_cli(fixture_encode_args("constq_1080p"), src_1080p,
                            out_1080p)
    encode_launches = counts()
    check(stream == streams["constq_1080p"],
          "the 1080p ConstQ encode differs from constq_1080p.vc2")
    sink = io.BytesIO()
    check(Decoder(sink=sink).run(stream) == 0, "decode of the encode failed")
    digest = hashlib.sha256(sink.getvalue()).hexdigest()
    check(digest == fixtures["constq_1080p"]["decoded_sha256"],
          f"the decode of the 1080p encode has SHA-256 {digest}")
    print(f"main path encode: the 1080p ConstQ picture, {len(stream)} bytes "
          "equal to constq_1080p.vc2, its decode at the recorded SHA-256; "
          f"launches {encode_launches}")
    check(encode_launches["band_forward"] == 2
          and encode_launches["lift_level"] == 0,
          f"band_forward launched {encode_launches['band_forward']} times "
          f"(lift_level {encode_launches['lift_level']}) in the encode, "
          "expected 2 (0)")
    check(encode_launches["hq_pack"] == 1,
          f"hq_pack launched {encode_launches['hq_pack']} times, expected 1")

    # the slice's main path: the 1080p HQ CBR encode
    out_cbr = os.path.join(work.name, "cbr_1080p.vc2")
    zero_counts()
    stream = run_encode_cli(fixture_encode_args("cbr_1080p"), src_1080p,
                            out_cbr)
    cbr_launches = counts()
    check(stream == streams["cbr_1080p"],
          "the 1080p CBR encode differs from cbr_1080p.vc2")
    print(f"main path CBR encode: the 1080p HQ CBR picture, {len(stream)} "
          f"bytes equal to cbr_1080p.vc2; launches {cbr_launches}")
    for k, want in (("band_forward", 2), ("lift_level", 0), ("hq_cbr", 1),
                    ("hq_pack", 1), ("hq_unpack", 0), ("ld_unpack", 0)):
        check(cbr_launches[k] == want, f"{k} launched {cbr_launches[k]} "
                                       f"times in the CBR encode, expected "
                                       f"{want}")
    # the same encode cut into fragments, and its decode
    frag_argv = fixture_encode_args("cbr_1080p") + ["-F", str(FRAGMENT)]
    frag_stream = run_encode_cli(frag_argv, src_1080p, out_cbr)
    n_frags = fragments_of(frag_stream)
    zero_counts()
    sink = io.BytesIO()
    check(Decoder(sink=sink).run(frag_stream) == 0,
          "decode of the fragmented encode failed")
    frag_launches = counts()
    digest = hashlib.sha256(sink.getvalue()).hexdigest()
    check(digest == fixtures["cbr_1080p"]["decoded_sha256"],
          f"the decode of the -F {FRAGMENT} encode has SHA-256 {digest}")
    check(frag_launches["band_inverse"] == 2
          and frag_launches["lift_level"] == 0
          and frag_launches["hq_unpack"] == 1,
          f"the fragmented decode launched {frag_launches}")
    print(f"main path fragments: the -F {FRAGMENT} encode, {n_frags} HQ "
          f"fragments, decodes to the recorded SHA-256; launches "
          f"{frag_launches}")

    # the slice's main path: the 1080p LD encode
    out_ld = os.path.join(work.name, "ld_1080p.vc2")
    zero_counts()
    stream = run_encode_cli(fixture_encode_args("ld_1080p"), src_1080p,
                            out_ld)
    ld_enc_launches = counts()
    check(stream == streams["ld_1080p"],
          "the 1080p LD encode differs from ld_1080p.vc2")
    print(f"main path LD encode: the 1080p LD picture, {len(stream)} bytes "
          f"equal to ld_1080p.vc2; launches {ld_enc_launches}")
    for k, want in (("band_forward", 2), ("lift_level", 0), ("ld_rate", 1),
                    ("ld_pack", 1), ("hq_pack", 0), ("hq_cbr", 0),
                    ("ld_unpack", 0)):
        check(ld_enc_launches[k] == want, f"{k} launched {ld_enc_launches[k]}"
                                          f" times in the LD encode, expected "
                                          f"{want}")
    ld_planes = enc_mod.upload_picture(picture_1080p, 2, dev)

    def ld_device_half():
        lcfg, lgeo_ = ld_encoder.cfg, ld_encoder.geo
        lanes = bands.forward_lanes(ld_planes, lcfg.kernel,
                                    lcfg.wavelet_depth, lgeo_)
        q, *ll = ld_encoder.rate_control(lanes)
        dp.ld_result(ld_encoder.pack(lanes, q, ll)[0].cpu().numpy())

    syncs = count_syncs(torch, ld_device_half)
    picture_syncs = count_syncs(
        torch, lambda: ld_encoder.encode_picture(picture_1080p))
    check(syncs == 1, f"the LD encode's device half synchronised {syncs} "
                      "times, expected 1")
    print(f"LD encode synchronisations: {syncs} from the forward lift to "
          f"the result's read (the D2H of [flags | payload]); "
          f"{picture_syncs} in encode_picture with the upload")
    phase_done("5 main paths")

    with open(os.path.join(GOLDEN, "meta.json")) as f:
        meta = json.load(f)
    cases = [c[0] for c in meta["cases"]]
    for case in cases:
        sink = io.BytesIO()
        with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
            check(Decoder(sink=sink).run(f.read()) == 0, f"golden {case}")
        with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
            check(sink.getvalue() == f.read(),
                  f"golden {case}: output differs from the reference's")
    n_ld = sum(c.startswith("ld") for c in cases)
    print(f"goldens: {len(cases) - n_ld} HQ cases and {n_ld} LD cases "
          "(cbr_fragmented and ld_fragmented among them) decode "
          "byte-identically on the card")
    taps = [DecOutput.TRANSFORM, DecOutput.QUANTISED, DecOutput.INDICES]
    tap_cases = ("constq_legall_d2", "cbr_fragmented", "ld_legall_d2",
                 "ld_fragmented")
    for case in tap_cases:
        with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
            data = f.read()
        for tap in taps:
            outs = []
            for where in (dev, "cpu"):
                sink = io.BytesIO()
                check(Decoder(output=tap, sink=sink, device=where).run(data)
                      == 0, f"{case} {tap.value} on {where}")
                outs.append(sink.getvalue())
            check(outs[0] == outs[1] and outs[0],
                  f"{case} {tap.value}: the card's output differs from the "
                  "CPU's")
    print(f"decoder taps: {', '.join(t.value for t in taps)} of "
          f"{', '.join(tap_cases)} equal on the card and the CPU")
    frame_out = os.path.join(work.name, "frame.16p2")
    check(decode_frame.main(
        ["-x", "64", "-y", "32", "-f", "4:2:2", "-l", "10", "-k", "LeGall",
         "-d", "2", "-u", "1", "-a", "2",
         os.path.join(GOLDEN, "constq_legall_d2.packaged.raw"), frame_out])
        == 0, "decode_frame of constq_legall_d2.packaged.raw failed")
    with open(frame_out, "rb") as f, open(
            os.path.join(GOLDEN, "constq_legall_d2.dec.16p2"), "rb") as g:
        check(f.read() == g.read(), "decode_frame of the Packaged golden "
                                    "differs from constq_legall_d2.dec.16p2")
    print("decode_frame: constq_legall_d2.packaged.raw decodes to "
          "constq_legall_d2.dec.16p2 on the card")
    encodes = ([(c[0], None) for c in meta["cases"]]
               + [tuple(t) for t in meta["taps"]])
    n_ld_encodes = 0
    for case, tap in encodes:
        argv, src, ref = golden_encode_args(meta, case, tap)
        before = rdo_ld.ld_rate_control.launches
        got = run_encode_cli(argv, src, os.path.join(work.name, "golden"))
        with open(ref, "rb") as f:
            check(got == f.read(), f"golden encode {case} {tap or 'Stream'}: "
                                   "output differs from the reference's")
        if case.startswith("ld"):
            check(rdo_ld.ld_rate_control.launches > before,
                  f"golden encode {case}: the LD rate control did not run")
            n_ld_encodes += 1
    print(f"goldens: {sum(t is None for _c, t in encodes)} streams (ConstQ, "
          f"CBR and LD) and {sum(t is not None for _c, t in encodes)} taps "
          f"encode byte-identically on the card ({n_ld_encodes} of them LD: "
          "the four LD goldens and the ld_legall_d2 Quantised tap)")
    phase_done("5 goldens and taps")

    # 6. times
    # the device guard every launch runs in: its host cost a launch
    guard_t = torch.zeros(1, device=dev)

    def guards():
        for _ in range(1000):
            with devices.guard(guard_t):
                pass
    print(f"device guard: {1e3 * time_host(guards) / 1000:.3f} us a launch "
          f"(host clock, median of {REPS} x 1000 entries; {card})")
    for key, data in streams.items():
        def decode_once():
            Decoder(sink=io.BytesIO()).run(data)
        report_rate(f"decode {key}", decode_once, card)
        report_busy(torch, f"decode {key}", decode_once, card)

    cfg, geo = encoder.cfg, encoder.geo
    preamble = PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=geo.x_slices, slices_y=geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)

    def encode_once():
        enc = encoder.encode_picture(read_picture())
        StreamWriter(io.BytesIO()).write_picture(0, preamble, enc.payload)

    ccfg, cgeo = cbr_encoder.cfg, cbr_encoder.geo
    cbr_preamble = PicturePreamble(
        wavelet_kernel=ccfg.kernel, depth=ccfg.wavelet_depth,
        slices_x=cgeo.x_slices, slices_y=cgeo.y_slices,
        slice_prefix=ccfg.slice_prefix, slice_size_scalar=ccfg.slice_scalar)

    def encode_cbr_once():
        enc = cbr_encoder.encode_picture(read_picture())
        StreamWriter(io.BytesIO()).write_picture(0, cbr_preamble, enc.payload)

    lcfg, lgeo = ld_encoder.cfg, ld_encoder.geo
    num, den = rationalise(ld_encoder.picture_bytes, lgeo.n_slices)
    ld_preamble = PicturePreamble(
        wavelet_kernel=lcfg.kernel, depth=lcfg.wavelet_depth,
        slices_x=lgeo.x_slices, slices_y=lgeo.y_slices,
        slice_bytes_numerator=num, slice_bytes_denominator=den)

    def encode_ld_once():
        enc = ld_encoder.encode_picture(read_picture())
        StreamWriter(io.BytesIO()).write_picture(0, ld_preamble, enc.payload,
                                                 hq=False)

    report_rates_in_turns(
        {"encode constq_1080p (read, encode, write a picture)": encode_once,
         "encode cbr_1080p (read, encode, write a picture)": encode_cbr_once,
         "encode ld_1080p (read, encode, write a picture)": encode_ld_once},
        card)
    report_busy(torch, "encode constq_1080p", encode_once, card)
    report_busy(torch, "encode cbr_1080p", encode_cbr_once, card)
    report_busy(torch, "encode ld_1080p", encode_ld_once, card)

    # the band route (the entry points') against the in-place route, end
    # to end in turns: the three 1080p fixture decodes and the ConstQ encode
    InplaceDecoder, InplaceEncoder = inplace_route()
    route_pairs = {}
    for key in ("constq_1080p", "cbr_1080p", "ld_1080p"):
        data = streams[key]
        zero_counts()
        sink = io.BytesIO()
        check(InplaceDecoder(sink=sink).run(data) == 0,
              f"in-place decode {key} failed")
        got = counts()
        check(hashlib.sha256(sink.getvalue()).hexdigest()
              == fixtures[key]["decoded_sha256"],
              f"{key}: the in-place route's decode differs")
        check(got["lift_level"] == 2 and got["band_inverse"] == 0,
              f"the in-place decode of {key} launched {got}")
        route_pairs[f"decode {key}"] = (
            lambda d=data: Decoder(sink=io.BytesIO()).run(d),
            lambda d=data: InplaceDecoder(sink=io.BytesIO()).run(d))
    inplace_encoder = InplaceEncoder(cfg)
    check(inplace_encoder.encode_picture(picture_1080p).payload
          == encoder.encode_picture(picture_1080p).payload,
          "the in-place route's ConstQ encode differs from the band route's")

    def encode_inplace_once():
        enc = inplace_encoder.encode_picture(read_picture())
        StreamWriter(io.BytesIO()).write_picture(0, preamble, enc.payload)

    route_pairs["encode constq_1080p (read, encode, write a picture)"] = (
        encode_once, encode_inplace_once)
    print("routes: the in-place route decodes the three 1080p fixtures to "
          "the recorded SHA-256 (lift_level 2, band_inverse 0 a picture) and "
          "encodes the ConstQ picture to the band route's bytes")
    report_routes_in_turns(route_pairs, card)

    def decode_fragments_once():
        Decoder(sink=io.BytesIO()).run(frag_stream)

    report_rates_in_turns(
        {"decode cbr_1080p": lambda: Decoder(sink=io.BytesIO()).run(
            streams["cbr_1080p"]),
         f"decode cbr_1080p -F {FRAGMENT} ({n_frags} fragments)":
             decode_fragments_once}, card)
    report_busy(torch, "decode cbr_1080p fragments", decode_fragments_once,
                card)

    # per-stage breakdown of one 1080p ConstQ picture, decode
    window = streams["constq_1080p"]
    dec, offset, job = pictures_of(window, dev)[0]
    hdr, pre, dgeo = dec.hdr, job.pre, job.geo
    kernel, depth = pre.wavelet_kernel, pre.depth
    qmatrix = matrices.quant_matrix(kernel, depth)
    out_geom = PictureGeometry.of(job.pic_h, hdr.width, hdr.chroma_format)
    ly = dgeo.luma_slice[0] * dgeo.luma_slice[1]
    lc = dgeo.chroma_slice[0] * dgeo.chroma_slice[1]
    stages = {}
    unit = window[offset:]

    def parse_only():
        rd = StreamReader(bytes(unit))
        rd.major_version = dec._major_version
        rd.r.seek(13)
        rd.read_picture_number()
        rd.read_preamble(True)

    scan_args = (dgeo.n_slices, pre.slice_prefix, pre.slice_size_scalar,
                 job.start)
    stages["decode host: stream parse (picture header, preamble)"] = (
        time_host(parse_only))
    stages["decode host: chain scan (native)"] = time_host(
        lambda: slices_hq.scan_hq_slice_offsets(unit, *scan_args))
    stages["decode host: chain scan (Python loop, the reference)"] = (
        time_host(lambda: slices_hq.scan_hq_slice_offsets_plain(
            unit, *scan_args), 3))

    routes = ("band route", "in-place route")

    def decode_stages(mark, route):
        pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
        mark("decode device: H2D (payload + slice fields)")
        clen = fields[1:]
        dstart = du.hq_component_offsets(clen, pre.slice_prefix, job.start)
        mark("decode device: component offsets")
        lanes = du.unpack_hq(pay, dstart, clen, ly, lc)
        mark("decode device: unpack kernel")
        if route == routes[0]:
            planes = bands.inverse_lanes(lanes, fields[0], qmatrix, dgeo,
                                         kernel, depth)
            mark("decode device: dequantise + inverse DWT (band route, 2 "
                 "band_inverse launches)")
        else:
            planes = pipe.dequantise_planes(lanes, fields[0], qmatrix, depth,
                                            dgeo)
            mark("decode device (in-place route): dequantise + "
                 "lanes_to_plane")
            planes = lifting.inverse_planes(planes, kernel, depth)
            mark("decode device (in-place route): inverse_planes (2 lift "
                 "launches)")
        words = pipe.format_planes(planes, out_geom, hdr.bitdepth)
        mark("decode device: crop + format")
        words.cpu()
        mark("decode device: D2H copy of the output bytes")

    for route in routes:
        stages.update(stage_times(
            torch, lambda mark, r=route: decode_stages(mark, r), route))

    # per-stage breakdown of one 1080p LD picture, decode: the host scan,
    # then the device stages
    ld_stream = streams["ld_1080p"]
    ld_dec, ld_offset, ld_job = ld_picture_of(ld_stream, dev)
    lpre, lgeo = ld_job.pre, ld_job.geo
    lqm = matrices.quant_matrix(lpre.wavelet_kernel, lpre.depth)
    ld_sizes = layout.slice_bytes_map(
        lgeo.y_slices, lgeo.x_slices,
        lpre.slice_bytes_numerator * lgeo.n_slices
        // lpre.slice_bytes_denominator, 1).ravel()
    ld_unit = ld_stream[ld_offset:]
    ld_scan_args = (ld_sizes, lgeo, lpre.depth, lqm, ld_job.start)
    stages["LD decode host: header walk (native, the main path)"] = \
        time_host(lambda: slices_ld.ld_fields(
            ld_unit, ld_sizes, lgeo, lpre.depth, ld_job.start))
    stages["LD decode host: ld scan + LL recurrence (native, a reference "
           "timing: no route runs it)"] = time_host(
        lambda: slices_ld.ld_scan(ld_unit, *ld_scan_args))
    stages["LD decode host: ld scan + LL recurrence (Python twin, the "
           "reference)"] = time_host(
        lambda: slices_ld.ld_scan_plain(ld_unit, *ld_scan_args), 1)
    ld_out = PictureGeometry.of(ld_job.pic_h, ld_dec.hdr.width,
                                ld_dec.hdr.chroma_format)
    lly = lgeo.luma_slice[0] * lgeo.luma_slice[1]
    llc = lgeo.chroma_slice[0] * lgeo.chroma_slice[1]
    ld_plan = ld_dc.plan(lgeo, lpre.depth, tuple(int(v) for v in lqm),
                         torch.device("cuda", torch.cuda.current_device()))

    def ld_decode_stages(mark, route):
        pay, fields = pipe.upload_ld(ld_job.payload, ld_job.ld, dev)
        mark("LD decode device: H2D (payload + fields)")
        lanes = du.unpack_ld(pay, fields[1:], lly, llc)
        mark("LD decode device: ld_unpack kernel")
        grids = ld_dc.ll_grids(lanes, fields[0], ld_plan)
        mark("LD decode device: ld_dc kernel (the LL grids)")
        if route == routes[0]:
            planes = bands.inverse_lanes(lanes, fields[0], lqm, lgeo,
                                         lpre.wavelet_kernel, lpre.depth,
                                         grids)
            mark("LD decode device: dequantise + inverse DWT with the LL "
                 "grids (band route, 2 band_inverse launches)")
        else:
            planes = pipe.dequantise_ld_planes(lanes, fields[0], grids, lqm,
                                               lpre.depth, lgeo)
            mark("LD decode device (in-place route): dequantise + "
                 "lanes_to_plane + LL grids")
            planes = lifting.inverse_planes(planes, lpre.wavelet_kernel,
                                            lpre.depth)
            mark("LD decode device (in-place route): inverse_planes (2 lift "
                 "launches)")
        words = pipe.format_planes(planes, ld_out, ld_dec.hdr.bitdepth)
        mark("LD decode device: crop + format")
        words.cpu()
        mark("LD decode device: D2H copy of the output bytes")

    for route in routes:
        stages.update(stage_times(
            torch, lambda mark, r=route: ld_decode_stages(mark, r), route))

    # per-stage breakdown of one 1080p picture, encode: ConstQ, and CBR
    # with the search before the pack
    def analysis_stages(mark, prefix, route, cfg_, geo_):
        d_ = cfg_.wavelet_depth
        planes = enc_mod.upload_picture(picture_1080p, cfg_.bytes_per_sample,
                                        dev)
        mark(f"{prefix} device: H2D of the samples (int16)")
        if route == routes[0]:
            lanes = bands.forward_lanes(planes, cfg_.kernel, d_, geo_)
            mark(f"{prefix} device: pad + forward DWT + lanes (band route, "
                 "2 band_forward launches)")
        else:
            tr = enc_mod.analyse(planes, cfg_.kernel, d_)
            mark(f"{prefix} device (in-place route): widen + pad + "
                 "forward_planes (2 lift launches)")
            lanes = enc_mod.planes_to_lanes(tr, geo_, d_)
            mark(f"{prefix} device (in-place route): plane_to_lanes")
        return lanes

    def encode_stages(mark, enc, prefix, route):
        cfg_, geo_ = enc.cfg, enc.geo
        lanes = analysis_stages(mark, prefix, route, cfg_, geo_)
        scratch = dp.pack_scratch(geo_.n_slices, lanes[0].shape[1],
                                  lanes[1].shape[1], dev)
        q = enc.q_indices()
        if enc.budgets is not None:
            q = cbr.cbr_quant_indices(*lanes, *enc.qm, enc.budgets,
                                      cfg_.slice_scalar, flags=scratch[1:2])
            mark(f"{prefix} device: cbr search (1 launch, no sync)")
        buf, flags, _ = dp.quant_pack_hq(*lanes, q, *enc.qm,
                                         cfg_.slice_prefix, cfg_.slice_scalar,
                                         enc.budgets, scratch=scratch)
        mark(f"{prefix} device: quantise + pack (1 launch, 1 sync)")
        check(flags == 0, "flags in the staged encode")
        buf.cpu()
        mark(f"{prefix} device: D2H of totals + payload")

    for prefix, enc in (("encode", encoder), ("CBR encode", cbr_encoder)):
        for route in routes:
            stages.update(stage_times(
                torch, lambda mark, e=enc, p=prefix, r=route:
                encode_stages(mark, e, p, r), route))

    def ld_encode_stages(mark, route):
        lanes = analysis_stages(mark, "LD encode", route, lcfg,
                                ld_encoder.geo)
        q, *ll = ld_encoder.rate_control(lanes)
        mark("LD encode device: rate control (1 launch, no sync)")
        buf, _ = ld_encoder.pack(lanes, q, ll)
        mark("LD encode device: quantise + pack (1 launch, no sync)")
        buf.cpu()
        mark("LD encode device: D2H of flags + payload (the picture's one "
             "sync)")

    for route in routes:
        stages.update(stage_times(
            torch, lambda mark, r=route: ld_encode_stages(mark, r), route))
    stages["encode host: read a picture (PlanarReader, NumPy)"] = time_host(
        read_picture)
    payload = encoder.encode_picture(picture_1080p).payload
    stages["encode host: stream write (picture data unit)"] = time_host(
        lambda: StreamWriter(io.BytesIO()).write_picture(0, preamble,
                                                         payload))

    times = kernel_times(torch, job, dev, tlanes_1080p, encoder, q_1080p)
    times.update(band_times(
        torch, {"constq": job,
                "cbr": pictures_of(streams["cbr_1080p"], dev)[0][2]}, dev,
        enc_mod.upload_picture(picture_1080p, 2, dev), encoder))
    times.update(cbr_times(torch, cbr_tlanes, cbr_encoder))
    times.update(ld_times(torch, np, ld_job, dev))
    times.update(ld_encode_times(torch, ld_encoder, ld_tlanes, ld_rate_1080p))
    for lab, ms in stages.items():
        print(f"stage {lab}: {ms:.4f} ms ({card})")
    print(f"kernel times: {json.dumps(times)} ({card})")
    report_busy(torch, "quant_pack_hq of the 1080p transform lanes",
                lambda: dp.quant_pack_hq(*tlanes_1080p, q_1080p, *encoder.qm,
                                         cfg.slice_prefix, cfg.slice_scalar),
                card)

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
    # the band levels: the inverse reads every lane and q index once,
    # writes each level's result once and reads the coarser results again
    # as the next level's LL; it dequantises every lane (~12 operations)
    # and runs the lift's ladders. The forward reads the samples once,
    # writes every lane once and the coarser LLs once and reads them
    # again; it runs the forward ladders and the accuracy shift
    coarse = sum(4 * n for n in level_sizes) - sum(
        4 * n for n in times["plane_samples"])   # results read again as LL
    band_inverse_bound, band_inverse_by = bound_ms(
        4 * times["band_lanes"] + 4 * times["band_slices"]
        + sum(4 * n for n in level_sizes) + coarse,
        lift_ops + 12 * times["band_lanes"])
    forward_ops = 0
    for n in level_sizes:
        for (_t, _s, taps, _a, _sh) in lifting.ladder(kernel, False):
            forward_ops += 2 * (n // 2) * (2 * len(taps) + 3)
        forward_ops += n                              # accuracy shift
    band_forward_bound, band_forward_by = bound_ms(
        times["band_sample_bytes"] + 4 * times["band_lanes"] + 2 * coarse,
        forward_ops)

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

    # the fused pack: the transform lanes, the q indices and the quant
    # matrix tables read once, the totals and the payload written once.
    # Operations: a lane's quantise (index, magnitude, the division as a
    # multiply-high by the factor's reciprocal and its fix of sign, 12),
    # code length and sums (8); a non-zero quantised lane's code and its
    # append (30); each run of zeros before it is one more append (8)
    n_lanes = sum(t.numel() for t in tlanes_1080p)
    n_slices = q_1080p.numel()
    n_nonzero = sum(int(torch.count_nonzero(t).item()) for t in lanes_1080p)
    pack_bytes = (4 * n_lanes + 4 * n_slices
                  + 4 * sum(t.numel() for t in encoder.qm) + 4 * n_slices
                  + times["pack_payload_bytes"])
    pack_bound, pack_by = bound_ms(pack_bytes,
                                   20 * n_lanes + 38 * n_nonzero)

    # the CBR search: the transform lanes, the budgets and the quant matrix
    # tables read once, the q indices written once. Operations, for this
    # run's data: each of the 7 probes ~15 a lane (the trial quantise as a
    # multiply-high, the code length, the sums); each luma error pass ~20 a
    # luma lane (quantise, rescale, square, sum), and a slice makes (its
    # climb + 2) passes
    cbr_lanes = sum(t.numel() for t in cbr_tlanes)
    cbr_slices = cbr_tlanes[0].shape[0]
    cbr_bytes = (4 * cbr_lanes + 8 * cbr_slices
                 + 4 * sum(t.numel() for t in cbr_encoder.qm))
    cbr_ops = (7 * 15 * cbr_lanes
               + 20 * cbr_tlanes[0].shape[1] * times["cbr_luma_passes"])
    cbr_bound, cbr_by = bound_ms(cbr_bytes, cbr_ops)

    # the LD unpack: the payload, the fields and the lanes as the HQ
    # unpack's, operations counted as the HQ unpack's
    ld_pay = torch.as_tensor(np.array(ld_job.payload), device=dev)
    ld_lanes = du.unpack_ld(ld_pay, torch.as_tensor(ld_job.ld.fields,
                                                    device=dev), lly, llc)
    ld_n_lanes = sum(t.numel() for t in ld_lanes)
    ld_bytes = (ld_pay.numel() + ld_job.ld.fields.nbytes + 4 * ld_n_lanes)
    ld_ndata = sum(
        int(torch.floor(torch.log2(t.abs().double() + 1)).sum().item())
        for t in ld_lanes)
    ld_bound, ld_by = bound_ms(ld_bytes, 20 * ld_n_lanes + 3 * ld_ndata)
    # the LD DC prediction: the LL codes gathered from the lanes, their
    # lane map, the q indices and the row and column tables read once, the
    # grids written once; ~40 operations a cell (c_scale and the
    # prediction). Its chain: llh + llw - 1 anti-diagonals of the largest
    # grid, DC_CELL_CHAIN dependent instructions of INT_LATENCY cycles each
    # (at most MAX_THREADS rows a band: one band at 1080p), at the card's
    # highest clock
    src_y, src_c = slices_ld.ll_sources(lgeo, lpre.depth)
    dc_cells = src_y.size + 2 * src_c.size
    ld_dc_bound, ld_dc_by = bound_ms(4 * 3 * dc_cells + 4 * lgeo.n_slices,
                                     40 * dc_cells)
    dc_steps = max(h + w - 1 for h, w in (src_y.shape, src_c.shape))
    ld_dc_chain = 1e3 * dc_steps * DC_CELL_CHAIN * INT_LATENCY / max_sm_hz()

    # the LD rate control: the transform lanes, the budgets and the quant
    # matrix tables read once, the q indices and the LL lanes written once.
    # Operations: each of the 7 probes ~15 a lane (the trial quantise as a
    # multiply-high, the code length, the sums); the LL recurrence and
    # the final requantise touch 1/16 of the lanes. The 374 dependent
    # slice steps of the wavefront are not in the bound: their latency is
    # measured apart (a single row and a single column of the same slices)
    n_ld_lanes = sum(t.numel() for t in ld_tlanes)
    n_ld = ld_tlanes[0].shape[0]
    n_ll = sum(t.shape[1] for t in ld_rate_1080p[1:])
    ld_rate_bytes = (4 * n_ld_lanes + 4 * n_ld
                     + 4 * sum(t.numel() for t in ld_encoder.qm)
                     + 4 * n_ld + 4 * n_ld * n_ll)
    ld_rate_bound, ld_rate_by = bound_ms(ld_rate_bytes, 7 * 15 * n_ld_lanes)
    # its dependent chain: R + C - 1 slice steps, each at least the deepest
    # LL block's cells (lh + lw - 1 of them) of LL_CELL_CHAIN dependent
    # instructions at INT_LATENCY cycles, at the card's highest clock
    ld_steps = lgeo.y_slices + lgeo.x_slices - 1
    ll_depth = max(h + w - 1 for h, w in (ld_encoder.ll_y, ld_encoder.ll_c))
    ld_rate_chain = (1e3 * ld_steps * ll_depth * LL_CELL_CHAIN * INT_LATENCY
                     / max_sm_hz())
    # the LD pack: the transform lanes, the LL lanes, the q indices, the
    # sizes, the offsets and the quant matrix tables read once, the flags
    # and the payload written once; operations as the HQ pack's
    ld_nonzero = sum(int(torch.count_nonzero(t).item()) for t in ld_qlanes)
    ld_pack_bytes = (4 * n_ld_lanes + 4 * n_ld * n_ll + 4 * n_ld
                     + 4 * n_ld + 8 * n_ld
                     + 4 * sum(t.numel() for t in ld_encoder.qm)
                     + 4 + ld_encoder.payload_bytes)
    ld_pack_bound, ld_pack_by = bound_ms(ld_pack_bytes,
                                         20 * n_ld_lanes + 38 * ld_nonzero)

    phase_done("6 times")

    # 7. the encode CLI's one-picture pipeline, before the 8K runs too
    pipeline_paths = pipeline_phase(torch, work.name, zero_counts, counts,
                                    card)
    phase_done("7 encode pipeline")

    # 8. the multi-device paths on the one card, after the times, so that
    # what the 8K runs leave in the process does not weigh on them
    dev0 = torch.device("cuda", 0)
    halo_cases, halo_err, (band_cases, fwd_err, inv_err) = check_halo_lift(
        torch, np, rng, dev0)
    print(f"halo lift: {halo_cases} in-place cases (7 wavelets, 2 and 4 "
          "bands of one card, the thinnest bands) equal to the unsharded "
          "lift, depth launches each way, 50 planes in 2 launches; "
          f"{band_cases} band-form cases equal to the single-device band "
          "route and the plain versions (max |err| against the plain: "
          f"forward {fwd_err}, inverse {inv_err}), depth launches a band "
          "each way")
    lift_err = max(lift_err, halo_err)
    band_forward_err = max(band_forward_err, fwd_err)
    band_inverse_err = max(band_inverse_err, inv_err)
    sharded_paths = sharded_phase(torch, np, dev0, streams, fixtures,
                                  src_1080p, frag_stream, work.name,
                                  zero_counts, counts, card)
    split_row_phase(torch, np, dev0, work.name, card)
    phase_done("8 sharded")

    paths = {"decode": decode_launches, "encode": encode_launches,
             "encode_cbr": cbr_launches, "decode_fragments": frag_launches,
             "decode_ld": ld_launches, "encode_ld": ld_enc_launches,
             **pipeline_paths, **sharded_paths}

    def launches(k):
        return sum(p[k] for p in paths.values())

    def by_path(k):
        return {name: p[k] for name, p in paths.items()}

    kernels = [
        {"name": "lift_level", "route": "cuda",
         "source": "vc2tpu_torch/csrc/lift_level.cu",
         "replaces": "vc2tpu/wavelet/pallas_lift.py:235",
         "launches": launches("lift_level"),
         "launches_by_path": by_path("lift_level"),
         "max_abs_err": lift_err,
         "ms": times["lift_ms"], "device_ms": times["lift_device_ms"],
         "plain_ms": times["lift_plain_ms"], "bound_ms": lift_bound,
         "bound_by": lift_by, "library_ms": None},
        {"name": "band_inverse", "route": "cuda",
         "source": "vc2tpu_torch/csrc/band_lift.cu",
         "replaces": "vc2tpu/pipeline/decoder.py:101",
         "launches": launches("band_inverse"),
         "launches_by_path": by_path("band_inverse"),
         "max_abs_err": band_inverse_err,
         "ms": times["band_inverse_ms"],
         "device_ms": times["band_inverse_device_ms"],
         "plain_ms": times["band_inverse_plain_ms"],
         "bound_ms": band_inverse_bound, "bound_by": band_inverse_by,
         "library_ms": None},
        {"name": "band_forward", "route": "cuda",
         "source": "vc2tpu_torch/csrc/band_lift.cu",
         "replaces": "vc2tpu/pipeline/encoder.py:253",
         "launches": launches("band_forward"),
         "launches_by_path": by_path("band_forward"),
         "max_abs_err": band_forward_err,
         "ms": times["band_forward_ms"],
         "device_ms": times["band_forward_device_ms"],
         "plain_ms": times["band_forward_plain_ms"],
         "bound_ms": band_forward_bound, "bound_by": band_forward_by,
         "library_ms": None},
        {"name": "hq_unpack", "route": "cuda",
         "source": "vc2tpu_torch/csrc/hq_unpack.cu",
         "replaces": "vc2tpu/vlc/device_unpack.py:107",
         "launches": launches("hq_unpack"),
         "launches_by_path": by_path("hq_unpack"),
         "max_abs_err": unpack_err,
         "ms": times["unpack_ms"], "device_ms": times["unpack_device_ms"],
         "plain_ms": times["unpack_plain_ms"],
         "bound_ms": unpack_bound, "bound_by": unpack_by,
         "library_ms": None},
        {"name": "hq_pack", "route": "cuda",
         "source": "vc2tpu_torch/csrc/hq_pack.cu",
         "replaces": "vc2tpu/vlc/device_pack.py:133",
         "launches": launches("hq_pack"),
         "launches_by_path": by_path("hq_pack"),
         "max_abs_err": pack_err,
         "ms": times["pack_ms"], "device_ms": times["pack_device_ms"],
         "plain_ms": times["pack_plain_ms"],
         "bound_ms": pack_bound, "bound_by": pack_by,
         "library_ms": None},
        {"name": "hq_cbr", "route": "cuda",
         "source": "vc2tpu_torch/csrc/hq_cbr.cu",
         "replaces": "vc2tpu/rdo/cbr.py:183",
         "launches": launches("hq_cbr"),
         "launches_by_path": by_path("hq_cbr"),
         "max_abs_err": cbr_err,
         "ms": times["cbr_ms"], "device_ms": times["cbr_device_ms"],
         "plain_ms": times["cbr_plain_ms"],
         "bound_ms": cbr_bound, "bound_by": cbr_by,
         "group": cbr.group_plan(cbr_tlanes[0].shape[1],
                                 cbr_tlanes[1].shape[1]),
         "library_ms": None},
        {"name": "ld_unpack", "route": "cuda",
         "source": "vc2tpu_torch/csrc/ld_unpack.cu",
         "replaces": "vc2tpu/vlc/device_unpack.py:262",
         "launches": launches("ld_unpack"),
         "launches_by_path": by_path("ld_unpack"),
         "max_abs_err": ld_err,
         "ms": times["ld_unpack_ms"],
         "device_ms": times["ld_unpack_device_ms"],
         "plain_ms": times["ld_unpack_plain_ms"],
         "bound_ms": ld_bound, "bound_by": ld_by, "library_ms": None},
        {"name": "ld_dc", "route": "cuda",
         "source": "vc2tpu_torch/csrc/ld_dc.cu",
         "replaces": "vc2tpu_torch/csrc/ld_scan.cpp ld_dequantise_grid "
                     "(vc2tpu/pipeline/decoder.py ld_ll_grids)",
         "launches": launches("ld_dc"),
         "launches_by_path": by_path("ld_dc"),
         "max_abs_err": ld_dc_err,
         "ms": times["ld_dc_ms"], "device_ms": times["ld_dc_device_ms"],
         "plain_ms": times["ld_dc_plain_ms"],
         "bound_ms": ld_dc_bound, "bound_by": ld_dc_by,
         "chain_bound_ms": ld_dc_chain, "library_ms": None},
        {"name": "ld_rate", "route": "cuda",
         "source": "vc2tpu_torch/csrc/ld_rate.cu",
         "replaces": "vc2tpu/rdo/ld.py:233",
         "launches": launches("ld_rate"),
         "launches_by_path": by_path("ld_rate"),
         "max_abs_err": ld_rate_err,
         "ms": times["ld_rate_ms"], "device_ms": times["ld_rate_device_ms"],
         "plain_ms": ld_rate_plain_ms,
         "bound_ms": ld_rate_bound, "bound_by": ld_rate_by,
         "chain_bound_ms": ld_rate_chain,
         "body_table_device_ms": times["ld_body_table_device_ms"],
         "step_us": times["ld_rate_step_us"], "library_ms": None},
        {"name": "ld_pack", "route": "cuda",
         "source": "vc2tpu_torch/csrc/ld_pack.cu",
         "replaces": "vc2tpu/vlc/device_pack.py:302",
         "launches": launches("ld_pack"),
         "launches_by_path": by_path("ld_pack"),
         "max_abs_err": ld_pack_err,
         "ms": times["ld_pack_ms"], "device_ms": times["ld_pack_device_ms"],
         "plain_ms": times["ld_pack_plain_ms"],
         "bound_ms": ld_pack_bound, "bound_by": ld_pack_by,
         "group": dp.ld_group_size(ld_tlanes[0].shape[1],
                                   ld_tlanes[1].shape[1]),
         "library_ms": None},
    ]
    print(f"cbr search at 1080p: {times['cbr_luma_passes']} luma error "
          f"passes over {cbr_slices} slices, longest climb {cbr_climb}")
    steps = ld_steps
    print(f"ld_rate body table kernel alone (the generic shapes' first "
          f"launch): {times['ld_body_table_device_ms']:.4f} ms; chain bound "
          f"{ld_rate_chain:.4f} ms ({steps} steps x "
          f"{ll_depth} cells x {LL_CELL_CHAIN} instructions x {INT_LATENCY} "
          f"cycles at {max_sm_hz() / 1e6:.0f} MHz) ({card})")
    print(f"ld_rate dependent step: {times['ld_rate_row_us']:.3f} us a slice "
          f"on the picture's first row ({lgeo.x_slices} slices, no waits), "
          f"{times['ld_rate_col_us']:.3f} us on its first column "
          f"({lgeo.y_slices} slices, each waiting on the one above); the "
          f"picture's {steps} steps at the column's rate: "
          f"{steps * times['ld_rate_col_us'] / 1e3:.4f} ms, device_ms / that "
          f"{times['ld_rate_device_ms'] / (steps * times['ld_rate_col_us'] / 1e3):.3f} "
          f"({card})")
    print(f"ld_dc chain bound {ld_dc_chain:.4f} ms ({dc_steps} steps x "
          f"{DC_CELL_CHAIN} instructions x {INT_LATENCY} cycles at "
          f"{max_sm_hz() / 1e6:.0f} MHz); device_ms / that "
          f"{times['ld_dc_device_ms'] / ld_dc_chain:.2f} ({card})")
    for k in kernels:
        if k["name"] == "band_inverse":
            print(f"kernel band_inverse on the CBR fixture's lanes "
                  f"({times['band_inverse_cbr_distinct_q']} distinct q; "
                  f"ConstQ {times['band_inverse_distinct_q']}): "
                  f"{times['band_inverse_cbr_ms']:.4f} ms per 1080p "
                  f"picture (device alone "
                  f"{times['band_inverse_cbr_device_ms']:.4f} ms) ({card})")
        print(f"kernel {k['name']}: {k['ms']:.4f} ms per 1080p picture "
              f"(device alone {k['device_ms']:.4f} ms), bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, launches {k['launches']} "
              f"{k['launches_by_path']} ({card})")
    work.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_times(torch, job, dev, tlanes, enc, q_idx) -> dict:
    """Times of one 1080p picture's kernel work at the main paths' shapes:
    ``*_ms`` as the host issues it (the lift's two decode levels once; the
    unpack 10 times back to back; the fused pack's launch with its one
    synchronisation), ``*_device_ms`` queued (the device's time alone; the
    pack's launch without the read of its size and flags, so nothing
    synchronises), ``*_plain_ms`` of the plain versions."""
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.vlc import device_pack as dp
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

    prefix, scalar = enc.cfg.slice_prefix, enc.cfg.slice_scalar
    buf, _flags, _ = dp.quant_pack_hq(*tlanes, q_idx, *enc.qm, prefix, scalar)
    total = buf.numel() - 4 * q_idx.numel()

    def pack():
        return dp.quant_pack_hq(*tlanes, q_idx, *enc.qm, prefix, scalar)

    def pack_queued():
        dp.launch_pack(tlanes, q_idx, prefix, scalar, qm=enc.qm)

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
        "pack_ms": time_device(torch, pack),
        "pack_device_ms": time_device(torch, pack_queued, KERNEL_INNER,
                                      queued=True),
        "pack_plain_ms": time_device(
            torch, lambda: dp.quant_pack_hq_plain(*tlanes, q_idx, *enc.qm,
                                                  prefix, scalar), reps=3),
        "pack_payload_bytes": total,
        "plane_samples": [p.numel() for p in planes],
    }


def band_times(torch, jobs: dict, dev, samples, enc) -> dict:
    """Times of the band kernels at the main paths' 1080p shapes: the
    inverse on each fixture's unpacked lanes (``jobs``: "constq", one q
    for every slice, and "cbr", a q a slice, whose dequantisation reads a
    factor a slice), the forward on the 1080p picture's uploaded int16
    samples; ``*_ms`` as the host issues one picture's ``depth`` launches,
    ``*_device_ms`` queued (the device's time alone), ``*_plain_ms`` of
    the plain versions on the card (ConstQ); and the sample counts of each
    level, for the bounds. The ConstQ keys carry no fixture name; the CBR
    inverse's are ``band_inverse_cbr_*``."""
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import bands, matrices

    out = {}
    for name, job in jobs.items():
        pre, geo = job.pre, job.geo
        kernel, depth = pre.wavelet_kernel, pre.depth
        qm = matrices.quant_matrix(kernel, depth)
        pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
        clen = fields[1:].contiguous()
        dstart = du.hq_component_offsets(clen, pre.slice_prefix, job.start)
        lanes = du.unpack_hq(pay, dstart, clen,
                             geo.luma_slice[0] * geo.luma_slice[1],
                             geo.chroma_slice[0] * geo.chroma_slice[1])
        q = fields[0]

        def inverse(lanes=lanes, q=q, qm=qm, geo=geo, kernel=kernel,
                    depth=depth):
            return bands.inverse_lanes(lanes, q, qm, geo, kernel, depth)

        key = "band_inverse" if name == "constq" else f"band_inverse_{name}"
        out[f"{key}_ms"] = time_device(torch, inverse)
        out[f"{key}_device_ms"] = time_device(torch, inverse, KERNEL_INNER,
                                              queued=True)
        out[f"{key}_distinct_q"] = int(torch.unique(q).numel())
        if name == "constq":
            out["band_inverse_plain_ms"] = time_device(
                torch, lambda: bands.inverse_lanes_plain(
                    lanes, q, qm, geo, kernel, depth))
            out["band_lanes"] = sum(t.numel() for t in lanes)
            out["band_slices"] = q.numel()
    cfg = enc.cfg

    def forward():
        return bands.forward_lanes(samples, cfg.kernel, cfg.wavelet_depth,
                                   enc.geo)

    out.update({
        "band_forward_ms": time_device(torch, forward),
        "band_forward_device_ms": time_device(torch, forward, KERNEL_INNER,
                                              queued=True),
        "band_forward_plain_ms": time_device(
            torch, lambda: bands.forward_lanes_plain(
                samples, cfg.kernel, cfg.wavelet_depth, enc.geo)),
        "band_sample_bytes": sum(t.numel() * t.element_size()
                                 for t in samples),
    })
    return out


def ld_times(torch, np, job, dev) -> dict:
    """Times of the LD unpack and the DC prediction on the 1080p LD
    picture: ``*_ms`` as the host issues 10 launches back to back,
    ``*_device_ms`` queued (the device's time alone), ``*_plain_ms`` of the
    plain version (the unpack's on the card; the DC prediction's, the host
    recurrence over the codes gathered from the lanes, on the host)."""
    from vc2tpu_torch.quant import ld_dc
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import matrices

    geo = job.geo
    ly = geo.luma_slice[0] * geo.luma_slice[1]
    lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    pay = torch.as_tensor(np.array(job.payload), device=dev)
    fields = torch.as_tensor(job.ld.fields, device=dev)

    def unpack():
        return du.unpack_ld(pay, fields, ly, lc)

    lanes = unpack()
    q = torch.as_tensor(job.ld.q, device=dev)
    qm = tuple(int(v) for v in matrices.quant_matrix(job.pre.wavelet_kernel,
                                                      job.pre.depth))
    plan = ld_dc.plan(geo, job.pre.depth, qm, q.device)
    host_plan = ld_dc.plan(geo, job.pre.depth, qm, torch.device("cpu"))
    host_lanes = [t.cpu() for t in lanes]

    def dc():
        return ld_dc.ll_grids(lanes, q, plan)

    return {
        "ld_unpack_ms": time_device(torch, unpack, 10),
        "ld_unpack_device_ms": time_device(torch, unpack, KERNEL_INNER,
                                           queued=True),
        "ld_unpack_plain_ms": time_device(
            torch, lambda: du.unpack_ld_plain(pay, fields, ly, lc)),
        "ld_dc_ms": time_device(torch, dc, 10),
        "ld_dc_device_ms": time_device(torch, dc, KERNEL_INNER, queued=True),
        "ld_dc_plain_ms": time_host(
            lambda: ld_dc.ll_grids(host_lanes, q.cpu(), host_plan)),
    }


def ld_encode_times(torch, enc, tlanes, rate) -> dict:
    """Times of the LD rate control and pack on the 1080p LD picture:
    ``*_ms`` as the host issues one launch (the pack's with the read of its
    flags word), ``*_device_ms`` queued (the device's time alone),
    ``ld_pack_plain_ms`` of the plain pack on the card; and the rate
    control's body table kernel alone (``ld_body_table_device_ms``: the
    generic kernel's first launch; at 1080p the fixed-shape kernel's
    producer warps do this work inside its one launch) and
    its dependent step: the kernel on the picture's first row of slices
    (one CTA, no waits) and on its first column (each slice waits on the
    one above), device time per slice in microseconds (``ld_rate_step_us``
    the column's)."""
    from vc2tpu_torch.rdo import ld as rdo_ld
    from vc2tpu_torch.vlc import device_pack as dp

    q, *ll = rate
    geo = enc.geo
    rows, cols = geo.y_slices, geo.x_slices

    def rate_fn():
        return enc.rate_control(tlanes)

    def pack_fn():
        return enc.pack(tlanes, q, ll)[0][:4].cpu()

    def pack_queued():
        return enc.pack(tlanes, q, ll)

    def grid_fn(index, grid):
        lanes = [x[index].contiguous() for x in tlanes]
        avail = enc.avail_device[index].contiguous()
        return lambda: rdo_ld.ld_rate_control(
            *lanes, enc.qmatrix, enc.band_sizes_y, enc.band_sizes_c, avail,
            grid, enc.ll_y, enc.ll_c)

    def table_fn():
        return rdo_ld.launch_table(*tlanes, enc.qmatrix, enc.band_sizes_y,
                                   enc.band_sizes_c)

    row_ms = time_device(torch, grid_fn(slice(0, cols), (1, cols)), 5,
                         queued=True)
    col_ms = time_device(torch, grid_fn(slice(0, None, cols), (rows, 1)), 5,
                         queued=True)
    return {
        "ld_rate_ms": time_device(torch, rate_fn),
        "ld_rate_device_ms": time_device(torch, rate_fn, 5, queued=True),
        "ld_body_table_device_ms": time_device(torch, table_fn, 5,
                                               queued=True),
        "ld_rate_row_us": 1e3 * row_ms / cols,
        "ld_rate_col_us": 1e3 * col_ms / rows,
        "ld_rate_step_us": 1e3 * col_ms / rows,
        "ld_pack_ms": time_device(torch, pack_fn),
        "ld_pack_device_ms": time_device(torch, pack_queued, KERNEL_INNER,
                                         queued=True),
        "ld_pack_plain_ms": time_device(
            torch, lambda: dp.quant_pack_ld_plain(*tlanes, ll, q, *enc.qm,
                                                  enc.sizes), reps=3),
    }


def cbr_times(torch, tlanes, enc) -> dict:
    """Times of the CBR search on one 1080p picture's transform lanes:
    ``cbr_ms`` as the host issues its launch (no synchronisation in the
    wrapper), ``cbr_device_ms`` queued (the device's time alone),
    ``cbr_plain_ms`` of the plain version on the card; and the number of
    luma error passes this picture's slices make (each slice: its climb
    + 2), for the bound."""
    from vc2tpu_torch.rdo import cbr

    scalar = enc.cfg.slice_scalar

    def search():
        return cbr.cbr_quant_indices(*tlanes, *enc.qm, enc.budgets, scalar)

    q = cbr.cbr_quant_indices_plain(*tlanes, *enc.qm, enc.budgets, scalar)
    best = cbr.bisect_plain(*tlanes, *enc.qm, enc.budgets, scalar)
    return {
        "cbr_ms": time_device(torch, search),
        "cbr_device_ms": time_device(torch, search, KERNEL_INNER,
                                     queued=True),
        "cbr_plain_ms": time_device(
            torch, lambda: cbr.cbr_quant_indices_plain(
                *tlanes, *enc.qm, enc.budgets, scalar), reps=3),
        "cbr_luma_passes": int((q.to(torch.int64) - best + 2).sum()),
    }


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
