"""Multi-process orchestration: the process group, the global mesh, the
frame axis and the row bands across processes, process-0 stream assembly
and the throughput harness.

Port of ``vc2tpu.shard.multihost``. The global mesh is every process's
devices in process order, reshaped to (data, space), as the JAX package
reshapes ``jax.devices()``: a process holds whole rows when its devices
cover them, and a ``space`` row may span processes. Each process encodes
the pictures of the rows it holds positions in, on its own positions
(``pipeline.sharded``): a band's block of slice rows comes from the
row's whole host picture (the band form of ``shard.halo``), so a row
split over processes sends no rows (the in-place halo lift's exchange,
point-to-point over ``torch.distributed``, serves ``--halo-check``).
What crosses processes is host bytes: each band's flags, q indices, slice sizes
and payload span, keyed by (picture, band) and gathered on the gloo
backend (sizes first, then padded uint8 tensors), so every process
assembles the same stream (and raises the same first error) and process
0 writes it. Gloo runs on any machine, also for processes that share one
card (NCCL cannot put two ranks on one card).

    python -m vc2tpu_torch.shard.multihost --world 2 --device cpu OUT
    python -m vc2tpu_torch.shard.multihost --world 2 --data 1 --space 4 \\
        --device cpu OUT

runs the two-process harness (``launch``): the processes encode a
deterministic batch of ``data`` frames (default: one a process) over a
``data`` x ``space`` global mesh (``data * space / world`` devices a
process; the second command splits one row of four bands over two
processes), process 0 writes the stream (OUT), the fragment-streamed
stream (OUT.frag) and the multi-process decode of the fragments (OUT.dec,
the decoder's DECODED bytes). ``--halo-check`` also lifts seeded planes
forward and back over the first row's bands, for every wavelet at depths
1-3, and each process writes its bands to OUT.halo<rank>.npz.
"""

from __future__ import annotations

import argparse
import datetime
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                      Mode, Profile, WaveletKernel)
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline.decoder import format_planes
from vc2tpu_torch.pipeline.encoder import EncodedPicture
from vc2tpu_torch.pipeline.sharded import ShardedDecoder, ShardedEncoder
from vc2tpu_torch.shard import halo
from vc2tpu_torch.shard.mesh import Mesh, devices_of
from vc2tpu_torch.stream.dataunit import (DataUnitType, PicturePreamble,
                                          StreamReader, StreamWriter)
from vc2tpu_torch.stream.headers import SequenceHeader
from vc2tpu_torch.vlc import device_pack


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout: float = 120.0) -> None:
    """Join the gloo process group at ``coordinator_address`` ("host:port";
    None: the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
    environment). Every collective of the group fails after ``timeout``
    seconds."""
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))


def make_global_mesh(data: int | None = None, space: int | None = None,
                     devices=None, device=None) -> Mesh:
    """The mesh over every process's devices, in process order, reshaped to
    ``data`` (frames) x ``space`` (row bands): position (d, s) belongs to
    process ``(d * space + s) // local``, ``local`` being the devices a
    process has, so a row spans processes where a process has fewer
    devices than ``space``. A process's devices are ``devices``, else the
    visible cards (``device`` a card or None) or, on the CPU (``device=
    "cpu"``), as many CPU positions as the mesh gives each process.
    Defaults: a row a process, the devices left a row (1 on the CPU).
    Raises the JAX package's ValueError where ``data * space`` is not the
    number of devices. ``mesh.owners[d][s]`` is the owner of position
    (d, s); only the owner's device is real."""
    world = dist.get_world_size()
    local = ([torch.device(d) for d in devices] if devices is not None
             else devices_of(device))
    data = world if data is None else data
    if local is None:                    # the CPU: as many as asked
        space = 1 if space is None else space
        if data * space % world:
            raise ValueError(f"mesh {data}x{space} does not divide over "
                             f"{world} processes")
        local = [torch.device("cpu")] * (data * space // world)
    n = world * len(local)
    if space is None:
        space = n // data
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} != {n} devices")
    per = len(local)
    return Mesh([[local[(d * space + s) % per] for s in range(space)]
                 for d in range(data)],
                [[(d * space + s) // per for s in range(space)]
                 for d in range(data)])


def local_rows(mesh: Mesh, rank: int | None = None) -> list:
    """The data rows in which process ``rank`` (default: this one) holds a
    position."""
    rank = dist.get_rank() if rank is None else rank
    return [d for d, row in enumerate(mesh.owners) if rank in row]


def local_mesh(mesh: Mesh, rank: int | None = None) -> Mesh:
    """The rows of ``mesh`` in which process ``rank`` (default: this one)
    holds a position, with their owners."""
    rows = local_rows(mesh, rank)
    return Mesh([mesh.devices[d] for d in rows],
                [mesh.owners[d] for d in rows])


def all_gather_bytes(blob: bytes) -> list:
    """Every process's ``blob``, in rank order, through gloo: the sizes
    first, then uint8 tensors padded to the largest."""
    world = dist.get_world_size()
    mine = torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob \
        else torch.empty(0, dtype=torch.uint8)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([mine.numel()], dtype=torch.int64))
    most = max(int(s) for s in sizes)
    padded = torch.zeros(most, dtype=torch.uint8)
    padded[:mine.numel()] = mine
    outs = [torch.empty(most, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(outs, padded)
    return [o[:int(s)].numpy().tobytes() for o, s in zip(outs, sizes)]


def _pack_bands(bands) -> bytes:
    """[(picture, band, flags, q int32 [n], totals int32 [n], payload
    bytes)] as one blob: the count, then each band's keys, n and payload
    size, its arrays and its payload."""
    out = [np.array([len(bands)], np.int64).tobytes()]
    for pic, band, flags, q, totals, payload in bands:
        out += [np.array([pic, band, flags, q.size, len(payload)],
                         np.int64).tobytes(),
                q.astype(np.int32).tobytes(),
                totals.astype(np.int32).tobytes(), payload]
    return b"".join(out)


def _unpack_bands(blob: bytes) -> list:
    count = int(np.frombuffer(blob, np.int64, 1, 0)[0])
    at, out = 8, []
    for _ in range(count):
        pic, band, flags, n, size = (int(v) for v in
                                     np.frombuffer(blob, np.int64, 5, at))
        at += 40
        q = np.frombuffer(blob, np.int32, n, at)
        totals = np.frombuffer(blob, np.int32, n, at + 4 * n)
        at += 8 * n
        out.append((pic, band, flags, q, totals, blob[at:at + size]))
        at += size
    return out


class MultiHostEncoder:
    """Multi-process HQ encoder over a global mesh. Every process calls
    with the pictures of the rows it holds positions in (a row's block of
    the global batch, in row order; a row split over processes gives each
    of them the row's whole pictures) and encodes its own positions; the
    bands' bytes are gathered so every process holds the global batch's
    results, in data-axis order; process 0 writes the stream."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.rows = local_rows(mesh)
        self.enc = ShardedEncoder(cfg, local_mesh(mesh), dist.get_rank())

    def _gather(self, pictures) -> list:
        """Encode this process's pictures and gather every process's bands:
        [picture][band] (q, totals, payload span), global order. Every
        band's flags are gathered before any is checked, so each process
        raises the same first error (in picture, then band order) and none
        is left waiting in a collective."""
        enc = self.enc
        jobs = enc._launch(pictures)
        status = enc._statuses(jobs, check=False)
        n = enc.n_loc
        per = len(pictures) // len(self.rows)
        mine = []
        for (b, s), (flags, size) in sorted(status.items()):
            q, buf, _st = jobs[b][s]
            span = buf[:4 * n + (0 if flags else size)].cpu().numpy()
            totals, payload = device_pack.split_result(span, n)
            mine.append((self.rows[b // per] * per + b % per, s, flags,
                         q.cpu().numpy(), totals, payload.tobytes()))
        bands = {(pic, s): rest for blob in all_gather_bytes(
            _pack_bands(mine)) for pic, s, *rest in _unpack_bands(blob)}
        for key in sorted(bands):
            device_pack.check_flags(bands[key][0])
        space = self.mesh.shape["space"]
        return [[tuple(bands[p, s][1:]) for s in range(space)]
                for p in range(self.mesh.shape["data"] * per)]

    def encode_local_batch(self, pictures) -> list:
        """``EncodedPicture``s of the global batch (its q indices on the
        CPU), identical on every process."""
        geo = self.enc.geo
        return [EncodedPicture(
            q_device=torch.from_numpy(np.concatenate([q for q, _t, _p in row])),
            slices=(geo.y_slices, geo.x_slices),
            payload=b"".join(p for _q, _t, p in row),
            slice_totals=np.concatenate([t for _q, t, _p in row]))
            for row in self._gather(pictures)]

    def stream_fragments(self, pictures, writer, picture_numbers, preamble):
        """Encode, gather, and on process 0 frame and write each picture's
        fragments a band's span at a time (``picture_numbers`` cover the
        global batch). Returns the pictures' q indices on process 0, None
        elsewhere."""
        rows = self._gather(pictures)
        if dist.get_rank() != 0:
            return None
        geo = self.enc.geo
        q_out = []
        for row, picnum in zip(rows, picture_numbers):
            fw = writer.begin_fragments(picnum, preamble, hq=True)
            for _q, totals, payload in row:
                fw.feed(totals, payload)
            fw.close()
            q_out.append(np.concatenate([q for q, _t, _p in row]).reshape(
                geo.y_slices, geo.x_slices))
        return q_out


def collect_hq_payloads(stream: bytes):
    """Parse a well-formed HQ stream into (sequence header, [(picture
    number, preamble, payload uint8)]): whole pictures and reassembled
    fragments (reference DecodeStream.cpp:62-101, 799-976). The
    multi-process decode's front end: every process parses the same bytes
    and decodes its own pictures. Needs valid next_parse_offsets."""
    rd = StreamReader(stream)
    hdr = None
    out = []
    frags: dict = {}
    pos = 0
    while pos + 13 <= len(stream):
        rd.r.seek(pos)
        du, next_off, _prev = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            hdr = rd.read_sequence_header()
        elif du == DataUnitType.HQ_PICTURE:
            picnum = rd.read_picture_number()
            pre = rd.read_preamble(True)
            end = pos + next_off if next_off >= 13 else len(stream)
            out.append((picnum, pre,
                        np.frombuffer(stream[rd.r.byte_pos:end], np.uint8)))
        elif du == DataUnitType.HQ_FRAGMENT:
            picnum = rd.read_picture_number()
            frag = rd.read_fragment_header()
            if frag.n_slices == 0:
                frags[picnum] = (rd.read_preamble(True), {}, 0)
            elif picnum in frags:
                pre, parts, cnt = frags[picnum]
                parts[frag.slice_offset_y * pre.slices_x
                      + frag.slice_offset_x] = rd.r.get_raw(frag.data_length)
                cnt += frag.n_slices
                if cnt >= pre.slices_x * pre.slices_y:
                    payload = b"".join(p for _, p in sorted(parts.items()))
                    out.append((picnum, pre,
                                np.frombuffer(payload, np.uint8)))
                    del frags[picnum]
                else:
                    frags[picnum] = (pre, parts, cnt)
        if next_off >= 13:
            pos += next_off
        elif du == DataUnitType.END_OF_SEQUENCE:
            pos += 13
        else:
            break
    return hdr, out


class MultiHostDecoder:
    """Frame-parallel multi-process HQ decode: picture i decodes on process
    i % world, over the row bands of that process's own devices
    (``ShardedDecoder``); process 0 gathers the cropped planes."""

    def __init__(self, kernel, depth: int, geo, space: int | None = None,
                 devices=None, device=None):
        local = ([torch.device(d) for d in devices] if devices is not None
                 else devices_of(device))
        if local is None:
            local = [torch.device("cpu")] * (space or 1)
        space = len(local) if space is None else space
        self.sdec = ShardedDecoder(kernel, depth, geo, Mesh([local[:space]]))
        self.geo = geo

    def decode_pictures(self, items, prefix: int, scalar: int, out_luma,
                        out_chroma):
        """items: the global [(picture number, payload)] in output order.
        Returns [(y, c1, c2)] int32 NumPy planes cropped to ``out_luma`` /
        ``out_chroma`` on process 0, None elsewhere."""
        world, rank = dist.get_world_size(), dist.get_rank()
        n = len(items)
        if n == 0:
            return [] if rank == 0 else None
        k = -(-n // world)                 # pictures a process, padded
        (lh, lw), (ch, cw) = out_luma, out_chroma
        mine = [np.empty((k, h, w), np.int32)
                for h, w in ((lh, lw), (ch, cw), (ch, cw))]
        for j in range(k):
            i = min(rank + j * world, n - 1)
            planes = self.sdec.decode_payload(items[i][1], prefix, scalar)
            for out, p, (h, w) in zip(mine, planes,
                                      ((lh, lw), (ch, cw), (ch, cw))):
                out[j] = p[:h, :w].cpu().numpy()
        gathered = []
        for a in mine:
            parts = [torch.empty(a.shape, dtype=torch.int32)
                     for _ in range(world)]
            dist.all_gather(parts, torch.from_numpy(a))
            gathered.append(torch.cat(parts).numpy())
        if rank != 0:
            return None
        return [tuple(g[(i % world) * k + i // world] for g in gathered)
                for i in range(n)]


def scaling_efficiency(cfg: EncoderConfig, mesh: Mesh, n_frames: int = 4,
                       seed: int = 0) -> float:
    """Frames a second of ``ShardedEncoder.encode_batch`` on ``mesh`` over
    ``n_frames`` seeded frames, after one batch of warm-up: run with meshes
    of more processes or cards and divide. Works on any device."""
    pics = harness_frames(cfg, n_frames, seed)
    enc = ShardedEncoder(cfg, mesh)
    data = mesh.shape["data"]
    enc.encode_batch((pics * data)[:data])
    t0 = time.perf_counter()
    done = 0
    while done < n_frames:
        batch = pics[done:done + data]
        done += len(batch)
        enc.encode_batch(batch + [batch[-1]] * (data - len(batch)))
    return n_frames / (time.perf_counter() - t0)


# --- the multi-process harness -------------------------------------------

def harness_config(size: str) -> EncoderConfig:
    """The harness's HQ CBR configuration: ``tiny`` (64 x 64, the JAX
    package's multi-host test), ``1080p`` (BASELINE config #1's 4:2:2
    10-bit picture at -u 1 -a 2, 829440 bytes, scalar 2) or ``8k``
    (BASELINE config #5: 7680 x 4320 4:2:2 10-bit at -u 1 -a 2, 16 x
    829440 bytes, scalar 2)."""
    if size == "8k":
        return EncoderConfig(height=4320, width=7680,
                             chroma_format=ColourFormat.CF422,
                             kernel=WaveletKernel.LeGall, wavelet_depth=2,
                             y_size=1, x_size=2, mode=Mode.HQ_CBR,
                             luma_depth=10, chroma_depth=10,
                             frame_rate=FrameRate.FR50,
                             compressed_bytes=16 * 829440, slice_scalar=2)
    if size == "tiny":
        return EncoderConfig(height=64, width=64,
                             chroma_format=ColourFormat.CF422,
                             kernel=WaveletKernel.LeGall, wavelet_depth=2,
                             y_size=1, x_size=2, mode=Mode.HQ_CBR,
                             luma_depth=10, chroma_depth=10,
                             frame_rate=FrameRate.FR25,
                             compressed_bytes=64 * 64 // 2, slice_scalar=1)
    return EncoderConfig(height=1080, width=1920,
                         chroma_format=ColourFormat.CF422,
                         kernel=WaveletKernel.LeGall, wavelet_depth=2,
                         y_size=1, x_size=2, mode=Mode.HQ_CBR,
                         luma_depth=10, chroma_depth=10,
                         frame_rate=FrameRate.FR50,
                         compressed_bytes=829440, slice_scalar=2)


def harness_frames(cfg: EncoderConfig, n: int, seed: int = 7) -> list:
    """``n`` seeded pictures of samples in [-512, 512)."""
    rng = np.random.default_rng(seed)
    g = cfg.geometry
    return [Picture(
        rng.integers(-512, 512, (g.luma_height, g.luma_width)).astype(
            np.int32),
        rng.integers(-512, 512, (g.chroma_height, g.chroma_width)).astype(
            np.int32),
        rng.integers(-512, 512, (g.chroma_height, g.chroma_width)).astype(
            np.int32), cfg.chroma_format) for _ in range(n)]


def harness_stream(cfg: EncoderConfig, encoded,
                   fragment_length: int = 0) -> bytes:
    """The stream of ``encoded`` pictures (numbered from 0), whole or in
    fragments: what the harness's process 0 writes."""
    buf = io.BytesIO()
    w = StreamWriter(buf)
    w.fragment_length = fragment_length
    w.start_sequence()
    w.write_sequence_header(harness_header(cfg))
    for i, e in enumerate(encoded):
        w.write_picture(i, harness_preamble(cfg, e.slices), e.payload,
                        slice_sizes=e.slice_totals)
    w.end_sequence()
    return buf.getvalue()


def harness_header(cfg: EncoderConfig) -> SequenceHeader:
    g = cfg.geometry
    return SequenceHeader(
        profile=Profile.PROFILE_HQ, height=g.luma_height, width=g.luma_width,
        chroma_format=cfg.chroma_format, interlace=cfg.interlaced,
        frame_rate=cfg.frame_rate, top_field_first=cfg.top_field_first,
        bitdepth=cfg.luma_depth)


def harness_preamble(cfg: EncoderConfig, slices) -> PicturePreamble:
    ys, xs = slices
    return PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth, slices_x=xs,
        slices_y=ys, slice_prefix=cfg.slice_prefix,
        slice_size_scalar=cfg.slice_scalar)


def halo_planes(kernel: WaveletKernel, depth: int, n: int) -> list:
    """The halo check's seeded planes for ``kernel`` at ``depth`` over
    ``n`` bands: bands of the thinnest height the JAX package accepts and
    of three times it, samples in [-2**16, 2**16)."""
    thin = (1 << depth) * max(1, halo.halo_width(kernel))
    rng = np.random.default_rng(int(kernel) * 8 + depth)
    return [torch.from_numpy(rng.integers(-(1 << 16), 1 << 16,
                                          (n * rows, 24)).astype(np.int32))
            for rows in (thin, 3 * thin)]


def halo_check(mesh: Mesh, out: str) -> None:
    """Lift ``halo_planes`` forward over the bands of the mesh's first row
    (this process's positions of it), then back from the forward's bands,
    for every wavelet at depths 1-3; write this process's bands of both to
    ``out`` (an .npz keyed ``{kernel}_{depth}_{plane}_{f|i}_{band}``)."""
    owners = mesh.owners[0]
    n = len(owners)
    mine = [o == dist.get_rank() for o in owners]
    saved = {}
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for depth in (1, 2, 3):
            planes = halo_planes(kernel, depth, n)
            bands = [[t[s * t.shape[0] // n:(s + 1) * t.shape[0] // n].to(
                dev) if m else None for s, (dev, m) in enumerate(
                zip(mesh.devices[0], mine))] for t in planes]
            fwd = halo.forward_bands(bands, kernel, depth,
                                     [owners] * len(planes))
            inv = halo.inverse_bands(fwd, kernel, depth,
                                     [owners] * len(planes))
            for p in range(len(planes)):
                for kind, res in (("f", fwd), ("i", inv)):
                    for s in range(n):
                        if mine[s]:
                            saved[f"{kernel.name}_{depth}_{p}_{kind}_{s}"] = (
                                res[p][s].cpu().numpy())
    np.savez(out, **saved)


def worker(address: str, world: int, rank: int, out: str, device: str,
           space: int, size: str, fragment_length: int,
           timeout: float, data: int | None = None,
           check_halo: bool = False) -> None:
    """One process of the harness: a global ``data`` (default: ``world``)
    x ``space`` mesh of ``data * space / world`` devices a process, the
    frames of the rows this process holds positions in encoded on its
    positions, the stream (and the fragment-streamed one) written by
    process 0, then the multi-process decode of the fragmented stream (on
    this process's devices); with ``check_halo``, ``halo_check``."""
    init_distributed(address, world, rank, timeout)
    try:
        data = world if data is None else data
        n_local = data * space // world
        mesh = make_global_mesh(data=data, space=space,
                                devices=[device] * n_local)
        cfg = harness_config(size)
        pictures = harness_frames(cfg, data)
        local = [pictures[d] for d in local_rows(mesh)]
        enc = MultiHostEncoder(cfg, mesh)
        encoded = enc.encode_local_batch(local)
        if rank == 0:
            with open(out, "wb") as f:
                f.write(harness_stream(cfg, encoded))
        buf = io.BytesIO()
        w = StreamWriter(buf)
        w.fragment_length = fragment_length
        w.start_sequence()
        w.write_sequence_header(harness_header(cfg))
        geo = enc.enc.geo
        pre = harness_preamble(cfg, (geo.y_slices, geo.x_slices))
        qs = enc.stream_fragments(local, w, list(range(data)), pre)
        if rank == 0:
            w.end_sequence()
            with open(out + ".frag", "wb") as f:
                f.write(buf.getvalue())
        elif qs is not None:
            raise RuntimeError("stream_fragments returned q indices off "
                               "process 0")
        _hdr, items = collect_hq_payloads(
            harness_stream(cfg, encoded, fragment_length))
        g = cfg.geometry
        dec = MultiHostDecoder(cfg.kernel, cfg.wavelet_depth, geo,
                               devices=[device] * n_local)
        frames = dec.decode_pictures(
            [(p, pl) for p, _pre, pl in items], cfg.slice_prefix,
            cfg.slice_scalar, (g.luma_height, g.luma_width),
            (g.chroma_height, g.chroma_width))
        if rank == 0:
            with open(out + ".dec", "wb") as f:
                for planes in frames:
                    f.write(format_planes([torch.from_numpy(p) for p in
                                           planes], g,
                                          cfg.luma_depth).numpy().tobytes())
        if check_halo and rank in mesh.owners[0]:
            halo_check(mesh, f"{out}.halo{rank}.npz")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out: str, world: int = 2, device: str | None = None,
           space: int = 1, size: str = "tiny", fragment_length: int = 256,
           timeout: float = 110.0, data: int | None = None,
           check_halo: bool = False) -> list:
    """Run the harness (``worker``) in ``world`` processes on 127.0.0.1,
    each with its own ``timeout`` (the process group's too), every process
    on ``device`` (None: the card; RuntimeError without one). Returns each
    process's output; raises RuntimeError if any process failed or timed
    out (the others are then killed)."""
    if device is None:
        device = str(devices.resolve(None))
    port = free_port()
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vc2tpu_torch.shard.multihost", "--worker",
         "--address", f"127.0.0.1:{port}", "--world", str(world), "--rank",
         str(r), "--device", device, "--space", str(space), "--size", size,
         "--fragment-length", str(fragment_length), "--timeout",
         str(timeout), out]
        + ([] if data is None else ["--data", str(data)])
        + (["--halo-check"] if check_halo else []), env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    outputs, failed = [], []
    deadline = time.monotonic() + timeout
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                                1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            failed.append(f"process {r} timed out")
        text = text.decode(errors="replace")
        outputs.append(text)
        if p.returncode != 0:
            failed.append(f"process {r} exited {p.returncode}: "
                          f"{text[-2000:]}")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if failed:
        raise RuntimeError("; ".join(failed))
    return outputs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="vc2tpu-torch-multihost",
        description="The multi-process encode/decode harness over gloo")
    p.add_argument("out")
    p.add_argument("--worker", action="store_true",
                   help="run one process (launch starts these)")
    p.add_argument("--address", default=None)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of every process (default: cuda)")
    p.add_argument("--data", type=int, default=None,
                   help="rows of the global mesh (default: --world)")
    p.add_argument("--space", type=int, default=1,
                   help="bands a row of the global mesh")
    p.add_argument("--size", choices=["tiny", "1080p", "8k"], default="tiny")
    p.add_argument("--fragment-length", type=int, default=256)
    p.add_argument("--timeout", type=float, default=110.0)
    p.add_argument("--halo-check", action="store_true",
                   help="also lift seeded planes over the first row's bands "
                        "and write each process's to OUT.halo<rank>.npz")
    a = p.parse_args(argv)
    if a.device is None:
        a.device = str(devices.resolve(None))
    if a.worker:
        worker(a.address, a.world, a.rank, a.out, a.device, a.space, a.size,
               a.fragment_length, a.timeout, a.data, a.halo_check)
        print(f"worker {a.rank} done", flush=True)
        return 0
    for text in launch(a.out, a.world, a.device, a.space, a.size,
                       a.fragment_length, a.timeout, a.data, a.halo_check):
        print(text, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
