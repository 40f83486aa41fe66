"""Multi-process orchestration: the process group, the global mesh, the
frame axis across processes, process-0 stream assembly and the
throughput harness.

Port of ``vc2tpu.shard.multihost``. Processes split the ``data`` axis:
each owns whole rows of the global mesh and encodes its own frames on
them with the sharded pipeline (``pipeline.sharded``); the ``space`` bands
of a row, and so the halo exchange, stay within one process. What crosses
processes is host bytes: each band's q indices, slice sizes and payload
span, gathered with ``torch.distributed`` on the gloo backend (sizes first,
then padded uint8 tensors), so every process assembles the same stream
and process 0 writes it. Gloo runs on any machine, also for processes that
share one card (NCCL cannot put two ranks on one card).

A ``space`` row that would span processes raises ValueError: the halo
exchange over ``torch.distributed`` point-to-point is not ported.

    python -m vc2tpu_torch.shard.multihost --world 2 --device cpu OUT

runs the two-process harness (``launch``): both processes encode their
frame of a deterministic batch, process 0 writes the stream (OUT), the
fragment-streamed stream (OUT.frag) and the multi-process decode of the
fragments (OUT.dec, the decoder's DECODED bytes).
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
    """The mesh over every process's devices: ``data`` (frames, one block
    of rows a process, in process order) x ``space`` (row bands, within a
    process). A process's devices are ``devices``, else the visible cards
    (``device`` a card or None) or the CPU in every position (``device=
    "cpu"``). Defaults: a row a process, a band a local device (1 on the
    CPU). ``mesh.processes[d]`` is the owner of row d; only the owner's
    devices are real."""
    world = dist.get_world_size()
    local = ([torch.device(d) for d in devices] if devices is not None
             else devices_of(device))
    data = world if data is None else data
    if space is None:
        space = len(local) * world // data if local else 1
    if local is not None and data * space != world * len(local):
        raise ValueError(f"mesh {data}x{space} != {world * len(local)} "
                         "devices")
    if data % world or (local is not None and space > len(local)):
        raise ValueError(f"mesh {data}x{space}: a space row would span "
                         f"processes ({world} processes); the halo exchange "
                         "runs within one process")
    rows = data // world
    if local is None:
        local = [torch.device("cpu")] * (rows * space)
    grid = [local[(d % rows) * space:(d % rows + 1) * space]
            for d in range(data)]
    return Mesh(grid, processes=[d // rows for d in range(data)])


def local_mesh(mesh: Mesh, rank: int | None = None) -> Mesh:
    """The rows of ``mesh`` that process ``rank`` (default: this one)
    owns."""
    rank = dist.get_rank() if rank is None else rank
    return Mesh([r for r, p in zip(mesh.devices, mesh.processes)
                 if p == rank])


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
    """[picture][band] (q int32 [n], totals int32 [n], payload bytes) as one
    blob: the counts, then each band's n and payload size, its arrays and
    its payload."""
    out = [np.array([len(bands), len(bands[0]) if bands else 0],
                    np.int64).tobytes()]
    for row in bands:
        for q, totals, payload in row:
            out += [np.array([q.size, len(payload)], np.int64).tobytes(),
                    q.astype(np.int32).tobytes(),
                    totals.astype(np.int32).tobytes(), payload]
    return b"".join(out)


def _unpack_bands(blob: bytes) -> list:
    n_pic, n_band = np.frombuffer(blob, np.int64, 2, 0)
    at, out = 16, []
    for _ in range(int(n_pic)):
        row = []
        for _ in range(int(n_band)):
            n, size = (int(v) for v in np.frombuffer(blob, np.int64, 2, at))
            at += 16
            q = np.frombuffer(blob, np.int32, n, at)
            totals = np.frombuffer(blob, np.int32, n, at + 4 * n)
            at += 8 * n
            row.append((q, totals, blob[at:at + size]))
            at += size
        out.append(row)
    return out


class MultiHostEncoder:
    """Frame-parallel multi-process HQ encoder. Every process calls with
    its own frames (its rows' block of the global batch); the bands' bytes
    are gathered so every process holds the global batch's results, in
    data-axis order; process 0 writes the stream."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.enc = ShardedEncoder(cfg, local_mesh(mesh))

    def _gather(self, pictures) -> list:
        """Encode this process's pictures and gather every process's bands:
        [picture][band] (q, totals, payload span), global order."""
        enc = self.enc
        jobs = enc._launch(pictures)
        status = enc._statuses(jobs)
        n = enc.n_loc
        bands = []
        for b, row in enumerate(jobs):
            out = []
            for s, (q, buf, _st) in enumerate(row):
                span = buf[:4 * n + status[b, s][1]].cpu().numpy()
                totals, payload = device_pack.split_result(span, n)
                out.append((q.cpu().numpy(), totals, payload.tobytes()))
            bands.append(out)
        return [row for blob in all_gather_bytes(_pack_bands(bands))
                for row in _unpack_bands(blob)]

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
    package's multi-host test) or ``1080p`` (BASELINE config #1's 4:2:2
    10-bit picture at -u 1 -a 2, 829440 bytes, scalar 2)."""
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


def worker(address: str, world: int, rank: int, out: str, device: str,
           space: int, size: str, fragment_length: int,
           timeout: float) -> None:
    """One process of the harness: a global (world x space) mesh, this
    process's frame of the batch encoded on its row, the stream (and the
    fragment-streamed one) written by process 0, then the multi-process
    decode of the fragmented stream."""
    init_distributed(address, world, rank, timeout)
    try:
        mesh = make_global_mesh(data=world, space=space,
                                devices=[device] * space)
        cfg = harness_config(size)
        local = harness_frames(cfg, world)[rank:rank + 1]
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
        qs = enc.stream_fragments(local, w, list(range(world)), pre)
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
                               devices=[device] * space)
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
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out: str, world: int = 2, device: str | None = None,
           space: int = 1, size: str = "tiny", fragment_length: int = 256,
           timeout: float = 110.0) -> list:
    """Run the harness in ``world`` processes on 127.0.0.1, each with its
    own ``timeout`` (the process group's too), every process on ``device``
    (None: the card; RuntimeError without one). Returns each process's
    output; raises RuntimeError if any process failed or timed out (the
    others are then killed)."""
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
         str(timeout), out], env=env, stdout=subprocess.PIPE,
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
    p.add_argument("--space", type=int, default=1)
    p.add_argument("--size", choices=["tiny", "1080p"], default="tiny")
    p.add_argument("--fragment-length", type=int, default=256)
    p.add_argument("--timeout", type=float, default=110.0)
    a = p.parse_args(argv)
    if a.device is None:
        a.device = str(devices.resolve(None))
    if a.worker:
        worker(a.address, a.world, a.rank, a.out, a.device, a.space, a.size,
               a.fragment_length, a.timeout)
        print(f"worker {a.rank} done", flush=True)
        return 0
    for text in launch(a.out, a.world, a.device, a.space, a.size,
                       a.fragment_length, a.timeout):
        print(text, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
