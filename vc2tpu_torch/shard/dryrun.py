"""The multi-device dry run: the sharded paths certified on a device list.

Twin of the JAX package's ``dryrun_multichip``. On an n-device mesh
(2 x n/2 when n is even and at least 4, else 1 x n):

1. ``ShardedEncoder`` of tiny HQ CBR frames: q indices and payloads equal
   the single-device ``Encoder``'s, and so do the streams, whole and in
   fragments;
2. ``ShardedDecoder.decode_payload`` equals the single-device decode;
3. ``Decoder(mesh=)`` decodes both streams byte-identically;
4. the in-place halo inverse lift undoes the unsharded forward (the LD
   mesh synthesis where slice rows do not divide over the mesh);
5. unless ``fast``: 1080p HQ CBR over a (n/2) x 2 mesh, encode and the
   fragmented stream's mesh decode against one device.

Each leg prints the per-band balance: slices, payload bytes and the bytes
each band's unpack reads (its block's slices: its own and the margin
slices of its neighbours).

    python -m vc2tpu_torch.shard.dryrun --device cpu --count 8
    python -m vc2tpu_torch.shard.dryrun --device cuda:0 --count 4 --fast

``--device cpu`` puts the CPU in every position, ``cuda`` takes the first
``count`` visible cards, ``cuda:K`` repeats card K ``count`` times.
"""

from __future__ import annotations

import argparse
import io
import sys
import time

import numpy as np
import torch

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                      Mode, WaveletKernel)
from vc2tpu_torch.pipeline import decoder as pipe
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.sharded import ShardedDecoder, ShardedEncoder
from vc2tpu_torch.shard import halo, multihost
from vc2tpu_torch.shard.mesh import make_mesh
from vc2tpu_torch.slices.hq import scan_hq_slice_offsets
from vc2tpu_torch.wavelet import lifting


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def balance_lines(label: str, senc: ShardedEncoder, sdec=None) -> list:
    """Lines of the per-band balance of the last batch: each band's slices
    and payload bytes (the first picture), and the bytes its unpack read
    in ``sdec``'s last decode, which include the margin slices of its
    block (``halo.band_blocks``)."""
    pay = senc.balance[0]
    lines = [f"{label} balance: {senc.n_loc} slices a band; payload bytes "
             f"a band {pay} (max/mean "
             f"{max(pay) / (sum(pay) / len(pay)):.4f})"]
    if sdec is not None and sdec.spans:
        lines.append(f"{label} balance: unpack bytes a band {sdec.spans}")
    return lines


def _cbr_config(H: int, W: int, scalar: int, nbytes: int,
                rate=FrameRate.FR25) -> EncoderConfig:
    return EncoderConfig(height=H, width=W, chroma_format=ColourFormat.CF422,
                         kernel=WaveletKernel.LeGall, wavelet_depth=2,
                         y_size=1, x_size=2, mode=Mode.HQ_CBR,
                         luma_depth=10, chroma_depth=10, frame_rate=rate,
                         compressed_bytes=nbytes, slice_scalar=scalar)


def _decode(stream: bytes, **kw) -> tuple:
    sink = io.BytesIO()
    dec = Decoder(sink=sink, **kw)
    _check(dec.run(stream) == 0, "decode failed")
    return sink.getvalue(), dec


def dryrun_multichip(devices, fast: bool = False, out=print) -> None:
    """Run the dry run on ``devices`` (torch devices, repeats allowed);
    raises AssertionError at the first difference."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    data = 2 if n % 2 == 0 and n >= 4 else 1
    space = n // data
    mesh = make_mesh(data, space, devices=devices)
    first = devices[0]
    H, W = max(space * 16, 32), 64
    cfg = _cbr_config(H, W, 1, H * W // 2)
    pics = multihost.harness_frames(cfg, data, seed=0)

    # 1. the sharded encode to stream bytes
    senc = ShardedEncoder(cfg, mesh)
    got = senc.encode_batch(pics)
    enc = Encoder(cfg, device=first)
    want = [enc.encode_picture(p) for p in pics]
    for g, w in zip(got, want):
        _check(np.array_equal(g.q_indices, w.q_indices),
               "sharded CBR decisions differ from one device's")
        _check(g.payload == w.payload,
               "sharded payload differs from one device's")
    for frag in (0, 512):
        _check(multihost.harness_stream(cfg, got, frag)
               == multihost.harness_stream(cfg, want, frag),
               f"sharded stream differs (fragment length {frag})")

    # 2. the sharded decode against the single-device one
    geo = senc.geo
    payload = np.frombuffer(got[0].payload, np.uint8)
    sdec = ShardedDecoder(cfg.kernel, cfg.wavelet_depth, geo, mesh)
    planes = sdec.decode_payload(payload, cfg.slice_prefix, cfg.slice_scalar)
    q, _ds, cbytes, _end = scan_hq_slice_offsets(
        payload, geo.n_slices, cfg.slice_prefix, cfg.slice_scalar)
    lanes, q_t = pipe.unpack_payload(payload, q, cbytes, geo,
                                     cfg.slice_prefix, device=first)
    ref = lifting.inverse_planes(
        pipe.dequantise_planes(lanes, q_t, enc.qmatrix, cfg.wavelet_depth,
                               geo), cfg.kernel, cfg.wavelet_depth)
    for a, b in zip(planes, ref):
        _check(torch.equal(a.to(first), b),
               "sharded decode differs from one device's")

    # 3. the mesh stream decode, whole pictures and fragments
    for frag in (0, 512):
        s = multihost.harness_stream(cfg, got, frag)
        want_out, _ = _decode(s, device=first)
        got_out, dec = _decode(s, mesh=mesh)
        _check(got_out == want_out and dec.frames_out == data,
               f"mesh stream decode differs (fragment length {frag})")

    # 4. the indivisible LD mesh synthesis: the in-place halo inverse of a
    # forward transform
    rng = np.random.default_rng(0)
    plane = torch.from_numpy(rng.integers(-512, 512, (H, W)).astype(np.int32))
    t = lifting.forward_plane(plane.to(first), cfg.kernel, cfg.wavelet_depth)
    back = halo.sharded_inverse_plane(t, mesh, cfg.kernel, cfg.wavelet_depth)
    _check(torch.equal(back.cpu(), plane),
           "the halo inverse does not undo the forward")
    qs = np.concatenate([g.q_indices.ravel() for g in got])
    out(f"dryrun_multichip OK: mesh {data}x{space} on "
        f"{[str(d) for d in devices]}, {H}x{W}, {geo.n_slices} slices, "
        f"stream {len(multihost.harness_stream(cfg, got))} B equal (whole "
        "and fragmented), sharded decode and mesh stream decode equal, the "
        f"halo inverse round trip exact, q range [{int(qs.min())},"
        f"{int(qs.max())}]")
    for line in balance_lines("tiny", senc, sdec):
        out(line)
    if fast or n < 2:
        return

    # 5. 1080p HQ CBR: 270 slice rows over 2 bands, frames over the rest
    t0 = time.perf_counter()
    space_p, data_p = 2, n // 2
    mesh_p = make_mesh(data_p, space_p, devices=devices[:2 * data_p])
    cfg_p = _cbr_config(1080, 1920, 2, 829440, FrameRate.FR50)
    pics_p = multihost.harness_frames(cfg_p, data_p, seed=1)
    senc_p = ShardedEncoder(cfg_p, mesh_p)
    got_p = senc_p.encode_batch(pics_p)
    enc_p = Encoder(cfg_p, device=first)
    for i, (g, p) in enumerate(zip(got_p, pics_p)):
        w = enc_p.encode_picture(p)
        _check(np.array_equal(g.q_indices, w.q_indices)
               and g.payload == w.payload,
               f"1080p sharded encode differs (frame {i})")
    s_frag = multihost.harness_stream(cfg_p, got_p, 4096)
    want_out, _ = _decode(s_frag, device=first)
    got_out, dec = _decode(s_frag, mesh=mesh_p)
    _check(got_out == want_out, "1080p mesh fragmented decode differs")
    sdec_p = dec.sharded_decoders()[0]
    out(f"dryrun_multichip 1080p OK: mesh {data_p}x{space_p}, "
        f"{senc_p.geo.n_slices} slices, {data_p} frames, stream "
        f"{len(s_frag)} B fragmented, encode equal, mesh stream decode "
        f"equal ({time.perf_counter() - t0:.1f} s)")
    for line in balance_lines("1080p", senc_p, sdec_p):
        out(line)


def devices_for(device: str, count: int) -> list:
    """The dry run's device list (see the module's docstring)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * count
    if dev.index is not None:
        return [dev] * count
    if torch.cuda.device_count() < count:
        raise ValueError(f"{count} cards asked, "
                         f"{torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(count)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vc2tpu-torch-dryrun",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--count", type=int, default=None,
                   help="mesh positions (default: the visible cards, or 8 "
                        "on the CPU)")
    p.add_argument("--fast", action="store_true",
                   help="the tiny legs only")
    a = p.parse_args(argv)
    count = a.count or (8 if a.device == "cpu"
                        else max(torch.cuda.device_count(), 1))
    dryrun_multichip(devices_for(a.device, count), a.fast)
    return 0


if __name__ == "__main__":
    sys.exit(main())
