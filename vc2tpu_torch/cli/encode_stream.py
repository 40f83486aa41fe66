"""EncodeStream-compatible CLI: planar file -> VC-2 stream (HQ ConstQ, HQ
CBR or LD), on the card.

The flag surface mirrors the reference's (src/EncodeStream/
EncodeParams.cpp:80-107), with the seven outputs (Transform / Quantised /
Indices / Packaged / Stream / Decoded / PSNR, EncodeStream.cpp:486-767).
Each picture is encoded on the device by ``pipeline.encoder.Encoder``
(HQ) or ``pipeline.ld.LDEncoder`` (LD); interlaced input encodes each
field as a picture of half the height (and, for LD, half the bytes). HQ
CBR and LD with ``-F`` write each picture as a series of fragments. HQ
Stream output keeps one picture in flight (``Encoder.encode_picture_async``):
picture k is written after picture k + 1 has been read and dispatched, so
an error in picture k surfaces then, with the pictures before it written.

``--mesh DxS`` (Stream output only) encodes HQ over a D x S device mesh
(``pipeline.sharded.ShardedEncoder``: pictures in batches of D over the
``data`` axis, row bands over ``space``, each band's block of slice rows
through the band form of the forward DWT, one ``band_forward`` launch a
level; with ``-F`` each band's span is framed as it lands), and LD with
its analysis DWT over the bands (``LDEncoder(mesh=...)``, the in-place
halo lift); the bytes equal one device's. With ``--device
cpu`` the mesh is the CPU mesh. A program may instead set ``args.mesh``
to a ``shard.mesh.Mesh`` before ``run(args)``; ``make_mesh(1, 3,
devices=["cuda:0"] * 3)`` runs the bands on one card. Unlike the JAX
package's CLI, which fails on it, LD with ``--mesh`` and ``-F`` writes
fragments.

    python -m vc2tpu_torch.cli.encode_stream -x 64 -y 32 -f 4:2:2 -l 10 \\
        -k LeGall -d 2 -u 1 -a 2 -m HQ_ConstQ -q 20 in.16p2 out.vc2
    python -m vc2tpu_torch.cli.encode_stream -x 64 -y 32 -f 4:2:2 -l 10 \\
        -k LeGall -d 2 -u 1 -a 2 -m HQ_CBR -S 1 -s 2048 -F 512 in.16p2 out.vc2
    python -m vc2tpu_torch.cli.encode_stream -x 64 -y 32 -f 4:2:2 -l 10 \\
        -k LeGall -d 2 -u 1 -a 2 -m LD -s 2048 in.16p2 out.vc2
    python -m vc2tpu_torch.cli.encode_stream --device cpu --mesh 2x4 \
        -x 64 -y 64 -f 4:2:2 -l 10 -k LeGall -d 2 -u 1 -a 2 -m HQ_CBR \
        -s 2048 in.16p2 out.vc2
"""

from __future__ import annotations

import argparse
import math
import sys
from collections import deque

import numpy as np

from vc2tpu_torch.core import intmath
from vc2tpu_torch.core.config import (ColourFormat, EncOutput, EncoderConfig,
                                      FrameRate, Mode, PictureGeometry,
                                      Profile, WaveletKernel)
from vc2tpu_torch.core.picture import interleave_fields, signal_clip
from vc2tpu_torch.core.planario import (PlanarReader, SampleFormat,
                                        write_picture)
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.ld import LDEncoder
from vc2tpu_torch.pipeline.sharded import ShardedEncoder
from vc2tpu_torch.shard.mesh import from_spec
from vc2tpu_torch.stream.dataunit import PicturePreamble, StreamWriter
from vc2tpu_torch.stream.headers import SequenceHeader
from vc2tpu_torch.wavelet import matrices


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vc2tpu-torch-encode",
        description="Encodes an uncompressed planar video file to a VC-2 "
                    "stream on a CUDA device")
    p.add_argument("inFile")
    p.add_argument("outFile")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-m", "--mode", required=True,
                   choices=[m.value for m in Mode])
    p.add_argument("-o", "--output", default="Stream",
                   choices=[o.value for o in EncOutput])
    p.add_argument("-a", "--hSlice", type=int, required=True)
    p.add_argument("-u", "--vSlice", type=int, required=True)
    p.add_argument("-d", "--waveletDepth", type=int, required=True)
    p.add_argument("-k", "--kernel", required=True,
                   choices=[k.name for k in WaveletKernel])
    p.add_argument("-b", "--bottomFieldFirst", action="store_true")
    p.add_argument("-t", "--topFieldFirst", action="store_true")
    p.add_argument("-i", "--interlace", action="store_true")
    p.add_argument("-p", "--progressive", action="store_true")
    p.add_argument("-c", "--chromaDepth", type=int, default=None)
    p.add_argument("-l", "--lumaDepth", type=int, default=None)
    p.add_argument("-z", "--bitDepth", type=int, default=None)
    p.add_argument("-n", "--bytes", type=int, default=2)
    p.add_argument("-f", "--format", required=True,
                   choices=["4:4:4", "4:2:2", "4:2:0"])
    p.add_argument("-x", "--width", type=int, required=True)
    p.add_argument("-y", "--height", type=int, required=True)
    p.add_argument("-r", "--framerate", type=int, default=3)
    p.add_argument("-S", "--scalar", type=int, default=None)
    p.add_argument("-P", "--prefix", type=int, default=None)
    p.add_argument("-F", "--fragmentLength", type=int, default=None)
    p.add_argument("-s", "--compressedBytes", type=int, default=None)
    p.add_argument("-q", "--quantIndex", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (default: cuda)")
    p.add_argument("--mesh", metavar="DxS", default=None,
                   help="encode on a DxS device mesh (frames x row bands; "
                        "Stream output only): the HQ modes' whole encode a "
                        "band, LD's analysis DWT; bytes equal one device's")
    return p


def config_from_args(args) -> EncoderConfig:
    """Cross-flag validation matrix of the reference CLI
    (src/EncodeStream/EncodeParams.cpp:139-204)."""
    mode = Mode(args.mode)
    hq = mode in (Mode.HQ_CBR, Mode.HQ_ConstQ)
    rate = mode in (Mode.HQ_CBR, Mode.LD)
    if args.bitDepth is not None and (args.lumaDepth is not None
                                      or args.chromaDepth is not None):
        raise ValueError("bitDepth is incompatible with luma depth (and/or "
                         "chroma depth): use one or the other")
    if args.progressive and args.interlace:
        raise ValueError("image can't be both interlaced and progressive: "
                         "specify one or the other")
    if args.progressive and (args.topFieldFirst or args.bottomFieldFirst):
        raise ValueError("field parity is incompatible with progressive "
                         "image")
    if args.topFieldFirst and args.bottomFieldFirst:
        raise ValueError("image can't be both top field first and bottom "
                         "field first: specify one or the other")
    if not hq and args.scalar is not None:
        raise ValueError("Slice Scalar is only used in HQ_CBR and HQ_ConstQ "
                         "modes")
    if not hq and args.prefix is not None:
        raise ValueError("Slice Prefix is only used in HQ_CBR and HQ_ConstQ "
                         "modes")
    if not rate and args.fragmentLength is not None:
        raise ValueError("Fragment length is only used in HQ_CBR and LD "
                         "modes")
    if not rate and args.compressedBytes is not None:
        raise ValueError("Compressed bytes is only used in HQ_CBR and LD "
                         "modes")
    if mode != Mode.HQ_ConstQ and args.quantIndex is not None:
        raise ValueError("Quantisation index is only used in HQ_ConstQ mode")
    if rate and args.compressedBytes is None:
        raise ValueError("Compressed bytes must be set in HQ_CBR and LD "
                         "modes")
    if mode == Mode.HQ_ConstQ and args.quantIndex is None:
        raise ValueError("Quantisation index must be set in HQ_ConstQ mode")

    # None-aware (not falsy): an explicit 0 must reach the range check, as
    # the reference CLI's isSet() handling does (EncodeParams.cpp:166-170)
    bit_depth = 8 * args.bytes if args.bitDepth is None else args.bitDepth
    luma_depth = bit_depth if args.lumaDepth is None else args.lumaDepth
    chroma_depth = luma_depth if args.chromaDepth is None else args.chromaDepth
    return EncoderConfig(
        height=args.height, width=args.width,
        chroma_format=ColourFormat.parse(args.format),
        kernel=WaveletKernel.parse(args.kernel),
        wavelet_depth=args.waveletDepth,
        y_size=args.vSlice, x_size=args.hSlice,
        mode=mode, bytes_per_sample=args.bytes,
        luma_depth=luma_depth, chroma_depth=chroma_depth,
        interlaced=args.interlace, top_field_first=not args.bottomFieldFirst,
        frame_rate=FrameRate(args.framerate),
        slice_scalar=1 if args.scalar is None else args.scalar,
        slice_prefix=0 if args.prefix is None else args.prefix,
        fragment_length=args.fragmentLength or 0,
        compressed_bytes=args.compressedBytes or 0,
        q_index=args.quantIndex or 0,
    )


def _psnr(orig: np.ndarray, dec: np.ndarray, depth: int, pixels: int) -> float:
    # the reference squares per-pixel differences in 32-bit int
    # (std::multiplies<int>, EncodeStream.cpp:710-713; wraps for
    # |diff| > 46340) and accumulates in long long; match both exactly
    d = (orig.astype(np.int64) - dec.astype(np.int64)).astype(np.int32)
    ss = int((d * d).astype(np.int64).sum())
    if ss < 0:                   # wrapped squares can sum negative; the
        return float("nan")      # reference's sqrt(negative) prints nan
    rms = math.sqrt(ss / float(pixels)) / (1 << depth)
    return -20.0 * math.log10(rms) if rms > 0 else float("inf")


def _q_stats(q_indices) -> tuple[float, float]:
    """Mean and variance of the quantiser indices."""
    qi = np.concatenate(q_indices).astype(np.float64)
    mean = float(qi.mean())
    return mean, float((qi * qi).mean() - mean * mean)


def _narrate(args, cfg: EncoderConfig, output: EncOutput, geo,
             picture_bytes: int) -> None:
    """The reference's -v parameter dump (EncodeStream.cpp:284-293,
    349-365, 408-429)."""
    g = cfg.geometry
    lines = ["", " ".join(sys.argv), f"input file = {args.inFile}",
             f"output file = {args.outFile}", f"mode= {cfg.mode.value}",
             f"bytes per sample= {cfg.bytes_per_sample}",
             f"luma depth (bits) = {cfg.luma_depth}",
             f"chroma depth (bits) = {cfg.chroma_depth}",
             f"height = {g.luma_height}", f"width = {g.luma_width}",
             f"chroma format = {args.format}",
             f"interlaced = {str(cfg.interlaced).lower()}"]
    if cfg.interlaced:
        lines.append(f"top field first = {str(cfg.top_field_first).lower()}")
    qm = matrices.quant_matrix(cfg.kernel, cfg.wavelet_depth)
    lines += [f"wavelet kernel = {cfg.kernel.name}",
              f"wavelet depth = {cfg.wavelet_depth}",
              "vertical slice size (in units of 2**(wavelet depth)) = "
              f"{cfg.y_size}",
              "horizontal slice size (in units of 2**(wavelet depth)) = "
              f"{cfg.x_size}",
              f"compressed bytes = {cfg.compressed_bytes}",
              f"output = {output.value}",
              f"Vertical slices per picture          = {geo.y_slices}",
              f"Horizontal slices per picture        = {geo.x_slices}"]
    if cfg.mode == Mode.HQ_CBR:
        num, den = intmath.rationalise(picture_bytes, geo.n_slices)
        lines += [f"Slice bytes numerator                = {num}",
                  f"Slice bytes denominator              = {den}"]
    lines.append("Quantisation matrix = "
                 + ", ".join(str(int(v)) for v in qm))
    print("\n".join(lines), file=sys.stderr)


class _MeshStream:
    """The HQ stream behind ``--mesh``: pictures gather into batches of
    the mesh's ``data`` extent (the last padded with copies of its last
    picture, whose results are dropped), each batch encoded by one
    ``ShardedEncoder.encode_batch`` and written in order, or with
    fragments streamed a band's span at a time."""

    def __init__(self, cfg: EncoderConfig, mesh, device):
        self.impl = ShardedEncoder(cfg, from_spec(mesh, device))
        self.geo = self.impl.geo
        self.data = self.impl.data
        self.batch = []             # [(picture number, Picture)]
        self.q_log = []             # each written picture's q indices

    def submit(self, writer, preamble, picture_number, picture):
        self.batch.append((picture_number, picture))
        if len(self.batch) == self.data:
            self.flush(writer, preamble)

    def flush(self, writer, preamble):
        if not self.batch:
            return
        nums = [n for n, _p in self.batch]
        pics = [p for _n, p in self.batch]
        pics += [pics[-1]] * (self.data - len(pics))
        self.batch = []
        if writer.fragment_length:
            self.q_log += [q.ravel() for q in
                           self.impl.encode_batch_to_fragments(
                               pics, writer, nums, preamble)]
            return
        for num, enc in zip(nums, self.impl.encode_batch(pics)):
            writer.write_picture(num, preamble, enc.payload,
                                 slice_sizes=enc.slice_totals)
            self.q_log.append(enc.q_indices.ravel())


def run(args) -> int:
    cfg = config_from_args(args)
    output = EncOutput(args.output)
    verbose = args.verbose
    geometry = cfg.geometry
    luma_fmt = SampleFormat(word_width=cfg.bytes_per_sample,
                            bit_depth=cfg.luma_depth)
    chroma_fmt = SampleFormat(word_width=cfg.bytes_per_sample,
                              bit_depth=cfg.chroma_depth)
    sig_fmt = SampleFormat(word_width=4, offset=False)
    ld = cfg.mode == Mode.LD
    mesh = None
    if args.mesh and output != EncOutput.STREAM:
        raise ValueError("--mesh supports Stream output only")
    if args.mesh and not ld:
        encoder = mesh = _MeshStream(cfg, args.mesh, args.device)
    elif ld:
        encoder = LDEncoder(cfg, device=args.device, mesh=args.mesh)
    else:
        encoder = Encoder(cfg, device=args.device)
    geo = encoder.geo

    infile = sys.stdin.buffer if args.inFile == "-" else open(args.inFile, "rb")
    outfile = (sys.stdout.buffer if args.outFile == "-"
               else open(args.outFile, "wb"))
    reader = PlanarReader(infile, geometry, luma_fmt, chroma_fmt)
    frame_pics = 2 if cfg.interlaced else 1
    picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                     else cfg.compressed_bytes)
    if verbose:
        _narrate(args, cfg, output, geo, picture_bytes)

    writer = StreamWriter(outfile)
    writer.fragment_length = (cfg.fragment_length
                              if cfg.mode in (Mode.HQ_CBR, Mode.LD) else 0)
    if output == EncOutput.STREAM:
        if verbose:
            print("\nWriting Sequence Header\n", file=sys.stderr)
        writer.start_sequence()
        writer.write_sequence_header(SequenceHeader(
            profile=Profile.PROFILE_LD if ld else Profile.PROFILE_HQ,
            height=geometry.luma_height,
            width=geometry.luma_width, chroma_format=cfg.chroma_format,
            interlace=cfg.interlaced, frame_rate=cfg.frame_rate,
            top_field_first=cfg.top_field_first, bitdepth=cfg.luma_depth))
    keep_planes = output in (EncOutput.TRANSFORM, EncOutput.QUANTISED,
                             EncOutput.DECODED, EncOutput.PSNR)
    preamble = PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=geo.x_slices, slices_y=geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)
    if ld:
        (preamble.slice_bytes_numerator,
         preamble.slice_bytes_denominator) = intmath.rationalise(
            picture_bytes, geo.n_slices)
    all_q_indices = []          # quantiser index stats (EncodeStream.cpp:676)
    # the q indices come back from the device only for what shows them
    keep_q = verbose or output == EncOutput.PSNR
    # Stream output: one picture in flight, so the next picture's read and
    # dispatch overlap the previous picture's device work and fetch (the
    # JAX package's one-picture software pipeline); an error in a picture
    # surfaces when the next one has been dispatched
    can_pipeline = (output == EncOutput.STREAM and not keep_planes
                    and hasattr(encoder, "encode_picture_async"))
    pending = deque()           # FIFO of (picture number, handle)
    pipe_depth = 1

    def flush_one():
        number, handle = pending.popleft()
        enc = handle()
        if keep_q:
            all_q_indices.append(enc.q_indices.ravel())
        writer.write_picture(number, preamble, enc.payload,
                             slice_sizes=enc.slice_totals)

    frame = 0
    while True:
        in_frame = reader.read_frame()
        if in_frame is None:
            if frame == 0:
                print("Failed to read input frame number 0", file=sys.stderr)
                return 1
            break
        if verbose:
            print(f"Reading input frame number {frame}\nForward transform",
                  file=sys.stderr)
            if cfg.mode in (Mode.HQ_CBR, Mode.LD):
                print("Determine quantisation indices", file=sys.stderr)
            print("Quantise transform coefficients\n"
                  "Split quantised coefficients into slices",
                  file=sys.stderr)
            if output == EncOutput.STREAM:
                print("Writing compressed output to file", file=sys.stderr)
        decoded_fields, frame_q_indices = [], []
        for pic_i in range(frame_pics):
            picture = in_frame
            if cfg.interlaced:
                picture = (in_frame.first_field(cfg.top_field_first)
                           if pic_i == 0
                           else in_frame.second_field(cfg.top_field_first))
            number = intmath.picture_number(pic_i, frame, frame_pics)
            if mesh is not None:
                mesh.submit(writer, preamble, number, picture)
                continue
            if can_pipeline:
                pending.append((number, encoder.encode_picture_async(picture)))
                while len(pending) > pipe_depth:
                    flush_one()
                continue
            enc = encoder.encode_picture(picture, keep_planes=keep_planes)
            if keep_q:
                frame_q_indices.append(enc.q_indices.ravel())
            if output == EncOutput.TRANSFORM:
                write_picture(outfile, enc.transform, sig_fmt)
            elif output == EncOutput.QUANTISED:
                write_picture(outfile, enc.quantised, sig_fmt)
            elif output == EncOutput.INDICES:
                outfile.write(enc.q_indices.astype(np.uint8).tobytes())
            elif output == EncOutput.PACKAGED:
                outfile.write(enc.payload)
            elif output == EncOutput.STREAM:
                writer.write_picture(number, preamble, enc.payload,
                                     slice_sizes=enc.slice_totals, hq=not ld)
            else:                                   # DECODED / PSNR
                pic_geom = PictureGeometry.of(
                    geometry.luma_height // frame_pics, geometry.luma_width,
                    cfg.chroma_format)
                dec = encoder.decode_inprocess(enc, pic_geom)
                decoded_fields.append(signal_clip(dec, cfg.luma_depth,
                                                  cfg.chroma_depth))
        if output in (EncOutput.DECODED, EncOutput.PSNR):
            out_frame = (interleave_fields(*decoded_fields,
                                           cfg.top_field_first)
                         if cfg.interlaced else decoded_fields[0])
            cpix = geometry.chroma_width * geometry.chroma_height
            ypsnr = _psnr(in_frame.y, out_frame.y, cfg.luma_depth,
                          cfg.width * cfg.height)
            upsnr = _psnr(in_frame.c1, out_frame.c1, cfg.chroma_depth, cpix)
            vpsnr = _psnr(in_frame.c2, out_frame.c2, cfg.chroma_depth, cpix)
            if output == EncOutput.DECODED:
                write_picture(outfile, out_frame, luma_fmt, chroma_fmt)
            else:
                mean, var = _q_stats(frame_q_indices)
                outfile.write(f"Frame {frame}\n{mean:.2f} {np.sqrt(var):.2f}\n"
                              f"{ypsnr:.4f} {upsnr:.4f} {vpsnr:.4f}\n"
                              .encode())
            if verbose:
                print(f"PSNR for Y/R, U/G, V/B = {ypsnr:.4f}, {upsnr:.4f}, "
                      f"{vpsnr:.4f}", file=sys.stderr)
                if output == EncOutput.DECODED:
                    print(f"Writing decoded output frame {frame}",
                          file=sys.stderr)
        all_q_indices.extend(frame_q_indices)
        frame += 1
    while pending:
        flush_one()
    if mesh is not None:
        mesh.flush(writer, preamble)
        all_q_indices.extend(mesh.q_log)
    if verbose:
        print(f"\rEnd of input reached after {frame} frames", file=sys.stderr)
        if output != EncOutput.TRANSFORM:
            mean, var = _q_stats(all_q_indices)
            print(f"\nMean, Standard Deviation of quantiser index = "
                  f"{mean:.2f}, {math.sqrt(max(var, 0.0)):.2f}",
                  file=sys.stderr)
    if output == EncOutput.STREAM:
        writer.end_sequence()
    if args.inFile != "-":
        infile.close()
    if args.outFile != "-":
        outfile.close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as exc:  # the reference's catch-all (EncodeStream.cpp:782)
        print(f"Error: {exc}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
