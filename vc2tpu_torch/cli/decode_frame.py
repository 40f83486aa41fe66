"""DecodeFrame-compatible CLI: headerless slice payloads -> planar file, on
the card.

Port of ``vc2tpu.cli.decode_frame``: decodes raw concatenated slice
payloads (no VC-2 stream syntax) given the geometry, kernel, depth and
slice parameters on the command line, mirroring the reference's frame
decoder (src/DecodeFrame/DecodeFrame.cpp:61-358, flag surface
src/DecodeFrame/DecodeParams.cpp:54-160), plus ``--device`` (default
``cuda``). HQ pictures go through the host chain scan and the HQ unpack
kernel; LD pictures through the LD header scan and the LD unpack kernel
(``slices.ld.decode_ld_slices``); then dequantise, the inverse transform
and, for the Decoded output, the signal clip, all on the device.

It keeps the JAX package's two deliberate deviations from the reference
binary, which follow the reference source instead: (a) with several
frames the Transform and Quantised outputs are right for every picture
(the binary corrupts all after the first: stale iostream state); (b) in
LD mode it reads its encoder's Packaged output (the binary fails: "Failed
to read the first compressed frame"). As the reference source does, LD
dequantises without DC prediction (DecodeFrame.cpp:298), so its output
differs from DecodeStream's predictive decode.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import (ColourFormat, DecOutput,
                                      PictureGeometry, WaveletKernel,
                                      chroma_dims)
from vc2tpu_torch.core.picture import Picture, interleave_fields, signal_clip
from vc2tpu_torch.core.planario import SampleFormat, write_picture
from vc2tpu_torch.pipeline.decoder import dequantise_planes, unpack_payload
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices.hq import SliceGeometry, scan_hq_slice_offsets
from vc2tpu_torch.slices.ld import decode_ld_slices
from vc2tpu_torch.wavelet import lifting, matrices


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vc2tpu-torch-decode-frame",
        description="Decodes headerless VC-2 frames to an uncompressed "
                    "planar file on a CUDA device")
    p.add_argument("inFile")
    p.add_argument("outFile")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-m", "--mode", default="HQ", choices=["HQ", "LD"])
    p.add_argument("-o", "--output", default="Decoded",
                   choices=["Transform", "Quantised", "Indices", "Decoded"])
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
    p.add_argument("-S", "--scalar", type=int, default=1)
    p.add_argument("-P", "--prefix", type=int, default=0)
    p.add_argument("-s", "--compressedBytes", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default: cuda)")
    return p


def run(args) -> int:
    # None-aware, not falsy: an explicit 0 must fail validation, not be
    # silently replaced with the default
    bit_depth = 8 * args.bytes if args.bitDepth is None else args.bitDepth
    luma_depth = bit_depth if args.lumaDepth is None else args.lumaDepth
    chroma_depth = luma_depth if args.chromaDepth is None else args.chromaDepth
    chroma_format = ColourFormat.parse(args.format)
    depth = args.waveletDepth
    interlaced = args.interlace
    hq = args.mode == "HQ"
    device = devices.resolve(args.device)

    pic_h = args.height // 2 if interlaced else args.height
    padded_h = matrices.padded_size(pic_h, depth)
    padded_w = matrices.padded_size(args.width, depth)
    y_tx = args.vSlice << depth
    x_tx = args.hSlice << depth
    if padded_h % y_tx or padded_w % x_tx:
        raise ValueError("Padded picture size is not divisible by slice size")
    ys, xs = padded_h // y_tx, padded_w // x_tx
    pch, pcw = chroma_dims(padded_h, padded_w, chroma_format)
    geo = SliceGeometry(ys, xs, (padded_h, padded_w), (pch, pcw),
                        (padded_h // ys, padded_w // xs),
                        (pch // ys, pcw // xs))
    qmatrix = matrices.quant_matrix(WaveletKernel.parse(args.kernel), depth)
    picture_bytes = (args.compressedBytes // 2 if interlaced
                     else args.compressedBytes)
    ld_sizes = (layout.slice_bytes_map(ys, xs, picture_bytes, 1).ravel()
                if not hq else None)
    if not hq and int(ld_sizes.sum()) <= 0:
        # zero-size LD slices would decode end == start and loop forever
        raise ValueError("compressed bytes must be >0 in LD mode")

    if args.inFile == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(args.inFile, "rb") as f:
            data = f.read()
    sink = sys.stdout.buffer if args.outFile == "-" else open(args.outFile,
                                                               "wb")
    try:
        return _decode_frames(args, data, sink, hq, geo, ld_sizes, qmatrix,
                              device, pic_h, luma_depth, chroma_depth)
    finally:
        if args.outFile != "-":
            sink.close()


def _decode_frames(args, data: bytes, sink, hq: bool, geo: SliceGeometry,
                   ld_sizes, qmatrix, device, pic_h: int, luma_depth: int,
                   chroma_depth: int) -> int:
    """The frame loop of ``run``: decode ``data`` picture by picture into
    ``sink``; 1 when not even the first frame can be read."""
    out = DecOutput(args.output)
    sig_fmt = SampleFormat(word_width=4, offset=False)
    chroma_format = ColourFormat.parse(args.format)
    kernel = WaveletKernel.parse(args.kernel)
    depth = args.waveletDepth
    interlaced = args.interlace
    out_geom = PictureGeometry.of(pic_h, args.width, chroma_format)
    frame_pics = 2 if interlaced else 1
    ys, xs = geo.y_slices, geo.x_slices
    ly = geo.luma_slice[0] * geo.luma_slice[1]
    lc = geo.chroma_slice[0] * geo.chroma_slice[1]

    pos = 0
    frame = 0
    while True:
        pictures = []
        for _pic in range(frame_pics):
            # a short or corrupt input raises ValueError: the end of the
            # input; kernel errors propagate
            try:
                if hq:
                    q_idx, _dstart, cbytes, end = scan_hq_slice_offsets(
                        data, geo.n_slices, args.prefix, args.scalar, pos)
                    (qy, qu, qv), q_dev = unpack_payload(
                        np.frombuffer(data, np.uint8, count=end), q_idx,
                        cbytes, geo, args.prefix, start=pos, device=device)
                else:
                    end = pos + int(ld_sizes.sum())
                    if end > len(data):
                        raise ValueError("eof")
                    q_idx, qy, qu, qv, _ = decode_ld_slices(
                        data, ld_sizes, (ly, lc), start=pos, device=device)
                    q_dev = None
            except ValueError:
                if frame == 0:
                    print("Failed to read the first compressed frame",
                          file=sys.stderr)
                    return 1
                if args.verbose:
                    print(f"End of input reached after {frame} frames",
                          file=sys.stderr)
                return 0
            pos = end
            pictures.append((q_idx, q_dev, (qy, qu, qv)))

        fields = []
        for q_idx, q_dev, lanes in pictures:
            if out == DecOutput.INDICES:
                sink.write(np.asarray(q_idx).astype(np.uint8).tobytes())
                continue
            if out == DecOutput.QUANTISED:
                planes = [layout.lanes_to_plane(
                    lanes_c, ys, xs,
                    *(geo.luma_slice if c == 0 else geo.chroma_slice), depth)
                    for c, lanes_c in enumerate(lanes)]
                write_picture(sink, Picture(*planes, chroma_format), sig_fmt)
                continue
            if q_dev is None:
                q_dev = lanes[0].new_tensor(np.asarray(q_idx, np.int32))
            planes = dequantise_planes(lanes, q_dev, qmatrix, depth, geo)
            if out == DecOutput.TRANSFORM:
                write_picture(sink, Picture(*planes, chroma_format), sig_fmt)
                continue
            y, c1, c2 = lifting.inverse_planes(planes, kernel, depth)
            g = out_geom
            fields.append(Picture(
                y[:g.luma_height, :g.luma_width].cpu().numpy(),
                c1[:g.chroma_height, :g.chroma_width].cpu().numpy(),
                c2[:g.chroma_height, :g.chroma_width].cpu().numpy(),
                chroma_format))

        if out == DecOutput.DECODED:
            out_frame = (interleave_fields(fields[0], fields[1],
                                           not args.bottomFieldFirst)
                         if interlaced else fields[0])
            out_frame = signal_clip(out_frame, luma_depth, chroma_depth)
            luma_fmt = SampleFormat(word_width=args.bytes,
                                    bit_depth=luma_depth, offset=True)
            chroma_fmt = SampleFormat(word_width=args.bytes,
                                      bit_depth=chroma_depth, offset=True)
            write_picture(sink, out_frame, luma_fmt, chroma_fmt)
        frame += 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as exc:
        # stdout, as the reference's catch-all does (DecodeFrame.cpp:352
        # prints to cout): error-case output stays byte-comparable
        print(f"Error: {exc}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
