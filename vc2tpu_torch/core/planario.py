"""Planar picture file I/O.

Port of ``vc2tpu.core.planario``. The input side (``PlanarReader``,
``decode_plane``) parses the file on the host with NumPy, as the
reference's operator>>(istream, Array2D&) does
(src/Library/src/Arrays.cpp:333-380); the encoder then uploads the planes
in one copy. The output side (``encode_plane``, the reference's
operator<<, Arrays.cpp:381-426) is torch ops, so output bytes are built
where the picture lies and cross to the host in one copy.

Format model (the reference's semantics):
* ``word_width`` bytes per sample, big-endian;
* data is ``bit_depth`` bits, left (MSB) justified;
* ``offset`` binary adds/subtracts 2^(depth-1); without it the samples
  are two's complement (the Transform and Quantised taps write them so).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SampleFormat:
    word_width: int = 2          # bytes per sample, 1..4
    bit_depth: int = 0           # 0 -> 8*word_width
    offset: bool = True          # offset binary

    @property
    def depth(self) -> int:
        return self.bit_depth if self.bit_depth else 8 * self.word_width

    @property
    def shift(self) -> int:
        return 8 * self.word_width - self.depth

    @property
    def zero(self) -> int:
        return 1 << (self.depth - 1) if self.offset else 0


_DTYPES = {1: ">u1", 2: ">u2", 4: ">u4"}


def _read_words(buf: bytes, fmt: SampleFormat, count: int) -> np.ndarray:
    w = fmt.word_width
    if w == 3:
        raw = np.frombuffer(buf, dtype=np.uint8,
                            count=count * 3).reshape(count, 3)
        return ((raw[:, 0].astype(np.uint32) << 16)
                | (raw[:, 1].astype(np.uint32) << 8)
                | raw[:, 2].astype(np.uint32))
    return np.frombuffer(buf, dtype=_DTYPES[w], count=count).astype(np.uint32)


def decode_plane(buf: bytes, height: int, width: int,
                 fmt: SampleFormat) -> np.ndarray:
    """bytes -> int32 (height, width) plane, per reference
    operator>>(istream, Array2D&)."""
    out = (_read_words(buf, fmt, height * width) >> fmt.shift).astype(
        np.int32)
    if fmt.offset:
        out = out - np.int32(fmt.zero)
    return out.reshape(height, width)


def encode_plane(plane: torch.Tensor, fmt: SampleFormat) -> torch.Tensor:
    """int32 plane -> flat uint8 bytes on the plane's device, per reference
    operator<<(ostream, const Array2D&): offset, justify, big-endian (the
    low ``word_width`` bytes of the 32-bit word). The caller clips the
    plane to the format's range where it must."""
    value = ((plane.to(torch.int64) + fmt.zero) & 0xFFFFFFFF) << fmt.shift
    w = fmt.word_width
    parts = [(value >> (8 * (w - 1 - k))) & 0xFF for k in range(w)]
    return torch.stack(parts, dim=-1).to(torch.uint8).reshape(-1)


class PlanarReader:
    """Frame-at-a-time reader of Y, C1, C2 planar files; returns Pictures
    of int32 NumPy planes."""

    def __init__(self, fileobj, geometry, luma_fmt: SampleFormat,
                 chroma_fmt: SampleFormat | None = None):
        self.f = fileobj
        self.g = geometry
        self.luma_fmt = luma_fmt
        self.chroma_fmt = chroma_fmt or luma_fmt

    def frame_bytes(self) -> int:
        g = self.g
        return (g.luma_height * g.luma_width * self.luma_fmt.word_width
                + 2 * g.chroma_height * g.chroma_width
                * self.chroma_fmt.word_width)

    def read_frame(self):
        from vc2tpu_torch.core.picture import Picture

        g = self.g
        need = self.frame_bytes()
        buf = self.f.read(need)
        if len(buf) < need:
            return None
        ybytes = g.luma_height * g.luma_width * self.luma_fmt.word_width
        cbytes = g.chroma_height * g.chroma_width * self.chroma_fmt.word_width
        y = decode_plane(buf[:ybytes], g.luma_height, g.luma_width,
                         self.luma_fmt)
        c1 = decode_plane(buf[ybytes:ybytes + cbytes], g.chroma_height,
                          g.chroma_width, self.chroma_fmt)
        c2 = decode_plane(buf[ybytes + cbytes:], g.chroma_height,
                          g.chroma_width, self.chroma_fmt)
        return Picture(y, c1, c2, g.chroma_format)


def write_picture(fileobj, picture, luma_fmt: SampleFormat,
                  chroma_fmt: SampleFormat | None = None) -> None:
    """Write a Picture's planes (NumPy arrays or tensors on any device):
    each plane is formatted where it lies and copied to the host once."""
    chroma_fmt = chroma_fmt or luma_fmt
    for plane, fmt in ((picture.y, luma_fmt), (picture.c1, chroma_fmt),
                       (picture.c2, chroma_fmt)):
        data = encode_plane(torch.as_tensor(plane), fmt)
        fileobj.write(data.cpu().numpy().tobytes())
