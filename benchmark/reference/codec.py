"""The reference codec: planar pictures to VC-2 picture data units (HQ CBR
or LD, LeGall, progressive), and each picture's decode, in plain PyTorch
on any device.

The decode of a picture is worked out from what the encoder coded (its q
indices, quantised lanes and, for LD, the reconstructions its DC
prediction ran on), not by parsing the bytes again: the CPU tests hold
both halves to the goldens and to the 1080p fixtures, which the JAX
package and the bbc/vc2-reference binaries made. It imports nothing of
the program, and nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import hq, ld, stream
from reference.transform import (band_dims, band_sizes, bands_to_lanes,
                                 forward_bands, inverse_bands, lane_qm,
                                 lanes_to_bands, padded_size, quant_lanes,
                                 quant_matrix, rationalise, scale_lanes,
                                 slice_count, wavelet_pad)

CHROMA = {"4:4:4": (0, 1, 1), "4:2:2": (1, 1, 2), "4:2:0": (2, 2, 2)}


@dataclasses.dataclass
class Coded:
    """One picture as the reference codes it: ``body`` is its data unit
    after the picture number (transform parameters and slices), ``decoded``
    the planar bytes its decode gives, ``q`` its slice indices and
    ``lanes`` its quantised lanes (y, u, v)."""

    body: bytes
    decoded: bytes
    q: torch.Tensor
    lanes: tuple
    passes: torch.Tensor | None = None


class Codec:
    """The reference codec of one configuration: ``cfg`` is the ``coding``
    object of a configuration file (``width``, ``height``, ``chroma``,
    ``depth_bits``, ``frame_rate``, ``mode`` HQ_CBR or LD, ``kernel``
    LeGall, ``wavelet_depth``, ``slice_units`` [vertical, horizontal],
    ``compressed_bytes``, ``slice_scalar``, ``slice_prefix``)."""

    def __init__(self, cfg: dict, device):
        if cfg["kernel"] != "LeGall" or cfg.get("interlace"):
            raise ValueError("the reference codes progressive LeGall only")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mode = cfg["mode"]
        if self.mode not in ("HQ_CBR", "LD"):
            raise ValueError(f"the reference codes HQ_CBR and LD, not "
                             f"{self.mode}")
        self.hq = self.mode == "HQ_CBR"
        h, w = cfg["height"], cfg["width"]
        cf, dy, dx = CHROMA[cfg["chroma"]]
        self.chroma_format = cf
        self.dims = ((h, w), (h // dy, w // dx), (h // dy, w // dx))
        d = self.depth = cfg["wavelet_depth"]
        u, a = cfg["slice_units"]
        self.ys = slice_count(d, h, h // dy, u)
        self.xs = slice_count(d, w, w // dx, a)
        if not self.ys or not self.xs:
            raise ValueError("the slice geometry cannot code this picture")
        self.n = self.ys * self.xs
        self.padded = [(padded_size(ph, d), padded_size(pw, d))
                       for ph, pw in self.dims]
        self.slice = [(ph // self.ys, pw // self.xs) for ph, pw in self.padded]
        self.qmatrix = quant_matrix(d)
        self.sizes = [band_sizes(*sl, d) for sl in self.slice[:2]]
        self.qm = [torch.as_tensor(lane_qm(self.qmatrix, s), device=device)
                   for s in self.sizes]
        self.bits = cfg["depth_bits"]
        nbytes = cfg["compressed_bytes"]
        if self.hq:
            self.scalar = cfg["slice_scalar"]
            self.prefix = cfg["slice_prefix"]
            self.budgets = torch.as_tensor(hq.slice_bytes_map(
                self.ys, self.xs, nbytes, self.scalar), device=device)
        else:
            self.budgets = hq.slice_bytes_map(self.ys, self.xs, nbytes,
                                              1).astype(np.int64)
            self.avail = torch.as_tensor(ld.avail_bits(self.budgets),
                                         device=device)
        header = stream.SequenceHeader(
            profile=stream.Profile.PROFILE_HQ if self.hq
            else stream.Profile.PROFILE_LD,
            height=h, width=w, chroma_format=stream.ColourFormat(cf),
            interlace=False, frame_rate=stream.FrameRate(cfg["frame_rate"]),
            top_field_first=True, bitdepth=self.bits)
        self.major_version = header.major_version
        self.header = stream.sequence_header_payload(header)
        first, second = ((self.prefix, self.scalar) if self.hq
                         else rationalise(nbytes, self.n))
        self.params = stream.transform_params(
            self.major_version, 1, d, self.xs, self.ys, first, second)
        self.kind = "hq_picture" if self.hq else "ld_picture"

    # --- encode -------------------------------------------------------------

    def analyse(self, planes) -> list:
        """The transform lanes (y, u, v), int32 [N, L], of a picture's
        three int32 sample planes."""
        return [bands_to_lanes(forward_bands(
            wavelet_pad(p.to(self.device, torch.int32), self.depth),
            self.depth), self.ys, self.xs) for p in planes]

    def encode(self, pictures) -> list:
        """``Coded`` of each picture (three int32 sample planes each)."""
        tlanes = [self.analyse(p) for p in pictures]
        if self.hq:
            return [self._encode_hq(t) for t in tlanes]
        return self._encode_ld(tlanes)

    def _encode_hq(self, tlanes) -> Coded:
        qm = (self.qm[0], self.qm[1], self.qm[1])
        q, passes = hq.cbr_quant_indices(*tlanes, qm[0], qm[1],
                                         self.budgets, self.scalar)
        if bool((q > 119).any()):
            raise ValueError("quantization index exceeds maximum implemented "
                             "value.")
        lanes = tuple(quant_lanes(x, q, m) for x, m in zip(tlanes, qm))
        payload, _totals = hq.pack(*lanes, q, self.prefix, self.scalar,
                                   self.budgets)
        bands = [self._dequantise(x, q, c) for c, x in enumerate(lanes)]
        return Coded(self.params + payload.cpu().numpy().tobytes(),
                     self.decode_bands(bands), q, lanes, passes)

    def _encode_ld(self, tlanes) -> list:
        count = len(tlanes)
        ts = 1 << self.depth
        ll = [(sh // ts, sw // ts) for sh, sw in self.slice[:2]]
        stacked = [torch.cat([t[c] for t in tlanes]) for c in range(3)]
        q, ll_codes, rec = ld.ld_rate_control(
            *stacked, self.qmatrix, self.sizes[0], self.sizes[1], self.avail,
            count, (self.ys, self.xs), ll[0], ll[1])
        sizes = torch.as_tensor(self.budgets.astype(np.int32),
                                device=self.device)
        qm = (self.qm[0], self.qm[1], self.qm[1])
        out = []
        for k in range(count):
            at = slice(k * self.n, (k + 1) * self.n)
            qk = q[at]
            lanes = tuple(ld.quantise_body(stacked[c][at], ll_codes[c][at],
                                           qk, qm[c]) for c in range(3))
            payload = ld.pack(*lanes, qk, sizes)
            bands = []
            for c in range(3):
                b = self._dequantise(lanes[c], qk, c)
                b[0] = rec[c][k].to(torch.int32)
                bands.append(b)
            out.append(Coded(self.params + payload.cpu().numpy().tobytes(),
                             self.decode_bands(bands), qk, lanes))
        return out

    # --- decode -------------------------------------------------------------

    def _dequantise(self, lanes, q, comp: int) -> list:
        """A component's quantised lanes, dequantised, as subband arrays."""
        qm = self.qm[min(comp, 1)]
        return lanes_to_bands(scale_lanes(lanes, q, qm), self.ys, self.xs,
                              band_dims(*self.padded[comp], self.depth))

    def decode_bands(self, bands) -> bytes:
        """A picture's planar bytes from its three components' dequantised
        subbands: the inverse DWT, the crop, the clip to the signal range
        and the wire form (offset binary, MSB-justified big-endian words)."""
        parts = []
        for (h, w), b in zip(self.dims, bands):
            plane = inverse_bands(b, self.depth)[:h, :w]
            parts.append(planar_bytes(plane, self.bits))
        return b"".join(p.cpu().numpy().tobytes() for p in parts)

    # --- the stream ---------------------------------------------------------

    def unit_head(self, number: int, body_bytes: int, prev: int) -> bytes:
        """The first 17 bytes of the picture data unit of picture
        ``number`` whose body has ``body_bytes``, after a unit whose
        next-parse offset was ``prev``: parse info and picture number."""
        return (stream.parse_info(self.kind, 4 + body_bytes, prev)
                + number.to_bytes(4, "big"))

    def unit(self, number: int, body: bytes, prev: int) -> bytes:
        """The whole picture data unit of picture ``number``."""
        return self.unit_head(number, len(body), prev) + body

    def header_unit(self) -> bytes:
        return stream.parse_info("sequence_header", len(self.header),
                                 0) + self.header

    def stream(self, bodies) -> bytes:
        """A whole stream: the sequence header, the pictures numbered from
        0, the end of the sequence."""
        out = [self.header_unit()]
        prev = 13 + len(self.header)
        for k, body in enumerate(bodies):
            out.append(self.unit(k, body, prev))
            prev = 13 + 4 + len(body)
        out.append(stream.parse_info("end_of_sequence", None, prev))
        return b"".join(out)


def planar_bytes(plane: torch.Tensor, bits: int) -> torch.Tensor:
    """An int32 plane clipped to the signal range of ``bits`` and written
    as the reference writes it: offset binary, MSB-justified in 16-bit
    big-endian words (8-bit: one byte), flat uint8."""
    zero = 1 << (bits - 1)
    width = 1 if bits == 8 else 2
    value = (torch.clamp(plane.to(torch.int64), -zero, zero - 1) + zero) \
        << (8 * width - bits)
    parts = [(value >> (8 * (width - 1 - k))) & 0xFF for k in range(width)]
    return torch.stack(parts, dim=-1).to(torch.uint8).reshape(-1)


def planes_of(buf: bytes, dims, bits: int) -> list:
    """The int32 sample planes of one planar picture (16-bit big-endian
    MSB-justified offset-binary words, or bytes for 8 bits) of plane
    sizes ``dims``."""
    width = 1 if bits == 8 else 2
    dtype = ">u1" if width == 1 else ">u2"
    out, at = [], 0
    for h, w in dims:
        words = np.frombuffer(buf, dtype=dtype, count=h * w, offset=at)
        v = (words.astype(np.int32) >> (8 * width - bits)) - (1 << (bits - 1))
        out.append(torch.from_numpy(v.reshape(h, w)))
        at += h * w * width
    return out
