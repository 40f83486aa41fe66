"""The control: the reference codec with its wavelet lifting computed in a
float type instead of exact 32-bit integers.

The configurations state exact integer arithmetic and byte identity with
the reference codec. The control is the step that would tempt a later
change: the same ladders in ``float16`` (the least float type a card
computes natively), whose 11-bit significand cannot hold every
intermediate of a 10-bit picture's transform. Its outputs have to come out
not correct; ``control.py`` puts it in the program's place.
"""

from __future__ import annotations

import torch

from reference import codec, transform


def _apply_steps(e, o, steps, dim: int, dtype):
    """``transform._apply_steps`` with the sums, the rounding shift and the
    update in ``dtype``."""
    for target, sign, taps, add, sh in steps:
        src = e if target == "o" else o
        n = src.shape[dim]
        idx = torch.arange(n, device=src.device)
        acc = None
        for off, coeff in taps:
            term = coeff * src.index_select(dim, (idx + off).clamp(0, n - 1))
            acc = term if acc is None else acc + term
        delta = torch.floor((acc + add) / (1 << sh)) if sh else acc
        if target == "o":
            o = o + sign * delta
        else:
            e = e + sign * delta
    return e, o


def forward_bands(plane, depth: int, dtype) -> list:
    steps = transform.ladder(False)
    x = plane.to(dtype)
    fine_to_coarse = []
    for _ in range(depth):
        x = x * 2
        he, ho = _apply_steps(*transform._split(x, 1), steps, 1, dtype)
        ll, lh = _apply_steps(*transform._split(he, 0), steps, 0, dtype)
        hl, hh = _apply_steps(*transform._split(ho, 0), steps, 0, dtype)
        fine_to_coarse.append((hl, lh, hh))
        x = ll
    bands = [x]
    for level in reversed(fine_to_coarse):
        bands.extend(level)
    return [torch.round(b.float()).to(torch.int32) for b in bands]


def inverse_bands(bands, depth: int, dtype):
    steps = transform.ladder(True)
    x = bands[0].to(dtype)
    for level in range(depth):
        hl, lh, hh = (b.to(dtype) for b in bands[1 + 3 * level:4 + 3 * level])
        he = transform._interleave(*_apply_steps(x, lh, steps, 0, dtype), 0)
        ho = transform._interleave(*_apply_steps(hl, hh, steps, 0, dtype), 0)
        x = transform._interleave(*_apply_steps(he, ho, steps, 1, dtype), 1)
        x = torch.floor((x + 1) / 2)
    return torch.round(x.float()).to(torch.int32)


class LoweredCodec(codec.Codec):
    """``codec.Codec`` with both wavelet directions in ``dtype``."""

    def __init__(self, cfg: dict, device, dtype=torch.float16):
        super().__init__(cfg, device)
        self.dtype = dtype

    def analyse(self, planes) -> list:
        return [transform.bands_to_lanes(forward_bands(
            transform.wavelet_pad(p.to(self.device, torch.int32),
                                  self.depth), self.depth, self.dtype),
            self.ys, self.xs) for p in planes]

    def decode_bands(self, bands) -> bytes:
        parts = []
        for (h, w), b in zip(self.dims, bands):
            plane = inverse_bands(b, self.depth, self.dtype)[:h, :w]
            parts.append(codec.planar_bytes(plane, self.bits))
        return b"".join(p.cpu().numpy().tobytes() for p in parts)
