"""Picture: three int32 planes and their colour format.

Port of ``vc2tpu.core.picture`` as a plain dataclass (the reference's
``Picture``/``Frame`` classes, src/Library/Picture.h:53-70,
src/Frame.cpp:40-110). Planes are NumPy arrays on the host, or tensors on
the device for the encoder's tap outputs; the field and clip helpers take
NumPy planes. Interlaced fields are stride-2 row views:
``top = plane[0::2]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from vc2tpu_torch.core.config import ColourFormat


@dataclasses.dataclass
class Picture:
    y: Any
    c1: Any
    c2: Any
    chroma_format: ColourFormat = ColourFormat.CF444

    def map(self, fn_luma, fn_chroma=None) -> "Picture":
        fn_chroma = fn_chroma or fn_luma
        return Picture(fn_luma(self.y), fn_chroma(self.c1),
                       fn_chroma(self.c2), self.chroma_format)

    # --- interlace field views (reference src/Library/src/Frame.cpp:40-110)

    def top_field(self) -> "Picture":
        return self.map(lambda p: p[0::2])

    def bottom_field(self) -> "Picture":
        return self.map(lambda p: p[1::2])

    def first_field(self, top_field_first: bool) -> "Picture":
        return self.top_field() if top_field_first else self.bottom_field()

    def second_field(self, top_field_first: bool) -> "Picture":
        return self.bottom_field() if top_field_first else self.top_field()


def interleave_fields(first: Picture, second: Picture,
                      top_field_first: bool) -> Picture:
    """Weave two fields back into a frame."""
    top, bottom = (first, second) if top_field_first else (second, first)

    def weave(t, b):
        return np.stack([t, b], 1).reshape(t.shape[0] * 2, t.shape[1])

    return Picture(weave(top.y, bottom.y), weave(top.c1, bottom.c1),
                   weave(top.c2, bottom.c2), first.chroma_format)


def signal_clip(picture: Picture, luma_depth: int,
                chroma_depth: int) -> Picture:
    """Clip to [-2^(d-1), 2^(d-1)-1] as DecodeStream does
    (reference src/DecodeStream/DecodeStream.cpp:591-598)."""

    def cl(depth):
        return lambda p: np.clip(p, -(1 << (depth - 1)),
                                 (1 << (depth - 1)) - 1)

    return picture.map(cl(luma_depth), cl(chroma_depth))
