"""HQ-profile slice chain: slice geometry and the host chain scan.

Wire format per slice (reference src/Library/src/Slices.cpp:305-612):
``prefix`` zero bytes, 1-byte qIndex, then per component {1-byte
length/scalar, bounded exp-Golomb data}. HQ slices are always parsed with
the self-describing lengths, as the reference decoder does
(DecodeStream.cpp:512).

``scan_hq_slice_offsets`` walks the chain in native host code
(``csrc/hq_scan.cpp``, built with the host C++ compiler at first use);
``scan_hq_slice_offsets_plain`` is the same walk as a Python loop, the
reference the tests hold it against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np

from vc2tpu_torch.core import build


@dataclasses.dataclass(frozen=True)
class SliceGeometry:
    """Static per-picture slice/lane geometry."""

    y_slices: int
    x_slices: int
    padded_luma: tuple[int, int]
    padded_chroma: tuple[int, int]
    luma_slice: tuple[int, int]      # slice block dims in the luma plane
    chroma_slice: tuple[int, int]

    @property
    def n_slices(self) -> int:
        return self.y_slices * self.x_slices


_PAST_END = "slice payload runs past the end of the data unit"


def scan_source() -> build.Source:
    return build.Source("hq_scan", compiler="c++")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(scan_source())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.hq_scan.argtypes = [p, i64, i64, i64, i64, i64, p, p, p]
    lib.hq_scan.restype = i64
    return lib


def scan_hq_slice_offsets(payload, n_slices: int, prefix: int, scalar: int,
                          start: int = 0):
    """Walk the self-describing slice chain to locate per-slice fields, in
    native code (``csrc/hq_scan.cpp``).

    ``payload`` is bytes, a bytearray, a memoryview or a contiguous uint8
    array.
    Returns (q_indices int32[N], data_starts int64[3, N] byte offsets,
    comp_bytes int64[3, N], end_offset). Raises ValueError when the chain
    runs past the end of the payload (the decoder's stream loop answers
    that by growing its window)."""
    data = np.frombuffer(payload, dtype=np.uint8)
    q = np.zeros(n_slices, dtype=np.int32)
    dstart = np.zeros((3, n_slices), dtype=np.int64)
    cbytes = np.zeros((3, n_slices), dtype=np.int64)
    end = _lib().hq_scan(data.ctypes.data, data.size, n_slices, prefix,
                         scalar, start, q.ctypes.data, dstart.ctypes.data,
                         cbytes.ctypes.data)
    if end < 0:
        raise ValueError(_PAST_END)
    return q, dstart, cbytes, int(end)


def scan_hq_slice_offsets_plain(payload, n_slices: int, prefix: int,
                                scalar: int, start: int = 0):
    """``scan_hq_slice_offsets`` as a Python loop over a ``bytes`` object
    (whose indexing yields Python ints): the reference of the native
    walk."""
    data = bytes(payload)
    q = [0] * n_slices
    d0, d1, d2 = [0] * n_slices, [0] * n_slices, [0] * n_slices
    c0, c1, c2 = [0] * n_slices, [0] * n_slices, [0] * n_slices
    pos = start
    try:
        for i in range(n_slices):
            pos += prefix
            q[i] = data[pos]
            s = data[pos + 1] * scalar
            d0[i] = pos + 2
            c0[i] = s
            pos += 2 + s
            s = data[pos] * scalar
            d1[i] = pos + 1
            c1[i] = s
            pos += 1 + s
            s = data[pos] * scalar
            d2[i] = pos + 1
            c2[i] = s
            pos += 1 + s
    except IndexError:
        raise ValueError(_PAST_END)
    if pos > len(data):
        raise ValueError(_PAST_END)
    return (np.asarray(q, np.int32), np.asarray([d0, d1, d2], np.int64),
            np.asarray([c0, c1, c2], np.int64), pos)
