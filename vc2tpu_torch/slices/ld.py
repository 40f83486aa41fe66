"""LD-profile slices: the header scan, the slice decode, and the LL
DC-prediction dequantise.

Wire format per slice (reference src/Library/src/Slices.cpp:195-303): a
7-bit qIndex, an ``intlog2(8*size-7)``-bit luma-length field, a bounded
luma exp-Golomb region of that many bits, then the remaining bits as a
bounded interleaved-U,V region. Slices are fixed-size (``layout
.slice_bytes_map`` of the picture's bytes), so every offset follows from
the sizes. Reads past the payload give 1-bits (the JAX package's 0xFF
pad, the reference's at-EOF rule).

``ld_fields`` is the host half of the single-device LD decode, in native
code (``csrc/ld_scan.cpp``, built with the host C++ compiler at first
use): the header fields of every slice (span ``dec.ld_read``), whose LL
codes the unpack kernel decodes with the rest of each region and whose
DC prediction runs on the card (``quant.ld_dc``). ``ll_sources`` says,
once a geometry, which lane holds each LL grid cell's code.

``ld_scan`` is the host scan that keeps the LL band on the host, in two
phases: the slice walk (``ld_read``, span ``dec.ld_read``: the header
fields, and the LL band's codes into three compact grids), then the DC
prediction (``dec.ld_dc``: a strict raster recurrence, reference
Quantisation.cpp:287-306, that dequantises each grid in place). No decode
route calls it: it is the native reference that the tests hold the card's
LL grids to, on inputs too large for the plain one. ``ld_scan_plain`` is
the same from
``ld_header_fields``, the plain bit reader and a Python loop of the
recurrence: the reference the tests hold both native scans and the card's
DC prediction against. ``dequantise_ll`` runs the recurrence alone on a
grid of LL codes (``ld_dequantise_grid`` of the same library), for the
encoder's Decoded and PSNR outputs and the CPU form of ``quant.ld_dc``;
``dequantise_ll_plain`` is its twin.

``encode_ld_slices`` packs a whole picture's slices on the host from
quantised lanes, through ``device_pack.pack_ld_plain``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core import trace
from vc2tpu_torch.core.intmath import wrap32
from vc2tpu_torch.quant.quantiser import MAX_QINDEX, QUANT_FACTORS_I32, \
    QUANT_OFFSETS
from vc2tpu_torch.slices import layout
from vc2tpu_torch.vlc import device_unpack


def len_bits_of(sizes: np.ndarray) -> np.ndarray:
    """``intlog2(8 * size - 7)`` of every slice size, int64: the bit length
    of ``8 * size - 8`` (0 where that is not positive)."""
    x = 8 * np.asarray(sizes, np.int64) - 8
    return np.where(x > 0, np.frexp(np.maximum(x, 1))[1], 0).astype(np.int64)


def ld_header_fields(payload, slice_sizes, start: int = 0):
    """Per-slice LD header scan, vectorised: (q int32, s_bits, len_bits,
    y_bits, uv_bits int64, end offset). ``payload`` is bytes, a bytearray,
    a memoryview or a uint8 array; only the first bytes of each slice are
    read. The luma length is not clamped to the slice; ``uv_bits`` is
    ``max(8 size - 7 - len_bits - y_bits, 0)``."""
    sizes = np.asarray(slice_sizes, np.int64).ravel()
    n = len(sizes)
    starts = start + np.cumsum(sizes) - sizes
    len_bits = len_bits_of(sizes)
    width = int(len_bits.max(initial=0))
    k = (7 + width + 7) // 8
    data = np.frombuffer(payload, np.uint8)
    buf = np.concatenate([data, np.full(k + 1, 0xFF, np.uint8)])
    idx = np.minimum(starts[:, None] + np.arange(k), len(buf) - 1)
    hbits = np.unpackbits(buf[idx], axis=1).astype(np.int64)   # (n, 8k)
    q = hbits[:, :7] @ (1 << np.arange(6, -1, -1, dtype=np.int64))
    b = np.arange(width, dtype=np.int64)
    weight = np.where(b < len_bits[:, None],
                      np.left_shift(1, np.maximum(len_bits[:, None] - 1 - b,
                                                  0)), 0)
    y_bits = (hbits[:, 7:7 + width] * weight).sum(1) if n else np.zeros(
        0, np.int64)
    uv_bits = np.maximum(8 * sizes - 7 - len_bits - y_bits, 0)
    end = int(start + sizes.sum())
    return q.astype(np.int32), 8 * starts, len_bits, y_bits, uv_bits, end


def _fields(s_bits, len_bits, y_bits, uv_bits) -> np.ndarray:
    """The four bit fields as the int32 [4, N] the unpack takes."""
    f = np.stack([s_bits, len_bits, y_bits, uv_bits]).astype(np.int64)
    if f.size and int((f[0] + 7 + f[1] + f[2] + f[3]).max()) > 2**31 - 1:
        raise ValueError("LD slice fields exceed the int32 range")
    return f.astype(np.int32)


def decode_ld_slices(payload, slice_sizes, lane_counts: tuple[int, int],
                     start: int = 0, device=None):
    """Decode LD slices: the header scan on the host, then both regions of
    every slice through ``device_unpack.unpack_ld`` (the kernel on the card,
    the default, or its plain version for ``device="cpu"``). Returns
    (q_indices int32 [N] numpy, lanes_y, lanes_u, lanes_v int32 tensors on
    the device, end offset)."""
    device = devices.resolve(device)
    ly, lc = lane_counts
    q, *bits, end = ld_header_fields(payload, slice_sizes, start)
    pay = torch.from_numpy(np.array(np.frombuffer(payload, np.uint8)))
    fields = torch.from_numpy(_fields(*bits))
    qy, qu, qv = device_unpack.unpack_ld(pay.to(device), fields.to(device),
                                         ly, lc)
    return q, qy, qu, qv, end


def qm_block(slice_h: int, slice_w: int, depth: int, qmatrix) -> np.ndarray:
    """Quant matrix entry of every position of a slice block, row-major,
    int32 [slice_h * slice_w] (the JAX package's ``pipeline.ld._qm_block``,
    reference EncodeStream.cpp:159-171)."""
    perm, band = layout.lane_order(slice_h, slice_w, depth)
    out = np.zeros(slice_h * slice_w, dtype=np.int32)
    out[perm] = np.asarray(qmatrix)[band]
    return out


@dataclasses.dataclass
class LLGeometry:
    """One component's compact LL grid: its slice block (sh x sw), the nll
    LL codes a slice, each code's offset in its slice's block of the grid
    (row-major at the grid width llw; the first nll codes of a region, in
    ``layout.lane_order``), and the grid's size (llh x llw)."""

    sh: int
    sw: int
    nll: int
    llh: int
    llw: int
    offset: np.ndarray

    @staticmethod
    def of(sh: int, sw: int, depth: int, ys: int, xs: int) -> "LLGeometry":
        ts = 1 << depth
        nll = (sh // ts) * (sw // ts)
        perm, _ = layout.lane_order(sh, sw, depth)
        llw = (xs * sw) // ts
        by, bx = np.divmod(perm[:nll].astype(np.int64), max(sw, 1))
        return LLGeometry(sh, sw, nll, (ys * sh) // ts, llw,
                          (by // ts) * llw + bx // ts)

    def origins(self, ys: int, xs: int, ts: int) -> np.ndarray:
        """Offset of every slice's LL block in the grid, int64 [N]."""
        sy, sx = np.divmod(np.arange(ys * xs, dtype=np.int64), xs)
        return sy * (self.sh // ts) * self.llw + sx * (self.sw // ts)


@dataclasses.dataclass
class LDScan:
    """The host half of an LD picture's decode: the q indices (int32 [N]),
    the bit fields (int32 [4, N]: s_bits, len_bits, y_bits, uv_bits), the
    three dequantised LL grids (int32, luma then U and V; None from
    ``ld_fields``, whose grids the decode device computes) and the offset
    just past the last slice."""

    q: np.ndarray
    fields: np.ndarray
    grids: tuple | None
    end: int


def scan_source() -> build.Source:
    return build.Source("ld_scan", compiler="c++")


class _LLGrid(ctypes.Structure):
    _fields_ = [("sh", ctypes.c_int64), ("sw", ctypes.c_int64),
                ("nll", ctypes.c_int64), ("llh", ctypes.c_int64),
                ("llw", ctypes.c_int64), ("offset", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(scan_source())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ld_read.argtypes = [p, i64, i64, i64, p, i64, i64, p, p, p, p, p, p,
                            p]
    lib.ld_read.restype = i64
    lib.ld_fields.argtypes = [p, i64, i64, i64, p, p, p]
    lib.ld_fields.restype = i64
    lib.ld_dequantise_grid.argtypes = [p, i64, i64, i64, i64, i64, i64, i64,
                                       p, p, p, p]
    lib.ld_dequantise_grid.restype = None
    return lib


_QF = np.ascontiguousarray(QUANT_FACTORS_I32, np.int32)
_QO = np.ascontiguousarray(QUANT_OFFSETS, np.int32)
_LL_OUTSIDE = "an LL code of the slice grid lands outside its LL grid"


def _geometries(geo, depth: int):
    ys, xs = geo.y_slices, geo.x_slices
    return (LLGeometry.of(*geo.luma_slice, depth, ys, xs),
            LLGeometry.of(*geo.chroma_slice, depth, ys, xs))


def _sizes(slice_sizes) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(slice_sizes).ravel(), np.int32)


def ld_fields(payload, slice_sizes, geo, depth: int,
              start: int = 0) -> LDScan:
    """The header walk of an LD picture's slices in native code
    (``ld_fields`` of ``csrc/ld_scan.cpp``, span ``dec.ld_read``): the q
    indices and bit fields that ``ld_scan`` gives, and no LL grids.
    ``payload`` is bytes, a bytearray, a memoryview or a uint8 array whose
    slices begin at byte ``start``; ``geo`` a ``SliceGeometry``. Raises
    ValueError when the fields leave the int32 range, and (once a geometry,
    ``ll_sources``) when an LL code would land outside its grid."""
    with trace.span("dec.ld_read"):
        data = np.frombuffer(payload, np.uint8)
        sizes = _sizes(slice_sizes)
        n = sizes.size
        q = np.empty(n, np.int32)
        fields = np.empty((4, n), np.int32)
        end = _lib().ld_fields(data.ctypes.data, data.size, n, start,
                               sizes.ctypes.data, q.ctypes.data,
                               fields.ctypes.data)
    if end < 0:
        raise ValueError("LD slice fields exceed the int32 range")
    ll_sources(geo, depth)
    return LDScan(q, fields, None, int(end))


@functools.lru_cache(maxsize=16)
def ll_sources(geo, depth: int) -> tuple:
    """The lane of every LL grid cell's code, luma then chroma (U and V
    alike): int32 [llh, llw], the flat index ``slice * lanes + k`` of the
    unpack's lanes [N, lanes] (a slice's LL codes are the first ``nll``
    lanes of its region, ``LLGeometry``), -1 where no code lands (the code
    0). Raises ValueError where an LL code lands outside its grid (a
    geometry no encoder writes; ``ld_read``'s -2). Once a geometry."""
    ys, xs, ts = geo.y_slices, geo.x_slices, 1 << depth
    out = []
    for g in _geometries(geo, depth):
        at = g.origins(ys, xs, ts)[:, None] + g.offset[None, :]
        if at.size and (at.min() < 0 or at.max() >= g.llh * g.llw):
            raise ValueError(_LL_OUTSIDE)
        lanes = g.sh * g.sw
        if ys * xs * lanes > 2**31 - 1:
            raise ValueError("LD lanes exceed the int32 index range")
        src = np.full(g.llh * g.llw, -1, np.int32)
        src[at.ravel()] = (np.arange(ys * xs, dtype=np.int64)[:, None] * lanes
                           + np.arange(g.nll)).ravel()
        out.append(src.reshape(g.llh, g.llw))
    return tuple(out)


def ld_scan(payload, slice_sizes, geo, depth: int, qmatrix,
            start: int = 0) -> LDScan:
    """Scan an LD picture's slices in native code (``csrc/ld_scan.cpp``):
    the header fields and the LL codes (``ld_read``, span ``dec.ld_read``),
    then the LL grids dequantised with DC prediction (``ld_dequantise_grid``
    a grid, span ``dec.ld_dc``). ``payload`` is bytes, a bytearray, a
    memoryview or a uint8 array whose slices begin at byte ``start``;
    ``geo`` a ``SliceGeometry``. Raises ValueError on a corrupt geometry or
    fields, before any recurrence runs."""
    lib = _lib()
    ts = 1 << depth
    slices = (geo.luma_slice, geo.chroma_slice, geo.chroma_slice)
    with trace.span("dec.ld_read"):
        data = np.frombuffer(payload, np.uint8)
        sizes = _sizes(slice_sizes)
        n = sizes.size
        gl, gc = _geometries(geo, depth)
        offsets = [np.ascontiguousarray(g.offset, np.int64) for g in (gl, gc)]
        luma, chroma = (_LLGrid(g.sh, g.sw, g.nll, g.llh, g.llw,
                                off.ctypes.data)
                        for g, off in zip((gl, gc), offsets))
        q = np.zeros(n, np.int32)
        fields = np.zeros((4, n), np.int32)
        grids = tuple(np.zeros((g.llh, g.llw), np.int32)
                      for g in (gl, gc, gc))
        end = lib.ld_read(
            data.ctypes.data, data.size, n, start, sizes.ctypes.data,
            geo.x_slices, ts, ctypes.byref(luma), ctypes.byref(chroma),
            q.ctypes.data, fields.ctypes.data,
            *(g.ctypes.data for g in grids))
    if end == -1:
        raise ValueError("LD slice fields exceed the int32 range")
    if end < 0:
        raise ValueError(_LL_OUTSIDE)
    with trace.span("dec.ld_dc"):
        qy, qc = (qm_block(sh, sw, depth, qmatrix) for sh, sw in slices[:2])
        for grid, (sh, sw), qm in zip(grids, slices, (qy, qc, qc)):
            lib.ld_dequantise_grid(
                grid.ctypes.data, *grid.shape, geo.y_slices, geo.x_slices,
                ts, sh, sw, qm.ctypes.data, q.ctypes.data, _QF.ctypes.data,
                _QO.ctypes.data)
    return LDScan(q, fields, grids, int(end))


def dequantise_ll(grid: np.ndarray, ys: int, xs: int, ts: int, sh: int,
                  sw: int, qm_blk: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The LL DC-prediction recurrence of ``dequantise_ll_plain`` in native
    code (``csrc/ld_scan.cpp``): the values of a grid of quantised LL codes,
    int32, with the slices' q indices (int32 [ys * xs], raster order)."""
    out = np.ascontiguousarray(grid, np.int32).copy()
    qm = np.ascontiguousarray(qm_blk, np.int32)
    qs = np.ascontiguousarray(np.asarray(q).ravel(), np.int32)
    if qs.size != ys * xs or qm.size != sh * sw:
        raise ValueError(f"dequantise_ll: {qs.size} q indices, "
                         f"{qm.size} quant matrix entries")
    llh, llw = out.shape
    _lib().ld_dequantise_grid(out.ctypes.data, llh, llw, ys, xs, ts, sh, sw,
                              qm.ctypes.data, qs.ctypes.data, _QF.ctypes.data,
                              _QO.ctypes.data)
    return out


def encode_ld_slices(q_indices, lanes_y, lanes_u, lanes_v, slice_sizes):
    """Pack all LD slices from quantised lanes (int32 [N, L], lane order)
    on the host: (payload bytes, per-slice sizes int64). Raises the
    reference's error when a slice's U/V codes do not fit."""
    from vc2tpu_torch.vlc import device_pack

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    sizes = np.asarray(slice_sizes, np.int64).ravel()
    buf = device_pack.pack_ld_plain(t(lanes_y), t(lanes_u), t(lanes_v),
                                    t(np.asarray(q_indices).ravel()),
                                    t(sizes))
    flags, payload = device_pack.ld_result(buf)
    if flags & device_pack.FLAG_LD_FIT:
        raise ValueError(
            "SliceIO, LD mode: Too many bytes for the U and V slices")
    return payload.tobytes(), sizes


def _c_scale(value: int, q: int) -> int:
    """The reference's scalar inverse quantise (Quantisation.cpp:86-95)
    with int32 wrap and C truncating division."""
    q = min(max(q, 0), MAX_QINDEX)
    neg = value < 0
    v = wrap32(-value) if neg else value
    v = wrap32(v * int(QUANT_FACTORS_I32[q]))
    if v > 0:
        v = wrap32(v + int(QUANT_OFFSETS[q]))
    v = wrap32(v + 2)
    v = -(-v // 4) if v < 0 else v // 4
    return wrap32(-v) if neg else v


def _trunc3(r: int) -> int:
    return -(-r // 3) if r < 0 else r // 3


def dequantise_ll_plain(grid: np.ndarray, ys: int, xs: int, ts: int,
                        sh: int, sw: int, qm_blk: np.ndarray,
                        q: np.ndarray) -> np.ndarray:
    """The LL DC-prediction recurrence as a Python loop: each value is
    c_scale(code, adjusted q) plus the truncating mean of its left, above
    and above-left values (reference Quantisation.cpp:287-306)."""
    llh, llw = grid.shape
    out = [[0] * llw for _ in range(llh)]
    codes = grid.tolist()
    qs, qm = q.tolist(), qm_blk.tolist()
    for y in range(llh):
        yb = ((y + 1) * ys - 1) // llh
        row, up = out[y], out[y - 1] if y else None
        for x in range(llw):
            xb = ((x + 1) * xs - 1) // llw
            aq = max(qs[yb * xs + xb] - qm[((y * ts) % sh) * sw + (x * ts) % sw],
                     0)
            if y and x:
                r = wrap32(up[x - 1] + up[x] + row[x - 1])
                pred = _trunc3(wrap32(r + 1)) if r >= 0 else _trunc3(
                    wrap32(r - 1))
            elif y:
                pred = up[x]
            elif x:
                pred = row[x - 1]
            else:
                pred = 0
            row[x] = wrap32(_c_scale(codes[y][x], aq) + pred)
    return np.asarray(out, np.int32).reshape(llh, llw)


def ld_scan_plain(payload, slice_sizes, geo, depth: int, qmatrix,
                  start: int = 0) -> LDScan:
    """``ld_scan`` from ``ld_header_fields``, the plain bit reader
    (``device_unpack.unpack_signed_streams``) and a Python loop of the
    recurrence: the reference of the native scan."""
    q, s_bits, len_bits, y_bits, uv_bits, end = ld_header_fields(
        payload, slice_sizes, start)
    fields = _fields(s_bits, len_bits, y_bits, uv_bits)
    pay = torch.from_numpy(np.array(np.frombuffer(payload, np.uint8)))
    luma, chroma = device_unpack.ld_regions(torch.from_numpy(fields))
    ts = 1 << depth
    ys, xs = geo.y_slices, geo.x_slices
    gl, gc = _geometries(geo, depth)
    lly = device_unpack.unpack_signed_streams(
        pay, luma, torch.from_numpy(fields[2]), gl.nll).numpy()
    lluv = device_unpack.unpack_signed_streams(
        pay, chroma, torch.from_numpy(fields[3]), 2 * gc.nll).numpy()
    grids = []
    for g, codes, (sh, sw) in ((gl, lly, geo.luma_slice),
                               (gc, lluv[:, 0::2], geo.chroma_slice),
                               (gc, lluv[:, 1::2], geo.chroma_slice)):
        at = g.origins(ys, xs, ts)[:, None] + g.offset[None, :]
        if at.size and (at.min() < 0 or at.max() >= g.llh * g.llw):
            raise ValueError(_LL_OUTSIDE)
        grid = np.zeros((g.llh, g.llw), np.int32)
        grid.ravel()[at] = codes
        grids.append(dequantise_ll_plain(grid, ys, xs, ts, sh, sw,
                                         qm_block(sh, sw, depth, qmatrix), q))
    return LDScan(q, fields, tuple(grids), end)
