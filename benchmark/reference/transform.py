"""The quantiser, the LeGall wavelet and the slice layout of the reference
codec, in plain PyTorch on any device.

Frozen copies of the plain forms of the port's ``quant/quantiser.py``,
``wavelet/lifting.py``, ``wavelet/matrices.py`` and ``slices/layout.py``,
cut to the LeGall (5, 3) kernel (SMPTE ST 2042-1 section 15.4.2): the
quantiser of Quantisation.cpp:16-95 with the int32 wrap of the reference,
the lifting ladders with clamped taps (edge replication), the subbands'
lane order in a slice. Nothing of the program is imported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def wrap32(x):
    """Wrap an int64 (or wider) value into int32 two's-complement range."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def rationalise(numerator: int, denominator: int):
    """Reduce a fraction to simplest form (reference Utils.cpp:65)."""
    g = math.gcd(numerator, denominator)
    if g == 0:
        return numerator, denominator
    return numerator // g, denominator // g


# --- the quantiser ---------------------------------------------------------

# VC-2 quantisation factor table, quant_factor(q) for q in [0, 119]
# (SMPTE ST 2042-1; reference Quantisation.cpp:42-59).
QUANT_FACTORS = np.array([
    0x000000004, 0x000000005, 0x000000006, 0x000000007, 0x000000008, 0x00000000A, 0x00000000B, 0x00000000D,
    0x000000010, 0x000000013, 0x000000017, 0x00000001B, 0x000000020, 0x000000026, 0x00000002D, 0x000000036,
    0x000000040, 0x00000004C, 0x00000005B, 0x00000006C, 0x000000080, 0x000000098, 0x0000000B5, 0x0000000D7,
    0x000000100, 0x000000130, 0x00000016A, 0x0000001AF, 0x000000200, 0x000000261, 0x0000002D4, 0x00000035D,
    0x000000400, 0x0000004C2, 0x0000005A8, 0x0000006BA, 0x000000800, 0x000000983, 0x000000B50, 0x000000D74,
    0x000001000, 0x000001307, 0x0000016A1, 0x000001AE9, 0x000002000, 0x00000260E, 0x000002D41, 0x0000035D1,
    0x000004000, 0x000004C1C, 0x000005A82, 0x000006BA2, 0x000008000, 0x000009838, 0x00000B505, 0x00000D745,
    0x000010000, 0x000013070, 0x000016A0A, 0x00001AE8A, 0x000020000, 0x0000260E0, 0x00002D414, 0x000035D14,
    0x000040000, 0x00004C1C0, 0x00005A828, 0x00006BA28, 0x000080000, 0x00009837F, 0x0000B504F, 0x0000D7450,
    0x000100000, 0x0001306FE, 0x00016A09E, 0x0001AE8A0, 0x000200000, 0x000260DFC, 0x0002D413D, 0x00035D13F,
    0x000400000, 0x0004C1BF8, 0x0005A827A, 0x0006BA27E, 0x000800000, 0x0009837F0, 0x000B504F3, 0x000D744FD,
    0x001000000, 0x001306FE1, 0x0016A09E6, 0x001AE89FA, 0x002000000, 0x00260DFC1, 0x002D413CD, 0x0035D13F3,
    0x004000000, 0x004C1BF83, 0x005A8279A, 0x006BA27E6, 0x008000000, 0x009837F05, 0x00B504F33, 0x00D744FCD,
    0x010000000, 0x01306FE0A, 0x016A09E66, 0x01AE89F99, 0x020000000, 0x0260DFC14, 0x02D413CCD, 0x035D13F33,
    0x040000000, 0x04C1BF829, 0x05A82799A, 0x06BA27E65, 0x080000000, 0x09837F052, 0x0B504F334, 0x0D744FCCB,
], dtype=np.int64)

MAX_QINDEX = len(QUANT_FACTORS) - 1  # 119

# int32-wrapped views — the reference casts the uint32 table entries to int,
# so factors >= 2^31 become negative int32 values (Quantisation.cpp:65).
QUANT_FACTORS_I32 = QUANT_FACTORS.astype(np.uint32).astype(np.int32)

# quant_offset(q) (reference Quantisation.cpp:78-83), evaluated on the
# int32-wrapped factor with C truncating division.
_qf64 = QUANT_FACTORS_I32.astype(np.int64)
_off = np.where(_qf64 >= 0, (_qf64 + 1) // 2, -((-(_qf64 + 1)) // 2))
QUANT_OFFSETS = np.where(
    np.arange(len(QUANT_FACTORS)) == 0, 1,
    np.where(np.arange(len(QUANT_FACTORS)) == 1, 2, _off),
).astype(np.int32)



def adjust_quant_index(q_index, q_matrix):
    """max(qIndex - qMatrix, 0) (reference Quantisation.cpp:16-20)."""
    return torch.clamp(q_index - q_matrix, min=0)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    return (torch.as_tensor(QUANT_FACTORS_I32.astype(np.int64), device=device),
            torch.as_tensor(QUANT_OFFSETS.astype(np.int64), device=device))


def _scale_core(v, qf, qo):
    """Inverse quantise int32 values held in int64 tensors, with the
    reference's int32 wrap at every step (|INT_MIN| and the wrapped table
    entries at q 116-119 included)."""
    mag = wrap32(v.abs())
    prod = wrap32(mag * qf)                          # int32 wrap
    prod = wrap32(prod + torch.where(prod > 0, qo, 0) + 2)
    out = torch.where(prod < 0, -(wrap32(-prod) >> 2), prod >> 2)  # trunc /4
    return wrap32(torch.where(v < 0, -out, out)).to(torch.int32)


def quant(values: torch.Tensor, q_indices: torch.Tensor) -> torch.Tensor:
    """Element-wise dead-zone quantise (reference Quantisation.cpp:69-76):
    ``sign(v) * ((|v| << 2) / quant_factor(q))`` with C truncating
    division by the int32-wrapped factor, so the wrapped (negative) table
    entries at q 116-119 flip the sign. ``q_indices`` broadcasts against
    ``values`` and clamps to [0, 119]. The division is exact in int64 (the
    JAX package's float32 reciprocal answered the TPU's lack of an integer
    divide); the result equals the reference wherever its ``<< 2`` does not
    overflow int32 (|v| < 2^29)."""
    qf_t, _ = _device_tables(values.device)
    q = torch.clamp(q_indices.to(torch.int64), 0, MAX_QINDEX)
    qf = qf_t[q]
    v = values.to(torch.int64)
    out = torch.div(v.abs() << 2, qf.abs(), rounding_mode="floor")
    out = torch.where(qf < 0, -out, out)
    return wrap32(torch.where(v < 0, -out, out)).to(torch.int32)


def scale(values: torch.Tensor, q_indices: torch.Tensor) -> torch.Tensor:
    """Element-wise inverse quantise (reference Quantisation.cpp:86-95);
    ``q_indices`` broadcasts against ``values`` and clamps to [0, 119]."""
    qf_t, qo_t = _device_tables(values.device)
    q = torch.clamp(q_indices.to(torch.int64), 0, MAX_QINDEX)
    return _scale_core(values.to(torch.int64), qf_t[q], qo_t[q])


# --- banded forms ----------------------------------------------------------
# A slice's lanes are contiguous by subband (slices/layout.lane_order) and
# the quant matrix is constant within a subband, so the tables are looked
# up per (slice, band) and broadcast along the bands' lanes.


def quant_lanes(lanes: torch.Tensor, q: torch.Tensor,
                qm: torch.Tensor) -> torch.Tensor:
    """``quant`` of [N, L] lanes at each lane's adjusted index max(q[slice]
    - qm[lane], 0)."""
    aq = adjust_quant_index(q.to(torch.int64)[:, None],
                            qm.to(torch.int64)[None, :])
    return quant(lanes, aq)


def scale_lanes(lanes: torch.Tensor, q: torch.Tensor,
                qm: torch.Tensor) -> torch.Tensor:
    """``scale`` of [N, L] lanes at each lane's adjusted index."""
    aq = adjust_quant_index(q.to(torch.int64)[:, None],
                            qm.to(torch.int64)[None, :])
    return scale(lanes, aq)


# --- the LeGall (5, 3) wavelet ---------------------------------------------

# (target parity, sign, ((offset, coefficient), ...), add, shift):
# target 'o': o[i] (sign)= (sum coeff * e[i + off] + add) >> shift, and
# 'e' the other way (reference WaveletTransform.cpp:595-698)
LEGALL_STEPS = (
    ("o", -1, ((0, 1), (1, 1)), 1, 1),
    ("e", +1, ((-1, 1), (0, 1)), 2, 2),
)
LEGALL_SHIFT = 1          # the transform's accuracy bit
# (alpha, beta, shift): the subband gain model (WaveletTransform.cpp:353-396)
LEGALL_GAIN = (1.224744871, 0.847791248, 1)


def ladder(invert: bool):
    """The step list one level runs: the inverse is the reversed list with
    flipped signs."""
    if not invert:
        return LEGALL_STEPS
    return tuple((t, -s, taps, add, sh)
                 for (t, s, taps, add, sh) in reversed(LEGALL_STEPS))


def _apply_steps(e, o, steps, dim: int):
    """One predict/update ladder along ``dim`` on int64 parity planes that
    hold int32 values; tap indices clamp to [0, n-1] (edge replication)."""
    for target, sign, taps, add, sh in steps:
        src = e if target == "o" else o
        n = src.shape[dim]
        idx = torch.arange(n, device=src.device)
        acc = None
        for off, coeff in taps:
            term = coeff * src.index_select(dim, (idx + off).clamp(0, n - 1))
            acc = term if acc is None else acc + term
        delta = wrap32(acc + add) >> sh if sh else wrap32(acc)
        if target == "o":
            o = wrap32(o + sign * delta)
        else:
            e = wrap32(e + sign * delta)
    return e, o


def _split(v, dim: int):
    if dim == 0:
        return v[0::2], v[1::2]
    return v[:, 0::2], v[:, 1::2]


def _interleave(e, o, dim: int):
    shape = list(e.shape)
    shape[dim] *= 2
    return torch.stack([e, o], dim=dim + 1).reshape(shape)


def padded_size(size: int, depth: int) -> int:
    """Pad to a multiple of 2**depth (reference WaveletTransform.cpp:74-77)."""
    cell = 1 << depth
    return cell * ((size + cell - 1) // cell)


def wavelet_pad(plane: torch.Tensor, depth: int) -> torch.Tensor:
    """Edge-replication pad to multiples of 2**depth
    (reference WaveletTransform.cpp:79-94)."""
    h, w = plane.shape[-2], plane.shape[-1]
    ph, pw = padded_size(h, depth), padded_size(w, depth)
    if (ph, pw) == (h, w):
        return plane
    rows = torch.arange(ph, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=plane.device).clamp(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def forward_bands(plane: torch.Tensor, depth: int) -> list:
    """Forward DWT of an already-padded (h, w) plane as a list of int32
    subband arrays [LL, then (HL, LH, HH) a level, coarsest first]: per
    level the accuracy shift, the horizontal ladder, then the vertical
    ladder on each half."""
    steps = ladder(False)
    x = plane.to(torch.int64)
    fine_to_coarse = []
    for _ in range(depth):
        x = wrap32(x << LEGALL_SHIFT)
        he, ho = _apply_steps(*_split(x, 1), steps, 1)
        ll, lh = _apply_steps(*_split(he, 0), steps, 0)
        hl, hh = _apply_steps(*_split(ho, 0), steps, 0)
        fine_to_coarse.append((hl, lh, hh))
        x = ll
    bands = [x]
    for level in reversed(fine_to_coarse):
        bands.extend(level)
    return [b.to(torch.int32) for b in bands]


def inverse_bands(bands, depth: int) -> torch.Tensor:
    """Inverse DWT from subband arrays back to the (padded) plane, int32:
    per level, coarsest first, the vertical ladder on (LL, LH) and on (HL,
    HH), the horizontal ladder, then the rounded unshift."""
    steps = ladder(True)
    x = bands[0].to(torch.int64)
    for level in range(depth):
        hl, lh, hh = (b.to(torch.int64)
                      for b in bands[1 + 3 * level:4 + 3 * level])
        he = _interleave(*_apply_steps(x, lh, steps, 0), 0)
        ho = _interleave(*_apply_steps(hl, hh, steps, 0), 0)
        x = _interleave(*_apply_steps(he, ho, steps, 1), 1)
        x = wrap32(x + (1 << (LEGALL_SHIFT - 1))) >> LEGALL_SHIFT
    return x.to(torch.int32)


def band_dims(padded_h: int, padded_w: int, depth: int) -> list:
    """(h, w) of each band in ``forward_bands`` order."""
    dims = [(padded_h >> depth, padded_w >> depth)]
    for level in range(1, depth + 1):
        s = 1 << (depth + 1 - level)
        dims.extend([(padded_h // s, padded_w // s)] * 3)
    return dims


def bands_to_lanes(bands, y_slices: int, x_slices: int) -> torch.Tensor:
    """Subband arrays -> (nSlices, L) lanes in serialisation order
    (band-major, raster within each band's slice sub-block)."""
    parts = []
    for b in bands:
        h, w = b.shape
        sh, sw = h // y_slices, w // x_slices
        t = b.reshape(y_slices, sh, x_slices, sw).permute(0, 2, 1, 3)
        parts.append(t.reshape(y_slices * x_slices, sh * sw))
    return torch.cat(parts, dim=1)


def lanes_to_bands(lanes: torch.Tensor, y_slices: int, x_slices: int,
                   dims) -> list:
    """Inverse of ``bands_to_lanes``; ``dims`` from ``band_dims``."""
    bands, pos = [], 0
    for h, w in dims:
        sh, sw = h // y_slices, w // x_slices
        t = lanes[:, pos:pos + sh * sw].reshape(y_slices, x_slices, sh, sw)
        bands.append(t.permute(0, 2, 1, 3).reshape(h, w))
        pos += sh * sw
    return bands


def band_sizes(slice_h: int, slice_w: int, depth: int) -> tuple:
    """Lanes of each band in a slice, in lane order: LL, then (HL, LH, HH)
    a level, coarsest first, each a (slice_h, slice_w) >> its level block."""
    sizes = [(slice_h >> depth) * (slice_w >> depth)]
    for level in range(1, depth + 1):
        s = depth + 1 - level
        sizes += [(slice_h >> s) * (slice_w >> s)] * 3
    return tuple(sizes)


def quant_matrix(depth: int) -> np.ndarray:
    """The default LeGall quantisation matrix, int32[3*depth+1], ordered
    [LL, (HL, LH, HH) per level from lowest to highest frequency]
    (reference WaveletTransform.cpp:353-426)."""
    if depth == 0:
        return np.zeros(1, dtype=np.int32)
    alpha32 = np.float32(LEGALL_GAIN[0])
    beta32 = np.float32(LEGALL_GAIN[1])
    shift = LEGALL_GAIN[2]
    a2 = np.float32(alpha32 * alpha32)
    ab = np.float32(alpha32 * beta32)
    b2 = np.float32(beta32 * beta32)
    ll = np.zeros(depth + 1, dtype=np.float32)
    lh = np.zeros(depth + 1, dtype=np.float32)
    hh = np.zeros(depth + 1, dtype=np.float32)
    min_gain = np.float32(np.finfo(np.float32).max)
    for level in range(depth, 0, -1):
        # double pow() ratio, truncated to float32 on assignment
        scale_ = np.float32(math.pow(float(a2), depth - level)
                            / math.pow(2.0, shift * (depth - level + 1)))
        ll[level] = np.float32(scale_ * a2)
        lh[level] = np.float32(scale_ * ab)
        hh[level] = np.float32(scale_ * b2)
        min_gain = min(min(ll[level], lh[level], hh[level]), min_gain)

    def q(gain: np.float32) -> int:
        ratio = np.float32(gain / min_gain)           # float32 division
        return int(math.floor(4.0 * math.log(float(ratio)) / math.log(2.0)
                              + 0.5))

    out = np.zeros(3 * depth + 1, dtype=np.int32)
    out[0] = q(ll[1])
    idx = 1
    for level in range(1, depth + 1):
        out[idx] = q(lh[level])
        out[idx + 1] = q(lh[level])
        out[idx + 2] = q(hh[level])
        idx += 3
    return out


def lane_qm(qmatrix, sizes) -> np.ndarray:
    """The quant matrix entry of every lane of a slice, int32 [L]."""
    return np.repeat(np.asarray(qmatrix, np.int32)[:len(sizes)],
                     np.asarray(sizes, np.int64)).astype(np.int32)


def slice_count(depth: int, luma: int, chroma: int, n_size: int) -> int:
    """Slices along one axis for a slice size of ``n_size`` units of
    2**depth (reference WaveletTransform.cpp:116-136); 0 when invalid."""
    max_slices = min(luma, chroma) >> depth
    if n_size <= 0 or n_size > max_slices:
        return 0
    size = n_size << depth
    pl, pc = padded_size(luma, depth), padded_size(chroma, depth)
    n = (pl + size - 1) // size
    cell = 1 << depth
    if (pl % n == 0 and (pl // n) % cell == 0 and pc % n == 0
            and (pc // n) % cell == 0):
        return n
    return 0
