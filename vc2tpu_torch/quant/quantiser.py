"""Dead-zone quantiser and inverse quantiser, as torch ops.

Port of ``vc2tpu.quant.quantiser``, bit-exact against the reference scalar
functions (reference src/Library/src/Quantisation.cpp:16-95):

* ``quant(v, q)  = sign(v) * ((|v| << 2) / quant_factor(q))``
* ``scale(v, q)  = sign(v) * ((|v| * quant_factor(q) [+offset] + 2) / 4)``
* ``adjust(qIndex, qMatrix) = max(qIndex - qMatrix, 0)``

with C truncating division and int32 wrap-around (the reference's
``value *= quant_factor(q)`` wraps int32 for extreme values). The int32
arithmetic is formed in int64 and wrapped explicitly.

The quant_factor table is the 120-entry VC-2 standard table
(Quantisation.cpp:40-66); it is *data* from SMPTE ST 2042-1, so it is
tabulated, not derived. Indices above 119 raise in the reference; the
device lookup clamps them to 119.

The per-element lookup is a plain gather, and the banded forms
(``scale_banded``, ``quant_banded``) gather per (slice, band): the one-hot
matmul lookup of the JAX package (``banded_lookup``, ``pack_tables``,
``mxu_tables_enabled``) worked around slow TPU gathers and is not carried
over.
"""

from __future__ import annotations

import numpy as np
import torch

from vc2tpu_torch.core import capture
from vc2tpu_torch.core.intmath import wrap32

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


def quant_factor(q: int) -> int:
    if q > MAX_QINDEX:
        raise ValueError("quantization index exceeds maximum implemented value.")
    return int(QUANT_FACTORS_I32[max(q, 0)])


def quant_offset(q: int) -> int:
    return int(QUANT_OFFSETS[max(q, 0)])


def adjust_quant_index(q_index, q_matrix):
    """max(qIndex - qMatrix, 0) (reference Quantisation.cpp:16-20)."""
    return torch.clamp(q_index - q_matrix, min=0)


@capture.device_cache(maxsize=None)
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


# --- banded forms ------------------------------------------------------------
# A slice's lanes are contiguous by subband (slices/layout.lane_order) and
# the quant matrix is constant within a subband, so the tables are looked
# up per (slice, band) and broadcast along the bands' lanes.

def expand_bands(p: torch.Tensor, band_sizes: tuple) -> torch.Tensor:
    """(..., B) per-band values -> (..., L) per-lane values."""
    sizes = torch.as_tensor(band_sizes, device=p.device)
    return torch.repeat_interleave(p, sizes, dim=-1)


def banded_aq(q: torch.Tensor, qm_bands) -> torch.Tensor:
    """Adjusted quant index per (..., band), max(q - qm, 0) clamped to the
    table, int32."""
    qm = torch.as_tensor(qm_bands, device=q.device).to(torch.int64)
    aq = torch.clamp(q.to(torch.int64)[..., None] - qm, 0, MAX_QINDEX)
    return aq.to(torch.int32)


def scale_tables(q: torch.Tensor, qm_bands) -> tuple:
    """(wrapped factor, offset) per (..., band) at the adjusted indices,
    int64."""
    qf, qo = _device_tables(q.device)
    aq = banded_aq(q, qm_bands).to(torch.int64)
    return qf[aq], qo[aq]


def quant_tables(q: torch.Tensor, qm_bands) -> tuple:
    """(|factor| clamped to int32, wrapped factor) per (..., band) at the
    adjusted indices, int64. The division is exact, so no reciprocal goes
    with them."""
    qf, _ = _device_tables(q.device)
    wrapped = qf[banded_aq(q, qm_bands).to(torch.int64)]
    return wrapped.abs().clamp(max=(1 << 31) - 1), wrapped


def quant_banded(values: torch.Tensor, q: torch.Tensor, qm_bands,
                 band_sizes: tuple) -> torch.Tensor:
    """``quant`` of band-contiguous lanes (..., N, L) with per-slice q
    (..., N); ``qm_bands`` is the (B,) quant matrix."""
    return quant(values, expand_bands(banded_aq(q, qm_bands), band_sizes))


def scale_banded(values: torch.Tensor, q: torch.Tensor, qm_bands,
                 band_sizes: tuple) -> torch.Tensor:
    """``scale`` of band-contiguous lanes with per-slice q."""
    qf_b, qo_b = scale_tables(q, qm_bands)
    return _scale_core(values.to(torch.int64), expand_bands(qf_b, band_sizes),
                       expand_bands(qo_b, band_sizes))
