"""The HQ profile's rate control and slice packing, in plain PyTorch.

Frozen copies of the plain forms of the port's ``rdo/cbr.py``
(``cbr_quant_indices_plain``, the reference's EncodeStream.cpp:73-125 over
Quantisation.cpp:627-642) and ``vlc/device_pack.py`` (``pack_hq_plain``,
Slices.cpp:305-467). The search reports how many luma error passes each
slice made, which the kernel counts of ``kernels/hq_cbr.py`` read.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.golomb import signed_codes
from reference.transform import quant_lanes, rationalise, scale_lanes, wrap32

PROBES = (32, 16, 8, 4, 2, 1, 0)   # the deltas after each of the 7 probes


def slice_bytes_map(y_slices: int, x_slices: int, total_bytes: int,
                    scalar: int) -> np.ndarray:
    """HQ CBR per-slice byte budget by rational residue spread (reference
    Slices.cpp:28-49), int32 [ySlices * xSlices]."""
    n = y_slices * x_slices
    num, den = rationalise(total_bytes // scalar - 4 * n, n)
    ratio = num // den
    remainder = num - ratio * den
    k = np.arange(n, dtype=np.int64)
    bump = ((k + 1) * remainder) // den - (k * remainder) // den
    return ((ratio + bump) * scalar + 4).astype(np.int32)


def component_bytes(lanes, nbits, scalar: int):
    """Scaled bytes of each slice's component (reference Slices.cpp:97-119):
    bits up to the last non-zero coefficient, in whole bytes, in whole
    units of ``scalar``."""
    n, length = lanes.shape
    idx = torch.arange(length, device=lanes.device)
    last = torch.where(lanes != 0, idx, -1).amax(1) if length else \
        torch.full((n,), -1, dtype=torch.int64, device=lanes.device)
    used = nbits.sum(1) - (length - 1 - last)
    return ((used + 7) // 8 + scalar - 1) // scalar


def slice_bytes(y, u, v, qm_y, qm_c, q, scalar: int):
    """Bytes of each slice's three components at its index q (int64 [N])."""
    total = 0
    for lanes, qm in ((y, qm_y), (u, qm_c), (v, qm_c)):
        ql = quant_lanes(lanes, q, qm)
        _, nbits = signed_codes(ql)
        total = total + scalar * component_bytes(ql, nbits, scalar)
    return total


def luma_error(y, qm_y, q):
    """Sum over each slice's luma lanes of d * d (int64, wrapping), d the
    int32-wrapped difference of a lane and its reconstruction at q."""
    d = wrap32(y.to(torch.int64)
               - scale_lanes(quant_lanes(y, q, qm_y), q, qm_y).to(torch.int64))
    return (d * d).sum(1)


def cbr_quant_indices(y, u, v, qm_y, qm_c, budgets, scalar: int):
    """Each slice's quantisation index: the reference's 7-probe bisection
    (trial 63, best 127; best = trial where the slice fits and trial <
    best, then trial -= delta where it fits, else += delta), then the hill
    climb (q += 1 while the luma error at q + 1 is strictly below that at
    q). Returns (q int32 [N], luma error passes a slice int64 [N])."""
    available = budgets.to(torch.int64) - 4
    trial = torch.full((y.shape[0],), 63, dtype=torch.int64, device=y.device)
    q = torch.full_like(trial, 127)
    for delta in PROBES:
        fits = slice_bytes(y, u, v, qm_y, qm_c, trial, scalar) <= available
        q = torch.where(fits & (trial < q), trial, q)
        trial = torch.where(fits, trial - delta, trial + delta)
    passes = torch.full_like(q, 2)
    prev = luma_error(y, qm_y, q)
    active = torch.arange(y.shape[0], device=y.device)
    while active.numel():
        nxt = q[active] + 1
        cur = luma_error(y[active], qm_y, nxt)
        up = cur < prev[active]
        active = active[up]
        q[active] = nxt[up]
        prev[active] = cur[up]
        passes[active] += 1
    return q.to(torch.int32), passes


def pack(qy, qu, qv, q_idx, prefix: int, scalar: int, slice_sizes=None):
    """Every slice of a picture from its quantised lanes: ``prefix`` zero
    bytes, the qIndex byte, then per component a length byte (bytes /
    scalar) and its codes, cut at the component's bound and zero-filled;
    with ``slice_sizes`` (HQ CBR) the third component fills the slice.
    Returns (payload uint8 tensor, slice totals int64 [N])."""
    dev = qy.device
    comps = (qy, qu, qv)
    codes = [signed_codes(c) for c in comps]
    scaled = [component_bytes(c, nb, scalar) for c, (_, nb) in
              zip(comps, codes)]
    if bool((scaled[0] > 255).any() | (scaled[1] > 255).any()):
        raise ValueError("Slice scalar is too small")
    yb, ub = scaled[0] * scalar, scaled[1] * scalar
    if slice_sizes is not None:
        vb = slice_sizes.to(torch.int64) - 4 - yb - ub
        if bool((vb < scaled[2] * scalar).any()):
            raise ValueError("SliceIO, HQ CBR mode: Too many bytes for the "
                             "slice")
    else:
        vb = scaled[2] * scalar
    if bool((torch.div(vb, scalar, rounding_mode="trunc") > 255).any()
            | (q_idx > 255).any()):
        raise ValueError("a length or qIndex byte exceeds 8 bits")
    totals = prefix + 4 + yb + ub + vb
    starts = torch.cumsum(totals, 0) - totals
    total = int(totals.sum())
    bits = torch.zeros(8 * total, dtype=torch.int64, device=dev)
    data_at = (prefix + 2, prefix + 3 + yb, prefix + 4 + yb + ub)
    for (code, nb), at, nbytes in zip(codes, data_at, (yb, ub, vb)):
        cum = torch.cumsum(nb, 1) - nb
        keep = torch.minimum((8 * nbytes[:, None] - cum).clamp(min=0), nb)
        kept = torch.where(keep > 0, code >> (nb - keep), 0)
        pos = 8 * (starts + at)[:, None] + cum
        for j in range(64):
            live = j < keep
            if not bool(live.any()):
                break
            one = live & (((kept >> (keep - 1 - j).clamp(min=0)) & 1) == 1)
            bits[pos[one] + j] = 1
    weights = 1 << torch.arange(7, -1, -1, device=dev)
    payload = (bits.view(-1, 8) * weights).sum(1)
    for at, value in ((prefix, q_idx.to(torch.int64)),
                      (prefix + 1, yb // scalar),
                      (prefix + 2 + yb, ub // scalar),
                      (prefix + 3 + yb + ub, vb // scalar)):
        payload[starts + at] = value & 0xFF
    return payload.to(torch.uint8), totals
