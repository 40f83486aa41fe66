"""The LD profile's rate control and slice packing, in plain PyTorch.

Frozen copies of the plain forms of the port's ``rdo/ld.py``
(``ld_rate_control_plain``: the reference's EncodeStream.cpp:195-245 over
Quantisation.cpp:191-234) and ``vlc/device_pack.py`` (``pack_ld_plain``),
with one change: the LL recurrence runs the slices of a diagonal of every
picture of a batch in lockstep, so the 8 pictures of a cell cost the steps
of one. Each slice's index comes from the reference's 7-probe bisection
over its bits at every trial; the LL band is coded against a DC
prediction from the reconstructions of its left, above and above-left
neighbours, which the decode of the stream starts from (``rec``).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.golomb import (_code_bits, interleave, signed_codes,
                              truncated_bits)
from reference.transform import (MAX_QINDEX, QUANT_FACTORS_I32,
                                 QUANT_OFFSETS, _scale_core, lane_qm,
                                 quant_lanes, wrap32)

PROBES = (32, 16, 8, 4, 2, 1, 0)   # the deltas after each of the 7 probes
TRIALS = 128             # a body table row: trials 0-126, and 127 (unused)
MONOTONE_MAX = 115       # the factors rise with the index up to here
# the least |factor| of the wrapped indices 116-119: a lane of |v| << 2
# below it quantises to 0 there
WRAP_MIN = int(np.abs(QUANT_FACTORS_I32[MONOTONE_MAX + 1:].astype(
    np.int64)).min())


def len_bits_of(sizes: np.ndarray) -> np.ndarray:
    """``intlog2(8 * size - 7)`` of every slice size, int64."""
    x = 8 * np.asarray(sizes, np.int64) - 8
    return np.where(x > 0, np.frexp(np.maximum(x, 1))[1], 0).astype(np.int64)


def avail_bits(budgets) -> np.ndarray:
    """The bits each slice's codes may take, int32 [N]: 8 b - 7 -
    intlog2(8 b - 7) for a budget of b bytes (EncodeStream.cpp:210-212)."""
    b = np.asarray(budgets, np.int64).ravel()
    return (8 * b - 7 - len_bits_of(b)).astype(np.int32)


def body_table(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c):
    """The body lanes' share of a probe's bits at every trial, int32 [N, 2,
    TRIALS] on the lanes' device: [:, 0, t] luma, [:, 1, t] chroma (u and v
    interleaved), at trial t in 0-126 (column 127 is 0). An entry is the
    component's body code bits up to its last non-zero body code (what
    ``by - (body_y - 1 - last_y)`` is in csrc/ld_rate.cu), 0 where every
    body code is 0. Each body lane is quantised at clamp(t - qm[lane], 0,
    119).

    Up to index 115 a lane's magnitude does not rise with the index, so
    once every lane is 0 the trials up to the wrapped factors (116-119,
    ``WRAP_MIN``) are 0 too and are skipped; those the wrapped factors
    reach are computed."""
    dev = lanes_y.device
    n = lanes_y.shape[0]
    table = torch.zeros((n, 2, TRIALS), dtype=torch.int32, device=dev)
    absqf = torch.as_tensor(np.abs(QUANT_FACTORS_I32.astype(np.int64)),
                            device=dev)
    qm_np = np.asarray(qm, np.int64)
    for c, (parts, bs) in enumerate((((lanes_y,), bs_y),
                                     ((lanes_u, lanes_v), bs_c))):
        nll = bs[0]
        nums = [x[:, nll:].to(torch.int64).abs() << 2 for x in parts]
        body = nums[0].shape[1]
        if not body:
            continue
        qm_body = torch.as_tensor(lane_qm(qm_np, bs)[nll:].astype(np.int64),
                                  device=dev)
        pos = torch.arange(body, device=dev)
        # each lane's position in code order (chroma: u0 v0 u1 v1 ...)
        where = [pos] if c == 0 else [2 * pos, 2 * pos + 1]
        big = sum((x >= WRAP_MIN).any(0).to(torch.int64) for x in nums) > 0
        wrap_at = int((qm_body[big] + MONOTONE_MAX + 1).min()) \
            if bool(big.any()) else TRIALS - 1
        last_monotone = MONOTONE_MAX + int(qm_body.min())
        t = 0
        while t < TRIALS - 1:
            aq = (t - qm_body).clamp(0, MAX_QINDEX)
            excess, last, any_nz = 0, -1, False
            for num, p in zip(nums, where):
                mag = num // absqf[aq]
                nz = mag != 0
                excess = excess + torch.where(nz, _code_bits(mag) - 1,
                                              0).sum(1)
                last = torch.maximum(torch.as_tensor(last, device=dev),
                                     torch.where(nz, p, -1).amax(1))
                any_nz = any_nz or bool(nz.any())
            table[:, c, t] = torch.where(last >= 0, excess + last + 1,
                                         0).to(torch.int32)
            t += 1
            if not any_nz and t - 1 <= last_monotone:
                t = max(t, wrap_at)
    return table


def walk_fits(fits):
    """The reference's bisection over a fits mask: ``fits`` bool [K, T >=
    127] says whether each slice fits at each trial; returns the best index
    of each slice, int64 [K]. Trial 63, best 127; after each probe best =
    trial where it fits and trial < best, then trial -= delta where it
    fits, else += delta, for delta 32, 16, 8, 4, 2, 1, 0."""
    trial = torch.full((fits.shape[0],), 63, dtype=torch.int64,
                       device=fits.device)
    best = torch.full_like(trial, 127)
    for delta in PROBES:
        f = fits.gather(1, trial[:, None])[:, 0]
        best = torch.where(f & (trial < best), trial, best)
        trial = torch.where(f, trial - delta, trial + delta)
    return best


def _ll_counts(codes):
    """(gross bits, bits up to the last non-zero code) of each row of LL
    codes in code order, int64 [K] each."""
    return _code_bits(codes).sum(1), truncated_bits(codes)


class _LLBand:
    """The LL band of the three components of P pictures: each one's
    reconstructed values of the finished slices ([P, R lh, C lw], int64),
    and the LL pass of the slices of a diagonal of every picture, the three
    components in one batch, each LL block padded to the largest (a padded
    cell comes after every real cell it could feed, so it changes none).
    Slice ``s`` of the batch is slice ``s % (R C)`` of picture ``s // (R
    C)``."""

    def __init__(self, lanes, shapes, qm_ll: int, pictures: int, rows: int,
                 cols: int):
        self.shapes, self.qm_ll = shapes, qm_ll
        self.lh = max(lh for lh, _ in shapes)
        self.lw = max(lw for _, lw in shapes)
        dev = lanes[0].device
        n = lanes[0].shape[0]
        self.vals = torch.zeros((3, n, self.lh, self.lw), dtype=torch.int64,
                                device=dev)
        for c, (x, (lh, lw)) in enumerate(zip(lanes, shapes)):
            self.vals[c, :, :lh, :lw] = x[:, :lh * lw].reshape(n, lh, lw)
        self.rec = [torch.zeros((pictures, rows * lh, cols * lw),
                                dtype=torch.int64, device=dev)
                    for lh, lw in shapes]
        qf, qo = (torch.as_tensor(t.astype(np.int64), device=dev)
                  for t in (QUANT_FACTORS_I32, QUANT_OFFSETS))
        self.tables = (qf, qf.abs(), qo)

    def borders(self, p, v, h):
        """[3, K, lh + 1, lw + 1]: row 0 holds the above slices' bottom rows
        and the above-left corners, column 0 the left slices' right
        columns, 0 where a slice lies on the picture's top or left edge."""
        k = v.numel()
        pad = torch.zeros((3, k, self.lh + 1, self.lw + 1),
                          dtype=torch.int64, device=v.device)
        pc = p[:, None]
        for c, (rec, (lh, lw)) in enumerate(zip(self.rec, self.shapes)):
            y0, x0 = v * lh, h * lw
            ys = (y0 - 1).clamp(min=0)[:, None]
            xs = (x0 - 1).clamp(min=0)[:, None]
            jj = torch.arange(lw, device=v.device)[None, :]
            ii = torch.arange(lh, device=v.device)[None, :]
            pad[c, :, 0, 1:lw + 1] = torch.where(
                (v > 0)[:, None], rec[pc, ys, x0[:, None] + jj], 0)
            pad[c, :, 1:lh + 1, 0] = torch.where(
                (h > 0)[:, None], rec[pc, y0[:, None] + ii, xs], 0)
            pad[c, :, 0, 0] = torch.where((v > 0) & (h > 0),
                                          rec[p, ys[:, 0], xs[:, 0]], 0)
        return pad

    def trial(self, s, v, h, pad, q):
        """Quantise the LL blocks of slices ``s`` (at (v, h)) at index q
        (int64 [K]) against the borders ``pad`` (filled in place with the
        reconstructions); returns each component's codes, int64 [K, nLL]."""
        qf_t, absqf_t, qo_t = self.tables
        aq = (q - self.qm_ll).clamp(0, MAX_QINDEX)
        qf, absqf, qo = qf_t[aq], absqf_t[aq], qo_t[aq]
        vals = self.vals[:, s]
        codes = torch.empty_like(vals)
        up0, left0 = v > 0, h > 0
        for i in range(self.lh):
            for j in range(self.lw):
                a, b, c = pad[:, :, i, j], pad[:, :, i, j + 1], \
                    pad[:, :, i + 1, j]
                r = wrap32(a + b + c)
                pred = torch.div(wrap32(torch.where(r >= 0, r + 1, r - 1)), 3,
                                 rounding_mode="trunc")
                # the reduced branches of predict_dc on the picture's edges
                if i == 0 and j == 0:
                    pred = torch.where(up0 & left0, pred, torch.where(
                        up0, b, torch.where(left0, c, 0)))
                elif i == 0:
                    pred = torch.where(up0, pred, c)
                elif j == 0:
                    pred = torch.where(left0, pred, b)
                x = wrap32(vals[:, :, i, j] - pred)
                mag = (x.abs() << 2) // absqf
                code = wrap32(torch.where((x < 0) ^ (qf < 0), -mag, mag))
                pad[:, :, i + 1, j + 1] = wrap32(
                    _scale_core(code, qf, qo).to(torch.int64) + pred)
                codes[:, :, i, j] = code
        return [codes[c, :, :lh, :lw].reshape(-1, lh * lw)
                for c, (lh, lw) in enumerate(self.shapes)]

    def keep(self, p, v, h, pad):
        """Store the final reconstructions of slices (v, h) of pictures p."""
        for c, (rec, (lh, lw)) in enumerate(zip(self.rec, self.shapes)):
            rows = (v * lh)[:, None, None] + torch.arange(
                lh, device=v.device)[None, :, None]
            cols = (h * lw)[:, None, None] + torch.arange(
                lw, device=v.device)[None, None, :]
            rec[p[:, None, None], rows, cols] = pad[c, :, 1:lh + 1, 1:lw + 1]


def ld_rate_control(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail,
                    pictures: int, grid_shape, ll_y_shape, ll_c_shape):
    """The q indices and LL codes of ``pictures`` pictures whose lanes are
    stacked picture after picture ([P N, L] each; ``avail`` int64 [N], the
    same for every picture): the body table, then one step a diagonal of
    the slice grid, the slices of that diagonal of every picture in
    lockstep, each running its LL recurrence at every trial at once and
    walking the fits mask. Returns (q int32 [P N], LL codes int32 [P N,
    nLL] a component, the LL bands' reconstructions int64 [P, R lh, C lw]
    a component)."""
    ll_shapes = (tuple(ll_y_shape), tuple(ll_c_shape), tuple(ll_c_shape))
    rows, cols = grid_shape
    n = rows * cols
    dev = lanes_y.device
    table = body_table(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c).to(
        torch.int64)
    band = _LLBand((lanes_y, lanes_u, lanes_v), ll_shapes,
                   int(np.asarray(qm)[0]), pictures, rows, cols)
    total = pictures * n
    q_out = torch.empty(total, dtype=torch.int32, device=dev)
    ll_out = [torch.empty((total, lh * lw), dtype=torch.int32, device=dev)
              for lh, lw in ll_shapes]
    avail64 = avail.to(torch.int64)
    trials = torch.arange(TRIALS, device=dev)
    pics = torch.arange(pictures, device=dev)
    for d in range(rows + cols - 1):
        v1 = torch.arange(max(0, d - cols + 1), min(rows - 1, d) + 1,
                          device=dev)
        p = pics.repeat_interleave(v1.numel())
        v = v1.repeat(pictures)
        h = d - v
        local = v * cols + h
        s = p * n + local
        k = s.numel()
        pad = band.borders(p, v, h)
        # every trial of every slice: row i * TRIALS + t is slice i at t
        ll = band.trial(s.repeat_interleave(TRIALS),
                        v.repeat_interleave(TRIALS),
                        h.repeat_interleave(TRIALS),
                        pad.repeat_interleave(TRIALS, 1), trials.repeat(k))
        gy, cy = (x.view(k, TRIALS) for x in _ll_counts(ll[0]))
        gc, cc = (x.view(k, TRIALS) for x in _ll_counts(interleave(ll[1],
                                                                     ll[2])))
        ey, ec = table[s, 0], table[s, 1]
        bits = torch.where(ey > 0, gy + ey, cy) + torch.where(ec > 0,
                                                              gc + ec, cc)
        fits = (bits <= avail64[local, None]) & (trials < TRIALS - 1)
        best = walk_fits(fits)
        codes = band.trial(s, v, h, pad, best)
        band.keep(p, v, h, pad)
        for out, c in zip(ll_out, codes):
            out[s] = c.to(torch.int32)
        q_out[s] = best.to(torch.int32)
    return q_out, ll_out, band.rec


def _place_bits(bits, code, keep, pos, lo, hi):
    """Set the bits of each kept code (its low ``keep`` bits, MSB first) at
    bit ``pos`` of ``bits``, those outside [lo, hi) of its row dropped."""
    for j in range(64):
        live = j < keep
        if not bool(live.any()):
            break
        at = pos + j
        one = (live & (((code >> (keep - 1 - j).clamp(min=0)) & 1) == 1)
               & (at >= lo) & (at < hi))
        bits[at[one]] = 1


def quantise_body(lanes, ll, q_idx, qm):
    """A component's lanes quantised for the stream: the rate control's LL
    codes, then the body lanes at max(qIndex - qm[lane], 0)."""
    k = ll.shape[1]
    return torch.cat([ll, quant_lanes(lanes[:, k:], q_idx, qm[k:])], 1)


def pack(qy, qu, qv, q_idx, sizes):
    """The LD slice payload of a picture from quantised lanes: each slice
    at its fixed bytes, the 7-bit qIndex, the luma length, the luma codes,
    then the interleaved U/V codes up to the slice's end (reference
    Slices.cpp:200-300). Returns the payload, a uint8 tensor."""
    dev = qy.device
    size = sizes.to(torch.int64)
    len_bits = torch.as_tensor(len_bits_of(size.cpu().numpy()), device=dev)
    y_used = truncated_bits(qy)
    uv = interleave(qu, qv)
    uv_used = truncated_bits(uv)
    uv_bits = 8 * size - 7 - len_bits - y_used
    if bool((uv_used > uv_bits).any()):
        raise ValueError("SliceIO, LD mode: Too many bytes for the U and V "
                         "slices")
    starts = 8 * (torch.cumsum(size, 0) - size)
    ends = starts + 8 * size
    bits = torch.zeros(int(8 * size.sum()), dtype=torch.int64, device=dev)
    lo, hi = starts[:, None], ends[:, None]
    head = torch.stack([q_idx.to(torch.int64) & 0x7F,
                        y_used & ((1 << len_bits) - 1)], 1)
    head_keep = torch.stack([torch.full_like(len_bits, 7), len_bits], 1)
    _place_bits(bits, head, head_keep, starts[:, None] + torch.tensor(
        [0, 7], device=dev), lo, hi)
    at = starts + 7 + len_bits
    for lanes, bound in ((qy, y_used), (uv, uv_bits)):
        code, nb = signed_codes(lanes)
        cum = torch.cumsum(nb, 1) - nb
        keep = torch.minimum((bound[:, None] - cum).clamp(min=0), nb)
        kept = torch.where(keep > 0, code >> (nb - keep), 0)
        _place_bits(bits, kept, keep, at[:, None] + cum, lo, hi)
        at = at + bound
    weights = 1 << torch.arange(7, -1, -1, device=dev)
    return (bits.view(-1, 8) * weights).sum(1).to(torch.uint8)
