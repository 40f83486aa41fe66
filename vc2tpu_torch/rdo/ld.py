"""LD rate control: the quantisation index of every slice, and the LL lanes
quantised with DC prediction.

Port of ``vc2tpu.rdo.ld.ld_rate_control`` (reference
src/EncodeStream/EncodeStream.cpp:195-245 over Quantisation.cpp:191-234).
For each slice, the reference's 7-probe bisection: trial 63, best 127;
after each probe best = trial where the slice's bits at trial fit its
budget (``avail_bits``) and trial < best, then trial -= delta where it
fits, else trial += delta, for delta 32, 16, 8, 4, 2, 1, 0. Sizes are not
assumed monotone in q.

A probe quantises each lane at clamp(trial - qm[band], 0, 119). The LL
band (the first lanes of a slice, raster within its LL block) is
quantised against a DC prediction: each LL value less the truncating mean
(|r| + 1) / 3 of its left, above and above-left reconstructions (the
reduced branches at the picture's top and left edges), the reconstruction
being scale(code) + prediction, wrapped to int32. So a slice depends on the
final reconstructions of its left, above and above-left neighbours. The
bits of a probe are each component's truncated count (the code bits up to
its last non-zero code, in lane order), chroma interleaved u0 v0 u1 v1.
After the search, the requantise at best gives the LL lanes and the
reconstructions the later slices read.

The search is split in two. The body lanes (every lane after the LL
block) are quantised on their own, so their share of a probe's bits at
each of the 127 trials 0-126 is a table computed before the search
(``body_table_plain``): nothing in it depends on a neighbour. The LL
recurrence is then run at every trial at once, the fits of the 127 trials
form a mask, and the bisection's 7 probes read it (``walk_fits``): the
probes visit a binary search tree over 0-126, so the walk needs no
monotonicity and picks what the sequential bisection picks.

``ld_rate_control_plain`` walks the anti-diagonals of the slice grid, every
slice of a diagonal in lockstep (R + C - 1 steps, 374 at 1080p).
``ld_rate_control`` launches ``csrc/ld_rate.cu`` for CUDA lanes (at 1080p
one launch: a CTA a slice row, a thread a trial, and warps that size the
row's body lanes ahead of it; rows wait on the row above through device
memory) and runs the plain version for CPU lanes. Quantisation divides
exactly (the port's ``quant``); the JAX package's float32 reciprocal was a
TPU form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.intmath import wrap32
from vc2tpu_torch.quant.quantiser import (MAX_QINDEX, QUANT_FACTORS_I32,
                                         QUANT_OFFSETS, _scale_core)
from vc2tpu_torch.vlc import device_pack
from vc2tpu_torch.vlc.golomb import _code_bits, interleave, truncated_bits

PROBES = (32, 16, 8, 4, 2, 1, 0)   # the deltas after each of the 7 probes
TRIALS = 128             # a body table row: trials 0-126, and 127 (unused)
MONOTONE_MAX = 115       # the factors rise with the index up to here
# the least |factor| of the wrapped indices 116-119: a lane of |v| << 2
# below it quantises to 0 there
WRAP_MIN = int(np.abs(QUANT_FACTORS_I32[MONOTONE_MAX + 1:].astype(
    np.int64)).min())
STAGE_BYTES = 40960      # shared memory of the generic kernel's row CTA


def avail_bits(budgets) -> np.ndarray:
    """The bits each slice's codes may take, int32 [N]: 8 b - 7 -
    intlog2(8 b - 7) for a budget of b bytes (EncodeStream.cpp:210-212)."""
    from vc2tpu_torch.slices.ld import len_bits_of

    b = np.asarray(budgets, np.int64).ravel()
    return (8 * b - 7 - len_bits_of(b)).astype(np.int32)


def lane_qm(qm, band_sizes) -> np.ndarray:
    """The quant matrix entry of every lane of a slice, int32 [L], from the
    entry of each band and the lanes in each band (lane order)."""
    return np.repeat(np.asarray(qm, np.int32)[:len(band_sizes)],
                     np.asarray(band_sizes, np.int64)).astype(np.int32)


def _check(lanes, qm, band_sizes, avail, grid_shape, ll_shapes):
    n = lanes[0].shape[0]
    if grid_shape[0] * grid_shape[1] != n:
        raise ValueError(f"ld_rate_control: {n} slices in a {grid_shape} "
                         "grid")
    for name, t, bs, (lh, lw) in zip("yuv", lanes, band_sizes, ll_shapes):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"ld_rate_control: lanes_{name} must be int32 "
                             f"[N, L], got {t.dtype} {tuple(t.shape)}")
        if sum(bs) != t.shape[1] or bs[0] != lh * lw or lh < 1 or lw < 1:
            raise ValueError(f"ld_rate_control: lanes_{name} of "
                             f"{t.shape[1]} lanes, bands {tuple(bs)}, LL "
                             f"block {lh}x{lw}")
        if t.device != lanes[0].device:
            raise ValueError(f"ld_rate_control: inputs on {t.device} and "
                             f"{lanes[0].device}")
    if lanes[1].shape != lanes[2].shape:
        raise ValueError("ld_rate_control: lanes_u and lanes_v differ")
    if len(qm) < max(len(band_sizes[0]), len(band_sizes[1])):
        raise ValueError("ld_rate_control: the quant matrix has too few "
                         "bands")
    if (avail.dtype != torch.int32 or tuple(avail.shape) != (n,)
            or avail.device != lanes[0].device):
        raise ValueError(f"ld_rate_control: avail must be int32 [{n}] on "
                         f"{lanes[0].device}")


class _LLBand:
    """The LL band of the three components across the picture: each one's
    reconstructed values of the finished slices ((R lh) x (C lw), int64),
    and the LL pass of the slices of a diagonal, the three components in
    one batch, each LL block padded to the largest (a padded cell comes
    after every real cell it could feed, so it changes none)."""

    def __init__(self, lanes, shapes, qm_ll: int, rows: int, cols: int):
        self.shapes, self.qm_ll = shapes, qm_ll
        self.lh = max(lh for lh, _ in shapes)
        self.lw = max(lw for _, lw in shapes)
        dev = lanes[0].device
        n = lanes[0].shape[0]
        self.vals = torch.zeros((3, n, self.lh, self.lw), dtype=torch.int64,
                                device=dev)
        for c, (x, (lh, lw)) in enumerate(zip(lanes, shapes)):
            self.vals[c, :, :lh, :lw] = x[:, :lh * lw].reshape(n, lh, lw)
        self.rec = [torch.zeros((rows * lh, cols * lw), dtype=torch.int64,
                                device=dev) for lh, lw in shapes]
        qf, qo = (torch.as_tensor(t.astype(np.int64), device=dev)
                  for t in (QUANT_FACTORS_I32, QUANT_OFFSETS))
        self.tables = (qf, qf.abs(), qo)

    def borders(self, v, h):
        """[3, K, lh + 1, lw + 1]: row 0 holds the above slices' bottom rows
        and the above-left corners, column 0 the left slices' right
        columns, 0 where a slice lies on the picture's top or left edge."""
        k = v.numel()
        pad = torch.zeros((3, k, self.lh + 1, self.lw + 1),
                          dtype=torch.int64, device=v.device)
        for c, (rec, (lh, lw)) in enumerate(zip(self.rec, self.shapes)):
            y0, x0 = v * lh, h * lw
            ys = (y0 - 1).clamp(min=0)[:, None]
            xs = (x0 - 1).clamp(min=0)[:, None]
            jj = torch.arange(lw, device=v.device)[None, :]
            ii = torch.arange(lh, device=v.device)[None, :]
            pad[c, :, 0, 1:lw + 1] = torch.where(
                (v > 0)[:, None], rec[ys, x0[:, None] + jj], 0)
            pad[c, :, 1:lh + 1, 0] = torch.where(
                (h > 0)[:, None], rec[y0[:, None] + ii, xs], 0)
            pad[c, :, 0, 0] = torch.where((v > 0) & (h > 0),
                                          rec[ys[:, 0], xs[:, 0]], 0)
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

    def keep(self, v, h, pad):
        """Store the final reconstructions of slices (v, h)."""
        for c, (rec, (lh, lw)) in enumerate(zip(self.rec, self.shapes)):
            rows = (v * lh)[:, None, None] + torch.arange(
                lh, device=v.device)[None, :, None]
            cols = (h * lw)[:, None, None] + torch.arange(
                lw, device=v.device)[None, None, :]
            rec[rows, cols] = pad[c, :, 1:lh + 1, 1:lw + 1]


def body_table_plain(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c):
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


def ld_rate_control_plain(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail,
                          grid_shape, ll_y_shape, ll_c_shape):
    """Plain PyTorch version of ``ld_rate_control``, on any device: the
    body table, then one step a diagonal of the slice grid, its slices in
    lockstep, each running its LL recurrence at every trial at once and
    walking the fits mask."""
    lanes = (lanes_y, lanes_u, lanes_v)
    band_sizes = (tuple(bs_y), tuple(bs_c), tuple(bs_c))
    ll_shapes = (tuple(ll_y_shape), tuple(ll_c_shape), tuple(ll_c_shape))
    _check(lanes, qm, band_sizes, avail, grid_shape, ll_shapes)
    rows, cols = grid_shape
    dev = lanes_y.device
    table = body_table_plain(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c).to(
        torch.int64)
    band = _LLBand(lanes, ll_shapes, int(np.asarray(qm)[0]), rows, cols)
    n = rows * cols
    q_out = torch.empty(n, dtype=torch.int32, device=dev)
    ll_out = [torch.empty((n, lh * lw), dtype=torch.int32, device=dev)
              for lh, lw in ll_shapes]
    avail64 = avail.to(torch.int64)
    trials = torch.arange(TRIALS, device=dev)
    for d in range(rows + cols - 1):
        v = torch.arange(max(0, d - cols + 1), min(rows - 1, d) + 1,
                         device=dev)
        h = d - v
        s = v * cols + h
        k = s.numel()
        pad = band.borders(v, h)
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
        fits = (bits <= avail64[s, None]) & (trials < TRIALS - 1)
        best = walk_fits(fits)
        codes = band.trial(s, v, h, pad, best)
        band.keep(v, h, pad)
        for out, c in zip(ll_out, codes):
            out[s] = c.to(torch.int32)
        q_out[s] = best.to(torch.int32)
    return q_out, ll_out[0], ll_out[1], ll_out[2]


def params_header() -> str:
    """``ld_rate_params.h`` for csrc/ld_rate.cu: its shared-memory limit
    and table width, the index range where the factors rise and the least
    wrapped factor, the int32-wrapped quant factors and offsets
    (``quantiser.QUANT_FACTORS_I32``, ``QUANT_OFFSETS``) and the
    reciprocals of the factors' magnitudes
    (``device_pack.quant_reciprocals``)."""
    factors = ", ".join(str(int(f)) for f in QUANT_FACTORS_I32)
    offsets = ", ".join(str(int(o)) for o in QUANT_OFFSETS)
    recips = ", ".join(f"0x{r:x}ull"
                       for r in device_pack.quant_reciprocals())
    return ("// Generated by vc2tpu_torch.rdo.ld.params_header().\n"
            "#pragma once\n"
            f"#define VC2_LD_STAGE_BYTES {STAGE_BYTES}\n"
            f"#define VC2_LD_TRIALS {TRIALS}\n"
            f"#define VC2_MONOTONE_MAX {MONOTONE_MAX}\n"
            f"#define VC2_WRAP_MIN {WRAP_MIN}ull\n"
            f"#define VC2_QUANT_FACTORS {factors}\n"
            f"#define VC2_QUANT_OFFSETS {offsets}\n"
            f"#define VC2_QUANT_RECIPROCALS {recips}\n")


def kernel_source() -> build.Source:
    return build.Source("ld_rate", (("ld_rate_params.h", params_header()),))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ld_body_table_launch.argtypes = [p, p, p, i, i, i, i, p, p, i, p, p]
    lib.ld_body_table_launch.restype = i
    lib.ld_rate_launch.argtypes = [p, p, p, i, i, p, p, i, i, i, i, p, p, i,
                                   i, p, p, p, p, p, p]
    lib.ld_rate_launch.restype = i
    lib.ld_rate_resident.argtypes = [i] * 6
    lib.ld_rate_resident.restype = i
    lib.ld_rate_fixed_shape.argtypes = [i] * 6
    lib.ld_rate_fixed_shape.restype = i
    return lib


def fixed_shape(ly: int, lc: int, ll_y_shape, ll_c_shape) -> bool:
    """Whether csrc/ld_rate.cu runs these shapes on a kernel compiled for
    their LL blocks (4:2:2 at -a 2 with -u 2, as at 1080p, or -u 1, and at
    most 64 luma and 32 chroma body lanes): a thread a trial with every LL
    value in registers, and producer warps that size the body lanes ahead
    of it; else its generic kernel (a warp a row, the probes one after
    another) after the body table's launch."""
    return bool(_lib().ld_rate_fixed_shape(ly, lc, *ll_y_shape,
                                           *ll_c_shape))


def resident_rows(ly: int, lc: int, ll_y_shape, ll_c_shape,
                  device=None) -> int:
    """The slice rows (CTAs of csrc/ld_rate.cu's wavefront) the card runs
    at once for these shapes: its SMs times the CTAs one SM holds. A grid
    of more rows makes later rows wait for a CTA to finish and take the
    next ticket."""
    n = _lib().ld_rate_resident(ly, lc, *ll_y_shape, *ll_c_shape)
    if n < 0:
        raise RuntimeError(f"ld_rate occupancy query failed: CUDA error {-n}")
    props = torch.cuda.get_device_properties(device or 0)
    return n * props.multi_processor_count


@capture.device_cache(maxsize=64)
def _lane_tables(qm_key: tuple, bs_y: tuple, bs_c: tuple,
                 device: torch.device):
    return tuple(torch.as_tensor(lane_qm(qm_key, bs), device=device)
                 for bs in (bs_y, bs_c))


def scratch_words(rows: int, cols: int, ll_shapes) -> int:
    """int64 words of the wavefront's scratch: the row ticket, then each
    component's bottom LL row of every slice, a value and its ready tag a
    word."""
    return 1 + rows * cols * sum(lw for _lh, lw in ll_shapes)


def ll_bytes(ll_y_shape, ll_c_shape) -> int:
    """Shared memory a CTA of the generic kernel needs: each component's
    code bits and reconstructions of a trial and the borders of its slice,
    and the slice's body table row."""
    return 4 * (sum(2 * lh * lw + lh + lw for lh, lw in
                    (ll_y_shape, ll_c_shape, ll_c_shape)) + 2 * TRIALS)


def launch_table(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c):
    """One launch of csrc/ld_rate.cu's body table on CUDA tensors (checked
    by the caller), not synchronised. Returns the table, int32 [N, 2,
    TRIALS] (33.2 MB at 1080p)."""
    n, ly, lc = lanes_y.shape[0], lanes_y.shape[1], lanes_u.shape[1]
    dev = lanes_y.device
    table = torch.empty((n, 2, TRIALS), dtype=torch.int32, device=dev)
    qm_y, qm_c = _lane_tables(tuple(int(x) for x in qm), tuple(bs_y),
                              tuple(bs_c), dev)
    with devices.guard(lanes_y):
        rc = _lib().ld_body_table_launch(
            lanes_y.data_ptr(), lanes_u.data_ptr(), lanes_v.data_ptr(), ly,
            lc, bs_y[0], bs_c[0], qm_y.data_ptr(), qm_c.data_ptr(), n,
            table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ld_rate body table launch failed: CUDA error "
                           f"{rc}")
    return table


@capture.counted
def body_table(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c):
    """The body table of ``ld_rate_control``'s arguments (see
    ``body_table_plain``): CUDA lanes through one launch of csrc/ld_rate.cu's
    table kernel, not synchronised, counted in ``body_table.launches``; CPU
    lanes through ``body_table_plain``."""
    if lanes_y.device.type == "cpu":
        return body_table_plain(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c)
    if lanes_y.device.type != "cuda":
        raise ValueError(f"body_table: unsupported device {lanes_y.device}")
    for t in (lanes_y, lanes_u, lanes_v):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError("body_table: lanes must be contiguous int32 "
                             "[N, L]")
    table = launch_table(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c)
    body_table.launches += 1
    return table


def launch_rate(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail,
                grid_shape, ll_y_shape, ll_c_shape):
    """The launch of csrc/ld_rate.cu's wavefront on CUDA tensors (checked
    by the caller), not synchronised; for shapes without a fixed-shape
    kernel, the body table's launch before it. Returns (q, ll_qy, ll_qu,
    ll_qv)."""
    rows, cols = grid_shape
    n, ly, lc = lanes_y.shape[0], lanes_y.shape[1], lanes_u.shape[1]
    dev = lanes_y.device
    if ll_bytes(ll_y_shape, ll_c_shape) > STAGE_BYTES:
        raise ValueError(f"ld_rate_control: LL blocks {tuple(ll_y_shape)} "
                         f"and {tuple(ll_c_shape)} are too large for the "
                         "kernel's shared memory")
    qm_y, qm_c = _lane_tables(tuple(int(x) for x in qm), tuple(bs_y),
                              tuple(bs_c), dev)
    table = None if fixed_shape(ly, lc, ll_y_shape, ll_c_shape) else \
        launch_table(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c)
    ll_shapes = (ll_y_shape, ll_c_shape, ll_c_shape)
    q = torch.empty(n, dtype=torch.int32, device=dev)
    ll = [torch.empty((n, lh * lw), dtype=torch.int32, device=dev)
          for lh, lw in ll_shapes]
    scratch = torch.zeros(scratch_words(rows, cols, ll_shapes),
                          dtype=torch.int64, device=dev)
    (lyh, lyw), (lch, lcw) = ll_y_shape, ll_c_shape
    with devices.guard(lanes_y):
        rc = _lib().ld_rate_launch(
            lanes_y.data_ptr(), lanes_u.data_ptr(), lanes_v.data_ptr(), ly,
            lc, qm_y.data_ptr(), qm_c.data_ptr(), lyh, lyw, lch, lcw,
            None if table is None else table.data_ptr(), avail.data_ptr(),
            rows, cols, q.data_ptr(), ll[0].data_ptr(), ll[1].data_ptr(),
            ll[2].data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ld_rate kernel launch failed: CUDA error {rc}")
    ld_rate_control.launches += 1
    return q, ll[0], ll[1], ll[2]


@capture.counted
def ld_rate_control(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail,
                    grid_shape, ll_y_shape, ll_c_shape):
    """The LD quantisation index of every slice and its LL lanes.

    lanes_*: int32 [N, L] transform lanes in lane order (the LL lanes
    first, raster within the LL block); qm: the quant matrix entry of each
    band (host sequence); bs_y / bs_c: the lanes in each band of a luma /
    chroma slice; avail: int32 [N] each slice's bits (``avail_bits``) on
    the lanes' device; grid_shape: (rows, columns) of slices, N of them in
    raster order; ll_*_shape: a slice's LL block (height, width) in each
    plane. Returns (q int32 [N], ll_qy [N, nLLy], ll_qu, ll_qv [N, nLLc])
    on the lanes' device: the indices, and the LL lanes quantised with DC
    prediction at them (the body lanes are quantised at q on their own).
    CUDA lanes go through csrc/ld_rate.cu (one launch for the shapes of
    ``fixed_shape``, else the body table's and the wavefront's; one count
    in ``ld_rate_control.launches``), not synchronised; CPU lanes through
    ``ld_rate_control_plain``."""
    args = (lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail, grid_shape,
            ll_y_shape, ll_c_shape)
    if lanes_y.device.type == "cpu":
        return ld_rate_control_plain(*args)
    if lanes_y.device.type != "cuda":
        raise ValueError(f"ld_rate_control: unsupported device "
                         f"{lanes_y.device}")
    _check((lanes_y, lanes_u, lanes_v), qm, (tuple(bs_y), tuple(bs_c),
                                             tuple(bs_c)), avail, grid_shape,
           (tuple(ll_y_shape), tuple(ll_c_shape), tuple(ll_c_shape)))
    for t in (lanes_y, lanes_u, lanes_v, avail):
        if not t.is_contiguous():
            raise ValueError("ld_rate_control: inputs must be contiguous")
    return launch_rate(*args)
