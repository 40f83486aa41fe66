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

``ld_rate_control_plain`` walks the anti-diagonals of the slice grid, every
slice of a diagonal in lockstep (R + C - 1 steps, 374 at 1080p).
``ld_rate_control`` launches ``csrc/ld_rate.cu`` for CUDA lanes (a warp a
slice row; rows wait on the row above through device memory) and runs the
plain version for CPU lanes. Quantisation divides exactly (the port's
``quant``); the JAX package's float32 reciprocal was a TPU form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core.intmath import wrap32
from vc2tpu_torch.quant.quantiser import (MAX_QINDEX, QUANT_FACTORS_I32,
                                         QUANT_OFFSETS, _scale_core)
from vc2tpu_torch.vlc import device_pack
from vc2tpu_torch.vlc.golomb import interleave, truncated_bits

PROBES = (32, 16, 8, 4, 2, 1, 0)   # the deltas after each of the 7 probes
STAGE_BYTES = 40960      # shared memory a row's CTA may stage a slice in


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


def ld_rate_control_plain(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail,
                          grid_shape, ll_y_shape, ll_c_shape):
    """Plain PyTorch version of ``ld_rate_control``, on any device: one step
    a diagonal of the slice grid, its slices in lockstep."""
    lanes = (lanes_y, lanes_u, lanes_v)
    band_sizes = (tuple(bs_y), tuple(bs_c), tuple(bs_c))
    ll_shapes = (tuple(ll_y_shape), tuple(ll_c_shape), tuple(ll_c_shape))
    _check(lanes, qm, band_sizes, avail, grid_shape, ll_shapes)
    rows, cols = grid_shape
    dev = lanes_y.device
    qm_np = np.asarray(qm, np.int64)
    body_qm = [torch.as_tensor(lane_qm(qm_np, bs)[bs[0]:].astype(np.int64),
                               device=dev) for bs in band_sizes[:2]]
    band = _LLBand(lanes, ll_shapes, int(qm_np[0]), rows, cols)
    n = rows * cols
    q_out = torch.empty(n, dtype=torch.int32, device=dev)
    ll_out = [torch.empty((n, lh * lw), dtype=torch.int32, device=dev)
              for lh, lw in ll_shapes]
    avail64 = avail.to(torch.int64)
    absqf_t = band.tables[1]
    for d in range(rows + cols - 1):
        v = torch.arange(max(0, d - cols + 1), min(rows - 1, d) + 1,
                         device=dev)
        h = d - v
        s = v * cols + h
        # |lane| << 2, the quotient's numerator, of each body lane
        num = [x[s, lh * lw:].to(torch.int64).abs() << 2
               for x, (lh, lw) in zip(lanes, ll_shapes)]
        pad = band.borders(v, h)
        trial = torch.full_like(v, 63)
        best = torch.full_like(v, 127)
        fit_at = avail64[s]
        for delta in PROBES:
            ll = band.trial(s, v, h, pad, trial)
            # a code's bits depend on its magnitude alone
            div = [absqf_t[(trial[:, None] - qm[None, :]).clamp(0,
                                                                MAX_QINDEX)]
                   for qm in body_qm]
            y = torch.cat([ll[0].abs(), num[0] // div[0]], 1)
            u = torch.cat([ll[1].abs(), num[1] // div[1]], 1)
            w = torch.cat([ll[2].abs(), num[2] // div[1]], 1)
            fits = truncated_bits(y) + truncated_bits(interleave(u, w)) \
                <= fit_at
            best = torch.where(fits & (trial < best), trial, best)
            trial = torch.where(fits, trial - delta, trial + delta)
        codes = band.trial(s, v, h, pad, best)
        band.keep(v, h, pad)
        for out, c in zip(ll_out, codes):
            out[s] = c.to(torch.int32)
        q_out[s] = best.to(torch.int32)
    return q_out, ll_out[0], ll_out[1], ll_out[2]


def params_header() -> str:
    """``ld_rate_params.h`` for csrc/ld_rate.cu: the int32-wrapped quant
    factors and offsets (``quantiser.QUANT_FACTORS_I32``, ``QUANT_OFFSETS``)
    and the reciprocals of the factors' magnitudes
    (``device_pack.quant_reciprocals``)."""
    factors = ", ".join(str(int(f)) for f in QUANT_FACTORS_I32)
    offsets = ", ".join(str(int(o)) for o in QUANT_OFFSETS)
    recips = ", ".join(f"0x{r:x}ull"
                       for r in device_pack.quant_reciprocals())
    return ("// Generated by vc2tpu_torch.rdo.ld.params_header().\n"
            "#pragma once\n"
            f"#define VC2_LD_STAGE_BYTES {STAGE_BYTES}\n"
            f"#define VC2_QUANT_FACTORS {factors}\n"
            f"#define VC2_QUANT_OFFSETS {offsets}\n"
            f"#define VC2_QUANT_RECIPROCALS {recips}\n")


def kernel_source() -> build.Source:
    return build.Source("ld_rate", (("ld_rate_params.h", params_header()),))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ld_rate_launch.argtypes = [p, p, p, i, i, p, p, i, i, i, i, p, i, i,
                                   i, p, p, p, p, p, p]
    lib.ld_rate_launch.restype = i
    lib.ld_rate_resident.argtypes = [i] * 7
    lib.ld_rate_resident.restype = i
    lib.ld_rate_fixed_shape.argtypes = [i] * 6
    lib.ld_rate_fixed_shape.restype = i
    return lib


def fixed_shape(ly: int, lc: int, ll_y_shape, ll_c_shape) -> bool:
    """Whether csrc/ld_rate.cu runs these shapes on a kernel compiled for
    their LL blocks (4:2:2 at -a 2 with -u 2, as at 1080p, or -u 1), whose
    probes keep every value in registers, rather than its generic
    kernel."""
    return bool(_lib().ld_rate_fixed_shape(ly, lc, *ll_y_shape,
                                           *ll_c_shape))


def resident_rows(ly: int, lc: int, ll_y_shape, ll_c_shape,
                  device=None) -> int:
    """The slice rows (CTAs of csrc/ld_rate.cu) the card runs at once for
    these shapes: its SMs times the CTAs one SM holds. A grid of more rows
    makes later rows wait for a CTA to finish and take the next ticket."""
    n = _lib().ld_rate_resident(
        ly, lc, *ll_y_shape, *ll_c_shape,
        int(staged(ly, lc, ll_y_shape, ll_c_shape)))
    if n < 0:
        raise RuntimeError(f"ld_rate occupancy query failed: CUDA error {-n}")
    props = torch.cuda.get_device_properties(device or 0)
    return n * props.multi_processor_count


@functools.lru_cache(maxsize=64)
def _lane_tables(qm_key: tuple, bs_y: tuple, bs_c: tuple,
                 device: torch.device):
    return tuple(torch.as_tensor(lane_qm(qm_key, bs), device=device)
                 for bs in (bs_y, bs_c))


def scratch_ints(rows: int, cols: int, ll_shapes) -> int:
    """int32 words of a launch's scratch: the row ticket, each row's
    progress, and each component's bottom LL row of every slice."""
    return 1 + rows + rows * cols * sum(lw for _lh, lw in ll_shapes)


def ll_bytes(ll_y_shape, ll_c_shape) -> int:
    """Shared memory a CTA of csrc/ld_rate.cu needs for its LL recurrences:
    each component's code bits and reconstructions of a trial, and the
    borders of its slice."""
    return 4 * sum(2 * lh * lw + lh + lw for lh, lw in
                   (ll_y_shape, ll_c_shape, ll_c_shape))


def staged(ly: int, lc: int, ll_y_shape, ll_c_shape) -> bool:
    """Whether csrc/ld_rate.cu keeps the quant matrix entries and two
    slices' lanes (the current one and the next, copied while the current
    one is searched) in shared memory, else it reads them from device
    memory at every probe."""
    return (4 * (3 * ly + 5 * lc) + ll_bytes(ll_y_shape, ll_c_shape)
            <= STAGE_BYTES)


def launch_rate(lanes_y, lanes_u, lanes_v, qm, bs_y, bs_c, avail,
                grid_shape, ll_y_shape, ll_c_shape):
    """The one launch of csrc/ld_rate.cu on CUDA tensors (checked by the
    caller), not synchronised. Returns (q, ll_qy, ll_qu, ll_qv)."""
    rows, cols = grid_shape
    n, ly, lc = lanes_y.shape[0], lanes_y.shape[1], lanes_u.shape[1]
    dev = lanes_y.device
    if ll_bytes(ll_y_shape, ll_c_shape) > STAGE_BYTES:
        raise ValueError(f"ld_rate_control: LL blocks {tuple(ll_y_shape)} "
                         f"and {tuple(ll_c_shape)} are too large for the "
                         "kernel's shared memory")
    qm_y, qm_c = _lane_tables(tuple(int(x) for x in qm), tuple(bs_y),
                              tuple(bs_c), dev)
    ll_shapes = (ll_y_shape, ll_c_shape, ll_c_shape)
    q = torch.empty(n, dtype=torch.int32, device=dev)
    ll = [torch.empty((n, lh * lw), dtype=torch.int32, device=dev)
          for lh, lw in ll_shapes]
    scratch = torch.empty(scratch_ints(rows, cols, ll_shapes),
                          dtype=torch.int32, device=dev)
    scratch[:1 + rows].zero_()
    (lyh, lyw), (lch, lcw) = ll_y_shape, ll_c_shape
    rc = _lib().ld_rate_launch(
        lanes_y.data_ptr(), lanes_u.data_ptr(), lanes_v.data_ptr(), ly, lc,
        qm_y.data_ptr(), qm_c.data_ptr(), lyh, lyw, lch, lcw,
        avail.data_ptr(), rows, cols,
        int(staged(ly, lc, ll_y_shape, ll_c_shape)), q.data_ptr(),
        ll[0].data_ptr(), ll[1].data_ptr(), ll[2].data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ld_rate kernel launch failed: CUDA error {rc}")
    ld_rate_control.launches += 1
    return q, ll[0], ll[1], ll[2]


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
    CUDA lanes go through one launch of csrc/ld_rate.cu, not synchronised;
    CPU lanes through ``ld_rate_control_plain``."""
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


ld_rate_control.launches = 0
