"""HQ CBR rate control: the quantisation index of every slice.

Port of ``vc2tpu.rdo.cbr.cbr_quant_indices`` (reference
src/EncodeStream/EncodeStream.cpp:73-125, yss_for_slice at
src/Library/src/Quantisation.cpp:627-642). Each slice on its own:

1. **Bisection**, the reference's probe sequence verbatim: trial 63, best
   127; six probes with delta 32, 16, 8, 4, 2, 1, then a seventh. After
   each probe best = trial when the slice fits (its bytes at trial <=
   budget - 4) and trial < best; then trial -= delta when it fits, else
   trial += delta. Sizes are not assumed monotone in q.
2. **Hill climb**: from q = best, while the luma error at q + 1 is
   strictly below the error at q, q += 1.

A probe's size sums, for each component, the signed exp-Golomb bits of
each lane quantised at clamp(q - qm[lane], 0, 119), less the trailing run
of zero codes, in whole bytes, in whole units of ``scalar``
(``device_pack._component_bytes``). The luma error is the int64 sum of
d * d, d = lane - scale(quant(lane)) formed in int32, wrapping, before it
is widened. The budgets (``layout.slice_bytes_map``) exclude the slice
prefix, so only the qIndex and three length bytes come off them.

CUDA lanes go through one launch of ``csrc/hq_cbr.cu`` (a group of 4-32
threads a slice holding its lanes in registers, ``group_plan``; every
probe and climb step on the chip, no host round trip); CPU lanes through
``cbr_quant_indices_plain``. A result above 119 (no q fits, or a
climb past it) is an error of the encoder's; the search reports it in a
flags word (``device_pack.FLAG_QMAX``) that the pack's one
synchronisation reads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.intmath import wrap32
from vc2tpu_torch.quant.quantiser import (MAX_QINDEX, QUANT_FACTORS_I32,
                                         QUANT_OFFSETS, adjust_quant_index,
                                         quant, scale)
from vc2tpu_torch.vlc import device_pack
from vc2tpu_torch.vlc.golomb import signed_codes

PROBES = (32, 16, 8, 4, 2, 1, 0)   # the deltas after each of the 7 probes
# csrc/hq_cbr.cu's work split (generated into its header), from the 1080p
# CBR picture on the H100 (PERF.md): 256 threads a CTA, six CTAs an
# SM (40 registers a thread), a thread holding at most 4 luma and 2 + 2
# chroma lanes, so a 1080p slice takes a group of 16
THREADS = 256
HOLD_Y = 4               # luma lanes a thread of a group holds in registers
HOLD_C = 2               # lanes of each chroma component it holds
MIN_BLOCKS = 6           # CTAs an SM holds at once (caps the registers)


def _check(y, u, v, qm_y, qm_c, budgets):
    n = y.shape[0]
    for name, t in (("y", y), ("u", u), ("v", v)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"cbr_quant_indices: {name} must be int32 "
                             f"[N, L], got {t.dtype} {tuple(t.shape)}")
    if u.shape != v.shape:
        raise ValueError("cbr_quant_indices: u and v differ in shape")
    for name, t, shape in (("qm_y", qm_y, (y.shape[1],)),
                           ("qm_c", qm_c, (u.shape[1],)),
                           ("budgets", budgets, (n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"cbr_quant_indices: {name} must be int32 "
                             f"{list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (u, v, qm_y, qm_c, budgets):
        if t.device != y.device:
            raise ValueError(f"cbr_quant_indices: inputs on {t.device} and "
                             f"{y.device}")


def slice_bytes_plain(y, u, v, qm_y, qm_c, q, scalar: int):
    """Bytes of each slice's three components at its index q (int64 [N]),
    through the exact quantiser and the code lengths."""
    q = q.to(torch.int64)[:, None]
    total = 0
    for lanes, qm in ((y, qm_y), (u, qm_c), (v, qm_c)):
        ql = quant(lanes, adjust_quant_index(q, qm.to(torch.int64)[None, :]))
        _, nbits = signed_codes(ql)
        total = total + scalar * device_pack._component_bytes(ql, nbits,
                                                              scalar)
    return total


def luma_error_plain(y, qm_y, q):
    """Sum over each slice's luma lanes of d * d (int64, wrapping), d the
    int32-wrapped difference of a lane and its reconstruction at q."""
    aq = adjust_quant_index(q.to(torch.int64)[:, None],
                            qm_y.to(torch.int64)[None, :])
    d = wrap32(y.to(torch.int64) - scale(quant(y, aq), aq).to(torch.int64))
    return (d * d).sum(1)


def bisect_plain(y, u, v, qm_y, qm_c, budgets, scalar: int):
    """The 7-probe bisection: the best index of each slice (127 where no
    probe fits), int64 [N]."""
    available = budgets.to(torch.int64) - 4
    trial = torch.full((y.shape[0],), 63, dtype=torch.int64, device=y.device)
    best = torch.full_like(trial, 127)
    for delta in PROBES:
        fits = slice_bytes_plain(y, u, v, qm_y, qm_c, trial, scalar) \
            <= available
        best = torch.where(fits & (trial < best), trial, best)
        trial = torch.where(fits, trial - delta, trial + delta)
    return best


def cbr_quant_indices_plain(y, u, v, qm_y, qm_c, budgets, scalar: int):
    """Plain PyTorch version of ``cbr_quant_indices``, on any device: the
    bisection in whole-picture passes, then the climb as a loop over the
    slices still climbing."""
    _check(y, u, v, qm_y, qm_c, budgets)
    q = bisect_plain(y, u, v, qm_y, qm_c, budgets, scalar)
    prev = luma_error_plain(y, qm_y, q)
    active = torch.arange(y.shape[0], device=y.device)
    while active.numel():
        nxt = q[active] + 1
        cur = luma_error_plain(y[active], qm_y, nxt)
        up = cur < prev[active]
        active = active[up]
        q[active] = nxt[up]
        prev[active] = cur[up]
    return q.to(torch.int32)


def group_plan(ly: int, lc: int) -> int:
    """Threads a slice in csrc/hq_cbr.cu for slices of ``ly`` luma and
    ``lc`` chroma lanes: the fewest (a power of two, 4 to 32) whose
    contiguous runs, one of each component a thread, fit its registers
    (``HOLD_Y`` luma, ``HOLD_C`` of each chroma component); 0 where none
    does, and a warp a slice then reads the lanes from device memory at
    every probe."""
    for g in (4, 8, 16, 32):
        if -(-ly // g) <= HOLD_Y and -(-lc // g) <= HOLD_C:
            return g
    return 0


def params_header() -> str:
    """``hq_cbr_params.h`` for csrc/hq_cbr.cu: its CTA size and register
    runs, the flag it sets, the int32-wrapped quant factors and offsets
    (``quantiser.QUANT_FACTORS_I32``, ``QUANT_OFFSETS``) and the
    reciprocals of the factors' magnitudes
    (``device_pack.quant_reciprocals``)."""
    factors = ", ".join(str(int(f)) for f in QUANT_FACTORS_I32)
    offsets = ", ".join(str(int(o)) for o in QUANT_OFFSETS)
    recips = ", ".join(f"0x{r:x}ull"
                       for r in device_pack.quant_reciprocals())
    return ("// Generated by vc2tpu_torch.rdo.cbr.params_header().\n"
            "#pragma once\n"
            f"#define VC2_CBR_THREADS {THREADS}\n"
            f"#define VC2_CBR_HOLD_Y {HOLD_Y}\n"
            f"#define VC2_CBR_HOLD_C {HOLD_C}\n"
            f"#define VC2_CBR_MIN_BLOCKS {MIN_BLOCKS}\n"
            f"#define VC2_CBR_MAX_Q {MAX_QINDEX}\n"
            f"#define VC2_FLAG_QMAX {device_pack.FLAG_QMAX}\n"
            f"#define VC2_QUANT_FACTORS {factors}\n"
            f"#define VC2_QUANT_OFFSETS {offsets}\n"
            f"#define VC2_QUANT_RECIPROCALS {recips}\n")


def kernel_source() -> build.Source:
    return build.Source("hq_cbr", (("hq_cbr_params.h", params_header()),))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hq_cbr_launch.argtypes = [p, p, p, i, i, p, p, p, i, i, i, p, p, p]
    lib.hq_cbr_launch.restype = i
    # the card check of the groups' reductions (chip_smoke.py, the tests)
    lib.hq_cbr_reduce_check_launch.argtypes = [p, p, i, i, p]
    lib.hq_cbr_reduce_check_launch.restype = i
    return lib


def launch_search(y, u, v, qm_y, qm_c, budgets, scalar: int, flags=None):
    """The one launch of csrc/hq_cbr.cu on CUDA tensors (checked by the
    caller), not synchronised. Returns the int32 [N] q indices."""
    n, ly, lc = y.shape[0], y.shape[1], u.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=y.device)
    with devices.guard(y):
        rc = _lib().hq_cbr_launch(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), ly, lc,
            qm_y.data_ptr(), qm_c.data_ptr(), budgets.data_ptr(), n, scalar,
            group_plan(ly, lc), out.data_ptr(),
            None if flags is None else flags.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
    if rc:
        raise RuntimeError(f"hq_cbr kernel launch failed: CUDA error {rc}")
    cbr_quant_indices.launches += 1
    return out


@capture.counted
def cbr_quant_indices(y, u, v, qm_y, qm_c, budgets, scalar: int,
                      flags=None):
    """The HQ CBR quantisation index of every slice.

    y: int32 [N, Ly], u/v: int32 [N, Lc] transform lanes in serialisation
    order (what ``quant_pack_hq`` reads); qm_y: int32 [Ly], qm_c: int32
    [Lc] the quant matrix entry of each lane (``pipeline.decoder.qm_lanes``);
    budgets: int32 [N] each slice's bytes without its prefix
    (``layout.slice_bytes_map``). ``flags``, an int64 word on the lanes'
    device (the pack's flags word, ``device_pack.pack_scratch(...)[1:2]``),
    receives ``FLAG_QMAX`` where an index exceeds 119. Returns int32 [N] on
    the lanes' device. CUDA lanes go through one launch of csrc/hq_cbr.cu,
    not synchronised; CPU lanes through ``cbr_quant_indices_plain``."""
    if y.device.type == "cpu":
        q = cbr_quant_indices_plain(y, u, v, qm_y, qm_c, budgets, scalar)
        if flags is not None and bool((q > MAX_QINDEX).any()):
            flags.bitwise_or_(device_pack.FLAG_QMAX)
        return q
    if y.device.type != "cuda":
        raise ValueError(f"cbr_quant_indices: unsupported device {y.device}")
    _check(y, u, v, qm_y, qm_c, budgets)
    for t in (y, u, v, qm_y, qm_c, budgets):
        if not t.is_contiguous():
            raise ValueError("cbr_quant_indices: inputs must be contiguous")
    if flags is not None and (flags.dtype != torch.int64
                              or flags.device != y.device):
        raise ValueError("cbr_quant_indices: flags must be an int64 word on "
                         f"{y.device}")
    if y.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=y.device)
    return launch_search(y, u, v, qm_y, qm_c, budgets, scalar, flags)
