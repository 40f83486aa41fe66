"""On-device HQ slice payload assembly: lanes -> payload bytes.

Port of ``vc2tpu.vlc.device_pack.pack_hq_core`` (reference
src/Library/src/Slices.cpp:305-467 over VLC.cpp:21-94). ``pack_hq``
assembles a whole picture's slices from quantised lanes;
``quant_pack_hq`` takes the transform lanes and quantises them on the way
(the JAX encoder's ``quant_banded`` then ``pack_hq_core``). Both go
through one launch of a CUDA kernel (``csrc/hq_pack.cu``: each CTA places
its tile of slices by a decoupled look-back, so no scan runs between
launches) for CUDA tensors, and through the plain PyTorch versions
``pack_hq_plain`` / ``quant_pack_hq_plain`` for CPU tensors.

Layout of a slice: ``prefix`` zero bytes, the qIndex byte, then per
component a length byte (bytes / scalar) and its interleaved signed
exp-Golomb codes, cut at the component's byte bound (a trailing run of
zero coefficients is 1-bit codes that may fall past it) and zero-filled
to it. HQ CBR (``slice_sizes`` given) makes the third component fill the
slice's byte budget.

Both routes return one uint8 buffer, ``[totals int32 [N] | payload]``
(``split_result`` takes it apart), and the error flags. When a flag is
set the payload is left out: the slice sizes are not valid, and the
encoder raises with the reference's message (``check_flags``). The flags
word lies in the launch's scratch (``pack_scratch``); HQ CBR's rate
control (``rdo/cbr.py``) sets ``FLAG_QMAX`` in it before the pack, so one
synchronisation reads both.

LD (``quant_pack_ld``, the port of ``pack_ld_core``): each slice at its
fixed byte offset, its body lanes quantised in the load of one launch of
``csrc/ld_pack.cu`` after the rate control's LL lanes (a group of threads
a slice, sized as ``ld_chunk_sizes_plain`` sizes it); ``pack_ld_plain``
assembles the same buffer ``[flags uint32 | payload]`` from quantised
lanes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.quant.quantiser import (QUANT_FACTORS_I32,
                                         adjust_quant_index, quant)
from vc2tpu_torch.vlc.golomb import (_code_bits, interleave, signed_codes,
                                     truncated_bits)

FLAG_SCALAR = 2          # a component length byte > 255 ("scalar too small")
FLAG_CBR_FIT = 4         # CBR: y+u data leave v too few bytes
FLAG_QINDEX = 8          # a qIndex exceeds 8 bits
FLAG_VLEN = 32           # CBR: forced v length byte > 255 (Slices.cpp:365)
FLAG_QMAX = 64           # CBR: the rate control chose a qIndex above 119

# csrc/hq_pack.cu's work split (generated into its header): 256 threads a
# CTA, a group of 4-32 threads a slice, each keeping up to HOLD quantised
# lanes in shared memory
THREADS = 256
HOLD = 32


def check_flags(flags: int) -> None:
    """Raise the reference's error for the pack's flags (in the JAX
    encoder's order, ``vc2tpu/pipeline/encoder.py:374-387``)."""
    if flags & (FLAG_QMAX | FLAG_QINDEX):
        raise ValueError(
            "quantization index exceeds maximum implemented value.")
    if flags & FLAG_CBR_FIT:
        raise ValueError("SliceIO, HQ CBR mode: Too many bytes for the slice")
    if flags & FLAG_VLEN:
        raise ValueError(
            "Slice component length exceeds 1 byte when divided by slice "
            "size scalar. See above for suggestions to prevent this.")
    if flags & FLAG_SCALAR:
        raise ValueError(
            "Slice scalar is too small, consider using a larger slice "
            "scalar.")


def split_result(buf, n: int):
    """(totals int32 [N], payload uint8) views of a ``pack_hq`` buffer
    (a tensor on any device, or a NumPy array)."""
    if isinstance(buf, torch.Tensor):
        return buf[:4 * n].view(torch.int32), buf[4 * n:]
    return buf[:4 * n].view("<i4"), buf[4 * n:]


def _check(qy, qu, qv, q_idx, slice_sizes):
    n = qy.shape[0]
    for name, t in (("qy", qy), ("qu", qu), ("qv", qv)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"pack_hq: {name} must be int32 [N, L], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if qu.shape != qv.shape:
        raise ValueError("pack_hq: qu and qv differ in shape")
    for name, t in (("q_idx", q_idx), ("slice_sizes", slice_sizes)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (n,)):
            raise ValueError(f"pack_hq: {name} must be int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (qu, qv, q_idx, slice_sizes):
        if t is not None and t.device != qy.device:
            raise ValueError(f"pack_hq: inputs on {t.device} and "
                             f"{qy.device}")


def _component_bytes(lanes, nbits, scalar: int):
    """Scaled bytes of each slice's component (reference Slices.cpp:
    97-119): bits up to the last non-zero coefficient, in whole bytes, in
    whole units of ``scalar``."""
    n, length = lanes.shape
    idx = torch.arange(length, device=lanes.device)
    last = torch.where(lanes != 0, idx, -1).amax(1) if length else \
        torch.full((n,), -1, dtype=torch.int64, device=lanes.device)
    used = nbits.sum(1) - (length - 1 - last)
    return ((used + 7) // 8 + scalar - 1) // scalar


def pack_hq_plain(qy, qu, qv, q_idx, prefix: int, scalar: int,
                  slice_sizes=None):
    """Plain PyTorch version of ``pack_hq``, on any device: every code is
    placed bit by bit (one pass per bit index of the longest code). Returns
    (buffer, flags) as ``pack_hq`` does."""
    _check(qy, qu, qv, q_idx, slice_sizes)
    dev = qy.device
    comps = (qy, qu, qv)
    codes = [signed_codes(c) for c in comps]
    scaled = [_component_bytes(c, nb, scalar) for c, (_, nb) in
              zip(comps, codes)]
    flags = 0
    if bool((scaled[0] > 255).any() | (scaled[1] > 255).any()):
        flags |= FLAG_SCALAR
    yb, ub = scaled[0] * scalar, scaled[1] * scalar
    if slice_sizes is not None:
        vb = slice_sizes.to(torch.int64) - 4 - yb - ub
        if bool((vb < scaled[2] * scalar).any()):
            flags |= FLAG_CBR_FIT
        if bool((torch.div(vb, scalar, rounding_mode="trunc") > 255).any()):
            flags |= FLAG_VLEN
    else:
        vb = scaled[2] * scalar
        if bool((scaled[2] > 255).any()):
            flags |= FLAG_SCALAR
    if bool((q_idx > 255).any()):
        flags |= FLAG_QINDEX
    totals = prefix + 4 + yb + ub + vb
    head = totals.to(torch.int32).view(torch.uint8)
    if flags:
        return head.clone(), flags
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
    return torch.cat([head, payload.to(torch.uint8)]), flags


def quant_pack_hq_plain(y, u, v, q_idx, qm_y, qm_c, prefix: int,
                        scalar: int, slice_sizes=None,
                        keep_lanes: bool = False, scratch=None):
    """Plain PyTorch version of ``quant_pack_hq``: ``quant`` of each lane
    at max(qIndex - qm[lane], 0), then ``pack_hq_plain``; flags already
    set in ``scratch`` join the result's."""
    _check_qm(y, u, qm_y, qm_c)
    q = q_idx.to(torch.int64)[:, None]
    lanes = [quant(x, adjust_quant_index(q, qm.to(torch.int64)[None, :]))
             for x, qm in ((y, qm_y), (u, qm_c), (v, qm_c))]
    buf, flags = pack_hq_plain(*lanes, q_idx, prefix, scalar, slice_sizes)
    if scratch is not None and int(scratch[1]):
        flags |= int(scratch[1])
        buf = buf[:4 * y.shape[0]]
    return buf, flags, tuple(lanes) if keep_lanes else None


def _check_qm(y, u, qm_y, qm_c):
    for name, qm, length in (("qm_y", qm_y, y.shape[-1]),
                             ("qm_c", qm_c, u.shape[-1])):
        if qm.dtype != torch.int32 or qm.shape != (length,):
            raise ValueError(f"quant_pack_hq: {name} must be int32 "
                             f"[{length}], got {qm.dtype} {tuple(qm.shape)}")
        if qm.device != y.device:
            raise ValueError(f"quant_pack_hq: {name} on {qm.device}, lanes "
                             f"on {y.device}")


def quant_reciprocals() -> list:
    """ceil(2^64 / |factor|) for each q: the high 64 bits of n times it
    are n // |factor| for every n < 2^32 (the error n * (ceil - 2^64 / f)
    / 2^64 < 2^-32 <= 1 / f cannot carry n / f past an integer)."""
    return [-(-(1 << 64) // abs(int(f))) for f in QUANT_FACTORS_I32]


def params_header() -> str:
    """``hq_pack_params.h`` for csrc/hq_pack.cu: its work split (``THREADS``,
    ``HOLD``), the int32-wrapped quant factor table
    (``quantiser.QUANT_FACTORS_I32``) and the reciprocals of its
    magnitudes (``quant_reciprocals``)."""
    factors = ", ".join(str(int(f)) for f in QUANT_FACTORS_I32)
    recips = ", ".join(f"0x{r:x}ull" for r in quant_reciprocals())
    return ("// Generated by vc2tpu_torch.vlc.device_pack.params_header().\n"
            "#pragma once\n"
            f"#define VC2_PACK_THREADS {THREADS}\n"
            f"#define VC2_PACK_HOLD {HOLD}\n"
            f"#define VC2_QUANT_FACTORS {factors}\n"
            f"#define VC2_QUANT_RECIPROCALS {recips}\n")


def kernel_source() -> build.Source:
    return build.Source("hq_pack", (("hq_pack_params.h", params_header()),))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hq_pack_launch.argtypes = [p, p, p, i, i, p, p, p, p, p, p, p, i, i,
                                   i, i, p, ctypes.c_longlong, p, p]
    lib.hq_pack_launch.restype = i
    return lib


def group_size(ly: int, lc: int) -> int:
    """Threads a slice in csrc/hq_pack.cu: the fewest (a power of two, 4 to
    32) whose three chunks, one of each component, hold at most ``HOLD``
    lanes, so the kernel keeps every quantised lane on the chip; 32 for
    larger slices, whose lanes are then read again to be written."""
    g = 4
    while g < 32 and -(-ly // g) + 2 * -(-lc // g) > HOLD:
        g *= 2
    return g


def payload_capacity(n: int, ly: int, lc: int, prefix: int, scalar: int,
                     cbr: bool) -> int:
    """Payload bytes that bound every pack of n slices that sets no flag,
    from the shapes alone. A component of L lanes codes in at most 8L
    bytes (64 bits a code) and rounds up by less than ``scalar``; without
    a flag its length byte is at most 255, so it holds at most 255 *
    scalar bytes, and CBR's last component less than 256 * scalar."""
    if cbr:
        body = 3 * 255 * scalar + scalar - 1
    else:
        body = min(8 * ly + 16 * lc + 3 * (scalar - 1), 3 * 255 * scalar)
    return n * (prefix + 4 + body)


def pack_scratch(n: int, ly: int, lc: int, device) -> torch.Tensor:
    """The zeroed int64 scratch of one launch of n slices: [ticket, flags,
    payload size, a status word a tile]."""
    tiles = -(-n // (THREADS // group_size(ly, lc)))
    return torch.zeros(3 + tiles, dtype=torch.int64, device=device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_pack(lanes, q_idx, prefix: int, scalar: int, slice_sizes=None,
                qm=None, keep=None, out=None, scratch=None):
    """The one launch of csrc/hq_pack.cu on CUDA tensors (checked by the
    caller), not synchronised. ``lanes`` (y, u, v) are quantised lanes,
    or transform lanes when ``qm`` = (qm_y, qm_c) is given; ``keep`` (y,
    u, v) then receive the quantised lanes. ``out`` (uint8, 16-byte
    aligned) defaults to a buffer of ``4N + payload_capacity`` bytes;
    nothing is stored past it. ``scratch`` defaults to a new
    ``pack_scratch``. Returns (out, scratch): the payload size is
    ``scratch[2]`` and the flags ``scratch[1]``."""
    y, u, v = lanes
    n, ly, lc = y.shape[0], y.shape[1], u.shape[1]
    group = group_size(ly, lc)
    if out is None:
        cap = payload_capacity(n, ly, lc, prefix, scalar,
                               slice_sizes is not None)
        out = torch.empty(4 * n + cap, dtype=torch.uint8, device=y.device)
    elif (out.dtype != torch.uint8 or not out.is_contiguous()
          or out.data_ptr() % 16 or out.numel() < 4 * n):
        raise ValueError("pack_hq: out must be a contiguous, 16-byte aligned "
                         f"uint8 buffer of at least {4 * n} bytes")
    if scratch is None:
        scratch = pack_scratch(n, ly, lc, y.device)
    elif (scratch.dtype != torch.int64 or scratch.device != y.device
          or not scratch.is_contiguous()
          or scratch.numel() != 3 + -(-n // (THREADS // group))):
        raise ValueError("pack_hq: scratch must come from pack_scratch")
    qm_y, qm_c = qm if qm is not None else (None, None)
    ky, ku, kv = keep if keep is not None else (None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with devices.guard(y):
        rc = _lib().hq_pack_launch(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), ly, lc, ptr(qm_y),
            ptr(qm_c), ptr(ky), ptr(ku), ptr(kv), q_idx.data_ptr(),
            ptr(slice_sizes), n, group, prefix, scalar,
            out.data_ptr(), out.numel() - 4 * n, scratch.data_ptr(),
            _stream(y))
    if rc:
        raise RuntimeError(f"hq_pack kernel launch failed: CUDA error {rc}")
    pack_hq.launches += 1
    return out, scratch


def _result(out, scratch, n: int):
    """The (buffer, flags) of a launch: the host's one synchronisation
    reads the flags and the payload size together."""
    flags, total = scratch[1:3].tolist()
    if flags:
        return out[:4 * n], flags
    return out[:4 * n + total], 0


def _cuda_inputs(name, tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


@capture.counted
def pack_hq(qy, qu, qv, q_idx, prefix: int, scalar: int, slice_sizes=None):
    """Assemble the HQ slice payload of a picture.

    qy: int32 [N, Ly], qu/qv: int32 [N, Lc] quantised lanes in
    serialisation order; q_idx: int32 [N]; slice_sizes: None (ConstQ) or
    the int32 [N] CBR byte budgets (``layout.slice_bytes_map``).
    Returns (buffer, flags): the uint8 ``[totals int32 [N] | payload]``
    buffer on the lanes' device, and the flags as an int (payload left out
    when it is not 0). CUDA lanes go through the one launch of
    csrc/hq_pack.cu and one synchronisation, to read the payload size and
    the flags; CPU lanes through ``pack_hq_plain``."""
    if qy.device.type == "cpu":
        return pack_hq_plain(qy, qu, qv, q_idx, prefix, scalar, slice_sizes)
    if qy.device.type != "cuda":
        raise ValueError(f"pack_hq: unsupported device {qy.device}")
    _check(qy, qu, qv, q_idx, slice_sizes)
    _cuda_inputs("pack_hq", (qy, qu, qv, q_idx, slice_sizes))
    n = qy.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.uint8, device=qy.device), 0
    return _result(*launch_pack((qy, qu, qv), q_idx, prefix, scalar,
                                slice_sizes), n)


def quant_pack_hq(y, u, v, q_idx, qm_y, qm_c, prefix: int, scalar: int,
                  slice_sizes=None, keep_lanes: bool = False, scratch=None):
    """Quantise and assemble the HQ slice payload of a picture.

    y: int32 [N, Ly], u/v: int32 [N, Lc] transform lanes in serialisation
    order; qm_y: int32 [Ly], qm_c: int32 [Lc] the quant matrix entry of
    each lane (``pipeline.decoder.qm_lanes``); each lane is quantised at
    max(q_idx - qm, 0). Returns (buffer, flags, lanes): as ``pack_hq``,
    and the quantised lanes (y, u, v) when ``keep_lanes``, else None.
    ``scratch`` (``pack_scratch``) may carry flags set before the pack,
    by the rate control. CUDA lanes go through the one launch of
    csrc/hq_pack.cu (quantised in its load) and one synchronisation, to
    read the payload size and the flags; the buffer stays on the device,
    so the caller's copy of it to the host waits a second time
    (``Encoder.encode_picture_async`` waits once, on an event, before its
    copy). CPU lanes go through ``quant_pack_hq_plain``."""
    buf, status, keep = quant_pack_hq_queued(
        y, u, v, q_idx, qm_y, qm_c, prefix, scalar, slice_sizes, keep_lanes,
        scratch)
    flags, total = status.tolist()         # the one synchronisation
    return buf[:4 * y.shape[0] + (0 if flags else total)], flags, keep


def quant_pack_hq_queued(y, u, v, q_idx, qm_y, qm_c, prefix: int,
                         scalar: int, slice_sizes=None,
                         keep_lanes: bool = False, scratch=None):
    """``quant_pack_hq`` without its synchronisation, for a caller that
    reads several packs at once (``pipeline.sharded``) or later
    (``Encoder.encode_picture_async``): returns (buffer,
    status, lanes), status the int64 [flags, payload size] on the lanes'
    device; when flags is 0 the payload is buffer[4N:4N + size] (the
    buffer may be longer). CUDA lanes go through the one launch of
    csrc/hq_pack.cu, not synchronised; CPU lanes through
    ``quant_pack_hq_plain``."""
    n = y.shape[0]
    if y.device.type == "cpu":
        buf, flags, lanes = quant_pack_hq_plain(
            y, u, v, q_idx, qm_y, qm_c, prefix, scalar, slice_sizes,
            keep_lanes, scratch)
        return buf, torch.tensor([flags, buf.numel() - 4 * n]), lanes
    if y.device.type != "cuda":
        raise ValueError(f"quant_pack_hq: unsupported device {y.device}")
    _check(y, u, v, q_idx, slice_sizes)
    _check_qm(y, u, qm_y, qm_c)
    _cuda_inputs("quant_pack_hq", (y, u, v, q_idx, slice_sizes, qm_y, qm_c))
    keep = tuple(torch.empty_like(x) for x in (y, u, v)) if keep_lanes \
        else None
    if n == 0:
        return (torch.empty(0, dtype=torch.uint8, device=y.device),
                torch.zeros(2, dtype=torch.int64, device=y.device), keep)
    out, scratch = launch_pack((y, u, v), q_idx, prefix, scalar, slice_sizes,
                               (qm_y, qm_c), keep, scratch=scratch)
    return out, scratch[1:3], keep


# --- LD -------------------------------------------------------------------

FLAG_LD_FIT = 128        # LD: the U/V codes exceed the slice's remaining bits
# csrc/ld_pack.cu's work split (generated into its header): LD_THREADS
# threads a CTA, a group of 4-32 threads a slice (ld_group_size), each
# holding up to LD_HOLD quantised lanes in shared memory, and at least
# LD_MIN_BLOCKS CTAs an SM (__launch_bounds__: 64 registers a thread). At
# 1080p a group of 4 and one wave of 1013 CTAs were fastest of 4-16
# threads a slice and 4-12 CTAs an SM (PERF.md §6).
LD_THREADS = 128
LD_HOLD = 32
LD_MIN_BLOCKS = 8


def ld_group_size(ly: int, lc: int) -> int:
    """Threads a slice in csrc/ld_pack.cu: the fewest (a power of two, 4 to
    32) whose chunks, one of the luma lanes and the same index range of U
    and V, hold at most ``LD_HOLD`` lanes, so the kernel keeps every
    quantised lane on the chip; 32 for larger slices, whose lanes are then
    read again to be written."""
    g = 4
    while g < 32 and -(-ly // g) + 2 * -(-lc // g) > LD_HOLD:
        g *= 2
    return g


def ld_chunks(length: int, g: int) -> list:
    """The lane range [lo, hi) of each of the g threads of a group over
    ``length`` lanes, as csrc/ld_pack.cu splits them."""
    lg = g.bit_length() - 1
    return [((t * length) >> lg, ((t + 1) * length) >> lg) for t in range(g)]


def ld_chunk_sizes_plain(qy, qu, qv, g: int):
    """The sizing of csrc/ld_pack.cu, in plain PyTorch: thread t of a
    slice's group of g sums its chunk's code bits and the bits up to the
    end of its last non-zero code, in the luma region and in its part of
    the interleaved U/V region; an exclusive scan over the group gives the
    bits before each chunk, a max over it the region's bits up to its last
    non-zero code. Returns (y_before [N, g], uv_before [N, g], y_used [N],
    uv_used [N]), int64."""

    def region(parts):
        bits, ends = [], []
        for lanes in parts:
            cum = torch.cumsum(_code_bits(lanes), 1)
            last = (cum[:, -1] if lanes.shape[1] else
                    torch.zeros(lanes.shape[0], dtype=torch.int64,
                                device=lanes.device))
            bits.append(last)
            ends.append(torch.where(lanes != 0, cum, 0).amax(1)
                        if lanes.shape[1] else last)
        bits, ends = torch.stack(bits, 1), torch.stack(ends, 1)
        before = torch.cumsum(bits, 1) - bits
        used = torch.where(ends > 0, before + ends, 0).amax(1)
        return before, used

    y_before, y_used = region([qy[:, lo:hi] for lo, hi in
                               ld_chunks(qy.shape[1], g)])
    uv_before, uv_used = region([interleave(qu[:, lo:hi], qv[:, lo:hi])
                                 for lo, hi in ld_chunks(qu.shape[1], g)])
    return y_before, uv_before, y_used, uv_used


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


def _check_ld(qy, qu, qv, q_idx, sizes):
    n = qy.shape[0]
    for name, t in (("qy", qy), ("qu", qu), ("qv", qv)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"LD pack: {name} must be int32 [N, L], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if qu.shape != qv.shape:
        raise ValueError("LD pack: qu and qv differ in shape")
    for name, t in (("q_idx", q_idx), ("sizes", sizes)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"LD pack: {name} must be int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (qu, qv, q_idx, sizes):
        if t.device != qy.device:
            raise ValueError(f"LD pack: inputs on {t.device} and "
                             f"{qy.device}")


def pack_ld_plain(qy, qu, qv, q_idx, sizes):
    """Assemble the LD slice payload of a picture from quantised lanes, in
    plain PyTorch on any device: each region's codes placed bit by bit (one
    pass per bit index of the longest code).

    qy: int32 [N, Ly], qu/qv: int32 [N, Lc] quantised lanes in lane order;
    q_idx: int32 [N]; sizes: int32 [N] the slice bytes. Returns the uint8
    buffer [flags uint32 | payload] (``ld_result`` splits it);
    ``FLAG_LD_FIT`` where a slice's U/V codes do not fit."""
    from vc2tpu_torch.slices.ld import len_bits_of

    _check_ld(qy, qu, qv, q_idx, sizes)
    dev = qy.device
    size = sizes.to(torch.int64)
    len_bits = torch.as_tensor(len_bits_of(size.cpu().numpy()), device=dev)
    y_used = truncated_bits(qy)
    uv = interleave(qu, qv)
    uv_used = truncated_bits(uv)
    uv_bits = 8 * size - 7 - len_bits - y_used
    flags = FLAG_LD_FIT if bool((uv_used > uv_bits).any()) else 0
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
    payload = (bits.view(-1, 8) * weights).sum(1).to(torch.uint8)
    head = torch.tensor([flags], dtype=torch.int32).view(torch.uint8)
    return torch.cat([head.to(dev), payload])


def ld_result(buf):
    """(flags, payload) of an LD pack buffer: a tensor on any device
    (read with one synchronisation) or a NumPy array."""
    if isinstance(buf, torch.Tensor):
        buf = buf.cpu().numpy()
    return int(buf[:4].view("<u4")[0]), buf[4:]


def _ld_starts(sizes: torch.Tensor) -> torch.Tensor:
    size = sizes.to(torch.int64)
    return torch.cumsum(size, 0) - size


def ld_kernel_source() -> build.Source:
    factors = ", ".join(str(int(f)) for f in QUANT_FACTORS_I32)
    recips = ", ".join(f"0x{r:x}ull" for r in quant_reciprocals())
    header = ("// Generated by vc2tpu_torch.vlc.device_pack."
              "ld_kernel_source().\n"
              "#pragma once\n"
              f"#define VC2_LD_PACK_THREADS {LD_THREADS}\n"
              f"#define VC2_LD_PACK_HOLD {LD_HOLD}\n"
              f"#define VC2_LD_PACK_MIN_BLOCKS {LD_MIN_BLOCKS}\n"
              f"#define VC2_FLAG_LD_FIT {FLAG_LD_FIT}\n"
              f"#define VC2_QUANT_FACTORS {factors}\n"
              f"#define VC2_QUANT_RECIPROCALS {recips}\n")
    return build.Source("ld_pack", (("ld_pack_params.h", header),))


@functools.lru_cache(maxsize=None)
def _ld_lib():
    lib = build.load(ld_kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ld_pack_launch.argtypes = [p, p, p, i, i, p, p, p, i, i, p, p, p, p,
                                   p, p, p, p, i, i, p, p]
    lib.ld_pack_launch.restype = i
    return lib


def launch_ld_pack(lanes, ll, q_idx, qm, sizes, starts, total: int,
                   keep=None, out=None):
    """The one launch of csrc/ld_pack.cu on CUDA tensors (checked by the
    caller), not synchronised. ``lanes`` (y, u, v) are transform lanes whose
    first lanes ``ll`` (the rate control's LL lanes) replace, the others
    quantised at max(q_idx - qm, 0), ``qm`` = (qm_y, qm_c); ``keep`` (y, u,
    v) receive the quantised lanes. ``starts`` (int64 [N]) is each slice's
    first byte, ``total`` the payload's bytes. ``out`` (uint8, contiguous,
    16-byte aligned) defaults to a new buffer of 4 + total bytes; the
    kernel stores nothing past them. Returns the uint8 buffer [flags uint32
    | payload]."""
    y, u, v = lanes
    n, ly, lc = y.shape[0], y.shape[1], u.shape[1]
    if out is None:
        out = torch.empty(4 + total, dtype=torch.uint8, device=y.device)
    elif (out.dtype != torch.uint8 or not out.is_contiguous()
          or out.numel() < 4 + total or out.device != y.device
          or out.data_ptr() % 16):
        raise ValueError(f"quant_pack_ld: out must be a contiguous, 16-byte "
                         f"aligned uint8 buffer of at least {4 + total} "
                         f"bytes on {y.device}")
    out[:4].zero_()
    ky, ku, kv = keep if keep is not None else (None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with devices.guard(y):
        rc = _ld_lib().ld_pack_launch(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), ly, lc,
            ll[0].data_ptr(), ll[1].data_ptr(), ll[2].data_ptr(),
            ll[0].shape[1], ll[1].shape[1], qm[0].data_ptr(),
            qm[1].data_ptr(), ptr(ky), ptr(ku), ptr(kv), q_idx.data_ptr(),
            sizes.data_ptr(), starts.data_ptr(), n, ld_group_size(ly, lc),
            out.data_ptr(), _stream(y))
    if rc:
        raise RuntimeError(f"ld_pack kernel launch failed: CUDA error {rc}")
    quant_pack_ld.launches += 1
    return out


def _check_ll(lanes, ll, qm_y, qm_c):
    _check_qm(lanes[0], lanes[1], qm_y, qm_c)
    for name, x, l in zip("yuv", lanes, ll):
        if (l.dtype != torch.int32 or l.dim() != 2
                or l.shape[0] != x.shape[0] or l.shape[1] > x.shape[1]
                or l.device != x.device):
            raise ValueError(f"quant_pack_ld: ll_{name} must be int32 [N, "
                             f"nLL] on {x.device}, got {l.dtype} "
                             f"{tuple(l.shape)}")


def quant_pack_ld_plain(y, u, v, ll, q_idx, qm_y, qm_c, sizes,
                        keep_lanes: bool = False):
    """Plain PyTorch version of ``quant_pack_ld``: the body lanes quantised
    at max(qIndex - qm[lane], 0) after the rate control's LL lanes, then
    ``pack_ld_plain``."""
    _check_ll((y, u, v), ll, qm_y, qm_c)
    q = q_idx.to(torch.int64)[:, None]
    lanes = []
    for x, l, qm in ((y, ll[0], qm_y), (u, ll[1], qm_c), (v, ll[2], qm_c)):
        k = l.shape[1]
        aq = adjust_quant_index(q, qm[k:].to(torch.int64)[None, :])
        lanes.append(torch.cat([l, quant(x[:, k:], aq)], 1))
    buf = pack_ld_plain(*lanes, q_idx, sizes)
    return buf, tuple(lanes) if keep_lanes else None


@capture.counted
def quant_pack_ld(y, u, v, ll, q_idx, qm_y, qm_c, sizes, starts=None,
                  total=None, keep_lanes: bool = False):
    """Quantise and assemble the LD slice payload of a picture.

    y: int32 [N, Ly], u/v: int32 [N, Lc] transform lanes in lane order;
    ll: the rate control's LL lanes (y [N, nLLy], u and v [N, nLLc]),
    which replace the first lanes; qm_y: int32 [Ly], qm_c: int32 [Lc] the
    quant matrix entry of each lane; the other lanes are quantised at
    max(q_idx - qm, 0). sizes: int32 [N] the slice bytes; ``starts`` (int64
    [N], each slice's first byte) and ``total`` (the payload's bytes) may
    be given to save their sums. Returns (buffer, lanes): the uint8
    [flags uint32 | payload] buffer on the lanes' device and, when
    ``keep_lanes``, the quantised lanes (y, u, v), else None. CUDA lanes
    go through one launch of csrc/ld_pack.cu (quantised in its load), not
    synchronised; CPU lanes through ``quant_pack_ld_plain``."""
    if y.device.type == "cpu":
        return quant_pack_ld_plain(y, u, v, ll, q_idx, qm_y, qm_c, sizes,
                                   keep_lanes)
    if y.device.type != "cuda":
        raise ValueError(f"quant_pack_ld: unsupported device {y.device}")
    _check_ld(y, u, v, q_idx, sizes)
    _check_ll((y, u, v), ll, qm_y, qm_c)
    _cuda_inputs("quant_pack_ld", (y, u, v, *ll, q_idx, sizes, qm_y, qm_c))
    if starts is None:
        starts = _ld_starts(sizes)
    if total is None:
        total = int(sizes.to(torch.int64).sum())
    keep = tuple(torch.empty_like(x) for x in (y, u, v)) if keep_lanes \
        else None
    if y.shape[0] == 0:
        return torch.zeros(4, dtype=torch.uint8, device=y.device), keep
    return launch_ld_pack((y, u, v), ll, q_idx, (qm_y, qm_c), sizes, starts,
                          total, keep), keep
