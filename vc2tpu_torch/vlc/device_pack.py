"""On-device HQ slice payload assembly: quantised lanes -> payload bytes.

Port of ``vc2tpu.vlc.device_pack.pack_hq_core`` (reference
src/Library/src/Slices.cpp:305-467 over VLC.cpp:21-94). ``pack_hq``
assembles a whole picture's slices: a CUDA kernel (``csrc/hq_pack.cu``,
two launches with an exclusive scan of the slice sizes between them) for
CUDA tensors, the plain PyTorch version ``pack_hq_plain`` for CPU tensors.

Layout of a slice: ``prefix`` zero bytes, the qIndex byte, then per
component a length byte (bytes / scalar) and its interleaved signed
exp-Golomb codes, cut at the component's byte bound (a trailing run of
zero coefficients is 1-bit codes that may fall past it) and zero-filled
to it. HQ CBR (``slice_sizes`` given) makes the third component fill the
slice's byte budget.

Both routes return one uint8 buffer, ``[totals int32 [N] | payload]``
(``split_result`` takes it apart), and the error flags. When a flag is
set the payload is left out: the slice sizes are not valid, and the
encoder raises with the reference's message (``check_flags``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.vlc.golomb import signed_codes

FLAG_SCALAR = 2          # a component length byte > 255 ("scalar too small")
FLAG_CBR_FIT = 4         # CBR: y+u data leave v too few bytes
FLAG_QINDEX = 8          # a qIndex exceeds 8 bits
FLAG_VLEN = 32           # CBR: forced v length byte > 255 (Slices.cpp:365)


def check_flags(flags: int) -> None:
    """Raise the reference's error for the pack's flags (in the JAX
    encoder's order, ``vc2tpu/pipeline/encoder.py:374-387``)."""
    if flags & FLAG_QINDEX:
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


def kernel_source() -> build.Source:
    return build.Source("hq_pack")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hq_pack_sizes_launch.argtypes = [p, p, p, i, i, p, p, i, i, i, p, p,
                                         p, p]
    lib.hq_pack_sizes_launch.restype = i
    lib.hq_pack_write_launch.argtypes = [p, p, p, i, i, p, p, p, p, i, i, i,
                                         p, p]
    lib.hq_pack_write_launch.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_sizes(qy, qu, qv, q_idx, prefix: int, scalar: int,
                 slice_sizes=None):
    """The first launch of ``pack_hq`` (CUDA tensors, checked by the
    caller): (component bytes int32 [N, 3], totals int32 [N], flags int32
    [1]), not synchronised."""
    n, dev = qy.shape[0], qy.device
    comp = torch.empty((n, 3), dtype=torch.int32, device=dev)
    totals = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = _lib().hq_pack_sizes_launch(
        qy.data_ptr(), qu.data_ptr(), qv.data_ptr(), qy.shape[1],
        qu.shape[1], q_idx.data_ptr(),
        slice_sizes.data_ptr() if slice_sizes is not None else None, n,
        prefix, scalar, comp.data_ptr(), totals.data_ptr(), flags.data_ptr(),
        _stream(qy))
    if rc:
        raise RuntimeError(f"hq_pack sizes kernel launch failed: CUDA error "
                           f"{rc}")
    pack_hq.launches += 1
    return comp, totals, flags


def launch_write(qy, qu, qv, q_idx, comp, totals, starts, total: int,
                 prefix: int, scalar: int) -> torch.Tensor:
    """The second launch of ``pack_hq``: the ``[totals | payload]`` buffer
    of ``total`` payload bytes, slice i at ``starts[i]`` (int64)."""
    n = qy.shape[0]
    out = torch.empty(4 * n + total, dtype=torch.uint8, device=qy.device)
    rc = _lib().hq_pack_write_launch(
        qy.data_ptr(), qu.data_ptr(), qv.data_ptr(), qy.shape[1],
        qu.shape[1], q_idx.data_ptr(), comp.data_ptr(), totals.data_ptr(),
        starts.data_ptr(), n, prefix, scalar, out.data_ptr(), _stream(qy))
    if rc:
        raise RuntimeError(f"hq_pack write kernel launch failed: CUDA error "
                           f"{rc}")
    pack_hq.launches += 1
    return out


def pack_hq(qy, qu, qv, q_idx, prefix: int, scalar: int, slice_sizes=None):
    """Assemble the HQ slice payload of a picture.

    qy: int32 [N, Ly], qu/qv: int32 [N, Lc] quantised lanes in
    serialisation order; q_idx: int32 [N]; slice_sizes: None (ConstQ) or
    the int32 [N] CBR byte budgets (``layout.slice_bytes_map``).
    Returns (buffer, flags): the uint8 ``[totals int32 [N] | payload]``
    buffer on the lanes' device, and the flags as an int (payload left out
    when it is not 0). CUDA lanes go through the two launches of
    csrc/hq_pack.cu, with one synchronisation between them to read the
    payload size and the flags; CPU lanes through ``pack_hq_plain``."""
    if qy.device.type == "cpu":
        return pack_hq_plain(qy, qu, qv, q_idx, prefix, scalar, slice_sizes)
    if qy.device.type != "cuda":
        raise ValueError(f"pack_hq: unsupported device {qy.device}")
    _check(qy, qu, qv, q_idx, slice_sizes)
    for t in (qy, qu, qv, q_idx, slice_sizes):
        if t is not None and not t.is_contiguous():
            raise ValueError("pack_hq: inputs must be contiguous")
    n = qy.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.uint8, device=qy.device), 0
    comp, totals, flags_t = launch_sizes(qy, qu, qv, q_idx, prefix, scalar,
                                         slice_sizes)
    ends = torch.cumsum(totals, 0, dtype=torch.int64)
    total, flags = torch.cat([ends[-1:], flags_t.to(torch.int64)]).tolist()
    if flags:
        return totals.view(torch.uint8).clone(), flags
    return launch_write(qy, qu, qv, q_idx, comp, totals, ends - totals,
                        total, prefix, scalar), 0


pack_hq.launches = 0
