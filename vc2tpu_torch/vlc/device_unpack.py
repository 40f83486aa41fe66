"""On-device entropy unpack: slice payload bytes -> coefficient lanes.

Ports of ``vc2tpu.vlc.device_unpack.unpack_hq_lanes`` and
``unpack_ld_lanes``. Every slice component is a bounded region of
interleaved exp-Golomb codes (reference src/Library/src/VLC.cpp:54-94;
the slice layouts are src/Library/src/Slices.cpp:384-467 for HQ, whose
regions are byte-granular, and :195-303 for LD, whose two regions a slice
start mid-byte and are bounded in bits). ``unpack_hq`` and ``unpack_ld``
decode all of a picture's regions: CUDA kernels (``csrc/hq_unpack.cu``,
``csrc/ld_unpack.cu``, one decode core in ``csrc/golomb_decode.cuh``) for
CUDA tensors, the plain PyTorch versions ``unpack_hq_plain`` and
``unpack_ld_plain`` for CPU tensors. Both plain versions are the one
bit-granular reader ``unpack_signed_streams``. A code's length and value
depend only on the 64 bits at its start (``_codes_at``): the LD kernel
takes a step a code from a fresh peek, and ``ld_code_starts_plain`` finds
every code's start from the lengths at all bit positions at once, with
no walk (pointer doubling), an independent parse that the tests hold to
the reader.

Semantics, as in the JAX package:

* bits at or past a region's bound read as 1 (VLC.cpp:182-185), and so do
  bits past the end of the payload; a code that starts before the bound
  and straddles it decodes with the 1-fill;
* a code is accepted only if it starts before the bound, and a row stops
  at its lane count; lanes never written stay 0;
* the follow-bit position is clamped to 62 (at most 31 data bits), and the
  value is +-((1 << ndata | data) - 1) in 64 bits, truncated to int32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.intmath import wrap32


def hq_component_offsets(clens: torch.Tensor, prefix: int,
                         start: int) -> torch.Tensor:
    """Per-component data byte offsets from the slice chain structure
    (prefix zeros, 1B qIndex, then per component {1B length, data}).
    clens: int32 [3, N]. Returns int32 [3, N]."""
    c = clens.to(torch.int64)
    totals = prefix + 4 + c[0] + c[1] + c[2]
    sstart = start + torch.cumsum(totals, 0) - totals
    d0 = sstart + prefix + 2
    d1 = d0 + c[0] + 1
    d2 = d1 + c[1] + 1
    return torch.stack([d0, d1, d2]).to(torch.int32)


def _check(payload, dstart, clen):
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError("unpack_hq: payload must be a 1-D uint8 tensor")
    for name, t in (("dstart", dstart), ("clen", clen)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != 3:
            raise ValueError(f"unpack_hq: {name} must be int32 [3, N], "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != payload.device:
            raise ValueError(f"unpack_hq: {name} is on {t.device}, "
                             f"payload on {payload.device}")
    if dstart.shape != clen.shape:
        raise ValueError("unpack_hq: dstart and clen differ in shape")


def unpack_signed_streams(payload: torch.Tensor, start_bits: torch.Tensor,
                          bound_bits: torch.Tensor, n_lanes: int,
                          lane_limits: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain bounded-stream reader: decode rows of interleaved exp-Golomb
    codes from bit-granular regions, one code a step for every row at once.

    payload: uint8 [P]. start_bits: int64 [S] absolute first bit of each
    row's region; bound_bits: int64 [S] its length in bits. Each row decodes
    ``n_lanes`` codes, or its entry of ``lane_limits`` (int64 [S], each at
    most ``n_lanes``). Returns int32 [S, n_lanes], lanes a row never
    reached 0. Bits at or past a row's bound, and past the payload's end,
    read as 1. The twin of ``vc2tpu.vlc.bitpack
    .unpack_signed_streams`` (which reads codes of more than 31 data bits
    bit by bit, where this clamps them, as the device unpacks do).

    The stream is expanded to one byte per bit, so a 64-bit peek is a
    gather and the follow-bit search an argmax (torch has no clz)."""
    dev = payload.device
    s = start_bits.numel()
    lim = (torch.full((s,), n_lanes, dtype=torch.int64, device=dev)
           if lane_limits is None
           else lane_limits.to(device=dev, dtype=torch.int64))
    bits, nbits = _stream_bits(payload)
    pos = start_bits.to(device=dev, dtype=torch.int64).reshape(-1)
    bound = pos + bound_bits.to(device=dev, dtype=torch.int64).reshape(-1)
    out = torch.zeros((s, n_lanes), dtype=torch.int32, device=dev)
    nd = torch.zeros(s, dtype=torch.int64, device=dev)
    rows = torch.arange(s, device=dev)
    for _ in range(n_lanes):
        active = (pos < bound) & (nd < lim)
        if not bool(active.any()):
            break
        val, length = _codes_at(bits, nbits, pos, bound)
        out[rows[active], nd[active]] = wrap32(val[active]).to(torch.int32)
        pos = torch.where(active, pos + length, pos)
        nd = nd + active.to(torch.int64)
    return out


def _stream_bits(payload: torch.Tensor):
    """(bits, nbits): the payload one int64 element a bit, MSB first, with
    one 1 bit appended, which every read past the end lands on."""
    shifts = torch.arange(7, -1, -1, device=payload.device)
    bits = ((payload.to(torch.int64)[:, None] >> shifts) & 1).reshape(-1)
    ones = torch.ones(1, dtype=torch.int64, device=payload.device)
    return torch.cat([bits, ones]), bits.numel()


def _codes_at(bits, nbits: int, pos, bound):
    """(value, length), int64, of the code that starts at each bit ``pos``
    (int64 [...]) of a region bounded at ``bound`` (the same shape), read
    from ``_stream_bits``: the bits at or past the bound or the payload's
    end read as 1; the follow-bit position is clamped to 62."""
    dev = bits.device
    idx = pos[..., None] + torch.arange(64, device=dev)
    w = torch.where(idx < bound[..., None], bits[idx.clamp(max=nbits)], 1)
    follow = w[..., 0::2]
    first = torch.where(follow.any(-1), follow.argmax(-1), 32)
    z = (2 * first).clamp(max=62)
    ndata = z >> 1
    j32 = torch.arange(32, device=dev)
    weight = torch.where(j32 < ndata[..., None],
                         1 << (ndata[..., None] - 1 - j32).clamp(min=0), 0)
    data = (w[..., 1::2] * weight).sum(-1)
    mag = ((1 << ndata) | data) - 1
    sign = w.gather(-1, (z + 1)[..., None])[..., 0]
    val = torch.where(z == 0, 0, torch.where(sign == 1, -mag, mag))
    return val, torch.where(z == 0, 1, z + 2)


def ld_code_starts_plain(payload: torch.Tensor, start_bits: torch.Tensor,
                         bound_bits: torch.Tensor, n_lanes: int
                         ) -> torch.Tensor:
    """The code starts of each bounded region, found without a walk: the
    parse of csrc/ld_unpack.cu in plain PyTorch.

    A code's length at a bit position depends only on the bits there
    (``_codes_at``), so the lengths of every position before the region's
    bound, and before 64 x ``n_lanes`` (past which no code is taken), are
    computed at once; the chain p0, p0 + len(p0), ... is then marked by
    pointer doubling: round k adds the 2^k-th successor of every marked
    position, so ceil(log2(n_lanes)) rounds mark the first ``n_lanes``
    codes. payload: uint8 [P]; start_bits, bound_bits: int64 [S] as for
    ``unpack_signed_streams``. Returns int64 [S, n_lanes]: the bit offset
    (from the region's start) of each code, -1 past the chain."""
    dev = payload.device
    bits, nbits = _stream_bits(payload)
    start = start_bits.to(device=dev, dtype=torch.int64).reshape(-1)
    length = bound_bits.to(device=dev, dtype=torch.int64).reshape(-1)
    rows = start.numel()
    span = length.clamp(0, 64 * n_lanes)
    top = int(span.max()) if rows else 0
    r = torch.arange(top + 1, device=dev)
    nxt = span[:, None].expand(rows, top + 1).clone()
    for c0 in range(0, top, 64):          # 64 positions at a time
        at = r[c0:min(c0 + 64, top)]
        _, ln = _codes_at(bits, nbits, start[:, None] + at,
                          (start + length)[:, None].expand(-1, at.numel()))
        live = at < span[:, None]
        nxt[:, at] = torch.where(live, torch.minimum(at + ln, span[:, None]),
                                 span[:, None])
    mark = torch.zeros((rows, top + 1), dtype=torch.bool, device=dev)
    mark[:, 0] = True
    jump = nxt
    for _ in range(max(n_lanes - 1, 0).bit_length()):
        mark.scatter_(1, torch.where(mark, jump, span[:, None]), True)
        jump = jump.gather(1, jump)
    mark &= r < span[:, None]
    rank = torch.cumsum(mark.to(torch.int64), 1) - 1
    take = mark & (rank < n_lanes)
    out = torch.full((rows, n_lanes), -1, dtype=torch.int64, device=dev)
    row_of = torch.arange(rows, device=dev)[:, None].expand_as(take)
    out[row_of[take], rank[take]] = r.expand_as(take)[take]
    return out


def unpack_parsed_plain(payload: torch.Tensor, start_bits: torch.Tensor,
                        bound_bits: torch.Tensor, n_lanes: int
                        ) -> torch.Tensor:
    """``unpack_signed_streams`` (without lane limits) by the parse of
    ``ld_code_starts_plain``: each code decoded at its start. Returns int32
    [S, n_lanes]."""
    dev = payload.device
    starts = ld_code_starts_plain(payload, start_bits, bound_bits, n_lanes)
    bits, nbits = _stream_bits(payload)
    start = start_bits.to(device=dev, dtype=torch.int64).reshape(-1, 1)
    bound = start + bound_bits.to(device=dev, dtype=torch.int64).reshape(
        -1, 1)
    val, _ = _codes_at(bits, nbits, start + starts.clamp(min=0),
                       bound.expand_as(starts))
    return wrap32(torch.where(starts >= 0, val, 0)).to(torch.int32)


def unpack_hq_plain(payload: torch.Tensor, dstart: torch.Tensor,
                    clen: torch.Tensor, ly: int, lc: int):
    """Plain PyTorch unpack of an HQ picture: its byte-granular regions
    through ``unpack_signed_streams``. Returns (qy [N, ly], qu [N, lc],
    qv [N, lc]) int32."""
    _check(payload, dstart, clen)
    n = dstart.shape[1]
    pos = 8 * dstart.reshape(-1).to(torch.int64)
    lim = torch.tensor([ly] * n + [lc] * (2 * n), dtype=torch.int64)
    out = unpack_signed_streams(payload, pos,
                                8 * clen.reshape(-1).to(torch.int64),
                                max(ly, lc), lim)
    return (out[:n, :ly].contiguous(), out[n:2 * n, :lc].contiguous(),
            out[2 * n:, :lc].contiguous())


# The kernel's plan: one CTA for each run of SLICES_PER_CTA slices (3 threads
# a slice, one for each component region; 32 was fastest of 16-128 on the
# 1080p fixture). It stages the payload bytes its regions span in a
# WINDOW_BYTES window of shared memory when they fit, and its lanes in a
# tile of rows of an odd pitch (so a warp's stores of one lane index fall
# in 32 different banks) when the tile fits LANE_TILE_BYTES; else it writes
# lanes straight to device memory.
SLICES_PER_CTA = 32
WINDOW_BYTES = 8192
LANE_TILE_BYTES = 98304


# The LD kernel's plan: CTAs of LD_SLICES_PER_CTA slices (two threads a
# slice) and a LD_WINDOW_BYTES window of staged payload (a 1080p CTA's
# regions span ~850 bytes).
LD_SLICES_PER_CTA = 32
LD_WINDOW_BYTES = 2048


def _plan(rows: tuple, slices: int = SLICES_PER_CTA) -> tuple:
    row = 4 * sum(length | 1 for length in rows)
    s = min(slices, LANE_TILE_BYTES // row)
    return (s, True) if s >= 1 else (slices, False)


def unpack_plan(ly: int, lc: int) -> tuple:
    """(slices a CTA, lanes staged in shared memory?) of the HQ kernel for
    these lane counts (three regions a slice)."""
    return _plan((ly, lc, lc))


def ld_unpack_plan(ly: int, lc: int) -> tuple:
    """The same for the LD kernel (two regions a slice: luma, and U/V
    interleaved)."""
    return _plan((ly, 2 * lc), LD_SLICES_PER_CTA)


def kernel_source() -> build.Source:
    return build.Source("hq_unpack")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    lib.hq_unpack_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.hq_unpack_launch.restype = ctypes.c_int
    return lib


@capture.counted
def unpack_hq(payload: torch.Tensor, dstart: torch.Tensor,
              clen: torch.Tensor, ly: int, lc: int,
              staged: torch.Tensor | None = None):
    """Decode every slice component of an HQ picture.

    payload: uint8 [P] (the bytes the offsets index).
    dstart: int32 [3, N] absolute byte offset of each component's region.
    clen: int32 [3, N] region length in bytes (the bound).
    staged: None, or (CUDA only) a uint8 tensor of one byte a CTA
    (ceil(N / s), s from ``unpack_plan``) that the kernel sets to 1 where
    the CTA staged its payload window in shared memory, 0 where its peeks
    read device memory.
    Returns (qy [N, ly], qu [N, lc], qv [N, lc]) int32 in lane order. A CUDA
    payload goes through the kernel of csrc/hq_unpack.cu; a CPU payload
    through unpack_hq_plain."""
    if payload.device.type == "cpu":
        if staged is not None:
            raise ValueError("unpack_hq: staged flags come from the CUDA "
                             "kernel only")
        return unpack_hq_plain(payload, dstart, clen, ly, lc)
    _check(payload, dstart, clen)
    n = dstart.shape[1]
    s, stage = unpack_plan(ly, lc)
    payload, out = _kernel_inputs("unpack_hq", payload, (dstart, clen), n,
                                  ly, lc, s, staged)
    qy, qu, qv = out
    if n == 0:
        return out
    with devices.guard(payload):
        rc = _lib().hq_unpack_launch(
            payload.data_ptr(), payload.numel(), dstart.data_ptr(),
            clen.data_ptr(), n, ly, lc, qy.data_ptr(), qu.data_ptr(),
            qv.data_ptr(), s, WINDOW_BYTES, int(stage),
            staged.data_ptr() if staged is not None else None,
            torch.cuda.current_stream(payload.device).cuda_stream)
    if rc:
        raise RuntimeError(f"hq_unpack kernel launch failed: CUDA error {rc}")
    unpack_hq.launches += 1
    return qy, qu, qv


def _kernel_inputs(name: str, payload: torch.Tensor, tensors: tuple, n: int,
                   ly: int, lc: int, s: int, staged):
    """The checks an unpack kernel's wrapper makes before its launch, and
    its outputs: (the payload, 16-byte aligned, (qy, qu, qv) empty)."""
    if payload.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {payload.device}")
    if not all(t.is_contiguous() for t in (payload, *tensors)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if payload.data_ptr() % 16:
        payload = payload.clone()          # the kernel loads 16-byte words
    if staged is not None and (
            staged.device != payload.device or staged.dtype != torch.uint8
            or not staged.is_contiguous() or staged.numel() != -(-n // s)):
        raise ValueError(f"{name}: staged must be a contiguous uint8 "
                         f"tensor of {-(-n // s)} CTAs on {payload.device}")
    return payload, tuple(
        torch.empty((n, lanes), dtype=torch.int32, device=payload.device)
        for lanes in (ly, lc, lc))


# --- LD -------------------------------------------------------------------

def _check_ld(payload, fields):
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError("unpack_ld: payload must be a 1-D uint8 tensor")
    if fields.dtype != torch.int32 or fields.dim() != 2 or fields.shape[0] != 4:
        raise ValueError("unpack_ld: fields must be int32 [4, N], got "
                         f"{fields.dtype} {tuple(fields.shape)}")
    if fields.device != payload.device:
        raise ValueError(f"unpack_ld: fields are on {fields.device}, "
                         f"payload on {payload.device}")


def ld_regions(fields: torch.Tensor):
    """(luma start, U/V start) absolute bits of every LD slice's two
    regions, int64 [N] each, from its fields [s_bits, len_bits, y_bits,
    uv_bits]: the luma region follows the 7-bit qIndex and the length
    field, the U/V region follows the luma region."""
    f = fields.to(torch.int64)
    luma = f[0] + 7 + f[1]
    return luma, luma + f[2]


def unpack_ld_plain(payload: torch.Tensor, fields: torch.Tensor, ly: int,
                    lc: int):
    """Plain PyTorch unpack of an LD picture: both bit-granular regions of
    every slice through ``unpack_signed_streams``, the U/V codes split into
    U (even) and V (odd). Returns (qy [N, ly], qu [N, lc], qv [N, lc])
    int32."""
    _check_ld(payload, fields)
    luma, chroma = ld_regions(fields)
    qy = unpack_signed_streams(payload, luma, fields[2], ly)
    quv = unpack_signed_streams(payload, chroma, fields[3], 2 * lc)
    return qy, quv[:, 0::2].contiguous(), quv[:, 1::2].contiguous()


def ld_kernel_source() -> build.Source:
    return build.Source("ld_unpack")


@functools.lru_cache(maxsize=None)
def _ld_lib():
    lib = build.load(ld_kernel_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ld_unpack_launch.argtypes = [p, ctypes.c_longlong, p, i, i, i, p, p,
                                     p, i, i, i, p, p]
    lib.ld_unpack_launch.restype = ctypes.c_int
    return lib


@capture.counted
def unpack_ld(payload: torch.Tensor, fields: torch.Tensor, ly: int, lc: int,
              staged: torch.Tensor | None = None):
    """Decode both regions of every slice of an LD picture.

    payload: uint8 [P] (the bytes the bit offsets index; bits past its end
    read as 1).
    fields: int32 [4, N]: each slice's s_bits (absolute first bit),
    len_bits, y_bits and uv_bits, from the host header walk
    (``slices.ld.ld_fields``).
    staged: as for ``unpack_hq`` (CTAs of ``ld_unpack_plan``).
    Returns (qy [N, ly], qu [N, lc], qv [N, lc]) int32 in lane order. A CUDA
    payload goes through the kernel of csrc/ld_unpack.cu; a CPU payload
    through unpack_ld_plain."""
    if payload.device.type == "cpu":
        if staged is not None:
            raise ValueError("unpack_ld: staged flags come from the CUDA "
                             "kernel only")
        return unpack_ld_plain(payload, fields, ly, lc)
    _check_ld(payload, fields)
    n = fields.shape[1]
    s, stage = ld_unpack_plan(ly, lc)
    payload, out = _kernel_inputs("unpack_ld", payload, (fields,), n, ly, lc,
                                  s, staged)
    qy, qu, qv = out
    if n == 0:
        return out
    with devices.guard(payload):
        rc = _ld_lib().ld_unpack_launch(
            payload.data_ptr(), payload.numel(), fields.data_ptr(), n, ly,
            lc, qy.data_ptr(), qu.data_ptr(), qv.data_ptr(), s,
            LD_WINDOW_BYTES, int(stage),
            staged.data_ptr() if staged is not None else None,
            torch.cuda.current_stream(payload.device).cuda_stream)
    if rc:
        raise RuntimeError(f"ld_unpack kernel launch failed: CUDA error {rc}")
    unpack_ld.launches += 1
    return out
