"""On-device entropy unpack: HQ slice payload bytes -> coefficient lanes.

Port of ``vc2tpu.vlc.device_unpack.unpack_hq_lanes``. Every slice
component is a bounded region of interleaved exp-Golomb codes (reference
src/Library/src/VLC.cpp:54-94; the slice layout is
src/Library/src/Slices.cpp:384-467). ``unpack_hq`` decodes all of a
picture's regions: a CUDA kernel (``csrc/hq_unpack.cu``) for CUDA tensors,
the plain PyTorch version ``unpack_hq_plain`` for CPU tensors.

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


def unpack_hq_plain(payload: torch.Tensor, dstart: torch.Tensor,
                    clen: torch.Tensor, ly: int, lc: int):
    """Plain PyTorch unpack, one code per step for every region at once.
    The stream is expanded to one byte per bit, so a 64-bit peek is a
    gather and the follow-bit search an argmax (torch has no clz).
    Returns (qy [N, ly], qu [N, lc], qv [N, lc]) int32."""
    _check(payload, dstart, clen)
    dev = payload.device
    n = dstart.shape[1]
    shifts = torch.arange(7, -1, -1, device=dev)
    bits = ((payload.to(torch.int64)[:, None] >> shifts) & 1).reshape(-1)
    nbits = bits.numel()
    bits = torch.cat([bits, torch.ones(1, dtype=torch.int64, device=dev)])
    pos = 8 * dstart.reshape(-1).to(torch.int64)
    bound = pos + 8 * clen.reshape(-1).to(torch.int64)
    lim = torch.tensor([ly] * n + [lc] * (2 * n), dtype=torch.int64,
                       device=dev)
    width = max(ly, lc)
    out = torch.zeros((3 * n, width), dtype=torch.int32, device=dev)
    nd = torch.zeros(3 * n, dtype=torch.int64, device=dev)
    k64 = torch.arange(64, device=dev)
    j32 = torch.arange(32, device=dev)
    rows = torch.arange(3 * n, device=dev)
    for _ in range(width):
        active = (pos < bound) & (nd < lim)
        if not bool(active.any()):
            break
        idx = pos[:, None] + k64
        w = torch.where(idx < bound[:, None], bits[idx.clamp(max=nbits)], 1)
        follow = w[:, 0::2]
        first = torch.where(follow.any(1), follow.argmax(1), 32)
        z = (2 * first).clamp(max=62)
        ndata = z >> 1
        weight = torch.where(j32 < ndata[:, None],
                             1 << (ndata[:, None] - 1 - j32).clamp(min=0), 0)
        data = (w[:, 1::2] * weight).sum(1)
        mag = ((1 << ndata) | data) - 1
        sign = w.gather(1, (z + 1)[:, None])[:, 0]
        val = torch.where(z == 0, 0, torch.where(sign == 1, -mag, mag))
        out[rows[active], nd[active]] = wrap32(val[active]).to(torch.int32)
        pos = torch.where(active, pos + torch.where(z == 0, 1, z + 2), pos)
        nd = nd + active.to(torch.int64)
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


def unpack_plan(ly: int, lc: int) -> tuple:
    """(slices a CTA, lanes staged in shared memory?) for these lane
    counts."""
    row = 4 * ((ly | 1) + 2 * (lc | 1))
    s = min(SLICES_PER_CTA, LANE_TILE_BYTES // row)
    return (s, True) if s >= 1 else (SLICES_PER_CTA, False)


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
    if payload.device.type != "cuda":
        raise ValueError(f"unpack_hq: unsupported device {payload.device}")
    _check(payload, dstart, clen)
    if not (payload.is_contiguous() and dstart.is_contiguous()
            and clen.is_contiguous()):
        raise ValueError("unpack_hq: inputs must be contiguous")
    if payload.data_ptr() % 16:
        payload = payload.clone()          # the kernel loads 16-byte words
    n = dstart.shape[1]
    qy = torch.empty((n, ly), dtype=torch.int32, device=payload.device)
    qu = torch.empty((n, lc), dtype=torch.int32, device=payload.device)
    qv = torch.empty((n, lc), dtype=torch.int32, device=payload.device)
    if n == 0:
        return qy, qu, qv
    s, stage = unpack_plan(ly, lc)
    if staged is not None and (
            staged.device != payload.device or staged.dtype != torch.uint8
            or not staged.is_contiguous() or staged.numel() != -(-n // s)):
        raise ValueError("unpack_hq: staged must be a contiguous uint8 "
                         f"tensor of {-(-n // s)} CTAs on {payload.device}")
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


unpack_hq.launches = 0
