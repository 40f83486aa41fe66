"""Interleaved signed exp-Golomb codes (reference VLC.cpp:21-94), on
tensors: a frozen copy of the port's ``vlc/golomb.py``."""

from __future__ import annotations

import torch


def signed_codes(values: torch.Tensor):
    """Signed interleaved exp-Golomb code of each int32 element: (code,
    nbits), both int64; the code is the low ``nbits`` bits, MSB first on
    the wire. Code bit string: [0 u_{k-2} 0 u_{k-3} .. 0 u_0 1 s] where
    u = |v|+1 (k bits) and s the sign; zero codes as the single bit 1."""
    v = values.to(torch.int64)
    u = v.abs() + 1
    k = torch.zeros_like(u)                    # bit length of u, 1..32
    for j in range(33):
        k += (u >= (1 << j)).to(torch.int64)
    m = u - (1 << (k - 1))                     # u below its top bit
    spread = torch.zeros_like(u)
    for j in range(31):
        spread |= ((m >> j) & 1) << (2 * j)
    code = (((spread << 1) | 1) << 1) | (v < 0).to(torch.int64)
    return torch.where(v == 0, 1, code), torch.where(v == 0, 1, 2 * k)


def _code_bits(v: torch.Tensor) -> torch.Tensor:
    """Bits of the signed exp-Golomb code of each value (int64)."""
    mag = v.to(torch.int64).abs()
    _, e = torch.frexp((mag + 1).to(torch.float64))
    return torch.where(mag == 0, 1, 2 * e.to(torch.int64))


def truncated_bits(codes: torch.Tensor) -> torch.Tensor:
    """Each row's code bits up to its last non-zero code (0 for none),
    int64 [K], for the quantised values ``codes`` [K, L] in wire order."""
    nb = _code_bits(codes)
    length = codes.shape[1]
    idx = torch.arange(length, device=codes.device)
    last = torch.where(codes != 0, idx, -1).amax(1)
    return torch.where(last >= 0, nb.sum(1) - (length - 1 - last), 0)


def interleave(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u0 v0 u1 v1 ... of two [K, L] tensors: [K, 2L]."""
    return torch.stack([u, v], 2).reshape(u.shape[0], -1)
