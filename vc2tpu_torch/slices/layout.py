"""Slice-grid layout: static lane permutations and HQ CBR byte budgets.

The reference walks each slice's subbands with nested scalar loops
(split_into_subbands, reference src/Library/src/WaveletTransform.cpp:
428-476, and the per-slice serialisation loops in src/Slices.cpp). Here the
same traversal is a *static permutation* computed once per geometry:

* a picture plane in in-place transform layout reshapes to
  (ySlices, sliceH, xSlices, sliceW) -> (nSlices, sliceH*sliceW);
* ``lane_order`` maps serialisation position -> flat offset inside the
  slice block (subbands in order LL, then HL/LH/HH per level, raster within
  each subband).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vc2tpu_torch.core import capture
from vc2tpu_torch.core.intmath import rationalise


@functools.lru_cache(maxsize=None)
def lane_order(slice_h: int, slice_w: int, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm, band) — perm[k] is the flat row-major offset within the slice
    block of the k-th serialised coefficient; band[k] is its subband index
    (0 = LL, then HL,LH,HH per level low->high frequency)."""
    order = []
    bands = []
    s = 1 << depth
    yy, xx = np.mgrid[0:slice_h:s, 0:slice_w:s]
    order.append((yy * slice_w + xx).ravel())
    bands.append(np.zeros(order[-1].size, dtype=np.int32))
    band = 1
    for level in range(1, depth + 1):
        stride = 1 << (depth + 1 - level)
        off = stride // 2
        for (oy, ox) in ((0, off), (off, 0), (off, off)):  # HL, LH, HH
            yy, xx = np.mgrid[oy:slice_h:stride, ox:slice_w:stride]
            order.append((yy * slice_w + xx).ravel())
            bands.append(np.full(order[-1].size, band, dtype=np.int32))
            band += 1
    perm = np.concatenate(order).astype(np.int32)
    band_of_lane = np.concatenate(bands).astype(np.int32)
    assert perm.size == slice_h * slice_w
    return perm, band_of_lane


@functools.lru_cache(maxsize=None)
def inverse_lane_order(slice_h: int, slice_w: int, depth: int) -> np.ndarray:
    perm, _ = lane_order(slice_h, slice_w, depth)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


@capture.device_cache(maxsize=None)
def _inverse_index(slice_h: int, slice_w: int, depth: int,
                   device: torch.device) -> torch.Tensor:
    inv = inverse_lane_order(slice_h, slice_w, depth)
    return torch.as_tensor(inv.astype(np.int64), device=device)


@capture.device_cache(maxsize=16)
def _lane_index(h: int, w: int, y_slices: int, x_slices: int, depth: int,
                device: torch.device) -> torch.Tensor:
    """Flat plane offset of every lane, int64 (nSlices * L): slice (r, c)'s
    lane k sits at row r*sh + perm[k] // sw, column c*sw + perm[k] % sw."""
    sh, sw = h // y_slices, w // x_slices
    perm, _ = lane_order(sh, sw, depth)
    r = np.arange(y_slices, dtype=np.int64)[:, None, None]
    c = np.arange(x_slices, dtype=np.int64)[None, :, None]
    p = perm.astype(np.int64)[None, None, :]
    idx = (r * sh + p // sw) * w + c * sw + p % sw
    return torch.as_tensor(idx.reshape(-1), device=device)


def plane_to_lanes(plane: torch.Tensor, y_slices: int, x_slices: int,
                   depth: int) -> torch.Tensor:
    """Plane in transform layout -> (nSlices, L) lanes in serialisation
    order: one gather of the flat plane by a cached index (the JAX
    package's slice-block reshape and ``lane_order`` permutation in one)."""
    h, w = plane.shape
    idx = _lane_index(h, w, y_slices, x_slices, depth, plane.device)
    lanes = plane.reshape(-1).index_select(0, idx)
    return lanes.reshape(y_slices * x_slices, -1)


@functools.lru_cache(maxsize=64)
def slice_bytes_map(y_slices: int, x_slices: int, total_bytes: int,
                    scalar: int) -> np.ndarray:
    """HQ CBR per-slice byte budget by rational residue spread (reference
    src/Library/src/Slices.cpp:28-49), int32 [ySlices, xSlices], read
    only. The reference's residue walk (+= remainder, -= den when it
    spills) is the identity bump_k = floor((k+1)r/den) - floor(kr/den)."""
    n = y_slices * x_slices
    num, den = rationalise(total_bytes // scalar - 4 * n, n)
    ratio = num // den
    remainder = num - ratio * den
    k = np.arange(n, dtype=np.int64)
    bump = ((k + 1) * remainder) // den - (k * remainder) // den
    out = ((ratio + bump) * scalar + 4).astype(np.int32)
    out = out.reshape(y_slices, x_slices)
    out.setflags(write=False)
    return out


def lanes_to_plane(lanes: torch.Tensor, y_slices: int, x_slices: int,
                   slice_h: int, slice_w: int, depth: int) -> torch.Tensor:
    """(nSlices, L) lanes -> contiguous plane in transform layout: one
    gather by ``inverse_lane_order``, then a reshape/permute."""
    inv = _inverse_index(slice_h, slice_w, depth, lanes.device)
    blocks = lanes.index_select(1, inv)
    x = blocks.reshape(y_slices, x_slices, slice_h, slice_w)
    return x.permute(0, 2, 1, 3).reshape(y_slices * slice_h,
                                         x_slices * slice_w)
