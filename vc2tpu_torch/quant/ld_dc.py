"""The LD LL band's inverse quantise with DC prediction, from the unpack's
lanes: the three dequantised LL grids of a picture.

An LD slice codes its LL band as residuals of a DC prediction (reference
Quantisation.cpp:287-306): each LL value is its code inverse quantised
(``c_scale`` at ``max(q - qm, 0)``) plus the truncating mean of its left,
above and above-left values, a raster recurrence over the whole grid. A
slice's LL codes are the first lanes of its luma and U/V regions, which
``device_unpack.unpack_ld`` decodes with the rest, so ``ll_grids`` takes
them from there: on the card ``csrc/ld_dc.cu`` (the terms a thread a
cell, the recurrence, one CTA a grid, a wavefront over the
anti-diagonals, then the grids out of its diagonal-ordered scratch), on
the CPU the host
recurrence (``slices.ld.dequantise_ll``, native) over the codes gathered
from the lanes, which is also the reference the card tests hold the
kernel to. Either way the grids are bit for bit those of
``slices.ld.ld_scan``. Every LD picture decode takes its grids from here:
on one device, the taps, and both mesh routes (each band of the mesh
whose slice rows divide takes its rows of them).

``Plan`` holds what the grids need of a geometry: the lane of each cell's
code (``slices.ld.ll_sources``), the quant matrix block, and for the
kernel, tables of each grid row's and column's slice and quant-matrix
offsets, on the device once (``plan``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.quant.quantiser import QUANT_FACTORS_I32, QUANT_OFFSETS
from vc2tpu_torch.slices import ld as slices_ld

# The recurrence's CTAs: a thread a grid row, in bands of at most this
# many rows.
MAX_THREADS = 1024


class _Grid(ctypes.Structure):
    """``Grid`` of csrc/ld_dc.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lanes", "src", "row_q", "row_m", "col_q", "col_m", "qm", "skew",
        "out")] + [("llh", ctypes.c_int), ("llw", ctypes.c_int)]


class _Component:
    """One component's LL grid: shape, slice block, quant matrix block and
    the lane of each cell's code; ``tables`` the kernel's int32 constants,
    src, row_q, row_m, col_q, col_m, qm in a row."""

    def __init__(self, src: np.ndarray, slice_hw: tuple, ys: int, xs: int,
                 ts: int, qm: np.ndarray):
        self.src = src
        self.llh, self.llw = src.shape
        self.sh, self.sw = slice_hw
        self.qm = qm
        y = np.arange(self.llh, dtype=np.int64)
        x = np.arange(self.llw, dtype=np.int64)
        # csrc/ld_scan.cpp's dequantise_grid, split by row and by column
        row_q = ((y + 1) * ys - 1) // max(self.llh, 1) * xs
        row_m = (y * ts) % self.sh * self.sw
        col_q = ((x + 1) * xs - 1) // max(self.llw, 1)
        col_m = (x * ts) % self.sw
        self.tables = [src.ravel(), row_q, row_m, col_q, col_m, qm]


class Plan:
    """What ``ll_grids`` needs of a picture geometry (``geo``, transform
    ``depth``, quant matrix) on ``device``."""

    def __init__(self, geo, depth: int, qmatrix, device: torch.device):
        ys, xs, ts = geo.y_slices, geo.x_slices, 1 << depth
        self.geo, self.ts, self.device = geo, ts, device
        src_y, src_c = slices_ld.ll_sources(geo, depth)
        self.luma, self.chroma = (
            _Component(src, hw, ys, xs, ts,
                       slices_ld.qm_block(*hw, depth, qmatrix))
            for src, hw in ((src_y, geo.luma_slice),
                            (src_c, geo.chroma_slice)))
        self.consts = None
        if device.type == "cuda":
            parts = [*self.luma.tables, *self.chroma.tables,
                     QUANT_FACTORS_I32, QUANT_OFFSETS]
            flat = np.concatenate([np.asarray(a, np.int64) for a in parts])
            self.consts = torch.from_numpy(flat.astype(np.int32)).to(device)
            ptrs = [v.data_ptr()
                    for v in self.consts.split([len(a) for a in parts])]
            comps = (self.luma, self.chroma, self.chroma)
            # each grid's tables' addresses (luma, U, V), the quant
            # factors' and offsets', the recurrence's CTA size, and the
            # words a picture's grids and the kernel's scratch take
            self.table_ptrs = [ptrs[:6], ptrs[6:12], ptrs[6:12]]
            self.qf_qo = ptrs[12:14]
            self.threads = threads_of(max(c.llh for c in comps))
            self.words = ([c.llh * c.llw for c in comps]
                          + [_lib().ld_dc_skew_words(c.llh, c.llw)
                             for c in comps])


@capture.device_cache(maxsize=16)
def plan(geo, depth: int, qmatrix_key: tuple, device: torch.device) -> Plan:
    """The ``Plan`` of a geometry on a device, made once (``qmatrix_key``:
    the quant matrix as a tuple of ints)."""
    return Plan(geo, depth, np.asarray(qmatrix_key, np.int64), device)


def kernel_source() -> build.Source:
    return build.Source("ld_dc")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    p = ctypes.c_void_p
    lib.ld_dc_launch.argtypes = [p, p, p, p, ctypes.c_int, p]
    lib.ld_dc_launch.restype = ctypes.c_int
    lib.ld_dc_skew_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ld_dc_skew_words.restype = ctypes.c_longlong
    return lib


def threads_of(llh: int) -> int:
    """The recurrence's CTA size for grids of ``llh`` rows at most."""
    return min(MAX_THREADS, max(32, -(-llh // 32) * 32))


@capture.counted
def ll_grids(lanes, q: torch.Tensor, plan_: Plan) -> list:
    """The three dequantised LL grids (luma, U, V; int32 [llh, llw] on the
    lanes' device) of a picture from its unpacked lanes (qy [N, ly], qu and
    qv [N, lc], ``device_unpack.unpack_ld``) and q indices (int32 [N]). On
    the card csrc/ld_dc.cu's three kernels (``launches`` counts the calls),
    not synchronised; on the CPU ``slices.ld.dequantise_ll`` a grid."""
    comps = (plan_.luma, plan_.chroma, plan_.chroma)
    if q.device.type == "cpu":
        return _ll_grids_host(lanes, q, plan_)
    n = plan_.geo.n_slices
    if q.dtype != torch.int32 or q.shape != (n,) or not q.is_contiguous():
        raise ValueError(f"ll_grids: q must be contiguous int32 [{n}], got "
                         f"{q.dtype} {tuple(q.shape)}")
    for t, c in zip(lanes, comps):
        if (t.dtype != torch.int32 or t.shape != (n, c.sh * c.sw)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"ll_grids: lanes must be contiguous int32 [{n}, "
                f"{c.sh * c.sw}] on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if plan_.device != q.device:
        raise ValueError(f"ll_grids: the plan is for {plan_.device}, the "
                         f"lanes are on {q.device}")
    # the grids and the kernel's scratch in one allocation
    *out, skew_y, skew_u, skew_v = torch.empty(
        sum(plan_.words), dtype=torch.int32, device=q.device).split(
            plan_.words)
    out = [o.view(c.llh, c.llw) for o, c in zip(out, comps)]
    if n == 0:
        return out
    grids = (_Grid * 3)(*(
        _Grid(t.data_ptr(), *ptrs, w.data_ptr(), o.data_ptr(), c.llh, c.llw)
        for t, ptrs, w, o, c in zip(lanes, plan_.table_ptrs,
                                    (skew_y, skew_u, skew_v), out, comps)))
    with devices.guard(q):
        rc = _lib().ld_dc_launch(
            ctypes.byref(grids), q.data_ptr(), *plan_.qf_qo, plan_.threads,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"ld_dc kernel launch failed: CUDA error {rc}")
    ll_grids.launches += 1
    return out


def _ll_grids_host(lanes, q: torch.Tensor, plan_: Plan) -> list:
    """``ll_grids`` on the CPU: each grid's codes gathered from the lanes,
    then the native host recurrence."""
    qs = q.numpy()
    ys, xs = plan_.geo.y_slices, plan_.geo.x_slices
    out = []
    for t, c in zip(lanes, (plan_.luma, plan_.chroma, plan_.chroma)):
        flat = t.contiguous().numpy().ravel()
        codes = (np.where(c.src >= 0, flat[np.maximum(c.src, 0)], 0)
                 if flat.size else np.zeros(c.src.shape, np.int32))
        out.append(torch.from_numpy(slices_ld.dequantise_ll(
            codes, ys, xs, plan_.ts, c.sh, c.sw, c.qm, qs)))
    return out
