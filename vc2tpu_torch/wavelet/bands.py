"""The band (Mallat) route of the DWT, on the slices' lanes: the decode's
dequantise and inverse transform, and the encode's forward transform and
lane layout, each one launch a level of csrc/band_lift.cu.

Ports of the JAX package's band route:

* ``inverse_lanes``: ``scale_banded`` -> ``lanes_to_bands`` ->
  ``inverse_bands`` of a picture's three components (the decode tail of
  ``vc2tpu.pipeline.decoder._lanes_words_tail``; with ``ll``, the LD
  tail's host LL grids in place of band 0). Its levels run coarsest first;
  each reads its three detail bands from the lanes, dequantised as they
  load, and its LL from the lanes (coarsest level), the grids or the
  previous level's result.
* ``forward_lanes``: ``wavelet_pad`` -> ``forward_bands`` ->
  ``bands_to_lanes`` (``vc2tpu.pipeline.encoder.Encoder._analyse_impl``).
  Its levels run finest first; the first reads the uploaded samples,
  int16 or int32, and each stores its detail bands (and, the coarsest,
  LL) straight into the lanes.

CUDA tensors go through the kernels, launched on their card; CPU tensors
through the plain versions ``inverse_lanes_plain`` and
``forward_lanes_plain``, compositions of ``quant.quantiser``'s and
``wavelet.lifting``'s band functions. Any other device raises. A level's
tiles, halo and ladders are the in-place lift's (``lifting.tile_shape``,
``lifting.halo``, ``lift_ladders.h``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import WaveletKernel
from vc2tpu_torch.quant.quantiser import (QUANT_FACTORS_I32, QUANT_OFFSETS,
                                          scale_banded)
from vc2tpu_torch.slices import layout
from vc2tpu_torch.wavelet import lifting

MAX_PLANES = 3                # a picture's components (csrc/band_lift.cu)


def slice_dims(geo, comp: int) -> tuple:
    """(rows, columns) of a slice of component ``comp``."""
    return geo.luma_slice if comp == 0 else geo.chroma_slice


@functools.lru_cache(maxsize=None)
def band_sizes(slice_h: int, slice_w: int, depth: int) -> tuple:
    """Lanes of each band in a slice, in lane order (``layout.lane_order``)."""
    _, band = layout.lane_order(slice_h, slice_w, depth)
    return tuple(int(c) for c in np.bincount(band, minlength=3 * depth + 1))


# --- plain PyTorch versions --------------------------------------------------

def inverse_lanes_plain(lanes, q_idx: torch.Tensor, qmatrix, geo,
                        kernel: WaveletKernel, depth: int, ll=None) -> list:
    """Plain version of ``inverse_lanes``, on any device."""
    ys, xs = geo.y_slices, geo.x_slices
    out = []
    for comp, lanes_c in enumerate(lanes):
        sh, sw = slice_dims(geo, comp)
        scaled = scale_banded(lanes_c, q_idx, np.asarray(qmatrix, np.int64),
                              band_sizes(sh, sw, depth))
        bands = lifting.lanes_to_bands(
            scaled, ys, xs, lifting.band_dims(ys * sh, xs * sw, depth))
        if ll is not None:
            bands[0] = ll[comp]
        out.append(lifting.inverse_bands(bands, kernel, depth))
    return out


def forward_lanes_plain(planes, kernel: WaveletKernel, depth: int,
                        geo) -> list:
    """Plain version of ``forward_lanes``, on any device."""
    out = []
    for comp, p in enumerate(planes):
        sh, sw = slice_dims(geo, comp)
        x = lifting.wavelet_pad(p.to(torch.int32), depth)
        if tuple(x.shape) != (geo.y_slices * sh, geo.x_slices * sw):
            raise ValueError(f"forward_lanes: plane {tuple(p.shape)} does "
                             "not pad to the slice grid")
        out.append(lifting.bands_to_lanes(
            lifting.forward_bands(x, kernel, depth), geo.y_slices,
            geo.x_slices))
    return out


# --- the CUDA kernels --------------------------------------------------------

def params_header() -> str:
    """``band_lift_params.h`` for csrc/band_lift.cu: the int32-wrapped
    quant factors and offsets (``quantiser.QUANT_FACTORS_I32``,
    ``QUANT_OFFSETS``)."""
    factors = ", ".join(str(int(f)) for f in QUANT_FACTORS_I32)
    offsets = ", ".join(str(int(o)) for o in QUANT_OFFSETS)
    return ("// Generated by vc2tpu_torch.wavelet.bands.params_header().\n"
            "#pragma once\n"
            f"#define VC2_QUANT_FACTORS {factors}\n"
            f"#define VC2_QUANT_OFFSETS {offsets}\n")


def kernel_source() -> build.Source:
    return build.Source("band_lift",
                        (("lift_ladders.h", lifting.ladder_header()),
                         ("band_lift_params.h", params_header())))


class _BandPlane(ctypes.Structure):
    """Mirror of ``struct BandPlane`` in csrc/band_lift.cu."""

    _fields_ = [
        ("lanes", ctypes.c_void_p),
        ("ll", ctypes.c_void_p),
        ("dst", ctypes.c_void_p),
        ("src", ctypes.c_void_p),
        ("src_ld", ctypes.c_longlong),
        ("src_h", ctypes.c_int),
        ("src_w", ctypes.c_int),
        ("src_bytes", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("L", ctypes.c_int),
        ("xs", ctypes.c_int),
        ("bh", ctypes.c_int),
        ("bw", ctypes.c_int),
        ("off", ctypes.c_int * 4),
        ("qm", ctypes.c_int * 4),
        ("tiles_x", ctypes.c_int),
        ("tile0", ctypes.c_int),
    ]


class _BandTable(ctypes.Structure):
    """Mirror of ``struct BandTable`` in csrc/band_lift.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("th", ctypes.c_int),
        ("tw", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("p", _BandPlane * MAX_PLANES),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    for fn in (lib.band_inverse_launch, lib.band_forward_launch):
        fn.argtypes = [ctypes.POINTER(_BandTable), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(th: int, tw: int, hr: int) -> int:
    """Shared memory of one CTA: the region's four parity planes, then a
    band row's and a band column's lane and slice offsets."""
    rh, ldq = th + 2 * hr, tw // 2 + lifting.col_halo(hr)
    return lifting.smem_bytes(th, tw, hr) + 4 * (rh + 2 * ldq)


@functools.lru_cache(maxsize=64)
def _plan(geo, qmatrix: tuple, kernel: int, depth: int, sms: int) -> list:
    """The inverse levels of a picture geometry, coarsest first: for each,
    (table with its pointers 0, as bytes; the three components' (h, w)).
    The forward levels are the same, finest first. Raises ValueError where
    the kernel cannot take the geometry. Cached: a stream repeats it."""
    if depth < 1:
        raise ValueError("the band route lifts at depth 1 or more")
    kernel = WaveletKernel(kernel)
    hr = lifting.halo(kernel)
    comps = []
    for comp in range(MAX_PLANES):
        sh, sw = slice_dims(geo, comp)
        if sh % (1 << depth) or sw % (1 << depth):
            raise ValueError(f"the band route needs slices of whole "
                             f"2**{depth} blocks, got {sh} x {sw}")
        if geo.n_slices * sh * sw >= 1 << 31:
            raise ValueError("the band route indexes lanes in int32")
        sizes = band_sizes(sh, sw, depth)
        comps.append((sh, sw, sh * sw, np.cumsum((0,) + sizes)[:-1]))
    levels = []
    for level in range(1, depth + 1):
        s = 1 << (depth + 1 - level)     # the stride of this level's bands
        dims = [(2 * geo.y_slices * sh // s, 2 * geo.x_slices * sw // s)
                for sh, sw, _L, _off in comps]
        th, tw = lifting.tile_shape(dims, hr, lifting.CTAS_PER_SM * sms)
        if smem_bytes(th, tw, hr) > lifting.SMEM_LIMIT:
            raise ValueError(f"band route: {kernel.name} tiles exceed shared "
                             "memory")
        table = _BandTable(n=MAX_PLANES, th=th, tw=tw, halo=hr)
        tile0 = 0
        first = 1 + 3 * (level - 1)      # this level's HL band
        for i, ((sh, sw, L, off), (h, w)) in enumerate(zip(comps, dims)):
            tiles_x = -(-w // tw)
            bands = (0 if level == 1 else -1, first, first + 1, first + 2)
            table.p[i] = _BandPlane(
                h=h, w=w, L=L, xs=geo.x_slices, bh=sh // s, bw=sw // s,
                tiles_x=tiles_x, tile0=tile0)
            for k, b in enumerate(bands):
                if b >= 0:
                    table.p[i].off[k] = int(off[b])
                    table.p[i].qm[k] = int(qmatrix[b])
            tile0 += tiles_x * -(-h // th)
        table.n_tiles = tile0
        levels.append((bytes(table), dims))
    return levels


def _check_lanes(lanes, geo, dev) -> None:
    for comp, t in enumerate(lanes):
        sh, sw = slice_dims(geo, comp)
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous() or \
                tuple(t.shape) != (geo.n_slices, sh * sw):
            raise ValueError("band route: needs contiguous int32 lanes "
                             f"[{geo.n_slices}, {sh * sw}] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def inverse_lanes(lanes, q_idx: torch.Tensor, qmatrix, geo,
                  kernel: WaveletKernel, depth: int, ll=None) -> list:
    """Dequantise and inverse-transform a picture's lanes: ``lanes`` the
    (y, u, v) int32 [N, L] lanes of slice geometry ``geo``, ``q_idx`` the
    int32 [N] quant indices, ``qmatrix`` the quant matrix [3 depth + 1],
    ``ll`` (LD) three int32 LL grids of the padded planes' (h, w) >>
    depth that replace band 0. Returns the three padded int32 planes.

    CUDA lanes go through csrc/band_lift.cu, ``depth`` launches (one a
    level, the three components in each), without synchronising; CPU
    lanes through ``inverse_lanes_plain``."""
    dev = lanes[0].device
    if dev.type == "cpu":
        return inverse_lanes_plain(lanes, q_idx, qmatrix, geo, kernel, depth,
                                   ll)
    if dev.type != "cuda":
        raise ValueError(f"inverse_lanes: unsupported device {dev}")
    _check_lanes(lanes, geo, dev)
    if q_idx.device != dev or q_idx.dtype != torch.int32 or \
            not q_idx.is_contiguous() or q_idx.numel() != geo.n_slices:
        raise ValueError("inverse_lanes: needs contiguous int32 q indices "
                         f"[{geo.n_slices}] on {dev}")
    qm = tuple(int(v) for v in qmatrix)
    levels = _plan(geo, qm, int(kernel), depth, lifting._sm_count(dev.index))
    coarse = ll
    if ll is not None:
        for g, (h, w) in zip(ll, levels[0][1]):
            if g.device != dev or g.dtype != torch.int32 or \
                    not g.is_contiguous() or tuple(g.shape) != (h // 2,
                                                               w // 2):
                raise ValueError("inverse_lanes: the LL grids must be "
                                 "contiguous int32 planes of the padded "
                                 "planes >> depth")
    for template, dims in levels:
        table = _BandTable.from_buffer_copy(template)
        table.q = q_idx.data_ptr()
        outs = []
        for i, (h, w) in enumerate(dims):
            out = torch.empty((h, w), dtype=torch.int32, device=dev)
            entry = table.p[i]
            entry.lanes, entry.dst = lanes[i].data_ptr(), out.data_ptr()
            if coarse is not None:
                entry.ll = coarse[i].data_ptr()
            outs.append(out)
        with devices.guard(lanes[0]):
            rc = _lib().band_inverse_launch(ctypes.byref(table), int(kernel),
                                            _stream(dev))
        if rc:
            raise RuntimeError(f"band_inverse kernel launch failed: CUDA "
                               f"error {rc}")
        inverse_lanes.launches += 1
        coarse = outs
    return coarse


inverse_lanes.launches = 0


def forward_lanes(planes, kernel: WaveletKernel, depth: int, geo) -> list:
    """Forward-transform a picture's three planes into their lanes:
    ``planes`` the (y, u, v) samples as uploaded (2-D, int16 or int32, rows
    contiguous), padded by edge replication to the slice grid of ``geo``.
    Returns the (y, u, v) int32 [N, L] lanes in serialisation order.

    CUDA planes go through csrc/band_lift.cu, ``depth`` launches (one a
    level, the three components in each), without synchronising; CPU
    planes through ``forward_lanes_plain``."""
    dev = planes[0].device
    if dev.type == "cpu":
        return forward_lanes_plain(planes, kernel, depth, geo)
    if dev.type != "cuda":
        raise ValueError(f"forward_lanes: unsupported device {dev}")
    levels = _plan(geo, (0,) * (3 * depth + 1), int(kernel), depth,
                   lifting._sm_count(dev.index))
    for comp, p in enumerate(planes):
        (h, w) = levels[-1][1][comp]
        if p.device != dev or p.dtype not in (torch.int16, torch.int32) or \
                p.dim() != 2 or p.stride(1) != 1 or \
                lifting.padded_size(p.shape[0], depth) != h or \
                lifting.padded_size(p.shape[1], depth) != w:
            raise ValueError("forward_lanes: needs 2-D int16 or int32 planes "
                             f"with contiguous rows on {dev} that pad to "
                             f"{h} x {w}, got {p.dtype} {tuple(p.shape)}")
    lanes = [torch.empty((geo.n_slices, sh * sw), dtype=torch.int32,
                         device=dev)
             for sh, sw in (slice_dims(geo, c) for c in range(MAX_PLANES))]
    src = list(planes)
    for level, (template, dims) in enumerate(reversed(levels)):
        table = _BandTable.from_buffer_copy(template)
        outs = []
        for i, (h, w) in enumerate(dims):
            entry = table.p[i]
            entry.lanes = lanes[i].data_ptr()
            x = src[i]
            entry.src, entry.src_ld = x.data_ptr(), x.stride(0)
            entry.src_h, entry.src_w = x.shape
            entry.src_bytes = x.element_size()
            if level + 1 < depth:
                out = torch.empty((h // 2, w // 2), dtype=torch.int32,
                                  device=dev)
                entry.dst = out.data_ptr()
                outs.append(out)
        with devices.guard(lanes[0]):
            rc = _lib().band_forward_launch(ctypes.byref(table), int(kernel),
                                            _stream(dev))
        if rc:
            raise RuntimeError(f"band_forward kernel launch failed: CUDA "
                               f"error {rc}")
        forward_lanes.launches += 1
        src = outs
    return lanes


forward_lanes.launches = 0
