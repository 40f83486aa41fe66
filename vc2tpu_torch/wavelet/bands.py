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
halo and ladders are the in-place lift's (``lifting.halo``,
``lift_ladders.h``).

The kernels move a slice's lanes in runs: a level's bands are the lanes
[run0, run0 + R) of every slice (``level_run``), and the run map
(``run_map``, on the card once a geometry: ``_map_tensors``) gives each
lane of the run its band, row and column in the slice's sub-block.
``tile_shape`` keeps tiles whole slices where it can; ``_plan`` packs a
level's tiles, runs and shared memory into the kernel's table.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
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
        ("map", ctypes.c_void_p),
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
        ("run0", ctypes.c_int),
        ("R", ctypes.c_int),
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
        ("rw", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("max_slices", ctypes.c_int),
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


# --- the plan: runs, run maps, tiles ------------------------------------------

MAP_FIELD = 0x7fff              # a run map entry's row and column fields
MAP_PAD = MAP_FIELD << 15       # padding: a row that no region reaches
PITCH_PAD = 8                   # words a parity plane row has beyond ...
PLANE_PAD = 8                   # ... the region, before and between planes


def level_block(sh: int, sw: int, depth: int, level: int) -> tuple:
    """(bh, bw): a slice's sub-block of each band of ``level`` (1 the
    coarsest) for slices of ``sh`` x ``sw``."""
    s = 1 << (depth + 1 - level)
    return sh // s, sw // s


def level_run(sh: int, sw: int, depth: int, level: int,
              with_ll: bool) -> tuple:
    """(run0, R, kb): the lanes [run0, run0 + R) of every slice that hold
    ``level``'s bands, in lane order (``layout.lane_order``): HL, LH, HH,
    with LL first where ``with_ll`` (the coarsest level only). ``kb`` is
    the parity plane of the run's first band: 0 (LL) or 1 (HL)."""
    bh, bw = level_block(sh, sw, depth, level)
    if with_ll:
        if level != 1:
            raise ValueError("only the coarsest level's run holds LL")
        return 0, 4 * bh * bw, 0
    first = 1 + 3 * (level - 1)          # this level's HL band
    return sum(band_sizes(sh, sw, depth)[:first]), 3 * bh * bw, 1


def run_map(bh: int, bw: int, kb: int, n: int) -> np.ndarray:
    """The run map of a run of ``n`` lanes whose first band is parity plane
    ``kb`` (each band a row-major ``bh`` x ``bw`` sub-block): lane l's
    (plane << 30 | row << 15 | column) as uint32, padded to whole quads of
    4 with ``MAP_PAD``."""
    lane = np.arange(n, dtype=np.int64)
    band, at = np.divmod(lane, bh * bw)
    row, col = np.divmod(at, bw)
    entries = ((kb + band) << 30) | (row << 15) | col
    return np.concatenate([entries, np.full(-n % 4, MAP_PAD)]).astype(
        np.uint32)


def tile_shape(dims, blocks, hr: int, min_ctas: int) -> tuple:
    """(th, tw, rw): the output tile of a level over planes of (h, w)
    ``dims`` whose bands' slice sub-blocks are ``blocks`` (bh, bw), and the
    width of its region in shared memory. ``lifting.tile_shape``'s choice
    over ``lifting.REGIONS``, each side of a region's tile first cut to
    whole slices of every component (2 bh rows, 2 bw columns; columns also
    a multiple of 8); a side that would lose more than half stays whole,
    and the edge slices' lanes are masked."""
    hc = lifting.col_halo(hr)
    rstep = math.lcm(*(2 * bh for bh, _ in blocks))
    cstep = math.lcm(8, *(2 * bw for _, bw in blocks))
    options = []
    for rh, rw in lifting.REGIONS:
        if 4 * hr > rh or 4 * hc > rw:
            continue
        th, tw = rh - 2 * hr, rw - 2 * hc
        ath, atw = th - th % rstep, tw - tw % cstep
        options.append((ath if 2 * ath >= th else th,
                        atw if 2 * atw >= tw else tw, rw))
    for th, tw, rw in options:
        if sum(-(-h // th) * -(-w // tw) for h, w in dims) >= min_ctas:
            return th, tw, rw
    return options[-1]


def window_slices(n: int, b: int) -> int:
    """The most slices of ``b`` band samples that ``n`` consecutive band
    samples touch."""
    return (n + 2 * b - 2) // b


def smem_bytes(th: int, rw: int, hr: int, max_slices: int) -> int:
    """Shared memory of one inverse CTA (the forward's is less): the
    region's four parity planes (rows ``PITCH_PAD`` words longer than the
    region, ``PLANE_PAD`` words before and between them), the 120-entry
    quant factor and offset tables, the q index of every slice of the
    region, and a word a band row and column of the region (its window
    slice)."""
    rows, ldq = (th + 2 * hr) // 2, rw // 2
    return (16 * (rows * (ldq + PITCH_PAD) + PLANE_PAD) + 4 * PLANE_PAD
            + 8 * len(QUANT_OFFSETS) + 4 * (max_slices + rows + ldq))


@functools.lru_cache(maxsize=64)
def _plan(geo, qmatrix: tuple, kernel: int, depth: int, sms: int,
          ll_in_run: bool) -> list:
    """The inverse levels of a picture geometry, coarsest first: for each,
    (table with its pointers 0, as bytes; the three components' (h, w)).
    The forward levels are the same, finest first. ``ll_in_run``: the
    coarsest level's run holds LL (not so where the LD grids replace it).
    Raises ValueError where the kernel cannot take the geometry. Cached:
    a stream repeats it."""
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
        if max(sh, sw) >= MAP_FIELD:
            raise ValueError("the band route's run map takes slices of "
                             f"fewer than {MAP_FIELD} rows and columns")
        comps.append((sh, sw))
    levels = []
    for level in range(1, depth + 1):
        s = 1 << (depth + 1 - level)     # the stride of this level's bands
        dims = [(2 * geo.y_slices * sh // s, 2 * geo.x_slices * sw // s)
                for sh, sw in comps]
        blocks = [level_block(sh, sw, depth, level) for sh, sw in comps]
        th, tw, rw = tile_shape(dims, blocks, hr, lifting.CTAS_PER_SM * sms)
        max_slices = max(window_slices(th // 2 + hr, bh)
                         * window_slices(rw // 2, bw) for bh, bw in blocks)
        if smem_bytes(th, rw, hr, max_slices) > lifting.SMEM_LIMIT:
            raise ValueError(f"band route: {kernel.name} tiles exceed shared "
                             "memory")
        table = _BandTable(n=MAX_PLANES, th=th, tw=tw, rw=rw, halo=hr,
                           max_slices=max_slices)
        tile0 = 0
        first = 1 + 3 * (level - 1)      # this level's HL band
        for i, ((sh, sw), (h, w), (bh, bw)) in enumerate(zip(comps, dims,
                                                              blocks)):
            tiles_x = -(-w // tw)
            run0, n, _kb = level_run(sh, sw, depth, level,
                                     ll_in_run and level == 1)
            table.p[i] = _BandPlane(
                h=h, w=w, L=sh * sw, xs=geo.x_slices, bh=bh, bw=bw,
                run0=run0, R=n, tiles_x=tiles_x, tile0=tile0)
            for k, b in enumerate((0, first, first + 1, first + 2)):
                table.p[i].qm[k] = int(qmatrix[b])
            tile0 += tiles_x * -(-h // th)
        table.n_tiles = tile0
        levels.append((bytes(table), dims))
    return levels


def run_maps(geo, depth: int, ll_in_run: bool) -> list:
    """The run maps of a picture geometry's levels, coarsest first: for
    each, the three components' ``run_map``."""
    out = []
    for level in range(1, depth + 1):
        maps = []
        for comp in range(MAX_PLANES):
            sh, sw = slice_dims(geo, comp)
            bh, bw = level_block(sh, sw, depth, level)
            _run0, n, kb = level_run(sh, sw, depth, level,
                                     ll_in_run and level == 1)
            maps.append(run_map(bh, bw, kb, n))
        out.append(maps)
    return out


@capture.device_cache(maxsize=64)
def _map_tensors(geo, depth: int, ll_in_run: bool,
                 dev: torch.device) -> tuple:
    """``run_maps`` on ``dev``, each an int32 tensor (the kernel reads it
    as uint32). Uploaded once a geometry and card."""
    return tuple(tuple(torch.from_numpy(m.view(np.int32)).to(dev)
                       for m in maps)
                 for maps in run_maps(geo, depth, ll_in_run))


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


@capture.counted
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
    levels = _plan(geo, qm, int(kernel), depth, lifting._sm_count(dev.index),
                   ll is None)
    maps = _map_tensors(geo, depth, ll is None, dev)
    coarse = ll
    if ll is not None:
        for g, (h, w) in zip(ll, levels[0][1]):
            if g.device != dev or g.dtype != torch.int32 or \
                    not g.is_contiguous() or tuple(g.shape) != (h // 2,
                                                               w // 2):
                raise ValueError("inverse_lanes: the LL grids must be "
                                 "contiguous int32 planes of the padded "
                                 "planes >> depth")
    for (template, dims), level_maps in zip(levels, maps):
        table = _BandTable.from_buffer_copy(template)
        table.q = q_idx.data_ptr()
        outs = []
        for i, (h, w) in enumerate(dims):
            out = torch.empty((h, w), dtype=torch.int32, device=dev)
            entry = table.p[i]
            entry.lanes, entry.dst = lanes[i].data_ptr(), out.data_ptr()
            entry.map = level_maps[i].data_ptr()
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


@capture.counted
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
                   lifting._sm_count(dev.index), True)
    maps = _map_tensors(geo, depth, True, dev)
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
    for level, ((template, dims), level_maps) in enumerate(
            zip(reversed(levels), reversed(maps))):
        table = _BandTable.from_buffer_copy(template)
        outs = []
        for i, (h, w) in enumerate(dims):
            entry = table.p[i]
            entry.lanes = lanes[i].data_ptr()
            entry.map = level_maps[i].data_ptr()
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
