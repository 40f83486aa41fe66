"""The band (Mallat) route of the port against vc2tpu's, on the CPU: every
Mallat-form function of ``wavelet.lifting`` and the banded quantiser
against their JAX twins (integer ==), and the plain versions of the two
band kernels (``bands.inverse_lanes_plain``, ``bands.forward_lanes_plain``)
against the JAX package's decode and encode compositions and against the
port's in-place route. The kernels themselves are held against the plain
versions by tests/test_torch_cuda.py (on the card)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vc2tpu.core.config import ColourFormat as JCF, WaveletKernel as JK
from vc2tpu.core.picture import Picture as JPicture
from vc2tpu.quant import quantiser as jq
from vc2tpu.wavelet import lifting as jl

from vc2tpu_torch.core.config import (ColourFormat, PictureGeometry,
                                      WaveletKernel as TK)
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline import decoder as pipe
from vc2tpu_torch.pipeline import encoder as enc
from vc2tpu_torch.quant import quantiser as tq
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.wavelet import bands, lifting as tl, matrices

KERNELS = [k for k in JK if k != JK.NullKernel]
IDS = [k.name for k in KERNELS]


def _eq(got, want) -> bool:
    return np.array_equal(np.asarray(got), np.asarray(want))


def _rand(rng, shape, lim):
    return rng.integers(-lim, lim + 1, shape).astype(np.int32)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_mallat_functions_match_vc2tpu(kernel):
    """forward_bands, inverse_bands, band_dims, bands_to_inplace,
    inplace_to_bands, bands_to_lanes, lanes_to_bands and
    coefficient_bound at depths 1-3 on a 32 x 64 plane (2 x 4 slices),
    with both round trips."""
    tk = TK(int(kernel))
    rng = np.random.default_rng(int(kernel))
    for depth in (1, 2, 3):
        x = _rand(rng, (32, 64), 1 << 12)
        want = jl.forward_bands(jnp.asarray(x), kernel, depth)
        got = tl.forward_bands(torch.from_numpy(x), tk, depth)
        assert len(got) == 3 * depth + 1
        assert all(_eq(g, w) for g, w in zip(got, want)), depth
        assert tl.band_dims(32, 64, depth) == jl.band_dims(32, 64, depth)
        assert [tuple(b.shape) for b in got] == tl.band_dims(32, 64, depth)
        # the inverse of seeded bands (no forward structure to lean on)
        rand_bands = [_rand(rng, b.shape, 1 << 14) for b in want]
        assert _eq(tl.inverse_bands([torch.from_numpy(b) for b in rand_bands],
                                    tk, depth),
                   jl.inverse_bands([jnp.asarray(b) for b in rand_bands],
                                    kernel, depth))
        assert _eq(tl.inverse_bands(got, tk, depth), x)
        inplace = tl.bands_to_inplace(got, depth)
        assert _eq(inplace, jl.bands_to_inplace(want, depth))
        assert _eq(inplace, tl.forward_plane(torch.from_numpy(x), tk, depth))
        back = tl.inplace_to_bands(inplace, depth)
        assert all(_eq(b, w) for b, w in zip(back, want))
        assert all(_eq(b, w) for b, w in zip(
            back, jl.inplace_to_bands(jnp.asarray(np.asarray(inplace)),
                                      depth)))
        lanes = tl.bands_to_lanes(got, 2, 4)
        assert _eq(lanes, jl.bands_to_lanes(want, 2, 4))
        dims = tl.band_dims(32, 64, depth)
        assert all(_eq(b, w) for b, w in zip(tl.lanes_to_bands(lanes, 2, 4,
                                                               dims), want))
        assert all(_eq(b, w) for b, w in zip(
            tl.lanes_to_bands(lanes, 2, 4, dims),
            jl.lanes_to_bands(jnp.asarray(lanes.numpy()), 2, 4, dims)))
        for input_max in (511, 1 << 15):
            assert tl.coefficient_bound(tk, depth, input_max) == \
                jl.coefficient_bound(kernel, depth, input_max)


def test_pictures_match_vc2tpu():
    """forward_picture and inverse_picture of a 4:2:2 picture whose planes
    pad (LeGall depth 1)."""
    rng = np.random.default_rng(3)
    planes = [_rand(rng, s, 511) for s in ((15, 30), (15, 15), (15, 15))]
    geom = PictureGeometry.of(15, 30, ColourFormat.CF422)
    want = jl.forward_picture(JPicture(*map(jnp.asarray, planes), JCF.CF422),
                              JK.LeGall, 1)
    got = tl.forward_picture(Picture(*map(torch.from_numpy, planes),
                                     ColourFormat.CF422), TK.LeGall, 1)
    for g, w in zip((got.y, got.c1, got.c2), (want.y, want.c1, want.c2)):
        assert _eq(g, w)
    back = tl.inverse_picture(got, TK.LeGall, 1, geom)
    want_back = jl.inverse_picture(want, JK.LeGall, 1, geom)
    for g, w, p in zip((back.y, back.c1, back.c2),
                       (want_back.y, want_back.c1, want_back.c2), planes):
        assert _eq(g, w) and _eq(g, p)


def _banded_case(seed, lim):
    """Lanes of 24 slices of 4:2:2 LeGall depth 2 luma (8 x 8: bands of
    4, 4, 4, 4, 16, 16, 16), q 0-119 over the slices with 116-119 among
    them, and a quant matrix with zeros, so adjusted indices reach the
    wrapped factors at 116-119."""
    rng = np.random.default_rng(seed)
    sizes = bands.band_sizes(8, 8, 2)
    values = _rand(rng, (24, sum(sizes)), lim)
    values[0, :4] = [-lim - 1 if lim == (1 << 31) - 1 else -lim, lim, 0, -1]
    q = rng.integers(0, 120, 24).astype(np.int32)
    q[:4] = [116, 117, 118, 119]
    qm = np.array([0, 2, 0, 4, 1, 0, 3], np.int32)
    return values, q, qm, sizes


def test_scale_banded_matches_vc2tpu():
    """scale_banded over int32 lanes (INT_MIN and INT_MAX among them) at
    q 0-119, and its tables, against the JAX package's gather form."""
    values, q, qm, sizes = _banded_case(11, (1 << 31) - 1)
    want = jq.scale_banded(jnp.asarray(values), jnp.asarray(q),
                           jnp.asarray(qm), sizes)
    got = tq.scale_banded(torch.from_numpy(values), torch.from_numpy(q), qm,
                          sizes)
    assert got.dtype == torch.int32 and _eq(got, want)
    aq = tq.banded_aq(torch.from_numpy(q), qm)
    assert _eq(aq, jq.banded_aq(jnp.asarray(q), jnp.asarray(qm)))
    assert int(aq.max()) == 119 and int(aq.min()) == 0
    qf, qo = tq.scale_tables(torch.from_numpy(q), qm)
    wqf, wqo = jq.scale_tables(jnp.asarray(q), jnp.asarray(qm))
    assert _eq(qf, wqf) and _eq(qo, wqo)
    assert bool((qf < 0).any())              # the wrapped factors 116-119
    assert _eq(tq.expand_bands(aq, sizes),
               jq.expand_bands(jq.banded_aq(jnp.asarray(q), jnp.asarray(qm)),
                               sizes))
    # the per-lane form
    lane_q = tq.expand_bands(aq, sizes)
    assert torch.equal(got, tq.scale(torch.from_numpy(values), lane_q))


def test_quant_banded_matches_vc2tpu():
    """quant_banded below 2^29 (where the JAX package's float reciprocal
    is exact), and its tables."""
    values, q, qm, sizes = _banded_case(12, (1 << 29) - 1)
    want = jq.quant_banded(jnp.asarray(values), jnp.asarray(q),
                           jnp.asarray(qm), sizes)
    got = tq.quant_banded(torch.from_numpy(values), torch.from_numpy(q), qm,
                          sizes)
    assert got.dtype == torch.int32 and _eq(got, want)
    absqf, wrapped = tq.quant_tables(torch.from_numpy(q), qm)
    wabs, _recip, wwrapped = jq.quant_tables(jnp.asarray(q), jnp.asarray(qm))
    assert _eq(absqf, wabs) and _eq(wrapped, wwrapped)


def _geometry(ys, xs, luma, chroma):
    return SliceGeometry(ys, xs, (ys * luma[0], xs * luma[1]),
                         (ys * chroma[0], xs * chroma[1]), luma, chroma)


# (slices down, across, luma slice, chroma slice, wavelet, depth, LD grids)
ROUTE_CASES = {
    "422_legall_d2_ld": (3, 4, (8, 8), (8, 4), JK.LeGall, 2, True),
    "444_daub97_d3": (2, 2, (16, 32), (16, 32), JK.Daub97, 3, False),
    "420_dd137_d2": (2, 3, (16, 24), (8, 12), JK.DD137, 2, False),
}


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _jax_inverse(lanes, q, ll, geo, kernel, depth, qm):
    """The JAX package's decode tail, uncropped: scale_banded,
    lanes_to_bands, inverse_bands (LD: the grids as band 0). One compile
    a case."""
    out = []
    for c, x in enumerate(lanes):
        sh, sw = bands.slice_dims(geo, c)
        scaled = jq.scale_banded(x, q, jnp.asarray(qm, jnp.int32),
                                 bands.band_sizes(sh, sw, depth))
        bl = list(jl.lanes_to_bands(
            scaled, geo.y_slices, geo.x_slices,
            jl.band_dims(geo.y_slices * sh, geo.x_slices * sw, depth)))
        if ll is not None:
            bl[0] = ll[c]
        out.append(jl.inverse_bands(bl, kernel, depth))
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_forward(planes, geo, kernel, depth):
    """The JAX encoder's analysis: wavelet_pad, forward_bands,
    bands_to_lanes."""
    return [jl.bands_to_lanes(
        jl.forward_bands(jl.wavelet_pad(x.astype(jnp.int32), depth), kernel,
                         depth), geo.y_slices, geo.x_slices)
        for x in planes]


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_inverse_lanes_plain_matches_vc2tpu(case):
    """inverse_lanes_plain against the JAX composition and against the
    port's in-place route (dequantise_planes or dequantise_ld_planes, then
    inverse_planes): 4:2:2 with LD LL grids, 4:4:4, and 4:2:0 slices whose
    bands are not powers of two wide (24 / 12 columns)."""
    ys, xs, luma, chroma, kernel, depth, ld = ROUTE_CASES[case]
    geo = _geometry(ys, xs, luma, chroma)
    tk = TK(int(kernel))
    rng = np.random.default_rng(len(case))
    qm = matrices.quant_matrix(tk, depth)
    lanes = [_rand(rng, (geo.n_slices, sh * sw), 600)
             for sh, sw in (luma, chroma, chroma)]
    q = rng.integers(0, 60, geo.n_slices).astype(np.int32)
    ll = None
    if ld:
        ll = [_rand(rng, (p[0] >> depth, p[1] >> depth), 1 << 13)
              for p in (geo.padded_luma, geo.padded_chroma,
                        geo.padded_chroma)]
    tlanes = [torch.from_numpy(x) for x in lanes]
    tll = None if ll is None else [torch.from_numpy(g) for g in ll]
    got = bands.inverse_lanes_plain(tlanes, torch.from_numpy(q), qm, geo, tk,
                                    depth, tll)
    want = _jax_inverse([jnp.asarray(x) for x in lanes], jnp.asarray(q),
                        None if ll is None else [jnp.asarray(g) for g in ll],
                        geo, kernel, depth, tuple(int(v) for v in qm))
    assert all(_eq(g, w) for g, w in zip(got, want))
    if ld:
        planes = pipe.dequantise_ld_planes(tlanes, torch.from_numpy(q), tll,
                                           qm, depth, geo)
    else:
        planes = pipe.dequantise_planes(tlanes, torch.from_numpy(q), qm,
                                        depth, geo)
    inplace = tl.inverse_planes(planes, tk, depth)
    assert all(torch.equal(g, w) for g, w in zip(got, inplace))
    # the wrapper takes the plain version for CPU lanes
    assert all(torch.equal(g, w) for g, w in zip(
        bands.inverse_lanes(tlanes, torch.from_numpy(q), qm, geo, tk, depth,
                            tll), got))


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_forward_lanes_plain_matches_vc2tpu(case):
    """forward_lanes_plain of int16 planes that pad, against the JAX
    encoder's wavelet_pad, forward_bands and bands_to_lanes, and against
    the port's in-place route (analyse, planes_to_lanes)."""
    ys, xs, luma, chroma, kernel, depth, _ld = ROUTE_CASES[case]
    geo = _geometry(ys, xs, luma, chroma)
    tk = TK(int(kernel))
    rng = np.random.default_rng(100 + len(case))
    planes = [_rand(rng, (p[0] - 1, p[1] - 1), 511).astype(np.int16)
              for p in (geo.padded_luma, geo.padded_chroma,
                        geo.padded_chroma)]
    tplanes = [torch.from_numpy(p) for p in planes]
    got = bands.forward_lanes_plain(tplanes, tk, depth, geo)
    want = _jax_forward([jnp.asarray(x) for x in planes], geo, kernel, depth)
    assert all(g.dtype == torch.int32 and _eq(g, w)
               for g, w in zip(got, want))
    inplace = enc.planes_to_lanes(
        enc.analyse([p.to(torch.int32) for p in tplanes], tk, depth), geo,
        depth)
    assert all(torch.equal(g, w) for g, w in zip(got, inplace))
    assert all(torch.equal(g, w) for g, w in zip(
        bands.forward_lanes(tplanes, tk, depth, geo), got))
    # the TRANSFORM tap's planes: the lanes in transform layout
    assert all(torch.equal(p, w) for p, w in zip(
        enc.lanes_to_planes(got, geo, depth),
        enc.analyse([p.to(torch.int32) for p in tplanes], tk, depth)))


def test_band_wrappers_refuse_other_devices():
    geo = _geometry(1, 1, (4, 4), (4, 4))
    lanes = [torch.zeros((1, 16), dtype=torch.int32, device="meta")] * 3
    q = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        bands.inverse_lanes(lanes, q, np.zeros(7), geo, TK.LeGall, 2)
    with pytest.raises(ValueError):
        bands.forward_lanes([torch.zeros((4, 4), device="meta")] * 3,
                            TK.LeGall, 2, geo)


# --- the kernels' plan: runs, run maps, tiles (csrc/band_lift.cu) ----------

# (slices down, across, luma slice, chroma slice, depth): the 1080p 4:2:2
# geometry (135 x 240 slices, cut to fewer for the maps), -u 1 -a 2 at
# 1080p, 12-row slices, 4:2:0 with 24 / 12 columns, 4:4:4 at depth 3
PLAN_GRIDS = {"1080p_422": (135, 240, (8, 8), (8, 4), 2),
              "u1a2_1080p": (270, 240, (4, 8), (4, 4), 2),
              "rows12": (3, 5, (12, 24), (12, 12), 2),
              "420_cols24": (4, 3, (16, 24), (8, 12), 2),
              "444_d3": (2, 3, (24, 40), (24, 40), 3)}


def _map_fields(entries):
    e = entries.astype(np.int64)
    return e >> 30, (e >> 15) & bands.MAP_FIELD, e & bands.MAP_FIELD


@pytest.mark.parametrize("grid", list(PLAN_GRIDS))
def test_run_map_matches_lane_order(grid):
    """Each level's run (level_run) and run map (run_map, run_maps) place
    every lane of the run where vc2tpu's lane_order and lanes_to_bands put
    it: lane run0 + l of slice (sy, sx) is band sample (sy bh + row,
    sx bw + column) of the band of its parity plane; the run holds the
    level's bands and nothing else, with LL first only where asked; the
    map pads to whole quads with entries whose row no region reaches."""
    from vc2tpu.slices import layout as jlayout

    ys, xs, luma, chroma, depth = PLAN_GRIDS[grid]
    ys, xs = min(ys, 3), min(xs, 4)          # the map is a slice's
    geo = _geometry(ys, xs, luma, chroma)
    for with_ll in (True, False):
        maps = bands.run_maps(geo, depth, with_ll)
        assert len(maps) == depth
        for comp in range(3):
            sh, sw = bands.slice_dims(geo, comp)
            perm, band_of = jlayout.lane_order(sh, sw, depth)
            n_lanes = geo.n_slices * sh * sw
            lanes = np.arange(n_lanes, dtype=np.int32).reshape(
                geo.n_slices, sh * sw)
            dims = jl.band_dims(ys * sh, xs * sw, depth)
            band_arrays = [np.asarray(b) for b in jl.lanes_to_bands(
                jnp.asarray(lanes), ys, xs, dims)]
            for level in range(1, depth + 1):
                ll = with_ll and level == 1
                run0, n, kb = bands.level_run(sh, sw, depth, level, ll)
                bh, bw = bands.level_block(sh, sw, depth, level)
                entries = maps[level - 1][comp]
                assert entries.dtype == np.uint32
                assert len(entries) == -(-n // 4) * 4
                assert np.all(entries[n:] == bands.MAP_PAD)
                k, row, col = _map_fields(entries[:n])
                first = 1 + 3 * (level - 1)
                want_bands = ([0] if ll else []) + [first, first + 1,
                                                    first + 2]
                assert kb == (0 if ll else 1)
                assert list(band_of[run0:run0 + n]) == \
                    [b for b in want_bands for _ in range(bh * bw)]
                b_of_k = np.where(k == 0, 0, first + k - 1)
                assert np.array_equal(b_of_k, band_of[run0:run0 + n])
                # lane_order: the offset within the slice's block
                s = 1 << (depth + 1 - level)
                half = s // 2 if level > 0 else 0
                oy = np.where((k == 2) | (k == 3), half, 0)
                ox = np.where((k == 1) | (k == 3), half, 0)
                assert np.array_equal(perm[run0:run0 + n],
                                      (row * s + oy) * sw + col * s + ox)
                # lanes_to_bands: every slice's run lands on its band
                for sy in range(ys):
                    for sx in range(xs):
                        got = np.array([band_arrays[b][sy * bh + r,
                                                       sx * bw + c]
                                        for b, r, c in zip(b_of_k, row,
                                                           col)])
                        assert np.array_equal(
                            got, lanes[sy * xs + sx, run0:run0 + n])


@pytest.mark.parametrize("grid", list(PLAN_GRIDS))
@pytest.mark.parametrize("kernel", [TK.LeGall, TK.Fidelity],
                         ids=["LeGall", "Fidelity"])
def test_plan_tiles_keep_whole_slices(grid, kernel):
    """The plan's tiles (tile_shape) are whole slices of every component
    where that keeps at least half of a side and fit their region with the
    halo; every tile's window of slices fits the table's max_slices (the
    shared memory the inverse is given); the tiles, quant matrix and run
    fields of each component match the geometry and level_run."""
    ys, xs, luma, chroma, depth = PLAN_GRIDS[grid]
    geo = _geometry(ys, xs, luma, chroma)
    hr = tl.halo(kernel)
    hc = tl.col_halo(hr)
    qm = tuple(range(3 * depth + 1))
    for ll_in_run in (True, False):
        levels = bands._plan(geo, qm, int(kernel), depth, 132, ll_in_run)
        for level, (template, dims) in enumerate(levels, start=1):
            t = bands._BandTable.from_buffer_copy(template)
            assert t.rw >= t.tw + 2 * hc and t.rw & (t.rw - 1) == 0
            assert t.th % 2 == 0 and t.tw % 8 == 0
            rh = min(r for r, w in tl.REGIONS
                     if w == t.rw and t.th + 2 * hr <= r)
            blocks = [bands.level_block(*bands.slice_dims(geo, c), depth,
                                        level) for c in range(3)]
            # each side: whole slices of every component, or (where that
            # would lose more than half) the region's full side
            for side, full, steps in (
                    (t.th, rh - 2 * hr, [2 * bh for bh, _ in blocks]),
                    (t.tw, t.rw - 2 * hc, [8] + [2 * bw for _, bw in blocks])):
                step = int(np.lcm.reduce(steps))
                if side % step == 0:
                    assert side == full - full % step
                else:
                    assert side == full and 2 * (full - full % step) < full
            n_tiles = 0
            for c, ((h, w), (bh, bw)) in enumerate(zip(dims, blocks)):
                p = t.p[c]
                sh, sw = bands.slice_dims(geo, c)
                assert (p.h, p.w, p.bh, p.bw) == (h, w, bh, bw)
                assert (p.run0, p.R) == bands.level_run(
                    sh, sw, depth, level, ll_in_run and level == 1)[:2]
                assert list(p.qm) == [qm[0]] + [qm[1 + 3 * (level - 1) + i]
                                                for i in range(3)]
                assert p.tile0 == n_tiles
                n_tiles += p.tiles_x * -(-h // t.th)
                # the kernel's window of slices of every tile's region
                # fits the inverse's tables (max_slices words)
                for ty0 in range(0, h, t.th):
                    for tx0 in range(0, w, t.tw):
                        r0, r1, c0, c1 = tl.tile_region(ty0, tx0, t.th,
                                                        t.tw, h, w, hr)
                        i0, i1, j0, j1 = r0 // 2, r1 // 2, c0 // 2, c1 // 2
                        ns = ((i1 - 1) // bh - i0 // bh + 1) * \
                            ((j1 - 1) // bw - j0 // bw + 1)
                        assert ns <= t.max_slices
            assert t.n_tiles == n_tiles
            assert bands.smem_bytes(t.th, t.rw, hr, t.max_slices) <= \
                tl.SMEM_LIMIT
    if grid == "1080p_422" and kernel == TK.LeGall:
        # the finest level's 60-row tile becomes 56: whole 8-row slices
        fine = bands._BandTable.from_buffer_copy(levels[-1][0])
        coarse = bands._BandTable.from_buffer_copy(levels[0][0])
        assert (fine.th, fine.tw, fine.rw) == (56, 120, 128)
        assert (coarse.th, coarse.tw, coarse.rw) == (28, 56, 64)


def test_plan_splits_slices_larger_than_a_tile():
    """Slices of 64 x 64 at depth 1 (32-row sub-blocks) are larger than
    any tile: the tiles keep their full size and split the slices, whose
    lanes the kernel masks."""
    geo = _geometry(2, 3, (64, 64), (64, 32))
    (template, _dims), = bands._plan(geo, (0,) * 4, int(TK.LeGall), 1, 132,
                                     True)
    t = bands._BandTable.from_buffer_copy(template)
    assert (t.th, t.tw) in tl.tiles(tl.halo(TK.LeGall))
    assert t.th % 64 and t.p[0].bh == 32
