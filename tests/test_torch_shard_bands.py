"""The band (Mallat) form of the port's row-band DWT on the CPU:
``shard.halo.forward_bands_local`` / ``inverse_bands_local`` against
``vc2tpu.shard.halo``'s own under ``jax.shard_map`` (the JAX package's
mesh encode and decode compositions, on the 8 virtual CPU devices of
tests/conftest.py), and over CPU meshes against the port's single-device
band route (``wavelet.bands``) for every wavelet, depths 0-3 and 1-8
bands: the thinnest bands the JAX package takes, 4:2:2, 4:2:0 and 4:4:4
slice heights, an interlaced field and the LD grids as band 0. Integer
``==`` throughout. A shard_map compiles for seconds on the CPU, so the
JAX values come from one module-scoped case each way; which geometries
the JAX package refuses comes from tracing alone (``jax.eval_shape``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vc2tpu.core import config as jcfg
from vc2tpu.pipeline import sharded as jsharded
from vc2tpu.shard import halo as jhalo
from vc2tpu.shard.mesh import make_mesh as j_make_mesh
from vc2tpu.wavelet import lifting as jl

from vc2tpu_torch.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                      Mode, WaveletKernel)
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline import decoder as pipe
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.sharded import ShardedDecoder, ShardedEncoder
from vc2tpu_torch.shard import halo
from vc2tpu_torch.shard.mesh import make_mesh
from vc2tpu_torch.slices.hq import SliceGeometry, scan_hq_slice_offsets
from vc2tpu_torch.wavelet import bands, lifting, matrices

KERNELS = [k for k in WaveletKernel if k != WaveletKernel.NullKernel]
IDS = [k.name for k in KERNELS]


def _rand(rng, shape, lim):
    return rng.integers(-lim, lim + 1, shape).astype(np.int32)


def _geometry(ys, xs, luma, chroma) -> SliceGeometry:
    return SliceGeometry(ys, xs, (ys * luma[0], xs * luma[1]),
                         (ys * chroma[0], xs * chroma[1]), luma, chroma)


def _thinnest(kernel, depth, sh_min: int) -> int:
    """Slice rows of the thinnest band the JAX package takes, for slices
    whose shortest component is ``sh_min`` rows."""
    hw = halo.halo_width(kernel) if depth else 0
    return max(1, -(-(hw << depth) // sh_min))


def _picture(rng, geo, depth, lim=1 << 9):
    """Three planes that pad to ``geo`` (each short of it by up to
    2**depth - 1 rows and columns, so the last band's block is padded by
    the kernel's clamp)."""
    cut = (1 << depth) - 1
    return [torch.from_numpy(_rand(rng, (h - cut, w - cut), lim))
            for h, w in (geo.padded_luma, geo.padded_chroma,
                         geo.padded_chroma)]


def _forward_over_bands(planes, kernel, depth, geo, n):
    """Each band's block of ``planes`` (``halo.band_blocks``) through
    ``forward_bands_local``; the bands' lanes concatenated."""
    out = [[], [], []]
    for s, blk in enumerate(halo.band_blocks(geo, n, kernel, depth)):
        a, _r0, _r1, b = blk
        block = [p[a * sh:b * sh] for p, sh in zip(
            planes, (geo.luma_slice[0], geo.chroma_slice[0],
                     geo.chroma_slice[0]))]
        for c, t in enumerate(halo.forward_bands_local(block, kernel, depth,
                                                       geo, s, n)):
            out[c].append(t)
    return [torch.cat(t) for t in out]


def _inverse_over_bands(lanes, q, qm, kernel, depth, geo, n, ll=None):
    """Each band's block of the lanes (LD: of the grids) through
    ``inverse_bands_local``; the bands' rows concatenated."""
    xs, ts = geo.x_slices, 1 << depth
    out = [[], [], []]
    for s, (a, _r0, _r1, b) in enumerate(halo.band_blocks(geo, n, kernel,
                                                          depth)):
        sl = slice(a * xs, b * xs)
        grids = None if ll is None else [
            g[a * sh // ts:b * sh // ts] for g, sh in zip(
                ll, (geo.luma_slice[0], geo.chroma_slice[0],
                     geo.chroma_slice[0]))]
        for c, t in enumerate(halo.inverse_bands_local(
                [x[sl] for x in lanes], q[sl], qm, kernel, depth, geo, s, n,
                grids)):
            out[c].append(t)
    return [torch.cat(t) for t in out]


def _lanes(rng, geo, depth, lim=1 << 8):
    return [torch.from_numpy(_rand(rng, (geo.n_slices, sh * sw), lim))
            for sh, sw in (geo.luma_slice, geo.chroma_slice,
                           geo.chroma_slice)]


def _grids(rng, geo, depth):
    return [torch.from_numpy(_rand(rng, (h >> depth, w >> depth), 1 << 12))
            for h, w in (geo.padded_luma, geo.padded_chroma,
                         geo.padded_chroma)]


def _both_ways(kernel, depth, geo, n, seed, ld=False):
    """The band form over ``n`` bands against the single-device band route
    (``bands.forward_lanes`` / ``inverse_lanes``, the plain versions on
    the CPU), both ways; the inverse through ``ShardedDecoder.synthesise``
    on a CPU mesh, and with LD grids as band 0 when ``ld``."""
    rng = np.random.default_rng(seed)
    planes = _picture(rng, geo, depth)
    want = bands.forward_lanes(planes, kernel, depth, geo)
    got = _forward_over_bands(planes, kernel, depth, geo, n)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    lanes = _lanes(rng, geo, depth)
    q = torch.from_numpy(rng.integers(0, 60, geo.n_slices).astype(np.int32))
    qm = matrices.quant_matrix(kernel, depth)
    want = bands.inverse_lanes(lanes, q, qm, geo, kernel, depth)
    sdec = ShardedDecoder(kernel, depth, geo, make_mesh(1, n, device="cpu"))
    got = sdec.synthesise(q.numpy(), *[x.numpy() for x in lanes])
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    if ld:
        grids = _grids(rng, geo, depth)
        want = (bands.inverse_lanes(lanes, q, qm, geo, kernel, depth, grids)
                if depth else grids)
        got = _inverse_over_bands(lanes, q, qm, kernel, depth, geo, n, grids)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)


# --- (a) against vc2tpu.shard.halo under jax.shard_map ----------------------

# 4:2:2 slices of 4 x 8 luma rows and columns over 8 of the thinnest bands
# Fidelity takes at depth 2 (16 rows: its margin of 11 slice rows spans
# the next two bands and more); the DD137 inverse over 4 bands
JAX_FWD = (WaveletKernel.Fidelity, 2, _geometry(32, 3, (4, 8), (4, 4)), 8)
JAX_INV = (WaveletKernel.DD137, 2, _geometry(16, 3, (8, 8), (8, 4)), 4)


@pytest.fixture(scope="module")
def jax_band_form():
    """The JAX package's band form under shard_map: the encode's
    ``forward_bands_local`` -> ``bands_to_lanes`` (``sharded.py:107``) of
    three seeded planes, and the decode step's ``scale_banded`` ->
    ``lanes_to_bands`` -> ``inverse_bands_local``
    (``make_sharded_decode_step``) of seeded lanes."""
    rng = np.random.default_rng(14)
    kernel, depth, geo, n = JAX_FWD
    jk = jcfg.WaveletKernel(int(kernel))
    planes = [_rand(rng, dims, 1 << 9) for dims in (
        geo.padded_luma, geo.padded_chroma, geo.padded_chroma)]
    ys_local = geo.y_slices // n

    def local(*xs):
        return tuple(jl.bands_to_lanes(
            jhalo.forward_bands_local(x, jk, depth, "space"), ys_local,
            geo.x_slices) for x in xs)

    fwd = jax.shard_map(local, mesh=j_make_mesh(1, n),
                        in_specs=(P("space", None),) * 3,
                        out_specs=(P("space", None),) * 3)
    fwd_lanes = [np.asarray(t) for t in jax.jit(fwd)(*planes)]

    kernel, depth, geo, n = JAX_INV
    lanes = [_rand(rng, (geo.n_slices, sh * sw), 1 << 8)
             for sh, sw in (geo.luma_slice, geo.chroma_slice,
                            geo.chroma_slice)]
    q = rng.integers(0, 60, geo.n_slices).astype(np.int32)
    step = jsharded.make_sharded_decode_step(
        jcfg.WaveletKernel(int(kernel)), depth, geo, j_make_mesh(1, n),
        batch_axis=None)
    inv = [np.asarray(t)[0] for t in step(jnp.asarray(q[None]),
                                          *[jnp.asarray(x[None])
                                            for x in lanes])]
    return planes, fwd_lanes, lanes, q, inv


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_band_form_matches_vc2tpu(jax_band_form, direction):
    planes, fwd_lanes, lanes, q, inv = jax_band_form
    if direction == "forward":
        kernel, depth, geo, n = JAX_FWD
        got = _forward_over_bands([torch.from_numpy(p) for p in planes],
                                  kernel, depth, geo, n)
        for g, w in zip(got, fwd_lanes, strict=True):
            assert np.array_equal(g.numpy(), w)
    else:
        kernel, depth, geo, n = JAX_INV
        got = ShardedDecoder(kernel, depth, geo,
                             make_mesh(1, n, device="cpu")).synthesise(
            q, *lanes)
        for g, w in zip(got, inv, strict=True):
            assert np.array_equal(g.numpy(), w)


# --- (b) against the single-device band route -------------------------------

@pytest.mark.parametrize("space", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_band_form_matches_single_device(kernel, depth, space):
    """4:2:2 slices of 2**depth rows over ``space`` of the thinnest bands
    the JAX package takes (or one slice row a band where it takes any),
    pictures short of the slice grid by 2**depth - 1 rows and columns:
    both ways equal to one device's band route, and with LD grids."""
    ts = 1 << depth
    geo = _geometry(space * _thinnest(kernel, depth, ts), 2, (ts, 2 * ts),
                    (ts, ts))
    _both_ways(kernel, depth, geo, space, 100 * depth + space, ld=True)


# (luma slice, chroma slice): rows and columns, whole blocks of 2**3
LAYOUTS = {
    "420": ((16, 16), (8, 8)),
    "444": ((8, 8), (8, 8)),
    "422_tall": ((16, 16), (16, 8)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kernel,depth", [
    (WaveletKernel.Fidelity, 3), (WaveletKernel.DD137, 2),
    (WaveletKernel.LeGall, 2), (WaveletKernel.Daub97, 1)],
    ids=["Fidelity_d3", "DD137_d2", "LeGall_d2", "Daub97_d1"])
def test_band_form_over_slice_heights(kernel, depth, layout):
    """4:2:0 (chroma slices half as tall: the margin is the chroma's whole
    slice rows), 4:4:4 and tall 4:2:2 slices, over the thinnest bands
    the JAX package takes for the shortest component, 4 bands, with LD
    grids."""
    luma, chroma = LAYOUTS[layout]
    geo = _geometry(4 * _thinnest(kernel, depth, chroma[0]), 2, luma,
                    chroma)
    _both_ways(kernel, depth, geo, 4, depth, ld=True)


def _cfg(kernel, mode, interlaced, height=64):
    return EncoderConfig(
        height=height, width=32, chroma_format=ColourFormat.CF422,
        kernel=kernel, wavelet_depth=2, y_size=1, x_size=2, mode=mode,
        luma_depth=10, chroma_depth=10, frame_rate=FrameRate.FR25,
        interlaced=interlaced,
        compressed_bytes=height * 32 // 2 if mode == Mode.HQ_CBR else 0,
        q_index=12 if mode == Mode.HQ_ConstQ else 0)


@pytest.mark.parametrize("kernel", [WaveletKernel.Fidelity,
                                    WaveletKernel.DD97],
                         ids=["Fidelity", "DD97"])
def test_sharded_encoder_interlaced_fields(kernel):
    """An interlaced 4:2:2 picture of 92 rows encoded as fields of 46 rows
    (2 short of 48, 12 slice rows) by ShardedEncoder over 1x3 bands, and HQ
    CBR frames over 1x4 bands of the thinnest rows the JAX package takes
    (Fidelity: 16), against the single-device Encoder; the fields decode
    over the mesh to the single-device lanes' inverse."""
    rng = np.random.default_rng(int(kernel))
    for cfg, space in ((_cfg(kernel, Mode.HQ_ConstQ, True, 92), 3),
                       (_cfg(kernel, Mode.HQ_CBR, False), 4)):
        enc = Encoder(cfg, device="cpu")
        rows = enc.geo.padded_luma[0] - (2 if cfg.interlaced else 0)
        pics = [Picture(_rand(rng, (rows, 32), 511),
                        _rand(rng, (rows, 16), 511),
                        _rand(rng, (rows, 16), 511), ColourFormat.CF422)
                for _ in range(2)]
        got = ShardedEncoder(cfg, make_mesh(1, space, device="cpu")
                             ).encode_batch(pics[:1])
        want = enc.encode_picture(pics[0])
        assert got[0].payload == want.payload
        assert np.array_equal(got[0].q_indices, want.q_indices)
        sdec = ShardedDecoder(kernel, 2, enc.geo,
                              make_mesh(1, space, device="cpu"))
        payload = np.frombuffer(want.payload, np.uint8)
        planes = sdec.decode_payload(payload, cfg.slice_prefix,
                                     cfg.slice_scalar)
        q, _ds, cbytes, _end = scan_hq_slice_offsets(
            payload, enc.geo.n_slices, cfg.slice_prefix, cfg.slice_scalar)
        lanes, q_t = pipe.unpack_payload(payload, q, cbytes, enc.geo,
                                         cfg.slice_prefix, device="cpu")
        ref = bands.inverse_lanes(lanes, q_t, sdec.qmatrix, enc.geo, kernel,
                                  2)
        for a, b in zip(planes, ref, strict=True):
            assert torch.equal(a, b)


# --- (c) the JAX package's refusals -----------------------------------------

def _jax_decode_refuses(kernel, depth, geo, n) -> str:
    """The ValueError's message where the JAX package's band-form decode
    step refuses ``geo`` over ``n`` bands, else ''; traced, not
    compiled."""
    step = jsharded.make_sharded_decode_step(
        jcfg.WaveletKernel(int(kernel)), depth, geo, j_make_mesh(1, n),
        batch_axis=None)
    shapes = [jax.ShapeDtypeStruct((1, geo.n_slices), jnp.int32)] + [
        jax.ShapeDtypeStruct((1, geo.n_slices, sh * sw), jnp.int32)
        for sh, sw in (geo.luma_slice, geo.chroma_slice, geo.chroma_slice)]
    try:
        jax.eval_shape(step, *shapes)
    except ValueError as exc:
        return str(exc)
    return ""


@pytest.mark.parametrize("kernel", [WaveletKernel.Fidelity,
                                    WaveletKernel.DD137,
                                    WaveletKernel.LeGall],
                         ids=["Fidelity", "DD137", "LeGall"])
def test_band_form_refuses_what_vc2tpu_refuses(kernel):
    """Bands one slice row thinner than the thinnest the JAX package takes
    are refused by the mesh decode and encode with its ValueError; the
    thinnest it takes are not. Bands not a multiple of 2**depth rows:
    check_rows' other error, the JAX package's in-place geometry check's
    message."""
    depth, n, ts = 2, 4, 4
    thin = _thinnest(kernel, depth, ts)
    mesh = make_mesh(1, n, device="cpu")
    for ys, refused in ((n * thin, False), (n * (thin - 1), True)):
        if not ys:
            continue
        geo = _geometry(ys, 2, (ts, 8), (ts, 4))
        msg = _jax_decode_refuses(kernel, depth, geo, n)
        assert bool(msg) == refused
        lanes = [np.zeros((geo.n_slices, sh * sw), np.int32)
                 for sh, sw in (geo.luma_slice, geo.chroma_slice,
                                geo.chroma_slice)]
        sdec = ShardedDecoder(kernel, depth, geo, mesh)
        if not refused:
            sdec.synthesise(np.zeros(geo.n_slices, np.int32), *lanes)
            continue
        with pytest.raises(ValueError) as err:
            sdec.synthesise(np.zeros(geo.n_slices, np.int32), *lanes)
        assert str(err.value) == msg
        cfg = _cfg(kernel, Mode.HQ_ConstQ, False, ys * ts)
        senc = ShardedEncoder(cfg, mesh)
        assert senc.geo.luma_slice[0] == ts
        pic = Picture(np.zeros((ys * ts, 32), np.int32),
                      np.zeros((ys * ts, 16), np.int32),
                      np.zeros((ys * ts, 16), np.int32), ColourFormat.CF422)
        with pytest.raises(ValueError) as err:
            senc.encode_batch([pic])
        assert str(err.value) == msg
    geo = _geometry(2, 2, (6, 8), (6, 4))
    msg = _jax_inplace_refuses(12, 2, kernel, depth)
    assert msg
    with pytest.raises(ValueError) as err:
        ShardedDecoder(kernel, depth, geo, make_mesh(1, 2, device="cpu")
                       ).synthesise(np.zeros(4, np.int32),
                                    np.zeros((4, 48), np.int32),
                                    np.zeros((4, 24), np.int32),
                                    np.zeros((4, 24), np.int32))
    assert str(err.value) == msg


def _jax_inplace_refuses(rows, n, kernel, depth) -> str:
    try:
        jax.eval_shape(lambda a: jhalo.sharded_forward_plane(
            a, j_make_mesh(1, n), jcfg.WaveletKernel(int(kernel)), depth),
            np.zeros((rows, 8), np.int32))
    except ValueError as exc:
        return str(exc)
    return ""


# --- (d) the margin ---------------------------------------------------------

def _ladder_reach(ladder, bad):
    """Rows of a level's output that a wrong input row (``bad``) or a
    clamped tap past the block's edge reaches, through ``ladder``'s
    vertical steps: (even rows, odd rows)."""
    e, o = bad[0::2].copy(), bad[1::2].copy()
    n = len(e)
    idx = np.arange(n)
    for target, _sign, taps, _add, _sh in ladder:
        src = e if target == "o" else o
        hit = np.zeros(n, bool)
        for off, _c in taps:
            j = idx + off
            hit |= (j < 0) | (j >= n) | src[np.clip(j, 0, n - 1)]
        if target == "o":
            o = o | hit
        else:
            e = e | hit
    return e, o


def _taps_reach(kernel, depth) -> int:
    """Plane rows from a block's edge (top or bottom) that a clamped tap
    past the edge reaches through the ladders' taps, on a 64-slice-row
    block: the forward's subband rows (each covering 2**(level + 1) plane
    rows) and the inverse's plane rows. Where the result differs lies
    within it (a wrong value can cancel out, not spread further)."""
    rows = 64 << depth
    reach = 0
    x = np.zeros(rows, bool)
    for level in range(depth):
        e, o = _ladder_reach(lifting.ladder(kernel, False), x)
        wrong = np.flatnonzero(e | o)
        half = len(e) // 2
        top = wrong[wrong < half].max(initial=-1) + 1
        bot = len(e) - wrong[wrong >= half].min(initial=len(e))
        reach = max(reach, max(top, bot) << (level + 1))
        x = e
    ll = np.zeros(rows >> depth, bool)
    for level in range(depth - 1, -1, -1):
        e, o = _ladder_reach(lifting.ladder(kernel, True),
                             np.stack([ll, np.zeros_like(ll)], 1).ravel())
        ll = np.stack([e, o], 1).ravel()
    wrong = np.flatnonzero(ll)
    top = wrong[wrong < rows // 2].max(initial=-1) + 1
    bot = rows - wrong[wrong >= rows // 2].min(initial=rows)
    return max(reach, top, bot)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_margin_is_whole_slice_rows_past_the_reach(kernel):
    """``band_margin`` is the stated reach ``halo * (2**depth - 1)``
    rounded up to whole slice rows of each component (4:2:0, 4:2:2 and
    4:4:4 heights), and covers the exact reach of a clamped block edge
    (a simulation of the ladders' taps, both directions, both edges) at
    depths 0-4."""
    for depth in range(5):
        stated = lifting.halo(kernel) * ((1 << depth) - 1)
        reach = _taps_reach(kernel, depth)
        assert reach <= -(-stated >> depth << depth) if depth else reach == 0
        for luma, chroma in (((1 << depth, 8), (1 << depth, 4)),
                             ((2 << depth, 8), (1 << depth, 4)),
                             ((4 << depth, 8), (4 << depth, 8))):
            geo = _geometry(8, 2, luma, chroma)
            m = halo.band_margin(kernel, depth, geo)
            assert m == max(-(-stated // sh) for sh in (luma[0], chroma[0]))
            assert all(m * sh >= reach for sh in (luma[0], chroma[0]))
            blocks = halo.band_blocks(geo, 4, kernel, depth)
            assert blocks[0][0] == 0 and blocks[-1][3] == geo.y_slices
            assert all(a == max(0, r0 - m) and b == min(8, r1 + m)
                       for a, r0, r1, b in blocks)


@pytest.mark.parametrize("kernel", [WaveletKernel.LeGall, WaveletKernel.DD97,
                                    WaveletKernel.Daub97],
                         ids=["LeGall", "DD97", "Daub97"])
def test_a_block_short_of_the_margin_goes_wrong(kernel):
    """Where the stated reach is tight (these wavelets at depth 2, slices
    of 4 rows), a block one slice row short of ``band_margin`` gives a
    band's lanes that differ from the picture's: band 1 of 4 bands of 16
    slice rows, whose block edges then lie inside the picture."""
    ts, ys, xs = 4, 64, 2
    geo = _geometry(ys, xs, (ts, 8), (ts, 4))
    planes = _picture(np.random.default_rng(1), geo, 2)
    want = bands.forward_lanes(planes, kernel, 2, geo)
    a, r0, r1, b = halo.band_rows(ys, 4, halo.band_margin(kernel, 2, geo)
                                  - 1)[1]
    assert 0 < a and b < ys
    got = bands.forward_lanes([p[a * ts:b * ts] for p in planes], kernel, 2,
                              halo.block_geometry(geo, a, b))
    assert not all(torch.equal(g[(r0 - a) * xs:(r1 - a) * xs],
                               w[r0 * xs:r1 * xs]) for g, w in zip(got, want))
