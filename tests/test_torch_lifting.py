"""The port's lifting against vc2tpu: the plain ``lift_level`` against
``lifting.lift_level`` and the Pallas ``pallas_lift.lift_level`` (interpret
mode off the TPU), whole-plane transforms at depths 1-4, and a CPU model of
the CUDA kernel's tiling that pins its halo. The kernel itself is held
against the plain version by tests/test_torch_cuda.py (on the card)."""

import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vc2tpu.core.config import WaveletKernel as JK
from vc2tpu.wavelet import lifting as jl
from vc2tpu.wavelet import pallas_lift

from vc2tpu_torch.core.config import WaveletKernel as TK
from vc2tpu_torch.core.intmath import wrap32
from vc2tpu_torch.wavelet import lifting as tl

KERNELS = [k for k in JK if k != JK.NullKernel]
IDS = [k.name for k in KERNELS]
H100_SMS = 132


# one compile per (shape, kernel, depth) instead of one per eager op
@functools.partial(jax.jit, static_argnums=(1,))
def _lift_both(x, kernel):
    return jl.lift_level(x, kernel), jl.lift_level(x, kernel, invert=True)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _roundtrip(x, kernel, depth):
    fwd = jl.forward_plane(x, kernel, depth)
    return fwd, jl.inverse_plane(fwd, kernel, depth)


def _rand(shape, seed, lim=1 << 20):
    return np.random.default_rng(seed).integers(-lim, lim + 1, shape).astype(
        np.int32)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_plain_lift_matches_vc2tpu(kernel):
    tk = TK(int(kernel))
    for i, shape in enumerate([(2, 2), (4, 8), (34, 66)]):
        x = _rand(shape, i)
        for invert, want in zip((False, True),
                                _lift_both(jnp.asarray(x), kernel)):
            got = tl.lift_level(torch.from_numpy(x), tk, invert).numpy()
            assert np.array_equal(got, np.asarray(want)), (shape, invert)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_plain_lift_matches_pallas_interpret(kernel):
    h, w = 128, 256
    assert pallas_lift.supported(h, w, kernel)
    x = np.random.default_rng(7).integers(-600, 600, (h, w)).astype(np.int32)
    want = np.asarray(pallas_lift.lift_level(jnp.asarray(x), kernel))
    got = tl.lift_level(torch.from_numpy(x), TK(int(kernel))).numpy()
    assert np.array_equal(got, want)
    inv_want = np.asarray(pallas_lift.lift_level(jnp.asarray(want), kernel,
                                                 invert=True))
    inv_got = tl.lift_level(torch.from_numpy(got), TK(int(kernel)),
                            invert=True).numpy()
    assert np.array_equal(inv_got, inv_want)
    assert np.array_equal(inv_got, x)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_planes_match_vc2tpu(kernel):
    tk = TK(int(kernel))
    cases = [((2, 2), 1), ((4, 8), 2), ((8, 24), 3), ((32, 64), 4)]
    for i, (shape, depth) in enumerate(cases):
        x = _rand(shape, 10 + i, lim=1023)
        fwd_want, inv_want = _roundtrip(jnp.asarray(x), kernel, depth)
        fwd_got = tl.forward_plane(torch.from_numpy(x), tk, depth)
        assert np.array_equal(fwd_got.numpy(), np.asarray(fwd_want)), (
            shape, depth)
        inv_got = tl.inverse_plane(fwd_got.clone(), tk, depth).numpy()
        assert np.array_equal(inv_got, np.asarray(inv_want)), (shape, depth)


def test_wavelet_pad_matches_vc2tpu():
    x = _rand((5, 7), 3)
    want = np.asarray(jl.wavelet_pad(jnp.asarray(x), 2))
    assert np.array_equal(tl.wavelet_pad(torch.from_numpy(x), 2).numpy(),
                          want)


def _parity_lift(reg, kernel, invert):
    """The kernel's arithmetic on one region held as four parity planes
    q[row parity][column parity]: the horizontal ladder runs on the pairs
    (q[a][0], q[a][1]), the vertical one on (q[0][b], q[1][b])."""
    steps = tl.ladder(kernel, invert)
    shift = tl.TRANSFORM_SHIFT[kernel]
    v = reg.to(torch.int64)
    if not invert and shift:
        v = wrap32(v << shift)
    q = [[v[a::2, b::2] for b in (0, 1)] for a in (0, 1)]

    def rows():
        for a in (0, 1):
            q[a][0], q[a][1] = tl._apply_steps(q[a][0], q[a][1], steps, 1)

    def cols():
        for b in (0, 1):
            q[0][b], q[1][b] = tl._apply_steps(q[0][b], q[1][b], steps, 0)

    if invert:
        cols()
        rows()
    else:
        rows()
        cols()
    out = torch.empty_like(v)
    for a in (0, 1):
        for b in (0, 1):
            out[a::2, b::2] = q[a][b]
    if invert and shift:
        out = wrap32(out + (1 << (shift - 1))) >> shift
    return out.to(torch.int32)


def _kernel_model(plane, kernel, invert, stride, overlay, th, tw):
    """One CTA grid of csrc/lift_level.cu on the CPU: every th x tw tile of
    the level's (h, w) = plane[::stride, ::stride] is the parity-split lift
    of its region (tile plus ``halo`` rows and ``col_halo`` columns,
    clipped), whose samples come from the strided plane and, at (even,
    even), from the compact overlay; the tile is written to a compact
    (h, w) result."""
    hr = tl.halo(kernel)
    h, w = plane.shape[0] // stride, plane.shape[1] // stride
    out = torch.empty((h, w), dtype=torch.int32)
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            r0, r1, c0, c1 = tl.tile_region(ty, tx, th, tw, h, w, hr)
            reg = plane[r0 * stride:r1 * stride:stride,
                        c0 * stride:c1 * stride:stride].clone()
            if overlay is not None:
                reg[::2, ::2] = overlay[r0 // 2:r1 // 2, c0 // 2:c1 // 2]
            lifted = _parity_lift(reg, kernel, invert)
            hh, ww = min(th, h - ty), min(tw, w - tx)
            out[ty:ty + hh, tx:tx + ww] = lifted[ty - r0:ty - r0 + hh,
                                                 tx - c0:tx - c0 + ww]
    return out


@pytest.mark.parametrize("kernel", [TK(int(k)) for k in KERNELS], ids=IDS)
def test_kernel_tiling_halo_is_exact(kernel):
    hr = tl.halo(kernel)
    assert hr % 2 == 0
    for th, tw in tl.tiles(hr):
        assert th % 2 == 0 and tw % 8 == 0
        assert tl.smem_bytes(th, tw, hr) <= tl.SMEM_LIMIT
    sizes = [(1080, 1920), (1080, 960), (1080, 960)]
    th_tw = tl.tile_shape(sizes, hr, tl.CTAS_PER_SM * H100_SMS)
    assert tl.smem_bytes(*th_tw, hr) <= tl.SMEM_LIMIT
    for i, shape in enumerate([(2, 2), (66, 130), (100, 194), (34, 66)]):
        x = torch.from_numpy(_rand(shape, 20 + i))
        for th, tw in tl.tiles(hr):
            for invert in (False, True):
                assert torch.equal(
                    _kernel_model(x, kernel, invert, 1, None, th, tw),
                    tl.lift_level_plain(x, kernel, invert)), (shape, th, tw)


@pytest.mark.parametrize("kernel", [TK(int(k)) for k in KERNELS], ids=IDS)
def test_kernel_levels_without_copies_are_exact(kernel):
    """The inverse's levels as the card runs them: each level reads the
    plane's strided sub-lattice and the coarser level's compact result as
    its (even, even) overlay, and writes a compact plane; equal to
    inverse_planes (copy and scatter) at depths 1-3, planes down to 2x2."""
    hr = tl.halo(kernel)
    cases = [((2, 2), (2, 2), 1), ((4, 8), (4, 4), 2),
             ((72, 136), (72, 64), 3), ((104, 200), (104, 100), 2)]
    for i, (shape, shape2, depth) in enumerate(cases):
        planes = [torch.from_numpy(_rand(shape, 40 + i)),
                  torch.from_numpy(_rand(shape2, 50 + i))]
        want = tl.inverse_planes(planes, kernel, depth)
        coarse = None
        for level in range(depth - 1, -1, -1):
            s = 1 << level
            sizes = [(p.shape[0] // s, p.shape[1] // s) for p in planes]
            th, tw = tl.tile_shape(sizes, hr, tl.CTAS_PER_SM * H100_SMS)
            level_want = tl.lift_levels_plain(planes, kernel, True, s, coarse)
            coarse = [_kernel_model(p, kernel, True, s, o, th, tw)
                      for p, o in zip(planes, coarse or [None, None])]
            for got, w in zip(coarse, level_want):
                assert torch.equal(got, w), (shape, depth, level)
        for got, w in zip(coarse, want):
            assert torch.equal(got, w), (shape, depth)
        # a forward level read in place from the sub-lattice, smallest tile
        s = 1 << (depth - 1)
        th, tw = tl.tiles(hr)[-1]
        assert torch.equal(
            _kernel_model(planes[0], kernel, False, s, None, th, tw),
            tl.lift_levels_plain(planes[:1], kernel, False, s)[0])


@pytest.mark.parametrize("kernel", list(TK), ids=[k.name for k in TK])
def test_ladder_header_decodes_to_steps(kernel):
    """lift_ladders.h, generated from _STEPS, holds every ladder exactly:
    parsing it back gives ladder(kernel, invert) and the transform shift."""
    text = tl.ladder_header()
    for invert in (False, True):
        name = f"lift_{kernel.name}_{'inv' if invert else 'fwd'}"
        m = re.search(rf"using {name} = Ladder<(\d+), (\d+)(.*)>;", text)
        assert m, name
        assert int(m.group(1)) == int(invert)
        assert int(m.group(2)) == tl.TRANSFORM_SHIFT[kernel]
        steps = []
        for args in re.findall(r"Step<([^>]*)>", m.group(3)):
            v = [int(a) for a in args.split(",")]
            taps = tuple(zip(v[4::2], v[5::2]))
            steps.append(("o" if v[0] else "e", v[1], taps, v[2], v[3]))
        assert tuple(steps) == tl.ladder(kernel, invert)
        case = 2 * int(kernel) + int(invert)
        assert f"case {case}: return f({name}{{}});" in text
    assert tl.ladder(kernel, False) == tl._STEPS[kernel]


def test_lift_wrapper_refuses_other_devices():
    x = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tl.lift_level(x, TK.LeGall)
