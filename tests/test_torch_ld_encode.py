"""The port's LD encode on the CPU against vc2tpu, integer == throughout:
the plain rate control ``ld_rate_control_plain`` against
``vc2tpu.rdo.ld.ld_rate_control`` (XLA on the CPU) and the JAX package's
native scan, over slice grids, wavelets, depths, budgets no q meets and
codes over 32 bits; the plain pack ``pack_ld_plain`` against
``vc2tpu.vlc.device_pack.pack_ld_payload`` (or, where its flags ask for
the host, ``vc2tpu.slices.ld.encode_ld_slices``); the pack kernel's work
split (``ld_group_size``, ``ld_chunks``) on ragged and tiny shapes and its
chunked sizing (``ld_chunk_sizes_plain``) against the whole-row sizing of
``pack_ld_plain``; the encoder's constants
both ways; ``LDEncoder(device="cpu")`` against ``vc2tpu.pipeline.ld
.LDEncoder``; and ``encode_stream.main`` with ``--device cpu`` on the four
LD goldens, the ``ld_legall_d2`` Quantised tap, the Decoded and PSNR
outputs, the 1080p LD fixture and an overflowing budget. The kernels
themselves are held against the plain versions by tests/test_torch_cuda.py
and ``chip_smoke.py`` (on the card)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vc2tpu._native.bridge import native
from vc2tpu.cli import encode_stream as j_cli
from vc2tpu.core import config as jcfg
from vc2tpu.core.intmath import intlog2
from vc2tpu.pipeline import ld as jld
from vc2tpu.quant import quantiser as jq
from vc2tpu.rdo import cbr as jcbr
from vc2tpu.rdo import ld as jrdo
from vc2tpu.slices import layout as jlayout
from vc2tpu.slices import ld as jslices
from vc2tpu.vlc import device_pack as jdp
from vc2tpu.wavelet import matrices as jm

from vc2tpu_torch.cli import encode_stream
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.pipeline import encoder as tenc
from vc2tpu_torch.pipeline.ld import LDEncoder
from vc2tpu_torch.rdo import ld as rdo_ld
from vc2tpu_torch.slices import ld as tslices
from vc2tpu_torch.vlc import device_pack
from vc2tpu_torch.vlc import golomb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TESTDATA = os.path.join(ROOT, "vc2tpu_torch", "testdata")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
LD = [c[0] for c in META["cases"] if c[0].startswith("ld")]
LD_TAPS = [tuple(t) for t in META["taps"] if t[0].startswith("ld")]

pytestmark = pytest.mark.skipif(native is None,
                                reason="the JAX package's native codec, "
                                       "its LD oracle, is unavailable")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- the rate control against vc2tpu.rdo.ld ----------------------------------

K = jcfg.WaveletKernel
# name: (seed, depth, kernel, H, W, CH, CW, ys, xs, budget lo, hi, magnitude)
_RC = {
    "legall_d2_4x6": (1, 2, K.LeGall, 32, 48, 32, 24, 4, 6, 8, 60, 900),
    "dd137_d3_2x4": (3, 3, K.DD137, 32, 64, 32, 32, 2, 4, 20, 200, 2000),
    "haar1_d2_single_row": (9, 2, K.Haar1, 8, 80, 8, 40, 1, 10, 8, 64, 800),
    # budgets generous enough for low q: body codes over 32 bits
    "legall_d1_codes_over_32_bits": (13, 1, K.LeGall, 16, 32, 16, 16, 4, 4,
                                     500, 700, 200_000),
}
# against the native scan only (no XLA compile): degenerate grids, every
# other wavelet, budgets no q meets, large coefficients. The native scan
# shifts |v| << 2 in int32, so an LL difference stays below 2^29 (the
# quantiser's exact domain): a coefficient below 2^27, or an LL band of
# zeros (the last flag) where the body holds coefficients to 2^28
_RC_NATIVE = {
    "single_slice_haar0": (7, 1, K.Haar0, 8, 8, 8, 4, 1, 1, 6, 50, 700),
    "single_column": (12, 2, K.LeGall, 80, 8, 80, 4, 10, 1, 8, 64, 800),
    "rows_ne_cols_dd97": (8, 2, K.DD97, 40, 40, 40, 20, 5, 5, 7, 70, 22_000),
    "fidelity_420": (6, 2, K.Fidelity, 32, 32, 16, 16, 2, 2, 10, 90, 1200),
    "daub97_444": (5, 2, K.Daub97, 16, 48, 16, 48, 2, 6, 30, 300, 100),
    # codes non-zero even at q 127, 2-byte budgets (5 bits)
    "no_q_fits": (4, 2, K.LeGall, 24, 24, 24, 24, 3, 3, 2, 3,
                  (1 << 28) - 1, True),
    "large_coefficients": (14, 2, K.Haar1, 16, 32, 16, 16, 2, 4, 30, 400,
                           (1 << 27) - 1),
}


def _rc_inputs(seed, depth, kernel, H, W, CH, CW, ys, xs, lo, hi, mag,
               ll_zero=False):
    """Seeded transform planes and budgets (every third seed: half the
    luma and all of U zero), as tests/test_ld_device_rdo.py makes them,
    with ``ll_zero`` the LL sub-lattice zero; the native scan's result;
    the lanes and arguments of both rate controls."""
    rng = np.random.default_rng(seed)
    sh, sw, csh, csw = H // ys, W // xs, CH // ys, CW // xs
    ts = 1 << depth
    qmatrix = jm.quant_matrix(kernel, depth)
    n = ys * xs
    ty = rng.integers(-mag, mag, (H, W)).astype(np.int32)
    tu = rng.integers(-mag // 2 - 1, mag // 2 + 1, (CH, CW)).astype(np.int32)
    tv = rng.integers(-mag // 2 - 1, mag // 2 + 1, (CH, CW)).astype(np.int32)
    if seed % 3 == 0:
        ty[:H // 2] = 0
        tu[:] = 0
    if ll_zero:
        for p in (ty, tu, tv):
            p[::ts, ::ts] = 0
    budgets = rng.integers(lo, hi, n).astype(np.int32)
    perm_y, band_y = jlayout.lane_order(sh, sw, depth)
    perm_c, band_c = jlayout.lane_order(csh, csw, depth)
    ly, lc = sh * sw, csh * csw
    ref = (np.zeros(n, np.int32), np.empty((n, ly), np.int32),
           np.empty((n, lc), np.int32), np.empty((n, lc), np.int32))
    native.ld_encode(ty, tu, tv, (H, W, CH, CW), (ys, xs), ts,
                     jld._qm_block(sh, sw, depth, qmatrix),
                     jld._qm_block(csh, csw, depth, qmatrix), perm_y, perm_c,
                     budgets, ref[0], ref[1].ravel(), ref[2].ravel(),
                     ref[3].ravel())

    def lanes(plane, perm, h, w):
        blocks = plane.reshape(plane.shape[0] // h, h, -1, w)
        return np.ascontiguousarray(blocks.transpose(0, 2, 1, 3).reshape(
            -1, h * w)[:, perm])

    nb = 3 * depth + 1
    args = dict(
        lanes=(lanes(ty, perm_y, sh, sw), lanes(tu, perm_c, csh, csw),
               lanes(tv, perm_c, csh, csw)),
        qm=qmatrix.astype(np.int32),
        bs_y=tuple(int(c) for c in np.bincount(band_y, minlength=nb)),
        bs_c=tuple(int(c) for c in np.bincount(band_c, minlength=nb)),
        avail=jrdo.avail_bits_np(tuple(int(b) for b in budgets)),
        grid=(ys, xs), ll_y=(sh // ts, sw // ts), ll_c=(csh // ts, csw // ts))
    return ref, args, budgets


def _port_rc(a):
    return rdo_ld.ld_rate_control(
        *(_t(x) for x in a["lanes"]), a["qm"], a["bs_y"], a["bs_c"],
        _t(a["avail"]), a["grid"], a["ll_y"], a["ll_c"])


def _same_rc(got, ref, a):
    nly, nlc = a["ll_y"][0] * a["ll_y"][1], a["ll_c"][0] * a["ll_c"][1]
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    for g, r, k in zip(got[1:], ref[1:], (nly, nlc, nlc)):
        np.testing.assert_array_equal(g.numpy(), r[:, :k])


_JIT_RC = jax.jit(jrdo.ld_rate_control,
                  static_argnames=("bs_y", "bs_c", "grid_shape",
                                   "ll_y_shape", "ll_c_shape"))


@pytest.mark.parametrize("case", list(_RC))
def test_ld_rate_control_plain_matches_vc2tpu(case):
    """q and the three LL lane sets, integer ==, against the JAX package's
    wavefront on XLA's CPU and against its native raster scan."""
    ref, a, _ = _rc_inputs(*_RC[case])
    got = _port_rc(a)
    want = _JIT_RC(*(jnp.asarray(x) for x in a["lanes"]), a["qm"],
                   a["bs_y"], a["bs_c"], jnp.asarray(a["avail"]),
                   grid_shape=a["grid"], ll_y_shape=a["ll_y"],
                   ll_c_shape=a["ll_c"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _same_rc(got, ref, a)
    if case == "legall_d1_codes_over_32_bits":
        assert int(got[0].min()) < 8 and a["lanes"][0].max() > 1 << 16


@pytest.mark.parametrize("case", list(_RC_NATIVE))
def test_ld_rate_control_plain_matches_the_native_scan(case):
    ref, a, _ = _rc_inputs(*_RC_NATIVE[case])
    got = _port_rc(a)
    _same_rc(got, ref, a)
    if case == "no_q_fits":              # most slices keep best = 127
        assert int((got[0] == 127).sum()) > got[0].numel() // 2


def test_ld_rate_control_all_zero_bodies():
    """Every lane zero but the LL band: the count is the LL band's alone."""
    ref, a, _ = _rc_inputs(*_RC["legall_d2_4x6"])
    nly, nlc = a["ll_y"][0] * a["ll_y"][1], a["ll_c"][0] * a["ll_c"][1]
    lanes = [x.copy() for x in a["lanes"]]
    for x, k in zip(lanes, (nly, nlc, nlc)):
        x[:, k:] = 0
    want = _JIT_RC(*(jnp.asarray(x) for x in lanes), a["qm"], a["bs_y"],
                   a["bs_c"], jnp.asarray(a["avail"]), grid_shape=a["grid"],
                   ll_y_shape=a["ll_y"], ll_c_shape=a["ll_c"])
    a["lanes"] = lanes
    for g, w in zip(_port_rc(a), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_body_entries(a, trial):
    """The JAX package's body sizing at one trial for every slice: its
    ``_body_nb`` and ``_trunc_count_1`` / ``_trunc_count_2`` (truncated
    count where a body code is non-zero, else 0), luma and chroma."""
    n = a["lanes"][0].shape[0]
    absqf, blq, qfn, *_ = jrdo._tables_at(jnp.full((n,), trial, jnp.int32),
                                          jnp.asarray(a["qm"]))
    out = []
    for parts, bs in (((a["lanes"][0],), a["bs_y"]),
                      ((a["lanes"][1], a["lanes"][2]), a["bs_c"])):
        tabs = tuple(jq.expand_bands(x[:, 1:], tuple(bs[1:]))
                     for x in (absqf, blq, qfn))
        nbs = [jrdo._body_nb(jcbr._magnitude_forms(jnp.asarray(
            x[:, bs[0]:])), *tabs) for x in parts]
        count, any_nz = (jrdo._trunc_count_1(*nbs[0]) if len(nbs) == 1
                         else jrdo._trunc_count_2(*nbs[0], *nbs[1]))
        out.append(np.where(np.asarray(any_nz), np.asarray(count), 0))
    return out


@pytest.mark.parametrize("case", list(_RC) + list(_RC_NATIVE))
def test_body_table_plain_matches_vc2tpu(case):
    """The body table at every trial 0-126 against the JAX package's body
    sizing (``_body_nb``, ``_trunc_count_1/2``), integer ==; column 127 is
    0."""
    spec = _RC[case] if case in _RC else _RC_NATIVE[case]
    _ref, a, _ = _rc_inputs(*spec)
    got = rdo_ld.body_table_plain(*(_t(x) for x in a["lanes"]), a["qm"],
                                  a["bs_y"], a["bs_c"]).numpy()
    assert got.shape == (a["lanes"][0].shape[0], 2, rdo_ld.TRIALS)
    for trial in range(rdo_ld.TRIALS - 1):
        want_y, want_c = _jax_body_entries(a, trial)
        np.testing.assert_array_equal(got[:, 0, trial], want_y, str(trial))
        np.testing.assert_array_equal(got[:, 1, trial], want_c, str(trial))
    assert not got[:, :, rdo_ld.TRIALS - 1].any()


def _body_table_brute(lanes, qm, bs_y, bs_c):
    """Every body lane quantised with the port's ``quant`` at every trial,
    its truncated count (chroma interleaved), 0 where no body code is
    non-zero: the body table with no shortcut."""
    from vc2tpu_torch.quant import quantiser as tq

    n = lanes[0].shape[0]
    out = np.zeros((n, 2, rdo_ld.TRIALS), np.int64)
    for c, (parts, bs) in enumerate((((lanes[0],), bs_y),
                                     ((lanes[1], lanes[2]), bs_c))):
        qm_body = torch.from_numpy(rdo_ld.lane_qm(qm, bs)[bs[0]:]
                                   .astype(np.int64))
        for trial in range(rdo_ld.TRIALS - 1):
            aq = (trial - qm_body).clamp(0, 119)[None, :]
            codes = [tq.quant(_t(x[:, bs[0]:]), aq) for x in parts]
            row = codes[0] if c == 0 else golomb.interleave(*codes)
            out[:, c, trial] = golomb.truncated_bits(row).numpy()
    return out


@pytest.mark.parametrize("case", ["full_range", "zero_then_wrapped",
                                  "mixed"])
def test_body_table_plain_over_the_int32_range(case):
    """Values up to +-(2^31 - 1) and INT_MIN, at trials that reach every
    index 0-119 (quant matrix entries 0-7): the body table against every
    lane quantised at every trial. ``zero_then_wrapped``: lanes that are 0
    by index 115 and non-zero again at the wrapped factors (116-119), so
    the shortcut that skips the all-zero trials (112-115 here) must stop
    at them."""
    rng = np.random.default_rng(2042 + len(case))
    n, ly, lc = 40, 20, 10
    if case == "full_range":
        lanes = [rng.integers(-(1 << 31), 1 << 31, (n, k)) for k in (ly, lc,
                                                                    lc)]
        lanes[0][0, 4] = -(1 << 31)
    elif case == "zero_then_wrapped":      # 4|v| in [683344693, 8e8]
        lanes = [rng.integers(171_000_000, 200_000_000, (n, k))
                 * rng.choice([-1, 1], (n, k)) for k in (ly, lc, lc)]
    else:
        lanes = [np.where(rng.random((n, k)) < 0.1,
                          rng.integers(-(1 << 31), 1 << 31, (n, k)),
                          rng.integers(-300, 300, (n, k)))
                 for k in (ly, lc, lc)]
    lanes = [x.astype(np.int32) for x in lanes]
    qm = rng.integers(0, 8, 4).astype(np.int32)
    if case == "zero_then_wrapped":       # index = trial
        qm[:] = 0
    bs_y, bs_c = (4, 6, 6, 4), (2, 3, 3, 2)
    got = rdo_ld.body_table_plain(*(_t(x) for x in lanes), qm, bs_y,
                                  bs_c).numpy()
    np.testing.assert_array_equal(got, _body_table_brute(lanes, qm, bs_y,
                                                         bs_c))
    if case == "zero_then_wrapped":       # 0 from 111, non-zero at 119
        assert not got[:, :, 111:119].any() and got[:, :, 119:127].all()


def _bisect_sequential(fits_at):
    """The reference's loop (EncodeStream.cpp:203-223): delta 64, halved
    before each probe; the probe at trialQ; bestQ the least trialQ that
    fits; trialQ down by delta where it fits, else up; until delta is 0."""
    trial, best, delta = 63, 127, 64
    while True:
        delta >>= 1
        if fits_at(trial):
            best = min(best, trial)
            trial -= delta
        else:
            trial += delta
        if delta == 0:
            return best


def _walk_masks():
    """127-trial fits masks: seeded random ones at several densities; every
    one of the 2^7 outcomes of the 7 probes, the probed trials set to that
    outcome over a random rest; all, none, and every threshold either
    way."""
    rng = np.random.default_rng(7)
    masks = [rng.random(127) < p for p in (0.1, 0.5, 0.9)
             for _ in range(200)]
    for outcome in range(128):
        for _ in range(3):
            m = rng.random(127) < 0.5
            trial = 63
            for k, delta in enumerate(rdo_ld.PROBES):
                m[trial] = bool(outcome >> k & 1)
                trial += -delta if m[trial] else delta
            masks.append(m)
    masks += [np.ones(127, bool), np.zeros(127, bool)]
    for k in range(128):
        masks += [np.arange(127) >= k, np.arange(127) < k]
    return np.stack(masks)


def test_walk_fits_matches_the_sequential_bisection():
    """``walk_fits`` on a mask picks what the reference's sequential
    bisection picks, for monotone and non-monotone masks alike; a 128th
    column (trial 127, never probed) changes nothing."""
    masks = _walk_masks()
    want = [_bisect_sequential(lambda t, m=m: bool(m[t])) for m in masks]
    got = rdo_ld.walk_fits(torch.from_numpy(masks))
    assert got.tolist() == want
    padded = np.concatenate([masks, np.ones((len(masks), 1), bool)], 1)
    assert rdo_ld.walk_fits(torch.from_numpy(padded)).tolist() == want
    assert set(want) >= {0, 126, 127}


def test_avail_bits_match_vc2tpu():
    budgets = np.concatenate([np.arange(1, 300), [829440 // 32400, 4096,
                                                  1 << 20]])
    np.testing.assert_array_equal(
        rdo_ld.avail_bits(budgets),
        jrdo.avail_bits_np(tuple(int(b) for b in budgets)))


def test_ld_rate_control_refuses_bad_inputs():
    _ref, a, _ = _rc_inputs(*_RC["legall_d2_4x6"])
    lanes = [_t(x) for x in a["lanes"]]
    rest = (a["qm"], a["bs_y"], a["bs_c"], _t(a["avail"]))
    with pytest.raises(ValueError, match="grid"):
        rdo_ld.ld_rate_control(*lanes, *rest, (5, 6), a["ll_y"], a["ll_c"])
    with pytest.raises(ValueError, match="LL block"):
        rdo_ld.ld_rate_control(*lanes, *rest, a["grid"], (3, 3), a["ll_c"])
    with pytest.raises(ValueError, match="int32"):
        rdo_ld.ld_rate_control(lanes[0].long(), *lanes[1:], *rest, a["grid"],
                               a["ll_y"], a["ll_c"])
    with pytest.raises(ValueError, match="avail"):
        rdo_ld.ld_rate_control(*lanes, *rest[:3], _t(a["avail"][:-1]),
                               a["grid"], a["ll_y"], a["ll_c"])


def _header_values(text, name):
    m = re.search(rf"#define {name} (.*)", text)
    return [int(x.rstrip("ul"), 0) for x in m.group(1).split(", ")]


def test_ld_kernel_headers_match_vc2tpu_tables():
    """The factors, offsets and reciprocals compiled into csrc/ld_rate.cu
    and csrc/ld_pack.cu are the JAX package's tables."""
    recips = [-(-(1 << 64) // abs(int(f))) for f in jq.QUANT_FACTORS_I32]
    rate = rdo_ld.params_header()
    (_name, pack), = device_pack.ld_kernel_source().headers
    for text in (rate, pack):
        assert _header_values(text, "VC2_QUANT_FACTORS") == [
            int(f) for f in jq.QUANT_FACTORS_I32]
        assert _header_values(text, "VC2_QUANT_RECIPROCALS") == recips
    assert _header_values(rate, "VC2_QUANT_OFFSETS") == [
        int(o) for o in jq.QUANT_OFFSETS]
    assert _header_values(pack, "VC2_FLAG_LD_FIT") == [
        device_pack.FLAG_LD_FIT]


def test_rate_kernel_quotient_matches_quant():
    """The branch-free quotient of csrc/golomb_encode.cuh, modelled in
    Python: the high 64 bits of (|v| << 2) times ceil(2^64 / |factor|),
    less one where that times |factor| passes (|v| << 2), equal |quant(v,
    q)| at every q 0-119 over the int32 range (INT_MIN, |v| >= 2^30, the
    wrapped factors)."""
    from vc2tpu_torch.quant import quantiser as tq

    rng = np.random.default_rng(17)
    edge = [0, 1, -1, 3, 887, (1 << 29) - 1, -(1 << 29), (1 << 30) - 1,
            1 << 30, -(1 << 30) - 3, (1 << 31) - 1, -(1 << 31)]
    v = np.concatenate([edge, rng.integers(-(1 << 31), 1 << 31, 60)]
                       ).astype(np.int32)
    recips = device_pack.quant_reciprocals()
    vv = torch.from_numpy(np.broadcast_to(v, (120, v.size)).copy())
    qq = torch.from_numpy(np.broadcast_to(np.arange(120)[:, None],
                                          vv.shape).copy())
    want = tq.quant(vv, qq).to(torch.int64).abs().numpy()
    for q in range(120):
        af = abs(int(tq.QUANT_FACTORS_I32[q]))
        for j, x in enumerate(v.tolist()):
            n = abs(x) << 2
            est = (n * recips[q]) >> 64
            got = est - (1 if est * af > n else 0)
            assert got == want[q, j] % (1 << 32), (q, x)


# --- the pack against vc2tpu.vlc.device_pack ---------------------------------

def _pack_lanes(seed, n, ly, lc, span, zero_frac):
    rng = np.random.default_rng(seed)
    out = []
    for length, s in ((ly, span), (lc, span // 2), (lc, span // 2)):
        v = rng.integers(-s, s + 1, (n, length))
        v[rng.random((n, length)) < zero_frac] = 0
        out.append(v.astype(np.int32))
    out[0][::7] = 0
    out[1][::5] = 0
    out[2][::5] = 0
    return out, rng.integers(0, 128, n).astype(np.int32), rng


def _fitting_sizes(lanes, rng, slack):
    """Budgets each slice fits, with 0 to ``slack`` spare bytes."""
    need = (golomb.truncated_bits(_t(lanes[0]))
            + golomb.truncated_bits(golomb.interleave(_t(lanes[1]),
                                                      _t(lanes[2])))).numpy()
    return ((need + 7 + 24) // 8
            + rng.integers(0, slack + 1, need.size)).astype(np.int32)


# name: (seed, slices, luma lanes, chroma lanes, span, zero share, slack,
# sizes cut to force the U/V fit error)
_PACK = {
    "fits": (1, 300, 16, 8, 40, 0.5, 3, False),
    "fits_wide_slices": (2, 120, 64, 32, 3000, 0.5, 2, False),
    "codes_over_32_bits": (3, 100, 16, 8, 1 << 20, 0.5, 3, False),
    "all_zero_slices": (4, 64, 16, 8, 0, 0.0, 1, False),
    "uv_does_not_fit": (5, 80, 16, 8, 40, 0.5, 0, True),
}


@pytest.mark.parametrize("case", list(_PACK))
def test_pack_ld_plain_matches_vc2tpu(case):
    """Bytes and the U/V fit flag against the JAX device pack; where its
    flags send the picture to the host packer (codes over 32 bits), the
    bytes against ``encode_ld_slices``."""
    seed, n, ly, lc, span, zeros, slack, cut = _PACK[case]
    lanes, q, rng = _pack_lanes(seed, n, ly, lc, span, zeros)
    sizes = _fitting_sizes(lanes, rng, slack)
    if cut:
        sizes[::9] = np.maximum(sizes[::9] - 3, 2)
    flags, payload = device_pack.ld_result(
        device_pack.pack_ld_plain(*(_t(x) for x in lanes), _t(q), _t(sizes)))
    len_bits = np.array([intlog2(int(8 * s - 7)) for s in sizes], np.int32)
    buf = np.asarray(jdp.pack_ld_payload(
        *(jnp.asarray(x) for x in lanes), jnp.asarray(q), jnp.asarray(sizes),
        jnp.asarray(len_bits), w32=int(sizes.max()) // 4 + 2,
        cap_bytes=int(sizes.sum())))
    jflags, jq_idx, jpayload = jdp.unpack_ld_result(buf, n)
    np.testing.assert_array_equal(jq_idx, q)
    assert bool(flags & device_pack.FLAG_LD_FIT) == bool(
        jflags & jdp.FLAG_LD_FIT) == cut
    assert flags in (0, device_pack.FLAG_LD_FIT)
    if cut:
        return
    if jflags & jdp.FLAG_CODE_OVERFLOW:
        assert case == "codes_over_32_bits"
        host, _ = jslices.encode_ld_slices(q, *lanes, sizes)
        assert payload.tobytes() == host
    else:
        assert jflags == 0
        assert payload.tobytes() == jpayload.tobytes()


@pytest.mark.parametrize("case", ["fits", "uv_does_not_fit"])
def test_encode_ld_slices_matches_vc2tpu(case):
    seed, n, ly, lc, span, zeros, slack, cut = _PACK[case]
    lanes, q, rng = _pack_lanes(seed, n, ly, lc, span, zeros)
    sizes = _fitting_sizes(lanes, rng, slack)
    if cut:
        sizes[::9] = np.maximum(sizes[::9] - 3, 2)
        with pytest.raises(ValueError) as want:
            jslices.encode_ld_slices(q, *lanes, sizes)
        with pytest.raises(ValueError) as got:
            tslices.encode_ld_slices(q, *lanes, sizes)
        assert str(got.value) == str(want.value)
        return
    got, got_sizes = tslices.encode_ld_slices(q, *lanes, sizes)
    want, want_sizes = jslices.encode_ld_slices(q, *lanes, sizes)
    assert got == want
    np.testing.assert_array_equal(got_sizes, want_sizes)


@pytest.mark.parametrize("ly,lc", [(64, 32), (16, 8), (4, 2), (3, 1),
                                   (1, 0), (0, 0), (20, 10), (63, 31),
                                   (96, 48), (1000, 500)])
def test_ld_group_size_on_ragged_and_tiny_shapes(ly, lc):
    """The fewest threads a slice (4-32, a power of two) whose chunks hold
    at most LD_HOLD lanes, else 32; the chunks tile each component's lanes
    in order, none longer than ceil(L / g)."""
    g = device_pack.ld_group_size(ly, lc)

    def fits(k):
        return -(-ly // k) + 2 * -(-lc // k) <= device_pack.LD_HOLD

    assert g in (4, 8, 16, 32)
    assert fits(g) or g == 32
    assert g == 4 or not fits(g // 2)
    for length in (ly, lc):
        chunks = device_pack.ld_chunks(length, g)
        assert len(chunks) == g
        assert chunks[0][0] == 0 and chunks[-1][1] == length
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(0 <= hi - lo <= -(-length // g) for lo, hi in chunks)


@pytest.mark.parametrize("g", [4, 8, 32])
@pytest.mark.parametrize("case", list(_PACK))
def test_ld_chunk_sizes_plain_match_pack_ld_plain(case, g):
    """The pack kernel's sizing by chunks (each chunk's bits, the exclusive
    scan over the group, the max of the bits up to the last non-zero code)
    against the whole-row sizing that ``pack_ld_plain`` derives: y_used,
    uv_used, each chunk's first bit in its region, and the U/V fit flag."""
    seed, n, ly, lc, span, zeros, slack, cut = _PACK[case]
    lanes, q, rng = _pack_lanes(seed, n, ly, lc, span, zeros)
    sizes = _fitting_sizes(lanes, rng, slack)
    if cut:
        sizes[::9] = np.maximum(sizes[::9] - 3, 2)
    qy, qu, qv = (_t(x) for x in lanes)
    uv = golomb.interleave(qu, qv)
    y_before, uv_before, y_used, uv_used = device_pack.ld_chunk_sizes_plain(
        qy, qu, qv, g)
    assert torch.equal(y_used, golomb.truncated_bits(qy))
    assert torch.equal(uv_used, golomb.truncated_bits(uv))
    for rows, before, length, step in ((qy, y_before, ly, 1),
                                       (uv, uv_before, lc, 2)):
        nb = golomb._code_bits(rows)
        first = torch.cat([torch.zeros((n, 1), dtype=torch.int64),
                           torch.cumsum(nb, 1)], 1)
        for t, (lo, _hi) in enumerate(device_pack.ld_chunks(length, g)):
            assert torch.equal(before[:, t], first[:, step * lo])
    len_bits = tslices.len_bits_of(sizes.astype(np.int64))
    uv_bits = 8 * sizes.astype(np.int64) - 7 - len_bits - y_used.numpy()
    flags, _ = device_pack.ld_result(
        device_pack.pack_ld_plain(qy, qu, qv, _t(q), _t(sizes)))
    assert bool((uv_used.numpy() > uv_bits).any()) == bool(
        flags & device_pack.FLAG_LD_FIT) == cut


def test_quant_pack_ld_plain_quantises_the_body():
    """The fused plain route: the LL lanes taken as given, every other lane
    quantised at max(q - qm, 0), then the plain pack."""
    lanes, q, rng = _pack_lanes(6, 50, 16, 8, 5000, 0.3)
    qm_y = rng.integers(0, 10, 16).astype(np.int32)
    qm_c = rng.integers(0, 10, 8).astype(np.int32)
    ll = [rng.integers(-9, 10, (50, k)).astype(np.int32) for k in (4, 2, 2)]
    qlanes = []
    for x, l, qm in zip(lanes, ll, (qm_y, qm_c, qm_c)):
        k = l.shape[1]
        aq = np.clip(q[:, None] - qm[None, k:], 0, 119)
        body = np.asarray(jq.quant(jnp.asarray(x[:, k:]), jnp.asarray(aq)))
        qlanes.append(np.concatenate([l, body], 1))
    sizes = _fitting_sizes(qlanes, rng, 2)
    buf, kept = device_pack.quant_pack_ld(
        *(_t(x) for x in lanes), [_t(x) for x in ll], _t(q), _t(qm_y),
        _t(qm_c), _t(sizes), keep_lanes=True)
    for k, w in zip(kept, qlanes):
        np.testing.assert_array_equal(k.numpy(), w)
    want = device_pack.pack_ld_plain(*(_t(x) for x in qlanes), _t(q),
                                     _t(sizes))
    assert torch.equal(buf, want)


def test_dequantise_ll_native_matches_plain():
    """The LL DC-prediction inverse of csrc/ld_scan.cpp against its Python
    twin, on seeded codes over a 4 x 6 slice grid."""
    rng = np.random.default_rng(21)
    ys, xs, ts, sh, sw = 4, 6, 4, 8, 8
    grid = rng.integers(-3000, 3000, (ys * sh // ts, xs * sw // ts))
    grid = grid.astype(np.int32)
    grid[0, 0] = np.iinfo(np.int32).min
    qm_blk = rng.integers(0, 6, sh * sw).astype(np.int32)
    q = rng.integers(0, 128, ys * xs).astype(np.int32)
    np.testing.assert_array_equal(
        tslices.dequantise_ll(grid, ys, xs, ts, sh, sw, qm_blk, q),
        tslices.dequantise_ll_plain(grid, ys, xs, ts, sh, sw, qm_blk, q))


# --- the encoder --------------------------------------------------------------

def _configs(interlaced=False, kernel="LeGall", depth=2, size=(64, 32),
             nbytes=2000):
    kw = dict(height=size[1], width=size[0], wavelet_depth=depth, y_size=1,
              x_size=2, luma_depth=10, chroma_depth=10,
              compressed_bytes=nbytes, interlaced=interlaced)
    tc = tcfg.EncoderConfig(chroma_format=tcfg.ColourFormat.CF422,
                            kernel=tcfg.WaveletKernel[kernel],
                            mode=tcfg.Mode.LD, **kw)
    jc = jcfg.EncoderConfig(chroma_format=jcfg.ColourFormat.CF422,
                            kernel=jcfg.WaveletKernel[kernel],
                            mode=jcfg.Mode.LD, **kw)
    return tc, jc


@pytest.mark.parametrize("interlaced", [False, True],
                         ids=["progressive", "interlaced"])
def test_encoder_constants_match_vc2tpu(interlaced):
    tc, jc = _configs(interlaced, "DD97", 3, (128, 64), 6000)
    got = LDEncoder(tc, device="cpu")
    want = jld.LDEncoder(jc)
    np.testing.assert_array_equal(got.qmatrix, want.qmatrix)
    np.testing.assert_array_equal(got.qm_block_y, want.qm_block_y)
    np.testing.assert_array_equal(got.qm_block_c, want.qm_block_c)
    assert got.band_sizes_y == want.band_sizes_y
    assert got.band_sizes_c == want.band_sizes_c
    assert got.picture_bytes == want.picture_bytes
    np.testing.assert_array_equal(got.slice_budgets, want.slice_budgets)
    np.testing.assert_array_equal(got.avail, want._avail_np)
    np.testing.assert_array_equal(got.len_bits, want._len_bits_np)
    assert got.payload_bytes == want._cap_ld
    np.testing.assert_array_equal(got.qm[0].numpy(),
                                  want.qmatrix[jlayout.lane_order(
                                      *want.geo.luma_slice, 3)[1]])


def _pictures(tc, jc, seed):
    rng = np.random.default_rng(seed)
    h, w = tc.height, tc.width
    planes = [rng.integers(-512, 512, (h, w)).astype(np.int32),
              rng.integers(-512, 512, (h, w // 2)).astype(np.int32),
              rng.integers(-512, 512, (h, w // 2)).astype(np.int32)]
    from vc2tpu.core.picture import Picture as JPicture
    from vc2tpu_torch.core.picture import Picture as TPicture

    return (TPicture(*planes, tcfg.ColourFormat.CF422),
            JPicture(*planes, jcfg.ColourFormat.CF422))


@pytest.mark.parametrize("kernel,depth", [("LeGall", 2), ("Haar1", 1)])
def test_ld_encoder_matches_vc2tpu(kernel, depth, monkeypatch):
    """q, payload, slice totals, transform and quantised planes of one
    picture, against the JAX LDEncoder (its host route, which its tests
    hold byte-identical to its device route)."""
    monkeypatch.setenv("VC2TPU_ENCODE_ROUTE", "host")
    tc, jc = _configs(False, kernel, depth, (64, 32), 1500)
    tpic, jpic = _pictures(tc, jc, 3 + depth)
    got = LDEncoder(tc, device="cpu").encode_picture(tpic, keep_planes=True)
    want = jld.LDEncoder(jc).encode_picture(jpic, keep_planes=True)
    np.testing.assert_array_equal(got.q_indices, want.q_indices)
    assert got.payload == want.payload
    np.testing.assert_array_equal(np.asarray(got.slice_totals),
                                  np.asarray(want.slice_totals))
    for k in ("y", "c1", "c2"):
        np.testing.assert_array_equal(getattr(got.transform, k).numpy(),
                                      np.asarray(getattr(want.transform, k)))
        np.testing.assert_array_equal(getattr(got.quantised, k).numpy(),
                                      np.asarray(getattr(want.quantised, k)))


def test_encoders_refuse_the_other_mode():
    tc, _jc = _configs()
    with pytest.raises(ValueError, match="LDEncoder"):
        tenc.Encoder(tc, device="cpu")
    import dataclasses

    hq = dataclasses.replace(tc, mode=tcfg.Mode.HQ_ConstQ, q_index=20,
                             compressed_bytes=0)
    with pytest.raises(ValueError, match="Mode.LD"):
        LDEncoder(hq, device="cpu")


# --- the encode CLI -----------------------------------------------------------

def _golden_argv(case):
    _, inp, extra = next(c for c in META["cases"] if c[0] == case)
    m = META["inputs"][inp]
    argv = ["-x", str(m["width"]), "-y", str(m["height"]), "-f", m["fmt"],
            "-l", str(m["depth"]), "-n", "2", *extra]
    return argv, os.path.join(GOLDEN, f"{inp}.16p2")


def _encode(argv, src, tmp_path):
    out = str(tmp_path / "out.bin")
    assert encode_stream.main(argv + ["--device", "cpu", src, out]) == 0
    return _read(out)


@pytest.mark.parametrize("case", LD)
def test_ld_golden_byte_identical(case, tmp_path):
    argv, src = _golden_argv(case)
    assert _encode(argv, src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.vc2"))


@pytest.mark.parametrize("case,tap", LD_TAPS,
                         ids=[f"{c}-{t}" for c, t in LD_TAPS])
def test_ld_tap_byte_identical(case, tap, tmp_path):
    argv, src = _golden_argv(case)
    assert _encode(argv + ["-o", tap], src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.{tap.lower()}.raw"))


def _jax_encode(argv, src, out, monkeypatch):
    monkeypatch.setenv("VC2TPU_ENCODE_ROUTE", "host")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = j_cli.main(argv + [src, out])
    return rc, said.getvalue()


@pytest.mark.parametrize("case,output", [
    (c, o) for c in ("ld_legall_d2", "ld_interlaced")
    for o in ("Decoded", "PSNR")])
def test_ld_decoded_and_psnr_match_vc2tpu(case, output, tmp_path,
                                          monkeypatch):
    """The encoder's in-process decode (the LL band's DC-prediction inverse
    and the deliberate interlaced deviation included) against the JAX
    CLI's."""
    argv, src = _golden_argv(case)
    argv += ["-o", output]
    want_path = str(tmp_path / "want.bin")
    rc, _ = _jax_encode(argv, src, want_path, monkeypatch)
    assert rc == 0
    assert _encode(argv, src, tmp_path) == _read(want_path)


def test_overflowing_budget_fails_like_vc2tpu(tmp_path, monkeypatch):
    """A budget no q meets: the same exit code and message as the JAX CLI
    ("SliceIO, LD mode: Too many bytes for the U and V slices")."""
    argv, src = _golden_argv("ld_legall_d2")
    argv[argv.index("-s") + 1] = "40"
    want_rc, want_said = _jax_encode(argv, src, str(tmp_path / "j.vc2"),
                                     monkeypatch)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        got_rc = encode_stream.main(argv + ["--device", "cpu", src,
                                            str(tmp_path / "t.vc2")])
    assert got_rc == want_rc == 1
    assert said.getvalue() == want_said
    assert "Too many bytes for the U and V slices" in want_said


def test_ld_1080p_fixture(tmp_path):
    """The 1080p LD fixture, made by the JAX package's encoder from the
    same seeded input: 32 400 slices of 25 or 26 bytes, on the CPU."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_1080p", os.path.join(TESTDATA, "make_1080p.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    src = str(tmp_path / "hd.16p2")
    make.make_input(src)
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        cmd = json.load(f)["streams"]["ld_1080p"]["encode"]
    argv = cmd[cmd.index("vc2tpu.cli.encode_stream") + 1:-2]
    assert _encode(argv, src, tmp_path) == _read(
        os.path.join(TESTDATA, "ld_1080p.vc2"))


def test_ld_verbose_narrates_the_rate_control(tmp_path, capsys):
    argv, src = _golden_argv("ld_legall_d2")
    _encode(argv + ["-v"], src, tmp_path)
    assert "Determine quantisation indices" in capsys.readouterr().err


def test_ld_q_indices_equal_the_indices_of_vc2tpu(tmp_path, monkeypatch):
    argv, src = _golden_argv("ld_legall_d2")
    argv += ["-o", "Indices"]
    want_path = str(tmp_path / "want.bin")
    assert _jax_encode(argv, src, want_path, monkeypatch)[0] == 0
    assert _encode(argv, src, tmp_path) == _read(want_path)
