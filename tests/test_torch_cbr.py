"""The port's HQ CBR encode on the CPU against vc2tpu: the plain rate
control ``cbr_quant_indices_plain`` against ``vc2tpu.rdo.cbr``'s
``cbr_quant_indices`` (integer ==) over slice shapes, scalars, budgets
from ``slice_bytes_map``, lanes up to +-(2^29 - 1), all-zero slices,
budgets no q meets and climbs longer than the JAX package's batched
prefix; the tables generated into ``hq_cbr_params.h`` against the JAX
package's arrays; the kernel's quotient and rescale arithmetic modelled in
Python; the encoder's error for a budget too small for any q; and the 6
HQ CBR goldens, the 2 CBR taps and the 1080p CBR fixture through
``encode_stream.main`` with ``--device cpu``, byte for byte. The kernel
itself is held against the plain version by tests/test_torch_cuda.py and
``chip_smoke.py`` (on the card)."""

import io
import json
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vc2tpu.core import config as jcfg
from vc2tpu.core import planario as jio
from vc2tpu.pipeline import encoder as jenc
from vc2tpu.quant import quantiser as jq
from vc2tpu.rdo import cbr as jcbr
from vc2tpu.slices import layout as jlayout
from vc2tpu.wavelet import matrices as jm

from vc2tpu_torch.cli import encode_stream
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.core import planario as tio
from vc2tpu_torch.pipeline import encoder as tenc
from vc2tpu_torch.quant import quantiser as tq
from vc2tpu_torch.rdo import cbr
from vc2tpu_torch.slices import layout
from vc2tpu_torch.vlc import device_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TESTDATA = os.path.join(ROOT, "vc2tpu_torch", "testdata")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
CBR = [c[0] for c in META["cases"] if c[0].startswith("cbr")]
CBR_TAPS = [tuple(t) for t in META["taps"] if t[0].startswith("cbr")]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# --- the rate control against vc2tpu.rdo.cbr ---------------------------------

def _slice_tables(kernel, depth, luma, chroma):
    """The quant matrix entry of each lane (the port's inputs) and the
    band sizes (the JAX package's) of one slice geometry."""
    qm = jm.quant_matrix(jcfg.WaveletKernel(int(kernel)), depth)
    out = []
    for sh, sw in (luma, chroma):
        _, band = jlayout.lane_order(sh, sw, depth)
        out.append((qm[band].astype(np.int32),
                    tuple(int(c) for c in np.bincount(band))))
    return qm.astype(np.int32), out


def _climb_slices(n_luma, n_chroma):
    """Lane 0 alone non-zero, at every magnitude 1-3999, budgets 5-8
    bytes: some of these slices climb 4 steps."""
    mags, budgets = np.meshgrid(np.arange(1, 4000), np.arange(5, 9),
                                indexing="ij")
    y = np.zeros((mags.size, n_luma), np.int32)
    y[:, 0] = mags.ravel() * np.where(np.arange(mags.size) % 2, -1, 1)
    chroma = np.zeros((mags.size, n_chroma), np.int32)
    return (y, chroma, chroma.copy()), budgets.ravel().astype(np.int32)


# name: (kernel, depth, luma slice, chroma slice, slices, span, zero
# fraction, scalar, bytes a slice)
_CASES = {
    "1080p_slices": (tcfg.WaveletKernel.LeGall, 2, (8, 8), (8, 4), 600,
                     1 << 12, 0.4, 1, 40),
    "1080p_slices_scalar2": (tcfg.WaveletKernel.LeGall, 2, (8, 8), (8, 4),
                             600, 1 << 12, 0.4, 2, 60),
    "lanes_to_2^29_scalar3": (tcfg.WaveletKernel.LeGall, 2, (8, 8), (8, 4),
                              400, (1 << 29) - 1, 0.3, 3, 400),
    "all_zero": (tcfg.WaveletKernel.LeGall, 2, (8, 8), (8, 4), 64, 0, 0.0,
                 1, 20),
    "no_q_fits": (tcfg.WaveletKernel.LeGall, 2, (8, 8), (8, 4), 64,
                  (1 << 29) - 1, 0.2, 1, 5),
    "dd97_depth1": (tcfg.WaveletKernel.DD97, 1, (4, 8), (4, 4), 300, 1 << 10,
                    0.5, 1, 24),
    "daub97_depth3_444": (tcfg.WaveletKernel.Daub97, 3, (8, 16), (8, 16),
                          80, 1 << 14, 0.5, 2, 300),
    "haar0_depth2_420": (tcfg.WaveletKernel.Haar0, 2, (8, 8), (4, 4), 200,
                         1 << 9, 0.6, 1, 16),
}


@pytest.mark.parametrize("case", list(_CASES) + ["climb_past_3"])
def test_cbr_plain_matches_vc2tpu(case):
    rng = np.random.default_rng(len(case))
    if case == "climb_past_3":
        kernel, depth, luma, chroma, scalar = (tcfg.WaveletKernel.LeGall, 2,
                                               (8, 8), (8, 4), 1)
        qm_bands, ((qm_y, bs_y), (qm_c, bs_c)) = _slice_tables(
            kernel, depth, luma, chroma)
        lanes, budgets = _climb_slices(qm_y.size, qm_c.size)
    else:
        (kernel, depth, luma, chroma, n, span, zero_frac, scalar,
         per) = _CASES[case]
        qm_bands, ((qm_y, bs_y), (qm_c, bs_c)) = _slice_tables(
            kernel, depth, luma, chroma)
        lanes = []
        for length in (qm_y.size, qm_c.size, qm_c.size):
            v = rng.integers(-span, span + 1, (n, length))
            v[rng.random((n, length)) < zero_frac] = 0
            lanes.append(v.astype(np.int32))
        if span:
            lanes[0][::5] = 0                  # all-zero luma in some slices
            lanes[0][1::7, 0] = span
        budgets = np.asarray(layout.slice_bytes_map(1, n, n * per, scalar)
                             ).ravel()
    want = np.asarray(jcbr.cbr_quant_indices(
        *(jnp.asarray(x) for x in lanes), jnp.asarray(qm_bands), bs_y, bs_c,
        jnp.asarray(budgets), scalar))
    t = [torch.from_numpy(np.array(x)) for x in (*lanes, qm_y, qm_c, budgets)]
    got = cbr.cbr_quant_indices_plain(*t, scalar)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    climb = got.to(torch.int64) - cbr.bisect_plain(*t, scalar)
    if case == "climb_past_3":
        assert int(climb.max()) > 3
    if case == "no_q_fits":
        assert (want == 127).all()
    if case == "all_zero":
        assert (want == 0).all()


def test_cbr_wrapper_sets_the_flag_above_119():
    """CPU lanes take the plain route; an index above 119 sets
    ``FLAG_QMAX`` in the flags word, which ``check_flags`` turns into the
    reference's error before any pack error."""
    lanes = [torch.full((4, n), 1 << 28, dtype=torch.int32) for n in
             (16, 8, 8)]
    qm = [torch.zeros(n, dtype=torch.int32) for n in (16, 8)]
    for per, want in ((5, device_pack.FLAG_QMAX), (200, 0)):
        flags = torch.zeros(1, dtype=torch.int64)
        budgets = torch.full((4,), per, dtype=torch.int32)
        q = cbr.cbr_quant_indices(*lanes, *qm, budgets, 1, flags=flags)
        assert int(flags) == want and bool((q > 119).any()) == bool(want)
    with pytest.raises(ValueError, match="exceeds maximum implemented"):
        device_pack.check_flags(device_pack.FLAG_QMAX
                                | device_pack.FLAG_CBR_FIT)


def test_cbr_wrapper_refuses_bad_inputs():
    y = torch.zeros((4, 16), dtype=torch.int32)
    u = torch.zeros((4, 8), dtype=torch.int32)
    qm = [torch.zeros(n, dtype=torch.int32) for n in (16, 8)]
    budgets = torch.full((4,), 20, dtype=torch.int32)
    with pytest.raises(ValueError, match="budgets"):
        cbr.cbr_quant_indices(y, u, u, *qm, budgets[:3], 1)
    with pytest.raises(ValueError, match="qm_c"):
        cbr.cbr_quant_indices(y, u, u, qm[0], qm[0], budgets, 1)
    with pytest.raises(ValueError, match="int32"):
        cbr.cbr_quant_indices(y.to(torch.int64), u, u, *qm, budgets, 1)


# --- the kernel's tables and arithmetic --------------------------------------

def _header_values(text, name):
    line = next(x for x in text.splitlines()
                if x.startswith(f"#define {name} "))
    return [int(v.rstrip("ul"), 0)
            for v in re.split(r",\s*", line.split(" ", 2)[2])]


def test_params_header_matches_vc2tpu_tables():
    """The factors, offsets and reciprocals compiled into csrc/hq_cbr.cu
    are the JAX package's tables."""
    text = cbr.params_header()
    factors = _header_values(text, "VC2_QUANT_FACTORS")
    offsets = _header_values(text, "VC2_QUANT_OFFSETS")
    recips = _header_values(text, "VC2_QUANT_RECIPROCALS")
    assert factors == [int(f) for f in jq.QUANT_FACTORS_I32]
    assert offsets == [int(o) for o in jq.QUANT_OFFSETS]
    assert recips == [-(-(1 << 64) // abs(int(f)))
                      for f in jq.QUANT_FACTORS_I32]
    assert _header_values(text, "VC2_CBR_MAX_Q") == [
        len(jq.QUANT_FACTORS_I32) - 1]
    assert _header_values(text, "VC2_FLAG_QMAX") == [device_pack.FLAG_QMAX]
    assert _header_values(text, "VC2_CBR_THREADS") == [cbr.THREADS]
    assert _header_values(text, "VC2_CBR_HOLD_Y") == [cbr.HOLD_Y]
    assert _header_values(text, "VC2_CBR_HOLD_C") == [cbr.HOLD_C]
    assert _header_values(text, "VC2_CBR_MIN_BLOCKS") == [cbr.MIN_BLOCKS]


# (luma lanes, chroma lanes): the group csrc/hq_cbr.cu takes them with
_GROUPS = {
    (64, 32): 16,       # 1080p 4:2:2 at -u 2 -a 2
    (32, 16): 8,        # the goldens' 4:2:2 slices
    (2, 1): 4,          # tiny: threads past the last lane hold none
    (8, 4): 4,
    (65, 33): 32,       # ragged: 5 luma lanes a thread at 16 is too many
    (64, 64): 32,       # 4:4:4
    (64, 16): 16,       # 4:2:0
    (100, 3): 32,
    (128, 64): 32,
    (129, 10): 0,       # too many for the registers: a warp, streamed
    (2048, 1024): 0,
}


@pytest.mark.parametrize("shape", list(_GROUPS), ids=str)
def test_group_plan_on_ragged_and_tiny_shapes(shape):
    """The group of each slice shape, and the kernel's split of it: thread r
    holds lanes [r k, min((r + 1) k, L)) of a component, k = ceil(L / g),
    so the runs cover every lane once and fit the registers."""
    ly, lc = shape
    g = cbr.group_plan(ly, lc)
    assert g == _GROUPS[shape]
    if not g:
        assert -(-ly // 32) > cbr.HOLD_Y or -(-lc // 32) > cbr.HOLD_C
        return
    for length, hold in ((ly, cbr.HOLD_Y), (lc, cbr.HOLD_C)):
        k = -(-length // g)
        runs = [range(r * k, min((r + 1) * k, length)) for r in range(g)]
        assert k <= hold and [j for run in runs for j in run] == list(
            range(length))
    if g > 4:      # the next smaller group would not fit
        h = g // 2
        assert -(-ly // h) > cbr.HOLD_Y or -(-lc // h) > cbr.HOLD_C


@pytest.mark.parametrize("shape", [(64, 32), (32, 16), (2, 1), (65, 33),
                                   (100, 3)], ids=str)
def test_group_split_sizes_like_the_plain_version(shape):
    """The kernel's sizing of a slice, modelled: each thread's code bits and
    last non-zero lane over its run, summed and maxed over the group (the
    two redux.sync a component), then the bytes; against
    ``slice_bytes_plain`` at every q of a seeded set, lanes up to
    +-(2^29 - 1) with a third zero."""
    ly, lc = shape
    g = cbr.group_plan(ly, lc)
    rng = np.random.default_rng(ly * 100 + lc)
    n, scalar = 50, 3
    lanes = []
    for length in (ly, lc, lc):
        v = rng.integers(-(1 << 29) + 1, 1 << 29, (n, length))
        v[rng.random(v.shape) < 0.3] = 0
        v[::7] = 0
        lanes.append(torch.from_numpy(v.astype(np.int32)))
    qm = [torch.from_numpy(rng.integers(0, 8, k).astype(np.int32))
          for k in (ly, lc)]
    for q in (0, 17, 40, 63, 95, 126):
        want = cbr.slice_bytes_plain(*lanes, *qm, torch.full((n,), q),
                                     scalar)
        total = 0
        for x, qmc in zip(lanes, (qm[0], qm[1], qm[1])):
            length = x.shape[1]
            k = -(-length // g)
            aq = tq.adjust_quant_index(torch.tensor(q), qmc.long()).clamp(
                max=119)
            r = tq.quant(x, aq[None, :]).long().abs()
            nb = torch.where(r == 0, 1, 2 * torch.frexp(
                (r + 1).double())[1].long())
            bits = sum(nb[:, i * k:(i + 1) * k].sum(1) for i in range(g))
            idx = torch.arange(length)
            last = torch.stack([
                torch.where(r[:, i * k:(i + 1) * k] != 0,
                            idx[i * k:(i + 1) * k], -1).amax(1)
                if i * k < length else torch.full((n,), -1)
                for i in range(g)]).amax(0)
            used = bits - (length - 1 - last)
            total = total + ((used + 7) // 8 + scalar - 1) // scalar * scalar
        assert torch.equal(total, want), q


_U32, _U64 = (1 << 32) - 1, (1 << 64) - 1


def _s32(x):
    x &= _U32
    return x - (1 << 32) if x >> 31 else x


def _kernel_quotient(v: int, q: int) -> int:
    """csrc/hq_cbr.cu's quotient(): (|v| << 2) times the reciprocal split
    into 32-bit halves (n * hi + umulhi(n, lo), then >> 32) below |v| =
    2^30, a 64-bit division above."""
    m = abs(v) & _U32
    if m < 1 << 30:
        n = m << 2
        rc = device_pack.quant_reciprocals()[q]
        hi, lo = rc >> 32, rc & _U32
        return (((n * hi) & _U64) + ((n * lo) >> 32)) >> 32
    return (m << 2) // abs(int(tq.QUANT_FACTORS_I32[q]))


def _kernel_rescale(x: int, q: int) -> int:
    """csrc/hq_cbr.cu's rescale(): scale with int32 wrap at every step."""
    f, o = int(tq.QUANT_FACTORS_I32[q]), int(tq.QUANT_OFFSETS[q])
    prod = _s32(abs(x) * (f & _U32))
    p = _s32(prod + (o if prod > 0 else 0) + 2)
    r = -(_s32(-p) >> 2) if p < 0 else p >> 2
    return _s32(-r) if x < 0 else _s32(r)


def test_kernel_arithmetic_matches_quant_and_scale():
    """The kernel's quotient and rescale at every q 0-119 over the whole
    int32 range (INT_MIN, |v| >= 2^30, the wrapped factors at 116-119),
    against the port's ``quant`` and ``scale``, and its error term d =
    v - scale(quant(v)) formed in int32 against ``luma_error_plain``."""
    rng = np.random.default_rng(13)
    edge = [0, 1, -1, 3, -5, 887, (1 << 29) - 1, -(1 << 29), (1 << 30) - 1,
            1 << 30, (1 << 31) - 1, -(1 << 31), -(1 << 31) + 1]
    v = np.concatenate([edge, rng.integers(-(1 << 31), 1 << 31, 40)]
                       ).astype(np.int32)
    vv = torch.from_numpy(np.broadcast_to(v, (120, v.size)).copy())
    qq = torch.from_numpy(np.broadcast_to(np.arange(120)[:, None],
                                          vv.shape).copy())
    want_q = tq.quant(vv, qq).numpy()
    want_s = tq.scale(vv, qq).numpy()
    for q in range(120):
        f = int(tq.QUANT_FACTORS_I32[q])
        for j, x in enumerate(v.tolist()):
            r = _kernel_quotient(x, q)
            qv = _s32(-r if (x < 0) != (f < 0) else r)
            assert qv == want_q[q, j], (q, x)
            assert _kernel_rescale(x, q) == want_s[q, j], (q, x)
    # the error of one lane a slice, at each q: d formed in int32
    y = torch.from_numpy(v[:, None].copy())
    for q in (0, 40, 117, 119):
        err = cbr.luma_error_plain(y, torch.zeros(1, dtype=torch.int32),
                                   torch.full((v.size,), q))
        want = [_s32(x - _kernel_rescale(_s32(
            -_kernel_quotient(x, q) if (x < 0) != (int(
                tq.QUANT_FACTORS_I32[q]) < 0) else _kernel_quotient(x, q)),
            q)) ** 2 for x in v.tolist()]
        assert err.tolist() == want


# --- the encoder and the encode CLI ------------------------------------------

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


@pytest.mark.parametrize("case", CBR)
def test_cbr_golden_byte_identical(case, tmp_path):
    argv, src = _golden_argv(case)
    assert _encode(argv, src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.vc2"))


@pytest.mark.parametrize("case,tap", CBR_TAPS,
                         ids=[f"{c}-{t}" for c, t in CBR_TAPS])
def test_cbr_tap_byte_identical(case, tap, tmp_path):
    argv, src = _golden_argv(case)
    assert _encode(argv + ["-o", tap], src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.{tap.lower()}.raw"))


def test_cbr_1080p_fixture(tmp_path):
    """The 1080p CBR fixture, made by the JAX package's encoder from the
    same seeded input."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_1080p", os.path.join(TESTDATA, "make_1080p.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    src = str(tmp_path / "hd.16p2")
    make.make_input(src)
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        cmd = json.load(f)["streams"]["cbr_1080p"]["encode"]
    argv = cmd[cmd.index("vc2tpu.cli.encode_stream") + 1:-2]
    assert _encode(argv, src, tmp_path) == _read(
        os.path.join(TESTDATA, "cbr_1080p.vc2"))


def test_budget_too_small_raises_like_vc2tpu():
    """No q meets the budgets: both encoders raise the reference's
    "quantization index exceeds maximum implemented value."."""
    kw = dict(height=32, width=64, wavelet_depth=2, y_size=1, x_size=2,
              luma_depth=10, chroma_depth=10, compressed_bytes=100)
    with open(os.path.join(GOLDEN, "tiny422.16p2"), "rb") as f:
        data = f.read()
    tc = tcfg.EncoderConfig(chroma_format=tcfg.ColourFormat.CF422,
                            kernel=tcfg.WaveletKernel.LeGall,
                            mode=tcfg.Mode.HQ_CBR, **kw)
    jc = jcfg.EncoderConfig(chroma_format=jcfg.ColourFormat.CF422,
                            kernel=jcfg.WaveletKernel.LeGall,
                            mode=jcfg.Mode.HQ_CBR, **kw)
    fmt = dict(word_width=2, bit_depth=10)
    tpic = tio.PlanarReader(io.BytesIO(data), tc.geometry,
                            tio.SampleFormat(**fmt)).read_frame()
    jpic = jio.PlanarReader(io.BytesIO(data), jc.geometry,
                            jio.SampleFormat(**fmt)).read_frame()
    with pytest.raises(ValueError) as want:
        jenc.Encoder(jc).encode_picture(jpic)
    with pytest.raises(ValueError) as got:
        tenc.Encoder(tc, device="cpu").encode_picture(tpic)
    assert str(got.value) == str(want.value) == (
        "quantization index exceeds maximum implemented value.")


def test_cbr_q_indices_stay_on_the_device_until_read():
    """The encoder keeps the searched q indices as a tensor; the host copy
    is made when an output asks for it, and equals the JAX encoder's."""
    argv, src = _golden_argv("cbr_legall_d2")
    args = encode_stream.build_parser().parse_args(argv + ["in", "out"])
    cfg = encode_stream.config_from_args(args)
    with open(src, "rb") as f:
        data = f.read()
    pic = tio.PlanarReader(io.BytesIO(data), cfg.geometry, tio.SampleFormat(
        word_width=2, bit_depth=10)).read_frame()
    enc = tenc.Encoder(cfg, device="cpu").encode_picture(pic)
    assert isinstance(enc.q_device, torch.Tensor)
    assert "q_indices" not in vars(enc)            # not read back yet
    want = _read(os.path.join(GOLDEN, "cbr_legall_d2.indices.raw"))
    n = enc.q_indices.size
    assert enc.q_indices.astype(np.uint8).tobytes() == want[:n]
    assert sum(enc.slice_totals) == len(enc.payload) == 2048
