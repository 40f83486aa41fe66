"""The port's HQ ConstQ encode on the CPU against vc2tpu: the stream writer
(bits, video format, data units), the planar reader and writer, the
forward transform and lane layout, the quantiser, the encode CLI's flag
checks, and the whole ``cli/encode_stream.py`` with ``--device cpu`` on
the 13 ConstQ goldens and the 6 ConstQ taps, byte for byte. HQ CBR and LD
encode have their own tests (tests/test_torch_cbr.py,
tests/test_torch_ld_encode.py)."""

import dataclasses
import io
import json
import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vc2tpu.cli import encode_stream as j_cli
from vc2tpu.core import config as jcfg
from vc2tpu.core import picture as jpic
from vc2tpu.core import planario as jio
from vc2tpu.pipeline import encoder as jenc
from vc2tpu.quant import quantiser as jq
from vc2tpu.slices import layout as jlayout
from vc2tpu.stream import bits as jbits
from vc2tpu.stream import dataunit as jdu
from vc2tpu.stream import headers as jhdr
from vc2tpu.wavelet import lifting as jl
from vc2tpu.wavelet import matrices as jm

from vc2tpu_torch.cli import encode_stream
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.core import picture as tpic
from vc2tpu_torch.core import planario as tio
from vc2tpu_torch.pipeline import encoder as tenc
from vc2tpu_torch.quant import quantiser as tq
from vc2tpu_torch.slices import layout as tlayout
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.stream import bits as tbits
from vc2tpu_torch.stream import dataunit as tdu
from vc2tpu_torch.stream import headers as thdr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TESTDATA = os.path.join(ROOT, "vc2tpu_torch", "testdata")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
CONSTQ = [c[0] for c in META["cases"] if c[0].startswith("constq")]
CONSTQ_TAPS = [tuple(t) for t in META["taps"] if t[0].startswith("constq")]
KERNELS = [k for k in tcfg.WaveletKernel if k != tcfg.WaveletKernel.NullKernel]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


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


# --- the encode CLI against the goldens --------------------------------------

@pytest.mark.parametrize("case", CONSTQ)
def test_encode_golden_byte_identical(case, tmp_path):
    argv, src = _golden_argv(case)
    assert _encode(argv, src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.vc2"))


@pytest.mark.parametrize("case,tap", CONSTQ_TAPS,
                         ids=[f"{c}-{t}" for c, t in CONSTQ_TAPS])
def test_encode_tap_byte_identical(case, tap, tmp_path):
    argv, src = _golden_argv(case)
    assert _encode(argv + ["-o", tap], src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.{tap.lower()}.raw"))


@pytest.mark.parametrize("case", ["constq_legall_d2", "constq_interlaced",
                                  "constq_16bit"])
def test_decoded_tap_equals_the_decode(case, tmp_path):
    """The Decoded tap's in-process decode equals DecodeStream's output on
    the same stream."""
    argv, src = _golden_argv(case)
    assert _encode(argv + ["-o", "Decoded"], src, tmp_path) == _read(
        os.path.join(GOLDEN, f"{case}.dec.16p2"))


def test_encode_1080p_fixture(tmp_path):
    """The 1080p ConstQ fixture, made by the JAX package's encoder, from
    the same seeded input."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_1080p", os.path.join(TESTDATA, "make_1080p.py"))
    make = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make)
    src = str(tmp_path / "hd.16p2")
    make.make_input(src)
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        cmd = json.load(f)["streams"]["constq_1080p"]["encode"]
    argv = cmd[cmd.index("vc2tpu.cli.encode_stream") + 1:-2]
    assert _encode(argv, src, tmp_path) == _read(
        os.path.join(TESTDATA, "constq_1080p.vc2"))


_BAD_ARGS = [
    ["-m", "HQ_ConstQ"],                              # no -q
    ["-m", "HQ_ConstQ", "-q", "4", "-s", "100"],
    ["-m", "HQ_CBR", "-q", "4", "-s", "100"],
    ["-m", "LD", "-s", "100", "-S", "2"],
    ["-m", "HQ_ConstQ", "-q", "4", "-i", "-p"],
    ["-m", "HQ_ConstQ", "-q", "4", "-z", "10", "-l", "10"],
    ["-m", "HQ_ConstQ", "-q", "4", "-F", "512"],
]


@pytest.mark.parametrize("extra", _BAD_ARGS, ids=range(len(_BAD_ARGS)))
def test_cli_flag_checks_match_vc2tpu(extra):
    base = ["-x", "64", "-y", "32", "-f", "4:2:2", "-k", "LeGall", "-d", "2",
            "-u", "1", "-a", "2"]
    argv = base + extra + ["in", "out"]
    with pytest.raises(ValueError) as want:
        j_cli.config_from_args(j_cli.build_parser().parse_args(argv))
    with pytest.raises(ValueError) as got:
        encode_stream.config_from_args(
            encode_stream.build_parser().parse_args(argv))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("u,d", [(3, 2), (1, 6)],
                         ids=["slices", "depth"])
def test_slice_geometry_errors_match_vc2tpu(u, d, capsys):
    kw = dict(height=32, width=64, kernel=1, wavelet_depth=d, y_size=u,
              x_size=2, luma_depth=10, chroma_depth=10, q_index=4)
    jc = jcfg.EncoderConfig(chroma_format=jcfg.ColourFormat.CF422, **kw)
    tc = tcfg.EncoderConfig(chroma_format=tcfg.ColourFormat.CF422, **kw)
    with pytest.raises(ValueError) as want:
        jenc.slice_geometry(jc)
    j_err = capsys.readouterr().err
    with pytest.raises(ValueError) as got:
        tenc.slice_geometry(tc)
    assert str(got.value) == str(want.value)
    assert capsys.readouterr().err == j_err and j_err


# --- transform, layout and quantiser ------------------------------------------

def _geometry(shapes, depth):
    (lh, lw), (ch, cw) = shapes[0], shapes[1]
    pl = (jm.padded_size(lh, depth), jm.padded_size(lw, depth))
    pc = (jm.padded_size(ch, depth), jm.padded_size(cw, depth))
    ys = math.gcd(pl[0], pc[0]) >> depth
    xs = math.gcd(pl[1], pc[1]) >> depth
    return SliceGeometry(ys, xs, pl, pc, (pl[0] // ys, pl[1] // xs),
                         (pc[0] // ys, pc[1] // xs))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_forward_planes_and_lanes_match_vc2tpu(kernel, depth):
    """``analyse`` (pad + forward_planes) against the JAX encoder's
    ``bands_to_inplace(forward_bands(wavelet_pad(p)))``, and
    ``plane_to_lanes`` of the result against ``bands_to_lanes``."""
    rng = np.random.default_rng(10 * int(kernel) + depth)
    shapes = [(36, 68), (36, 34), (36, 34)]
    planes = [rng.integers(-512, 512, s).astype(np.int32) for s in shapes]
    geo = _geometry(shapes, depth)
    got = tenc.analyse([torch.from_numpy(p) for p in planes], kernel, depth)
    got_lanes = tenc.planes_to_lanes(got, geo, depth)
    jk = jcfg.WaveletKernel(int(kernel))
    for p, g, gl in zip(planes, got, got_lanes):
        bands = jl.forward_bands(jl.wavelet_pad(jnp.asarray(p), depth), jk,
                                 depth)
        assert np.array_equal(g.numpy(),
                              np.asarray(jl.bands_to_inplace(bands, depth)))
        want = jl.bands_to_lanes(bands, geo.y_slices, geo.x_slices)
        assert np.array_equal(gl.numpy(), np.asarray(want))


def test_plane_to_lanes_matches_vc2tpu():
    x = np.random.default_rng(5).integers(-99, 99, (24, 40)).astype(np.int32)
    t = torch.from_numpy(x)
    for depth in (1, 2, 3):
        assert np.array_equal(tlayout.plane_to_lanes(t, 3, 5, depth).numpy(),
                              jlayout.plane_to_lanes(x, 3, 5, depth))


def _quant_values(domain, rng):
    if domain == "small":
        mag = rng.integers(0, 1 << 12, (120, 400))
    elif domain == "large":
        mag = (2.0 ** rng.uniform(0, 29, (120, 400))).astype(np.int64)
        mag = np.minimum(mag, (1 << 29) - 1)
    else:   # edges: 0, 1, magnitudes just under 2^29, table multiples
        edge = [0, 1, 2, 3, 4, 5, (1 << 29) - 1, (1 << 29) - 2,
                (1 << 29) - 3, (1 << 29) - 4, (1 << 28), (1 << 28) - 1]
        mag = np.tile(np.asarray(edge, np.int64), (120, 1))
        qf = np.abs(jq.QUANT_FACTORS_I32.astype(np.int64))
        near = np.clip((qf[:, None] * np.arange(1, 9)) // 4 - 1, 0,
                       (1 << 29) - 2)
        mag = np.concatenate([mag, near, near + 1], axis=1)
    sign = np.where(rng.random(mag.shape) < 0.5, -1, 1)
    return (sign * mag).astype(np.int32)


@pytest.mark.parametrize("domain", ["small", "large", "edges"])
def test_quant_matches_vc2tpu(domain):
    """Every q 0-119, including the wrapped (negative) factors at 116-119,
    over |v| < 2^29, where the JAX package's quant is exact."""
    v = _quant_values(domain, np.random.default_rng(len(domain)))
    q = np.broadcast_to(np.arange(120, dtype=np.int32)[:, None], v.shape)
    want = np.asarray(jq.quant(jnp.asarray(v), jnp.asarray(q)))
    got = tq.quant(torch.from_numpy(v), torch.from_numpy(np.array(q)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_quantise_matches_quant_banded(depth):
    """Each lane quantised at max(q - qMatrix[band], 0), per slice q,
    against the JAX encoder's ``quant_banded``."""
    rng = np.random.default_rng(depth)
    kernel = tcfg.WaveletKernel.DD97
    geo = _geometry([(36, 68), (36, 34)], depth)
    qm = jm.quant_matrix(jcfg.WaveletKernel(int(kernel)), depth)
    q_idx = rng.integers(0, 120, geo.n_slices).astype(np.int32)
    lanes = []
    for sh, sw in (geo.luma_slice, geo.chroma_slice, geo.chroma_slice):
        lanes.append(rng.integers(-(1 << 20), 1 << 20,
                                  (geo.n_slices, sh * sw)).astype(np.int32))
    got = tenc.quantise([torch.from_numpy(x) for x in lanes],
                        torch.from_numpy(q_idx), qm, depth, geo)
    for comp, (x, g) in enumerate(zip(lanes, got)):
        sh, sw = geo.luma_slice if comp == 0 else geo.chroma_slice
        _, band = jlayout.lane_order(sh, sw, depth)
        sizes = tuple(int(c) for c in np.bincount(band))
        want = jq.quant_banded(jnp.asarray(x), jnp.asarray(q_idx),
                               jnp.asarray(qm.astype(np.int32)), sizes)
        assert np.array_equal(g.numpy(), np.asarray(want))


# --- stream writer --------------------------------------------------------------

def _bit_ops(w):
    w.put_bits(5, 0b10110)
    for v in (0, 1, 2, 3, 100, 65535):
        w.put_uvlc(v)
    for v in (0, -1, 1, -77, 1000):
        w.put_svlc(v)
    w.put_bool(True)
    w.bounded(12)
    w.put_bits(20, 0b10101010101011111111)    # 1-bits past the bound drop
    w.flush()
    w.put_bytes_value(4, 0xDEADBEEF)
    w.put_raw(b"xyz")
    w.put_bool(False)
    w.align()
    return w


def test_bit_writer_matches_vc2tpu():
    assert (_bit_ops(tbits.BitWriter()).getvalue()
            == _bit_ops(jbits.BitWriter()).getvalue())
    for mod in (tbits, jbits):
        w = mod.BitWriter()
        w.bounded(2)
        w.put_bits(2, 0b11)
        with pytest.raises(ValueError, match="beyond end"):
            w.put_bit(0)


_HEADERS = [
    dict(height=1080, width=1920, chroma_format=1, frame_rate=6, bitdepth=10),
    dict(height=1080, width=1920, chroma_format=1, frame_rate=3, bitdepth=10),
    dict(height=1080, width=1920, chroma_format=1, frame_rate=3, bitdepth=10,
         interlace=True),
    dict(height=32, width=64, chroma_format=1, frame_rate=3, bitdepth=10),
    dict(height=32, width=48, chroma_format=1, frame_rate=3, bitdepth=16),
    dict(height=486, width=720, chroma_format=1, frame_rate=4, bitdepth=10,
         interlace=True),
    dict(height=480, width=720, chroma_format=1, frame_rate=4, bitdepth=10,
         interlace=True, top_field_first=False),
    dict(height=1080, width=2048, chroma_format=0, frame_rate=11,
         bitdepth=12),
    dict(height=2160, width=3840, chroma_format=1, frame_rate=6, bitdepth=10),
    dict(height=120, width=176, chroma_format=2, frame_rate=9, bitdepth=8,
         top_field_first=False),
    dict(height=32, width=32, chroma_format=0, frame_rate=14, bitdepth=12,
         color_spec=0, color_primaries=1, transfer_function=2),
    dict(height=64, width=64, chroma_format=1, frame_rate=3, bitdepth=10,
         pixel_aspect_ratio=3, clean_width=60, clean_height=60,
         left_offset=2, top_offset=2),
]
_ENUMS = {"chroma_format": "ColourFormat", "frame_rate": "FrameRate",
          "profile": "Profile"}


def _header(mod_cfg, mod_hdr, fields):
    kw = dict(profile=2, top_field_first=True)
    kw.update(fields)
    for name, enum in _ENUMS.items():
        kw[name] = getattr(mod_cfg, enum)(kw[name])
    return mod_hdr.SequenceHeader(**kw)


@pytest.mark.parametrize("fields", _HEADERS, ids=range(len(_HEADERS)))
def test_video_format_and_stream_match_vc2tpu(fields):
    th = _header(tcfg, thdr, fields)
    jh = _header(jcfg, jhdr, fields)
    assert (dataclasses.asdict(thdr.video_format_of(th))
            == dataclasses.asdict(jhdr.video_format_of(jh)))
    pre = dict(wavelet_kernel=1, depth=2, slices_x=3, slices_y=2,
               slice_prefix=1, slice_size_scalar=4)
    payload = bytes(range(57))
    got, want = io.BytesIO(), io.BytesIO()
    for mod, cfg, hdr, sink in ((tdu, tcfg, th, got), (jdu, jcfg, jh, want)):
        w = mod.StreamWriter(sink)
        w.start_sequence()
        w.write_sequence_header(hdr)
        hq = {"hq": True} if mod is jdu else {}   # the port writes HQ only
        for num in (0, 1):
            w.write_picture(num, mod.PicturePreamble(**dict(
                pre, wavelet_kernel=cfg.WaveletKernel(1))), payload, **hq)
        w.end_sequence()
    assert got.getvalue() == want.getvalue()


def test_invalid_bit_depth_raises_like_vc2tpu():
    fields = dict(height=32, width=64, chroma_format=1, frame_rate=3,
                  bitdepth=9)
    for cfg, hdr in ((tcfg, thdr), (jcfg, jhdr)):
        with pytest.raises(ValueError, match="invalid bit depth"):
            hdr.video_format_of(_header(cfg, hdr, fields))


# --- planar I/O and pictures ------------------------------------------------------

_FORMATS = [dict(word_width=1, bit_depth=8), dict(word_width=2, bit_depth=10),
            dict(word_width=3, bit_depth=20), dict(word_width=4, bit_depth=24),
            dict(word_width=4, offset=False),
            dict(word_width=2, bit_depth=12, offset=False)]


@pytest.mark.parametrize("fmt", _FORMATS, ids=range(len(_FORMATS)))
def test_planar_io_matches_vc2tpu(fmt):
    rng = np.random.default_rng(fmt["word_width"])
    geo = tcfg.PictureGeometry.of(6, 8, tcfg.ColourFormat.CF422)
    jgeo = jcfg.PictureGeometry.of(6, 8, jcfg.ColourFormat.CF422)
    nbytes = (6 * 8 + 2 * 6 * 4) * fmt["word_width"]
    data = rng.integers(0, 256, 2 * nbytes, dtype=np.uint8).tobytes()
    tr = tio.PlanarReader(io.BytesIO(data), geo, tio.SampleFormat(**fmt))
    jr = jio.PlanarReader(io.BytesIO(data), jgeo, jio.SampleFormat(**fmt))
    for _ in range(2):
        tp, jp = tr.read_frame(), jr.read_frame()
        for a, b in ((tp.y, jp.y), (tp.c1, jp.c1), (tp.c2, jp.c2)):
            assert a.dtype == np.int32 and np.array_equal(a, b)
        got, want = io.BytesIO(), io.BytesIO()
        tio.write_picture(got, tp, tio.SampleFormat(**fmt))
        jio.write_picture(want, jp, jio.SampleFormat(**fmt))
        assert got.getvalue() == want.getvalue()
    assert tr.read_frame() is None and jr.read_frame() is None


@pytest.mark.parametrize("tff", [True, False])
def test_fields_and_clip_match_vc2tpu(tff):
    rng = np.random.default_rng(int(tff))
    planes = [rng.integers(-2000, 2000, s).astype(np.int32)
              for s in ((8, 6), (8, 3), (8, 3))]
    tp = tpic.Picture(*planes, tcfg.ColourFormat.CF422)
    jp = jpic.Picture(*planes, jcfg.ColourFormat.CF422)
    got = tpic.signal_clip(tpic.interleave_fields(
        tp.first_field(tff), tp.second_field(tff), tff), 10, 8)
    want = jpic.signal_clip(jpic.interleave_fields(
        jp.first_field(tff), jp.second_field(tff), tff), 10, 8)
    for a, b in ((got.y, want.y), (got.c1, want.c1), (got.c2, want.c2)):
        assert np.array_equal(a, b)
