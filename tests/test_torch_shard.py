"""The port's multi-device paths on the CPU mesh (``make_mesh(...,
device="cpu")``): the halo lift of ``vc2tpu_torch.shard.halo``,
``ShardedEncoder``, ``ShardedDecoder``, ``Decoder(mesh=)`` and
``LDEncoder(mesh=)``, against the port's single-device paths and
``vc2tpu``'s sharded functions on the 8 virtual CPU devices of
tests/conftest.py, integer ``==``.

A JAX shard_map program compiles for 5-25 s a shape on the CPU, so the
JAX values come from a few module-scoped cases; which geometries the JAX
package accepts comes from tracing alone (``jax.eval_shape``), for every
case."""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from vc2tpu.core import config as jcfg
from vc2tpu.core.picture import Picture as JPicture
from vc2tpu.pipeline.sharded import ShardedEncoder as JShardedEncoder
from vc2tpu.shard import halo as jhalo
from vc2tpu.shard.mesh import make_mesh as j_make_mesh

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core.config import (ColourFormat, EncoderConfig, FrameRate,
                                      Mode, Profile, WaveletKernel)
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline import decoder as pipe
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.ld import LDEncoder
from vc2tpu_torch.pipeline.sharded import ShardedDecoder, ShardedEncoder
from vc2tpu_torch.shard import halo
from vc2tpu_torch.shard.mesh import make_mesh
from vc2tpu_torch.slices.hq import SliceGeometry, scan_hq_slice_offsets
from vc2tpu_torch.stream.dataunit import PicturePreamble, StreamWriter
from vc2tpu_torch.stream.headers import SequenceHeader
from vc2tpu_torch.wavelet import lifting, matrices

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
KERNELS = [WaveletKernel.LeGall, WaveletKernel.Haar0, WaveletKernel.Haar1,
           WaveletKernel.DD97, WaveletKernel.DD137, WaveletKernel.Fidelity,
           WaveletKernel.Daub97]


def _cpu_mesh(data, space):
    return make_mesh(data, space, device="cpu")


def _jax_accepts(rows, cols, space, kernel, depth, inverse=False) -> str:
    """'' where vc2tpu.shard.halo takes a (rows, cols) plane over ``space``
    bands, else its ValueError's message; traced, not compiled."""
    fn = jhalo.sharded_inverse_plane if inverse else \
        jhalo.sharded_forward_plane
    mesh = j_make_mesh(data=1, space=space)
    try:
        jax.eval_shape(lambda a: fn(a, mesh, jcfg.WaveletKernel(int(kernel)),
                                    depth),
                       np.zeros((rows, cols), np.int32))
    except ValueError as exc:
        return str(exc)
    return ""


def _halo_case(rows, cols, space, kernel, depth, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-512, 512, (rows, cols)).astype(np.int32)
    mesh = _cpu_mesh(1, space)
    for inverse in (False, True):
        fn = halo.sharded_inverse_plane if inverse else \
            halo.sharded_forward_plane
        refused = _jax_accepts(rows, cols, space, kernel, depth, inverse)
        if refused:
            with pytest.raises(ValueError) as err:
                fn(x, mesh, kernel, depth)
            assert str(err.value) == refused
            continue
        ref = (lifting.inverse_plane if inverse else lifting.forward_plane)(
            torch.from_numpy(x), kernel, depth)
        assert torch.equal(fn(x, mesh, kernel, depth), ref), inverse


@pytest.mark.parametrize("space", [1, 2, 4, 8])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_halo_lift_matches_unsharded(kernel, depth, space):
    """Every wavelet at depths 1-3 over 1, 2, 4 and 8 bands of a (space *
    16, 32) plane (tests/test_shard.py's size) and a (64, 48) one: equal to
    the unsharded lift both ways where the JAX package takes the geometry,
    its ValueError where it does not."""
    _halo_case(space * 16, 32, space, kernel, depth, 10 * depth + space)
    _halo_case(64, 48, space, kernel, depth, 100 + depth + space)


def _thinnest(kernel, depth):
    """Rows of the thinnest band the JAX package takes."""
    unit = 1 << depth
    return unit * max(1, halo.halo_width(kernel))


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_thinnest_band(kernel, depth):
    """The thinnest band the JAX package accepts lifts exactly, reaching
    rows two or more bands away (the port's level halo is deeper than a
    band: Fidelity's 14 interleaved rows at stride 2 over 16-row bands);
    the next thinner band that is a multiple of 2**depth, or a band that
    is not one, is refused with the JAX package's error."""
    space = 4
    rows = space * _thinnest(kernel, depth)
    assert _jax_accepts(rows, 24, space, kernel, depth) == ""
    _halo_case(rows, 24, space, kernel, depth, depth)
    if kernel == WaveletKernel.Fidelity:
        # the coarsest level's margin reaches past the next band
        assert halo.margin(kernel, depth) > rows // space
    thinner = rows - space * (1 << depth)
    for bad in ([thinner] if thinner else []) + [rows + space]:
        msg = _jax_accepts(bad, 24, space, kernel, depth)
        assert msg, bad
        with pytest.raises(ValueError) as err:
            halo.sharded_forward_plane(np.zeros((bad, 24), np.int32),
                                       _cpu_mesh(1, space), kernel, depth)
        assert str(err.value) == msg


@pytest.fixture(scope="module")
def jax_halo():
    """vc2tpu's sharded lift, compiled for two cases: the forward over 8
    thinnest Fidelity bands at depth 2, and the LeGall inverse of
    tests/test_shard.py over 4 bands."""
    rng = np.random.default_rng(7)
    x = rng.integers(-512, 512, (8 * 16, 32)).astype(np.int32)
    t = rng.integers(-2048, 2048, (64, 48)).astype(np.int32)
    fwd = np.asarray(jhalo.sharded_forward_plane(
        x, j_make_mesh(data=1, space=8), jcfg.WaveletKernel.Fidelity, 2))
    inv = np.asarray(jhalo.sharded_inverse_plane(
        t, j_make_mesh(data=1, space=4), jcfg.WaveletKernel.LeGall, 2))
    return x, fwd, t, inv


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_halo_lift_matches_vc2tpu(jax_halo, direction):
    x, fwd, t, inv = jax_halo
    if direction == "forward":
        got = halo.sharded_forward_plane(x, _cpu_mesh(1, 8),
                                         WaveletKernel.Fidelity, 2)
        assert np.array_equal(got.numpy(), fwd)
    else:
        got = halo.sharded_inverse_plane(t, _cpu_mesh(1, 4),
                                         WaveletKernel.LeGall, 2)
        assert np.array_equal(got.numpy(), inv)


def test_halo_lift_over_frames_and_a_data_axis():
    """(B, H, W) planes over a 2x4 mesh's space axis, and over its data
    axis: the round trip is the identity and the forward the unsharded."""
    rng = np.random.default_rng(2)
    x = rng.integers(-512, 512, (2, 32, 32)).astype(np.int32)
    mesh = _cpu_mesh(2, 4)
    t = halo.sharded_forward_plane(x, mesh, WaveletKernel.LeGall, 2)
    for b in range(2):
        assert torch.equal(t[b], lifting.forward_plane(
            torch.from_numpy(x[b]), WaveletKernel.LeGall, 2))
    assert torch.equal(halo.sharded_inverse_plane(
        t, mesh, WaveletKernel.LeGall, 2), torch.from_numpy(x))
    t2 = halo.sharded_forward_plane(x, mesh, WaveletKernel.LeGall, 2,
                                    axis_name="data")
    assert torch.equal(t2, t)


def test_halo_lift_is_one_call_a_level_a_device(monkeypatch):
    """Every band of every plane that a device holds goes to one
    ``lift_levels`` call a level, each way."""
    calls = []
    real = lifting.lift_levels

    def spy(planes, *a, **k):
        calls.append(len(planes))
        return real(planes, *a, **k)

    monkeypatch.setattr(lifting, "lift_levels", spy)
    rng = np.random.default_rng(3)
    planes = [[torch.from_numpy(rng.integers(-512, 512, (16, w)).astype(
        np.int32)) for _ in range(4)] for w in (32, 16, 16)]
    t = halo.forward_bands(planes, WaveletKernel.DD137, 2)
    assert calls == [12, 12]
    calls.clear()
    back = halo.inverse_bands(t, WaveletKernel.DD137, 2)
    assert calls == [12, 12]
    for p, q in zip(planes, back):
        assert all(torch.equal(a, b) for a, b in zip(p, q))


# --- ShardedEncoder --------------------------------------------------------

def _cfg(mode, H=64, W=64, kernel=WaveletKernel.LeGall, interlaced=False,
         scalar=1, prefix=0):
    return EncoderConfig(
        height=H, width=W, chroma_format=ColourFormat.CF422, kernel=kernel,
        wavelet_depth=2, y_size=1, x_size=2, mode=mode, luma_depth=10,
        chroma_depth=10, frame_rate=FrameRate.FR25, interlaced=interlaced,
        compressed_bytes=H * W // 2 if mode == Mode.HQ_CBR else 0,
        slice_scalar=scalar, slice_prefix=prefix,
        q_index=20 if mode == Mode.HQ_ConstQ else 0)


def _frames(B, H, W, seed=3):
    rng = np.random.default_rng(seed)
    return [Picture(rng.integers(-512, 512, (H, W)).astype(np.int32),
                    rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                    rng.integers(-512, 512, (H, W // 2)).astype(np.int32),
                    ColourFormat.CF422) for _ in range(B)]


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.q_indices, w.q_indices)
        assert np.array_equal(g.slice_totals, w.slice_totals)
        assert g.payload == w.payload


@pytest.fixture(scope="module")
def jax_sharded_cbr():
    """vc2tpu's ShardedEncoder on a 2x2 mesh: HQ CBR, two 64 x 64 frames."""
    cfg = _cfg(Mode.HQ_CBR)
    jc = jcfg.EncoderConfig(**{f: getattr(cfg, f) for f in (
        "height", "width", "wavelet_depth", "y_size", "x_size",
        "luma_depth", "chroma_depth", "compressed_bytes", "slice_scalar")},
        chroma_format=jcfg.ColourFormat.CF422,
        kernel=jcfg.WaveletKernel.LeGall, mode=jcfg.Mode.HQ_CBR,
        frame_rate=jcfg.FrameRate.FR25)
    pics = _frames(2, 64, 64)
    jpics = [JPicture(p.y, p.c1, p.c2, jcfg.ColourFormat.CF422)
             for p in pics]
    return cfg, pics, JShardedEncoder(jc, j_make_mesh(2, 2)).encode_batch(
        jpics)


def test_sharded_encoder_matches_vc2tpu(jax_sharded_cbr):
    cfg, pics, want = jax_sharded_cbr
    got = ShardedEncoder(cfg, _cpu_mesh(2, 2)).encode_batch(pics)
    _same(got, want)


@pytest.mark.parametrize("interlaced", [False, True],
                         ids=["progressive", "interlaced"])
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("mode", [Mode.HQ_ConstQ, Mode.HQ_CBR],
                         ids=["ConstQ", "CBR"])
def test_sharded_encoder_matches_encoder(mode, mesh, interlaced):
    """Both HQ modes, progressive and interlaced (fields of half the
    height and, for CBR, half the bytes), on 2x2 and 1x4 meshes, against
    the single-device Encoder; a scalar and prefix for ConstQ, DD97 for
    CBR."""
    kernel = WaveletKernel.DD97 if mode == Mode.HQ_CBR else \
        WaveletKernel.LeGall
    cfg = _cfg(mode, kernel=kernel, interlaced=interlaced,
               scalar=2 if mode == Mode.HQ_ConstQ else 1,
               prefix=1 if mode == Mode.HQ_ConstQ else 0)
    d, s = (int(v) for v in mesh.split("x"))
    rows = 32 if interlaced else 64
    pics = _frames(2, rows, 64, seed=5 + s)
    senc = ShardedEncoder(cfg, _cpu_mesh(d, s))
    got = senc.encode_batch(pics)
    enc = Encoder(cfg, device="cpu")
    _same(got, [enc.encode_picture(p) for p in pics])
    assert len(senc.balance) == 2 and len(senc.balance[0]) == s
    assert [sum(b) for b in senc.balance] == [len(g.payload) for g in got]


def test_sharded_encoder_refuses_what_vc2tpu_refuses():
    cfg = _cfg(Mode.HQ_CBR)
    with pytest.raises(ValueError, match="y_slices must divide"):
        ShardedEncoder(cfg, _cpu_mesh(1, 3))
    with pytest.raises(ValueError, match="data extent"):
        ShardedEncoder(cfg, _cpu_mesh(2, 2)).encode_batch(_frames(3, 64, 64))
    with pytest.raises(ValueError, match="LD"):
        ShardedEncoder(EncoderConfig(
            height=64, width=64, chroma_format=ColourFormat.CF422,
            kernel=WaveletKernel.LeGall, wavelet_depth=2, y_size=1,
            x_size=2, mode=Mode.LD, luma_depth=10, chroma_depth=10,
            compressed_bytes=2048), _cpu_mesh(1, 2))


def _header(cfg, H, W):
    return SequenceHeader(
        profile=Profile.PROFILE_HQ, height=H, width=W,
        chroma_format=cfg.chroma_format, interlace=False,
        frame_rate=cfg.frame_rate, top_field_first=True, bitdepth=10)


def _preamble(cfg, geo):
    return PicturePreamble(
        wavelet_kernel=cfg.kernel, depth=cfg.wavelet_depth,
        slices_x=geo.x_slices, slices_y=geo.y_slices,
        slice_prefix=cfg.slice_prefix, slice_size_scalar=cfg.slice_scalar)


def _stream(cfg, geo, encoded, H, W, fragment_length=0):
    buf = io.BytesIO()
    w = StreamWriter(buf)
    w.fragment_length = fragment_length
    w.start_sequence()
    w.write_sequence_header(_header(cfg, H, W))
    for i, e in enumerate(encoded):
        w.write_picture(i, _preamble(cfg, geo), e.payload,
                        slice_sizes=e.slice_totals)
    w.end_sequence()
    return buf.getvalue()


@pytest.mark.parametrize("mode", [Mode.HQ_CBR, Mode.HQ_ConstQ],
                         ids=["CBR", "ConstQ"])
def test_fragments_streamed_match_the_batch(mode):
    """encode_batch_to_fragments, a band's span at a time, against
    write_picture over the batch's assembled payloads; a padded batch
    (three pictures on two data rows) writes only the numbered ones."""
    cfg = _cfg(mode)
    pics = _frames(3, 64, 64, seed=13)
    senc = ShardedEncoder(cfg, _cpu_mesh(2, 4))
    pre = _preamble(cfg, senc.geo)
    out = io.BytesIO()
    w = StreamWriter(out)
    w.fragment_length = 300
    w.start_sequence()
    w.write_sequence_header(_header(cfg, 64, 64))
    qs = senc.encode_batch_to_fragments(pics[:2], w, [0, 1], pre)
    qs += senc.encode_batch_to_fragments(pics[2:] * 2, w, [2], pre)
    w.end_sequence()
    batch = senc.encode_batch(pics + pics[2:])[:3]
    assert out.getvalue() == _stream(cfg, senc.geo, batch, 64, 64, 300)
    assert len(qs) == 3
    for q, e in zip(qs, batch):
        assert np.array_equal(q, e.q_indices)


# --- ShardedDecoder and Decoder(mesh=) -------------------------------------

@pytest.mark.parametrize("space", [2, 8])
def test_sharded_decoder_matches_single_device(space):
    """decode_payload (the chain scan and a band's unpack), the scan's
    fields through decode_payload_device and host lanes through
    synthesise, each against the single-device unpack, dequantise and
    inverse, and the spans the bands upload cover the payload."""
    cfg = _cfg(Mode.HQ_CBR)
    enc = Encoder(cfg, device="cpu")
    e = enc.encode_picture(_frames(1, 64, 64, seed=5)[0])
    payload = np.frombuffer(e.payload, np.uint8)
    geo = enc.geo
    q, dstart, cbytes, _ = scan_hq_slice_offsets(payload, geo.n_slices, 0, 1)
    lanes, q_t = pipe.unpack_payload(payload, q, cbytes, geo, 0,
                                     device="cpu")
    ref = lifting.inverse_planes(
        pipe.dequantise_planes(lanes, q_t, enc.qmatrix, 2, geo),
        cfg.kernel, 2)
    sdec = ShardedDecoder(cfg.kernel, 2, geo, _cpu_mesh(1, space))
    for got in (sdec.decode_payload(payload, 0, 1),
                sdec.decode_payload_device(payload, q, dstart, cbytes),
                sdec.synthesise(q, *[x.numpy() for x in lanes])):
        for a, b in zip(got, ref, strict=True):
            assert torch.equal(a, b)
    # each band's span runs from its block's first slice's first region to
    # its block's last slice's end; the first and last blocks reach the
    # payload's ends
    xs, ends = geo.x_slices, dstart + cbytes
    blocks = halo.band_blocks(geo, space, cfg.kernel, 2)
    assert sdec.spans == [int(ends[2, b * xs - 1] - dstart[0, a * xs])
                          for a, _r0, _r1, b in blocks]
    assert blocks[0][0] == 0 and blocks[-1][3] == geo.y_slices
    assert dstart[0, 0] == 2 and ends[2, -1] == payload.size


@pytest.mark.parametrize("fragment_length", [0, 512],
                         ids=["whole", "fragmented"])
def test_mesh_decode_matches_single_device(fragment_length):
    """Decoder(mesh=) over whole pictures and reassembled fragments
    against Decoder() on the CPU, three pictures; the route engages."""
    cfg = _cfg(Mode.HQ_CBR)
    enc = Encoder(cfg, device="cpu")
    encoded = [enc.encode_picture(p) for p in _frames(3, 64, 64, seed=11)]
    stream = _stream(cfg, enc.geo, encoded, 64, 64, fragment_length)
    want = io.BytesIO()
    assert Decoder(sink=want, device="cpu").run(stream) == 0
    got = io.BytesIO()
    dec = Decoder(sink=got, device="cpu", mesh="1x8")
    assert dec.run(stream) == 0 and dec.frames_out == 3
    assert got.getvalue() == want.getvalue()
    assert all(s is not None for s in dec._sdec_cache.values())


@pytest.mark.parametrize("case", ["ld_legall_d2", "ld_midsize",
                                  "ld_fragmented", "ld_interlaced"])
def test_mesh_decode_ld_goldens(case):
    """LD over a 1x4 mesh: the picture unpacked on one device with its LL
    grids from the lanes (every picture), each band's block of the lanes
    and the grids' rows, the band inverse; ld_interlaced's 4 slice rows
    divide, its fields' 16 rows too."""
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        stream = f.read()
    with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
        want = f.read()
    sink = io.BytesIO()
    dec = Decoder(sink=sink, device="cpu", mesh="1x4")
    assert dec.run(stream) == 0
    assert sink.getvalue() == want
    assert all(s is not None for s in dec._sdec_cache.values())
    pictures = dec.frames_out * (2 if dec.hdr.interlace else 1)
    assert dec.ld_card_dc == pictures > 0


def test_sharded_ld_decode_matches_single_device():
    """synthesise with the LL grids (tensors, then host arrays), over 4
    bands, against the single-device LD unpack, dequantise and inverse on
    the midsize golden's picture."""
    from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader

    with open(os.path.join(GOLDEN, "ld_midsize.vc2"), "rb") as f:
        data = f.read()
    dec = Decoder(sink=io.BytesIO(), device="cpu")
    pos = 0
    while True:
        rd = StreamReader(data[pos:])
        du, nxt, _ = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            dec.hdr = rd.read_sequence_header()
        if du == DataUnitType.LD_PICTURE:
            break
        pos += nxt
    _end, job = dec.locate_picture(data[pos:], False)
    geo, pre = job.geo, job.pre
    qm = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
    lanes, q, grids = pipe.unpack_ld_payload(job.payload, job.ld, geo, qm,
                                             pre.depth, device="cpu")
    ref = lifting.inverse_planes(
        pipe.dequantise_ld_planes(lanes, q, grids, qm, pre.depth, geo),
        pre.wavelet_kernel, pre.depth)
    sdec = ShardedDecoder(pre.wavelet_kernel, pre.depth, geo,
                          _cpu_mesh(1, 4))
    for got in (sdec.synthesise(q, *lanes, grids=grids),
                sdec.synthesise(q.numpy(), *[x.numpy() for x in lanes],
                                grids=[g.numpy() for g in grids])):
        for a, b in zip(got, ref, strict=True):
            assert torch.equal(a, b)


# --- LDEncoder(mesh=) -------------------------------------------------------

def _ld_golden_config(case):
    _c, inp, extra = next(c for c in META["cases"] if c[0] == case)
    m = META["inputs"][inp]
    args = dict(zip(extra[::2], extra[1::2]))
    cfg = EncoderConfig(
        height=m["height"], width=m["width"],
        chroma_format=ColourFormat.parse(m["fmt"]),
        kernel=WaveletKernel.parse(args["-k"]),
        wavelet_depth=int(args["-d"]), y_size=int(args["-u"]),
        x_size=int(args["-a"]), mode=Mode.LD, luma_depth=m["depth"],
        chroma_depth=m["depth"], compressed_bytes=int(args["-s"]))
    return cfg, os.path.join(GOLDEN, f"{inp}.16p2")


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x8"])
def test_ld_encoder_mesh_matches_single_device(mesh):
    """The LD analysis over the mesh's bands, then the rate control and
    pack on its first device: the payloads equal LDEncoder's on the
    midsize golden's input (128 rows: bands of 64, 32 and 16)."""
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat

    cfg, src = _ld_golden_config("ld_midsize")
    fmt = SampleFormat(word_width=2, bit_depth=10)
    with open(src, "rb") as f:
        pic = PlanarReader(f, cfg.geometry, fmt, fmt).read_frame()
    want = LDEncoder(cfg, device="cpu").encode_picture(pic)
    enc = LDEncoder(cfg, device="cpu", mesh=mesh)
    assert enc.device == torch.device("cpu")
    got = enc.encode_picture(pic)
    assert got.payload == want.payload
    assert np.array_equal(got.q_indices, want.q_indices)
    assert not enc._mesh_inert_logged


def test_ld_encoder_mesh_falls_back_once(capsys):
    """Padded rows that do not divide into bands of whole 2**depth rows:
    the single-device analysis, said once on stderr, as the JAX
    package's LDEncoder says it."""
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat

    cfg, src = _ld_golden_config("ld_legall_d2")
    fmt = SampleFormat(word_width=2, bit_depth=10)
    with open(src, "rb") as f:
        rd = PlanarReader(f, cfg.geometry, fmt, fmt)
        pics = [rd.read_frame(), rd.read_frame()]
    enc = LDEncoder(cfg, device="cpu", mesh="1x3")
    base = LDEncoder(cfg, device="cpu")
    for p in pics:
        assert enc.encode_picture(p).payload == base.encode_picture(p).payload
    err = capsys.readouterr().err
    assert err == ("--mesh: LD plane of 32 rows does not divide over 3 "
                   "shards in units of 4; analysing single-chip\n")


def test_sharded_decoder_geometry_checks():
    geo = SliceGeometry(6, 4, (24, 32), (24, 16), (4, 8), (4, 4))
    with pytest.raises(ValueError, match="y_slices must divide"):
        ShardedDecoder(WaveletKernel.LeGall, 2, geo, _cpu_mesh(1, 4))
    sdec = ShardedDecoder(WaveletKernel.Fidelity, 2, geo, _cpu_mesh(1, 3))
    with pytest.raises(ValueError, match="too small for this kernel"):
        sdec.synthesise(np.zeros(24, np.int32),
                        np.zeros((24, 32), np.int32),
                        np.zeros((24, 16), np.int32),
                        np.zeros((24, 16), np.int32))


def test_mesh_decode_ld_whose_slice_rows_do_not_divide(capsys, monkeypatch):
    """ld_midsize's 16 slice rows over 32 bands: the LD unpack on one
    device, then the halo inverse of its three planes over the 32 bands of
    4 rows, one ``lift_levels`` call a level; said once, as the JAX
    package's decoder says it."""
    calls = []
    real = lifting.lift_levels

    def spy(planes, *a, **k):
        calls.append(len(planes))
        return real(planes, *a, **k)

    monkeypatch.setattr(lifting, "lift_levels", spy)
    with open(os.path.join(GOLDEN, "ld_midsize.vc2"), "rb") as f:
        stream = f.read()
    with open(os.path.join(GOLDEN, "ld_midsize.dec.16p2"), "rb") as f:
        want = f.read()
    sink = io.BytesIO()
    dec = Decoder(sink=sink, device="cpu", mesh="1x32")
    assert dec.run(stream) == 0
    assert sink.getvalue() == want
    assert calls == [96, 96]
    assert dec.ld_card_dc == dec.frames_out > 0
    assert capsys.readouterr().err == (
        "mesh decode: 16 slice rows do not divide over 32 shards; using the "
        "single-chip route\n")
