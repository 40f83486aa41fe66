"""The port's LD decode on the CPU, against vc2tpu with integer ==: the
vectorised header scan ``ld_header_fields``; the plain bit-granular reader
``unpack_signed_streams`` against ``vc2tpu.vlc.bitpack``'s; the plain LD
unpack ``unpack_ld_plain`` against ``vc2tpu.vlc.device_unpack
.unpack_ld_lanes`` (JAX on the CPU) on the goldens' payloads and on seeded
random payloads with every lead bit offset 0-31, over-long luma lengths,
empty U/V regions and payloads cut short; the parse without a walk
(``ld_code_starts_plain``: the code lengths at every bit position, the
chain by pointer doubling) against both readers, on regions that cover
the 1-fill past the bound, the payload's end and the 64-bit clamp; the
native LD scan (``csrc/ld_scan.cpp``, built with the host C++ compiler)
and its Python twin against ``vc2tpu.pipeline.decoder.ld_ll_grids``; the
device-route synthesis against the JAX function of the same name; the
decoder's three taps on LD streams; and the LD 1080p fixture against its
recorded SHA-256.
The LD unpack kernel itself is held against its plain version by
tests/test_torch_cuda.py and ``chip_smoke.py`` (on the card)."""

import hashlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vc2tpu.cli import decode_stream as j_cli
from vc2tpu.core import config as jcfg
from vc2tpu.core.intmath import intlog2
from vc2tpu.pipeline import decoder as jdec
from vc2tpu.pipeline import ld as jld_pipe
from vc2tpu.pipeline.encoder import SliceGeometry as JSG
from vc2tpu.slices import ld as jld
from vc2tpu.vlc import bitpack as jbits
from vc2tpu.vlc import device_unpack as jdu

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.core.config import PictureGeometry
from vc2tpu_torch.pipeline import decoder as tdec
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices import ld as tld
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader
from vc2tpu_torch.vlc import device_unpack as tdu
from vc2tpu_torch.wavelet import matrices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TESTDATA = os.path.join(ROOT, "vc2tpu_torch", "testdata")
PICTURE_GOLDENS = ["ld_legall_d2", "ld_midsize", "ld_interlaced"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _ld_pictures(data):
    """The located LD pictures of a stream (``Decoder.locate_picture``)."""
    dec = Decoder(sink=io.BytesIO(), device="cpu")
    out, pos = [], 0
    while pos + 13 <= len(data):
        rd = StreamReader(data[pos:])
        du, next_off, _ = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            dec.hdr = rd.read_sequence_header()
            dec._major_version = rd.major_version
        elif du == DataUnitType.LD_PICTURE:
            out.append(dec.locate_picture(data[pos:], False)[1])
        if next_off == 0:
            break
        pos += next_off
    return dec.hdr, out


def _sizes(job):
    pre, geo = job.pre, job.geo
    return layout.slice_bytes_map(
        geo.y_slices, geo.x_slices,
        pre.slice_bytes_numerator * geo.n_slices
        // pre.slice_bytes_denominator, 1).ravel()


def _random_geometry(ys=5, xs=7):
    """A 4:2:2 slice grid of 8x8 luma and 8x4 chroma blocks (depth 2)."""
    return SliceGeometry(ys, xs, (8 * ys, 8 * xs), (8 * ys, 4 * xs), (8, 8),
                         (8, 4))


def _payload_case(case):
    """(payload bytes, slice sizes, start, geometry) of a header or scan
    case."""
    if case in PICTURE_GOLDENS:
        _hdr, jobs = _ld_pictures(_read(os.path.join(GOLDEN, f"{case}.vc2")))
        job = jobs[0]
        return bytes(job.payload), _sizes(job), job.start, job.geo
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "sizes_25_26":              # the 1080p LD slice sizes
        sizes = layout.slice_bytes_map(135, 240, 829440, 1).ravel()
        assert set(sizes.tolist()) == {25, 26}
        geo = SliceGeometry(135, 240, (540, 1920), (540, 960), (4, 8),
                            (4, 4))
    else:
        geo = _random_geometry()
        sizes = layout.slice_bytes_map(5, 7, 35 * 21 + 3, 1).ravel()
    start = 13
    payload = rng.integers(0, 256, start + int(sizes.sum()), dtype=np.uint8)
    if case == "random_cut_short":
        payload = payload[:start + int(sizes.sum()) * 2 // 3]
    return payload.tobytes(), sizes, start, geo


HEADER_CASES = PICTURE_GOLDENS + ["random", "random_cut_short", "sizes_25_26"]


@pytest.mark.parametrize("case", HEADER_CASES)
def test_ld_header_fields_match_vc2tpu(case):
    payload, sizes, start, _geo = _payload_case(case)
    want = jld.ld_header_fields(np.frombuffer(payload, np.uint8), sizes,
                                start)
    got = tld.ld_header_fields(payload, sizes, start)
    for g, w in zip(got[:5], want[:5]):
        assert np.array_equal(g, w)
    assert got[5] == want[5]


def test_len_bits_of_is_intlog2():
    sizes = np.concatenate([np.arange(0, 300), [1 << 20, (1 << 20) + 1,
                                                 (1 << 27) - 1]])
    want = [intlog2(int(8 * s - 7)) for s in sizes]
    assert tld.len_bits_of(sizes).tolist() == want


def _stream_rows(case):
    """(payload, start bits, length bits, lanes) of bounded rows."""
    rng = np.random.default_rng(3 + len(case))
    payload = rng.integers(0, 256, 3000, dtype=np.uint8)
    n = 96
    starts = 32 * rng.integers(0, 700, n) + np.arange(n) % 32   # leads 0-31
    lens = rng.integers(0, 300, n)
    lens[::7] = 0
    if case == "past_end":
        starts[:8] = 8 * 3000 - rng.integers(1, 200, 8)
    if case == "long_codes":
        # ramp of magnitudes up to 2^31 - 1 (codes of up to 64 bits),
        # read from its start with several bounds (a row read from inside a
        # code may meet 32 zero follow bits, which vc2tpu's host reader
        # decodes bit by bit and the port clamps, as the device unpacks do)
        bits = []
        for k in range(31):
            m = (1 << (k + 1)) - 1
            for ch in bin(m + 1)[3:]:
                bits += [0, int(ch)]
            bits += [1, k & 1]
        bits += [1] * (-len(bits) % 8)
        payload = np.packbits(np.asarray(bits, np.uint8))
        starts = np.zeros(4, np.int64)
        lens = np.array([len(bits), len(bits) - 40, 100, 7])
    return payload, starts.astype(np.int64), lens.astype(np.int64), 40


@pytest.mark.parametrize("case", ["random", "past_end", "long_codes"])
def test_plain_reader_matches_vc2tpu(case):
    payload, starts, lens, lanes = _stream_rows(case)
    want = jbits.unpack_signed_streams(payload, starts, lens, lanes)
    got = tdu.unpack_signed_streams(torch.from_numpy(payload),
                                    torch.from_numpy(starts),
                                    torch.from_numpy(lens), lanes)
    assert np.array_equal(got.numpy(), want)


def _runs_rows():
    """(payload, start bits, length bits, lanes) of regions over runs of
    0x00 bytes (codes with no terminator in 64 bits: the clamp) and 0xFF
    bytes (zero codes, long runs of them past the bound), read from every
    offset of a word, some past the payload's end."""
    rng = np.random.default_rng(17)
    chunks = [np.full(rng.integers(1, 24), rng.choice([0, 0xFF, 0x5A]),
                      np.uint8) for _ in range(60)]
    payload = np.concatenate(chunks)
    n = 128
    starts = rng.integers(0, 8 * len(payload) - 8, n)
    starts[:32] = np.arange(32) + 8 * 16
    lens = rng.integers(1, 400, n)
    lens[32:40] = 8 * len(payload) + 100 - starts[32:40]   # past the end
    return payload, starts.astype(np.int64), lens.astype(np.int64), 48


@pytest.mark.parametrize("case", ["random", "past_end", "long_codes",
                                  "runs"])
def test_parse_without_walk_matches_the_serial_readers(case):
    """``ld_code_starts_plain``'s starts decode, code by code, to what the
    serial reader reads (and vc2tpu's, which agrees with it where no code
    lacks a terminator in 64 bits); the starts rise and each is the one
    before it plus that code's length."""
    payload, starts, lens, lanes = (_runs_rows() if case == "runs"
                                    else _stream_rows(case))
    args = (torch.from_numpy(payload), torch.from_numpy(starts),
            torch.from_numpy(lens), lanes)
    got = tdu.unpack_parsed_plain(*args)
    assert torch.equal(got, tdu.unpack_signed_streams(*args))
    if case != "runs":
        want = jbits.unpack_signed_streams(payload, starts, lens, lanes)
        assert np.array_equal(got.numpy(), want)
    at = tdu.ld_code_starts_plain(*args)
    bits, nbits = tdu._stream_bits(args[0])
    first = args[1][:, None]
    _, length = tdu._codes_at(bits, nbits, first + at.clamp(min=0),
                              (first + args[2][:, None]).expand_as(at))
    live = at >= 0
    assert bool((at[:, 0] == torch.where(args[2] > 0, 0, -1)).all())
    nxt = torch.where(live[:, 1:], at[:, 1:], -1)
    assert torch.equal(nxt, torch.where(live[:, 1:],
                                        at[:, :-1] + length[:, :-1], -1))


@settings(max_examples=40, deadline=None)
@given(data=st.binary(min_size=1, max_size=48),
       start=st.integers(0, 400), length=st.integers(0, 600),
       lanes=st.integers(1, 40))
def test_parse_without_walk_matches_the_serial_reader(data, start, length,
                                                      lanes):
    """The parse without a walk against the serial reader on any bytes,
    region start, bound (past the payload's end too) and lane count."""
    args = (torch.frombuffer(bytearray(data), dtype=torch.uint8),
            torch.tensor([start]), torch.tensor([length]), lanes)
    assert torch.equal(tdu.unpack_parsed_plain(*args),
                       tdu.unpack_signed_streams(*args))


def _jax_unpack_ld(payload, fields, ly, lc):
    """vc2tpu's device LD unpack, as its decoder calls it: the payload
    0xFF-padded to whole words, windows from the largest regions."""
    pl = np.frombuffer(payload, np.uint8)
    p4 = (len(pl) + 3) // 4 * 4 + 8
    pad = np.full(p4, 0xFF, np.uint8)
    pad[:len(pl)] = pl
    wy = jdu.window_words_bits(
        jdec._bucket_bytes(int(fields[2].max()) // 8 + 1) * 8, ly)
    wc = jdu.window_words_bits(
        jdec._bucket_bytes(int(fields[3].max()) // 8 + 1) * 8, 2 * lc)
    fn = jax.jit(lambda p, s, lb, y, uv: jdu.unpack_ld_lanes(
        p, s, lb, y, uv, (ly, lc), (wy, wc)))
    qy, quv = fn(jnp.asarray(pad), *(jnp.asarray(f, jnp.int32)
                                      for f in fields))
    quv = np.asarray(quv)
    return np.asarray(qy), quv[:, 0::2], quv[:, 1::2]


def _unpack_case(case):
    """(payload, fields int32 [4, N], ly, lc) of an unpack case."""
    if case in ("ld_legall_d2", "ld_midsize"):
        _hdr, jobs = _ld_pictures(_read(os.path.join(GOLDEN, f"{case}.vc2")))
        job = jobs[0]
        geo = job.geo
        return (bytes(job.payload), job.ld.fields,
                geo.luma_slice[0] * geo.luma_slice[1],
                geo.chroma_slice[0] * geo.chroma_slice[1])
    rng = np.random.default_rng(len(case))
    n = 320
    payload = rng.integers(0, 256, 8000, dtype=np.uint8)
    s_bits = np.sort(rng.integers(0, 8 * 7000, n))
    s_bits[:64] = 8 * 64 + np.arange(64)          # every lead offset 0-31
    len_bits = rng.integers(0, 10, n)
    y_bits = rng.integers(0, 300, n)
    uv_bits = rng.integers(0, 300, n)
    uv_bits[::5] = 0
    if case == "oversized_luma":                  # regions past their slice
        y_bits[::3] = rng.integers(1000, 4000, len(y_bits[::3]))
    if case == "cut_short":
        payload = payload[:5000]
    fields = np.stack([s_bits, len_bits, y_bits, uv_bits]).astype(np.int32)
    return payload.tobytes(), fields, 16, 8


def test_decode_ld_slices_runs_on_the_card_unless_asked(monkeypatch):
    """``decode_ld_slices`` runs on the card by default, as the entry points
    do: without one it raises, unless given ``device="cpu"``, where it
    decodes as ``vc2tpu.slices.ld.decode_ld_slices`` does."""
    payload, sizes, start, geo = _payload_case("ld_legall_d2")
    counts = (geo.luma_slice[0] * geo.luma_slice[1],
              geo.chroma_slice[0] * geo.chroma_slice[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tld.decode_ld_slices(payload, sizes, counts, start)
    got = tld.decode_ld_slices(payload, sizes, counts, start, device="cpu")
    want = jld.decode_ld_slices(np.frombuffer(payload, np.uint8), sizes,
                                counts, start)
    assert np.array_equal(got[0], want[0]) and got[4] == want[4]
    for g, w in zip(got[1:4], want[1:4]):
        assert g.device.type == "cpu" and np.array_equal(g.numpy(), w)


UNPACK_CASES = ["ld_legall_d2", "ld_midsize", "random_leads",
                "oversized_luma", "cut_short"]


@pytest.mark.parametrize("case", UNPACK_CASES)
def test_unpack_ld_plain_matches_vc2tpu(case):
    payload, fields, ly, lc = _unpack_case(case)
    want = _jax_unpack_ld(payload, fields, ly, lc)
    got = tdu.unpack_ld(torch.from_numpy(np.frombuffer(payload, np.uint8)
                                         .copy()),
                        torch.from_numpy(fields), ly, lc)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", UNPACK_CASES)
def test_parsed_ld_regions_match_vc2tpu(case):
    """Both regions of every slice by the parse without a walk, U and V
    split by parity, against vc2tpu's device LD unpack."""
    payload, fields, ly, lc = _unpack_case(case)
    pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    f = torch.from_numpy(fields)
    luma, chroma = tdu.ld_regions(f)
    qy = tdu.unpack_parsed_plain(pay, luma, f[2], ly)
    quv = tdu.unpack_parsed_plain(pay, chroma, f[3], 2 * lc)
    want = _jax_unpack_ld(payload, fields, ly, lc)
    for g, w in zip((qy, quv[:, 0::2], quv[:, 1::2]), want):
        assert np.array_equal(g.numpy(), w)


def test_unpack_ld_wrapper_refuses_bad_inputs():
    pay = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tdu.unpack_ld(pay, torch.zeros((3, 2), dtype=torch.int32), 4, 2)
    with pytest.raises(ValueError):
        tdu.unpack_ld(pay, torch.zeros((4, 2), dtype=torch.int64), 4, 2)
    with pytest.raises(ValueError):       # CTA flags need the kernel
        tdu.unpack_ld(pay, torch.zeros((4, 2), dtype=torch.int32), 4, 2,
                      staged=torch.zeros(1, dtype=torch.uint8))


def _jax_geo(geo):
    return JSG(geo.y_slices, geo.x_slices, geo.padded_luma,
               geo.padded_chroma, geo.luma_slice, geo.chroma_slice)


SCAN_CASES = PICTURE_GOLDENS + ["random", "random_cut_short"]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ld_scan_matches_vc2tpu(case):
    payload, sizes, start, geo = _payload_case(case)
    depth = 2
    qm = matrices.quant_matrix(tcfg.WaveletKernel.LeGall, depth)
    arr = np.frombuffer(payload, np.uint8)
    q, s_bits, len_bits, y_bits, uv_bits, end = jld.ld_header_fields(
        arr, sizes, start)
    want = jdec.ld_ll_grids(
        arr, q, s_bits, len_bits, y_bits, uv_bits, _jax_geo(geo), depth,
        jld_pipe._qm_block(*geo.luma_slice, depth, qm),
        jld_pipe._qm_block(*geo.chroma_slice, depth, qm))
    fields = np.stack([s_bits, len_bits, y_bits, uv_bits]).astype(np.int32)
    for scan in (tld.ld_scan(payload, sizes, geo, depth, qm, start),
                 tld.ld_scan_plain(payload, sizes, geo, depth, qm, start)):
        assert np.array_equal(scan.q, q)
        assert np.array_equal(scan.fields, fields)
        assert scan.end == end
        for g, w in zip(scan.grids, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("case", ["ld_legall_d2", "ld_midsize"])
def test_synthesise_ld_matches_vc2tpu(case):
    hdr, jobs = _ld_pictures(_read(os.path.join(GOLDEN, f"{case}.vc2")))
    job = jobs[0]
    pre, geo = job.pre, job.geo
    qm = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
    out = PictureGeometry.of(job.pic_h, hdr.width, hdr.chroma_format)
    got = tdec.synthesise_ld_payload_to_words(
        job.payload, job.ld, qm, pre.wavelet_kernel, pre.depth, geo, out,
        hdr.bitdepth, device="cpu")
    jout = jcfg.PictureGeometry(out.luma_height, out.luma_width,
                                out.chroma_height, out.chroma_width,
                                int(out.chroma_format))
    q, (words, post) = jdec.synthesise_ld_payload_to_words(
        job.payload, _sizes(job), qm, jcfg.WaveletKernel(
            int(pre.wavelet_kernel)), pre.depth, _jax_geo(geo), jout,
        hdr.bitdepth, jld_pipe._qm_block(*geo.luma_slice, pre.depth, qm),
        jld_pipe._qm_block(*geo.chroma_slice, pre.depth, qm),
        start=job.start)
    assert np.array_equal(q, job.q_idx)
    assert got.numpy().tobytes() == post(np.asarray(words))


_TAPS = [(c, o) for c in ("ld_legall_d2", "ld_fragmented")
         for o in ("Transform", "Quantised", "Indices")]


@pytest.mark.parametrize("case,output", _TAPS,
                         ids=[f"{c}-{o}" for c, o in _TAPS])
def test_ld_decoder_tap_matches_vc2tpu(case, output):
    data = _read(os.path.join(GOLDEN, f"{case}.vc2"))
    want = io.BytesIO()
    assert j_cli.Decoder(output=jcfg.DecOutput(output), sink=want).run(
        data) == 0
    got = io.BytesIO()
    assert Decoder(output=tcfg.DecOutput(output), sink=got,
                   device="cpu").run(data) == 0
    assert got.getvalue() and got.getvalue() == want.getvalue()


def test_ld_1080p_fixture_decodes_to_its_sha256():
    with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
        fixture = json.load(f)["streams"]["ld_1080p"]
    data = _read(os.path.join(TESTDATA, fixture["stream"]))
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu").run(data) == 0
    assert len(sink.getvalue()) == fixture["decoded_bytes"]
    assert hashlib.sha256(sink.getvalue()).hexdigest() == \
        fixture["decoded_sha256"]


def test_ld_window_too_short_is_grown_then_skipped():
    """An LD picture whose slices run past the stream's end is a corrupt
    picture (the short-window ValueError): skipped, not an error."""
    data = _read(os.path.join(GOLDEN, "ld_legall_d2.vc2"))
    want = _read(os.path.join(GOLDEN, "ld_legall_d2.dec.16p2"))
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu").run(data[:-40]) == 0
    got = sink.getvalue()
    assert want.startswith(got) and len(got) < len(want)
