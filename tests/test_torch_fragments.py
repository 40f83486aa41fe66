"""HQ fragments and the decoder's tap outputs, on the CPU, against vc2tpu:
``StreamWriter`` with ``fragment_length`` and ``FragmentWriter`` (the
greedy cut, at least one slice a fragment, the empty final fragment, runs
fed in pieces) and ``StreamReader.read_fragment_header`` byte for byte and
field for field; the decoder's fragment reassembly (idempotent under a
repeated fragment, a corrupt or truncated fragmented picture skipped,
later pictures still decoded, a series of 0 x 0 slices skipped as vc2tpu
skips it); and the TRANSFORM, QUANTISED and INDICES
outputs of ``Decoder`` against ``vc2tpu.cli.decode_stream``'s."""

import dataclasses
import io
import os

import numpy as np
import pytest

from vc2tpu.core import config as jcfg
from vc2tpu.cli import decode_stream as j_cli
from vc2tpu.stream import dataunit as jdu
from vc2tpu.stream import headers as jhdr

from vc2tpu_torch.cli import decode_stream
from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.stream import dataunit as tdu
from vc2tpu_torch.stream import headers as thdr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


# --- the writer and the header reader ---------------------------------------

def _stream(mod, cfg, hdr_mod, fragment_length, runs, slices_x=5):
    """A stream of one sequence header and one picture a run of slice
    sizes, each picture's slices fed in the given pieces."""
    sink = io.BytesIO()
    w = mod.StreamWriter(sink)
    w.fragment_length = fragment_length
    w.start_sequence()
    w.write_sequence_header(hdr_mod.SequenceHeader(
        profile=cfg.Profile(2), height=32, width=64,
        chroma_format=cfg.ColourFormat(1), frame_rate=cfg.FrameRate(3),
        bitdepth=10, top_field_first=True))
    kw = {"hq": True} if mod is jdu else {}      # the port writes HQ only
    for num, pieces in enumerate(runs):
        n = sum(len(p) for p in pieces)
        pre = mod.PicturePreamble(
            wavelet_kernel=cfg.WaveletKernel(1), depth=2, slices_x=slices_x,
            slices_y=max(1, -(-n // slices_x)), slice_prefix=0,
            slice_size_scalar=1)
        fw = mod.FragmentWriter(w, num, pre, **kw)
        for sizes in pieces:
            fw.feed(sizes, bytes((num + i) % 256 for i in range(sum(sizes))))
        fw.close()
        fw.close()                                # closing twice: one fragment
    w.end_sequence()
    return sink.getvalue()


def _runs(seed):
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(3):
        sizes = rng.integers(1, 300, rng.integers(1, 40)).tolist()
        cuts = sorted(rng.choice(len(sizes) + 1, 2).tolist())
        runs.append([sizes[:cuts[0]], sizes[cuts[0]:cuts[1]],
                     sizes[cuts[1]:]])
    return runs


_WRITER_CASES = {
    "seed1_F512": (512, _runs(1)),
    "seed2_F100": (100, _runs(2)),
    "seed3_F4096": (4096, _runs(3)),
    "slice_over_F": (64, [[[10, 200, 30, 64, 65, 1]]]),
    "empty_picture": (512, [[[]], [[7, 9]]]),
}


@pytest.mark.parametrize("case", list(_WRITER_CASES))
def test_fragment_writer_matches_vc2tpu(case):
    length, runs = _WRITER_CASES[case]
    got = _stream(tdu, tcfg, thdr, length, runs)
    want = _stream(jdu, jcfg, jhdr, length, runs)
    assert got == want
    frags = _fragments(tdu, got)
    assert frags == _fragments(jdu, want)
    for pieces, pic_frags in zip(runs, _by_picture(frags)):
        sizes = [s for p in pieces for s in p]
        assert pic_frags[0]["n_slices"] == 0           # the preamble
        body = pic_frags[1:]
        assert sum(f["n_slices"] for f in body) == len(sizes)
        if not sizes:
            assert len(body) == 1                      # the empty last one
        for f in body:
            assert f["n_slices"] >= 1 or not sizes
            assert f["data_length"] <= length or f["n_slices"] == 1


def _fragments(mod, data):
    """Every fragment's picture number and header fields, read with
    ``mod``'s StreamReader."""
    out, pos, version = [], 0, 0
    while pos + 13 <= len(data):
        rd = mod.StreamReader(data[pos:])
        rd.major_version = version
        du, next_off, _prev = rd.read_data_unit()
        if du == mod.DataUnitType.SEQUENCE_HEADER:
            rd.read_sequence_header()
            version = rd.major_version
        elif du == mod.DataUnitType.HQ_FRAGMENT:
            pic = rd.read_picture_number()
            frag = rd.read_fragment_header()
            out.append(dict(dataclasses.asdict(frag), picture=pic))
        if next_off == 0:
            break
        pos += next_off
    return out


def _by_picture(frags):
    pics = {}
    for f in frags:
        pics.setdefault(f["picture"], []).append(f)
    return list(pics.values())


def test_fragments_raise_the_stream_to_version_3():
    got = _stream(tdu, tcfg, thdr, 512, [[[5, 5]]])
    want = _stream(jdu, jcfg, jhdr, 512, [[[5, 5]]])
    assert got == want
    rd = tdu.StreamReader(got)
    rd.read_data_unit()
    assert rd.read_sequence_header().major_version == 3


def test_fragment_writer_rejects_a_mismatched_span():
    w = tdu.StreamWriter(io.BytesIO())
    w.fragment_length = 512
    pre = tdu.PicturePreamble(wavelet_kernel=tcfg.WaveletKernel(1), depth=2,
                              slices_x=2, slices_y=1, slice_prefix=0,
                              slice_size_scalar=1)
    fw = w.begin_fragments(0, pre)
    before = w.f.getvalue()
    with pytest.raises(ValueError, match="fragment span"):
        fw.feed([3, 4], b"abc")
    assert w.f.getvalue() == before                  # nothing written
    with pytest.raises(ValueError, match="slice sizes"):
        w.write_picture(1, pre, b"abcd")


# --- the decoder's fragment reassembly --------------------------------------

def _fragment_units(data):
    """(offset, length, picture number, slices) of every HQ fragment."""
    out, pos = [], 0
    while pos + 13 <= len(data):
        rd = tdu.StreamReader(data[pos:])
        du, next_off, _ = rd.read_data_unit()
        if du == tdu.DataUnitType.HQ_FRAGMENT:
            pic = rd.read_picture_number()
            n = rd.read_fragment_header().n_slices
            out.append((pos, next_off, pic, n))
        if next_off == 0:
            break
        pos += next_off
    return out


def _decode(data, **kw):
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu", **kw).run(data) == 0
    return sink.getvalue()


def test_repeated_fragment_counts_once():
    """A fragment of slices sent twice: its span is counted once, so the
    picture completes at its real last fragment."""
    data = _read("cbr_fragmented.vc2")
    pos, size, _pic, n = _fragment_units(data)[1]
    assert n > 0
    twice = data[:pos + size] + data[pos:]
    assert _decode(twice) == _read("cbr_fragmented.dec.16p2")


@pytest.mark.parametrize("damage", ["corrupt_slices", "no_preamble"])
def test_damaged_fragmented_picture_is_skipped(damage, capsys):
    """A fragmented picture whose slices are corrupt, or whose preamble
    fragment is lost, is skipped; the other pictures decode."""
    data = bytearray(_read("cbr_fragmented.vc2"))
    want = _read("cbr_fragmented.dec.16p2")
    frags = [f for f in _fragment_units(bytes(data)) if f[2] == 0]
    if damage == "no_preamble":
        pos, size, _pic, _n = frags[0]
        data = data[:pos] + data[pos + size:]
    else:
        # the first picture's last fragment declares 100 bytes fewer than
        # it holds: the assembled slice chain runs past its end
        pos, _size, _pic, _n = frags[-1]
        at = pos + 13 + 4
        short = int.from_bytes(data[at:at + 2], "big") - 100
        data[at:at + 2] = short.to_bytes(2, "big")
    got = _decode(bytes(data))
    assert len(got) == len(want) // 2 and want.endswith(got)
    if damage == "corrupt_slices":
        assert "Failed to decode fragmented picture" in capsys.readouterr().err


def test_zero_slice_fragment_series_is_skipped_as_vc2tpu_skips_it(tmp_path):
    """A fragment series whose transform parameters give 0 x 0 slices,
    inserted after the sequence header: vc2tpu's decoder skips it (it
    catches the ZeroDivisionError of its geometry), and so does the port,
    with the same output and exit code 0."""
    data = _read("cbr_fragmented.vc2")
    rd = tdu.StreamReader(data)
    _du, first, _prev = rd.read_data_unit()
    rd.read_sequence_header()
    sink = io.BytesIO()
    w = tdu.StreamWriter(sink)
    w.major_version = rd.major_version
    w.fragment_length = 512
    pre = tdu.PicturePreamble(wavelet_kernel=tcfg.WaveletKernel(1), depth=2,
                              slices_x=0, slices_y=0, slice_prefix=0,
                              slice_size_scalar=1)
    w.begin_fragments(77, pre)                   # the preamble fragment
    # then one fragment of 2 slices of 8 bytes at slice (0, 0)
    body = ((77).to_bytes(4, "big") + (16).to_bytes(2, "big")
            + (2).to_bytes(2, "big") + bytes(4) + bytes(16))
    sink.write(b"BBCD" + bytes([tdu.PARSE_CODES[tdu.DataUnitType
                                                .HQ_FRAGMENT]])
               + (13 + len(body)).to_bytes(4, "big") + bytes(4) + body)
    data = data[:first] + sink.getvalue() + data[first:]
    want = io.BytesIO()
    assert j_cli.Decoder(sink=want).run(data) == 0
    assert want.getvalue() == _read("cbr_fragmented.dec.16p2")
    assert _decode(data) == want.getvalue()
    src, out = tmp_path / "in.vc2", tmp_path / "out.16p2"
    src.write_bytes(data)
    assert decode_stream.main([str(src), str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == want.getvalue()


def test_truncated_fragmented_stream_decodes_a_prefix():
    data = _read("cbr_fragmented.vc2")
    want = _read("cbr_fragmented.dec.16p2")
    got = _decode(data[:len(data) * 3 // 4])
    assert want.startswith(got) and len(got) < len(want)


# --- the decoder's tap outputs ----------------------------------------------

_TAPS = [(c, o) for c in ("constq_legall_d2", "cbr_fragmented",
                          "constq_interlaced")
         for o in ("Transform", "Quantised", "Indices")]


@pytest.mark.parametrize("case,output", _TAPS,
                         ids=[f"{c}-{o}" for c, o in _TAPS])
def test_decoder_tap_matches_vc2tpu(case, output):
    data = _read(f"{case}.vc2")
    want = io.BytesIO()
    assert j_cli.Decoder(output=jcfg.DecOutput(output), sink=want).run(
        data) == 0
    got = _decode(data, output=tcfg.DecOutput(output))
    assert got and got == want.getvalue()
