"""The port's decode on the CPU: every HQ golden (``cbr_fragmented``
among them) and every LD golden (``ld_fragmented`` and ``ld_interlaced``
among them) decodes byte-identically through ``Decoder(device="cpu")``;
the payload-level decode equals vc2tpu's ``synthesise_payload_to_words``;
a picture whose header gives no slices or an LD byte fraction over zero
is skipped as vc2tpu's decoder skips it; and a kernel failure propagates
instead of being skipped as a corrupt picture. The tap outputs and the
fragment reassembly have their own tests (tests/test_torch_fragments.py,
tests/test_torch_ld.py)."""

import io
import json
import os

import numpy as np
import pytest

from vc2tpu.cli import decode_stream as j_cli
from vc2tpu.core.config import PictureGeometry as JPG
from vc2tpu.core.config import WaveletKernel as JK
from vc2tpu.pipeline import decoder as jdec
from vc2tpu.pipeline.encoder import SliceGeometry as JSG

from vc2tpu_torch.cli import decode_stream
from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core.config import PictureGeometry, WaveletKernel
from vc2tpu_torch.pipeline import decoder as tdec
from vc2tpu_torch.stream.dataunit import (PARSE_CODES, DataUnitType,
                                          PicturePreamble, StreamReader,
                                          StreamWriter)
from vc2tpu_torch.vlc import device_unpack
from vc2tpu_torch.wavelet import bands, matrices

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    _CASES = [c[0] for c in json.load(_f)["cases"]]
HQ = [c for c in _CASES if not c.startswith("ld")]
LD = [c for c in _CASES if c.startswith("ld")]


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _decode(data, **kw):
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu", **kw).run(data) == 0
    return sink.getvalue()


@pytest.mark.parametrize("case", HQ)
def test_hq_golden_byte_identical(case):
    assert _decode(_read(f"{case}.vc2")) == _read(f"{case}.dec.16p2")


def _first_picture(data):
    dec = Decoder(sink=io.BytesIO(), device="cpu")
    pos = 0
    while True:
        rd = StreamReader(data[pos:])
        du, next_off, _ = rd.read_data_unit()
        if du == DataUnitType.SEQUENCE_HEADER:
            dec.hdr = rd.read_sequence_header()
            dec._major_version = rd.major_version
        elif du == DataUnitType.HQ_PICTURE:
            return dec.hdr, dec.locate_picture(data[pos:], True)[1]
        pos += next_off


def test_payload_decode_matches_vc2tpu():
    hdr, job = _first_picture(_read("cbr_midsize.vc2"))
    pre, geo = job.pre, job.geo
    qm = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
    out = PictureGeometry.of(job.pic_h, hdr.width, hdr.chroma_format)
    got = tdec.synthesise_payload_to_words(
        job.payload, job.q_idx, job.cbytes, qm, pre.wavelet_kernel,
        pre.depth, geo, out, hdr.bitdepth, pre.slice_prefix, start=job.start,
        device="cpu")
    jgeo = JSG(geo.y_slices, geo.x_slices, geo.padded_luma,
               geo.padded_chroma, geo.luma_slice, geo.chroma_slice)
    jout = JPG(out.luma_height, out.luma_width, out.chroma_height,
               out.chroma_width, int(out.chroma_format))
    words, post = jdec.synthesise_payload_to_words(
        job.payload, job.q_idx, job.cbytes, qm, JK(int(pre.wavelet_kernel)),
        pre.depth, jgeo, jout, hdr.bitdepth, pre.slice_prefix,
        start=job.start)
    assert got.numpy().tobytes() == post(np.asarray(words))


@pytest.mark.parametrize("case", LD)
def test_ld_golden_byte_identical(case):
    assert _decode(_read(f"{case}.vc2")) == _read(f"{case}.dec.16p2")


def _with_corrupt_picture(case, du_type, slices, num_den):
    """The golden stream ``case`` with one picture data unit inserted after
    its sequence header: picture number 77, LeGall depth 2, ``slices``
    (x, y), then the HQ prefix and scalar or the LD byte fraction
    ``num_den``, and 16 zero bytes of slices."""
    data = _read(f"{case}.vc2")
    rd = StreamReader(data)
    _du, first, _prev = rd.read_data_unit()
    rd.read_sequence_header()
    w = StreamWriter(io.BytesIO())
    w.major_version = rd.major_version
    pre = PicturePreamble(wavelet_kernel=WaveletKernel.LeGall, depth=2,
                          slices_x=slices[0], slices_y=slices[1],
                          slice_prefix=num_den[0],
                          slice_size_scalar=num_den[1])
    body = (77).to_bytes(4, "big") + w._transform_params(pre) + bytes(16)
    unit = (b"BBCD" + bytes([PARSE_CODES[du_type]])
            + (13 + len(body)).to_bytes(4, "big") + first.to_bytes(4, "big")
            + body)
    return data[:first] + unit + data[first:]


_CORRUPT = {
    "hq_0x0_slices": ("constq_legall_d2", DataUnitType.HQ_PICTURE, (0, 0),
                      (0, 1)),
    "hq_0_rows": ("constq_legall_d2", DataUnitType.HQ_PICTURE, (4, 0),
                  (0, 1)),
    "ld_denominator_0": ("ld_legall_d2", DataUnitType.LD_PICTURE, (8, 8),
                         (2048, 0)),
    "ld_0x0_slices": ("ld_legall_d2", DataUnitType.LD_PICTURE, (0, 0),
                      (2048, 1)),
}


@pytest.mark.parametrize("case", list(_CORRUPT))
def test_corrupt_picture_header_is_skipped_as_vc2tpu_skips_it(case,
                                                                tmp_path):
    golden, du_type, slices, num_den = _CORRUPT[case]
    data = _with_corrupt_picture(golden, du_type, slices, num_den)
    want = io.BytesIO()
    assert j_cli.Decoder(sink=want).run(data) == 0
    assert want.getvalue() == _read(f"{golden}.dec.16p2")
    assert _decode(data) == want.getvalue()
    src, out = tmp_path / "in.vc2", tmp_path / "out.16p2"
    src.write_bytes(data)
    assert decode_stream.main([str(src), str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == want.getvalue()


def _boom(*_a, **_k):
    raise RuntimeError("kernel launch failed")


# the decode's lift is the band route's kernel (bands.inverse_lanes)
@pytest.mark.parametrize("module,name", [(bands, "inverse_lanes"),
                                         (device_unpack, "unpack_hq")],
                         ids=["lift_level", "unpack_hq"])
def test_kernel_error_propagates(module, name, monkeypatch):
    monkeypatch.setattr(module, name, _boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _decode(_read("constq_legall_d2.vc2"))


def test_truncated_picture_is_skipped():
    """A slice chain running past the end of the stream is a corrupt
    picture (the short-window ValueError): skipped, not an error."""
    data = _read("constq_legall_d2.vc2")
    want = _read("constq_legall_d2.dec.16p2")
    got = _decode(data[:-40])
    assert want.startswith(got) and len(got) < len(want)


def test_cli_main_writes_output(tmp_path):
    out = tmp_path / "out.16p2"
    rc = decode_stream.main([os.path.join(GOLDEN, "cbr_interlaced.vc2"),
                             str(out), "--device", "cpu"])
    assert rc == 0
    assert out.read_bytes() == _read("cbr_interlaced.dec.16p2")


def test_cli_main_fails_on_kernel_error(tmp_path, monkeypatch):
    monkeypatch.setattr(bands, "inverse_lanes", _boom)
    rc = decode_stream.main([os.path.join(GOLDEN, "constq_legall_d2.vc2"),
                             str(tmp_path / "out.16p2"), "--device", "cpu"])
    assert rc != 0
