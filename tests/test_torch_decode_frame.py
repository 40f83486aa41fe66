"""The port's DecodeFrame CLI on the CPU (``--device cpu``): the HQ
packaged golden decodes to the stream decode's pixels and to the golden
Quantised tap; a truncated input and an LD run with no ``-s`` fail with
exit code 1; and an LD Packaged tap, encoded in the test by vc2tpu's
encoder from ``tiny422.16p2`` (two frames), decodes in each output equal
to ``vc2tpu.cli.decode_frame`` on the same bytes."""

import os

import pytest

from vc2tpu.cli import decode_frame as j_frame
from vc2tpu.cli import encode_stream as j_encode

from vc2tpu_torch.cli import decode_frame

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GEOMETRY = ["-x", "64", "-y", "32", "-f", "4:2:2", "-l", "10", "-n", "2",
            "-k", "LeGall", "-d", "2", "-u", "1", "-a", "2"]
HQ = ["-m", "HQ"] + GEOMETRY
LD = ["-m", "LD"] + GEOMETRY


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _port(argv, src, out):
    return decode_frame.main(argv + ["--device", "cpu", str(src), str(out)])


def test_decode_frame_matches_stream_decode(tmp_path):
    out = tmp_path / "df.16p2"
    assert _port(HQ, os.path.join(GOLDEN, "constq_legall_d2.packaged.raw"),
                 out) == 0
    assert out.read_bytes() == _read(os.path.join(GOLDEN,
                                                  "constq_legall_d2.dec.16p2"))


def test_decode_frame_quantised_tap(tmp_path):
    out = tmp_path / "df.quant.raw"
    assert _port(HQ + ["-o", "Quantised"],
                 os.path.join(GOLDEN, "constq_legall_d2.packaged.raw"),
                 out) == 0
    assert out.read_bytes() == _read(
        os.path.join(GOLDEN, "constq_legall_d2.quantised.raw"))


def test_decode_frame_truncated_input_errors(tmp_path):
    src = tmp_path / "short.raw"
    src.write_bytes(_read(os.path.join(
        GOLDEN, "constq_legall_d2.packaged.raw"))[:40])
    assert _port(HQ, src, tmp_path / "out.16p2") == 1


def test_decode_frame_ld_requires_compressed_bytes(tmp_path):
    src = tmp_path / "in.raw"
    src.write_bytes(b"\x00" * 256)
    assert _port(LD, src, tmp_path / "out.16p2") == 1


@pytest.fixture(scope="module")
def ld_packaged(tmp_path_factory):
    """An LD Packaged tap of the two tiny422 frames, by vc2tpu's encoder."""
    path = tmp_path_factory.mktemp("ld") / "ld.packaged.raw"
    argv = GEOMETRY + ["-m", "LD", "-s", "2048", "-o", "Packaged",
                       os.path.join(GOLDEN, "tiny422.16p2"), str(path)]
    assert j_encode.main(argv) == 0
    return path


@pytest.mark.parametrize("output", ["Decoded", "Transform", "Quantised",
                                    "Indices"])
def test_decode_frame_ld_matches_vc2tpu(output, ld_packaged, tmp_path):
    argv = LD + ["-s", "2048", "-o", output]
    want, got = tmp_path / "want.raw", tmp_path / "got.raw"
    assert j_frame.main(argv + [str(ld_packaged), str(want)]) == 0
    assert _port(argv, ld_packaged, got) == 0
    assert got.read_bytes() and got.read_bytes() == want.read_bytes()
