"""The reference codec (``benchmark/reference``) against the repository's
goldens (the bbc/vc2-reference binaries' streams and decodes) and the 1080p
fixtures (the JAX package's encodes and decodes), on the CPU."""

from __future__ import annotations

import hashlib
import json
import os
import sys

import pytest
import torch

from reference.codec import Codec, planes_of
from tiny import ROOT

GOLDEN = os.path.join(ROOT, "tests", "golden")
FIXTURES = os.path.join(ROOT, "vc2tpu_torch", "testdata")
CASES = ("cbr_legall_d2", "cbr_scalar2_prefix3", "ld_legall_d2",
         "cbr_midsize", "ld_midsize")


def coding_of(inp: dict, args: list) -> dict:
    a = dict(zip(args[::2], args[1::2]))
    return {"width": inp["width"], "height": inp["height"],
            "chroma": inp["fmt"], "depth_bits": inp["depth"],
            "frame_rate": 3, "mode": a["-m"], "kernel": a["-k"],
            "wavelet_depth": int(a["-d"]),
            "slice_units": [int(a["-u"]), int(a["-a"])],
            "compressed_bytes": int(a["-s"]),
            "slice_scalar": int(a.get("-S", 1)),
            "slice_prefix": int(a.get("-P", 0))}


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", CASES)
def test_goldens(case):
    """Stream bytes and decode bytes equal the goldens', every picture."""
    with open(os.path.join(GOLDEN, "meta.json")) as f:
        meta = json.load(f)
    _name, inp, args = next(c for c in meta["cases"] if c[0] == case)
    info = meta["inputs"][inp]
    codec = Codec(coding_of(info, args), "cpu")
    raw = read(os.path.join(GOLDEN, inp + ".16p2"))
    size = sum(h * w for h, w in codec.dims) * 2
    pictures = [planes_of(raw[k * size:(k + 1) * size], codec.dims,
                          info["depth"]) for k in range(info["frames"])]
    coded = codec.encode(pictures)
    assert codec.stream([c.body for c in coded]) == read(
        os.path.join(GOLDEN, case + ".vc2"))
    assert b"".join(c.decoded for c in coded) == read(
        os.path.join(GOLDEN, case + ".dec.16p2"))


@pytest.mark.parametrize("name,mode", [("cbr_1080p", {"mode": "HQ_CBR",
                                                      "slice_scalar": 2}),
                                       ("ld_1080p", {"mode": "LD"})])
def test_1080p_fixtures(name, mode, tmp_path):
    """The 1080p fixture picture codes to the committed stream, and its
    decode has the SHA-256 of the JAX package's decode."""
    sys.path.insert(0, FIXTURES)
    try:
        from make_1080p import make_input
    finally:
        sys.path.remove(FIXTURES)
    make_input(str(tmp_path / "hd.16p2"))
    with open(os.path.join(FIXTURES, "fixtures_1080p.json")) as f:
        record = json.load(f)["streams"][name]
    coding = {"width": 1920, "height": 1080, "chroma": "4:2:2",
              "depth_bits": 10, "frame_rate": 3, "kernel": "LeGall",
              "wavelet_depth": 2, "slice_units": [2, 2],
              "compressed_bytes": 829440, "slice_scalar": 1,
              "slice_prefix": 0, **mode}
    codec = Codec(coding, "cpu")
    (coded,) = codec.encode([planes_of(read(str(tmp_path / "hd.16p2")),
                                       codec.dims, 10)])
    assert codec.stream([coded.body]) == read(
        os.path.join(FIXTURES, record["stream"]))
    assert len(coded.decoded) == record["decoded_bytes"]
    assert hashlib.sha256(coded.decoded).hexdigest() == \
        record["decoded_sha256"]


def test_ld_batch_equals_one_at_a_time():
    """The LD rate control's batch of pictures in lockstep codes each as
    alone."""
    import pictures
    from tiny import config, traffic

    coding = config("LD")["coding"]
    spec = dict(traffic("decode_closed")["pictures"], distinct=3)
    planes, _ = pictures.make(coding, spec, 11, "cpu")
    codec = Codec(coding, "cpu")
    together = codec.encode(planes)
    alone = [codec.encode([p])[0] for p in planes]
    assert [c.body for c in together] == [c.body for c in alone]
    assert [c.decoded for c in together] == [c.decoded for c in alone]


def test_pictures_follow_the_seed():
    import pictures
    from tiny import config, traffic

    coding = config()["coding"]
    spec = traffic("decode_closed")["pictures"]
    a = pictures.make(coding, spec, 2**31 + 99, "cpu")[1]
    b = pictures.make(coding, spec, 2**31 + 99, "cpu")[1]
    c = pictures.make(coding, spec, 7, "cpu")[1]
    assert a == b and a != c
    assert len(set(a)) == spec["distinct"]
    assert torch.tensor(len(a[0])) == 64 * 32 * 2 * 2
