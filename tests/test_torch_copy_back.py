"""The decoder's handoff of its DECODED output to the sink
(``Decoder._copy_back_async`` / ``Decoder._flush``).

A sink that keeps every object it is given, with no copy, as the
benchmark's planar sink keeps its sample, must still hold each picture's
bytes once the stream has ended: the decoder never hands it a buffer that
it fills again. The pictures come out whole and in stream order, each as
a ``memoryview`` (no ``bytes`` copy).

On the CPU (the unmarked tests) the sink gets a view of the decoded bytes
themselves and no ring is used. On the card (the tests marked ``cuda``,
which skip without one) every picture goes through the pinned ring: over
more pictures than the FIFO holds (slots reused), a geometry that changes
mid-stream (slots replaced), interlaced field pairs, the 1080p fixtures
and a ``--mesh 1x3`` decode on one card, with the ring's counts. The file
imports neither jax nor vc2tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_copy_back.py
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from vc2tpu_torch.cli.decode_stream import Decoder

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = os.path.join(os.path.dirname(__file__), os.pardir, "vc2tpu_torch",
                        "testdata")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    _META = json.load(_f)
_FRAMES = {c[0]: _META["inputs"][c[1]]["frames"] for c in _META["cases"]}
with open(os.path.join(FIXTURES, "fixtures_1080p.json")) as _f:
    _HD = json.load(_f)["streams"]

# streams made of goldens (and 1080p fixtures) one after another: each part
# brings its sequence header, so the geometry changes where the part does
SEVERAL = ["constq_legall_d2", "cbr_legall_d2", "ld_legall_d2",
           "cbr_fragmented", "constq_haar0_d2"]
GEOMETRIES = ["cbr_legall_d2", "cbr_midsize", "constq_dd137_d2",
              "ld_midsize", "constq_interlaced", "cbr_16bit", "ld_1080p",
              "cbr_legall_d2"]
INTERLACED = ["cbr_interlaced", "constq_420_interlaced", "ld_interlaced",
              "constq_interlaced"]
STREAMS = {**{c: [c] for c in _FRAMES}, "several": SEVERAL,
           "geometries": GEOMETRIES}


class KeepingSink:
    """Keeps a reference to every object written, as the benchmark's
    ``PlanarSink`` keeps its sample: no copy."""

    def __init__(self):
        self.kept = []

    def write(self, data):
        self.kept.append(data)
        return len(data)


def _part(name: str) -> tuple:
    """(stream bytes, [each picture's decoded bytes or SHA-256]) of a
    golden or a 1080p fixture."""
    if name in _HD:
        with open(os.path.join(FIXTURES, _HD[name]["stream"]), "rb") as f:
            return f.read(), [_HD[name]["decoded_sha256"]]
    with open(os.path.join(GOLDEN, name + ".vc2"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, name + ".dec.16p2"), "rb") as f:
        want = f.read()
    n = len(want) // _FRAMES[name]
    return data, [want[i:i + n] for i in range(0, len(want), n)]


def _stream(parts) -> tuple:
    got = [_part(p) for p in parts]
    return b"".join(d for d, _ in got), [w for _, ws in got for w in ws]


def _decode(parts, record=None, **kw) -> tuple:
    """Decode ``parts`` one after another into a KeepingSink; returns
    (decoder, kept, wanted pictures). ``record``, a list, gets each output
    tensor the FIFO was given."""
    data, want = _stream(parts)
    sink = KeepingSink()
    dec = Decoder(sink=sink, **kw)
    if record is not None:
        real = dec._copy_back_async

        def recording(words):
            record.append(words)
            return real(words)
        dec._copy_back_async = recording
    assert dec.run(data) == 0
    return dec, sink.kept, want


def _check_kept(kept, want):
    """Each kept object a whole picture's bytes as a memoryview, in stream
    order, on a buffer of its own."""
    assert len(kept) == len(want)
    for got, w in zip(kept, want):
        assert isinstance(got, memoryview) and got.c_contiguous
        assert got.format == "B" and got.ndim == 1
        if isinstance(w, str):
            assert hashlib.sha256(got).hexdigest() == w
        else:
            assert bytes(got) == w
    arrays = [np.asarray(k) for k in kept]
    for i, a in enumerate(arrays):
        assert not any(np.shares_memory(a, b) for b in arrays[i + 1:])


@pytest.mark.parametrize("stream", list(STREAMS))
def test_kept_outputs_hold_every_picture(stream):
    words = []
    dec, kept, want = _decode(STREAMS[stream], record=words, device="cpu")
    _check_kept(kept, want)
    assert dec.frames_out == len(want) == len(words)
    # the CPU path hands over the decoded bytes themselves: no copy, no ring
    for got, w in zip(kept, words):
        assert np.shares_memory(np.asarray(got), w.numpy())
    assert (dec.copy_back_ring, dec.copy_back_slots,
            dec.copy_back_waited) == (0, 0, 0)


# --- the pinned ring, on the card -------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _check_ring(dec, kept, want):
    _check_kept(kept, want)
    assert dec.copy_back_ring == dec.frames_out == len(want)
    assert 0 <= dec.copy_back_waited <= dec.copy_back_ring
    # no kept picture is a view of a slot the ring still holds
    for slot in dec._slots:
        assert not any(np.shares_memory(np.asarray(k), slot.numpy())
                       for k in kept)


RING = {
    # more pictures than the FIFO holds, one geometry: the slots reused
    "several": (SEVERAL * 2, 3),
    # a geometry that changes mid-stream: slots replaced, never more
    # than the FIFO's three held at once
    "geometries": (GEOMETRIES, 3 * len(GEOMETRIES)),
    "interlaced": (INTERLACED * 2, 3 * 2 * len(INTERLACED)),
    "1080p": (["constq_1080p", "cbr_1080p", "ld_1080p"] * 3, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RING))
def test_ring_keeps_every_picture(case, cuda):
    parts, most_slots = RING[case]
    dec, kept, want = _decode(parts)
    _check_ring(dec, kept, want)
    assert 1 <= dec.copy_back_slots <= most_slots
    assert len(dec._slots) <= dec._depth


@pytest.mark.cuda
def test_ring_over_a_mesh_of_one_card(cuda):
    from vc2tpu_torch.shard.mesh import make_mesh

    mesh = make_mesh(1, 3, devices=["cuda:0"] * 3)
    dec, kept, want = _decode(["cbr_1080p", "constq_1080p"] * 2
                              + ["cbr_legall_d2"], mesh=mesh)
    _check_ring(dec, kept, want)
    assert dec.sharded_decoders()
