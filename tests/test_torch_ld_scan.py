"""The LD host scan in its two native phases (``csrc/ld_scan.cpp``):
``ld_read`` (every slice's header fields, q index and LL codes into the
three compact grids) and then ``ld_dequantise_grid`` once a grid (the
serial DC-prediction recurrence). Held on seeded random payloads to
``ld_scan_plain`` and to the SHA-256 of what the one-pass entry they
replace gave on the same inputs; the ``-1`` (fields past int32) and
``-2`` (an LL code outside its grid) returns and their errors, raised
before any recurrence runs; under ``torch.profiler`` each picture of an
LD decode gives one ``dec.ld_read`` and one ``dec.ld_dc`` inside its
``dec.scan``, and none without one; on the card, ``ld_unpack`` launches
once a picture. The file imports neither jax nor vc2tpu."""

import dataclasses
import hashlib
import io
import os
import time

import numpy as np
import pytest
import torch

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.core import trace
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices import ld as tld
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader
from vc2tpu_torch.vlc import device_unpack as du
from vc2tpu_torch.wavelet import matrices

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = [torch.profiler.ProfilerActivity.CPU]

# name: (y slices, x slices, luma slice, chroma slice, depth, picture bytes)
GEOMETRIES = {
    "422_d2": (5, 7, (8, 8), (8, 4), 2, 35 * 21 + 3),
    "sizes_25_26": (9, 16, (8, 8), (8, 4), 2, 3686),   # 1080p LD's sizes
    "444_d3": (3, 4, (16, 16), (16, 16), 3, 12 * 60),
    "420_d1": (4, 4, (4, 8), (2, 4), 1, 16 * 9 + 5),
}
# payload kinds: uniform random bytes; mostly zero bytes (long codes up to
# the 64-bit clamp); random bytes cut short at two thirds (1-bits past the
# end)
CASES = [(g, kind, seed) for g in GEOMETRIES
         for kind in ("random", "sparse", "cut_short") for seed in (0, 1)]

# SHA-256 of the one-pass entry's result (q, fields, the three grids, end)
# on each case
ONE_PASS = {
    ("422_d2", "random", 0):
        "18d9c22062e75790ae50696ce1f5444f552ba3370f093eb64d0919c0bac53281",
    ("422_d2", "random", 1):
        "8c2ebb929b2906e815e28daf2315456f72e2ad80130ce826bdd62593c8dc37a4",
    ("422_d2", "sparse", 0):
        "109c3d07d8c7bbfc5ae52e3bd363a185bb645b8fc037bc593baa1954305dd2fb",
    ("422_d2", "sparse", 1):
        "b7f27779f87cc3d326f805421cbf32291edd267bc4978fb933ed762888a8e00d",
    ("422_d2", "cut_short", 0):
        "aecc04a34fc3a43b5fe6b9330bcf9f65fdc2e8911ec0e36e3b7f8b7cb8a45350",
    ("422_d2", "cut_short", 1):
        "af65307509c9541e2f4fed82c6eb428bf1e9e682639f659cc3d65b0c74d28199",
    ("sizes_25_26", "random", 0):
        "994da10f2c1b00913d0f3ce09d623f23e5a4f1ad2860f7f774e0aa948ceb5a43",
    ("sizes_25_26", "random", 1):
        "9aab453ef95c0f5c9b284bd1e0b071cde1d1beb35b7df337e39b7413edfdd9a3",
    ("sizes_25_26", "sparse", 0):
        "e7e397704a4c22930ee0a16ace23deb4f2db5d0edc1c1b75d80fb09192a31719",
    ("sizes_25_26", "sparse", 1):
        "a7674fe17429a1246fd12f4ac85ca69743b69672f6b474f215f3466e76e5ff88",
    ("sizes_25_26", "cut_short", 0):
        "85ed111fa28dd9a14638c4868446aabcf0e0838045980000f092f43c52703faf",
    ("sizes_25_26", "cut_short", 1):
        "2d885161dafbf39914d2d0eba0d4489cf9f315d8885053ffa67f05346cb814a4",
    ("444_d3", "random", 0):
        "14aa27eadd60b5a6c50e9aa0cceca6c7a8ab15c85badb05c238a98901a7c454b",
    ("444_d3", "random", 1):
        "8fa629ff75f053c66c3702c434c0c33617f7cf639b6ff89c40ccc1d9eba79f1a",
    ("444_d3", "sparse", 0):
        "e0724d1aed072f7eac7a0595fb7e5e6ab6824fcb9d6e164d2a9e62b233633a88",
    ("444_d3", "sparse", 1):
        "04611d3ad895eb149b888f4edf199e281433f7a257ac5c6377882a2bf13ffc68",
    ("444_d3", "cut_short", 0):
        "f8aaf11181c57d6a37ad03530240ba6eb4371e39e031fec42050a1fca5195d14",
    ("444_d3", "cut_short", 1):
        "d199bbaa76f72221cc5cd0b1b88557b210d571993debff32015d0c6b6386389b",
    ("420_d1", "random", 0):
        "dce8f9f46ecbce281bc81c88d2c6a801e56c6ad2219be1011367cbdf2cbb3975",
    ("420_d1", "random", 1):
        "30bf4efb2d9f05a9532bdea2bbf7c9b8b9677fb41de8846350f8f3766e9224fa",
    ("420_d1", "sparse", 0):
        "02da50fa6d4a16d9ec296596803b0c677fae50d0d61c87f9fadb2cb9527398c6",
    ("420_d1", "sparse", 1):
        "7de34480bc885230bedacf3b113374d6b75d9ab2b3d07f4e9d60f2889f866264",
    ("420_d1", "cut_short", 0):
        "b82475414e0c03b8281e429eb11071a8c6147797bf381f53b5415682c52edb38",
    ("420_d1", "cut_short", 1):
        "f3e6c1fa6a881add33b38b72f17640d416cf7edef664d894865ad47352732078",
}


def _geometry(name):
    ys, xs, (sh, sw), (ch, cw), depth, nbytes = GEOMETRIES[name]
    geo = SliceGeometry(ys, xs, (sh * ys, sw * xs), (ch * ys, cw * xs),
                        (sh, sw), (ch, cw))
    return geo, depth, layout.slice_bytes_map(ys, xs, nbytes, 1).ravel()


def _case(name, kind, seed):
    """``ld_scan``'s arguments: (payload bytes, slice sizes, geometry,
    depth, quant matrix, start)."""
    geo, depth, sizes = _geometry(name)
    rng = np.random.default_rng([seed, sum(map(ord, name + kind))])
    start = int(rng.integers(0, 40))
    n = start + int(sizes.sum())
    payload = rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "sparse":
        payload[rng.random(n) < 0.9] = 0
    if kind == "cut_short":
        payload = payload[:start + int(sizes.sum()) * 2 // 3]
    qm = matrices.quant_matrix(tcfg.WaveletKernel.LeGall, depth)
    return payload.tobytes(), sizes, geo, depth, qm, start


def _digest(scan):
    h = hashlib.sha256()
    for a in (scan.q, scan.fields, *scan.grids):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(str(scan.end).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name,kind,seed", CASES,
                         ids=[f"{g}-{k}-{s}" for g, k, s in CASES])
def test_split_scan_equals_one_pass_and_plain(name, kind, seed):
    args = _case(name, kind, seed)
    got = tld.ld_scan(*args)
    want = tld.ld_scan_plain(*args)
    assert np.array_equal(got.q, want.q)
    assert np.array_equal(got.fields, want.fields)
    assert got.end == want.end
    for g, w in zip(got.grids, want.grids):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert _digest(got) == ONE_PASS[name, kind, seed]


class _Recording:
    """``ld_scan``'s library with each return of ``ld_read`` and each call
    of ``ld_dequantise_grid`` kept."""

    def __init__(self, lib):
        self.lib, self.reads, self.grids = lib, [], 0

    def ld_read(self, *args):
        self.reads.append(self.lib.ld_read(*args))
        return self.reads[-1]

    def ld_dequantise_grid(self, *args):
        self.grids += 1
        return self.lib.ld_dequantise_grid(*args)


@pytest.fixture
def recording(monkeypatch):
    lib = _Recording(tld._lib())
    monkeypatch.setattr(tld, "_lib", lambda: lib)
    return lib


def test_recording_sees_both_phases(recording):
    args = _case("422_d2", "random", 0)
    assert _digest(tld.ld_scan(*args)) == ONE_PASS["422_d2", "random", 0]
    assert recording.reads == [args[-1] + int(args[1].sum())]
    assert recording.grids == 3


def test_fields_past_int32_raise_before_the_recurrence(recording):
    """A picture whose slices start past byte 2**28: the first slice's
    bit offset leaves int32, and ``ld_read`` returns -1 at once."""
    payload, sizes, geo, depth, qm, _start = _case("422_d2", "random", 0)
    args = (payload, sizes, geo, depth, qm, 2**28)
    msg = "LD slice fields exceed the int32 range"
    with pytest.raises(ValueError, match=msg):
        tld.ld_scan(*args)
    with pytest.raises(ValueError, match=msg):
        tld.ld_scan_plain(*args)
    assert recording.reads == [-1] and recording.grids == 0


def test_ll_code_outside_its_grid_raises_before_the_recurrence(
        recording, monkeypatch):
    """Chroma LL offsets moved one grid on (no encoder's geometry gives
    such offsets): ``ld_read`` walks every slice and returns -2."""
    real = tld._geometries

    def shifted(geo, depth):
        gl, gc = real(geo, depth)
        return gl, dataclasses.replace(gc, offset=gc.offset + gc.llh * gc.llw)

    monkeypatch.setattr(tld, "_geometries", shifted)
    args = _case("422_d2", "random", 0)
    with pytest.raises(ValueError, match=tld._LL_OUTSIDE):
        tld.ld_scan(*args)
    with pytest.raises(ValueError, match=tld._LL_OUTSIDE):
        tld.ld_scan_plain(*args)
    assert recording.reads == [-2] and recording.grids == 0


def _stream(case):
    with open(os.path.join(GOLDEN, case + ".vc2"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, case + ".dec.16p2"), "rb") as f:
        return data, f.read()


def _ld_units(data) -> int:
    """The LD picture data units of a stream."""
    count, pos = 0, 0
    while pos + 13 <= len(data):
        du, next_off, _ = StreamReader(data[pos:]).read_data_unit()
        count += du == DataUnitType.LD_PICTURE
        if next_off == 0:
            break
        pos += next_off
    return count


def _decode(case, device):
    data, want = _stream(case)
    sink = io.BytesIO()
    assert Decoder(sink=sink, device=device).run(data) == 0
    assert sink.getvalue() == want
    return _ld_units(data)


LD_STREAMS = ["ld_legall_d2", "ld_midsize", "ld_interlaced"]


@pytest.mark.parametrize("case", LD_STREAMS)
def test_profiled_decode_spans_both_phases_in_each_scan(case):
    t0 = trace.clock()
    with torch.profiler.profile(activities=CPU):
        units = _decode(case, "cpu")
    got = [r for r in trace.records() if r.start >= t0]
    scans = [r for r in got if r.name == "dec.scan"]
    assert len(scans) == units > 0
    for name in ("dec.ld_read", "dec.ld_dc"):
        phase = [r for r in got if r.name == name]
        assert len(phase) == units
        for r in phase:
            assert sum(s.picture == r.picture and s.start <= r.start
                       and r.end <= s.end for s in scans) == 1
    for s in scans:
        read, dc = (next(r for r in got if r.name == name
                         and s.start <= r.start and r.end <= s.end)
                    for name in ("dec.ld_read", "dec.ld_dc"))
        assert read.end <= dc.start


def test_no_profiler_keeps_no_phase():
    t0 = time.perf_counter()
    _decode("ld_legall_d2", "cpu")
    assert not [r for r in trace.records() if r.start >= t0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ld_legall_d2", "ld_midsize"])
def test_ld_unpack_launches_once_a_picture(case, cuda):
    before = du.unpack_ld.launches
    units = _decode(case, None)
    assert units > 0 and du.unpack_ld.launches - before == units
