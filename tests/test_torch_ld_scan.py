"""The LD host scan (``csrc/ld_scan.cpp``) and the LL band's DC prediction
from the unpack's lanes (``quant.ld_dc``).

The host scan in its two native phases, ``ld_read`` (every slice's header
fields, q index and LL codes into the three compact grids) and then
``ld_dequantise_grid`` once a grid (the serial DC-prediction recurrence),
held on seeded random payloads to ``ld_scan_plain`` and to the SHA-256 of
what the one-pass entry they replace gave on the same inputs; the ``-1``
(fields past int32) and ``-2`` (an LL code outside its grid) returns and
their errors, raised before any recurrence runs.

The single-device decode's host half, the header walk ``ld_fields``, held
to ``ld_header_fields`` on the same payloads; ``ld_fields``' ``-1`` and
``ll_sources``' ``-2`` raised before any kernel runs; the LL grids from
the lanes (``ll_grids``: on the CPU the host recurrence over the codes
gathered from ``unpack_ld``'s lanes) held to ``ld_scan_plain``'s, the
kernel's row and column tables to the recurrence's slice and quant matrix
indices, and the TRANSFORM tap through the lanes' grids to the host scan's.
Under ``torch.profiler`` each picture of an LD decode gives one
``dec.ld_read`` inside its ``dec.scan`` and one ``dec.ld_dc`` inside its
``dec.issue``, and none without one. On the card: the DC kernel against
the host recurrence (the 1080p LD fixture; random codes up to the int32
wrap, q indices 0-127 and adjusted ones clamped at 0; 1x1 LL blocks, a
non-square grid, a grid taller than a CTA), ``ld_unpack`` and ``ld_dc``
once a picture, also over a 1x3 mesh of the card, ``ld_card_dc`` every
picture. The file imports neither jax nor vc2tpu."""

import dataclasses
import hashlib
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from vc2tpu_torch.cli import decode_stream
from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import config as tcfg
from vc2tpu_torch.core import trace
from vc2tpu_torch.quant import ld_dc
from vc2tpu_torch.shard.mesh import make_mesh
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices import ld as tld
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader
from vc2tpu_torch.vlc import device_unpack as du
from vc2tpu_torch.wavelet import matrices

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TESTDATA = os.path.join(os.path.dirname(__file__), "..", "vc2tpu_torch",
                        "testdata")
CPU = [torch.profiler.ProfilerActivity.CPU]

# name: (y slices, x slices, luma slice, chroma slice, depth, picture bytes)
GEOMETRIES = {
    "422_d2": (5, 7, (8, 8), (8, 4), 2, 35 * 21 + 3),
    "sizes_25_26": (9, 16, (8, 8), (8, 4), 2, 3686),   # 1080p LD's sizes
    "444_d3": (3, 4, (16, 16), (16, 16), 3, 12 * 60),
    "420_d1": (4, 4, (4, 8), (2, 4), 1, 16 * 9 + 5),
}
# geometries the tests of the LL grids from the lanes add: 1x1 LL blocks
# on a non-square grid of slices
LANE_GEOMETRIES = {**GEOMETRIES,
                   "444_ll1x1": (6, 5, (4, 4), (4, 4), 2, 30 * 7)}
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
    ys, xs, (sh, sw), (ch, cw), depth, nbytes = LANE_GEOMETRIES[name]
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


LANE_CASES = [(g, kind, 0) for g in LANE_GEOMETRIES
              for kind in ("random", "sparse", "cut_short")]


def _lanes_of(payload, geo, fields, device):
    pay = torch.from_numpy(np.array(np.frombuffer(payload, np.uint8)))
    return du.unpack_ld(pay.to(device), torch.from_numpy(fields).to(device),
                        geo.luma_slice[0] * geo.luma_slice[1],
                        geo.chroma_slice[0] * geo.chroma_slice[1])


def _plan(geo, depth, qm, device):
    return ld_dc.plan(geo, depth, tuple(int(v) for v in qm),
                      torch.device(device))


@pytest.mark.parametrize("name,kind,seed", LANE_CASES,
                         ids=[f"{g}-{k}" for g, k, _s in LANE_CASES])
def test_header_walk_and_grids_from_lanes_equal_plain(name, kind, seed):
    """``ld_fields`` gives ``ld_header_fields``' q, fields and end, and no
    grids; the grids from ``unpack_ld``'s lanes (the CPU form of the
    card's DC prediction) are ``ld_scan_plain``'s."""
    payload, sizes, geo, depth, qm, start = _case(name, kind, seed)
    got = tld.ld_fields(payload, sizes, geo, depth, start)
    q, *bits, end = tld.ld_header_fields(payload, sizes, start)
    assert got.q.dtype == np.int32 and np.array_equal(got.q, q)
    assert np.array_equal(got.fields, tld._fields(*bits))
    assert got.end == end and got.grids is None
    want = tld.ld_scan_plain(payload, sizes, geo, depth, qm, start)
    fields = np.concatenate([got.q[None], got.fields])
    lanes = _lanes_of(payload, geo, got.fields, "cpu")
    grids = ld_dc.ll_grids(lanes, torch.from_numpy(fields[0]),
                           _plan(geo, depth, qm, "cpu"))
    for g, w in zip(grids, want.grids, strict=True):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", LANE_GEOMETRIES)
def test_kernel_tables_give_the_recurrence_indices(name):
    """The DC kernel's row and column tables add up to the slice and the
    quant matrix entry that ``ld_dequantise_grid`` computes a cell, and
    each cell's lane holds the code ``LLGeometry`` places there."""
    geo, depth, _sizes = _geometry(name)
    qm = matrices.quant_matrix(tcfg.WaveletKernel.LeGall, depth)
    plan = _plan(geo, depth, qm, "cpu")
    ys, xs, ts = geo.y_slices, geo.x_slices, 1 << depth
    for c, g in zip((plan.luma, plan.chroma), tld._geometries(geo, depth)):
        src, row_q, row_m, col_q, col_m, qm_blk = c.tables
        y, x = np.divmod(np.arange(c.llh * c.llw), c.llw)
        yb = ((y + 1) * ys - 1) // c.llh
        xb = ((x + 1) * xs - 1) // c.llw
        assert np.array_equal(row_q[y] + col_q[x], yb * xs + xb)
        assert np.array_equal(row_m[y] + col_m[x],
                              ((y * ts) % c.sh) * c.sw + (x * ts) % c.sw)
        assert np.array_equal(qm_blk, tld.qm_block(c.sh, c.sw, depth, qm))
        at = g.origins(ys, xs, ts)[:, None] + g.offset[None, :]
        lane = np.arange(ys * xs)[:, None] * (c.sh * c.sw) + np.arange(g.nll)
        assert np.array_equal(src[at.ravel()], lane.ravel())
        assert (src >= 0).sum() == at.size


def test_header_walk_fields_past_int32_raise_before_any_kernel(
        monkeypatch):
    """``ld_fields`` returns -1 at once for slices past byte 2**28, and
    the header walk raises with ``ld_scan``'s message."""
    payload, sizes, geo, depth, _qm, _start = _case("422_d2", "random", 0)
    lib = tld._lib()
    returns = []

    class Recording:
        def ld_fields(self, *args):
            returns.append(lib.ld_fields(*args))
            return returns[-1]

    monkeypatch.setattr(tld, "_lib", Recording)
    with pytest.raises(ValueError,
                       match="LD slice fields exceed the int32 range"):
        tld.ld_fields(payload, sizes, geo, depth, 2**28)
    assert returns == [-1]


def test_ll_code_outside_its_grid_raises_before_any_kernel(monkeypatch):
    """Chroma LL offsets moved one grid on: ``ll_sources`` raises once the
    header walk is done, so a decode skips every picture with no unpack
    and no DC prediction run."""
    real = tld._geometries

    def shifted(geo, depth):
        gl, gc = real(geo, depth)
        return gl, dataclasses.replace(gc, offset=gc.offset + gc.llh * gc.llw)

    ran = []
    monkeypatch.setattr(tld, "_geometries", shifted)
    monkeypatch.setattr(du, "unpack_ld", lambda *a: ran.append("unpack"))
    monkeypatch.setattr(ld_dc, "ll_grids", lambda *a: ran.append("dc"))
    tld.ll_sources.cache_clear()
    try:
        payload, sizes, geo, depth, _qm, start = _case("422_d2", "random", 0)
        with pytest.raises(ValueError, match=tld._LL_OUTSIDE):
            tld.ld_fields(payload, sizes, geo, depth, start)
        data, _want = _stream("ld_legall_d2")
        sink = io.BytesIO()
        assert Decoder(sink=sink, device="cpu").run(data) == 0
        assert sink.getvalue() == b"" and ran == []
    finally:
        tld.ll_sources.cache_clear()


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
    """The header walk inside each picture's ``dec.scan``; the LL grids'
    DC prediction from the lanes inside its ``dec.issue``, after it."""
    t0 = trace.clock()
    with torch.profiler.profile(activities=CPU):
        units = _decode(case, "cpu")
    got = [r for r in trace.records() if r.start >= t0]
    scans = [r for r in got if r.name == "dec.scan"]
    issues = [r for r in got if r.name == "dec.issue"]
    assert len(scans) == units > 0
    for name, outer in (("dec.ld_read", scans), ("dec.ld_dc", issues)):
        phase = [r for r in got if r.name == name]
        assert len(phase) == units
        for r in phase:
            assert sum(s.picture == r.picture and s.start <= r.start
                       and r.end <= s.end for s in outer) == 1
    for s in scans:
        read = next(r for r in got if r.name == "dec.ld_read"
                    and s.start <= r.start and r.end <= s.end)
        dc = next(r for r in got if r.name == "dec.ld_dc"
                  and r.picture == s.picture)
        assert read.end <= s.end <= dc.start


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


def _transform(case, device):
    data, _want = _stream(case)
    sink = io.BytesIO()
    assert Decoder(tcfg.DecOutput.TRANSFORM, sink=sink,
                   device=device).run(data) == 0
    return sink.getvalue()


def _transform_by_host_scan(case, device, monkeypatch):
    """The TRANSFORM tap with each picture's LL grids from the host scan
    (``ld_scan`` over the slices the header walk found) in place of those
    from its lanes."""
    real = decode_stream.unpack_ld_payload

    def host_grids(payload, scan, geo, qmatrix, depth, **kwargs):
        lanes, q, _grids = real(payload, scan, geo, qmatrix, depth, **kwargs)
        starts = scan.fields[0].astype(np.int64) // 8
        sizes = np.diff(np.append(starts, scan.end))
        host = tld.ld_scan(payload, sizes, geo, depth, qmatrix,
                           int(starts[0]))
        assert np.array_equal(host.q, scan.q)
        return lanes, q, [torch.from_numpy(g).to(q.device)
                          for g in host.grids]

    with monkeypatch.context() as m:
        m.setattr(decode_stream, "unpack_ld_payload", host_grids)
        return _transform(case, device)


@pytest.mark.parametrize("case", ["ld_legall_d2", "ld_interlaced"])
def test_transform_tap_equals_the_host_scan_route(case, monkeypatch):
    got = _transform(case, "cpu")
    assert got and got == _transform_by_host_scan(case, "cpu", monkeypatch)


# --- on the card ------------------------------------------------------------

MESH_1X3 = "ld_1080p_mesh1x3"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ld_legall_d2", "ld_midsize",
                                  "ld_interlaced", MESH_1X3])
def test_ld_dc_launches_once_a_picture(case, cuda):
    """The LD goldens on one device; the 1080p fixture's 135 slice rows
    over a 1x3 mesh of the one card (the route whose slice rows divide),
    to the fixture's recorded SHA-256."""
    mesh = None
    if case == MESH_1X3:
        mesh = make_mesh(1, 3, devices=[cuda] * 3)
        with open(os.path.join(TESTDATA, "fixtures_1080p.json")) as f:
            fixture = json.load(f)["streams"]["ld_1080p"]
        with open(os.path.join(TESTDATA, fixture["stream"]), "rb") as f:
            data = f.read()
    else:
        data, want = _stream(case)
    dec_before = ld_dc.ll_grids.launches
    sink = io.BytesIO()
    dec = Decoder(sink=sink, device=None, mesh=mesh)
    assert dec.run(data) == 0
    if mesh is None:
        assert sink.getvalue() == want
    else:
        assert (hashlib.sha256(sink.getvalue()).hexdigest()
                == fixture["decoded_sha256"])
        assert len(dec.sharded_decoders()) == 1
    units = _ld_units(data)
    assert units > 0 and ld_dc.ll_grids.launches - dec_before == units
    assert dec.ld_card_dc == units


@pytest.mark.cuda
def test_ld_dc_kernel_on_the_1080p_fixture(cuda):
    """The card's grids from the fixture's lanes against ``ld_scan``'s."""
    path = os.path.join(TESTDATA, "ld_1080p.vc2")
    with open(path, "rb") as f:
        data = f.read()
    dec = Decoder(sink=io.BytesIO(), device=None)
    pos = 0
    while True:
        rd = StreamReader(data[pos:])
        unit, next_off, _prev = rd.read_data_unit()
        if unit == DataUnitType.SEQUENCE_HEADER:
            dec.hdr = rd.read_sequence_header()
        if unit == DataUnitType.LD_PICTURE:
            break
        pos += next_off
    _end, job = dec.locate_picture(data[pos:], False)
    pre, geo = job.pre, job.geo
    qm = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
    sizes = layout.slice_bytes_map(
        geo.y_slices, geo.x_slices,
        pre.slice_bytes_numerator * geo.n_slices
        // pre.slice_bytes_denominator, 1).ravel()
    want = tld.ld_scan(job.payload, sizes, geo, pre.depth, qm, job.start)
    assert np.array_equal(want.q, job.ld.q)
    assert np.array_equal(want.fields, job.ld.fields)
    before = ld_dc.ll_grids.launches
    lanes = _lanes_of(job.payload, geo, job.ld.fields, cuda)
    grids = ld_dc.ll_grids(lanes, torch.from_numpy(job.ld.q).to(cuda),
                           _plan(geo, pre.depth, qm, "cuda:0"))
    assert ld_dc.ll_grids.launches - before == 1
    assert [tuple(g.shape) for g in grids] == [(270, 480), (270, 240),
                                               (270, 240)]
    for g, w in zip(grids, want.grids, strict=True):
        assert np.array_equal(g.cpu().numpy(), w)


# name: (y slices, x slices, luma slice, chroma slice, depth)
KERNEL_GEOMETRIES = {
    "1080p_422_d2": (135, 240, (8, 8), (8, 4), 2),
    "ll1x1_444": (6, 5, (4, 4), (4, 4), 2),
    "taller_than_a_cta": (600, 2, (8, 8), (8, 4), 2),
    "420_d1": (4, 4, (4, 8), (2, 4), 1),
    "d0_444": (3, 7, (2, 3), (2, 3), 0),
}


def _random_lanes(rng, geo, n):
    """Lanes of codes in every range: small, up to the int32 wrap (near
    +-2**31, -2**31 itself), and zeros; q indices 0-127 with 0, 119 and
    127 present, a quarter under the quant matrix (adjusted q 0)."""
    out = []
    for sh, sw in (geo.luma_slice, geo.chroma_slice, geo.chroma_slice):
        a = rng.integers(-40, 41, (n, sh * sw)).astype(np.int64)
        big = rng.random(a.shape) < 0.3
        a[big] = rng.integers(-2**31, 2**31, big.sum())
        edge = rng.random(a.shape) < 0.05
        a[edge] = rng.choice([-2**31, 2**31 - 1, -2**31 + 1, 2**31 - 2],
                             edge.sum())
        a[rng.random(a.shape) < 0.1] = 0
        out.append(torch.from_numpy(a.astype(np.int32)))
    q = rng.integers(0, 128, n)
    q[rng.random(n) < 0.25] = rng.integers(0, 3, 1)[0]
    q[:3] = (0, 119, 127)
    return out, torch.from_numpy(q.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_GEOMETRIES)
def test_ld_dc_kernel_equals_host_recurrence(name, cuda):
    ys, xs, luma, chroma, depth = KERNEL_GEOMETRIES[name]
    geo = SliceGeometry(ys, xs, (luma[0] * ys, luma[1] * xs),
                        (chroma[0] * ys, chroma[1] * xs), luma, chroma)
    rng = np.random.default_rng(sum(map(ord, name)))
    for kernel in (tcfg.WaveletKernel.LeGall, tcfg.WaveletKernel.Daub97):
        qm = matrices.quant_matrix(kernel, depth)
        lanes, q = _random_lanes(rng, geo, ys * xs)
        want = ld_dc.ll_grids(lanes, q, _plan(geo, depth, qm, "cpu"))
        got = ld_dc.ll_grids([t.to(cuda) for t in lanes], q.to(cuda),
                             _plan(geo, depth, qm, "cuda:0"))
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ld_legall_d2", "ld_interlaced"])
def test_transform_tap_on_the_card_equals_the_host_scan_route(
        case, cuda, monkeypatch):
    got = _transform(case, None)
    assert got and got == _transform_by_host_scan(case, None, monkeypatch)
