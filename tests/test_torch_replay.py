"""The decoder's CUDA graph route (``pipeline.replay``): one replay a
picture once a picture's key repeats.

On the CPU (the unmarked tests) the key policy, with a stand-in capture
that runs the chain at each replay: the first picture of a key eager,
the second captured and replayed, the later ones replayed; at most eight
keys, the least recently used out first; a payload length that never
repeats stays eager; the launch counts of a replay, of a wrapper known
only to ``core.capture``'s registry; ``device_cache`` noting what it
gives in the open ``holding`` blocks, and a graph holding the tables its
capture read after their cache drops them; the routes never
eligible (a mesh, the taps, interlaced fields, the CPU); and the stream
decoder's own use of it, the CPU standing in for a card, against the
goldens.

On the card (the tests marked ``cuda``, which skip without one): the HQ
and LD goldens and the 1080p fixtures, each picture byte-equal to the
eager decode, with one replay a picture after each key's first; the
same with the copy stream held busy before each copy back; the same
with the table caches cleared and the freed device memory written over
between pictures; the kernel wrappers' launches once a picture; a geometry change mid-stream; an
interlaced stream, never replayed; and the kernels of a replay in the
profiler's trace. The file imports neither jax nor vc2tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_replay.py
"""

import collections
import gc
import hashlib
import json
import os
import weakref

import numpy as np
import pytest
import torch

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import capture
from vc2tpu_torch.core.config import DecOutput
from vc2tpu_torch.pipeline import replay
from vc2tpu_torch.pipeline.decoder import qm_lanes
from vc2tpu_torch.quant import ld_dc
from vc2tpu_torch.vlc import device_unpack as du
from vc2tpu_torch.wavelet import bands

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = os.path.join(os.path.dirname(__file__), os.pardir, "vc2tpu_torch",
                        "testdata")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    _META = json.load(_f)
_FRAMES = {c[0]: _META["inputs"][c[1]]["frames"] for c in _META["cases"]}
with open(os.path.join(FIXTURES, "fixtures_1080p.json")) as _f:
    _HD = json.load(_f)["streams"]
CPU = torch.device("cpu")


# --- the key policy, with a stand-in capture --------------------------------

class Counter:
    """A kernel wrapper's stand-in, counted (``core.capture``)."""


def _fake_capture(chain, pay, fields):
    """``capture_cuda``'s form on the CPU: the chain runs at the capture
    and at each replay, into the captured output; as a graph's replay runs
    no Python, a replay's own run leaves the launch counts as they were.
    As a CUDA capture cannot copy a new table up from pageable memory,
    the capture raises where the chain makes a ``_table``."""
    made = _table.cache_info().misses
    words = chain(pay, fields)
    if _table.cache_info().misses != made:
        raise RuntimeError("a table made during the capture")

    def run():
        counts = capture.launch_counts()
        words.copy_(chain(pay, fields))
        for w, n in counts.items():
            w.launches = n
    return run, words


@capture.device_cache(maxsize=2)
def _table(n: int) -> torch.Tensor:
    """A cached table the stand-in chain reads, as a kernel reads a run
    map: 0 .. n - 1."""
    return torch.arange(n, dtype=torch.int32)


class Stream:
    """Pictures through a PictureGraphs with the stand-in capture; each
    run of the chain counts a launch on ``counter``, a wrapper counted
    only through ``core.capture``'s registry, and reads ``_table``."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(capture, "_COUNTED", [])
        self.counter = capture.counted(Counter())
        self.graphs = replay.PictureGraphs(capture=_fake_capture)
        self.calls = 0
        self.rng = np.random.default_rng(22)

    def chain(self, pay, fields, base):
        self.calls += 1
        self.counter.launches += 1
        return torch.cat([pay.to(torch.int32), fields.reshape(-1)]) + \
            _table(pay.numel())[0] + base

    def picture(self, key, length=16):
        """Decode one picture of ``key`` with a payload of ``length``
        bytes; returns (output, what it should be)."""
        payload = self.rng.integers(0, 256, length, dtype=np.uint8)
        fields = self.rng.integers(-99, 99, (4, 3), dtype=np.int32)
        out = self.graphs.run((key, length), self.chain, (7,), payload,
                              fields, CPU)
        want = torch.cat([torch.from_numpy(payload).to(torch.int32),
                          torch.from_numpy(fields).reshape(-1)]) + 7
        self.graphs.read(out, None)
        return out, want

    def counts(self):
        """(eager, captures, replays): the chain runs once a picture, and
        twice more at each capture (its run as it is, then captured)."""
        g = self.graphs
        return self.calls - 2 * g.captures - g.replays, g.captures, g.replays


def test_first_eager_then_captured_then_replayed(monkeypatch):
    s = Stream(monkeypatch)
    outs = []
    for i in range(5):
        out, want = s.picture("a")
        assert torch.equal(out, want)
        outs.append(out)
        assert s.counts() == (1, int(i >= 1), i)
        # one launch a picture, the capture's taken back off
        assert s.counter.launches == i + 1
    # the replays hand back the graph's one output
    assert all(o is outs[1] for o in outs[2:]) and outs[0] is not outs[1]


def test_lru_eviction_at_eight_keys(monkeypatch):
    s = Stream(monkeypatch)
    assert replay.SIZE == 8
    for k in range(8):
        s.picture(k)
    assert len(s.graphs._keys) == 8
    s.picture(0)                      # the oldest touched: captured
    assert s.counts() == (8, 1, 1)
    s.picture(8)                      # a ninth key: key 1 goes first
    assert len(s.graphs._keys) == 8
    s.picture(1)
    assert s.counts() == (10, 1, 1)   # seen afresh, eager
    s.picture(0)                      # still held: replayed
    assert s.counts() == (10, 1, 2)
    for k in range(100, 108):         # eight new keys push the graph out
        s.picture(k)
    out, want = s.picture(0)
    assert torch.equal(out, want) and s.counts() == (19, 1, 2)
    out, want = s.picture(0)
    assert torch.equal(out, want) and s.counts() == (19, 2, 3)


def test_a_length_that_never_repeats_stays_eager(monkeypatch):
    s = Stream(monkeypatch)
    for length in range(10, 40):
        out, want = s.picture("vbr", length)
        assert torch.equal(out, want)
    assert s.counts() == (30, 0, 0)
    assert len(s.graphs._keys) == replay.SIZE
    assert s.counter.launches == 30


def test_device_cache_notes_what_it_gives_in_open_blocks():
    _table.cache_clear()
    a = _table(3)                     # outside any block: noted nowhere
    with capture.holding() as outer:
        b = _table(3)                 # found in the cache
        with capture.holding() as inner:
            c = _table(4)             # made
        d = _table(5)                 # made; 3 leaves the cache (maxsize 2)
    assert a is b
    assert [id(t) for t in outer] == [id(b), id(c), id(d)]
    assert [id(t) for t in inner] == [id(c)]
    assert _table.cache_info().currsize == 2
    with capture.holding() as after:
        pass
    assert after == []
    _table.cache_clear()
    assert _table.cache_info().currsize == 0


def test_a_graph_holds_the_tables_its_capture_read(monkeypatch):
    """The cache drops the table a graph reads (cleared, then refilled
    with others); the graph holds it until the graph itself goes."""
    s = Stream(monkeypatch)
    _table.cache_clear()
    s.picture("a", 16)
    s.picture("a", 16)                # captured: the chain read _table(16)
    held = weakref.ref(_table(16))
    _table.cache_clear()
    _table(1), _table(2)
    gc.collect()
    assert held() is not None
    out, want = s.picture("a", 16)
    assert torch.equal(out, want) and s.counts() == (1, 1, 2)
    for k in range(replay.SIZE):      # eight new keys push the graph out
        s.picture(("b", k), 20 + k)
    _table.cache_clear()
    gc.collect()
    assert held() is None


def test_a_table_dropped_before_the_capture_is_remade_first(monkeypatch):
    """The key's first picture made the table; its cache drops it before
    the second picture, whose capture must only find it."""
    s = Stream(monkeypatch)
    s.picture("a", 16)
    _table.cache_clear()
    for _ in range(3):
        out, want = s.picture("a", 16)
        assert torch.equal(out, want)
    assert s.counts() == (1, 1, 3) and s.counter.launches == 4


CUDA = torch.device("cuda", 0)


@pytest.mark.parametrize("device, mesh, output, interlace, want", [
    (CUDA, None, DecOutput.DECODED, False, True),
    (CUDA, "1x3", DecOutput.DECODED, False, False),
    (CUDA, None, DecOutput.TRANSFORM, False, False),
    (CUDA, None, DecOutput.QUANTISED, False, False),
    (CUDA, None, DecOutput.INDICES, False, False),
    (CUDA, None, DecOutput.DECODED, True, False),
    (CPU, None, DecOutput.DECODED, False, False),
], ids=["card", "mesh", "transform", "quantised", "indices", "interlace",
        "cpu"])
def test_eligible(device, mesh, output, interlace, want):
    assert replay.eligible(device, mesh, output, interlace) is want


# --- the stream decoder's use, the CPU standing in for a card ---------------

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


class KeepingSink:
    def __init__(self):
        self.kept = []

    def write(self, data):
        self.kept.append(bytes(data))
        return len(data)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert hashlib.sha256(g).hexdigest() == w
        else:
            assert g == w


def _recording(dec) -> list:
    """The keys of the pictures ``dec`` hands its graphs, in order."""
    keys = []
    real = dec._graphs.run

    def run(key, *args, **kwargs):
        keys.append(key)
        return real(key, *args, **kwargs)
    dec._graphs.run = run
    return keys


def _expected(keys) -> tuple:
    """(captures, replays) of a stream of these keys (at most eight)."""
    seen = collections.Counter(keys)
    assert len(seen) <= replay.SIZE
    return sum(n > 1 for n in seen.values()), len(keys) - len(seen)


PROGRESSIVE = ["cbr_legall_d2", "ld_legall_d2", "cbr_legall_d2",
               "ld_fragmented", "constq_legall_d2", "ld_legall_d2",
               "cbr_fragmented", "cbr_scalar2_prefix3"]
INTERLACED = ["cbr_interlaced", "ld_interlaced", "constq_interlaced",
              "cbr_interlaced"]


def _as_card(monkeypatch, **kw):
    """A CPU Decoder that takes the graph route as a card would: the
    eligibility asked of a card, the stand-in capture, and a copy in
    place of the copy back (on the CPU the FIFO holds the output bytes
    themselves, which a replay writes over)."""
    real = replay.eligible
    monkeypatch.setattr(replay, "eligible",
                        lambda _device, *args: real(CUDA, *args))
    sink = KeepingSink()
    dec = Decoder(sink=sink, device="cpu", **kw)
    dec._graphs = replay.PictureGraphs(capture=_fake_capture)
    dec._copy_back_async = lambda words: (words.clone(), None)
    return dec, sink


def test_decoder_replays_progressive_pictures(monkeypatch):
    data, want = _stream(PROGRESSIVE)
    dec, sink = _as_card(monkeypatch)
    keys = _recording(dec)
    assert dec.run(data) == 0
    _same(sink.kept, want)
    assert len(keys) == len(want)
    assert (dec.graph_captures, dec.graph_replays) == _expected(keys)
    assert dec.graph_replays >= 6
    # the route, geometry and the payload's length key a graph
    assert len({k[0] for k in keys}) == 2
    assert len({k[-1] for k in keys}) >= 3


@pytest.mark.parametrize("route", ["interlaced", "tap", "cpu"])
def test_decoder_never_replays(route, monkeypatch):
    parts = INTERLACED if route == "interlaced" else PROGRESSIVE[:3]
    data, want = _stream(parts)
    if route == "cpu":
        sink = KeepingSink()
        dec = Decoder(sink=sink, device="cpu")
    else:
        dec, sink = _as_card(monkeypatch, output=(
            DecOutput.QUANTISED if route == "tap" else DecOutput.DECODED))
    keys = _recording(dec)
    assert dec.run(data) == 0
    if route != "tap":
        _same(sink.kept, want)
    assert (dec.graph_captures, dec.graph_replays) == (0, 0)
    assert not keys and len(dec._graphs._keys) == 0


def test_mesh_route_never_replays(monkeypatch):
    """A 1x2 mesh of the CPU: the bands' route, and the single-device
    route of a picture whose slice rows do not divide, stay eager."""
    data, want = _stream(["cbr_legall_d2", "cbr_midsize", "cbr_legall_d2"])
    dec, sink = _as_card(monkeypatch, mesh="1x2")
    assert dec.run(data) == 0
    _same(sink.kept, want)
    assert (dec.graph_captures, dec.graph_replays) == (0, 0)
    assert len(dec._graphs._keys) == 0


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


JUNK_BYTES = [512 << k for k in range(10)] + [4 << 20, 32 << 20]


def _churn(dec):
    """After each picture of ``dec``: every cache of device tables the
    chain reads cleared, the allocator's free memory handed back, then
    device memory of the tables' sizes and larger taken and written over,
    and held until the next picture's decode is issued."""
    real = dec._graphs.run
    junk = []

    def run(*args, **kwargs):
        out = real(*args, **kwargs)
        for cache in (ld_dc.plan, bands._map_tensors, qm_lanes):
            cache.cache_clear()
        junk.clear()
        gc.collect()
        torch.cuda.empty_cache()
        junk.extend(torch.full((n,), 0x5A, dtype=torch.uint8,
                               device=out.device)
                    for n in JUNK_BYTES for _ in range(32))
        return out
    dec._graphs.run = run


def _decode(data, busy=0, churn=False, **kw):
    """(decoder, kept pictures, keys) of ``data`` on the card; ``busy``
    cycles of ``torch.cuda._sleep`` queued on the copy stream before each
    copy back; ``churn``, the table caches dropped and the freed memory
    written over after each picture (``_churn``)."""
    sink = KeepingSink()
    dec = Decoder(sink=sink, **kw)
    keys = _recording(dec)
    if churn:
        _churn(dec)
    if busy:
        real = dec._copy_back_async

        def held(words):
            stream = dec._copy_streams.get(words.device)
            if stream is None:
                stream = dec._copy_streams[words.device] = \
                    torch.cuda.Stream(words.device)
            with torch.cuda.stream(stream):
                torch.cuda._sleep(busy)
            return real(words)
        dec._copy_back_async = held
    assert dec.run(data) == 0
    return dec, sink.kept, keys


CARD_STREAMS = {
    "hq_goldens": PROGRESSIVE[:1] * 3 + ["constq_legall_d2"] * 2
    + ["cbr_scalar2_prefix3", "cbr_fragmented"] * 2,
    "ld_goldens": ["ld_legall_d2"] * 3 + ["ld_midsize", "ld_fragmented"] * 2,
    "cbr_1080p": ["cbr_1080p"] * 4,
    "constq_1080p": ["constq_1080p"] * 3,
    "ld_1080p": ["ld_1080p"] * 4,
}


@pytest.mark.cuda
@pytest.mark.parametrize("stream", list(CARD_STREAMS))
def test_replays_equal_the_eager_decode(stream, cuda, monkeypatch):
    data, want = _stream(CARD_STREAMS[stream])
    dec, got, keys = _decode(data)
    _same(got, want)
    assert (dec.graph_captures, dec.graph_replays) == _expected(keys)
    with monkeypatch.context() as m:
        # no picture eligible: every one the library's decode
        m.setattr(replay, "eligible", lambda *args: False)
        eager_dec, eager, eager_keys = _decode(data)
    assert got == eager
    assert not eager_keys and eager_dec.graph_replays == 0
    assert dec.graph_replays >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["cbr_1080p", "ld_1080p", "hq_goldens"])
def test_replays_wait_for_the_copy_back(stream, cuda):
    """Each copy back queued behind ~30 ms of sleep on the copy stream:
    a replay that did not wait for it would write over the bytes the
    copy has yet to read."""
    data, want = _stream(CARD_STREAMS[stream])
    dec, got, keys = _decode(data, busy=50_000_000)
    _same(got, want)
    assert dec.graph_replays == _expected(keys)[1] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["cbr_1080p", "ld_1080p", "hq_goldens",
                                    "ld_goldens"])
def test_replays_outlive_the_table_caches(stream, cuda):
    """A graph reads the run maps, the LD plan and the quant entries by
    address: it holds them, so their caches' dropping them, and the
    memory written over, change nothing."""
    data, want = _stream(CARD_STREAMS[stream])
    dec, got, keys = _decode(data, churn=True)
    _same(got, want)
    assert dec.graph_replays == _expected(keys)[1] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["cbr_1080p", "ld_1080p"])
def test_launches_once_a_picture(stream, cuda):
    wrappers = (du.unpack_hq, du.unpack_ld, ld_dc.ll_grids,
                bands.inverse_lanes)
    data, want = _stream(CARD_STREAMS[stream])
    before = [w.launches for w in wrappers]
    dec, got, _keys = _decode(data)
    _same(got, want)
    n = len(want)
    hq = stream.startswith("cbr")
    a_picture = [int(hq), int(not hq), int(not hq), 2]
    assert dec.graph_replays == n - 1
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        n * k for k in a_picture]
    assert dec.ld_card_dc == (0 if hq else n)
    # a replay counts what its capture counted, and nothing more
    (graph,) = [g for g in dec._graphs._keys.values()
                if g is not replay._SEEN]
    assert graph.launches == {w: k for w, k in zip(wrappers, a_picture) if k}


@pytest.mark.cuda
def test_geometry_change_rekeys(cuda):
    parts = (["cbr_1080p"] * 2 + ["cbr_legall_d2"] * 2 + ["cbr_1080p"] * 2
             + ["ld_midsize"] * 2)
    data, want = _stream(parts)
    dec, got, keys = _decode(data)
    _same(got, want)
    # 1080p, the 64x32 golden's two frames a part, the 1080p key again
    # (still held), then LD
    assert keys[1] == keys[0] != keys[2] and keys[6] == keys[0] != keys[8]
    assert len(set(keys)) == dec.graph_captures == 3
    assert (dec.graph_captures, dec.graph_replays) == _expected(keys)


@pytest.mark.cuda
def test_interlaced_stream_never_replays(cuda):
    data, want = _stream(INTERLACED * 2)
    dec, got, keys = _decode(data)
    _same(got, want)
    assert (dec.graph_captures, dec.graph_replays) == (0, 0)
    assert not keys and len(dec._graphs._keys) == 0


@pytest.mark.cuda
def test_profiler_sees_the_replayed_kernels(cuda):
    """The rooflines read the kernels by name from the profiler's device
    trace: a replay's kernels show there as the eager ones do."""
    data, want = _stream(["cbr_1080p", "ld_1080p"] * 3)
    warm, _want = _stream(["cbr_1080p", "ld_1080p"] * 2)
    sink = KeepingSink()
    dec = Decoder(sink=sink)
    assert dec.run(warm) == 0
    replays = dec.graph_replays
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        assert dec.run(data) == 0
        torch.cuda.synchronize()
    _same(sink.kept[-len(want):], want)
    assert dec.graph_replays - replays == len(want)
    cuda_type = torch.autograd.DeviceType.CUDA
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda_type}
    for kernel in ("hq_unpack_kernel", "band_level_kernel",
                   "ld_unpack_kernel", "ld_dc_kernel"):
        assert any(kernel in n for n in names), kernel
