"""The port's CUDA kernels on the card, against their plain versions, the
HQ and LD goldens decoded through them and the ConstQ, CBR and LD goldens
encoded through them. Every test here needs a CUDA device
and skips without one. The file imports neither jax nor vc2tpu, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from vc2tpu_torch.cli import encode_stream
from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core.config import WaveletKernel
from vc2tpu_torch.rdo import cbr
from vc2tpu_torch.rdo import ld as rdo_ld
from vc2tpu_torch.slices import layout
from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader
from vc2tpu_torch.vlc import device_pack as dp
from vc2tpu_torch.vlc import device_unpack as du
from vc2tpu_torch.vlc import golomb
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.wavelet import bands, lifting, matrices

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
HQ = [c[0] for c in META["cases"] if not c[0].startswith("ld")]
HQ_ENCODE = [c[0] for c in META["cases"] if not c[0].startswith("ld")]
LD = [c[0] for c in META["cases"] if c[0].startswith("ld")]
KERNELS = [k for k in WaveletKernel if k != WaveletKernel.NullKernel]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_lift_kernel_matches_plain(kernel, cuda):
    rng = np.random.default_rng(int(kernel))
    for shape in [(1080, 1920), (540, 480), (130, 194), (2, 2), (4, 8)]:
        x = rng.integers(-(1 << 20), (1 << 20) + 1, shape).astype(np.int32)
        xt = torch.from_numpy(x).to(cuda)
        for invert in (False, True):
            got = lifting.lift_level(xt, kernel, invert)
            want = lifting.lift_level_plain(xt, kernel, invert)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, invert)


def _plane(rng, shape, cuda):
    x = rng.integers(-(1 << 20), (1 << 20) + 1, shape).astype(np.int32)
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_lift_levels_match_plain(kernel, cuda):
    """Three planes in one launch, read in place from the stride-s
    sub-lattice, with and without a compact (even, even) overlay."""
    rng = np.random.default_rng(100 + int(kernel))
    for shapes, stride, overlay in [
            ([(1080, 1920), (1080, 960), (1080, 960)], 2, False),
            ([(1080, 1920), (1080, 960), (1080, 960)], 1, True),
            ([(136, 200), (136, 104), (8, 8)], 2, True),
            ([(136, 200), (136, 104), (8, 8)], 4, True),
            ([(132, 196)], 1, True)]:
        planes = [_plane(rng, sh, cuda) for sh in shapes]
        overlays = ([_plane(rng, (h // (2 * stride), w // (2 * stride)), cuda)
                     for h, w in shapes] if overlay else None)
        for invert in (False, True):
            got = lifting.lift_levels(planes, kernel, invert, stride,
                                      overlays)
            want = lifting.lift_levels_plain(planes, kernel, invert, stride,
                                             overlays)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (shapes, stride, overlay, invert)


def _pack(vals):
    """Interleaved exp-Golomb codes (reference VLC.cpp:54-94), 1-padded."""
    bits = []
    for v in vals:
        m = abs(int(v))
        for ch in bin(m + 1)[3:]:
            bits += [0, int(ch)]
        bits.append(1)
        if m:
            bits.append(1 if v < 0 else 0)
    bits += [1] * (-len(bits) % 8)
    out = np.zeros(len(bits) // 8, np.uint8)
    for i, bit in enumerate(bits):
        out[i // 8] |= bit << (7 - i % 8)
    return out


def _random_rows(rng, n, nbytes):
    payload = rng.integers(0, 256, nbytes, dtype=np.uint8)
    starts = np.sort(rng.integers(0, nbytes - 8, 3 * n)).reshape(3, n)
    lens = rng.integers(0, 48, (3, n))
    return payload, starts, lens


def _code_rows():
    """Regions of long codes, alternations, zero runs and 1-fill."""
    big = (1 << 30) + 12345
    regions = [_pack([-big if i % 2 else big for i in range(24)]),
               _pack([0 if i % 2 else big for i in range(24)]),
               _pack([(1 << k) - 1 for k in range(24)]),
               np.zeros(7, np.uint8), np.full(64, 0xFF, np.uint8),
               np.zeros(0, np.uint8),
               np.zeros(16, np.uint8),          # no follow bit in 64 bits
               _pack([5, -3, 0, 0, 0, 7]), _pack([0] * 30 + [1])]
    starts, pos = [], 0
    for r in regions:
        starts.append(pos)
        pos += len(r) + 1
    payload = np.concatenate([np.concatenate([r, [0]]) for r in regions])
    lens = [len(r) for r in regions]
    return (payload.astype(np.uint8), np.asarray(starts).reshape(3, 3),
            np.asarray(lens).reshape(3, 3))


def _chained_rows(rng, n):
    """Regions laid end to end in slice order over several CTAs, the last
    one running past the payload end."""
    lens = rng.integers(0, 40, (n, 3))
    ends = np.cumsum(lens.reshape(-1) + 1)
    starts = (ends - lens.reshape(-1)).reshape(n, 3).T
    lens = lens.T.copy()
    lens[2, -1] = 64
    payload = rng.integers(0, 256, int(starts[2, -1]) + 5, dtype=np.uint8)
    return payload, np.ascontiguousarray(starts), lens


@pytest.mark.parametrize("case", ["random_bytes", "codes", "chained",
                                  "codes_cut_short", "wide_lanes"])
def test_unpack_kernel_matches_plain(case, cuda):
    lanes = 24
    if case == "random_bytes":         # CTAs over the window: device memory
        payload, starts, lens = _random_rows(np.random.default_rng(5), 2000,
                                             1 << 16)
    elif case == "wide_lanes":         # no lane tile: straight to memory
        payload, starts, lens = _random_rows(np.random.default_rng(7), 40,
                                             1 << 12)
        lanes = 20000
    elif case == "chained":            # staged windows, past the end
        payload, starts, lens = _chained_rows(np.random.default_rng(6), 1000)
    else:
        payload, starts, lens = _code_rows()
        if case == "codes_cut_short":
            payload = payload[:-40].copy()
    args = (torch.from_numpy(payload).to(cuda),
            torch.from_numpy(starts.astype(np.int32)).to(cuda),
            torch.from_numpy(lens.astype(np.int32)).to(cuda), lanes, lanes)
    s, lanes_staged = du.unpack_plan(lanes, lanes)
    staged = torch.full((-(-starts.shape[1] // s),), 2, dtype=torch.uint8,
                        device=cuda)
    got = du.unpack_hq(*args, staged=staged)
    want = du.unpack_hq_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert lanes_staged == (case != "wide_lanes")
    assert int(staged.max()) <= 1           # every CTA set its flag
    assert bool(staged.all()) == (case != "random_bytes")


def test_unpack_kernel_on_golden_payloads(cuda):
    for case in HQ:
        with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
            data = f.read()
        dec = Decoder(sink=io.BytesIO(), device=cuda)
        pos = 0
        while pos + 13 <= len(data):
            rd = StreamReader(data[pos:])
            kind, next_off, _ = rd.read_data_unit()
            if kind == DataUnitType.SEQUENCE_HEADER:
                dec.hdr = rd.read_sequence_header()
                dec._major_version = rd.major_version
            elif kind == DataUnitType.HQ_PICTURE:
                job = dec.locate_picture(data[pos:], True)[1]
                clen = torch.from_numpy(job.cbytes.astype(np.int32)).to(cuda)
                pay = torch.from_numpy(job.payload.copy()).to(cuda)
                dstart = du.hq_component_offsets(clen, job.pre.slice_prefix,
                                                 job.start)
                ly = job.geo.luma_slice[0] * job.geo.luma_slice[1]
                lc = job.geo.chroma_slice[0] * job.geo.chroma_slice[1]
                got = du.unpack_hq(pay, dstart, clen, ly, lc)
                want = du.unpack_hq_plain(pay, dstart, clen, ly, lc)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), case
            if next_off == 0:
                break
            pos += next_off


@pytest.mark.parametrize("case", HQ)
def test_golden_decodes_through_the_kernels(case, cuda):
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
        want = f.read()
    lifts, unpacks = lifting.lift_levels.launches, du.unpack_hq.launches
    inverses = bands.inverse_lanes.launches
    sink = io.BytesIO()
    assert Decoder(sink=sink).run(data) == 0
    assert sink.getvalue() == want
    assert bands.inverse_lanes.launches > inverses
    assert lifting.lift_levels.launches == lifts
    assert du.unpack_hq.launches > unpacks


def _ld_fields(rng, n, nbytes, case):
    """(payload, fields int32 [4, N]) of seeded LD slices: every lead bit
    offset 0-31, empty U/V regions, luma regions past their slice, slices
    spread too far apart to stage, a payload cut short, runs of 0x00 bytes
    (codes with no terminator in 64 bits) and 0xFF bytes (zero codes)."""
    payload = rng.integers(0, 256, nbytes, dtype=np.uint8)
    if case == "runs":
        payload = np.concatenate([
            np.full(rng.integers(1, 40), rng.choice([0, 0xFF, 0x3C]),
                    np.uint8) for _ in range(nbytes // 20)])[:nbytes]
        nbytes = len(payload)
    s_bits = np.sort(rng.integers(0, 8 * (nbytes - 64), n))
    if case not in ("far_apart", "wide_far"):
        k = min(n, 64)
        s_bits[:k] = 8 * 64 + np.arange(k)
    len_bits = rng.integers(0, 10, n)
    y_bits = rng.integers(0, 300, n)
    uv_bits = rng.integers(0, 300, n)
    uv_bits[::5] = 0
    if case == "oversized_luma":
        y_bits[::3] = rng.integers(1000, 4000, len(y_bits[::3]))
    if case == "cut_short":
        payload = payload[:nbytes // 2]
    fields = np.stack([s_bits, len_bits, y_bits, uv_bits]).astype(np.int32)
    return payload, fields


LD_UNPACK_CASES = {"leads": (4099, 1 << 17, 16, 8),      # ragged last CTA
                   "oversized_luma": (2000, 1 << 17, 16, 8),
                   "far_apart": (256, 1 << 20, 16, 8),   # device memory
                   "cut_short": (2000, 1 << 16, 16, 8),
                   "wide_lanes": (40, 1 << 12, 20000, 10000),
                   "runs": (2000, 1 << 16, 64, 32),
                   "wide_far": (40, 1 << 20, 20000, 10000)}


@pytest.mark.parametrize("case", list(LD_UNPACK_CASES))
def test_ld_unpack_kernel_matches_plain(case, cuda):
    n, nbytes, ly, lc = LD_UNPACK_CASES[case]
    payload, fields = _ld_fields(np.random.default_rng(len(case)), n, nbytes,
                                 case)
    args = (torch.from_numpy(payload).to(cuda),
            torch.from_numpy(fields).to(cuda), ly, lc)
    s, lanes_staged = du.ld_unpack_plan(ly, lc)
    staged = torch.full((-(-n // s),), 2, dtype=torch.uint8, device=cuda)
    got = du.unpack_ld(*args, staged=staged)
    want = du.unpack_ld_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the branches: lanes in the shared tile or straight to device memory
    # ("wide_*"), each with the window staged or read from device memory
    assert lanes_staged == (case not in ("wide_lanes", "wide_far"))
    assert int(staged.max()) <= 1           # every CTA set its flag
    assert bool(staged.any()) == (case not in ("far_apart", "wide_far"))


@pytest.mark.parametrize("case", LD)
def test_ld_golden_decodes_through_the_kernels(case, cuda):
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        data = f.read()
    with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
        want = f.read()
    lifts, unpacks = lifting.lift_levels.launches, du.unpack_ld.launches
    inverses = bands.inverse_lanes.launches
    sink = io.BytesIO()
    assert Decoder(sink=sink).run(data) == 0
    assert sink.getvalue() == want
    assert bands.inverse_lanes.launches > inverses
    assert lifting.lift_levels.launches == lifts
    assert du.unpack_ld.launches > unpacks


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_forward_planes_match_plain(kernel, cuda):
    rng = np.random.default_rng(200 + int(kernel))
    shapes = [(1080, 1920), (1080, 960), (1080, 960)]
    planes = [_plane(rng, sh, cuda) for sh in shapes]
    got = lifting.forward_planes(planes, kernel, 2)
    want = lifting.forward_planes([p.cpu() for p in planes], kernel, 2)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _lanes(rng, n, span, zero_frac, cuda):
    out = []
    for length, s in ((64, span), (32, span >> 2), (32, span >> 2)):
        v = rng.integers(-s, s + 1, (n, length))
        v[rng.random((n, length)) < zero_frac] = 0
        out.append(torch.from_numpy(v.astype(np.int32)).to(cuda))
    return out


PACK_CASES = ["random", "long_codes", "zeros", "prefix3_scalar2", "cbr",
              "over_the_window", "flag_scalar", "flag_qindex", "flag_cbr_fit",
              "flag_vlen"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_kernel_matches_plain(case, cuda):
    rng = np.random.default_rng(PACK_CASES.index(case))
    n = 4000
    q = torch.from_numpy(rng.integers(0, 120, n).astype(np.int32)).to(cuda)
    prefix, scalar, sizes, flags = 0, 1, None, 0
    lanes = _lanes(rng, n, 40, 0.6, cuda)
    if case == "random":
        lanes = _lanes(rng, n, 1 << 20, 0.5, cuda)
        scalar = 4
    elif case == "long_codes":
        lanes = _lanes(rng, n, 1 << 30, 0.3, cuda)
        lanes[0][::7, 3] = -(1 << 31)
        scalar = 16
    elif case == "zeros":
        lanes = [torch.zeros_like(x) for x in lanes]
    elif case == "prefix3_scalar2":
        prefix, scalar = 3, 2
    elif case in ("cbr", "flag_cbr_fit", "flag_vlen"):
        lanes = _lanes(rng, n, 8, 0.7, cuda) if case == "cbr" else lanes
        per = {"cbr": 80, "flag_cbr_fit": 6, "flag_vlen": 400}[case]
        prefix, scalar = (1, 2) if case == "cbr" else (0, 1)
        sizes = torch.from_numpy(np.array(layout.slice_bytes_map(
            1, n, n * per, scalar).ravel())).to(cuda)
        flags = {"cbr": 0, "flag_cbr_fit": dp.FLAG_CBR_FIT,
                 "flag_vlen": dp.FLAG_VLEN}[case]
    elif case in ("over_the_window", "flag_scalar"):
        lanes = [torch.from_numpy(rng.integers(
            -(1 << 24), 1 << 24, (16, length)).astype(np.int32)).to(cuda)
            for length in (2048, 1024, 1024)]
        q = q[:16].contiguous()
        prefix, scalar = (1, 256) if case == "over_the_window" else (0, 8)
        flags = dp.FLAG_SCALAR if case == "flag_scalar" else 0
    elif case == "flag_qindex":
        q = q + 200
        flags = dp.FLAG_QINDEX
    launches = dp.pack_hq.launches
    got, got_flags = dp.pack_hq(*lanes, q, prefix, scalar, sizes)
    want, want_flags = dp.pack_hq_plain(*lanes, q, prefix, scalar, sizes)
    torch.cuda.synchronize()
    assert got_flags == want_flags == flags
    assert got.shape == want.shape and torch.equal(got, want)
    assert dp.pack_hq.launches == launches + 1


FUSED_CASES = ["every_q", "ragged", "group16", "cbr_prefix"]


@pytest.mark.parametrize("case", FUSED_CASES)
def test_quant_pack_kernel_matches_plain(case, cuda):
    """Transform lanes quantised in the kernel: every q 0-119 (the wrapped
    factors at 116-119 included) over the whole int32 range and INT_MIN;
    slice counts that leave a ragged last tile; slices served by groups of
    16 threads; a CBR fill with a prefix."""
    rng = np.random.default_rng(50 + FUSED_CASES.index(case))
    n, lengths, span, prefix, scalar, sizes = 321, (64, 32, 32), 1 << 12, \
        0, 1, None
    if case == "every_q":
        n, span, scalar = 1200, 1 << 31, 64
    elif case == "group16":
        n, lengths, scalar = 50, (256, 128, 128), 16
    elif case == "cbr_prefix":
        prefix, scalar, span = 2, 2, 16
        sizes = torch.from_numpy(np.array(layout.slice_bytes_map(
            1, n, n * 200, scalar).ravel())).to(cuda)
    lanes = []
    for length in lengths:
        v = rng.integers(-span, span, (n, length), dtype=np.int64)
        v[rng.random(v.shape) < 0.3] = 0
        lanes.append(v.astype(np.int32))
    if case == "every_q":
        lanes[0][::3, 0] = -(1 << 31)
        lanes[1][::5, 1] = (1 << 31) - 1
    lanes = [torch.from_numpy(v).to(cuda) for v in lanes]
    qm = [torch.from_numpy(rng.integers(0, 12, length).astype(np.int32))
          .to(cuda) for length in lengths[:2]]
    q = torch.from_numpy((np.arange(n) % 120).astype(np.int32)).to(cuda)
    launches = dp.pack_hq.launches
    got, got_flags, kept = dp.quant_pack_hq(*lanes, q, *qm, prefix, scalar,
                                            sizes, keep_lanes=True)
    want, want_flags, want_kept = dp.quant_pack_hq_plain(
        *lanes, q, *qm, prefix, scalar, sizes, keep_lanes=True)
    torch.cuda.synchronize()
    assert got_flags == want_flags == 0
    assert got.shape == want.shape and torch.equal(got, want)
    for g, w in zip(kept, want_kept):
        assert torch.equal(g, w)
    assert dp.pack_hq.launches == launches + 1


@pytest.mark.parametrize("case", ["flagged", "short_buffer"])
def test_pack_kernel_stays_in_its_buffer(case, cuda):
    """Guard bytes after the buffer stay untouched: a flagged call whose
    slices need more than the buffer holds, and an unflagged call into a
    buffer too short for its payload (its first bytes are still right)."""
    rng = np.random.default_rng(7)
    n, guard = 256, 4096
    lanes = _lanes(rng, n, 40, 0.5, cuda)
    q = torch.full((n,), 30, dtype=torch.int32, device=cuda)
    want, _ = dp.pack_hq_plain(*lanes, q, 0, 1)
    if case == "flagged":
        for x in lanes:
            x[:192] = -(1 << 31)
        cap = dp.payload_capacity(n, 64, 32, 0, 1, False)
        size = 4 * n + cap
    else:
        size = want.numel() - 100
    buf = torch.full((size + guard,), 0xA5, dtype=torch.uint8, device=cuda)
    _out, scratch = dp.launch_pack(lanes, q, 0, 1, out=buf[:size])
    flags, total = scratch[1:3].tolist()
    assert bool((buf[size:] == 0xA5).all())
    if case == "flagged":
        assert flags == dp.FLAG_SCALAR and 4 * n + total > size
    else:
        assert flags == 0 and torch.equal(buf[:size], want[:size])


@pytest.mark.parametrize("case", HQ_ENCODE)
def test_golden_encodes_through_the_kernels(case, cuda, tmp_path):
    _, inp, extra = next(c for c in META["cases"] if c[0] == case)
    m = META["inputs"][inp]
    argv = ["-x", str(m["width"]), "-y", str(m["height"]), "-f", m["fmt"],
            "-l", str(m["depth"]), "-n", "2", *extra,
            os.path.join(GOLDEN, f"{inp}.16p2"), str(tmp_path / "out.vc2")]
    lifts, packs = bands.forward_lanes.launches, dp.pack_hq.launches
    searches = cbr.cbr_quant_indices.launches
    assert encode_stream.main(argv) == 0
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        assert (tmp_path / "out.vc2").read_bytes() == f.read()
    assert bands.forward_lanes.launches > lifts
    assert dp.pack_hq.launches > packs
    pictures = dp.pack_hq.launches - packs
    assert cbr.cbr_quant_indices.launches - searches == (
        pictures if case.startswith("cbr") else 0)


CBR_CASES = ["1080p_slices", "scalar2", "lanes_to_2^29", "zeros", "no_fit",
             "climb_past_3", "ragged", "unstaged", "ragged_group", "tiny",
             "group8", "444", "streamed_129"]


@pytest.mark.parametrize("case", CBR_CASES)
def test_cbr_kernel_matches_plain(case, cuda):
    """The CBR search on the card against its plain version: integer ==
    on the q indices, and the flag word set exactly when one exceeds 119."""
    rng = np.random.default_rng(80 + CBR_CASES.index(case))
    n, lengths, span, scalar, per = 3000, (64, 32, 32), 1 << 12, 1, 40
    if case == "scalar2":
        scalar, per = 2, 60
    elif case == "lanes_to_2^29":
        span, scalar, per = (1 << 29) - 1, 3, 400
    elif case == "zeros":
        span = 0
    elif case == "no_fit":
        span, per = (1 << 29) - 1, 5
    elif case == "ragged":
        n = 333
    elif case == "unstaged":
        n, lengths, span, scalar, per = 64, (2048, 1024, 1024), 1 << 16, 4, \
            6000
    elif case == "ragged_group":    # runs of 3 and 2 lanes, the last shorter
        n, lengths = 3001, (65, 33, 33)
    elif case == "tiny":            # groups of 4 threads for 2 and 1 lanes
        lengths, per = (2, 1, 1), 8
    elif case == "group8":          # the goldens' slices
        lengths, per = (32, 16, 16), 20
    elif case == "444":
        lengths, per = (64, 64, 64), 60
    elif case == "streamed_129":    # one lane past the registers
        n, lengths, per = 500, (129, 10, 10), 100
    lanes = []
    for length in lengths:
        v = rng.integers(-span, span + 1, (n, length))
        v[rng.random((n, length)) < 0.4] = 0
        lanes.append(v.astype(np.int32))
    budgets = np.array(layout.slice_bytes_map(1, n, n * per, scalar)).ravel()
    if case == "climb_past_3":
        # lane 0 alone, every magnitude 1-3999, budgets 5-8 bytes
        mags, b = np.meshgrid(np.arange(1, 4000), np.arange(5, 9),
                              indexing="ij")
        lanes = [np.zeros((mags.size, length), np.int32)
                 for length in lengths]
        lanes[0][:, 0] = mags.ravel()
        budgets = b.ravel().astype(np.int32)
    qm = [torch.from_numpy(rng.integers(0, 8, length).astype(np.int32))
          .to(cuda) for length in lengths[:2]]
    if case == "climb_past_3":        # the 1080p slices' LeGall matrix
        qmatrix = matrices.quant_matrix(WaveletKernel.LeGall, 2)
        qm = [torch.from_numpy(qmatrix[layout.lane_order(h, w, 2)[1]]
                               .astype(np.int32)).to(cuda)
              for h, w in ((8, 8), (8, 4))]
    t = [torch.from_numpy(x).to(cuda) for x in lanes]
    sizes = torch.from_numpy(budgets).to(cuda)
    assert cbr.group_plan(*lengths[:2]) == {
        "unstaged": 0, "streamed_129": 0, "ragged_group": 32, "tiny": 4,
        "group8": 8, "444": 32}.get(case, 16)
    flags = torch.zeros(1, dtype=torch.int64, device=cuda)
    launches = cbr.cbr_quant_indices.launches
    got = cbr.cbr_quant_indices(*t, *qm, sizes, scalar, flags=flags)
    want = cbr.cbr_quant_indices_plain(*t, *qm, sizes, scalar)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cbr.cbr_quant_indices.launches == launches + 1
    over = bool((want > 119).any())
    assert int(flags.item()) == (dp.FLAG_QMAX if over else 0)
    assert over == (case == "no_fit")
    if case == "climb_past_3":
        best = cbr.bisect_plain(*t, *qm, sizes, scalar)
        assert int((want.to(torch.int64) - best).max()) > 3


@pytest.mark.parametrize("group", [4, 8, 16, 32])
def test_cbr_group_reductions(group, cuda):
    """redux.sync on a group's own mask, several groups a warp reaching it
    apart, against log2(g) shuffles and against numpy (csrc/hq_cbr.cu's
    reduction check)."""
    rng = np.random.default_rng(group)
    n = 4096
    x = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    src = torch.from_numpy(x).to(cuda)
    out = torch.empty((n // group, 4), dtype=torch.int32, device=cuda)
    assert cbr._lib().hq_cbr_reduce_check_launch(
        src.data_ptr(), out.data_ptr(), n, group,
        torch.cuda.current_stream().cuda_stream) == 0
    got = out.cpu().numpy()
    groups = x.reshape(-1, group)
    # a group's values gain nothing from the syncs before its reductions
    assert np.array_equal(got[:, 0], groups.sum(1)) and np.array_equal(
        got[:, 1], got[:, 0])
    assert np.array_equal(got[:, 2], groups.max(1)) and np.array_equal(
        got[:, 3], got[:, 2])


# name: (wavelet, depth, luma slice, chroma slice, grid, span, budget bytes)
LD_RATE_CASES = {
    "legall_d2_grid": (WaveletKernel.LeGall, 2, (8, 8), (8, 4), (20, 30),
                       4000, (20, 32)),
    "single_slice": (WaveletKernel.Haar1, 1, (4, 4), (4, 2), (1, 1), 3000,
                     (6, 50)),
    "single_row": (WaveletKernel.LeGall, 2, (8, 8), (8, 4), (1, 60), 3000,
                   (8, 64)),
    "single_column": (WaveletKernel.DD97, 3, (8, 16), (8, 8), (60, 1),
                      3000, (8, 64)),
    "lanes_to_2^29": (WaveletKernel.DD97, 2, (8, 8), (8, 4), (7, 11),
                      (1 << 29) - 1, (30, 400)),
    "no_fit": (WaveletKernel.LeGall, 2, (8, 8), (8, 4), (6, 9),
               (1 << 28) - 1, (2, 3)),
    "zero_bodies": (WaveletKernel.LeGall, 2, (8, 8), (8, 4), (9, 13), 3000,
                    (8, 40)),
    # large slices (the generic kernel, LL blocks 8 x 8 and 8 x 4): body
    # entries past the int16 range, 126 luma warps a slice in the table
    "unstaged": (WaveletKernel.LeGall, 3, (64, 64), (64, 32), (5, 6), 3000,
                 (300, 4000)),
    # coefficients over the whole int32 range, INT_MIN among them
    "lanes_to_2^31": (WaveletKernel.LeGall, 2, (8, 8), (8, 4), (6, 10),
                      (1 << 31) - 1, (30, 600)),
    # body lanes 0 by index 115 and non-zero at the wrapped factor 119:
    # the table's warps skip the all-zero trials and stop at the wrap
    "zero_then_wrapped": (WaveletKernel.LeGall, 2, (8, 8), (8, 4), (5, 7),
                          None, (6, 400)),
    # 4:4:4 and 4:2:0 slices: the generic kernel
    "444": (WaveletKernel.LeGall, 2, (8, 8), (8, 8), (6, 9), 3000, (8, 80)),
    "420": (WaveletKernel.DD97, 2, (8, 8), (4, 4), (6, 9), 3000, (8, 80)),
    # 4:2:2 at -u 1: the other fixed-shape kernel
    "fixed_1x2": (WaveletKernel.LeGall, 2, (4, 8), (4, 4), (12, 20), 3000,
                  (4, 40)),
    # more rows than the card runs at once (the generic kernel; the grid is
    # set at run time): the later rows wait for a CTA and take the next
    # ticket
    "rows_past_residency": (WaveletKernel.LeGall, 3, (8, 8), (8, 8),
                            None, 3000, (8, 80)),
}


def _ld_rate_inputs(case, cuda):
    kernel, depth, ys, cs, grid, span, (lo, hi) = LD_RATE_CASES[case]
    rng = np.random.default_rng(300 + list(LD_RATE_CASES).index(case))
    qmatrix = matrices.quant_matrix(kernel, depth)
    ts = 1 << depth
    if grid is None:
        rows = rdo_ld.resident_rows(ys[0] * ys[1], cs[0] * cs[1],
                                    (ys[0] // ts, ys[1] // ts),
                                    (cs[0] // ts, cs[1] // ts))
        grid = (rows + 64, 1)
    n = grid[0] * grid[1]
    bs, lanes = [], []
    for h, w in (ys, cs, cs):
        _, band = layout.lane_order(h, w, depth)
        bs.append(tuple(int(c) for c in np.bincount(band,
                                                    minlength=3 * depth + 1)))
        if span is None:    # 4|v| in [683344693, 8e8] and quant matrix 0
            v = rng.integers(171_000_000, 200_000_001, (n, h * w)) \
                * rng.choice([-1, 1], (n, h * w))
            qmatrix = np.zeros_like(qmatrix)
        else:
            v = rng.integers(-span, span + 1, (n, h * w))
            v[rng.random(v.shape) < 0.3] = 0
        if case == "lanes_to_2^31":
            v[::5, -1] = -(1 << 31)
        if case == "zero_bodies":
            v[:, bs[-1][0]:] = 0
        lanes.append(torch.from_numpy(v.astype(np.int32)).to(cuda))
    avail = rdo_ld.avail_bits(rng.integers(lo, hi, n))
    return (*lanes, qmatrix, bs[0], bs[1],
            torch.from_numpy(avail).to(cuda), grid,
            (ys[0] // ts, ys[1] // ts), (cs[0] // ts, cs[1] // ts))


@pytest.mark.parametrize("case", list(LD_RATE_CASES))
def test_ld_rate_kernel_matches_plain(case, cuda):
    """The LD rate control on the card against its plain version (run on
    the CPU, where its small per-diagonal ops cost less): integer == on q
    and the three LL lane sets."""
    args = _ld_rate_inputs(case, cuda)
    assert rdo_ld.fixed_shape(args[0].shape[1], args[1].shape[1], args[8],
                              args[9]) == (case not in (
                                  "single_column", "unstaged",
                                  "rows_past_residency", "444", "420"))
    launches = rdo_ld.ld_rate_control.launches
    got = rdo_ld.ld_rate_control(*args)
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    want = rdo_ld.ld_rate_control_plain(*cpu)
    torch.cuda.synchronize()
    assert rdo_ld.ld_rate_control.launches == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case == "no_fit":
        assert int((want[0] == 127).sum()) > want[0].numel() // 2


@pytest.mark.parametrize("case", list(LD_RATE_CASES))
def test_ld_body_table_kernel_matches_plain(case, cuda):
    """The LD rate control's body table on the card against its plain
    version (on the CPU): integer ==, every slice and trial."""
    args = _ld_rate_inputs(case, cuda)
    launches = rdo_ld.body_table.launches
    got = rdo_ld.body_table(*args[:6])
    cpu = [a.cpu() for a in args[:3]]
    want = rdo_ld.body_table_plain(*cpu, *args[3:6])
    torch.cuda.synchronize()
    assert rdo_ld.body_table.launches == launches + 1
    assert torch.equal(got.cpu(), want)
    if case == "unstaged":            # entries past the int16 range
        assert int(want.max()) > (1 << 15) - 1
    if case == "zero_then_wrapped":
        assert not want[:, :, 111:119].any() and bool(
            want[:, :, 119:127].all())


LD_PACK_CASES = ["random", "codes_over_32_bits", "zeros", "uv_fit_flag",
                 "ragged", "fused", "guard", "cut_in_a_code", "luma_overruns",
                 "ragged_chunks", "no_ll", "wide_slices", "many_windows",
                 "many_windows_long"]
# case: (luma lanes, chroma lanes, LL lanes of each, slices), where not
# (64, 32, (4, 2), 3000)
LD_PACK_SHAPES = {"ragged": (64, 32, (4, 2), 333),
                  "ragged_chunks": (63, 21, (3, 1), 1001),  # chunks of 15-16
                  "no_ll": (64, 32, (0, 0), 3000),
                  "wide_slices": (1024, 512, (4, 2), 300)}  # not held


def _ld_cut_sizes(rng, lanes, cut):
    """Slice bytes that hold the header and the luma codes but whose U/V
    bound falls 1 to 12 bits before the end of the last non-zero U/V code
    (inside a code or between codes, inside some chunk); with ``cut`` None,
    bytes that the luma codes alone overrun (uv_bits < 0)."""
    y_used = golomb.truncated_bits(lanes[0]).cpu().numpy()
    uv_used = golomb.truncated_bits(golomb.interleave(
        lanes[1], lanes[2])).cpu().numpy()
    sizes = np.maximum((7 + y_used) // 8, 1)
    if cut is None:
        return np.maximum(sizes - 1 - (y_used > 48), 1).astype(np.int32)
    need = 7 + y_used + uv_used - rng.integers(1, 13, y_used.size)
    for _ in range(3):     # len_bits grows with the size: settle it
        sizes = np.maximum(
            (need - np.array([max(8 * int(x) - 8, 1).bit_length()
                              if x > 1 else 0 for x in sizes])) // 8, 1)
    return sizes.astype(np.int32)


@pytest.mark.parametrize("case", LD_PACK_CASES)
def test_ld_pack_kernel_matches_plain(case, cuda):
    """The LD pack on the card against its plain version: the buffer
    [flags | payload] byte for byte, the quantised lanes, and nothing
    stored past the buffer. But for "fused", every quant matrix entry is
    127, so each body lane is quantised at index 0, where quant is the
    identity: the kernel packs the seeded lanes as they are. The cases
    reach the kernel's branches: a thread's chunk codes in one 64-bit
    string or through the code writer (codes over 32 bits,
    "many_windows_long"), lanes held or read again ("wide_slices"), a
    slice range of one window or several ("many_windows*"), the U/V bound
    inside a code, slices the luma codes overrun, chunks of unequal
    lengths, and no LL lanes."""
    rng = np.random.default_rng(400 + LD_PACK_CASES.index(case))
    ly, lc, nll, n = LD_PACK_SHAPES.get(case, (64, 32, (4, 2), 3000))
    span = {"codes_over_32_bits": 1 << 20, "zeros": 0,
            "many_windows_long": 1 << 16}.get(case, 40)
    lanes = []
    for length, s in ((ly, span), (lc, span // 2), (lc, span // 2)):
        v = rng.integers(-s, s + 1, (n, length))
        v[rng.random(v.shape) < 0.5] = 0
        lanes.append(torch.from_numpy(v.astype(np.int32)).to(cuda))
    if case == "codes_over_32_bits":
        lanes[0][::97, 5] = (1 << 30) + 12345           # codes of 62 bits
        lanes[1][::89, 3] = -(1 << 31)                  # |INT_MIN|: 64 bits
    q = torch.from_numpy(rng.integers(0, 128, n).astype(np.int32)).to(cuda)
    need = (golomb.truncated_bits(lanes[0]) + golomb.truncated_bits(
        golomb.interleave(lanes[1], lanes[2]))).cpu().numpy()
    sizes = ((need + 31) // 8 + rng.integers(0, 3, n)).astype(np.int32)
    if case == "uv_fit_flag":
        sizes[::7] = np.maximum(sizes[::7] - 4, 2)
    if case == "cut_in_a_code":
        sizes = _ld_cut_sizes(rng, lanes, True)
    if case == "luma_overruns":
        sizes = _ld_cut_sizes(rng, lanes, None)
    if case.startswith("many_windows"):     # a CTA's slices span 4 KB+
        sizes = sizes + 300
    sizes = torch.from_numpy(sizes).to(cuda)
    qm = [torch.from_numpy((rng.integers(0, 8, k) if case == "fused"
                            else np.full(k, 127)).astype(np.int32)).to(cuda)
          for k in (ly, lc)]
    ll = [x[:, :k].contiguous() for x, k in zip(lanes, (nll[0], nll[1],
                                                           nll[1]))]
    want, want_kept = dp.quant_pack_ld_plain(*lanes, ll, q, *qm, sizes,
                                             keep_lanes=True)
    if case == "guard":
        total = int(sizes.sum())
        buf = torch.full((4 + total + 4096,), 0xA5, dtype=torch.uint8,
                         device=cuda)
        kept = tuple(torch.empty_like(x) for x in lanes)
        dp.launch_ld_pack(lanes, ll, q, qm, sizes, dp._ld_starts(sizes),
                          total, keep=kept, out=buf)
        torch.cuda.synchronize()
        assert bool((buf[4 + total:] == 0xA5).all())
        got = buf[:4 + total]
    else:
        got, kept = dp.quant_pack_ld(*lanes, ll, q, *qm, sizes,
                                     keep_lanes=True)
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept, want_kept))
    if case != "fused":
        assert all(torch.equal(a, b) for a, b in zip(kept, lanes))
        assert torch.equal(want, dp.pack_ld_plain(*lanes, q, sizes))
    assert torch.equal(got, want)
    flags, _ = dp.ld_result(got)
    assert flags == (dp.FLAG_LD_FIT if case in (
        "uv_fit_flag", "cut_in_a_code", "luma_overruns") else 0)
    if case == "wide_slices":
        assert dp.ld_group_size(ly, lc) == 32


@pytest.mark.parametrize("case,tap", [(c, None) for c in LD] + [
    tuple(t) for t in META["taps"] if t[0].startswith("ld")])
def test_ld_golden_encodes_through_the_kernels(case, tap, cuda, tmp_path):
    _, inp, extra = next(c for c in META["cases"] if c[0] == case)
    m = META["inputs"][inp]
    argv = ["-x", str(m["width"]), "-y", str(m["height"]), "-f", m["fmt"],
            "-l", str(m["depth"]), "-n", "2", *extra,
            *(["-o", tap] if tap else []),
            os.path.join(GOLDEN, f"{inp}.16p2"), str(tmp_path / "out.bin")]
    rates, packs = (rdo_ld.ld_rate_control.launches,
                    dp.quant_pack_ld.launches)
    hq, lifts = dp.pack_hq.launches, bands.forward_lanes.launches
    assert encode_stream.main(argv) == 0
    ref = f"{case}.vc2" if tap is None else f"{case}.{tap.lower()}.raw"
    with open(os.path.join(GOLDEN, ref), "rb") as f:
        assert (tmp_path / "out.bin").read_bytes() == f.read()
    pictures = rdo_ld.ld_rate_control.launches - rates
    assert pictures > 0 and dp.quant_pack_ld.launches - packs == pictures
    assert bands.forward_lanes.launches - lifts == pictures * int(
        extra[extra.index("-d") + 1])
    assert dp.pack_hq.launches == hq


# --- the band route's kernels (csrc/band_lift.cu) ----------------------------

def _slice_grid(ys, xs, luma, chroma):
    return SliceGeometry(ys, xs, (ys * luma[0], xs * luma[1]),
                         (ys * chroma[0], xs * chroma[1]), luma, chroma)


def _check_band_kernels(rng, geo, kernel, depth, dev, lim=2000, q_hi=60,
                        wrap=False):
    """Both band kernels against their plain versions on seeded inputs of
    slice geometry ``geo``: the inverse from lanes alone and with LD LL
    grids, the forward from int16 samples and from int32 ones (whose
    planes pad); ``wrap``: lanes over the whole int32 range with half the
    slices at q 116-119 (the wrapped factors), int32 samples over it too.
    Returns the launches of each."""
    qm = matrices.quant_matrix(kernel, depth)
    comps = (geo.luma_slice, geo.chroma_slice, geo.chroma_slice)
    pads = (geo.padded_luma, geo.padded_chroma, geo.padded_chroma)
    lanes = [torch.from_numpy(rng.integers(-lim, lim, (geo.n_slices, h * w))
                              .astype(np.int32)).to(dev) for h, w in comps]
    q = rng.integers(0, q_hi, geo.n_slices).astype(np.int32)
    if wrap:
        q[::2] = rng.integers(116, 120, len(q[::2]))
    q = torch.from_numpy(q).to(dev)
    inverses, forwards = bands.inverse_lanes.launches, \
        bands.forward_lanes.launches
    for ll in (None, [torch.from_numpy(
            rng.integers(-1 << 14, 1 << 14, (h >> depth, w >> depth))
            .astype(np.int32)).to(dev) for h, w in pads]):
        got = bands.inverse_lanes(lanes, q, qm, geo, kernel, depth, ll)
        want = bands.inverse_lanes_plain(lanes, q, qm, geo, kernel, depth, ll)
        for g, w in zip(got, want):
            assert torch.equal(g, w), ("inverse", ll is not None)
    cut = 1 if depth == 1 else 3              # rows and columns the pad adds
    for dtype, span in ((torch.int16, 512), (torch.int32, lim)):
        planes = [torch.from_numpy(rng.integers(-span, span,
                                                (h - cut, w - 1)))
                  .to(dtype).to(dev) for h, w in pads]
        got = bands.forward_lanes(planes, kernel, depth, geo)
        want = bands.forward_lanes_plain(planes, kernel, depth, geo)
        for g, w in zip(got, want):
            assert torch.equal(g, w), ("forward", dtype)
    return (bands.inverse_lanes.launches - inverses,
            bands.forward_lanes.launches - forwards)


def test_band_kernels_match_plain_at_1080p(cuda):
    """The 1080p 4:2:2 LeGall depth-2 geometry (135 x 240 slices of 8 x 8
    and 8 x 4): depth launches each way a picture."""
    geo = _slice_grid(135, 240, (8, 8), (8, 4))
    launches = _check_band_kernels(np.random.default_rng(1080), geo,
                                   WaveletKernel.LeGall, 2, cuda)
    assert launches == (2 * 2, 2 * 2)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_band_kernels_match_plain(kernel, depth, cuda):
    side = 8 << max(depth - 1, 0)
    geo = _slice_grid(3, 5, (side, 16), (side, 8))
    _check_band_kernels(np.random.default_rng(10 * int(kernel) + depth), geo,
                        kernel, depth, cuda)


# slice grids whose bands' sub-blocks are not powers of two: -u 1 -a 2 at
# 1080p (slices of 4 x 8 luma, 4 x 4 chroma), 12-row slices, 4:2:0 with
# 24 / 12 columns, 4:4:4
BAND_GRIDS = {"u1a2_1080p": (270, 240, (4, 8), (4, 4), 2),
              "rows12": (3, 5, (12, 24), (12, 12), 2),
              "420_cols24": (4, 3, (16, 24), (8, 12), 2),
              "444_d3": (2, 3, (24, 40), (24, 40), 3)}


@pytest.mark.parametrize("grid", list(BAND_GRIDS))
def test_band_kernels_on_other_slice_grids(grid, cuda):
    ys, xs, luma, chroma, depth = BAND_GRIDS[grid]
    for kernel in (WaveletKernel.DD137, WaveletKernel.Fidelity):
        _check_band_kernels(np.random.default_rng(len(grid)),
                            _slice_grid(ys, xs, luma, chroma), kernel, depth,
                            cuda)


@pytest.mark.parametrize("kernel", [WaveletKernel.Daub97,
                                    WaveletKernel.LeGall],
                         ids=["Daub97", "LeGall"])
def test_band_kernels_wrap_int32(kernel, cuda):
    """Lanes and samples over the whole int32 range, half the slices at
    q 116-119: the dequantise's wrapped products and factors and the
    ladders' wrapped sums (Daub97's taps reach 6497)."""
    _check_band_kernels(np.random.default_rng(97), _slice_grid(
        4, 6, (24, 40), (24, 16)), kernel, 3, cuda, lim=(1 << 31) - 1,
        q_hi=120, wrap=True)


# the edges of the run-major design: slices of 64 x 64 at depth 1, whose
# 32-row sub-blocks every tile splits; runs that start off a 16-byte
# boundary (6 x 10 slices at depth 1: LL is 15 lanes, where the LD grids
# replace it the run starts at lane 15)
BAND_EDGES = {"split_64x64_d1": (2, 3, (64, 64), (64, 32), 1),
              "runs_off_16B_d1": (5, 7, (6, 10), (6, 6), 1)}


@pytest.mark.parametrize("grid", list(BAND_EDGES))
def test_band_kernels_on_the_run_edges(grid, cuda):
    ys, xs, luma, chroma, depth = BAND_EDGES[grid]
    for kernel in (WaveletKernel.LeGall, WaveletKernel.Fidelity):
        _check_band_kernels(np.random.default_rng(len(grid)),
                            _slice_grid(ys, xs, luma, chroma), kernel, depth,
                            cuda)


def test_band_kernels_walk_many_tiles_at_8k(cuda):
    """The 8K geometry (BASELINE config #5, -u 1 -a 2): 4536 tiles at the
    finest level, far more than the CTAs the card holds, so every CTA
    walks many tiles and reuses its shared memory."""
    launches = _check_band_kernels(np.random.default_rng(8),
                                   _slice_grid(1080, 960, (4, 8), (4, 4)),
                                   WaveletKernel.LeGall, 2, cuda)
    assert launches == (2 * 2, 2 * 2)


def test_band_kernels_with_a_q_a_slice_at_1080p(cuda):
    """The 1080p geometry with a q a slice over 0-119, half of them
    116-119 (CBR-like), with and without the LD grids."""
    _check_band_kernels(np.random.default_rng(119),
                        _slice_grid(135, 240, (8, 8), (8, 4)),
                        WaveletKernel.LeGall, 2, cuda, q_hi=120, wrap=True)


# --- the multi-device paths (shard/, pipeline/sharded.py) -------------------

def _shared_mesh(data, space):
    from vc2tpu_torch.shard.mesh import make_mesh

    return make_mesh(data, space, devices=["cuda:0"] * (data * space))


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_halo_lift_matches_unsharded_on_the_card(kernel, cuda):
    """The halo lift over 2 and 4 bands of one card (one launch a level
    for all of them) against the unsharded lift, both ways, at 1080p rows
    and on bands thin enough to reach two bands away."""
    from vc2tpu_torch.shard import halo

    rng = np.random.default_rng(int(kernel))
    for rows, cols, space in ((1080, 1920, 2), (1088, 960, 4),
                              (4 * 16, 48, 4)):
        x = _plane(rng, (rows, cols), cuda)
        mesh = _shared_mesh(1, space)
        want = lifting.forward_plane(x, kernel, 2)
        assert torch.equal(halo.sharded_forward_plane(x, mesh, kernel, 2),
                           want)
        assert torch.equal(halo.sharded_inverse_plane(want, mesh, kernel, 2),
                           lifting.inverse_plane(want, kernel, 2))


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_band_form_matches_single_device_on_the_card(kernel, cuda):
    """``halo.forward_bands_local`` / ``inverse_bands_local`` over 2 and 4
    bands of one card (4:2:2 at 1080p slice rows and over the thinnest
    bands the JAX package takes, 4:2:0 over 4 bands; LD grids as band 0)
    against the single-device band route on the card, with ``depth``
    launches of each kernel a band; int16 samples whose last rows and
    columns the kernel pads."""
    from vc2tpu_torch.shard import halo

    rng = np.random.default_rng(200 + int(kernel))
    depth = 2
    thin = max(1, halo.halo_width(kernel))
    for geo, n in ((_slice_grid(136, 8, (8, 8), (8, 4)), 2),
                   (_slice_grid(4 * thin, 6, (4, 8), (4, 4)), 4),
                   (_slice_grid(16 * thin, 3, (16, 16), (8, 8)), 4)):
        comps = (geo.luma_slice, geo.chroma_slice, geo.chroma_slice)
        pads = (geo.padded_luma, geo.padded_chroma, geo.padded_chroma)
        planes = [torch.from_numpy(rng.integers(-512, 512, (h - 3, w - 3))
                                   .astype(np.int16)).to(cuda)
                  for h, w in pads]
        lanes = [torch.from_numpy(rng.integers(-2000, 2000, (
            geo.n_slices, h * w)).astype(np.int32)).to(cuda)
            for h, w in comps]
        q = torch.from_numpy(rng.integers(0, 60, geo.n_slices).astype(
            np.int32)).to(cuda)
        grids = [torch.from_numpy(rng.integers(-1 << 14, 1 << 14, (
            h >> depth, w >> depth)).astype(np.int32)).to(cuda)
            for h, w in pads]
        qm = matrices.quant_matrix(kernel, depth)
        want_f = bands.forward_lanes(planes, kernel, depth, geo)
        want_i = [bands.inverse_lanes(lanes, q, qm, geo, kernel, depth, ll)
                  for ll in (None, grids)]
        got_f, got_i = [[], [], []], [[[], [], []], [[], [], []]]
        blocks = halo.band_blocks(geo, n, kernel, depth)
        xs = geo.x_slices
        f0, i0 = bands.forward_lanes.launches, bands.inverse_lanes.launches
        for s, (a, _r0, _r1, b) in enumerate(blocks):
            sh = [c[0] for c in comps]
            blk = [p[a * h:b * h] for p, h in zip(planes, sh)]
            for c, t in enumerate(halo.forward_bands_local(
                    blk, kernel, depth, geo, s, n)):
                got_f[c].append(t)
            sl = slice(a * xs, b * xs)
            for k, ll in enumerate((None, grids)):
                g = None if ll is None else [
                    x[a * h >> depth:b * h >> depth] for x, h in zip(ll, sh)]
                for c, t in enumerate(halo.inverse_bands_local(
                        [x[sl] for x in lanes], q[sl], qm, kernel, depth,
                        geo, s, n, g)):
                    got_i[k][c].append(t)
        assert bands.forward_lanes.launches - f0 == depth * n
        assert bands.inverse_lanes.launches - i0 == 2 * depth * n
        for g, w in zip(got_f, want_f):
            assert torch.equal(torch.cat(g), w), (geo, n)
        for gk, wk in zip(got_i, want_i):
            for g, w in zip(gk, wk):
                assert torch.equal(torch.cat(g), w), (geo, n)


def _random_1080p(cfg, seed=1):
    from vc2tpu_torch.shard import multihost

    return multihost.harness_frames(cfg, 2, seed)


def test_sharded_1080p_encode_and_decode_on_one_card(cuda):
    """1080p HQ CBR over a 1x3 mesh of one card, and a 2x3 one with two
    pictures: the payloads equal the single-device Encoder's, and
    Decoder(mesh=) decodes them as Decoder() does; the bands' launches
    (the band form: ``depth`` band launches a band, no ``lift_level``)."""
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.pipeline.sharded import ShardedEncoder
    from vc2tpu_torch.shard import multihost

    cfg = multihost.harness_config("1080p")
    pics = _random_1080p(cfg)
    enc = Encoder(cfg)
    want = [enc.encode_picture(p) for p in pics]
    lifts = lifting.lift_levels.launches
    for data in (1, 2):
        mesh = _shared_mesh(data, 3)
        packs = dp.pack_hq.launches
        forwards = bands.forward_lanes.launches
        got = ShardedEncoder(cfg, mesh).encode_batch(pics[:data])
        assert dp.pack_hq.launches - packs == 3 * data
        assert bands.forward_lanes.launches - forwards == 2 * 3 * data
        for g, w in zip(got, want):
            assert g.payload == w.payload
            assert np.array_equal(g.q_indices, w.q_indices)
    stream = multihost.harness_stream(cfg, want, 16384)
    ref, out = io.BytesIO(), io.BytesIO()
    assert Decoder(sink=ref).run(stream) == 0
    unpacks = du.unpack_hq.launches
    inverses = bands.inverse_lanes.launches
    assert Decoder(sink=out, mesh=_shared_mesh(1, 3)).run(stream) == 0
    assert du.unpack_hq.launches - unpacks == 6
    assert bands.inverse_lanes.launches - inverses == 2 * 3 * 2
    assert lifting.lift_levels.launches == lifts
    assert out.getvalue() == ref.getvalue()


def test_async_encodes_of_distinct_pictures(cuda):
    """Four distinct 1080p pictures dispatched with
    ``encode_picture_async`` before any handle is resolved (so the
    two-slot staging ring waits on its events): each handle equals
    ``encode_picture`` of its own picture, one at a time."""
    import dataclasses

    from vc2tpu_torch.core.config import Mode
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.shard import multihost

    for cfg in (multihost.harness_config("1080p"),
                dataclasses.replace(multihost.harness_config("1080p"),
                                    mode=Mode.HQ_ConstQ, q_index=40,
                                    compressed_bytes=0)):
        pics = multihost.harness_frames(cfg, 4, seed=3)
        enc = Encoder(cfg)
        handles = [enc.encode_picture_async(p) for p in pics]
        results = [h() for h in handles]
        for got, p in zip(results, pics):
            want = enc.encode_picture(p)
            assert got.payload == want.payload
            assert np.array_equal(got.slice_totals, want.slice_totals)
        assert len({r.payload for r in results}) == len(pics)


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


def test_launches_go_to_the_tensors_card(cuda):
    """With the tensors on cuda:1 and cuda:0 current, an HQ decode and a
    CBR encode give cuda:0's bytes (each launch runs in its tensors'
    card's device guard)."""
    _two_cards()
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.shard import multihost

    cfg = multihost.harness_config("1080p")
    pic = _random_1080p(cfg)[0]
    with open(os.path.join(GOLDEN, "constq_legall_d2.vc2"), "rb") as f:
        stream = f.read()
    torch.cuda.set_device(0)
    outs = []
    for dev in ("cuda:0", "cuda:1"):
        sink = io.BytesIO()
        assert Decoder(sink=sink, device=dev).run(stream) == 0
        outs.append((sink.getvalue(),
                     Encoder(cfg, device=dev).encode_picture(pic).payload))
        assert torch.cuda.current_device() == 0
    assert outs[0] == outs[1]


def test_mesh_over_two_cards(cuda):
    """A 1x2 mesh over cuda:0 and cuda:1 (peer copies of the halo rows):
    the encode and the mesh decode equal one card's."""
    _two_cards()
    from vc2tpu_torch.pipeline.encoder import Encoder
    from vc2tpu_torch.pipeline.sharded import ShardedEncoder
    from vc2tpu_torch.shard import multihost
    from vc2tpu_torch.shard.mesh import make_mesh

    cfg = multihost.harness_config("1080p")
    pics = _random_1080p(cfg)[:1]
    mesh = make_mesh(1, 2)
    got = ShardedEncoder(cfg, mesh).encode_batch(pics)[0]
    want = Encoder(cfg).encode_picture(pics[0])
    assert got.payload == want.payload
    stream = multihost.harness_stream(cfg, [want])
    ref, out = io.BytesIO(), io.BytesIO()
    assert Decoder(sink=ref).run(stream) == 0
    assert Decoder(sink=out, mesh=mesh).run(stream) == 0
    assert out.getvalue() == ref.getvalue()
