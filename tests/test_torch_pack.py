"""The port's HQ slice pack and chain scan against vc2tpu on the CPU: the
plain ``pack_hq`` (the CUDA kernel's reference) against the JAX package's
device pack and its host packer, byte for byte, over prefixes, scalars,
CBR budgets, codes up to 64 bits and every error flag; the fused plain
``quant_pack_hq`` against the JAX encoder's ``quant_banded`` and device
pack; the kernel's buffer bound, its tile assembly and its quantise
arithmetic modelled in Python; the exp-Golomb codes; and the native and
plain chain scans against ``vc2tpu.slices.hq.scan_hq_slice_offsets``. The
kernel itself is held against the plain versions by
tests/test_torch_cuda.py (on the card)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vc2tpu.core import config as jcfg
from vc2tpu.quant import quantiser as jq
from vc2tpu.slices.hq import encode_hq_slices
from vc2tpu.slices.hq import scan_hq_slice_offsets as j_scan
from vc2tpu.slices.layout import slice_bytes_map as j_slice_bytes_map
from vc2tpu.vlc import device_pack as jdp
from vc2tpu.vlc import golomb as jgolomb
from vc2tpu.wavelet import matrices as jm

from vc2tpu_torch.quant import quantiser as tq
from vc2tpu_torch.slices import hq as thq
from vc2tpu_torch.slices import layout as tlayout
from vc2tpu_torch.slices.layout import slice_bytes_map
from vc2tpu_torch.vlc import device_pack as tdp
from vc2tpu_torch.vlc import golomb as tgolomb


def _lanes(rng, n, ly, lc, zero_frac=0.6, span=200):
    qy = rng.integers(-span, span, (n, ly)).astype(np.int32)
    qu = rng.integers(-span // 4, span // 4, (n, lc)).astype(np.int32)
    qv = rng.integers(-span // 4, span // 4, (n, lc)).astype(np.int32)
    qy[rng.random((n, ly)) < zero_frac] = 0
    qu[rng.random((n, lc)) < zero_frac + 0.1] = 0
    qv[rng.random((n, lc)) < zero_frac + 0.1] = 0
    return qy, qu, qv


def _pack(qy, qu, qv, q_idx, prefix, scalar, sizes=None):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (qy, qu, qv,
                                                              q_idx)]
    s = None if sizes is None else torch.from_numpy(
        np.array(sizes, dtype=np.int32))
    buf, flags = tdp.pack_hq(*t, prefix, scalar, s)
    totals, payload = tdp.split_result(buf.numpy(), len(q_idx))
    return totals, payload.tobytes(), flags


@pytest.mark.parametrize("prefix,scalar,cbr", [
    (0, 1, False), (2, 3, False), (0, 1, True), (1, 2, True)])
def test_pack_matches_vc2tpu_device_pack(prefix, scalar, cbr):
    rng = np.random.default_rng(42)
    n, ly, lc = 24, 64, 32
    qy, qu, qv = _lanes(rng, n, ly, lc)
    q_idx = rng.integers(0, 100, n).astype(np.int32)
    sizes = (slice_bytes_map(1, n, n * 150, scalar).ravel() if cbr
             else np.zeros(n, np.int32))
    w32 = (prefix + (int(sizes.max()) if cbr else 4 + 3 * 255 * scalar)
           + 3) // 4
    want_payload, want_totals = encode_hq_slices(
        q_idx, qy, qu, qv, prefix, scalar, slice_sizes=sizes if cbr else None)
    cap = int(np.asarray(want_totals).sum())
    buf = np.asarray(jdp.pack_hq_payload(
        jnp.asarray(qy), jnp.asarray(qu), jnp.asarray(qv), jnp.asarray(q_idx),
        jnp.asarray(sizes), prefix=prefix, scalar=scalar, w32=w32,
        cap_bytes=cap, cbr=cbr))
    jflags, _q, jtotals, jpayload = jdp.unpack_result(buf, n)
    totals, payload, flags = _pack(qy, qu, qv, q_idx, prefix, scalar,
                                   sizes if cbr else None)
    assert flags == jflags == 0
    assert np.array_equal(totals, jtotals)
    assert np.array_equal(totals, np.asarray(want_totals))
    assert payload == jpayload[:cap].tobytes() == want_payload


@pytest.mark.parametrize("seed", range(6))
def test_pack_matches_host_packer_over_alignments(seed):
    """Random slice counts, lane counts, prefixes, scalars and CBR budgets
    (each slice's natural size plus slack), so slice starts hit every byte
    phase and the CBR fill varies."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(3, 40))
    ly = int(rng.choice([4, 16, 64]))
    lc = max(ly // 2, 1)
    prefix, scalar = int(rng.integers(0, 4)), int(rng.integers(1, 4))
    cbr = bool(seed % 2)
    qy, qu, qv = _lanes(rng, n, ly, lc, float(rng.uniform(0.2, 0.95)),
                        int(rng.integers(2, 400)))
    q_idx = rng.integers(0, 120, n).astype(np.int32)
    sizes = None
    if cbr:
        _, natural = encode_hq_slices(q_idx, qy, qu, qv, prefix, scalar)
        sizes = (np.asarray(natural) - prefix
                 + rng.integers(0, 8, n) * scalar).astype(np.int32)
    want_payload, want_totals = encode_hq_slices(q_idx, qy, qu, qv, prefix,
                                                 scalar, slice_sizes=sizes)
    totals, payload, flags = _pack(qy, qu, qv, q_idx, prefix, scalar, sizes)
    assert flags == 0
    assert np.array_equal(totals, np.asarray(want_totals))
    assert payload == want_payload


@pytest.mark.parametrize("scalar", [1, 8, 64])
def test_pack_long_codes_match_host_packer(scalar):
    """Codes of 33-64 bits (|v| up to 2^31), which the JAX device pack
    leaves to its host packer: the port packs them directly."""
    rng = np.random.default_rng(scalar)
    n = 12
    qy = rng.integers(-(1 << 31), 1 << 31, (n, 32)).astype(np.int32)
    qy[rng.random((n, 32)) < 0.3] = 0
    qy[0, 0], qy[1, 1], qy[2, 31] = -(1 << 31), (1 << 31) - 1, (1 << 30)
    qu = rng.integers(-(1 << 20), 1 << 20, (n, 16)).astype(np.int32)
    qv = np.zeros((n, 16), np.int32)
    qv[::3, 15] = -1                         # a last non-zero at the end
    q_idx = rng.integers(0, 120, n).astype(np.int32)
    want_payload, want_totals = encode_hq_slices(q_idx, qy, qu, qv, 1,
                                                 scalar)
    totals, payload, flags = _pack(qy, qu, qv, q_idx, 1, scalar)
    assert flags == 0
    assert np.array_equal(totals, np.asarray(want_totals))
    assert payload == want_payload


def _flag_case(flag):
    """(lanes, q indices, prefix, scalar, CBR sizes or None) of a pack
    that sets ``flag``."""
    rng = np.random.default_rng(9)
    n = 6
    small = _lanes(rng, n, 16, 8, span=40)
    q = rng.integers(0, 120, n).astype(np.int32)
    if flag == tdp.FLAG_SCALAR:
        big = rng.integers(-(1 << 24), 1 << 24, (n, 256)).astype(np.int32)
        return (big, small[1], small[2]), q, 0, 1, None
    if flag == tdp.FLAG_QINDEX:
        return small, q + 250, 0, 1, None
    if flag == tdp.FLAG_CBR_FIT:
        return small, q, 0, 1, slice_bytes_map(1, n, n * 6, 1).ravel()
    return small, q, 0, 1, slice_bytes_map(1, n, n * 400, 1).ravel()


@pytest.mark.parametrize("flag", [tdp.FLAG_SCALAR, tdp.FLAG_QINDEX,
                                  tdp.FLAG_CBR_FIT, tdp.FLAG_VLEN],
                         ids=["scalar", "qindex", "cbr_fit", "vlen"])
def test_pack_flags_and_errors(flag):
    lanes, q, prefix, scalar, sizes = _flag_case(flag)
    totals, payload, flags = _pack(*lanes, q, prefix, scalar, sizes)
    assert flags == flag
    assert payload == b""                    # no payload for invalid sizes
    with pytest.raises(ValueError) as got:
        tdp.check_flags(flags)
    if flag == tdp.FLAG_QINDEX:              # vc2tpu's encoder message
        assert "quantization index exceeds" in str(got.value)
        return
    with pytest.raises(ValueError) as want:  # vc2tpu's host packer
        encode_hq_slices(q, *lanes, prefix, scalar, slice_sizes=sizes)
    assert str(got.value) == str(want.value)


def _put_byte(win, pos, x):
    """csrc/hq_pack.cu's put_byte: OR byte x at window bit ``pos`` (a
    multiple of 8) unless it falls outside the window."""
    if 0 <= pos < 32 * len(win):
        win[pos >> 5] |= x << (24 - (pos & 31))


def _write_chunk(win, pos, codes):
    """csrc/hq_pack.cu's BitWriter: append the (code, bits) of a thread's
    chunk from window bit ``pos`` on; the first and last word are ORed in,
    the words between are stored (they must be the thread's alone), words
    outside the window are dropped."""
    word, fill, acc, first = pos >> 5, pos & 31, 0, True

    def emit(x, shared):
        if x and 0 <= word < len(win):
            win[word] = win[word] | x if shared else x

    for code, n in codes:
        parts = ([(code >> 32, n - 32), (code & 0xFFFFFFFF, 32)] if n > 32
                 else [(code, n)])
        for c, k in parts:
            acc |= c << (64 - fill - k)
            fill += k
            if fill >= 32:
                emit(acc >> 32, first)
                first = False
                acc = (acc << 32) & ((1 << 64) - 1)
                fill -= 32
                word += 1
    if fill:
        emit(acc >> 32, True)


def _assembly_model(lanes, q_idx, prefix, scalar, tile, window_words, lo,
                    cap, mem, group=4):
    """csrc/hq_pack.cu's write phase on the CPU: slice totals from the
    plain version's sizing, tiles of ``tile`` consecutive slices placed by
    the exclusive scan of the tile totals (what the look-back yields);
    each tile's byte range assembled in 16-byte-aligned windows of
    ``window_words`` words: thread t of a slice's ``group`` writes chunk
    (t + c) mod group of component c with ``_write_chunk``, the threads
    taken last to first, and four of them a header byte each; then stored
    into ``mem`` from absolute byte ``lo`` on: whole 16-byte chunks at
    once, the edge chunks byte by byte, nothing at or past ``lo + cap``.
    Returns the numbers of whole and of edge chunks."""
    codes = [tgolomb.signed_codes(torch.from_numpy(c)) for c in lanes]
    cb = [(tdp._component_bytes(torch.from_numpy(c), nb, scalar)
           * scalar).tolist() for c, (_, nb) in zip(lanes, codes)]
    codes = [(c.tolist(), nb.tolist()) for c, nb in codes]
    n = len(q_idx)
    totals = [prefix + 4 + cb[0][i] + cb[1][i] + cb[2][i] for i in range(n)]
    wbytes = 4 * window_words
    whole = edge = 0
    base = 0
    hi = lo + cap
    for t0 in range(0, n, tile):
        slices = range(t0, min(t0 + tile, n))
        starts = np.cumsum([0] + [totals[i] for i in slices])
        agg = int(starts[-1])
        a0, a1 = lo + base, min(lo + base + agg, hi)
        wa = max(a0, lo) & ~15
        while wa < a1:
            win = [0] * window_words
            for k in reversed(range(len(slices))):
                i = slices[k]
                sa = a0 + int(starts[k])
                if sa + totals[i] <= wa or sa >= wa + wbytes:
                    continue
                rel = 8 * (sa - wa)
                yb, ub, vb = cb[0][i], cb[1][i], cb[2][i]
                for at, value in ((prefix, int(q_idx[i])),
                                  (prefix + 1, yb // scalar),
                                  (prefix + 2 + yb, ub // scalar),
                                  (prefix + 3 + yb + ub, vb // scalar)):
                    _put_byte(win, rel + 8 * at, value & 0xFF)
                data_at = (prefix + 2, prefix + 3 + yb, prefix + 4 + yb + ub)
                for t in reversed(range(group)):
                    for c, ((code, nb), at, nbytes) in enumerate(
                            zip(codes, data_at, (yb, ub, vb))):
                        length = len(code[i])
                        chunk = (t + c) % group
                        j0 = chunk * length // group
                        j1 = (chunk + 1) * length // group
                        off = sum(nb[i][:j0])
                        out = []
                        for j in range(j0, j1):
                            if off >= 8 * nbytes:
                                break
                            m = nb[i][j]
                            keep = min(m, 8 * nbytes - off)
                            out.append((code[i][j] >> (m - keep), keep))
                            off += m
                        if out:
                            _write_chunk(win, rel + 8 * at + sum(
                                nb[i][:j0]), out)
            b0, b1 = max(wa, a0, lo), min(wa + wbytes, a1)
            for c0 in range(wa, wa + wbytes, 16):
                if c0 >= b1 or c0 + 16 <= b0:
                    continue
                inside = b0 <= c0 and c0 + 16 <= b1
                whole += inside
                edge += not inside
                for b in range(c0, c0 + 16):
                    if b0 <= b < b1:
                        j = b - wa
                        mem[b] = (win[j >> 2] >> (24 - 8 * (j & 3))) & 0xFF
            wa += wbytes
        base += agg
    return whole, edge


@pytest.mark.parametrize("window_words,tile,phase", [
    (4, 3, 5), (12, 5, 0), (2048, 64, 9), (12, 1, 14)])
def test_pack_kernel_assembly_is_exact(window_words, tile, phase):
    """The kernel's tile assembly, modelled on the CPU, equals the plain
    pack: consecutive slices staged into one byte range that starts at an
    unaligned byte, four threads a slice each writing one rotated chunk of
    each component (the words between a chunk's first and last are
    stored, not ORed), whole 16-byte chunks and edge chunks, windows of 1,
    3 and 512 chunks (codes up to 64 bits straddle them, and a slice spans
    several), header bytes, zero fill, a ragged last tile; no byte outside
    the payload is stored, and a smaller capacity cuts the stores."""
    rng = np.random.default_rng(window_words + tile)
    n = 10
    qy = rng.integers(-(1 << 31), 1 << 31, (n, 16)).astype(np.int32)
    qy[rng.random((n, 16)) < 0.4] = 0
    qu, qv = (rng.integers(-300, 300, (n, 8)).astype(np.int32)
              for _ in range(2))
    qv[:, 4:] = 0
    q_idx = rng.integers(0, 120, n).astype(np.int32)
    for prefix, scalar in ((0, 1), (3, 2), (1, 7)):
        _totals, payload, flags = _pack(qy, qu, qv, q_idx, prefix, scalar)
        assert flags == 0
        lo = 4 * n + phase
        for cap in (len(payload), len(payload) // 2):
            mem = bytearray(b"\xee" * (lo + len(payload) + 48))
            whole, edge = _assembly_model((qy, qu, qv), q_idx, prefix,
                                          scalar, tile, window_words, lo,
                                          cap, mem)
            assert mem[lo:lo + cap] == payload[:cap]
            assert mem[:lo] == b"\xee" * lo
            assert mem[lo + cap:] == b"\xee" * (len(mem) - lo - cap)
            assert whole > 0 and edge > 0


@pytest.mark.parametrize("prefix,scalar,cbr", [
    (0, 1, False), (2, 3, False), (0, 1, True), (1, 2, True)])
def test_quant_pack_matches_vc2tpu(prefix, scalar, cbr):
    """The fused plain version (``quant`` at each lane's adjusted index,
    then the pack) against the JAX encoder's ``quant_banded`` and
    ``pack_hq_payload`` on the same transform lanes, and its kept lanes
    against ``quant_banded``."""
    rng = np.random.default_rng(7 + prefix + 10 * scalar)
    depth, (sh, sw), (ch, cw) = 2, (4, 8), (4, 4)
    qm = jm.quant_matrix(jcfg.WaveletKernel.LeGall, depth).astype(np.int32)
    n = 24
    trans, qms, want_q = [], [], []
    q_idx = rng.integers(16, 60, n).astype(np.int32)
    for h, w in ((sh, sw), (ch, cw), (ch, cw)):
        _, band = tlayout.lane_order(h, w, depth)
        x = rng.integers(-(1 << 12), 1 << 12, (n, h * w)).astype(np.int32)
        x[rng.random(x.shape) < 0.3] = 0
        trans.append(x)
        qms.append(qm[band])
        sizes = tuple(int(c) for c in np.bincount(band))
        want_q.append(np.asarray(jq.quant_banded(
            jnp.asarray(x), jnp.asarray(q_idx), jnp.asarray(qm), sizes)))
    per_slice = 120 + 130 * scalar
    budgets = (slice_bytes_map(1, n, n * per_slice, scalar).ravel() if cbr
               else np.zeros(n, np.int32))
    w32 = (prefix + (int(budgets.max()) if cbr else 4 + 3 * 255 * scalar)
           + 3) // 4
    _, want_totals = encode_hq_slices(q_idx, *want_q, prefix, scalar,
                                      slice_sizes=budgets if cbr else None)
    buf = np.asarray(jdp.pack_hq_payload(
        *(jnp.asarray(a) for a in want_q), jnp.asarray(q_idx),
        jnp.asarray(budgets), prefix=prefix, scalar=scalar, w32=w32,
        cap_bytes=int(np.asarray(want_totals).sum()), cbr=cbr))
    jflags, _q, jtotals, jpayload = jdp.unpack_result(buf, n)
    t = [torch.from_numpy(a) for a in trans]
    got, flags, lanes = tdp.quant_pack_hq(
        *t, torch.from_numpy(q_idx), torch.from_numpy(qms[0]),
        torch.from_numpy(qms[1]), prefix, scalar,
        torch.from_numpy(budgets.copy()) if cbr else None, keep_lanes=True)
    totals, payload = tdp.split_result(got.numpy(), n)
    assert flags == jflags == 0
    assert np.array_equal(totals, jtotals)
    assert payload.tobytes() == jpayload[:int(totals.sum())].tobytes()
    for g, w in zip(lanes, want_q):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("scalar", [1, 7, 64])
@pytest.mark.parametrize("cbr", [False, True])
def test_payload_capacity_bounds_int_min_lanes(scalar, cbr):
    """``payload_capacity``, the kernel's buffer size, bounds the payload
    of every pack that sets no flag: lanes of INT_MIN (the longest code,
    64 bits), and for CBR budgets that give v the largest unflagged size
    (a length byte of 255). Lanes too long for the scalar set a flag."""
    n = 6
    q = np.arange(n, dtype=np.int32)
    unflagged = 0
    for ly, lc in ((8, 4), (24, 12), (32, 16), (512, 256)):
        lanes = [np.full((n, L), -(1 << 31), np.int32) for L in (ly, lc, lc)]
        sizes = None
        if cbr:
            natural, _, _ = _pack(lanes[0], lanes[1],
                                  np.zeros_like(lanes[2]), q, 1, scalar)
            sizes = (natural - 1 + 256 * scalar - 1).astype(np.int32)
        _totals, payload, flags = _pack(*lanes, q, 1, scalar, sizes)
        cap = tdp.payload_capacity(n, ly, lc, 1, scalar, cbr)
        if flags:
            assert flags & tdp.FLAG_SCALAR and 8 * ly > 255 * scalar
            continue
        unflagged += 1
        assert len(payload) <= cap
        body = 8 * (ly + 2 * lc) + 3 * (scalar - 1)
        if not cbr and body <= 3 * 255 * scalar:   # tight up to rounding
            assert cap - len(payload) <= n * 3 * (scalar - 1)
    assert unflagged >= 2


def _kernel_quantise(v: int, q: int) -> int:
    """csrc/hq_pack.cu's quantise in Python integers: the high 64 bits of
    (|v| << 2) times the factor's reciprocal, or a 64-bit division from
    |v| >= 2^30 on; the sign of v times the factor's; int32 wrap."""
    f = int(tq.QUANT_FACTORS_I32[q])
    m = abs(v)
    if m < 1 << 30:
        r = ((m << 2) * tdp.quant_reciprocals()[q]) >> 64
    else:
        r = (m << 2) // abs(f)
    r = -r if (v < 0) != (f < 0) else r
    return (r + (1 << 31)) % (1 << 32) - (1 << 31)


def test_quant_reciprocals_divide_exactly():
    """n // |factor| as the kernel forms it, for every q, at the edges of
    each quotient (k * d - 1, k * d) up to 2^32 - 1 and at random n."""
    rng = np.random.default_rng(11)
    for q, rc in enumerate(tdp.quant_reciprocals()):
        d = abs(int(tq.QUANT_FACTORS_I32[q]))
        ks = np.unique(np.concatenate([np.arange(1, 50),
                                       rng.integers(1, (1 << 32) // d + 1,
                                                    200)]))
        ns = [0, 1, d - 1, d, (1 << 32) - 1] + [
            n for k in ks.tolist() for n in (k * d - 1, k * d)
            if n < 1 << 32] + rng.integers(0, 1 << 32, 300).tolist()
        for n in ns:
            assert (n * rc) >> 64 == n // d, (q, n)


def test_kernel_quantise_matches_quant():
    """The kernel's quantise arithmetic equals the port's ``quant`` at every
    q 0-119 over the whole int32 range (INT_MIN, |v| >= 2^30 and the
    wrapped factors at 116-119 included)."""
    rng = np.random.default_rng(12)
    edge = [0, 1, -1, 2, 3, -5, (1 << 29) - 1, 1 << 29, (1 << 30) - 1,
            1 << 30, -(1 << 30), (1 << 31) - 1, -(1 << 31), -(1 << 31) + 1]
    v = np.concatenate([edge, rng.integers(-(1 << 31), 1 << 31, 60)]
                       ).astype(np.int32)
    vv = np.broadcast_to(v, (120, v.size))
    q = np.broadcast_to(np.arange(120)[:, None], vv.shape)
    want = tq.quant(torch.from_numpy(vv.copy()),
                    torch.from_numpy(q.copy())).numpy()
    got = np.array([[_kernel_quantise(int(x), qq) for x in v]
                    for qq in range(120)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ys,xs,total,scalar", [
    (1, 24, 3600, 1), (135, 240, 829440, 2), (4, 4, 2048, 3), (2, 3, 50, 1)])
def test_slice_bytes_map_matches_vc2tpu(ys, xs, total, scalar):
    assert np.array_equal(slice_bytes_map(ys, xs, total, scalar),
                          j_slice_bytes_map(ys, xs, total, scalar))


def test_pack_without_slices():
    z = torch.zeros((0, 4), dtype=torch.int32)
    buf, flags = tdp.pack_hq(z, z[:, :2], z[:, :2],
                             torch.zeros(0, dtype=torch.int32), 0, 1)
    assert flags == 0 and buf.numel() == 0


def test_pack_wrapper_refuses_bad_inputs():
    y = torch.zeros((3, 4), dtype=torch.int32)
    c = torch.zeros((3, 2), dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tdp.pack_hq(y.to(torch.int64), c, c, q, 0, 1)
    with pytest.raises(ValueError):
        tdp.pack_hq(y, c, c[:, :1], q, 0, 1)
    with pytest.raises(ValueError):
        tdp.pack_hq(y, c, c, q[:2], 0, 1)
    with pytest.raises(ValueError):
        tdp.pack_hq(y.to("meta"), c.to("meta"), c.to("meta"), q.to("meta"),
                    0, 1)


def test_signed_codes_match_vc2tpu():
    rng = np.random.default_rng(3)
    v = np.concatenate([
        np.arange(-300, 301), rng.integers(-(1 << 31), 1 << 31, 5000),
        [-(1 << 31), (1 << 31) - 1, (1 << 16) - 1, -(1 << 16), 1 << 30],
    ]).astype(np.int32)
    code, nbits = tgolomb.signed_codes(torch.from_numpy(v))
    want_code, want_nbits = jgolomb.signed_codes_np(v)
    assert np.array_equal(nbits.numpy(), want_nbits.astype(np.int64))
    assert np.array_equal(code.numpy().astype(np.uint64), want_code)


@pytest.mark.parametrize("value", [0, 1, 2, 7, 255, 1 << 20])
def test_scalar_codes_match_vc2tpu(value):
    assert (tgolomb.encode_unsigned_scalar(value)
            == jgolomb.encode_unsigned_scalar(value))
    assert (tgolomb.encode_signed_scalar(-value)
            == jgolomb.encode_signed_scalar(-value))


def _chain(rng, n, prefix, scalar):
    """An HQ slice chain with random lengths and data."""
    parts = []
    for _ in range(n):
        parts += [0] * prefix + [int(rng.integers(0, 120))]
        for _c in range(3):
            k = int(rng.integers(0, 6))
            parts += [k] + list(rng.integers(0, 256, k * scalar))
    return np.asarray(parts, np.uint8)


@pytest.mark.parametrize("prefix,scalar", [(0, 1), (3, 2), (1, 5)])
@pytest.mark.parametrize("scan", ["native", "plain"])
def test_chain_scan_matches_vc2tpu(prefix, scalar, scan):
    fn = (thq.scan_hq_slice_offsets if scan == "native"
          else thq.scan_hq_slice_offsets_plain)
    rng = np.random.default_rng(prefix + 10 * scalar)
    n = 300
    pl = np.concatenate([rng.integers(0, 256, 7).astype(np.uint8),
                         _chain(rng, n, prefix, scalar),
                         np.zeros(5, np.uint8)])
    want = j_scan(pl, n, prefix, scalar, 7)
    for payload in (pl, pl.tobytes(), bytearray(pl.tobytes()),
                    memoryview(pl.tobytes())):
        got = fn(payload, n, prefix, scalar, 7)
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w)
        assert got[3] == want[3] == len(pl) - 5


@pytest.mark.parametrize("cut", [1, 2, 5, 40])
@pytest.mark.parametrize("scan", ["native", "plain"])
def test_chain_scan_cut_short_raises(cut, scan):
    """A chain that runs past the end of the data: both scans raise the
    ValueError the decoder's stream loop answers by growing its window,
    where vc2tpu's scan raises too."""
    fn = (thq.scan_hq_slice_offsets if scan == "native"
          else thq.scan_hq_slice_offsets_plain)
    rng = np.random.default_rng(cut)
    n = 50
    pl = _chain(rng, n, 1, 2)
    short = pl[:-cut]
    with pytest.raises(ValueError, match="past the end"):
        j_scan(short, n, 1, 2)
    with pytest.raises(ValueError, match="past the end"):
        fn(short.tobytes(), n, 1, 2)
