"""The port's HQ slice pack and chain scan against vc2tpu on the CPU: the
plain ``pack_hq`` (the CUDA kernel's reference) against the JAX package's
device pack and its host packer, byte for byte, over prefixes, scalars,
CBR budgets, codes up to 64 bits and every error flag; the exp-Golomb
codes; and the native and plain chain scans against
``vc2tpu.slices.hq.scan_hq_slice_offsets``. The kernel itself is held
against the plain version by tests/test_torch_cuda.py (on the card)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vc2tpu.slices.hq import encode_hq_slices
from vc2tpu.slices.hq import scan_hq_slice_offsets as j_scan
from vc2tpu.slices.layout import slice_bytes_map as j_slice_bytes_map
from vc2tpu.vlc import device_pack as jdp
from vc2tpu.vlc import golomb as jgolomb

from vc2tpu_torch.slices import hq as thq
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


def _window_put(win, pos, n, code):
    """csrc/hq_pack.cu's put_bits: OR the n bits of ``code`` (MSB first)
    at window bit ``pos``, dropping the bits outside the window."""
    bits = 32 * len(win)
    end = pos + n
    if end <= 0 or pos >= bits:
        return
    if end > bits:
        code >>= end - bits
        n -= end - bits
    if pos < 0:
        n += pos
        pos = 0
        code &= (1 << n) - 1
    while n > 0:
        room = 32 - (pos & 31)
        take = min(n, room)
        win[pos >> 5] |= ((code >> (n - take)) & ((1 << take) - 1)) << (
            room - take)
        n -= take
        pos += take


def _kernel_model(lanes, q_idx, prefix, scalar, window_words):
    """csrc/hq_pack.cu's write launch on the CPU, one slice after another:
    each slice assembled one window of ``window_words`` words at a time
    (the header bytes and every code clipped to the window), then emitted
    as bytes. Component bytes come from the plain version's sizing."""
    codes = [tgolomb.signed_codes(torch.from_numpy(c)) for c in lanes]
    cb = [tdp._component_bytes(torch.from_numpy(c), nb, scalar) * scalar
          for c, (_, nb) in zip(lanes, codes)]
    out = bytearray()
    for i in range(len(q_idx)):
        yb, ub, vb = (int(b[i]) for b in cb)
        total = prefix + 4 + yb + ub + vb
        data_at = (prefix + 2, prefix + 3 + yb, prefix + 4 + yb + ub)
        header = ((prefix, int(q_idx[i])), (prefix + 1, yb // scalar),
                  (prefix + 2 + yb, ub // scalar),
                  (prefix + 3 + yb + ub, vb // scalar))
        for w0 in range(0, total, 4 * window_words):
            win = [0] * window_words
            for at, value in header:
                _window_put(win, 8 * (at - w0), 8, value & 0xFF)
            for (code, nb), at, nbytes in zip(codes, data_at, (yb, ub, vb)):
                carry = 0
                for c, n in zip(code[i].tolist(), nb[i].tolist()):
                    keep = max(0, min(n, 8 * nbytes - carry))
                    if keep:
                        _window_put(win, 8 * (at - w0) + carry, keep,
                                    c >> (n - keep))
                    carry += n
            for j in range(min(4 * window_words, total - w0)):
                out.append((win[j >> 2] >> (24 - 8 * (j & 3))) & 0xFF)
    return bytes(out)


@pytest.mark.parametrize("window_words", [1, 3, 256])
def test_pack_kernel_windows_are_exact(window_words):
    """The kernel's window assembly, modelled on the CPU with windows of
    1, 3 and 256 words, equals the plain pack: codes up to 64 bits that
    straddle windows, header bytes and zero fill included."""
    rng = np.random.default_rng(window_words)
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
        assert _kernel_model((qy, qu, qv), q_idx, prefix, scalar,
                             window_words) == payload


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
