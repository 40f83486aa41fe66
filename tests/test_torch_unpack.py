"""The port's plain HQ unpack (and its host chain scan) against vc2tpu's
device unpack, on the cases of tests/test_device_unpack.py: host-encoded
slices, the random-bytes fuzz, the adversarial scan-bound rows and
zero-length components. The CUDA kernel is held against the plain version
by tests/test_torch_cuda.py (on the card)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vc2tpu.slices.hq import encode_hq_slices
from vc2tpu.slices.hq import scan_hq_slice_offsets as j_scan
from vc2tpu.vlc import device_unpack as jdu

from vc2tpu_torch.slices.hq import scan_hq_slice_offsets as t_scan
from vc2tpu_torch.vlc import device_unpack as tdu


def _jax_hq(pl, n, prefix, lane_counts, cbytes):
    p4 = (len(pl) + 3) // 4 * 4 + 8
    pad = np.zeros(p4, np.uint8)
    pad[:len(pl)] = pl
    wc = tuple(jdu.window_words(int(cbytes[c].max(initial=0)), lane_counts[c])
               for c in range(3))
    fn = jax.jit(lambda p, c, s: jdu.unpack_hq_lanes(p, c, s, prefix,
                                                     lane_counts, wc))
    out = fn(jnp.asarray(pad), jnp.asarray(cbytes, jnp.int32), jnp.int32(0))
    return [np.asarray(o) for o in out]


def _port_hq(pl, n, prefix, scalar, lane_counts, device="cpu"):
    """The port's path: host chain scan, device offsets, unpack."""
    q, dstart, cbytes, end = t_scan(pl.tobytes(), n, prefix, scalar)
    clen = torch.as_tensor(cbytes.astype(np.int32), device=device)
    offs = tdu.hq_component_offsets(clen, prefix, 0)
    assert np.array_equal(offs.cpu().numpy(), dstart)
    pay = torch.as_tensor(pl, device=device)
    return tdu.unpack_hq(pay, offs, clen, lane_counts[0], lane_counts[1])


def _slices(scale, prefix, scalar, cbr):
    rng = np.random.default_rng(hash((scale, prefix, scalar, cbr)) % 2**32)
    N, Ly, Lc = 37, 64, 32
    ly = rng.normal(0, scale, (N, Ly)).astype(np.int32)
    lu = rng.normal(0, scale / 2, (N, Lc)).astype(np.int32)
    lv = rng.normal(0, scale / 2, (N, Lc)).astype(np.int32)
    ly[rng.random((N, Ly)) < 0.4] = 0
    lu[rng.random((N, Lc)) < 0.6] = 0
    lv[:, Lc // 2:] = 0                     # trailing-zero truncation paths
    q = rng.integers(0, 50, N).astype(np.int32)
    sizes = np.full(N, 160, np.int64) if cbr else None
    payload, _ = encode_hq_slices(q, ly, lu, lv, prefix, scalar,
                                  slice_sizes=sizes)
    return np.frombuffer(payload, np.uint8).copy(), N, (Ly, Lc, Lc)


ENCODED = [
    (12, 0, 1, False),
    (300, 2, 3, False),
    (200000, 0, 1, False),      # huge magnitudes (long codes)
    (7, 0, 1, True),            # CBR: padded third component (bounded 1s)
    (3, 1, 2, True),
]


def _jax_rows(regions, L):
    """vc2tpu's device unpack of many (payload, starts, lens) row sets in
    ONE jitted call (one compile): the payloads are laid end to end."""
    chunks, starts, lens, base = [], [], [], 0
    for payload, st, ln in regions:
        chunks.append(payload)
        starts.append(np.asarray(st, np.int64) + base)
        lens.append(np.asarray(ln, np.int64))
        base += len(payload)
    payload = np.concatenate(chunks)
    starts, lens = np.concatenate(starts), np.concatenate(lens)
    p4 = (len(payload) + 3) // 4 * 4 + 8
    pad = np.zeros(p4, np.uint8)
    pad[:len(payload)] = payload
    W = jdu.window_words(int(lens.max()), L)
    words = jdu.assemble_words(jnp.asarray(pad))
    got = np.asarray(jax.jit(
        lambda w, d, c: jdu.unpack_component(w, d, c, L, W))(
            words, jnp.asarray(starts, jnp.int32),
            jnp.asarray(lens, jnp.int32)))
    out, pos = [], 0
    for _payload, st, _ln in regions:
        out.append(got[pos:pos + len(st)])
        pos += len(st)
    return out


@pytest.fixture(scope="module")
def encoded_want():
    """vc2tpu's unpack of every ENCODED case's three components. Rows are
    decoded with the luma lane count; a chroma row's first Lc lanes are its
    lanes (decoding is sequential, so a longer row only adds lanes)."""
    regions = []
    for case in ENCODED:
        pl, n, _lanes = _slices(*case)
        _q, dstart, cbytes, _end = j_scan(pl, n, case[1], case[2])
        regions.append((pl, dstart.reshape(-1), cbytes.reshape(-1)))
    return _jax_rows(regions, 64)


@pytest.mark.parametrize("idx", range(len(ENCODED)),
                         ids=["-".join(map(str, c)) for c in ENCODED])
def test_unpack_matches_vc2tpu_on_encoded_slices(idx, encoded_want):
    scale, prefix, scalar, cbr = ENCODED[idx]
    pl, n, lanes = _slices(scale, prefix, scalar, cbr)
    jq, jdst, jcb, jend = j_scan(pl, n, prefix, scalar)
    tq, tdst, tcb, tend = t_scan(pl.tobytes(), n, prefix, scalar)
    assert np.array_equal(jq, tq) and np.array_equal(jdst, tdst)
    assert np.array_equal(jcb, tcb) and jend == tend
    got = _port_hq(pl, n, prefix, scalar, lanes)
    want = encoded_want[idx]
    for c in range(3):
        w = want[c * n:(c + 1) * n, :lanes[c]]
        assert np.array_equal(got[c].numpy(), w), c


def _rows_case(case):
    """(payload, starts, lens, L) bounded rows of one lane count."""
    if case == "random_bytes":
        rng = np.random.default_rng(7)
        payload = rng.integers(0, 256, 4096, dtype=np.uint8)
        S, L = 63, 24
        starts = np.sort(rng.integers(0, 3000, S)).astype(np.int64)
        lens = rng.integers(0, 40, S).astype(np.int64)      # bytes, incl. 0
        return payload, starts, lens, L
    rng = np.random.default_rng(42)
    L = 24
    big = (1 << 30) + 12345                 # 62-bit code (31 data bits)
    if case == "all_long":
        regions = [_pack([-big if i % 2 else big for i in range(L)])] * 4
    elif case == "alternating":
        regions = [_pack([0 if i % 2 else big for i in range(L)]),
                   _pack([big if i % 3 else 0 for i in range(L)]),
                   _pack([0, 0, big, big] * (L // 4))]
    elif case == "all_zero_bytes":
        regions = [np.zeros(n, np.uint8) for n in (1, 3, 5, 7)]
    elif case == "all_ones":
        regions = [np.full(n, 0xFF, np.uint8) for n in (1, 8, 64)]
    else:                                   # ramp over every code length
        regions = [_pack([(1 << k) - 1 for k in range(L)]),
                   _pack([-(1 << k) for k in range(L)])]
    gap = rng.integers(1, 5, len(regions))
    starts, lens, chunks, pos = [], [], [], 0
    for g, r in zip(gap, regions):
        chunks.append(np.zeros(g, np.uint8))
        pos += int(g)
        starts.append(pos)
        lens.append(len(r))
        chunks.append(r)
        pos += len(r)
    return (np.concatenate(chunks), np.asarray(starts, np.int64),
            np.asarray(lens, np.int64), L)


def _pack(vals):
    """Reference-shaped interleaved exp-Golomb packer (VLC.cpp:54-94)."""
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


def _port_rows(payload, starts, lens, L, device="cpu"):
    """Rows of one lane count through the port's [3, N] interface: pad to
    a multiple of 3 with empty regions, one third per component."""
    S = len(starts)
    n = -(-S // 3)
    st = np.zeros(3 * n, np.int32)
    ln = np.zeros(3 * n, np.int32)
    st[:S], ln[:S] = starts, lens
    out = tdu.unpack_hq(torch.as_tensor(payload, device=device),
                        torch.as_tensor(st.reshape(3, n), device=device),
                        torch.as_tensor(ln.reshape(3, n), device=device),
                        L, L)
    return torch.cat(out).cpu().numpy()[:S]


ROW_CASES = ["random_bytes", "all_long", "alternating", "all_zero_bytes",
             "all_ones", "ramp"]


@pytest.fixture(scope="module")
def rows_want():
    regions = [_rows_case(case)[:3] for case in ROW_CASES]
    return dict(zip(ROW_CASES, _jax_rows(regions, 24)))


@pytest.mark.parametrize("case", ROW_CASES)
def test_unpack_rows_match_vc2tpu(case, rows_want):
    payload, starts, lens, L = _rows_case(case)
    assert L == 24
    assert np.array_equal(_port_rows(payload, starts, lens, L),
                          rows_want[case])


def test_unpack_zero_length_components():
    """A 0-byte bounded region reads only 1-bits: every lane decodes 0."""
    N, Ly, Lc = 5, 16, 8
    z = np.zeros((N, Ly), np.int32)
    payload, _ = encode_hq_slices(np.zeros(N, np.int32), z, z[:, :Lc].copy(),
                                  z[:, :Lc].copy(), 0, 1)
    pl = np.frombuffer(payload, np.uint8).copy()
    _, _, cbytes, _ = t_scan(pl.tobytes(), N, 0, 1)
    assert not cbytes.any()
    want = _jax_hq(pl, N, 0, (Ly, Lc, Lc), cbytes)
    got = _port_hq(pl, N, 0, 1, (Ly, Lc, Lc))
    for w, g in zip(want, got):
        assert not w.any() and not g.numpy().any()


def test_scan_raises_on_short_payload():
    pl, n, _lanes = _slices(12, 0, 1, False)
    with pytest.raises(ValueError):
        t_scan(pl[:-5].tobytes(), n, 0, 1)


def test_unpack_wrapper_refuses_bad_inputs():
    pay = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tdu.unpack_hq(pay, torch.zeros((3, 2), dtype=torch.int64),
                      torch.zeros((3, 2), dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError):
        tdu.unpack_hq(pay.to("meta"), torch.zeros((3, 2), dtype=torch.int32),
                      torch.zeros((3, 2), dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError):       # CTA flags need the kernel
        tdu.unpack_hq(pay, torch.zeros((3, 2), dtype=torch.int32),
                      torch.zeros((3, 2), dtype=torch.int32), 4, 4,
                      staged=torch.zeros(1, dtype=torch.uint8))


def _cta_windows(dstart, clen, s):
    """The kernel's byte window of every CTA of slices [c * s, (c + 1) * s):
    the 16-byte-aligned start of its non-empty regions, the bytes it stages
    (to 16 past the aligned end, for the peeks' look-ahead) and whether they
    fit WINDOW_BYTES (else its peeks read device memory). Returns (lo16,
    span, staged), int64/bool [ceil(N / s)]."""
    n = dstart.shape[1]
    pad = -n % s
    lo = torch.nn.functional.pad(dstart.to(torch.int64), (0, pad))
    ln = torch.nn.functional.pad(clen.to(torch.int64), (0, pad))
    hi = lo + ln
    big = torch.iinfo(torch.int64).max
    lo = torch.where(ln > 0, lo, big).reshape(3, -1, s).amin(dim=(0, 2))
    hi = torch.where(ln > 0, hi, -1).reshape(3, -1, s).amax(dim=(0, 2))
    empty = hi < 0
    lo16 = torch.where(empty, 0, lo & ~15)
    span = torch.where(empty, 0, ((hi + 15) & ~15) + 16 - lo16)
    return lo16, span, span <= tdu.WINDOW_BYTES


def _kernel_model(payload, dstart, clen, ly, lc):
    """csrc/hq_unpack.cu on the CPU: each CTA's regions are decoded from
    peeks of its staged window (``_cta_windows``: big-endian words of the
    bytes it spans, 0xFF past the payload end) or, for a CTA whose window
    is over the budget, of the whole payload with the same rule; every
    staged peek is also checked against the whole-payload peek. The
    decode loop is the kernel's: one peek for every code that ends inside
    it, runs of zero codes counted at once into zeroed lanes. Returns the
    lanes and the CTAs' staged flags."""
    pl = payload.numpy()
    nbytes = len(pl)
    n = dstart.shape[1]
    s, _stage = tdu.unpack_plan(ly, lc)
    lo16, span, staged = _cta_windows(dstart, clen, s)

    def global_word(k):
        return int.from_bytes(bytes(int(pl[b]) if b < nbytes else 0xFF
                                    for b in range(4 * k, 4 * k + 4)), "big")

    def peek(word, p, bound):
        k, o = p >> 5, p & 31
        w0, w1, w2 = word(k), word(k + 1), word(k + 2)
        w = ((((w0 << 32) | w1) << o) >> 32 & 0xFFFFFFFF) << 32
        w |= (((w1 << 32) | w2) << o) >> 32 & 0xFFFFFFFF
        if bound - p < 64:
            w |= (1 << 64) - 1 >> (bound - p)
        return w

    follow = int("10" * 32, 2)
    m64 = (1 << 64) - 1

    def clz(x):
        return 64 - x.bit_length()

    out = [np.zeros((n, ly), np.int64), np.zeros((n, lc), np.int64),
           np.zeros((n, lc), np.int64)]
    for cta in range(-(-n // s)):
        base = int(lo16[cta])
        win = bytes(int(pl[b]) if b < nbytes else 0xFF
                    for b in range(base, base + int(span[cta])))

        def window_word(k, win=win, base=base):
            i = 4 * k - base
            assert 0 <= i and i + 4 <= len(win), "peek outside the window"
            return int.from_bytes(win[i:i + 4], "big")

        for c in range(3):
            for i in range(cta * s, min(n, (cta + 1) * s)):
                # the kernel's loop: w holds stream bits [p, p + avail)
                p = 8 * int(dstart[c, i])
                bound = p + 8 * int(clen[c, i])
                nd, w, avail, lanes = 0, 0, 0, out[c].shape[1]
                while nd < lanes and p < bound:
                    ones = clz(~w & m64)
                    if ones:                 # a run of zero codes
                        k = min(ones, lanes - nd)
                        nd, p, avail = nd + k, p + k, avail - k
                        w = (w << k) & m64
                        continue
                    z = clz(w & follow)
                    if z + 2 > avail:
                        if avail < 64:
                            w = peek(global_word, p, bound)
                            if staged[cta]:
                                assert peek(window_word, p, bound) == w
                            avail = 64
                            continue
                        z = 62
                    ndata = z >> 1
                    even = int("".join(str(w >> (2 * j) & 1)
                                       for j in range(31, -1, -1)), 2)
                    mag = ((1 << ndata) | (even >> (32 - ndata))) - 1
                    val = -mag if (w >> (62 - z)) & 1 else mag
                    out[c][i, nd] = (val + (1 << 31)) % (1 << 32) - (1 << 31)
                    nd, p, avail = nd + 1, p + z + 2, avail - z - 2
                    w = (w << (z + 2)) & m64
    return [torch.from_numpy(o.astype(np.int32)) for o in out], staged


def _window_case(case):
    """(payload, dstart, clen, ly, lc) of one window-model case."""
    rng = np.random.default_rng(11)
    if case == "encoded":
        pl, n, lanes = _slices(300, 2, 3, False)
        _q, dstart, cbytes, _end = t_scan(pl.tobytes(), n, 2, 3)
        return pl, dstart, cbytes, lanes[0], lanes[1]
    if case in ROW_CASES:                # long codes, 1-fill, random bits
        payload, starts, lens, L = _rows_case(case)
        k = -(-len(starts) // 3)
        st, ln = np.zeros(3 * k, np.int64), np.zeros(3 * k, np.int64)
        st[:len(starts)], ln[:len(lens)] = starts, lens
        return payload, st.reshape(3, k), ln.reshape(3, k), L, L
    if case == "no_terminator":          # 64 bits with no follow bit set
        pl = np.zeros(48, np.uint8)
        pl[20] = 0x55
        return (pl, np.array([[0, 9], [17, 30], [40, 47]]),
                np.array([[9, 8], [13, 10], [7, 9]]), 6, 6)
    if case == "over_budget":            # regions far apart: one window
        n, size = 40, 3 * tdu.WINDOW_BYTES
        starts = np.sort(rng.integers(0, size - 64, 3 * n)).reshape(3, n)
        lens = rng.integers(0, 40, (3, n))
        pl = rng.integers(0, 256, size, dtype=np.uint8)
        return pl, starts, lens, 16, 8
    # slices laid end to end over several CTAs; the last region runs past
    # the payload end
    n = 2 * tdu.SLICES_PER_CTA + 37
    lens = rng.integers(0, 12, (n, 3))
    lens[::5] = 0                        # empty regions
    ends = np.cumsum(lens.reshape(-1) + 1)
    starts = (ends - lens.reshape(-1)).reshape(n, 3).T
    lens = lens.T.copy()
    lens[2, -1] = 24
    pl = rng.integers(0, 256, int(starts[2, -1]) + 9, dtype=np.uint8)
    return pl, starts, lens, 12, 6


@pytest.mark.parametrize("case", ["encoded", "over_budget", "past_end",
                                  "random_bytes", "all_long", "ramp",
                                  "all_zero_bytes", "no_terminator"])
def test_unpack_kernel_windows_are_exact(case):
    pl, dstart, clen, ly, lc = _window_case(case)
    args = (torch.from_numpy(pl), torch.from_numpy(dstart.astype(np.int32)),
            torch.from_numpy(clen.astype(np.int32)))
    got, staged = _kernel_model(*args, ly, lc)
    want = tdu.unpack_hq_plain(*args, ly, lc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "over_budget":
        assert not staged.any()
    else:
        assert staged.all()
    if case == "past_end":
        assert len(staged) > 2
        assert int(dstart[2, -1]) + int(clen[2, -1]) > len(pl)
