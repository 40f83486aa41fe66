// LD slice payload assembly on the card, with the body lanes quantised in
// its load: the port of the JAX package's XLA function
// vc2tpu/vlc/device_pack.py:302::pack_ld_core, applied to the output of
// its encoder's quant_banded (vc2tpu/pipeline/ld.py:146-151), with the
// bytes of the host packer vc2tpu/_native/vc2host.cpp:1363 (ld_pack;
// reference src/Library/src/Slices.cpp:195-303).
//
// A slice of `size` bytes starts at its fixed byte offset, the exclusive
// sum of the sizes before it, and holds in order:
//   the 7-bit qIndex;
//   a len_bits = intlog2(8 size - 7)-bit field: y_used, the luma codes'
//   bits up to the last non-zero code;
//   the luma codes, bounded at y_used bits;
//   the U/V codes interleaved (u0 v0 u1 v1 ...), bounded at uv_bits = 8
//   size - 7 - len_bits - y_used bits, the last code cut at the bound;
//   zeros to the slice's end.
// Where the interleaved U/V codes need more than uv_bits up to their last
// non-zero code, FLAG_LD_FIT is set (the encoder raises the reference's
// error); every store stays inside its slice all the same.
//
// What bounds it on the card: the transform lanes read once and the
// payload written once, ~17 MB at 1080p, ~5.7 us of memory time. The
// kernel before this design (commit 7f60d0a) ran one thread a slice (7.7
// warps an SM at 1080p), each loading its lanes with loads a warp could
// not coalesce and walking them twice, sizing then writing through the
// code writer: 28.8 and 46.5 us a warp, 0.085 ms a picture (clock64()
// stamps, vc2tpu_torch/testdata/ld_stamps.py, and chip_smoke.py; PERF.md
// §6). This design takes 0.033 ms, its load and sizing ~14 us a warp.
//
// Design (hq_pack.cu's groups, without its look-back: LD offsets are fixed
// by the budgets, so no scan runs between slices). One launch; a CTA of
// THREADS threads takes THREADS / g consecutive slices, a group of g
// threads (4 to 32, a power of two, device_pack.ld_group_size) a slice.
// Thread t owns a contiguous chunk of the luma lanes and the same index
// range j of U and V, so its part of the interleaved stream u_j v_j ... is
// contiguous too.
//   load   each lane is read once, with 16-byte loads, eight lanes' loads
//          in flight, and quantised there: the first nll lanes are the
//          rate control's LL lanes, the others quantised at max(q - qm[j],
//          0) by golomb_encode.cuh's exact quotient (its short form where
//          four lanes are below 2^30). The quantised lanes are stored when
//          asked for and held in shared memory (thread-major, no bank
//          conflicts) with a mask of the non-zero ones; chunks too long to
//          hold are read and quantised again to be written.
//   size   each thread sums its chunks' code bits and the bits up to the
//          end of its last non-zero code; a group scan gives each chunk's
//          offset in its region, a group max y_used and uv_used, and the
//          first thread of the group sets FLAG_LD_FIT.
//   write  the CTA's byte range is assembled in a shared window, zeroed
//          first (the zero fill). Where a chunk's codes fit 64 bits (at
//          1080p nearly all: most lanes quantise to 0, a 1-bit code), the
//          thread forms them as one bit string, a run of zero lanes and the
//          non-zero lane after it a step, cuts it at y_used or uv_bits and
//          at the slice's end, and ORs it into the window with at most
//          three shared atomics; the header goes the same way. Longer
//          chunks go through the shared code writer (golomb_encode.cuh).
//          The CTA stores the window with 16-byte stores; only the chunks
//          at its ends, which the neighbouring CTAs share, go byte by byte.
//          A range larger than the window is assembled one window after
//          another.
// Every int32 codes in at most 64 bits, so there is no overflow case and
// no host fallback. Every store stays inside [4, 4 + total).

#include <cstdint>
#include <cuda_runtime.h>

#include "golomb_encode.cuh"
#include "ld_pack_params.h"

namespace {

using vc2::code_bits;
using vc2::code_of;
using vc2::quantise;

constexpr int THREADS = VC2_LD_PACK_THREADS;
constexpr int HOLD = VC2_LD_PACK_HOLD;     // quantised lanes a thread keeps
constexpr int MIN_BLOCKS = VC2_LD_PACK_MIN_BLOCKS;   // CTAs an SM, at least
static_assert(HOLD <= 32, "a held chunk's non-zero lanes are a 32-bit mask");
constexpr unsigned FLAG_LD_FIT = VC2_FLAG_LD_FIT;
constexpr int MIN_GROUP = 4;
constexpr int WINDOW_WORDS = 1024;         // the CTA's output window
constexpr int WINDOW_BYTES = 4 * WINDOW_WORDS;
constexpr long long WINDOW_BITS = 8LL * WINDOW_BYTES;
constexpr unsigned FULL = 0xffffffffu;

__constant__ int32_t QUANT_FACTORS[120] = {VC2_QUANT_FACTORS};
__constant__ unsigned long long QUANT_RECIPROCALS[120] = {
    VC2_QUANT_RECIPROCALS};

struct PackArgs {
  const int32_t* lanes[3];   // [n, len[c]] transform lanes
  const int32_t* ll[3];      // [n, nll[c]] LL codes of the rate control
  const int32_t* qm[3];      // quant matrix entry of each lane
  int32_t* keep[3];          // quantised lanes out, or null
  int len[3], nll[3];
  const int32_t* q_idx;      // [n]
  const int32_t* sizes;      // [n] slice bytes
  const long long* starts;   // [n] first byte of each slice
  uint8_t* out;              // [flags uint32 | payload]
  int n, group;
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Four lanes' loads in flight: the transform lanes, their quant matrix
// entries and, for LL lanes, the rate control's LL codes.
struct Fetch {
  int32_t v[4], m[4], ll[4];
};

// Issue the loads of lanes b..b+cnt-1 (cnt <= 4) of component c of slice
// s: one 16-byte load of the lanes and one of the quant matrix where
// aligned; the LL codes of those below nll.
__device__ __forceinline__ Fetch fetch4(const PackArgs& a, int c, long long s,
                                        int b, int cnt) {
  Fetch f;
  const int32_t* src = a.lanes[c] + s * a.len[c] + b;
  const int32_t* qm = a.qm[c] + b;
  if (cnt == 4 && aligned16(src) && aligned16(qm)) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(src));
    const int4 y = __ldg(reinterpret_cast<const int4*>(qm));
    f.v[0] = x.x, f.v[1] = x.y, f.v[2] = x.z, f.v[3] = x.w;
    f.m[0] = y.x, f.m[1] = y.y, f.m[2] = y.z, f.m[3] = y.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f.v[k] = k < cnt ? __ldg(src + k) : 0;
      f.m[k] = k < cnt ? __ldg(qm + k) : 0;
    }
  }
  const int nll = a.nll[c];
  if (b < nll) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f.ll[k] = b + k < nll ? __ldg(a.ll[c] + s * nll + b + k) : 0;
  }
  return f;
}

// The fetched lanes, quantised at max(q - qm[j], 0) (the LL lanes below
// nll as they are): golomb_encode.cuh's small_quotient where all four are
// below 2^30 in magnitude (every lane of real pictures), else its 64-bit
// quotient.
__device__ __forceinline__ void quantise4(int32_t (&v)[4], const Fetch& f,
                                          int b, int nll, int q,
                                          const int32_t* factors,
                                          const unsigned long long* recips) {
  uint32_t most = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) most = max(most, vc2::magnitude(f.v[k]));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int qk = min(max(q - f.m[k], 0), 119);
    int32_t x;
    if (most < (1u << 30)) {
      const int32_t fk = factors[qk];
      const uint32_t r = vc2::small_quotient(vc2::magnitude(f.v[k]),
                                             recips[qk]);
      x = static_cast<int32_t>(((f.v[k] < 0) != (fk < 0)) ? 0u - r : r);
    } else {
      x = quantise(f.v[k], qk, factors, recips);
    }
    v[k] = b + k < nll ? f.ll[k] : x;
  }
}

// Lanes b..b+cnt-1 (cnt <= 4) of component c of slice s, quantised.
__device__ __forceinline__ void lanes4(int32_t (&v)[4], const PackArgs& a,
                                       int c, long long s, int b, int cnt,
                                       int q, const int32_t* factors,
                                       const unsigned long long* recips) {
  quantise4(v, fetch4(a, c, s, b, cnt), b, a.nll[c], q, factors, recips);
}

// Store the cnt (<= 4) quantised lanes v at p, with one 16-byte store
// where aligned.
__device__ __forceinline__ void store4(int32_t* p, const int32_t (&v)[4],
                                       int cnt) {
  if (cnt == 4 && aligned16(p)) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < cnt; ++k) p[k] = v[k];
  }
}

// Where a thread's codes land: words of the window, those it fills alone
// stored, its first and last word (which other writers' bits may share)
// ORed in. Bits at or past the slice's end (bit `end` of the window) and
// words outside the window are dropped.
struct WindowSink {
  uint32_t* win;
  long long end;
  __device__ void word(long long w, uint32_t x, bool shared) const {
    if (w < 0 || w >= WINDOW_WORDS) return;
    const long long inside = end - 32 * w;
    if (inside <= 0) return;
    if (inside < 32) {
      x &= ~0u << (32 - inside);
      shared = true;
    }
    if (!x) return;                       // the window holds zeros
    if (shared) atomicOr(&win[w], x);
    else win[w] = x;
  }
};
using BitWriter = vc2::BitAccumulator<WindowSink>;

__device__ __forceinline__ uint32_t byteswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// A chunk's codes as one bit string while they fit 64 bits: the code of
// nb bits appended to str (its bits right-aligned).
__device__ __forceinline__ unsigned long long append(unsigned long long str,
                                                     unsigned long long code,
                                                     int nb) {
  return (nb < 64 ? str << nb : 0ull) | code;
}

// The codes of a held chunk of n lanes (whose non-zero ones are the bits
// of `nonzero`) as one bit string, where they fit 64 bits: a run of zero
// lanes (1-bit codes, each a 1) and the non-zero lane after it a step.
__device__ __forceinline__ unsigned long long chunk_string(
    const int32_t* held, int n, uint32_t nonzero) {
  unsigned long long str = 0;
  int j = 0;                                   // lanes appended so far
  for (uint32_t rest = nonzero; rest; rest &= rest - 1) {
    const int k = __ffs(rest) - 1;
    const int32_t v = held[k * THREADS];
    const int nb = code_bits(v);
    str = append(append(str, (1ull << (k - j)) - 1, k - j), code_of(v, nb),
                 nb);
    j = k + 1;
  }
  return append(str, (1ull << (n - j)) - 1, n - j);
}

// OR the first `keep` bits of the bits-bit string str (right-aligned) into
// the window at bit pos; the words outside the window are dropped. At most
// three shared atomics, and no branch but their predicates.
__device__ __forceinline__ void emit(uint32_t* win, unsigned long long str,
                                     int bits, long long pos,
                                     long long keep) {
  if (keep <= 0) return;
  const unsigned long long x =
      (str << (64 - bits)) & (~0ull << (64 - keep));  // 1 <= keep <= bits
  const long long w = pos >> 5;
  const int o = static_cast<int>(pos & 31);
  const uint32_t word[3] = {static_cast<uint32_t>(x >> (32 + o)),
                            static_cast<uint32_t>(x >> o),
                            o ? static_cast<uint32_t>(x << (32 - o)) : 0u};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (word[i] && w + i >= 0 && w + i < WINDOW_WORDS)
      atomicOr(&win[w + i], word[i]);
}

// Append the code of v, cut to the bits left below `bound` (off: the
// region's bits before it). Returns the code's full length.
__device__ __forceinline__ int put_code(BitWriter& w, int32_t v,
                                        long long off, long long bound) {
  if (v == 0) {
    w.put_one();
    return 1;
  }
  const int nb = code_bits(v);
  const int keep = static_cast<int>(min(static_cast<long long>(nb),
                                        bound - off));
  w.put(code_of(v, nb) >> (nb - keep), keep);
  return nb;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ld_pack(PackArgs a) {
  __shared__ uint32_t win[WINDOW_WORDS];
  __shared__ int32_t s_hold[HOLD * THREADS];  // lane k of thread i at k*T+i
  __shared__ int32_t s_factors[120];
  __shared__ unsigned long long s_recips[120];

  const int tid = threadIdx.x;
  const int g = a.group, lg = __ffs(g) - 1;
  const int tile = THREADS >> lg;
  const long long s0 = static_cast<long long>(blockIdx.x) * tile;
  const int tn = static_cast<int>(min(static_cast<long long>(tile),
                                      a.n - s0));
  const int sl = tid >> lg, t = tid & (g - 1);
  const bool live = sl < tn;
  const long long s = s0 + sl;
  // the slice's scalars and the CTA's byte range, loaded with the tables
  const int q = live ? a.q_idx[s] : 0;
  const int size = live ? a.sizes[s] : 0;
  const long long sa = live ? 4 + a.starts[s] : 0;
  const long long a0 = 4 + a.starts[s0];
  const long long a1 = 4 + a.starts[s0 + tn - 1] + a.sizes[s0 + tn - 1];
  for (int i = tid; i < 120; i += THREADS) {
    s_factors[i] = QUANT_FACTORS[i];
    s_recips[i] = QUANT_RECIPROCALS[i];
  }
  __syncthreads();
  const int ly = a.len[0], lc = a.len[1];
  // thread t: luma lanes [lo, hi), U and V lanes [clo, chi)
  const int lo = (t * ly) >> lg, hi = ((t + 1) * ly) >> lg;
  const int clo = (t * lc) >> lg, chi = ((t + 1) * lc) >> lg;
  const bool held = ((ly + g - 1) >> lg) + 2 * ((lc + g - 1) >> lg) <= HOLD;
  int32_t* const hold = s_hold + tid;
  int32_t* const hold_uv = hold + (hi - lo) * THREADS;

  // load, quantise, size: each region's bits and the bits up to the end
  // of its last non-zero code (0 where it has none); the held lanes' non-
  // zero ones as bit masks, in the order of the wire
  int ybits = 0, yend = 0, uvbits = 0, uvend = 0;
  uint32_t ynz = 0, uvnz = 0;
  if (live) {
    for (int b = lo; b < hi; b += 8) {      // eight lanes' loads in flight
      const int cnt = min(4, hi - b), cnt2 = min(4, hi - b - 4);
      const Fetch f0 = fetch4(a, 0, s, b, cnt);
      Fetch f1;
      if (cnt2 > 0) f1 = fetch4(a, 0, s, b + 4, cnt2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bh = b + 4 * h, ch = h ? cnt2 : cnt;
        if (ch <= 0) break;
        int32_t v[4];
        quantise4(v, h ? f1 : f0, bh, a.nll[0], q, s_factors, s_recips);
        if (a.keep[0]) store4(a.keep[0] + s * ly + bh, v, ch);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < ch) {
            ybits += code_bits(v[i]);
            if (v[i]) {
              yend = ybits;
              if (held) ynz |= 1u << (bh + i - lo);
            }
            if (held) hold[(bh + i - lo) * THREADS] = v[i];
          }
        }
      }
    }
    for (int b = clo; b < chi; b += 4) {
      const int cnt = min(4, chi - b);
      const Fetch fu = fetch4(a, 1, s, b, cnt), fv = fetch4(a, 2, s, b, cnt);
      int32_t u[4], v[4];
      quantise4(u, fu, b, a.nll[1], q, s_factors, s_recips);
      quantise4(v, fv, b, a.nll[2], q, s_factors, s_recips);
      if (a.keep[1]) store4(a.keep[1] + s * lc + b, u, cnt);
      if (a.keep[2]) store4(a.keep[2] + s * lc + b, v, cnt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < cnt) {
          const int k = 2 * (b + i - clo);
          uvbits += code_bits(u[i]);
          if (u[i]) {
            uvend = uvbits;
            if (held) uvnz |= 1u << k;
          }
          uvbits += code_bits(v[i]);
          if (v[i]) {
            uvend = uvbits;
            if (held) uvnz |= 2u << k;
          }
          if (held) {
            hold_uv[k * THREADS] = u[i];
            hold_uv[(k + 1) * THREADS] = v[i];
          }
        }
      }
    }
  }
  // the group: the bits before each chunk (an exclusive scan), and the
  // regions' bits up to their last non-zero code (a max)
  int yin = ybits, uvin = uvbits;
  for (int o = 1; o < g; o <<= 1) {
    const int y = __shfl_up_sync(FULL, yin, o, g);
    const int u = __shfl_up_sync(FULL, uvin, o, g);
    if (t >= o) {
      yin += y;
      uvin += u;
    }
  }
  const int ybefore = yin - ybits, uvbefore = uvin - uvbits;
  int yused = yend ? ybefore + yend : 0;
  int uvused = uvend ? uvbefore + uvend : 0;
  for (int o = g >> 1; o; o >>= 1) {
    yused = max(yused, __shfl_xor_sync(FULL, yused, o, g));
    uvused = max(uvused, __shfl_xor_sync(FULL, uvused, o, g));
  }
  const long long total = 8LL * size;
  const int len_bits = total - 8 > 0 ? 64 - __clzll(total - 8) : 0;
  const long long uv_bits = total - 7 - len_bits - yused;
  if (live && t == 0 && uvused > uv_bits)
    atomicOr(reinterpret_cast<unsigned*>(a.out), FLAG_LD_FIT);

  // write, one 16-byte aligned window of the CTA's byte range at a time
  for (long long wa = a0 & ~15LL; wa < a1; wa += WINDOW_BYTES) {
    const long long b0 = max(wa, a0), b1 = min(wa + WINDOW_BYTES, a1);
    const int k0 = static_cast<int>((b0 - wa) >> 4);
    const int k1 = static_cast<int>((b1 - wa + 15) >> 4);
    for (int i = 4 * k0 + tid; i < 4 * k1; i += THREADS) win[i] = 0;
    __syncthreads();
    const long long rel = 8 * (sa - wa);        // the slice's first bit
    if (live && rel < WINDOW_BITS && rel + total > 0) {
      const WindowSink sink{win, rel + total};
      const long long body = rel + 7 + len_bits;
      const long long end = rel + total;          // bits past it dropped
      if (t == 0) {                               // the header
        const int bits = 7 + len_bits;
        emit(win, (static_cast<unsigned long long>(q & 0x7F) << len_bits) |
                      (static_cast<unsigned long long>(yused) &
                       ((1ull << len_bits) - 1)),
             bits, rel, min(static_cast<long long>(bits), end - rel));
      }
      long long off = ybefore;                    // luma, up to y_used
      if (held && ybits <= 64) {
        emit(win, chunk_string(hold, hi - lo, ynz), ybits, body + off,
             min(min(static_cast<long long>(ybits), yused - off),
                 end - body - off));
      } else if (off < yused && body + off < WINDOW_BITS) {
        BitWriter w;
        w.start(sink, body + off);
        for (int j = lo; j < hi && off < yused && w.word < WINDOW_WORDS;
             ++j) {
          int32_t x[4];
          if (held) x[0] = hold[(j - lo) * THREADS];
          else lanes4(x, a, 0, s, j, 1, q, s_factors, s_recips);
          off += put_code(w, x[0], off, yused);
        }
        w.finish();
      }
      off = uvbefore;                             // U/V, cut at uv_bits
      const long long uv = body + yused;
      if (held && uvbits <= 64) {
        emit(win, chunk_string(hold_uv, 2 * (chi - clo), uvnz), uvbits,
             uv + off,
             min(min(static_cast<long long>(uvbits), uv_bits - off),
                 end - uv - off));
      } else if (off < uv_bits && uv + off < WINDOW_BITS) {
        BitWriter w;
        w.start(sink, uv + off);
        for (int j = clo; j < chi && off < uv_bits && w.word < WINDOW_WORDS;
             ++j) {
#pragma unroll
          for (int c = 1; c < 3; ++c) {
            if (off < uv_bits) {
              int32_t x[4];
              if (held) x[0] = hold_uv[(2 * (j - clo) + c - 1) * THREADS];
              else lanes4(x, a, c, s, j, 1, q, s_factors, s_recips);
              off += put_code(w, x[0], off, uv_bits);
            }
          }
        }
        w.finish();
      }
    }
    __syncthreads();
    for (int c = k0 + tid; c < k1; c += THREADS) {
      const long long c0 = wa + 16LL * c;
      if (c0 >= b0 && c0 + 16 <= b1) {
        *reinterpret_cast<uint4*>(a.out + c0) = make_uint4(
            byteswap(win[4 * c]), byteswap(win[4 * c + 1]),
            byteswap(win[4 * c + 2]), byteswap(win[4 * c + 3]));
      } else {                        // an end chunk, shared with a CTA
        for (int i = 0; i < 16; ++i) {
          const long long b = c0 + i;
          if (b >= b0 && b < b1)
            a.out[b] = static_cast<uint8_t>(
                win[4 * c + (i >> 2)] >> (24 - 8 * (i & 3)));
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// out = [flags uint32 | payload] (16-byte aligned; the flags word zeroed by
// the caller) from the lanes y [n, ly], u and v [n, lc] (int32, contiguous
// rows), `group` threads a slice (4, 8, 16 or 32), the qIndex q_idx [n],
// the slice bytes sizes [n] and their first bytes starts [n] (int64). The
// lanes are transform coefficients whose first nll_y / nll_c lanes are
// replaced by ll_y [n, nll_y], ll_u / ll_v [n, nll_c], the others
// quantised by qm_y / qm_c (int32 [ly], [lc]); keep_* (or null) receive
// the quantised lanes. Returns the launch's CUDA error code.
extern "C" int ld_pack_launch(const void* y, const void* u, const void* v,
                              int ly, int lc, const void* ll_y,
                              const void* ll_u, const void* ll_v, int nll_y,
                              int nll_c, const void* qm_y, const void* qm_c,
                              void* keep_y, void* keep_u, void* keep_v,
                              const void* q_idx, const void* sizes,
                              const void* starts, int n, int group,
                              void* out, void* stream) {
  if (n <= 0) return 0;
  if (!qm_y || !qm_c || (nll_y && !ll_y) || (nll_c && (!ll_u || !ll_v)) ||
      nll_y < 0 || nll_y > ly || nll_c < 0 || nll_c > lc ||
      group < MIN_GROUP || group > 32 ||
      (group & (group - 1)) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a;
  a.lanes[0] = static_cast<const int32_t*>(y);
  a.lanes[1] = static_cast<const int32_t*>(u);
  a.lanes[2] = static_cast<const int32_t*>(v);
  a.ll[0] = static_cast<const int32_t*>(ll_y);
  a.ll[1] = static_cast<const int32_t*>(ll_u);
  a.ll[2] = static_cast<const int32_t*>(ll_v);
  a.qm[0] = static_cast<const int32_t*>(qm_y);
  a.qm[1] = a.qm[2] = static_cast<const int32_t*>(qm_c);
  a.keep[0] = static_cast<int32_t*>(keep_y);
  a.keep[1] = static_cast<int32_t*>(keep_u);
  a.keep[2] = static_cast<int32_t*>(keep_v);
  a.len[0] = ly;
  a.len[1] = a.len[2] = lc;
  a.nll[0] = nll_y;
  a.nll[1] = a.nll[2] = nll_c;
  a.q_idx = static_cast<const int32_t*>(q_idx);
  a.sizes = static_cast<const int32_t*>(sizes);
  a.starts = static_cast<const long long*>(starts);
  a.out = static_cast<uint8_t*>(out);
  a.n = n;
  a.group = group;
  const int tile = THREADS / group;
  ld_pack<<<(n + tile - 1) / tile, THREADS, 0,
            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
