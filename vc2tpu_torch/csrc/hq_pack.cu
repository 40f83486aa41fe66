// HQ slice payload assembly on the card, with the quantiser fused into its
// load: the port of the JAX package's XLA function
// vc2tpu/vlc/device_pack.py:133::pack_hq_core (reference
// src/Library/src/Slices.cpp:305-467 over VLC.cpp:21-94), applied to the
// output of its encoder's quant_banded (vc2tpu/quant/quantiser.py:261).
//
// Each slice of the payload is, in order: `prefix` zero bytes, the qIndex
// byte, then for each component a length byte (its bytes / scalar) and its
// interleaved signed exp-Golomb codes, cut at the component's byte bound
// by the bounded-write rule (a trailing run of zero coefficients is 1-bit
// codes that may fall past the bound) and zero-filled to the bound. HQ CBR
// gives the third component the rest of the slice's byte budget.
//
// One launch. A CTA of 256 threads takes a tile of consecutive slices, its
// tile number drawn from a ticket (atomicAdd), so a tile only waits on
// tiles whose CTAs already run. A group of g threads (4 to 32, a power of
// two) serves a slice: each thread takes one contiguous chunk of each
// component's lanes, chunk (t + c) mod g of component c, so the dense low
// bands at the head of the three components go to three threads.
//   load     each thread reads its chunks with 16-byte loads. With the
//            quant matrix tables given, the lanes are transform
//            coefficients and each is quantised as it is loaded, at
//            max(qIndex - qm[lane], 0): exact division by a 64-bit
//            reciprocal of each factor (hq_pack_params.h; a 64-bit divide
//            where |v| << 2 needs 34 bits), the wrapped factors at q
//            116-119 flipping the sign. The quantised lanes are stored
//            when asked for, and kept in shared memory (thread-major, no
//            bank conflicts) with a bit mask of the non-zero ones;
//   size     each thread sums its chunks' code lengths; a group scan and
//            a group max (shuffles) give the bits before each chunk, each
//            component's bytes, the slice total and the error flags;
//   place    a warp scan of the totals places each slice in the tile, and
//            a decoupled look-back over the earlier tiles' published
//            aggregates and inclusive prefixes places the tile in the
//            payload (no host scan, no second launch);
//   write    the tile's byte range is assembled in a shared-memory window
//            aligned to 16 bytes: each thread appends its chunks' codes to
//            a 64-bit accumulator, a run of zeros (1-bit codes) and the
//            non-zero lane after it at a time, and stores the words it
//            fills alone; only a chunk's first and last word, and the
//            byte-aligned header bytes, are ORed in (shared atomics). The
//            CTA stores the window with 16-byte stores; only the edge
//            chunks, which the neighbouring tiles share, go byte by byte.
//            A range larger than the window (large slices, CBR at high
//            rates) is assembled one window after another.
// Every int32 codes in at most 64 bits (|v| + 1 <= 2^31 + 1), so there is
// no overflow case and no host fallback. The quotient, the code lengths,
// the codes and the 64-bit accumulator are golomb_encode.cuh's, which
// csrc/ld_pack.cu and csrc/ld_rate.cu include too. Chunks too long to keep
// in shared memory (slices of over ~1000 lanes) are read and quantised
// again to be written. Every store is bounded by the payload capacity the
// caller gives, so a call whose flags are set (its payload is thrown
// away) writes nothing past the buffer; a tile that set a flag writes
// none.
//
// What bounds it on the card: the lanes read once and the payload written
// once, ~17 MB at 1080p, ~5 us of memory time; the arithmetic (quantise,
// code lengths, code bits) is some 50 integer operations a lane, ~3 us at
// the card's integer rate. The design keeps every intermediate (the
// quantised lanes, sizes, offsets) on the chip and synchronises with the
// host once. At 1080p it takes ~30 us (chip_smoke.py, PERF.md), most of
// it in the sizing (load, quantise, code lengths): the per-lane integer
// work, done by one wave of 4 CTAs an SM, is what remains to cut.

#include <cstdint>
#include <cuda_runtime.h>

#include "golomb_encode.cuh"
#include "hq_pack_params.h"

namespace {

using vc2::code_bits;
using vc2::code_of;
using vc2::quantise;

constexpr int FLAG_SCALAR = 2;     // a component's length byte exceeds 255
constexpr int FLAG_CBR_FIT = 4;    // CBR: y + u leave v too few bytes
constexpr int FLAG_QINDEX = 8;     // a qIndex exceeds 8 bits
constexpr int FLAG_VLEN = 32;      // CBR: v's forced length byte exceeds 255

constexpr int THREADS = VC2_PACK_THREADS;
constexpr int MIN_GROUP = 4;                      // threads a slice
constexpr int MAX_TILE = THREADS / MIN_GROUP;     // slices a CTA
constexpr int HOLD = VC2_PACK_HOLD;  // quantised lanes a thread keeps
constexpr int WINDOW_WORDS = 1024;                // the CTA's output window
constexpr int WINDOW_BYTES = 4 * WINDOW_WORDS;
constexpr long long WINDOW_BITS = 8LL * WINDOW_BYTES;
constexpr unsigned FULL = 0xffffffffu;
// a tile's status word: 0 until published, then a state and a byte count
constexpr unsigned long long HAS_AGGREGATE = 1ull << 62;
constexpr unsigned long long HAS_PREFIX = 2ull << 62;
constexpr unsigned long long VALUE_MASK = (1ull << 62) - 1;

__constant__ int32_t QUANT_FACTORS[120] = {VC2_QUANT_FACTORS};
__constant__ unsigned long long QUANT_RECIPROCALS[120] = {
    VC2_QUANT_RECIPROCALS};

struct PackArgs {
  const int32_t* lanes[3];   // [n, len[c]], transform lanes when qm is set
  int32_t* keep[3];          // quantised lanes out, or null
  const int32_t* qm[3];      // quant matrix entry of each lane, or null
  int len[3];
  const int32_t* q_idx;      // [n]
  const int32_t* sizes;      // CBR byte budgets [n], or null for ConstQ
  uint8_t* out;              // [totals int32 [n] | payload of cap bytes]
  unsigned long long* scratch;  // [ticket, flags, total, status[tiles]]
  long long cap;
  int n, group, prefix, scalar;
};

__device__ __forceinline__ long long warp_sum64(long long x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// OR the byte x into the window at bit `pos` (a multiple of 8) from the
// window's start, unless it falls outside. Word w of the window holds
// bytes 4w..4w+3 big-endian.
__device__ __forceinline__ void put_byte(uint32_t* win, long long pos,
                                         uint32_t x) {
  if (pos >= 0 && pos < WINDOW_BITS)
    atomicOr(&win[pos >> 5], x << (24 - (pos & 31)));
}

// Where a thread's codes land: words of the window, those it fills alone
// stored, its first and last word (which other threads' bits may share)
// ORed in; words outside the window are dropped.
struct WindowSink {
  uint32_t* win;
  __device__ void word(long long w, uint32_t x, bool shared) const {
    if (x && w >= 0 && w < WINDOW_WORDS) {
      if (shared) atomicOr(&win[w], x);
      else win[w] = x;
    }
  }
};
using BitWriter = vc2::BitAccumulator<WindowSink>;

// Four lanes from p (those past cnt read 0): one 16-byte load where p is
// aligned and all four are wanted.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p,
                                      int cnt) {
  if (cnt >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const int4*>(p));
  return make_int4(__ldg(p), cnt > 1 ? __ldg(p + 1) : 0,
                   cnt > 2 ? __ldg(p + 2) : 0, cnt > 3 ? __ldg(p + 3) : 0);
}

// Lanes b..b+3 of a slice's component row (those past cnt read 0),
// quantised at the slice's qIndex q when the component has a quant matrix
// table.
__device__ __forceinline__ void lanes4(int32_t (&v)[4], const PackArgs& a,
                                       int c, long long row, int b, int cnt,
                                       int q, const int32_t* factors,
                                       const unsigned long long* recips) {
  const int4 x = load4(a.lanes[c] + row + b, cnt);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
  if (a.qm[c]) {
    const int4 m = load4(a.qm[c] + b, cnt);
    const int32_t qm[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = quantise(v[k], min(max(q - qm[k], 0), 119), factors, recips);
  }
}

// The look-back of warp 0: publish the tile's aggregate, add up the
// predecessors' (each lane one tile, 32 a step) until one has published
// its inclusive prefix, publish this tile's inclusive prefix. Returns the
// tile's exclusive prefix (its first payload byte) on every lane.
__device__ long long look_back(unsigned long long* status, int tile,
                               long long agg, int lane) {
  volatile unsigned long long* st = status;
  // a negative aggregate comes only with a flag set; masked, it cannot
  // pose as a state
  const unsigned long long own = static_cast<unsigned long long>(agg) &
                                 VALUE_MASK;
  if (tile == 0) {
    if (lane == 0) atomicExch(&status[0], HAS_PREFIX | own);
    return 0;
  }
  if (lane == 0) atomicExch(&status[tile], HAS_AGGREGATE | own);
  long long excl = 0;
  for (int last = tile - 1;; last -= 32) {
    const int pred = last - lane;
    unsigned long long s = HAS_PREFIX;        // before tile 0: prefix 0
    if (pred >= 0) {
      do {
        s = st[pred];
      } while (s == 0);
    }
    const unsigned prefix = __ballot_sync(FULL, (s >> 62) == 2);
    long long v = static_cast<long long>(s & VALUE_MASK);
    if (prefix) {
      const int first = __ffs(prefix) - 1;    // the nearest such tile
      excl += warp_sum64(lane <= first ? v : 0);
      break;
    }
    excl += warp_sum64(v);
  }
  if (lane == 0)
    atomicExch(&status[tile], HAS_PREFIX | (static_cast<unsigned long long>(
                                               excl + agg) & VALUE_MASK));
  return excl;
}

__device__ __forceinline__ uint32_t byteswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__global__ void __launch_bounds__(THREADS, 4) hq_pack(PackArgs a) {
  __shared__ uint32_t win[WINDOW_WORDS];
  __shared__ int32_t s_hold[HOLD * THREADS];  // lane k of thread i at k*T+i
  __shared__ int s_before[3][THREADS];         // code bits before a chunk
  __shared__ uint32_t s_nonzero[3][THREADS];   // a held chunk's non-zeros
  __shared__ int32_t s_factors[120];
  __shared__ unsigned long long s_recips[120];
  __shared__ long long s_start[MAX_TILE];   // byte offset within the tile
  __shared__ int s_total[MAX_TILE];
  __shared__ int s_bytes[MAX_TILE][3];
  __shared__ int s_tile, s_flags;
  __shared__ long long s_base, s_agg;

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = a.group, lg = __ffs(g) - 1;
  const int tile_slices = THREADS >> lg;
  if (tid == 0) {
    s_tile = static_cast<int>(atomicAdd(a.scratch, 1ull));
    s_flags = 0;
  }
  for (int i = tid; i < 120; i += THREADS) {
    s_factors[i] = QUANT_FACTORS[i];
    s_recips[i] = QUANT_RECIPROCALS[i];
  }
  __syncthreads();
  const int tile = s_tile;
  const int s0 = tile * tile_slices;
  const int tn = min(tile_slices, a.n - s0);
  const int sl = tid >> lg, t = tid & (g - 1);
  const bool live = sl < tn;
  const int s = s0 + sl;
  const int q = live ? a.q_idx[s] : 0;

  // load, quantise and size: thread t of the group takes lanes [lo, hi)
  // of each component, four at a time, and keeps them in shared memory
  // when they fit (`held`; else the write reads them again)
  const bool held = ((a.len[0] + g - 1) >> lg) +
                        2 * ((a.len[1] + g - 1) >> lg) <= HOLD;
  int scaled[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int len = a.len[c];
    const long long row = static_cast<long long>(s) * len;
    const int chunk = (t + c) & (g - 1);
    const int lo = (chunk * len) >> lg, hi = ((chunk + 1) * len) >> lg;
    const int hold_at = c == 0 ? 0 : ((a.len[0] + g - 1) >> lg) +
                                     (c - 1) * ((a.len[1] + g - 1) >> lg);
    int bits = 0, last = -1;
    uint32_t nonzero = 0;
    // one lane: code bits, last non-zero, kept and held copies
    auto take = [&](int32_t v, int j) {
      bits += code_bits(v);
      if (v) last = j;
      if (a.keep[c]) a.keep[c][row + j] = v;
      if (held) {
        s_hold[(hold_at + j - lo) * THREADS + tid] = v;
        if (v) nonzero |= 1u << (j - lo);
      }
    };
    const int32_t* src = a.lanes[c] + row;
    const int32_t* qm = a.qm[c];
    const bool vec =
        ((reinterpret_cast<uintptr_t>(src + lo) | (hi - lo) * 4 |
          (qm ? reinterpret_cast<uintptr_t>(qm + lo) : 0)) & 15) == 0;
    if (live && vec) {                 // 16-byte loads, four lanes a step
#pragma unroll 4
      for (int b = lo; b < hi; b += 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(src + b));
        int32_t v[4] = {x.x, x.y, x.z, x.w};
        if (qm) {
          const int4 m = __ldg(reinterpret_cast<const int4*>(qm + b));
          const int32_t mq[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = quantise(v[i], min(max(q - mq[i], 0), 119), s_factors,
                            s_recips);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) take(v[i], b + i);
      }
    } else if (live) {
      for (int j = lo; j < hi; ++j) {
        int32_t v = __ldg(src + j);
        if (qm)
          v = quantise(v, min(max(q - __ldg(qm + j), 0), 119), s_factors,
                       s_recips);
        take(v, j);
      }
    }
    // the group: bits before each chunk (a scan in chunk order; chunk j
    // is thread (j - c) mod g's), the component's bits, its last non-zero
    int incl = bits;
    for (int o = 1; o < g; o <<= 1) {
      const int y = __shfl_sync(FULL, incl, (chunk - o - c) & (g - 1), g);
      if (chunk >= o) incl += y;
    }
    s_before[c][tid] = incl - bits;
    s_nonzero[c][tid] = nonzero;
    const int total_bits = __shfl_sync(FULL, incl, (g - 1 - c) & (g - 1), g);
    for (int o = g >> 1; o; o >>= 1)
      last = max(last, __shfl_xor_sync(FULL, last, o, g));
    // the trailing zeros after the last non-zero are 1-bit codes
    const int used = total_bits - (len - 1 - last);
    scaled[c] = ((used + 7) / 8 + a.scalar - 1) / a.scalar;
  }
  if (live && t == 0) {
    int f = 0;
    if (scaled[0] > 255 || scaled[1] > 255) f |= FLAG_SCALAR;
    const int yb = scaled[0] * a.scalar, ub = scaled[1] * a.scalar;
    int vb;
    if (a.sizes) {
      vb = a.sizes[s] - 4 - yb - ub;
      if (vb < scaled[2] * a.scalar) f |= FLAG_CBR_FIT;
      if (vb / a.scalar > 255) f |= FLAG_VLEN;
    } else {
      vb = scaled[2] * a.scalar;
      if (scaled[2] > 255) f |= FLAG_SCALAR;
    }
    if (q > 255) f |= FLAG_QINDEX;
    const int total = a.prefix + 4 + yb + ub + vb;
    s_bytes[sl][0] = yb;
    s_bytes[sl][1] = ub;
    s_bytes[sl][2] = vb;
    s_total[sl] = total;
    reinterpret_cast<int32_t*>(a.out)[s] = total;
    if (f) atomicOr(&s_flags, f);
  }
  __syncthreads();

  // place: the slices in the tile, the tile in the payload
  if (tid < 32) {
    constexpr int PER = MAX_TILE / 32;
    long long part[PER], sum = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane * PER + k;
      part[k] = sum;
      sum += i < tn ? s_total[i] : 0;
    }
    long long incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane * PER + k;
      if (i < tn) s_start[i] = incl - sum + part[k];
    }
    const long long agg = __shfl_sync(FULL, incl, 31);
    const long long base = look_back(a.scratch + 3, tile, agg, lane);
    if (lane == 0) {
      s_base = base;
      s_agg = agg;
      if (s_flags)
        atomicOr(a.scratch + 1, static_cast<unsigned long long>(s_flags));
      if (tile == static_cast<int>(gridDim.x) - 1)
        a.scratch[2] = static_cast<unsigned long long>(base + agg);
    }
  }
  __syncthreads();

  // write, one 16-byte-aligned window of the tile's byte range at a time;
  // bytes are stored only inside [lo_b, hi_b), the payload's capacity. A
  // tile that set a flag writes none: the call's payload is thrown away.
  if (s_flags) return;
  const long long lo_b = 4LL * a.n, hi_b = lo_b + a.cap;
  const long long a0 = lo_b + s_base, a1 = min(a0 + s_agg, hi_b);
  for (long long wa = max(a0, lo_b) & ~15LL; wa < a1; wa += WINDOW_BYTES) {
    // the window's chunks of 16 bytes that this tile stores
    const long long b0 = max(wa, max(a0, lo_b));
    const long long b1 = min(wa + WINDOW_BYTES, a1);
    const int k0 = static_cast<int>((b0 - wa) >> 4);
    const int k1 = static_cast<int>((b1 - wa + 15) >> 4);
    for (int i = 4 * k0 + tid; i < 4 * k1; i += THREADS) win[i] = 0;
    __syncthreads();
    const long long sa = live ? a0 + s_start[sl] : 0;
    if (live && sa + s_total[sl] > wa && sa < wa + WINDOW_BYTES) {
      const int yb = s_bytes[sl][0], ub = s_bytes[sl][1];
      const int vb = s_bytes[sl][2];
      const long long rel = 8 * (sa - wa);    // the slice's first bit
      if (t < 4) {           // thread t: qIndex (0) or a length byte
        const int at = t == 0 ? a.prefix : t == 1 ? a.prefix + 1
                     : t == 2 ? a.prefix + 2 + yb : a.prefix + 3 + yb + ub;
        const int x = t == 0 ? q : (t == 1 ? yb : t == 2 ? ub : vb) / a.scalar;
        put_byte(win, rel + 8LL * at, x & 0xFF);
      }
      const int data_at[3] = {a.prefix + 2, a.prefix + 3 + yb,
                              a.prefix + 4 + yb + ub};
      const int bound[3] = {8 * yb, 8 * ub, 8 * vb};
#pragma unroll 1
      for (int c = 0; c < 3; ++c) {
        const long long at = rel + 8LL * data_at[c];
        int off = s_before[c][tid];          // bits of the codes before
        if (off >= bound[c] || at + off >= WINDOW_BITS || at + bound[c] <= 0)
          continue;
        const int len = a.len[c];
        const long long row = static_cast<long long>(s) * len;
        const int chunk = (t + c) & (g - 1);
        const int lo = (chunk * len) >> lg, hi = ((chunk + 1) * len) >> lg;
        const int hold_at = c == 0 ? 0 : ((a.len[0] + g - 1) >> lg) +
                                         (c - 1) * ((a.len[1] + g - 1) >> lg);
        BitWriter w;
        w.start(WindowSink{win}, at + off);
        // held lanes: a run of zeros (1-bit codes, each a 1) is one put,
        // each non-zero lane one more
        const int n = hi - lo;
        const uint32_t nonzero = s_nonzero[c][tid];
        for (int j = 0; held && j < n && off < bound[c] && w.word < WINDOW_WORDS;) {
          const uint32_t rest = nonzero >> j;         // j < n <= HOLD
          const int z = rest ? __ffs(rest) - 1 : n - j;
          if (!rest || off + z >= bound[c]) {   // zeros to the end or bound
            const int ones = min(z, bound[c] - off);
            w.put32(0xFFFFFFFFu >> (32 - ones), ones);
            break;
          }
          // z zeros (z < 32), then a non-zero lane, in one put if it fits
          const int32_t v = s_hold[(hold_at + j + z) * THREADS + tid];
          const int nb = code_bits(v);
          const int keep = min(nb, bound[c] - off - z);
          const unsigned long long code = code_of(v, nb) >> (nb - keep);
          if (z + keep <= 64) {
            w.put((((1ull << z) - 1) << keep) | code, z + keep);
          } else {
            w.put32(0xFFFFFFFFu >> (32 - z), z);
            w.put(code, keep);
          }
          off += z + nb;
          j += z + 1;
        }
        for (int b = lo; !held && b < hi && off < bound[c] &&
                            w.word < WINDOW_WORDS; b += 4) {
          int32_t v[4];
          lanes4(v, a, c, row, b, hi - b, q, s_factors, s_recips);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (b + k < hi && off < bound[c]) {
              if (v[k] == 0) {
                w.put_one();
                ++off;
              } else {
                const int nb = code_bits(v[k]);
                const int keep = min(nb, bound[c] - off);
                w.put(code_of(v[k], nb) >> (nb - keep), keep);
                off += nb;
              }
            }
          }
        }
        w.finish();
      }
    }
    __syncthreads();
    for (int k = k0 + tid; k < k1; k += THREADS) {
      const long long c0 = wa + 16LL * k;
      if (c0 >= b0 && c0 + 16 <= b1) {
        *reinterpret_cast<uint4*>(a.out + c0) = make_uint4(
            byteswap(win[4 * k]), byteswap(win[4 * k + 1]),
            byteswap(win[4 * k + 2]), byteswap(win[4 * k + 3]));
      } else {                          // an edge chunk, shared with a tile
        for (int i = 0; i < 16; ++i) {
          const long long b = c0 + i;
          if (b >= b0 && b < b1)
            a.out[b] = static_cast<uint8_t>(
                win[4 * k + (i >> 2)] >> (24 - 8 * (i & 3)));
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// out = [totals int32 [n] | payload of `cap` bytes] (16-byte aligned) from
// the lanes y [n, ly], u and v [n, lc] (int32, contiguous rows), `group`
// threads a slice (4, 8, 16 or 32) and 256 / group slices a CTA. With
// qm_y / qm_c (int32 [ly], [lc]) the lanes are transform coefficients,
// quantised in the kernel, and keep_* (or null) receive the quantised
// lanes. `sizes` is the CBR byte budget of each slice, or null for
// ConstQ. `scratch` (int64 [3 + tiles], zeroed) receives the flags at [1]
// and the payload size at [2]. Returns the launch's CUDA error code.
extern "C" int hq_pack_launch(const void* y, const void* u, const void* v,
                              int ly, int lc, const void* qm_y,
                              const void* qm_c, void* keep_y, void* keep_u,
                              void* keep_v, const void* q_idx,
                              const void* sizes, int n, int group,
                              int prefix, int scalar, void* out,
                              long long cap, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (group < MIN_GROUP || group > 32 || (group & (group - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a;
  a.lanes[0] = static_cast<const int32_t*>(y);
  a.lanes[1] = static_cast<const int32_t*>(u);
  a.lanes[2] = static_cast<const int32_t*>(v);
  a.keep[0] = static_cast<int32_t*>(keep_y);
  a.keep[1] = static_cast<int32_t*>(keep_u);
  a.keep[2] = static_cast<int32_t*>(keep_v);
  a.qm[0] = static_cast<const int32_t*>(qm_y);
  a.qm[1] = a.qm[2] = static_cast<const int32_t*>(qm_c);
  a.len[0] = ly;
  a.len[1] = a.len[2] = lc;
  a.q_idx = static_cast<const int32_t*>(q_idx);
  a.sizes = static_cast<const int32_t*>(sizes);
  a.out = static_cast<uint8_t*>(out);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.cap = cap;
  a.n = n;
  a.group = group;
  a.prefix = prefix;
  a.scalar = scalar;
  const int tile = THREADS / group;
  hq_pack<<<(n + tile - 1) / tile, THREADS, 0,
            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
