// LD rate control on the card: the port of the JAX package's XLA function
// vc2tpu/rdo/ld.py:233::ld_rate_control, which gives what the host scan
// vc2tpu/_native/vc2host.cpp:790-858 (ld_encode) gives (reference
// src/EncodeStream/EncodeStream.cpp:195-245 over Quantisation.cpp:191-234).
//
// For each slice, the quantisation index and its LL lanes:
//   bisection  trial 63, best 127; probes with delta 32, 16, 8, 4, 2, 1, 0:
//              after each, best = trial where the slice's bits at trial are
//              at most its budget `avail` and trial < best, then trial -=
//              delta where it fits, else += delta;
//   a probe    every lane quantised at clamp(trial - qm[lane], 0, 119); the
//              LL lanes (the first nll of a slice, raster in its LL block)
//              against a DC prediction: the truncating mean (r + 1) / 3 (r -
//              1 below 0) of the left, above and above-left reconstructions
//              (predict_dc, vc2host.cpp:476, with its reduced branches at
//              the picture's top and left edges), the reconstruction being
//              scale(code) + prediction, wrapped to int32; the bits: each
//              component's code bits up to its last non-zero code in lane
//              order, chroma interleaved u0 v0 u1 v1;
//   final      the requantise at best writes the LL lanes and leaves the
//              reconstructions the later slices read.
//
// Design. The body lanes (every lane after the LL block) are sized at every
// trial 0-126 off the dependent chain, since nothing of theirs depends on a
// neighbour: for slice s, trial t and component c (luma; chroma u and v
// interleaved) a body table entry is the body's code bits up to its last
// non-zero code, or 0 where every body code is 0. Up to index 115 a lane's
// magnitude does not rise with the index, so once every lane a warp sizes
// has been 0 it skips to the first trial a wrapped factor (116-119) could
// make non-zero, or stops; a warp sums the code bits and takes the last
// non-zero position with one redux each a trial.
//
// The wavefront: a slice waits only on the final reconstructions of its
// left, above and above-left neighbours. A CTA takes a row of slices from a
// ticket (atomicAdd) and walks it left to right, so a row only ever waits
// on a row whose CTA already runs: no co-residency or cooperative launch is
// needed. A border value is published as one 64-bit word, the value and a
// ready tag, so a slice waits on the words it reads and on nothing else
// (one L2 round trip, where a progress flag and then the values took two).
//
// ld_rate_fixed, compiled for the LL blocks of the measured 4:2:2 shapes,
// runs a thread a trial (128 consumer threads, trials 0-127): every thread
// runs the three LL recurrences at its own trial in registers, adds its
// body table entries, and the 127 fits bits are gathered with a ballot a
// warp. Every thread replays the bisection's walk on that mask; the thread
// of the trial the walk picks writes the LL codes, q and the bottom rows,
// and hands its right columns to the next slice. The CTA's PRODUCERS
// further warps size the row's body lanes into a ring of table rows in
// shared memory, a slice a warp, ahead of the consumers, so the picture
// takes one launch. The critical path is R + C - 1 dependent slice steps
// (374 at 1080p), each one LL pass deep.
//
// ld_rate serves the other shapes (4:4:4, 4:2:0, larger LL blocks or
// bodies): ld_body_table first writes the whole table to device memory (a
// warp 32 lanes of a slice), then a warp a row runs the LL blocks in shared
// memory on lanes 0-2 and the 7 probes one after another.
//
// What bounds it on the card: not the bytes (16.6 MB of lanes at 1080p,
// 5 us) nor the operations (~7 us), but the dependent chain. Its least
// time is 374 steps of a 3-cell LL pass, each cell ~34 dependent integer
// instructions (the mean, the 64-bit quotient and its correction, the
// rescale): ~0.08 ms at 4 cycles an instruction. On the H100 a 1080p step
// takes ~1.64 us with the wait for the borders through L2, and the
// picture ~0.82 ms: along a row the consumers also wait on their producer
// warps, which size a slice every ~2.1 us, and every row follows the
// first (chip_smoke.py's kernel line and dependent step, PERF.md).
//
// The LL quotient is golomb_encode.cuh's, exact for every int32 and without
// a branch; the body sizing takes its small_quotient where every lane of a
// warp is below 2^30. Scale wraps at every step as the port's quantiser
// does.

#include <cstdint>
#include <cuda_runtime.h>

#include "golomb_encode.cuh"
#include "ld_rate_params.h"

namespace {

using vc2::magnitude;
using vc2::quotient;

constexpr int STAGE_BYTES = VC2_LD_STAGE_BYTES;
constexpr int TRIALS = VC2_LD_TRIALS;     // trials 0-126 and 127 (no fit)
constexpr int MONOTONE_MAX = VC2_MONOTONE_MAX;
constexpr unsigned long long WRAP_MIN = VC2_WRAP_MIN;
constexpr int TABLE_WARPS = 8;            // warps a CTA of the body table
constexpr int TABLE_SLICES = 8;           // slices a CTA of the body table
constexpr int PRODUCERS = 4;              // body warps of a fixed row CTA
constexpr int RING = 32;                  // body table slots of a row CTA
constexpr int FIXED_THREADS = TRIALS + 32 * PRODUCERS;
constexpr int FIXED_BODY_Y = 64;          // body lanes the fixed kernel takes
constexpr int FIXED_BODY_C = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long READY = 1ull << 32;   // a border word's tag

__constant__ int32_t QUANT_FACTORS[120] = {VC2_QUANT_FACTORS};
__constant__ int32_t QUANT_OFFSETS[120] = {VC2_QUANT_OFFSETS};
__constant__ unsigned long long QUANT_RECIPROCALS[120] = {
    VC2_QUANT_RECIPROCALS};

struct Tables {
  int32_t factors[120];
  int32_t offsets[120];
  unsigned long long recips[120];

  __device__ __forceinline__ void load(int from, int step) {
    for (int i = from; i < 120; i += step) {
      factors[i] = QUANT_FACTORS[i];
      offsets[i] = QUANT_OFFSETS[i];
      recips[i] = QUANT_RECIPROCALS[i];
    }
  }
};

struct TableArgs {
  const int32_t* lanes[3];   // [n, len[c]] transform lanes
  const int32_t* qm[2];      // quant matrix entry of each lane: luma, chroma
  int len[2], nll[2];        // lanes, and LL lanes, of a luma / chroma slice
  int32_t* table;            // [n, 2, TRIALS]
  int n;
};

struct RateArgs {
  const int32_t* lanes[3];   // [n, len[c]] transform lanes
  const int32_t* qm[2];      // quant matrix entry of each lane: luma, chroma
  int len[3];
  int llh[3], llw[3];        // a slice's LL block
  const int32_t* table;      // [n, 2, TRIALS] the body table (generic kernel)
  const int32_t* avail;      // [n] bits a slice's codes may take
  int32_t* q_out;            // [n]
  int32_t* ll_out[3];        // [n, llh * llw] LL codes
  unsigned long long* bottom[3];   // [rows, cols * llw] tagged bottom rows
  int* ticket;
  int rows, cols;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// scale(x, q) of quantiser.py, in int32 with the reference's wrap at every
// step: sign(x) * ((|x| * factor [+ offset if > 0] + 2) / 4), C division.
__device__ __forceinline__ int32_t rescale(int32_t x, int32_t f, int32_t o) {
  const int32_t prod = static_cast<int32_t>(magnitude(x) *
                                            static_cast<uint32_t>(f));
  const int32_t p = static_cast<int32_t>(
      static_cast<uint32_t>(prod) + (prod > 0 ? static_cast<uint32_t>(o) : 0u)
      + 2u);
  const int32_t r = p < 0
      ? static_cast<int32_t>(0u - static_cast<uint32_t>(
            static_cast<int32_t>(0u - static_cast<uint32_t>(p)) >> 2))
      : (p >> 2);
  return x < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(r)) : r;
}

// The truncating mean of three reconstructions, their sum wrapped.
__device__ __forceinline__ int32_t mean3(int32_t a, int32_t b, int32_t c) {
  const int32_t r = wadd(wadd(a, b), c);
  return (r >= 0 ? wadd(r, 1) : wsub(r, 1)) / 3;
}

__device__ __forceinline__ int code_bits_of(uint32_t m) {   // m = |code|
  return m ? 2 * (32 - __clz(m + 1u)) : 1;
}

// A border word: published once with its tag, read until the tag shows.
__device__ __forceinline__ void publish(unsigned long long* p, int32_t v) {
  const unsigned long long w = READY | static_cast<uint32_t>(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ int32_t await(const unsigned long long* p) {
  unsigned long long w;
  do {
    w = peek(p);
  } while (!(w & READY));
  return static_cast<int32_t>(static_cast<uint32_t>(w));
}

// The quantiser of a probe's LL band: its factor, offset, the factor's
// magnitude and its reciprocal (golomb_encode.cuh's quantise, hoisted).
struct LLQuant {
  int32_t f, o;
  uint32_t af;
  unsigned long long rc;
};

__device__ __forceinline__ LLQuant ll_quant(int q, int qm_ll,
                                            const Tables& t) {
  const int aq = min(max(q - qm_ll, 0), 119);
  return LLQuant{t.factors[aq], t.offsets[aq], magnitude(t.factors[aq]),
                 t.recips[aq]};
}

// One LL cell: its code (into `code`) and its reconstruction, from its
// value and its prediction.
__device__ __forceinline__ int32_t ll_cell(int32_t val, int32_t pred,
                                           const LLQuant& z, int32_t& code) {
  const int32_t x = wsub(val, pred);
  const uint32_t r = quotient(magnitude(x), z.af, z.rc);
  code = static_cast<int32_t>(((x < 0) != (z.f < 0)) ? 0u - r : r);
  return wadd(rescale(code, z.f, z.o), pred);
}

// The prediction of cell (i, j) of an LL block (predict_dc with its
// reduced branches at the picture's edges): `al`, `above`, `left` the
// reconstructions around it.
__device__ __forceinline__ int32_t ll_pred(bool up, bool lf, int32_t al,
                                           int32_t above, int32_t left) {
  const int32_t mean = mean3(al, above, left);   // selects, no branch
  return up ? (lf ? mean : above) : (lf ? left : 0);
}

// ---------------------------------------------------------------------------
// The body table in device memory, for the generic kernel: a CTA takes
// TABLE_SLICES slices, a warp 32 lanes (or u/v pairs) of one of them at a
// time, and the slice's warps add their sums into its rows in shared
// memory before the rows are written out.

__global__ void __launch_bounds__(32 * TABLE_WARPS) ld_body_table(
    TableArgs a) {
  __shared__ Tables t;
  __shared__ int excess[TABLE_SLICES][2][TRIALS];   // bits past 1 a code
  __shared__ int last[TABLE_SLICES][2][TRIALS];     // last non-zero code
  t.load(threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < TABLE_SLICES * 2 * TRIALS; i += blockDim.x) {
    (&excess[0][0][0])[i] = 0;
    (&last[0][0][0])[i] = -1;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int body_y = a.len[0] - a.nll[0], body_c = a.len[1] - a.nll[1];
  const int chunks_y = (body_y + 31) / 32;
  const int items = chunks_y + (body_c + 31) / 32;   // a slice's warps
  const long long s0 = static_cast<long long>(blockIdx.x) * TABLE_SLICES;
  const int slices = static_cast<int>(
      min(static_cast<long long>(TABLE_SLICES), a.n - s0));

  for (int item = warp; item < slices * items; item += TABLE_WARPS) {
    const int slot = item / items, k = item % items;
    const long long s = s0 + slot;
    const int c = k < chunks_y ? 0 : 1;
    const int p = (c ? k - chunks_y : k) * 32 + lane;   // body position
    // this lane's magnitudes (luma: m1 = 0), quant matrix entry, and its
    // position(s) in code order; a lane past the body counts nothing
    uint32_t m0 = 0, m1 = 0;
    int qm = TRIALS;
    if (p < (c ? body_c : body_y)) {
      const int len = c ? a.len[1] : a.len[0];
      const int j = (c ? a.nll[1] : a.nll[0]) + p;
      qm = __ldg((c ? a.qm[1] : a.qm[0]) + j);
      m0 = magnitude(__ldg((c ? a.lanes[1] : a.lanes[0]) + s * len + j));
      if (c) m1 = magnitude(__ldg(a.lanes[2] + s * len + j));
    }
    const int pos0 = c ? 2 * p : p, pos1 = 2 * p + 1;
    // the first trial a wrapped factor could make this lane non-zero
    const bool big = (static_cast<unsigned long long>(max(m0, m1)) << 2) >=
                     WRAP_MIN;
    const int wrap_at = big ? qm + MONOTONE_MAX + 1 : TRIALS - 1;
    int* ex_row = excess[slot][c];
    int* last_row = last[slot][c];
    // every lane of the warp below 2^30 (real pictures): the short quotient
    const bool small = __all_sync(FULL, max(m0, m1) < (1u << 30));
    bool done = false;   // 0 at an index <= 115, so 0 until index 116
    for (int trial = 0; trial < TRIALS - 1;) {
      const int aq = min(max(trial - qm, 0), 119);
      const unsigned long long rc = t.recips[aq];
      uint32_t r0, r1 = 0;
      if (small) {
        r0 = vc2::small_quotient(m0, rc);
        if (c) r1 = vc2::small_quotient(m1, rc);
      } else {
        const uint32_t af = magnitude(t.factors[aq]);
        r0 = quotient(m0, af, rc);
        if (c) r1 = quotient(m1, af, rc);
      }
      int e = (r0 ? code_bits_of(r0) - 1 : 0) + (r1 ? code_bits_of(r1) - 1
                                                       : 0);
      int pos = r1 ? pos1 : (r0 ? pos0 : -1);
      e = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(e)));
      pos = __reduce_max_sync(FULL, pos);
      if (lane == 0 && pos >= 0) {   // the slice's other warps add theirs
        atomicAdd(ex_row + trial, e);
        atomicMax(last_row + trial, pos);
      }
      done = done || (!r0 && !r1 && aq <= MONOTONE_MAX);
      ++trial;
      if (__all_sync(FULL, done))
        trial = max(trial, __reduce_min_sync(FULL, wrap_at));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slices * 2 * TRIALS; i += blockDim.x) {
    const int l = (&last[0][0][0])[i];
    a.table[s0 * 2 * TRIALS + i] = l >= 0 ? (&excess[0][0][0])[i] + l + 1
                                          : 0;
  }
}

// ---------------------------------------------------------------------------
// The wavefront, generic: a warp a row, one probe at a time.

// One component's LL block in shared memory, as lane c < 3 runs it.
struct LLBlock {
  int32_t* rec;    // [lh * lw] reconstructions of the current trial
  int32_t* bits;   // [lh * lw] code bits, or 0 for the code of 0
  int32_t* top;    // [lw] the above slice's bottom row
  int32_t* left;   // [lh] the left slice's right column
  int lh, lw;
};

// The LL block at index q against its borders: reconstructions and code
// bits into b (codes into `codes` when given), from the values `vals`.
// up0 / left0: the slice has a slice above / to its left.
__device__ __forceinline__ void ll_pass(const LLBlock& b,
                                        const int32_t* vals, int qm_ll, int q,
                                        bool up0, bool left0, int32_t corner,
                                        const Tables& t, int32_t* codes) {
  const LLQuant z = ll_quant(q, qm_ll, t);
  for (int i = 0; i < b.lh; ++i) {
    for (int j = 0; j < b.lw; ++j) {
      const int k = i * b.lw + j;
      const int32_t pred = ll_pred(
          up0 || i > 0, left0 || j > 0,
          i ? (j ? b.rec[k - b.lw - 1] : b.left[i - 1])
            : (j ? b.top[j - 1] : corner),
          i ? b.rec[k - b.lw] : b.top[j], j ? b.rec[k - 1] : b.left[i]);
      int32_t code;
      b.rec[k] = ll_cell(__ldg(vals + k), pred, z, code);
      b.bits[k] = code ? code_bits_of(magnitude(code)) : 0;
      if (codes) codes[k] = code;
    }
  }
}

// Code bits of a run of LL cells (bits 0 for a zero code, which costs 1):
// the gross bits and the bits up to the last non-zero code.
__device__ __forceinline__ void ll_count(const int32_t* bits, int n,
                                         int& gross, int& count) {
  for (int k = 0; k < n; ++k) {
    const int nb = bits[k];
    gross += nb ? nb : 1;
    if (nb) count = gross;
  }
}

__global__ void __launch_bounds__(32) ld_rate(RateArgs a) {
  extern __shared__ int32_t smem[];
  __shared__ Tables t;
  const int lane = threadIdx.x;
  t.load(lane, 32);
  int row = 0;
  if (lane == 0) row = atomicAdd(a.ticket, 1);
  row = __shfl_sync(FULL, row, 0);

  const int nll_y = a.llh[0] * a.llw[0], nll_c = a.llh[1] * a.llw[1];
  // the LL blocks; lane c < 3 runs component c's; then the slice's table
  LLBlock ll[3];
  int at = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int lh = a.llh[c], lw = a.llw[c];
    ll[c] = LLBlock{smem + at, smem + at + lh * lw, smem + at + 2 * lh * lw,
                    smem + at + 2 * lh * lw + lw, lh, lw};
    at += 2 * lh * lw + lh + lw;
  }
  int32_t* entries = smem + at;   // [2, TRIALS]
  const int c = min(lane, 2);
  const LLBlock own = c == 0 ? ll[0] : c == 1 ? ll[1] : ll[2];
  const int32_t* own_lanes = c == 0 ? a.lanes[0] : c == 1 ? a.lanes[1]
                                                           : a.lanes[2];
  const int own_len = c == 0 ? a.len[0] : a.len[1];
  int32_t* own_out = c == 0 ? a.ll_out[0] : c == 1 ? a.ll_out[1]
                                                    : a.ll_out[2];
  unsigned long long* own_bottom = c == 0 ? a.bottom[0]
                                   : c == 1 ? a.bottom[1] : a.bottom[2];
  const int qm_ll = __ldg(a.qm[0]);   // the LL band's entry
  __syncwarp();

  int32_t corner = 0;                 // lane c < 3: component c's
  for (int h = 0; h < a.cols; ++h) {
    const long long s = static_cast<long long>(row) * a.cols + h;
    const int avail = __ldg(a.avail + s);
    for (int k = lane; k < 2 * TRIALS; k += 32)
      entries[k] = __ldg(a.table + s * 2 * TRIALS + k);
    const int32_t* own_vals = own_lanes + s * own_len;
    if (lane < 3 && row > 0) {      // the above slice's bottom row
      const unsigned long long* b =
          own_bottom + (s - a.cols) * own.lw;
      for (int j = 0; j < own.lw; ++j) own.top[j] = await(b + j);
      corner = h > 0 ? await(b - 1) : 0;
    }
    __syncwarp();

    int trial = 63, best = 127;
#pragma unroll 1
    for (int delta = 32;; delta >>= 1) {
      if (lane < 3)
        ll_pass(own, own_vals, qm_ll, trial, row > 0, h > 0, corner, t,
                nullptr);
      __syncwarp();
      // the LL counts, every lane: luma, then chroma interleaved
      int gy = 0, cy = 0, gc = 0, cc = 0;
      ll_count(ll[0].bits, nll_y, gy, cy);
      for (int k = 0; k < nll_c; ++k) {
        const int nu = ll[1].bits[k], nv = ll[2].bits[k];
        gc += nu ? nu : 1;
        if (nu) cc = gc;
        gc += nv ? nv : 1;
        if (nv) cc = gc;
      }
      const int ey = entries[trial], ec = entries[TRIALS + trial];
      const int bits = (ey ? gy + ey : cy) + (ec ? gc + ec : cc);
      const bool fits = bits <= avail;
      if (fits && trial < best) best = trial;
      if (delta == 0) break;
      trial += fits ? -delta : delta;
      __syncwarp();      // the counts are read before the next pass writes
    }

    // the final requantise at best: the LL lanes, the bottom row for the
    // row below, the right column for the next slice
    if (lane < 3) {
      const int lh = own.lh, lw = own.lw;
      ll_pass(own, own_vals, qm_ll, best, row > 0, h > 0, corner, t,
              own_out + s * lh * lw);
      unsigned long long* b = own_bottom + s * lw;
      for (int j = 0; j < lw; ++j) publish(b + j, own.rec[(lh - 1) * lw + j]);
      for (int i = 0; i < lh; ++i) own.left[i] = own.rec[i * lw + lw - 1];
    }
    if (lane == 0) a.q_out[s] = best;
    __syncwarp();
  }
}


// ---------------------------------------------------------------------------
// The wavefront for fixed LL blocks: a CTA a row, a thread a trial, and
// producer warps that size the row's body lanes ahead of it.

// The body table rows of a row's slices, a ring of RING slots in shared
// memory: the producer warps fill a slot once the consumers have read the
// slice it held before.
struct Ring {
  int32_t entries[RING][2][TRIALS];
  int ready[RING];   // the slice a slot holds, -1 before the first
  int consumed;      // slices of the row whose entries the consumers read
};

__device__ __forceinline__ int load_volatile(const int* p) {
  return *static_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_volatile(int* p, int v) {
  *static_cast<volatile int*>(p) = v;
}

// The barrier of the CTA's TRIALS consumer threads (the producers never
// take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(TRIALS) : "memory");
}

// The first trial at which a wrapped factor (116-119) could make |v| = m
// non-zero at quant matrix entry q, or TRIALS - 1 for none.
__device__ __forceinline__ int wrap_trial(uint32_t m, int q) {
  return (static_cast<unsigned long long>(m) << 2) >= WRAP_MIN
             ? q + MONOTONE_MAX + 1 : TRIALS - 1;
}

// Producer warp pw of a row's CTA: the body table rows of slices pw, pw +
// PRODUCERS, ... of the row, into the ring, as ld_body_table sizes them;
// lane p holds luma body lanes p and p + 32 and chroma pair p (at most
// FIXED_BODY_Y and FIXED_BODY_C body lanes).
template <int NY, int NC>
__device__ __forceinline__ void produce(const RateArgs& a, const Tables& t,
                                        Ring& ring, int row, int pw,
                                        int lane) {
  const int len_y = a.len[0], len_c = a.len[1];
  const int body_y = len_y - NY, body_c = len_c - NC;
  const int p = lane;
  const bool in0 = p < body_y, in1 = p + 32 < body_y, inc = p < body_c;
  const int q0 = in0 ? __ldg(a.qm[0] + NY + p) : TRIALS;
  const int q1 = in1 ? __ldg(a.qm[0] + NY + p + 32) : TRIALS;
  const int qc = inc ? __ldg(a.qm[1] + NC + p) : TRIALS;
  for (int k = pw; k < a.cols; k += PRODUCERS) {
    const long long s = static_cast<long long>(row) * a.cols + k;
    const int32_t* y = a.lanes[0] + s * len_y + NY;
    const uint32_t m0 = in0 ? magnitude(__ldg(y + p)) : 0u;
    const uint32_t m1 = in1 ? magnitude(__ldg(y + p + 32)) : 0u;
    const uint32_t mu = inc ? magnitude(__ldg(a.lanes[1] + s * len_c + NC + p))
                            : 0u;
    const uint32_t mv = inc ? magnitude(__ldg(a.lanes[2] + s * len_c + NC + p))
                            : 0u;
    const int slot = k % RING;
    while (load_volatile(&ring.consumed) <= k - RING) {
    }
    int32_t* ey = ring.entries[slot][0];
    int32_t* ec = ring.entries[slot][1];
    for (int i = lane; i < TRIALS; i += 32) {
      ey[i] = 0;
      ec[i] = 0;
    }
    __syncwarp();
    const bool small = __all_sync(
        FULL, max(max(m0, m1), max(mu, mv)) < (1u << 30));
    const int wrap_at = min(min(wrap_trial(m0, q0), wrap_trial(m1, q1)),
                            wrap_trial(max(mu, mv), qc));
    bool d0 = false, d1 = false, dc = false;   // as `done` of ld_body_table
    for (int trial = 0; trial < TRIALS - 1;) {
      const int a0 = min(max(trial - q0, 0), 119);
      const int a1 = min(max(trial - q1, 0), 119);
      const int ac = min(max(trial - qc, 0), 119);
      uint32_t r0, r1, ru, rv;
      if (small) {
        r0 = vc2::small_quotient(m0, t.recips[a0]);
        r1 = vc2::small_quotient(m1, t.recips[a1]);
        ru = vc2::small_quotient(mu, t.recips[ac]);
        rv = vc2::small_quotient(mv, t.recips[ac]);
      } else {
        r0 = quotient(m0, magnitude(t.factors[a0]), t.recips[a0]);
        r1 = quotient(m1, magnitude(t.factors[a1]), t.recips[a1]);
        ru = quotient(mu, magnitude(t.factors[ac]), t.recips[ac]);
        rv = quotient(mv, magnitude(t.factors[ac]), t.recips[ac]);
      }
      int e_y = (r0 ? code_bits_of(r0) - 1 : 0) +
                (r1 ? code_bits_of(r1) - 1 : 0);
      int e_c = (ru ? code_bits_of(ru) - 1 : 0) +
                (rv ? code_bits_of(rv) - 1 : 0);
      int pos_y = r1 ? p + 32 : (r0 ? p : -1);
      int pos_c = rv ? 2 * p + 1 : (ru ? 2 * p : -1);
      e_y = static_cast<int>(
          __reduce_add_sync(FULL, static_cast<unsigned>(e_y)));
      e_c = static_cast<int>(
          __reduce_add_sync(FULL, static_cast<unsigned>(e_c)));
      pos_y = __reduce_max_sync(FULL, pos_y);
      pos_c = __reduce_max_sync(FULL, pos_c);
      if (lane == 0) {
        if (pos_y >= 0) ey[trial] = e_y + pos_y + 1;
        if (pos_c >= 0) ec[trial] = e_c + pos_c + 1;
      }
      d0 = d0 || (!r0 && a0 <= MONOTONE_MAX);
      d1 = d1 || (!r1 && a1 <= MONOTONE_MAX);
      dc = dc || (!ru && !rv && ac <= MONOTONE_MAX);
      ++trial;
      if (__all_sync(FULL, d0 && d1 && dc))
        trial = max(trial, __reduce_min_sync(FULL, wrap_at));
    }
    __syncwarp();
    __threadfence_block();
    if (lane == 0) store_volatile(&ring.ready[slot], k);
  }
}

// One component's LL block of H x W cells at one trial, in registers.
template <int H, int W>
struct FixedLL {
  int32_t vals[H * W], rec[H * W], code[H * W];
  int32_t top[W], left[H], corner;

  __device__ __forceinline__ void pass(const LLQuant& z, bool up0,
                                       bool left0) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int k = i * W + j;
        const int32_t pred = ll_pred(
            up0 || i > 0, left0 || j > 0,
            i ? (j ? rec[k - W - 1] : left[i - 1]) : (j ? top[j - 1] : corner),
            i ? rec[k - W] : top[j], j ? rec[k - 1] : left[i]);
        rec[k] = ll_cell(vals[k], pred, z, code[k]);
      }
    }
  }
};

// The gross bits and the bits up to the last non-zero code of a run of
// codes, continued from (gross, count).
__device__ __forceinline__ void count_code(int32_t code, int& gross,
                                           int& count) {
  gross += code ? code_bits_of(magnitude(code)) : 1;
  if (code) count = gross;
}

// The walk of the bisection over the fits mask (bit t of lo for t < 64,
// of hi for the others): the reference's 7 probes, in registers.
__device__ __forceinline__ int walk(unsigned long long lo,
                                    unsigned long long hi) {
  int trial = 63, best = 127;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int delta = 32 >> k;   // 32, 16, ..., 1, then 0
    const bool fits = (((trial & 64) ? hi : lo) >> (trial & 63)) & 1ull;
    if (fits && trial < best) best = trial;
    trial += fits ? -delta : delta;
  }
  return best;
}

// The rate control for a luma LL block of YH x YW and chroma blocks of
// CH x CW: thread `trial` < TRIALS of the row's CTA, or a producer warp.
template <int YH, int YW, int CH, int CW>
__global__ void __launch_bounds__(FIXED_THREADS) ld_rate_fixed(RateArgs a) {
  constexpr int NY = YH * YW, NC = CH * CW;
  __shared__ Tables t;
  __shared__ Ring ring;
  __shared__ unsigned fits_words[TRIALS / 32];
  __shared__ int32_t right[YH + 2 * CH];   // the picked trial's right columns
  __shared__ int row_of_cta;
  const int trial = threadIdx.x, lane = trial & 31;
  t.load(trial, FIXED_THREADS);
  for (int i = trial; i < RING; i += FIXED_THREADS) ring.ready[i] = -1;
  if (trial == 0) {
    row_of_cta = atomicAdd(a.ticket, 1);
    ring.consumed = 0;
  }
  __syncthreads();
  const int row = row_of_cta;
  if (trial >= TRIALS) {
    produce<NY, NC>(a, t, ring, row, (trial - TRIALS) >> 5, lane);
    return;
  }
  const LLQuant z = ll_quant(trial, __ldg(a.qm[0]), t);   // this thread's
  const int len_y = a.len[0], len_c = a.len[1];
  const long long s0 = static_cast<long long>(row) * a.cols;

  // slice h's LL values, body table entries and budget, loaded a slice
  // ahead so their latency is off the chain
  int32_t nvy[NY], nvu[NC], nvv[NC];
  int ney, nec, navail;
  auto prefetch = [&](int h) {
    const long long s = s0 + h;
#pragma unroll
    for (int k = 0; k < NY; ++k) nvy[k] = __ldg(a.lanes[0] + s * len_y + k);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      nvu[k] = __ldg(a.lanes[1] + s * len_c + k);
      nvv[k] = __ldg(a.lanes[2] + s * len_c + k);
    }
    navail = __ldg(a.avail + s);
    const int slot = h % RING;   // the producers' row of slice h
    while (load_volatile(&ring.ready[slot]) != h) {
    }
    __threadfence_block();
    ney = ring.entries[slot][0][trial];
    nec = ring.entries[slot][1][trial];
  };
  prefetch(0);

  FixedLL<YH, YW> ly{};
  FixedLL<CH, CW> lu{}, lv{};
  const bool up0 = row > 0;
  for (int h = 0; h < a.cols; ++h) {
    const long long s = s0 + h;
#pragma unroll
    for (int k = 0; k < NY; ++k) ly.vals[k] = nvy[k];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      lu.vals[k] = nvu[k];
      lv.vals[k] = nvv[k];
    }
    const int ey = ney, ec = nec, avail = navail;
    if (h + 1 < a.cols) prefetch(h + 1);
    const bool left0 = h > 0;
    if (up0) {   // the above slice's bottom rows: all words at once
      const long long above = s - a.cols;
      unsigned long long w[YW + 2 * CW];
      bool ready;
        do {
  #pragma unroll
        for (int j = 0; j < YW; ++j) w[j] = peek(a.bottom[0] + above * YW + j);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          w[YW + j] = peek(a.bottom[1] + above * CW + j);
          w[YW + CW + j] = peek(a.bottom[2] + above * CW + j);
        }
        ready = true;
#pragma unroll
        for (int j = 0; j < YW + 2 * CW; ++j) ready = ready && (w[j] & READY);
      } while (!ready);
#pragma unroll
      for (int j = 0; j < YW; ++j) ly.top[j] = static_cast<int32_t>(w[j]);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        lu.top[j] = static_cast<int32_t>(w[YW + j]);
        lv.top[j] = static_cast<int32_t>(w[YW + CW + j]);
      }
    }
    ly.pass(z, up0, left0);
    lu.pass(z, up0, left0);
    lv.pass(z, up0, left0);
    int gy = 0, cy = 0, gc = 0, cc = 0;
#pragma unroll
    for (int k = 0; k < NY; ++k) count_code(ly.code[k], gy, cy);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      count_code(lu.code[k], gc, cc);
      count_code(lv.code[k], gc, cc);
    }
    const int bits = (ey ? gy + ey : cy) + (ec ? gc + ec : cc);
    const unsigned word =
        __ballot_sync(FULL, trial < TRIALS - 1 && bits <= avail);
    if (lane == 0) fits_words[trial >> 5] = word;
    consumers_sync();
    const int best = walk(
        fits_words[0] | static_cast<unsigned long long>(fits_words[1]) << 32,
        fits_words[2] | static_cast<unsigned long long>(fits_words[3]) << 32);

    if (trial == best) {    // the picked trial's thread writes the slice
      a.q_out[s] = best;
#pragma unroll
      for (int k = 0; k < NY; ++k) a.ll_out[0][s * NY + k] = ly.code[k];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        a.ll_out[1][s * NC + k] = lu.code[k];
        a.ll_out[2][s * NC + k] = lv.code[k];
      }
#pragma unroll
      for (int j = 0; j < YW; ++j)
        publish(a.bottom[0] + s * YW + j, ly.rec[(YH - 1) * YW + j]);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        publish(a.bottom[1] + s * CW + j, lu.rec[(CH - 1) * CW + j]);
        publish(a.bottom[2] + s * CW + j, lv.rec[(CH - 1) * CW + j]);
      }
#pragma unroll
      for (int i = 0; i < YH; ++i) right[i] = ly.rec[i * YW + YW - 1];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        right[YH + i] = lu.rec[i * CW + CW - 1];
        right[YH + CH + i] = lv.rec[i * CW + CW - 1];
      }
    }
    consumers_sync();
    if (trial == 0) {   // slices up to h + 1 are read: their slots are free
      __threadfence_block();
      store_volatile(&ring.consumed, h + 2);
    }
    // the next slice's left columns, and its above-left corners: the last
    // of this slice's top rows
#pragma unroll
    for (int i = 0; i < YH; ++i) ly.left[i] = right[i];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      lu.left[i] = right[YH + i];
      lv.left[i] = right[YH + CH + i];
    }
    ly.corner = ly.top[YW - 1];
    lu.corner = lu.top[CW - 1];
    lv.corner = lv.top[CW - 1];
  }
}

// The wavefront kernel for these LL blocks, its threads and its dynamic
// shared memory: a fixed-shape kernel where one is compiled, else the
// generic one.
struct Plan {
  void (*kernel)(RateArgs);
  int threads;
  long long smem;
};

Plan plan(int ly, int lc, int lyh, int lyw, int lch, int lcw) {
  const bool held = ly - lyh * lyw <= FIXED_BODY_Y &&
                    lc - lch * lcw <= FIXED_BODY_C;
  if (held && lyh == 2 && lyw == 2 && lch == 2 && lcw == 1)  // -u 2 -a 2
    return {ld_rate_fixed<2, 2, 2, 1>, FIXED_THREADS, 0};
  if (held && lyh == 1 && lyw == 2 && lch == 1 && lcw == 1)  // -u 1 -a 2
    return {ld_rate_fixed<1, 2, 1, 1>, FIXED_THREADS, 0};
  const long long ll_ints = 2LL * lyh * lyw + lyh + lyw +
                            2 * (2LL * lch * lcw + lch + lcw);
  return {ld_rate, 32, 4 * (ll_ints + 2 * TRIALS)};
}

}  // namespace


// Whether these shapes take a fixed-shape kernel (1), which sizes the body
// lanes itself, or the generic one (0), which reads the body table.
extern "C" int ld_rate_fixed_shape(int ly, int lc, int lyh, int lyw, int lch,
                                   int lcw) {
  return plan(ly, lc, lyh, lyw, lch, lcw).kernel != ld_rate;
}

// The CTAs of the wavefront kernel for these shapes that one SM holds at
// once (each CTA is one row of slices), or a negative CUDA error code.
extern "C" int ld_rate_resident(int ly, int lc, int lyh, int lyw, int lch,
                                int lcw) {
  const Plan p = plan(ly, lc, lyh, lyw, lch, lcw);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, p.kernel, p.threads, static_cast<size_t>(p.smem));
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// The body table [n, 2, TRIALS] (int32) of the transform lanes y [n, ly],
// u and v [n, lc] (int32, contiguous rows) whose first nll_y / nll_c lanes
// are the LL block, with the quant matrix entry of each lane qm_y [ly],
// qm_c [lc]. Returns the launch's CUDA error code.
extern "C" int ld_body_table_launch(const void* y, const void* u,
                                    const void* v, int ly, int lc, int nll_y,
                                    int nll_c, const void* qm_y,
                                    const void* qm_c, int n, void* table,
                                    void* stream) {
  if (n <= 0) return 0;
  if (nll_y < 0 || nll_c < 0 || nll_y > ly || nll_c > lc)
    return static_cast<int>(cudaErrorInvalidValue);
  TableArgs a;
  a.lanes[0] = static_cast<const int32_t*>(y);
  a.lanes[1] = static_cast<const int32_t*>(u);
  a.lanes[2] = static_cast<const int32_t*>(v);
  a.qm[0] = static_cast<const int32_t*>(qm_y);
  a.qm[1] = static_cast<const int32_t*>(qm_c);
  a.len[0] = ly;
  a.len[1] = lc;
  a.nll[0] = nll_y;
  a.nll[1] = nll_c;
  a.table = static_cast<int32_t*>(table);
  a.n = n;
  ld_body_table<<<(n + TABLE_SLICES - 1) / TABLE_SLICES, 32 * TABLE_WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// q_out [n] (int32) and the LL lanes ll_* [n, llh * llw] from the transform
// lanes y [n, ly], u and v [n, lc] (int32, contiguous rows, n = rows *
// cols in raster order; the first llh * llw lanes of a row are its LL
// block), the quant matrix entry of each lane qm_y [ly], qm_c [lc], the LL
// blocks (lyh x lyw, lch x lcw) and avail [n]. The generic kernel reads the
// body table [n, 2, TRIALS] of ld_body_table_launch; a fixed-shape kernel
// (ld_rate_fixed_shape) sizes the body itself and takes `table` null.
// `scratch` (int64, zero) holds [ticket, the tagged bottom rows: rows *
// cols * (lyw + 2 lcw)]. Returns the launch's CUDA error code.
extern "C" int ld_rate_launch(const void* y, const void* u, const void* v,
                              int ly, int lc, const void* qm_y,
                              const void* qm_c, int lyh, int lyw, int lch,
                              int lcw, const void* table, const void* avail,
                              int rows, int cols, void* q_out, void* ll_y,
                              void* ll_u, void* ll_v, void* scratch,
                              void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const Plan p = plan(ly, lc, lyh, lyw, lch, lcw);
  if (lyh < 1 || lyw < 1 || lch < 1 || lcw < 1 || lyh * lyw > ly ||
      lch * lcw > lc || p.smem > STAGE_BYTES ||
      (p.kernel == ld_rate) != (table != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RateArgs a;
  a.lanes[0] = static_cast<const int32_t*>(y);
  a.lanes[1] = static_cast<const int32_t*>(u);
  a.lanes[2] = static_cast<const int32_t*>(v);
  a.qm[0] = static_cast<const int32_t*>(qm_y);
  a.qm[1] = static_cast<const int32_t*>(qm_c);
  a.len[0] = ly;
  a.len[1] = a.len[2] = lc;
  a.llh[0] = lyh;
  a.llw[0] = lyw;
  a.llh[1] = a.llh[2] = lch;
  a.llw[1] = a.llw[2] = lcw;
  a.table = static_cast<const int32_t*>(table);
  a.avail = static_cast<const int32_t*>(avail);
  a.q_out = static_cast<int32_t*>(q_out);
  a.ll_out[0] = static_cast<int32_t*>(ll_y);
  a.ll_out[1] = static_cast<int32_t*>(ll_u);
  a.ll_out[2] = static_cast<int32_t*>(ll_v);
  unsigned long long* w = static_cast<unsigned long long*>(scratch);
  a.ticket = reinterpret_cast<int*>(w);
  const long long n = static_cast<long long>(rows) * cols;
  a.bottom[0] = w + 1;
  a.bottom[1] = a.bottom[0] + n * lyw;
  a.bottom[2] = a.bottom[1] + n * lcw;
  a.rows = rows;
  a.cols = cols;
  p.kernel<<<rows, p.threads, static_cast<size_t>(p.smem),
             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
