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
// Design. A slice waits only on the final reconstructions of its left,
// above and above-left neighbours. One warp, one CTA, takes a row of
// slices from a ticket (atomicAdd) and walks it left to right, so a row
// only ever waits on a row whose CTA already runs: no co-residency or
// cooperative launch is needed. Before slice h it spins (acquire) until
// the row above has published progress > h; after the slice it stores the
// bottom row of each LL block in device memory, fences and publishes
// progress h + 1 (release). The next slice's lanes are copied into shared
// memory (cp.async, double buffered) while the current one is searched,
// so their load is off the dependent path. The critical path is R + C - 1
// dependent slice steps (374 at 1080p), each 8 probes long.
//
// Two kernels. ld_rate_fixed, compiled for the LL blocks of the measured
// 4:2:2 shapes (luma 2 x 2 with chroma 2 x 1, 1080p at -u 2 -a 2; luma
// 1 x 2 with chroma 1 x 1) and up to 64 body lanes a component, keeps
// everything of a probe in registers: every lane computes the three LL
// recurrences (the same values, so no divergence) and sizes its own share
// of the body lanes, and a probe is straight-line code the compiler can
// interleave. ld_rate, for any other shape (4:4:4 and 4:2:0 among them),
// keeps the LL blocks in shared memory, runs them on lanes 0-2 and sizes
// the body in loops. Both reduce with redux.
//
// What bounds it on the card: not the bytes (16.6 MB of lanes at 1080p,
// 5 us) nor the operations (~7 us), but the latency of one warp's
// dependent chain: an LL cell is some 50 dependent integer instructions
// (the mean, the 64-bit quotient and its correction, the rescale), the
// 2 x 2 luma block is 3 cells deep, and one warp a row leaves each SM
// nothing to issue while it waits. At 1080p a slice takes ~9 us of which
// the LL passes are about half (chip_smoke.py, PERF.md). Sizing the body
// on a second warp, or probing two levels of the bisection at once, is
// the next step.
//
// The quotient is golomb_encode.cuh's, exact for every int32 and without
// a branch; scale wraps at every step as the port's quantiser does.

#include <cstdint>
#include <cuda_runtime.h>

#include "golomb_encode.cuh"
#include "ld_rate_params.h"

namespace {

using vc2::magnitude;
using vc2::quotient;

constexpr int STAGE_BYTES = VC2_LD_STAGE_BYTES;
constexpr unsigned FULL = 0xffffffffu;

__constant__ int32_t QUANT_FACTORS[120] = {VC2_QUANT_FACTORS};
__constant__ int32_t QUANT_OFFSETS[120] = {VC2_QUANT_OFFSETS};
__constant__ unsigned long long QUANT_RECIPROCALS[120] = {
    VC2_QUANT_RECIPROCALS};

struct RateArgs {
  const int32_t* lanes[3];   // [n, len[c]] transform lanes
  const int32_t* qm[3];      // quant matrix entry of each lane
  int len[3];
  int llh[3], llw[3];        // a slice's LL block
  const int32_t* avail;      // [n] bits a slice's codes may take
  int32_t* q_out;            // [n]
  int32_t* ll_out[3];        // [n, llh * llw] LL codes
  int32_t* bottom[3];        // [rows, cols * llw] LL blocks' bottom rows
  int* ticket;
  int* progress;             // [rows] slices finished a row
  int rows, cols, staged;
};

struct Tables {
  int32_t factors[120];
  int32_t offsets[120];
  unsigned long long recips[120];
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

// The magnitude of a lane quantised at the adjusted index aq.
__device__ __forceinline__ uint32_t quantised_magnitude(int32_t v, int aq,
                                                        const Tables& t) {
  return quotient(magnitude(v), magnitude(t.factors[aq]), t.recips[aq]);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// A 4-byte asynchronous copy from device memory to shared memory.
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
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
      b.rec[k] = ll_cell(vals[k], pred, z, code);
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
  for (int i = lane; i < 120; i += 32) {
    t.factors[i] = QUANT_FACTORS[i];
    t.offsets[i] = QUANT_OFFSETS[i];
    t.recips[i] = QUANT_RECIPROCALS[i];
  }
  int row = 0;
  if (lane == 0) row = atomicAdd(a.ticket, 1);
  row = __shfl_sync(FULL, row, 0);

  const int len_y = a.len[0], len_c = a.len[1];
  const int nll_y = a.llh[0] * a.llw[0], nll_c = a.llh[1] * a.llw[1];
  const int body_y = len_y - nll_y, body_c = len_c - nll_c;
  // the LL blocks; lane c < 3 runs component c's
  LLBlock ll[3];
  int at = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int lh = a.llh[c], lw = a.llw[c];
    ll[c] = LLBlock{smem + at, smem + at + lh * lw, smem + at + 2 * lh * lw,
                    smem + at + 2 * lh * lw + lw, lh, lw};
    at += 2 * lh * lw + lh + lw;
  }
  const int c = min(lane, 2);
  const LLBlock own = c == 0 ? ll[0] : c == 1 ? ll[1] : ll[2];
  const int32_t* own_lanes = c == 0 ? a.lanes[0] : c == 1 ? a.lanes[1]
                                                           : a.lanes[2];
  const int own_len = c == 0 ? len_y : len_c;
  int32_t* own_out = c == 0 ? a.ll_out[0] : c == 1 ? a.ll_out[1]
                                                    : a.ll_out[2];
  int32_t* own_bottom = c == 0 ? a.bottom[0] : c == 1 ? a.bottom[1]
                                                       : a.bottom[2];
  // the quant matrix entries and, double-buffered, a slice's lanes
  const int32_t* qm_y = a.qm[0];
  const int32_t* qm_c = a.qm[1];
  int32_t* buf[2] = {nullptr, nullptr};
  if (a.staged) {
    int32_t* p = smem + at;
    for (int j = lane; j < len_y; j += 32) p[j] = __ldg(a.qm[0] + j);
    for (int j = lane; j < len_c; j += 32) p[len_y + j] = __ldg(a.qm[1] + j);
    qm_y = p;
    qm_c = p + len_y;
    buf[0] = p + len_y + len_c;
    buf[1] = buf[0] + len_y + 2 * len_c;
  }
  const int qm_ll = c == 0 ? qm_y[0] : qm_c[0];   // the LL band's entry
  auto prefetch = [&](int h) {   // slice h of the row into buf[h & 1]
    const long long s = static_cast<long long>(row) * a.cols + h;
    int32_t* d = buf[h & 1];
    for (int j = lane; j < len_y; j += 32)
      copy_async(d + j, a.lanes[0] + s * len_y + j);
    for (int j = lane; j < len_c; j += 32) {
      copy_async(d + len_y + j, a.lanes[1] + s * len_c + j);
      copy_async(d + len_y + len_c + j, a.lanes[2] + s * len_c + j);
    }
    copy_commit();
  };
  if (a.staged) prefetch(0);
  __syncwarp();

  int32_t corner = 0;                 // lane c < 3: component c's
  int next_avail = __ldg(a.avail + static_cast<long long>(row) * a.cols);
  for (int h = 0; h < a.cols; ++h) {
    const long long s = static_cast<long long>(row) * a.cols + h;
    const int avail = next_avail;
    if (h + 1 < a.cols) next_avail = __ldg(a.avail + s + 1);
    const int32_t *y, *u, *v;
    if (a.staged) {
      if (h + 1 < a.cols) {
        prefetch(h + 1);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      y = buf[h & 1];
      u = y + len_y;
      v = u + len_c;
    } else {
      y = a.lanes[0] + s * len_y;
      u = a.lanes[1] + s * len_c;
      v = a.lanes[2] + s * len_c;
    }
    const int32_t* own_vals = a.staged ? (c == 0 ? y : c == 1 ? u : v)
                                       : own_lanes + s * own_len;
    if (row > 0) {
      while (load_acquire(a.progress + row - 1) <= h) {
      }
    }
    if (lane < 3 && row > 0) {      // the above slice's bottom row
      const int32_t* b = own_bottom +
                         static_cast<long long>(row - 1) * a.cols * own.lw +
                         static_cast<long long>(h) * own.lw;
      for (int j = 0; j < own.lw; ++j) own.top[j] = __ldcg(b + j);
      corner = h > 0 ? __ldcg(b - 1) : 0;
    }
    __syncwarp();

    int trial = 63, best = 127;
#pragma unroll 1
    for (int delta = 32;; delta >>= 1) {
      // the body lanes, stateless: bits and the last non-zero position
      int by = 0, last_y = -1, bc = 0, last_c = -1;
      for (int j = nll_y + lane; j < len_y; j += 32) {
        const uint32_t m = quantised_magnitude(
            y[j], min(max(trial - qm_y[j], 0), 119), t);
        by += code_bits_of(m);
        if (m) last_y = j - nll_y;
      }
      for (int j = nll_c + lane; j < len_c; j += 32) {
        const int aq = min(max(trial - qm_c[j], 0), 119);
        const uint32_t mu = quantised_magnitude(u[j], aq, t);
        const uint32_t mv = quantised_magnitude(v[j], aq, t);
        bc += code_bits_of(mu) + code_bits_of(mv);
        if (mu) last_c = 2 * (j - nll_c);
        if (mv) last_c = 2 * (j - nll_c) + 1;
      }
      // the LL recurrences, lanes 0-2
      if (lane < 3)
        ll_pass(own, own_vals, qm_ll, trial, row > 0, h > 0, corner, t,
                nullptr);
      by = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(by)));
      bc = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(bc)));
      last_y = __reduce_max_sync(FULL, last_y);
      last_c = __reduce_max_sync(FULL, last_c);
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
      const int bits = (last_y >= 0 ? gy + by - (body_y - 1 - last_y) : cy) +
                       (last_c >= 0 ? gc + bc - (2 * body_c - 1 - last_c)
                                    : cc);
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
      int32_t* b = own_bottom + static_cast<long long>(row) * a.cols * lw +
                   static_cast<long long>(h) * lw;
      for (int j = 0; j < lw; ++j) b[j] = own.rec[(lh - 1) * lw + j];
      for (int i = 0; i < lh; ++i) own.left[i] = own.rec[i * lw + lw - 1];
      __threadfence();
    }
    __syncwarp();
    if (lane == 0) {
      a.q_out[s] = best;
      store_release(a.progress + row, h + 1);
    }
  }
}

// One component's LL block of H x W cells, in registers: every lane of the
// warp computes it (the same values), so the probe is straight-line code
// that the compiler interleaves with the body sizing.
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

// The rate control for a luma LL block of YH x YW and chroma blocks of
// CH x CW, at most 32 KY luma and 32 KC chroma body lanes a slice: each
// lane holds its share of the body lanes and their quant matrix entries in
// registers, and every probe is one straight-line block. Otherwise as
// ld_rate; the lanes are always staged.
template <int YH, int YW, int CH, int CW, int KY, int KC>
__global__ void __launch_bounds__(32) ld_rate_fixed(RateArgs a) {
  extern __shared__ int32_t smem[];
  __shared__ Tables t;
  constexpr int NY = YH * YW, NC = CH * CW;
  const int lane = threadIdx.x;
  for (int i = lane; i < 120; i += 32) {
    t.factors[i] = QUANT_FACTORS[i];
    t.offsets[i] = QUANT_OFFSETS[i];
    t.recips[i] = QUANT_RECIPROCALS[i];
  }
  int row = 0;
  if (lane == 0) row = atomicAdd(a.ticket, 1);
  row = __shfl_sync(FULL, row, 0);
  const int len_y = a.len[0], len_c = a.len[1];
  const int body_y = len_y - NY, body_c = len_c - NC;
  // this lane's body lanes: NY + lane + 32 k of luma, NC + lane + 32 k of
  // each chroma component, and their quant matrix entries
  int qm_y[KY], qm_c[KC];
#pragma unroll
  for (int k = 0; k < KY; ++k)
    qm_y[k] = NY + lane + 32 * k < len_y ? __ldg(a.qm[0] + NY + lane + 32 * k)
                                         : 0;
#pragma unroll
  for (int k = 0; k < KC; ++k)
    qm_c[k] = NC + lane + 32 * k < len_c ? __ldg(a.qm[1] + NC + lane + 32 * k)
                                         : 0;
  const int qm_ll = __ldg(a.qm[0]);
  const int slice_ints = len_y + 2 * len_c;
  auto prefetch = [&](int h) {   // slice h of the row into buffer h & 1
    const long long s = static_cast<long long>(row) * a.cols + h;
    int32_t* d = smem + (h & 1) * slice_ints;
    for (int j = lane; j < len_y; j += 32)
      copy_async(d + j, a.lanes[0] + s * len_y + j);
    for (int j = lane; j < len_c; j += 32) {
      copy_async(d + len_y + j, a.lanes[1] + s * len_c + j);
      copy_async(d + len_y + len_c + j, a.lanes[2] + s * len_c + j);
    }
    copy_commit();
  };
  prefetch(0);
  __syncwarp();

  FixedLL<YH, YW> ly{};
  FixedLL<CH, CW> lu{}, lv{};
  const long long width_y = static_cast<long long>(a.cols) * YW;
  const long long width_c = static_cast<long long>(a.cols) * CW;
  int next_avail = __ldg(a.avail + static_cast<long long>(row) * a.cols);
  for (int h = 0; h < a.cols; ++h) {
    const long long s = static_cast<long long>(row) * a.cols + h;
    const int avail = next_avail;
    if (h + 1 < a.cols) {
      next_avail = __ldg(a.avail + s + 1);
      prefetch(h + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncwarp();
    const int32_t* y = smem + (h & 1) * slice_ints;
    const int32_t* u = y + len_y;
    const int32_t* v = u + len_c;
#pragma unroll
    for (int k = 0; k < NY; ++k) ly.vals[k] = y[k];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      lu.vals[k] = u[k];
      lv.vals[k] = v[k];
    }
    int32_t bvy[KY], bvu[KC], bvv[KC];
#pragma unroll
    for (int k = 0; k < KY; ++k)
      bvy[k] = NY + lane + 32 * k < len_y ? y[NY + lane + 32 * k] : 0;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool in = NC + lane + 32 * k < len_c;
      bvu[k] = in ? u[NC + lane + 32 * k] : 0;
      bvv[k] = in ? v[NC + lane + 32 * k] : 0;
    }
    const bool up0 = row > 0, left0 = h > 0;
    if (up0) {                      // the above slices' bottom rows
      while (load_acquire(a.progress + row - 1) <= h) {
      }
      const int32_t* by = a.bottom[0] + (row - 1) * width_y + h * YW;
      const int32_t* bu = a.bottom[1] + (row - 1) * width_c + h * CW;
      const int32_t* bv = a.bottom[2] + (row - 1) * width_c + h * CW;
#pragma unroll
      for (int j = 0; j < YW; ++j) ly.top[j] = __ldcg(by + j);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        lu.top[j] = __ldcg(bu + j);
        lv.top[j] = __ldcg(bv + j);
      }
      ly.corner = left0 ? __ldcg(by - 1) : 0;
      lu.corner = left0 ? __ldcg(bu - 1) : 0;
      lv.corner = left0 ? __ldcg(bv - 1) : 0;
    }

    int trial = 63, best = 127;
#pragma unroll 1
    for (int delta = 32;; delta >>= 1) {
      const LLQuant z = ll_quant(trial, qm_ll, t);
      ly.pass(z, up0, left0);
      lu.pass(z, up0, left0);
      lv.pass(z, up0, left0);
      // this lane's body lanes (a lane past the slice's counts nothing)
      int by = 0, last_y = -1, bc = 0, last_c = -1;
#pragma unroll
      for (int k = 0; k < KY; ++k) {
        const bool in = NY + lane + 32 * k < len_y;
        const uint32_t m = quantised_magnitude(
            bvy[k], min(max(trial - qm_y[k], 0), 119), t);
        by += in ? code_bits_of(m) : 0;
        last_y = in && m ? lane + 32 * k : last_y;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const bool in = NC + lane + 32 * k < len_c;
        const int aq = min(max(trial - qm_c[k], 0), 119);
        const uint32_t mu = quantised_magnitude(bvu[k], aq, t);
        const uint32_t mv = quantised_magnitude(bvv[k], aq, t);
        bc += in ? code_bits_of(mu) + code_bits_of(mv) : 0;
        last_c = in && mu ? 2 * (lane + 32 * k) : last_c;
        last_c = in && mv ? 2 * (lane + 32 * k) + 1 : last_c;
      }
      int gy = 0, cy = 0, gc = 0, cc = 0;
#pragma unroll
      for (int k = 0; k < NY; ++k) count_code(ly.code[k], gy, cy);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        count_code(lu.code[k], gc, cc);
        count_code(lv.code[k], gc, cc);
      }
      by = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(by)));
      bc = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(bc)));
      last_y = __reduce_max_sync(FULL, last_y);
      last_c = __reduce_max_sync(FULL, last_c);
      const int bits = (last_y >= 0 ? gy + by - (body_y - 1 - last_y) : cy) +
                       (last_c >= 0 ? gc + bc - (2 * body_c - 1 - last_c)
                                    : cc);
      const bool fits = bits <= avail;
      if (fits && trial < best) best = trial;
      if (delta == 0) break;
      trial += fits ? -delta : delta;
    }

    // the final requantise at best: lane k stores LL code k and bottom-row
    // value k of each component; every lane keeps the right columns
    const LLQuant z = ll_quant(best, qm_ll, t);
    ly.pass(z, up0, left0);
    lu.pass(z, up0, left0);
    lv.pass(z, up0, left0);
#pragma unroll
    for (int k = 0; k < NY; ++k)
      if (lane == k) a.ll_out[0][s * NY + k] = ly.code[k];
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (lane == k) {
        a.ll_out[1][s * NC + k] = lu.code[k];
        a.ll_out[2][s * NC + k] = lv.code[k];
      }
#pragma unroll
    for (int j = 0; j < YW; ++j)
      if (lane == j)
        a.bottom[0][row * width_y + h * YW + j] = ly.rec[(YH - 1) * YW + j];
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (lane == j) {
        a.bottom[1][row * width_c + h * CW + j] = lu.rec[(CH - 1) * CW + j];
        a.bottom[2][row * width_c + h * CW + j] = lv.rec[(CH - 1) * CW + j];
      }
#pragma unroll
    for (int i = 0; i < YH; ++i) ly.left[i] = ly.rec[i * YW + YW - 1];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      lu.left[i] = lu.rec[i * CW + CW - 1];
      lv.left[i] = lv.rec[i * CW + CW - 1];
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      a.q_out[s] = best;
      store_release(a.progress + row, h + 1);
    }
  }
}

// Dynamic shared memory of a CTA: each component's LL code bits,
// reconstructions and borders, and with `staged` the quant matrix entries
// and two slices' lanes.
long long smem_bytes(int ly, int lc, int lyh, int lyw, int lch, int lcw,
                     int staged) {
  const long long ll_ints = 2LL * lyh * lyw + lyh + lyw +
                            2 * (2LL * lch * lcw + lch + lcw);
  return 4 * (ll_ints + (staged ? 3LL * ly + 5LL * lc : 0));
}

// The kernel for these shapes and its dynamic shared memory: a fixed-shape
// kernel where one is compiled for the LL blocks and the body lanes fit
// it, else the generic one.
struct Plan {
  void (*kernel)(RateArgs);
  long long smem;
};

template <int YH, int YW, int CH, int CW, int KY, int KC>
bool fits_fixed(int ly, int lc, int lyh, int lyw, int lch, int lcw) {
  return lyh == YH && lyw == YW && lch == CH && lcw == CW &&
         ly - YH * YW <= 32 * KY && lc - CH * CW <= 32 * KC;
}

Plan plan(int ly, int lc, int lyh, int lyw, int lch, int lcw, int staged) {
  const long long fixed = 8LL * (ly + 2LL * lc);    // two slices' lanes
  if (fits_fixed<2, 2, 2, 1, 2, 1>(ly, lc, lyh, lyw, lch, lcw))
    return {ld_rate_fixed<2, 2, 2, 1, 2, 1>, fixed};   // 4:2:2, -u 2 -a 2
  if (fits_fixed<1, 2, 1, 1, 1, 1>(ly, lc, lyh, lyw, lch, lcw))
    return {ld_rate_fixed<1, 2, 1, 1, 1, 1>, fixed};   // 4:2:2, -u 1 -a 2
  return {ld_rate, smem_bytes(ly, lc, lyh, lyw, lch, lcw, staged)};
}

}  // namespace

// Whether these shapes take a fixed-shape kernel (1) or the generic one (0).
extern "C" int ld_rate_fixed_shape(int ly, int lc, int lyh, int lyw, int lch,
                                   int lcw) {
  return plan(ly, lc, lyh, lyw, lch, lcw, 0).kernel != ld_rate;
}

// The CTAs of the kernel for these shapes that one SM holds at once (each
// CTA is one row of slices), or a negative CUDA error code.
extern "C" int ld_rate_resident(int ly, int lc, int lyh, int lyw, int lch,
                                int lcw, int staged) {
  const Plan p = plan(ly, lc, lyh, lyw, lch, lcw, staged);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, p.kernel, 32, static_cast<size_t>(p.smem));
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// q_out [n] (int32) and the LL lanes ll_* [n, llh * llw] from the transform
// lanes y [n, ly], u and v [n, lc] (int32, contiguous rows, n = rows *
// cols in raster order), the quant matrix entry of each lane qm_y [ly],
// qm_c [lc], the LL blocks (lyh x lyw, lch x lcw) and avail [n]. `staged`
// (rdo/ld.py::staged) keeps the quant matrix entries and a slice's lanes
// in shared memory. `scratch` (int32) holds [ticket, progress [rows], the
// bottom rows: rows * cols * (lyw + 2 lcw)]; the ticket and the progress
// must be zero. Returns the launch's CUDA error code.
extern "C" int ld_rate_launch(const void* y, const void* u, const void* v,
                              int ly, int lc, const void* qm_y,
                              const void* qm_c, int lyh, int lyw, int lch,
                              int lcw, const void* avail, int rows, int cols,
                              int staged, void* q_out, void* ll_y,
                              void* ll_u, void* ll_v, void* scratch,
                              void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const Plan p = plan(ly, lc, lyh, lyw, lch, lcw, staged);
  if (lyh < 1 || lyw < 1 || lch < 1 || lcw < 1 || lyh * lyw > ly ||
      lch * lcw > lc || p.smem > STAGE_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  RateArgs a;
  a.lanes[0] = static_cast<const int32_t*>(y);
  a.lanes[1] = static_cast<const int32_t*>(u);
  a.lanes[2] = static_cast<const int32_t*>(v);
  a.qm[0] = static_cast<const int32_t*>(qm_y);
  a.qm[1] = a.qm[2] = static_cast<const int32_t*>(qm_c);
  a.len[0] = ly;
  a.len[1] = a.len[2] = lc;
  a.llh[0] = lyh;
  a.llw[0] = lyw;
  a.llh[1] = a.llh[2] = lch;
  a.llw[1] = a.llw[2] = lcw;
  a.avail = static_cast<const int32_t*>(avail);
  a.q_out = static_cast<int32_t*>(q_out);
  a.ll_out[0] = static_cast<int32_t*>(ll_y);
  a.ll_out[1] = static_cast<int32_t*>(ll_u);
  a.ll_out[2] = static_cast<int32_t*>(ll_v);
  int* w = static_cast<int*>(scratch);
  a.ticket = w;
  a.progress = w + 1;
  const long long n = static_cast<long long>(rows) * cols;
  a.bottom[0] = w + 1 + rows;
  a.bottom[1] = a.bottom[0] + n * lyw;
  a.bottom[2] = a.bottom[1] + n * lcw;
  a.rows = rows;
  a.cols = cols;
  a.staged = staged;
  p.kernel<<<rows, 32, static_cast<size_t>(p.smem),
             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
