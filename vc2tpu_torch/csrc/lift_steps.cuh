// The lifting ladders' machinery shared by csrc/lift_level.cu (the
// in-place level) and csrc/band_lift.cu (the band-layout levels): a
// region of a level's interleaved plane held in shared memory as four
// parity planes, the horizontal and vertical steps of a compile-time
// ladder over it, and the store of a tile of the interleaved result. The
// ladders themselves come from the generated lift_ladders.h, which a
// source includes after this header.
//
// Integers: XLA int32 wraps, C++ signed overflow does not, so products and
// sums are formed in uint32_t and only the rounding shift is applied to the
// signed value (arithmetic >>).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int PT, int SIGN, int ADD, int SHIFT, int... OFF_COEFF>
struct Step {};

template <int INV, int TSHIFT, class... STEPS>
struct Ladder {};

namespace {

constexpr int LOG_NT = 8;
constexpr int NT = 1 << LOG_NT;  // threads of a CTA

__host__ __device__ constexpr int col_halo(int h) { return (h + 3) & ~3; }

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// A step's taps as compile-time (offset, coefficient) pairs.
template <int... OC>
struct Taps {
  static constexpr int n = sizeof...(OC) / 2;
  __host__ __device__ static constexpr int at(int k) {
    constexpr int a[] = {OC...};
    return a[k];
  }
  __host__ __device__ static constexpr int off(int t) { return at(2 * t); }
  __host__ __device__ static constexpr int coeff(int t) {
    return at(2 * t + 1);
  }
  __host__ __device__ static constexpr int lo() {
    int m = off(0);
    for (int t = 1; t < n; ++t) m = off(t) < m ? off(t) : m;
    return m;
  }
  __host__ __device__ static constexpr int hi() {
    int m = off(0);
    for (int t = 1; t < n; ++t) m = off(t) > m ? off(t) : m;
    return m;
  }
};

template <int SIGN, int ADD, int SHIFT>
__device__ __forceinline__ uint32_t update(uint32_t v, uint32_t acc) {
  // JAX: delta = (acc + add) >> shift if shift else acc
  uint32_t d = acc;
  if constexpr (SHIFT != 0)
    d = (uint32_t)(((int32_t)(acc + (uint32_t)ADD)) >> SHIFT);
  return SIGN > 0 ? v + d : v - d;
}

// The region in shared memory: parity plane (a, b) holds local sample
// (2i + a, 2j + b) at q(a, b)[i * pitch + j]. The full region is rh rows
// by 2^lw columns (ldq = 2^(lw - 1) <= NT / 2); this CTA's is nr x nc,
// clipped to the plane. A thread's place in it follows from its index by
// shifts and masks. A plane's rows are pitch >= ldq words apart (even),
// its planes qsz words.
struct Region {
  uint32_t* base;
  int qsz, ldq, lw, rh, nr, nc, pitch;
  __device__ uint32_t* q(int a, int b) const {
    return base + (2 * a + b) * qsz;
  }
};

// Horizontal step: the target-parity columns of every row. A thread keeps
// one column j (its taps' clamped indices computed once) and one row
// parity, and walks the rows NT / ldq apart.
template <int PT, int SIGN, int ADD, int SHIFT, int... OC>
__device__ __forceinline__ void row_step(const Region& g,
                                         Step<PT, SIGN, ADD, SHIFT, OC...>) {
  using T = Taps<OC...>;
  const int np = g.nc >> 1, lp = g.lw - 1;
  const int j = threadIdx.x & (g.ldq - 1);
  if (j >= np) return;
  int idx[T::n];
#pragma unroll
  for (int t = 0; t < T::n; ++t) idx[t] = clampi(j + T::off(t), np - 1);
  int r = threadIdx.x >> lp;
  const int rstep = NT >> lp;  // even: the row parity stays
  const int pstep = (rstep >> 1) * g.pitch;
  const uint32_t* src = g.q(r & 1, 1 - PT) + (r >> 1) * g.pitch;
  uint32_t* dst = g.q(r & 1, PT) + (r >> 1) * g.pitch + j;
  for (; r < g.nr; r += rstep, src += pstep, dst += pstep) {
    uint32_t acc = 0;
#pragma unroll
    for (int t = 0; t < T::n; ++t) acc += (uint32_t)T::coeff(t) * src[idx[t]];
    *dst = update<SIGN, ADD, SHIFT>(*dst, acc);
  }
}

// Vertical step: the target-parity rows of every column. NT / 2^lw threads
// share a column (j, parity b), each walking a run of consecutive rows
// with the taps' source values in a sliding register window: one shared
// load per output.
template <int PT, int SIGN, int ADD, int SHIFT, int... OC>
__device__ __forceinline__ void col_step(const Region& g,
                                         Step<PT, SIGN, ADD, SHIFT, OC...>) {
  using T = Taps<OC...>;
  constexpr int LO = T::lo(), SPAN = T::hi() - T::lo() + 1;
  const int np = g.nr >> 1, ncp = g.nc >> 1, lp = g.lw - 1;
  const int j = threadIdx.x & (g.ldq - 1), b = (threadIdx.x >> lp) & 1;
  if (j >= ncp) return;
  const int lper = LOG_NT - g.lw;  // log2 of the threads on a column
  const int run = (np + (1 << lper) - 1) >> lper;
  int i = (threadIdx.x >> g.lw) * run;
  const int i1 = min(np, i + run);
  const int ld = g.pitch;
  const uint32_t* src = g.q(1 - PT, b) + j;
  uint32_t* dst = g.q(PT, b) + j;
  uint32_t w[SPAN];
#pragma unroll
  for (int k = 1; k < SPAN; ++k)
    w[k] = src[clampi(i + LO + k - 1, np - 1) * ld];
  for (; i < i1; ++i) {
#pragma unroll
    for (int k = 0; k + 1 < SPAN; ++k) w[k] = w[k + 1];
    w[SPAN - 1] = src[clampi(i + LO + SPAN - 1, np - 1) * ld];
    uint32_t acc = 0;
#pragma unroll
    for (int t = 0; t < T::n; ++t)
      acc += (uint32_t)T::coeff(t) * w[T::off(t) - LO];
    dst[i * ld] = update<SIGN, ADD, SHIFT>(dst[i * ld], acc);
  }
}

template <class... S>
__device__ __forceinline__ void rows(const Region& g) {
  ((row_step(g, S{}), __syncthreads()), ...);
}

template <class... S>
__device__ __forceinline__ void cols(const Region& g) {
  ((col_step(g, S{}), __syncthreads()), ...);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Store a tile of the level's interleaved result: rows [lr0, lr0 + th)
// and parity columns [lq0, lq0 + tw / 2) of the region, each sample
// rounded and shifted down by POST (the inverse's unshift; 0 forward), to
// dst (the tile's first sample) with rows w apart. 16-byte stores where
// the rows allow.
template <int POST>
__device__ __forceinline__ void store_tile(const Region& g, int32_t* dst,
                                           int w, int th, int tw, int lr0,
                                           int lq0) {
  constexpr uint32_t rnd = POST ? (1u << (POST > 0 ? POST - 1 : 0)) : 0u;
  const int lp = g.lw - 1, lv = g.lw - 2;
  if ((w & 3) == 0 && aligned16(dst)) {
    for (int k = threadIdx.x; k < (th << lv); k += NT) {
      const int r = k >> lv, v = k & ((1 << lv) - 1);
      if (v < (tw >> 2)) {
        const int lr = lr0 + r, off = (lr >> 1) * g.pitch + lq0 + 2 * v;
        const uint2 a = *(const uint2*)(g.q(lr & 1, 0) + off);
        const uint2 b = *(const uint2*)(g.q(lr & 1, 1) + off);
        *((int4*)(dst + (long long)r * w) + v) =
            make_int4(((int32_t)(a.x + rnd)) >> POST,
                      ((int32_t)(b.x + rnd)) >> POST,
                      ((int32_t)(a.y + rnd)) >> POST,
                      ((int32_t)(b.y + rnd)) >> POST);
      }
    }
  } else {
    for (int k = threadIdx.x; k < (th << lp); k += NT) {
      const int r = k >> lp, j = k & (g.ldq - 1);
      if (j < (tw >> 1)) {
        const int lr = lr0 + r, off = (lr >> 1) * g.pitch + lq0 + j;
        int32_t* out = dst + (long long)r * w + 2 * j;
        out[0] = ((int32_t)(g.q(lr & 1, 0)[off] + rnd)) >> POST;
        out[1] = ((int32_t)(g.q(lr & 1, 1)[off] + rnd)) >> POST;
      }
    }
  }
}

}  // namespace
