// The band (Mallat) route's levels of the VC-2 integer lifting DWT, for
// sm_90a, over the slices' lanes: the inverse level reads its subbands
// from the lanes and dequantises them as it loads; the forward level
// stores its subbands straight into the lanes. One launch a level for all
// three components of a picture.
//
// Replaces the XLA functions of the JAX package's band route (it has no
// Pallas kernel; vc2tpu/wavelet/pallas_lift.py:29-48 records that on the
// TPU this route beat the in-place Pallas lift):
// - inverse: quant/quantiser.scale_banded -> wavelet/lifting.lanes_to_bands
//   -> lifting.inverse_bands, the decode tail of
//   vc2tpu/pipeline/decoder.py:101-128 (_lanes_words_tail), and the LD
//   tail at :267-276 with the host's LL grid as band 0;
// - forward: lifting.wavelet_pad -> forward_bands -> bands_to_lanes, the
//   analysis of vc2tpu/pipeline/encoder.py:253-258 and pipeline/ld.py:
//   128-133.
//
// Bound on the card: device memory. A level reads each input sample once
// and writes each output sample once; the arithmetic is a few integer
// operations a tap and ~12 a dequantised sample. At 1080p 4:2:2 depth 2 a
// picture's two inverse levels move ~41 MB (16.6 MB of lanes, 16.6 MB of
// plane, 8.3 MB of the coarse level written and read), ~12 us at 3.35 TB/s;
// the forward levels the same.
//
// Design:
// - A level is csrc/lift_level.cu's level (lift_steps.cuh: a region of the
//   level's interleaved plane, output tile plus halo, held in shared
//   memory as four parity planes; the compile-time ladders of the
//   generated lift_ladders.h) with other loads and stores. Parity plane
//   (a, b) of a level is its band 2a + b: LL, HL, LH, HH.
// - Band sample (i, j) of a level whose bands' slice sub-blocks are
//   bh x bw lives in slice (i / bh, j / bw), at lane
//   off_band + (i % bh) * bw + j % bw. bh and bw are not powers of two in
//   general (a 4:2:2 chroma slice at 1080p is 8 x 4; -u 1 -a 2 makes
//   others), so a CTA first divides once for each band row and column of
//   its region into shared tables (a row's lane and slice offset, a
//   column's), and a sample's lane is then two table reads and an add.
// - Inverse: a sample is dequantised in the load at
//   clamp(q[slice] - qm[band], 0, 119) with the factor and offset tables
//   in constant memory (_scale_core's int32 wrap and truncating /4 in
//   uint32_t). LL comes from band 0 of the lanes at the coarsest level,
//   or from a compact plane: the host's LL grid (LD) or the previous
//   level's result. The vertical ladder, the horizontal ladder and the
//   rounded unshift follow, as inverse_bands runs them; the level's result
//   is written compact: the next level's LL, at the finest level the
//   padded plane.
// - Forward: the first level reads the uploaded samples (int16 or int32)
//   with clamped indices, which is wavelet_pad's edge replication; a later
//   level reads the previous level's compact LL. Then << TRANSFORM_SHIFT,
//   the horizontal ladder and the vertical ladder. HL, LH and HH go
//   straight to their lanes, LL to the lanes at the coarsest level and to
//   a compact plane, the next level's input, before it.
// - Lanes are read and written 4 bytes at a time: a band row's samples
//   are contiguous for bw lanes, then jump a slice. A thread issues the
//   loads of BATCH positions before it uses any of them.
//
// Edges: as lift_level.cu, a tap's source clamps to [0, n - 1] of its
// parity plane, which is the band.

#include <cstdint>
#include <cuda_runtime.h>

#include "lift_steps.cuh"
#include "lift_ladders.h"
#include "band_lift_params.h"

namespace {

constexpr int MAX_PLANES = 3;  // a picture's components
constexpr int MIN_CTAS = 4;    // CTAs an SM holds at once: <= 64 registers
constexpr int BATCH = 4;       // samples whose loads a thread issues at once
constexpr int MAX_Q = 119;

__constant__ int32_t QUANT_FACTORS[120] = {VC2_QUANT_FACTORS};
__constant__ int32_t QUANT_OFFSETS[120] = {VC2_QUANT_OFFSETS};

}  // namespace

// Mirror of bands._BandPlane: one component of a level.
struct BandPlane {
  int32_t* lanes;         // [N, L] lanes: read (inverse), written (forward)
  const int32_t* ll;      // inverse: the compact LL, or null: band 0 of lanes
  int32_t* dst;           // inverse: the compact (h, w) result; forward: the
                          // compact LL, or null: LL into the lanes
  const void* src;        // forward: the level's input
  long long src_ld;       // forward: elements between the input's rows
  int src_h, src_w;       // forward: the input's size; past it, its last
                          // row and column repeat (wavelet_pad)
  int src_bytes;          // forward: 2 (int16) or 4 (int32)
  int h, w;               // the level's interleaved size
  int L, xs;              // lanes a slice, slices across
  int bh, bw;             // a slice's sub-block of each of the level's bands
  int off[4];             // lane offset of the LL, HL, LH, HH sub-blocks
  int qm[4];              // inverse: quant matrix of LL, HL, LH, HH
  int tiles_x, tile0;
};

// Mirror of bands._BandTable.
struct BandTable {
  const int32_t* q;       // inverse: the slices' quant indices [N]
  int n, n_tiles, th, tw, halo;
  BandPlane p[MAX_PLANES];
};

namespace {

template <class L>
struct Inverse;
template <int INV, int TSHIFT, class... S>
struct Inverse<Ladder<INV, TSHIFT, S...>> {
  static constexpr bool value = INV != 0;
};

__device__ __forceinline__ BandPlane cta_plane(const BandTable& t) {
  BandPlane P = t.p[0];
#pragma unroll
  for (int k = 1; k < MAX_PLANES; ++k)
    if (k < t.n && (int)blockIdx.x >= t.p[k].tile0) P = t.p[k];
  return P;
}

// _scale_core at adjusted index clamp(q, 0, 119), in uint32_t: the
// magnitude's product wraps, the offset is added to a positive product,
// and the /4 truncates toward zero.
__device__ __forceinline__ int32_t dequant(int32_t v, int q) {
  const int aq = q < 0 ? 0 : (q > MAX_Q ? MAX_Q : q);
  const uint32_t mag = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  uint32_t p = mag * (uint32_t)QUANT_FACTORS[aq];
  if ((int32_t)p > 0) p += (uint32_t)QUANT_OFFSETS[aq];
  p += 2u;
  const int32_t out = (int32_t)p < 0 ? -(((int32_t)(0u - p)) >> 2)
                                     : ((int32_t)p >> 2);
  return v < 0 ? (int32_t)(0u - (uint32_t)out) : out;
}

// The lane and slice offsets of band rows [i0, i0 + ni) and columns
// [j0, j0 + nj): row k's lanes start at rlane[k] + clane[c] of column c,
// its slice is rslice[k] + cslice[c]. One division a row and a column.
__device__ __forceinline__ void band_tables(const BandPlane& P, int i0,
                                            int ni, int j0, int nj,
                                            int* rlane, int* rslice,
                                            int* clane, int* cslice) {
  for (int k = threadIdx.x; k < ni + nj; k += NT) {
    if (k < ni) {
      const int i = i0 + k, sy = i / P.bh;
      rlane[k] = sy * P.xs * P.L + (i - sy * P.bh) * P.bw;
      rslice[k] = sy * P.xs;
    } else {
      const int c = k - ni, j = j0 + c, sx = j / P.bw;
      clane[c] = sx * P.L + (j - sx * P.bw);
      cslice[c] = sx;
    }
  }
}

// This CTA's plane, tile and region (the tile plus the halo, clipped to
// the level's plane).
struct Tile {
  BandPlane P;
  Region g;
  int ty0, tx0, r0, c0;
  int *rlane, *rslice, *clane, *cslice;
};

__device__ __forceinline__ Tile cta_tile(const BandTable& t) {
  extern __shared__ __align__(16) uint32_t smem[];
  Tile T;
  T.P = cta_plane(t);
  const int tile = (int)blockIdx.x - T.P.tile0;
  const int ty = tile / T.P.tiles_x;
  T.ty0 = ty * t.th;
  T.tx0 = (tile - ty * T.P.tiles_x) * t.tw;
  const int hc = col_halo(t.halo);
  T.r0 = max(0, T.ty0 - t.halo);
  T.c0 = max(0, T.tx0 - hc);
  Region& g = T.g;
  g.base = smem;
  g.rh = t.th + 2 * t.halo;
  g.ldq = (t.tw >> 1) + hc;
  g.lw = 32 - __clz(g.ldq);  // ldq is a power of 2
  g.qsz = (g.rh >> 1) * g.ldq;
  g.nr = min(T.P.h, T.ty0 + t.th + t.halo) - T.r0;
  g.nc = min(T.P.w, T.tx0 + t.tw + hc) - T.c0;
  // the tables follow the four parity planes
  T.rlane = (int*)(smem + 4 * g.qsz);
  T.rslice = T.rlane + (g.rh >> 1);
  T.clane = T.rslice + (g.rh >> 1);
  T.cslice = T.clane + g.ldq;
  return T;
}

template <int INV, int TSHIFT, class... S>
__device__ __forceinline__ void inverse_tile(Ladder<INV, TSHIFT, S...>,
                                             const BandTable& t) {
  const Tile T = cta_tile(t);
  const BandPlane& P = T.P;
  const Region& g = T.g;
  const int nrp = g.nr >> 1, ncp = g.nc >> 1;
  const int i0 = T.r0 >> 1, j0 = T.c0 >> 1;  // the region's first band sample
  band_tables(P, i0, nrp, j0, ncp, T.rlane, T.rslice, T.clane, T.cslice);
  __syncthreads();

  // load: the four bands of the region, the details dequantised; each
  // thread issues the loads of BATCH band samples before it uses any
  const int lp = g.lw - 1;
  const int llw = P.w >> 1;
  const int n = nrp << lp;
  for (int k0 = threadIdx.x; k0 < n; k0 += BATCH * NT) {
    int32_t v[BATCH][4];
    int q[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int k = k0 + u * NT, i = k >> lp, j = k & (g.ldq - 1);
      if (k < n && j < ncp) {
        const int32_t* lane = P.lanes + T.rlane[i] + T.clane[j];
        q[u] = __ldg(t.q + T.rslice[i] + T.cslice[j]);
        v[u][0] = P.ll ? __ldg(P.ll + (long long)(i0 + i) * llw + j0 + j)
                       : __ldg(lane + P.off[0]);
#pragma unroll
        for (int b = 1; b < 4; ++b) v[u][b] = __ldg(lane + P.off[b]);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int k = k0 + u * NT, i = k >> lp, j = k & (g.ldq - 1);
      if (k < n && j < ncp) {
        const int at = i * g.ldq + j;
        g.q(0, 0)[at] = P.ll ? (uint32_t)v[u][0]
                             : (uint32_t)dequant(v[u][0], q[u] - P.qm[0]);
        g.q(0, 1)[at] = (uint32_t)dequant(v[u][1], q[u] - P.qm[1]);
        g.q(1, 0)[at] = (uint32_t)dequant(v[u][2], q[u] - P.qm[2]);
        g.q(1, 1)[at] = (uint32_t)dequant(v[u][3], q[u] - P.qm[3]);
      }
    }
  }
  __syncthreads();

  cols<S...>(g);
  rows<S...>(g);

  store_tile<TSHIFT>(g, P.dst + (long long)T.ty0 * P.w + T.tx0, P.w,
                     min(t.th, P.h - T.ty0), min(t.tw, P.w - T.tx0),
                     T.ty0 - T.r0, (T.tx0 - T.c0) >> 1);
}

template <int INV, int TSHIFT, class... S>
__device__ __forceinline__ void forward_tile(Ladder<INV, TSHIFT, S...>,
                                             const BandTable& t) {
  const Tile T = cta_tile(t);
  const BandPlane& P = T.P;
  const Region& g = T.g;

  // load: the level's input with clamped indices, << TRANSFORM_SHIFT; a
  // thread takes a pair of columns (even, odd: one word of each parity
  // plane) and issues the loads of BATCH pairs before it stores any
  const int lp = g.lw - 1;
  const int n = g.rh << lp;
  for (int k0 = threadIdx.x; k0 < n; k0 += BATCH * NT) {
    int32_t v[BATCH][2];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int k = k0 + u * NT, r = k >> lp, c = 2 * (k & (g.ldq - 1));
      if (k < n && r < g.nr && c < g.nc) {
        const long long row =
            (long long)min(T.r0 + r, P.src_h - 1) * P.src_ld;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const long long at = row + min(T.c0 + c + x, P.src_w - 1);
          v[u][x] = P.src_bytes == 2
                        ? (int32_t)__ldg((const int16_t*)P.src + at)
                        : __ldg((const int32_t*)P.src + at);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int k = k0 + u * NT, r = k >> lp, c = 2 * (k & (g.ldq - 1));
      if (k < n && r < g.nr && c < g.nc) {
        const int at = (r >> 1) * g.ldq + (c >> 1);
        g.q(r & 1, 0)[at] = (uint32_t)v[u][0] << TSHIFT;
        g.q(r & 1, 1)[at] = (uint32_t)v[u][1] << TSHIFT;
      }
    }
  }
  __syncthreads();

  rows<S...>(g);
  cols<S...>(g);

  // store: the tile's band samples to their lanes (LL to the compact
  // plane before the coarsest level)
  const int ni = min(t.th, P.h - T.ty0) >> 1;
  const int nj = min(t.tw, P.w - T.tx0) >> 1;
  const int i0 = T.ty0 >> 1, j0 = T.tx0 >> 1;
  band_tables(P, i0, ni, j0, nj, T.rlane, T.rslice, T.clane, T.cslice);
  __syncthreads();
  const int li0 = (T.ty0 - T.r0) >> 1, lj0 = (T.tx0 - T.c0) >> 1;
  const int llw = P.w >> 1;
  for (int k = threadIdx.x; k < (ni << lp); k += NT) {
    const int i = k >> lp, j = k & (g.ldq - 1);
    if (j >= nj) continue;
    int32_t* lane = P.lanes + T.rlane[i] + T.clane[j];
    const int at = (li0 + i) * g.ldq + lj0 + j;
    lane[P.off[1]] = (int32_t)g.q(0, 1)[at];
    lane[P.off[2]] = (int32_t)g.q(1, 0)[at];
    lane[P.off[3]] = (int32_t)g.q(1, 1)[at];
    if (P.dst)
      P.dst[(long long)(i0 + i) * llw + j0 + j] = (int32_t)g.q(0, 0)[at];
    else
      lane[P.off[0]] = (int32_t)g.q(0, 0)[at];
  }
}

template <class L>
__global__ void __launch_bounds__(NT, MIN_CTAS)
band_level_kernel(const __grid_constant__ BandTable t) {
  if constexpr (Inverse<L>::value)
    inverse_tile(L{}, t);
  else
    forward_tile(L{}, t);
}

template <class L>
int launch(const BandTable& t, cudaStream_t stream) {
  const int rh = t.th + 2 * t.halo, ldq = (t.tw >> 1) + col_halo(t.halo);
  // four parity planes of (rh / 2) x ldq words, then the tables
  const size_t smem = sizeof(uint32_t) * ((size_t)2 * rh * ldq + rh + 2 * ldq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_level_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  band_level_kernel<L><<<t.n_tiles, NT, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

bool valid(const BandTable* t) {
  const int rw = t->tw + 2 * col_halo(t->halo);
  return t->n >= 1 && t->n <= MAX_PLANES && t->n_tiles >= 1 &&
         !(t->th & 1) && !(t->tw & 7) && !(t->halo & 1) && rw >= 8 &&
         rw <= NT && !(rw & (rw - 1));
}

template <bool INV>
int launch_level(const BandTable* t, int kernel, void* stream) {
  if (!valid(t)) return (int)cudaErrorInvalidValue;
  return with_ladder(kernel, INV ? 1 : 0, [&](auto ladder) -> int {
    using L = decltype(ladder);
    if constexpr (Inverse<L>::value == INV)
      return launch<L>(*t, (cudaStream_t)stream);
    else
      return (int)cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" int band_inverse_launch(const BandTable* t, int kernel,
                                   void* stream) {
  return launch_level<true>(t, kernel, stream);
}

extern "C" int band_forward_launch(const BandTable* t, int kernel,
                                   void* stream) {
  return launch_level<false>(t, kernel, stream);
}
