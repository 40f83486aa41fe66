// One 2-D integer lifting level of a VC-2 wavelet, in place-layout
// (interleaved even/odd samples), for up to three planes in one launch,
// for sm_90a.
//
// Replaces: vc2tpu/wavelet/pallas_lift.py::lift_level (the Pallas kernel,
// pl.pallas_call in _build), which computes vc2tpu.wavelet.lifting.lift_level.
// Forward: << TRANSFORM_SHIFT, the horizontal ladder, then the vertical
// ladder. Inverse: the vertical ladder, the horizontal ladder, then the
// rounded unshift. Each wavelet's ladder is a compile-time type from the
// generated lift_ladders.h (written from lifting._STEPS at build time), so
// steps, taps, coefficients and rounding are constants and the tap loops
// unroll.
//
// Bound on the card: device memory. Each level reads and writes its
// samples once (8 bytes a sample); the arithmetic is a few integer
// operations a tap. At 1080p 4:2:2 a picture's two levels move ~41 MB,
// ~12 us at 3.35 TB/s.
//
// Design:
// - One grid over the tiles of all the planes of a level (a plane table
//   passed by value); a CTA finds its plane and tile with one division.
// - A level at stride s reads its input in place from the plane's
//   x[::s, ::s] sub-lattice, and the (even, even) samples from the coarser
//   level's compact result (the overlay) when there is one. It writes a
//   compact plane, so no CTA writes where a neighbour still reads its halo,
//   and the level needs no sub-lattice copy or scatter.
// - The CTA loads its output tile plus a halo (lifting.halo rows,
//   col_halo columns: rounded up to 4 so a region starts 16-byte aligned)
//   into shared memory split by parity: four planes q[row parity][column
//   parity]. A horizontal tap then reads consecutive words of one parity
//   plane along a row, a vertical tap consecutive words of a row of
//   another: unit-stride and free of bank conflicts.
// - A CTA's 256 threads walk the region's index space with strides; a
//   region is 2^k columns wide, so a thread's row and column follow from
//   its index by shifts and masks: no per-element division. A horizontal
//   step keeps a thread on one column (its clamped tap indices computed
//   once); a vertical step gives a thread a run of rows and keeps the
//   taps' sources in a sliding register window: one shared load an output.
// - Global loads are 16-byte (4 samples at stride 1, one even/odd pair of
//   the stride-2 sub-lattice), issued BATCH at a time before any is used;
//   stores are 16-byte; other strides and unaligned widths take 4-byte
//   accesses.
// - Regions are large (up to 64 x 256 samples, dynamic shared memory
//   above 48 KB) to cut the halo's re-reads, and a multiple of 64 columns
//   wide, so a warp's loads and taps along a row fill its 32 lanes; the
//   wrapper picks the region so the grid still fills the card.
//
// Edges: a tap's source index clamps per parity. Tiles and halos are even,
// so a region's parity indices are [0, n/2 - 1] in local coordinates, and
// clamping there equals the global clamp wherever the region touches the
// picture edge; elsewhere the clamp only touches halo samples that the
// halo keeps away from the tile.
//
// Integers: XLA int32 wraps, C++ signed overflow does not, so products and
// sums are formed in uint32_t and only the rounding shift is applied to the
// signed value (arithmetic >>). The region, the steps and the store are
// csrc/lift_steps.cuh's, shared with the band-layout levels.

#include <cstdint>
#include <cuda_runtime.h>

#include "lift_steps.cuh"
#include "lift_ladders.h"

namespace {

constexpr int FEW_PLANES = 3;   // one picture's planes: a table selected unrolled
constexpr int MAX_PLANES = 48;  // a launch's planes: the kernel parameter stays < 4 KB
constexpr int BATCH = 4;     // global loads a thread issues before it waits
constexpr int MIN_CTAS = 6;  // CTAs an SM holds at once: <= 40 registers

}  // namespace

// Mirror of lifting._LiftPlane: one plane of a level.
struct LiftPlane {
  const int32_t* src;      // the whole plane
  const int32_t* overlay;  // compact (h/2, w/2) even-even samples, or null
  int32_t* dst;            // compact (h, w) result
  long long src_ld;        // elements between the level's rows
  int src_step;            // elements between the level's columns
  int h, w;                // the level's size
  int tiles_x;
  int tile0;               // first tile of this plane in the grid
};

// Mirror of lifting._LiftTable (N = MAX_PLANES). A launch of at most
// FEW_PLANES planes passes the short table, so one picture's kernel
// parameter stays as small as its select.
template <int N>
struct LiftTable {
  int n, n_tiles, th, tw, halo;
  LiftPlane p[N];
};

namespace {

// This CTA's plane: the last whose first tile is at or before the CTA,
// unrolled over a short table, a binary search of a long one in parameter
// space.
template <int N>
__device__ __forceinline__ LiftPlane cta_plane(const LiftTable<N>& t) {
  if constexpr (N <= FEW_PLANES) {
    LiftPlane P = t.p[0];
#pragma unroll
    for (int k = 1; k < N; ++k)
      if (k < t.n && (int)blockIdx.x >= t.p[k].tile0) P = t.p[k];
    return P;
  } else {
    int lo = 0, hi = t.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if ((int)blockIdx.x >= t.p[mid].tile0) lo = mid; else hi = mid - 1;
    }
    return t.p[lo];
  }
}

template <int INV, int TSHIFT, class... S, int N>
__device__ __forceinline__ void lift_tile(Ladder<INV, TSHIFT, S...>,
                                          const LiftTable<N>& t) {
  extern __shared__ __align__(16) uint32_t smem[];

  // this CTA's plane and tile
  const LiftPlane P = cta_plane(t);
  const int tile = (int)blockIdx.x - P.tile0;
  const int ty = tile / P.tiles_x;
  const int ty0 = ty * t.th;
  const int tx0 = (tile - ty * P.tiles_x) * t.tw;

  const int hc = col_halo(t.halo);
  const int r0 = max(0, ty0 - t.halo), r1 = min(P.h, ty0 + t.th + t.halo);
  const int c0 = max(0, tx0 - hc), c1 = min(P.w, tx0 + t.tw + hc);
  Region g;
  g.base = smem;
  g.rh = t.th + 2 * t.halo;
  g.ldq = (t.tw >> 1) + hc;
  g.lw = 32 - __clz(g.ldq);  // ldq is a power of 2
  g.pitch = g.ldq;
  g.qsz = (g.rh >> 1) * g.ldq;
  g.nr = r1 - r0;
  g.nc = c1 - c0;
  const int ncp = g.nc >> 1;
  const int lp = g.lw - 1, lv = g.lw - 2;  // log2 pairs, quads in a row
  const int pre = INV ? 0 : TSHIFT;
  const bool ovl = P.overlay != nullptr;

  // load: the sub-lattice's samples, deinterleaved into the parity planes;
  // the even-even plane from the overlay when there is one. Each thread
  // issues BATCH 16-byte loads before it stores any of them.
  const int32_t* src = P.src + (long long)r0 * P.src_ld
                       + (long long)c0 * P.src_step;
  const bool vec = aligned16(P.src) && (P.src_ld & 3) == 0;
  if (vec && ((P.src_step == 1 && (P.w & 3) == 0) || P.src_step == 2)) {
    // stride 1: a load is 4 samples (two pairs); stride 2: one pair
    const int l = P.src_step == 1 ? lv : lp;
    const int nx = P.src_step == 1 ? g.nc >> 2 : ncp;
    for (int k0 = threadIdx.x; k0 < (g.rh << l); k0 += BATCH * NT) {
      int4 x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int k = k0 + u * NT, r = k >> l, v = k & ((1 << l) - 1);
        if (r < g.nr && v < nx)
          x[u] = __ldg((const int4*)(src + r * P.src_ld) + v);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int k = k0 + u * NT, r = k >> l, v = k & ((1 << l) - 1);
        if (r < g.nr && v < nx) {
          const int off = (r >> 1) * g.ldq;
          uint32_t* e = g.q(r & 1, 0) + off;
          uint32_t* o = g.q(r & 1, 1) + off;
          const bool keep_e = !(ovl && (r & 1) == 0);
          if (P.src_step == 1) {
            if (keep_e)
              *(uint2*)(e + 2 * v) = make_uint2((uint32_t)x[u].x << pre,
                                                (uint32_t)x[u].z << pre);
            *(uint2*)(o + 2 * v) = make_uint2((uint32_t)x[u].y << pre,
                                              (uint32_t)x[u].w << pre);
          } else {
            if (keep_e) e[v] = (uint32_t)x[u].x << pre;
            o[v] = (uint32_t)x[u].z << pre;
          }
        }
      }
    }
  } else {
    const long long st = P.src_step;
    for (int k = threadIdx.x; k < (g.rh << lp); k += NT) {
      const int r = k >> lp, j = k & (g.ldq - 1);
      if (r < g.nr && j < ncp) {
        const int32_t* row = src + r * P.src_ld;
        const int off = (r >> 1) * g.ldq;
        if (!(ovl && (r & 1) == 0))
          g.q(r & 1, 0)[off + j] = (uint32_t)__ldg(row + 2 * j * st) << pre;
        g.q(r & 1, 1)[off + j] = (uint32_t)__ldg(row + (2 * j + 1) * st)
                                 << pre;
      }
    }
  }
  if (ovl) {
    const int old = P.w >> 1;
    const int32_t* osrc = P.overlay + (long long)(r0 >> 1) * old + (c0 >> 1);
    uint32_t* e = g.q(0, 0);
    if ((old & 1) == 0 && (ncp & 1) == 0 && ((uintptr_t)P.overlay & 7) == 0) {
      for (int k = threadIdx.x; k < ((g.rh >> 1) << lv); k += NT) {
        const int i = k >> lv, v = k & ((1 << lv) - 1);
        if (i < (g.nr >> 1) && v < (ncp >> 1)) {
          const int2 x = __ldg((const int2*)(osrc + (long long)i * old) + v);
          *(uint2*)(e + i * g.ldq + 2 * v) =
              make_uint2((uint32_t)x.x << pre, (uint32_t)x.y << pre);
        }
      }
    } else {
      for (int k = threadIdx.x; k < ((g.rh >> 1) << lp); k += NT) {
        const int i = k >> lp, j = k & (g.ldq - 1);
        if (i < (g.nr >> 1) && j < ncp)
          e[i * g.ldq + j] = (uint32_t)__ldg(osrc + (long long)i * old + j)
                             << pre;
      }
    }
  }
  __syncthreads();

  if constexpr (INV) {
    cols<S...>(g);
    rows<S...>(g);
  } else {
    rows<S...>(g);
    cols<S...>(g);
  }

  // store the tile: interleave the parity planes back, unshift if inverse
  store_tile<INV ? TSHIFT : 0>(g, P.dst + (long long)ty0 * P.w + tx0, P.w,
                               min(t.th, P.h - ty0), min(t.tw, P.w - tx0),
                               ty0 - r0, (tx0 - c0) >> 1);
}

template <class L, int N>
__global__ void __launch_bounds__(NT, MIN_CTAS)
lift_level_kernel(const __grid_constant__ LiftTable<N> t) {
  lift_tile(L{}, t);
}

template <class L, int N>
int launch(const LiftTable<N>& t, cudaStream_t stream) {
  const size_t smem = (size_t)(t.th + 2 * t.halo) *
                      (t.tw + 2 * col_halo(t.halo)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lift_level_kernel<L, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lift_level_kernel<L, N><<<t.n_tiles, NT, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lift_level_launch(const LiftTable<MAX_PLANES>* t, int kernel,
                                 int invert, void* stream) {
  const int rw = t->tw + 2 * col_halo(t->halo);
  if (t->n < 1 || t->n > MAX_PLANES || t->n_tiles < 1 || (t->th & 1) ||
      (t->tw & 7) || (t->halo & 1) || rw < 8 || rw > NT || (rw & (rw - 1)))
    return (int)cudaErrorInvalidValue;
  if (t->n <= FEW_PLANES) {
    LiftTable<FEW_PLANES> few{t->n, t->n_tiles, t->th, t->tw, t->halo, {}};
    for (int k = 0; k < t->n; ++k) few.p[k] = t->p[k];
    return with_ladder(kernel, invert, [&](auto ladder) {
      return launch<decltype(ladder)>(few, (cudaStream_t)stream);
    });
  }
  return with_ladder(kernel, invert, [&](auto ladder) {
    return launch<decltype(ladder)>(*t, (cudaStream_t)stream);
  });
}
