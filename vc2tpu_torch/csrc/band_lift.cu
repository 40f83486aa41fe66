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
// picture's two inverse levels move 41.6 MB (the lanes, the q indices,
// the plane, the coarse level written and read again), 12.4 us at
// 3.35 TB/s; the two forward levels 33.2 MB (int16 samples), 9.9 us.
//
// Layout. Band sample (i, j) of a level whose bands' slice sub-blocks are
// bh x bw lives in slice (i / bh, j / bw), at lane
// off_band + (i % bh) * bw + j % bw. A level's bands are one contiguous
// run of lanes in every slice, [run0, run0 + R): HL, LH, HH (and LL first
// at the coarsest level when it comes from the lanes), each a row-major
// bh x bw sub-block. The run map (bands.run_map, built once a level and
// component by the host and kept on the card) gives each lane of the run
// its parity plane, row and column in the sub-block.
//
// Design, against what held the first form back:
// 1. Lanes move slice-major in whole runs (the first form touched bw
//    lanes, 4-16 bytes, of each 32-byte sector). The inverse copies each
//    slice's run straight into the parity planes with cp.async, all of a
//    tile's copies in flight at once: consecutive threads take
//    consecutive units of the run (16-byte quads where a sub-block row is
//    a multiple of 4 lanes wide; 8-byte pairs where it is even; lanes
//    otherwise), each placed through the run map; a unit none of whose
//    lanes is in the region (a halo slice's other rows) is not copied.
//    The forward gathers each quad of lanes from the planes through the
//    map (8-byte reads of pairs where bw is even) and stores it in 16
//    bytes. A plane's rows are PITCH_PAD words longer than the region and
//    its planes PLANE_PAD words apart, so the run-ordered shared accesses
//    of a warp spread over the banks; the inverse shifts the region's
//    columns so that a sub-block row is 16-byte aligned in shared memory
//    wherever it is in the lanes. bands.tile_shape makes tiles whole
//    slices where the geometry allows (at 1080p the finest level's 60-row
//    tile becomes 56); where it cannot, the edge slices' lanes are masked.
// 2. Dequantisation a (slice, band), without constant memory: each slice
//    of the window has its q index copied once; after the copies land one
//    pass over the region's band positions (consecutive threads on
//    consecutive pairs of columns) dequantises them in place, the factor
//    and offset of clamp(q - qm[band]) from a shared copy of the 120-entry
//    tables. The int32 wrap of _scale_core and its truncating /4 are kept
//    (dequant below).
// 3. A grid sized to the card: as many CTAs as the card holds at once
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs), at
//    most one a tile, each walking the tiles gridDim.x apart (Walk: the
//    work items' slice and unit without a division each). A CTA's shared
//    memory is one region and small tables, so MIN_CTAS of them fit an
//    SM; a second buffer for the next tile's copies (three CTAs an SM)
//    and fewer, larger or smaller tiles all measured slower at 1080p.
// 4. The forward's input is read in 16-byte chunks (8 int16 or 4 int32
//    samples) aligned in the row, BATCH chunks in flight a thread, and
//    stored two pairs at a time; only a chunk that reaches past the last
//    column (which wavelet_pad repeats) takes the clamped path.
// 5. Halo: a region is the tile plus the ladders' halo (lifting.halo);
//    a halo slice contributes only the units that hold region samples.
//
// A level is otherwise csrc/lift_level.cu's (lift_steps.cuh: the region
// held in shared memory as four parity planes, the compile-time ladders
// of lift_ladders.h). Parity plane (a, b) of a level is its band 2a + b:
// LL, HL, LH, HH. Inverse: the vertical ladder, the horizontal ladder and
// the rounded unshift, as inverse_bands runs them; LL comes from the lanes
// at the coarsest level, else from a compact plane (the host's LL grid,
// LD, or the coarser level's result); the result is written compact.
// Forward: << TRANSFORM_SHIFT, the horizontal ladder and the vertical
// ladder; LL goes to the lanes at the coarsest level and to a compact
// plane, the next level's input, before it.
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
constexpr int MIN_CTAS = 5;    // CTAs an SM holds at once: <= 48 registers
constexpr int BATCH = 2;       // input chunks whose loads a thread issues
constexpr int MAX_Q = 119;
constexpr int N_Q = MAX_Q + 1;
constexpr uint32_t MAP_FIELD = 0x7fff;  // a run map entry's row and column
// Padding around the parity planes, in words: beyond each row (at least
// 3, for the lanes of a unit that fall outside the region) and before and
// between the planes (at least 2, for the inverse's column shift); 8 each
// spreads a warp's run-ordered accesses over more banks.
constexpr int PITCH_PAD = 8;
constexpr int PLANE_PAD = 8;

__device__ const int32_t QUANT_FACTORS[N_Q] = {VC2_QUANT_FACTORS};
__device__ const int32_t QUANT_OFFSETS[N_Q] = {VC2_QUANT_OFFSETS};

}  // namespace

// Mirror of bands._BandPlane: one component of a level.
struct BandPlane {
  int32_t* lanes;         // [N, L] lanes: read (inverse), written (forward)
  const uint32_t* map;    // the run map: (plane << 30 | row << 15 | column)
                          // of each lane of the run, padded to whole quads
  const int32_t* ll;      // inverse: the compact LL, or null: LL in the run
  int32_t* dst;           // inverse: the compact (h, w) result; forward: the
                          // compact LL, or null: LL in the run
  const void* src;        // forward: the level's input
  long long src_ld;       // forward: elements between the input's rows
  int src_h, src_w;       // forward: the input's size; past it, its last
                          // row and column repeat (wavelet_pad)
  int src_bytes;          // forward: 2 (int16) or 4 (int32)
  int h, w;               // the level's interleaved size
  int L, xs;              // lanes a slice, slices across
  int bh, bw;             // a slice's sub-block of each of the level's bands
  int run0, R;            // the level's run: lanes [run0, run0 + R)
  int qm[4];              // inverse: quant matrix of LL, HL, LH, HH
  int tiles_x, tile0;
};

// Mirror of bands._BandTable.
struct BandTable {
  const int32_t* q;       // inverse: the slices' quant indices [N]
  int n, n_tiles, th, tw;
  int rw;                 // the region's columns in shared memory, 2^k
  int halo;
  int max_slices;         // inverse: slices a region touches, at most
  BandPlane p[MAX_PLANES];
};

namespace {

template <class L>
struct Inverse;
template <int INV, int TSHIFT, class... S>
struct Inverse<Ladder<INV, TSHIFT, S...>> {
  static constexpr bool value = INV != 0;
};

__host__ __device__ inline int region_rows(const BandTable& t) {
  return t.th + 2 * t.halo;
}

__host__ __device__ inline int region_ldq(const BandTable& t) {
  return t.rw >> 1;
}

__host__ __device__ inline int plane_words(const BandTable& t) {
  return (region_rows(t) >> 1) * (region_ldq(t) + PITCH_PAD) + PLANE_PAD;
}

// Shared memory: the region's four parity planes (PLANE_PAD words before
// them, for a tile's column shift), then the inverse's tables: the quant
// factors and offsets, the window slices' q indices, and the region's
// band rows' and columns' window slice.
struct Smem {
  uint32_t* planes;
  int2* fo;               // (factor, offset) of each clamped quant index
  int32_t* sq;            // a window slice's q index
  int* srow;              // a region band row's first window slice
  int* scol;              // a region band column's window slice
};

__host__ __device__ inline int buffer_words(const BandTable& t) {
  return PLANE_PAD + 4 * plane_words(t);
}

__device__ __forceinline__ Smem smem_layout(const BandTable& t,
                                            uint32_t* base) {
  Smem s;
  s.planes = base + PLANE_PAD;
  s.fo = (int2*)(base + buffer_words(t));
  s.sq = (int32_t*)(s.fo + N_Q);
  s.srow = s.sq + t.max_slices;
  s.scol = s.srow + (region_rows(t) >> 1);
  return s;
}

size_t smem_bytes(const BandTable& t, bool inverse) {
  if (!inverse) return sizeof(uint32_t) * buffer_words(t);
  return sizeof(uint32_t) * ((size_t)buffer_words(t) + t.max_slices +
                             (region_rows(t) >> 1) + region_ldq(t)) +
         sizeof(int2) * N_Q;
}

// _scale_core with factor f and offset o, in uint32_t: the magnitude's
// product wraps, the offset is added to a positive product, and the /4
// truncates toward zero.
__device__ __forceinline__ int32_t dequant(int32_t v, int2 fo) {
  const uint32_t mag = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  uint32_t p = mag * (uint32_t)fo.x;
  if ((int32_t)p > 0) p += (uint32_t)fo.y;
  p += 2u;
  const int32_t out = (int32_t)p < 0 ? -(((int32_t)(0u - p)) >> 2)
                                     : ((int32_t)p >> 2);
  return v < 0 ? (int32_t)(0u - (uint32_t)out) : out;
}

// Asynchronous copies to shared memory (cp.async): 16 bytes through L2
// alone, or 8 or 4; all of a thread's copies are in flight until
// copy_wait.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ bool aligned8(const void* p) {
  return ((uintptr_t)p & 7) == 0;
}

// A run map entry's lane, placed: its parity plane k and its position
// (li, lj) in region coordinates, for a slice whose first band sample is
// at (oi, oj) there.
struct Lane {
  int k, li, lj;
};

__device__ __forceinline__ Lane place(uint32_t e, int oi, int oj) {
  Lane l;
  l.k = (int)(e >> 30);
  l.li = oi + (int)((e >> 15) & MAP_FIELD);
  l.lj = oj + (int)(e & MAP_FIELD);
  return l;
}

__device__ __forceinline__ bool inside(const Lane& l, int i0, int ni, int j0,
                                       int nj) {
  return (unsigned)(l.li - i0) < (unsigned)ni &&
         (unsigned)(l.lj - j0) < (unsigned)nj;
}

__device__ __forceinline__ uint32_t* at(const Region& g, const Lane& l) {
  return g.q(l.k >> 1, l.k & 1) + l.li * g.pitch + l.lj;
}

// This tile's plane, tile and region (the tile plus the halo, clipped to
// the level's plane).
struct Tile {
  BandPlane P;
  Region g;
  int ty0, tx0, r0, c0;
};

// The region's columns start `shift` words into the planes' rows: the
// inverse puts its first band column at j0 % 4 (0 or 2), so that a
// sub-block row of a slice starts 16-byte aligned in shared memory
// wherever its lanes do.
__device__ __forceinline__ Tile tile_at(const BandTable& t, int tile,
                                        uint32_t* planes, bool shift) {
  Tile T;
  T.P = t.p[0];
#pragma unroll
  for (int k = 1; k < MAX_PLANES; ++k)
    if (k < t.n && tile >= t.p[k].tile0) T.P = t.p[k];
  tile -= T.P.tile0;
  const int ty = tile / T.P.tiles_x;
  T.ty0 = ty * t.th;
  T.tx0 = (tile - ty * T.P.tiles_x) * t.tw;
  const int hc = col_halo(t.halo);
  T.r0 = max(0, T.ty0 - t.halo);
  T.c0 = max(0, T.tx0 - hc);
  Region& g = T.g;
  g.base = planes + (shift ? (T.c0 >> 1) & 3 : 0);
  g.rh = region_rows(t);
  g.ldq = region_ldq(t);
  g.lw = 32 - __clz(g.ldq);  // ldq is a power of 2
  g.pitch = g.ldq + PITCH_PAD;
  g.qsz = plane_words(t);
  g.nr = min(T.P.h, T.ty0 + t.th + t.halo) - T.r0;
  g.nc = min(T.P.w, T.tx0 + t.tw + hc) - T.c0;
  return T;
}

// The slices that band rows [i0, i0 + ni) and columns [j0, j0 + nj) of P
// touch, row-major: slice s of the window is (sy0 + s / nsx, sx0 +
// s % nsx), and its first band sample lies at (oi, oj) relative to band
// sample (ri, rj), the region's first.
struct Window {
  int sy0, sx0, nsx, ns, ri, rj;
};

__device__ __forceinline__ Window window(const BandPlane& P, int i0, int ni,
                                         int j0, int nj, int ri, int rj) {
  Window W;
  W.sy0 = i0 / P.bh;
  W.sx0 = j0 / P.bw;
  W.nsx = (j0 + nj - 1) / P.bw - W.sx0 + 1;
  W.ns = ((i0 + ni - 1) / P.bh - W.sy0 + 1) * W.nsx;
  W.ri = ri;
  W.rj = rj;
  return W;
}

// A thread's work items f = threadIdx.x + k NT over a window's runs, ru
// units a slice: unit v = f % ru of window slice f / ru, at window row yl
// and column xl. Divides once; each step after is a few adds.
struct Walk {
  int v, yl, xl;
  int ru, nsx, dv, dx, dy;
  __device__ Walk(int ru_, int nsx_) : ru(ru_), nsx(nsx_) {
    const int s = threadIdx.x / ru, ds = NT / ru;
    v = threadIdx.x - s * ru;
    yl = s / nsx;
    xl = s - yl * nsx;
    dv = NT - ds * ru;
    dy = ds / nsx;
    dx = ds - dy * nsx;
  }
  __device__ void next() {
    v += dv;
    const int c = v >= ru;
    v -= c ? ru : 0;
    xl += dx + c;
    const int cx = xl >= nsx;
    xl -= cx ? nsx : 0;
    yl += dy + cx;
  }
  // the current slice's index and first band sample (oi, oj)
  __device__ int slice(const BandPlane& P, const Window& W, int& oi,
                       int& oj) const {
    const int sy = W.sy0 + yl, sx = W.sx0 + xl;
    oi = sy * P.bh - W.ri;
    oj = sx * P.bw - W.rj;
    return sy * P.xs + sx;
  }
};

// Inverse: the run of each slice of the window into the parity planes, a
// unit of U lanes (a quad or a pair of one sub-block row, or one lane) a
// work item, through the run map; a unit none of whose lanes is in the
// region is not copied. A unit's lanes outside the region (a quad's first
// two, or last ones, where the region's edge cuts a sub-block row) land
// in the padding around the planes' rows.
template <int U>
__device__ __forceinline__ void copy_lanes(const BandPlane& P,
                                           const Region& g,
                                           const Window& win) {
  const int ru = (P.R + U - 1) / U;
  const int nrp = g.nr >> 1, ncp = g.nc >> 1;
  Walk it(ru, win.nsx);
  for (int f = threadIdx.x; f < win.ns * ru; f += NT, it.next()) {
    int oi, oj;
    const long long slice = it.slice(P, win, oi, oj);
    const Lane l = place(__ldg(P.map + U * it.v), oi, oj);
    if ((unsigned)l.li >= (unsigned)nrp || l.lj + U <= 0 || l.lj >= ncp)
      continue;
    const int32_t* src = P.lanes + slice * P.L + P.run0 + U * it.v;
    if constexpr (U == 4)
      copy16(at(g, l), src);
    else if constexpr (U == 2)
      copy8(at(g, l), src);
    else
      copy4(at(g, l), src);
  }
}

// Inverse: each slice of the window its q index, copied once into sq.
__device__ __forceinline__ void copy_q(const BandPlane& P, const Window& win,
                                       const int32_t* q, int32_t* sq) {
  Walk it(1, win.nsx);
  for (int s = threadIdx.x; s < win.ns; s += NT, it.next()) {
    int oi, oj;
    copy4(sq + s, q + it.slice(P, win, oi, oj));
  }
}

// Inverse: each region band row and column its window slice
// (srow[i] + scol[j]).
__device__ __forceinline__ void slice_tables(const BandPlane& P,
                                             const Window& win,
                                             const Region& g,
                                             const Smem& sm) {
  const int nrp = g.nr >> 1, ncp = g.nc >> 1;
  for (int k = threadIdx.x; k < nrp + ncp; k += NT) {
    if (k < nrp)
      sm.srow[k] = ((win.ri + k) / P.bh - win.sy0) * win.nsx;
    else
      sm.scol[k - nrp] = (win.rj + k - nrp) / P.bw - win.sx0;
  }
}

// Inverse (after the copies and a barrier): bands kb..3 of every band
// position of the region dequantised in place, each at its slice's
// clamped index q - qm[band]. A thread keeps a pair of columns and walks
// the rows NT / (ldq / 2) apart.
__device__ __forceinline__ void dequant_planes(const BandPlane& P,
                                               const Region& g, int kb,
                                               const int32_t* sq,
                                               const Smem& sm) {
  // one 8-byte word of each plane row; where the region has an odd number
  // of columns the last pair's second is the row's padding
  const int nrp = g.nr >> 1, ncp = g.nc >> 1, lv = g.lw - 2;
  const int j = 2 * (threadIdx.x & ((g.ldq >> 1) - 1));
  if (j >= ncp) return;
  const int sa = sm.scol[j], sb = sm.scol[min(j + 1, ncp - 1)];
  for (int i = threadIdx.x >> lv; i < nrp; i += NT >> lv) {
    const int r = sm.srow[i], qa = sq[r + sa], qb = sq[r + sb];
    const int o = i * g.pitch + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < kb) continue;
      uint2* p = (uint2*)(g.q(k >> 1, k & 1) + o);
      const uint2 v = *p;
      *p = make_uint2(
          (uint32_t)dequant((int32_t)v.x, sm.fo[clampi(qa - P.qm[k], MAX_Q)]),
          (uint32_t)dequant((int32_t)v.y, sm.fo[clampi(qb - P.qm[k], MAX_Q)]));
    }
  }
}

// Inverse: the compact LL of the region's band samples into parity plane
// (0, 0), from rows llw apart, in pairs where the rows allow.
__device__ __forceinline__ void copy_ll(const int32_t* ll, int llw, int i0,
                                        int j0, const Region& g) {
  const int nrp = g.nr >> 1, ncp = g.nc >> 1;
  uint32_t* e = g.q(0, 0);
  const bool two = !(llw & 1) && !(j0 & 1) && aligned8(ll);
  const int u = two ? 2 : 1, nu = (ncp + u - 1) / u;
  Walk it(nu, 1 << 30);  // row xl, unit v
  for (int f = threadIdx.x; f < nrp * nu; f += NT, it.next()) {
    const int i = it.xl, j = u * it.v;
    const int32_t* src = ll + (long long)(i0 + i) * llw + j0 + j;
    if (two && j + 2 <= ncp)
      copy8(e + i * g.pitch + j, src);
    else
      copy4(e + i * g.pitch + j, src);
  }
}

// Forward: the region's input samples, << TSHIFT, into the parity planes.
// A thread takes a 16-byte chunk of a row (E samples, aligned in the
// input) and issues BATCH chunks' loads before it stores any; a chunk
// that reaches past the input's last column, or an unaligned input, reads
// sample by sample with clamped indices (wavelet_pad's edge replication).
// Chunk word p holds the even/odd pair p (int16) or half of it (int32);
// pairs p and p + 1 are one 8-byte word of each parity row.
template <class T, int TSHIFT>
__device__ __forceinline__ void load_input(const BandPlane& P,
                                           const Region& g, int r0, int c0) {
  constexpr int E = 16 / sizeof(T);
  const T* src = (const T*)P.src;
  const int xa = c0 & ~(E - 1);
  const int nch = (c0 + g.nc - xa + E - 1) / E;
  const int n = g.nr * nch, ncp = g.nc >> 1;
  const bool vec = aligned16(src) && P.src_ld % E == 0;
  Walk it(nch, 1 << 30);  // row xl, chunk v
  for (int f0 = threadIdx.x; f0 < n; f0 += BATCH * NT) {
    uint32_t x[BATCH][4];
    const Walk first = it;
#pragma unroll
    for (int u = 0; u < BATCH; ++u, it.next()) {
      const int f = f0 + u * NT;
      if (f >= n) continue;
      const int r = it.xl, xg = xa + E * it.v;
      const T* row = src + (long long)min(r0 + r, P.src_h - 1) * P.src_ld;
      if (vec && xg + E <= P.src_w) {
        const uint4 q4 = __ldg((const uint4*)(row + xg));
        x[u][0] = q4.x, x[u][1] = q4.y, x[u][2] = q4.z, x[u][3] = q4.w;
      } else {
        T s[E];
#pragma unroll
        for (int k = 0; k < E; ++k)
          s[k] = __ldg(row + min(xg + k, P.src_w - 1));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (E == 8)
            x[u][k] = (uint32_t)(uint16_t)s[2 * k] |
                      (uint32_t)(uint16_t)s[2 * k + 1] << 16;
          else
            x[u][k] = (uint32_t)s[k];
        }
      }
    }
    Walk again = first;
#pragma unroll
    for (int u = 0; u < BATCH; ++u, again.next()) {
      const int f = f0 + u * NT;
      if (f >= n) continue;
      const int r = again.xl, xg = xa + E * again.v;
      const int o = (r >> 1) * g.pitch;
      uint32_t* ev = g.q(r & 1, 0) + o;
      uint32_t* od = g.q(r & 1, 1) + o;
      // 8-byte aligned: a chunk starts at a multiple of E samples, the
      // region at a multiple of 4
#pragma unroll
      for (int p = 0; p < E / 2; p += 2) {
        const int j = ((xg - c0) >> 1) + p;
        uint32_t a[2], b[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (E == 8) {
            a[h] = (uint32_t)(int32_t)(int16_t)(x[u][p + h] & 0xffff);
            b[h] = (uint32_t)(int32_t)(int16_t)(x[u][p + h] >> 16);
          } else {
            a[h] = x[u][2 * (p + h)];
            b[h] = x[u][2 * (p + h) + 1];
          }
        }
        if (j >= 0 && j + 1 < ncp) {
          *(uint2*)(ev + j) = make_uint2(a[0] << TSHIFT, a[1] << TSHIFT);
          *(uint2*)(od + j) = make_uint2(b[0] << TSHIFT, b[1] << TSHIFT);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (j + h < 0 || j + h >= ncp) continue;
            ev[j + h] = a[h] << TSHIFT;
            od[j + h] = b[h] << TSHIFT;
          }
        }
      }
    }
  }
}

// Forward: the tile's band samples (region rows [li0, li0 + ni), columns
// [lj0, lj0 + nj)) gathered through the run map into the lanes of the
// window's slices, a unit of U lanes (a quad, or one) a work item; a quad
// whose lanes are all in the tile is one 16-byte store.
template <int U>
__device__ __forceinline__ void store_lanes(const BandPlane& P,
                                            const Region& g,
                                            const Window& win, int li0,
                                            int ni, int lj0, int nj) {
  const int ru = (P.R + U - 1) / U;
  const bool pair = !(P.bw & 1);
  Walk it(ru, win.nsx);
  for (int f = threadIdx.x; f < win.ns * ru; f += NT, it.next()) {
    int oi, oj;
    int32_t* lane = P.lanes + P.run0 + U * it.v +
                    (long long)it.slice(P, win, oi, oj) * P.L;
    uint32_t e[U];
    if constexpr (U == 4) {
      const uint4 m = __ldg((const uint4*)P.map + it.v);
      e[0] = m.x, e[1] = m.y, e[2] = m.z, e[3] = m.w;
    } else {
      e[0] = __ldg(P.map + it.v);
    }
    int32_t x[U] = {};
    unsigned mask = 0;
    if constexpr (U == 1) {
      const Lane l = place(e[0], oi, oj);
      if (inside(l, li0, ni, lj0, nj)) {
        x[0] = (int32_t)*at(g, l);
        mask = 1;
      }
    } else {
#pragma unroll
      for (int h = 0; h < U; h += 2) {
        // lanes h, h + 1: one sub-block row where bw is even, so one
        // 8-byte read (the region's columns start at a multiple of 4)
        const Lane a = place(e[h], oi, oj), b = place(e[h + 1], oi, oj);
        const bool ia = inside(a, li0, ni, lj0, nj);
        const bool ib = inside(b, li0, ni, lj0, nj);
        if (pair && ia && ib) {
          const uint2 v = *(const uint2*)at(g, a);
          x[h] = (int32_t)v.x;
          x[h + 1] = (int32_t)v.y;
        } else {
          if (ia) x[h] = (int32_t)*at(g, a);
          if (ib) x[h + 1] = (int32_t)*at(g, b);
        }
        mask |= (unsigned)ia << h | (unsigned)ib << (h + 1);
      }
    }
    if constexpr (U == 4) {
      if (mask == 0xf) {
        *(int4*)lane = make_int4(x[0], x[1], x[2], x[3]);
        continue;
      }
    }
#pragma unroll
    for (int w = 0; w < U; ++w)
      if (mask >> w & 1) lane[w] = x[w];
  }
}

// Forward: the tile's LL (region rows [li0, li0 + ni), columns
// [lj0, lj0 + nj) of parity plane (0, 0)) into the compact plane dst at
// band sample (i0, j0), rows llw apart; 16-byte stores where they allow.
__device__ __forceinline__ void store_ll(int32_t* dst, int llw, int i0,
                                         int j0, const Region& g, int li0,
                                         int ni, int lj0, int nj) {
  const uint32_t* e = g.q(0, 0) + li0 * g.pitch + lj0;
  int32_t* out = dst + (long long)i0 * llw + j0;
  if ((llw & 3) == 0 && aligned16(out)) {
    const int n4 = (nj + 3) >> 2;
    for (int f = threadIdx.x; f < ni * n4; f += NT) {
      const int i = f / n4, j = 4 * (f - i * n4);
      const uint32_t* s = e + i * g.pitch + j;
      int32_t* d = out + (long long)i * llw + j;
      if (j + 4 <= nj)
        *(int4*)d = make_int4((int32_t)s[0], (int32_t)s[1], (int32_t)s[2],
                              (int32_t)s[3]);
      else
        for (int k = 0; j + k < nj; ++k) d[k] = (int32_t)s[k];
    }
  } else {
    for (int f = threadIdx.x; f < (ni << (g.lw - 1)); f += NT) {
      const int i = f >> (g.lw - 1), j = f & (g.ldq - 1);
      if (j < nj) out[(long long)i * llw + j] = (int32_t)e[i * g.pitch + j];
    }
  }
}

// The inverse copies a run in quads where each is 16-byte aligned and in
// one sub-block row (run start, lanes a slice and sub-block width
// multiples of 4), else in pairs where each is 8-byte aligned and in one
// sub-block row (the same, even), else lane by lane.
__device__ __forceinline__ int lane_unit(const BandPlane& P) {
  const int m = P.L | P.run0 | P.bw;
  if (!(m & 3) && aligned16(P.lanes)) return 4;
  if (!(m & 1) && aligned8(P.lanes)) return 2;
  return 1;
}

// The forward stores a run in quads where every quad is 16-byte aligned.
__device__ __forceinline__ bool quads(const BandPlane& P) {
  return !(P.L & 3) && !(P.run0 & 3) && aligned16(P.lanes) &&
         aligned16(P.map);
}

template <int INV, int TSHIFT, class... S>
__device__ __forceinline__ void inverse_level(Ladder<INV, TSHIFT, S...>,
                                              const BandTable& t,
                                              const Smem& sm) {
  for (int tile = blockIdx.x; tile < t.n_tiles; tile += gridDim.x) {
    const Tile T = tile_at(t, tile, sm.planes, true);
    const BandPlane& P = T.P;
    const Region& g = T.g;
    const int i0 = T.r0 >> 1, j0 = T.c0 >> 1;  // the region's first band
    const Window win = window(P, i0, g.nr >> 1, j0, g.nc >> 1, i0, j0);
    // the copies (lanes, LL, q indices) first, the tables while they fly
    const int unit = lane_unit(P);
    if (unit == 4)
      copy_lanes<4>(P, g, win);
    else if (unit == 2)
      copy_lanes<2>(P, g, win);
    else
      copy_lanes<1>(P, g, win);
    if (P.ll) copy_ll(P.ll, P.w >> 1, i0, j0, g);
    copy_q(P, win, t.q, sm.sq);
    slice_tables(P, win, g, sm);
    if (tile == (int)blockIdx.x)  // the quant tables, once a CTA
      for (int i = threadIdx.x; i < N_Q; i += NT)
        sm.fo[i] = make_int2(__ldg(QUANT_FACTORS + i),
                             __ldg(QUANT_OFFSETS + i));
    copy_wait();
    __syncthreads();
    dequant_planes(P, g, P.ll ? 1 : 0, sm.sq, sm);
    __syncthreads();

    cols<S...>(g);
    rows<S...>(g);

    store_tile<TSHIFT>(g, P.dst + (long long)T.ty0 * P.w + T.tx0, P.w,
                       min(t.th, P.h - T.ty0), min(t.tw, P.w - T.tx0),
                       T.ty0 - T.r0, (T.tx0 - T.c0) >> 1);
    __syncthreads();  // the planes and tables are the next tile's
  }
}

template <int INV, int TSHIFT, class... S>
__device__ __forceinline__ void forward_level(Ladder<INV, TSHIFT, S...>,
                                              const BandTable& t,
                                              const Smem& sm) {
  for (int tile = blockIdx.x; tile < t.n_tiles; tile += gridDim.x) {
    const Tile T = tile_at(t, tile, sm.planes, false);
    const BandPlane& P = T.P;
    const Region& g = T.g;
    if (P.src_bytes == 2)
      load_input<int16_t, TSHIFT>(P, g, T.r0, T.c0);
    else
      load_input<int32_t, TSHIFT>(P, g, T.r0, T.c0);
    __syncthreads();

    rows<S...>(g);
    cols<S...>(g);

    // the tile's band samples, and the slices they fill
    const int ti0 = T.ty0 >> 1, tj0 = T.tx0 >> 1;
    const int ni = min(t.th, P.h - T.ty0) >> 1;
    const int nj = min(t.tw, P.w - T.tx0) >> 1;
    const int li0 = ti0 - (T.r0 >> 1), lj0 = tj0 - (T.c0 >> 1);
    const Window win = window(P, ti0, ni, tj0, nj, T.r0 >> 1, T.c0 >> 1);
    if (quads(P))
      store_lanes<4>(P, g, win, li0, ni, lj0, nj);
    else
      store_lanes<1>(P, g, win, li0, ni, lj0, nj);
    if (P.dst) store_ll(P.dst, P.w >> 1, ti0, tj0, g, li0, ni, lj0, nj);
    __syncthreads();  // the planes are the next tile's
  }
}

template <class L>
__global__ void __launch_bounds__(NT, MIN_CTAS)
band_level_kernel(const __grid_constant__ BandTable t) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem sm = smem_layout(t, smem);
  if constexpr (Inverse<L>::value)
    inverse_level(L{}, t, sm);
  else
    forward_level(L{}, t, sm);
}

template <class L>
int launch(const BandTable& t, cudaStream_t stream) {
  const size_t smem = smem_bytes(t, Inverse<L>::value);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(band_level_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  // as many CTAs as the card holds at once, at most one a tile
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_level_kernel<L>, NT, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = min(t.n_tiles, max(per_sm, 1) * sms);
  band_level_kernel<L><<<grid, NT, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

bool valid(const BandTable* t) {
  const int rw = t->rw;
  bool ok = t->n >= 1 && t->n <= MAX_PLANES && t->n_tiles >= 1 &&
            t->max_slices >= 1 && !(t->th & 1) && !(t->tw & 7) &&
            !(t->halo & 1) && rw >= t->tw + 2 * col_halo(t->halo) &&
            rw >= 8 && rw <= NT && !(rw & (rw - 1));
  for (int k = 0; ok && k < t->n; ++k) {
    const BandPlane& P = t->p[k];
    ok = P.map && P.bh >= 1 && P.bw >= 1 && (unsigned)P.bh < MAP_FIELD / 2 &&
         (unsigned)P.bw < MAP_FIELD / 2 && P.R >= 1 && P.run0 >= 0 &&
         P.run0 + P.R <= P.L;
  }
  return ok;
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
