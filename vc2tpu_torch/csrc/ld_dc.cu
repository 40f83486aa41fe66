// The LD LL band's inverse quantise with DC prediction on the card, for
// sm_90a: the three dequantised LL grids of a picture (luma, U, V) from the
// lanes of csrc/ld_unpack.cu.
//
// Replaces: the host recurrence of csrc/ld_scan.cpp (ld_dequantise_grid,
// the JAX package's vc2tpu/_native/vc2host.cpp:1859-1876 and
// vc2tpu/pipeline/decoder.py::ld_ll_grids), which ran over the codes the
// host had decoded for it; the reference is inverse_quantise_LLSubband
// (Quantisation.cpp:287-306). Each LL value is c_scale(code, max(q - qm,
// 0)) plus the DC prediction from its above-left, above and left values
// (dc_predict.cuh, the host's arithmetic), so the grids are the host's bit
// for bit.
//
// Bound on the card: not the bytes (~2 MB a 1080p picture, under 1 us at
// 3.35 TB/s) but the chain. A value needs its left and above values, so
// the cells of one anti-diagonal are independent and the diagonals are
// not: llh + llw - 1 dependent steps (749 for the 270 x 480 luma grid at
// 1080p depth 2, 509 for each 270 x 240 chroma grid), each an add chain, a
// division by 3 and the hand-over of a value to the next row.
//
// Design. Three launches.
//   terms   every cell's scaled code c_scale(code, aq) is independent of
//           the recurrence: a thread a cell of all three grids computes
//           it (the code from the lane that holds it, `src`; the slice's
//           q index and quant matrix entry from tables a row and a
//           column), off the chain, into a scratch in diagonal order;
//   chain   one CTA a grid, the three at once, one thread a grid row, in
//           bands of blockDim rows. At step t the thread of row y takes
//           column t - y: its left value is its own last (a register), its
//           above value row y - 1's last, from a two-slot ring in shared
//           memory (the band's first row reads the band above's last row,
//           kept in shared memory as it was computed), its above-left
//           value the above of its last step (a register). One barrier a
//           step. The 32 cells of a warp's step lie on one anti-diagonal of
//           its 32 rows, 32 consecutive words of the scratch, so its term
//           loads (AHEAD steps before their use) and value stores are one
//           128-byte access each, where a row-major grid costs 32;
//   unskew  the values from the scratch into the row-major grids, a
//           thread a cell.

#include <cstdint>

#include "dc_predict.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int CELL_THREADS = 256;
constexpr int AHEAD = 8;  // steps a term is loaded before its use
constexpr size_t MAX_SMEM = 227 * 1024;

// One component's grid: its lanes [n, lanes] (the unpack's), the lane of
// every cell's code (`src` [llh * llw], -1 where no code lands: the code
// 0), the q index offset and quant-matrix row of every grid row (row_q,
// row_m [llh]) and column (col_q, col_m [llw]), the slice's quant matrix
// block qm [sh * sw], the scratch (ld_dc_skew_words) and the grid out
// [llh * llw].
struct Grid {
  const int32_t* lanes;
  const int32_t* src;
  const int32_t* row_q;
  const int32_t* row_m;
  const int32_t* col_q;
  const int32_t* col_m;
  const int32_t* qm;
  int32_t* skew;
  int32_t* out;
  int llh, llw;
};

struct Params {
  Grid g[3];
  const int32_t* q;   // [n] the slices' q indices
  const int32_t* qf;  // [120] int32-wrapped quant factors
  const int32_t* qo;  // [120] quant offsets
};

// Cell (y, x) in the scratch: rows in blocks of 32, a block's cells by
// anti-diagonal x + (y mod 32) (llw + 31 of them), 32 words a diagonal.
__device__ __forceinline__ size_t skew_at(int y, int x, int llw) {
  return ((size_t)(y >> 5) * (llw + 31) + x + (y & 31)) * 32 + (y & 31);
}

// Every cell's scaled code c_scale(code, max(q - qm, 0)) into the scratch:
// a thread a cell, blockIdx.y the component.
__global__ void __launch_bounds__(CELL_THREADS)
ld_dc_terms_kernel(const Params p) {
  __shared__ int32_t qf[120], qo[120];
  for (int k = threadIdx.x; k < 120; k += blockDim.x) {
    qf[k] = p.qf[k];
    qo[k] = p.qo[k];
  }
  __syncthreads();
  const Grid& g = p.g[blockIdx.y];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.llh * g.llw) return;
  const int y = c / g.llw, x = c - y * g.llw;
  const int s = __ldg(g.src + c);
  const int32_t code = s >= 0 ? __ldg(g.lanes + s) : 0;
  const int slice = __ldg(g.row_q + y) + __ldg(g.col_q + x);
  const int entry = __ldg(g.row_m + y) + __ldg(g.col_m + x);
  const int aq = dc::adjust(__ldg(p.q + slice), __ldg(g.qm + entry));
  g.skew[skew_at(y, x, g.llw)] = dc::c_scale(code, aq, qf, qo);
}

// The recurrence over the scratch's terms, in place: one CTA a grid, a
// thread a row, a band of blockDim rows at a time. Dynamic shared memory:
// the ring [2][blockDim] and the band above's last row [llw].
__global__ void __launch_bounds__(MAX_THREADS) ld_dc_kernel(const Params p) {
  extern __shared__ int32_t smem[];
  const Grid& g = p.g[blockIdx.x];
  const int threads = blockDim.x, tid = threadIdx.x;
  int32_t* const ring = smem;
  int32_t* const edge = smem + 2 * threads;
  const int llh = g.llh, llw = g.llw;
  for (int y0 = 0; y0 < llh; y0 += threads) {
    const int y = y0 + tid;
    const bool row = y < llh;
    const bool feeds_next = tid == threads - 1 && y + 1 < llh;
    // the row's cell of column x is cell[32 x]
    int32_t* cell = g.skew + skew_at(min(y, llh - 1), 0, llw);
    const int steps = min(threads, llh - y0) + llw - 1;
    int32_t term[AHEAD];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      const int x = a - tid;
      term[a] = row && x >= 0 && x < llw ? cell[32 * x] : 0;
    }
    int32_t left = 0, above_left = 0;
    for (int t0 = 0; t0 < steps; t0 += AHEAD) {
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        const int t = t0 + a;
        if (t >= steps) break;  // the same for every thread
        const int x = t - tid;
        if (row && x >= 0 && x < llw) {
          const int32_t above =
              tid > 0 ? ring[((t - 1) & 1) * threads + tid - 1]
                      : (y > 0 ? edge[x] : 0);
          const int32_t v = dc::wrap32(
              (long long)term[a] +
              dc::predict(y > 0, x > 0, above_left, above, left));
          cell[32 * x] = v;
          ring[(t & 1) * threads + tid] = v;
          if (feeds_next) edge[x] = v;
          left = v;
          above_left = above;
        }
        const int xn = x + AHEAD;
        term[a] = row && xn >= 0 && xn < llw ? cell[32 * xn] : 0;
        __syncthreads();
      }
    }
  }
}

// The values from the scratch into the row-major grids: a thread a cell,
// blockIdx.y the component.
__global__ void __launch_bounds__(CELL_THREADS)
ld_dc_unskew_kernel(const Params p) {
  const Grid& g = p.g[blockIdx.y];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.llh * g.llw) return;
  const int y = c / g.llw, x = c - y * g.llw;
  g.out[c] = g.skew[skew_at(y, x, g.llw)];
}

}  // namespace

// Words of the scratch of an llh x llw grid.
extern "C" long long ld_dc_skew_words(int llh, int llw) {
  return (long long)((llh + 31) / 32) * (llw + 31) * 32;
}

// The three grids of `grids` (luma, U, V) from their lanes and the q
// indices q [n], with the quant factor and offset tables qf, qo [120]:
// the terms, the recurrence (one CTA a grid of `threads` threads: whole
// warps, at most 1024) and the grids out. Returns the launches' CUDA
// error code.
extern "C" int ld_dc_launch(const void* grids, const void* q, const void* qf,
                            const void* qo, int threads, void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int c = 0; c < 3; ++c) p.g[c] = static_cast<const Grid*>(grids)[c];
  p.q = (const int32_t*)q;
  p.qf = (const int32_t*)qf;
  p.qo = (const int32_t*)qo;
  int cells = 0, llw = 0;
  for (int c = 0; c < 3; ++c) {
    cells = max(cells, p.g[c].llh * p.g[c].llw);
    llw = max(llw, p.g[c].llw);
  }
  if (cells == 0) return (int)cudaSuccess;
  const size_t smem = 4ull * (2ull * threads + llw);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ld_dc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 cell_blocks((cells + CELL_THREADS - 1) / CELL_THREADS, 3);
  ld_dc_terms_kernel<<<cell_blocks, CELL_THREADS, 0, s>>>(p);
  ld_dc_kernel<<<3, threads, smem, s>>>(p);
  ld_dc_unskew_kernel<<<cell_blocks, CELL_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
