// HQ CBR rate control on the card: the port of the JAX package's XLA
// function vc2tpu/rdo/cbr.py:183::cbr_quant_indices (reference
// src/EncodeStream/EncodeStream.cpp:73-125, yss_for_slice at
// src/Library/src/Quantisation.cpp:627-642).
//
// For each slice, on its own, the quantisation index:
//   bisection  trial 63, best 127; six probes with delta 32, 16, 8, 4, 2, 1
//              and a seventh: after each, best = trial where the slice fits
//              (bytes at trial <= budget - 4) and trial < best, then trial
//              -= delta where it fits, else += delta. No monotonicity in q
//              is assumed: this is the reference's probe sequence;
//   climb      from q = best, q += 1 while the luma error at q + 1 is
//              strictly below the error at q.
// A probe's bytes: for each component, the signed exp-Golomb bits of each
// lane quantised at clamp(q - qm[lane], 0, 119), less the trailing run of
// zero codes (1 bit each), in whole bytes, in whole units of `scalar`. The
// luma error: the sum over the slice's luma lanes of d * d in 64 bits
// (wrapping, compared as signed), d = lane - scale(quant(lane)) formed in
// int32, wrapping; scale with the int32-wrapped factor and offset, which are
// negative at q 116-119 (vc2tpu_torch/quant/quantiser.py).
//
// One warp a slice, eight slices a CTA, one launch for the picture. The
// warp keeps its slice's lanes in shared memory across every probe and
// climb step (when 8 slices' lanes fit the stage; else each probe reads
// them from device memory, where L1 and L2 hold them), loops over the lanes
// 32 at a time, so any slice size works, and reduces with shuffles: a sum
// of code bits and a max of the last non-zero lane a component, a 64-bit
// sum for the error. Every lane of the warp takes the same path, since
// each reduction ends on all lanes. Nothing goes back to the host: the
// indices stay on the card for the pack, and an index above 119 sets
// FLAG_QMAX in the pack's flags word, read in the picture's one
// synchronisation.
//
// The quotient (|v| << 2) / |factor| is exact for every int32 v: the high
// 64 bits of (|v| << 2) * ceil(2^64 / |factor|) below |v| = 2^30, a 64-bit
// divide above. On the H100 this form runs the search faster than the
// packs' branch-free one (golomb_encode.cuh).
//
// What bounds it on the card: the lanes read once, 16.6 MB at 1080p (5 us
// of memory time), against ~105 integer operations a lane for the seven
// probes and ~20 a luma lane for each of a slice's (climb + 2) error passes
// (~8 us at the card's integer rate): operations, if the lanes stay on the
// chip as here. A warp a slice spends most of its issue slots on the
// reductions (ten shuffles a component a probe) rather than on the lanes,
// so it runs well above that bound; a group of a few threads a slice, as
// csrc/hq_pack.cu has, is the step after this simple form.

#include <cstdint>
#include <cuda_runtime.h>

#include "hq_cbr_params.h"

namespace {

constexpr int WARPS = VC2_CBR_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGE_BYTES = VC2_CBR_STAGE_BYTES;
constexpr int MAX_Q = VC2_CBR_MAX_Q;
constexpr unsigned long long FLAG_QMAX = VC2_FLAG_QMAX;
constexpr unsigned FULL = 0xffffffffu;

__constant__ int32_t QUANT_FACTORS[120] = {VC2_QUANT_FACTORS};
__constant__ int32_t QUANT_OFFSETS[120] = {VC2_QUANT_OFFSETS};
__constant__ unsigned long long QUANT_RECIPROCALS[120] = {
    VC2_QUANT_RECIPROCALS};

struct CbrArgs {
  const int32_t* lanes[3];   // [n, len[c]] transform lanes
  const int32_t* qm[3];      // quant matrix entry of each lane
  int len[3];
  const int32_t* budgets;    // [n] slice bytes without the prefix
  int32_t* q_out;            // [n]
  unsigned long long* flags;  // receives FLAG_QMAX, or null
  int n, scalar, staged;
};

struct Tables {
  int32_t factors[120];
  int32_t offsets[120];
  unsigned long long recips[120];
};

__device__ __forceinline__ uint32_t magnitude(int32_t v) {
  return v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
}

// |quant(v, q)| = (|v| << 2) / |factor(q)|, exact; at most 2^31.
__device__ __forceinline__ uint32_t quotient(int32_t v, int q,
                                             const Tables& t) {
  const uint32_t m = magnitude(v);
  if (m < (1u << 30)) {
    const uint32_t n = m << 2;
    const unsigned long long rc = t.recips[q];
    return static_cast<uint32_t>(
        (static_cast<unsigned long long>(n) * static_cast<uint32_t>(rc >> 32) +
         __umulhi(n, static_cast<uint32_t>(rc))) >> 32);
  }
  return static_cast<uint32_t>((static_cast<unsigned long long>(m) << 2) /
                               magnitude(t.factors[q]));
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

__device__ __forceinline__ int adjusted(int q, int32_t qm) {
  return min(max(q - qm, 0), MAX_Q);
}

// The slice's bytes at index q (every lane of the warp returns it). The
// component loop is unrolled so that its arrays stay in registers.
__device__ __forceinline__ int slice_bytes(const int32_t* const src[3],
                                           const CbrArgs& a, int q,
                                           const Tables& t, int lane) {
  int total = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int len = a.len[c];
    const int32_t* qm = a.qm[c];
    int bits = 0, last = -1;
    for (int j = lane; j < len; j += 32) {
      const uint32_t r = quotient(src[c][j], adjusted(q, __ldg(qm + j)), t);
      bits += r ? 2 * (32 - __clz(r + 1u)) : 1;
      if (r) last = j;
    }
    for (int o = 16; o; o >>= 1) {
      bits += __shfl_xor_sync(FULL, bits, o);
      last = max(last, __shfl_xor_sync(FULL, last, o));
    }
    const int used = bits - (len - 1 - last);
    total += ((used + 7) / 8 + a.scalar - 1) / a.scalar * a.scalar;
  }
  return total;
}

// The slice's luma error at index q, as a signed 64-bit sum that wraps.
__device__ long long luma_error(const int32_t* y, const CbrArgs& a, int q,
                                const Tables& t, int lane) {
  unsigned long long acc = 0;
  const int32_t* qm = a.qm[0];
  for (int j = lane; j < a.len[0]; j += 32) {
    const int32_t v = y[j];
    const int aq = adjusted(q, __ldg(qm + j));
    const int32_t f = t.factors[aq];
    const uint32_t r = quotient(v, aq, t);
    const int32_t x = static_cast<int32_t>(((v < 0) != (f < 0)) ? 0u - r : r);
    const int32_t d = static_cast<int32_t>(
        static_cast<uint32_t>(v) -
        static_cast<uint32_t>(rescale(x, f, t.offsets[aq])));
    acc += static_cast<unsigned long long>(static_cast<long long>(d) * d);
  }
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return static_cast<long long>(acc);
}

__global__ void __launch_bounds__(THREADS) hq_cbr(CbrArgs a) {
  extern __shared__ int32_t stage[];   // WARPS slices' lanes, when staged
  __shared__ Tables t;
  for (int i = threadIdx.x; i < 120; i += THREADS) {
    t.factors[i] = QUANT_FACTORS[i];
    t.offsets[i] = QUANT_OFFSETS[i];
    t.recips[i] = QUANT_RECIPROCALS[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= a.n) return;

  const int32_t* src[3];
  int32_t* own = stage + static_cast<long long>(warp) *
                             (a.len[0] + a.len[1] + a.len[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int32_t* row = a.lanes[c] + static_cast<long long>(s) * a.len[c];
    if (a.staged) {
      for (int j = lane; j < a.len[c]; j += 32) own[j] = __ldg(row + j);
      src[c] = own;
      own += a.len[c];
    } else {
      src[c] = row;
    }
  }
  __syncwarp();

  const int available = a.budgets[s] - 4;
  int trial = 63, best = 127;
#pragma unroll 1
  for (int delta = 32;; delta >>= 1) {
    const bool fits = slice_bytes(src, a, trial, t, lane) <= available;
    if (fits && trial < best) best = trial;
    if (delta == 0) break;
    trial += fits ? -delta : delta;
  }

  int q = best;
  long long prev = luma_error(src[0], a, q, t, lane);
  for (;;) {
    const long long cur = luma_error(src[0], a, q + 1, t, lane);
    if (!(cur < prev)) break;
    ++q;
    prev = cur;
  }
  if (lane == 0) {
    a.q_out[s] = q;
    if (q > MAX_Q && a.flags) atomicOr(a.flags, FLAG_QMAX);
  }
}

}  // namespace

// q_out [n] (int32) from the transform lanes y [n, ly], u and v [n, lc]
// (int32, contiguous rows), the quant matrix entry of each lane qm_y [ly],
// qm_c [lc] and the budgets [n]. `staged` (from rdo/cbr.py::staged) keeps a
// CTA's slices in shared memory; it must fit STAGE_BYTES. `flags` (an int64
// word, or null) receives FLAG_QMAX where an index exceeds 119. Returns the
// launch's CUDA error code.
extern "C" int hq_cbr_launch(const void* y, const void* u, const void* v,
                             int ly, int lc, const void* qm_y,
                             const void* qm_c, const void* budgets, int n,
                             int scalar, int staged, void* q_out, void* flags,
                             void* stream) {
  if (n <= 0) return 0;
  const long long stage_bytes = 4LL * WARPS * (ly + 2LL * lc);
  if (ly < 0 || lc < 0 || scalar < 1 || (staged && stage_bytes > STAGE_BYTES))
    return static_cast<int>(cudaErrorInvalidValue);
  CbrArgs a;
  a.lanes[0] = static_cast<const int32_t*>(y);
  a.lanes[1] = static_cast<const int32_t*>(u);
  a.lanes[2] = static_cast<const int32_t*>(v);
  a.qm[0] = static_cast<const int32_t*>(qm_y);
  a.qm[1] = a.qm[2] = static_cast<const int32_t*>(qm_c);
  a.len[0] = ly;
  a.len[1] = a.len[2] = lc;
  a.budgets = static_cast<const int32_t*>(budgets);
  a.q_out = static_cast<int32_t*>(q_out);
  a.flags = static_cast<unsigned long long*>(flags);
  a.n = n;
  a.scalar = scalar;
  a.staged = staged;
  hq_cbr<<<(n + WARPS - 1) / WARPS, THREADS,
           staged ? static_cast<size_t>(stage_bytes) : 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
