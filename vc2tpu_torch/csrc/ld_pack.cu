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
// One thread a slice, one launch. The lanes are transform coefficients:
// the LL lanes come from the rate control (csrc/ld_rate.cu), and each body
// lane is quantised as it is read, at max(qIndex - qm[lane], 0), by the
// exact quotient of golomb_encode.cuh. A first pass sizes the slice (and stores the
// quantised lanes when asked for), a second writes its codes through the
// shared code writer, 32 bits at a time, as big-endian bytes. Every int32
// codes in at most 64 bits, so there is no overflow case and no host
// fallback. No scan runs: the offsets are fixed by the budgets.

#include <cstdint>
#include <cuda_runtime.h>

#include "golomb_encode.cuh"
#include "ld_pack_params.h"

namespace {

using vc2::code_bits;
using vc2::code_of;
using vc2::quantise;

constexpr int THREADS = VC2_LD_PACK_THREADS;
constexpr unsigned FLAG_LD_FIT = VC2_FLAG_LD_FIT;

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
  int n;
};

// A slice's bytes: word w of the code writer is bytes 4w..4w+3 from the
// slice's start, stored big-endian, those past the slice dropped.
struct SliceSink {
  uint8_t* at;
  int size;
  __device__ void word(long long w, uint32_t x, bool) const {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long i = 4 * w + b;
      if (i < size) at[i] = static_cast<uint8_t>(x >> (24 - 8 * b));
    }
  }
};

// Lane j of component c of slice s: its LL code, or the body lane
// quantised at max(q - qm[j], 0).
__device__ __forceinline__ int32_t lane_value(const PackArgs& a, int c,
                                              long long s, int j, int q,
                                              const int32_t* factors,
                                              const unsigned long long* rc) {
  if (j < a.nll[c]) return __ldg(a.ll[c] + s * a.nll[c] + j);
  return quantise(__ldg(a.lanes[c] + s * a.len[c] + j),
                  min(max(q - __ldg(a.qm[c] + j), 0), 119), factors, rc);
}

__global__ void __launch_bounds__(THREADS) ld_pack(PackArgs a) {
  __shared__ int32_t s_factors[120];
  __shared__ unsigned long long s_recips[120];
  for (int i = threadIdx.x; i < 120; i += THREADS) {
    s_factors[i] = QUANT_FACTORS[i];
    s_recips[i] = QUANT_RECIPROCALS[i];
  }
  __syncthreads();
  const long long s = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (s >= a.n) return;
  const int q = a.q_idx[s];
  const int size = a.sizes[s];
  const long long total = 8LL * size;
  const int len_bits = total - 8 > 0 ? 64 - __clzll(total - 8) : 0;

  // size: the luma and the interleaved U/V codes' bits up to their last
  // non-zero code
  long long gross = 0, y_used = 0;
  for (int j = 0; j < a.len[0]; ++j) {
    const int32_t v = lane_value(a, 0, s, j, q, s_factors, s_recips);
    if (a.keep[0]) a.keep[0][s * a.len[0] + j] = v;
    gross += code_bits(v);
    if (v) y_used = gross;
  }
  long long uv_used = 0;
  gross = 0;
  for (int j = 0; j < a.len[1]; ++j) {
#pragma unroll
    for (int c = 1; c < 3; ++c) {
      const int32_t v = lane_value(a, c, s, j, q, s_factors, s_recips);
      if (a.keep[c]) a.keep[c][s * a.len[c] + j] = v;
      gross += code_bits(v);
      if (v) uv_used = gross;
    }
  }
  const long long uv_bits = total - 7 - len_bits - y_used;
  if (uv_used > uv_bits)
    atomicOr(reinterpret_cast<unsigned*>(a.out), FLAG_LD_FIT);

  // write: header, bounded luma, bounded U/V, zero fill
  vc2::BitAccumulator<SliceSink> w;
  w.start(SliceSink{a.out + 4 + a.starts[s], size}, 0);
  w.put(static_cast<uint32_t>(q) & 0x7Fu, 7);
  if (len_bits)
    w.put(static_cast<unsigned long long>(y_used) &
              (len_bits < 64 ? (1ull << len_bits) - 1 : ~0ull), len_bits);
  long long off = 0;
  for (int j = 0; j < a.len[0] && off < y_used; ++j) {
    const int32_t v = lane_value(a, 0, s, j, q, s_factors, s_recips);
    const int nb = code_bits(v);
    const int keep = static_cast<int>(min(static_cast<long long>(nb),
                                          y_used - off));
    w.put(code_of(v, nb) >> (nb - keep), keep);
    off += nb;
  }
  off = 0;
  for (int j = 0; j < a.len[1] && off < uv_bits; ++j) {
#pragma unroll
    for (int c = 1; c < 3; ++c) {
      if (off < uv_bits) {
        const int32_t v = lane_value(a, c, s, j, q, s_factors, s_recips);
        const int nb = code_bits(v);
        const int keep = static_cast<int>(min(static_cast<long long>(nb),
                                              uv_bits - off));
        w.put(code_of(v, nb) >> (nb - keep), keep);
        off += nb;
      }
    }
  }
  uint8_t* at = a.out + 4 + a.starts[s];
  for (long long i = 4 * w.finish(); i < size; ++i) at[i] = 0;
}

}  // namespace

// out = [flags uint32 | payload] (the flags word zeroed by the caller) from
// the lanes y [n, ly], u and v [n, lc] (int32, contiguous rows), the
// qIndex q_idx [n], the slice bytes sizes [n] and their first bytes
// starts [n] (int64). The lanes are transform coefficients whose first
// nll_y / nll_c lanes are replaced by ll_y [n, nll_y], ll_u / ll_v [n,
// nll_c], the others quantised by qm_y / qm_c (int32 [ly], [lc]); keep_*
// (or null) receive the quantised lanes. Returns the launch's CUDA error
// code.
extern "C" int ld_pack_launch(const void* y, const void* u, const void* v,
                              int ly, int lc, const void* ll_y,
                              const void* ll_u, const void* ll_v, int nll_y,
                              int nll_c, const void* qm_y, const void* qm_c,
                              void* keep_y, void* keep_u, void* keep_v,
                              const void* q_idx, const void* sizes,
                              const void* starts, int n, void* out,
                              void* stream) {
  if (n <= 0) return 0;
  if (!qm_y || !qm_c || !ll_y || !ll_u || !ll_v || nll_y < 0 || nll_y > ly ||
      nll_c < 0 || nll_c > lc)
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
  ld_pack<<<(n + THREADS - 1) / THREADS, THREADS, 0,
            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
