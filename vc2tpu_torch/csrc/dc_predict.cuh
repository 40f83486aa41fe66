// The arithmetic of the LD LL band's inverse quantise with DC prediction
// (reference Quantisation.cpp:86-95 and 287-306; the JAX package's
// vc2tpu/_native/vc2host.cpp:1859-1876, c_scale, predict_dc, adjust_q),
// one copy for the host recurrence (csrc/ld_scan.cpp, built with the host
// C++ compiler) and the card's wavefront (csrc/ld_dc.cu, nvcc), so the two
// give the same values bit for bit. int32 arithmetic wraps, as the
// reference's does on x86; divisions truncate, as C's do.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define DC_FN __host__ __device__ __forceinline__
#else
#define DC_FN inline
#endif

namespace dc {

DC_FN int32_t wrap32(long long v) {
  return static_cast<int32_t>(
      static_cast<uint32_t>(static_cast<unsigned long long>(v)));
}

// The scalar inverse quantise of `value` at quant index q (clamped to
// 0..119) with the 120-entry int32-wrapped factors qf and offsets qo.
DC_FN int32_t c_scale(int32_t value, int q, const int32_t* qf,
                      const int32_t* qo) {
  if (q < 0) q = 0;
  if (q > 119) q = 119;
  const bool neg = value < 0;
  long long v = neg ? wrap32(-static_cast<long long>(value)) : value;
  v = wrap32(v * qf[q]);
  if (v > 0) v = wrap32(v + qo[q]);
  v = wrap32(v + 2) / 4;
  return neg ? wrap32(-v) : static_cast<int32_t>(v);
}

// The DC prediction of a value from its above-left, above and left
// neighbours' values, where it has an above (y > 0) and a left (x > 0)
// neighbour: their mean rounded away from zero and truncated; else the
// one neighbour it has, else 0.
DC_FN int32_t predict(bool has_above, bool has_left, int32_t above_left,
                      int32_t above, int32_t left) {
  if (has_above && has_left) {
    const int32_t r = wrap32(static_cast<long long>(above_left) + above +
                             left);
    return r >= 0 ? wrap32(static_cast<long long>(r) + 1) / 3
                  : wrap32(static_cast<long long>(r) - 1) / 3;
  }
  if (has_above) return above;
  if (has_left) return left;
  return 0;
}

// The adjusted quant index max(q - qm, 0).
DC_FN int adjust(int q, int qm) { return q > qm ? q - qm : 0; }

}  // namespace dc
