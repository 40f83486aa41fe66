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
// A group of g threads a slice (g = 4 to 32, a power of two, from
// rdo/cbr.py::group_plan), 256 threads a CTA, one launch for the picture.
// Thread r of a group holds a contiguous run of each component's lanes in
// registers (up to HOLD_Y luma and HOLD_C of each chroma component: 4 + 2
// + 2 at 1080p, g = 16) across every probe and climb step, and its quant
// matrix entries. A probe sums each component's code bits and takes its
// last non-zero lane with one redux.sync each on the group's mask; the
// 64-bit luma error takes log2(g) shuffle pairs. Slices whose lanes do not
// fit the registers at g = 32 take a warp that reads them from device
// memory at every probe, 32 lanes at a time. The groups of a warp reduce
// on their own masks, so a group that climbs further than its neighbours
// needs nothing of them. Nothing goes back to the host: the indices stay
// on the card for the pack, and an index above 119 sets FLAG_QMAX in the
// pack's flags word, read in the picture's one synchronisation.
//
// The quotient (|v| << 2) / |factor| is exact for every int32 v:
// golomb_encode.cuh's small_quotient below |v| = 2^30, a 64-bit divide
// above. A thread whose held lanes are all below 2^30 (every lane of real
// pictures) sizes them without the branch, in straight-line code; on the
// H100 this form runs the search faster than the packs' 64-bit one.
//
// What bounds it on the card: the lanes read once, 16.6 MB at 1080p (5 us
// of memory time), against ~105 integer operations a lane for the seven
// probes and ~20 a luma lane for each of a slice's (climb + 2) error passes
// (~8 us at the card's integer rate): operations, as the lanes stay on the
// chip. Measured at 1080p it runs near 0.07 ms, latency-bound: a probe is
// a short chain (the table read, the quotient, the code length, the
// reductions, the byte count) with a few lanes of work a thread, and the
// split that holds more lanes a thread needs more registers and keeps
// fewer warps resident (chip_smoke.py's kernel line, PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "golomb_encode.cuh"
#include "hq_cbr_params.h"

namespace {

constexpr int THREADS = VC2_CBR_THREADS;
constexpr int HOLD_Y = VC2_CBR_HOLD_Y;   // luma lanes a thread holds
constexpr int HOLD_C = VC2_CBR_HOLD_C;   // lanes of each chroma component
constexpr int MIN_BLOCKS = VC2_CBR_MIN_BLOCKS;   // CTAs an SM holds at once
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
  int n, scalar, group;
  int scalar_shift;          // log2(scalar) where it is a power of two, else -1
};

struct Tables {
  int32_t factors[120];
  int32_t offsets[120];
  unsigned long long recips[120];
};

__device__ __forceinline__ uint32_t magnitude(int32_t v) {
  return v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
}

// |quant(v, q)| for every int32 v: golomb_encode.cuh's small_quotient
// below |v| = 2^30, a 64-bit divide above; at most 2^31. FAST: the caller
// knows |v| < 2^30.
template <bool FAST = false>
__device__ __forceinline__ uint32_t quotient(int32_t v, int q,
                                             const Tables& t) {
  const uint32_t m = magnitude(v);
  if (FAST || m < (1u << 30)) return vc2::small_quotient(m, t.recips[q]);
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

__device__ __forceinline__ int code_bits(uint32_t r) {   // r = |code|
  return r ? 2 * (32 - __clz(r + 1u)) : 1;
}

// d * d of a lane v at the adjusted index aq, d = v - scale(quant(v))
// formed in int32, wrapping, squared in 64 bits.
template <bool FAST = false>
__device__ __forceinline__ unsigned long long square_error(int32_t v, int aq,
                                                           const Tables& t) {
  const int32_t f = t.factors[aq];
  const uint32_t r = quotient<FAST>(v, aq, t);
  const int32_t x = static_cast<int32_t>(((v < 0) != (f < 0)) ? 0u - r : r);
  const int32_t d = static_cast<int32_t>(
      static_cast<uint32_t>(v) -
      static_cast<uint32_t>(rescale(x, f, t.offsets[aq])));
  return static_cast<unsigned long long>(static_cast<long long>(d) * d);
}

// A slice's lanes as thread r of its group of g holds them: a contiguous
// run of each component's lanes and their quant matrix entries, in
// registers. Where none is 2^30 or more in magnitude (every lane of real
// pictures) the thread sizes them with the branch-free quotient, in
// straight-line code the compiler interleaves.
template <int KY, int KC>
struct Held {
  int32_t y[KY], u[KC], v[KC], qy[KY], qc[KC];
  int ny, nc, oy, oc;   // lanes held, and the first one's index
  bool big;             // a lane of magnitude 2^30 or more

  __device__ __forceinline__ void load(const CbrArgs& a, long long s, int r,
                                       int g) {
    const int ky = (a.len[0] + g - 1) / g, kc = (a.len[1] + g - 1) / g;
    oy = r * ky;
    oc = r * kc;
    ny = max(0, min(ky, a.len[0] - oy));
    nc = max(0, min(kc, a.len[1] - oc));
    const int32_t* ry = a.lanes[0] + s * a.len[0] + oy;
    const int32_t* ru = a.lanes[1] + s * a.len[1] + oc;
    const int32_t* rv = a.lanes[2] + s * a.len[1] + oc;
#pragma unroll
    for (int k = 0; k < KY; ++k) {
      y[k] = k < ny ? __ldg(ry + k) : 0;
      qy[k] = k < ny ? __ldg(a.qm[0] + oy + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      u[k] = k < nc ? __ldg(ru + k) : 0;
      v[k] = k < nc ? __ldg(rv + k) : 0;
      qc[k] = k < nc ? __ldg(a.qm[1] + oc + k) : 0;
    }
    uint32_t most = 0;
#pragma unroll
    for (int k = 0; k < KY; ++k) most = max(most, magnitude(y[k]));
#pragma unroll
    for (int k = 0; k < KC; ++k)
      most = max(most, max(magnitude(u[k]), magnitude(v[k])));
    big = most >= (1u << 30);
  }

  // This thread's code bits and last non-zero lane of each component at
  // index q (a lane it does not hold counts nothing).
  __device__ __forceinline__ void size(const CbrArgs&, int q, const Tables& t,
                                       int (&bits)[3], int (&last)[3]) const {
    if (big)
      size_as<false>(q, t, bits, last);
    else
      size_as<true>(q, t, bits, last);
  }

  template <bool FAST>
  __device__ __forceinline__ void size_as(int q, const Tables& t,
                                          int (&bits)[3],
                                          int (&last)[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bits[c] = 0;
      last[c] = -1;
    }
#pragma unroll
    for (int k = 0; k < KY; ++k) {
      if (k < ny) {
        const uint32_t r = quotient<FAST>(y[k], adjusted(q, qy[k]), t);
        bits[0] += code_bits(r);
        if (r) last[0] = oy + k;
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (k < nc) {
        const int aq = adjusted(q, qc[k]);
        const uint32_t ru = quotient<FAST>(u[k], aq, t);
        const uint32_t rv = quotient<FAST>(v[k], aq, t);
        bits[1] += code_bits(ru);
        bits[2] += code_bits(rv);
        if (ru) last[1] = oc + k;
        if (rv) last[2] = oc + k;
      }
    }
  }

  // This thread's share of the slice's luma error at index q.
  __device__ __forceinline__ unsigned long long error(const CbrArgs&, int q,
                                                      const Tables& t) const {
    return big ? error_as<false>(q, t) : error_as<true>(q, t);
  }

  template <bool FAST>
  __device__ __forceinline__ unsigned long long error_as(
      int q, const Tables& t) const {
    unsigned long long acc = 0;
#pragma unroll
    for (int k = 0; k < KY; ++k)
      if (k < ny) acc += square_error<FAST>(y[k], adjusted(q, qy[k]), t);
    return acc;
  }
};

// A slice too large for the registers: lane r of its warp reads lanes r,
// r + 32, ... of each component from device memory at every probe.
struct Streamed {
  long long s;
  int r;

  __device__ __forceinline__ void size(const CbrArgs& a, int q,
                                       const Tables& t, int (&bits)[3],
                                       int (&last)[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int len = a.len[c];
      const int32_t* row = a.lanes[c] + s * len;
      bits[c] = 0;
      last[c] = -1;
      for (int j = r; j < len; j += 32) {
        const uint32_t m = quotient(__ldg(row + j),
                                    adjusted(q, __ldg(a.qm[c] + j)), t);
        bits[c] += code_bits(m);
        if (m) last[c] = j;
      }
    }
  }

  __device__ __forceinline__ unsigned long long error(const CbrArgs& a, int q,
                                                      const Tables& t) const {
    unsigned long long acc = 0;
    const int32_t* row = a.lanes[0] + s * a.len[0];
    for (int j = r; j < a.len[0]; j += 32)
      acc += square_error(__ldg(row + j), adjusted(q, __ldg(a.qm[0] + j)), t);
    return acc;
  }
};

// The search of slice s by its group (rank r, g threads, lane mask
// `mask`): the bisection, then the climb.
template <class Lanes>
__device__ __forceinline__ void search(const CbrArgs& a, const Lanes& lanes,
                                       long long s, unsigned mask, int g,
                                       int r, const Tables& t) {
  const int available = __ldg(a.budgets + s) - 4;
  int trial = 63, best = 127;
#pragma unroll 1
  for (int delta = 32;; delta >>= 1) {
    int bits[3], last[3];
    lanes.size(a, trial, t, bits, last);
    int total = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int b = static_cast<int>(
          __reduce_add_sync(mask, static_cast<unsigned>(bits[c])));
      const int l = __reduce_max_sync(mask, last[c]);
      const int bytes = (b - (a.len[c] - 1 - l) + 7) >> 3;   // used >= 0
      total += a.scalar_shift >= 0
          ? ((bytes + a.scalar - 1) >> a.scalar_shift) << a.scalar_shift
          : (bytes + a.scalar - 1) / a.scalar * a.scalar;
    }
    const bool fits = total <= available;
    if (fits && trial < best) best = trial;
    if (delta == 0) break;
    trial += fits ? -delta : delta;
  }

  // the climb: q += 1 while the luma error at q + 1 is below that at q
  auto error = [&](int q) {
    unsigned long long acc = lanes.error(a, q, t);
    for (int o = g >> 1; o; o >>= 1) acc += __shfl_xor_sync(mask, acc, o, g);
    return static_cast<long long>(acc);
  };
  int q = best;
  long long prev = error(q);
  for (;;) {
    const long long cur = error(q + 1);
    if (!(cur < prev)) break;
    ++q;
    prev = cur;
  }
  if (r == 0) {
    a.q_out[s] = q;
    if (q > MAX_Q && a.flags) atomicOr(a.flags, FLAG_QMAX);
  }
}

__device__ __forceinline__ void load_tables(Tables& t) {
  for (int i = threadIdx.x; i < 120; i += THREADS) {
    t.factors[i] = QUANT_FACTORS[i];
    t.offsets[i] = QUANT_OFFSETS[i];
    t.recips[i] = QUANT_RECIPROCALS[i];
  }
  __syncthreads();
}

// Slices whose runs fit the registers: a.group threads each.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) hq_cbr_held(
    CbrArgs a) {
  __shared__ Tables t;
  load_tables(t);
  const int g = a.group, lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * (THREADS / g) + threadIdx.x / g;
  if (s >= a.n) return;   // whole groups: a group's mask names only itself
  const unsigned mask =
      g == 32 ? FULL : ((1u << g) - 1u) << (lane & ~(g - 1));
  Held<HOLD_Y, HOLD_C> lanes;
  lanes.load(a, s, lane & (g - 1), g);
  search(a, lanes, s, mask, g, lane & (g - 1), t);
}

// Slices too large for the registers: a warp each.
__global__ void __launch_bounds__(THREADS) hq_cbr_streamed(CbrArgs a) {
  __shared__ Tables t;
  load_tables(t);
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (s >= a.n) return;
  search(a, Streamed{s, lane}, s, FULL, 32, lane, t);
}

// A check of the group reductions on the card: each group of g threads
// reduces its values of `in` with redux.sync on its own mask and with
// log2(g) shuffles, after looping its index modulo 3 times on group-wide
// syncs, so that the groups of a warp reach the reductions apart, as the
// climb makes them. out [n / g, 4]: redux sum, shuffle sum, redux max,
// shuffle max.
__global__ void __launch_bounds__(THREADS) hq_cbr_reduce_check(
    const int32_t* in, int32_t* out, int n, int g) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int lane = threadIdx.x & 31, group = i / g;
  const unsigned mask =
      g == 32 ? FULL : ((1u << g) - 1u) << (lane & ~(g - 1));
  int32_t x = in[i];
  for (int k = 0; k < group % 3; ++k)
    x += static_cast<int32_t>(__reduce_add_sync(mask, 0u));
  const int32_t rs = static_cast<int32_t>(
      __reduce_add_sync(mask, static_cast<unsigned>(x)));
  const int32_t rm = __reduce_max_sync(mask, x);
  int32_t ss = x, sm = x;
  for (int o = g >> 1; o; o >>= 1) {
    ss += __shfl_xor_sync(mask, ss, o, g);
    sm = max(sm, __shfl_xor_sync(mask, sm, o, g));
  }
  if ((lane & (g - 1)) == 0) {
    out[4 * group] = rs;
    out[4 * group + 1] = ss;
    out[4 * group + 2] = rm;
    out[4 * group + 3] = sm;
  }
}

}  // namespace

// The group reductions' check (hq_cbr_reduce_check) on n int32 values, n a
// multiple of g; out holds n / g rows of 4. Returns the launch's CUDA error
// code.
extern "C" int hq_cbr_reduce_check_launch(const void* in, void* out, int n,
                                          int g, void* stream) {
  if (n <= 0 || g < 4 || g > 32 || (g & (g - 1)) || n % g)
    return static_cast<int>(cudaErrorInvalidValue);
  hq_cbr_reduce_check<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n, g);
  return static_cast<int>(cudaGetLastError());
}

// q_out [n] (int32) from the transform lanes y [n, ly], u and v [n, lc]
// (int32, contiguous rows), the quant matrix entry of each lane qm_y [ly],
// qm_c [lc] and the budgets [n]: `group` threads a slice (4, 8, 16 or 32),
// holding its lanes in registers, or with `group` 0 a warp a slice reading
// them from device memory (rdo/cbr.py::group_plan). `flags` (an int64
// word, or null) receives FLAG_QMAX where an index exceeds 119. Returns the
// launch's CUDA error code.
extern "C" int hq_cbr_launch(const void* y, const void* u, const void* v,
                             int ly, int lc, const void* qm_y,
                             const void* qm_c, const void* budgets, int n,
                             int scalar, int group, void* q_out, void* flags,
                             void* stream) {
  if (n <= 0) return 0;
  const bool held = group != 0;
  const int g = held ? group : 32;
  if (ly < 0 || lc < 0 || scalar < 1 || g < 4 || g > 32 || (g & (g - 1)) ||
      (held && ((ly + g - 1) / g > HOLD_Y || (lc + g - 1) / g > HOLD_C)))
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
  a.scalar_shift = (scalar & (scalar - 1)) ? -1 : __builtin_ctz(scalar);
  a.group = g;
  const int slices = THREADS / g;
  void (*kernel)(CbrArgs) = held ? hq_cbr_held : hq_cbr_streamed;
  kernel<<<(n + slices - 1) / slices, THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
