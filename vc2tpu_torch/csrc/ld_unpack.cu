// Bounded interleaved exp-Golomb unpack of a whole LD picture's slices,
// for sm_90a.
//
// Replaces: vc2tpu/vlc/device_unpack.py::unpack_ld_lanes (XLA: the merged
// lockstep lax.scan _decode_scan_raw over both regions of every slice, the
// placement pass _place and the de-interleave of u and v after it). Wire
// semantics are the reference's (src/Library/src/Slices.cpp:195-303): each
// slice holds a 7-bit qIndex, an intlog2(8 size - 7)-bit luma length
// field, a luma region of y_bits bits and then an interleaved U/V region
// of uv_bits bits; both regions start mid-byte and are bounded in bits.
// The host header scan (csrc/ld_scan.cpp) supplies the four bit fields; a
// corrupt y_bits is not clamped, so a region may run past its slice and
// past the payload (read as 1-bits there), as in the JAX package.
//
// Bound on the card: the lanes written (N x (Ly + 2 Lc) int32, 16.6 MB at
// 1080p 4:2:2 with -u 2 -a 2) plus the payload and the fields read (~1.3
// MB): ~5 us at 3.35 TB/s.
//
// The kernel before this design (commit 7f60d0a) walked each region with
// golomb_decode.cuh's
// decode_region, whose three branches (a zero run, a code, a refill)
// diverge across a warp's 32 regions: 180 cycles a region bit, a warp's
// walk 8.3 us at 1080p (clock64() stamps, vc2tpu_torch/testdata/
// ld_stamps.py; PERF.md §6). Computing the code length at every bit
// position in parallel (~6.5 M positions at 1080p), then walking a table
// of them, was slower on the card than that walk, so this design shortens
// the walk's step instead: 95 cycles a region bit, 0.013 ms a picture.
//
// Design. One CTA for each run of S consecutive slices, one thread for
// each of its 2 S regions.
//   stage   LD slices are fixed-size and contiguous, so a CTA's regions
//           span one short byte range, staged in shared memory
//           (golomb::stage_window) unless a corrupt length field stretches
//           it past the window (then the peeks read device memory);
//   decode  each thread walks its region a step at a time, a step a run of
//           zero codes and the code after it: a fresh 64-bit peek at its
//           position (three shared loads; window-relative 32-bit
//           arithmetic when staged), the run's length from one count of
//           leading ones, the code's length from one count of its follow
//           bits and its value from the same peek, where the peek holds
//           the code's terminator. The only branch is the store, so a
//           warp's 32 regions stay converged, and lanes of zero codes keep
//           the zeros the tile starts with;
//   write   the tile (odd row pitch) leaves in 16-byte stores; the U/V row
//           is read back at stride 2, so U (even codes) and V (odd codes)
//           go straight to qu and qv.
// Lane counts whose tile would not fit are decoded with decode_region
// straight to device memory.

#include "golomb_decode.cuh"

namespace {

constexpr int MAX_SLICES = 128;
constexpr int MAX_THREADS = 2 * MAX_SLICES;

// The U/V region's code k: U lane k / 2 for even k, V lane k / 2 for odd.
struct Interleaved {
  int32_t* u;
  int32_t* v;
  __device__ void operator()(int k, int32_t x) const {
    (k & 1 ? v : u)[k >> 1] = x;
  }
};

// Payload words relative to the staged window: word k at w[k].
struct WindowWords {
  const uint32_t* w;
  __device__ uint32_t operator()(int k) const { return w[k]; }
};

// Bits 2j of x to bits j (j < 16).
__device__ __forceinline__ uint32_t even16(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// Decode the region [p, bound) into `row` (zeroed) up to `lanes` codes. A
// step takes a fresh 64-bit peek at p: the run of zero codes (1 bits) at
// its top, then the code after the run where the peek holds its
// terminator (else the next step's peek starts at that code). P is int for
// positions in the staged window, long long in the payload.
template <class Words, class P>
__device__ __forceinline__ void decode_steps(const Words& words, P p,
                                             P bound, int lanes,
                                             int32_t* row) {
  for (int k = 0; k < lanes && p < bound;) {
    const P wk = p >> 5;
    const int o = (int)(p & 31);
    const uint32_t w0 = words(wk), w1 = words(wk + 1), w2 = words(wk + 2);
    unsigned long long w =
        ((unsigned long long)__funnelshift_l(w1, w0, o) << 32) |
        __funnelshift_l(w2, w1, o);
    const P ok = bound - p;  // >= 1
    if (ok < 64) w |= ~0ull >> ok;
    const int ones = __clzll((long long)~w);
    k += min(ones, lanes - k);
    // the code after the run starts before the bound (its first bit is 0,
    // and every bit at or past the bound reads 1); its follow-bit position
    // z, clamped to 62 (the JAX clamp) where the code starts the peek
    const unsigned long long c = ones < 64 ? w << ones : 0ull;
    const int z = min(__clzll((long long)(c & golomb::FOLLOW)), 62);
    const bool code = k < lanes && (ones == 0 || ones + z + 2 <= 64);
    if (code) {
      // data bit j at bit 62 - 2j of c: bit 31 - j of its even bits
      const uint32_t even = (even16((uint32_t)(c >> 32)) << 16) |
                            even16((uint32_t)c);
      const int ndata = z >> 1;  // >= 1
      const uint32_t mag = ((1u << ndata) | (even >> (32 - ndata))) - 1u;
      row[k++] = (int32_t)((c >> (62 - z)) & 1ull ? 0u - mag : mag);
    }
    p += ones + (code ? z + 2 : 0);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
ld_unpack_kernel(const uint8_t* __restrict__ payload, long long nbytes,
                 const int32_t* __restrict__ fields, int n, int ly, int lc,
                 int32_t* __restrict__ qy, int32_t* __restrict__ qu,
                 int32_t* __restrict__ qv, int s, int win_bytes, int stage,
                 uint8_t* __restrict__ staged_flags) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* win = smem;
  int32_t* tile = (int32_t*)(smem + (win_bytes >> 2));
  const int py = ly | 1, pc = (2 * lc) | 1;

  const int t = threadIdx.x;
  const int s0 = blockIdx.x * s;
  const int comp = t >= s;  // 0: luma region, 1: U/V region
  const int i = t - comp * s;
  const bool valid = i < s && s0 + i < n;  // threads past 2 s fill a warp
  const int lanes = comp == 0 ? ly : 2 * lc;
  long long p = 0, bound = 0;
  if (valid) {
    const int j = s0 + i;
    // fields: s_bits, len_bits, y_bits, uv_bits, each [n]
    const long long y_bits = fields[2 * n + j];
    p = (long long)fields[j] + 7 + fields[n + j];
    if (comp) p += y_bits;
    bound = p + (comp ? (long long)fields[3 * n + j] : y_bits);
  }

  if (stage) {  // the tile, zeroed in 16-byte stores
    const int words = s * (py + pc);
    for (int k = t; k < words >> 2; k += blockDim.x)
      ((int4*)tile)[k] = make_int4(0, 0, 0, 0);
    for (int k = (words & ~3) + t; k < words; k += blockDim.x) tile[k] = 0;
  }
  const golomb::Window w =
      golomb::stage_window(payload, nbytes, p, bound, win, win_bytes);
  if (staged_flags != nullptr && t == 0) staged_flags[blockIdx.x] = w.staged;

  if (valid) {
    if (stage) {
      int32_t* row = comp ? tile + s * py + i * pc : tile + i * py;
      if (w.staged) {
        // positions from the window's first bit: the window spans the
        // CTA's regions, so they fit an int
        const long long base = 8 * w.lo16;
        decode_steps(WindowWords{win}, (int)(p - base),
                     (int)(bound - base), lanes, row);
      } else {
        decode_steps(golomb::GlobalWords{payload, nbytes}, p, bound, lanes,
                     row);
      }
    } else {  // lanes too many for the tile: straight to device memory
      const golomb::SharedWords shared{win, w.lo16 >> 2};
      const golomb::GlobalWords global{payload, nbytes};
      if (comp == 0) {
        const golomb::Row out{qy + (size_t)(s0 + i) * ly};
        if (w.staged)
          golomb::decode_region(shared, p, bound, lanes, out, false);
        else
          golomb::decode_region(global, p, bound, lanes, out, false);
      } else {
        const Interleaved out{qu + (size_t)(s0 + i) * lc,
                              qv + (size_t)(s0 + i) * lc};
        if (w.staged)
          golomb::decode_region(shared, p, bound, lanes, out, false);
        else
          golomb::decode_region(global, p, bound, lanes, out, false);
      }
    }
  }
  if (!stage) return;
  __syncthreads();

  const int rows = min(s, n - s0);
  golomb::write_lanes(tile, py, 1, rows, ly, qy + (size_t)s0 * ly);
  golomb::write_lanes(tile + s * py, pc, 2, rows, lc, qu + (size_t)s0 * lc);
  golomb::write_lanes(tile + s * py + 1, pc, 2, rows, lc,
                      qv + (size_t)s0 * lc);
}

}  // namespace

// qy [n, ly], qu and qv [n, lc] from the payload and the fields int32 [4,
// n] (s_bits, len_bits, y_bits, uv_bits): CTAs of s slices (2 s threads,
// rounded up to whole warps), a win_bytes window of staged payload, the
// lanes staged in a shared tile when `stage` (else decoded straight to
// device memory); staged_flags (or null) receive one byte a CTA, 1 where
// its window was staged. Returns the launch's CUDA error code.
extern "C" int ld_unpack_launch(const void* payload, long long nbytes,
                                const void* fields, int n, int ly, int lc,
                                void* qy, void* qu, void* qv, int s,
                                int win_bytes, int stage, void* staged_flags,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (s < 1 || s > MAX_SLICES || win_bytes < 0 || (win_bytes & 15) ||
      ((uintptr_t)payload & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)win_bytes +
      (stage ? 4ull * s * ((ly | 1) + ((2ull * lc) | 1)) : 0ull);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ld_unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (2 * s + 31) & ~31;  // whole warps
  ld_unpack_kernel<<<(n + s - 1) / s, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, nbytes, (const int32_t*)fields, n, ly, lc,
      (int32_t*)qy, (int32_t*)qu, (int32_t*)qv, s, win_bytes, stage,
      (uint8_t*)staged_flags);
  return (int)cudaGetLastError();
}
