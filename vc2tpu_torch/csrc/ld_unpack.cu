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
// Design: the decode core of hq_unpack.cu (golomb_decode.cuh), with two
// regions a slice. One CTA for each run of S consecutive slices, one
// thread for each region. LD slices are fixed-size and contiguous, so a
// CTA's regions span one short byte range (~830 bytes at 1080p), staged in
// shared memory unless a corrupt length field stretches it past
// WINDOW_BYTES (then its peeks read device memory). Lanes go to a zeroed
// shared tile (odd row pitch) and leave it in 16-byte stores; the U/V row
// is read back at stride 2, so U (even codes) and V (odd codes) are
// written straight to qu and qv with no de-interleave pass. Lane counts
// whose tile would not fit write straight to device memory.

#include "golomb_decode.cuh"

namespace {

constexpr int MAX_SLICES = 128;

// The U/V region's code k: U lane k / 2 for even k, V lane k / 2 for odd.
struct Interleaved {
  int32_t* u;
  int32_t* v;
  __device__ void operator()(int k, int32_t x) const {
    (k & 1 ? v : u)[k >> 1] = x;
  }
};

__global__ void __launch_bounds__(2 * MAX_SLICES)
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

  if (stage)
    for (int k = t; k < s * (py + pc); k += blockDim.x) tile[k] = 0;
  const golomb::Window w =
      golomb::stage_window(payload, nbytes, p, bound, win, win_bytes);
  if (staged_flags != nullptr && t == 0) staged_flags[blockIdx.x] = w.staged;

  if (valid) {
    const golomb::SharedWords shared{win, w.lo16 >> 2};
    const golomb::GlobalWords global{payload, nbytes};
    if (stage || comp == 0) {
      const golomb::Row out{stage ? tile + (comp ? s * py + i * pc : i * py)
                                  : qy + (size_t)(s0 + i) * ly};
      if (w.staged)
        golomb::decode_region(shared, p, bound, lanes, out, stage);
      else
        golomb::decode_region(global, p, bound, lanes, out, stage);
    } else {
      const Interleaved out{qu + (size_t)(s0 + i) * lc,
                            qv + (size_t)(s0 + i) * lc};
      if (w.staged)
        golomb::decode_region(shared, p, bound, lanes, out, false);
      else
        golomb::decode_region(global, p, bound, lanes, out, false);
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
