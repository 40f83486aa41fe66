// Bounded interleaved exp-Golomb unpack of a whole HQ picture's slice
// components, for sm_90a.
//
// Replaces: vc2tpu/vlc/device_unpack.py::unpack_hq_lanes (XLA: the lockstep
// lax.scan _decode_scan_raw and the placement pass _place). Wire semantics
// are the reference's (src/Library/src/VLC.cpp:54-94 codes, :182-185 reads
// at or past a region's bound return 1-bits; src/Library/src/Slices.cpp:
// 384-467 slice layout), with the JAX package's clamp of codes longer than
// 64 bits (more than 31 data bits); the decode core is golomb_decode.cuh.
//
// Bound on the card: the lanes written (N x (Ly + 2 Lc) int32, ~16.6 MB at
// 1080p 4:2:2) plus the payload read (~1 MB): ~5 us at 3.35 TB/s. Each
// region is a serial walk over its codes (at most 32 a region at 1080p),
// so the kernel needs many regions in flight and every byte it moves
// coalesced.
//
// Design:
// - One CTA for each run of S consecutive slices (S = 32 where the lanes
//   fit: more, smaller CTAs hide the serial decode better than S = 64 or
//   128 at 1080p), one thread for each of its 3 S component regions. The TPU's
//   K-codes-per-peek lockstep scan, window gather and placement pass are
//   not carried over: they existed because the TPU has no per-row control
//   flow.
// - Staged payload (golomb::stage_window): the byte window the CTA's
//   regions span, in shared memory when it fits WINDOW_BYTES; a window
//   over it (regions far apart, which the contract allows) is not staged,
//   and that CTA's peeks read the same words from device memory. Where the
//   caller passes a flag array, each CTA writes there which of the two it
//   took.
// - Staged lanes: decoded lanes go to a shared tile, zeroed first, one row
//   a region at an odd pitch (a warp's writes of one lane index hit 32
//   banks), and leave it as contiguous [S, L] blocks of qy/qu/qv in
//   16-byte coalesced stores. Lane counts whose tile would not fit write
//   straight to device memory instead.

#include "golomb_decode.cuh"

namespace {

constexpr int MAX_SLICES = 128;

__global__ void __launch_bounds__(3 * MAX_SLICES)
hq_unpack_kernel(const uint8_t* __restrict__ payload, long long nbytes,
                 const int32_t* __restrict__ dstart,
                 const int32_t* __restrict__ clen, int n, int ly, int lc,
                 int32_t* __restrict__ qy, int32_t* __restrict__ qu,
                 int32_t* __restrict__ qv, int s, int win_bytes,
                 int stage, uint8_t* __restrict__ staged_flags) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* win = smem;
  int32_t* tile = (int32_t*)(smem + (win_bytes >> 2));
  const int py = ly | 1, pc = lc | 1;

  const int t = threadIdx.x;
  const int s0 = blockIdx.x * s;
  const int comp = (t >= s) + (t >= 2 * s);
  const int i = t - comp * s;
  const bool valid = i < s && s0 + i < n;  // threads past 3 s fill a warp
  const int lanes = comp == 0 ? ly : lc;
  long long p = 0, bound = 0;
  if (valid) {
    const int row = comp * n + s0 + i;
    p = 8ll * dstart[row];
    bound = p + 8ll * clen[row];
  }

  if (stage)
    for (int k = t; k < s * (py + 2 * pc); k += blockDim.x) tile[k] = 0;
  const golomb::Window w =
      golomb::stage_window(payload, nbytes, p, bound, win, win_bytes);
  if (staged_flags != nullptr && t == 0) staged_flags[blockIdx.x] = w.staged;

  if (valid) {
    int32_t* const q = comp == 0 ? qy : (comp == 1 ? qu : qv);
    const golomb::Row out{
        stage ? tile + (comp == 0 ? i * py
                                  : s * (py + (comp - 1) * pc) + i * pc)
              : q + (size_t)(s0 + i) * lanes};
    if (w.staged)
      golomb::decode_region(golomb::SharedWords{win, w.lo16 >> 2}, p, bound,
                            lanes, out, stage);
    else
      golomb::decode_region(golomb::GlobalWords{payload, nbytes}, p, bound,
                            lanes, out, stage);
  }
  if (!stage) return;
  __syncthreads();

  const int rows = min(s, n - s0);
  golomb::write_lanes(tile, py, 1, rows, ly, qy + (size_t)s0 * ly);
  golomb::write_lanes(tile + s * py, pc, 1, rows, lc, qu + (size_t)s0 * lc);
  golomb::write_lanes(tile + s * (py + pc), pc, 1, rows, lc,
                      qv + (size_t)s0 * lc);
}

}  // namespace

extern "C" int hq_unpack_launch(const void* payload, long long nbytes,
                                const void* dstart, const void* clen, int n,
                                int ly, int lc, void* qy, void* qu, void* qv,
                                int s, int win_bytes, int stage,
                                void* staged_flags, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (s < 1 || s > MAX_SLICES || win_bytes < 0 || (win_bytes & 15) ||
      ((uintptr_t)payload & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)win_bytes +
      (stage ? 4ull * s * ((ly | 1) + 2ull * (lc | 1)) : 0ull);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hq_unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (3 * s + 31) & ~31;  // whole warps
  hq_unpack_kernel<<<(n + s - 1) / s, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, nbytes, (const int32_t*)dstart,
      (const int32_t*)clen, n, ly, lc, (int32_t*)qy, (int32_t*)qu,
      (int32_t*)qv, s, win_bytes, stage, (uint8_t*)staged_flags);
  return (int)cudaGetLastError();
}
