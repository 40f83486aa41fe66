// Bounded interleaved exp-Golomb unpack of a whole HQ picture's slice
// components, for sm_90a.
//
// Replaces: vc2tpu/vlc/device_unpack.py::unpack_hq_lanes (XLA: the lockstep
// lax.scan _decode_scan_raw and the placement pass _place). Wire semantics
// are the reference's (src/Library/src/VLC.cpp:54-94 codes, :182-185 reads
// at or past a region's bound return 1-bits; src/Library/src/Slices.cpp:
// 384-467 slice layout), with the JAX package's clamp of codes longer than
// 64 bits (more than 31 data bits).
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
// - Staged payload: the CTA finds the byte window its regions span
//   (warp shuffles, then shared atomics) and copies it to shared memory
//   with 16-byte
//   loads, as big-endian 32-bit words, bytes past the payload end as 0xFF.
//   A 64-bit peek is then three aligned words and two __funnelshift_l. A
//   window over WINDOW_BYTES (regions far apart, which the contract
//   allows) is not staged: that CTA's peeks read the same words from
//   device memory, with the same 0xFF rule. Where the caller passes a
//   flag array, each CTA writes there which of the two it took.
// - One peek serves every code that ends inside its 64 bits, and a run
//   of zero codes (single 1 bits, most of a picture's coefficients) is
//   counted with one __clzll and stores nothing: the lane tile was zeroed.
//   The data bits of a code sit at every other bit of the peek; a
//   five-step bit compaction gathers them, with no loop over the bits.
// - Staged lanes: decoded lanes go to a shared tile, zeroed first, one row
//   a region at an odd pitch (a warp's writes of one lane index hit 32
//   banks), and leave it as contiguous [S, L] blocks of qy/qu/qv in
//   16-byte coalesced stores. Lane counts whose tile would not fit write
//   straight to device memory instead.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLICES = 128;
constexpr unsigned long long FOLLOW = 0xAAAAAAAAAAAAAAAAull;

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// Big-endian word k of the payload (bytes 4k..4k+3); bytes past the end
// read 0xFF.
__device__ __forceinline__ uint32_t global_word(const uint8_t* payload,
                                                long long nbytes,
                                                long long k) {
  const long long b = 4 * k;
  if (b + 4 <= nbytes) return bswap(__ldg((const uint32_t*)payload + k));
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w = (w << 8) | (b + i < nbytes ? (uint32_t)payload[b + i] : 0xFFu);
  return w;
}

struct SharedWords {
  const uint32_t* w;
  long long k0;  // payload word index of w[0]
  __device__ uint32_t operator()(long long k) const { return w[k - k0]; }
};

struct GlobalWords {
  const uint8_t* payload;
  long long nbytes;
  __device__ uint32_t operator()(long long k) const {
    return global_word(payload, nbytes, k);
  }
};

// 64 bits of the stream starting at absolute bit p; bits at or past
// `bound` read as 1.
template <class Words>
__device__ __forceinline__ unsigned long long peek64(const Words& words,
                                                     long long p,
                                                     long long bound) {
  const long long k = p >> 5;
  const int o = (int)(p & 31);
  const uint32_t w0 = words(k), w1 = words(k + 1), w2 = words(k + 2);
  unsigned long long w =
      ((unsigned long long)__funnelshift_l(w1, w0, o) << 32) |
      __funnelshift_l(w2, w1, o);
  const long long ok = bound - p;  // >= 1: the caller decodes only in-bound
  if (ok < 64) w |= ~0ull >> ok;
  return w;
}

// bit 2j of w -> bit j, for j < 32
__device__ __forceinline__ unsigned long long even_bits(unsigned long long x) {
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFull;
  return (x | (x >> 16)) & 0x00000000FFFFFFFFull;
}

// Decode the region [p, bound) into out[0 .. lanes), which holds zeros
// already when `zeroed`. One peek serves every code that ends inside its
// 64 bits: w holds the stream's bits [p, p + avail) at its top. A run of
// zero codes (single 1 bits) is counted with one __clzll and, in a zeroed
// row, costs no store: past the bound the 1-fill decodes as zeros too, so
// the lanes it covers are the zeros they hold anyway.
template <class Words>
__device__ __forceinline__ void decode_region(const Words& words, long long p,
                                              long long bound, int lanes,
                                              int32_t* out, bool zeroed) {
  int nd = 0;
  unsigned long long w = 0;
  int avail = 0;
  while (nd < lanes && p < bound) {
    const int ones = __clzll((long long)~w);
    if (ones > 0) {  // zero codes; ones <= avail (w is 0 past avail)
      const int k = min(ones, lanes - nd);
      if (!zeroed)
        for (int i = 0; i < k; ++i) out[nd + i] = 0;
      nd += k;
      p += k;
      w = k < 64 ? w << k : 0ull;
      avail -= k;
      continue;
    }
    // first 1 follow bit (even code position) ends the magnitude
    int z = __clzll((long long)(w & FOLLOW));
    if (z + 2 > avail) {  // the code does not end inside w (or w is empty)
      if (avail == 64) {
        z = 62;  // no terminator in 64 bits: the JAX clamp
      } else {
        w = peek64(words, p, bound);
        avail = 64;
        continue;
      }
    }
    const int ndata = z >> 1;
    // data bit j sits at bit 62 - 2j: bit 31 - j of the even bits
    const unsigned long long data = even_bits(w) >> (32 - ndata);
    const unsigned long long mag = ((1ull << ndata) | data) - 1ull;
    const unsigned long long sign = (w >> (62 - z)) & 1ull;
    // +-mag in 64 bits, truncated to int32 as the JAX unpack does
    out[nd++] = (int32_t)(uint32_t)(sign ? 0ull - mag : mag);
    p += z + 2;
    w = z + 2 < 64 ? w << (z + 2) : 0ull;
    avail -= z + 2;
  }
  if (!zeroed)
    for (; nd < lanes; ++nd) out[nd] = 0;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Copy a [rows, L] block of lanes from the tile (row pitch L | 1) to
// device memory, 16 bytes a store where L allows it.
__device__ void write_lanes(const int32_t* tile, int rows, int L,
                            int32_t* dst) {
  if (L == 0) return;
  const int pitch = L | 1;
  const int words = rows * L;
  const int vec = (L & 3) == 0 && aligned16(dst) ? 4 : 1;
  const int step = vec * (int)blockDim.x;
  // the flat index f walks the block; (r, c) follow it without a division
  // in the loop
  int f = vec * (int)threadIdx.x;
  int r = f / L, c = f - (f / L) * L;
  const int dr = step / L, dc = step - dr * L;
  for (; f < words; f += step) {
    const int32_t* q = tile + r * pitch + c;
    if (vec == 4)
      *(int4*)(dst + f) = make_int4(q[0], q[1], q[2], q[3]);
    else
      dst[f] = q[0];
    r += dr;
    c += dc;
    if (c >= L) {
      c -= L;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(3 * MAX_SLICES)
hq_unpack_kernel(const uint8_t* __restrict__ payload, long long nbytes,
                 const int32_t* __restrict__ dstart,
                 const int32_t* __restrict__ clen, int n, int ly, int lc,
                 int32_t* __restrict__ qy, int32_t* __restrict__ qu,
                 int32_t* __restrict__ qv, int s, int win_bytes,
                 int stage, uint8_t* __restrict__ staged_flags) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ long long s_lo, s_hi;
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

  if (t == 0) {
    s_lo = LLONG_MAX;
    s_hi = -1;
  }
  if (stage)
    for (int k = t; k < s * (py + 2 * pc); k += blockDim.x) tile[k] = 0;
  __syncthreads();
  // the warp's extremes first, then one atomic a warp
  long long lo = valid && bound > p ? p >> 3 : LLONG_MAX;
  long long hi = valid && bound > p ? bound >> 3 : -1;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, d));
  }
  if ((t & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();

  // the byte window of this CTA's regions, staged when it fits
  const bool any = s_hi >= 0;
  const long long lo16 = any ? (s_lo & ~15ll) : 0;
  const long long span = any ? ((s_hi + 15) & ~15ll) + 16 - lo16 : 0;
  const bool staged = span <= win_bytes;
  if (staged_flags != nullptr && t == 0) staged_flags[blockIdx.x] = staged;
  if (staged) {
    for (int c = t; c < (int)(span >> 4); c += blockDim.x) {
      const long long b = lo16 + 16ll * c;
      uint4 v;
      if (b + 16 <= nbytes) {
        v = __ldg((const uint4*)(payload + b));
        v = make_uint4(bswap(v.x), bswap(v.y), bswap(v.z), bswap(v.w));
      } else {
        const long long k = b >> 2;
        v = make_uint4(global_word(payload, nbytes, k),
                       global_word(payload, nbytes, k + 1),
                       global_word(payload, nbytes, k + 2),
                       global_word(payload, nbytes, k + 3));
      }
      *(uint4*)(win + 4 * c) = v;
    }
  }
  __syncthreads();

  if (valid) {
    int32_t* const q = comp == 0 ? qy : (comp == 1 ? qu : qv);
    int32_t* const out =
        stage ? tile + (comp == 0 ? i * py
                                  : s * (py + (comp - 1) * pc) + i * pc)
              : q + (size_t)(s0 + i) * lanes;
    if (staged)
      decode_region(SharedWords{win, lo16 >> 2}, p, bound, lanes, out, stage);
    else
      decode_region(GlobalWords{payload, nbytes}, p, bound, lanes, out,
                    stage);
  }
  if (!stage) return;
  __syncthreads();

  const int rows = min(s, n - s0);
  write_lanes(tile, rows, ly, qy + (size_t)s0 * ly);
  write_lanes(tile + s * py, rows, lc, qu + (size_t)s0 * lc);
  write_lanes(tile + s * (py + pc), rows, lc, qv + (size_t)s0 * lc);
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
