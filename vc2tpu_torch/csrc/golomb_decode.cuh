// The bounded interleaved exp-Golomb decode core shared by the unpack
// kernels (hq_unpack.cu, ld_unpack.cu), for sm_90a.
//
// Wire semantics are the reference's (src/Library/src/VLC.cpp:54-94 codes,
// :182-185 reads at or past a region's bound return 1-bits), with the JAX
// package's clamp of codes longer than 64 bits (more than 31 data bits).
// A region is [p, bound) in absolute bits of the payload, so byte-granular
// (HQ) and bit-granular (LD) regions decode alike. Bytes past the payload
// end read 0xFF.
//
// Pieces:
// - peek64: 64 stream bits from three big-endian words and two
//   __funnelshift_l, the bits at or past the bound forced to 1; the words
//   come from a CTA's staged window in shared memory (SharedWords) or from
//   device memory (GlobalWords);
// - stage_window: a CTA finds the byte window its regions span (warp
//   shuffles, then shared atomics) and copies it to shared memory with
//   16-byte loads when it fits, else its peeks read device memory;
// - decode_region: one peek serves every code that ends inside its 64
//   bits, a run of zero codes (single 1 bits) is counted with one __clzll,
//   the data bits are gathered by a five-step compaction;
// - write_lanes: a [rows, L] block of lanes from a shared tile to device
//   memory in 16-byte stores.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace golomb {

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

// A row of lanes: lane k at p[k].
struct Row {
  int32_t* p;
  __device__ void operator()(int k, int32_t v) const { p[k] = v; }
};

// Decode the region [p, bound) into lanes 0 .. lanes of `out` (a functor
// storing lane k), which hold zeros already when `zeroed`. One peek serves
// every code that ends inside its 64 bits: w holds the stream's bits
// [p, p + avail) at its top. A run of zero codes (single 1 bits) is
// counted with one __clzll and, in zeroed lanes, costs no store: past the
// bound the 1-fill decodes as zeros too, so the lanes it covers are the
// zeros they hold anyway.
template <class Words, class Out>
__device__ __forceinline__ void decode_region(const Words& words, long long p,
                                              long long bound, int lanes,
                                              const Out& out, bool zeroed) {
  int nd = 0;
  unsigned long long w = 0;
  int avail = 0;
  while (nd < lanes && p < bound) {
    const int ones = __clzll((long long)~w);
    if (ones > 0) {  // zero codes; ones <= avail (w is 0 past avail)
      const int k = min(ones, lanes - nd);
      if (!zeroed)
        for (int i = 0; i < k; ++i) out(nd + i, 0);
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
    out(nd++, (int32_t)(uint32_t)(sign ? 0ull - mag : mag));
    p += z + 2;
    w = z + 2 < 64 ? w << (z + 2) : 0ull;
    avail -= z + 2;
  }
  if (!zeroed)
    for (; nd < lanes; ++nd) out(nd, 0);
}

// The byte window of a CTA's regions: its 16-byte aligned start and its
// length (to 16 bytes past the aligned end, for the peeks' look-ahead), and
// whether it was staged in shared memory.
struct Window {
  long long lo16;
  bool staged;
};

// Called by every thread of the CTA. Each thread passes its region
// [p, bound) (empty when it has none); the CTA stages the bytes its
// non-empty regions span in `win` (win_bytes bytes) as big-endian words,
// bytes past the payload end as 0xFF, when they fit. Ends with a barrier.
__device__ __forceinline__ Window stage_window(const uint8_t* payload,
                                               long long nbytes, long long p,
                                               long long bound, uint32_t* win,
                                               int win_bytes) {
  __shared__ long long s_lo, s_hi;
  const int t = threadIdx.x;
  if (t == 0) {
    s_lo = LLONG_MAX;
    s_hi = -1;
  }
  __syncthreads();
  // the warp's extremes first, then one atomic a warp
  long long lo = bound > p ? p >> 3 : LLONG_MAX;
  long long hi = bound > p ? bound >> 3 : -1;
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

  const bool any = s_hi >= 0;
  const long long lo16 = any ? (s_lo & ~15ll) : 0;
  const long long span = any ? ((s_hi + 15) & ~15ll) + 16 - lo16 : 0;
  const bool staged = span <= win_bytes;
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
  return Window{lo16, staged};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Copy a [rows, L] block of lanes from a shared tile to device memory:
// lane (r, c) is tile[r * pitch + c * stride]; 16 bytes a store where L
// allows it.
__device__ __forceinline__ void write_lanes(const int32_t* tile, int pitch,
                                            int stride, int rows, int L,
                                            int32_t* dst) {
  if (L == 0) return;
  const int words = rows * L;
  const int vec = (L & 3) == 0 && aligned16(dst) ? 4 : 1;
  const int step = vec * (int)blockDim.x;
  // the flat index f walks the block; (r, c) follow it without a division
  // in the loop
  int f = vec * (int)threadIdx.x;
  int r = f / L, c = f - (f / L) * L;
  const int dr = step / L, dc = step - dr * L;
  for (; f < words; f += step) {
    const int32_t* q = tile + r * pitch + c * stride;
    if (vec == 4)
      *(int4*)(dst + f) =
          make_int4(q[0], q[stride], q[2 * stride], q[3 * stride]);
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

}  // namespace golomb
