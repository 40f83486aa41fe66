// The signed interleaved exp-Golomb code writer and the exact quantiser
// quotient that the encode kernels share (csrc/hq_pack.cu and
// csrc/ld_pack.cu write codes; they and csrc/ld_rate.cu quantise with
// `quotient`). Reference src/Library/src/VLC.cpp:21-94 and
// Quantisation.cpp:69-76.
//
// A code of v, MSB first on the wire: [0 u_{k-2} 0 u_{k-3} .. 0 u_0 1 s],
// u = |v| + 1 of k bits, s the sign; 0 codes as the single bit 1. Every
// int32 codes in at most 64 bits (|v| + 1 <= 2^31 + 1).
//
// BitAccumulator appends codes, MSB first, to a run of 32-bit words that
// a sink stores: sink.word(index, bits, shared) receives each word the
// accumulator fills, `shared` for the first word it touches and the last
// (partial) one, which other writers' bits may share.

#pragma once

#include <cstdint>

namespace vc2 {

__device__ __forceinline__ uint32_t magnitude(int32_t v) {
  return v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
}

// |quant(v, q)| = (|v| << 2) / |factor(q)| for m = |v| (at most 2^31), af =
// |factor(q)| (at least 4) and rc = ceil(2^64 / af), exact for every int32
// and without a branch: the high 64 bits of n * rc, n = m << 2 < 2^34,
// exceed n / af by less than n / 2^64 < 2^-30, so they are the quotient or
// one more, which one multiply corrects (q * af <= n + af < 2^64). The LD
// rate control runs this on every lane of every probe, where a branch to
// a 64-bit divide would end the straight-line code the compiler
// interleaves; the packs quantise with it too.
//
// small_quotient below is shorter but holds for |v| < 2^30 only: the CBR
// search and the LD body sizing take it where every lane a thread or warp
// sizes is below that. On the H100 this 64-bit form made the CBR search
// 10-14 % slower than small_quotient with a 64-bit divide above 2^30, and
// forming its high bits from two products of m made the LD rate
// control's recurrence 5 % slower (chip_smoke.py's kernel times).
__device__ __forceinline__ uint32_t quotient(uint32_t m, uint32_t af,
                                             unsigned long long rc) {
  const unsigned long long n = static_cast<unsigned long long>(m) << 2;
  const unsigned long long q = __umul64hi(n, rc);
  return static_cast<uint32_t>(q - (q * af > n ? 1ull : 0ull));
}

// The same quotient for m < 2^30 only: n = m << 2 fits 32 bits, and the
// high 64 bits of n * rc from two 32 x 32 products (the low product's
// carry left out) are exact there.
__device__ __forceinline__ uint32_t small_quotient(uint32_t m,
                                                   unsigned long long rc) {
  const uint32_t n = m << 2;
  return static_cast<uint32_t>(
      (static_cast<unsigned long long>(n) * static_cast<uint32_t>(rc >> 32) +
       __umulhi(n, static_cast<uint32_t>(rc))) >> 32);
}

// quant(v, q) of vc2tpu_torch/quant/quantiser.py: sign(v) * ((|v| << 2) /
// factor(q)), C division by the int32-wrapped factor, wrapped to int32.
// `factors` and `recips` are the 120-entry tables (factor, ceil(2^64 /
// |factor|)) of the kernel's generated header.
__device__ __forceinline__ int32_t quantise(int32_t v, int q,
                                            const int32_t* factors,
                                            const unsigned long long* recips) {
  const int32_t f = factors[q];
  const uint32_t r = quotient(magnitude(v), magnitude(f), recips[q]);
  return static_cast<int32_t>(((v < 0) != (f < 0)) ? 0u - r : r);
}

// Bits of the signed interleaved exp-Golomb code of v: 1 for 0, else
// 2 * bit_length(|v| + 1), at most 64.
__device__ __forceinline__ int code_bits(int32_t v) {
  return v == 0 ? 1 : 2 * (32 - __clz(magnitude(v) + 1u));
}

// Bit j of m to bit 2j.
__device__ __forceinline__ unsigned long long spread(uint32_t m) {
  unsigned long long x = m;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  x = (x | (x << 1)) & 0x5555555555555555ull;
  return x;
}

// Bit j of m (< 2^16) to bit 2j.
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// The code of v in its low nb = code_bits(v) bits, MSB first on the wire;
// in 32-bit arithmetic when it fits 32 bits (|v| < 2^16).
__device__ __forceinline__ unsigned long long code_of(int32_t v, int nb) {
  if (v == 0) return 1ull;
  const uint32_t u = magnitude(v) + 1u;
  const uint32_t low = u ^ (1u << (nb / 2 - 1));      // u below its top bit
  const uint32_t sign = v < 0 ? 1u : 0u;
  if (nb <= 32) return (spread16(low) << 2) | 2u | sign;
  return (((spread(low) << 1) | 1ull) << 1) | sign;
}

// Codes appended one after another from a bit position: the accumulator
// holds the bits of the word it fills, MSB first from bit 63.
template <class Sink>
struct BitAccumulator {
  Sink sink;
  long long word;             // the index of the word being filled
  unsigned long long acc;     // `fill` bits, MSB first from bit 63
  int fill;
  bool first;

  __device__ void start(const Sink& s, long long pos) {
    sink = s;
    word = pos >> 5;
    fill = static_cast<int>(pos & 31);
    acc = 0;
    first = true;
  }
  __device__ void put32(uint32_t code, int n) {     // 1 <= n <= 32
    acc |= static_cast<unsigned long long>(code) << (64 - fill - n);
    fill += n;
    if (fill >= 32) {
      sink.word(word, static_cast<uint32_t>(acc >> 32), first);
      first = false;
      acc <<= 32;
      fill -= 32;
      ++word;
    }
  }
  __device__ void put(unsigned long long code, int n) {    // 1 <= n <= 64
    if (n > 32) {
      put32(static_cast<uint32_t>(code >> 32), n - 32);
      n = 32;
    }
    put32(static_cast<uint32_t>(code), n);
  }
  __device__ void put_one() {                        // the code of 0
    acc |= 1ull << (63 - fill);
    if (++fill == 32) {
      sink.word(word, static_cast<uint32_t>(acc >> 32), first);
      first = false;
      acc <<= 32;
      fill = 0;
      ++word;
    }
  }
  // Store the partial last word; returns the index of the next word.
  __device__ long long finish() {
    if (fill) {
      sink.word(word, static_cast<uint32_t>(acc >> 32), true);
      return word + 1;
    }
    return word;
  }
};

}  // namespace vc2
