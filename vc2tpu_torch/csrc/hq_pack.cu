// HQ slice payload assembly on the card: the port of the JAX package's
// XLA function vc2tpu/vlc/device_pack.py::pack_hq_core (reference
// src/Library/src/Slices.cpp:305-467 over VLC.cpp:21-94).
//
// Each slice of the payload is, in order: `prefix` zero bytes, the qIndex
// byte, then for each component a length byte (its bytes / scalar) and its
// interleaved signed exp-Golomb codes, cut at the component's byte bound
// by the bounded-write rule (a trailing run of zero coefficients is 1-bit
// codes that may fall past the bound) and zero-filled to the bound. HQ CBR
// gives the third component the rest of the slice's byte budget.
//
// Two launches, one warp a slice in each:
//   hq_pack_sizes  each lane sizes a lane's code; a warp sum and a ballot
//                  give the bits a component uses (up to its last non-zero
//                  coefficient), hence the scaled component bytes, the
//                  slice total and the error flags;
//   hq_pack_write  after an exclusive scan of the totals (torch.cumsum,
//                  between the launches), each lane forms its code in 64
//                  bits, a warp prefix sum of the code lengths gives its
//                  bit offset, and the codes are ORed (shared-memory
//                  atomics) into a window of words of the warp's slice, in
//                  byte order with the header bytes and the zero fill; the
//                  warp then stores the window's bytes.
// Slices start on byte boundaries, so every byte of the payload belongs to
// one warp: nothing is zeroed beforehand and no global atomics are needed.
// Every int32 value codes in at most 64 bits (|v| + 1 <= 2^31 + 1), so
// there is no overflow case and no host fallback. A slice larger than the
// window (WINDOW_WORDS * 4 bytes) is assembled one window after another.
//
// What bounds it on the card: the quantised lanes read twice (once a
// launch) and the payload written once; at 1080p that is ~5 us of memory
// time against a few arithmetic operations a lane. This first form keeps
// one warp a slice in both launches for simplicity: at ConstQ rates most
// slices hold a few bytes, so most of a warp's work is the loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FLAG_SCALAR = 2;     // a component's length byte exceeds 255
constexpr int FLAG_CBR_FIT = 4;    // CBR: y + u leave v too few bytes
constexpr int FLAG_QINDEX = 8;     // a qIndex exceeds 8 bits
constexpr int FLAG_VLEN = 32;      // CBR: v's forced length byte exceeds 255

constexpr int WARPS = 8;                          // slices a CTA
constexpr int WINDOW_WORDS = 256;                 // a warp's shared window
constexpr int WINDOW_BYTES = 4 * WINDOW_WORDS;
constexpr long long WINDOW_BITS = 8LL * WINDOW_BYTES;
constexpr unsigned FULL = 0xffffffffu;

struct Lanes {
  const int32_t* p[3];   // qy [n, len[0]], qu [n, len[1]], qv [n, len[2]]
  int len[3];
};

__device__ __forceinline__ uint32_t magnitude(int32_t v) {
  return v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
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

// The code of v in its low nb = code_bits(v) bits, MSB first on the wire:
// [0 u_{k-2} 0 u_{k-3} .. 0 u_0 1 s], u = |v| + 1 of k bits, s the sign.
__device__ __forceinline__ unsigned long long code_of(int32_t v, int nb) {
  if (v == 0) return 1ull;
  const uint32_t u = magnitude(v) + 1u;
  const uint32_t low = u ^ (1u << (nb / 2 - 1));      // u below its top bit
  return (((spread(low) << 1) | 1ull) << 1) | (v < 0 ? 1ull : 0ull);
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// OR the n (1..64) bits of `code`, MSB first, into the window at bit `pos`
// from the window's start; bits outside the window are dropped. Word w of
// the window holds bytes 4w..4w+3 big-endian, so bit b of the window is
// bit 31 - (b & 31) of word b >> 5.
__device__ __forceinline__ void put_bits(uint32_t* win, long long pos, int n,
                                         unsigned long long code) {
  const long long end = pos + n;
  if (end <= 0 || pos >= WINDOW_BITS) return;
  if (end > WINDOW_BITS) {
    const int cut = static_cast<int>(end - WINDOW_BITS);
    code >>= cut;
    n -= cut;
  }
  if (pos < 0) {
    n += static_cast<int>(pos);
    pos = 0;
    code &= n >= 64 ? ~0ull : (1ull << n) - 1ull;
  }
  int p = static_cast<int>(pos);
  while (n > 0) {
    const int room = 32 - (p & 31);
    const int take = n < room ? n : room;
    const uint32_t mask = take == 32 ? FULL : (1u << take) - 1u;
    const uint32_t part = static_cast<uint32_t>(code >> (n - take)) & mask;
    atomicOr(&win[p >> 5], part << (room - take));
    n -= take;
    p += take;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
hq_pack_sizes(Lanes lanes, const int32_t* __restrict__ q_idx,
              const int32_t* __restrict__ sizes, int n, int prefix,
              int scalar, int32_t* __restrict__ comp_bytes,
              int32_t* __restrict__ totals, int32_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (slice >= n) return;                 // whole warps leave together
  int scaled[3];
  for (int c = 0; c < 3; ++c) {
    const int len = lanes.len[c];
    const int32_t* row = lanes.p[c] + static_cast<long long>(slice) * len;
    int bits = 0, last = -1;
    for (int j0 = 0; j0 < len; j0 += 32) {
      const int j = j0 + lane;
      const int32_t v = j < len ? row[j] : 0;
      bits += j < len ? code_bits(v) : 0;
      const unsigned nz = __ballot_sync(FULL, v != 0);
      if (nz) last = j0 + 31 - __clz(nz);
    }
    // the trailing zeros after the last non-zero are 1-bit codes
    const int used = warp_sum(bits) - (len - 1 - last);
    scaled[c] = ((used + 7) / 8 + scalar - 1) / scalar;
  }
  if (lane) return;
  int f = 0;
  if (scaled[0] > 255 || scaled[1] > 255) f |= FLAG_SCALAR;
  const int yb = scaled[0] * scalar, ub = scaled[1] * scalar;
  int vb;
  if (sizes) {
    vb = sizes[slice] - 4 - yb - ub;
    if (vb < scaled[2] * scalar) f |= FLAG_CBR_FIT;
    if (vb / scalar > 255) f |= FLAG_VLEN;
  } else {
    vb = scaled[2] * scalar;
    if (scaled[2] > 255) f |= FLAG_SCALAR;
  }
  if (q_idx[slice] > 255) f |= FLAG_QINDEX;
  comp_bytes[3 * slice] = yb;
  comp_bytes[3 * slice + 1] = ub;
  comp_bytes[3 * slice + 2] = vb;
  totals[slice] = prefix + 4 + yb + ub + vb;
  if (f) atomicOr(flags, f);
}

__global__ void __launch_bounds__(WARPS * 32)
hq_pack_write(Lanes lanes, const int32_t* __restrict__ q_idx,
              const int32_t* __restrict__ comp_bytes,
              const int32_t* __restrict__ totals,
              const long long* __restrict__ starts, int n, int prefix,
              int scalar, uint8_t* __restrict__ out) {
  __shared__ uint32_t smem[WARPS * WINDOW_WORDS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = blockIdx.x * WARPS + warp;
  if (slice >= n) return;
  uint32_t* win = smem + warp * WINDOW_WORDS;
  const int total = totals[slice];
  if (lane == 0) reinterpret_cast<int32_t*>(out)[slice] = total;
  uint8_t* dst = out + 4LL * n + starts[slice];
  const int yb = comp_bytes[3 * slice];
  const int ub = comp_bytes[3 * slice + 1];
  const int vb = comp_bytes[3 * slice + 2];
  const int data_at[3] = {prefix + 2, prefix + 3 + yb, prefix + 4 + yb + ub};
  const int bound[3] = {8 * yb, 8 * ub, 8 * vb};
  // lanes 0-3 each own one header byte: qIndex and the three lengths
  int hdr_at = prefix, hdr = q_idx[slice];
  if (lane == 1) { hdr_at = prefix + 1; hdr = yb / scalar; }
  if (lane == 2) { hdr_at = prefix + 2 + yb; hdr = ub / scalar; }
  if (lane == 3) { hdr_at = prefix + 3 + yb + ub; hdr = vb / scalar; }
  for (int w0 = 0; w0 < total; w0 += WINDOW_BYTES) {
    const long long lo = 8LL * w0;
    const int nbytes = min(WINDOW_BYTES, total - w0);
    for (int i = lane; i < (nbytes + 3) / 4; i += 32) win[i] = 0;
    __syncwarp();
    if (lane < 4) put_bits(win, 8LL * hdr_at - lo, 8, hdr & 0xFF);
    for (int c = 0; c < 3; ++c) {
      const int len = lanes.len[c];
      const int32_t* row = lanes.p[c] + static_cast<long long>(slice) * len;
      const long long at = 8LL * data_at[c] - lo;
      int carry = 0;                       // bits of the codes before j0
      for (int j0 = 0; j0 < len && carry < bound[c]; j0 += 32) {
        const int j = j0 + lane;
        const int32_t v = j < len ? row[j] : 0;
        const int nb = j < len ? code_bits(v) : 0;
        const int incl = warp_inclusive_scan(nb, lane);
        const int off = carry + incl - nb;
        const int keep = max(0, min(nb, bound[c] - off));
        if (keep > 0)
          put_bits(win, at + off, keep, code_of(v, nb) >> (nb - keep));
        carry += __shfl_sync(FULL, incl, 31);
      }
    }
    __syncwarp();
    for (int i = lane; i < nbytes; i += 32)
      dst[w0 + i] = static_cast<uint8_t>(win[i >> 2] >> (24 - 8 * (i & 3)));
    __syncwarp();
  }
}

Lanes make_lanes(const void* qy, const void* qu, const void* qv, int ly,
                 int lc) {
  Lanes l;
  l.p[0] = static_cast<const int32_t*>(qy);
  l.p[1] = static_cast<const int32_t*>(qu);
  l.p[2] = static_cast<const int32_t*>(qv);
  l.len[0] = ly;
  l.len[1] = lc;
  l.len[2] = lc;
  return l;
}

}  // namespace

// Launch 1: comp_bytes int32 [n, 3], totals int32 [n] and the flags word
// (int32, zeroed by the caller) from the lanes (int32, contiguous rows).
// `sizes` is the CBR byte budget of each slice, or null for ConstQ.
// Returns the launch's CUDA error code.
extern "C" int hq_pack_sizes_launch(const void* qy, const void* qu,
                                    const void* qv, int ly, int lc,
                                    const void* q_idx, const void* sizes,
                                    int n, int prefix, int scalar,
                                    void* comp_bytes, void* totals,
                                    void* flags, void* stream) {
  if (n <= 0) return 0;
  hq_pack_sizes<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      make_lanes(qy, qu, qv, ly, lc), static_cast<const int32_t*>(q_idx),
      static_cast<const int32_t*>(sizes), n, prefix, scalar,
      static_cast<int32_t*>(comp_bytes), static_cast<int32_t*>(totals),
      static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: out = [totals int32 [n] | payload bytes], the payload of slice
// i at byte 4n + starts[i] (starts int64 [n], the exclusive scan of the
// totals). Returns the launch's CUDA error code.
extern "C" int hq_pack_write_launch(const void* qy, const void* qu,
                                    const void* qv, int ly, int lc,
                                    const void* q_idx, const void* comp_bytes,
                                    const void* totals, const void* starts,
                                    int n, int prefix, int scalar, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  hq_pack_write<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      make_lanes(qy, qu, qv, ly, lc), static_cast<const int32_t*>(q_idx),
      static_cast<const int32_t*>(comp_bytes),
      static_cast<const int32_t*>(totals),
      static_cast<const long long*>(starts), n, prefix, scalar,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
