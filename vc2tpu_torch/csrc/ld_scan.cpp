// LD slice header scan and LL DC-prediction dequantise on the host: the
// twin of the JAX package's vc2tpu/slices/ld.py::ld_header_fields and
// vc2tpu/pipeline/decoder.py::ld_ll_grids, whose recurrence is
// vc2tpu/_native/vc2host.cpp:1859-1876 (ld_ll_dequantise_grid, with
// predict_dc, c_scale and adjust_q). The port loads no library of the JAX
// package, so this is its own copy; the recurrence's arithmetic is
// dc_predict.cuh's, which the card's wavefront (ld_dc.cu) shares.
//
// Per slice (reference Slices.cpp:195-303): a 7-bit qIndex, an
// intlog2(8 size - 7)-bit luma length y_bits, the luma region of y_bits
// bits, then the U/V region of uv_bits = max(8 size - 7 - len_bits -
// y_bits, 0) bits. The luma bound is not clamped to the slice (neither is
// the JAX package's). Reads past the payload give 1-bits (its 0xFF pad).
//
// ld_fields walks the slices' headers alone: the q indices and the four
// bit fields, from one big-endian 32-bit load at each slice's first byte.
// It is the host half of the single-device LD decode, whose LL codes
// ld_unpack.cu decodes with the rest of each region and whose DC
// prediction ld_dc.cu runs on the card.
//
// ld_read walks the slices as ld_fields does and also decodes the LL band
// of every slice, the first nll codes of its luma region and the first
// 2 nllc codes of its interleaved U/V region (the bounded exp-Golomb rule
// of golomb_decode.cuh, codes of more than 31 data bits clamped), scattered
// into the compact LL grids; ld_dequantise_grid then runs, on one grid of
// LL codes, in place, the strictly sequential raster recurrence of the
// reference's inverse_quantise_LLSubband (Quantisation.cpp:287-306): each
// LL value is c_scale(code, adjusted q) plus the mean of its left, above
// and above-left neighbours' values (a truncating division by 3). No
// decode route runs ld_read: with the recurrence it is the native
// reference the tests hold the card's grids (ld_dc.cu) to. The recurrence
// alone serves the encoder's Decoded and PSNR outputs (the quantised LL
// band; the JAX package's vc2host.cpp ld_dequantise_plane, LL part) and a
// decode on the CPU.

#include <cstdint>
#include <cstring>

#include "dc_predict.cuh"

namespace {

constexpr uint64_t FOLLOW = 0xAAAAAAAAAAAAAAAAull;

inline int byte_at(const uint8_t* buf, int64_t len, int64_t b) {
  return b >= 0 && b < len ? buf[b] : 0xFF;
}

// 64 bits from absolute bit p; bits at or past `bound` read as 1.
inline uint64_t peek64(const uint8_t* buf, int64_t len, int64_t p,
                       int64_t bound) {
  const int64_t b = p >> 3;
  const int o = static_cast<int>(p & 7);
  uint64_t w = 0;
  for (int i = 0; i < 8; ++i) w = (w << 8) | byte_at(buf, len, b + i);
  if (o) w = (w << o) | (byte_at(buf, len, b + 8) >> (8 - o));
  const int64_t ok = bound - p;
  if (ok < 64) w |= ~0ull >> ok;
  return w;
}

// The first `count` codes of the region [p, p + bits) into out(k, value);
// codes past the region decode as 0.
template <class Out>
void decode_codes(const uint8_t* buf, int64_t len, int64_t p, int64_t bits,
                  int64_t count, Out out) {
  const int64_t bound = p + bits;
  for (int64_t k = 0; k < count; ++k) {
    if (p >= bound) {
      out(k, 0);
      continue;
    }
    const uint64_t w = peek64(buf, len, p, bound);
    if (w >> 63) {  // a single 1 bit: the code of 0
      out(k, 0);
      p += 1;
      continue;
    }
    const uint64_t f = w & FOLLOW;
    int z = f ? __builtin_clzll(f) : 64;
    if (z > 62) z = 62;  // no terminator in 64 bits: the JAX clamp
    const int ndata = z >> 1;
    uint64_t data = 0;
    for (int j = 0; j < ndata; ++j) data = (data << 1) | ((w >> (62 - 2 * j)) & 1);
    const uint64_t mag = ((1ull << ndata) | data) - 1ull;
    const bool neg = (w >> (62 - z)) & 1;
    out(k, static_cast<int32_t>(static_cast<uint32_t>(neg ? 0ull - mag : mag)));
    p += z + 2;
  }
}

inline int64_t intlog2(int64_t v) {  // reference Utils.cpp:40
  return v > 1 ? 64 - __builtin_clzll(static_cast<uint64_t>(v - 1)) : 0;
}

// A slice's header: its 7-bit q index and its len_bits-bit luma length,
// the first 7 + len_bits bits from byte b. One big-endian 32-bit load
// where the slice's first 4 bytes lie inside the payload and the two
// fields fit them (len_bits <= 25: slices under 4 MB); else 8 bounded
// byte reads (1-bits past the end).
inline void read_header(const uint8_t* buf, int64_t len, int64_t b,
                        int len_bits, int64_t* q, int64_t* y_bits) {
  if (b >= 0 && b + 4 <= len && len_bits <= 25) {
    uint32_t w;
    std::memcpy(&w, buf + b, 4);
    w = __builtin_bswap32(w);
    *q = w >> 25;
    *y_bits = len_bits ? (w << 7) >> (32 - len_bits) : 0;
    return;
  }
  uint64_t w = 0;
  for (int i = 0; i < 8; ++i) w = (w << 8) | byte_at(buf, len, b + i);
  *q = static_cast<int64_t>(w >> 57);
  *y_bits = len_bits ? static_cast<int64_t>((w << 7) >> (64 - len_bits)) : 0;
}

// Slice i's header fields (at byte pos, of size bytes) into q [n] and
// fields [4, n]; false when they leave the int32 range.
inline bool slice_fields(const uint8_t* buf, int64_t len, int64_t n,
                         int64_t i, int64_t pos, int64_t size, int32_t* q,
                         int32_t* fields) {
  const int64_t s_bits = 8 * pos;
  const int64_t len_bits = intlog2(8 * size - 7);
  int64_t qi, y_bits;
  read_header(buf, len, pos, static_cast<int>(len_bits), &qi, &y_bits);
  int64_t uv_bits = 8 * size - 7 - len_bits - y_bits;
  if (uv_bits < 0) uv_bits = 0;
  if (s_bits > INT32_MAX || y_bits > INT32_MAX || uv_bits > INT32_MAX ||
      s_bits + 7 + len_bits + y_bits + uv_bits > INT32_MAX)
    return false;
  q[i] = static_cast<int32_t>(qi);
  fields[i] = static_cast<int32_t>(s_bits);
  fields[n + i] = static_cast<int32_t>(len_bits);
  fields[2 * n + i] = static_cast<int32_t>(y_bits);
  fields[3 * n + i] = static_cast<int32_t>(uv_bits);
  return true;
}

// In place: grid holds the quantised LL codes and becomes their values.
void dequantise_grid(int32_t* grid, int64_t llh, int64_t llw, int64_t ys,
                     int64_t xs, int64_t ts, int64_t sh, int64_t sw,
                     const int32_t* qm_block, const int32_t* q,
                     const int32_t* qf, const int32_t* qo) {
  for (int64_t y = 0; y < llh; ++y)
    for (int64_t x = 0; x < llw; ++x) {
      const int64_t yb = ((y + 1) * ys - 1) / llh;
      const int64_t xb = ((x + 1) * xs - 1) / llw;
      const int aq = dc::adjust(
          q[yb * xs + xb], qm_block[((y * ts) % sh) * sw + (x * ts) % sw]);
      const int32_t* row = grid + y * llw;
      const int32_t* up = y > 0 ? row - llw : row;
      const int32_t pred =
          dc::predict(y > 0, x > 0, y > 0 && x > 0 ? up[x - 1] : 0,
                      y > 0 ? up[x] : 0, x > 0 ? row[x - 1] : 0);
      grid[y * llw + x] = dc::wrap32(
          static_cast<int64_t>(dc::c_scale(row[x], aq, qf, qo)) + pred);
    }
}

}  // namespace

// The header walk: q [n] and fields [4, n] (s_bits, len_bits, y_bits,
// uv_bits) of the n slices of sizes [n] from byte start. Returns the byte
// offset just past the last slice, or -1 (at once) when a slice's bit
// fields leave the int32 range.
extern "C" int64_t ld_fields(const uint8_t* payload, int64_t paylen,
                             int64_t n, int64_t start, const int32_t* sizes,
                             int32_t* q, int32_t* fields) {
  int64_t pos = start;
  for (int64_t i = 0; i < n; ++i) {
    if (!slice_fields(payload, paylen, n, i, pos, sizes[i], q, fields))
      return -1;
    pos += sizes[i];
  }
  return pos;
}

// One component's LL geometry: the slice block (sh x sw), its nll LL
// codes' offsets in a slice's LL block of the grid (row-major at the grid
// width llw), and the grid (llh x llw).
struct LLGrid {
  int64_t sh, sw, nll, llh, llw;
  const int64_t* offset;
};

// The slice walk: q [n] and fields [4, n] as ld_fields gives them, and
// the LL codes of every slice into the grids gy, gu, gv
// (slices xs a row, transform depth log2(ts); each grid zeroed first).
// Returns the byte offset just past the last slice; -1 when a slice's bit
// fields leave the int32 range (at once), -2 when an LL code lands outside
// its grid (a geometry no encoder writes; after the walk).
extern "C" int64_t ld_read(const uint8_t* payload, int64_t paylen, int64_t n,
                           int64_t start, const int32_t* sizes, int64_t xs,
                           int64_t ts, const LLGrid* luma,
                           const LLGrid* chroma, int32_t* q, int32_t* fields,
                           int32_t* gy, int32_t* gu, int32_t* gv) {
  const int64_t grid_y = luma->llh * luma->llw;
  const int64_t grid_c = chroma->llh * chroma->llw;
  for (int64_t k = 0; k < grid_y; ++k) gy[k] = 0;
  for (int64_t k = 0; k < grid_c; ++k) gu[k] = gv[k] = 0;
  int64_t pos = start;
  bool outside = false;
  for (int64_t i = 0; i < n; ++i) {
    if (!slice_fields(payload, paylen, n, i, pos, sizes[i], q, fields))
      return -1;

    const int64_t sy = i / xs, sx = i % xs;
    const int64_t oy = sy * (luma->sh / ts) * luma->llw + sx * (luma->sw / ts);
    const int64_t oc =
        sy * (chroma->sh / ts) * chroma->llw + sx * (chroma->sw / ts);
    const int64_t y_bits = fields[2 * n + i];
    const int64_t p = 8 * pos + 7 + fields[n + i];
    decode_codes(payload, paylen, p, y_bits, luma->nll,
                 [&](int64_t k, int32_t v) {
                   const int64_t at = oy + luma->offset[k];
                   if (at < 0 || at >= grid_y) outside = true;
                   else gy[at] = v;
                 });
    decode_codes(payload, paylen, p + y_bits, fields[3 * n + i],
                 2 * chroma->nll,
                 [&](int64_t k, int32_t v) {
                   const int64_t at = oc + chroma->offset[k >> 1];
                   if (at < 0 || at >= grid_c) outside = true;
                   else (k & 1 ? gv : gu)[at] = v;
                 });
    pos += sizes[i];
  }
  return outside ? -2 : pos;
}

// The LL DC-prediction recurrence alone, in place on a grid (llh x llw) of
// quantised LL codes of slices (sh x sw blocks, ys x xs of them, transform
// depth log2(ts)) with the q indices q [ys * xs]; qf / qo the 120-entry
// int32-wrapped quant factors and offsets.
extern "C" void ld_dequantise_grid(int32_t* grid, int64_t llh, int64_t llw,
                                   int64_t ys, int64_t xs, int64_t ts,
                                   int64_t sh, int64_t sw,
                                   const int32_t* qm_block, const int32_t* q,
                                   const int32_t* qf, const int32_t* qo) {
  dequantise_grid(grid, llh, llw, ys, xs, ts, sh, sw, qm_block, q, qf, qo);
}
