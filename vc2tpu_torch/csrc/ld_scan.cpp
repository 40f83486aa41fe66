// LD slice header scan and LL DC-prediction dequantise on the host, in two
// phases: the twin of the JAX package's vc2tpu/slices/ld.py::ld_header_fields
// and vc2tpu/pipeline/decoder.py::ld_ll_grids, whose recurrence is
// vc2tpu/_native/vc2host.cpp:1859-1876 (ld_ll_dequantise_grid, with
// predict_dc, c_scale and adjust_q). The port loads no library of the JAX
// package, so this is its own copy.
//
// Per slice (reference Slices.cpp:195-303): a 7-bit qIndex, an
// intlog2(8 size - 7)-bit luma length y_bits, the luma region of y_bits
// bits, then the U/V region of uv_bits = max(8 size - 7 - len_bits -
// y_bits, 0) bits. The luma bound is not clamped to the slice (neither is
// the JAX package's). Reads past the payload give 1-bits (its 0xFF pad).
//
// ld_read, the first phase, walks the slices: the header fields, the q
// indices, and the LL band of every slice, the first nll codes of its luma
// region and the first 2 nllc codes of its interleaved U/V region, decoded
// (the bounded exp-Golomb rule of golomb_decode.cuh, codes of more than 31
// data bits clamped) and scattered into the compact LL grids.
//
// ld_dequantise_grid, the second, runs on one grid of LL codes, in place,
// the strictly sequential raster recurrence of the reference's
// inverse_quantise_LLSubband (Quantisation.cpp:287-306): each LL value is
// c_scale(code, adjusted q) plus the mean of its left, above and above-left
// neighbours' values (a truncating division by 3). The int32 arithmetic
// wraps, as the reference's does on x86. The decoder runs it once a grid
// after ld_read; the encoder's Decoded and PSNR outputs run it on the
// quantised LL band (the JAX package's vc2host.cpp ld_dequantise_plane, LL
// part).
//
// Both stay on the host: the recurrence is serial over the whole grid, and
// the grids are 1/4^depth of the picture (0.26 M values at 1080p depth 2).

#include <cstdint>

namespace {

constexpr uint64_t FOLLOW = 0xAAAAAAAAAAAAAAAAull;

inline int32_t wrap32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(v)));
}

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

// `count` unsigned bits from absolute bit p (no bound).
inline int64_t read_bits(const uint8_t* buf, int64_t len, int64_t p,
                         int count) {
  int64_t v = 0;
  for (int i = 0; i < count; ++i)
    v = (v << 1) | ((byte_at(buf, len, (p + i) >> 3) >> (7 - ((p + i) & 7))) & 1);
  return v;
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
  int64_t log = 0;
  for (v -= 1; v > 0; v >>= 1) ++log;
  return log;
}

struct Tables {
  const int32_t* qf;  // [120] int32-wrapped quant factors
  const int32_t* qo;  // [120] quant offsets
};

inline int32_t c_scale(int32_t value, int q, const Tables& t) {
  if (q < 0) q = 0;
  if (q > 119) q = 119;
  const bool neg = value < 0;
  int64_t v = neg ? wrap32(-static_cast<int64_t>(value)) : value;
  v = wrap32(v * t.qf[q]);
  if (v > 0) v = wrap32(v + t.qo[q]);
  v = wrap32(v + 2) / 4;  // C truncating division
  return neg ? wrap32(-v) : static_cast<int32_t>(v);
}

inline int32_t predict_dc(const int32_t* ll, int64_t llw, int64_t y,
                          int64_t x) {
  if (y > 0 && x > 0) {
    const int32_t r = wrap32(static_cast<int64_t>(ll[(y - 1) * llw + x - 1]) +
                             ll[(y - 1) * llw + x] + ll[y * llw + x - 1]);
    return r >= 0 ? wrap32(static_cast<int64_t>(r) + 1) / 3
                  : wrap32(static_cast<int64_t>(r) - 1) / 3;
  }
  if (y > 0) return ll[(y - 1) * llw + x];
  if (x > 0) return ll[y * llw + x - 1];
  return 0;
}

// In place: grid holds the quantised LL codes and becomes their values.
void dequantise_grid(int32_t* grid, int64_t llh, int64_t llw, int64_t ys,
                     int64_t xs, int64_t ts, int64_t sh, int64_t sw,
                     const int32_t* qm_block, const int32_t* q,
                     const Tables& t) {
  for (int64_t y = 0; y < llh; ++y)
    for (int64_t x = 0; x < llw; ++x) {
      const int64_t yb = ((y + 1) * ys - 1) / llh;
      const int64_t xb = ((x + 1) * xs - 1) / llw;
      int aq = q[yb * xs + xb] - qm_block[((y * ts) % sh) * sw + (x * ts) % sw];
      if (aq < 0) aq = 0;
      const int32_t pred = predict_dc(grid, llw, y, x);
      grid[y * llw + x] =
          wrap32(static_cast<int64_t>(c_scale(grid[y * llw + x], aq, t)) + pred);
    }
}

}  // namespace

// One component's LL geometry: the slice block (sh x sw), its nll LL
// codes' offsets in a slice's LL block of the grid (row-major at the grid
// width llw), and the grid (llh x llw).
struct LLGrid {
  int64_t sh, sw, nll, llh, llw;
  const int64_t* offset;
};

// The slice walk: q [n], fields [4, n] (s_bits, len_bits, y_bits,
// uv_bits) and the LL codes of every slice into the grids gy, gu, gv
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
    const int64_t size = sizes[i];
    const int64_t s_bits = 8 * pos;
    const int64_t len_bits = intlog2(8 * size - 7);
    const int64_t y_bits = read_bits(payload, paylen, s_bits + 7,
                                     static_cast<int>(len_bits));
    int64_t uv_bits = 8 * size - 7 - len_bits - y_bits;
    if (uv_bits < 0) uv_bits = 0;
    if (s_bits > INT32_MAX || y_bits > INT32_MAX || uv_bits > INT32_MAX ||
        s_bits + 7 + len_bits + y_bits + uv_bits > INT32_MAX)
      return -1;
    q[i] = static_cast<int32_t>(read_bits(payload, paylen, s_bits, 7));
    fields[i] = static_cast<int32_t>(s_bits);
    fields[n + i] = static_cast<int32_t>(len_bits);
    fields[2 * n + i] = static_cast<int32_t>(y_bits);
    fields[3 * n + i] = static_cast<int32_t>(uv_bits);

    const int64_t sy = i / xs, sx = i % xs;
    const int64_t oy = sy * (luma->sh / ts) * luma->llw + sx * (luma->sw / ts);
    const int64_t oc =
        sy * (chroma->sh / ts) * chroma->llw + sx * (chroma->sw / ts);
    const int64_t p = s_bits + 7 + len_bits;
    decode_codes(payload, paylen, p, y_bits, luma->nll,
                 [&](int64_t k, int32_t v) {
                   const int64_t at = oy + luma->offset[k];
                   if (at < 0 || at >= grid_y) outside = true;
                   else gy[at] = v;
                 });
    decode_codes(payload, paylen, p + y_bits, uv_bits, 2 * chroma->nll,
                 [&](int64_t k, int32_t v) {
                   const int64_t at = oc + chroma->offset[k >> 1];
                   if (at < 0 || at >= grid_c) outside = true;
                   else (k & 1 ? gv : gu)[at] = v;
                 });
    pos += size;
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
  const Tables t{qf, qo};
  dequantise_grid(grid, llh, llw, ys, xs, ts, sh, sw, qm_block, q, t);
}
