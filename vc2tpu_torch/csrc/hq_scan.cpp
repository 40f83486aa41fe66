// HQ slice chain scan on the host: the twin of the JAX package's native
// scan_hq_offsets (vc2tpu/_native/vc2host.cpp:353-375), with the same
// contract.
//
// Walks the self-describing HQ slice chain (reference Slices.cpp:384-467):
// per slice `prefix` zero bytes, a 1-byte qIndex, then three times
// {1-byte length / scalar, data}. Fills q[n], dstart[3 * n] and
// cbytes[3 * n] (component-major) and returns the offset just past the
// last slice, or -1 when the chain runs past the payload.
//
// The walk is serial by construction (each slice's size comes from its
// three length bytes): about 4 dependent byte reads a slice, a few hundred
// microseconds for the 64 800 slices of a 1080p picture. It stays on the
// host because the device decode needs the offsets before it starts, and
// the payload lies in host memory until the upload.

#include <cstdint>

extern "C" int64_t hq_scan(const uint8_t* payload, int64_t paylen, int64_t n,
                           int64_t prefix, int64_t scalar, int64_t start,
                           int32_t* q, int64_t* dstart, int64_t* cbytes) {
  int64_t pos = start;
  for (int64_t i = 0; i < n; ++i) {
    pos += prefix;
    if (pos >= paylen) return -1;
    q[i] = payload[pos];
    ++pos;
    for (int c = 0; c < 3; ++c) {
      if (pos >= paylen) return -1;
      const int64_t size = static_cast<int64_t>(payload[pos]) * scalar;
      ++pos;
      dstart[c * n + i] = pos;
      cbytes[c * n + i] = size;
      pos += size;
    }
  }
  // the data of the last slice may run past the payload
  if (pos > paylen) return -1;
  return pos;
}
