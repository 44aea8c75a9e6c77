// tiff — the strip and tile codecs of a TIFF reader with no library but the
// C++ standard library, as libtiff 4.7 decodes them: LZW (compression 5,
// the MSB-first codes of TIFF 6.0 with the early change to wider codes),
// PackBits (32773), and the horizontal predictor (Predictor 2) over 8 and
// 16-bit samples.  Deflate is inflated by Python's zlib (io/tiff.py).
//
// C ABI; Python binds it through ctypes (io/tiff.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libtiffdec.so tiff.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;

}  // namespace

extern "C" {

// LZW data `in` (n bytes) into `out` (cap bytes, the strip's or tile's
// size).  Returns the bytes written (cap when the strip is whole), or -1
// for a code past the table.
int64_t tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  // each entry: its first byte position in `out` is not stable, so the
  // table keeps (prefix code, last byte, length) and strings are written
  // back to front
  std::vector<int32_t> prefix(1 << kMaxBits), length(1 << kMaxBits);
  std::vector<uint8_t> suffix(1 << kMaxBits), first(1 << kMaxBits);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int nbits = 9, next = kFirst, old = -1;
  uint64_t acc = 0;
  int have = 0;
  int64_t pos = 0, o = 0;
  while (o < cap) {
    while (have < nbits && pos < n) {
      acc = (acc << 8) | in[pos++];
      have += 8;
    }
    if (have < nbits) break;                  // the data ends
    const int code = static_cast<int>((acc >> (have - nbits))
                                      & ((1u << nbits) - 1));
    have -= nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = 9;
      next = kFirst;
      old = -1;
      continue;
    }
    int cur;
    if (old < 0) {                            // the first code after Clear
      if (code >= 256) return -1;
      cur = code;
    } else if (code < next) {
      cur = code;
      if (next < (1 << kMaxBits)) {
        prefix[next] = old;
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = length[old] + 1;
        ++next;
      }
    } else if (code == next && next < (1 << kMaxBits)) {
      prefix[next] = old;                     // the KwKwK case
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = length[old] + 1;
      cur = next++;
    } else {
      return -1;
    }
    // write the string of `cur`, cut at the end of the buffer
    const int len = length[cur];
    int c = cur;
    for (int64_t k = len - 1; k >= 0; --k) {
      if (o + k < cap) out[o + k] = suffix[c];
      c = prefix[c];
    }
    o += len;
    old = cur;
    if (next + 1 > (1 << nbits) - 1 && nbits < kMaxBits) ++nbits;
  }
  return o < cap ? o : cap;
}

// PackBits data `in` (n bytes) into `out` (cap bytes); a run past the end
// is cut, as libtiff discards it.  Returns the bytes written.
int64_t tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out,
                      int64_t cap) {
  int64_t pos = 0, o = 0;
  while (pos < n && o < cap) {
    const int b = static_cast<int8_t>(in[pos++]);
    if (b >= 0) {
      int64_t len = b + 1;
      if (len > n - pos) len = n - pos;
      if (len > cap - o) len = cap - o;
      std::memcpy(out + o, in + pos, len);
      o += len;
      pos += b + 1;
    } else if (b != -128) {
      if (pos >= n) break;
      int64_t len = 1 - b;
      if (len > cap - o) len = cap - o;
      std::memset(out + o, in[pos++], len);
      o += len;
    }
  }
  return o;
}

// Undo horizontal differencing in place over `rows` rows of `row_samples`
// samples of `bits` (8 or 16; 16-bit samples in the file's byte order,
// big-endian where `big`), each sample adding the one `stride` before it.
void tiff_predict(uint8_t* buf, int64_t rows, int64_t row_samples,
                  int stride, int bits, int big) {
  if (bits == 8) {
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* p = buf + r * row_samples;
      for (int64_t i = stride; i < row_samples; ++i) p[i] += p[i - stride];
    }
    return;
  }
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* p = buf + 2 * r * row_samples;
    for (int64_t i = stride; i < row_samples; ++i) {
      uint8_t* a = p + 2 * (i - stride);
      uint8_t* b = p + 2 * i;
      const int hi = big ? 0 : 1, lo = big ? 1 : 0;
      const uint16_t v = static_cast<uint16_t>(
          ((a[hi] << 8) | a[lo]) + ((b[hi] << 8) | b[lo]));
      b[hi] = static_cast<uint8_t>(v >> 8);
      b[lo] = static_cast<uint8_t>(v);
    }
  }
}

}  // extern "C"
