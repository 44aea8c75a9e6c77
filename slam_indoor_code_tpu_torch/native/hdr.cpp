// hdr — the pixels of a Radiance HDR (RGBE) photo decoded with no library
// but the C++ standard library, as OpenCV's imread reads them in colour
// (grfmt_hdr.cpp over Greg Ward's rgbe.c, RGBE_ReadPixels_RLE):
//   - scanlines 8 to 32767 wide may be new-style run-length coded: each
//     starts 2, 2 and its width in two bytes, then its four channels one
//     after the other, each as runs (a count past 128: that many less 128
//     copies of the next byte) and literals (a count up to 128: that many
//     bytes);
//   - the first scanline that does not start 2, 2 with a width below
//     32768 starts flat RGBE pixels, four bytes each, to the end of the
//     image (old-style runs are read as such pixels); narrower or wider
//     images are flat throughout;
//   - each pixel's float (byte * 2^(e - 136), 0 where e is 0) times 255,
//     rounded half to even and saturated as OpenCV's convertTo rounds:
//     0 past the range of 32-bit integers.
// A scanline of another width, a run of no bytes or past the channel's
// end, and data that ends early give no image.
//
// C ABI; Python binds it through ctypes (io/hdr.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libhdrdec.so hdr.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

uint8_t to_byte_slow(int v, int e) {
  if (!e) return 0;
  const double x = double(v) * 255.0 * std::ldexp(1.0, e - 136);
  if (x >= 2147483648.0) return 0;  // cvRound overflows to INT_MIN
  const double r = std::nearbyint(x);
  return static_cast<uint8_t>(r > 255.0 ? 255.0 : r);
}

// to_byte_slow for every (exponent, byte), filled once
struct Table {
  uint8_t v[256][256];
  Table() {
    for (int e = 0; e < 256; ++e)
      for (int b = 0; b < 256; ++b) v[e][b] = to_byte_slow(b, e);
  }
};

inline uint8_t to_byte(int v, int e) {
  static const Table table;
  return table.v[e][v];
}

}  // namespace

extern "C" {

// The w x h pixels of the RGBE data (n bytes after the header) to h*w*3
// RGB bytes.  0: done; 1: the data ends early; 2: a bad scanline.
int hdr_rgb(const uint8_t* p, int64_t n, int w, int h, uint8_t* out) {
  const uint8_t* const end = p + n;
  const int64_t total = int64_t(w) * h;
  int64_t done = 0;
  auto flat = [&]() {
    for (; done < total; ++done, p += 4) {
      if (end - p < 4) return 1;
      for (int c = 0; c < 3; ++c) out[3 * done + c] = to_byte(p[c], p[3]);
    }
    return 0;
  };
  if (w < 8 || w > 0x7fff) return flat();
  std::vector<uint8_t> line(size_t(w) * 4);
  for (int y = 0; y < h; ++y) {
    if (end - p < 4) return 1;
    if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) return flat();
    if ((p[2] << 8 | p[3]) != w) return 2;
    p += 4;
    for (int c = 0; c < 4; ++c) {
      uint8_t* q = &line[size_t(c) * w];
      uint8_t* const qe = q + w;
      while (q < qe) {
        if (end - p < 2) return 1;
        int count = p[0];
        if (count > 128) {
          count -= 128;
          if (count > qe - q) return 2;
          std::memset(q, p[1], count);
          q += count;
          p += 2;
        } else {
          if (count == 0 || count > qe - q) return 2;
          if (end - p < 1 + count) return 1;
          std::memcpy(q, p + 1, count);
          q += count;
          p += 1 + count;
        }
      }
    }
    for (int x = 0; x < w; ++x, ++done)
      for (int c = 0; c < 3; ++c)
        out[3 * done + c] = to_byte(line[size_t(c) * w + x],
                                    line[size_t(3) * w + x]);
  }
  return 0;
}

}  // extern "C"
