// png — the pixel stage of a PNG decoder with no library but the C++
// standard library: the inflated image data (io/png.py inflates it with
// Python's zlib) unfiltered, de-interlaced and converted to 8-bit RGB as
// libpng 1.6 gives it to OpenCV's imread in colour:
//   - every bit depth (1, 2, 4, 8, 16) of gray, gray+alpha, RGB, RGBA and
//     palette images, and Adam7 interlacing;
//   - 16-bit samples become their high byte (png_set_strip_16);
//   - gray below 8 bits is scaled to 8 (png_set_expand_gray_1_2_4_to_8:
//     v * 255 / (2^depth - 1)), then repeated into three channels;
//   - palette indices index a 256-entry table whose entries past the PLTE
//     chunk's are black, as libpng's;
//   - alpha (and a palette's tRNS) is dropped, not composited
//     (png_set_strip_alpha).
// With kVideo, the rows as FFmpeg's png decoder gives them to OpenCV's
// video reader (a PNG a frame: MPNG, QuickTime `png `) through swscale:
// 16-bit gray becomes min((v + 128) >> 8, 255); rows the data does not
// reach are zero bytes (a palette image's index 0); a row whose filter
// is unknown is zero bytes too, or, in an Adam7 pass, the row two above
// it in the pass (FFmpeg filters into the row buffer that held it).
//
// C ABI; Python binds it through ctypes (io/png.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libpngdec.so png.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Adam7: first column, first row, column step, row step of each pass.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

int channels_of(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo row filter `ft` of `row` (n bytes) in place given the unfiltered
// row above, `prior` (zeros for a pass's first row); false for an unknown
// filter.
bool unfilter(int ft, uint8_t* row, const uint8_t* prior, int64_t n,
              int bpp) {
  switch (ft) {
    case 0:
      return true;
    case 1:
      for (int64_t i = bpp; i < n; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i) row[i] += prior[i];
      return true;
    case 3:
      for (int64_t i = 0; i < bpp && i < n; ++i) row[i] += prior[i] >> 1;
      for (int64_t i = bpp; i < n; ++i)
        row[i] += static_cast<uint8_t>((row[i - bpp] + prior[i]) >> 1);
      return true;
    case 4:
      for (int64_t i = 0; i < bpp && i < n; ++i) row[i] += prior[i];
      for (int64_t i = bpp; i < n; ++i)
        row[i] += paeth(row[i - bpp], prior[i], prior[i - bpp]);
      return true;
    default:
      return false;
  }
}

// Sample `i` of an unfiltered row at `depth` bits (the high byte of a
// 16-bit sample; a sub-byte sample scaled to 8 bits unless it is a
// palette index).
inline int sample(const uint8_t* row, int64_t i, int depth, bool scale,
                  bool round16 = false) {
  switch (depth) {
    case 8: return row[i];
    case 16:
      if (round16)
        return std::min(((row[2 * i] << 8 | row[2 * i + 1]) + 128) >> 8, 255);
      return row[2 * i];
    default: {
      const int64_t bit = i * depth;
      const int v = (row[bit >> 3] >> (8 - depth - (bit & 7)))
                    & ((1 << depth) - 1);
      return scale ? v * 255 / ((1 << depth) - 1) : v;
    }
  }
}

void put_msg(const char* s, char* msg, int msg_len) {
  if (msg_len > 0) std::snprintf(msg, msg_len, "%s", s);
}

constexpr int kVideo = 1;  // pngdec_rgb's flag: FFmpeg's png decoder

}  // namespace

extern "C" {

// The image data `raw` (n inflated bytes: each pass's rows, each with its
// filter byte) of a w x h PNG of bit `depth`, colour type `ctype` and
// `interlace` (0 or 1) to h*w*3 RGB bytes in `out`; `palette` holds 256
// RGB entries; `flags` kVideo reads as FFmpeg does (see the top).  0:
// done; 1: the data is short or a row's filter unknown (msg says which;
// never with kVideo).
int pngdec_rgb(const uint8_t* raw, int64_t n, int w, int h, int depth,
               int ctype, int interlace, const uint8_t* palette, int flags,
               uint8_t* out, char* msg, int msg_len) {
  const int ch = channels_of(ctype);
  const int bits = ch * depth;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  const bool scale = ctype != 3;
  const bool video = flags & kVideo;
  const int passes = interlace ? 7 : 1;
  if (video) {  // the frame buffer FFmpeg fills starts as zero bytes
    const uint8_t* z = ctype == 3 ? palette : nullptr;
    for (int64_t i = 0; i < int64_t(w) * h; ++i) {
      out[3 * i] = z ? z[0] : 0;
      out[3 * i + 1] = z ? z[1] : 0;
      out[3 * i + 2] = z ? z[2] : 0;
    }
  }
  std::vector<uint8_t> rows[2];
  int64_t pos = 0;
  for (int p = 0; p < passes; ++p) {
    const int* a = interlace ? kAdam7[p] : nullptr;
    const int x0 = a ? a[0] : 0, y0 = a ? a[1] : 0;
    const int dx = a ? a[2] : 1, dy = a ? a[3] : 1;
    const int64_t pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int64_t ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;       // an empty pass has no rows
    const int64_t rb = (pw * bits + 7) / 8;
    rows[0].assign(rb, 0);
    rows[1].assign(rb, 0);
    for (int64_t r = 0; r < ph; ++r) {
      if (pos + 1 + rb > n) {
        if (video) return 0;
        put_msg("Not enough image data", msg, msg_len);
        return 1;
      }
      uint8_t* row = rows[r & 1].data();
      const uint8_t* prior = rows[(r + 1) & 1].data();   // zeros at r 0
      const int ft = raw[pos];
      if (video && ft > 4) {
        if (!interlace) std::memset(row, 0, rb);
      } else {
        std::memcpy(row, raw + pos + 1, rb);
      }
      pos += 1 + rb;
      if (!(video && ft > 4) && !unfilter(ft, row, prior, rb, bpp)) {
        put_msg("bad adaptive filter value", msg, msg_len);
        return 1;
      }
      uint8_t* dst = out + ((y0 + r * dy) * int64_t(w) + x0) * 3;
      for (int64_t x = 0; x < pw; ++x, dst += 3 * dx) {
        const int64_t s = x * ch;
        if (ctype == 3) {
          const uint8_t* e = palette + 3 * sample(row, s, depth, false);
          dst[0] = e[0];
          dst[1] = e[1];
          dst[2] = e[2];
        } else if (ch >= 3) {
          dst[0] = static_cast<uint8_t>(sample(row, s, depth, scale));
          dst[1] = static_cast<uint8_t>(sample(row, s + 1, depth, scale));
          dst[2] = static_cast<uint8_t>(sample(row, s + 2, depth, scale));
        } else {
          dst[0] = dst[1] = dst[2] =
              static_cast<uint8_t>(sample(row, s, depth, scale, video));
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
