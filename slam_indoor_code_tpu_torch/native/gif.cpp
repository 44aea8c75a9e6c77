// gif — the first image of a GIF87a/GIF89a file decoded with no library
// but the C++ standard library, to the pixels OpenCV 5.0's own GIF decoder
// (modules/imgcodecs/src/grfmt_gif.cpp, not giflib) gives imread in
// colour:
//   - the whole block structure is walked first, to the trailer (0x3B):
//     extensions (their sub-blocks skipped), images (descriptor, local
//     colour table, LZW code size, sub-blocks); any other byte, or a file
//     that ends before the trailer, gives no image;
//   - a Graphic Control Extension before the first image gives its
//     transparency index (its block must be 4 bytes); the disposal method
//     does not change the first image;
//   - the logical screen is the image: filled with the global colour
//     table's background entry (the background index must lie in that
//     table), or black without a global table; the first image is drawn at
//     its offset (it must lie inside the screen);
//   - its colours come from its local table, else the global one, else a
//     gray ramp (index i is i, i, i, save index 1, white); an index past
//     the table is an error,
//     and pixels of the transparency index are not drawn (the background
//     shows);
//   - LZW with minimum code sizes 2-11 (codes of 3-12 bits), clear and end
//     codes (an end code resets the table as a clear code does, and the
//     codes go on), a table that stops growing at 4096 entries until a
//     clear comes; a code past the table is an error; the image must be
//     filled exactly, save that one code after it is full is ignored when
//     it is the last the data holds;
//   - interlaced images' rows in their four passes.
//
// C ABI; Python binds it through ctypes (io/gif.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libgifdec.so gif.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMaxPixels = int64_t(1) << 30;  // OpenCV's imread limit
constexpr int kMaxCodes = 4096;

struct Reader {
  const uint8_t* p;
  int64_t n, pos = 0;
  bool ok = true;

  int byte() {
    if (pos >= n) {
      ok = false;
      return 0;
    }
    return p[pos++];
  }
  int word() {
    const int lo = byte();
    return lo | (byte() << 8);
  }
  void skip(int64_t k) {
    if (pos + k > n) ok = false;
    pos = pos + k > n ? n : pos + k;
  }
  // A chain of sub-blocks to its zero length; appended to `out` if given.
  void sub_blocks(std::vector<uint8_t>* out) {
    for (int len = byte(); ok && len; len = byte()) {
      if (out && pos + len <= n)
        out->insert(out->end(), p + pos, p + pos + len);
      skip(len);
    }
  }
};

struct Image {
  int left = 0, top = 0, w = 0, h = 0, flags = 0, min_code = 0;
  const uint8_t* local = nullptr;
  int local_size = 0;
  int64_t data_at = 0;  // the first sub-block's length byte
};

struct Gif {
  int sw = 0, sh = 0, bg = 0, global_size = 0, trans = -1;
  const uint8_t* global = nullptr;
  Image first;
};

// The screen, the first image and its transparency; false where OpenCV
// gives no image.
bool parse(const uint8_t* d, int64_t n, Gif* g) {
  Reader r{d, n};
  if (n < 13 || (std::memcmp(d, "GIF87a", 6) && std::memcmp(d, "GIF89a", 6)))
    return false;
  r.skip(6);
  g->sw = r.word();
  g->sh = r.word();
  const int flags = r.byte();
  g->bg = r.byte();
  r.byte();  // pixel aspect ratio
  if (g->sw == 0 || g->sh == 0 || int64_t(g->sw) * g->sh > kMaxPixels)
    return false;
  if (flags & 0x80) {
    g->global_size = 2 << (flags & 7);
    g->global = d + r.pos;
    r.skip(3 * g->global_size);
    if (g->bg >= g->global_size) return false;
  }
  bool have_first = false;
  while (r.ok) {
    const int block = r.byte();
    if (!r.ok) return false;
    if (block == 0x3B) break;
    if (block == 0x21) {
      const int label = r.byte();
      if (!have_first && label == 0xF9) {
        if (r.byte() != 4) return false;
        const int packed = r.byte();
        r.word();  // delay
        const int index = r.byte();
        if (r.byte() != 0) return false;
        g->trans = (packed & 1) ? index : -1;
      } else {
        // OpenCV 5 counts frames only past the one application extension
        // it knows (its assertion in getFrameCount_)
        if (label == 0xFF && r.pos + 12 <= r.n && d[r.pos] == 11 &&
            std::memcmp(d + r.pos + 1, "NETSCAPE2.0", 11) != 0)
          return false;
        r.sub_blocks(nullptr);
      }
    } else if (block == 0x2C) {
      Image im;
      im.left = r.word();
      im.top = r.word();
      im.w = r.word();
      im.h = r.word();
      im.flags = r.byte();
      if (im.flags & 0x80) {
        im.local_size = 2 << (im.flags & 7);
        im.local = d + r.pos;
        r.skip(3 * im.local_size);
      }
      im.min_code = r.byte();
      im.data_at = r.pos;
      r.sub_blocks(nullptr);
      if (!have_first) {
        g->first = im;
        have_first = true;
      }
    } else {
      return false;
    }
  }
  if (!r.ok || !have_first) return false;
  const Image& im = g->first;
  return im.w > 0 && im.h > 0 && im.left + im.w <= g->sw &&
         im.top + im.h <= g->sh && im.min_code >= 2 && im.min_code <= 11;
}

// The LZW codes of `data` to exactly `total` indices (kept as bytes, as
// OpenCV keeps them); false where OpenCV fails.
bool lzw(const std::vector<uint8_t>& data, int min_code, int64_t total,
         uint8_t* out) {
  const int clear = 1 << min_code, end = clear + 1;
  std::vector<uint16_t> prefix(kMaxCodes);
  std::vector<uint8_t> suffix(kMaxCodes), first(kMaxCodes);
  std::vector<uint16_t> length(kMaxCodes);
  for (int c = 0; c < clear; ++c) {
    suffix[c] = first[c] = static_cast<uint8_t>(c);
    length[c] = 1;
  }
  int width = min_code + 1, next = end + 1, prev = -1;
  const int64_t nbits = int64_t(data.size()) * 8;
  int64_t bit = 0, idx = 0;
  while (bit + width <= nbits) {
    int code = 0;
    for (int i = 0; i < width; ++i, ++bit)
      code |= ((data[bit >> 3] >> (bit & 7)) & 1) << i;
    if (code == clear || code == end) {
      width = min_code + 1;
      next = end + 1;
      prev = -1;
      continue;
    }
    if (idx == total) {  // the image is full: only a last code is ignored
      return nbits - bit < width;
    }
    if (code > next || (prev < 0 && code >= clear)) return false;
    int len;
    uint8_t head;
    if (code < next) {
      len = length[code];
      head = first[code];
    } else {  // the entry being made: prev's string and its first index
      len = length[prev] + 1;
      head = first[prev];
    }
    if (idx + len > total) return false;
    if (prev >= 0 && next < kMaxCodes) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = first[prev];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
    }
    // write the string backwards from its last index
    int c = code;
    for (int64_t i = idx + len - 1; i >= idx; --i) {
      out[i] = suffix[c];
      c = prefix[c];
    }
    idx += len;
    prev = code;
    if (next == (1 << width) && width < 12) ++width;
  }
  return idx == total;
}

}  // namespace

extern "C" {

// The logical screen's size (the image's) of the GIF `data`.  0: read;
// 1: no image (a damaged or truncated file, or one OpenCV refuses).
int gif_info(const uint8_t* data, int64_t n, int* w, int* h) {
  Gif g;
  if (!parse(data, n, &g)) return 1;
  *w = g.sw;
  *h = g.sh;
  return 0;
}

// The first image on its screen as h*w*3 RGB bytes in `out`.  0: done;
// 1: no image, as gif_info, or the image data fails.
int gif_rgb(const uint8_t* data, int64_t n, uint8_t* out) {
  Gif g;
  if (!parse(data, n, &g)) return 1;
  const Image& im = g.first;
  Reader r{data, n, im.data_at};
  std::vector<uint8_t> codes;
  r.sub_blocks(&codes);
  const int64_t total = int64_t(im.w) * im.h;
  std::vector<uint8_t> idx(total);
  if (!r.ok || !lzw(codes, im.min_code, total, idx.data())) return 1;
  uint8_t gray[256 * 3];
  for (int i = 0; i < 256; ++i)
    gray[3 * i] = gray[3 * i + 1] = gray[3 * i + 2] = static_cast<uint8_t>(i);
  gray[3] = gray[4] = gray[5] = 255;  // index 1 is white, as in OpenCV
  const uint8_t* table = im.local ? im.local : g.global ? g.global : gray;
  const int size = im.local ? im.local_size : g.global ? g.global_size : 256;
  const uint8_t fill[3] = {g.global ? g.global[3 * g.bg] : uint8_t(0),
                           g.global ? g.global[3 * g.bg + 1] : uint8_t(0),
                           g.global ? g.global[3 * g.bg + 2] : uint8_t(0)};
  for (int64_t i = 0; i < int64_t(g.sw) * g.sh; ++i)
    std::memcpy(out + 3 * i, fill, 3);
  // rows in stream order -> image rows (four passes when interlaced)
  std::vector<int> rows;
  if (im.flags & 0x40) {
    static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; ++p)
      for (int y = kStart[p]; y < im.h; y += kStep[p]) rows.push_back(y);
  } else {
    for (int y = 0; y < im.h; ++y) rows.push_back(y);
  }
  for (int i = 0; i < im.h; ++i) {
    const uint8_t* src = idx.data() + int64_t(i) * im.w;
    uint8_t* dst = out + (int64_t(im.top + rows[i]) * g.sw + im.left) * 3;
    for (int x = 0; x < im.w; ++x) {
      const int v = src[x];
      if (v == g.trans) continue;
      if (v >= size) return 1;
      std::memcpy(dst + 3 * x, table + 3 * v, 3);
    }
  }
  return 0;
}

}  // extern "C"
