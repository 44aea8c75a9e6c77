// vp8l — the WebP lossless bitstream (a ``VP8L`` chunk, RFC 9649) decoded
// with no library but the C++ standard library, to the pixels libwebp's
// src/dec/vp8l_dec.c and src/dsp/lossless.c give:
//   - the image header (signature 0x2f, 14-bit width and height, the alpha
//     hint, version 0);
//   - prefix codes: simple codes (one or two symbols of 1 or 8 bits) and
//     normal codes through the 19-symbol code-length code, its max_symbol,
//     the repeat codes 16/17/18; a code that is not complete (or
//     over-subscribed) is an error, one used symbol is a code of 0 bits;
//   - the colour cache (1-11 bits, every decoded pixel inserted in order,
//     hashed by 0x1e35a7bd);
//   - LZ77 backward references: length and distance prefix codes with
//     their extra bits, the 120-entry distance map clamped to 1, copies
//     that overlap;
//   - meta prefix codes: the entropy image, each tile's group read from its
//     green and red bytes (groups nothing points to are read and checked,
//     not kept);
//   - the four transforms, each at most once, undone in the reverse of
//     stream order: the predictor (14 modes from each tile's green byte; 14
//     and 15 predict black), cross-colour (green_to_red, green_to_blue,
//     red_to_blue as signed 3.5 fixed point), subtract-green and colour
//     indexing (palette delta-coded, 1, 2 or 4-bit indices bundled into one
//     pixel, indices past the palette black and transparent);
//   - a stream read past the bytes it is given (by more than their length,
//     or than 64 bits where they are fewer than 8, as libwebp's bit reader
//     holds them) fails.
// The output drops alpha: the RGB bytes of each ARGB pixel, as OpenCV's
// imread gets them from libwebp in colour.
//
// C ABI; Python binds it through ctypes (io/webp.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libvp8ldec.so vp8l.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;
constexpr int kNumLiterals = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kCodeLengthCodes = 19;
constexpr int kMaxCacheBits = 11;
constexpr int kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4;
enum { kPredictor, kCrossColor, kSubtractGreen, kColorIndexing };

const uint8_t kCodeLengthOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// (dx, dy) of the 120 short distance codes: distance dx + dy * width.
const int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// LSB-first bits; past the end of the data the bits read are zeros and
// `eos` tells that more was consumed than libwebp's reader holds.
struct Bits {
  const uint8_t* buf;
  int64_t len, pos = 0, consumed = 0, limit;
  uint64_t win = 0;
  int n = 0;

  Bits(const uint8_t* b, int64_t l)
      : buf(b), len(l), limit(8 * (l < 8 ? 8 : l)) {}
  void fill() {
    while (n <= 56) {
      win |= static_cast<uint64_t>(pos < len ? buf[pos] : 0) << n;
      n += 8;
      ++pos;
    }
  }
  uint32_t peek() {
    fill();
    return static_cast<uint32_t>(win);
  }
  void skip(int k) {
    win >>= k;
    n -= k;
    consumed += k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    fill();
    const uint32_t v = static_cast<uint32_t>(win & ((1ull << k) - 1));
    skip(k);
    return v;
  }
  bool eos() const { return consumed > limit; }
};

// A prefix code as a two-level lookup on the next bits, LSB first: a root
// entry of at most kRootBits bits is a symbol; one with more links to the
// second-level table at `value` indexed by the following bits - 8.
struct Entry {
  uint16_t value;
  uint8_t bits;
};
using Table = std::vector<Entry>;

inline uint32_t reverse_bits(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) r |= ((code >> i) & 1u) << (len - 1 - i);
  return r;
}

// The canonical code of `lengths` (n symbols) into `t`; false where
// libwebp's BuildHuffmanTable fails (no symbol, a length over 15, a code
// that is over-subscribed or not complete).  One symbol is 0 bits long.
bool build(const int* lengths, int n, Table* t) {
  int count[kMaxCodeLength + 1] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] < 0 || lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  if (n - count[0] == 1) {
    int s = 0;
    while (lengths[s] == 0) ++s;
    t->assign(1 << kRootBits, Entry{static_cast<uint16_t>(s), 0});
    return true;
  }
  int open = 1;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    open = 2 * open - count[len];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  uint32_t next[kMaxCodeLength + 2] = {0};
  uint32_t code = 0;
  count[0] = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  // codes in symbol order, and the longest code under each root prefix
  std::vector<uint32_t> rev(n);
  int sub_bits[1 << kRootBits] = {0};
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (len == 0) continue;
    rev[s] = reverse_bits(next[len]++, len);
    if (len > kRootBits) {
      int& b = sub_bits[rev[s] & ((1 << kRootBits) - 1)];
      if (len - kRootBits > b) b = len - kRootBits;
    }
  }
  t->assign(1 << kRootBits, Entry{0, 0});
  for (int low = 0; low < (1 << kRootBits); ++low) {
    if (sub_bits[low] == 0) continue;
    (*t)[low] = Entry{static_cast<uint16_t>(t->size()),
                      static_cast<uint8_t>(kRootBits + sub_bits[low])};
    t->resize(t->size() + (size_t(1) << sub_bits[low]), Entry{0, 0});
  }
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (len == 0) continue;
    const Entry e{static_cast<uint16_t>(s), static_cast<uint8_t>(len)};
    if (len <= kRootBits) {
      for (uint32_t i = rev[s]; i < (1u << kRootBits); i += 1u << len)
        (*t)[i] = e;
    } else {
      const Entry link = (*t)[rev[s] & ((1 << kRootBits) - 1)];
      const int sb = link.bits - kRootBits;
      const Entry sub{static_cast<uint16_t>(s),
                      static_cast<uint8_t>(len - kRootBits)};
      for (uint32_t i = rev[s] >> kRootBits; i < (1u << sb);
           i += 1u << (len - kRootBits))
        (*t)[link.value + i] = sub;
    }
  }
  return true;
}

inline int read_symbol(Bits* br, const Entry* t) {
  const uint32_t v = br->peek();
  const Entry e = t[v & ((1u << kRootBits) - 1)];
  if (e.bits <= kRootBits) {
    br->skip(e.bits);
    return e.value;
  }
  const Entry s =
      t[e.value + ((v >> kRootBits) & ((1u << (e.bits - kRootBits)) - 1))];
  br->skip(kRootBits + s.bits);
  return s.value;
}

struct Group {
  Table trees[5];
};

struct Transform {
  int type = 0, bits = 0, xsize = 0;
  std::vector<uint32_t> data;
};

// The entropy-coded image's header: its prefix-code groups, the entropy
// image that picks one per tile, the colour cache size.
struct Codes {
  std::vector<Group> groups;
  std::vector<int32_t> tile_group;  // per entropy-image pixel, into groups
  int bits = 0, xsize = 0, cache_bits = 0;
};

struct Decoder {
  Bits br;
  int width = 0, height = 0;
  Transform tr[4];
  int ntr = 0;
  unsigned seen = 0;

  Decoder(const uint8_t* d, int64_t n) : br(d, n) {}

  bool header() {
    if (br.read(8) != 0x2f) return false;
    width = static_cast<int>(br.read(14)) + 1;
    height = static_cast<int>(br.read(14)) + 1;
    br.read(1);  // alpha_is_used: a hint only
    return br.read(3) == 0 && !br.eos();
  }

  // libwebp's ReadHuffmanCodeLengths.
  bool code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    Table t;
    if (!build(cl_lengths, kCodeLengthCodes, &t)) return false;
    int max_symbol = num_symbols;
    if (br.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(br.read(3));
      max_symbol = 2 + static_cast<int>(br.read(nbits));
      if (max_symbol > num_symbols) return false;
    }
    int prev = 8;
    for (int s = 0; s < num_symbols;) {
      if (max_symbol-- == 0) break;
      const int c = read_symbol(&br, t.data());
      if (c < 16) {
        lengths[s++] = c;
        if (c != 0) prev = c;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat =
            static_cast<int>(br.read(kExtra[c - 16])) + kOffset[c - 16];
        if (s + repeat > num_symbols) return false;
        const int len = c == 16 ? prev : 0;
        while (repeat-- > 0) lengths[s++] = len;
      }
    }
    return true;
  }

  // libwebp's ReadHuffmanCode: one prefix code of `alphabet` symbols.
  bool prefix_code(int alphabet, Table* t) {
    std::vector<int> lengths(alphabet < 256 ? 256 : alphabet, 0);
    bool ok = true;
    if (br.read(1)) {  // simple code
      const int num = static_cast<int>(br.read(1)) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num == 2) lengths[br.read(8)] = 1;
    } else {
      int cl[kCodeLengthCodes] = {0};
      const int num_codes = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
      ok = code_lengths(cl, alphabet, lengths.data());
    }
    return ok && !br.eos() && build(lengths.data(), alphabet, t);
  }

  // The header of an entropy-coded image of xsize x ysize: colour cache,
  // and (for the main image) the meta prefix codes; then its groups.
  bool read_codes(int xsize, int ysize, bool level0, Codes* c) {
    if (br.read(1)) {
      c->cache_bits = static_cast<int>(br.read(4));
      if (c->cache_bits < 1 || c->cache_bits > kMaxCacheBits) return false;
    }
    int num_groups = 1;
    std::vector<uint32_t> image;
    if (level0 && br.read(1)) {
      c->bits = static_cast<int>(br.read(3)) + 2;
      c->xsize = subsample(xsize, c->bits);
      if (!sub_image(c->xsize, subsample(ysize, c->bits), &image))
        return false;
      for (uint32_t& p : image) {
        p = (p >> 8) & 0xffff;
        if (static_cast<int>(p) >= num_groups) num_groups = p + 1;
      }
    }
    // keep the groups some tile uses; read and check the others
    std::vector<int32_t> slot(num_groups, -1);
    int used = 0;
    if (image.empty()) {
      slot[0] = used++;
    } else {
      for (uint32_t p : image)
        if (slot[p] < 0) slot[p] = used++;
    }
    c->groups.resize(used);
    c->tile_group.assign(image.size(), 0);
    for (size_t i = 0; i < image.size(); ++i)
      c->tile_group[i] = slot[image[i]];
    const int green = kNumLiterals + kNumLengthCodes +
                      (c->cache_bits ? 1 << c->cache_bits : 0);
    const int sizes[5] = {green, kNumLiterals, kNumLiterals, kNumLiterals,
                          kNumDistanceCodes};
    Group scratch;
    for (int g = 0; g < num_groups; ++g) {
      Group* dst = slot[g] >= 0 ? &c->groups[slot[g]] : &scratch;
      for (int j = 0; j < 5; ++j)
        if (!prefix_code(sizes[j], &dst->trees[j])) return false;
    }
    return true;
  }

  int prefix_value(int sym) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  // libwebp's DecodeImageData: width x height ARGB pixels into `out`;
  // with `late_eos` (its DecodeAlphaData) a read past the end while the
  // last pixel is decoded is no error.
  bool pixels(const Codes& c, int width, int height, uint32_t* out,
              bool late_eos = false) {
    const int mask = c.bits == 0 ? ~0 : (1 << c.bits) - 1;
    const int cache_size = c.cache_bits ? 1 << c.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size, 0);
    const int cache_shift = 32 - c.cache_bits;
    const int64_t total = int64_t(width) * height;
    int64_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const Group* {
      if (c.bits == 0) return &c.groups[0];
      return &c.groups[c.tile_group[int64_t(y >> c.bits) * c.xsize +
                                    (x >> c.bits)]];
    };
    auto insert_upto = [&](int64_t end) {
      for (; cached < end; ++cached)
        cache[(0x1e35a7bdu * out[cached]) >> cache_shift] = out[cached];
    };
    const Group* g = group_at(0, 0);
    while (pos < total) {
      if (br.eos()) return false;
      if ((col & mask) == 0) g = group_at(col, row);
      const int code = read_symbol(&br, g->trees[kGreen].data());
      if (code < kNumLiterals + kNumLengthCodes && code >= kNumLiterals) {
        const int length = prefix_value(code - kNumLiterals);
        const int dist_code =
            prefix_value(read_symbol(&br, g->trees[kDist].data()));
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int8_t* d = kDistanceMap[dist_code - 1];
          dist = d[0] + int64_t(d[1]) * width;
          if (dist < 1) dist = 1;
        }
        if (br.eos()) return false;
        if (pos < dist || total - pos < length) return false;
        for (int i = 0; i < length; ++i) out[pos + i] = out[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < total && (col & mask)) g = group_at(col, row);
        if (cache_size) insert_upto(pos);
        continue;
      }
      if (code < kNumLiterals) {
        const uint32_t red = read_symbol(&br, g->trees[kRed].data());
        const uint32_t blue = read_symbol(&br, g->trees[kBlue].data());
        const uint32_t alpha = read_symbol(&br, g->trees[kAlpha].data());
        out[pos] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
      } else if (code < kNumLiterals + kNumLengthCodes + cache_size) {
        insert_upto(pos);
        out[pos] = cache[code - kNumLiterals - kNumLengthCodes];
      } else {
        return false;
      }
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
        if (cache_size) insert_upto(pos);
      }
    }
    return late_eos || !br.eos();
  }

  // A sub-image (a transform's data, the entropy image, a palette): no
  // transforms, no meta prefix codes.
  bool sub_image(int xsize, int ysize, std::vector<uint32_t>* out) {
    Codes c;
    if (!read_codes(xsize, ysize, false, &c)) return false;
    out->assign(size_t(xsize) * ysize, 0);
    return pixels(c, xsize, ysize, out->data());
  }

  bool transform(int* xsize) {
    const int type = static_cast<int>(br.read(2));
    if (seen & (1u << type)) return false;
    seen |= 1u << type;
    Transform& t = tr[ntr++];
    t.type = type;
    t.xsize = *xsize;
    if (type == kPredictor || type == kCrossColor) {
      t.bits = static_cast<int>(br.read(3)) + 2;
      return sub_image(subsample(t.xsize, t.bits), subsample(height, t.bits),
                       &t.data);
    }
    if (type == kColorIndexing) {
      const int num = static_cast<int>(br.read(8)) + 1;
      t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal;
      if (!sub_image(num, 1, &pal)) return false;
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 0; i < 4 * num; ++i)
        dst[i] = static_cast<uint8_t>(src[i] + (i >= 4 ? dst[i - 4] : 0));
    }
    return true;
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                  int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(v)) << s;
  }
  return out;
}

inline uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

// The predictor of `mode` for the pixel left of `left` and below `top`
// (top[-1], top[0], top[1]: TL, T, TR).
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10:
      return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: return clamped_full(left, top[0], top[-1]);
    case 13: return clamped_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14/15 as libwebp reads them
  }
}

void undo_predictor(const Transform& t, int h, uint32_t* d) {
  const int w = t.xsize;
  d[0] = add_pixels(d[0], 0xff000000u);
  for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
  const int tiles = subsample(w, t.bits);
  for (int y = 1; y < h; ++y) {
    uint32_t* o = d + int64_t(y) * w;
    const uint32_t* up = o - w;
    const uint32_t* modes = t.data.data() + int64_t(y >> t.bits) * tiles;
    o[0] = add_pixels(o[0], up[0]);
    for (int x = 1; x < w; ++x)
      o[x] = add_pixels(o[x],
                        predict((modes[x >> t.bits] >> 8) & 0xf, o[x - 1],
                                up + x));
  }
}

inline int delta(int8_t pred, int8_t color) {
  return (int(pred) * int(color)) >> 5;
}

void undo_cross_color(const Transform& t, int h, uint32_t* d) {
  const int w = t.xsize, tiles = subsample(w, t.bits);
  for (int y = 0; y < h; ++y) {
    const uint32_t* codes = t.data.data() + int64_t(y >> t.bits) * tiles;
    uint32_t* o = d + int64_t(y) * w;
    for (int x = 0; x < w; ++x) {
      const uint32_t m = codes[x >> t.bits];
      const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                   r2b = int8_t((m >> 16) & 0xff);
      const uint32_t argb = o[x];
      const int8_t green = int8_t((argb >> 8) & 0xff);
      int red = (argb >> 16) & 0xff, blue = argb & 0xff;
      red = (red + delta(g2r, green)) & 0xff;
      blue = (blue + delta(g2b, green) + delta(r2b, int8_t(red))) & 0xff;
      o[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
    }
  }
}

void undo_subtract_green(int64_t n, uint32_t* d) {
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t g = (d[i] >> 8) & 0xff;
    const uint32_t rb = ((d[i] & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
    d[i] = (d[i] & 0xff00ff00u) | rb;
  }
}

void undo_color_indexing(const Transform& t, int h, const uint32_t* in,
                         uint32_t* out) {
  const int w = t.xsize;
  const uint32_t* map = t.data.data();
  if (t.bits == 0) {
    for (int64_t i = 0; i < int64_t(w) * h; ++i)
      out[i] = map[(in[i] >> 8) & 0xff];
    return;
  }
  const int bpp = 8 >> t.bits, count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bpp) - 1;
  for (int y = 0; y < h; ++y) {
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & count_mask) == 0) packed = (*in++ >> 8) & 0xff;
      *out++ = map[packed & bit_mask];
      packed >>= bpp;
    }
  }
}

// The whole image as ARGB; false where libwebp fails.  With w and h
// given, the stream has no header (an ALPH chunk's), and its pixels are
// decoded as libwebp decodes alpha: the 8-bit path where the one
// transform is colour indexing and the red, blue and alpha codes are of
// one symbol.
bool decode_argb(const uint8_t* data, int64_t n, std::vector<uint32_t>* argb,
                 int* w, int* h) {
  Decoder dec(data, n);
  const bool alpha = *w > 0;
  if (alpha) {
    dec.width = *w;
    dec.height = *h;
  } else if (n < 5 || !dec.header()) {
    return false;
  }
  int xsize = dec.width;
  while (dec.br.read(1))
    if (!dec.transform(&xsize)) return false;
  Codes c;
  if (!dec.read_codes(xsize, dec.height, true, &c)) return false;
  bool eight_bit = alpha && dec.ntr == 1 &&
                   dec.tr[0].type == kColorIndexing && c.cache_bits == 0;
  for (const Group& g : c.groups)
    for (int j : {kRed, kBlue, kAlpha})
      eight_bit = eight_bit && g.trees[j][0].bits == 0;
  std::vector<uint32_t> img(size_t(xsize) * dec.height);
  if (!dec.pixels(c, xsize, dec.height, img.data(), eight_bit)) return false;
  for (int i = dec.ntr - 1; i >= 0; --i) {
    const Transform& t = dec.tr[i];
    switch (t.type) {
      case kPredictor: undo_predictor(t, dec.height, img.data()); break;
      case kCrossColor: undo_cross_color(t, dec.height, img.data()); break;
      case kSubtractGreen: undo_subtract_green(img.size(), img.data()); break;
      default: {
        std::vector<uint32_t> wide(size_t(t.xsize) * dec.height);
        undo_color_indexing(t, dec.height, img.data(), wide.data());
        img.swap(wide);
      }
    }
  }
  *w = dec.width;
  *h = dec.height;
  argb->swap(img);
  return true;
}

}  // namespace

extern "C" {

// The size a VP8L stream declares (`data`: the n bytes from the chunk's
// payload on that libwebp may read).  0: read; 1: not a VP8L stream
// (signature, version or length).
int vp8l_info(const uint8_t* data, int64_t n, int* w, int* h) {
  if (n < 5) return 1;
  Decoder dec(data, n);
  if (!dec.header()) return 1;
  *w = dec.width;
  *h = dec.height;
  return 0;
}

// The VP8L stream's pixels as h*w*3 RGB bytes (alpha dropped) in `out`.
// 0: done; 1: the stream is damaged or truncated (libwebp refuses it).
int vp8l_rgb(const uint8_t* data, int64_t n, uint8_t* out) {
  std::vector<uint32_t> argb;
  int w = 0, h = 0;
  if (!decode_argb(data, n, &argb, &w, &h)) return 1;
  for (size_t i = 0; i < argb.size(); ++i) {
    out[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
    out[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
    out[3 * i + 2] = static_cast<uint8_t>(argb[i]);
  }
  return 0;
}

// Whether an ALPH chunk's payload (`data`, n bytes) decodes for a w x h
// frame, as libwebp decodes it when it outputs alpha: its header byte
// (compression 0 or 1, pre-processing 0 or 1, reserved bits 0), then w*h
// raw bytes, or a VP8L stream without a header.  0: it does; 1: it fails.
int vp8l_alpha_check(const uint8_t* data, int64_t n, int w, int h) {
  if (n <= 1) return 1;
  const int method = data[0] & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) return 1;
  if (method == 0) return n - 1 >= int64_t(w) * h ? 0 : 1;
  std::vector<uint32_t> argb;
  return decode_argb(data + 1, n - 1, &argb, &w, &h) ? 0 : 1;
}

}  // extern "C"
