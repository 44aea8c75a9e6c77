// tiff — the strip and tile codecs of a TIFF reader with no library but the
// C++ standard library, as libtiff 4.7 decodes them for OpenCV, damaged data
// included: LZW (compression 5: tif_lzw.c's LZWDecode, MSB-first codes with
// the early change to wider codes, and LZWDecodeCompat, the old-style
// LSB-first codes), Deflate (8 and 32946: tif_zip.c's ZIPDecode over an
// inflate that stops, fails and checks as zlib's does), PackBits (32773),
// and the horizontal predictor (Predictor 2) over 8 and 16-bit samples.
//
// Each decoder fills a strip or tile buffer the caller has zeroed, as
// libtiff's _TIFFReadEncodedStripAndAllocBuffer zeroes it, and returns 1
// when the data filled it, 0 where libtiff's decoder fails ("Using code not
// yet in table", "Corrupted LZW table", "Not enough data", "not terminated
// with EOI code", a zlib error, an inflate that ends short).  The bytes
// written before the failure stay, and the rest stays zero: libtiff's RGBA
// reader, which OpenCV's imread uses, keeps a failed strip's buffer as it
// stands and converts it.
//
// C ABI; Python binds it through ctypes (io/tiff.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libtiffdec.so tiff.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;
// tif_lzw.c CSIZE: MAXCODE(BITS_MAX) + 1024 entries
constexpr int kCsize = (1 << kMaxBits) - 1 + 1024;

struct LzwEntry {
  int32_t next;        // the entry of the string's prefix, or -1
  uint16_t length;     // the string's length
  uint8_t value;       // its last byte
  uint8_t firstchar;   // its first byte
};

struct LzwTable {
  std::vector<LzwEntry> t;
  LzwTable() : t(kCsize) {
    for (int i = 0; i < kCsize; ++i) t[i] = {-1, 0, 0, 0};
    for (int i = 0; i < 256; ++i)
      t[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  }
  // The string of `code` back to front into out[o, o + len), cut to the
  // first `room` bytes where it is longer (libtiff's too_short_buffer).
  void put(int code, uint8_t* out, int64_t room) const {
    int64_t len = t[code].length;
    int c = code;
    while (len > room) {
      c = t[c].next;
      --len;
    }
    for (int64_t k = len - 1; k >= 0 && c >= 0; --k) {
      out[k] = t[c].value;
      c = t[c].next;
    }
  }
};

// LZWDecode (libtiff 4.7): the first code of a strip must be Clear; a code
// past the last entry made, a code above EOI right after Clear, or the
// table's overflow fail the strip; so does data that ends before the strip
// is full or an EOI that comes early.
int lzw_new(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  LzwTable tab;
  auto& t = tab.t;
  int free_ent = -1, oldcode = 0, nbits = 9;
  int nbitsmask = (1 << 9) - 1, maxcode = nbitsmask - 1;
  uint64_t acc = 0;
  int have = 0;
  int64_t pos = 0, o = 0;
  auto get = [&](int& code) {
    while (have < nbits) {
      if (pos >= n) return false;               // no_eoi
      acc = (acc << 8) | in[pos++];
      have += 8;
    }
    code = static_cast<int>((acc >> (have - nbits)) & nbitsmask);
    have -= nbits;
    acc &= (uint64_t(1) << have) - 1;
    return true;
  };
  while (o < cap) {
    int code;
    if (!get(code)) return 0;
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      nbitsmask = (1 << 9) - 1;
      maxcode = nbitsmask - 1;
      do {
        if (!get(code)) return 0;
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return 0;
      out[o++] = static_cast<uint8_t>(code);
      oldcode = code;
      continue;
    }
    if (code > free_ent) return 0;              // not yet in the table
    LzwEntry& e = t[free_ent];
    e.next = oldcode;
    e.firstchar = t[oldcode].firstchar;
    e.length = static_cast<uint16_t>(t[oldcode].length + 1);
    e.value = code < 256 ? static_cast<uint8_t>(code)
              : code < free_ent ? t[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kMaxBits) nbits = kMaxBits;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      if (free_ent >= kCsize) free_ent = -1;    // only Clear or EOI now
    }
    oldcode = code;
    const int64_t len = t[code].length;
    tab.put(code, out + o, cap - o);
    o += len < cap - o ? len : cap - o;
  }
  return o >= cap;
}

// LZWDecodeCompat (libtiff 4.7): the old-style codes, LSB first, wider one
// code later; data that runs out reads as EOI.
int lzw_compat(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  LzwTable tab;
  auto& t = tab.t;
  int free_ent = -1, oldcode = 0, nbits = 9;
  int nbitsmask = (1 << 9) - 1, maxcode = nbitsmask - 1;
  uint64_t acc = 0;
  int have = 0;
  int64_t pos = 0, o = 0, bitsleft = n * 8;
  auto get = [&](int& code) {
    if (bitsleft < nbits) {
      code = kEoi;
      return;
    }
    while (have < nbits) {
      acc |= uint64_t(pos < n ? in[pos] : 0) << have;
      ++pos;
      have += 8;
    }
    code = static_cast<int>(acc & nbitsmask);
    acc >>= nbits;
    have -= nbits;
    bitsleft -= nbits;
  };
  while (o < cap) {
    int code;
    get(code);
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kCsize; ++i) t[i] = {-1, 0, 0, 0};
        nbits = 9;
        nbitsmask = (1 << 9) - 1;
        maxcode = nbitsmask;
        get(code);
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;              // Corrupted LZW table
      out[o++] = static_cast<uint8_t>(code);
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize) return 0;
    LzwEntry& e = t[free_ent];
    e.next = oldcode;
    e.firstchar = t[oldcode].firstchar;
    e.length = static_cast<uint16_t>(t[oldcode].length + 1);
    e.value = code < free_ent ? t[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kMaxBits) nbits = kMaxBits;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask;
    }
    oldcode = code;
    if (code >= 256) {
      const int64_t len = t[code].length;
      if (len == 0) return 0;                   // wrong length of string
      tab.put(code, out + o, cap - o);
      o += len < cap - o ? len : cap - o;
    } else {
      out[o++] = static_cast<uint8_t>(code);
    }
  }
  return o >= cap;
}

// ------------------------------------------------------------- inflate
// zlib's inflate as tif_zip.c's ZIPDecode drives it: one call over the
// strip's data into the strip's buffer.  It stops (the strip whole) where
// it must write a byte and the buffer is full, after decoding the code
// that needs it; it fails at zlib's data errors (a bad header, block type,
// stored length, code lengths set, code, distance, distance too far back,
// Adler-32 check), at a stream that ends before the strip is full, and at
// data that runs out before it is.
struct Huff {
  // canonical code: count of each length, symbols by code
  int count[16] = {};
  std::vector<int> symbol;
  int max = 0;          // the longest length used
};

// zlib's inflate_table checks: -1 over-subscribed or incomplete (an
// incomplete code is allowed for literal/lengths and distances only when
// it is a single code of one bit); an empty code is allowed.
int build(Huff& h, const uint8_t* lens, int n, bool codes) {
  for (int i = 0; i < 16; ++i) h.count[i] = 0;
  for (int i = 0; i < n; ++i) h.count[lens[i]]++;
  h.max = 0;
  for (int l = 15; l >= 1; --l)
    if (h.count[l]) {
      h.max = l;
      break;
    }
  h.symbol.clear();
  if (h.max == 0) return 0;
  int left = 1;
  for (int l = 1; l <= 15; ++l) {
    left <<= 1;
    left -= h.count[l];
    if (left < 0) return -1;
  }
  if (left > 0 && (codes || h.max != 1)) return -1;
  int offs[16];
  offs[1] = 0;
  for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + h.count[l];
  h.symbol.assign(n, 0);
  for (int i = 0; i < n; ++i)
    if (lens[i]) h.symbol[offs[lens[i]]++] = i;
  return 0;
}

const int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                          15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                          67, 83, 99, 115, 131, 163, 195, 227, 258};
const int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                           2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                           17,   25,   33,   49,   65,   97,    129,   193,
                           257,  385,  513,  769,  1025, 1537,  2049,  3073,
                           4097, 6145, 8193, 12289, 16385, 24577};
const int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                            6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

struct Inflate {
  const uint8_t* in;
  int64_t n, pos = 0;
  uint64_t hold = 0;
  int bits = 0;
  uint8_t* out;
  int64_t cap, o = 0;

  // k more bits (LSB first); false when the data runs out
  bool need(int k) {
    while (bits < k) {
      if (pos >= n) return false;
      hold |= uint64_t(in[pos++]) << bits;
      bits += 8;
    }
    return true;
  }
  uint32_t take(int k) {
    uint32_t v = static_cast<uint32_t>(hold & ((uint64_t(1) << k) - 1));
    hold >>= k;
    bits -= k;
    return v;
  }
  // A symbol: >= 0, -1 a code the table lacks, -2 out of data.
  int decode(const Huff& h) {
    if (h.max == 0) {                   // an empty code: one bit, invalid
      return need(1) ? (take(1), -1) : -2;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= h.max; ++l) {
      if (!need(1)) return -2;
      code |= static_cast<int>(take(1));
      const int c = h.count[l];
      if (code - c < first) return h.symbol[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }

  enum { kFull = 1, kFail = 0, kShort = 2 };

  // Literal/length and distance codes of one block; kFull where a byte
  // must be written to a full buffer, kShort out of data, -1 at the end
  // of the block.
  int codes(const Huff& lit, const Huff& dist) {
    for (;;) {
      int sym = decode(lit);
      if (sym == -2) return kShort;
      if (sym < 0 || sym > 285) return kFail;    // invalid literal/length
      if (sym < 256) {
        if (o >= cap) return kFull;
        out[o++] = static_cast<uint8_t>(sym);
        continue;
      }
      if (sym == 256) return -1;
      sym -= 257;
      if (!need(kLenExtra[sym])) return kShort;
      const int len = kLenBase[sym] + static_cast<int>(take(kLenExtra[sym]));
      int ds = decode(dist);
      if (ds == -2) return kShort;
      if (ds < 0 || ds > 29) return kFail;       // invalid distance code
      if (!need(kDistExtra[ds])) return kShort;
      const int64_t d = kDistBase[ds] + take(kDistExtra[ds]);
      if (o >= cap) return kFull;
      if (d > o) return kFail;                   // too far back
      int i = 0;
      for (; i < len && o < cap; ++i, ++o) out[o] = out[o - d];
      if (i < len) return kFull;    // the match runs past the buffer
    }
  }

  int run() {
    if (!need(16)) return kShort;
    const uint32_t cmf = take(8), flg = take(8);
    if (((cmf << 8) | flg) % 31) return kFail;   // incorrect header check
    if ((cmf & 15) != 8) return kFail;           // unknown method
    if ((cmf >> 4) + 8 > 15) return kFail;       // invalid window size
    if (flg & 0x20) return kFail;                // a preset dictionary
    Huff lit, dist;
    for (;;) {
      if (!need(3)) return kShort;
      const int last = static_cast<int>(take(1));
      const int type = static_cast<int>(take(2));
      int st;
      if (type == 0) {
        take(bits & 7);
        if (!need(32)) return kShort;
        const uint32_t len = take(16), nlen = take(16);
        if (len != (nlen ^ 0xffff)) return kFail;
        for (uint32_t i = 0; i < len; ++i) {
          if (o >= cap) return kFull;
          if (!need(8)) return kShort;
          out[o++] = static_cast<uint8_t>(take(8));
        }
        st = -1;
      } else if (type == 1) {
        uint8_t l[288 + 32];
        for (int i = 0; i < 288; ++i)
          l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        for (int i = 0; i < 32; ++i) l[288 + i] = 5;
        build(lit, l, 288, false);
        build(dist, l + 288, 32, false);
        st = codes(lit, dist);
      } else if (type == 2) {
        if (!need(14)) return kShort;
        const int nlen = static_cast<int>(take(5)) + 257;
        const int ndist = static_cast<int>(take(5)) + 1;
        const int ncode = static_cast<int>(take(4)) + 4;
        if (nlen > 286 || ndist > 30) return kFail;
        static const int kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                       11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint8_t cl[19] = {};
        for (int i = 0; i < ncode; ++i) {
          if (!need(3)) return kShort;
          cl[kOrder[i]] = static_cast<uint8_t>(take(3));
        }
        Huff lc;
        if (build(lc, cl, 19, true) < 0) return kFail;
        uint8_t lens[286 + 30] = {};
        int have = 0;
        while (have < nlen + ndist) {
          int sym = decode(lc);
          if (sym == -2) return kShort;
          if (sym == -1) sym = 0;     // an empty code reads a zero length
          if (sym < 16) {
            lens[have++] = static_cast<uint8_t>(sym);
            continue;
          }
          int len = 0, copy;
          if (sym == 16) {
            if (!need(2)) return kShort;
            if (have == 0) return kFail;         // invalid bit length repeat
            len = lens[have - 1];
            copy = 3 + static_cast<int>(take(2));
          } else if (sym == 17) {
            if (!need(3)) return kShort;
            copy = 3 + static_cast<int>(take(3));
          } else {
            if (!need(7)) return kShort;
            copy = 11 + static_cast<int>(take(7));
          }
          if (have + copy > nlen + ndist) return kFail;
          while (copy--) lens[have++] = static_cast<uint8_t>(len);
        }
        if (lens[256] == 0) return kFail;        // missing end-of-block
        if (build(lit, lens, nlen, false) < 0) return kFail;
        if (build(dist, lens + nlen, ndist, false) < 0) return kFail;
        st = codes(lit, dist);
      } else {
        return kFail;                            // invalid block type
      }
      if (st != -1) return st;
      if (last) break;
    }
    take(bits & 7);
    if (!need(32)) return kShort;
    uint32_t check = 0;
    for (int i = 0; i < 4; ++i) check = (check << 8) | take(8);
    uint32_t a = 1, b = 0;
    for (int64_t i = 0; i < o; ++i) {
      a = (a + out[i]) % 65521;
      b = (b + a) % 65521;
    }
    if (check != ((b << 16) | a)) return kFail;  // incorrect data check
    return o >= cap ? kFull : kFail;             // a stream that ends short
  }
};

}  // namespace

extern "C" {

// LZW data `in` (n bytes) into `out` (cap bytes, zeroed: the strip's or
// tile's size), by the old-style decoder where `compat` (the first strip
// libtiff reads began with the bytes 0x00 and an odd one).  1: the buffer
// filled; 0: libtiff's decoder fails.
int tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
             int compat) {
  return compat ? lzw_compat(in, n, out, cap) : lzw_new(in, n, out, cap);
}

// Deflate data `in` into `out` (cap bytes, zeroed).  1: the buffer filled;
// 0: ZIPDecode fails (a zlib error, or the data ends short of the strip).
int tiff_inflate(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  Inflate z{in, n, 0, 0, 0, out, cap, 0};
  const int st = z.run();
  return st == Inflate::kFull || (st == Inflate::kShort && z.o >= cap);
}

// PackBits data `in` into `out` (cap bytes, zeroed), as tif_packbits.c
// decodes it: a run past the end of the buffer is cut, a literal run the
// data cuts short is dropped.  1: the buffer filled; 0: not enough data.
int tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0, o = 0;
  while (pos < n && o < cap) {
    int64_t b = static_cast<int8_t>(in[pos++]);
    if (b < 0) {
      if (b == -128) continue;
      int64_t len = 1 - b;
      if (len > cap - o) len = cap - o;
      if (pos >= n) break;
      std::memset(out + o, in[pos++], len);
      o += len;
    } else {
      if (cap - o < b + 1) b = cap - o - 1;
      if (n - pos < b + 1) break;
      std::memcpy(out + o, in + pos, b + 1);
      o += b + 1;
      pos += b + 1;
    }
  }
  return o >= cap;
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
