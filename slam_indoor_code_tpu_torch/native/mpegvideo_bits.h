// mpegvideo_bits.h — what the H.263-family decoders of this directory
// (mpeg4.cpp, h263.cpp) share: the big-endian bit reader, prefix-code
// tables read by one lookup, H.263's own VLC tables (MCBPC, CBPY, MVD and
// the TCOEF table H.263 codes every block with and MPEG-4 its inter
// blocks), the scans, the picture planes, and FFmpeg's edge emulation
// and motion vector helpers.  Header-only, no library but the C++
// standard one.

#ifndef SLAM_NATIVE_MPEGVIDEO_BITS_H_
#define SLAM_NATIVE_MPEGVIDEO_BITS_H_

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace mpegvideo_bits {

enum Status { kFrame = 0, kNoFrame = 1, kUnsupported = 2, kCorrupt = 3,
              kSmall = 4 };

struct Error {
  Status status;
  std::string msg;
};

[[noreturn]] inline void corrupt(const std::string& what) {
  throw Error{kCorrupt, "corrupt stream: " + what};
}

// ---------------------------------------------------------------- bits

class Bits {
 public:
  Bits(const uint8_t* p, int64_t n) : buf_(static_cast<size_t>(n) + 72, 0),
                                      nbits_(n * 8) {
    if (n > 0) std::memcpy(buf_.data(), p, static_cast<size_t>(n));
  }
  uint32_t peek(int n) const {  // 1 <= n <= 32; zeros past the end
    if (pos_ >= nbits_ + 256) corrupt("read past the end of the sample");
    uint64_t v;
    std::memcpy(&v, &buf_[static_cast<size_t>(pos_ >> 3)], 8);
    v = __builtin_bswap64(v) << (pos_ & 7);  // big-endian bit order
    return static_cast<uint32_t>(v >> (64 - n));
  }
  void skip(int n) { pos_ += n; }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  void marker(const char* what) {
    if (!get1()) corrupt(std::string("marker bit missing in ") + what);
  }
  int64_t pos() const { return pos_; }
  void seek(int64_t p) { pos_ = p; }
  bool overrun() const { return pos_ > nbits_; }
  int64_t left() const { return nbits_ - pos_; }
  int byte(int64_t i) const { return buf_[static_cast<size_t>(i)]; }

 private:
  std::vector<uint8_t> buf_;
  int64_t nbits_;
  int64_t pos_ = 0;
};

// ---------------------------------------------------------------- VLCs

struct Code {
  uint16_t code;
  uint8_t len;
};

// A prefix code read by one lookup of `bits` bits.
class Vlc {
 public:
  Vlc(const Code* codes, int n) {
    for (int i = 0; i < n; ++i) bits_ = std::max<int>(bits_, codes[i].len);
    sym_.assign(size_t(1) << bits_, -1);
    len_.assign(size_t(1) << bits_, 0);
    for (int i = 0; i < n; ++i) {
      if (codes[i].len == 0) continue;  // an unused entry
      int shift = bits_ - codes[i].len;
      size_t lo = size_t(codes[i].code) << shift;
      for (size_t k = lo; k < lo + (size_t(1) << shift); ++k) {
        sym_[k] = static_cast<int16_t>(i);
        len_[k] = codes[i].len;
      }
    }
  }
  // The symbol, or -1 (and nothing read) for a code not in the table.
  int try_read(Bits& b) const {
    uint32_t x = b.peek(bits_);
    if (!len_[x]) return -1;
    b.skip(len_[x]);
    return sym_[x];
  }
  int read(Bits& b, const char* what) const {
    int s = try_read(b);
    if (s < 0) corrupt(std::string("invalid ") + what + " code");
    return s;
  }

 private:
  int bits_ = 0;
  std::vector<int16_t> sym_;
  std::vector<uint8_t> len_;
};

// MCBPC for I-pictures (H.263 Table 7, MPEG-4 Table B-6): index = intra
// (0-3) / intra+q (4-7) by cbpc, 8 = stuffing.
const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                             {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC for P-pictures (Table 8 / B-7), FFmpeg's layout: index & 3 =
// cbpc, 4 = intra, 8 = dquant, 16 = INTER4V; 20 = stuffing; 21-23
// unused; 24-27 INTER4V+Q (H.263's MB type 5).
const Code kInterMcbpc[28] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6},     {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9},     {4, 6}, {4, 9}, {3, 9}, {2, 9},
    {2, 3}, {5, 7}, {4, 7}, {5, 8},     {1, 9}, {0, 0}, {0, 0}, {0, 0},
    {2, 11}, {12, 13}, {14, 13}, {15, 13}};
// CBPY (Table 9 / B-8), index = the intra value.
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                        {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                        {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// MVD magnitude 0..32 (Table 14 / B-12); a sign bit follows a nonzero.
const Code kMv[33] = {
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
    {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10},
    {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10},
    {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11},
    {3, 11}, {2, 11}, {3, 12}, {2, 12}};

// TCOEF (H.263 Table 16, MPEG-4 Table B-17): entries ordered by last, run,
// level (the runs and levels follow from kInterMaxLevel); the last entry
// (102) is the escape.  A sign bit follows each code.
const Code kInterTcoef[103] = {
    {2, 2}, {15, 4}, {21, 6}, {23, 7}, {31, 8}, {37, 9}, {36, 9}, {33, 10},
    {32, 10}, {7, 11}, {6, 11}, {32, 11}, {6, 3}, {20, 6}, {30, 8},
    {15, 10}, {33, 11}, {80, 12}, {14, 4}, {29, 8}, {14, 10}, {81, 12},
    {13, 5}, {35, 9}, {13, 10}, {12, 5}, {34, 9}, {82, 12}, {11, 5},
    {12, 10}, {83, 12}, {19, 6}, {11, 10}, {84, 12}, {18, 6}, {10, 10},
    {17, 6}, {9, 10}, {16, 6}, {8, 10}, {22, 7}, {85, 12}, {21, 7},
    {20, 7}, {28, 8}, {27, 8}, {33, 9}, {32, 9}, {31, 9}, {30, 9},
    {29, 9}, {28, 9}, {27, 9}, {26, 9}, {34, 11}, {35, 11}, {86, 12},
    {87, 12}, {7, 4}, {25, 9}, {5, 11}, {15, 6}, {4, 11}, {14, 6},
    {13, 6}, {12, 6}, {19, 7}, {18, 7}, {17, 7}, {16, 7}, {26, 8},
    {25, 8}, {24, 8}, {23, 8}, {22, 8}, {21, 8}, {20, 8}, {19, 8},
    {24, 9}, {23, 9}, {22, 9}, {21, 9}, {20, 9}, {19, 9}, {18, 9},
    {17, 9}, {7, 10}, {6, 10}, {5, 10}, {4, 10}, {36, 11}, {37, 11},
    {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
// LMAX by run: last 0 (27 runs), then last 1 (41 runs).
const uint8_t kInterMaxLevel[2][41] = {
    {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1},
    {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

constexpr int kEscape = 102;

// One TCOEF table with its (last, run, level) per entry and the escape
// limits LMAX[last][run] and RMAX[last][level].
struct RunLevel {
  Vlc vlc;
  uint8_t last[102], run[102], level[102];
  uint8_t max_level[2][64] = {};
  uint8_t max_run[2][64] = {};
  RunLevel(const Code* codes, const uint8_t* lmax0, int runs0,
           const uint8_t* lmax1, int runs1) : vlc(codes, 103) {
    int k = 0;
    for (int l = 0; l < 2; ++l) {
      const uint8_t* lmax = l ? lmax1 : lmax0;
      int runs = l ? runs1 : runs0;
      for (int r = 0; r < runs; ++r) {
        max_level[l][r] = lmax[r];
        for (int v = 1; v <= lmax[r]; ++v, ++k) {
          last[k] = static_cast<uint8_t>(l);
          run[k] = static_cast<uint8_t>(r);
          level[k] = static_cast<uint8_t>(v);
          max_run[l][v] = static_cast<uint8_t>(r);
        }
      }
    }
    if (k != 102) std::abort();
  }
};

// The zigzag scan, the alternate-vertical one and its transpose, the
// alternate-horizontal one.
struct Scans {
  uint8_t zigzag[64], vertical[64], horizontal[64];
  Scans() {
    static const uint8_t zz[64] = {
        0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
    static const uint8_t vt[64] = {
        0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
        41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
        51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
        53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
    for (int i = 0; i < 64; ++i) {
      zigzag[i] = zz[i];
      vertical[i] = vt[i];
      horizontal[i] = static_cast<uint8_t>((vt[i] & 7) * 8 + (vt[i] >> 3));
    }
  }
};

// ---------------------------------------------------------------- pictures

struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  void init(int width, int height) {
    w = width;
    h = height;
    px.assign(size_t(w) * h, 0);
  }
  uint8_t* at(int x, int y) { return px.data() + int64_t(y) * w + x; }
  const uint8_t* at(int x, int y) const {
    return px.data() + int64_t(y) * w + x;
  }
};

struct Picture {
  Plane y, u, v;
  int64_t tag = -1;  // the caller's tag of the sample it was decoded from
  void init(int mbw, int mbh) {
    y.init(mbw * 16, mbh * 16);
    u.init(mbw * 8, mbh * 8);
    v.init(mbw * 8, mbh * 8);
  }
};

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// The chroma vector of a 4MV macroblock from the sum of its four luma
// vectors, in half-pel units (H.263's sixteenth rounding table).
inline int round_chroma(int x) {
  static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                  1, 1, 1, 1, 1, 1, 2, 2};
  return tab[x & 15] + ((x >> 3) & ~1);
}

// ---------------------------------------------------------- prediction
// The block copies FFmpeg's mpegvideo_motion.c makes, each with its own
// test for reading past the picture's edge: in place when the block lies
// within [0, ew) x [0, eh) (the macroblock-aligned picture, or the VOL's
// size under FFmpeg's FF_BUG_EDGE), else through emulated_edge_mc, which
// takes each position outside to the nearest one inside.

constexpr int kWin = 24;  // row stride of an emulated window

inline const uint8_t* window(const Plane& p, int x, int y, int w, int h,
                             int ew, int eh, bool emu, uint8_t* buf,
                             int* stride) {
  if (!emu) {
    if (x >= 0 && y >= 0 && x + w <= p.w && y + h <= p.h) {
      *stride = p.w;
      return p.at(x, y);
    }
    ew = p.w;  // never read outside the plane
    eh = p.h;
  }
  for (int j = 0; j < h; ++j) {
    const uint8_t* row = p.at(0, std::clamp(y + j, 0, eh - 1));
    for (int i = 0; i < w; ++i)
      buf[j * kWin + i] = row[std::clamp(x + i, 0, ew - 1)];
  }
  *stride = kWin;
  return buf;
}

}  // namespace mpegvideo_bits

#endif  // SLAM_NATIVE_MPEGVIDEO_BITS_H_
