// jpeg — a baseline and progressive JPEG decoder with no library but the
// C++ standard library, for machines without libjpeg.
//
// It decodes what libjpeg-turbo decodes for a sequential or progressive
// Huffman JPEG (SOF0/SOF1/SOF2, 8-bit samples, 1 or 3 components at any
// integral sampling factors, restart intervals, optimized or absent
// Huffman tables, a DHT between scans) and gives the same pixels as
// libjpeg-turbo 3.1 with its defaults, bit for bit:
//   - progressive scans (jdphuff.c) into a whole-image coefficient buffer:
//     DC first and refine, AC first with end-of-band runs, AC refine with
//     correction bits; then block smoothing (jdcoefct.c
//     decompress_smooth_data) where the scan script left any of the first
//     nine AC coefficients short of full precision, as in a file cut at a
//     scan boundary;
//   - the ISLOW inverse DCT as libjpeg-turbo's SIMD code computes it
//     (jidctint-sse2/avx2.asm, what OpenCV runs on x86-64): jidctint.c's
//     13-bit constants and descales, with 16-bit dequantised
//     coefficients, sums and pass outputs (saturated), so that damaged
//     data gives OpenCV's pixels too;
//   - fancy upsampling (jdsample.c): the triangle filters of h2v1, h1v2 and
//     h2v2 with their biases, the first and last columns special-cased and
//     the rows above the first and below the last real row replicated;
//     box replication for other integral factors and for h2 components
//     at most two samples wide;
//   - jdcolor.c's fixed-point YCbCr->RGB tables (16 fraction bits).
// Arithmetic-coded, lossless, hierarchical and 12-bit JPEGs are refused
// with the process named; a corrupt or truncated stream decodes to nothing,
// unless the caller asks for libjpeg-turbo 3.1's reading of damaged data
// (`lenient`: a photo as cv2.imread reads it, a Motion-JPEG frame, a
// JPEG-in-TIFF strip): a bad code reads as zero, data that runs out as
// zero bits, restart markers resynchronised (jpeg_resync_to_restart),
// damaged and cut progressive scans kept (jdphuff.c's insufficient_data,
// jdcoefct.c's last_good_iMCU_row and prev_coef_bits in block smoothing),
// and the source managers' fake EOI for every read past the end.  A scan that
// references Huffman table 0 or 1 without defining it takes the Annex K
// tables, as libjpeg does (Motion-JPEG frames carry no DHT).  Markers
// libjpeg's read_markers() does not know fail the stream; what follows a
// single scan of every component is not read (libjpeg has given every row
// by then).  The caller may set the colour space of three components as
// libtiff sets jpeg_color_space (YCbCr, or none).
//
// C ABI; Python binds it through ctypes (io/jpeg.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libjpegdec.so jpeg.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zig-zag index -> natural index; 16 extra entries absorb a corrupt run
// past the end of a block, as jpeg_natural_order does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 tables (libjpeg's jstdhuff.c): code counts by length 1..16,
// then the symbols.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];   // 0: the code is longer than 9 bits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];                // largest code of each length, or -1
  int32_t valoff[18];                 // symbol index minus smallest code
  uint8_t vals[256];
  int nsym = 0;                       // symbols

  // jdhuff.c jpeg_make_d_derived_tbl's check of a DC table, made where a
  // scan first uses it: every symbol a size of at most 15 bits.
  bool dc_ok() const {
    for (int i = 0; i < nsym; ++i)
      if (vals[i] > 15) return false;
    return true;
  }

  // Canonical codes from the counts by length (jdhuff.c
  // jpeg_make_d_derived_tbl); false for a table that overflows its lengths
  // (JERR_BAD_HUFF_TABLE: a code of all ones, or one past its length).
  bool build(const uint8_t bits[16], const uint8_t* symbols, int count) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[l];
    if (total > 256 || total > count) return false;
    int32_t code = 0;
    for (int l = 1; l <= 16; ++l) {
      code += bits[l - 1];
      if (code >= (int32_t(1) << l)) return false;
      code <<= 1;
    }
    std::memcpy(vals, symbols, total);
    nsym = total;
    std::memset(look_len, 0, sizeof(look_len));
    code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = static_cast<uint8_t>(l);
            look_sym[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

// Entropy-coded bits, MSB first, with 0xFF00 unstuffed, as jdhuff.c's
// jpeg_fill_bit_buffer reads them.  At a marker it stops, keeps the
// marker's code (libjpeg's unread_marker; the end of the data gives the
// fake EOI of libjpeg's source managers) and feeds zero bits; consuming any
// of them sets `insufficient` (libjpeg's insufficient_data).  A valid
// stream never consumes one.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int cnt = 0;            // valid bits in the low end of acc
  int fill = 0;           // of which this many (the lowest) are zero fill
  int marker = 0;         // the marker the data ran into, or 0
  bool insufficient = false;
  bool lenient = false;   // a code the table lacks reads as libjpeg's

  void refill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (marker) {
        fill += 8;
      } else if (pos >= n) {
        marker = 0xD9;
        fill += 8;
      } else {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;   // fill bytes before a marker
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            marker = q < n ? d[q] : 0xD9;
            pos = q < n ? q + 1 : n;
            b = 0;
            fill += 8;
          }
        } else {
          ++pos;
        }
      }
      acc = (acc << 8) | b;
      cnt += 8;
    }
  }
  inline uint32_t peek(int k) {
    return static_cast<uint32_t>(acc >> (cnt - k)) & ((1u << k) - 1);
  }
  inline void skip(int k) {
    cnt -= k;
    if (cnt < fill) {
      insufficient = true;
      fill = cnt;
    }
  }
  inline int bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) refill();
    int v = static_cast<int>(peek(k));
    skip(k);
    return v;
  }
  // One Huffman symbol, or -1 for a code the table does not hold.
  inline int decode(const Huffman& h) {
    if (cnt < 17) refill();   // a bad code reads 17 bits
    uint32_t p = peek(kLookBits);
    int l = h.look_len[p];
    if (l) {
      skip(l);
      return h.look_sym[p];
    }
    for (l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(peek(l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[code + h.valoff[l]];
      }
    }
    if (!lenient) return -1;
    skip(17);      // jpeg_huff_decode: 17 bits read, a zero faked
    return 0;
  }
  // jdmarker.c next_marker: drop the bit buffer and, unless the data has
  // already run into a marker, skip to the next one (FF00 is data).
  void next_marker() {
    acc = 0;
    cnt = fill = 0;
    while (!marker) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) {
        marker = 0xD9;
      } else {
        const int c = d[pos++];
        if (c != 0) marker = c;
      }
    }
  }
  // The restart marker expected after an interval (jdhuff.c
  // process_restart, jdmarker.c read_restart_marker and
  // jpeg_resync_to_restart): a marker that is not RSTn `rst` is discarded
  // (one far from it), skipped to the next marker (an earlier RSTn or a
  // code below SOF0), or left for the next interval (one of the next two
  // RSTn, or another marker), which then reads no data.
  void restart(int& rst) {
    next_marker();
    if (marker != 0xD0 + rst) {
      for (;;) {
        int action;
        if (marker < 0xC0) {
          action = 2;
        } else if (marker < 0xD0 || marker > 0xD7) {
          action = 3;
        } else if (marker == 0xD0 + ((rst + 1) & 7) ||
                   marker == 0xD0 + ((rst + 2) & 7)) {
          action = 3;
        } else if (marker == 0xD0 + ((rst - 1) & 7) ||
                   marker == 0xD0 + ((rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 3) break;
        if (action == 1) {
          marker = 0;
          break;
        }
        marker = 0;
        next_marker();
      }
    } else {
      marker = 0;
    }
    rst = (rst + 1) & 7;
    if (!marker) insufficient = false;
  }
  // The strict reading of a restart: the interval's data whole and RSTn
  // `rst` right after it.
  bool strict_restart(int& rst) {
    if (insufficient) return false;
    next_marker();
    if (marker != 0xD0 + rst) return false;
    marker = 0;
    rst = (rst + 1) & 7;
    return true;
  }
};

inline int extend(int v, int s) {
  return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v);
}

// ---------------------------------------------------------------- ISLOW IDCT
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg-turbo's jpeg_idct_islow as its SIMD versions compute it
// (jidctint-sse2/avx2.asm, what OpenCV's build runs on x86-64): the
// algorithm of jidctint.c, but the dequantized coefficients, the sums
// in0 +- in4, in7 + in3 and in5 + in1, and the left shift of a block whose
// AC terms are all zero are 16-bit (they wrap), each pass's outputs are
// saturated to 16 bits, and the samples to [0, 255].  On valid data this
// equals jidctint.c; on damaged data it gives what OpenCV gives.
inline int32_t wrap16(int64_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v & 0xffff));
}
inline int32_t sat16(int64_t v) {
  return static_cast<int32_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

// One 1-D pass over 8 values (stride `st`) into 8 outputs, descaled by `s`
// and saturated to 16 bits.
inline void idct_1d(const int32_t* in, int st, int32_t* out, int ost, int s) {
  const int64_t F054 = FIX_0_541196100, F076 = FIX_0_765366865,
                F184 = FIX_1_847759065, F117 = FIX_1_175875602,
                F196 = FIX_1_961570560, F039 = FIX_0_390180644,
                F029 = FIX_0_298631336, F089 = FIX_0_899976223,
                F150 = FIX_1_501321110, F205 = FIX_2_053119869,
                F256 = FIX_2_562915447, F307 = FIX_3_072711026;
  const int64_t in0 = in[0], in1 = in[st], in2 = in[2 * st], in3 = in[3 * st],
                in4 = in[4 * st], in5 = in[5 * st], in6 = in[6 * st],
                in7 = in[7 * st];
  const int64_t tmp3 = in2 * (F054 + F076) + in6 * F054;
  const int64_t tmp2 = in2 * F054 + in6 * (F054 - F184);
  const int64_t tmp0 = int64_t(wrap16(in0 + in4)) * (int64_t(1) << kConstBits);
  const int64_t tmp1 = int64_t(wrap16(in0 - in4)) * (int64_t(1) << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const int64_t z3m = z3 * (F117 - F196) + z4 * F117;
  const int64_t z4m = z3 * F117 + z4 * (F117 - F039);
  const int64_t o0 = in7 * (F029 - F089) + in1 * -F089 + z3m;
  const int64_t o3 = in7 * -F089 + in1 * (F150 - F089) + z4m;
  const int64_t o1 = in5 * (F205 - F256) + in3 * -F256 + z4m;
  const int64_t o2 = in5 * -F256 + in3 * (F307 - F256) + z3m;
  out[0] = sat16(descale(tmp10 + o3, s));
  out[7 * ost] = sat16(descale(tmp10 - o3, s));
  out[ost] = sat16(descale(tmp11 + o2, s));
  out[6 * ost] = sat16(descale(tmp11 - o2, s));
  out[2 * ost] = sat16(descale(tmp12 + o1, s));
  out[5 * ost] = sat16(descale(tmp12 - o1, s));
  out[3 * ost] = sat16(descale(tmp13 + o0, s));
  out[4 * ost] = sat16(descale(tmp13 - o0, s));
}

// Coefficients in natural order times the quantization table, into an
// 8x8 block of out (row stride `stride`).
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                size_t stride) {
  int32_t deq[64], ws[64];
  bool ac_zero = true;
  for (int i = 0; i < 64; ++i) {
    deq[i] = wrap16(int32_t(in[i]) * q[i]);
    if (i >= 8 && in[i] != 0) ac_zero = false;
  }
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int32_t dc = wrap16(int64_t(deq[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c)
      idct_1d(deq + c, 8, ws + c, 8, kConstBits - kPass1Bits);
  }
  int32_t row[8];
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, 1, row, 1, kConstBits + kPass1Bits + 3);
    uint8_t* op = out + r * stride;
    for (int c = 0; c < 8; ++c)
      op[c] = static_cast<uint8_t>(std::clamp(row[c], -128, 127) + 128);
  }
}

// ------------------------------------------------------- YCbCr -> RGB tables
// jdcolor.c build_ycc_rgb_table.
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << kScale) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// -------------------------------------------------------------- the decoder
enum Status { kOk = 0, kCorrupt = 1, kRefused = 2, kSmall = 3 };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;     // downsampled size (jdinput.c)
  int plane_w = 0, plane_h = 0;
  std::vector<uint8_t> plane; // samples, block-padded to whole MCUs
  int16_t q[64];              // quantization table latched at its 1st scan
  bool latched = false;
  int dc = 0;                 // DC prediction
  // progressive: every block's coefficients (natural order), block-padded
  // to whole MCUs as libjpeg's whole-image buffer, and the successive-
  // approximation bit each coefficient is known to (jdphuff.c coef_bits;
  // -1: none of it yet)
  std::vector<int16_t> coef;
  int coef_bits[64];
  // coef_bits[1..9] as they were before the component's latest scan
  // (libjpeg-turbo's prev_coef_bits): block smoothing takes them for the
  // iMCU rows past the last one whose data was whole
  int prev_bits[10];
  int blocks_w() const { return plane_w / 8; }
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * blocks_w() + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  std::string msg;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc_tab[4], ac_tab[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool frame = false;
  bool progressive = false;
  int colour = 0;          // 0: libjpeg's guess; 1: YCbCr; 2: none (raw)
  // damaged data read as libjpeg-turbo reads it (see the header); else a
  // damaged stream fails
  bool lenient = false;
  int scans = 0;           // libjpeg's input_scan_number
  int last_good_row = 0;   // libjpeg-turbo's master->last_good_iMCU_row

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  Status refuse(const std::string& what) {
    msg = what;
    return kRefused;
  }

  static int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  Status parse_sof(int marker, const uint8_t* p, int len) {
    if (len < 6) return kCorrupt;
    int precision = p[0];
    height = be16(p + 1);
    width = be16(p + 3);
    ncomp = p[5];
    // jdinput.c initial_setup: a DCT-based JPEG of any precision but 8 or
    // 12 bits is an error (a damaged header)
    if (precision != 8 && precision != 12) return kCorrupt;
    if (precision != 8)
      return refuse(std::to_string(precision) +
                    "-bit sample precision (SOF" +
                    std::to_string(marker - 0xC0) +
                    "): only 8-bit JPEG is decoded");
    if (ncomp == 4)
      return refuse("4-component (CMYK/YCCK) JPEG is not decoded");
    if (ncomp != 1 && ncomp != 3) return kCorrupt;
    // get_sof: JERR_BAD_LENGTH unless the length is exactly the components'
    if (height == 0 || width == 0 || len != 6 + 3 * ncomp) return kCorrupt;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = p[6 + 3 * c];
      k.h = p[7 + 3 * c] >> 4;
      k.v = p[7 + 3 * c] & 15;
      k.tq = p[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        return kCorrupt;
      hmax = k.h > hmax ? k.h : hmax;
      vmax = k.v > vmax ? k.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.ds_w = static_cast<int>((int64_t(width) * k.h + hmax - 1) / hmax);
      k.ds_h = static_cast<int>((int64_t(height) * k.v + vmax - 1) / vmax);
      k.plane_w = mcux * k.h * 8;
      k.plane_h = mcuy * k.v * 8;
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
      for (int i = 0; i < 10; ++i) k.prev_bits[i] = 0;
      std::memset(k.q, 0, sizeof(k.q));
    }
    progressive = marker == 0xC2;
    frame = true;
    return kOk;
  }

  Status parse_dht(const uint8_t* p, int len) {
    while (len > 0) {
      if (len < 17) return kCorrupt;
      int tc = p[0] >> 4, th = p[0] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += p[1 + i];
      if (len < 17 + total) return kCorrupt;
      Huffman& h = tc == 0 ? dc_tab[th] : ac_tab[th];
      if (!h.build(p + 1, p + 17, total)) return kCorrupt;
      p += 17 + total;
      len -= 17 + total;
    }
    return kOk;
  }

  Status parse_dqt(const uint8_t* p, int len) {
    while (len > 0) {
      int pq = p[0] >> 4, tq = p[0] & 15;
      if (tq > 3 || pq > 1 || len < 1 + 64 * (pq + 1)) return kCorrupt;
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] =
            pq ? static_cast<uint16_t>(be16(p + 1 + 2 * i)) : p[1 + i];
      qt_defined[tq] = true;
      p += 1 + 64 * (pq + 1);
      len -= 1 + 64 * (pq + 1);
    }
    return kOk;
  }

  // Baseline block: DC difference then run/size AC symbols.
  inline bool decode_block(BitReader& br, Component& k, const Huffman& dct,
                           const Huffman& act, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = br.decode(dct);
    if (s < 0 || s > 16) return false;
    int diff = extend(br.bits(s), s);
    k.dc += diff;
    blk[0] = static_cast<int16_t>(k.dc);
    for (int i = 1; i < 64; ++i) {
      int rs = br.decode(act);
      if (rs < 0) return false;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    return true;
  }

  Status decode_scan(BitReader& br, Component** sc, const int* td,
                     const int* ta, int ns) {
    // Undefined tables 0 and 1 take Annex K's (jdhuff.c std_huff_tables).
    if (!dc_tab[0].defined) dc_tab[0].build(kDcLumBits, kDcVals, 12);
    if (!dc_tab[1].defined) dc_tab[1].build(kDcChromBits, kDcVals, 12);
    if (!ac_tab[0].defined) ac_tab[0].build(kAcLumBits, kAcLumVals, 162);
    if (!ac_tab[1].defined) ac_tab[1].build(kAcChromBits, kAcChromVals, 162);
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (td[i] > 3 || ta[i] > 3) return kCorrupt;
      if (!dc_tab[td[i]].defined || !ac_tab[ta[i]].defined) return kCorrupt;
      if (!dc_tab[td[i]].dc_ok()) return kCorrupt;
      if (!latch(k)) return kCorrupt;
      if (k.plane.empty())
        k.plane.assign(static_cast<size_t>(k.plane_w) * k.plane_h, 0);
      k.dc = 0;
    }
    int units_x, units_y;
    if (ns == 1) {  // non-interleaved: one block per MCU
      units_x = (sc[0]->ds_w + 7) / 8;
      units_y = (sc[0]->ds_h + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int64_t total = int64_t(units_x) * units_y;
    int16_t blk[64];
    int rst = 0;
    br.lenient = lenient;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        if (lenient)
          br.restart(rst);
        else if (!br.strict_restart(rst))
          return kCorrupt;
        for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
      }
      // out of data: the MCU is left zero, a uniform grey
      const bool short_data = br.insufficient;
      int mx = static_cast<int>(m % units_x), my = static_cast<int>(m / units_x);
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
        for (int v = 0; v < bv; ++v)
          for (int h = 0; h < bh; ++h) {
            if (short_data)
              std::memset(blk, 0, sizeof(blk));
            else if (!decode_block(br, k, dc_tab[td[i]], ac_tab[ta[i]], blk))
              return kCorrupt;
            size_t x = (size_t(mx) * bh + h) * 8, y = (size_t(my) * bv + v) * 8;
            idct_islow(blk, k.q, k.plane.data() + y * k.plane_w + x,
                       static_cast<size_t>(k.plane_w));
          }
      }
    }
    if (br.insufficient && !lenient) return kCorrupt;
    return kOk;
  }

  // ------------------------------------------------------ progressive
  // One scan of a progressive JPEG into the coefficient buffers, as
  // jdphuff.c decodes it: DC first (differences, scaled by Al), DC refine
  // (one bit per block), AC first (one component, the band Ss..Se with
  // end-of-band runs) and AC refine (newly nonzero coefficients and the
  // correction bits of those already nonzero).  A non-interleaved scan
  // covers the component's own blocks, not the MCU-padded grid.
  Status decode_prog_scan(BitReader& br, Component** sc, const int* td,
                          const int* ta, int ns, int ss, int se, int ah,
                          int al) {
    const bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) return kCorrupt;                  // JERR_BAD_PROGRESSION
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (dc_band ? (ah == 0 && (td[i] > 3 || !dc_tab[td[i]].defined))
                  : (ta[i] > 3 || !ac_tab[ta[i]].defined))
        return kCorrupt;
      if (dc_band && ah == 0 && !dc_tab[td[i]].dc_ok()) return kCorrupt;
      if (!latch(k)) return kCorrupt;
      if (k.coef.empty())
        k.coef.assign(static_cast<size_t>(k.plane_w / 8) * (k.plane_h / 8) *
                          64, 0);
      // jdphuff.c start_pass_phuff_decoder's progression bookkeeping
      for (int c = std::min(ss, 1); c <= std::max(se, 9); ++c)
        if (c < 10) k.prev_bits[c] = scans > 1 ? k.coef_bits[c] : 0;
      for (int c = ss; c <= se; ++c) k.coef_bits[c] = al;
      k.dc = 0;
    }
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->ds_w + 7) / 8;
      units_y = (sc[0]->ds_h + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int64_t total = int64_t(units_x) * units_y;
    int eobrun = 0, rst = 0;
    br.lenient = lenient;
    for (int64_t m = 0; m < total; ++m) {
      const int mx = static_cast<int>(m % units_x);
      const int my = static_cast<int>(m / units_x);
      // jdcoefct.c consume_data: the iMCU row of the last MCU met with
      // data left
      if (!br.insufficient) last_good_row = ns == 1 ? my / sc[0]->v : my;
      if (restart_interval && m && m % restart_interval == 0) {
        if (lenient)
          br.restart(rst);
        else if (!br.strict_restart(rst))
          return kCorrupt;
        for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
        eobrun = 0;
      }
      // out of data: the blocks keep what earlier scans gave them (a DC
      // refinement reads on, its zero bits change nothing)
      if (br.insufficient && !(dc_band && ah != 0)) continue;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
        for (int v = 0; v < bv; ++v)
          for (int h = 0; h < bh; ++h) {
            int16_t* blk = k.block(mx * bh + h, my * bv + v);
            bool ok;
            if (dc_band && ah == 0) {
              ok = dc_first(br, k, dc_tab[td[i]], blk, al);
            } else if (dc_band) {
              if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              ok = true;
            } else if (ah == 0) {
              ok = ac_first(br, ac_tab[ta[i]], blk, ss, se, al, eobrun);
            } else {
              ok = ac_refine(br, ac_tab[ta[i]], blk, ss, se, al, eobrun);
            }
            if (!ok) return kCorrupt;
          }
      }
    }
    if (br.insufficient && !lenient) return kCorrupt;
    return kOk;
  }

  bool latch(Component& k) {
    if (!k.latched) {
      if (!qt_defined[k.tq]) return false;
      for (int j = 0; j < 64; ++j) k.q[j] = static_cast<int16_t>(qt[k.tq][j]);
      k.latched = true;
    }
    return true;
  }

  static bool dc_first(BitReader& br, Component& k, const Huffman& tab,
                       int16_t* blk, int al) {
    int s = br.decode(tab);
    if (s < 0 || s > 16) return false;
    k.dc += extend(br.bits(s), s);
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(k.dc) << al);
    return true;
  }

  static bool ac_first(BitReader& br, const Huffman& tab, int16_t* blk,
                       int ss, int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(tab);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;                               // ZRL
      } else {                                 // EOBr
        eobrun = (1 << r) + br.bits(r) - 1;
        break;
      }
    }
    return true;
  }

  // A correction bit for each already nonzero coefficient from k on
  // until `stop` zero coefficients have been passed (stop < 0: to Se);
  // returns the position reached.
  static int correct(BitReader& br, int16_t* blk, int k, int se, int stop,
                     int p1) {
    for (; k <= se; ++k) {
      int16_t& c = blk[kNatural[k]];
      if (c != 0) {
        if (br.bits(1) && (c & p1) == 0)
          c = static_cast<int16_t>(c >= 0 ? c + p1 : c - p1);
      } else if (stop >= 0 && --stop < 0) {
        break;
      }
    }
    return k;
  }

  static bool ac_refine(BitReader& br, const Huffman& tab, int16_t* blk,
                        int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(tab);
        if (rs < 0) return false;
        int r = rs >> 4, s = rs & 15, value = 0;
        if (s) {                               // size 1: a new +-1
          value = br.bits(1) ? p1 : -p1;
        } else if (r != 15) {                  // EOBr
          eobrun = (1 << r) + br.bits(r);
          break;
        }
        k = correct(br, blk, k, se, r, p1);
        if (value) blk[kNatural[k]] = static_cast<int16_t>(value);
      }
    }
    if (eobrun > 0) {
      correct(br, blk, k, se, -1, p1);
      --eobrun;
    }
    return true;
  }

  // libjpeg-turbo's output of the coefficient buffers (jdcoefct.c): the
  // ISLOW IDCT of every block, after block smoothing where the scans left
  // some of the first nine AC coefficients (or, with none of them sent,
  // the DC too) short of full precision (smoothing_ok).  Block smoothing
  // reads the progression as it stood before the last scan's start in the
  // iMCU rows after the last one that scan reached with data left.
  Status prog_output() {
    const bool smooth = smoothing_ok();
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      if (k.coef.empty())
        k.coef.assign(static_cast<size_t>(k.plane_w / 8) * (k.plane_h / 8) *
                          64, 0);
      k.plane.assign(static_cast<size_t>(k.plane_w) * k.plane_h, 0);
      const int bw = k.plane_w / 8, bh = k.plane_h / 8;
      if (!smooth) {
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bw; ++bx)
            idct_islow(k.block(bx, by), k.q,
                       k.plane.data() + (size_t(by) * k.plane_w + bx) * 8,
                       static_cast<size_t>(k.plane_w));
        continue;
      }
      smooth_component(k);
    }
    return kOk;
  }

  bool smoothing_ok() const {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp; ++c) {
      const Component& k = comp[c];
      if (!k.latched) return false;
      for (int p : kPos)
        if (k.q[p] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data for one component: each block's
  // first nine AC coefficients, where still zero and not known exactly,
  // estimated from the DC values of its 5x5 neighbourhood (rows and
  // columns clamped as libjpeg-turbo clamps them, its iMCU-row
  // bookkeeping included).
  void smooth_component(Component& k) {
    const int wib = (k.ds_w + 7) / 8, hib = (k.ds_h + 7) / 8;
    int prev_latch[10];         // smoothing_ok's latch of prev_coef_bits
    prev_latch[0] = k.coef_bits[0];
    for (int i = 1; i < 10; ++i) prev_latch[i] = scans > 1 ? k.prev_bits[i] : -1;
    const int64_t Q00 = k.q[0], Q01 = k.q[1], Q10 = k.q[8], Q20 = k.q[16],
                  Q11 = k.q[9], Q02 = k.q[2], Q03 = k.q[3], Q12 = k.q[10],
                  Q21 = k.q[17], Q30 = k.q[24];
    const int rows = mcuy, v = ncomp == 1 ? k.v : k.v;
    int16_t ws[64];
    for (int R = 0; R < rows; ++R) {
      const int* bits = R > last_good_row ? prev_latch : k.coef_bits;
      const bool change_dc = bits[1] == -1 && bits[2] == -1 &&
                             bits[3] == -1 && bits[4] == -1 &&
                             bits[5] == -1 && bits[6] == -1 &&
                             bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
      int block_rows = v;
      if (R == rows - 1 && hib % v) block_rows = hib % v;
      const int image_rows = block_rows * rows;
      for (int br = 0; br < block_rows; ++br) {
        const int y = R * v + br, r = R * block_rows + br;
        const int prev = r > 0 ? y - 1 : y;
        const int pprev = r > 1 ? y - 2 : prev;
        const int next = r < image_rows - 1 ? y + 1 : y;
        const int nnext = r < image_rows - 2 ? y + 2 : next;
        const int row_of[5] = {pprev, prev, y, next, nnext};
        for (int x = 0; x < wib; ++x) {
          int d[5][5];
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) {
              int cx = std::min(std::max(x + j - 2, 0), wib - 1);
              d[i][j] = k.block(cx, row_of[i])[0];
            }
#define DC(n) int64_t(d[((n) - 1) / 5][((n) - 1) % 5])
          std::memcpy(ws, k.block(x, y), sizeof(ws));
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0)
            ws[1] = estimate(Q00 * (change_dc
                ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
                   13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
                   38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
                   13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) +
                   DC(25))
                : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15))),
                Q01, al);
          if ((al = bits[2]) != 0 && ws[8] == 0)
            ws[8] = estimate(Q00 * (change_dc
                ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) -
                   DC(6) + 13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) +
                   DC(16) - 13 * DC(17) - 38 * DC(18) - 13 * DC(19) +
                   DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) +
                   DC(25))
                : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23))),
                Q10, al);
          if ((al = bits[3]) != 0 && ws[16] == 0)
            ws[16] = estimate(Q00 * (change_dc
                ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
                   14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
                   2 * DC(19) + DC(23))
                : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) -
                   DC(23))),
                Q20, al);
          if ((al = bits[4]) != 0 && ws[9] == 0)
            ws[9] = estimate(Q00 * (change_dc
                ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
                   9 * DC(19) + DC(21) - DC(25))
                : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) -
                   DC(20) + DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) -
                   10 * DC(9))),
                Q11, al);
          if ((al = bits[5]) != 0 && ws[2] == 0)
            ws[2] = estimate(Q00 * (change_dc
                ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
                   14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) -
                   5 * DC(18) + 2 * DC(19))
                : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) -
                   DC(15))),
                Q02, al);
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)
              ws[3] = estimate(Q00 * (DC(7) - DC(9) + 2 * DC(12) -
                                      2 * DC(14) + DC(17) - DC(19)),
                               Q03, al);
            if ((al = bits[7]) != 0 && ws[10] == 0)
              ws[10] = estimate(Q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) +
                                       3 * DC(18) - DC(19)),
                                Q12, al);
            if ((al = bits[8]) != 0 && ws[17] == 0)
              ws[17] = estimate(Q00 * (DC(7) - DC(9) - 3 * DC(12) +
                                       3 * DC(14) + DC(17) - DC(19)),
                                Q21, al);
            if ((al = bits[9]) != 0 && ws[24] == 0)
              ws[24] = estimate(Q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) -
                                       2 * DC(18) - DC(19)),
                                Q30, al);
            ws[0] = estimate(Q00 * (
                -2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
                6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
                8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) -
                8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) +
                6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) -
                8 * DC(23) - 6 * DC(24) - 2 * DC(25)),
                Q00, 0);
          }
#undef DC
          idct_islow(ws, k.q,
                     k.plane.data() + (size_t(y) * k.plane_w + x) * 8,
                     static_cast<size_t>(k.plane_w));
        }
      }
    }
  }

  // One estimate: num / (256 q) rounded, its magnitude kept below 2^al
  // when the coefficient is known to bit al (al > 0).
  static int16_t estimate(int64_t num, int64_t q, int al) {
    int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) /
                                (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return static_cast<int16_t>(num >= 0 ? pred : -pred);
  }

  // Walk the markers; with header_only stop at the frame header.
  Status run(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kCorrupt;
    size_t pos = 2;
    bool any_scan = false, complete = false;
    int pending = 0;     // the marker a scan's data ran into
    while (!complete) {
      int m = pending;
      pending = 0;
      if (!m) {
        while (pos < n && d[pos] != 0xFF) ++pos;  // garbage before a marker
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) break;                      // no EOI: end of data
        m = d[pos++];
      }
      if (m == 0xD9) break;                       // EOI
      // TEM and RSTn carry no length; FF00 is stuffed data, which
      // next_marker() discards
      if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD8) return kCorrupt;             // JERR_SOI_DUPLICATE
      if (pos + 2 > n) return kCorrupt;
      int len = be16(d + pos) - 2;
      if (len < 0 || pos + 2 + len > n) return kCorrupt;
      const uint8_t* p = d + pos + 2;
      pos += 2 + len;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (frame) return kCorrupt;               // JERR_SOF_DUPLICATE
        if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
          Status st = parse_sof(m, p, len);
          if (st != kOk || header_only) return st;
          continue;
        }
        std::string sof = " (SOF" + std::to_string(m - 0xC0) + ")";
        if (m == 0xC3) return refuse("lossless JPEG" + sof + " is not decoded");
        if (m == 0xC9)
          return refuse("arithmetic-coded sequential JPEG" + sof + " is not decoded");
        if (m == 0xCA)
          return refuse("arithmetic-coded progressive JPEG" + sof + " is not decoded");
        if (m == 0xCB)
          return refuse("arithmetic-coded lossless JPEG" + sof + " is not decoded");
        return refuse("hierarchical JPEG" + sof + " is not decoded");
      }
      switch (m) {
        case 0xC4: {
          Status st = parse_dht(p, len);
          if (st != kOk) return st;
          break;
        }
        case 0xCC:
          // after a Huffman frame header (a damaged photo): jdmarker.c
          // get_dac's checks, the values unused
          if (!(lenient && frame))
            return refuse("arithmetic-coded JPEG (DAC) is not decoded");
          if (len % 2) return kCorrupt;
          for (int i = 0; i < len; i += 2)
            if (p[i] >= 32 || (p[i] < 16 && (p[i + 1] & 15) > (p[i + 1] >> 4)))
              return kCorrupt;
          break;
        case 0xDB: {
          Status st = parse_dqt(p, len);
          if (st != kOk) return st;
          break;
        }
        case 0xDD:
          if (len != 2) return kCorrupt;           // get_dri
          restart_interval = be16(p);
          break;
        case 0xE0:
          if (len >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xEE:
          if (len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = p[11];
          }
          break;
        case 0xDA: {
          if (!frame || len < 1) return kCorrupt;
          int ns = p[0];
          // get_sos: JERR_BAD_LENGTH unless the length is exactly 6 + 2 ns
          if (ns < 1 || ns > ncomp || len != 4 + 2 * ns) return kCorrupt;
          Component* sc[3];
          int td[3], ta[3];
          for (int i = 0; i < ns; ++i) {
            int id = p[1 + 2 * i];
            sc[i] = nullptr;
            for (int c = 0; c < ncomp; ++c)
              if (comp[c].id == id) sc[i] = &comp[c];
            td[i] = p[2 + 2 * i] >> 4;
            ta[i] = p[2 + 2 * i] & 15;
            // a table number past 3 fails where a scan uses the table
            // (jdhuff.c jpeg_make_d_derived_tbl)
            if (!sc[i]) return kCorrupt;
          }
          int blocks = 0;
          for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
          if (ns > 1 && blocks > 10) return kCorrupt;
          const uint8_t* sp = p + 1 + 2 * ns;  // Ss, Se, Ah/Al
          BitReader br{d, n, pos};
          ++scans;
          Status st = progressive
              ? decode_prog_scan(br, sc, td, ta, ns, sp[0], sp[1], sp[2] >> 4,
                                 sp[2] & 15)
              : decode_scan(br, sc, td, ta, ns);
          if (st != kOk) return st;
          any_scan = true;
          // one scan of every component, not progressive: libjpeg outputs
          // it as it reads it and reads what follows only in
          // jpeg_finish_decompress, whose errors OpenCV ignores
          if (!progressive && ns == ncomp) {
            complete = true;
            break;
          }
          pending = br.marker;
          pos = br.pos;
          break;
        }
        default:
          // APPn, COM, DNL; read_markers() fails on any other marker
          if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC))
            return kCorrupt;
          break;
      }
    }
    if (!frame) return kCorrupt;
    if (header_only) return kOk;
    if (!any_scan) return kCorrupt;
    if (progressive) return prog_output();
    for (int c = 0; c < ncomp; ++c)
      if (comp[c].plane.empty()) return kCorrupt;
    return kOk;
  }

  // jdsample.c: component c at full size (hmax x vmax) into out, a plane of
  // out_w x out_h (at least ds_w*hx x ds_h*vx).
  Status upsample(const Component& k, std::vector<uint8_t>& out, int& out_w) {
    if (hmax % k.h || vmax % k.v)
      return refuse("fractional sampling factors are not decoded");
    const int hx = hmax / k.h, vx = vmax / k.v;
    const int W = k.ds_w, H = k.ds_h, S = k.plane_w;
    const uint8_t* in = k.plane.data();
    out_w = W * hx;
    out.assign(static_cast<size_t>(out_w) * H * vx, 0);
    auto row = [&](int r) {
      r = r < 0 ? 0 : r >= H ? H - 1 : r;    // context rows replicated
      return in + static_cast<size_t>(r) * S;
    };
    if (hx == 2 && vx == 1 && W > 2) {       // h2v1_fancy_upsample
      for (int r = 0; r < H; ++r) {
        const uint8_t* ip = row(r);
        uint8_t* op = out.data() + static_cast<size_t>(r) * out_w;
        int v = ip[0];
        op[0] = v;
        op[1] = (v * 3 + ip[1] + 2) >> 2;
        for (int c = 1; c < W - 1; ++c) {
          v = ip[c] * 3;
          op[2 * c] = (v + ip[c - 1] + 1) >> 2;
          op[2 * c + 1] = (v + ip[c + 1] + 2) >> 2;
        }
        v = ip[W - 1];
        op[2 * W - 2] = (v * 3 + ip[W - 2] + 1) >> 2;
        op[2 * W - 1] = v;
      }
    } else if (hx == 1 && vx == 2) {         // h1v2_fancy_upsample
      for (int r = 0; r < H; ++r)
        for (int half = 0; half < 2; ++half) {
          const uint8_t* i0 = row(r);
          const uint8_t* i1 = row(half ? r + 1 : r - 1);
          const int bias = half ? 2 : 1;
          uint8_t* op = out.data() + static_cast<size_t>(2 * r + half) * out_w;
          for (int c = 0; c < W; ++c) op[c] = (i0[c] * 3 + i1[c] + bias) >> 2;
        }
    } else if (hx == 2 && vx == 2 && W > 2) {  // h2v2_fancy_upsample
      for (int r = 0; r < H; ++r)
        for (int half = 0; half < 2; ++half) {
          const uint8_t* i0 = row(r);
          const uint8_t* i1 = row(half ? r + 1 : r - 1);
          uint8_t* op = out.data() + static_cast<size_t>(2 * r + half) * out_w;
          int this_sum = i0[0] * 3 + i1[0];
          int next_sum = i0[1] * 3 + i1[1];
          op[0] = (this_sum * 4 + 8) >> 4;
          op[1] = (this_sum * 3 + next_sum + 7) >> 4;
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int c = 2; c < W; ++c) {
            next_sum = i0[c] * 3 + i1[c];
            op[2 * c - 2] = (this_sum * 3 + last_sum + 8) >> 4;
            op[2 * c - 1] = (this_sum * 3 + next_sum + 7) >> 4;
            last_sum = this_sum;
            this_sum = next_sum;
          }
          op[2 * W - 2] = (this_sum * 3 + last_sum + 8) >> 4;
          op[2 * W - 1] = (this_sum * 4 + 7) >> 4;
        }
    } else {                                 // fullsize or int_upsample
      for (int r = 0; r < H; ++r) {
        const uint8_t* ip = in + static_cast<size_t>(r) * S;
        for (int j = 0; j < vx; ++j) {
          uint8_t* op = out.data() + static_cast<size_t>(r * vx + j) * out_w;
          for (int c = 0; c < W; ++c)
            for (int i = 0; i < hx; ++i) op[c * hx + i] = ip[c];
        }
      }
    }
    return kOk;
  }

  Status to_rgb(uint8_t* rgb) {
    std::vector<uint8_t> up[3];
    int up_w[3];
    for (int c = 0; c < ncomp; ++c) {
      Status st = upsample(comp[c], up[c], up_w[c]);
      if (st != kOk) return st;
    }
    if (ncomp == 1) {
      for (int y = 0; y < height; ++y) {
        const uint8_t* g = up[0].data() + static_cast<size_t>(y) * up_w[0];
        uint8_t* o = rgb + static_cast<size_t>(y) * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return kOk;
    }
    // jdapimin.c default_decompress_parms: the JPEG colour space.
    bool rgb_space;
    if (colour != 0)
      rgb_space = colour == 2;
    else if (saw_jfif)
      rgb_space = false;
    else if (saw_adobe)
      rgb_space = adobe_transform == 0;
    else
      rgb_space = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    for (int y = 0; y < height; ++y) {
      const uint8_t* p0 = up[0].data() + static_cast<size_t>(y) * up_w[0];
      const uint8_t* p1 = up[1].data() + static_cast<size_t>(y) * up_w[1];
      const uint8_t* p2 = up[2].data() + static_cast<size_t>(y) * up_w[2];
      uint8_t* o = rgb + static_cast<size_t>(y) * width * 3;
      if (rgb_space) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = p0[x];
          o[3 * x + 1] = p1[x];
          o[3 * x + 2] = p2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        int yy = p0[x], cb = p1[x], cr = p2[x];
        o[3 * x] = clamp255(yy + kColor.cr_r[cr]);
        o[3 * x + 1] = clamp255(
            yy + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + kColor.cb_b[cb]);
      }
    }
    return kOk;
  }
};

// The bytes a lenient decoder reads: the data, then what libjpeg's
// source managers give for every read past its end, a fake EOI (FF D9) as
// often as they are asked (enough for a segment of the largest length cut
// at its first byte).  So a segment or scan header cut by the end of a
// file reads those bytes, as libjpeg reads them.
std::vector<uint8_t> past_the_end(const uint8_t* data, size_t n) {
  std::vector<uint8_t> v;
  v.reserve(n + 65540);
  v.assign(data, data + n);
  for (int i = 0; i < 32770; ++i) {
    v.push_back(0xFF);
    v.push_back(0xD9);
  }
  return v;
}

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
  }
}

}  // namespace

extern "C" {

// Image size of a JPEG in memory.  0: *h and *w set; 1: not a decodable
// JPEG; 2: a JPEG this decoder refuses (msg names the process).  `flags`
// as jpegdec_decode's (bit 0 reads past the end as libjpeg does).
int jpegdec_info(const uint8_t* data, int64_t n, int flags, int* h, int* w,
                 char* msg, int msg_len) {
  std::vector<uint8_t> padded;
  if (flags & 1) padded = past_the_end(data, static_cast<size_t>(n));
  Decoder dec(padded.empty() ? data : padded.data(),
              padded.empty() ? static_cast<size_t>(n) : padded.size());
  Status st = dec.run(true);
  put_msg(dec.msg, msg, msg_len);
  if (st == kOk) {
    *h = dec.height;
    *w = dec.width;
  }
  return st;
}

// Decode a JPEG in memory to h*w*3 RGB bytes.  0: done, *h and *w set;
// 1: corrupt or truncated; 2: refused (msg names the process); 3: `cap`
// is smaller than h*w*3.  `flags` bit 0 (lenient): damaged or short
// entropy-coded data of a sequential JPEG decodes as libjpeg-turbo decodes
// it (restart markers resynchronised, progressive scans kept, reads past
// the end given the fake EOI); bits 1-2: the colour space as a caller sets
// jpeg_color_space (0: libjpeg's guess, 1: YCbCr, 2: none, three
// components as stored).
int jpegdec_decode(const uint8_t* data, int64_t n, int flags, uint8_t* rgb,
                   int64_t cap, int* h, int* w, char* msg, int msg_len) {
  std::vector<uint8_t> padded;
  if (flags & 1) padded = past_the_end(data, static_cast<size_t>(n));
  Decoder dec(padded.empty() ? data : padded.data(),
              padded.empty() ? static_cast<size_t>(n) : padded.size());
  dec.lenient = (flags & 1) != 0;
  dec.colour = (flags >> 1) & 3;
  Status st = dec.run(false);
  if (st == kOk) {
    *h = dec.height;
    *w = dec.width;
    if (int64_t(dec.height) * dec.width * 3 > cap)
      st = kSmall;
    else
      st = dec.to_rgb(rgb);
  }
  put_msg(dec.msg, msg, msg_len);
  return st;
}

}  // extern "C"
