// mpeg12 — an MPEG-1 and MPEG-2 Main and 4:2:2 Profile video decoder
// (4:2:0 and 4:2:2, 8-bit frame pictures, as FFmpeg's `mpeg1video` and `mpeg2video` encoders,
// OpenCV's `MPEG`/`mpg1`/`mpg2` writers, DVD authoring tools, camcorders
// and broadcast encoders write them) with no library but the C++ standard
// library.
//
// It gives the pixels FFmpeg's mpeg12dec.c gives, bit for bit:
//   - headers: the sequence header with its loaded matrices (an intra
//     matrix's first entry taken as 8, as FFmpeg takes it), the sequence
//     extension, sequence_display_extension with its colour description,
//     the quant matrix extension (luma and chroma), the GOP header
//     (closed_gop), the picture header (MPEG-1's full_pel and f_code) and
//     the picture coding extension (f_codes, intra_dc_precision 8-11,
//     top_field_first, frame_pred_frame_dct, concealment_motion_vectors,
//     q_scale_type, intra_vlc_format, alternate_scan, repeat_first_field,
//     progressive_frame);
//   - slices (with the vertical position extension above 2800 lines) and
//     macroblock_address_increment with MPEG-1's escape and stuffing; the
//     I, P and B macroblock_type tables; skipped macroblocks (P: a zero
//     vector; B: the previous macroblock's vectors and directions);
//     concealment vectors; MPEG-1 full_pel vectors; frame and field
//     motion_type and field dct_type in frame pictures; B pictures, the
//     two predictions averaged with rounding (FFmpeg's x86 half-pel put and
//     average, mpegvideo_dsp.h);
//   - 4:2:2 chroma (chroma_format 2): eight blocks a macroblock (the
//     coded_block_pattern's two more bits), the chroma matrices, chroma at
//     full height in motion compensation and in field DCT, as FFmpeg's
//     mpeg_motion_internal and mpv_reconstruct_mb lay them out;
//   - dequantisation: MPEG-1's with oddification, MPEG-2's with mismatch
//     control on the last coefficient, the linear and non-linear
//     quantiser_scale, MPEG-2's 12-bit escapes and MPEG-1's 8/16-bit ones;
//     the tables B-14 and B-15; FFmpeg's "simple" IDCT;
//   - frames in display order with FFmpeg's one-frame delay (none under
//     low_delay) and its end-of-stream flush; `repeat_first_field` gives no
//     extra frame (OpenCV gives each coded frame once);
//   - FFmpeg's rules for a stream joined mid-way: pictures before the first
//     sequence header fail, P pictures before a GOP header or I picture and
//     B pictures of an open GOP without their older reference are skipped;
//     a P picture after a GOP header but no I picture predicts from grey;
//     a picture packet too small for its macroblock count fails;
//   - damage: a slice that does not parse, or macroblocks no slice reaches,
//     are concealed from the start of the damaged slice as FFmpeg's error
//     resilience conceals them (conceal(): B and P pictures from their
//     references at a zero vector, I pictures by guessed DC values or the
//     forward reference), short of its vector guessing;
//   - the crop of the macroblock-aligned picture to the sequence's size and
//     YUV 4:2:0 -> RGB as OpenCV's FFmpeg backend returns it
//     (swscale_rgb.h, the colour description's matrix: BT.601 or BT.709;
//     chroma sited at the centre for MPEG-1, left for MPEG-2).
//     4:2:2 goes through swscale's unscaled converter at an even height
//     (swscale_rgb::unscaled, as lossless_frame.h uses it).
// A tool it does not decode raises with the tool named: field pictures
// (picture_structure 1/2), dual-prime prediction (in a slice that parses
// to its end; in one that breaks it is taken for damage), 4:4:4 chroma and
// 4:2:2 at an odd height (their conversions go through swscale's scaled
// path), the scalable extensions, MPEG-1 D-pictures and colour matrices other than
// unknown, BT.601 (BT.470BG, SMPTE 170M) and BT.709.
//
// C ABI; Python binds it through ctypes (io/mpeg12.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libmpeg12dec.so mpeg12.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "mpegvideo_dsp.h"
#include "swscale_rgb.h"

namespace {

using namespace mpegvideo_dsp;

enum Status { kFrame = 0, kNoFrame = 1, kUnsupported = 2, kCorrupt = 3,
              kSmall = 4 };

struct Error {
  Status status;
  std::string msg;
};

[[noreturn]] void unsupported(const std::string& tool) {
  throw Error{kUnsupported, "MPEG-1/2 video: " + tool +
                                " is not decoded (4:2:0 frame pictures "
                                "without it only)"};
}

[[noreturn]] void corrupt(const std::string& what) {
  throw Error{kCorrupt, "corrupt MPEG-1/2 stream: " + what};
}

// ---------------------------------------------------------------- bits

// MSB-first reader over n bytes that the caller pads with at least 16 zero
// bytes; reads past the end give zeros and count as an overrun.
class Bits {
 public:
  Bits(const uint8_t* p, int64_t n) : p_(p), nbits_(n * 8) {}
  uint32_t peek(int n) const {  // 1 <= n <= 32
    if (pos_ >= nbits_ + 64) corrupt("read past the end of the data");
    uint64_t v;
    std::memcpy(&v, p_ + (pos_ >> 3), 8);
    v = __builtin_bswap64(v) << (pos_ & 7);
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
  int sget(int n) {  // n bits as a two's complement number
    return static_cast<int32_t>(get(n) << (32 - n)) >> (32 - n);
  }
  int64_t pos() const { return pos_; }
  int64_t left() const { return nbits_ - pos_; }

 private:
  const uint8_t* p_;
  int64_t nbits_;
  int64_t pos_ = 0;
};

// ---------------------------------------------------------------- VLCs

struct Code {
  const char* bits;  // the code word, '0'/'1'
  int sym;
};

// A prefix code read by one lookup.
class Vlc {
 public:
  Vlc(const Code* codes, int n) {
    for (int i = 0; i < n; ++i)
      bits_ = std::max<int>(bits_, static_cast<int>(std::strlen(codes[i].bits)));
    sym_.assign(size_t(1) << bits_, 0);
    len_.assign(size_t(1) << bits_, 0);
    for (int i = 0; i < n; ++i) {
      const int len = static_cast<int>(std::strlen(codes[i].bits));
      uint32_t code = 0;
      for (int k = 0; k < len; ++k) code = code * 2 + (codes[i].bits[k] - '0');
      const int shift = bits_ - len;
      const size_t lo = size_t(code) << shift;
      for (size_t k = lo; k < lo + (size_t(1) << shift); ++k) {
        sym_[k] = static_cast<int16_t>(codes[i].sym);
        len_[k] = static_cast<uint8_t>(len);
      }
    }
  }
  // The symbol, or -1 for a code not in the table (nothing consumed).
  int read(Bits& b) const {
    const uint32_t x = b.peek(bits_);
    if (!len_[x]) return -1;
    b.skip(len_[x]);
    return sym_[x];
  }

 private:
  int bits_ = 0;
  std::vector<int16_t> sym_;
  std::vector<uint8_t> len_;
};

// macroblock_address_increment (Table B-1): symbol = increment - 1; 33
// escape (+33), 34 MPEG-1 stuffing, 35 eight zero bits (a start code: the
// end of the slice).
constexpr int kIncrEscape = 33, kIncrStuffing = 34, kIncrEnd = 35;
const Code kMbIncr[] = {
    {"1", 0}, {"011", 1}, {"010", 2}, {"0011", 3}, {"0010", 4},
    {"00011", 5}, {"00010", 6}, {"0000111", 7}, {"0000110", 8},
    {"00001011", 9}, {"00001010", 10}, {"00001001", 11}, {"00001000", 12},
    {"00000111", 13}, {"00000110", 14}, {"0000010111", 15},
    {"0000010110", 16}, {"0000010101", 17}, {"0000010100", 18},
    {"0000010011", 19}, {"0000010010", 20}, {"00000100011", 21},
    {"00000100010", 22}, {"00000100001", 23}, {"00000100000", 24},
    {"00000011111", 25}, {"00000011110", 26}, {"00000011101", 27},
    {"00000011100", 28}, {"00000011011", 29}, {"00000011010", 30},
    {"00000011001", 31}, {"00000011000", 32}, {"00000001000", kIncrEscape},
    {"00000001111", kIncrStuffing}, {"00000000", kIncrEnd}};

// macroblock_type flags
constexpr int kQuant = 1, kFwd = 2, kBwd = 4, kCbp = 8, kIntra = 16;
// P pictures (Table B-3): no motion-compensation flag means a zero vector
const Code kMbTypeP[] = {
    {"1", kFwd | kCbp}, {"01", kCbp}, {"001", kFwd},
    {"00011", kIntra}, {"00010", kQuant | kFwd | kCbp},
    {"00001", kQuant | kCbp}, {"000001", kQuant | kIntra}};
// B pictures (Table B-4)
const Code kMbTypeB[] = {
    {"10", kFwd | kBwd}, {"11", kFwd | kBwd | kCbp}, {"010", kBwd},
    {"011", kBwd | kCbp}, {"0010", kFwd}, {"0011", kFwd | kCbp},
    {"00011", kIntra}, {"00010", kQuant | kFwd | kBwd | kCbp},
    {"000011", kQuant | kFwd | kCbp}, {"000010", kQuant | kBwd | kCbp},
    {"000001", kQuant | kIntra}};

// coded_block_pattern (Table B-9), bit 5 = Y0 ... bit 0 = Cr.
const Code kCbpCodes[] = {
    {"111", 60}, {"1101", 4}, {"1100", 8}, {"1011", 16}, {"1010", 32},
    {"10011", 12}, {"10010", 48}, {"10001", 20}, {"10000", 40},
    {"01111", 28}, {"01110", 44}, {"01101", 52}, {"01100", 56},
    {"01011", 1}, {"01010", 61}, {"01001", 2}, {"01000", 62},
    {"001111", 24}, {"001110", 36}, {"001101", 3}, {"001100", 63},
    {"0010111", 5}, {"0010110", 9}, {"0010101", 17}, {"0010100", 33},
    {"0010011", 6}, {"0010010", 10}, {"0010001", 18}, {"0010000", 34},
    {"00011111", 7}, {"00011110", 11}, {"00011101", 19}, {"00011100", 35},
    {"00011011", 13}, {"00011010", 49}, {"00011001", 21}, {"00011000", 41},
    {"00010111", 14}, {"00010110", 50}, {"00010101", 22}, {"00010100", 42},
    {"00010011", 15}, {"00010010", 51}, {"00010001", 23}, {"00010000", 43},
    {"00001111", 25}, {"00001110", 37}, {"00001101", 26}, {"00001100", 38},
    {"00001011", 29}, {"00001010", 45}, {"00001001", 53}, {"00001000", 57},
    {"00000111", 30}, {"00000110", 46}, {"00000101", 54}, {"00000100", 58},
    {"000000111", 31}, {"000000110", 47}, {"000000101", 55},
    {"000000100", 59}, {"000000011", 27}, {"000000010", 39},
    {"000000001", 0}};

// motion_code magnitude (Table B-10); a sign bit follows a nonzero one.
const Code kMotion[] = {
    {"1", 0}, {"01", 1}, {"001", 2}, {"0001", 3}, {"000011", 4},
    {"0000101", 5}, {"0000100", 6}, {"0000011", 7}, {"000001011", 8},
    {"000001010", 9}, {"000001001", 10}, {"0000010001", 11},
    {"0000010000", 12}, {"0000001111", 13}, {"0000001110", 14},
    {"0000001101", 15}, {"0000001100", 16}};

// dct_dc_size_luminance / _chrominance (Tables B-12, B-13).
const Code kDcLum[] = {{"100", 0}, {"00", 1}, {"01", 2}, {"101", 3},
                       {"110", 4}, {"1110", 5}, {"11110", 6},
                       {"111110", 7}, {"1111110", 8}, {"11111110", 9},
                       {"111111110", 10}, {"111111111", 11}};
const Code kDcChrom[] = {{"00", 0}, {"01", 1}, {"10", 2}, {"110", 3},
                         {"1110", 4}, {"11110", 5}, {"111110", 6},
                         {"1111110", 7}, {"11111110", 8}, {"111111110", 9},
                         {"1111111110", 10}, {"1111111111", 11}};

// DCT coefficients: run/level pairs (the sign bit follows), EOB and escape.
struct RunLevelCode {
  const char* bits;
  int run, level;
};
constexpr int kEob = -1, kEscape = -2;
// The codes Tables B-14 and B-15 share (the 14- to 16-bit ones) and the
// escape.
const RunLevelCode kSharedCoefs[] = {
    {"00000000011111", 0, 16}, {"00000000011110", 0, 17},
    {"00000000011101", 0, 18}, {"00000000011100", 0, 19},
    {"00000000011011", 0, 20}, {"00000000011010", 0, 21},
    {"00000000011001", 0, 22}, {"00000000011000", 0, 23},
    {"00000000010111", 0, 24}, {"00000000010110", 0, 25},
    {"00000000010101", 0, 26}, {"00000000010100", 0, 27},
    {"00000000010011", 0, 28}, {"00000000010010", 0, 29},
    {"00000000010001", 0, 30}, {"00000000010000", 0, 31},
    {"000000000011000", 0, 32}, {"000000000010111", 0, 33},
    {"000000000010110", 0, 34}, {"000000000010101", 0, 35},
    {"000000000010100", 0, 36}, {"000000000010011", 0, 37},
    {"000000000010010", 0, 38}, {"000000000010001", 0, 39},
    {"000000000010000", 0, 40}, {"000000000011111", 1, 8},
    {"000000000011110", 1, 9}, {"000000000011101", 1, 10},
    {"000000000011100", 1, 11}, {"000000000011011", 1, 12},
    {"000000000011010", 1, 13}, {"000000000011001", 1, 14},
    {"0000000000010011", 1, 15}, {"0000000000010010", 1, 16},
    {"0000000000010001", 1, 17}, {"0000000000010000", 1, 18},
    {"0000000000010100", 6, 3}, {"0000000000011010", 11, 2},
    {"0000000000011001", 12, 2}, {"0000000000011000", 13, 2},
    {"0000000000010111", 14, 2}, {"0000000000010110", 15, 2},
    {"0000000000010101", 16, 2}, {"0000000000011111", 27, 1},
    {"0000000000011110", 28, 1}, {"0000000000011101", 29, 1},
    {"0000000000011100", 30, 1}, {"0000000000011011", 31, 1},
    {"000001", kEscape, 0}};
// Table B-14 (MPEG-1, and MPEG-2 non-intra or intra_vlc_format 0); "11"
// is (0, 1) after a block's first coefficient.
const RunLevelCode kB14[] = {
    {"10", kEob, 0}, {"11", 0, 1}, {"011", 1, 1}, {"0100", 0, 2},
    {"0101", 2, 1}, {"00101", 0, 3}, {"00111", 3, 1}, {"00110", 4, 1},
    {"000110", 1, 2}, {"000111", 5, 1}, {"000101", 6, 1}, {"000100", 7, 1},
    {"0000110", 0, 4}, {"0000100", 2, 2}, {"0000111", 8, 1},
    {"0000101", 9, 1}, {"00100110", 0, 5}, {"00100001", 0, 6},
    {"00100101", 1, 3}, {"00100100", 3, 2}, {"00100111", 10, 1},
    {"00100011", 11, 1}, {"00100010", 12, 1}, {"00100000", 13, 1},
    {"0000001010", 0, 7}, {"0000001100", 1, 4}, {"0000001011", 2, 3},
    {"0000001111", 4, 2}, {"0000001001", 5, 2}, {"0000001110", 14, 1},
    {"0000001101", 15, 1}, {"0000001000", 16, 1},
    {"000000011101", 0, 8}, {"000000011000", 0, 9},
    {"000000010011", 0, 10}, {"000000010000", 0, 11},
    {"000000011011", 1, 5}, {"000000010100", 2, 4},
    {"000000011100", 3, 3}, {"000000010010", 4, 3},
    {"000000011110", 6, 2}, {"000000010101", 7, 2},
    {"000000010001", 8, 2}, {"000000011111", 17, 1},
    {"000000011010", 18, 1}, {"000000011001", 19, 1},
    {"000000010111", 20, 1}, {"000000010110", 21, 1},
    {"0000000011010", 0, 12}, {"0000000011001", 0, 13},
    {"0000000011000", 0, 14}, {"0000000010111", 0, 15},
    {"0000000010110", 1, 6}, {"0000000010101", 1, 7},
    {"0000000010100", 2, 5}, {"0000000010011", 3, 4},
    {"0000000010010", 5, 3}, {"0000000010001", 9, 2},
    {"0000000010000", 10, 2}, {"0000000011111", 22, 1},
    {"0000000011110", 23, 1}, {"0000000011101", 24, 1},
    {"0000000011100", 25, 1}, {"0000000011011", 26, 1}};
// Table B-15 (MPEG-2 intra blocks under intra_vlc_format 1).
const RunLevelCode kB15[] = {
    {"0110", kEob, 0}, {"10", 0, 1}, {"010", 1, 1}, {"110", 0, 2},
    {"00101", 2, 1}, {"0111", 0, 3}, {"00111", 3, 1}, {"000110", 4, 1},
    {"00110", 1, 2}, {"000111", 5, 1}, {"0000110", 6, 1},
    {"0000100", 7, 1}, {"11100", 0, 4}, {"0000111", 2, 2},
    {"0000101", 8, 1}, {"1111000", 9, 1}, {"11101", 0, 5},
    {"000101", 0, 6}, {"1111001", 1, 3}, {"00100110", 3, 2},
    {"1111010", 10, 1}, {"00100001", 11, 1}, {"00100101", 12, 1},
    {"00100100", 13, 1}, {"000100", 0, 7}, {"00100111", 1, 4},
    {"11111100", 2, 3}, {"11111101", 4, 2}, {"000000100", 5, 2},
    {"000000101", 14, 1}, {"000000111", 15, 1}, {"0000001101", 16, 1},
    {"1111011", 0, 8}, {"1111100", 0, 9}, {"00100011", 0, 10},
    {"00100010", 0, 11}, {"00100000", 1, 5}, {"0000001100", 2, 4},
    {"000000011100", 3, 3}, {"000000010010", 4, 3},
    {"000000011110", 6, 2}, {"000000010101", 7, 2},
    {"000000010001", 8, 2}, {"000000011111", 17, 1},
    {"000000011010", 18, 1}, {"000000011001", 19, 1},
    {"000000010111", 20, 1}, {"000000010110", 21, 1},
    {"11111010", 0, 12}, {"11111011", 0, 13}, {"11111110", 0, 14},
    {"11111111", 0, 15}, {"0000000010110", 1, 6},
    {"0000000010101", 1, 7}, {"0000000010100", 2, 5},
    {"0000000010011", 3, 4}, {"0000000010010", 5, 3},
    {"0000000010001", 9, 2}, {"0000000010000", 10, 2},
    {"0000000011111", 22, 1}, {"0000000011110", 23, 1},
    {"0000000011101", 24, 1}, {"0000000011100", 25, 1},
    {"0000000011011", 26, 1}};

// A coefficient table as a Vlc whose symbols index run/level arrays.
struct CoefTable {
  std::vector<int> run, level;
  std::unique_ptr<Vlc> vlc;
  template <size_t N>
  explicit CoefTable(const RunLevelCode (&own)[N]) {
    std::vector<Code> codes;
    for (const RunLevelCode* t : {own, kSharedCoefs}) {
      const size_t n = t == own ? N
                                : sizeof(kSharedCoefs) / sizeof(RunLevelCode);
      for (size_t i = 0; i < n; ++i) {
        codes.push_back({t[i].bits, static_cast<int>(run.size())});
        run.push_back(t[i].run);
        level.push_back(t[i].level);
      }
    }
    vlc = std::make_unique<Vlc>(codes.data(), static_cast<int>(codes.size()));
  }
};

struct Tables {
  Vlc incr{kMbIncr, sizeof(kMbIncr) / sizeof(Code)};
  Vlc ptype{kMbTypeP, sizeof(kMbTypeP) / sizeof(Code)};
  Vlc btype{kMbTypeB, sizeof(kMbTypeB) / sizeof(Code)};
  Vlc cbp{kCbpCodes, sizeof(kCbpCodes) / sizeof(Code)};
  Vlc motion{kMotion, sizeof(kMotion) / sizeof(Code)};
  Vlc dc_lum{kDcLum, sizeof(kDcLum) / sizeof(Code)};
  Vlc dc_chrom{kDcChrom, sizeof(kDcChrom) / sizeof(Code)};
  CoefTable b14{kB14}, b15{kB15};
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---------------------------------------------------------------- constants

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAlternate[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// The default intra matrix (raster order); the non-intra one is flat 16.
const uint8_t kDefaultIntra[64] = {
    8,  16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};
const uint8_t kNonLinearQscale[32] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12, 14, 16, 18,  20,  22,
    24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112};

constexpr int kSeqStart = 0xB3, kSeqEnd = 0xB7, kGopStart = 0xB8,
              kExtStart = 0xB5, kUserStart = 0xB2, kPictureStart = 0x00;
constexpr int kSliceMin = 0x01, kSliceMax = 0xAF;
constexpr int kI = 1, kP = 2, kB = 3;

// ---------------------------------------------------------------- pictures

struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  void init(int width, int height, uint8_t fill) {
    w = width;
    h = height;
    // a row and more past the end: the half-pel ops of a block at the
    // edge read one sample beyond it
    px.assign(size_t(w) * (h + 1) + 64, fill);
  }
  uint8_t* at(int x, int y) { return px.data() + int64_t(y) * w + x; }
  const uint8_t* at(int x, int y) const {
    return px.data() + int64_t(y) * w + x;
  }
};

struct Picture {
  Plane y, u, v;
  int64_t tag = -1;     // the caller's tag of the packet it was decoded from
  bool dummy = false;   // grey stand-in for a missing reference; never shown
  bool interlaced = false;
  int chroma_format = 1;  // 1: 4:2:0, 2: 4:2:2
  void init(int mbw, int mbh, int format, uint8_t fill = 0) {
    chroma_format = format;
    y.init(mbw * 16, mbh * 16, fill);
    u.init(mbw * 8, mbh * 8 * format, fill);
    v.init(mbw * 8, mbh * 8 * format, fill);
  }
};
using PicturePtr = std::shared_ptr<Picture>;

// Which tools the stream has used (mpeg12dec_stats, in this order).
struct Stats {
  int64_t frames = 0, mpeg1 = 0, b_pictures = 0, field_dct_mbs = 0,
          field_mc_mbs = 0, alternate_scan = 0, non_linear_quant = 0,
          intra_vlc = 0, max_dc_precision = 0, loaded_matrices = 0,
          matrix_coefficients = 2, concealed_mbs = 0, skipped_pictures = 0,
          repeat_first_field = 0, top_field_first = 0, interlaced_frames = 0,
          concealment_vectors = 0, full_pel = 0, closed_gops = 0,
          chroma_422_frames = 0;
};

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0)
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

class Decoder {
 public:
  int width = 0, height = 0;  // of the frame last given
  PicturePtr out;
  int64_t out_tag = -1;
  Stats stats;
  bool out_left = false;      // chroma siting of the frame last given
  int out_matrix = 2;

  // (w, h): the size the container reports, which FFmpeg's decoder starts
  // from (OpenCV opens it with the stream's parameters): a picture before
  // the first sequence header is then parsed, not failed.
  Decoder(int w, int h) : seq_w_(w), seq_h_(h) {
    for (int i = 0; i < 64; ++i) {
      intra_[i] = chroma_intra_[i] = kDefaultIntra[i];
      inter_[i] = chroma_inter_[i] = 16;
    }
  }

  // FFmpeg's mpeg_decode_frame on one packet (its parser's unit: the
  // headers before a picture, the picture, its slices).
  Status decode(const uint8_t* data, int64_t n, int64_t tag,
                bool headers_only = false) {
    out.reset();
    if (n == 0 || (n == 4 && data[0] == 0 && data[1] == 0 && data[2] == 1 &&
                   data[3] == kSeqEnd))
      return flush();
    buf_.assign(data, data + n);
    buf_.resize(size_t(n) + 32, 0);
    tag_ = tag;
    Status st = kNoFrame;
    try {
      st = chunks(buf_.data(), n, headers_only);
    } catch (const Error& e) {
      if (e.status == kUnsupported) throw;
      cur_.reset();
      return kCorrupt;
    } catch (const std::bad_alloc&) {
      cur_.reset();
      return kCorrupt;
    }
    if (st == kCorrupt || st == kFrame) cur_.reset();
    return st;
  }

  Status flush() {
    out.reset();
    if (!low_delay_ && next_) {
      give(next_);
      next_.reset();
      return kFrame;
    }
    return kNoFrame;
  }

 private:
  std::vector<uint8_t> buf_;
  int64_t tag_ = -1;

  // sequence
  int seq_w_ = 0, seq_h_ = 0;
  bool mpeg2_ = false, progressive_seq_ = true, low_delay_ = false;
  int matrix_ = 2;
  int chroma_format_ = 1, mb_blocks_ = 6;  // 4:2:0 or 4:2:2, 6 or 8 blocks
  uint16_t intra_[64], inter_[64], chroma_intra_[64], chroma_inter_[64];
  bool inited_ = false;
  int mbw_ = 0, mbh_ = 0, init_w_ = 0, init_h_ = 0;
  bool init_prog_ = true;
  int init_chroma_ = 1;

  // GOP and references
  bool closed_gop_ = false, sync_ = false;
  PicturePtr last_, next_, cur_;

  // picture
  int pict_type_ = 0;
  int f_code_[2][2] = {{1, 1}, {1, 1}};
  bool full_pel_[2] = {false, false};
  int dc_precision_ = 0, picture_structure_ = 3;
  bool top_field_first_ = false, frame_pred_frame_dct_ = true,
       concealment_mv_ = false, q_scale_type_ = false, intra_vlc_ = false,
       alternate_scan_ = false, repeat_first_field_ = false,
       progressive_frame_ = true;
  const uint8_t* scan_ = kZigzag;
  bool first_slice_ = false;
  // error resilience, per macroblock: damaged (kErr) and resync point
  // (kStart), as FFmpeg's error_status_table
  static constexpr uint8_t kErr = 1, kStart = 2;
  std::vector<uint8_t> er_;
  bool intact(size_t k) const { return !(er_[k] & kErr); }
  std::vector<uint8_t> mb_intra_;  // per macroblock: intra (B skips check)

  // macroblock
  int qscale_ = 2;
  int last_dc_[3] = {128, 128, 128};
  int last_mv_[2][2][2] = {};
  int mv_[2][2][2] = {};
  int field_select_[2][2] = {};
  int mv_dir_ = 0;      // kFwd | kBwd
  bool dual_prime_ = false;  // a dual-prime macroblock in this slice
  bool mv_field_ = false;
  bool interlaced_dct_ = false;
  alignas(16) int16_t block_[8][64];
  int last_index_[8];

  void give(const PicturePtr& p) {
    out = p;
    out_tag = p->tag;
    width = seq_w_;
    height = seq_h_;
    out_left = mpeg2_;
    out_matrix = matrix_;
    ++stats.frames;
  }

  // ------------------------------------------------------------- chunks

  static const uint8_t* find_start(const uint8_t* p, const uint8_t* end,
                                   int* code) {
    while (p + 3 < end) {
      if (p[2] > 1) {
        p += 3;
      } else if (p[0] == 0 && p[1] == 0 && p[2] == 1) {
        *code = p[3];
        return p + 4;
      } else {
        ++p;
      }
    }
    *code = -1;
    return end;
  }

  Status chunks(const uint8_t* buf, int64_t n, bool headers_only) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    int last_code = -1;  // none yet
    bool skip_frame = false, picture_seen = false;
    Status got = kNoFrame;
    for (;;) {
      int code;
      p = find_start(p, end, &code);
      if (code < 0) {
        if (!skip_frame && !headers_only && slice_end()) got = kFrame;
        pict_type_ = 0;
        return got;
      }
      const int64_t size = end - p;
      Bits b(p, size);
      // a header that does not parse is passed over, as FFmpeg passes over
      // the errors of its header readers
      auto header = [&](auto read) {
        try {
          read();
        } catch (const Error& e) {
          if (e.status == kUnsupported) throw;
        }
      };
      if (code == kSeqStart) {
        if (last_code == -1) {
          header([&] { sequence_header(b); });
          if (!headers_only) sync_ = true;
        }
      } else if (code == kPictureStart) {
        if (picture_seen && picture_structure_ == 3) continue;
        picture_seen = true;
        // FFmpeg's av_image_check_size
        if (seq_w_ <= 0 || seq_h_ <= 0 ||
            (int64_t(seq_w_) + 128) * (seq_h_ + 128) >= INT32_MAX / 8)
          return kCorrupt;
        if (last_code == -1 || last_code == kSliceMin) {
          postinit();
          header([&] {
            if (!picture_header(b)) pict_type_ = 0;
          });
          first_slice_ = true;
          last_code = kPictureStart;
        }
      } else if (code == kExtStart) {
        header([&] {
          const int id = static_cast<int>(b.get(4));
          if (id == 1) {
            if (last_code == -1) sequence_extension(b);
          } else if (id == 2) {
            display_extension(b);
          } else if (id == 3) {
            quant_matrix_extension(b);
          } else if (id == 8) {
            if (last_code == kPictureStart) picture_coding_extension(b);
          } else if (id == 5) {
            unsupported("the sequence scalable extension");
          } else if (id == 9 || id == 10) {
            unsupported(id == 9 ? "the picture spatial scalable extension"
                                : "the picture temporal scalable extension");
          }
        });
      } else if (code == kGopStart) {
        if (last_code == -1) {
          header([&] {
            b.skip(25);
            closed_gop_ = b.get1();
            stats.closed_gops += closed_gop_;
          });
          sync_ = true;
        }
      } else if (code >= kSliceMin && code <= kSliceMax &&
                 last_code != -1) {
        if (last_code == kPictureStart && progressive_seq_ &&
            !progressive_frame_)
          progressive_frame_ = true;
        int mb_y = code - kSliceMin;
        last_code = kSliceMin;
        if (mpeg2_ && mbh_ > 2800 / 16) mb_y += (p[0] & 0xE0) << 2;
        if (size < 2) return kCorrupt;
        if (mb_y >= mbh_) return kCorrupt;
        if (!last_ && pict_type_ == kB && !closed_gop_) {
          stats.skipped_pictures += !skip_frame;
          skip_frame = true;
          continue;
        }
        if (pict_type_ == kI) sync_ = true;
        if (!next_ && pict_type_ == kP && !sync_) {
          stats.skipped_pictures += !skip_frame;
          skip_frame = true;
          continue;
        }
        if (!pict_type_) continue;  // missing picture start code
        if (first_slice_) {
          skip_frame = false;
          first_slice_ = false;
          if (!field_start(n)) return kCorrupt;
        }
        if (!cur_) return kCorrupt;
        const uint8_t* q = p;
        if (slice(mb_y, &q, size)) p = q;
      }
      // everything else (user data, sequence end, unknown codes): ignored
    }
  }

  // FFmpeg's slice_end: the picture is complete; the frame to show now.
  bool slice_end() {
    if (!inited_ || !cur_ || first_slice_) return false;
    conceal();
    if (pict_type_ == kB || low_delay_) {
      give(cur_);
      return true;
    }
    if (last_ && !last_->dummy) {
      give(last_);
      return true;
    }
    return false;
  }

  // ------------------------------------------------------------- headers

  void load_matrix(Bits& b, uint16_t* m0, uint16_t* m1, bool intra) {
    for (int i = 0; i < 64; ++i) {
      int v = static_cast<int>(b.get(8));
      if (v == 0) corrupt("quantiser matrix damaged");
      if (intra && i == 0) v = 8;
      m0[kZigzag[i]] = static_cast<uint16_t>(v);
      if (m1) m1[kZigzag[i]] = static_cast<uint16_t>(v);
    }
    ++stats.loaded_matrices;
  }

  void sequence_header(Bits& b) {
    const int w = static_cast<int>(b.get(12)), h = static_cast<int>(b.get(12));
    b.skip(4);  // aspect_ratio_information
    const int rate = static_cast<int>(b.get(4));
    if (w == 0 || h == 0) return;
    if (rate == 0 || rate > 13) return;  // FFmpeg drops the header
    b.skip(18);
    if (!b.get1()) return;               // marker
    b.skip(10 + 1);                      // vbv_buffer_size, constrained
    if (b.get1()) {
      load_matrix(b, chroma_intra_, intra_, true);
    } else {
      for (int i = 0; i < 64; ++i) intra_[i] = chroma_intra_[i] = kDefaultIntra[i];
    }
    if (b.get1()) {
      load_matrix(b, chroma_inter_, inter_, false);
    } else {
      for (int i = 0; i < 64; ++i) inter_[i] = chroma_inter_[i] = 16;
    }
    seq_w_ = w;
    seq_h_ = h;
    progressive_seq_ = true;
    progressive_frame_ = true;
    picture_structure_ = 3;
    frame_pred_frame_dct_ = true;
    mpeg2_ = false;
    chroma_format_ = 1;
  }

  void sequence_extension(Bits& b) {
    b.skip(1 + 3 + 4);  // escape, profile, level
    progressive_seq_ = b.get1();
    const int chroma = static_cast<int>(b.get(2));
    if (chroma == 3) unsupported("4:4:4 chroma (chroma_format 3)");
    chroma_format_ = chroma == 2 ? 2 : 1;  // FFmpeg takes 0 for 4:2:0
    seq_w_ |= static_cast<int>(b.get(2)) << 12;
    seq_h_ |= static_cast<int>(b.get(2)) << 12;
    b.skip(12 + 1 + 8);  // bit_rate_extension, marker, vbv extension
    low_delay_ = b.get1();
    mpeg2_ = true;
  }

  void display_extension(Bits& b) {
    b.skip(3);  // video_format
    if (b.get1()) {
      b.skip(16);  // colour_primaries, transfer_characteristics
      const int m = static_cast<int>(b.get(8));
      if (m != 1 && m != 2 && m != 5 && m != 6) {
        static const char* names[] = {
            "0 (forbidden)", "BT.709", "unknown", "3 (reserved)", "FCC",
            "BT.470BG", "SMPTE 170M", "SMPTE 240M", "YCgCo", "BT.2020 NCL",
            "BT.2020 CL"};
        unsupported(std::string("the colour matrix ") +
                    (m < 11 ? names[m] : std::to_string(m).c_str()) +
                    " (matrix_coefficients " + std::to_string(m) + ")");
      }
      matrix_ = m;
      stats.matrix_coefficients = m;
    }
  }

  void quant_matrix_extension(Bits& b) {
    if (b.get1()) load_matrix(b, chroma_intra_, intra_, true);
    if (b.get1()) load_matrix(b, chroma_inter_, inter_, false);
    if (b.get1()) load_matrix(b, chroma_intra_, nullptr, true);
    if (b.get1()) load_matrix(b, chroma_inter_, nullptr, false);
  }

  bool picture_header(Bits& b) {
    b.skip(10);  // temporal_reference
    pict_type_ = static_cast<int>(b.get(3));
    if (pict_type_ == 4) unsupported("MPEG-1 D-pictures");
    if (pict_type_ == 0 || pict_type_ > 3) return false;
    b.skip(16);  // vbv_delay
    if (pict_type_ == kP || pict_type_ == kB) {
      full_pel_[0] = b.get1();
      int f = static_cast<int>(b.get(3));
      f += !f;
      f_code_[0][0] = f_code_[0][1] = f;
      stats.full_pel += full_pel_[0];
    }
    if (pict_type_ == kB) {
      full_pel_[1] = b.get1();
      int f = static_cast<int>(b.get(3));
      f += !f;
      f_code_[1][0] = f_code_[1][1] = f;
      stats.full_pel += full_pel_[1];
    }
    return true;
  }

  void picture_coding_extension(Bits& b) {
    full_pel_[0] = full_pel_[1] = false;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        f_code_[i][j] = static_cast<int>(b.get(4));
        f_code_[i][j] += !f_code_[i][j];
      }
    dc_precision_ = static_cast<int>(b.get(2));
    picture_structure_ = static_cast<int>(b.get(2));
    top_field_first_ = b.get1();
    frame_pred_frame_dct_ = b.get1();
    concealment_mv_ = b.get1();
    q_scale_type_ = b.get1();
    intra_vlc_ = b.get1();
    alternate_scan_ = b.get1();
    repeat_first_field_ = b.get1();
    b.skip(1);  // chroma_420_type
    progressive_frame_ = b.get1();
    scan_ = alternate_scan_ ? kAlternate : kZigzag;
    if (picture_structure_ == 1 || picture_structure_ == 2)
      unsupported("field pictures (picture_structure " +
                  std::to_string(picture_structure_) + ")");
  }

  // FFmpeg's mpeg_decode_postinit: the macroblock grid; a new size or
  // scan drops the references.
  void postinit() {
    if (inited_ && init_w_ == seq_w_ && init_h_ == seq_h_ &&
        init_prog_ == progressive_seq_ && init_chroma_ == chroma_format_)
      return;
    if (chroma_format_ == 2 && (seq_h_ & 1))
      unsupported("4:2:2 chroma at an odd height (its conversion to RGB "
                  "by swscale is not reproduced)");
    inited_ = true;
    init_w_ = seq_w_;
    init_h_ = seq_h_;
    init_prog_ = progressive_seq_;
    init_chroma_ = chroma_format_;
    mb_blocks_ = 4 + 2 * chroma_format_;
    mbw_ = (seq_w_ + 15) / 16;
    mbh_ = mpeg2_ && !progressive_seq_ ? 2 * ((seq_h_ + 31) / 32)
                                       : (seq_h_ + 15) / 16;
    last_.reset();
    next_.reset();
    cur_.reset();
  }

  // FFmpeg's mpeg_field_start / ff_mpv_frame_start: a new current picture,
  // the references moved along, grey for a missing older one.
  bool field_start(int64_t packet_size) {
    if (int64_t(mbw_) * mbh_ * 11 / (33 * 2 * 8) > packet_size) return false;
    if (picture_structure_ != 3)
      unsupported("field pictures (picture_structure " +
                  std::to_string(picture_structure_) + ")");
    cur_ = std::make_shared<Picture>();
    cur_->init(mbw_, mbh_, init_chroma_);
    cur_->tag = tag_;
    cur_->interlaced = !progressive_frame_ && !progressive_seq_;
    if (pict_type_ != kB) {
      last_ = next_;
      next_ = cur_;
    }
    if (!last_ && pict_type_ != kI) {
      last_ = std::make_shared<Picture>();
      last_->init(mbw_, mbh_, init_chroma_, 0x80);
      last_->dummy = true;
    }
    if (!next_ && pict_type_ == kB) {
      next_ = std::make_shared<Picture>();
      next_->init(mbw_, mbh_, init_chroma_, 0x80);
      next_->dummy = true;
    }
    er_.assign(size_t(mbw_) * mbh_, kErr | kStart);
    mb_intra_.assign(size_t(mbw_) * mbh_, 0);
    stats.mpeg1 += !mpeg2_;
    stats.b_pictures += pict_type_ == kB;
    stats.alternate_scan += alternate_scan_;
    stats.non_linear_quant += q_scale_type_;
    stats.intra_vlc += intra_vlc_;
    stats.max_dc_precision = std::max<int64_t>(stats.max_dc_precision,
                                               dc_precision_);
    stats.repeat_first_field += repeat_first_field_;
    stats.top_field_first += top_field_first_;
    stats.interlaced_frames += cur_->interlaced;
    stats.chroma_422_frames += init_chroma_ == 2;
    return true;
  }

  // Damaged or missing macroblocks, as FFmpeg's error resilience
  // (error_resilience.c) conceals them in an MPEG-2 picture: a B picture
  // by the mean of its references at a zero vector; a P picture by the
  // forward reference at a zero vector; an I picture, when its intact
  // macroblocks look more like themselves than like the forward
  // reference (is_intra_more_likely), by DC values guessed from the
  // nearest intact blocks, filtered and deblocked, else by the forward
  // reference.  FFmpeg's vector guess for P pictures with many intact
  // vectors, and its deblocking next to inter macroblocks, are not
  // reproduced.
  void conceal() {
    const size_t n = size_t(mbw_) * mbh_;
    bool any = false;
    for (size_t k = 0; k < n; ++k) any |= er_[k] & kErr;
    if (!any) return;
    // an error spreads forward to the next resync point
    uint8_t err = 0;
    for (size_t k = 0; k < n; ++k) {
      if (er_[k] & kStart) err = er_[k] & kErr;
      else er_[k] |= err, err |= er_[k] & kErr;
    }
    for (size_t k = 0; k < n; ++k) stats.concealed_mbs += !intact(k);
    const bool b_pic = pict_type_ == kB && last_ && next_;
    if (pict_type_ == kI && intra_more_likely()) {
      conceal_dc();
      return;
    }
    const Picture* ref = last_ && last_ != cur_ ? last_.get() : nullptr;
    for (int my = 0; my < mbh_; ++my)
      for (int mx = 0; mx < mbw_; ++mx) {
        if (intact(size_t(my) * mbw_ + mx)) continue;
        if (ref) {
          mv_dir_ = b_pic ? kFwd | kBwd : kFwd;
          mv_field_ = false;
          std::memset(mv_, 0, sizeof(mv_));
          std::memset(last_index_, -1, sizeof(last_index_));
          reconstruct_inter(mx, my);
          continue;
        }
        for (int j = 0; j < 16; ++j)
          std::memset(cur_->y.at(mx * 16, my * 16 + j), 0x80, 16);
        const int ch = 8 * init_chroma_;
        for (int j = 0; j < ch; ++j) {
          std::memset(cur_->u.at(mx * 8, my * ch + j), 0x80, 8);
          std::memset(cur_->v.at(mx * 8, my * ch + j), 0x80, 8);
        }
      }
  }

  // FFmpeg's is_intra_more_likely for an I picture: with no forward
  // reference, or the sampled intact macroblocks' SAD against it above
  // their reference's SAD against itself 16 rows down.
  bool intra_more_likely() const {
    if (!last_ || last_ == cur_) return true;
    int undamaged = 0;
    for (size_t k = 0; k < er_.size(); ++k) undamaged += intact(k);
    if (undamaged < 5) return false;
    const int skip = std::max(undamaged / 50, 1);
    int64_t likely = 0;
    int j = 0;
    const int ls = cur_->y.w;
    auto sad = [ls](const uint8_t* a, const uint8_t* b) {
      int s = 0;
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) s += std::abs(a[y * ls + x] - b[y * ls + x]);
      return s;
    };
    for (int my = 0; my < mbh_ - 1; ++my)
      for (int mx = 0; mx < mbw_; ++mx) {
        if (!intact(size_t(my) * mbw_ + mx)) continue;
        if (++j % skip) continue;
        const uint8_t* last = last_->y.at(mx * 16, my * 16);
        likely += sad(last, cur_->y.at(mx * 16, my * 16));
        likely -= sad(last, last + 16 * ls);
      }
    return likely > 0;
  }

  // guess_dc over one plane's 8x8 blocks (w x h of them, luma: 2x2 per
  // macroblock): each damaged block's DC from the nearest intact one in
  // each direction, weighted by the inverse of its distance.
  void guess_dc(std::vector<int>& dc, int w, int h, bool luma) const {
    auto ok = [&](int bx, int by) {
      const int s = luma ? 1 : 0;
      return intact(size_t(by >> s) * mbw_ + (bx >> s));
    };
    std::vector<int> col(size_t(w) * h * 4), dist(size_t(w) * h * 4);
    for (int by = 0; by < h; ++by) {
      int color = 1024, at = -1;
      for (int bx = 0; bx < w; ++bx) {
        if (ok(bx, by)) {
          color = dc[size_t(by) * w + bx];
          at = bx;
        }
        col[(size_t(by) * w + bx) * 4 + 1] = color;
        dist[(size_t(by) * w + bx) * 4 + 1] = at >= 0 ? bx - at : 9999;
      }
      color = 1024;
      at = -1;
      for (int bx = w - 1; bx >= 0; --bx) {
        if (ok(bx, by)) {
          color = dc[size_t(by) * w + bx];
          at = bx;
        }
        col[(size_t(by) * w + bx) * 4] = color;
        dist[(size_t(by) * w + bx) * 4] = at >= 0 ? at - bx : 9999;
      }
    }
    for (int bx = 0; bx < w; ++bx) {
      int color = 1024, at = -1;
      for (int by = 0; by < h; ++by) {
        if (ok(bx, by)) {
          color = dc[size_t(by) * w + bx];
          at = by;
        }
        col[(size_t(by) * w + bx) * 4 + 3] = color;
        dist[(size_t(by) * w + bx) * 4 + 3] = at >= 0 ? by - at : 9999;
      }
      color = 1024;
      at = -1;
      for (int by = h - 1; by >= 0; --by) {
        if (ok(bx, by)) {
          color = dc[size_t(by) * w + bx];
          at = by;
        }
        col[(size_t(by) * w + bx) * 4 + 2] = color;
        dist[(size_t(by) * w + bx) * 4 + 2] = at >= 0 ? at - by : 9999;
      }
    }
    for (int by = 0; by < h; ++by)
      for (int bx = 0; bx < w; ++bx) {
        if (ok(bx, by)) continue;
        int64_t guess = 0, sum = 0;
        for (int j = 0; j < 4; ++j) {
          const size_t i = (size_t(by) * w + bx) * 4 + j;
          const int64_t weight =
              int64_t(256) * 256 * 256 * 16 / std::max(dist[i], 1);
          guess += weight * col[i];
          sum += weight;
        }
        dc[size_t(by) * w + bx] = static_cast<int>((guess + sum / 2) / sum);
      }
  }

  // FFmpeg's filter181 over the luma DCs, horizontally then vertically.
  static void filter181(std::vector<int>& d, int w, int h) {
    auto f = [](int prev, int c, int next) {
      const int64_t v = std::clamp<int64_t>(-prev + c * 8 - next,
                                            INT32_MIN / 10923,
                                            INT32_MAX / 10923 - 32768);
      return static_cast<int>((v * 10923 + 32768) >> 16);
    };
    for (int y = 1; y < h - 1; ++y) {
      int prev = d[size_t(y) * w];
      for (int x = 1; x < w - 1; ++x) {
        const int c = d[size_t(y) * w + x];
        d[size_t(y) * w + x] = f(prev, c, d[size_t(y) * w + x + 1]);
        prev = c;
      }
    }
    for (int x = 1; x < w - 1; ++x) {
      int prev = d[x];
      for (int y = 1; y < h - 1; ++y) {
        const int c = d[size_t(y) * w + x];
        d[size_t(y) * w + x] = f(prev, c, d[size_t(y + 1) * w + x]);
        prev = c;
      }
    }
  }

  // The DC of every 8x8 block ((sum + 4) >> 3), the damaged ones guessed,
  // luma filtered; damaged macroblocks painted flat; block edges next to
  // them deblocked (h_block_filter, v_block_filter).
  void conceal_dc() {
    Picture& c = *cur_;
    const int bw = mbw_ * 2, bh = mbh_ * 2;
    std::vector<int> dy(size_t(bw) * bh), du(size_t(mbw_) * mbh_),
        dv(size_t(mbw_) * mbh_);
    auto block_dc = [](const Plane& p, int x0, int y0) {
      int s = 0;
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) s += p.at(x0, y0 + y)[x];
      return (s + 4) >> 3;
    };
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx)
        dy[size_t(by) * bw + bx] = block_dc(c.y, bx * 8, by * 8);
    for (int my = 0; my < mbh_; ++my)
      for (int mx = 0; mx < mbw_; ++mx) {
        du[size_t(my) * mbw_ + mx] = block_dc(c.u, mx * 8, my * 8);
        dv[size_t(my) * mbw_ + mx] = block_dc(c.v, mx * 8, my * 8);
      }
    guess_dc(dy, bw, bh, true);
    guess_dc(du, mbw_, mbh_, false);
    guess_dc(dv, mbw_, mbh_, false);
    filter181(dy, bw, bh);
    auto flat = [](Plane& p, int x0, int y0, int v) {
      v = std::clamp(v, 0, 2040) / 8;
      for (int y = 0; y < 8; ++y)
        std::memset(p.at(x0, y0 + y), v, 8);
    };
    for (int my = 0; my < mbh_; ++my)
      for (int mx = 0; mx < mbw_; ++mx) {
        if (intact(size_t(my) * mbw_ + mx)) continue;
        for (int i = 0; i < 4; ++i)
          flat(c.y, mx * 16 + (i & 1) * 8, my * 16 + (i >> 1) * 8,
               dy[size_t(my * 2 + (i >> 1)) * bw + mx * 2 + (i & 1)]);
        flat(c.u, mx * 8, my * 8, du[size_t(my) * mbw_ + mx]);
        flat(c.v, mx * 8, my * 8, dv[size_t(my) * mbw_ + mx]);
      }
    deblock(c.y, bw, bh, true);
    deblock(c.u, mbw_, mbh_, false);
    deblock(c.v, mbw_, mbh_, false);
  }

  // h_block_filter then v_block_filter over a plane of w x h blocks: at
  // each edge with a damaged (intra-concealed) side, the step across it
  // beyond the mean of its neighbours' is spread over four pixels of
  // each damaged side.
  void deblock(Plane& p, int w, int h, bool luma) const {
    auto bad = [&](int bx, int by) {
      const int s = luma ? 1 : 0;
      return !intact(size_t(by >> s) * mbw_ + (bx >> s));
    };
    auto filter = [](uint8_t* px, int step, bool first, bool second) {
      const int a = px[7 * step] - px[6 * step];
      const int b = px[8 * step] - px[7 * step];
      const int c = px[9 * step] - px[8 * step];
      int d = std::max(std::abs(b) - ((std::abs(a) + std::abs(c) + 1) >> 1),
                       0);
      if (b < 0) d = -d;
      if (d == 0) return;
      if (!(first && second)) d = d * 16 / 9;
      if (first) {
        px[7 * step] = clip8(px[7 * step] + ((d * 7) >> 4));
        px[6 * step] = clip8(px[6 * step] + ((d * 5) >> 4));
        px[5 * step] = clip8(px[5 * step] + ((d * 3) >> 4));
        px[4 * step] = clip8(px[4 * step] + ((d * 1) >> 4));
      }
      if (second) {
        px[8 * step] = clip8(px[8 * step] - ((d * 7) >> 4));
        px[9 * step] = clip8(px[9 * step] - ((d * 5) >> 4));
        px[10 * step] = clip8(px[10 * step] - ((d * 3) >> 4));
        px[11 * step] = clip8(px[11 * step] - ((d * 1) >> 4));
      }
    };
    for (int by = 0; by < h; ++by)
      for (int bx = 0; bx < w - 1; ++bx) {
        const bool l = bad(bx, by), r = bad(bx + 1, by);
        if (!(l || r)) continue;
        for (int y = 0; y < 8; ++y) filter(p.at(bx * 8, by * 8 + y), 1, l, r);
      }
    for (int by = 0; by < h - 1; ++by)
      for (int bx = 0; bx < w; ++bx) {
        const bool t = bad(bx, by), d = bad(bx, by + 1);
        if (!(t || d)) continue;
        for (int x = 0; x < 8; ++x)
          filter(p.at(bx * 8 + x, by * 8), p.w, t, d);
      }
  }

  // ------------------------------------------------------------- slices

  int get_qscale(Bits& b) {
    const int q = static_cast<int>(b.get(5));
    return q_scale_type_ ? kNonLinearQscale[q] : q << 1;
  }

  // FFmpeg's mpeg_decode_slice over the rest of the packet from *p; true
  // when it ends cleanly (*p then moved past it), false on damage.  Its
  // macroblocks' error status is set as ff_er_add_slice sets it: from the
  // resync point on intact, and on damage the macroblock where it showed.
  bool slice(int mb_y, const uint8_t** p, int64_t size) {
    Bits b(*p, size);
    const int n = mbw_ * mbh_;
    int mb_x = 0, resync = -1;
    auto fail = [&](int at) {  // damage showed at macroblock `at`
      if (resync >= 0) {
        for (int i = resync; i <= std::min(at, n - 1); ++i) er_[i] = kErr;
        er_[resync] |= kStart;
      }
      return false;
    };
    try {
      if (mpeg2_ && mbh_ > 2800 / 16) b.skip(3);
      last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << dc_precision_;
      std::memset(last_mv_, 0, sizeof(last_mv_));
      interlaced_dct_ = false;
      dual_prime_ = false;
      qscale_ = get_qscale(b);
      if (qscale_ == 0) return false;
      while (b.get1()) b.skip(8);  // extra slice information
      for (;;) {
        if (b.left() <= 0) break;
        const int code = tables().incr.read(b);
        if (code < 0) return false;
        if (code == kIncrEscape) {
          mb_x += 33;
        } else if (code < kIncrEscape) {
          mb_x += code;
          break;
        }
      }
      if (mb_x >= mbw_) return false;
      resync = mb_y * mbw_ + mb_x;
      int skip_run = 0;
      for (;;) {
        if (!macroblock(b, mb_x, mb_y, skip_run))
          return fail(mb_y * mbw_ + mb_x);
        if (++mb_x >= mbw_) {
          mb_x = 0;
          ++mb_y;
          if (mb_y >= mbh_) {
            const int64_t left = b.left();
            if (left < 0 ||
                (left && b.peek(static_cast<int>(std::min<int64_t>(left, 23)))))
              return fail(n);
            goto eos;
          }
          const int64_t left = b.left();
          if (mb_y >= ((seq_h_ + 15) >> 4) && !progressive_seq_ &&
              left <= 25 && left >= 0 && skip_run == -1 &&
              (!left || b.peek(static_cast<int>(left)) == 0))
            break;
        }
        if (skip_run == -1) {  // read the next increment
          skip_run = 0;
          for (;;) {
            const int code = tables().incr.read(b);
            if (code < 0) return fail(mb_y * mbw_ + mb_x);
            if (code == kIncrEscape) {
              skip_run += 33;
            } else if (code == kIncrEnd) {
              if (skip_run != 0 || b.peek(15) != 0)
                return fail(mb_y * mbw_ + mb_x);
              goto eos;
            } else if (code < kIncrEscape) {
              skip_run += code;
              break;
            }
          }
          if (skip_run) {
            if (pict_type_ == kI) return fail(mb_y * mbw_ + mb_x);
            std::memset(last_index_, -1, sizeof(last_index_));
            last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << dc_precision_;
            mv_field_ = false;
            if (pict_type_ == kP) {
              mv_dir_ = kFwd;
              mv_[0][0][0] = mv_[0][0][1] = 0;
              std::memset(last_mv_[0], 0, sizeof(last_mv_[0]));
              field_select_[0][0] = 0;
            } else {
              for (int d = 0; d < 2; ++d) {
                mv_[d][0][0] = last_mv_[d][0][0];
                mv_[d][0][1] = last_mv_[d][0][1];
                field_select_[d][0] = 0;
              }
            }
          }
        }
      }
    eos:
      if (b.left() < 0) return fail(mb_y * mbw_ + mb_x);
      if (dual_prime_) unsupported("dual-prime prediction (motion_type 3)");
      for (int i = resync; i < std::min(mb_y * mbw_ + mb_x, n); ++i) er_[i] = 0;
      er_[resync] |= kStart;
      *p += (b.pos() - 1) / 8;
      return true;
    } catch (const Error& e) {
      if (e.status == kUnsupported) throw;
      return fail(std::min(mb_y * mbw_ + mb_x, n));
    }
  }

  int decode_motion(Bits& b, int fcode, int pred) {
    const int code = tables().motion.read(b);
    if (code < 0) corrupt("motion_code");
    if (code == 0) return pred;
    const int sign = b.get1();
    const int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= static_cast<int>(b.get(shift));
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + shift;
    return static_cast<int32_t>(static_cast<uint32_t>(val) << (32 - bits)) >>
           (32 - bits);
  }

  // One macroblock at (mb_x, mb_y): skipped while skip_run counts down (-1
  // after a coded one); false on damage.
  bool macroblock(Bits& b, int mb_x, int mb_y, int& skip_run) {
    const size_t mb = size_t(mb_y) * mbw_ + mb_x;
    if (skip_run-- != 0) {
      if (pict_type_ == kB) {
        const size_t prev = mb_x ? mb - 1 : size_t(mb_y) * mbw_ - 1;
        if (mb_y == 0 && mb_x == 0) return false;
        if (mb_intra_[prev]) return false;  // skip with previous intra
      }
      reconstruct_inter(mb_x, mb_y);
      return true;
    }
    int type;
    if (pict_type_ == kI) {
      if (b.get1()) {
        type = kIntra;
      } else {
        if (!b.get1()) return false;
        type = kIntra | kQuant;
      }
    } else {
      type = (pict_type_ == kP ? tables().ptype : tables().btype).read(b);
      if (type < 0) return false;
    }
    if (type & kIntra) {
      if (!frame_pred_frame_dct_) interlaced_dct_ = b.get1();
      if (type & kQuant) qscale_ = get_qscale(b);
      if (concealment_mv_) {
        ++stats.concealment_vectors;
        mv_[0][0][0] = last_mv_[0][0][0] = last_mv_[0][1][0] =
            decode_motion(b, f_code_[0][0], last_mv_[0][0][0]);
        mv_[0][0][1] = last_mv_[0][0][1] = last_mv_[0][1][1] =
            decode_motion(b, f_code_[0][1], last_mv_[0][0][1]);
        b.skip(1);  // marker
      } else {
        std::memset(last_mv_, 0, sizeof(last_mv_));
      }
      mb_intra_[mb] = 1;
      for (int i = 0; i < mb_blocks_; ++i) {
        std::memset(block_[i], 0, sizeof(block_[i]));
        if (!(mpeg2_ ? intra_block_mpeg2(b, block_[i], i)
                     : intra_block_mpeg1(b, block_[i], i)))
          return false;
      }
      stats.field_dct_mbs += interlaced_dct_;
      put_blocks(mb_x, mb_y, false);
      return true;
    }
    mb_intra_[mb] = 0;
    if (!(type & (kFwd | kBwd))) {  // P, no motion compensation, coded
      mv_dir_ = kFwd;
      if (!frame_pred_frame_dct_) interlaced_dct_ = b.get1();
      mv_field_ = false;
      if (type & kQuant) qscale_ = get_qscale(b);
      std::memset(last_mv_[0], 0, sizeof(last_mv_[0]));
      mv_[0][0][0] = mv_[0][0][1] = 0;
    } else {
      int motion_type = 2;  // frame
      if (!frame_pred_frame_dct_) {
        motion_type = static_cast<int>(b.get(2));
        if (type & kCbp) interlaced_dct_ = b.get1();
      }
      if (type & kQuant) qscale_ = get_qscale(b);
      mv_dir_ = type & (kFwd | kBwd);
      if (motion_type == 2) {
        mv_field_ = false;
        for (int i = 0; i < 2; ++i) {
          if (!(mv_dir_ & (i ? kBwd : kFwd))) continue;
          for (int c = 0; c < 2; ++c) {
            mv_[i][0][c] = last_mv_[i][0][c] = last_mv_[i][1][c] =
                decode_motion(b, f_code_[i][c], last_mv_[i][0][c]);
            if (full_pel_[i]) mv_[i][0][c] *= 2;
          }
        }
      } else if (motion_type == 1) {
        mv_field_ = true;
        ++stats.field_mc_mbs;
        for (int i = 0; i < 2; ++i) {
          if (!(mv_dir_ & (i ? kBwd : kFwd))) continue;
          for (int j = 0; j < 2; ++j) {
            field_select_[i][j] = b.get1();
            int val = decode_motion(b, f_code_[i][0], last_mv_[i][j][0]);
            last_mv_[i][j][0] = val;
            mv_[i][j][0] = val;
            val = decode_motion(b, f_code_[i][1], last_mv_[i][j][1] >> 1);
            last_mv_[i][j][1] = 2 * val;
            mv_[i][j][1] = val;
          }
        }
      } else if (motion_type == 3) {
        // dual-prime: legal in P pictures of an interlaced sequence only,
        // and FFmpeg fails it in a progressive one.  Its vectors are read
        // (FFmpeg's order) so that the slice can be followed to its end:
        // a slice that then ends cleanly is refused, one that breaks later
        // was damage and is concealed.
        if (pict_type_ != kP || progressive_seq_) return false;
        auto dmv = [&b]() { return b.get1() ? 1 - 2 * b.get1() : 0; };
        const int mx = decode_motion(b, f_code_[0][0], last_mv_[0][0][0]);
        dmv();
        const int my =
            decode_motion(b, f_code_[0][1], last_mv_[0][0][1] >> 1);
        dmv();
        last_mv_[0][0][0] = last_mv_[0][1][0] = mx;
        last_mv_[0][0][1] = last_mv_[0][1][1] = my * 2;
        mv_field_ = false;
        mv_[0][0][0] = mx;
        mv_[0][0][1] = my * 2;
        dual_prime_ = true;
      } else {
        return false;  // motion_type 0
      }
    }
    last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << dc_precision_;
    std::memset(last_index_, -1, sizeof(last_index_));
    if (type & kCbp) {
      int cbp = tables().cbp.read(b);
      if (cbp < 0) return false;
      if (mb_blocks_ > 6)  // coded_block_pattern_1
        cbp = (cbp << (mb_blocks_ - 6)) | static_cast<int>(b.get(mb_blocks_ - 6));
      if (cbp <= 0) return false;
      for (int i = 0; i < mb_blocks_; ++i) {
        if (!(cbp & (1 << (mb_blocks_ - 1 - i)))) continue;
        std::memset(block_[i], 0, sizeof(block_[i]));
        if (!(mpeg2_ ? inter_block_mpeg2(b, block_[i], i)
                     : inter_block_mpeg1(b, block_[i], i)))
          return false;
      }
      stats.field_dct_mbs += interlaced_dct_;
    }
    reconstruct_inter(mb_x, mb_y);
    return true;
  }

  // ------------------------------------------------------------- blocks

  int decode_dc(Bits& b, int component) {
    const int size = (component ? tables().dc_chrom : tables().dc_lum).read(b);
    if (size < 0) corrupt("dct_dc_size");
    if (size == 0) return 0;
    const int v = static_cast<int>(b.get(size));
    return (v >> (size - 1)) ? v : v - (1 << size) + 1;
  }

  // The next run/level code of table t: its index, or kEob / kEscape.
  static int coef(Bits& b, const CoefTable& t, int* run, int* level) {
    const int k = t.vlc->read(b);
    if (k < 0) corrupt("DCT coefficient code");
    *run = t.run[k];
    *level = t.level[k];
    return *run;  // kEob / kEscape are negative runs
  }

  bool intra_block_mpeg1(Bits& b, int16_t* block, int n) {
    const int component = n <= 3 ? 0 : n - 3;
    const int dc = last_dc_[component] + decode_dc(b, component);
    last_dc_[component] = dc;
    block[0] = static_cast<int16_t>(dc * intra_[0]);
    const uint16_t* m = intra_;
    const CoefTable& t = tables().b14;
    int i = 0;
    for (;;) {
      if (b.peek(2) == 2) {  // EOB
        b.skip(2);
        break;
      }
      int run, level;
      if (coef(b, t, &run, &level) == kEscape) {
        run = static_cast<int>(b.get(6));
        level = b.sget(8);
        if (level == -128) level = static_cast<int>(b.get(8)) - 256;
        else if (level == 0) level = static_cast<int>(b.get(8));
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        const int a = std::abs(level);
        int v = (a * qscale_ * m[j]) >> 4;
        v = (v - 1) | 1;
        block[j] = static_cast<int16_t>(level < 0 ? -v : v);
      } else {
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        int v = (level * qscale_ * m[j]) >> 4;
        v = (v - 1) | 1;
        block[j] = static_cast<int16_t>(b.get1() ? -v : v);
      }
    }
    last_index_[n] = i;
    return true;
  }

  bool inter_block_mpeg1(Bits& b, int16_t* block, int n) {
    const uint16_t* m = inter_;
    const CoefTable& t = tables().b14;
    int i = -1;
    if (b.peek(1)) {  // "1s": (0, 1) as the first coefficient
      int v = (3 * qscale_ * m[0]) >> 5;
      v = (v - 1) | 1;
      block[0] = static_cast<int16_t>((b.peek(2) & 1) ? -v : v);
      b.skip(2);
      i = 0;
    }
    for (;;) {
      if (i >= 0 && b.peek(2) == 2) {
        b.skip(2);
        break;
      }
      int run, level;
      if (coef(b, t, &run, &level) == kEscape) {
        run = static_cast<int>(b.get(6));
        level = b.sget(8);
        if (level == -128) level = static_cast<int>(b.get(8)) - 256;
        else if (level == 0) level = static_cast<int>(b.get(8));
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        const int a = std::abs(level);
        int v = ((a * 2 + 1) * qscale_ * m[j]) >> 5;
        v = (v - 1) | 1;
        block[j] = static_cast<int16_t>(level < 0 ? -v : v);
      } else if (run == kEob) {
        return false;  // EOB before the first coefficient
      } else {
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        int v = ((level * 2 + 1) * qscale_ * m[j]) >> 5;
        v = (v - 1) | 1;
        block[j] = static_cast<int16_t>(b.get1() ? -v : v);
      }
    }
    last_index_[n] = i;
    return true;
  }

  bool intra_block_mpeg2(Bits& b, int16_t* block, int n) {
    const int component = n < 4 ? 0 : (n & 1) + 1;
    const uint16_t* m = n < 4 ? intra_ : chroma_intra_;
    const int dc = last_dc_[component] + decode_dc(b, component);
    last_dc_[component] = dc;
    block[0] = static_cast<int16_t>(dc * (1 << (3 - dc_precision_)));
    int mismatch = block[0] ^ 1;
    const CoefTable& t = intra_vlc_ ? tables().b15 : tables().b14;
    int i = 0;
    for (;;) {
      int run, level;
      const int r = coef(b, t, &run, &level);
      if (r == kEob) break;
      if (r == kEscape) {
        run = static_cast<int>(b.get(6));
        level = b.sget(12);
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        const int v = (std::abs(level) * qscale_ * m[j]) >> 4;
        level = level < 0 ? -v : v;
        mismatch ^= level;
        block[j] = static_cast<int16_t>(level);
      } else {
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        int v = (level * qscale_ * m[j]) >> 4;
        if (b.get1()) v = -v;
        mismatch ^= v;
        block[j] = static_cast<int16_t>(v);
      }
    }
    block[63] = static_cast<int16_t>(block[63] ^ (mismatch & 1));
    last_index_[n] = i;
    return true;
  }

  bool inter_block_mpeg2(Bits& b, int16_t* block, int n) {
    const uint16_t* m = n < 4 ? inter_ : chroma_inter_;
    const CoefTable& t = tables().b14;
    int mismatch = 1;
    int i = -1;
    if (b.peek(1)) {
      int v = (3 * qscale_ * m[0]) >> 5;
      if (b.peek(2) & 1) v = -v;
      block[0] = static_cast<int16_t>(v);
      mismatch ^= v;
      b.skip(2);
      i = 0;
    }
    for (;;) {
      if (i >= 0 && b.peek(2) == 2) {
        b.skip(2);
        break;
      }
      int run, level;
      const int r = coef(b, t, &run, &level);
      if (r == kEscape) {
        run = static_cast<int>(b.get(6));
        level = b.sget(12);
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        const int v = ((std::abs(level) * 2 + 1) * qscale_ * m[j]) >> 5;
        level = level < 0 ? -v : v;
        mismatch ^= level;
        block[j] = static_cast<int16_t>(level);
      } else if (r == kEob) {
        return false;
      } else {
        i += run + 1;
        if (i > 63) return false;
        const int j = scan_[i];
        int v = ((level * 2 + 1) * qscale_ * m[j]) >> 5;
        if (b.get1()) v = -v;
        mismatch ^= v;
        block[j] = static_cast<int16_t>(v);
      }
    }
    block[63] = static_cast<int16_t>(block[63] ^ (mismatch & 1));
    last_index_[n] = i;
    return true;
  }

  // ------------------------------------------------------- reconstruction

  // The blocks' origins and strides under interlaced_dct: luma, then
  // 4:2:0's two chroma blocks, or 4:2:2's U, V, lower U, lower V, laid
  // out as luma is.
  void put_blocks(int mb_x, int mb_y, bool add) {
    Picture& c = *cur_;
    uint8_t* dest[8];
    int stride[8];
    stride[0] = dct_blocks(c.y.at(mb_x * 16, mb_y * 16), c.y.w,
                           interlaced_dct_, 2, dest);
    stride[1] = stride[2] = stride[3] = stride[0];
    if (init_chroma_ == 2) {
      uint8_t* u[2];
      uint8_t* v[2];
      const int cs = dct_blocks(c.u.at(mb_x * 8, mb_y * 16), c.u.w,
                                interlaced_dct_, 1, u);
      dct_blocks(c.v.at(mb_x * 8, mb_y * 16), c.v.w, interlaced_dct_, 1, v);
      dest[4] = u[0], dest[5] = v[0], dest[6] = u[1], dest[7] = v[1];
      stride[4] = stride[5] = stride[6] = stride[7] = cs;
    } else {
      dest[4] = c.u.at(mb_x * 8, mb_y * 8);
      dest[5] = c.v.at(mb_x * 8, mb_y * 8);
      stride[4] = stride[5] = c.u.w;
    }
    for (int i = 0; i < mb_blocks_; ++i) {
      if (add && last_index_[i] < 0) continue;
      simple_idct(block_[i], dest[i], stride[i], add);
    }
  }

  // FFmpeg's mpeg_motion_internal for MPEG-1/2: one 16 x h luma block and
  // its chroma from `ref` (field_based: of the field `field_select`, into
  // the field `bottom` of the macroblock; 4:2:2 chroma at the luma rows,
  // its vertical half-sample from the luma vector); a vector out of the
  // picture predicts nothing, as in FFmpeg.
  void motion(const Picture& ref, int mb_x, int mb_y, int field_based,
              int bottom, int field_select, int mx, int my, int h, Op op) {
    Picture& c = *cur_;
    const bool c422 = init_chroma_ == 2;
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int src_x = mb_x * 16 + (mx >> 1);
    const int src_y = (mb_y << (4 - field_based)) + (my >> 1);
    const int cmx = mx / 2, cmy = my / 2;
    const int uvdxy = c422 ? ((my & 1) << 1) | (cmx & 1)
                           : ((cmy & 1) << 1) | (cmx & 1);
    const int uvsrc_x = mb_x * 8 + (cmx >> 1);
    const int uvsrc_y =
        c422 ? src_y : (mb_y << (3 - field_based)) + (cmy >> 1);
    const int h_edge = mbw_ * 16, v_edge = (mbh_ * 16) >> field_based;
    if (unsigned(src_x) >= unsigned(std::max(h_edge - (mx & 1) - 15, 0)) ||
        unsigned(src_y) >= unsigned(std::max(v_edge - (my & 1) - h + 1, 0)))
      return;
    const int fb = field_based;
    const uint8_t* py =
        ref.y.px.data() + int64_t(src_y) * (c.y.w << fb) + src_x;
    const uint8_t* pu =
        ref.u.px.data() + int64_t(uvsrc_y) * (c.u.w << fb) + uvsrc_x;
    const uint8_t* pv =
        ref.v.px.data() + int64_t(uvsrc_y) * (c.u.w << fb) + uvsrc_x;
    const int crow = c422 ? 16 : 8;
    uint8_t* dy = c.y.at(mb_x * 16, mb_y * 16);
    uint8_t* du = c.u.at(mb_x * 8, mb_y * crow);
    uint8_t* dv = c.v.at(mb_x * 8, mb_y * crow);
    int ls = c.y.w, dls = ls, uvls = c.u.w, duvls = uvls;
    if (fb) {
      field_lines(py, ls, dy, dls, field_select, bottom);
      int vls = c.v.w, dvls = vls;
      field_lines(pv, vls, dv, dvls, field_select, bottom);
      field_lines(pu, uvls, du, duvls, field_select, bottom);
    }
    const int ch = c422 ? h : h >> 1;
    hpel(py, ls, dxy, op, 16, h, dy, dls);
    hpel(pu, uvls, uvdxy, op, 8, ch, du, duvls);
    hpel(pv, uvls, uvdxy, op, 8, ch, dv, duvls);
  }

  void reconstruct_inter(int mb_x, int mb_y) {
    Op op = kPut;
    for (int d = 0; d < 2; ++d) {
      if (!(mv_dir_ & (d ? kBwd : kFwd))) continue;
      const Picture& ref = d ? *next_ : *last_;
      if (!mv_field_) {
        motion(ref, mb_x, mb_y, 0, 0, 0, mv_[d][0][0], mv_[d][0][1], 16, op);
      } else {
        for (int f = 0; f < 2; ++f)
          motion(ref, mb_x, mb_y, 1, f, field_select_[d][f], mv_[d][f][0],
                 mv_[d][f][1], 8, op);
      }
      op = kAvg;
    }
    put_blocks(mb_x, mb_y, true);
  }
};

}  // namespace

extern "C" {

// A decoder; `extra` (may be empty) holds headers a container keeps out of
// band (an MP4 esds, a Matroska CodecPrivate), read before the first
// packet; (w, h) the size the container reports (0 when it reports none).
// 0: *out set; 2: a tool it does not decode (msg names it).
int mpeg12dec_open(const uint8_t* extra, int64_t n, int w, int h, void** out,
                   char* msg, int msg_len) {
  Decoder* d = new Decoder(w, h);
  try {
    if (n > 0) d->decode(extra, n, -1, true);
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    delete d;
    return e.status;
  }
  *out = d;
  return kFrame;
}

// Decode one packet (a picture with the headers before it, as FFmpeg's
// parser splits a stream), tagged `tag` by the caller.  0: a frame is given
// (display order), *w, *h and *out_tag (the tag of the packet it was
// decoded from) set; 1: no frame (a reference held back, a picture FFmpeg
// skips, a damaged picture FFmpeg conceals); 2: a tool it does not decode
// (msg names it); 3: the packet fails as it fails in FFmpeg (a picture
// before any size is known, a slice start code at the packet's end or
// below the picture, a packet too small for its picture: no frame, and
// OpenCV's reader stops there).
int mpeg12dec_decode(void* handle, const uint8_t* data, int64_t n,
                     int64_t tag, int* w, int* h, int64_t* out_tag, char* msg,
                     int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  try {
    const Status st = d->decode(data, n, tag);
    *w = d->width;
    *h = d->height;
    *out_tag = d->out_tag;
    return st;
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    return e.status;
  }
}

// The end of the stream: 0 and the frame held back (as mpeg12dec_decode),
// or 1 when none is.
int mpeg12dec_flush(void* handle, int* w, int* h, int64_t* out_tag) {
  Decoder* d = static_cast<Decoder*>(handle);
  const Status st = d->flush();
  *w = d->width;
  *h = d->height;
  *out_tag = d->out_tag;
  return st;
}

// The frame last given as h*w*3 RGB bytes.  0: done; 4: cap too small or
// no frame.
int mpeg12dec_rgb(void* handle, uint8_t* rgb, int64_t cap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->out || int64_t(d->width) * d->height * 3 > cap) return kSmall;
  const Picture& p = *d->out;
  const swscale_rgb::Matrix m =
      d->out_matrix == 1 ? swscale_rgb::kBt709 : swscale_rgb::kBt601;
  if (p.chroma_format == 2)  // an even height (postinit)
    swscale_rgb::unscaled(p.y.px.data(), p.y.w, p.u.px.data(),
                          p.v.px.data(), p.u.w, d->width, d->height, rgb, m,
                          0);
  else
    swscale_rgb::to_rgb(p.y.px.data(), p.y.w, p.u.px.data(), p.v.px.data(),
                        p.u.w, d->width, d->height, rgb, d->out_left, m);
  return kFrame;
}

// The frame last given as planes, cropped: y (h*w), u and v
// (ceil(h/2)*ceil(w/2) each for 4:2:0, h*ceil(w/2) for 4:2:2).  0: done;
// 4: a cap too small or no frame.
int mpeg12dec_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                     int64_t ycap, int64_t ccap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->out) return kSmall;
  const Picture& p = *d->out;
  const int w = d->width, h = d->height, cw = (w + 1) / 2,
            ch = p.chroma_format == 2 ? h : (h + 1) / 2;
  if (int64_t(w) * h > ycap || int64_t(cw) * ch > ccap) return kSmall;
  for (int j = 0; j < h; ++j) std::memcpy(y + int64_t(j) * w, p.y.at(0, j), w);
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + int64_t(j) * cw, p.u.at(0, j), cw);
    std::memcpy(v + int64_t(j) * cw, p.v.at(0, j), cw);
  }
  return kFrame;
}

// The chroma format of the frame last given: 1 (4:2:0) or 2 (4:2:2); 0
// before the first.
int mpeg12dec_chroma_format(void* handle) {
  Decoder* d = static_cast<Decoder*>(handle);
  return d->out ? d->out->chroma_format : 0;
}

// Whether the frame last given is flagged interlaced (progressive_frame 0
// in an interlaced sequence), as FFmpeg flags it: 1 or 0.
int mpeg12dec_interlaced(void* handle) {
  Decoder* d = static_cast<Decoder*>(handle);
  return d->out && d->out->interlaced ? 1 : 0;
}

// What the stream has used so far (Stats, in its order): up to n values
// into out; returns how many there are.
int mpeg12dec_stats(void* handle, int64_t* out, int n) {
  const Stats& s = static_cast<Decoder*>(handle)->stats;
  const int64_t v[] = {s.frames, s.mpeg1, s.b_pictures, s.field_dct_mbs,
                       s.field_mc_mbs, s.alternate_scan, s.non_linear_quant,
                       s.intra_vlc, s.max_dc_precision, s.loaded_matrices,
                       s.matrix_coefficients, s.concealed_mbs,
                       s.skipped_pictures, s.repeat_first_field,
                       s.top_field_first, s.interlaced_frames,
                       s.concealment_vectors, s.full_pel, s.closed_gops,
                       s.chroma_422_frames};
  const int total = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < n && i < total; ++i) out[i] = v[i];
  return total;
}

void mpeg12dec_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
