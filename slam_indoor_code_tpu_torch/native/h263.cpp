// h263 — an H.263 video decoder (ITU-T H.263 baseline, and the H.263+
// annexes FFmpeg's `h263` and `h263p` encoders write: what OpenCV's
// `H263` writer, 3GPP phones, video-conference and surveillance recorders
// store) with no library but the C++ standard library.
//
// It gives the pixels FFmpeg's `h263` decoder (ituh263dec.c, h263dec.c,
// mpegvideo_motion.c, h263.c) gives on its x86 build, bit for bit:
//   - the picture layer: PSC, PTYPE with the five standard source formats,
//     PLUSPTYPE (UFEP, OPPTYPE, MPPTYPE), the custom picture format (4 to
//     2048 wide, 4 to 1152 high in steps of 4) and pixel aspect ratio, the
//     custom picture clock, RTYPE (rounding of half-pel averages), PEI;
//     GOB headers, and Annex K's slice headers (MBA, SQUANT), each
//     starting a slice across which no prediction reaches;
//   - macroblocks: COD, MCBPC, CBPY, DQUANT, MVD with the median
//     predictor and its rules on a slice's first row; TCOEF with H.263's
//     escape (LAST 1, RUN 6, LEVEL 8), the 8-bit intra DC, H.263's inverse
//     quantisation and FFmpeg's simple IDCT (mpegvideo_dsp.h);
//   - Annex D: unrestricted vectors (edge replication, FFmpeg's tests for
//     when a block needs it) with H.263's long-vector rule, or under
//     PLUSPTYPE the reversible MVD code and its PSC-preventing stuffing
//     bit;
//   - Annex F: a vector per 8x8 block, the chroma vector from their sum,
//     and overlapped block motion compensation of luma, with the vectors
//     of the macroblock to the right read ahead as FFmpeg reads them
//     (preview_obmc, quirks included);
//   - Annex I: advanced intra coding (DC-only, vertical and horizontal
//     DC/AC prediction, the three scans, the intra TCOEF table of Table
//     I.2, DC reconstructed odd);
//   - Annex J: the deblocking filter, edge by edge in FFmpeg's order;
//   - Annex S: the alternative inter VLC (a block that overruns with the
//     inter table read again with Annex I's);
//   - Annex T: modified quantisation (DQUANT's table and 5-bit form, the
//     chroma QP table, the extended escape);
//   - half-pel prediction with FFmpeg's x86 averages (mpegvideo_dsp.h),
//     the inexact 8-wide ones under RTYPE 1 included;
//   - a P-picture before any reference predicted from FFmpeg's dummy
//     frame (luma 16, chroma 128);
//   - the crop of the macroblock-aligned picture, and YUV 4:2:0 -> RGB as
//     OpenCV's FFmpeg backend returns it (swscale_rgb.h);
//   - Sorenson Spark (FLV1, what Flash Video and OpenCV's `FLV1` writer
//     store), as FFmpeg's flv decoder reads it: flvdec.c's picture header
//     (any size up to 65535 a side), baseline macroblocks with no annex,
//     FLV's escape (an 11- or 7-bit level) in format 1, and disposable
//     P-pictures given but kept from the reference (skipped before one).
// A tool it does not decode raises with the tool named: syntax-based
// arithmetic coding (E), PB-frames (G) and improved PB-frames (M), CPM,
// reference picture selection (N), B/EI/EP pictures (O), reference
// picture resampling (P), reduced-resolution update (Q), independent
// segment decoding (R), rectangular slices (K), supplemental enhancement
// information (L/W), and reserved PLUSPTYPE bits (which later annexes,
// U and V, use).  A picture whose header does not parse, or that is too
// short for its size (FFmpeg's test), gives no frame and leaves the
// reference as it was.  Macroblocks that fail to decode, and those up to
// the next GOB or slice header, are concealed (the reference's pixels,
// grey without one), and so is a whole slice that runs to the picture's
// end with more than 7 bits, or fewer than none, left, as FFmpeg conceals
// them (its error resilience
// re-estimates them, so a concealed area is held to a tolerance).
//
// C ABI; Python binds it through ctypes (io/h263.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libh263dec.so h263.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "mpegvideo_bits.h"
#include "mpegvideo_dsp.h"
#include "swscale_rgb.h"

namespace {

using namespace mpegvideo_bits;
using namespace mpegvideo_dsp;

[[noreturn]] void unsupported(const std::string& tool) {
  throw Error{kUnsupported, "H.263 " + tool + " is not decoded"};
}

// Annex I's INTRA TCOEF table (Table I.2), with which Annex S also codes
// inter blocks: H.263's codes (Table 16) given other (last, run, level)
// events.  Entries ordered by last, run, level (the runs and levels
// follow from kAicMaxLevel); the last entry (102) is the escape.
const Code kAicTcoef[103] = {
    {2, 2}, {6, 3}, {14, 4}, {12, 5}, {13, 5}, {16, 6}, {17, 6}, {18, 6},
    {22, 7}, {27, 8}, {32, 9}, {33, 9}, {26, 9}, {27, 9}, {28, 9}, {29, 9},
    {30, 9}, {31, 9}, {35, 11}, {34, 11}, {87, 12}, {86, 12}, {85, 12},
    {84, 12}, {83, 12}, {15, 4}, {20, 6}, {20, 7}, {30, 8}, {15, 10},
    {33, 11}, {80, 12}, {11, 5}, {21, 7}, {14, 10}, {9, 10}, {21, 6},
    {29, 8}, {13, 10}, {81, 12}, {19, 6}, {35, 9}, {7, 11}, {23, 7},
    {34, 9}, {82, 12}, {28, 8}, {12, 10}, {31, 8}, {11, 10}, {37, 9},
    {10, 10}, {36, 9}, {6, 11}, {33, 10}, {32, 10}, {8, 10}, {32, 11},
    {7, 4}, {12, 6}, {16, 7}, {19, 8}, {17, 9}, {18, 9}, {4, 10}, {39, 11},
    {38, 11}, {95, 12}, {15, 6}, {19, 9}, {5, 10}, {37, 11}, {14, 6},
    {20, 9}, {36, 11}, {13, 6}, {6, 10}, {94, 12}, {17, 7}, {7, 10},
    {19, 7}, {93, 12}, {18, 7}, {92, 12}, {20, 8}, {91, 12}, {21, 8},
    {26, 8}, {25, 8}, {24, 8}, {23, 8}, {22, 8}, {25, 9}, {21, 9}, {22, 9},
    {24, 9}, {23, 9}, {4, 11}, {5, 11}, {88, 12}, {89, 12}, {90, 12},
    {3, 7}};
// LMAX by run: last 0 (14 runs), then last 1 (24 runs).
const uint8_t kAicMaxLevel[2][24] = {
    {25, 7, 4, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1},
    {10, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1}};

struct Tables : Scans {
  Vlc intra_mcbpc{kIntraMcbpc, 9}, inter_mcbpc{kInterMcbpc, 28};
  Vlc cbpy{kCbpy, 16}, mv{kMv, 33};
  RunLevel inter{kInterTcoef, kInterMaxLevel[0], 27, kInterMaxLevel[1], 41};
  RunLevel aic{kAicTcoef, kAicMaxLevel[0], 14, kAicMaxLevel[1], 24};
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// The source formats of PTYPE and OPPTYPE: sub-QCIF, QCIF, CIF, 4CIF,
// 16CIF.
const int kFormat[8][2] = {{0, 0},     {128, 96},   {176, 144}, {352, 288},
                           {704, 576}, {1408, 1152}, {0, 0},     {0, 0}};
const int kDquant[4] = {-1, -2, 1, 2};
// Annex T: the quantiser after DQUANT "10" (row 0) and "11" (row 1).
const uint8_t kMqStep[2][32] = {
    {0, 3, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
     18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28},
    {0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     22, 24, 25, 26, 27, 28, 29, 30, 31, 31, 31, 26}};
// Annex T: the chroma quantiser of each luma one (Table T.1).
const uint8_t kMqChroma[32] = {0,  1,  2,  3,  4,  5,  6,  6,  7,  8,  9,
                               9,  10, 10, 11, 11, 12, 12, 12, 13, 13, 13,
                               14, 14, 14, 14, 14, 15, 15, 15, 15, 15};
// Annex J: the filter's strength by quantiser (Table J.2).
const uint8_t kStrength[32] = {0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5,
                               5, 6, 6, 7, 7, 7, 8, 8, 8, 9, 9,
                               9, 10, 10, 10, 11, 11, 11, 12, 12, 12};
// Annex K: MBA's width by the picture's macroblock count (Table K.2).
const int kMbaMax[6] = {47, 98, 395, 1583, 6335, 9215};
const int kMbaLength[6] = {6, 7, 9, 11, 13, 14};

// Annex F's OBMC weights (Figures F.2-F.4): of the block's own vector,
// of the vector above (rows 0-3) or below (rows 4-7), and of the vector
// to the left (columns 0-3) or right (columns 4-7); each pixel's sum is 8.
const uint8_t kObmcMid[8][8] = {
    {4, 5, 5, 5, 5, 5, 5, 4}, {5, 5, 5, 5, 5, 5, 5, 5},
    {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
    {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
    {5, 5, 5, 5, 5, 5, 5, 5}, {4, 5, 5, 5, 5, 5, 5, 4}};
const uint8_t kObmcVert[8][8] = {
    {2, 2, 2, 2, 2, 2, 2, 2}, {1, 1, 2, 2, 2, 2, 1, 1},
    {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
    {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
    {1, 1, 2, 2, 2, 2, 1, 1}, {2, 2, 2, 2, 2, 2, 2, 2}};
const uint8_t kObmcHorz[8][8] = {
    {2, 1, 1, 1, 1, 1, 1, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
    {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
    {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
    {2, 2, 1, 1, 1, 1, 2, 2}, {2, 1, 1, 1, 1, 1, 1, 2}};

// What a stream has used (h263dec_stats, io/h263.py's _STATS, in order).
enum Stat {
  kFrames, kPlusPictures, kCustomFormat, kNoRounding, kIntraMbs, kInterMbs,
  kInter4vMbs, kSkippedMbs, kObmcMbs, kAicBlocks, kAicPredMbs,
  kDeblockedEdges, kGobHeaders, kSliceHeaders, kUmvOutside, kLongVectors,
  kUmvCodes, kAltVlcBlocks, kMqEscapes, kMqChromaMbs,
  kConcealedMbs, kUmvPictures, kObmcPictures, kAicPictures,
  kLoopFilterPictures, kSlicePictures, kAivPictures, kMqPictures,
  kSorensonPictures, kDisposablePictures, kFlvEscapes7, kFlvEscapes11,
  kNumStats
};

enum MbType : uint8_t { kNone = 0, kIntra, kSkip, kInter16, kInter8 };

// ---------------------------------------------------------------- decoder

class Decoder {
 public:
  int width = 0, height = 0;
  const Picture* out = nullptr;  // the frame last given
  int64_t stats[kNumStats] = {};
  // Sorenson Spark (FLV1): FFmpeg's flv decoder, flvdec.c's picture header
  bool sorenson = false;

  // One picture.  kFrame when a frame is given (`out`); kNoFrame for a
  // disposable Sorenson picture before any reference, which FFmpeg skips.
  Status decode(const uint8_t* data, int64_t n) {
    Bits b(data, n);
    droppable_ = false;
    if (sorenson)
      sorenson_header(b, n);
    else
      picture_header(b, n);
    if (droppable_ && !has_ref_) return kNoFrame;
    if (pict_p_ && !has_ref_) {  // FFmpeg's dummy reference
      std::memset(ref_->y.px.data(), 16, ref_->y.px.size());
      std::memset(ref_->u.px.data(), 128, ref_->u.px.size());
      std::memset(ref_->v.px.data(), 128, ref_->v.px.size());
    }
    decode_picture(b);
    out = cur_;
    ++stats[kFrames];
    if (droppable_) return kFrame;  // given, but not a reference
    std::swap(cur_, ref_);
    has_ref_ = true;
    return kFrame;
  }

 private:
  Picture pic_[2];
  Picture* cur_ = &pic_[0];
  Picture* ref_ = &pic_[1];
  bool has_ref_ = false;
  int mbw_ = 0, mbh_ = 0, ew_ = 0, eh_ = 0, gob_index_ = 1;
  // picture-layer state; as in FFmpeg, a PLUSPTYPE without OPPTYPE (UFEP
  // 0) keeps the modes of the picture before it, and a PTYPE picture
  // leaves them as they were
  bool pict_p_ = false, long_vectors_ = false, umv_ = false, obmc_ = false;
  bool aic_ = false, loop_filter_ = false, slice_structured_ = false;
  bool alt_inter_vlc_ = false, modified_quant_ = false, custom_pcf_ = false;
  bool no_rounding_ = false, mq_chroma_ = false;
  // Sorenson: the escape's form (1: H.263's, 2: FLV's) and a disposable
  // P-picture (PTYPE 2 or 3), decoded but kept from the reference
  int flv_ = 0;
  bool droppable_ = false;
  int qscale_ = 1, chroma_qscale_ = 1, y_dc_scale_ = 8, c_dc_scale_ = 8;
  // the slice being decoded
  int mb_x_ = 0, mb_y_ = 0, resync_x_ = 0, resync_y_ = 0;
  bool first_line_ = true;
  int64_t last_resync_ = 0;
  // per macroblock / block state of the picture
  std::vector<uint8_t> mb_type_, done_;
  std::vector<int8_t> qs_;
  std::vector<int16_t> mv_;                   // (x, y) per 8x8 block
  std::vector<int16_t> dc_y_, dc_u_, dc_v_;   // AIC: reconstructed DC
  std::vector<int16_t> ac_y_, ac_u_, ac_v_;   // AIC: 16 per block
  // the macroblock being decoded
  bool intra_ = false, skipped_ = false, four_mv_ = false;
  bool ac_pred_ = false, aic_dir_ = false, emu_ = false;
  int mv16_[2] = {};
  int cbp_ = 0;
  int16_t block_[6][64];
  int last_index_[6] = {};

  // ------------------------------------------------------ picture layer

  void picture_header(Bits& b, int64_t n) {
    // PSC: 22 bits, the byte-aligned 0000 0000 0000 0000 1000 00 FFmpeg
    // searches for
    uint32_t sc = b.get(14);
    for (int64_t left = n * 8 - 14; left > 24; left -= 8) {
      sc = ((sc << 8) | b.get(8)) & 0x3FFFFF;
      if (sc == 0x20) break;
    }
    if (sc != 0x20) corrupt("no picture start code");
    b.skip(8);  // TR
    if (!b.get1()) corrupt("PTYPE's marker bit is 0");
    if (b.get1()) corrupt("PTYPE's H.263 bit is 1");
    b.skip(3);  // split screen, document camera, freeze picture release
    int format = b.get(3);
    int w = 0, h = 0;
    bool plus = format == 7 || format == 6;
    if (!plus) {
      w = kFormat[format][0];
      h = kFormat[format][1];
      if (!w) corrupt("source format 0");
      pict_p_ = b.get1();
      long_vectors_ = b.get1();
      if (b.get1()) unsupported("syntax-based arithmetic coding (Annex E)");
      obmc_ = b.get1();
      if (b.get1()) unsupported("PB-frames (Annex G)");
      qscale_ = b.get(5);
      if (b.get1()) unsupported("continuous presence multipoint (CPM)");
    } else {
      ++stats[kPlusPictures];
      const int ufep = b.get(3);
      if (ufep == 1) {  // OPPTYPE
        format = b.get(3);
        custom_pcf_ = b.get1();
        umv_ = b.get1();
        if (b.get1()) unsupported("syntax-based arithmetic coding (Annex E)");
        obmc_ = b.get1();
        aic_ = b.get1();
        loop_filter_ = b.get1();
        slice_structured_ = b.get1();
        if (b.get1()) unsupported("reference picture selection (Annex N)");
        if (b.get1()) unsupported("independent segment decoding (Annex R)");
        alt_inter_vlc_ = b.get1();
        modified_quant_ = b.get1();
        mq_chroma_ |= modified_quant_;  // FFmpeg keeps T's chroma table
        b.skip(1);  // start code emulation prevention
        if (b.get(3))
          unsupported("PLUSPTYPE with reserved OPPTYPE bits set (a later "
                      "annex: U or V)");
      } else if (ufep != 0) {
        corrupt("UFEP neither 0 nor 1");
      }
      const int type = b.get(3);  // MPPTYPE
      if (type == 2) unsupported("improved PB-frames (Annex M)");
      if (type >= 3 && type <= 5)
        unsupported("B, EI and EP pictures (Annex O)");
      if (type == 6) corrupt("reserved picture type");
      pict_p_ = type == 1;
      if (b.get1()) unsupported("reference picture resampling (Annex P)");
      if (b.get1()) unsupported("reduced-resolution update (Annex Q)");
      no_rounding_ = b.get1();
      if (b.get(2))
        unsupported("PLUSPTYPE with reserved MPPTYPE bits set (a later "
                    "annex: U or V)");
      b.skip(1);
      if (b.get1()) unsupported("continuous presence multipoint (CPM)");
      if (ufep) {
        if (format == 6) {  // CPFMT
          ++stats[kCustomFormat];
          const int par = b.get(4);
          w = (b.get(9) + 1) * 4;
          b.skip(1);  // FFmpeg logs a missing marker and goes on
          h = b.get(9) * 4;
          if (par == 15) b.skip(16);  // extended PAR
        } else {
          w = kFormat[format][0];
          h = kFormat[format][1];
        }
        if (!w || !h) corrupt("picture size 0");
        if (custom_pcf_) b.skip(8);  // CPCFC
      } else {
        w = width;
        h = height;
        if (!w) corrupt("PLUSPTYPE without OPPTYPE before any size");
      }
      if (custom_pcf_) b.skip(2);  // ETR
      if (ufep) {
        if (umv_ && !b.get1()) b.skip(1);  // UUI
        if (slice_structured_) {
          if (b.get1()) unsupported("rectangular slices (Annex K)");
          b.skip(1);  // arbitrary slice ordering: slices place themselves
        }
      }
      qscale_ = b.get(5);
    }
    if (b.overrun()) corrupt("picture header cut short");
    if (int64_t(w) * h / 256 / 8 > b.left())
      corrupt("picture too short for its size");
    if (w != width || h != height) resize(w, h);
    if (b.get1())  // PEI
      unsupported("supplemental enhancement information (PSUPP, annexes L "
                  "and W)");
    mb_x_ = mb_y_ = 0;
    if (slice_structured_) {
      if (!b.get1()) corrupt("SEPB1 missing");
      mba(b);
      if (!b.get1()) corrupt("SEPB2 missing");
    }
    if (b.overrun()) corrupt("picture header cut short");
    const bool modes[7] = {umv_ && plus, obmc_, aic_, loop_filter_,
                           slice_structured_, alt_inter_vlc_,
                           modified_quant_};
    for (int i = 0; i < 7; ++i) stats[kUmvPictures + i] += modes[i];
    if (no_rounding_) ++stats[kNoRounding];
  }

  // ff_flv_decode_picture_header: a 17-bit start code, the format (0: the
  // H.263 escape, 1: the FLV escape), TR, a size code (8- or 16-bit sizes,
  // or one of five), the picture type (2 and 3: disposable P), the
  // deblocking flag (ignored), the quantiser and PEI's extra bytes; no
  // annex, and vectors wrap as baseline's.
  void sorenson_header(Bits& b, int64_t n) {
    if (b.get(17) != 1) corrupt("no Sorenson picture start code");
    const int format = static_cast<int>(b.get(5));
    if (format > 1) corrupt("Sorenson picture format neither 0 nor 1");
    flv_ = format + 1;
    b.skip(8);  // TR
    static const int kSizes[5][2] = {
        {352, 288}, {176, 144}, {128, 96}, {320, 240}, {160, 120}};
    const int code = static_cast<int>(b.get(3));
    int w = 0, h = 0;
    if (code < 2) {
      w = static_cast<int>(b.get(code ? 16 : 8));
      h = static_cast<int>(b.get(code ? 16 : 8));
    } else if (code < 7) {
      w = kSizes[code - 2][0];
      h = kSizes[code - 2][1];
    }
    // av_image_check_size
    if (!w || !h || int64_t(w + 128) * (h + 128) >= (INT32_MAX / 8))
      corrupt("Sorenson picture size invalid");
    const int type = static_cast<int>(b.get(2));
    pict_p_ = type != 0;
    droppable_ = type > 1;
    b.skip(1);  // deblocking flag
    qscale_ = static_cast<int>(b.get(5));
    while (b.get1() && !b.overrun()) b.skip(8);  // PEI, PSUPP
    if (b.overrun()) corrupt("picture header cut short");
    if (int64_t(w) * h / 256 / 8 > b.left())
      corrupt("picture too short for its size");
    if (width && (w != width || h != height))
      unsupported("Sorenson Spark picture size change (" +
                  std::to_string(width) + "x" + std::to_string(height) +
                  " to " + std::to_string(w) + "x" + std::to_string(h) +
                  ")");
    if (w != width || h != height) resize(w, h);
    mb_x_ = mb_y_ = 0;
    ++stats[kSorensonPictures];
    stats[kDisposablePictures] += droppable_;
    (void)n;
  }

  void resize(int w, int h) {
    width = w;
    height = h;
    mbw_ = (w + 15) / 16;
    mbh_ = (h + 15) / 16;
    ew_ = mbw_ * 16;
    eh_ = mbh_ * 16;
    gob_index_ = h <= 400 ? 1 : h <= 800 ? 2 : 4;
    for (Picture& p : pic_) p.init(mbw_, mbh_);
    has_ref_ = false;
    out = nullptr;
  }

  void mba(Bits& b) {
    const int mb_num = mbw_ * mbh_;
    int i = 0;
    while (i < 5 && mb_num - 1 > kMbaMax[i]) ++i;
    const int pos = static_cast<int>(b.get(kMbaLength[i]));
    mb_x_ = pos % mbw_;
    mb_y_ = pos / mbw_;
  }

  void set_qscale(int q) {
    qscale_ = std::clamp(q, 1, 31);
    chroma_qscale_ = chroma_q(qscale_);
    y_dc_scale_ = aic_ ? 2 * qscale_ : 8;
    c_dc_scale_ = aic_ ? 2 * chroma_qscale_ : 8;
  }

  // The macroblocks: the first slice, then one for each GOB or slice
  // header FFmpeg's resync finds; what none of them decoded is concealed.
  void decode_picture(Bits& b) {
    const size_t nb = size_t(mbw_) * mbh_;
    mb_type_.assign(nb, kNone);
    done_.assign(nb, 0);
    qs_.assign(nb, 0);
    mv_.assign(nb * 8, 0);
    dc_y_.assign(nb * 4, 1024);
    dc_u_.assign(nb, 1024);
    dc_v_.assign(nb, 1024);
    ac_y_.assign(nb * 64, 0);
    ac_u_.assign(nb * 16, 0);
    ac_v_.assign(nb * 16, 0);
    decode_slice(b);
    while (mb_y_ < mbh_ && resync(b)) decode_slice(b);
    for (size_t i = 0; i < nb; ++i)
      if (!done_[i]) conceal(static_cast<int>(i % mbw_),
                             static_cast<int>(i / mbw_));
  }

  void conceal(int mx, int my) {
    ++stats[kConcealedMbs];
    for (int j = 0; j < 16; ++j) {
      uint8_t* d = cur_->y.at(mx * 16, my * 16 + j);
      if (has_ref_) std::memcpy(d, ref_->y.at(mx * 16, my * 16 + j), 16);
      else std::memset(d, 128, 16);
    }
    for (int j = 0; j < 8; ++j)
      for (Plane* p : {&cur_->u, &cur_->v}) {
        const Plane& r = p == &cur_->u ? ref_->u : ref_->v;
        uint8_t* d = p->at(mx * 8, my * 8 + j);
        if (has_ref_) std::memcpy(d, r.at(mx * 8, my * 8 + j), 8);
        else std::memset(d, 128, 8);
      }
  }

  // ff_h263_resync: a GOB or slice header where the slice ended, else the
  // first one on a byte boundary after the slice's start.
  bool resync(Bits& b) {
    if (b.left() >= 16 && b.peek(16) == 0 && gob_header(b)) return true;
    int64_t p = (last_resync_ + 7) & ~int64_t(7);
    b.seek(p);
    for (int64_t left = b.left(); left > 16 + 1 + 5 + 5; left -= 8) {
      if (b.peek(16) == 0) {
        const int64_t at = b.pos();
        if (gob_header(b)) return true;
        b.seek(at);
      }
      b.skip(8);
    }
    return false;
  }

  bool gob_header(Bits& b) {
    if (b.peek(16)) return false;
    b.skip(16);
    int64_t left = std::min<int64_t>(b.left(), 32);
    for (; left > 13; --left)
      if (b.get1()) break;
    if (left <= 13) return false;
    if (slice_structured_) {
      if (!b.get1()) return false;
      mba(b);
      if (mbw_ * mbh_ > 1583 && !b.get1()) return false;
      qscale_ = b.get(5);  // SQUANT
      if (!b.get1()) return false;
      b.skip(2);  // GFID
    } else {
      const int gn = b.get(5);
      mb_x_ = 0;
      mb_y_ = gob_index_ * gn;
      b.skip(2);  // GFID
      qscale_ = b.get(5);  // GQUANT
    }
    if (mb_y_ >= mbh_ || qscale_ == 0 || b.overrun()) return false;
    ++stats[slice_structured_ ? kSliceHeaders : kGobHeaders];
    return true;
  }

  // FFmpeg's decode_slice: macroblocks from (mb_x_, mb_y_) until one is
  // followed by 16 zero bits (a GOB or slice header, or the end) or fails.
  void decode_slice(Bits& b) {
    last_resync_ = b.pos();
    first_line_ = true;
    resync_x_ = mb_x_;
    resync_y_ = mb_y_;
    set_qscale(qscale_);
    for (; mb_y_ < mbh_; ++mb_y_, mb_x_ = 0) {
      for (; mb_x_ < mbw_; ++mb_x_) {
        if (resync_x_ == mb_x_ && resync_y_ + 1 == mb_y_) first_line_ = false;
        bool end;
        try {
          end = decode_mb(b);
        } catch (const Error& e) {
          if (e.status != kCorrupt) throw;
          return;
        }
        update_mv();
        reconstruct();
        if (loop_filter_) deblock();
        done_[mb_y_ * mbw_ + mb_x_] = 1;
        if (end) {
          if (++mb_x_ >= mbw_) {
            mb_x_ = 0;
            ++mb_y_;
          }
          return;
        }
      }
    }
    // The slice ran to the picture's end with no end marker: FFmpeg takes
    // it whole only where at most 7 bits are left ("discarding junk
    // bits", "overreading"), and else conceals all of it.
    const int64_t left = b.left();
    if (left > 7 || left < 0)
      for (int i = resync_y_ * mbw_ + resync_x_; i < mbw_ * mbh_; ++i)
        done_[i] = 0;
  }

  // ---------------------------------------------------- macroblock layer

  // ff_h263_decode_mb: true when the slice ends after it.
  bool decode_mb(Bits& b) {
    const Tables& t = tables();
    const int xy = mb_y_ * mbw_ + mb_x_;
    intra_ = skipped_ = four_mv_ = false;
    ac_pred_ = false;
    mv16_[0] = mv16_[1] = 0;
    std::memset(block_, 0, sizeof(block_));
    int cbpc = 0;
    bool dquant = false;
    if (pict_p_) {
      for (;;) {
        if (b.get1()) {  // COD 1: not coded
          skipped_ = true;
          mb_type_[xy] = kSkip;
          ++stats[kSkippedMbs];
          return end_of_mb(b);
        }
        cbpc = t.inter_mcbpc.read(b, "MCBPC");
        if (cbpc != 20) break;
      }
      dquant = (cbpc & 8) != 0;
      intra_ = (cbpc & 4) != 0;
    } else {
      do cbpc = t.intra_mcbpc.read(b, "MCBPC");
      while (cbpc == 8);
      dquant = (cbpc & 4) != 0;
      intra_ = true;
    }
    if (intra_) {
      mb_type_[xy] = kIntra;
      ++stats[kIntraMbs];
      if (aic_) {
        ac_pred_ = b.get1();
        if (ac_pred_) {
          aic_dir_ = b.get1();
          ++stats[kAicPredMbs];
        }
      }
      const int cbpy = t.cbpy.read(b, "CBPY");
      cbp_ = (cbpc & 3) | (cbpy << 2);
      if (dquant) decode_dquant(b);
    } else {
      int cbpy = t.cbpy.read(b, "CBPY");
      if (!alt_inter_vlc_ || (cbpc & 3) != 3) cbpy ^= 0xF;
      cbp_ = (cbpc & 3) | (cbpy << 2);
      if (dquant) decode_dquant(b);
      if (!(cbpc & 16)) {
        mb_type_[xy] = kInter16;
        ++stats[kInterMbs];
        int px, py;
        pred_motion(0, &px, &py);
        mv16_[0] = vector(b, px);
        mv16_[1] = vector(b, py);
        if (umv_ && mv16_[0] - px == 1 && mv16_[1] - py == 1)
          b.skip(1);  // stuffing that prevents a PSC
        count_long(mv16_);
      } else {
        mb_type_[xy] = kInter8;
        four_mv_ = true;
        ++stats[kInter4vMbs];
        for (int k = 0; k < 4; ++k) {
          int px, py, v[2];
          pred_motion(k, &px, &py);
          v[0] = vector(b, px);
          v[1] = vector(b, py);
          if (umv_ && v[0] - px == 1 && v[1] - py == 1) b.skip(1);
          count_long(v);
          int16_t* m = mv_at(2 * mb_x_ + (k & 1), 2 * mb_y_ + (k >> 1));
          m[0] = static_cast<int16_t>(v[0]);
          m[1] = static_cast<int16_t>(v[1]);
        }
      }
    }
    for (int n = 0; n < 6; ++n) decode_block(b, n, (cbp_ & (32 >> n)) != 0);
    if (obmc_ && !intra_ && pict_p_ && mb_x_ + 1 < mbw_) preview_obmc(b);
    return end_of_mb(b);
  }

  bool end_of_mb(Bits& b) {
    if (b.left() < 0) corrupt("macroblock runs past the end");
    uint32_t v = b.peek(16);
    if (b.left() < 16) v >>= 16 - b.left();
    return v == 0;
  }

  void count_long(const int* v) {
    if (v[0] < -32 || v[0] > 31 || v[1] < -32 || v[1] > 31)
      ++stats[kLongVectors];
  }

  void decode_dquant(Bits& b) {
    if (modified_quant_) {
      if (b.get1())
        set_qscale(kMqStep[b.get1()][qscale_]);
      else
        set_qscale(static_cast<int>(b.get(5)));
    } else {
      set_qscale(qscale_ + kDquant[b.get(2)]);
    }
  }

  // A vector component from its predictor: Annex D's reversible code
  // under PLUSPTYPE, else MVD (FFmpeg's f_code 1) with the wrap, or the
  // long-vector rule of a PTYPE picture's Annex D.
  int vector(Bits& b, int pred) {
    int v = umv_ ? umotion(b, pred) : motion(b, pred);
    if (v >= 0xffff) corrupt("invalid motion vector code");
    return v;
  }

  int motion(Bits& b, int pred) {
    const int code = tables().mv.try_read(b);
    if (code < 0) return 0xffff;
    if (code == 0) return pred;
    const int sign = b.get1();
    int val = (sign ? -code : code) + pred;
    if (!long_vectors_) {
      val = static_cast<int>(static_cast<unsigned>(val) << 26) >> 26;
    } else {
      if (pred < -31 && val < -63) val += 64;
      if (pred > 32 && val > 63) val -= 64;
    }
    return val;
  }

  int umotion(Bits& b, int pred) {
    if (b.get1()) return pred;
    ++stats[kUmvCodes];
    int code = 2 + b.get1();
    while (b.get1()) {
      code = (code << 1) + b.get1();
      if (code >= 32768) return 0xffff;
    }
    const int sign = code & 1;
    code >>= 1;
    return sign ? pred - code : pred + code;
  }

  int16_t* mv_at(int bx, int by) {
    return &mv_[2 * (size_t(by) * 2 * mbw_ + bx)];
  }
  int mv_or0(int bx, int by, int c) {
    if (bx < 0 || bx >= 2 * mbw_ || by < 0) return 0;
    return mv_at(bx, by)[c];
  }

  // ff_h263_pred_motion without MPEG-4's cases: the median of the blocks
  // left, above and above right; on a slice's first row the left one (0
  // at the slice's first macroblock), and for block 2 the left zeroed (and
  // stored so, into the macroblock to the left) at the slice's first
  // macroblock.
  void pred_motion(int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    const int bx = 2 * mb_x_ + (blk & 1), by = 2 * mb_y_ + (blk >> 1);
    int a0 = mv_or0(bx - 1, by, 0), a1 = mv_or0(bx - 1, by, 1);
    if (first_line_ && blk < 3) {
      if (blk == 0 && mb_x_ == resync_x_) {
        *px = *py = 0;
        return;
      }
      if (blk < 2) {
        *px = a0;
        *py = a1;
        return;
      }
      if (mb_x_ == resync_x_) {
        a0 = a1 = 0;
        if (bx > 0) mv_at(bx - 1, by)[0] = mv_at(bx - 1, by)[1] = 0;
      }
    }
    const int cx = bx + off[blk];
    *px = median3(a0, mv_or0(bx, by - 1, 0), mv_or0(cx, by - 1, 0));
    *py = median3(a1, mv_or0(bx, by - 1, 1), mv_or0(cx, by - 1, 1));
  }

  // preview_obmc: the vectors of the macroblock to the right, read ahead
  // for this one's OBMC as FFmpeg reads them: with this macroblock's
  // first-row state, its own 1MV vectors not yet stored (zero), and an
  // undecodable MCBPC (a slice header) taken for intra.
  void preview_obmc(Bits& b) {
    const Tables& t = tables();
    const int64_t at = b.pos();
    const int saved_x = mb_x_;
    ++mb_x_;
    const int xy = mb_y_ * mbw_ + mb_x_;
    int cbpc;
    bool skip = false;
    for (;;) {
      if (b.get1()) {
        skip = true;
        break;
      }
      cbpc = t.inter_mcbpc.try_read(b);
      if (cbpc != 20) break;
    }
    if (skip) {
      for (int k = 0; k < 4; ++k) {
        int16_t* m = mv_at(2 * mb_x_ + (k & 1), 2 * mb_y_ + (k >> 1));
        m[0] = m[1] = 0;
      }
      mb_type_[xy] = kSkip;
    } else if (cbpc < 0 || (cbpc & 4)) {
      mb_type_[xy] = kIntra;
    } else {
      t.cbpy.try_read(b);
      if (cbpc & 8) {
        if (modified_quant_)
          b.skip(b.get1() ? 1 : 5);
        else
          b.skip(2);
      }
      if (!(cbpc & 16)) {
        mb_type_[xy] = kInter16;
        int px, py;
        pred_motion(0, &px, &py);
        const int vx = umv_ ? umotion(b, px) : motion(b, px);
        const int vy = umv_ ? umotion(b, py) : motion(b, py);
        for (int k = 0; k < 4; ++k) {
          int16_t* m = mv_at(2 * mb_x_ + (k & 1), 2 * mb_y_ + (k >> 1));
          m[0] = static_cast<int16_t>(vx);
          m[1] = static_cast<int16_t>(vy);
        }
      } else {
        mb_type_[xy] = kInter8;
        for (int k = 0; k < 4; ++k) {
          int px, py;
          pred_motion(k, &px, &py);
          const int vx = umv_ ? umotion(b, px) : motion(b, px);
          const int vy = umv_ ? umotion(b, py) : motion(b, py);
          if (umv_ && vx - px == 1 && vy - py == 1) b.skip(1);
          int16_t* m = mv_at(2 * mb_x_ + (k & 1), 2 * mb_y_ + (k >> 1));
          m[0] = static_cast<int16_t>(vx);
          m[1] = static_cast<int16_t>(vy);
        }
      }
    }
    mb_x_ = saved_x;
    b.seek(at);
  }

  // ff_h263_update_motion_val: a 1MV, skipped or intra macroblock's vector
  // into its four blocks (a 4MV one's were stored as they were read).
  void update_mv() {
    if (four_mv_) return;
    const int vx = intra_ ? 0 : mv16_[0], vy = intra_ ? 0 : mv16_[1];
    for (int k = 0; k < 4; ++k) {
      int16_t* m = mv_at(2 * mb_x_ + (k & 1), 2 * mb_y_ + (k >> 1));
      m[0] = static_cast<int16_t>(vx);
      m[1] = static_cast<int16_t>(vy);
    }
  }

  // ---------------------------------------------------------- blocks

  // h263_decode_block: the levels of block n in raster order, still
  // quantised; an intra block under Annex I predicted (ff_h263_pred_acdc).
  void decode_block(Bits& b, int n, bool coded) {
    const Tables& t = tables();
    int16_t* block = block_[n];
    const RunLevel* rl = &t.inter;
    const uint8_t* scan = t.zigzag;
    const int64_t start = b.pos();
    int i = 0;
    const bool aic = aic_ && intra_;
    if (aic) {
      rl = &t.aic;
      ++stats[kAicBlocks];
      if (ac_pred_) scan = aic_dir_ ? t.vertical : t.horizontal;
    } else if (intra_) {
      int level = b.get(8);  // INTRADC; FFmpeg takes 0 and 128 too
      block[0] = static_cast<int16_t>(level == 255 ? 128 : level);
      i = 1;
    }
    if (coded) {
      for (;;) {
        const int k = rl->vlc.read(b, "TCOEF");
        int last, run, level;
        if (k == kEscape && flv_ > 1) {  // FLV: is11, LAST, RUN, LEVEL
          const int is11 = b.get1();
          last = b.get1();
          run = b.get(6);
          const int nb = is11 ? 11 : 7;
          level = static_cast<int>(b.get(nb) << (32 - nb)) >> (32 - nb);
          ++stats[is11 ? kFlvEscapes11 : kFlvEscapes7];
        } else if (k == kEscape) {
          last = b.get1();
          run = b.get(6);
          level = static_cast<int8_t>(b.get(8));
          if (level == -128) {  // Annex T's extended escape
            ++stats[kMqEscapes];
            const int lo = b.get(5);
            level = lo | (static_cast<int>(b.get(6) << 26) >> 21);
          }
        } else {
          last = rl->last[k];
          run = rl->run[k];
          level = rl->level[k];
          if (b.get1()) level = -level;
        }
        const int pos = i + run;
        if (pos > 63) {
          if (alt_inter_vlc_ && rl == &t.inter && !intra_) {
            // Annex S: the block read again with Annex I's table
            ++stats[kAltVlcBlocks];
            rl = &t.aic;
            i = 0;
            b.seek(start);
            std::memset(block, 0, sizeof(block_[0]));
            continue;
          }
          corrupt("run past the end of a block");
        }
        block[scan[pos]] = static_cast<int16_t>(level);
        i = pos + 1;
        if (last) break;
      }
    }
    last_index_[n] = i - 1;
    if (aic) {
      pred_acdc(n);
      last_index_[n] = 63;
    }
  }

  // ff_h263_pred_acdc: the DC predicted from the blocks left (A) and above
  // (C), 1024 where none is (outside the picture, before the slice, or
  // not intra); with INTRA_MODE's AC prediction, the first column from
  // the left block or the first row from the one above, and the DC from
  // that block alone; the DC scaled, added, clipped at 0 and made odd.
  void pred_acdc(int n) {
    int16_t* block = block_[n];
    int bx, by, gw;
    if (n < 4) {
      bx = 2 * mb_x_ + (n & 1);
      by = 2 * mb_y_ + (n >> 1);
      gw = 2 * mbw_;
    } else {
      bx = mb_x_;
      by = mb_y_;
      gw = mbw_;
    }
    std::vector<int16_t>& dc = n < 4 ? dc_y_ : n == 4 ? dc_u_ : dc_v_;
    std::vector<int16_t>& ac = n < 4 ? ac_y_ : n == 4 ? ac_u_ : ac_v_;
    const size_t here = size_t(by) * gw + bx;
    int a = bx > 0 ? dc[here - 1] : 1024;
    int c = by > 0 ? dc[here - gw] : 1024;
    if (first_line_ && n != 3) {
      if (n != 2) c = 1024;
      if (n != 1 && mb_x_ == resync_x_) a = 1024;
    }
    const int scale = n < 4 ? y_dc_scale_ : c_dc_scale_;
    int pred;
    if (ac_pred_) {
      pred = 1024;
      if (aic_dir_) {
        if (a != 1024) {
          const int16_t* left = &ac[(here - 1) * 16];
          for (int k = 1; k < 8; ++k)
            block[k * 8] = static_cast<int16_t>(block[k * 8] + left[k]);
          pred = a;
        }
      } else if (c != 1024) {
        const int16_t* top = &ac[(here - gw) * 16];
        for (int k = 1; k < 8; ++k)
          block[k] = static_cast<int16_t>(block[k] + top[8 + k]);
        pred = c;
      }
    } else if (a != 1024 && c != 1024) {
      pred = (a + c) >> 1;
    } else {
      pred = a != 1024 ? a : c;
    }
    int16_t d = static_cast<int16_t>(block[0] * scale + pred);
    d = d < 0 ? 0 : static_cast<int16_t>(d | 1);
    block[0] = d;
    dc[here] = d;
    int16_t* own = &ac[here * 16];
    for (int k = 1; k < 8; ++k) {
      own[k] = block[k * 8];
      own[8 + k] = block[k];
    }
  }

  // ------------------------------------------------------ reconstruction

  void reconstruct() {
    const int xy = mb_y_ * mbw_ + mb_x_;
    qs_[xy] = static_cast<int8_t>(qscale_);
    if (!skipped_ && chroma_qscale_ != qscale_) ++stats[kMqChromaMbs];
    if (intra_) {
      for (int n = 0; n < 6; ++n) {
        dequant_intra(n, n < 4 ? qscale_ : chroma_qscale_);
        uint8_t* dst;
        int stride;
        block_dest(n, &dst, &stride);
        simple_idct(block_[n], dst, stride, false);
      }
      return;
    }
    emu_ = false;
    const Op op = no_rounding_ ? kPutNoRnd : kPut;
    if (obmc_) {
      ++stats[kObmcMbs];
      apply_obmc(op);
    } else if (four_mv_) {
      int sx = 0, sy = 0;
      for (int k = 0; k < 4; ++k) {
        const int16_t* m = mv_at(2 * mb_x_ + (k & 1), 2 * mb_y_ + (k >> 1));
        hpel8(mb_x_ * 16 + (k & 1) * 8, mb_y_ * 16 + (k >> 1) * 8, m[0],
              m[1], op,
              cur_->y.at(mb_x_ * 16 + (k & 1) * 8, mb_y_ * 16 + (k >> 1) * 8),
              cur_->y.w);
        sx += m[0];
        sy += m[1];
      }
      chroma_4mv(sx, sy, op);
    } else {
      mc16(mv16_[0], mv16_[1], op);
    }
    if (emu_) ++stats[kUmvOutside];
    for (int n = 0; n < 6; ++n) {
      if (skipped_ || !(cbp_ & (32 >> n))) continue;
      dequant_inter(n, n < 4 ? qscale_ : chroma_qscale_);
      uint8_t* dst;
      int stride;
      block_dest(n, &dst, &stride);
      simple_idct(block_[n], dst, stride, true);
    }
  }

  // dct_unquantize_h263_intra: the DC scaled by 8 (Annex I: already
  // reconstructed), each AC level by 2q, +-(q - 1) | 1 (Annex I: none);
  // 16-bit results, as FFmpeg stores them.
  void dequant_intra(int n, int q) {
    int16_t* block = block_[n];
    const int qmul = 2 * q, qadd = aic_ ? 0 : (q - 1) | 1;
    if (!aic_) block[0] = static_cast<int16_t>(block[0] * 8);
    for (int k = 1; k < 64; ++k) {
      int level = block[k];
      if (!level) continue;
      level = level < 0 ? level * qmul - qadd : level * qmul + qadd;
      block[k] = static_cast<int16_t>(level);
    }
  }

  void dequant_inter(int n, int q) {
    int16_t* block = block_[n];
    const int qmul = 2 * q, qadd = (q - 1) | 1;
    for (int k = 0; k < 64; ++k) {
      int level = block[k];
      if (!level) continue;
      level = level < 0 ? level * qmul - qadd : level * qmul + qadd;
      block[k] = static_cast<int16_t>(level);
    }
  }

  void block_dest(int n, uint8_t** dst, int* stride) {
    if (n < 4) {
      *dst = cur_->y.at(mb_x_ * 16 + (n & 1) * 8, mb_y_ * 16 + (n >> 1) * 8);
      *stride = cur_->y.w;
    } else {
      Plane& c = n == 4 ? cur_->u : cur_->v;
      *dst = c.at(mb_x_ * 8, mb_y_ * 8);
      *stride = c.w;
    }
  }

  // ------------------------------------------------- motion compensation

  // mpeg_motion for H.263: one vector for the macroblock, the chroma
  // vector as FFmpeg derives it (uvdxy from the luma vector's two low
  // bits, the source at half the luma one's).
  void mc16(int vx, int vy, Op op) {
    uint8_t buf[3][kWin * kWin];
    int ys, us, vs;
    const int dxy = ((vy & 1) << 1) | (vx & 1);
    const int sx = mb_x_ * 16 + (vx >> 1), sy = mb_y_ * 16 + (vy >> 1);
    const int uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
    const int ux = sx >> 1, uy = sy >> 1;
    const bool emu =
        unsigned(sx) >= unsigned(std::max(ew_ - (vx & 1) - 15, 0)) ||
        unsigned(sy) >= unsigned(std::max(eh_ - (vy & 1) - 15, 0));
    emu_ |= emu;
    const uint8_t* y = window(ref_->y, sx, sy, 17, 17, ew_, eh_, emu, buf[0],
                              &ys);
    const uint8_t* u = window(ref_->u, ux, uy, 9, 9, ew_ >> 1, eh_ >> 1, emu,
                              buf[1], &us);
    const uint8_t* v = window(ref_->v, ux, uy, 9, 9, ew_ >> 1, eh_ >> 1, emu,
                              buf[2], &vs);
    hpel(y, ys, dxy, op, 16, 16, cur_->y.at(mb_x_ * 16, mb_y_ * 16),
         cur_->y.w);
    hpel(u, us, uvdxy, op, 8, 8, cur_->u.at(mb_x_ * 8, mb_y_ * 8), cur_->u.w);
    hpel(v, vs, uvdxy, op, 8, 8, cur_->v.at(mb_x_ * 8, mb_y_ * 8), cur_->v.w);
  }

  // hpel_motion: an 8x8 luma block whose top left is (x, y) plus the
  // vector, its source clipped to [-16, width] x [-16, height] with the
  // fraction dropped at the far end.
  void hpel8(int x, int y, int vx, int vy, Op op, uint8_t* dst, int ds) {
    uint8_t buf[kWin * kWin];
    int ss, dxy = 0;
    int sx = std::clamp(x + (vx >> 1), -16, width);
    if (sx != width) dxy |= vx & 1;
    int sy = std::clamp(y + (vy >> 1), -16, height);
    if (sy != height) dxy |= (vy & 1) << 1;
    const bool emu =
        unsigned(sx) >= unsigned(std::max(ew_ - (vx & 1) - 7, 0)) ||
        unsigned(sy) >= unsigned(std::max(eh_ - (vy & 1) - 7, 0));
    emu_ |= emu;
    const uint8_t* s = window(ref_->y, sx, sy, 9, 9, ew_, eh_, emu, buf, &ss);
    hpel(s, ss, dxy, op, 8, 8, dst, ds);
  }

  // chroma_4mv_motion: the chroma of a macroblock whose luma vectors sum
  // to (sx, sy), rounded by H.263's table.
  void chroma_4mv(int sx, int sy, Op op) {
    uint8_t buf[kWin * kWin];
    int ss;
    const int cx = round_chroma(sx), cy = round_chroma(sy);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    int ux = std::clamp(mb_x_ * 8 + (cx >> 1), -8, width >> 1);
    if (ux == (width >> 1)) dxy &= ~1;
    int uy = std::clamp(mb_y_ * 8 + (cy >> 1), -8, height >> 1);
    if (uy == (height >> 1)) dxy &= ~2;
    const bool emu =
        unsigned(ux) >= unsigned(std::max((ew_ >> 1) - (dxy & 1) - 7, 0)) ||
        unsigned(uy) >= unsigned(std::max((eh_ >> 1) - (dxy >> 1) - 7, 0));
    emu_ |= emu;
    const uint8_t* s = window(ref_->u, ux, uy, 9, 9, ew_ >> 1, eh_ >> 1, emu,
                              buf, &ss);
    hpel(s, ss, dxy, op, 8, 8, cur_->u.at(mb_x_ * 8, mb_y_ * 8), cur_->u.w);
    s = window(ref_->v, ux, uy, 9, 9, ew_ >> 1, eh_ >> 1, emu, buf, &ss);
    hpel(s, ss, dxy, op, 8, 8, cur_->v.at(mb_x_ * 8, mb_y_ * 8), cur_->v.w);
  }

  bool intra_at(int xy) const { return mb_type_[xy] == kIntra; }

  // apply_obmc: each 8x8 luma block from its own vector and those of the
  // blocks above, left, right and below it (within the macroblock its
  // own; outside, the neighbour's unless it is intra or outside the
  // picture; below, always the macroblock's own lower blocks), weighted
  // by Annex F's matrices; chroma from the sum of the four own vectors.
  void apply_obmc(Op op) {
    int cache[4][4][2];
    const int bx = 2 * mb_x_, by = 2 * mb_y_, xy = mb_y_ * mbw_ + mb_x_;
    auto set = [&](int r, int c, int x, int y) {
      const int16_t* m = mv_at(x, y);
      cache[r][c][0] = m[0];
      cache[r][c][1] = m[1];
    };
    auto copy = [&](int r, int c, int r2, int c2) {
      cache[r][c][0] = cache[r2][c2][0];
      cache[r][c][1] = cache[r2][c2][1];
    };
    set(1, 1, bx, by);
    set(1, 2, bx + 1, by);
    set(2, 1, bx, by + 1);
    set(2, 2, bx + 1, by + 1);
    copy(3, 1, 2, 1);
    copy(3, 2, 2, 2);
    if (mb_y_ == 0 || intra_at(xy - mbw_)) {
      copy(0, 1, 1, 1);
      copy(0, 2, 1, 2);
    } else {
      set(0, 1, bx, by - 1);
      set(0, 2, bx + 1, by - 1);
    }
    if (mb_x_ == 0 || intra_at(xy - 1)) {
      copy(1, 0, 1, 1);
      copy(2, 0, 2, 1);
    } else {
      set(1, 0, bx - 1, by);
      set(2, 0, bx - 1, by + 1);
    }
    if (mb_x_ + 1 >= mbw_ || intra_at(xy + 1)) {
      copy(1, 3, 1, 2);
      copy(2, 3, 2, 2);
    } else {
      set(1, 3, bx + 2, by);
      set(2, 3, bx + 2, by + 1);
    }
    int sx = 0, sy = 0;
    for (int k = 0; k < 4; ++k) {
      const int c = (k & 1) + 1, r = (k >> 1) + 1;
      const int* mv[5] = {cache[r][c], cache[r - 1][c], cache[r][c - 1],
                          cache[r][c + 1], cache[r + 1][c]};
      uint8_t pred[5][64];
      const int x = mb_x_ * 16 + (k & 1) * 8, y = mb_y_ * 16 + (k >> 1) * 8;
      for (int i = 0; i < 5; ++i) {
        if (i && mv[i][0] == mv[0][0] && mv[i][1] == mv[0][1])
          std::memcpy(pred[i], pred[0], 64);
        else
          hpel8(x, y, mv[i][0], mv[i][1], op, pred[i], 8);
      }
      uint8_t* dst = cur_->y.at(x, y);
      for (int j = 0; j < 8; ++j)
        for (int i = 0; i < 8; ++i) {
          const int p = j * 8 + i, vert = kObmcVert[j][i];
          const int horz = kObmcHorz[j][i];
          const int s = kObmcMid[j][i] * pred[0][p] +
                        (j < 4 ? vert * pred[1][p] : vert * pred[4][p]) +
                        (i < 4 ? horz * pred[2][p] : horz * pred[3][p]);
          dst[j * cur_->y.w + i] = static_cast<uint8_t>((s + 4) >> 3);
        }
      sx += mv[0][0];
      sy += mv[0][1];
    }
    chroma_4mv(sx, sy, op);
  }

  // ------------------------------------------------------- Annex J

  // h263_h_loop_filter (vertical edge left of src; `step` 1) and
  // h263_v_loop_filter (horizontal edge above src; `step` the stride),
  // over 8 pixels.
  void edge(uint8_t* src, int step, int along, int q) {
    ++stats[kDeblockedEdges];
    const int strength = kStrength[q];
    for (int k = 0; k < 8; ++k) {
      uint8_t* s = src + k * along;
      const int p0 = s[-2 * step], p3 = s[step];
      int p1 = s[-step], p2 = s[0];
      const int d = (p0 - p3 + 4 * (p2 - p1)) / 8;
      int d1;
      if (d < -2 * strength) d1 = 0;
      else if (d < -strength) d1 = -2 * strength - d;
      else if (d < strength) d1 = d;
      else if (d < 2 * strength) d1 = 2 * strength - d;
      else d1 = 0;
      p1 += d1;
      p2 -= d1;
      if (p1 & 256) p1 = ~(p1 >> 31);
      if (p2 & 256) p2 = ~(p2 >> 31);
      s[-step] = static_cast<uint8_t>(p1);
      s[0] = static_cast<uint8_t>(p2);
      const int ad1 = std::abs(d1) >> 1;
      const int d2 = std::clamp((p0 - p3) / 4, -ad1, ad1);
      s[-2 * step] = static_cast<uint8_t>(p0 - d2);
      s[step] = static_cast<uint8_t>(p3 + d2);
    }
  }
  void hfilt(uint8_t* s, int stride, int q) { edge(s, 1, stride, q); }
  void vfilt(uint8_t* s, int stride, int q) { edge(s, stride, 1, q); }
  int chroma_q(int q) const { return mq_chroma_ ? kMqChroma[q] : q; }
  bool skip_at(int xy) const { return mb_type_[xy] == kSkip; }

  // ff_h263_loop_filter after each macroblock: its inner edges and those
  // above and left of it, each with the quantiser of a coded macroblock
  // beside it (the current one's first), in FFmpeg's order.
  void deblock() {
    const int xy = mb_y_ * mbw_ + mb_x_;
    const int ls = cur_->y.w, cs = cur_->u.w;
    uint8_t* y = cur_->y.at(mb_x_ * 16, mb_y_ * 16);
    uint8_t* cb = cur_->u.at(mb_x_ * 8, mb_y_ * 8);
    uint8_t* cr = cur_->v.at(mb_x_ * 8, mb_y_ * 8);
    int qp_c = 0;
    if (!skip_at(xy)) {
      qp_c = qscale_;
      vfilt(y + 8 * ls, ls, qp_c);
      vfilt(y + 8 * ls + 8, ls, qp_c);
    }
    if (mb_y_) {
      const int qp_tt = skip_at(xy - mbw_) ? 0 : qs_[xy - mbw_];
      const int qp_tc = qp_c ? qp_c : qp_tt;
      if (qp_tc) {
        const int cq = chroma_q(qp_tc);
        vfilt(y, ls, qp_tc);
        vfilt(y + 8, ls, qp_tc);
        vfilt(cb, cs, cq);
        vfilt(cr, cs, cq);
      }
      if (qp_tt) hfilt(y - 8 * ls + 8, ls, qp_tt);
      if (mb_x_) {
        const int qp_dt = qp_tt || skip_at(xy - 1 - mbw_)
                              ? qp_tt
                              : qs_[xy - 1 - mbw_];
        if (qp_dt) {
          const int cq = chroma_q(qp_dt);
          hfilt(y - 8 * ls, ls, qp_dt);
          hfilt(cb - 8 * cs, cs, cq);
          hfilt(cr - 8 * cs, cs, cq);
        }
      }
    }
    if (qp_c) {
      hfilt(y + 8, ls, qp_c);
      if (mb_y_ + 1 == mbh_) hfilt(y + 8 * ls + 8, ls, qp_c);
    }
    if (mb_x_) {
      const int qp_lc = qp_c || skip_at(xy - 1) ? qp_c : qs_[xy - 1];
      if (qp_lc) {
        hfilt(y, ls, qp_lc);
        if (mb_y_ + 1 == mbh_) {
          const int cq = chroma_q(qp_lc);
          hfilt(y + 8 * ls, ls, qp_lc);
          hfilt(cb, cs, cq);
          hfilt(cr, cs, cq);
        }
      }
    }
  }
};

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0)
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

// A decoder.  0: *out set.
int h263dec_open(void** out) {
  *out = new Decoder();
  return kFrame;
}

// Read Sorenson Spark (FLV1) pictures (1) or H.263 ones (0, the default).
void h263dec_set_sorenson(void* handle, int on) {
  static_cast<Decoder*>(handle)->sorenson = on != 0;
}

// Decode one picture.  0: its frame is given, *w and *h set; 1: no frame
// (a disposable Sorenson picture before any reference); 2: a tool it
// does not decode (msg names it); 3: no picture (a header that does not
// parse, a picture too short for its size; the reference stays).
int h263dec_decode(void* handle, const uint8_t* data, int64_t n, int* w,
                   int* h, char* msg, int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  try {
    Status st = d->decode(data, n);
    *w = d->width;
    *h = d->height;
    return st;
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    return e.status;
  }
}

// The frame last given as h*w*3 RGB bytes.  0: done; 4: cap too small or
// no frame.
int h263dec_rgb(void* handle, uint8_t* rgb, int64_t cap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->out || int64_t(d->width) * d->height * 3 > cap) return kSmall;
  const Picture& p = *d->out;
  swscale_rgb::to_rgb(p.y.px.data(), p.y.w, p.u.px.data(), p.v.px.data(),
                      p.u.w, d->width, d->height, rgb);
  return kFrame;
}

// The frame last given as I420 planes, cropped: y (h*w), u and v
// (h/2*w/2 each; H.263's sizes are multiples of 4).  0: done; 4: a cap
// too small or no frame.
int h263dec_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                   int64_t ycap, int64_t ccap) {
  Decoder* d = static_cast<Decoder*>(handle);
  const int w = d->width, h = d->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  if (!d->out || int64_t(w) * h > ycap || int64_t(cw) * ch > ccap)
    return kSmall;
  const Picture& p = *d->out;
  for (int j = 0; j < h; ++j)
    std::memcpy(y + int64_t(j) * w, p.y.at(0, j), w);
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + int64_t(j) * cw, p.u.at(0, j), cw);
    std::memcpy(v + int64_t(j) * cw, p.v.at(0, j), cw);
  }
  return kFrame;
}

// The first n of the stream's counts (the Stat order).  Returns how many
// there are.
int h263dec_stats(void* handle, int64_t* out, int n) {
  const Decoder* d = static_cast<const Decoder*>(handle);
  for (int i = 0; i < n && i < kNumStats; ++i) out[i] = d->stats[i];
  return kNumStats;
}

void h263dec_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
