// mpeg4 — an MPEG-4 Part 2 video decoder (Simple and Advanced Simple
// Profile, as FFmpeg's `mpeg4` encoder, OpenCV's `mp4v` and `XVID`
// writers, Xvid and DivX write them) with no library but the C++ standard
// library.
//
// It gives the pixels FFmpeg's decoder gives for such a stream, bit for bit:
//   - I-VOPs: MCBPC, ac_pred_flag, CBPY, DQUANT; intra DC by its own VLC or
//     as the first TCOEF (intra_dc_vlc_thr, judged on the quantiser before
//     DQUANT); the intra and inter TCOEF tables with their three escapes;
//     DC prediction (reconstructed DC values, 1024 outside the VOP and in
//     non-intra macroblocks) and AC prediction (quantised levels, the
//     predictor rescaled when the neighbour's quantiser differs, with
//     FFmpeg's ROUNDED_DIV); H.263 inverse quantisation, or MPEG's
//     (quant_type 1: the default matrices or those the VOL loads, FFmpeg's
//     mpeg2 unquantisers, mismatch control on inter blocks only);
//   - P-VOPs: not_coded skips, 1MV and INTER4V (a vector per 8x8 block,
//     each with its own median predictor, the chroma vector from their sum
//     by H.263's sixteenth table) with the first row of a slice
//     special-cased, the f_code range and its wrap; half-pel bilinear or
//     quarter-pel (MPEG-4's mirrored 8-tap filter) prediction under
//     vop_rounding_type, the chroma vector derived as FFmpeg derives it;
//     unrestricted vectors by edge replication of the macroblock-aligned
//     picture, with FFmpeg's tests for when a block needs it and its clip
//     of 8x8 sources to the VOL's size;
//   - B-VOPs: two references; modb, mb_type, cbpb, dbquant; direct mode
//     (the co-located vectors of the newer reference, 1MV or INTER4V,
//     scaled by TRB/TRD from vop_time_increment, modulo_time_base and the
//     GOV time code, plus a delta), forward, backward and interpolated
//     prediction (the rounded mean); a macroblock not coded in the newer
//     reference skipped (the older one's pixels); frames given in display
//     order with FFmpeg's one-frame delay and its end-of-stream flush; a
//     B-VOP out of order or without two references skipped, as FFmpeg
//     skips it;
//   - interlace (the VOL's interlaced bit; top_field_first and
//     alternate_vertical_scan_flag per VOP): field DCT (dct_type) in I-,
//     P- and B-VOPs, laid out as mpegvideo_dsp.h's dct_blocks; field
//     motion vectors in P-VOPs (field_prediction, the two reference field
//     selects, the vertical predictor halved, the frame predictor the
//     fields leave behind as ff_h263_update_motion_val leaves it) and
//     forward, backward and interpolated field prediction in B-VOPs (the
//     predictors kept per field); field direct mode where the co-located
//     macroblock was field-predicted (its field vectors scaled by the
//     field distances FFmpeg derives from TRD/TRB and t_frame, with
//     top_field_first; an interlaced B-VOP whose field distances do not
//     order is skipped, as FFmpeg skips it); the field prediction of
//     FFmpeg's mpeg_motion_internal and qpel_motion, edges emulated in
//     frame lines; the alternate vertical scan for every block;
//   - DivX's packed bitstream (user data `DivX...p`): the VOP a sample holds
//     after its own is decoded in place of the next sample (the N-VOP
//     placeholder), as FFmpeg's decoder does; without `p` the second VOP
//     of a sample is not decoded;
//   - video packets (resync markers) in I-, P- and B-VOPs: the packet
//     header's macroblock number, quantiser and header extension, and
//     FFmpeg's slice rules for DC, AC and motion vector prediction across
//     a packet's start;
//   - FFmpeg's "simple" IDCT (mpegvideo_dsp.h), or its Xvid IDCT (xvididct.c) for a stream it takes to be Xvid's:
//     one with `XviD` user data, or an Xvid fourcc and no encoder's user
//     data; and the other workarounds ff_mpeg4_workaround_bugs applies by
//     the build the user data names: FF_BUG_EDGE (edges at the VOL's
//     size), DC_CLIP, QPEL_CHROMA, QPEL_CHROMA2 and HPEL_CHROMA (DivX's
//     field chroma vectors);
//   - FFmpeg's x86 half-pel averages (mpegvideo_dsp.h), including the
//     inexact ones it uses for 8-wide blocks without rounding;
//   - data partitioning in I- and P-VOPs: each video packet's modes with
//     the DCs (I) or the motion vectors (P), the DC or motion marker,
//     ac_pred, CBPY and DQUANT (a P-VOP intra macroblock's DCs there),
//     then the texture; a packet that does not parse concealed from where
//     it broke, with the vectors it gave, up to the next packet whose
//     header parses, where decoding goes on;
//   - the crop of the macroblock-aligned picture to the VOL's size, and
//     YUV 4:2:0 -> RGB as OpenCV's FFmpeg backend returns it (swscale_rgb.h,
//     chroma sited left as FFmpeg reports it for MPEG-4).
// A tool it does not decode raises with the tool named: interlace in a
// stream tagged XVIX (FFmpeg's FF_BUG_XVID_ILACE), RVLC (which no
// encoder the tests hold it to writes), data partitioning together with
// interlace (FFmpeg's decoder reads neither dct_type nor the field bits
// of the partitions its encoder writes), sprites/GMC (S-VOPs), the short
// video header (which FFmpeg's mpeg4 decoder refuses too; h263.cpp reads
// such a stream where its container names it H.263), non-rectangular
// shapes, not_8_bit,
// scalability, newpred, reduced resolution, complexity estimation, OBMC,
// and quarter-pel from libavcodec builds before 4653 (its old filter).  A VOP with vop_coded 0 gives no
// frame, as in FFmpeg.  A VOP whose macroblocks are damaged or cut short
// gives a frame, as FFmpeg's concealment does: its macroblocks from the
// damage on are predicted from the references.  A sample without a VOP, or
// with a damaged VOP header, gives no frame and leaves the references as
// they were.
//
// The bit reader, the VLC machinery and H.263's tables are shared with
// h263.cpp (mpegvideo_bits.h).
//
// C ABI; Python binds it through ctypes (io/mpeg4.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libmpeg4dec.so mpeg4.cpp

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
  throw Error{kUnsupported,
              "MPEG-4 Part 2 " + tool + " is not decoded (Simple Profile "
              "without it only)"};
}

// dct_dc_size_luminance / _chrominance (Tables B-13, B-14).
const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                         {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                         {1, 9}, {1, 10}, {1, 11}};
const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                           {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                           {1, 10}, {1, 11}, {1, 12}};
// Intra TCOEF (Table B-16): entries ordered by last, run, level (the runs
// and levels follow from kIntraMaxLevel); the last entry (102) is the
// escape.  A sign bit follows each code.  The inter table is H.263's
// (mpegvideo_bits.h).
const Code kIntraTcoef[103] = {
    {2, 2}, {6, 3}, {15, 4}, {13, 5}, {12, 5}, {21, 6}, {19, 6}, {18, 6},
    {23, 7}, {31, 8}, {30, 8}, {29, 8}, {37, 9}, {36, 9}, {35, 9}, {33, 9},
    {33, 10}, {32, 10}, {15, 10}, {14, 10}, {7, 11}, {6, 11}, {32, 11},
    {33, 11}, {80, 12}, {81, 12}, {82, 12}, {14, 4}, {20, 6}, {22, 7},
    {28, 8}, {32, 9}, {31, 9}, {13, 10}, {34, 11}, {83, 12}, {85, 12},
    {11, 5}, {21, 7}, {30, 9}, {12, 10}, {86, 12}, {17, 6}, {27, 8},
    {29, 9}, {11, 10}, {16, 6}, {34, 9}, {10, 10}, {13, 6}, {28, 9},
    {8, 10}, {18, 7}, {27, 9}, {84, 12}, {20, 7}, {26, 9}, {87, 12},
    {25, 8}, {9, 10}, {24, 8}, {35, 11}, {23, 8}, {25, 9}, {24, 9},
    {7, 10}, {88, 12}, {7, 4}, {12, 6}, {22, 8}, {23, 9}, {6, 10},
    {5, 11}, {4, 11}, {89, 12}, {15, 6}, {22, 9}, {5, 10}, {14, 6},
    {4, 10}, {17, 7}, {36, 11}, {16, 7}, {37, 11}, {19, 7}, {90, 12},
    {21, 8}, {91, 12}, {20, 8}, {19, 8}, {26, 8}, {21, 9}, {20, 9},
    {19, 9}, {18, 9}, {17, 9}, {38, 11}, {39, 11}, {92, 12}, {93, 12},
    {94, 12}, {95, 12}, {3, 7}};
// LMAX by run (Tables B-19, B-20): last 0, then last 1.
const uint8_t kIntraMaxLevel[2][21] = {
    {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1},
    {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

// The MPEG-4 intra and H.263 VLC tables, and the scans (mpegvideo_bits.h).
struct Tables : Scans {
  Vlc intra_mcbpc{kIntraMcbpc, 9}, inter_mcbpc{kInterMcbpc, 28};
  Vlc cbpy{kCbpy, 16}, dc_lum{kDcLum, 13}, dc_chrom{kDcChrom, 13};
  Vlc mv{kMv, 33};
  RunLevel intra{kIntraTcoef, kIntraMaxLevel[0], 15, kIntraMaxLevel[1], 21};
  RunLevel inter{kInterTcoef, kInterMaxLevel[0], 27, kInterMaxLevel[1], 41};
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// FFmpeg's Xvid IDCT as its x86 build runs it (xvididct.asm,
// ff_xvid_idct_sse2; the C ff_xvid_idct gives the same but where noted):
// a row pass with a table and rounding constant per row, each output
// saturated to 16 bits, then a column pass of 16-bit tangent multiplies
// that keep the high half; the output is clamped (put) or added and
// clamped (add).  The C version leaves a row whose only coefficient is its
// first as it was when that row's output rounds to 0 (row 0 = {-4, 0,
// ...}); the SSE2 one zeroes it, as here.  Rows 3-7 that are all zero
// leave the column pass's 4- and 3-row forms, which equal the 8-row form
// on zeros.
namespace xvid {

constexpr int kRowShift = 11, kColShift = 6;
const uint32_t kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const uint32_t kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const uint32_t kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const uint32_t kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
const uint32_t* const kRowTab[8] = {kTab04, kTab17, kTab26, kTab35,
                                    kTab04, kTab35, kTab26, kTab17};
const int kRowRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

inline int16_t sh(uint32_t v) {  // psrad 11, packssdw
  return static_cast<int16_t>(
      std::clamp(static_cast<int32_t>(v) >> kRowShift, -32768, 32767));
}

void row(int16_t* in, const uint32_t* tab, int rnd) {
  const uint32_t c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3],
                 c5 = tab[4], c6 = tab[5], c7 = tab[6];
  const int right = in[5] | in[6] | in[7];
  const int left = in[1] | in[2] | in[3];
  if (!(right | in[4])) {
    const int k = static_cast<int>(c4 * in[0] + rnd);
    if (left) {
      const uint32_t a0 = k + c2 * in[2], a1 = k + c6 * in[2];
      const uint32_t a2 = k - c6 * in[2], a3 = k - c2 * in[2];
      const int b0 = static_cast<int>(c1 * in[1] + c3 * in[3]);
      const int b1 = static_cast<int>(c3 * in[1] - c7 * in[3]);
      const int b2 = static_cast<int>(c5 * in[1] - c1 * in[3]);
      const int b3 = static_cast<int>(c7 * in[1] - c5 * in[3]);
      in[0] = sh(a0 + b0);
      in[7] = sh(a0 - b0);
      in[1] = sh(a1 + b1);
      in[6] = sh(a1 - b1);
      in[2] = sh(a2 + b2);
      in[5] = sh(a2 - b2);
      in[3] = sh(a3 + b3);
      in[4] = sh(a3 - b3);
    } else {
      const int16_t a0 = sh(static_cast<uint32_t>(k));
      for (int i = 0; i < 8; ++i) in[i] = a0;
    }
  } else if (!(left | right)) {
    const int16_t a0 = sh(rnd + c4 * (in[0] + in[4]));
    const int16_t a1 = sh(rnd + c4 * (in[0] - in[4]));
    in[0] = in[3] = in[4] = in[7] = a0;
    in[1] = in[2] = in[5] = in[6] = a1;
  } else {
    const uint32_t k1 = c4 * in[0], k2 = c4 * in[4];
    const uint32_t a0 = k1 + c2 * in[2] + k2 + c6 * in[6] + rnd;
    const uint32_t a1 = k1 + c6 * in[2] - k2 - c2 * in[6] + rnd;
    const uint32_t a2 = k1 - c6 * in[2] - k2 + c2 * in[6] + rnd;
    const uint32_t a3 = k1 - c2 * in[2] + k2 - c6 * in[6] + rnd;
    const uint32_t b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
    const uint32_t b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
    const uint32_t b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
    const uint32_t b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
    in[0] = sh(a0 + b0);
    in[1] = sh(a1 + b1);
    in[2] = sh(a2 + b2);
    in[3] = sh(a3 + b3);
    in[4] = sh(a3 - b3);
    in[5] = sh(a2 - b2);
    in[6] = sh(a1 - b1);
    in[7] = sh(a0 - b0);
  }
}

constexpr uint32_t kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E,
                   kSqrt2 = 0x5A82;
inline int mult(uint32_t c, int x) {
  return static_cast<int32_t>(c * static_cast<uint32_t>(x)) >> 16;
}

void col(int16_t* in) {
  int mm0, mm1, mm2, mm3, mm4, mm5, mm6, mm7, t;
  mm4 = in[7 * 8];
  mm5 = in[5 * 8];
  mm6 = in[3 * 8];
  mm7 = in[1 * 8];
  mm0 = mult(kTan1, mm4) + mm7;
  mm1 = mult(kTan1, mm7) - mm4;
  mm2 = mult(kTan3, mm5) + mm6;
  mm3 = mult(kTan3, mm6) - mm5;
  mm7 = mm0 + mm2;
  mm4 = mm1 - mm3;
  mm0 = mm0 - mm2;
  mm1 = mm1 + mm3;
  mm6 = mm0 + mm1;
  mm5 = mm0 - mm1;
  mm5 = 2 * mult(kSqrt2, mm5);
  mm6 = 2 * mult(kSqrt2, mm6);
  mm1 = in[2 * 8];
  mm2 = in[6 * 8];
  mm3 = mult(kTan2, mm2) + mm1;
  mm2 = mult(kTan2, mm1) - mm2;
  mm0 = in[0] + in[4 * 8];
  mm1 = in[0] - in[4 * 8];
  auto butf = [&t](int& a, int& b) {
    t = a + b;
    b = a - b;
    a = t;
  };
  auto out = [](int v) { return static_cast<int16_t>(v >> kColShift); };
  butf(mm0, mm3);
  butf(mm0, mm7);
  in[8 * 0] = out(mm0);
  in[8 * 7] = out(mm7);
  butf(mm3, mm4);
  in[8 * 3] = out(mm3);
  in[8 * 4] = out(mm4);
  butf(mm1, mm2);
  butf(mm1, mm6);
  in[8 * 1] = out(mm1);
  in[8 * 6] = out(mm6);
  butf(mm2, mm5);
  in[8 * 2] = out(mm2);
  in[8 * 5] = out(mm5);
}

void idct(int16_t* block, uint8_t* dest, int stride, bool add) {
  for (int i = 0; i < 8; ++i) row(block + 8 * i, kRowTab[i], kRowRnd[i]);
  for (int i = 0; i < 8; ++i) col(block + i);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      uint8_t* d = dest + y * stride + x;
      *d = clip8(add ? *d + block[8 * y + x] : block[8 * y + x]);
    }
}

}  // namespace xvid


const uint8_t kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

// The default MPEG quantisation matrices (ISO/IEC 14496-2 6.3.3), raster
// order.
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

inline int y_dc_scale(int q) {
  return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
}
inline int c_dc_scale(int q) {
  return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6;
}
inline int rounded_div(int a, int b) {
  return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}
// MPEG-4's quarter-pel half-sample filter (-1, 3, -6, 20, 20, -6, 3, -1)/32
// over N outputs from N + 1 inputs s[0], s[step], ..., mirrored at both
// ends (FFmpeg's mpeg4_qpel*_h/v_lowpass); r = 16, or 15 without rounding.
template <int N>
inline void lowpass(const uint8_t* s, int step, int r, uint8_t* o,
                    int ostep) {
  int v[N + 7];
  for (int k = -3; k <= N + 3; ++k) {
    const int m = k < 0 ? -k - 1 : k > N ? 2 * N + 1 - k : k;
    v[k + 3] = s[m * step];
  }
  for (int i = 0; i < N; ++i) {
    const int a = v[i + 3] + v[i + 4], b = v[i + 2] + v[i + 5],
              c = v[i + 1] + v[i + 6], e = v[i] + v[i + 7];
    o[i * ostep] = clip8((20 * a - 6 * b + 3 * c - e + r) >> 5);
  }
}

// Quarter-pel prediction of an N x N block (N = 8 or 16) from the
// (N + 1) x (N + 1) window s, at dxy = (y quarter << 2) | x quarter, as
// FFmpeg's qpeldsp computes it: the horizontal position first (the
// filtered half sample, averaged with the nearer full one at a quarter),
// then the vertical one over those rows in the same way; the averages
// round unless the prediction does not.
template <int N>
void qpel(const uint8_t* s, int ss, int dxy, Op op, uint8_t* d, int ds) {
  const bool no_rnd = op == kPutNoRnd;
  const int r = no_rnd ? 15 : 16, ra = no_rnd ? 0 : 1;
  const int x = dxy & 3, y = dxy >> 2;
  uint8_t hh[(N + 1) * N], vv[N * N];
  const int rows = y ? N + 1 : N;
  for (int j = 0; j < rows; ++j) {
    const uint8_t* row = s + j * ss;
    uint8_t* h = hh + j * N;
    if (x == 0) {
      std::memcpy(h, row, N);
      continue;
    }
    lowpass<N>(row, 1, r, h, 1);
    if (x != 2) {
      const uint8_t* full = row + (x == 3);
      for (int i = 0; i < N; ++i) h[i] = (h[i] + full[i] + ra) >> 1;
    }
  }
  if (y == 0) {
    store(op, N, N, d, ds, [&](int i, int j) { return hh[j * N + i]; });
    return;
  }
  for (int i = 0; i < N; ++i) lowpass<N>(hh + i, N, r, vv + i, N);
  if (y == 2) {
    store(op, N, N, d, ds, [&](int i, int j) { return vv[j * N + i]; });
    return;
  }
  const uint8_t* near = hh + (y == 3 ? N : 0);
  store(op, N, N, d, ds, [&](int i, int j) {
    return (near[j * N + i] + vv[j * N + i] + ra) >> 1;
  });
}

inline uint32_t upper4(uint32_t tag) {
  uint32_t out = 0;
  for (int i = 0; i < 4; ++i) {
    uint32_t c = (tag >> (8 * i)) & 0xFF;
    if (c >= 'a' && c <= 'z') c -= 'a' - 'A';
    out |= c << (8 * i);
  }
  return out;
}

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | uint32_t(uint8_t(s[1])) << 8 |
         uint32_t(uint8_t(s[2])) << 16 | uint32_t(uint8_t(s[3])) << 24;
}

// FFmpeg's per-encoder workarounds (ff_mpeg4_workaround_bugs) that change
// the pixels of the tools decoded here.
enum Bug {
  kBugEdge = 1,             // edges replicated at the VOL's size
  kBugDcClip = 2,           // DC predictors above 2047 kept
  kBugQpelChroma = 4,       // quarter-pel chroma vector rounded up
  kBugQpelChroma2 = 8,      // ... by DivX 5.02+'s table
  kBugStdQpel = 16,         // libavcodec's old quarter-pel filter
  kBugHpelChroma = 32       // DivX: field chroma vectors rounded apart
};

constexpr int kMaxNvopSize = 19;  // FFmpeg's MAX_NVOP_SIZE

// ---------------------------------------------------------------- decoder

// What the stream has used so far (mpeg4dec_stats, in this order).
struct Stats {
  int64_t vops = 0, b_vops = 0, interlaced_vops = 0, alternate_scan_vops = 0,
          field_dct_mbs = 0, field_mc_mbs = 0, field_direct_mbs = 0,
          partitioned_packets = 0, concealed_vops = 0;
};

class Decoder {
 public:
  int width = 0, height = 0;  // the VOL's size
  const Picture* out = nullptr;  // the frame last given
  int64_t out_tag = -1;          // and the tag it goes by

  // `tag` is the container's fourcc (AVI strf, MP4 sample entry; little
  // endian), which FFmpeg upper-cases and reads to tell Xvid's streams.
  explicit Decoder(uint32_t tag) : tag_(upper4(tag)) {}

  // Headers (VOS/VO/VOL/GOV/user data) out of band.
  void headers(const uint8_t* data, int64_t n) {
    Bits b(data, n);
    parse(b, n, true, -1, nullptr);
  }

  // One sample: its headers, then its VOP (or, under DivX's packed
  // bitstream, the one the sample before held after its own).  kFrame
  // when a frame is given (`out`, in display order), else kNoFrame.
  Status decode(const uint8_t* data, int64_t n, int64_t tag) {
    skipped_last_ = false;
    last_tag_ = tag;
    std::vector<uint8_t> pending;
    pending.swap(pending_);
    const uint8_t* buf = data;
    int64_t len = n;
    bool from_pending = false;
    if (!pending.empty()) {
      // ff_mpeg4_decode_picture_header: the held VOP is decoded in place of
      // this sample (an N-VOP placeholder), unless a VOS starts it
      bool keep = true;
      if (divx_packed_)
        for (int64_t i = 0; i + 3 < n; ++i)
          if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
            keep = data[i + 3] != 0xB0;
            break;
          }
      if (keep && (divx_packed_ || n <= kMaxNvopSize)) {
        buf = pending.data();
        len = static_cast<int64_t>(pending.size());
        from_pending = true;
      }
    }
    Bits b(buf, len);
    int64_t vop_end = -1;
    Status st = parse(b, len, false, tag, &vop_end);
    if (vop_end >= 0 && divx_packed_)
      hold_packed(data, n, from_pending ? 0 : vop_end >> 3);
    return st;
  }

  // The end of the stream: the last reference, which the one-frame delay
  // of a stream with B-VOPs (or one that ended on a not-coded VOP) holds.
  Status flush() {
    if ((!low_delay_ || skipped_last_) && has_next_) {
      out = next_;
      out_tag = skipped_last_ ? last_tag_ : next_->tag;
      has_next_ = false;
      return kFrame;
    }
    return kNoFrame;
  }

 private:
  bool have_vol_ = false;
  int mbw_ = 0, mbh_ = 0;
  int time_bits_ = 1, time_res_ = 1;
  bool resync_ = false;
  bool partitioned_ = false;  // data_partitioned: I- and P-VOPs in partitions
  bool low_delay_ = true;
  bool quarter_ = false, mpeg_quant_ = false;
  bool interlaced_ = false;  // the VOL's interlaced (FFmpeg's
                             // !progressive_sequence)
  uint8_t intra_matrix_[64] = {}, inter_matrix_[64] = {};
  // the encoder, as FFmpeg tells it (decode_user_data,
  // ff_mpeg4_workaround_bugs); -1: not seen
  uint32_t tag_;
  int xvid_build_ = -1, divx_version_ = -1, divx_build_ = -1,
      lavc_build_ = -1;
  bool divx_packed_ = false;
  int vo_type_ = 0;
  bool vol_control_ = false;
  bool xvid_idct_ = false;
  int bugs_ = 0;
  int picture_number_ = 0;
  // the pictures: cur_ is decoded into; last_ and next_ are the older and
  // the newer reference (FFmpeg's last_pic and next_pic)
  Picture pic_[3];
  Picture* cur_ = &pic_[0];
  Picture* last_ = &pic_[1];
  Picture* next_ = &pic_[2];
  bool has_last_ = false, has_next_ = false;
  int edge_w_ = 0, edge_h_ = 0;  // FFmpeg's h_edge_pos, v_edge_pos
  // the DivX packed bitstream: the VOP a sample held after its own
  std::vector<uint8_t> pending_;
  bool skipped_last_ = false;
  int64_t last_tag_ = -1;
  // time (decode_vop_header): seconds, and ticks of vop_time_increment
  int64_t time_base_ = 0, last_time_base_ = 0, time_ = 0,
          last_non_b_time_ = 0;
  int pp_time_ = 0, pb_time_ = 0;
  // the video packet (slice) being decoded: its first macroblock, and
  // whether the current one lies in its first row of macroblocks
  int resync_x_ = 0, resync_y_ = 0;
  bool first_line_ = true;
  // per macroblock / block state of the I- or P-VOP being decoded, and,
  // once decoded, of next_ (the co-located macroblocks of B-VOPs)
  std::vector<int16_t> dc_y_, dc_u_, dc_v_;   // reconstructed DC
  std::vector<int16_t> ac_y_, ac_u_, ac_v_;   // 16 per block
  std::vector<int8_t> qs_;                    // quantiser per macroblock
  std::vector<int16_t> mv_;                   // (x, y) per 8x8 block
  std::vector<uint8_t> four_mv_, skipped_;    // per macroblock
  // per macroblock of the I- or P-VOP (and then of next_): field
  // predicted, its field vectors (field, x/y) and reference field selects
  std::vector<uint8_t> field_mb_;
  std::vector<int16_t> field_mv_;  // 4 per macroblock
  std::vector<uint8_t> field_sel_;  // 2 per macroblock
  // B-VOP motion vector predictors: forward/backward, field, x/y
  int last_mv_[2][2][2] = {};
  // VOP state
  int qscale_ = 1, rnd_ = 0, fcode_ = 1, bcode_ = 1, dc_thr_ = 99;
  bool ac_pred_ = false;
  bool tff_ = false, alt_scan_ = false, interlaced_dct_ = false;
  // the field distances of direct mode (FFmpeg's pp/pb_field_time, kept
  // in 16 bits as FFmpeg keeps them) and its t_frame
  uint16_t pp_field_time_ = 4, pb_field_time_ = 2;
  int t_frame_ = 0;

 public:
  Stats stats;

 private:

  static int64_t next_start_code(const Bits& b, int64_t p, int64_t n) {
    for (; p + 3 < n; ++p)
      if (b.byte(p) == 0 && b.byte(p + 1) == 0 && b.byte(p + 2) == 1)
        return p;
    return -1;
  }

  // The headers in b, then its first VOP (decoded; *vop_end set to the
  // bit after its macroblocks when a picture was decoded).
  Status parse(Bits& b, int64_t n, bool headers_only, int64_t tag,
               int64_t* vop_end) {
    int64_t p = 0;
    bool vol_seen = false;
    while ((p = next_start_code(b, p, n)) >= 0) {
      int code = b.byte(p + 3);
      b.seek((p + 4) * 8);
      if (code >= 0x20 && code <= 0x2F) {
        if (!vol_seen) parse_vol(b);  // FFmpeg ignores a second one
        vol_seen = true;
      } else if (code == 0xB2) {
        parse_user_data(b, p + 4, n);
      } else if (code == 0xB3) {
        parse_gov(b);
      } else if (code == 0xB6) {
        if (headers_only) break;
        return decode_vop(b, tag, vop_end);
      }
      p += 4;
    }
    if (headers_only) return kNoFrame;
    if (n >= 3 && b.byte(0) == 0 && b.byte(1) == 0 &&
        (b.byte(2) & 0xFC) == 0x80)
      unsupported("short video header (H.263 baseline in mp4v: FFmpeg's "
                  "mpeg4 decoder refuses it too; tagged s263 or H263 it is "
                  "read as H.263)");
    // A sample without a VOP is an error to FFmpeg, save a one-byte one
    // from DivX or Xvid (a skipped frame).
    if (!(n == 1 && (divx_version_ >= 0 || xvid_build_ >= 0)))
      corrupt("no VOP in the sample");
    return kNoFrame;
  }

  // ff_mpeg4_frame_end: under DivX's packed bitstream, the rest of the
  // sample from byte `pos` is held when its next VOP is an I- or B-VOP.
  void hold_packed(const uint8_t* data, int64_t n, int64_t pos) {
    if (n - pos <= 7) return;
    for (int64_t i = pos; i < n - 4; ++i)
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1 &&
          data[i + 3] == 0xB6) {
        if (!(data[i + 4] & 0x40)) pending_.assign(data + pos, data + n);
        return;
      }
  }

  // User data: up to 255 bytes before the next start code, matched as
  // FFmpeg's decode_user_data matches them.
  void parse_user_data(const Bits& b, int64_t p, int64_t n) {
    char buf[256];
    int i = 0;
    for (; i < 255 && p < n; ++i, ++p) {
      if (b.byte(p) == 0 && b.byte(p + 1) == 0 && b.byte(p + 2) < 2) break;
      buf[i] = static_cast<char>(b.byte(p));
    }
    buf[i] = 0;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0;
    char last;
    int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version_ = ver;
      divx_build_ = build;
      divx_packed_ = e == 3 && last == 'p';
    }
    e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver,
                      &ver2, &ver3, &build);
    if (e != 4) {
      e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1)
        build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build_ = 4600;
    if (e == 4) lavc_build_ = build;
    if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build_ = build;
  }

  // The GOV header's time code sets the time base (seconds).
  void parse_gov(Bits& b) {
    if (!b.peek(23)) return;
    int hours = b.get(5), minutes = b.get(6);
    b.skip(1);
    int seconds = b.get(6);
    time_base_ = seconds + 60 * (minutes + 60 * hours);
  }

  // ff_mpeg4_workaround_bugs, after each VOP header: the encoder from the
  // fourcc when no user data names it, then the workarounds its build
  // needs and the IDCT (Xvid's for an Xvid stream; once chosen it stays).
  // xvid_build <= 3 and DivX 5.01 build 20020416 also set FFmpeg's
  // padding-bug score, which only decides how a VOP whose end does not
  // parse is concealed: this decoder conceals such a VOP its own way.
  // FF_BUG_DIRECT_BLOCKSIZE (DivX, libavcodec before build 4655) is set
  // too, but FFmpeg's direct mode reads the caller's flags, not these,
  // so it never applies (OpenCV sets none).
  void workaround_bugs() {
    if (xvid_build_ == -1 && divx_version_ == -1 && lavc_build_ == -1) {
      if (tag_ == fourcc("XVID") || tag_ == fourcc("XVIX") ||
          tag_ == fourcc("RMP4") || tag_ == fourcc("ZMP4") ||
          tag_ == fourcc("SIPP"))
        xvid_build_ = 0;
      else if (tag_ == fourcc("DIVX") && vo_type_ == 0 && !vol_control_)
        divx_version_ = 400;
    }
    if (xvid_build_ >= 0 && divx_version_ >= 0)
      divx_version_ = divx_build_ = -1;
    auto u = [](int v) { return static_cast<unsigned>(v); };
    if (divx_version_ >= 500 && divx_build_ < 1814) bugs_ |= kBugQpelChroma;
    if (divx_version_ > 502 && divx_build_ < 1814) bugs_ |= kBugQpelChroma2;
    if (u(xvid_build_) <= 1) bugs_ |= kBugQpelChroma;
    if (u(xvid_build_) <= 12) bugs_ |= kBugEdge;
    if (u(xvid_build_) <= 32) bugs_ |= kBugDcClip;
    if (u(lavc_build_) < 4653) bugs_ |= kBugStdQpel;
    if (u(lavc_build_) < 4670) bugs_ |= kBugEdge;
    if (u(lavc_build_) <= 4712) bugs_ |= kBugDcClip;
    if (u(divx_version_) < 500) bugs_ |= kBugEdge;
    if (divx_version_ >= 0) bugs_ |= kBugHpelChroma;
    if (xvid_build_ >= 0) xvid_idct_ = true;
  }

  void idct(int16_t* block, uint8_t* dest, int stride, bool add) const {
    if (xvid_idct_)
      xvid::idct(block, dest, stride, add);
    else
      simple_idct(block, dest, stride, add);
  }

  // A quantisation matrix sent in the VOL: up to 64 values in zigzag
  // order, a 0 ending it early and the last value repeated after it.
  void load_matrix(Bits& b, uint8_t* m) {
    const uint8_t* zz = tables().zigzag;
    int i = 0, last = 0;
    for (; i < 64; ++i) {
      int v = b.get(8);
      if (v == 0) break;
      m[zz[i]] = static_cast<uint8_t>(last = v);
    }
    for (; i < 64; ++i) m[zz[i]] = static_cast<uint8_t>(last);
  }

  void parse_vol(Bits& b) {
    t_frame_ = 0;  // direct mode's field distances start again
    b.skip(1);  // random_accessible_vol
    int type = b.get(8);
    if (type == 0x12) unsupported("fine granularity scalability");
    vo_type_ = type;
    int verid = 1;
    if (b.get1()) {  // is_object_layer_identifier
      verid = b.get(4);
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // extended pixel aspect ratio
    vol_control_ = b.get1();
    if (vol_control_) {
      if (b.get(2) != 1) unsupported("chroma format other than 4:2:0");
      low_delay_ = b.get1();
      if (b.get1()) {  // vbv_parameters
        b.skip(15); b.marker("VOL"); b.skip(15); b.marker("VOL");
        b.skip(15); b.marker("VOL"); b.skip(3); b.skip(11);
        b.marker("VOL"); b.skip(15); b.marker("VOL");
      }
    } else if (picture_number_ == 0) {
      // low_delay is 1 only for the Simple and Advanced Simple types
      low_delay_ = type == 1 || type == 17;
    }
    if (b.get(2) != 0) unsupported("non-rectangular shape");
    b.marker("VOL");
    time_res_ = b.get(16);
    if (time_res_ == 0) corrupt("vop_time_increment_resolution 0");
    b.marker("VOL");
    time_bits_ = 1;
    while ((1 << time_bits_) < time_res_) ++time_bits_;
    if (b.get1()) b.skip(time_bits_);  // fixed_vop_rate
    b.marker("VOL");
    int w = b.get(13);
    b.marker("VOL");
    int h = b.get(13);
    b.marker("VOL");
    interlaced_ = b.get1();
    if (!b.get1()) unsupported("OBMC (obmc_disable 0)");
    if (b.get(verid == 1 ? 1 : 2)) unsupported("sprites/GMC");
    if (b.get1()) unsupported("not_8_bit");
    mpeg_quant_ = b.get1();
    if (mpeg_quant_) {
      std::memcpy(intra_matrix_, kDefaultIntraMatrix, 64);
      std::memcpy(inter_matrix_, kDefaultInterMatrix, 64);
      if (b.get1()) load_matrix(b, intra_matrix_);
      if (b.get1()) load_matrix(b, inter_matrix_);
    }
    quarter_ = verid != 1 && b.get1();
    if (!b.get1()) unsupported("complexity estimation header");
    resync_ = !b.get1();
    partitioned_ = b.get1();
    if (partitioned_ && b.get1())
      unsupported("RVLC (reversible_vlc 1: no encoder this decoder is held "
                  "to writes it)");
    if (verid != 1) {
      if (b.get1()) unsupported("newpred");
      if (b.get1()) unsupported("reduced-resolution VOPs");
    }
    if (b.get1()) unsupported("scalability");
    if (b.overrun()) corrupt("VOL cut short");
    if (w <= 0 || h <= 0) corrupt("VOL size 0");
    if (!have_vol_ || w != width || h != height) {
      width = w;
      height = h;
      mbw_ = (w + 15) / 16;
      mbh_ = (h + 15) / 16;
      for (Picture& p : pic_) p.init(mbw_, mbh_);
      has_last_ = has_next_ = false;
      out = nullptr;
      edge_w_ = mbw_ * 16;
      edge_h_ = mbh_ * 16;
      reset_state();
    }
    have_vol_ = true;
  }

  Status decode_vop(Bits& b, int64_t tag, int64_t* vop_end) {
    if (!have_vol_) corrupt("VOP before any VOL header");
    const int type = b.get(2);
    if (type == 3) unsupported("sprites/GMC (S-VOP)");
    if (type == 2 && low_delay_ && !vol_control_) low_delay_ = false;
    int incr = 0;
    while (b.get1()) {
      ++incr;
      if (b.overrun()) corrupt("modulo_time_base runs past the end");
    }
    b.marker("VOP");
    const int64_t ticks = b.get(time_bits_);
    // TRD and TRB (pp_time, pb_time), as FFmpeg counts them
    if (type != 2) {
      last_time_base_ = time_base_;
      time_base_ += incr;
      time_ = time_base_ * time_res_ + ticks;
      pp_time_ = static_cast<int>(time_ - last_non_b_time_);
      last_non_b_time_ = time_;
    } else {
      time_ = (last_time_base_ + incr) * time_res_ + ticks;
      pb_time_ = static_cast<int>(pp_time_ - (last_non_b_time_ - time_));
      if (pp_time_ <= pb_time_ || pp_time_ <= pp_time_ - pb_time_ ||
          pp_time_ <= 0)
        return kNoFrame;  // out of order: FFmpeg skips the B-VOP
      if (!field_times() && interlaced_) return kNoFrame;  // FFmpeg skips it
    }
    b.marker("VOP");
    if (!b.get1()) {  // vop_coded 0
      skipped_last_ = true;
      return kNoFrame;
    }
    rnd_ = type == 1 ? b.get1() : 0;
    dc_thr_ = kDcThreshold[b.get(3)];
    tff_ = interlaced_ && b.get1();
    alt_scan_ = interlaced_ && b.get1();
    qscale_ = b.get(5);
    if (qscale_ == 0) corrupt("vop_quant 0");
    fcode_ = type != 0 ? b.get(3) : 1;
    if (fcode_ == 0) corrupt("vop_fcode_forward 0");
    bcode_ = type == 2 ? b.get(3) : 1;
    if (bcode_ == 0) corrupt("vop_fcode_backward 0");
    if (b.overrun()) corrupt("VOP header cut short");
    // divx4/old Xvid/OpenDivX streams that leave low_delay 0
    if (vo_type_ == 0 && !vol_control_ && divx_version_ == -1 &&
        picture_number_ == 0)
      low_delay_ = true;
    ++picture_number_;
    if (bugs_ & kBugEdge) {  // set by the VOPs before this one
      edge_w_ = width;
      edge_h_ = height;
    }
    workaround_bugs();
    if (interlaced_ && tag_ == fourcc("XVIX"))
      unsupported("interlace tagged XVIX (FFmpeg's FF_BUG_XVID_ILACE: "
                  "dct_type on uncoded macroblocks too)");
    if (quarter_ && (bugs_ & kBugStdQpel))
      unsupported("quarter-pel of libavcodec builds before 4653 (the old "
                  "filter FFmpeg applies as FF_BUG_STD_QPEL)");
    if (type == 1 && !has_next_) corrupt("P-VOP without a reference");
    if (type == 2 && !has_last_) return kNoFrame;  // FFmpeg skips it
    cur_->tag = tag;
    ++stats.vops;
    stats.b_vops += type == 2;
    stats.interlaced_vops += interlaced_;
    stats.alternate_scan_vops += alt_scan_;
    if (type == 2) {
      decode_b(b);
    } else if (partitioned_) {
      if (interlaced_)
        unsupported("data partitioning with interlace (FFmpeg's decoder "
                    "reads neither dct_type nor the field bits of the "
                    "partitions its encoder writes)");
      if (dc_thr_ != 99)
        unsupported("data partitioning with intra_dc_vlc_thr " +
                    std::to_string(dc_thr_));
      decode_partitioned(b, type);
    } else {
      decode_ip(b, type);
    }
    *vop_end = b.pos();
    if (type == 2) {
      out = cur_;
      out_tag = tag;
      return kFrame;
    }
    Picture* free = last_;
    last_ = next_;
    has_last_ = has_next_;
    next_ = cur_;
    has_next_ = true;
    cur_ = free;
    // FFmpeg's one-frame delay unless low_delay: a reference is given
    // once the next one is decoded
    if (low_delay_ || has_last_) {
      out = low_delay_ ? next_ : last_;
      out_tag = out->tag;
      return kFrame;
    }
    return kNoFrame;
  }

  // FFmpeg's field distances for direct mode (decode_vop_header): TRD and
  // TRB in units of t_frame (the TRB of the first B-VOP since the last VOL
  // header), rounded, doubled.
  // False, and FFmpeg's stand-ins 4 and 2, when they do not order.
  bool field_times() {
    if (t_frame_ == 0) t_frame_ = pb_time_;
    if (t_frame_ == 0) t_frame_ = 1;
    auto rdiv = [](int64_t a, int64_t b) {
      return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
    };
    const int64_t base = rdiv(last_non_b_time_ - pp_time_, t_frame_);
    pp_field_time_ =
        static_cast<uint16_t>((rdiv(last_non_b_time_, t_frame_) - base) * 2);
    pb_field_time_ = static_cast<uint16_t>((rdiv(time_, t_frame_) - base) * 2);
    if (pp_field_time_ <= pb_field_time_ || pb_field_time_ <= 1) {
      pb_field_time_ = 2;
      pp_field_time_ = 4;
      return false;
    }
    return true;
  }

  void decode_ip(Bits& b, int type) {
    reset_state();
    resync_x_ = resync_y_ = 0;
    first_line_ = true;
    int mx = 0, my = 0;
    try {
      for (; my < mbh_; ++my, mx = 0) {
        for (; mx < mbw_; ++mx) {
          if (resync_ && (mx || my)) video_packet(b, type, mx, my);
          if (mx == resync_x_ && my == resync_y_ + 1) first_line_ = false;
          if (type == 0)
            intra_mb(b, mx, my, false);
          else
            p_mb(b, mx, my);
          if (b.overrun()) corrupt("VOP cut short");
        }
      }
    } catch (const Error& e) {
      if (e.status != kCorrupt) throw;
      ++stats.concealed_vops;
      conceal(mx, my, false);
    }
  }

  void decode_b(Bits& b) {
    resync_x_ = resync_y_ = 0;
    std::memset(last_mv_, 0, sizeof(last_mv_));
    int mx = 0, my = 0;
    try {
      for (; my < mbh_; ++my, mx = 0) {
        for (; mx < mbw_; ++mx) {
          if (resync_ && (mx || my)) video_packet(b, 2, mx, my);
          if (mx == 0) std::memset(last_mv_, 0, sizeof(last_mv_));
          b_mb(b, mx, my);
          if (b.overrun()) corrupt("VOP cut short");
        }
      }
    } catch (const Error& e) {
      if (e.status != kCorrupt) throw;
      ++stats.concealed_vops;
      conceal(mx, my, true);
    }
  }

  // A VOP damaged from macroblock (mx, my) on, whose header was read: FFmpeg
  // conceals the damage and gives the frame; here the macroblocks from
  // there on are the newer reference's (grey without one), or, in a B-VOP,
  // predicted in direct mode with no delta.
  void conceal(int mx, int my, bool b_vop) {
    for (; my < mbh_; ++my, mx = 0)
      for (; mx < mbw_; ++mx) conceal_mb(mx, my, b_vop);
  }

  void conceal_mb(int mx, int my, bool b_vop) {
    if (b_vop && field_mb_[size_t(my) * mbw_ + mx]) {
      // FFmpeg's error concealment predicts a B-VOP macroblock from the
      // co-located macroblock's frame vector, field-predicted or not
      const int16_t* p = mv_at(2 * mx, 2 * my);
      mc16(*last_, mx, my, p[0] * pb_time_ / pp_time_,
           p[1] * pb_time_ / pp_time_, kPut);
      mc16(*next_, mx, my, p[0] * (pb_time_ - pp_time_) / pp_time_,
           p[1] * (pb_time_ - pp_time_) / pp_time_, kAvg);
    } else if (b_vop) {
      direct_mb(mx, my, 0, 0);
    } else if (has_next_) {
      copy_mb(*next_, mx, my);
    } else {
      for (int j = 0; j < 16; ++j)
        std::memset(cur_->y.at(mx * 16, my * 16 + j), 128, 16);
      for (int j = 0; j < 8; ++j) {
        std::memset(cur_->u.at(mx * 8, my * 8 + j), 128, 8);
        std::memset(cur_->v.at(mx * 8, my * 8 + j), 128, 8);
      }
    }
  }

  // ------------------------------------------------- data partitioning

  // What a partitioned packet's first two partitions say of a macroblock.
  enum PartKind : uint8_t { kSkip, kInter, kInter4v, kIntra };
  struct PartMb {
    uint8_t kind = kSkip, cbp = 0, dquant = 0, ac_pred = 0, dirs = 0;
  };
  std::vector<PartMb> part_;
  static constexpr uint32_t kDcMarker = 0x6B001, kMotionMarker = 0x1F001;

  // A data-partitioned I- or P-VOP (FFmpeg's ff_mpeg4_decode_partitions
  // and mpeg4_decode_partitioned_mb): each video packet holds, for its
  // macroblocks, their modes with the DCs (I) or the motion vectors (P),
  // a DC or motion marker, then ac_pred, CBPY and DQUANT (and a P-VOP's
  // intra DCs), then their texture.  A packet that does not parse is
  // concealed from the macroblock where its texture broke (from its first
  // where its first two partitions did): an inter macroblock whose vectors
  // were read is predicted by them, the others as conceal_mb conceals
  // them, up to the next packet whose header parses (found as FFmpeg's
  // ff_h263_resync finds it), where decoding goes on.
  void decode_partitioned(Bits& b, int type) {
    reset_state();
    part_.assign(size_t(mbw_) * mbh_, PartMb());
    const int nmb = mbw_ * mbh_;
    resync_x_ = resync_y_ = 0;
    bool concealed = false;
    for (int at = 0; at < nmb;) {
      const int64_t start = b.pos();
      const int q0 = qscale_;
      int count = 0, parsed = 0, done = 0;
      bool ok = false;
      try {
        count = partition_a(b, type, at, &parsed);
        if (at + count > nmb) corrupt("video packet past the VOP");
        partition_b(b, type, at, count);
        set_qscale(q0);
        texture(b, at, count, &done);
        ++stats.partitioned_packets;
        ok = true;
      } catch (const Error& e) {
        if (e.status != kCorrupt) throw;
      }
      int next = nmb;
      if (ok && at + count < nmb) {
        next = packet_here(b, type, at + count);
        // a texture that does not end at the next packet's header was
        // misread: the packet is re-rendered from its first partitions
        if (next != at + count) ok = false, done = 0;
      }
      const int from = at + (ok ? count : done);
      if (!ok) next = find_packet(b, type, start, at);
      if (from < next) concealed = true;
      for (int k = from; k < next; ++k) {
        const int mx = k % mbw_, my = k / mbw_;
        const PartMb& m = part_[k];
        if (k < at + parsed && type == 1 && m.kind != kIntra)
          predict_inter(mx, my, m.kind);
        else
          conceal_mb(mx, my, false);
      }
      at = next;
    }
    stats.concealed_vops += concealed;
  }

  // The packet header that should follow a packet at b (byte-alignment
  // stuffing, then a resync marker for macroblock `want`): `want` with b
  // past the header, else -1.
  int packet_here(Bits& b, int type, int want) {
    try {
      const int64_t p = b.pos();
      const int n = 8 - static_cast<int>(p & 7);
      if (b.peek(n) != (1u << (n - 1)) - 1) return -1;
      b.skip(n);
      if (resync_marker(b, type) != want) return -1;
      packet_header(b, type, want % mbw_, want / mbw_);
      return want;
    } catch (const Error& e) {
      if (e.status != kCorrupt) throw;
      return -1;
    }
  }

  // The next packet after the one whose data starts at bit `start` and
  // macroblock `at`: each byte from there on where 16 zero bits begin a
  // packet header that parses, for a macroblock after `at` (b then past
  // it); the VOP's macroblock count when none does.
  int find_packet(Bits& b, int type, int64_t start, int at) {
    const int nmb = mbw_ * mbh_;
    for (int64_t p = (start + 7) & ~int64_t(7); b.seek(p), b.left() > 27;
         p += 8) {
      if (b.peek(16)) continue;
      try {
        const int m = resync_marker(b, type);
        if (m > at && m < nmb) {
          packet_header(b, type, m % mbw_, m / mbw_);
          return m;
        }
      } catch (const Error& e) {
        if (e.status != kCorrupt) throw;
      }
    }
    return nmb;
  }

  // The first partition from macroblock `at` up to its marker: the count
  // of macroblocks (*parsed: those read whole).
  int partition_a(Bits& b, int type, int at, int* parsed) {
    const Tables& t = tables();
    first_line_ = true;
    int k = at;
    for (; k < mbw_ * mbh_; ++k) {
      const int mx = k % mbw_, my = k / mbw_;
      if (mx == resync_x_ && my == resync_y_ + 1) first_line_ = false;
      PartMb& m = part_[k];
      int cbpc;
      if (type == 0) {
        do {
          if (b.peek(19) == kDcMarker) return k - at;
          cbpc = t.intra_mcbpc.read(b, "MCBPC");
          if (b.overrun()) corrupt("stuffing runs past the end");
        } while (cbpc == 8);
        m.kind = kIntra;
        m.cbp = static_cast<uint8_t>(cbpc & 3);
        if (cbpc & 4) set_qscale(qscale_ + kDquant[b.get(2)]);
        qs_[k] = static_cast<int8_t>(qscale_);
        m.dirs = partition_dcs(b, mx, my);
      } else {
        for (;;) {
          if (b.peek(17) == kMotionMarker) return k - at;
          if (b.get1()) {
            cbpc = -1;  // not coded
            break;
          }
          cbpc = t.inter_mcbpc.read(b, "MCBPC");
          if (cbpc != 20) break;
          if (b.overrun()) corrupt("stuffing runs past the end");
        }
        if (cbpc < 0) {
          m.kind = kSkip;
          skipped_[k] = 1;
        } else {
          m.cbp = static_cast<uint8_t>(cbpc & 3);
          m.dquant = (cbpc & 8) != 0;
          if (cbpc & 4) {
            m.kind = kIntra;
          } else if (!(cbpc & 16)) {
            m.kind = kInter;
            int px, py;
            pred_motion(mx, my, 0, &px, &py);
            const int vx = motion(b, px, fcode_), vy = motion(b, py, fcode_);
            set_mb_mv(mx, my, vx, vy);
          } else {
            m.kind = kInter4v;
            four_mv_[k] = 1;
            for (int i = 0; i < 4; ++i) {
              int px, py;
              pred_motion(mx, my, i, &px, &py);
              int16_t* v = mv_at(2 * mx + (i & 1), 2 * my + (i >> 1));
              const int vx = motion(b, px, fcode_);
              v[0] = static_cast<int16_t>(vx);
              v[1] = static_cast<int16_t>(motion(b, py, fcode_));
            }
          }
        }
      }
      if (b.overrun()) corrupt("VOP cut short");
      *parsed = k - at + 1;
    }
    return k - at;
  }

  // An intra macroblock's six DCs (mpeg4_decode_dc), predicted and stored
  // as the unpartitioned syntax stores them; their prediction directions
  // (block 0 in bit 5).
  uint8_t partition_dcs(Bits& b, int mx, int my) {
    int dirs = 0;
    for (int n = 0; n < 6; ++n) {
      int dir;
      if (pred_dc(mx, my, n, dc_diff(b, n), &dir) < 0)
        corrupt("DC corrupted");
      dirs = (dirs << 1) | dir;
    }
    return static_cast<uint8_t>(dirs);
  }

  // The marker after the first partition, then the second: ac_pred and
  // CBPY, DQUANT in P-VOPs (with a P-VOP intra macroblock's DCs).
  void partition_b(Bits& b, int type, int at, int count) {
    const Tables& t = tables();
    if (type == 0) {
      while (b.peek(9) == 1) b.skip(9);
      if (b.get(19) != kDcMarker) corrupt("DC marker missing");
    } else {
      while (b.peek(10) == 1) b.skip(10);
      if (b.get(17) != kMotionMarker) corrupt("motion marker missing");
    }
    first_line_ = true;
    for (int k = at; k < at + count; ++k) {
      const int mx = k % mbw_, my = k / mbw_;
      if (mx == resync_x_ && my == resync_y_ + 1) first_line_ = false;
      PartMb& m = part_[k];
      if (m.kind == kIntra) {
        m.ac_pred = static_cast<uint8_t>(b.get1());
        const int cbpy = t.cbpy.read(b, "CBPY");
        if (type == 1) {
          if (m.dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
          qs_[k] = static_cast<int8_t>(qscale_);
          m.dirs = partition_dcs(b, mx, my);
        }
        m.cbp = static_cast<uint8_t>(m.cbp | (cbpy << 2));
      } else if (m.kind == kSkip) {
        qs_[k] = static_cast<int8_t>(qscale_);
      } else {
        const int cbpy = t.cbpy.read(b, "CBPY") ^ 15;
        if (m.dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
        qs_[k] = static_cast<int8_t>(qscale_);
        m.cbp = static_cast<uint8_t>(m.cbp | (cbpy << 2));
      }
      if (b.overrun()) corrupt("VOP cut short");
    }
  }

  // The third partition: each macroblock's blocks, reconstructed (*done:
  // the macroblocks finished).
  void texture(Bits& b, int at, int count, int* done) {
    first_line_ = true;
    for (int k = at; k < at + count; ++k) {
      const int mx = k % mbw_, my = k / mbw_;
      if (mx == resync_x_ && my == resync_y_ + 1) first_line_ = false;
      const PartMb& m = part_[k];
      const bool dc_vlc = qscale_ < dc_thr_;
      set_qscale(qs_[k]);
      if (m.kind == kIntra) {
        ac_pred_ = m.ac_pred != 0;
        intra_blocks(b, mx, my, m.cbp, dc_vlc, m.dirs);
      } else {
        predict_inter(mx, my, m.kind);
        if (m.kind != kSkip) residual(b, mx, my, m.cbp);
      }
      if (b.overrun()) corrupt("VOP cut short");
      *done = k - at + 1;
    }
  }

  // A P-VOP macroblock predicted by the vectors its first partition gave.
  void predict_inter(int mx, int my, int kind) {
    const Op op = rnd_ ? kPutNoRnd : kPut;
    const int16_t* v = mv_at(2 * mx, 2 * my);
    if (kind == kInter4v) {
      int mv[4][2];
      for (int k = 0; k < 4; ++k) {
        const int16_t* q = mv_at(2 * mx + (k & 1), 2 * my + (k >> 1));
        mv[k][0] = q[0];
        mv[k][1] = q[1];
      }
      mc8x8(*next_, mx, my, mv, op);
    } else {
      mc16(*next_, mx, my, v[0], v[1], kind == kSkip ? kPut : op);
    }
  }

  // Every block's DC and AC predictors start at 1024 and 0: what a
  // non-intra macroblock, which never writes them, leaves for its
  // neighbours.
  void reset_state() {
    size_t nb = size_t(mbw_) * mbh_;
    dc_y_.assign(nb * 4, 1024);
    dc_u_.assign(nb, 1024);
    dc_v_.assign(nb, 1024);
    ac_y_.assign(nb * 4 * 16, 0);
    ac_u_.assign(nb * 16, 0);
    ac_v_.assign(nb * 16, 0);
    qs_.assign(nb, 0);
    mv_.assign(nb * 4 * 2, 0);
    four_mv_.assign(nb, 0);
    skipped_.assign(nb, 0);
    field_mb_.assign(nb, 0);
    field_mv_.assign(nb * 4, 0);
    field_sel_.assign(nb * 2, 0);
  }

  // A video packet starting at macroblock (mx, my): MCBPC stuffing (I- and
  // P-VOPs), the byte-alignment stuffing, then a resync marker (16 zeros
  // for an I-VOP, 15 + vop_fcode for a P-VOP, 15 + the larger of the two
  // fcodes and 2 for a B-VOP, then a one) and the packet header:
  // macroblock_number, quant_scale and header_extension_code with the
  // fields it repeats (read past, as FFmpeg's
  // ff_mpeg4_decode_video_packet_header does).  The packet starts a slice:
  // DC, AC and motion vector prediction do not reach across it (the
  // slice's first row; ff_mpeg4_clean_buffers).  A B-VOP's skipped
  // macroblocks take no bits, so a packet may start at a later one.
  void video_packet(Bits& b, int type, int mx, int my) {
    if (type != 2 && !partitioned_) {
      const int stuffing = type == 0 ? 9 : 10;
      while (b.peek(stuffing) == 1) b.skip(stuffing);
    }
    int64_t p = b.pos();
    int n = 8 - static_cast<int>(p & 7);
    if (b.peek(n) != (1u << (n - 1)) - 1) return;
    b.skip(n);
    const int here = my * mbw_ + mx;
    const int at = resync_marker(b, type);
    if (at < 0) {
      b.seek(p);
      return;
    }
    if (at != here) {
      if (type == 2 && at > here && skipped_[here]) {
        b.seek(p);
        return;
      }
      corrupt("video packet does not start at the next macroblock");
    }
    packet_header(b, type, mx, my);
  }

  // A resync marker at b (byte-aligned): its macroblock_number, or -1 (b
  // unmoved) where fewer zeros than the VOP's prefix come first.
  int resync_marker(Bits& b, int type) {
    const int64_t p = b.pos();
    int zeros = 0;
    while (zeros < 32 && !b.get1()) ++zeros;
    const int prefix = type == 0   ? 16
                       : type == 1 ? 15 + fcode_
                                   : 15 + std::max({fcode_, bcode_, 2});
    if (zeros < prefix || b.overrun()) {
      b.seek(p);
      return -1;
    }
    if (zeros != prefix) corrupt("resync marker does not match vop_fcode");
    int mb_num = mbw_ * mbh_, bits = 1;
    while ((1 << bits) < mb_num) ++bits;
    return static_cast<int>(b.get(bits));
  }

  // The rest of a video packet header (after macroblock_number), whose
  // packet starts at macroblock (mx, my).
  void packet_header(Bits& b, int type, int mx, int my) {
    int q = b.get(5);
    if (q) qscale_ = q;
    if (b.get1()) {  // header_extension_code
      while (b.get1()) {
        if (b.overrun()) corrupt("modulo_time_base runs past the end");
      }
      b.marker("video packet header");
      b.skip(time_bits_);
      b.marker("video packet header");
      // type, dc threshold, fcodes
      b.skip(2 + 3 + (type != 0 ? 3 : 0) + (type == 2 ? 3 : 0));
    }
    if (b.overrun()) corrupt("video packet header cut short");
    resync_x_ = mx;
    resync_y_ = my;
    first_line_ = true;
    // ff_mpeg4_clean_buffers clears the first field's predictors only
    for (auto& d : last_mv_) d[0][0] = d[0][1] = 0;
    if (type != 2) clean_ac(mx, my);
  }

  // ff_mpeg4_clean_buffers: the AC predictors of the blocks before the
  // packet that its first macroblocks would read.  FFmpeg clears a run of
  // its bordered arrays; these are the blocks of that run inside the
  // picture.
  void clean_ac(int mx, int my) {
    auto clear = [](std::vector<int16_t>& v, int gw, int row, int c0,
                    int c1) {
      if (row < 0) return;
      for (int c = std::max(c0, 0); c <= std::min(c1, gw - 1); ++c)
        std::fill_n(&v[(size_t(row) * gw + c) * 16], 16, int16_t(0));
    };
    const int lw = 2 * mbw_;
    clear(ac_y_, lw, 2 * my - 1, 2 * mx - 1, lw - 1);
    clear(ac_y_, lw, 2 * my, 0, lw - 1);
    clear(ac_y_, lw, 2 * my + 1, 0, 2 * mx - 1);
    for (std::vector<int16_t>* v : {&ac_u_, &ac_v_}) {
      clear(*v, mbw_, my - 1, mx - 1, mbw_ - 1);
      clear(*v, mbw_, my, 0, mx - 1);
    }
  }

  // ---------------------------------------------------- motion vectors

  int16_t* mv_at(int bx, int by) {
    return &mv_[2 * (size_t(by) * 2 * mbw_ + bx)];
  }
  // The vector of 8x8 block (bx, by) of this VOP; 0 outside the picture.
  int mv_or0(int bx, int by, int c) {
    if (bx < 0 || bx >= 2 * mbw_ || by < 0) return 0;
    return mv_at(bx, by)[c];
  }

  // ff_h263_pred_motion: the predictor of block `blk` of macroblock
  // (mx, my) (0 for a 1MV macroblock): the median of the blocks left (A),
  // above (B) and above right (C), with the special cases of a slice's
  // first row.  Block 2 of a slice's first macroblock zeroes A, and FFmpeg
  // stores that zero into the left macroblock's block 3.
  void pred_motion(int mx, int my, int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    const int bx = 2 * mx + (blk & 1), by = 2 * my + (blk >> 1);
    int a0 = mv_or0(bx - 1, by, 0), a1 = mv_or0(bx - 1, by, 1);
    if (first_line_ && blk < 3) {
      if (blk == 0) {
        if (mx == resync_x_) {
          *px = *py = 0;
        } else if (mx + 1 == resync_x_) {
          int c0 = mv_or0(bx + 2, by - 1, 0), c1 = mv_or0(bx + 2, by - 1, 1);
          *px = mx == 0 ? c0 : median3(a0, 0, c0);
          *py = mx == 0 ? c1 : median3(a1, 0, c1);
        } else {
          *px = a0;
          *py = a1;
        }
        return;
      }
      if (blk == 1) {
        if (mx + 1 == resync_x_) {
          *px = median3(a0, 0, mv_or0(bx + 1, by - 1, 0));
          *py = median3(a1, 0, mv_or0(bx + 1, by - 1, 1));
        } else {
          *px = a0;
          *py = a1;
        }
        return;
      }
      if (mx == resync_x_) {
        a0 = a1 = 0;
        if (bx > 0) mv_at(bx - 1, by)[0] = mv_at(bx - 1, by)[1] = 0;
      }
      *px = median3(a0, mv_or0(bx, by - 1, 0), mv_or0(bx + 1, by - 1, 0));
      *py = median3(a1, mv_or0(bx, by - 1, 1), mv_or0(bx + 1, by - 1, 1));
      return;
    }
    const int cx = bx + off[blk];
    *px = median3(a0, mv_or0(bx, by - 1, 0), mv_or0(cx, by - 1, 0));
    *py = median3(a1, mv_or0(bx, by - 1, 1), mv_or0(cx, by - 1, 1));
  }

  int motion(Bits& b, int pred, int fcode) {
    int code = tables().mv.read(b, "motion vector");
    if (code == 0) return pred;
    int sign = b.get1();
    int shift = fcode - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= static_cast<int>(b.get(shift));
      val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;  // wrap into [-2^(bits-1), 2^(bits-1))
    val = static_cast<int>(static_cast<unsigned>(val) << (32 - bits)) >>
          (32 - bits);
    return val;
  }

  void set_mb_mv(int mx, int my, int vx, int vy) {
    for (int k = 0; k < 4; ++k) {
      int16_t* m = mv_at(2 * mx + (k & 1), 2 * my + (k >> 1));
      m[0] = static_cast<int16_t>(vx);
      m[1] = static_cast<int16_t>(vy);
    }
  }

  // ------------------------------------------------- motion compensation

  // One vector for the macroblock (FFmpeg's mpeg_motion, or qpel_motion
  // under quarter-pel), luma and chroma.
  void mc16(const Picture& ref, int mx, int my, int vx, int vy, Op op) {
    uint8_t buf[3][kWin * kWin];
    int ys, us, vs;
    const int ew = edge_w_, eh = edge_h_;
    int sx, sy, ux, uy, dxy, uvdxy;
    bool emu;
    if (quarter_) {
      dxy = ((vy & 3) << 2) | (vx & 3);
      sx = mx * 16 + (vx >> 2);
      sy = my * 16 + (vy >> 2);
      int cx, cy;
      if (bugs_ & kBugQpelChroma2) {
        static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
        cx = (vx >> 1) + rtab[vx & 7];
        cy = (vy >> 1) + rtab[vy & 7];
      } else if (bugs_ & kBugQpelChroma) {
        cx = (vx >> 1) | (vx & 1);
        cy = (vy >> 1) | (vy & 1);
      } else {
        cx = vx / 2;
        cy = vy / 2;
      }
      cx = (cx >> 1) | (cx & 1);
      cy = (cy >> 1) | (cy & 1);
      uvdxy = (cx & 1) | ((cy & 1) << 1);
      ux = mx * 8 + (cx >> 1);
      uy = my * 8 + (cy >> 1);
      emu = unsigned(sx) >= unsigned(std::max(ew - (vx & 3) - 15, 0)) ||
            unsigned(sy) >= unsigned(std::max(eh - (vy & 3) - 15, 0));
    } else {
      dxy = ((vy & 1) << 1) | (vx & 1);
      sx = mx * 16 + (vx >> 1);
      sy = my * 16 + (vy >> 1);
      uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
      ux = sx >> 1;
      uy = sy >> 1;
      emu = unsigned(sx) >= unsigned(std::max(ew - (vx & 1) - 15, 0)) ||
            unsigned(sy) >= unsigned(std::max(eh - (vy & 1) - 15, 0));
    }
    const uint8_t* y = window(ref.y, sx, sy, 17, 17, ew, eh, emu, buf[0], &ys);
    const uint8_t* u = window(ref.u, ux, uy, 9, 9, ew >> 1, eh >> 1, emu,
                              buf[1], &us);
    const uint8_t* v = window(ref.v, ux, uy, 9, 9, ew >> 1, eh >> 1, emu,
                              buf[2], &vs);
    Picture& d = *cur_;
    if (quarter_)
      qpel<16>(y, ys, dxy, op, d.y.at(mx * 16, my * 16), d.y.w);
    else
      hpel(y, ys, dxy, op, 16, 16, d.y.at(mx * 16, my * 16), d.y.w);
    hpel(u, us, uvdxy, op, 8, 8, d.u.at(mx * 8, my * 8), d.u.w);
    hpel(v, vs, uvdxy, op, 8, 8, d.v.at(mx * 8, my * 8), d.v.w);
  }

  // Four vectors, one per 8x8 luma block, and the chroma vector from their
  // sum (FFmpeg's apply_8x8 with hpel_motion and chroma_4mv_motion): each
  // block's source clipped to [-16, width] (chroma [-8, width/2]), its
  // fraction dropped at the clip's far end.
  void mc8x8(const Picture& ref, int mx, int my, const int (*mv)[2],
             Op op) {
    uint8_t buf[kWin * kWin];
    int ss;
    const int ew = edge_w_, eh = edge_h_;
    Picture& d = *cur_;
    int cx = 0, cy = 0;
    for (int i = 0; i < 4; ++i) {
      const int vx = mv[i][0], vy = mv[i][1];
      uint8_t* dst = d.y.at(mx * 16 + (i & 1) * 8, my * 16 + (i >> 1) * 8);
      int sx, sy, dxy;
      bool emu;
      if (quarter_) {
        dxy = ((vy & 3) << 2) | (vx & 3);
        sx = std::clamp(mx * 16 + (vx >> 2) + (i & 1) * 8, -16, width);
        if (sx == width) dxy &= ~3;
        sy = std::clamp(my * 16 + (vy >> 2) + (i >> 1) * 8, -16, height);
        if (sy == height) dxy &= ~12;
        emu = unsigned(sx) >= unsigned(std::max(ew - (vx & 3) - 7, 0)) ||
              unsigned(sy) >= unsigned(std::max(eh - (vy & 3) - 7, 0));
        const uint8_t* s = window(ref.y, sx, sy, 9, 9, ew, eh, emu, buf, &ss);
        qpel<8>(s, ss, dxy, op, dst, d.y.w);
        cx += vx / 2;
        cy += vy / 2;
      } else {
        dxy = 0;
        sx = std::clamp(mx * 16 + (i & 1) * 8 + (vx >> 1), -16, width);
        if (sx != width) dxy |= vx & 1;
        sy = std::clamp(my * 16 + (i >> 1) * 8 + (vy >> 1), -16, height);
        if (sy != height) dxy |= (vy & 1) << 1;
        emu = unsigned(sx) >= unsigned(std::max(ew - (vx & 1) - 7, 0)) ||
              unsigned(sy) >= unsigned(std::max(eh - (vy & 1) - 7, 0));
        const uint8_t* s = window(ref.y, sx, sy, 9, 9, ew, eh, emu, buf, &ss);
        hpel(s, ss, dxy, op, 8, 8, dst, d.y.w);
        cx += vx;
        cy += vy;
      }
    }
    cx = round_chroma(cx);
    cy = round_chroma(cy);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    int ux = std::clamp(mx * 8 + (cx >> 1), -8, width >> 1);
    if (ux == (width >> 1)) dxy &= ~1;
    int uy = std::clamp(my * 8 + (cy >> 1), -8, height >> 1);
    if (uy == (height >> 1)) dxy &= ~2;
    const bool emu =
        unsigned(ux) >= unsigned(std::max((ew >> 1) - (dxy & 1) - 7, 0)) ||
        unsigned(uy) >= unsigned(std::max((eh >> 1) - (dxy >> 1) - 7, 0));
    const uint8_t* s =
        window(ref.u, ux, uy, 9, 9, ew >> 1, eh >> 1, emu, buf, &ss);
    hpel(s, ss, dxy, op, 8, 8, d.u.at(mx * 8, my * 8), d.u.w);
    s = window(ref.v, ux, uy, 9, 9, ew >> 1, eh >> 1, emu, buf, &ss);
    hpel(s, ss, dxy, op, 8, 8, d.v.at(mx * 8, my * 8), d.v.w);
  }

  // Field `bottom` of the macroblock from field `sel` of `ref`, vector
  // (vx, vy) in that field's units: FFmpeg's mpeg_motion_internal (half-
  // pel, H.263's chroma rule) or qpel_motion (quarter-pel: two 8x8 luma
  // blocks) with field_based; a block near the edge is emulated in frame
  // lines (17 x 18 luma, 9 x 10 chroma) before its field is read.
  void mc_field(const Picture& ref, int mx, int my, int bottom, int sel,
                int vx, int vy, Op op) {
    uint8_t buf[3][kWin * kWin];
    const int ew = edge_w_, eh = edge_h_;
    int sx, sy, ux, uy, dxy, uvdxy;
    bool emu;
    if (quarter_) {
      dxy = ((vy & 3) << 2) | (vx & 3);
      sx = mx * 16 + (vx >> 2);
      sy = my * 8 + (vy >> 2);
      int cx = vx / 2, cy = vy >> 1;
      cx = (cx >> 1) | (cx & 1);
      cy = (cy >> 1) | (cy & 1);
      uvdxy = (cx & 1) | ((cy & 1) << 1);
      ux = mx * 8 + (cx >> 1);
      uy = my * 4 + (cy >> 1);
      emu = unsigned(sx) >= unsigned(std::max(ew - (vx & 3) - 15, 0)) ||
            unsigned(sy) >= unsigned(std::max((eh >> 1) - (vy & 3) - 7, 0));
    } else {
      dxy = ((vy & 1) << 1) | (vx & 1);
      sx = mx * 16 + (vx >> 1);
      sy = my * 8 + (vy >> 1);
      if (bugs_ & kBugHpelChroma) {  // FF_BUG_HPEL_CHROMA
        const int cx = (vx >> 1) | (vx & 1), cy = vy >> 1;
        uvdxy = ((cy & 1) << 1) | (cx & 1);
        ux = mx * 8 + (cx >> 1);
        uy = my * 4 + (cy >> 1);
      } else {
        uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
        ux = sx >> 1;
        uy = sy >> 1;
      }
      emu = unsigned(sx) >= unsigned(std::max(ew - (vx & 1) - 15, 0)) ||
            unsigned(sy) >= unsigned(std::max((eh >> 1) - (vy & 1) - 7, 0));
    }
    int ys, us, vs;
    const uint8_t* y =
        window(ref.y, sx, 2 * sy, 17, 18, ew, eh, emu, buf[0], &ys);
    const uint8_t* u = window(ref.u, ux, 2 * uy, 9, 10, ew >> 1, eh >> 1, emu,
                              buf[1], &us);
    const uint8_t* v = window(ref.v, ux, 2 * uy, 9, 10, ew >> 1, eh >> 1, emu,
                              buf[2], &vs);
    Picture& d = *cur_;
    uint8_t* dy = d.y.at(mx * 16, my * 16);
    uint8_t* du = d.u.at(mx * 8, my * 8);
    uint8_t* dv = d.v.at(mx * 8, my * 8);
    int dys = d.y.w, dus = d.u.w, dvs = d.v.w;
    field_lines(y, ys, dy, dys, sel, bottom);
    field_lines(u, us, du, dus, sel, bottom);
    field_lines(v, vs, dv, dvs, sel, bottom);
    if (quarter_) {
      qpel<8>(y, ys, dxy, op, dy, dys);
      qpel<8>(y + 8, ys, dxy, op, dy + 8, dys);
    } else {
      hpel(y, ys, dxy, op, 16, 8, dy, dys);
    }
    hpel(u, us, uvdxy, op, 8, 4, du, dus);
    hpel(v, vs, uvdxy, op, 8, 4, dv, dvs);
  }

  void copy_mb(const Picture& ref, int mx, int my) {
    int x = mx * 16, y = my * 16;
    for (int j = 0; j < 16; ++j)
      std::memcpy(cur_->y.at(x, y + j), ref.y.at(x, y + j), 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(cur_->u.at(x / 2, y / 2 + j), ref.u.at(x / 2, y / 2 + j), 8);
      std::memcpy(cur_->v.at(x / 2, y / 2 + j), ref.v.at(x / 2, y / 2 + j), 8);
    }
  }

  // ------------------------------------------------------- macroblocks

  void p_mb(Bits& b, int mx, int my) {
    const Tables& t = tables();
    const int i = my * mbw_ + mx;
    int cbpc;
    for (;;) {
      if (b.get1()) {  // not_coded: a zero vector, through the edge test
        set_mb_mv(mx, my, 0, 0);
        qs_[i] = static_cast<int8_t>(qscale_);
        skipped_[i] = 1;
        mc16(*next_, mx, my, 0, 0, kPut);
        return;
      }
      cbpc = t.inter_mcbpc.read(b, "MCBPC");
      if (cbpc != 20) break;
      if (b.overrun()) corrupt("stuffing runs past the end");
    }
    if (cbpc & 4) {
      intra_mb(b, mx, my, true, cbpc);
      return;
    }
    int cbpy = t.cbpy.read(b, "CBPY") ^ 15;
    if (cbpc & 8) set_qscale(qscale_ + kDquant[b.get(2)]);
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (interlaced_ && cbp) interlaced_dct_ = b.get1();
    qs_[i] = static_cast<int8_t>(qscale_);
    const Op op = rnd_ ? kPutNoRnd : kPut;
    if (!(cbpc & 16) && interlaced_ && b.get1()) {
      // field prediction: a vector per field, each from the macroblock's
      // predictor (its vertical half), with its reference field
      int sel[2], v[2][2], px, py;
      sel[0] = b.get1();
      sel[1] = b.get1();
      pred_motion(mx, my, 0, &px, &py);
      for (int f = 0; f < 2; ++f) {
        v[f][0] = motion(b, px, fcode_);
        v[f][1] = motion(b, py / 2, fcode_);
      }
      const int sx = v[0][0] + v[1][0];
      set_mb_mv(mx, my, (sx >> 1) | (sx & 1), v[0][1] + v[1][1]);
      field_mb_[i] = 1;
      for (int f = 0; f < 2; ++f) {
        field_sel_[2 * i + f] = static_cast<uint8_t>(sel[f]);
        field_mv_[4 * i + 2 * f] = static_cast<int16_t>(v[f][0]);
        field_mv_[4 * i + 2 * f + 1] = static_cast<int16_t>(v[f][1]);
        mc_field(*next_, mx, my, f, sel[f], v[f][0], v[f][1], op);
      }
      ++stats.field_mc_mbs;
    } else if (cbpc & 16) {  // INTER4V: a vector per 8x8 block
      int mv[4][2];
      for (int k = 0; k < 4; ++k) {
        int px, py;
        pred_motion(mx, my, k, &px, &py);
        mv[k][0] = motion(b, px, fcode_);
        mv[k][1] = motion(b, py, fcode_);
        int16_t* m = mv_at(2 * mx + (k & 1), 2 * my + (k >> 1));
        m[0] = static_cast<int16_t>(mv[k][0]);
        m[1] = static_cast<int16_t>(mv[k][1]);
      }
      four_mv_[i] = 1;
      mc8x8(*next_, mx, my, mv, op);
    } else {
      int px, py;
      pred_motion(mx, my, 0, &px, &py);
      int vx = motion(b, px, fcode_), vy = motion(b, py, fcode_);
      set_mb_mv(mx, my, vx, vy);
      mc16(*next_, mx, my, vx, vy, op);
    }
    residual(b, mx, my, cbp);
  }

  // The coded blocks of an inter macroblock, added to its prediction.
  void residual(Bits& b, int mx, int my, int cbp) {
    int qmul = qscale_ * 2, qadd = (qscale_ - 1) | 1;
    if (mpeg_quant_) qmul = 1, qadd = 0;
    const uint8_t* scan = alt_scan_ ? tables().vertical : tables().zigzag;
    stats.field_dct_mbs += interlaced_dct_ && cbp;
    for (int n = 0; n < 6; ++n) {
      if (!(cbp & (32 >> n))) continue;
      int16_t block[64] = {};
      tcoef(b, tables().inter, block, scan, 0, qmul, qadd);
      if (mpeg_quant_) dequant_inter_mpeg(block);
      uint8_t* dst;
      int stride;
      block_dest(*cur_, mx, my, n, &dst, &stride);
      idct(block, dst, stride, true);
    }
  }

  // MPEG inverse quantisation of an inter block (FFmpeg's
  // dct_unquantize_mpeg2_inter: ((2|level| + 1) * 2q * W) >> 5, and the
  // mismatch control: the sum's parity toggles coefficient 63).
  void dequant_inter_mpeg(int16_t* block) const {
    const int q = 2 * qscale_;
    int sum = -1;
    for (int k = 0; k < 64; ++k) {
      int level = block[k];
      if (!level) continue;
      int a = ((2 * std::abs(level) + 1) * q * inter_matrix_[k]) >> 5;
      level = level < 0 ? -a : a;
      block[k] = static_cast<int16_t>(level);
      sum += level;
    }
    block[63] = static_cast<int16_t>(block[63] ^ (sum & 1));
  }

  // A B-VOP macroblock: skipped where the newer reference's is not coded
  // (the older reference's pixels); else modb, mb_type, cbpb and dbquant,
  // then direct (the co-located vectors scaled by TRB/TRD, plus a delta),
  // interpolated, backward or forward prediction and the residual.
  void b_mb(Bits& b, int mx, int my) {
    const int i = my * mbw_ + mx;
    if (skipped_[i]) {
      mc16(*last_, mx, my, 0, 0, kPut);
      return;
    }
    int cbp = 0, mode = 0;  // 0 direct, 1 interpolate, 2 backward, 3 forward
    bool delta = false, field = false;
    int sel[2][2] = {};
    if (!b.get1()) {  // modb: more than a direct macroblock without data
      const bool no_cbp = b.get1();
      while (mode < 4 && !b.get1()) ++mode;
      if (mode == 4) corrupt("invalid B macroblock type");
      if (!no_cbp) cbp = b.get(6);
      if (mode != 0 && cbp && b.get1())  // dbquant
        set_qscale(qscale_ + (b.get1() ? 2 : -2));
      if (interlaced_) {
        if (cbp) interlaced_dct_ = b.get1();
        if (mode != 0 && b.get1()) {  // field_prediction
          field = true;
          for (int d = 0; d < 2; ++d)
            if (mode == 1 || mode == 3 - d) {
              sel[d][0] = b.get1();
              sel[d][1] = b.get1();
            }
        }
      }
      delta = mode == 0;
    }
    if (mode == 0) {
      int dx = 0, dy = 0;
      if (delta) {
        dx = motion(b, 0, 1);
        dy = motion(b, 0, 1);
      }
      direct_mb(mx, my, dx, dy);
    } else {
      // vectors: forward (older reference), backward (newer), per field
      // with the vertical predictor halved, or one for the macroblock
      int v[2][2][2] = {};
      for (int d = 0; d < 2; ++d) {
        if (!(mode == 1 || mode == 3 - d)) continue;
        const int code = d ? bcode_ : fcode_;
        for (int f = 0; f < (field ? 2 : 1); ++f) {
          int(&p)[2] = last_mv_[d][f];
          v[d][f][0] = motion(b, p[0], code);
          if (field) {
            v[d][f][1] = motion(b, p[1] / 2, code);
            p[0] = v[d][f][0];
            p[1] = v[d][f][1] * 2;
          } else {
            v[d][f][1] = motion(b, p[1], code);
            for (int* q : {last_mv_[d][0], last_mv_[d][1]}) {
              q[0] = v[d][0][0];
              q[1] = v[d][0][1];
            }
          }
        }
      }
      for (int d = 0; d < 2; ++d) {
        if (!(mode == 1 || mode == 3 - d)) continue;
        const Picture& ref = d ? *next_ : *last_;
        const Op op = d && mode == 1 ? kAvg : kPut;
        if (field) {
          for (int f = 0; f < 2; ++f)
            mc_field(ref, mx, my, f, sel[d][f], v[d][f][0], v[d][f][1], op);
        } else {
          mc16(ref, mx, my, v[d][0][0], v[d][0][1], op);
        }
      }
      stats.field_mc_mbs += field;
    }
    residual(b, mx, my, cbp);
  }

  // Direct mode (ff_mpeg4_set_direct_mv): per 8x8 block of the co-located
  // macroblock in the newer reference (one vector for a 1MV one), its
  // vector p gives the forward vector p * TRB / TRD + delta and the
  // backward one p * (TRB - TRD) / TRD, or forward - p with a delta (C's
  // division toward zero).  Four 8x8 predictions for a 4MV co-located
  // macroblock, and under quarter-pel for any.
  void direct_mb(int mx, int my, int dx, int dy) {
    const int i = my * mbw_ + mx;
    if (field_mb_[i]) {
      // the co-located macroblock's field vectors, each scaled by the
      // distances of its field and the field it referred to
      int fwd[2][2], bwd[2][2];
      for (int f = 0; f < 2; ++f) {
        const int sel = field_sel_[2 * i + f];
        const uint16_t pp = static_cast<uint16_t>(
            tff_ ? pp_field_time_ - sel + f : pp_field_time_ + sel - f);
        const uint16_t pb = static_cast<uint16_t>(
            tff_ ? pb_field_time_ - sel + f : pb_field_time_ + sel - f);
        for (int c = 0; c < 2; ++c) {
          const int d = c ? dy : dx, pv = field_mv_[4 * i + 2 * f + c];
          fwd[f][c] = pv * pb / pp + d;
          bwd[f][c] = d ? fwd[f][c] - pv : pv * (pb - pp) / pp;
        }
      }
      for (int f = 0; f < 2; ++f)
        mc_field(*last_, mx, my, f, field_sel_[2 * i + f], fwd[f][0],
                 fwd[f][1], kPut);
      for (int f = 0; f < 2; ++f)
        mc_field(*next_, mx, my, f, f, bwd[f][0], bwd[f][1], kAvg);
      ++stats.field_direct_mbs;
      return;
    }
    int fwd[4][2], bwd[4][2];
    const int nblk = four_mv_[i] ? 4 : 1;
    for (int k = 0; k < nblk; ++k) {
      const int16_t* p = mv_at(2 * mx + (k & 1), 2 * my + (k >> 1));
      for (int c = 0; c < 2; ++c) {
        const int d = c ? dy : dx, pv = p[c];
        fwd[k][c] = pv * pb_time_ / pp_time_ + d;
        bwd[k][c] = d ? fwd[k][c] - pv : pv * (pb_time_ - pp_time_) / pp_time_;
      }
    }
    for (int k = nblk; k < 4; ++k)
      for (int c = 0; c < 2; ++c) {
        fwd[k][c] = fwd[0][c];
        bwd[k][c] = bwd[0][c];
      }
    const bool eight = four_mv_[i] || quarter_;
    if (eight) {
      mc8x8(*last_, mx, my, fwd, kPut);
      mc8x8(*next_, mx, my, bwd, kAvg);
    } else {
      mc16(*last_, mx, my, fwd[0][0], fwd[0][1], kPut);
      mc16(*next_, mx, my, bwd[0][0], bwd[0][1], kAvg);
    }
  }

  void set_qscale(int q) { qscale_ = std::clamp(q, 1, 31); }

  // Where block n goes: luma laid out by dct_type (interlaced_dct_).
  void block_dest(Picture& p, int mx, int my, int n, uint8_t** dst,
                  int* stride) const {
    if (n < 4) {
      uint8_t* dest[4];
      *stride = dct_blocks(p.y.at(mx * 16, my * 16), p.y.w, interlaced_dct_,
                           2, dest);
      *dst = dest[n];
    } else {
      Plane& c = n == 4 ? p.u : p.v;
      *dst = c.at(mx * 8, my * 8);
      *stride = c.w;
    }
  }

  // The block grid of block n of macroblock (mx, my): column, row, width.
  void grid(int mx, int my, int n, int* bx, int* by, int* gw) const {
    if (n < 4) {
      *bx = 2 * mx + (n & 1);
      *by = 2 * my + (n >> 1);
      *gw = 2 * mbw_;
    } else {
      *bx = mx;
      *by = my;
      *gw = mbw_;
    }
  }
  int16_t* dc_ptr(int mx, int my, int n) {
    int bx, by, gw;
    grid(mx, my, n, &bx, &by, &gw);
    std::vector<int16_t>& v = n < 4 ? dc_y_ : (n == 4 ? dc_u_ : dc_v_);
    return &v[size_t(by) * gw + bx];
  }
  int16_t* ac_ptr(int mx, int my, int n) {
    int bx, by, gw;
    grid(mx, my, n, &bx, &by, &gw);
    std::vector<int16_t>& v = n < 4 ? ac_y_ : (n == 4 ? ac_u_ : ac_v_);
    return &v[(size_t(by) * gw + bx) * 16];
  }
  // DC (and AC) neighbour of block n at grid offset (dx, dy); null outside.
  int16_t* neighbour(std::vector<int16_t>& v, int mx, int my, int n, int dx,
                     int dy, int per) {
    int bx, by, gw;
    grid(mx, my, n, &bx, &by, &gw);
    bx += dx;
    by += dy;
    if (bx < 0 || by < 0 || bx >= gw) return nullptr;
    return &v[(size_t(by) * gw + bx) * per];
  }

  void intra_mb(Bits& b, int mx, int my, bool in_p, int cbpc = -1) {
    const Tables& t = tables();
    if (!in_p) {
      do {
        cbpc = t.intra_mcbpc.read(b, "MCBPC");
        if (b.overrun()) corrupt("stuffing runs past the end");
      } while (cbpc == 8);
    }
    bool dquant = in_p ? (cbpc & 8) != 0 : (cbpc & 4) != 0;
    ac_pred_ = b.get1();
    int cbpy = t.cbpy.read(b, "CBPY");
    int cbp = (cbpc & 3) | (cbpy << 2);
    bool dc_vlc = qscale_ < dc_thr_;
    if (dquant) set_qscale(qscale_ + kDquant[b.get(2)]);
    if (interlaced_) interlaced_dct_ = b.get1();
    stats.field_dct_mbs += interlaced_dct_;
    intra_blocks(b, mx, my, cbp, dc_vlc, -1);
  }

  // The six blocks of an intra macroblock at the current quantiser.
  // `dirs`: under data partitioning, the DC prediction directions its
  // partitions gave (block 0 in bit 5), its DCs predicted and stored
  // there; else -1.
  void intra_blocks(Bits& b, int mx, int my, int cbp, bool dc_vlc,
                    int dirs) {
    int i = my * mbw_ + mx;
    set_mb_mv(mx, my, 0, 0);
    qs_[i] = static_cast<int8_t>(qscale_);
    int qmul = qscale_ * 2, qadd = (qscale_ - 1) | 1;
    for (int n = 0; n < 6; ++n) {
      int16_t block[64] = {};
      intra_block(b, block, mx, my, n, (cbp & (32 >> n)) != 0, dc_vlc,
                  dirs < 0 ? -1 : (dirs >> (5 - n)) & 1);
      block[0] = static_cast<int16_t>(block[0] *
                                      (n < 4 ? y_dc_scale(qscale_)
                                             : c_dc_scale(qscale_)));
      for (int k = 1; k < 64; ++k) {
        int level = block[k];
        if (!level) continue;
        if (mpeg_quant_) {  // FFmpeg's dct_unquantize_mpeg2_intra
          int a = (std::abs(level) * 2 * qscale_ * intra_matrix_[k]) >> 4;
          level = level < 0 ? -a : a;
        } else {  // H.263
          level = level < 0 ? level * qmul - qadd : level * qmul + qadd;
        }
        block[k] = static_cast<int16_t>(level);
      }
      uint8_t* dst;
      int stride;
      block_dest(*cur_, mx, my, n, &dst, &stride);
      idct(block, dst, stride, false);
    }
  }

  // An intra DC's differential (dct_dc_size, dct_dc_differential and the
  // marker after a size above 8).
  int dc_diff(Bits& b, int n) {
    const Tables& t = tables();
    int size = (n < 4 ? t.dc_lum : t.dc_chrom).read(b, "DC size");
    int diff = 0;
    if (size) {
      uint32_t v = b.get(size);
      diff = (v >> (size - 1)) ? static_cast<int>(v)
                               : static_cast<int>(v) - ((1 << size) - 1);
      if (size > 8) b.marker("intra DC");
    }
    return diff;
  }

  // DC prediction: returns the quantised DC (`diff` plus the predictor),
  // stores its reconstruction (clipped to [0, 2047]; kept above 2047 under
  // FFmpeg's FF_BUG_DC_CLIP); *dir = 1 when predicted from the top.
  int pred_dc(int mx, int my, int n, int diff, int* dir) {
    std::vector<int16_t>& v = n < 4 ? dc_y_ : (n == 4 ? dc_u_ : dc_v_);
    auto dc = [&](int dx, int dy) {
      int16_t* p = neighbour(v, mx, my, n, dx, dy, 1);
      return p ? static_cast<int>(*p) : 1024;
    };
    int a = dc(-1, 0), bb = dc(-1, -1), c = dc(0, -1);
    // neighbours before the slice count as outside (ff_mpeg4_pred_dc)
    if (first_line_ && n != 3) {
      if (n != 2) bb = c = 1024;
      if (n != 1 && mx == resync_x_) bb = a = 1024;
    }
    if (mx == resync_x_ && my == resync_y_ + 1 && (n == 0 || n == 4 || n == 5))
      bb = 1024;
    int scale = n < 4 ? y_dc_scale(qscale_) : c_dc_scale(qscale_);
    int pred;
    if (std::abs(a - bb) < std::abs(bb - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    int level = diff + pred;
    int rec = level * scale;
    if (rec & ~2047) rec = rec < 0 ? 0 : (bugs_ & kBugDcClip) ? rec : 2047;
    *dc_ptr(mx, my, n) = static_cast<int16_t>(rec);
    return level;
  }

  // `known_dir` >= 0: the DC was predicted in the VOP's first partitions
  // (its direction, and the quantised DC from the stored one).
  void intra_block(Bits& b, int16_t* block, int mx, int my, int n,
                   bool coded, bool dc_vlc, int known_dir = -1) {
    const Tables& t = tables();
    int dir = 0;
    int pos = 0;
    if (known_dir >= 0) {
      const int scale = n < 4 ? y_dc_scale(qscale_) : c_dc_scale(qscale_);
      block[0] = static_cast<int16_t>((*dc_ptr(mx, my, n) + (scale >> 1)) /
                                      scale);
      dir = known_dir;
      pos = 1;
    } else if (dc_vlc) {
      block[0] = static_cast<int16_t>(pred_dc(mx, my, n, dc_diff(b, n), &dir));
      pos = 1;
    } else {
      pred_dc(mx, my, n, 0, &dir);  // for the direction only
    }
    if (coded) {
      // the alternate vertical scan, when the VOP asks for it, for all
      const uint8_t* scan = alt_scan_ || (ac_pred_ && dir == 0) ? t.vertical
                            : ac_pred_ ? t.horizontal
                                       : t.zigzag;
      tcoef(b, t.intra, block, scan, pos, 1, 0);
    }
    if (!dc_vlc && known_dir < 0) block[0] = static_cast<int16_t>(
        pred_dc(mx, my, n, block[0], &dir));
    pred_ac(block, mx, my, n, dir);
  }

  // TCOEF run/level pairs from scan position `pos` until `last`; levels
  // are scaled by qmul/qadd (1/0 for intra, which is dequantised after AC
  // prediction, and under MPEG quantisation).
  void tcoef(Bits& b, const RunLevel& rl, int16_t* block, const uint8_t* scan,
             int pos, int qmul, int qadd) {
    for (;;) {
      int k = rl.vlc.read(b, "TCOEF");
      int last, run, level;
      if (k != kEscape) {
        last = rl.last[k];
        run = rl.run[k];
        level = rl.level[k] * qmul + qadd;
        if (b.get1()) level = -level;
      } else if (!b.get1()) {  // escape 1: level offset
        k = rl.vlc.read(b, "TCOEF");
        if (k == kEscape) corrupt("escape in escape");
        last = rl.last[k];
        run = rl.run[k];
        level = (rl.level[k] + rl.max_level[last][run]) * qmul + qadd;
        if (b.get1()) level = -level;
      } else if (!b.get1()) {  // escape 2: run offset
        k = rl.vlc.read(b, "TCOEF");
        if (k == kEscape) corrupt("escape in escape");
        last = rl.last[k];
        run = rl.run[k] + rl.max_run[last][rl.level[k]] + 1;
        level = rl.level[k] * qmul + qadd;
        if (b.get1()) level = -level;
      } else {  // escape 3: fixed length
        last = b.get1();
        run = b.get(6);
        b.marker("escape");
        level = static_cast<int>(b.get(12) << 20) >> 20;
        b.marker("escape");
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        if (level < -2048 || level > 2047) level = level < 0 ? -2048 : 2047;
      }
      pos += run;
      if (pos > 63) corrupt("run past the end of a block");
      block[scan[pos]] = static_cast<int16_t>(level);
      ++pos;
      if (last) return;
    }
  }

  // AC prediction of the first row or column of quantised levels, and the
  // store of this block's for its neighbours.
  void pred_ac(int16_t* block, int mx, int my, int n, int dir) {
    std::vector<int16_t>& v = n < 4 ? ac_y_ : (n == 4 ? ac_u_ : ac_v_);
    int16_t* own = ac_ptr(mx, my, n);
    if (ac_pred_) {
      if (dir == 0) {  // from the left
        const int16_t* left = neighbour(v, mx, my, n, -1, 0, 16);
        if (left) {
          int lq = mx > 0 ? qs_[my * mbw_ + mx - 1] : qscale_;
          bool same = mx == 0 || lq == qscale_ || n == 1 || n == 3;
          for (int i = 1; i < 8; ++i)
            block[i * 8] = static_cast<int16_t>(
                block[i * 8] +
                (same ? left[i] : rounded_div(left[i] * lq, qscale_)));
        }
      } else {  // from the top
        const int16_t* top = neighbour(v, mx, my, n, 0, -1, 16);
        if (top) {
          int tq = my > 0 ? qs_[(my - 1) * mbw_ + mx] : qscale_;
          bool same = my == 0 || tq == qscale_ || n == 2 || n == 3;
          for (int i = 1; i < 8; ++i)
            block[i] = static_cast<int16_t>(
                block[i] +
                (same ? top[8 + i] : rounded_div(top[8 + i] * tq, qscale_)));
        }
      }
    }
    for (int i = 1; i < 8; ++i) {
      own[i] = block[i * 8];
      own[8 + i] = block[i];
    }
  }
};

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0)
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

// A decoder over the headers in `extra` (an MP4 esds DecoderSpecificInfo;
// may be empty when the stream carries its headers in band) for a stream
// the container tags `tag` (its fourcc as a little-endian word; 0: none).  0: *out set;
// 2: a tool it does not decode (msg names it); 3: corrupt headers.
int mpeg4dec_open(const uint8_t* extra, int64_t n, uint32_t tag, void** out,
                  char* msg, int msg_len) {
  Decoder* d = new Decoder(tag);
  try {
    if (n > 0) d->headers(extra, n);
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    delete d;
    return e.status;
  }
  *out = d;
  return kFrame;
}

// Decode one sample, tagged `tag` by the caller.  0: a frame is given
// (display order: with B-VOPs, a reference once the next one is decoded),
// *w, *h and *out_tag (the tag of the sample it was decoded from) set; 1:
// no frame (vop_coded 0, a one-byte DivX/Xvid skip, a reference held back,
// a B-VOP FFmpeg skips); 2: a tool it does not decode (msg names it); 3:
// no VOP, or a corrupt or truncated VOP header (no frame; the references
// stay).
int mpeg4dec_decode(void* handle, const uint8_t* data, int64_t n, int64_t tag,
                    int* w, int* h, int64_t* out_tag, char* msg,
                    int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  try {
    Status st = d->decode(data, n, tag);
    *w = d->width;
    *h = d->height;
    *out_tag = d->out_tag;
    return st;
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    return e.status;
  }
}

// The end of the stream: 0 and the frame held back (as mpeg4dec_decode),
// or 1 when none is.
int mpeg4dec_flush(void* handle, int* w, int* h, int64_t* out_tag) {
  Decoder* d = static_cast<Decoder*>(handle);
  Status st = d->flush();
  *w = d->width;
  *h = d->height;
  *out_tag = d->out_tag;
  return st;
}

// The frame last given as h*w*3 RGB bytes.  0: done; 4: cap too small or
// no frame.
int mpeg4dec_rgb(void* handle, uint8_t* rgb, int64_t cap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->out || int64_t(d->width) * d->height * 3 > cap) return kSmall;
  const Picture& p = *d->out;
  swscale_rgb::to_rgb(p.y.px.data(), p.y.w, p.u.px.data(), p.v.px.data(),
                      p.u.w, d->width, d->height, rgb, true);
  return kFrame;
}

// The frame last given as I420 planes, cropped: y (h*w), u and v
// (ceil(h/2)*ceil(w/2) each).  0: done; 4: a cap too small or no frame.
int mpeg4dec_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                    int64_t ycap, int64_t ccap) {
  Decoder* d = static_cast<Decoder*>(handle);
  int w = d->width, h = d->height, cw = (w + 1) / 2, ch = (h + 1) / 2;
  if (!d->out || int64_t(w) * h > ycap || int64_t(cw) * ch > ccap)
    return kSmall;
  const Picture& p = *d->out;
  for (int j = 0; j < h; ++j) std::memcpy(y + int64_t(j) * w, p.y.at(0, j), w);
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + int64_t(j) * cw, p.u.at(0, j), cw);
    std::memcpy(v + int64_t(j) * cw, p.v.at(0, j), cw);
  }
  return kFrame;
}

// What the stream has used so far (Stats, in its order): up to n values
// into out; returns how many there are.
int mpeg4dec_stats(void* handle, int64_t* out, int n) {
  const Stats& s = static_cast<Decoder*>(handle)->stats;
  const int64_t v[] = {s.vops,          s.b_vops,          s.interlaced_vops,
                       s.alternate_scan_vops, s.field_dct_mbs,
                       s.field_mc_mbs,  s.field_direct_mbs,
                       s.partitioned_packets, s.concealed_vops};
  const int total = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < n && i < total; ++i) out[i] = v[i];
  return total;
}

void mpeg4dec_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
