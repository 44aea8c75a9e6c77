// mpegvideo_dsp.h — the pixel operations FFmpeg's MPEG-1/2 and MPEG-4
// Part 2 decoders share on its x86 build, as mpeg12.cpp and mpeg4.cpp use
// them: the "simple" IDCT, the half-pel put and average of a block, and
// the addressing of field DCT and field motion compensation.
// Header-only, no library but the C++ standard one.

#ifndef SLAM_NATIVE_MPEGVIDEO_DSP_H_
#define SLAM_NATIVE_MPEGVIDEO_DSP_H_

#include <algorithm>
#include <cstdint>

namespace mpegvideo_dsp {

// ---------------------------------------------------------------- IDCT
// FFmpeg's simple_idct_template.c at 8 bits.

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20;

inline void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t t = static_cast<int16_t>(static_cast<uint16_t>(row[0] * 8));
    for (int i = 0; i < 8; ++i) row[i] = t;
    return;
  }
  unsigned a0 = W4 * row[0] + (1 << (kRowShift - 1));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * row[2];
  a1 += W6 * row[2];
  a2 -= W6 * row[2];
  a3 -= W2 * row[2];
  unsigned b0 = W1 * row[1] + W3 * row[3];
  unsigned b1 = W3 * row[1] - W7 * row[3];
  unsigned b2 = W5 * row[1] - W1 * row[3];
  unsigned b3 = W7 * row[1] - W5 * row[3];
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += W4 * row[4] + W6 * row[6];
    a1 += -W4 * row[4] - W2 * row[6];
    a2 += -W4 * row[4] + W2 * row[6];
    a3 += W4 * row[4] - W6 * row[6];
    b0 += W5 * row[5] + W7 * row[7];
    b1 += -W1 * row[5] - W5 * row[7];
    b2 += W7 * row[5] + W3 * row[7];
    b3 += W3 * row[5] - W1 * row[7];
  }
  row[0] = static_cast<int16_t>(static_cast<int>(a0 + b0) >> kRowShift);
  row[7] = static_cast<int16_t>(static_cast<int>(a0 - b0) >> kRowShift);
  row[1] = static_cast<int16_t>(static_cast<int>(a1 + b1) >> kRowShift);
  row[6] = static_cast<int16_t>(static_cast<int>(a1 - b1) >> kRowShift);
  row[2] = static_cast<int16_t>(static_cast<int>(a2 + b2) >> kRowShift);
  row[5] = static_cast<int16_t>(static_cast<int>(a2 - b2) >> kRowShift);
  row[3] = static_cast<int16_t>(static_cast<int>(a3 + b3) >> kRowShift);
  row[4] = static_cast<int16_t>(static_cast<int>(a3 - b3) >> kRowShift);
}

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The column pass; `add` adds to dest (inter), else writes (intra).
inline void idct_col(const int16_t* col, uint8_t* dest, int stride,
                     bool add) {
  unsigned a0 = W4 * (col[0] + ((1 << (kColShift - 1)) / W4));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * col[16];
  a1 += W6 * col[16];
  a2 += -W6 * col[16];
  a3 += -W2 * col[16];
  unsigned b0 = W1 * col[8] + W3 * col[24];
  unsigned b1 = W3 * col[8] - W7 * col[24];
  unsigned b2 = W5 * col[8] - W1 * col[24];
  unsigned b3 = W7 * col[8] - W5 * col[24];
  if (col[32]) {
    a0 += W4 * col[32];
    a1 += -W4 * col[32];
    a2 += -W4 * col[32];
    a3 += W4 * col[32];
  }
  if (col[40]) {
    b0 += W5 * col[40];
    b1 += -W1 * col[40];
    b2 += W7 * col[40];
    b3 += W3 * col[40];
  }
  if (col[48]) {
    a0 += W6 * col[48];
    a1 += -W2 * col[48];
    a2 += W2 * col[48];
    a3 += -W6 * col[48];
  }
  if (col[56]) {
    b0 += W7 * col[56];
    b1 += -W5 * col[56];
    b2 += W3 * col[56];
    b3 += -W1 * col[56];
  }
  const int v[8] = {static_cast<int>(a0 + b0) >> kColShift,
                    static_cast<int>(a1 + b1) >> kColShift,
                    static_cast<int>(a2 + b2) >> kColShift,
                    static_cast<int>(a3 + b3) >> kColShift,
                    static_cast<int>(a3 - b3) >> kColShift,
                    static_cast<int>(a2 - b2) >> kColShift,
                    static_cast<int>(a1 - b1) >> kColShift,
                    static_cast<int>(a0 - b0) >> kColShift};
  for (int i = 0; i < 8; ++i) {
    uint8_t* d = dest + i * stride;
    *d = clip8(add ? *d + v[i] : v[i]);
  }
}

inline void simple_idct(int16_t* block, uint8_t* dest, int stride, bool add) {
  for (int i = 0; i < 8; ++i) idct_row(block + 8 * i);
  for (int i = 0; i < 8; ++i) idct_col(block + i, dest + i, stride, add);
}


// How a prediction is written: put (rounded), put without rounding
// (vop_rounding_type 1), or averaged with what the block holds (FFmpeg's
// avg ops: the rounded mean of it and the rounded prediction; B-VOPs).
enum Op { kPut, kPutNoRnd, kAvg };

template <typename F>
inline void store(Op op, int bw, int bh, uint8_t* d, int ds, F value) {
  for (int j = 0; j < bh; ++j) {
    uint8_t* o = d + j * ds;
    if (op == kAvg)
      for (int i = 0; i < bw; ++i) o[i] = (o[i] + value(i, j) + 1) >> 1;
    else
      for (int i = 0; i < bw; ++i) o[i] = static_cast<uint8_t>(value(i, j));
  }
}

// Half-pel prediction of a bw x bh block from s (dxy: bit 0 x, bit 1 y).
// FFmpeg's x86 build predicts an 8-wide block without rounding (INTER4V
// luma, every chroma block of a P-VOP with vop_rounding_type 1) by its
// MMXEXT put_no_rnd_pixels8_x2/_y2, which are inexact unless the codec is
// bit-exact (OpenCV does not ask): pavgb of one operand less one,
// saturated -- the left pixel, or the pixel of the odd source row -- so
// where that pixel is 0 the result rounds up.  The 16-wide ones are exact.
inline void hpel(const uint8_t* s, int ss, int dxy, Op op, int bw, int bh,
          uint8_t* d, int ds) {
  const int r = op == kPutNoRnd ? 0 : 1;
  switch (dxy) {
    case 0:
      store(op, bw, bh, d, ds, [&](int i, int j) { return s[j * ss + i]; });
      break;
    case 1:
      if (op == kPutNoRnd && bw == 8) {
        store(op, bw, bh, d, ds, [&](int i, int j) {
          const uint8_t* p = s + j * ss + i;
          return (std::max(p[0] - 1, 0) + p[1] + 1) >> 1;
        });
        break;
      }
      store(op, bw, bh, d, ds, [&](int i, int j) {
        const uint8_t* p = s + j * ss + i;
        return (p[0] + p[1] + r) >> 1;
      });
      break;
    case 2:
      if (op == kPutNoRnd && bw == 8) {
        store(op, bw, bh, d, ds, [&](int i, int j) {
          const uint8_t* p = s + j * ss + i;
          int a = p[0], b = p[ss];
          if (j & 1) a = std::max(a - 1, 0); else b = std::max(b - 1, 0);
          return (a + b + 1) >> 1;
        });
        break;
      }
      store(op, bw, bh, d, ds, [&](int i, int j) {
        const uint8_t* p = s + j * ss + i;
        return (p[0] + p[ss] + r) >> 1;
      });
      break;
    default:
      store(op, bw, bh, d, ds, [&](int i, int j) {
        const uint8_t* p = s + j * ss + i;
        return (p[0] + p[1] + p[ss] + p[ss + 1] + 1 + r) >> 2;
      });
  }
}

// ------------------------------------------------------- interlaced tools
// What MPEG-2 and MPEG-4 Part 2 share for interlaced frame pictures.

// Field DCT (interlaced_dct, FFmpeg's dct_linesize and dct_offset): the
// destinations of the 8x8 blocks of a region two blocks high and `cols`
// wide (a macroblock's luma: 2; its 4:2:2 chroma: 1) at `p`, stride `ls`,
// in coding order, and the stride they are written at.  Under field DCT
// the upper row of blocks holds the top field's lines and the lower one
// the bottom field's, at twice the stride.
inline int dct_blocks(uint8_t* p, int ls, bool field, int cols,
                      uint8_t** dest) {
  for (int k = 0; k < 2 * cols; ++k)
    dest[k] = p + (k % cols) * 8 + (k / cols) * (field ? ls : 8 * ls);
  return field ? 2 * ls : ls;
}

// Field motion compensation in a frame picture (FFmpeg's
// mpeg_motion_internal and qpel_motion with field_based): `src` addresses
// the reference's top-field lines at stride `src_ls` and `dst` the
// macroblock's top-field lines at `dst_ls` (frame strides); the prediction
// of field `bottom` reads field `select`, one frame line down where either
// is 1, and both strides double to step a field's lines.
template <typename S, typename D>
inline void field_lines(S*& src, int& src_ls, D*& dst, int& dst_ls,
                        int select, int bottom) {
  if (select) src += src_ls;
  if (bottom) dst += dst_ls;
  src_ls *= 2;
  dst_ls *= 2;
}

}  // namespace mpegvideo_dsp

#endif  // SLAM_NATIVE_MPEGVIDEO_DSP_H_
