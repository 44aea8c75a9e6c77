// vp9_dsp.h — the pixel arithmetic of the VP9 decoder (vp9.cpp): the
// inverse transforms (DCT and ADST of 4 to 32 points, the Walsh-Hadamard
// transform of lossless frames), the intra predictors, the 8-tap and
// bilinear motion filters and the loop filters of 4, 8 and 16 taps.  Each
// is written as the VP9 bitstream defines it, which is what libvpx's and
// FFmpeg's C code compute; header-only, no library but the C++ standard
// one.

#ifndef SLAM_NATIVE_VP9_DSP_H_
#define SLAM_NATIVE_VP9_DSP_H_

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace vp9_dsp {

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ------------------------------------------------------- inverse transforms

// cos(k*pi/64) and sqrt(2)*2/3*sin(k*pi/9) in Q14
constexpr int64_t C[32] = {16384, 16364, 16305, 16207, 16069, 15893, 15679,
                           15426, 15137, 14811, 14449, 14053, 13623, 13160,
                           12665, 12140, 11585, 11003, 10394, 9760,  9102,
                           8423,  7723,  7005,  6270,  5520,  4756,  3981,
                           3196,  2404,  1606,  804};
constexpr int64_t S1 = 5283, S2 = 9929, S3 = 13377, S4 = 15212;

inline int64_t rs(int64_t v) { return (v + (1 << 13)) >> 14; }

inline void idct4(const int64_t* in, int64_t* out) {
  const int64_t s0 = rs((in[0] + in[2]) * C[16]);
  const int64_t s1 = rs((in[0] - in[2]) * C[16]);
  const int64_t s2 = rs(in[1] * C[24] - in[3] * C[8]);
  const int64_t s3 = rs(in[1] * C[8] + in[3] * C[24]);
  out[0] = s0 + s3;
  out[1] = s1 + s2;
  out[2] = s1 - s2;
  out[3] = s0 - s3;
}

inline void iadst4(const int64_t* in, int64_t* out) {
  const int64_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
  if (!(x0 | x1 | x2 | x3)) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  int64_t s0 = S1 * x0 + S4 * x2 + S2 * x3;
  int64_t s1 = S2 * x0 - S1 * x2 - S4 * x3;
  const int64_t s2 = S3 * (x0 - x2 + x3);
  const int64_t s3 = S3 * x1;
  out[0] = rs(s0 + s3);
  out[1] = rs(s1 + s3);
  out[2] = rs(s2);
  out[3] = rs(s0 + s1 - s3);
}

inline void idct8(const int64_t* in, int64_t* out) {
  int64_t e[4] = {in[0], in[2], in[4], in[6]}, s[8];
  idct4(e, s);
  int64_t s4 = rs(in[1] * C[28] - in[7] * C[4]);
  int64_t s7 = rs(in[1] * C[4] + in[7] * C[28]);
  int64_t s5 = rs(in[5] * C[12] - in[3] * C[20]);
  int64_t s6 = rs(in[5] * C[20] + in[3] * C[12]);
  const int64_t t4 = s4 + s5, t5 = s4 - s5, t6 = -s6 + s7, t7 = s6 + s7;
  s5 = rs((t6 - t5) * C[16]);
  s6 = rs((t5 + t6) * C[16]);
  out[0] = s[0] + t7;
  out[1] = s[1] + s6;
  out[2] = s[2] + s5;
  out[3] = s[3] + t4;
  out[4] = s[3] - t4;
  out[5] = s[2] - s5;
  out[6] = s[1] - s6;
  out[7] = s[0] - t7;
}

inline void iadst8(const int64_t* in, int64_t* out) {
  int64_t x0 = in[7], x1 = in[0], x2 = in[5], x3 = in[2], x4 = in[3],
          x5 = in[4], x6 = in[1], x7 = in[6];
  if (!(x0 | x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
    for (int i = 0; i < 8; ++i) out[i] = 0;
    return;
  }
  int64_t s0 = C[2] * x0 + C[30] * x1, s1 = C[30] * x0 - C[2] * x1;
  int64_t s2 = C[10] * x2 + C[22] * x3, s3 = C[22] * x2 - C[10] * x3;
  int64_t s4 = C[18] * x4 + C[14] * x5, s5 = C[14] * x4 - C[18] * x5;
  int64_t s6 = C[26] * x6 + C[6] * x7, s7 = C[6] * x6 - C[26] * x7;
  x0 = rs(s0 + s4); x1 = rs(s1 + s5); x2 = rs(s2 + s6); x3 = rs(s3 + s7);
  x4 = rs(s0 - s4); x5 = rs(s1 - s5); x6 = rs(s2 - s6); x7 = rs(s3 - s7);
  s0 = x0; s1 = x1; s2 = x2; s3 = x3;
  s4 = C[8] * x4 + C[24] * x5;
  s5 = C[24] * x4 - C[8] * x5;
  s6 = -C[24] * x6 + C[8] * x7;
  s7 = C[8] * x6 + C[24] * x7;
  x0 = s0 + s2; x1 = s1 + s3; x2 = s0 - s2; x3 = s1 - s3;
  x4 = rs(s4 + s6); x5 = rs(s5 + s7); x6 = rs(s4 - s6); x7 = rs(s5 - s7);
  s2 = C[16] * (x2 + x3);
  s3 = C[16] * (x2 - x3);
  s6 = C[16] * (x6 + x7);
  s7 = C[16] * (x6 - x7);
  x2 = rs(s2); x3 = rs(s3); x6 = rs(s6); x7 = rs(s7);
  out[0] = x0; out[1] = -x4; out[2] = x6; out[3] = -x2;
  out[4] = x3; out[5] = -x7; out[6] = x5; out[7] = -x1;
}

// a*C[p] -/+ b*C[q] rounded: the rotation every butterfly stage uses
inline void rot(int64_t a, int64_t b, int p, int q, int64_t& lo,
                int64_t& hi) {
  lo = rs(a * C[p] - b * C[q]);
  hi = rs(a * C[q] + b * C[p]);
}

inline void idct16(const int64_t* in, int64_t* out) {
  int64_t a[16], b[16];
  const int perm[16] = {0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15};
  for (int i = 0; i < 16; ++i) a[i] = in[perm[i]];
  // stage 2
  for (int i = 0; i < 8; ++i) b[i] = a[i];
  rot(a[8], a[15], 30, 2, b[8], b[15]);
  rot(a[9], a[14], 14, 18, b[9], b[14]);
  rot(a[10], a[13], 22, 10, b[10], b[13]);
  rot(a[11], a[12], 6, 26, b[11], b[12]);
  // stage 3
  for (int i = 0; i < 4; ++i) a[i] = b[i];
  rot(b[4], b[7], 28, 4, a[4], a[7]);
  rot(b[5], b[6], 12, 20, a[5], a[6]);
  a[8] = b[8] + b[9];    a[9] = b[8] - b[9];
  a[10] = -b[10] + b[11]; a[11] = b[10] + b[11];
  a[12] = b[12] + b[13]; a[13] = b[12] - b[13];
  a[14] = -b[14] + b[15]; a[15] = b[14] + b[15];
  // stage 4
  b[0] = rs((a[0] + a[1]) * C[16]);
  b[1] = rs((a[0] - a[1]) * C[16]);
  rot(a[2], a[3], 24, 8, b[2], b[3]);
  b[4] = a[4] + a[5]; b[5] = a[4] - a[5];
  b[6] = -a[6] + a[7]; b[7] = a[6] + a[7];
  b[8] = a[8]; b[15] = a[15];
  b[9] = rs(-a[9] * C[8] + a[14] * C[24]);
  b[14] = rs(a[9] * C[24] + a[14] * C[8]);
  b[10] = rs(-a[10] * C[24] - a[13] * C[8]);
  b[13] = rs(-a[10] * C[8] + a[13] * C[24]);
  b[11] = a[11]; b[12] = a[12];
  // stage 5
  a[0] = b[0] + b[3]; a[1] = b[1] + b[2];
  a[2] = b[1] - b[2]; a[3] = b[0] - b[3];
  a[4] = b[4];
  a[5] = rs((b[6] - b[5]) * C[16]);
  a[6] = rs((b[5] + b[6]) * C[16]);
  a[7] = b[7];
  a[8] = b[8] + b[11]; a[9] = b[9] + b[10];
  a[10] = b[9] - b[10]; a[11] = b[8] - b[11];
  a[12] = -b[12] + b[15]; a[13] = -b[13] + b[14];
  a[14] = b[13] + b[14]; a[15] = b[12] + b[15];
  // stage 6
  for (int i = 0; i < 4; ++i) {
    b[i] = a[i] + a[7 - i];
    b[7 - i] = a[i] - a[7 - i];
  }
  b[8] = a[8]; b[9] = a[9];
  b[10] = rs((-a[10] + a[13]) * C[16]);
  b[13] = rs((a[10] + a[13]) * C[16]);
  b[11] = rs((-a[11] + a[12]) * C[16]);
  b[12] = rs((a[11] + a[12]) * C[16]);
  b[14] = a[14]; b[15] = a[15];
  // stage 7
  for (int i = 0; i < 8; ++i) {
    out[i] = b[i] + b[15 - i];
    out[15 - i] = b[i] - b[15 - i];
  }
}

inline void iadst16(const int64_t* in, int64_t* out) {
  int64_t x[16];
  const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
  int64_t any = 0;
  for (int i = 0; i < 16; ++i) any |= (x[i] = in[perm[i]]);
  if (!any) {
    for (int i = 0; i < 16; ++i) out[i] = 0;
    return;
  }
  int64_t s[16];
  // stage 1: pairs (2k, 2k+1) rotated by cospi (2*(2k)+1) and its complement
  const int c1[8] = {1, 5, 9, 13, 17, 21, 25, 29};
  for (int k = 0; k < 8; ++k) {
    s[2 * k] = x[2 * k] * C[c1[k]] + x[2 * k + 1] * C[32 - c1[k]];
    s[2 * k + 1] = x[2 * k] * C[32 - c1[k]] - x[2 * k + 1] * C[c1[k]];
  }
  for (int k = 0; k < 8; ++k) {
    x[k] = rs(s[k] + s[k + 8]);
    x[k + 8] = rs(s[k] - s[k + 8]);
  }
  // stage 2
  for (int k = 0; k < 8; ++k) s[k] = x[k];
  s[8] = x[8] * C[4] + x[9] * C[28];
  s[9] = x[8] * C[28] - x[9] * C[4];
  s[10] = x[10] * C[20] + x[11] * C[12];
  s[11] = x[10] * C[12] - x[11] * C[20];
  s[12] = -x[12] * C[28] + x[13] * C[4];
  s[13] = x[12] * C[4] + x[13] * C[28];
  s[14] = -x[14] * C[12] + x[15] * C[20];
  s[15] = x[14] * C[20] + x[15] * C[12];
  for (int k = 0; k < 4; ++k) {
    x[k] = s[k] + s[k + 4];
    x[k + 4] = s[k] - s[k + 4];
    x[k + 8] = rs(s[k + 8] + s[k + 12]);
    x[k + 12] = rs(s[k + 8] - s[k + 12]);
  }
  // stage 3
  for (int h = 0; h < 16; h += 8) {
    s[h] = x[h]; s[h + 1] = x[h + 1]; s[h + 2] = x[h + 2]; s[h + 3] = x[h + 3];
    s[h + 4] = x[h + 4] * C[8] + x[h + 5] * C[24];
    s[h + 5] = x[h + 4] * C[24] - x[h + 5] * C[8];
    s[h + 6] = -x[h + 6] * C[24] + x[h + 7] * C[8];
    s[h + 7] = x[h + 6] * C[8] + x[h + 7] * C[24];
    x[h] = s[h] + s[h + 2];
    x[h + 1] = s[h + 1] + s[h + 3];
    x[h + 2] = s[h] - s[h + 2];
    x[h + 3] = s[h + 1] - s[h + 3];
    x[h + 4] = rs(s[h + 4] + s[h + 6]);
    x[h + 5] = rs(s[h + 5] + s[h + 7]);
    x[h + 6] = rs(s[h + 4] - s[h + 6]);
    x[h + 7] = rs(s[h + 5] - s[h + 7]);
  }
  // stage 4
  s[2] = -C[16] * (x[2] + x[3]);
  s[3] = C[16] * (x[2] - x[3]);
  s[6] = C[16] * (x[6] + x[7]);
  s[7] = C[16] * (-x[6] + x[7]);
  s[10] = C[16] * (x[10] + x[11]);
  s[11] = C[16] * (-x[10] + x[11]);
  s[14] = -C[16] * (x[14] + x[15]);
  s[15] = C[16] * (x[14] - x[15]);
  for (int k : {2, 3, 6, 7, 10, 11, 14, 15}) x[k] = rs(s[k]);
  out[0] = x[0];   out[1] = -x[8];  out[2] = x[12];  out[3] = -x[4];
  out[4] = x[6];   out[5] = x[14];  out[6] = x[10];  out[7] = x[2];
  out[8] = x[3];   out[9] = x[11];  out[10] = x[15]; out[11] = x[7];
  out[12] = x[5];  out[13] = -x[13]; out[14] = x[9]; out[15] = -x[1];
}

inline void idct32(const int64_t* in, int64_t* out) {
  int64_t a[32], b[32];
  // stage 1: the even half in bit-reversed order, the odd half rotated
  const int even[16] = {0, 16, 8, 24, 4, 20, 12, 28,
                        2, 18, 10, 26, 6, 22, 14, 30};
  for (int i = 0; i < 16; ++i) a[i] = in[even[i]];
  const int odd[8][2] = {{1, 31}, {17, 15}, {9, 23}, {25, 7},
                         {5, 27}, {21, 11}, {13, 19}, {29, 3}};
  const int cp[8] = {31, 15, 23, 7, 27, 11, 19, 3};
  for (int k = 0; k < 8; ++k)
    rot(in[odd[k][0]], in[odd[k][1]], cp[k], 32 - cp[k], a[16 + k],
        a[31 - k]);
  // stage 2
  for (int i = 0; i < 8; ++i) b[i] = a[i];
  rot(a[8], a[15], 30, 2, b[8], b[15]);
  rot(a[9], a[14], 14, 18, b[9], b[14]);
  rot(a[10], a[13], 22, 10, b[10], b[13]);
  rot(a[11], a[12], 6, 26, b[11], b[12]);
  for (int k = 16; k < 32; k += 4) {
    b[k] = a[k] + a[k + 1];
    b[k + 1] = a[k] - a[k + 1];
    b[k + 2] = -a[k + 2] + a[k + 3];
    b[k + 3] = a[k + 2] + a[k + 3];
  }
  // stage 3
  for (int i = 0; i < 4; ++i) a[i] = b[i];
  rot(b[4], b[7], 28, 4, a[4], a[7]);
  rot(b[5], b[6], 12, 20, a[5], a[6]);
  a[8] = b[8] + b[9];     a[9] = b[8] - b[9];
  a[10] = -b[10] + b[11]; a[11] = b[10] + b[11];
  a[12] = b[12] + b[13];  a[13] = b[12] - b[13];
  a[14] = -b[14] + b[15]; a[15] = b[14] + b[15];
  a[16] = b[16]; a[31] = b[31];
  a[17] = rs(-b[17] * C[4] + b[30] * C[28]);
  a[30] = rs(b[17] * C[28] + b[30] * C[4]);
  a[18] = rs(-b[18] * C[28] - b[29] * C[4]);
  a[29] = rs(-b[18] * C[4] + b[29] * C[28]);
  a[19] = b[19]; a[20] = b[20];
  a[21] = rs(-b[21] * C[20] + b[26] * C[12]);
  a[26] = rs(b[21] * C[12] + b[26] * C[20]);
  a[22] = rs(-b[22] * C[12] - b[25] * C[20]);
  a[25] = rs(-b[22] * C[20] + b[25] * C[12]);
  a[23] = b[23]; a[24] = b[24]; a[27] = b[27]; a[28] = b[28];
  // stage 4
  b[0] = rs((a[0] + a[1]) * C[16]);
  b[1] = rs((a[0] - a[1]) * C[16]);
  rot(a[2], a[3], 24, 8, b[2], b[3]);
  b[4] = a[4] + a[5]; b[5] = a[4] - a[5];
  b[6] = -a[6] + a[7]; b[7] = a[6] + a[7];
  b[8] = a[8]; b[15] = a[15];
  b[9] = rs(-a[9] * C[8] + a[14] * C[24]);
  b[14] = rs(a[9] * C[24] + a[14] * C[8]);
  b[10] = rs(-a[10] * C[24] - a[13] * C[8]);
  b[13] = rs(-a[10] * C[8] + a[13] * C[24]);
  b[11] = a[11]; b[12] = a[12];
  for (int k = 16; k < 32; k += 8) {
    b[k] = a[k] + a[k + 3];          b[k + 1] = a[k + 1] + a[k + 2];
    b[k + 2] = a[k + 1] - a[k + 2];  b[k + 3] = a[k] - a[k + 3];
    b[k + 4] = -a[k + 4] + a[k + 7]; b[k + 5] = -a[k + 5] + a[k + 6];
    b[k + 6] = a[k + 5] + a[k + 6];  b[k + 7] = a[k + 4] + a[k + 7];
  }
  // stage 5
  a[0] = b[0] + b[3]; a[1] = b[1] + b[2];
  a[2] = b[1] - b[2]; a[3] = b[0] - b[3];
  a[4] = b[4];
  a[5] = rs((b[6] - b[5]) * C[16]);
  a[6] = rs((b[5] + b[6]) * C[16]);
  a[7] = b[7];
  a[8] = b[8] + b[11]; a[9] = b[9] + b[10];
  a[10] = b[9] - b[10]; a[11] = b[8] - b[11];
  a[12] = -b[12] + b[15]; a[13] = -b[13] + b[14];
  a[14] = b[13] + b[14]; a[15] = b[12] + b[15];
  a[16] = b[16]; a[17] = b[17];
  a[18] = rs(-b[18] * C[8] + b[29] * C[24]);
  a[29] = rs(b[18] * C[24] + b[29] * C[8]);
  a[19] = rs(-b[19] * C[8] + b[28] * C[24]);
  a[28] = rs(b[19] * C[24] + b[28] * C[8]);
  a[20] = rs(-b[20] * C[24] - b[27] * C[8]);
  a[27] = rs(-b[20] * C[8] + b[27] * C[24]);
  a[21] = rs(-b[21] * C[24] - b[26] * C[8]);
  a[26] = rs(-b[21] * C[8] + b[26] * C[24]);
  a[22] = b[22]; a[23] = b[23]; a[24] = b[24]; a[25] = b[25];
  a[30] = b[30]; a[31] = b[31];
  // stage 6
  for (int i = 0; i < 4; ++i) {
    b[i] = a[i] + a[7 - i];
    b[7 - i] = a[i] - a[7 - i];
  }
  b[8] = a[8]; b[9] = a[9];
  b[10] = rs((-a[10] + a[13]) * C[16]);
  b[13] = rs((a[10] + a[13]) * C[16]);
  b[11] = rs((-a[11] + a[12]) * C[16]);
  b[12] = rs((a[11] + a[12]) * C[16]);
  b[14] = a[14]; b[15] = a[15];
  for (int i = 0; i < 4; ++i) {
    b[16 + i] = a[16 + i] + a[23 - i];
    b[23 - i] = a[16 + i] - a[23 - i];
    b[24 + i] = -a[24 + i] + a[31 - i];
    b[31 - i] = a[24 + i] + a[31 - i];
  }
  // stage 7
  for (int i = 0; i < 8; ++i) {
    a[i] = b[i] + b[15 - i];
    a[15 - i] = b[i] - b[15 - i];
  }
  for (int i = 16; i < 20; ++i) a[i] = b[i];
  for (int i = 0; i < 4; ++i) {
    a[20 + i] = rs((-b[20 + i] + b[27 - i]) * C[16]);
    a[27 - i] = rs((b[20 + i] + b[27 - i]) * C[16]);
  }
  for (int i = 28; i < 32; ++i) a[i] = b[i];
  // final stage
  for (int i = 0; i < 16; ++i) {
    out[i] = a[i] + a[31 - i];
    out[31 - i] = a[i] - a[31 - i];
  }
}

using Tx1d = void (*)(const int64_t*, int64_t*);

// The 2-D inverse transform of the n*n coefficients (row-major, int16 as
// the decoders store them) added to dst: each row transformed by `rows`,
// then each column by `cols` and rounded by `shift`.  tx_type 0: DCT both
// ways; 1: ADST down the columns; 2: ADST along the rows; 3: ADST both.
inline void inverse_add(const int16_t* coef, int n, int tx_type,
                        uint8_t* dst, int stride) {
  Tx1d dct = n == 4 ? idct4 : n == 8 ? idct8 : n == 16 ? idct16 : idct32;
  Tx1d adst = n == 4 ? iadst4 : n == 8 ? iadst8 : iadst16;
  Tx1d rows = (tx_type & 2) ? adst : dct, cols = (tx_type & 1) ? adst : dct;
  const int shift = n == 4 ? 4 : n == 8 ? 5 : 6;
  if (!tx_type) {  // a DC coefficient alone: every output the same
    bool dc_only = true;
    for (int i = 1; i < n * n && dc_only; ++i) dc_only = !coef[i];
    if (dc_only) {
      const int64_t v = rs(rs(coef[0] * C[16]) * C[16]);
      const int add = static_cast<int>((v + (1 << (shift - 1))) >> shift);
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
          dst[i * stride + j] = clip8(dst[i * stride + j] + add);
      return;
    }
  }
  int64_t tmp[32 * 32], in[32], out[32];
  for (int i = 0; i < n; ++i) {
    bool any = false;
    for (int j = 0; j < n; ++j) any |= (in[j] = coef[i * n + j]) != 0;
    if (!any) {
      for (int j = 0; j < n; ++j) tmp[i * n + j] = 0;
      continue;
    }
    rows(in, out);
    for (int j = 0; j < n; ++j) tmp[i * n + j] = out[j];
  }
  for (int j = 0; j < n; ++j) {
    for (int i = 0; i < n; ++i) in[i] = tmp[i * n + j];
    cols(in, out);
    for (int i = 0; i < n; ++i) {
      uint8_t& p = dst[i * stride + j];
      p = clip8(p + static_cast<int>((out[i] + (1 << (shift - 1))) >> shift));
    }
  }
}

// The lossless 4x4 inverse Walsh-Hadamard transform added to dst.
inline void iwht4_add(const int16_t* coef, uint8_t* dst, int stride) {
  int64_t t[16];
  for (int i = 0; i < 4; ++i) {
    int64_t a = coef[i * 4] >> 2, c = coef[i * 4 + 1] >> 2,
            d = coef[i * 4 + 2] >> 2, b = coef[i * 4 + 3] >> 2;
    a += c;
    d -= b;
    const int64_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    t[i * 4] = a; t[i * 4 + 1] = b; t[i * 4 + 2] = c; t[i * 4 + 3] = d;
  }
  for (int j = 0; j < 4; ++j) {
    int64_t a = t[j], c = t[4 + j], d = t[8 + j], b = t[12 + j];
    a += c;
    d -= b;
    const int64_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    const int64_t v[4] = {a, b, c, d};
    for (int i = 0; i < 4; ++i)
      dst[i * stride + j] = clip8(dst[i * stride + j] + static_cast<int>(v[i]));
  }
}

// ---------------------------------------------------------- intra predictors

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED,
       D207_PRED, D63_PRED, TM_PRED };

inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }
inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}

// Predict an n*n block into dst from above[-1..2n-1] (above[-1] the
// top-left) and left[0..n-1]; for DC, have_above/have_left pick the
// variant.
inline void intra_predict(int mode, int n, const uint8_t* above,
                          const uint8_t* left, bool have_above,
                          bool have_left, uint8_t* dst, int stride) {
  switch (mode) {
    case DC_PRED: {
      int v = 128;
      const int lg = n == 4 ? 2 : n == 8 ? 3 : n == 16 ? 4 : 5;
      if (have_above && have_left) {
        int s = 0;
        for (int i = 0; i < n; ++i) s += above[i] + left[i];
        v = (s + n) >> (lg + 1);
      } else if (have_above || have_left) {
        const uint8_t* e = have_above ? above : left;
        int s = 0;
        for (int i = 0; i < n; ++i) s += e[i];
        v = (s + (n >> 1)) >> lg;
      }
      for (int r = 0; r < n; ++r) std::memset(dst + r * stride, v, n);
      break;
    }
    case V_PRED:
      for (int r = 0; r < n; ++r) std::memcpy(dst + r * stride, above, n);
      break;
    case H_PRED:
      for (int r = 0; r < n; ++r) std::memset(dst + r * stride, left[r], n);
      break;
    case TM_PRED:
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c)
          dst[r * stride + c] = clip8(left[r] + above[c] - above[-1]);
      break;
    case D45_PRED:
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c)
          dst[r * stride + c] =
              r + c + 2 < 2 * n
                  ? avg3(above[r + c], above[r + c + 1], above[r + c + 2])
                  : above[2 * n - 1];
      break;
    case D63_PRED:
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c) {
          const int i = (r >> 1) + c;
          dst[r * stride + c] = (r & 1) ? avg3(above[i], above[i + 1], above[i + 2])
                                        : avg2(above[i], above[i + 1]);
        }
      break;
    case D207_PRED: {
      uint8_t col[64];
      // column 0 then 1 (averages down the left edge), then the rest
      // copied from the row above and one pair to the right
      for (int r = 0; r < n - 1; ++r) col[2 * r] = avg2(left[r], left[r + 1]);
      col[2 * (n - 1)] = left[n - 1];
      for (int r = 0; r < n - 2; ++r)
        col[2 * r + 1] = avg3(left[r], left[r + 1], left[r + 2]);
      col[2 * (n - 2) + 1] = avg3(left[n - 2], left[n - 1], left[n - 1]);
      col[2 * (n - 1) + 1] = left[n - 1];
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c) {
          const int k = 2 * r + c;
          dst[r * stride + c] = k < 2 * n ? col[k] : left[n - 1];
        }
      break;
    }
    case D135_PRED: {
      // the edge from bottom-left through the corner to the top-right
      uint8_t e[2 * 32 + 1];
      for (int i = 0; i < n; ++i) e[i] = left[n - 1 - i];
      e[n] = above[-1];
      for (int i = 0; i < n; ++i) e[n + 1 + i] = above[i];
      uint8_t f[2 * 32 + 1];
      f[0] = avg3(e[0], e[0], e[1]);  // unused corner
      for (int i = 1; i < 2 * n; ++i) f[i] = avg3(e[i - 1], e[i], e[i + 1]);
      for (int r = 0; r < n; ++r)
        for (int c = 0; c < n; ++c) dst[r * stride + c] = f[n + c - r];
      break;
    }
    case D117_PRED:
      for (int c = 0; c < n; ++c) dst[c] = avg2(above[c - 1], above[c]);
      dst[stride] = avg3(left[0], above[-1], above[0]);
      for (int c = 1; c < n; ++c)
        dst[stride + c] = avg3(above[c - 2], above[c - 1], above[c]);
      if (n > 2) {
        dst[2 * stride] = avg3(above[-1], left[0], left[1]);
        for (int r = 3; r < n; ++r)
          dst[r * stride] = avg3(left[r - 3], left[r - 2], left[r - 1]);
      }
      for (int r = 2; r < n; ++r)
        for (int c = 1; c < n; ++c)
          dst[r * stride + c] = dst[(r - 2) * stride + c - 1];
      break;
    case D153_PRED:
      dst[0] = avg2(above[-1], left[0]);
      for (int r = 1; r < n; ++r) dst[r * stride] = avg2(left[r - 1], left[r]);
      dst[1] = avg3(left[0], above[-1], above[0]);
      dst[stride + 1] = avg3(above[-1], left[0], left[1]);
      for (int r = 2; r < n; ++r)
        dst[r * stride + 1] = avg3(left[r - 2], left[r - 1], left[r]);
      for (int c = 2; c < n; ++c)
        dst[c] = avg3(above[c - 3], above[c - 2], above[c - 1]);
      for (int r = 1; r < n; ++r)
        for (int c = 2; c < n; ++c)
          dst[r * stride + c] = dst[(r - 1) * stride + c - 2];
      break;
  }
}

// ------------------------------------------------------------ motion filters

// One row of w outputs of the 8-tap filter f over s[-3 .. w + 4) (step
// `step` between taps), rounded to 8 bits; taps outer, pixels inner, so
// that the compiler vectorises it.
inline void filter_row(const uint8_t* s, int step, int w, const int16_t* f,
                       uint8_t* out) {
  int32_t acc[64];
  for (int c = 0; c < w; ++c) acc[c] = 64;
  for (int t = 0; t < 8; ++t) {
    const int32_t ft = f[t];
    const uint8_t* p = s + (t - 3) * step;
    for (int c = 0; c < w; ++c) acc[c] += p[c] * ft;
  }
  for (int c = 0; c < w; ++c) out[c] = clip8(acc[c] >> 7);
}

// One block of w*h from src (stride ss) at subpel phases (fx, fy) in 1/16
// with the 8-tap kernels k: the horizontal pass rounded to 8 bits over
// h + 7 rows, then the vertical one; phase 0 is the identity.  With avg
// the result is averaged (rounding up) into dst, as compound prediction
// averages its second reference.
inline void convolve(const uint8_t* src, int ss, uint8_t* dst, int ds, int w,
                     int h, const int16_t (*k)[8], int fx, int fy, bool avg) {
  uint8_t tmp[(64 + 7) * 64], row[64];
  const uint8_t* v_src = src;  // the rows the vertical pass reads
  int v_stride = ss;
  if (fx) {
    const uint8_t* s = fy ? src - 3 * ss : src;
    const int rows = fy ? h + 7 : h;
    for (int r = 0; r < rows; ++r, s += ss)
      filter_row(s, 1, w, k[fx], tmp + r * 64);
    v_src = fy ? tmp + 3 * 64 : tmp;
    v_stride = 64;
  }
  for (int r = 0; r < h; ++r) {
    const uint8_t* out = v_src + r * v_stride;
    if (fy) {
      filter_row(v_src + r * v_stride, v_stride, w, k[fy], row);
      out = row;
    }
    uint8_t* d = dst + r * ds;
    if (avg)
      for (int c = 0; c < w; ++c)
        d[c] = static_cast<uint8_t>((d[c] + out[c] + 1) >> 1);
    else
      std::memcpy(d, out, w);
  }
}

// ------------------------------------------------------------- loop filters

struct Thresh {
  int mblim, lim, hev;
};

inline int8_t sclamp(int t) {
  return static_cast<int8_t>(t < -128 ? -128 : (t > 127 ? 127 : t));
}

// One line across an edge: p[-k*s] are p_{k-1}, p[k*s] are q_k.  `wd` is
// 4, 8 or 16, the widest filter the edge allows.
inline void filter_line(uint8_t* p, int s, int wd, const Thresh& t) {
  const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
  const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
  // the filter mask: every step within the interior limit and the edge
  // within the edge limit
  if (std::abs(p3 - p2) > t.lim || std::abs(p2 - p1) > t.lim ||
      std::abs(p1 - p0) > t.lim || std::abs(q1 - q0) > t.lim ||
      std::abs(q2 - q1) > t.lim || std::abs(q3 - q2) > t.lim ||
      std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > t.mblim)
    return;
  const bool flat = wd >= 8 && std::abs(p1 - p0) <= 1 &&
                    std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
                    std::abs(q2 - q0) <= 1 && std::abs(p3 - p0) <= 1 &&
                    std::abs(q3 - q0) <= 1;
  if (flat && wd == 16) {
    int x[16];
    for (int i = 0; i < 16; ++i) x[i] = p[(i - 8) * s];
    bool flat2 = true;
    for (int i : {0, 1, 2, 3}) flat2 &= std::abs(x[i] - p0) <= 1;
    for (int i : {12, 13, 14, 15}) flat2 &= std::abs(x[i] - q0) <= 1;
    if (flat2) {
      // 15-tap: each output the window of 15 around it plus itself, the
      // ends replicated; the window slides one pixel per output
      int win = 7 * x[0];
      for (int j = 1; j <= 8; ++j) win += x[j];
      for (int i = 1; i < 15; ++i) {
        p[(i - 8) * s] = static_cast<uint8_t>((win + x[i] + 8) >> 4);
        win += x[i + 8 > 15 ? 15 : i + 8] - x[i - 7 < 0 ? 0 : i - 7];
      }
      return;
    }
  }
  if (flat) {
    p[-3 * s] = static_cast<uint8_t>((p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3);
    p[-2 * s] = static_cast<uint8_t>((p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3);
    p[-s] = static_cast<uint8_t>((p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3);
    p[0] = static_cast<uint8_t>((p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3);
    p[s] = static_cast<uint8_t>((p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3);
    p[2 * s] = static_cast<uint8_t>((p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3);
    return;
  }
  const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
  const bool hev = std::abs(p1 - p0) > t.hev || std::abs(q1 - q0) > t.hev;
  int f = hev ? sclamp(ps1 - qs1) : 0;
  f = sclamp(f + 3 * (qs0 - ps0));
  const int f1 = sclamp(f + 4) >> 3, f2 = sclamp(f + 3) >> 3;
  p[0] = static_cast<uint8_t>(sclamp(qs0 - f1) + 128);
  p[-s] = static_cast<uint8_t>(sclamp(ps0 + f2) + 128);
  if (!hev) {
    const int f3 = (f1 + 1) >> 1;
    p[s] = static_cast<uint8_t>(sclamp(qs1 - f3) + 128);
    p[-2 * s] = static_cast<uint8_t>(sclamp(ps1 + f3) + 128);
  }
}

}  // namespace vp9_dsp

#endif  // SLAM_NATIVE_VP9_DSP_H_
