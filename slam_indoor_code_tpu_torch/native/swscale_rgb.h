// swscale_rgb.h — YUV 4:2:0 -> packed RGB as OpenCV's FFmpeg backend
// returns it: libswscale's unscaled yuv420p -> bgr24 converter on x86 (BT.601
// limited range, 16-bit fixed point, one chroma sample per 2x2 block),
// written with R first.  Shared by the video decoders of this directory
// (mpeg4.cpp, vp8.cpp); header-only, no library but the C++ standard one.

#ifndef SLAM_NATIVE_SWSCALE_RGB_H_
#define SLAM_NATIVE_SWSCALE_RGB_H_

#include <algorithm>
#include <cstdint>

namespace swscale_rgb {

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// swscale's x86 yuv420p -> 24-bit converter: each sample scaled by 8,
// offset, multiplied by a 16-bit coefficient keeping the high half
// (pmulhw), summed with signed saturation (paddsw) and packed with
// unsigned saturation (packuswb).  The coefficients are libswscale's
// ff_yuv2rgb_c_init_tables for BT.601, limited range, default contrast and
// saturation, rounded to 16 bits.

inline int round16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return static_cast<int>(std::clamp<int64_t>(r, -0x8000, 0x7FFF));
}

struct Colour {
  int y_coeff, y_offset, v2r, u2g, v2g, u2b;
  Colour() {
    const int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;
    const int64_t cy = (int64_t(1 << 16) * 255) / 219, oy = 16 << 16;
    y_coeff = round16(cy * (1 << 13));
    y_offset = round16(oy * (1 << 3));
    v2r = round16(crv * (1 << 13));
    u2g = round16(cgu * (1 << 13));
    v2g = round16(cgv * (1 << 13));
    u2b = round16(cbu * (1 << 13));
  }
};

inline int mulhi(int a, int b) { return (a * b) >> 16; }

// Per pixel: R = lum[Y] + cr[V], G = lum[Y] + cg[U][V] (one paddsw of
// the two chroma products), B = lum[Y] + cb[U], each packed to 0..255
// (`clip`); no sum leaves 16 bits, so paddsw's saturation never acts.
inline void to_rgb(const uint8_t* py, int ys, const uint8_t* pu, const uint8_t* pv,
            int cs, int w, int h, uint8_t* out) {
  static const Colour k;
  int lum[256], cr[256], cb[256], ug[256], vg[256];
  // the sums reach -224 (Y 0, V 0) and 534 (Y 255, U 255)
  uint8_t clip_[2048];
  const uint8_t* clip = clip_ + 1024;
  for (int i = -1024; i < 1024; ++i) clip_[i + 1024] = clip8(i);
  for (int i = 0; i < 256; ++i) {
    lum[i] = mulhi(i * 8 - k.y_offset, k.y_coeff);
    cr[i] = mulhi(i * 8 - 1024, k.v2r);
    cb[i] = mulhi(i * 8 - 1024, k.u2b);
    ug[i] = mulhi(i * 8 - 1024, k.u2g);
    vg[i] = mulhi(i * 8 - 1024, k.v2g);
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* yr = py + int64_t(y) * ys;
    const uint8_t* ur = pu + int64_t(y >> 1) * cs;
    const uint8_t* vr = pv + int64_t(y >> 1) * cs;
    uint8_t* o = out + int64_t(y) * w * 3;
    for (int x = 0; x < w; x += 2) {
      int u = ur[x >> 1], v = vr[x >> 1];
      int r = cr[v], g = ug[u] + vg[v], b = cb[u];
      int n = std::min(2, w - x);
      for (int i = 0; i < n; ++i, o += 3) {
        int l = lum[yr[x + i]];
        o[0] = clip[l + r];
        o[1] = clip[l + g];
        o[2] = clip[l + b];
      }
    }
  }
}

}  // namespace swscale_rgb

#endif  // SLAM_NATIVE_SWSCALE_RGB_H_
