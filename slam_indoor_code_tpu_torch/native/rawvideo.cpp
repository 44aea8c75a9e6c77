// rawvideo — uncompressed planar YUV 4:2:0 frames (I420, IYUV: the Y plane,
// then U, then V, each chroma plane ceil(w/2) x ceil(h/2), no row padding)
// to packed RGB as OpenCV's FFmpeg backend returns them (swscale_rgb.h),
// with no library but the C++ standard library.
//
// C ABI; Python binds it through ctypes (io/rawvideo.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o librawvideo.so rawvideo.cpp

#include <cstdint>

#include "swscale_rgb.h"

extern "C" {

// One I420 frame of w x h in `frame` (n bytes) to h*w*3 RGB bytes.  0:
// done; 1: the frame is shorter than an I420 frame of that size; 4: cap
// is smaller than h*w*3.
int rawvideo_i420_rgb(const uint8_t* frame, int64_t n, int w, int h,
                      uint8_t* rgb, int64_t cap) {
  const int64_t cw = (w + 1) / 2, ch = (h + 1) / 2;
  const int64_t luma = int64_t(w) * h, chroma = cw * ch;
  if (n < luma + 2 * chroma) return 1;
  if (luma * 3 > cap) return 4;
  swscale_rgb::to_rgb(frame, w, frame + luma, frame + luma + chroma,
                      static_cast<int>(cw), w, h, rgb);
  return 0;
}

}  // extern "C"
