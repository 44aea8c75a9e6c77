// lossless_frame.h — the decoded picture of the lossless decoders of this
// directory (ffv1.cpp, huffyuv.cpp) and its conversion to RGB as OpenCV's
// FFmpeg backend returns it: packed BGRA/BGR0 lose their alpha byte (a
// copy, as swscale's unscaled packed converters copy), gray is repeated
// into R, G and B (swscale's gray8 -> bgr24 at the same size), YUV 4:2:0
// goes through swscale_rgb.h, and YUV 4:2:2 at an even height through
// swscale's unscaled converter, which reads it as 4:2:0 with a chroma row
// per luma row.  The layouts whose swscale arithmetic is not reproduced
// here (4:4:4, 4:4:0, 4:1:1, 4:1:0, 4:2:2 at an odd height, gray with
// alpha, 4:2:0 at an odd height below 9) are refused with their names.
// Also what the two decoders' C entry points share: their return codes,
// the error they throw, and the _rgb, _plane and _stats bodies.
// Header-only, no library but the C++ standard one.

#ifndef SLAM_NATIVE_LOSSLESS_FRAME_H_
#define SLAM_NATIVE_LOSSLESS_FRAME_H_

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "swscale_rgb.h"

namespace lossless {

// What the C entry points return: 0 a frame (or done), 1 an empty packet,
// 2 a feature not decoded, 3 data FFmpeg's decoder refuses, 4 no frame or
// a buffer too small.
enum Status {
  kFrame = 0,
  kNoFrame = 1,
  kRefused = 2,
  kFailed = 3,
  kSmall = 4
};

// What a decoder throws: the status its entry point returns, and why.
struct Error {
  Status status;
  std::string msg;
};

inline void put_msg(const std::string& s, char* msg, int len) {
  if (msg && len > 0) snprintf(msg, size_t(len), "%s", s.c_str());
}

// `body`'s status, or that of the Error it throws (its message in `msg`).
template <class Body>
int guarded(Body body, char* msg, int msg_len) {
  try {
    return body();
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    return e.status;
  }
}

inline int mid_pred(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  return std::max(a, std::min(b, c));
}

enum Layout { kNone = 0, kPacked, kGray, kGrayAlpha, kYuv };

struct Frame {
  Layout layout = kNone;
  int w = 0, h = 0;
  int hshift = 0, vshift = 0;  // chroma subsampling (kYuv)
  bool alpha = false;          // kYuv: a fourth plane; kPacked: BGRA
  // kPacked: one plane of w*4 bytes a row, B G R A/0 in memory order;
  // kGray: plane 0; kGrayAlpha: plane 0 with Y and A interleaved;
  // kYuv: planes Y, U, V (and A)
  std::vector<uint8_t> plane[4];
  int stride[4] = {0, 0, 0, 0};

  int chroma_w() const { return -((-w) >> hshift); }
  int chroma_h() const { return -((-h) >> vshift); }

  // Allocate the planes of a layout, zero-filled.
  void reset(Layout l, int width, int height, int hs = 0, int vs = 0,
             bool a = false) {
    layout = l;
    w = width;
    h = height;
    hshift = hs;
    vshift = vs;
    alpha = a;
    for (auto& p : plane) p.clear();
    for (int& s : stride) s = 0;
    if (l == kPacked) {
      stride[0] = w * 4;
      plane[0].assign(size_t(stride[0]) * h, 0);
    } else if (l == kGray || l == kGrayAlpha) {
      stride[0] = l == kGray ? w : 2 * w;
      plane[0].assign(size_t(stride[0]) * h, 0);
    } else if (l == kYuv) {
      stride[0] = w;
      plane[0].assign(size_t(w) * h, 0);
      stride[1] = stride[2] = chroma_w();
      plane[1].assign(size_t(stride[1]) * chroma_h(), 0);
      plane[2].assign(size_t(stride[2]) * chroma_h(), 0);
      if (a) {
        stride[3] = w;
        plane[3].assign(size_t(w) * h, 0);
      }
    }
  }

  // The name FFmpeg gives the pixel format.
  std::string name() const {
    switch (layout) {
      case kPacked:
        return alpha ? "bgra" : "bgr0";
      case kGray:
        return "gray";
      case kGrayAlpha:
        return "ya8";
      case kYuv: {
        const int k = 16 * hshift + vshift;
        std::string s = alpha ? "yuva" : "yuv";
        if (k == 0x00) return s + "444p";
        if (k == 0x01) return s + "440p";
        if (k == 0x10) return s + "422p";
        if (k == 0x11) return s + "420p";
        if (k == 0x20) return s + "411p";
        if (k == 0x22) return s + "410p";
        return s + " with chroma shifts " + std::to_string(hshift) + "," +
               std::to_string(vshift);
      }
      default:
        return "no picture";
    }
  }

  // Empty when to_rgb gives what OpenCV gives; else why it does not.
  std::string rgb_refusal() const {
    if (layout == kPacked || layout == kGray) return "";
    if (layout == kYuv && hshift == 1 && vshift == 1 && (!(h & 1) || h >= 9))
      return "";
    if (layout == kYuv && hshift == 1 && vshift == 0 && !(h & 1)) return "";
    std::string why = "the " + name() + " layout";
    if (layout == kYuv && hshift == 1 && vshift == 0)
      why += " at an odd height";
    if (layout == kYuv && hshift == 1 && vshift == 1)
      why += " at an odd height below 9";
    return why + " (its conversion to RGB by swscale is not reproduced)";
  }

  // h*w*3 RGB; false when the layout is refused (rgb_refusal).
  bool to_rgb(uint8_t* out) const {
    if (!rgb_refusal().empty()) return false;
    if (layout == kPacked) {
      for (int y = 0; y < h; ++y) {
        const uint8_t* s = plane[0].data() + int64_t(y) * stride[0];
        uint8_t* o = out + int64_t(y) * w * 3;
        for (int x = 0; x < w; ++x, s += 4, o += 3) {
          o[0] = s[2];
          o[1] = s[1];
          o[2] = s[0];
        }
      }
    } else if (layout == kGray) {
      for (int y = 0; y < h; ++y) {
        const uint8_t* s = plane[0].data() + int64_t(y) * stride[0];
        uint8_t* o = out + int64_t(y) * w * 3;
        for (int x = 0; x < w; ++x, o += 3) o[0] = o[1] = o[2] = s[x];
      }
    } else if (vshift == 1) {
      swscale_rgb::to_rgb(plane[0].data(), stride[0], plane[1].data(),
                          plane[2].data(), stride[1], w, h, out);
    } else {
      swscale_rgb::unscaled(plane[0].data(), stride[0], plane[1].data(),
                            plane[2].data(), stride[1], w, h, out,
                            swscale_rgb::kBt601, 0);
    }
    return true;
  }
};

// From `seen`, a frame of the same layout holding 1 where a decoder wrote
// a byte, the h*w pixels of the RGB conversion that read written bytes
// only (1) and the others (0): a packed pixel's B, G and R; a YUV pixel's
// Y and the chroma samples the converter reads (4:2:2 and 4:2:0 at an
// even height: the row's own; at an odd height the scaled path's filter
// reaches two chroma rows either side).
inline void rgb_defined(const Frame& seen, uint8_t* mask) {
  const int w = seen.w, h = seen.h;
  for (int y = 0; y < h; ++y) {
    const uint8_t* s0 = seen.plane[0].data() + int64_t(y) * seen.stride[0];
    uint8_t* m = mask + int64_t(y) * w;
    for (int x = 0; x < w; ++x) {
      if (seen.layout == kPacked)
        m[x] = s0[4 * x] & s0[4 * x + 1] & s0[4 * x + 2];
      else if (seen.layout == kGrayAlpha)
        m[x] = s0[2 * x];
      else
        m[x] = s0[x];
    }
    if (seen.layout != kYuv) continue;
    const int reach = seen.vshift == 1 && (h & 1) ? 2 : 0;
    const int ch = seen.chroma_h();
    for (int cy = (y >> seen.vshift) - reach;
         cy <= (y >> seen.vshift) + reach; ++cy) {
      const int r = std::clamp(cy, 0, ch - 1);
      for (int k = 1; k <= 2; ++k) {
        const uint8_t* c = seen.plane[k].data() + int64_t(r) * seen.stride[k];
        for (int x = 0; x < w; ++x) m[x] &= c[x >> seen.hshift];
      }
    }
  }
}

// <prefix>_rgb: frame `f` (null: none given) as h*w*3 RGB bytes.  0:
// done; 2: a layout whose conversion is not reproduced (msg names it,
// after `codec`); 4: cap too small or no frame.
inline int frame_rgb(const Frame* f, const char* codec, uint8_t* rgb,
                     int64_t cap, char* msg, int msg_len) {
  if (!f || int64_t(f->w) * f->h * 3 > cap) return kSmall;
  const std::string why = f->rgb_refusal();
  if (!why.empty()) {
    put_msg(std::string(codec) + " in " + why + " is not decoded", msg,
            msg_len);
    return kRefused;
  }
  f->to_rgb(rgb);
  return kFrame;
}

// <prefix>_plane: plane k (0..3) of frame `f`, its bytes into `dst` (rows
// of *row_bytes, *rows rows).  0: done; 4: no such plane or cap too small.
inline int frame_plane(const Frame* f, int k, uint8_t* dst, int64_t cap,
                       int* row_bytes, int* rows) {
  if (!f || k < 0 || k > 3 || f->plane[k].empty()) return kSmall;
  *row_bytes = f->stride[k];
  *rows = (k == 1 || k == 2) && f->layout == kYuv ? f->chroma_h() : f->h;
  const int64_t n = int64_t(*row_bytes) * *rows;
  if (n > cap) return kSmall;
  memcpy(dst, f->plane[k].data(), size_t(n));
  return kFrame;
}

// <prefix>_stats: the first n of `v` into `out` → how many.
template <size_t N>
int put_stats(const int64_t (&v)[N], int64_t* out, int n) {
  const int m = std::min<int>(n, int(N));
  for (int i = 0; i < m; ++i) out[i] = v[i];
  return m;
}

}  // namespace lossless

#endif  // SLAM_NATIVE_LOSSLESS_FRAME_H_
