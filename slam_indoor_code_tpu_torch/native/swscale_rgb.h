// swscale_rgb.h — YUV 4:2:0 -> packed RGB as OpenCV's FFmpeg backend
// returns it (sws_scale yuv420p -> bgr24, SWS_BICUBIC, same size, on x86,
// with sws_setColorspaceDetails given the frame's matrix), written with R
// first: at an even height libswscale's unscaled converter (limited range,
// 16-bit fixed point, one chroma sample per 2x2 block); at an odd height
// its scaling path, bicubic chroma.  The matrix is BT.601 (unknown,
// BT.470BG and SMPTE 170M take it too) or BT.709.  Shared by the decoders
// of this directory (mpeg4.cpp, mpeg12.cpp, vp8.cpp, vp9.cpp,
// rawvideo.cpp); header-only, no library but the C++ standard one.

#ifndef SLAM_NATIVE_SWSCALE_RGB_H_
#define SLAM_NATIVE_SWSCALE_RGB_H_

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

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

// libswscale's ff_yuv2rgb_coeffs (crv, cbu, cgu, cgv) for a matrix.
enum Matrix { kBt601 = 0, kBt709 = 1 };
inline const int64_t* coeffs(Matrix m) {
  static const int64_t k[2][4] = {{104597, 132201, 25675, 53279},
                                  {117489, 138438, 13975, 34925}};
  return k[m];
}

inline int round16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return static_cast<int>(std::clamp<int64_t>(r, -0x8000, 0x7FFF));
}

struct Colour {
  int y_coeff, y_offset, v2r, u2g, v2g, u2b;
  explicit Colour(Matrix m = kBt601) {
    const int64_t* c = coeffs(m);
    const int64_t crv = c[0], cbu = c[1], cgu = -c[2], cgv = -c[3];
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
inline const Colour& colour(Matrix m) {
  static const Colour k[2] = {Colour(kBt601), Colour(kBt709)};
  return k[m];
}

// `vshift` 1: a chroma row per two luma rows (4:2:0); 0: one per luma row
// (4:2:2, which swscale's unscaled converter takes the same way).
inline void unscaled(const uint8_t* py, int ys, const uint8_t* pu,
                     const uint8_t* pv, int cs, int w, int h, uint8_t* out,
                     Matrix m, int vshift = 1) {
  const Colour& k = colour(m);
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
    const uint8_t* ur = pu + int64_t(y >> vshift) * cs;
    const uint8_t* vr = pv + int64_t(y >> vshift) * cs;
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


// ------------------------------------------------------- the scaled path
// At an odd height swscale does not take the unscaled converter: it scales
// yuv420p to bgr24 at the same size with OpenCV's SWS_BICUBIC, which
// leaves luma and (at an even width, where two pixels share a chroma
// sample) horizontal chroma as they are and upsamples chroma vertically
// with a bicubic filter.  At an odd width it also forces full horizontal
// chroma (SWS_FULL_CHR_H_INT), upsampling chroma horizontally with the same
// filter.

// libswscale's initFilter for a bicubic (B 0, C 0.6) scaler of src to dst
// samples with step x_inc (16.16), the source and output sample centres at
// src_pos and dst_pos (1/256 of a sample; 128: the middle): each output's
// first source sample (pos) and `size` coefficients summing to `one`
// (coef, size per output); the identity where nothing moves.
struct Filter {
  int size = 0;
  std::vector<int> pos;
  std::vector<int> coef;
};

inline Filter init_filter(int src, int dst, int64_t x_inc, int align, int one,
                          bool vertical, int src_pos = 128,
                          int dst_pos = 128) {
  const int64_t fone = int64_t(1) << 54;  // an upscale
  const int64_t B = 0, C = static_cast<int64_t>(0.6 * (1 << 24));
  const bool same = std::abs(x_inc - 0x10000) < 10 && src_pos == dst_pos;
  int size = same ? 1 : std::max(std::min(5, src - 2), 1);
  std::vector<int64_t> f(size_t(dst) * size);
  std::vector<int> pos(dst);
  int64_t in_src = ((dst_pos * x_inc) >> 7) - ((src_pos * 0x10000LL) >> 7);
  for (int i = 0; i < dst && same; ++i) {
    f[i] = fone;
    pos[i] = i;
  }
  for (int i = 0; i < dst && !same; ++i) {
    int64_t xx = (in_src - (size - 2) * (int64_t(1) << 16)) / (1 << 17);
    pos[i] = static_cast<int>(xx);
    for (int j = 0; j < size; ++j, ++xx) {
      int64_t d = std::abs(xx * (1 << 17) - in_src) << 13;
      int64_t c = 0;
      if (d < int64_t(1) << 31) {
        int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
        if (d < int64_t(1) << 30)
          c = (12 * (1 << 24) - 9 * B - 6 * C) * ddd +
              (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
              (6 * (1 << 24) - 2 * B) * (int64_t(1) << 30);
        else
          c = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
              (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (int64_t(1) << 30);
      }
      f[size_t(i) * size + j] = c;  // / ((1 << 54) / fone) = / 1
    }
    in_src += 2 * x_inc;
  }
  // drop near-zero coefficients at the left and count them at the right
  const double cut = 0.002 * static_cast<double>(fone);
  int min_size = 0;
  for (int i = dst - 1; i >= 0; --i) {
    int64_t* r = &f[size_t(i) * size];
    int m = size;
    int64_t acc = 0;
    for (int j = 0; j < size; ++j) {
      acc += std::abs(r[0]);
      if (static_cast<double>(acc) > cut) break;
      if (i < dst - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < size; ++k) r[k - 1] = r[k];
      r[size - 1] = 0;
      ++pos[i];
    }
    acc = 0;
    for (int j = size - 1; j > 0; --j) {
      acc += std::abs(r[j]);
      if (static_cast<double>(acc) > cut) break;
      --m;
    }
    min_size = std::max(min_size, m);
  }
  if (vertical && min_size == 1 && align == 2) align = 1;
  const int n = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> g(size_t(dst) * n, 0);
  for (int i = 0; i < dst; ++i)
    for (int j = 0; j < n && j < size; ++j)
      g[size_t(i) * n + j] = f[size_t(i) * size + j];
  // the borders: coefficients past either end folded onto the edge sample
  for (int i = 0; i < dst; ++i) {
    int64_t* r = &g[size_t(i) * n];
    if (pos[i] < 0) {
      for (int j = 1; j < n; ++j) {
        int left = std::max(j + pos[i], 0);
        r[left] += r[j];
        r[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + n > src) {
      int shift = pos[i] + std::min(n - src, 0);
      int64_t acc = 0;
      for (int j = n - 1; j >= 0; --j)
        if (pos[i] + j >= src) {
          acc += r[j];
          r[j] = 0;
        }
      for (int j = n - 1; j >= 0; --j) r[j] = j < shift ? 0 : r[j - shift];
      pos[i] -= shift;
      r[src - 1 - pos[i]] += acc;
    }
  }
  // normalised to `one`, the rounding error carried along the taps
  Filter out;
  out.size = n;
  out.pos = pos;
  out.coef.assign(size_t(dst) * n, 0);
  for (int i = 0; i < dst; ++i) {
    const int64_t* r = &g[size_t(i) * n];
    int64_t sum = 0;
    for (int j = 0; j < n; ++j) sum += r[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    int64_t err = 0;
    for (int j = 0; j < n; ++j) {
      int64_t v = r[j] + err;
      int64_t q = (v >= 0 ? v + (sum >> 1) : v - (sum >> 1)) / sum;
      out.coef[size_t(i) * n + j] = static_cast<int>(q);
      err = v - q * sum;
    }
  }
  return out;
}

inline int16_t wrap16(int v) { return static_cast<int16_t>(v); }

// swscale's C yuv->rgb tables (ff_yuv2rgb_c_init_tables, 24 bits, limited
// range): R = y[off_r + (V * crv >> 16) + Y] and so on.
struct Tables {
  uint8_t y[2048];
  int64_t crv, cbu, cgu, cgv;
  static constexpr int kYoffs = 326 + 512;
  explicit Tables(Matrix m = kBt601) {
    const int64_t* c = coeffs(m);
    const int64_t cy = (int64_t(1) << 16) * 255 / 219, oy = 16 << 16;
    auto scale = [&](int64_t v) { return (v * (1 << 16) + 0x8000) / cy; };
    crv = scale(c[0]);
    cbu = scale(c[1]);
    cgu = scale(-c[2]);
    cgv = scale(-c[3]);
    int64_t yb = -(384LL << 16) - 512 * cy - oy;
    for (int i = 0; i < 2048; ++i, yb += cy) y[i] = clip8(static_cast<int>((yb + 0x8000) >> 16));
  }
  void pixel(int Y, int U, int V, uint8_t* o) const {
    U = U < 0 ? 0 : U > 255 ? 255 : U;
    V = V < 0 ? 0 : V > 255 ? 255 : V;
    o[0] = y[kYoffs - (crv >> 9) + ((V * crv) >> 16) + Y];
    o[1] = y[kYoffs - (cgu >> 9) + ((U * cgu) >> 16) - (cgv >> 9) +
             ((V * cgv) >> 16) + Y];
    o[2] = y[kYoffs - (cbu >> 9) + ((U * cbu) >> 16) + Y];
  }
};

// Odd height, even width: luma unscaled, chroma upsampled vertically.  The
// rows but the last two go through swscale's x86 MMX vertical scaler and
// converter (each tap's pmulhw on 15-bit samples, a rounder of 4, then the
// unscaled converter's arithmetic on the 8x-scaled sums); the last two
// through its C code (19-bit sums rounded to 8 bits, then the C tables).
// hScale8To15: each row of a chroma plane (ch x cw, stride cs) through the
// horizontal filter `hf` into 15-bit samples (ch x n).
inline void hscale(const uint8_t* p, int cs, int ch, int cw, const Filter& hf,
                   int n, std::vector<int>& out) {
  out.assign(size_t(ch) * n, 0);
  for (int r = 0; r < ch; ++r)
    for (int x = 0; x < n; ++x) {
      int s = 0;
      for (int j = 0; j < hf.size; ++j)
        s += p[int64_t(r) * cs + std::min(hf.pos[x] + j, cw - 1)] *
             hf.coef[size_t(x) * hf.size + j];
      out[size_t(r) * n + x] = std::min(s >> 7, (1 << 15) - 1);
    }
}

inline void scaled_even_width(const uint8_t* py, int ys, const uint8_t* pu,
                              const uint8_t* pv, int cs, int w, int h,
                              bool chroma_left, uint8_t* out, Matrix m) {
  static const Tables tables[2] = {Tables(kBt601), Tables(kBt709)};
  const Colour& k = colour(m);
  const Tables& t = tables[m];
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const Filter vf = init_filter(ch, h, ((int64_t(ch) << 16) + (h >> 1)) / h,
                                2, 4096, true);
  // two pixels share a chroma sample; left-sited chroma is moved to their
  // centre by a horizontal filter
  const Filter hf = init_filter(cw, cw, 0x10000, 4, 1 << 14, false,
                                chroma_left ? 64 : 128, 128);
  std::vector<int> uh, vh;
  hscale(pu, cs, ch, cw, hf, cw, uh);
  hscale(pv, cs, ch, cw, hf, cw, vh);
  std::vector<int> u8(cw), v8(cw);
  for (int y = 0; y < h; ++y) {
    const int* c = &vf.coef[size_t(y) * vf.size];
    const uint8_t* yr = py + int64_t(y) * ys;
    uint8_t* o = out + int64_t(y) * w * 3;
    if (y < h - 2) {
      for (int x = 0; x < cw; ++x) {
        int su = 4, sv = 4;
        for (int j = 0; j < vf.size; ++j) {
          const size_t row = size_t(std::min(vf.pos[y] + j, ch - 1)) * cw;
          su += mulhi(c[j], uh[row + x]);
          sv += mulhi(c[j], vh[row + x]);
        }
        u8[x] = wrap16(su);
        v8[x] = wrap16(sv);
      }
      for (int x = 0; x < w; ++x) {
        const int uu = wrap16(u8[x >> 1] - 1024), vv = wrap16(v8[x >> 1] - 1024);
        const int l = mulhi(wrap16(4 + yr[x] * 8 - k.y_offset), k.y_coeff);
        const int r = mulhi(vv, k.v2r);
        const int g = wrap16(mulhi(uu, k.u2g) + mulhi(vv, k.v2g));
        const int b = mulhi(uu, k.u2b);
        o[3 * x] = clip8(wrap16(l + r));
        o[3 * x + 1] = clip8(wrap16(l + g));
        o[3 * x + 2] = clip8(wrap16(l + b));
      }
      continue;
    }
    for (int x = 0; x < cw; ++x) {
      int64_t su = 1 << 18, sv = 1 << 18;
      for (int j = 0; j < vf.size; ++j) {
        const size_t row = size_t(std::min(vf.pos[y] + j, ch - 1)) * cw;
        su += int64_t(uh[row + x]) * c[j];
        sv += int64_t(vh[row + x]) * c[j];
      }
      u8[x] = static_cast<int>(static_cast<int32_t>(su) >> 19);
      v8[x] = static_cast<int>(static_cast<int32_t>(sv) >> 19);
    }
    for (int x = 0; x < w; ++x) t.pixel(yr[x], u8[x >> 1], v8[x >> 1], o + 3 * x);
  }
}

// Odd height and width: chroma upsampled horizontally (hScale8To15, 15-bit
// samples) and vertically, then swscale's full-chroma C converter
// (yuv2rgb_full_X_c: 10-bit scaled sums, 30-bit RGB clipped and shifted).
inline void scaled_full_chroma(const uint8_t* py, int ys, const uint8_t* pu,
                               const uint8_t* pv, int cs, int w, int h,
                               bool chroma_left, uint8_t* out, Matrix m) {
  const Colour& k0 = colour(m);
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  const Filter hf = init_filter(cw, w, ((int64_t(cw) << 16) + (w >> 1)) / w,
                                4, 1 << 14, false, chroma_left ? 64 : 128);
  const Filter vf = init_filter(ch, h, ((int64_t(ch) << 16) + (h >> 1)) / h,
                                2, 4096, true);
  std::vector<int> uh, vh;
  hscale(pu, cs, ch, cw, hf, w, uh);
  hscale(pv, cs, ch, cw, hf, w, vh);
  const int64_t cy = (int64_t(1) << 16) * 255 / 219;
  const int y_coeff = round16(cy * (1 << 13));
  const int y_offset = round16((int64_t(16) << 16) * (1 << 9));
  auto clip30 = [](int32_t v) {
    return (v & ~((1 << 30) - 1)) ? ((~v) >> 31) & ((1 << 30) - 1) : v;
  };
  for (int y = 0; y < h; ++y) {
    const int* c = &vf.coef[size_t(y) * vf.size];
    const uint8_t* yr = py + int64_t(y) * ys;
    uint8_t* o = out + int64_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      int64_t su = (1 << 9) - (128 << 19), sv = su;
      for (int j = 0; j < vf.size; ++j) {
        const size_t row = size_t(std::min(vf.pos[y] + j, ch - 1)) * w;
        su += int64_t(uh[row + x]) * c[j];
        sv += int64_t(vh[row + x]) * c[j];
      }
      const int32_t U = static_cast<int32_t>(su) >> 10;
      const int32_t V = static_cast<int32_t>(sv) >> 10;
      const int32_t Y =
          ((yr[x] << 9) - y_offset) * y_coeff + (1 << 21);
      int32_t R = static_cast<int32_t>(uint32_t(Y) + uint32_t(V) * uint32_t(k0.v2r));
      int32_t G = static_cast<int32_t>(uint32_t(Y) + uint32_t(V) * uint32_t(k0.v2g) +
                                       uint32_t(U) * uint32_t(k0.u2g));
      int32_t B = static_cast<int32_t>(uint32_t(Y) + uint32_t(U) * uint32_t(k0.u2b));
      if ((R | G | B) & 0xC0000000) {
        R = clip30(R);
        G = clip30(G);
        B = clip30(B);
      }
      o[3 * x] = static_cast<uint8_t>(R >> 22);
      o[3 * x + 1] = static_cast<uint8_t>(G >> 22);
      o[3 * x + 2] = static_cast<uint8_t>(B >> 22);
    }
  }
}

// YUV 4:2:0 -> RGB as OpenCV's FFmpeg backend returns it: the unscaled
// converter at an even height, the scaled path (above) at an odd one.
// `chroma_left`: the decoder reports its chroma sited left of each pixel
// pair (FFmpeg's MPEG-4 decoder does), which OpenCV passes on to the
// scaled path.  Odd heights below 9 take swscale's other vertical paths
// and are not matched.  `m`: the frame's matrix.
inline void to_rgb(const uint8_t* py, int ys, const uint8_t* pu,
                   const uint8_t* pv, int cs, int w, int h, uint8_t* out,
                   bool chroma_left = false, Matrix m = kBt601) {
  if (!(h & 1))
    unscaled(py, ys, pu, pv, cs, w, h, out, m);
  else if (!(w & 1))
    scaled_even_width(py, ys, pu, pv, cs, w, h, chroma_left, out, m);
  else
    scaled_full_chroma(py, ys, pu, pv, cs, w, h, chroma_left, out, m);
}

}  // namespace swscale_rgb

#endif  // SLAM_NATIVE_SWSCALE_RGB_H_
