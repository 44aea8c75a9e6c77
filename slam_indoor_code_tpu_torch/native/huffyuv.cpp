// huffyuv — a HuffYUV and FFVHuff video decoder (the lossless capture
// codecs of VirtualDub and FFmpeg: what OpenCV's `HFYU` and `FFVH` writers
// and FFmpeg's `huffyuv` and `ffvhuff` encoders store) with no library but
// the C++ standard library.
//
// It gives the pixels FFmpeg's `huffyuv`/`ffvhuff` decoder
// (huffyuvdec.c, huffyuv.c, lossless_videodsp.c) gives, bit for bit:
//   - the code-length tables of the extradata, run-length coded
//     (read_len_table), and the canonical codes FFmpeg builds from them
//     (ff_huffyuv_generate_bits_table); FFVHuff's tables at the start of
//     every frame (context 1);
//   - the 32-bit little-endian words of a packet read most significant
//     bit first, as FFmpeg reads them after its byte swap;
//   - version 2 streams: YUV 4:2:2 (HuffYUV) and 4:2:0 (FFVHuff), each
//     with left, gradient (plane) and median prediction and their rules
//     for a frame's first rows and interlaced strides; RGB24 and RGBA
//     coded bottom-up with the green-based decorrelation, left and
//     gradient prediction;
//   - version 3 (FFVHuff) planar streams of 8-bit samples: gray and
//     YCbCr, each plane predicted left, gradient or median, odd widths
//     included.
// The conversion to RGB is lossless_frame.h's.  What it does not decode
// raises with its name: HuffYUV 1.x's classic tables (no tables in the
// extradata), more than 8 bits a sample, planar RGB, alpha planes,
// median prediction of RGB (FFmpeg's decoder leaves such frames
// undecoded), and the layouts whose conversion lossless_frame.h does not
// reproduce.  A packet shorter than FFmpeg's minimum, or whose tables do
// not parse, gives no frame.
//
// C ABI; Python binds it through ctypes (io/huffyuv.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libhuffyuvdec.so huffyuv.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "lossless_frame.h"

namespace {

using lossless::Error;
using lossless::kFailed;
using lossless::kFrame;
using lossless::kNoFrame;
using lossless::kRefused;
using lossless::mid_pred;
using lossless::Status;

[[noreturn]] void refuse(const std::string& what) {
  throw Error{kRefused, "HuffYUV " + what + " is not decoded"};
}

[[noreturn]] void fail(const std::string& what) {
  throw Error{kFailed, "HuffYUV: " + what};
}

enum Predictor { kLeft = 0, kPlane = 1, kMedian = 2 };
constexpr int kLookupBits = 12;

// ------------------------------------------------------------ bit reader
// FFmpeg's GetBitContext: `size_bits` bits from `buf` (which the caller
// pads with zeros), bits_left going negative past them.
struct Bits {
  const uint8_t* buf = nullptr;
  int64_t size_bits = 0, pos = 0, avail_bits = 0;

  void init(const uint8_t* b, int64_t avail_bytes, int64_t size_bytes) {
    buf = b;
    avail_bits = std::max<int64_t>(avail_bytes, 0) * 8;
    size_bits = std::max<int64_t>(size_bytes, 0) * 8;
    pos = 0;
  }
  int bit_at(int64_t p) const {
    return p < avail_bits ? (buf[p >> 3] >> (7 - (p & 7))) & 1 : 0;
  }
  uint32_t peek32() const {
    if (pos + 40 <= avail_bits && !(pos & 7)) {
      const uint8_t* q = buf + (pos >> 3);
      return (uint32_t(q[0]) << 24) | (uint32_t(q[1]) << 16) |
             (uint32_t(q[2]) << 8) | q[3];
    }
    if (pos + 40 <= avail_bits) {
      const uint8_t* q = buf + (pos >> 3);
      uint64_t v = (uint64_t(q[0]) << 32) | (uint64_t(q[1]) << 24) |
                   (uint64_t(q[2]) << 16) | (uint64_t(q[3]) << 8) | q[4];
      return uint32_t(v >> (8 - (pos & 7)));
    }
    uint32_t v = 0;
    for (int k = 0; k < 32; ++k) v = (v << 1) | uint32_t(bit_at(pos + k));
    return v;
  }
  unsigned get(int n) {
    unsigned v = n ? peek32() >> (32 - n) : 0;
    pos += n;
    return v;
  }
  int64_t left() const { return size_bits - pos; }
};

// One table's canonical code: a 12-bit lookup for the short codes, the
// codes of each length for the long ones.
struct Vlc {
  uint8_t len[256];
  uint32_t code[256];
  uint16_t lookup[1 << kLookupBits];  // (len << 8) | symbol; 0: long code
  int first[33], count[33];
  std::vector<uint8_t> by_len[33];

  // false where FFmpeg refuses the lengths: its generate_bits_table when
  // a length's count is odd, its vlc_init when a code does not fit its
  // length (a table that asks for more codes than fit)
  bool build(int n) {
    int lens[33] = {0};
    uint32_t codes[33];
    for (int i = 0; i < n; ++i) lens[len[i]]++;
    codes[32] = 0;
    for (int i = 32; i > 0; --i) {
      if ((lens[i] + codes[i]) & 1) return false;
      codes[i - 1] = (lens[i] + codes[i]) >> 1;
    }
    for (int i = 0; i < n; ++i) {
      if (!len[i]) continue;
      code[i] = codes[len[i]]++;
      if (code[i] >= (uint64_t(1) << len[i])) return false;
    }
    memset(lookup, 0, sizeof lookup);
    for (int l = 0; l <= 32; ++l) {
      by_len[l].clear();
      count[l] = 0;
      first[l] = 0;
    }
    for (int i = 0; i < n; ++i) {
      const int l = len[i];
      if (!l) continue;
      if (by_len[l].empty()) first[l] = int(code[i]);
      by_len[l].push_back(uint8_t(i));
      count[l]++;
      if (l <= kLookupBits) {
        const uint32_t base = code[i] << (kLookupBits - l);
        for (uint32_t k = 0; k < (1u << (kLookupBits - l)); ++k)
          lookup[base + k] = uint16_t((l << 8) | i);
      }
    }
    return true;
  }

  // A symbol; a code that is no symbol's gives 0 and reads 12 bits.
  int read(Bits& gb) const {
    const uint32_t v = gb.peek32();
    const uint16_t e = lookup[v >> (32 - kLookupBits)];
    if (e) {
      gb.pos += e >> 8;
      return e & 0xFF;
    }
    for (int l = kLookupBits + 1; l <= 32; ++l) {
      if (!count[l]) continue;
      const int64_t c = int64_t(v >> (32 - l)) - first[l];
      if (c >= 0 && c < count[l]) {
        gb.pos += l;
        return by_len[l][size_t(c)];
      }
    }
    gb.pos += kLookupBits;
    return 0;
  }
};

// lossless_videodsp's add_left_pred: the running sum (not reduced mod 256)
int add_left(uint8_t* dst, const uint8_t* src, int w, int acc) {
  for (int i = 0; i < w; ++i) {
    acc += src[i];
    dst[i] = uint8_t(acc);
  }
  return acc;
}

void add_median(uint8_t* dst, const uint8_t* top, const uint8_t* diff, int w,
                int* left, int* left_top) {
  uint8_t l = uint8_t(*left), lt = uint8_t(*left_top);
  for (int i = 0; i < w; ++i) {
    l = uint8_t(mid_pred(l, top[i], (l + top[i] - lt) & 0xFF) + diff[i]);
    lt = top[i];
    dst[i] = l;
  }
  *left = l;
  *left_top = lt;
}

void add_bytes(uint8_t* dst, const uint8_t* src, int w) {
  for (int i = 0; i < w; ++i) dst[i] = uint8_t(dst[i] + src[i]);
}

struct Stats {
  int64_t frames = 0, table_frames = 0, median_rows = 0, plane_rows = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* extra, int64_t n, int width, int height,
          int bits_per_coded_sample);
  Status decode(const uint8_t* buf, int64_t size);
  const lossless::Frame* out() const { return have_ ? &frame_ : nullptr; }
  int width, height;
  int version = 0, predictor = 0, decorrelate = 0, bitstream_bpp = 0,
      interlaced = 0, context = 0, yuv = 0, chroma = 1, alpha = 0,
      hshift = 0, vshift = 0;
  Stats stats;

 private:
  Vlc vlc_[4];
  lossless::Frame frame_;
  bool have_ = false;
  std::vector<uint8_t> swapped_;
  std::vector<uint8_t> temp_[3];
  Bits gb_;

  int64_t read_tables(const uint8_t* p, int64_t n);
  void decode_422(int count);
  void decode_gray(int count);
  void decode_plane_bits(int w, int plane);
  void decode_bgr(int count);
  void yuv_v2();
  void rgb_v2();
  void planar_v3();
};

int64_t Decoder::read_tables(const uint8_t* p, int64_t n) {
  Bits gb;
  gb.init(p, n, n);
  const int count = version > 2 ? 1 + alpha + 2 * chroma : 3;
  for (int t = 0; t < count; ++t) {
    for (int i = 0; i < 256;) {
      int repeat = int(gb.get(3));
      const int val = int(gb.get(5));
      if (repeat == 0) repeat = int(gb.get(8));
      if (i + repeat > 256 || gb.left() < 0) fail("bad Huffman table");
      while (repeat--) vlc_[t].len[i++] = uint8_t(val);
    }
    if (!vlc_[t].build(256)) fail("Huffman table does not make a code");
  }
  return (gb.pos + 7) / 8;
}

Decoder::Decoder(const uint8_t* extra, int64_t n, int w, int h, int bpc)
    : width(w), height(h) {
  if (w <= 0 || h <= 0 || w > 32768 || h > 32768)
    fail("no frame size in the container");
  interlaced = h > 288;
  if (n > 0) {
    if ((bpc & 7) && bpc != 12)
      version = 1;
    else if (n > 3 && extra[3] == 0)
      version = 2;
    else
      version = 3;
  }
  if (version < 2)
    refuse("1.x with its classic tables (no tables in the extradata)");
  if (n < 4) fail("extradata too short");
  decorrelate = (extra[0] & 64) ? 1 : 0;
  predictor = extra[0] & 63;
  if (version == 2) {
    bitstream_bpp = extra[1];
    if (!bitstream_bpp) bitstream_bpp = bpc & ~7;
  } else {
    const int bps = (extra[1] >> 4) + 1;
    hshift = extra[1] & 3;
    vshift = (extra[1] >> 2) & 3;
    yuv = !!(extra[2] & 1);
    chroma = !!(extra[2] & 3);
    alpha = !!(extra[2] & 4);
    if (bps > 8)
      refuse(std::to_string(bps) + "-bit video (OpenCV dithers it to 8 bits)");
  }
  const int il = (extra[2] & 0x30) >> 4;
  interlaced = il == 1 ? 1 : il == 2 ? 0 : interlaced;
  context = (extra[2] & 0x40) ? 1 : 0;
  if (predictor > kMedian) fail("unknown predictor");
  read_tables(extra + 4, n - 4);
  if (version == 2) {
    if (bitstream_bpp == 12) {
      yuv = 1;
      hshift = vshift = 1;
    } else if (bitstream_bpp == 16) {
      yuv = 1;
      hshift = 1;
    } else if (bitstream_bpp == 24 || bitstream_bpp == 32) {
      if (predictor == kMedian)
        refuse("median prediction of RGB (FFmpeg decodes no frame of it)");
    } else {
      fail("bitstream of " + std::to_string(bitstream_bpp) + " bits a pixel");
    }
    if (yuv && (width & 1)) fail("YUV of an odd width");
  } else {
    if (alpha) refuse("video with an alpha plane");
    if (chroma && !yuv) refuse("planar RGB (gbrp)");
  }
}

// READ_2PIX over temp: two symbols, the first of table 0
void Decoder::decode_422(int count) {
  count /= 2;
  uint8_t *y = temp_[0].data(), *u = temp_[1].data(), *v = temp_[2].data();
  const int64_t icount = gb_.left() / (32 * 4);
  if (count >= icount) {
    int i = 0;
    for (; i < icount; ++i) {
      y[2 * i] = uint8_t(vlc_[0].read(gb_));
      u[i] = uint8_t(vlc_[1].read(gb_));
      y[2 * i + 1] = uint8_t(vlc_[0].read(gb_));
      v[i] = uint8_t(vlc_[2].read(gb_));
    }
    for (; i < count && gb_.left() > 0; ++i) {
      y[2 * i] = uint8_t(vlc_[0].read(gb_));
      u[i] = uint8_t(vlc_[1].read(gb_));
      if (gb_.left() <= 0) break;
      y[2 * i + 1] = uint8_t(vlc_[0].read(gb_));
      v[i] = uint8_t(vlc_[2].read(gb_));
    }
    for (; i < count; ++i) y[2 * i] = u[i] = y[2 * i + 1] = v[i] = 0;
  } else {
    for (int i = 0; i < count; ++i) {
      y[2 * i] = uint8_t(vlc_[0].read(gb_));
      u[i] = uint8_t(vlc_[1].read(gb_));
      y[2 * i + 1] = uint8_t(vlc_[0].read(gb_));
      v[i] = uint8_t(vlc_[2].read(gb_));
    }
  }
}

void Decoder::decode_gray(int count) {
  count /= 2;
  uint8_t* y = temp_[0].data();
  if (count >= gb_.left() / (32 * 2)) {
    for (int i = 0; i < count && gb_.left() > 0; ++i) {
      y[2 * i] = uint8_t(vlc_[0].read(gb_));
      y[2 * i + 1] = uint8_t(vlc_[0].read(gb_));
    }
  } else {
    for (int i = 0; i < count; ++i) {
      y[2 * i] = uint8_t(vlc_[0].read(gb_));
      y[2 * i + 1] = uint8_t(vlc_[0].read(gb_));
    }
  }
}

void Decoder::decode_plane_bits(int w, int plane) {
  const int count = w / 2;
  uint8_t* t = temp_[0].data();
  const Vlc& vlc = vlc_[plane];
  if (count >= gb_.left() / (32 * 2)) {
    for (int i = 0; i < count && gb_.left() > 0; ++i) {
      t[2 * i] = uint8_t(vlc.read(gb_));
      t[2 * i + 1] = uint8_t(vlc.read(gb_));
    }
  } else {
    for (int i = 0; i < count; ++i) {
      t[2 * i] = uint8_t(vlc.read(gb_));
      t[2 * i + 1] = uint8_t(vlc.read(gb_));
    }
  }
  if ((w & 1) && gb_.left() > 0) t[w - 1] = uint8_t(vlc.read(gb_));
}

// B G R A in temp: G, then B and R as differences from it (decorrelate),
// then A, all of table 2 but G (table 1) and B (table 0)
void Decoder::decode_bgr(int count) {
  uint8_t* t = temp_[0].data();
  for (int i = 0; i < count && gb_.left() > 0; ++i) {
    if (decorrelate) {
      const int g = vlc_[1].read(gb_);
      t[4 * i + 1] = uint8_t(g);
      t[4 * i + 0] = uint8_t(vlc_[0].read(gb_) + g);
      t[4 * i + 2] = uint8_t(vlc_[2].read(gb_) + g);
    } else {
      t[4 * i + 0] = uint8_t(vlc_[0].read(gb_));
      t[4 * i + 1] = uint8_t(vlc_[1].read(gb_));
      t[4 * i + 2] = uint8_t(vlc_[2].read(gb_));
    }
    if (bitstream_bpp == 32) t[4 * i + 3] = uint8_t(vlc_[2].read(gb_));
  }
}

// Version 2 YUV: 4:2:2 (bitstream_bpp 16) and 4:2:0 (12)
void Decoder::yuv_v2() {
  lossless::Frame& f = frame_;
  uint8_t *Y = f.plane[0].data(), *U = f.plane[1].data(),
          *V = f.plane[2].data();
  const int ys = f.stride[0], us = f.stride[1], vs = f.stride[2];
  const int fy = interlaced ? 2 * ys : ys, fu = interlaced ? 2 * us : us,
            fv = interlaced ? 2 * vs : vs;
  const int w = width, w2 = width >> 1, h = height;
  const uint8_t *t0 = temp_[0].data(), *t1 = temp_[1].data(),
                *t2 = temp_[2].data();
  int leftv = V[0] = uint8_t(gb_.get(8));
  int lefty = Y[1] = uint8_t(gb_.get(8));
  int leftu = U[0] = uint8_t(gb_.get(8));
  Y[0] = uint8_t(gb_.get(8));
  if (predictor == kLeft || predictor == kPlane) {
    decode_422(w - 2);
    lefty = add_left(Y + 2, t0, w - 2, lefty);
    leftu = add_left(U + 1, t1, w2 - 1, leftu);
    leftv = add_left(V + 1, t2, w2 - 1, leftv);
    for (int y = 1, cy = 1; y < h; ++y, ++cy) {
      if (bitstream_bpp == 12) {
        decode_gray(w);
        uint8_t* yd = Y + int64_t(ys) * y;
        lefty = add_left(yd, t0, w, lefty);
        if (predictor == kPlane && y > interlaced) {
          add_bytes(yd, yd - fy, w);
          ++stats.plane_rows;
        }
        if (++y >= h) break;
      }
      uint8_t* yd = Y + int64_t(ys) * y;
      uint8_t* ud = U + int64_t(us) * cy;
      uint8_t* vd = V + int64_t(vs) * cy;
      decode_422(w);
      lefty = add_left(yd, t0, w, lefty);
      leftu = add_left(ud, t1, w2, leftu);
      leftv = add_left(vd, t2, w2, leftv);
      if (predictor == kPlane && cy > interlaced) {
        add_bytes(yd, yd - fy, w);
        add_bytes(ud, ud - fu, w2);
        add_bytes(vd, vd - fv, w2);
        ++stats.plane_rows;
      }
    }
    return;
  }
  // median: the first row but its first two pixels left-predicted
  decode_422(w - 2);
  lefty = add_left(Y + 2, t0, w - 2, lefty);
  leftu = add_left(U + 1, t1, w2 - 1, leftu);
  leftv = add_left(V + 1, t2, w2 - 1, leftv);
  int y = 1, cy = 1;
  if (y >= h) return;
  if (interlaced) {  // the second row left-predicted too
    decode_422(w);
    lefty = add_left(Y + ys, t0, w, lefty);
    leftu = add_left(U + vs, t1, w2, leftu);
    leftv = add_left(V + us, t2, w2, leftv);
    ++y;
    ++cy;
    if (y >= h) return;
  }
  // the next four pixels left-predicted, the rest of the row median
  decode_422(4);
  lefty = add_left(Y + fy, t0, 4, lefty);
  leftu = add_left(U + fu, t1, 2, leftu);
  leftv = add_left(V + fv, t2, 2, leftv);
  int lefttopy = Y[3];
  decode_422(w - 4);
  add_median(Y + fy + 4, Y + 4, t0, w - 4, &lefty, &lefttopy);
  int lefttopu = U[1], lefttopv = V[1];
  add_median(U + fu + 2, U + 2, t1, w2 - 2, &leftu, &lefttopu);
  add_median(V + fv + 2, V + 2, t2, w2 - 2, &leftv, &lefttopv);
  ++stats.median_rows;
  ++y;
  ++cy;
  for (; y < h; ++y, ++cy) {
    if (bitstream_bpp == 12) {
      while (2 * cy > y) {
        decode_gray(w);
        uint8_t* yd = Y + int64_t(ys) * y;
        add_median(yd, yd - fy, t0, w, &lefty, &lefttopy);
        ++stats.median_rows;
        ++y;
      }
      if (y >= h) break;
    }
    decode_422(w);
    uint8_t* yd = Y + int64_t(ys) * y;
    uint8_t* ud = U + int64_t(us) * cy;
    uint8_t* vd = V + int64_t(vs) * cy;
    add_median(yd, yd - fy, t0, w, &lefty, &lefttopy);
    add_median(ud, ud - fu, t1, w2, &leftu, &lefttopu);
    add_median(vd, vd - fv, t2, w2, &leftv, &lefttopv);
    ++stats.median_rows;
  }
}

// Version 2 RGB, coded from the bottom row up
void Decoder::rgb_v2() {
  lossless::Frame& f = frame_;
  const int ls = f.stride[0];
  const int fy = interlaced ? 2 * ls : ls;
  uint8_t* data = f.plane[0].data();
  const int64_t last = int64_t(height - 1) * ls;
  uint8_t left[4];  // B G R A
  if (bitstream_bpp == 32) {
    left[3] = data[last + 3] = uint8_t(gb_.get(8));
    left[2] = data[last + 2] = uint8_t(gb_.get(8));
    left[1] = data[last + 1] = uint8_t(gb_.get(8));
    left[0] = data[last + 0] = uint8_t(gb_.get(8));
  } else {
    left[2] = data[last + 2] = uint8_t(gb_.get(8));
    left[1] = data[last + 1] = uint8_t(gb_.get(8));
    left[0] = data[last + 0] = uint8_t(gb_.get(8));
    left[3] = data[last + 3] = 255;
    gb_.get(8);
  }
  auto add_left_bgr = [&](uint8_t* dst, int w) {
    const uint8_t* s = temp_[0].data();
    uint8_t b = left[0], g = left[1], r = left[2], a = left[3];
    for (int i = 0; i < w; ++i) {
      b = uint8_t(b + s[4 * i]);
      g = uint8_t(g + s[4 * i + 1]);
      r = uint8_t(r + s[4 * i + 2]);
      a = uint8_t(a + s[4 * i + 3]);
      dst[4 * i] = b;
      dst[4 * i + 1] = g;
      dst[4 * i + 2] = r;
      dst[4 * i + 3] = a;
    }
    left[0] = b;
    left[1] = g;
    left[2] = r;
    left[3] = a;
  };
  decode_bgr(width - 1);
  add_left_bgr(data + last + 4, width - 1);
  for (int y = height - 2; y >= 0; --y) {
    decode_bgr(width);
    uint8_t* row = data + int64_t(y) * ls;
    add_left_bgr(row, width);
    if (predictor == kPlane) {
      if (bitstream_bpp != 32) left[3] = 0;
      if (y < height - 1 - interlaced) {
        add_bytes(row, row + fy, 4 * width);
        ++stats.plane_rows;
      }
    }
  }
}

// Version 3: each plane on its own
void Decoder::planar_v3() {
  lossless::Frame& f = frame_;
  const int planes = 1 + 2 * chroma;
  const uint8_t* t = temp_[0].data();
  for (int k = 0; k < planes; ++k) {
    int w = width, h = height;
    if (chroma && (k == 1 || k == 2)) {
      w >>= hshift;
      h >>= vshift;
    }
    uint8_t* base = f.plane[k].data();
    const int ls = f.stride[k];
    const int fs = interlaced ? 2 * ls : ls;
    int left = 0, lefttop = 0;
    if (predictor != kMedian) {
      decode_plane_bits(w, k);
      left = add_left(base, t, w, 0);
      for (int y = 1; y < h; ++y) {
        uint8_t* dst = base + int64_t(ls) * y;
        decode_plane_bits(w, k);
        left = add_left(dst, t, w, left);
        if (predictor == kPlane && y > interlaced) {
          add_bytes(dst, dst - fs, w);
          ++stats.plane_rows;
        }
      }
      continue;
    }
    decode_plane_bits(w, k);
    left = add_left(base, t, w, 0);
    int y = 1;
    if (y >= h) continue;
    if (interlaced) {
      decode_plane_bits(w, k);
      left = add_left(base + ls, t, w, left);
      if (++y >= h) continue;
    }
    lefttop = base[0];
    decode_plane_bits(w, k);
    add_median(base + fs, base, t, w, &left, &lefttop);
    ++stats.median_rows;
    for (++y; y < h; ++y) {
      decode_plane_bits(w, k);
      uint8_t* dst = base + int64_t(ls) * y;
      add_median(dst, dst - fs, t, w, &left, &lefttop);
      ++stats.median_rows;
    }
  }
}

Status Decoder::decode(const uint8_t* buf, int64_t size) {
  have_ = false;
  if (size <= 0) return kNoFrame;
  if (size < (int64_t(width) * height + 7) / 8) fail("packet too small");
  // av_fast_padded_malloc: the buffer is kept while it is large enough,
  // so the bytes a short packet does not reach are the frames' before it
  const int64_t need = size + 64;
  if (need > int64_t(swapped_.size()))
    swapped_.assign(size_t(need + need / 16 + 32), 0);
  memset(swapped_.data() + size, 0, 64);
  const int64_t words = size / 4;
  for (int64_t i = 0; i < words; ++i) {
    uint32_t v;
    memcpy(&v, buf + 4 * i, 4);
    v = __builtin_bswap32(v);
    memcpy(swapped_.data() + 4 * i, &v, 4);
  }
  int64_t table_size = 0;
  if (context) {
    table_size = read_tables(swapped_.data(), size);
    ++stats.table_frames;
  }
  // the bit reader runs over `size` bytes from the tables' end, past the
  // packet into the buffer's older bytes and its zero padding
  gb_.init(swapped_.data() + table_size,
           std::min<int64_t>(size, int64_t(swapped_.size()) - table_size),
           size - table_size);
  for (auto& t : temp_)  // kept from frame to frame, as FFmpeg's
    if (t.size() < size_t(4) * width + 16) t.assign(size_t(4) * width + 16, 0);
  if (version == 2 && !yuv)
    frame_.reset(lossless::kPacked, width, height, 0, 0,
                 bitstream_bpp == 32);
  else if (!chroma)
    frame_.reset(lossless::kGray, width, height);
  else
    frame_.reset(lossless::kYuv, width, height, hshift, vshift);
  if (frame_.layout == lossless::kYuv)  // FFmpeg's padding rows: 4:2:0's
    for (int k = 1; k <= 2; ++k)        // median rows reach chroma row 1
      frame_.plane[k].resize(frame_.plane[k].size() + 2 * frame_.stride[k]);
  if (version > 2)
    planar_v3();
  else if (yuv)
    yuv_v2();
  else
    rgb_v2();
  have_ = true;
  ++stats.frames;
  return kFrame;
}

}  // namespace

extern "C" {

// A decoder for a stream of `width` x `height` frames whose extradata is
// `extra` and bitmap depth `bits_per_coded_sample`.  0: *out set; 2: a
// feature it does not decode, 3: extradata that does not parse (msg says
// which).
int huffyuvdec_open(const uint8_t* extra, int64_t n, int width, int height,
                    int bits_per_coded_sample, void** out, char* msg,
                    int msg_len) {
  *out = nullptr;
  return lossless::guarded(
      [&] {
        *out = new Decoder(extra, n, width, height, bits_per_coded_sample);
        return kFrame;
      },
      msg, msg_len);
}

// Decode one frame.  0: its frame is given, *w and *h set; 1: an empty
// packet; 3: no frame (FFmpeg's decoder refuses the packet; msg says why).
int huffyuvdec_decode(void* handle, const uint8_t* data, int64_t n, int* w,
                      int* h, char* msg, int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  return lossless::guarded(
      [&] {
        const Status st = d->decode(data, n);
        *w = d->width;
        *h = d->height;
        return st;
      },
      msg, msg_len);
}

// The frame last given as h*w*3 RGB bytes (lossless::frame_rgb).
int huffyuvdec_rgb(void* handle, uint8_t* rgb, int64_t cap, char* msg,
                   int msg_len) {
  return lossless::frame_rgb(static_cast<Decoder*>(handle)->out(), "HuffYUV",
                             rgb, cap, msg, msg_len);
}

// Plane k (0..3) of the frame last given (lossless::frame_plane).
int huffyuvdec_plane(void* handle, int k, uint8_t* dst, int64_t cap,
                     int* row_bytes, int* rows) {
  return lossless::frame_plane(static_cast<Decoder*>(handle)->out(), k, dst,
                               cap, row_bytes, rows);
}

// The stream's parameters and what it has used so far, in the order of
// io/huffyuv.py's _STATS.
int huffyuvdec_stats(void* handle, int64_t* out, int n) {
  Decoder* d = static_cast<Decoder*>(handle);
  const Stats& s = d->stats;
  const int64_t v[] = {
      d->version,   d->predictor,  d->decorrelate,    d->bitstream_bpp,
      d->interlaced, d->context,   d->yuv,            d->chroma,
      d->hshift,    d->vshift,     s.frames,          s.table_frames,
      s.plane_rows, s.median_rows};
  return lossless::put_stats(v, out, n);
}

void huffyuvdec_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
