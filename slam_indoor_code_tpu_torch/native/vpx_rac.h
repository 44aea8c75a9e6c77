// vpx_rac.h — the boolean (range) decoder of VP8 and VP9, read as FFmpeg's
// vpx_rac reads it: two bytes at a time; past the packet it reads zeros,
// past its own partition the bytes that follow, as FFmpeg's padded packets
// give them.  ``libwebp_eof`` tells where libwebp's reader would have run
// out of the partition.  Shared by vp8.cpp and vp9.cpp; header-only.

#ifndef SLAM_NATIVE_VPX_RAC_H_
#define SLAM_NATIVE_VPX_RAC_H_

#include <algorithm>
#include <cstdint>

namespace vpx_rac {

class Bool {
 public:
  void init(const uint8_t* p, int64_t n, const uint8_t* frame_end) {
    frame_end_ = frame_end;
    start_ = p;
    size_ = std::max<int64_t>(n, 0);
    buf_ = p;
    end_ = p + std::max<int64_t>(n, 0);
    high_ = 255;
    bits_ = -16;
    end_reached_ = 0;
    code_ = (uint32_t(byte(buf_)) << 16) | (uint32_t(byte(buf_ + 1)) << 8) |
            byte(buf_ + 2);
    buf_ += 3;
  }

  inline int get(int prob) {
    int shift = __builtin_clz(static_cast<unsigned>(high_)) - 24;
    high_ <<= shift;
    code_ <<= shift;
    bits_ += shift;
    if (bits_ >= 0 && buf_ < end_) {
      code_ |= ((uint32_t(byte(buf_)) << 8) | byte(buf_ + 1)) << bits_;
      buf_ += 2;
      bits_ -= 16;
    }
    uint32_t low = 1 + ((static_cast<uint32_t>(high_ - 1) * prob) >> 8);
    uint32_t low_shift = low << 16;
    if (code_ >= low_shift) {
      high_ -= low;
      code_ -= low_shift;
      return 1;
    }
    high_ = low;
    return 0;
  }

  int literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | get(128);
    return v;
  }

  // A flag, an n-bit magnitude and a sign; 0 without the flag.
  int signed_literal(int n) {
    if (!get(128)) return 0;
    int v = literal(n);
    return get(128) ? -v : v;
  }

  int tree(const int8_t* t, const uint8_t* probs) {
    int i = 0;
    while ((i = t[i + get(probs[i >> 1])]) > 0) {
    }
    return -i;
  }

  // FFmpeg's test at each macroblock: the partition read to its end more
  // than ten times.
  bool exhausted() {
    if (end_ <= buf_ && bits_ >= 0) ++end_reached_;
    return end_reached_ > 10;
  }

  // libwebp's eof_ (VP8LoadFinalBytes): set once a read needs a byte past
  // the partition.  libwebp renormalises after each bit and this reader
  // before it, so the shift applied here so far is the one libwebp had at
  // the start of its last read: eof_ is set when that passes all but the
  // partition's last byte (at once for an empty partition).
  bool libwebp_eof() const {
    const int64_t shifted = bits_ + 16 + 8 * (buf_ - start_ - 3);
    return size_ == 0 || shifted > 8 * (size_ - 1);
  }

 private:
  inline uint8_t byte(const uint8_t* p) const {
    return p < frame_end_ ? *p : 0;
  }

  const uint8_t* start_ = nullptr;
  int64_t size_ = 0;
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  const uint8_t* frame_end_ = nullptr;
  int high_ = 255, bits_ = -16, end_reached_ = 0;
  uint32_t code_ = 0;
};

}  // namespace vpx_rac

#endif  // SLAM_NATIVE_VPX_RAC_H_
