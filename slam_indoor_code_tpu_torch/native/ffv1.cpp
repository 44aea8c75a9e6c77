// ffv1 — an FFV1 video decoder (RFC 9043: the lossless intra codec that
// OpenCV's `FFV1` writer, FFmpeg's `ffv1` encoder and archives of
// digitised film and tape store) with no library but the C++ standard
// library.
//
// It gives the pixels FFmpeg's `ffv1` decoder (ffv1dec.c,
// ffv1dec_template.c, ffv1.c, rangecoder.h, golomb.h) gives, bit for bit:
//   - the range coder with its state-transition table, built as
//     ff_build_rac_states builds it, or the custom table of a
//     configuration record or a version 0/1 header (coder 2);
//   - Golomb-Rice coding (coder 0) with its adaptive VLC states and run
//     mode;
//   - contexts from the five quantisation tables (the small and large
//     context models, any table a header carries) and the initial states
//     a configuration record may carry;
//   - version 0 and 1 headers in the first key frame's bitstream; the
//     version 2 and 3 configuration record in the extradata, its CRC-32
//     (version 3); version 2 slice layouts; version 3 slice headers and
//     footers (slice sizes, error status, CRC-32 of each slice when the
//     record asks for it); a slice whose CRC or end does not check is
//     replaced by the previous frame's pixels, and stays so until the next
//     key frame, as FFmpeg replaces it (with no previous frame it is kept
//     as decoded); damage that no check sees decodes as in FFmpeg, whose
//     bit reader reads on past a slice into the packet and whose range
//     coder's "invalid" symbol is a value;
//   - key frames (states reset) and the frames between them (each slice
//     keeps its states from the frame before);
//   - 8-bit YCbCr (gray, 4:2:0, 4:2:2, 4:4:4, 4:4:0, 4:1:1, 4:1:0, with
//     or without alpha) and RGB through JPEG 2000's reversible colour
//     transform (with or without alpha, which OpenCV drops).
// The conversion to RGB is lossless_frame.h's.  What it does not decode
// raises with its name: more than 8 bits a sample, colour spaces other
// than YCbCr and RGB, version 4, chroma subsampling in RGB.  A frame that
// FFmpeg's decoder refuses (a header that does not parse, a non-key frame
// before any key frame, a packet too small for its size, a slice chain
// that does not fit the packet) gives no frame.  Where a slice's data runs
// out (or its header does not parse, or a damaged slice has no previous
// frame to take), FFmpeg stops writing it and leaves its buffer's earlier
// contents there; this decoder leaves zeros and says which pixels it wrote
// (ffv1dec_defined).
//
// C ABI; Python binds it through ctypes (io/ffv1.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libffv1dec.so ffv1.cpp

#include <algorithm>
#include <climits>
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
  throw Error{kRefused, "FFV1 " + what + " is not decoded"};
}

[[noreturn]] void fail(const std::string& what) {
  throw Error{kFailed, "FFV1: " + what};
}

constexpr int kContextSize = 32;
constexpr int kMaxQuantTables = 8;
constexpr int kMaxSlices = 1024;
constexpr int kMaxOverread = 2;
constexpr int kInvalidData = -0x41444E49;  // AVERROR_INVALIDDATA
enum Coder { kGolomb = 0, kRange = 1, kRangeCustom = 2 };

const uint8_t kLog2Run[41] = {0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,
                              2,  3,  3,  3,  3,  4,  4,  5,  5,  6,  6,
                              7,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24};

// ---------------------------------------------------------------- CRC-32
// FFmpeg's AV_CRC_32_IEEE (0x04C11DB7, most significant bit first, no
// final inversion) as av_crc computes it: the register kept byte-swapped.
struct Crc {
  uint32_t t[256];
  Crc() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i << 24;
      for (int j = 0; j < 8; ++j)
        c = (c << 1) ^ ((0x04C11DB7u) & uint32_t(int32_t(c) >> 31));
      t[i] = __builtin_bswap32(c);
    }
  }
  uint32_t operator()(uint32_t crc, const uint8_t* p, int64_t n) const {
    for (int64_t i = 0; i < n; ++i) crc = t[uint8_t(crc) ^ p[i]] ^ (crc >> 8);
    return crc;
  }
};

const Crc& crc32() {
  static const Crc k;
  return k;
}

// ---------------------------------------------------------- range coder
struct RangeCoder {
  const uint8_t* start = nullptr;
  const uint8_t* ptr = nullptr;
  const uint8_t* end = nullptr;
  int low = 0, range = 0, overread = 0;
  uint8_t zero_state[256], one_state[256];

  // ff_init_range_decoder (bytes past the buffer read as FFmpeg's zero
  // padding)
  void init(const uint8_t* buf, int64_t size) {
    start = ptr = buf;
    end = buf + size;
    range = 0xFF00;
    low = ((size > 0 ? buf[0] : 0) << 8) | (size > 1 ? buf[1] : 0);
    ptr += 2;
    overread = 0;
    if (low >= 0xFF00) {
      low = 0xFF00;
      end = ptr;
    }
  }

  // ff_build_rac_states(c, 0.05 * (1LL << 32), 256 - 8)
  void build_states() {
    const int64_t one = int64_t(1) << 32;
    const int64_t factor = int64_t(0.05 * double(one));
    const int max_p = 256 - 8;
    memset(zero_state, 0, sizeof zero_state);
    memset(one_state, 0, sizeof one_state);
    int last_p8 = 0;
    int64_t p = one / 2;
    for (int i = 0; i < 128; ++i) {
      int p8 = int((256 * p + one / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= max_p) one_state[last_p8] = p8;
      p += ((one - p) * factor + one / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; ++i) {
      if (one_state[i]) continue;
      p = (i * one + 128) >> 8;
      p += ((one - p) * factor + one / 2) >> 32;
      int p8 = int((256 * p + one / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > max_p) p8 = max_p;
      one_state[i] = p8;
    }
    for (int i = 1; i < 255; ++i) zero_state[i] = 256 - one_state[256 - i];
  }

  // ff_ffv1_init_slice_state's custom table
  void custom_states(const uint8_t* transition) {
    for (int i = 1; i < 256; ++i) {
      one_state[i] = transition[i];
      zero_state[256 - i] = 256 - one_state[i];
    }
  }

  void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (ptr < end)
        low += *ptr++;
      else
        ++overread;
    }
  }

  int get(uint8_t* state) {
    int range1 = (range * (*state)) >> 8;
    range -= range1;
    if (low < range) {
      *state = zero_state[*state];
      refill();
      return 0;
    }
    low -= range;
    *state = one_state[*state];
    range = range1;
    refill();
    return 1;
  }

  int bit(uint8_t s) { return get(&s); }

  // get_symbol: a value of up to 31 bits with its 32 states; past 31
  // bits, AVERROR_INVALIDDATA as FFmpeg returns it (a slice takes it as a
  // value)
  int symbol(uint8_t* state, bool is_signed) {
    if (get(state + 0)) return 0;
    int e = 0;
    while (get(state + 1 + std::min(e, 9))) {
      if (++e > 31) return kInvalidData;
    }
    unsigned a = 1;
    for (int i = e - 1; i >= 0; --i) a += a + get(state + 22 + std::min(i, 9));
    int neg = -(is_signed && get(state + 11 + std::min(e, 10)));
    return int((a ^ unsigned(neg)) - unsigned(neg));
  }
};

// ------------------------------------------------------------ bit reader
// FFmpeg's checked GetBitContext over `size_bits` bits at `buf`: it reads
// on past them into the rest of the packet (zeros after it: the padding),
// and its position stops 8 bits past the end.  Its 32-bit cache holds the
// four bytes from the current one shifted by the bit offset, so the last
// bits of a long code read as zeros.
struct Bits {
  const uint8_t* buf = nullptr;
  int64_t size_bits = 0, pos = 0, avail = 0;

  void init(const uint8_t* b, int64_t bytes, int64_t avail_bytes) {
    buf = b;
    size_bits = std::max<int64_t>(bytes, 0) * 8;
    avail = std::max<int64_t>(avail_bytes, 0);
    pos = 0;
  }
  uint32_t cache32() const {
    uint32_t v = 0;
    for (int b = 0; b < 4; ++b) {
      const int64_t i = (pos >> 3) + b;
      v = (v << 8) | uint32_t(i < avail ? buf[i] : 0);
    }
    return v << (pos & 7);
  }
  void skip(int64_t n) { pos = std::min(size_bits + 8, pos + n); }
  unsigned get(int n) {
    if (!n) return 0;
    const unsigned v = cache32() >> (32 - n);
    skip(n);
    return v;
  }
  int64_t left() const { return size_bits - pos; }

  // get_ur_golomb(gb, k, 12, esc_len) on that cache
  int ur_golomb(int k, int limit, int esc_len) {
    uint32_t v = cache32();
    const int log = v ? 31 - __builtin_clz(v) : 0;
    if (log > 31 - limit) {
      v >>= (log - k) & 31;
      v += (30u - unsigned(log)) << k;
      skip(32 + k - log);
      return int(v);
    }
    skip(limit);
    return int(get(esc_len)) + limit - 1;
  }
  int sr_golomb(int k, int limit, int esc_len) {
    unsigned v = unsigned(ur_golomb(k, limit, esc_len));
    return int((v >> 1) ^ (0u - (v & 1)));
  }
};

// --------------------------------------------------------------- states
struct VlcState {
  int16_t drift = 0;
  uint16_t error_sum = 4;
  int8_t bias = 0;
  uint8_t count = 1;
};

int fold(int diff, int bits) {
  if (bits == 8) return int8_t(diff);
  const int s = 32 - bits;
  return int(unsigned(diff) << s) >> s;
}

void update_vlc_state(VlcState& st, int v) {
  int drift = st.drift, count = st.count;
  st.error_sum += std::abs(v);
  drift += v;
  if (count == 128) {
    count >>= 1;
    drift >>= 1;
    st.error_sum >>= 1;
  }
  ++count;
  if (drift <= -count) {
    st.bias = std::max(st.bias - 1, -128);
    drift = std::max(drift + count, -count + 1);
  } else if (drift > 0) {
    st.bias = std::min(st.bias + 1, 127);
    drift = std::min(drift - count, 0);
  }
  st.drift = drift;
  st.count = count;
}

int get_vlc_symbol(Bits& gb, VlcState& st, int bits) {
  int i = st.count, k = 0;
  while (i < st.error_sum) {
    ++k;
    i += i;
  }
  int v = gb.sr_golomb(k, 12, bits);
  v ^= (2 * st.drift + st.count) >> 31;
  int ret = fold(v + st.bias, bits);
  update_vlc_state(st, v);
  return ret;
}

struct PlaneCtx {
  int quant_table_index = 0;
  int context_count = 0;
  std::vector<uint8_t> state;      // context_count * 32
  std::vector<VlcState> vlc_state;  // context_count
};

struct Slice {
  int x = 0, y = 0, w = 0, h = 0;
  PlaneCtx plane[4];
  int run_index = 0;
  bool damaged = false;
  RangeCoder c;
};

struct Stats {
  int64_t frames = 0, key_frames = 0, slices = 0, crc_slices = 0,
          damaged_slices = 0, concealed_slices = 0, range_slices = 0,
          golomb_slices = 0, runs = 0, run_pixels = 0, escapes = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* extra, int64_t n, int width, int height)
      : width_(width), height_(height) {
    if (width <= 0 || height <= 0 || width > 32768 || height > 32768)
      fail("no frame size in the container");
    default_rc_.build_states();
    memcpy(transition_, default_rc_.one_state, 256);
    for (int i = 0; i < kMaxQuantTables; ++i) context_count_[i] = 0;
    if (n > 0) read_extra(extra, n);
    setup_slices(num_h_ * num_v_);
  }

  Status decode(const uint8_t* buf, int64_t size);
  const lossless::Frame* out() const { return out_; }
  const lossless::Frame* seen() const { return out_ ? &seen_[cur_] : nullptr; }
  int width() const { return width_; }
  int height() const { return height_; }
  Stats stats;
  int version = 0, micro_version = 0, coder = 0, ec = 0, colorspace = 0,
      bits = 8, chroma_planes = 0, hshift = 0, vshift = 0, transparency = 0,
      quant_table_count = 1, large_context = 0;
  std::string layout_name() const { return frame_[cur_].name(); }

 private:
  int width_, height_;
  RangeCoder default_rc_;
  uint8_t transition_[256];
  int combined_ = 0, plane_count_ = 2, num_h_ = 1, num_v_ = 1, intra_ = 0;
  uint32_t crcref_ = 0;
  int16_t quant_tables_[kMaxQuantTables][5][256];
  int context_count_[kMaxQuantTables];
  std::vector<uint8_t> initial_states_[kMaxQuantTables];
  bool have_initial_ = false;
  bool header_seen_ = false, key_frame_ok_ = false;
  int slice_count_ = 1;
  std::vector<Slice> slices_;
  lossless::Frame frame_[2];
  // which bytes of frame_ the decode wrote (1): FFmpeg leaves the others
  // as its buffer held them
  lossless::Frame seen_[2];
  int cur_ = 0;
  bool have_last_ = false;
  const lossless::Frame* out_ = nullptr;
  const uint8_t* packet_end_ = nullptr;
  std::vector<int> sample_;

  void read_extra(const uint8_t* p, int64_t n);
  int read_quant_table(RangeCoder& c, int16_t* table, int scale);
  int read_quant_tables(RangeCoder& c, int16_t (*tables)[256]);
  void read_header(RangeCoder& c);
  void check_layout();
  void setup_slices(int count);
  bool slice_header(Slice& sc);
  void init_slice_state(Slice& sc);
  void clear_slice_state(Slice& sc);
  void decode_slice(Slice& sc, bool key);
  int decode_line(Slice& sc, Bits& gb, int w, int* s0, int* s1, int plane,
                  int nbits, bool golomb);
  void decode_plane(Slice& sc, Bits& gb, int k, int64_t off, int w, int h,
                    int plane_index, int pixel_stride, bool golomb);
  void decode_rgb(Slice& sc, Bits& gb, int64_t off, int w, int h,
                  bool golomb);
  bool input_end(const RangeCoder& c, const Bits& gb, bool golomb) const {
    return golomb ? gb.left() < 1 : c.overread > kMaxOverread;
  }
};

int Decoder::read_quant_table(RangeCoder& c, int16_t* table, int scale) {
  uint8_t state[kContextSize];
  memset(state, 128, sizeof state);
  int i = 0, v = 0;
  for (v = 0; i < 128; ++v) {
    unsigned len = unsigned(c.symbol(state, false)) + 1u;
    if (len > unsigned(128 - i) || !len) fail("bad quantisation table");
    while (len--) table[i++] = int16_t(scale * v);
  }
  for (i = 1; i < 128; ++i) table[256 - i] = int16_t(-table[i]);
  table[128] = int16_t(-table[127]);
  return 2 * v - 1;
}

int Decoder::read_quant_tables(RangeCoder& c, int16_t (*tables)[256]) {
  int count = 1;
  for (int i = 0; i < 5; ++i) {
    count *= read_quant_table(c, tables[i], count);
    if (unsigned(count) > 32768u) fail("too many contexts");
  }
  return (count + 1) / 2;
}

// The configuration record (versions 2 and 3).
void Decoder::read_extra(const uint8_t* p, int64_t n) {
  RangeCoder c;
  c.init(p, n);
  c.build_states();
  uint8_t state[kContextSize];
  uint8_t state2[kContextSize][kContextSize];
  memset(state, 128, sizeof state);
  memset(state2, 128, sizeof state2);
  version = c.symbol(state, false);
  if (version < 2) fail("configuration record of version below 2");
  if (version > 3) refuse("version " + std::to_string(version));
  if (version > 2 && (n < 4 || crc32()(0, p, n) != 0) &&
      crc32()(0x7a8c4079, p, n) != 0x7a8c4079)
    fail("configuration record CRC mismatch");
  combined_ = version << 16;
  if (version > 2) {
    c.end -= 4;
    micro_version = c.symbol(state, false);
    if (micro_version < 0 || micro_version > 65535) fail("bad micro version");
    combined_ += micro_version;
  }
  coder = c.symbol(state, false);
  if (coder == kRangeCustom) {
    for (int i = 1; i < 256; ++i)
      transition_[i] = uint8_t(c.symbol(state, true) + c.one_state[i]);
  }
  colorspace = c.symbol(state, false);
  bits = c.symbol(state, false);
  chroma_planes = c.get(state);
  hshift = c.symbol(state, false);
  vshift = c.symbol(state, false);
  transparency = c.get(state);
  plane_count_ = 2 + transparency;
  num_h_ = 1 + c.symbol(state, false);
  num_v_ = 1 + c.symbol(state, false);
  if (unsigned(hshift) > 4u || unsigned(vshift) > 4u)
    fail("chroma shift out of range");
  if (num_h_ > width_ || num_h_ < 1 || num_v_ > height_ || num_v_ < 1)
    fail("slice count invalid");
  if (num_h_ > kMaxSlices / num_v_) fail("slice count unsupported");
  quant_table_count = c.symbol(state, false);
  if (quant_table_count < 1 || quant_table_count > kMaxQuantTables)
    fail("quant table count invalid");
  for (int i = 0; i < quant_table_count; ++i) {
    context_count_[i] = read_quant_tables(c, quant_tables_[i]);
    initial_states_[i].assign(size_t(context_count_[i]) * kContextSize, 128);
  }
  for (int i = 0; i < quant_table_count; ++i) {
    if (!c.get(state)) continue;
    have_initial_ = true;
    for (int j = 0; j < context_count_[i]; ++j)
      for (int k = 0; k < kContextSize; ++k) {
        int pred =
            j ? initial_states_[i][size_t(j - 1) * kContextSize + k] : 128;
        initial_states_[i][size_t(j) * kContextSize + k] =
            uint8_t((pred + c.symbol(state2[k], true)) & 0xFF);
      }
  }
  if (version > 2) {
    ec = c.symbol(state, false);
    if (ec >= 2) crcref_ = 0x7a8c4079;
    if (combined_ >= 0x30003) intra_ = c.symbol(state, false);
    uint32_t v = crc32()(crcref_, p, n);
    if (v != crcref_ || n < 4) fail("configuration record CRC mismatch");
  }
  header_seen_ = true;
  check_layout();
}

// FFmpeg's pixel format choice; what it has none for, or what cannot
// reach OpenCV's 8-bit BGR without dithering, is refused by name.
void Decoder::check_layout() {
  if (colorspace > 1)
    refuse("colorspace_type " + std::to_string(colorspace) +
           " (neither YCbCr nor RGB: Bayer or a reserved value)");
  if (bits > 8)
    refuse(std::to_string(bits) + "-bit video (OpenCV dithers it to 8 bits)");
  if (colorspace == 1 && (hshift || vshift))
    refuse("RGB with chroma subsampling");
  if (colorspace == 0 && chroma_planes) {
    const int k = 16 * hshift + vshift;
    const bool ok = transparency ? (k == 0x00 || k == 0x10 || k == 0x11)
                                 : (k == 0x00 || k == 0x01 || k == 0x10 ||
                                    k == 0x11 || k == 0x20 || k == 0x22);
    if (!ok)
      refuse("chroma subsampling " + std::to_string(hshift) + "," +
             std::to_string(vshift) + (transparency ? " with alpha" : ""));
  }
}

// Version 0/1 headers in a key frame, and a version 2/3 key frame's slice
// layout.
void Decoder::read_header(RangeCoder& c) {
  uint8_t state[kContextSize];
  memset(state, 128, sizeof state);
  int context_count = -1;
  if (version < 2) {
    unsigned v = unsigned(c.symbol(state, false));
    if (v >= 2) fail("invalid version in a version 0/1 header");
    int new_version = int(v);
    int new_coder = c.symbol(state, false);
    uint8_t tr[256];
    memcpy(tr, default_rc_.one_state, 256);
    if (new_coder == kRangeCustom) {
      for (int i = 1; i < 256; ++i) {
        int st = c.symbol(state, true) + c.one_state[i];
        if (st < 1 || st > 255) fail("invalid state transition");
        tr[i] = uint8_t(st);
      }
    }
    int cs = c.symbol(state, false);
    int bprs = new_version > 0 ? c.symbol(state, false) : 0;
    int cp = c.get(state);
    int hs = c.symbol(state, false);
    int vs = c.symbol(state, false);
    int tp = c.get(state);
    if (header_seen_ &&
        (cs != colorspace || (bprs ? bprs : 8) != bits ||
         cp != chroma_planes || hs != hshift || vs != vshift ||
         tp != transparency))
      fail("invalid change of global parameters");
    version = new_version;
    coder = new_coder;
    memcpy(transition_, tr, 256);
    colorspace = cs;
    bits = bprs ? bprs : 8;
    chroma_planes = cp;
    hshift = hs;
    vshift = vs;
    transparency = tp;
    plane_count_ = 2 + transparency;
    check_layout();
    context_count = read_quant_tables(c, quant_tables_[0]);
    context_count_[0] = context_count;
    quant_table_count = 1;
    slice_count_ = 1;
    header_seen_ = true;
  } else if (version < 3) {
    slice_count_ = c.symbol(state, false);
  } else {
    const uint8_t* p = c.end;
    const int trailer = 3 + 5 * !!ec;
    for (slice_count_ = 0;
         slice_count_ < kMaxSlices && trailer < p - c.start; ++slice_count_) {
      int size = (p[-trailer] << 16) | (p[-trailer + 1] << 8) |
                 p[-trailer + 2];
      if (size + trailer > p - c.start) break;
      p -= size + trailer;
    }
  }
  if (slice_count_ <= 0 || slice_count_ > num_h_ * num_v_)
    fail("slice count " + std::to_string(slice_count_) + " is invalid");
  for (int j = 0; j < slice_count_; ++j) {
    Slice& sc = slices_[j];
    sc.damaged = false;
    if (version == 2) {
      int64_t sx = int64_t(c.symbol(state, false)) * width_;
      int64_t sy = int64_t(c.symbol(state, false)) * height_;
      int64_t sw = (int64_t(c.symbol(state, false)) + 1) * width_ + sx;
      int64_t sh = (int64_t(c.symbol(state, false)) + 1) * height_ + sy;
      sx /= num_h_;
      sy /= num_v_;
      sw = sw / num_h_ - sx;
      sh = sh / num_v_ - sy;
      if (sw > width_ || sh > height_ || sw < 0 || sh < 0 ||
          sx + sw > width_ || sy + sh > height_)
        fail("slice out of the frame");
      sc.x = int(sx);
      sc.y = int(sy);
      sc.w = int(sw);
      sc.h = int(sh);
    }
    for (int i = 0; i < plane_count_; ++i) {
      PlaneCtx& p = sc.plane[i];
      if (version == 2) {
        int idx = c.symbol(state, false);
        if (unsigned(idx) >= unsigned(quant_table_count))
          fail("quant_table_index out of range");
        p.quant_table_index = idx;
        context_count = context_count_[idx];
      } else if (version < 2) {
        p.quant_table_index = 0;
      }
      if (version <= 2) p.context_count = context_count;
    }
  }
}

void Decoder::setup_slices(int count) {
  slices_.assign(size_t(count), Slice());
  for (int i = 0; i < count; ++i) {
    const int sx = i % num_h_, sy = i / num_h_;
    Slice& s = slices_[i];
    s.x = int(int64_t(width_) * sx / num_h_);
    s.y = int(int64_t(height_) * sy / num_v_);
    s.w = int(int64_t(width_) * (sx + 1) / num_h_) - s.x;
    s.h = int(int64_t(height_) * (sy + 1) / num_v_) - s.y;
  }
}

void Decoder::init_slice_state(Slice& sc) {
  for (int j = 0; j < plane_count_; ++j) {
    PlaneCtx& p = sc.plane[j];
    const size_t n = size_t(std::max(p.context_count, 0));
    if (coder != kGolomb) {
      if (p.state.size() < n * kContextSize)
        p.state.resize(n * kContextSize, 128);
    } else if (p.vlc_state.size() < n) {
      p.vlc_state.resize(n);
    }
  }
  if (coder == kRangeCustom) sc.c.custom_states(transition_);
}

void Decoder::clear_slice_state(Slice& sc) {
  for (int i = 0; i < plane_count_; ++i) {
    PlaneCtx& p = sc.plane[i];
    if (coder != kGolomb) {
      const std::vector<uint8_t>& init = initial_states_[p.quant_table_index];
      const size_t n = size_t(p.context_count) * kContextSize;
      if (init.size() >= n)
        std::copy(init.begin(), init.begin() + int64_t(n), p.state.begin());
      else
        std::fill(p.state.begin(), p.state.begin() + int64_t(n), 128);
    } else {
      for (int j = 0; j < p.context_count; ++j) p.vlc_state[j] = VlcState();
    }
  }
}

// A version 3 slice header; false where FFmpeg finds it damaged.
bool Decoder::slice_header(Slice& sc) {
  RangeCoder& c = sc.c;
  uint8_t state[kContextSize];
  memset(state, 128, sizeof state);
  int64_t sx = c.symbol(state, false), sy = c.symbol(state, false);
  int64_t sw = int64_t(unsigned(c.symbol(state, false)) + 1u);
  int64_t sh = int64_t(unsigned(c.symbol(state, false)) + 1u);
  int64_t x0 = width_ * sx / num_h_, y0 = height_ * sy / num_v_;
  int64_t w0 = width_ * (sx + sw) / num_h_ - x0;
  int64_t h0 = height_ * (sy + sh) / num_v_ - y0;
  sc.x = int(x0);
  sc.y = int(y0);
  sc.w = int(w0);
  sc.h = int(h0);
  if (w0 <= 0 || h0 <= 0) return false;
  if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0) return false;
  if (sx > num_h_ - sw || sy > num_v_ - sh) return false;
  for (int i = 0; i < plane_count_; ++i) {
    PlaneCtx& p = sc.plane[i];
    int idx = c.symbol(state, false);
    if (unsigned(idx) >= unsigned(quant_table_count)) return false;
    p.quant_table_index = idx;
    const int count = context_count_[idx];
    if (p.context_count < count) {
      p.state.clear();
      p.vlc_state.clear();
    }
    p.context_count = count;
  }
  c.symbol(state, false);  // picture structure
  c.symbol(state, false);  // sample aspect ratio
  c.symbol(state, false);
  return true;
}

int Decoder::decode_line(Slice& sc, Bits& gb, int w, int* s0, int* s1,
                         int plane, int nbits, bool golomb) {
  PlaneCtx& p = sc.plane[plane];
  RangeCoder& c = sc.c;
  const int16_t(*q)[256] = quant_tables_[p.quant_table_index];
  const bool large = q[3][127] || q[4][127];
  int run_count = 0, run_mode = 0, run_index = sc.run_index;
  const unsigned mask = (1u << nbits) - 1;
  if (input_end(c, gb, golomb)) return -1;
  for (int x = 0; x < w; ++x) {
    if (!(x & 1023) && input_end(c, gb, golomb)) return -1;
    const int LT = s0[x - 1], T = s0[x], RT = s0[x + 1], L = s1[x - 1];
    int context = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] +
                  q[2][(T - RT) & 0xFF];
    if (large)
      context += q[3][(s1[x - 2] - L) & 0xFF] + q[4][(s1[x] - T) & 0xFF];
    int sign = 0;
    if (context < 0) {
      context = -context;
      sign = 1;
    }
    if (context >= p.context_count) fail("context past the count");
    int diff;
    if (!golomb) {
      diff = c.symbol(&p.state[size_t(context) * kContextSize], true);
    } else {
      if (context == 0 && run_mode == 0) run_mode = 1;
      if (run_mode) {
        if (run_count == 0 && run_mode == 1) {
          ++stats.runs;
          if (gb.get(1)) {
            run_count = 1 << kLog2Run[run_index];
            if (x + run_count <= w) ++run_index;
          } else {
            run_count = kLog2Run[run_index] ? int(gb.get(kLog2Run[run_index]))
                                            : 0;
            if (run_index) --run_index;
            run_mode = 2;
          }
        }
        while (run_count > 1 && w - x > 1) {
          s1[x] = mid_pred(s1[x - 1], s1[x - 1] + s0[x] - s0[x - 1], s0[x]);
          ++x;
          --run_count;
          ++stats.run_pixels;
        }
        --run_count;
        if (run_count < 0) {
          run_mode = 0;
          run_count = 0;
          diff = get_vlc_symbol(gb, p.vlc_state[context], nbits);
          if (diff >= 0) ++diff;
        } else {
          diff = 0;
        }
      } else {
        diff = get_vlc_symbol(gb, p.vlc_state[context], nbits);
      }
    }
    if (sign) diff = int(0u - unsigned(diff));
    const int l = s1[x - 1], t = s0[x], lt = s0[x - 1];
    const unsigned pred = unsigned(mid_pred(l, l + t - lt, t));
    s1[x] = int((pred + unsigned(diff)) & mask);
  }
  sc.run_index = run_index;
  return 0;
}

// Plane k of the current frame from byte `off`: h rows of w samples.
void Decoder::decode_plane(Slice& sc, Bits& gb, int k, int64_t off, int w,
                           int h, int plane_index, int pixel_stride,
                           bool golomb) {
  const int stride = frame_[cur_].stride[k];
  uint8_t* dst = frame_[cur_].plane[k].data() + off;
  uint8_t* seen = seen_[cur_].plane[k].data() + off;
  sample_.assign(size_t(2) * (w + 6), 0);
  int* s0 = sample_.data() + 3;
  int* s1 = sample_.data() + w + 6 + 3;
  sc.run_index = 0;
  for (int y = 0; y < h; ++y) {
    std::swap(s0, s1);
    s1[-1] = s0[0];
    s0[w] = s0[w - 1];
    if (decode_line(sc, gb, w, s0, s1, plane_index, 8, golomb) < 0) return;
    uint8_t* row = dst + int64_t(stride) * y;
    uint8_t* srow = seen + int64_t(stride) * y;
    for (int x = 0; x < w; ++x) {
      row[x * pixel_stride] = uint8_t(s1[x]);
      srow[x * pixel_stride] = 1;
    }
  }
}

void Decoder::decode_rgb(Slice& sc, Bits& gb, int64_t off, int w, int h,
                         bool golomb) {
  const int stride = frame_[cur_].stride[0];
  uint8_t* dst = frame_[cur_].plane[0].data() + off;
  sample_.assign(size_t(8) * (w + 6), 0);
  int* s[4][2];
  for (int k = 0; k < 4; ++k) {
    s[k][0] = sample_.data() + size_t(k) * 2 * (w + 6) + 3;
    s[k][1] = sample_.data() + size_t(k * 2 + 1) * (w + 6) + 3;
  }
  sc.run_index = 0;
  const int offset = 1 << bits;
  for (int y = 0; y < h; ++y) {
    for (int p = 0; p < 3 + transparency; ++p) {
      std::swap(s[p][0], s[p][1]);
      s[p][1][-1] = s[p][0][0];
      s[p][0][w] = s[p][0][w - 1];
      if (decode_line(sc, gb, w, s[p][0], s[p][1], (p + 1) / 2, 9, golomb) <
          0)
        return;
    }
    uint8_t* row = dst + int64_t(stride) * y;
    for (int x = 0; x < w; ++x) {
      int g = s[0][1][x], b = s[1][1][x], r = s[2][1][x], a = s[3][1][x];
      b -= offset;
      r -= offset;
      g -= (b + r) >> 2;
      b += g;
      r += g;
      const uint32_t v = uint32_t(b) + (uint32_t(g) << 8) +
                         (uint32_t(r) << 16) + (uint32_t(a) << 24);
      memcpy(row + 4 * x, &v, 4);
    }
    memset(seen_[cur_].plane[0].data() + off + int64_t(stride) * y, 1,
           size_t(4) * w);
  }
}

void Decoder::decode_slice(Slice& sc, bool key) {
  lossless::Frame& f = frame_[cur_];
  if (version > 2) {
    init_slice_state(sc);
    if (!slice_header(sc)) {
      sc.x = sc.y = sc.w = sc.h = 0;
      sc.damaged = true;
      return;
    }
  }
  init_slice_state(sc);
  if (key) {
    clear_slice_state(sc);
  } else if (sc.damaged) {
    return;
  }
  const bool golomb = coder == kGolomb;
  Bits gb;
  if (golomb) {
    if (combined_ >= 0x30002) sc.c.bit(129);
    const int64_t skip = (version > 2 || (!sc.x && !sc.y))
                             ? (sc.c.ptr - sc.c.start) - 1
                             : 0;
    gb.init(sc.c.start + skip, (sc.c.end - sc.c.start) - skip,
            packet_end_ - (sc.c.start + skip));
    ++stats.golomb_slices;
  } else {
    ++stats.range_slices;
  }
  const int x = sc.x, y = sc.y, w = sc.w, h = sc.h;
  if (colorspace == 0 && (chroma_planes || !transparency)) {
    decode_plane(sc, gb, 0, x + int64_t(y) * f.stride[0], w, h, 0, 1, golomb);
    if (chroma_planes) {
      const int cw = -((-w) >> hshift), ch = -((-h) >> vshift);
      const int cx = x >> hshift, cy = y >> vshift;
      for (int k = 1; k <= 2; ++k)
        decode_plane(sc, gb, k, cx + int64_t(cy) * f.stride[k], cw, ch, 1, 1,
                     golomb);
    }
    if (transparency)
      decode_plane(sc, gb, 3, x + int64_t(y) * f.stride[3], w, h, 2, 1,
                   golomb);
  } else if (colorspace == 0) {
    const int64_t base = 2 * x + int64_t(y) * f.stride[0];
    decode_plane(sc, gb, 0, base, w, h, 0, 2, golomb);
    decode_plane(sc, gb, 0, base + 1, w, h, 1, 2, golomb);
  } else {
    decode_rgb(sc, gb, 4 * x + int64_t(y) * f.stride[0], w, h, golomb);
  }
  if (!golomb && version > 2) {
    sc.c.bit(129);
    const int64_t v = (sc.c.end - sc.c.ptr) - 2 - 5 * !!ec;
    if (v) sc.damaged = true;
  }
}

Status Decoder::decode(const uint8_t* buf, int64_t size) {
  out_ = nullptr;
  if (size <= 0) return kNoFrame;
  packet_end_ = buf + size;
  RangeCoder& c = slices_[0].c;
  c.init(buf, size);
  c.build_states();
  uint8_t keystate = 128;
  const bool key = c.get(&keystate);
  if (key) {
    key_frame_ok_ = false;
    read_header(c);
    key_frame_ok_ = true;
  } else if (!key_frame_ok_) {
    fail("a non-key frame without a key frame before it");
  }
  if (coder != kGolomb) {
    if (size < int64_t(width_) * height_ / (128 * 8))
      fail("packet too small");
  } else {
    int w = width_;
    const int s = 1 + w / (1 << 23);
    int i = 0;
    w /= s;
    for (i = 0; w > (1 << kLog2Run[i]); ++i) w -= kLog2Run[i];
    if (size < int64_t(height_ + i + 6) / 8 * s) fail("packet too small");
  }
  cur_ ^= 1;
  lossless::Frame& f = frame_[cur_];
  if (colorspace == 1)
    f.reset(lossless::kPacked, width_, height_, 0, 0, transparency);
  else if (!chroma_planes)
    f.reset(transparency ? lossless::kGrayAlpha : lossless::kGray, width_,
            height_);
  else
    f.reset(lossless::kYuv, width_, height_, hshift, vshift, transparency);
  seen_[cur_] = f;
  const uint8_t* buf_p = buf + size;
  const int trailer = 3 + 5 * !!ec;
  for (int i = slice_count_ - 1; i >= 0; --i) {
    Slice& sc = slices_[i];
    if (key) sc.damaged = false;  // else a damaged slice stays damaged
    int64_t v;
    if (i || version > 2) {
      if (trailer > buf_p - buf)
        v = INT_MAX;
      else
        v = ((buf_p[-trailer] << 16) | (buf_p[-trailer + 1] << 8) |
             buf_p[-trailer + 2]) +
            trailer;
    } else {
      v = buf_p - c.start;
    }
    if (buf_p - c.start < v) {
      cur_ ^= 1;
      fail("slice pointer chain broken");
    }
    buf_p -= v;
    if (ec) {
      ++stats.crc_slices;
      if (crc32()(crcref_, buf_p, v) != crcref_) sc.damaged = true;
    }
    if (i) {
      sc.c.init(buf_p, v);
      sc.c.build_states();
    } else {
      sc.c.end = buf_p + v;
    }
  }
  for (int i = 0; i < slice_count_; ++i) {
    decode_slice(slices_[i], key);
    ++stats.slices;
  }
  const int16_t(*q0)[256] =
      quant_tables_[slices_[0].plane[0].quant_table_index];
  large_context = q0[3][127] || q0[4][127];
  const lossless::Frame& last = frame_[cur_ ^ 1];
  for (int i = slice_count_ - 1; i >= 0; --i) {
    Slice& sc = slices_[i];
    if (!sc.damaged) continue;
    ++stats.damaged_slices;
    if (!have_last_ || last.layout != f.layout) {
      sc.damaged = false;  // decoded as it is, and not carried on
      continue;
    }
    ++stats.concealed_slices;
    for (int k = 0; k < 4; ++k) {
      if (f.plane[k].empty()) continue;
      const bool chroma = f.layout == lossless::kYuv && (k == 1 || k == 2);
      const int sh = chroma ? hshift : 0, sv = chroma ? vshift : 0;
      const int bpp = f.layout == lossless::kPacked
                          ? 4
                          : (f.layout == lossless::kGrayAlpha ? 2 : 1);
      const int cw = chroma ? -((-sc.w) >> sh) : sc.w;
      const int ch = chroma ? -((-sc.h) >> sv) : sc.h;
      for (int r = 0; r < ch; ++r) {
        const int64_t off = int64_t((sc.y >> sv) + r) * f.stride[k] +
                            int64_t(sc.x >> sh) * bpp;
        memcpy(f.plane[k].data() + off, last.plane[k].data() + off,
               size_t(cw) * bpp);
        memcpy(seen_[cur_].plane[k].data() + off,
               seen_[cur_ ^ 1].plane[k].data() + off, size_t(cw) * bpp);
      }
    }
  }
  have_last_ = true;
  ++stats.frames;
  if (key) ++stats.key_frames;
  out_ = &f;
  return kFrame;
}

}  // namespace

extern "C" {

// A decoder for a stream of `width` x `height` frames whose configuration
// record (versions 2 and 3; none for 0 and 1) is `extra`.  0: *out set;
// 2: a feature it does not decode, 3: a record that does not parse (msg
// says which).
int ffv1dec_open(const uint8_t* extra, int64_t n, int width, int height,
                 void** out, char* msg, int msg_len) {
  *out = nullptr;
  return lossless::guarded(
      [&] {
        *out = new Decoder(extra, n, width, height);
        return kFrame;
      },
      msg, msg_len);
}

// Decode one frame.  0: its frame is given, *w and *h set; 1: an empty
// packet; 2: a feature it does not decode (msg names it); 3: no frame
// (FFmpeg's decoder refuses the packet; msg says why).
int ffv1dec_decode(void* handle, const uint8_t* data, int64_t n, int* w,
                   int* h, char* msg, int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  return lossless::guarded(
      [&] {
        const Status st = d->decode(data, n);
        *w = d->width();
        *h = d->height();
        return st;
      },
      msg, msg_len);
}

// The frame last given as h*w*3 RGB bytes (lossless::frame_rgb).
int ffv1dec_rgb(void* handle, uint8_t* rgb, int64_t cap, char* msg,
                int msg_len) {
  return lossless::frame_rgb(static_cast<Decoder*>(handle)->out(), "FFV1",
                             rgb, cap, msg, msg_len);
}

// Plane k (0..3) of the frame last given (lossless::frame_plane).
int ffv1dec_plane(void* handle, int k, uint8_t* dst, int64_t cap,
                  int* row_bytes, int* rows) {
  return lossless::frame_plane(static_cast<Decoder*>(handle)->out(), k, dst,
                               cap, row_bytes, rows);
}

// Which pixels of the frame last given the decode wrote, as h*w bytes (1:
// written; lossless::rgb_defined): FFmpeg's decode leaves the others as
// its buffer held them.  0: done; 4: cap too small or no frame.
int ffv1dec_defined(void* handle, uint8_t* mask, int64_t cap) {
  const Decoder* d = static_cast<Decoder*>(handle);
  const lossless::Frame* seen = d->seen();
  if (!seen || int64_t(seen->w) * seen->h > cap) return lossless::kSmall;
  lossless::rgb_defined(*seen, mask);
  return kFrame;
}

// The stream's parameters and what it has used so far, in the order of
// io/ffv1.py's _STATS.
int ffv1dec_stats(void* handle, int64_t* out, int n) {
  Decoder* d = static_cast<Decoder*>(handle);
  const Stats& s = d->stats;
  const int64_t v[] = {
      d->version,       d->micro_version, d->coder,
      d->ec,            d->colorspace,    d->bits,
      d->chroma_planes, d->hshift,        d->vshift,
      d->transparency,  d->large_context, d->quant_table_count,
      s.frames,         s.key_frames,     s.slices,
      s.crc_slices,     s.damaged_slices, s.concealed_slices,
      s.range_slices,   s.golomb_slices,  s.runs,
      s.run_pixels};
  return lossless::put_stats(v, out, n);
}

void ffv1dec_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
