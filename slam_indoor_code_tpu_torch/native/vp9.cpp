// vp9 — a VP9 video decoder (profile 0: 8-bit 4:2:0, what libvpx writes
// for YouTube's WebM, Chrome's MediaRecorder and OpenCV's `VP90` writer)
// with no library but the C++ standard library.
//
// It gives the pixels FFmpeg's decoder (and libvpx's) gives, bit for bit:
//   - the superframe index (a hidden alt-ref frame packed with the next
//     shown one), show_existing_frame, key and inter frames, error
//     resilience, frame-parallel mode, the 8 reference slots with their
//     refresh flags and sign biases, frame_size_with_refs, high-precision
//     motion vectors, the interpolation filter, the four saved probability
//     contexts (refresh_frame_context; all reset by a key frame or error
//     resilience), the loop filter with its reference/mode deltas and
//     sharpness, the quantiser with its three deltas and lossless mode,
//     segmentation (quantiser,
//     filter level, reference and skip features; the map read, predicted
//     from the last frame's or carried over), tile columns and rows;
//   - the boolean decoder read as FFmpeg's range coder reads it
//     (vpx_rac.h), the marker bit of each partition and the zero bits
//     after the uncompressed header checked, a last byte that looks like
//     a superframe index held to FFmpeg's reading of it, the compressed
//     header's probability
//     updates (inv_remap_prob) for transform size, coefficients, skip,
//     inter modes, interpolation filters, intra/inter, reference modes,
//     intra modes, partitions and motion vectors;
//   - partitions from 64x64 down to the 4x4 blocks, mode info with the
//     contexts of its above and left neighbours (segment id, skip,
//     transform size, intra modes per 4x4 on key frames, single and
//     compound references, the motion-vector candidate list with the last
//     frame's vectors where they may be used, NEWMV with joints, classes,
//     fractions and the high-precision bit);
//   - tokens with their band and neighbour contexts, dequantisation (32x32
//     halved), DCT/ADST of 4 to 32 points with the transform type of the
//     intra mode, the Walsh-Hadamard transform of lossless frames
//     (vp9_dsp.h);
//   - intra prediction with VP9's edge rules (above-right only within the
//     block and for 4x4 transforms, 127 above and 129 left of the frame,
//     pixels beyond the 8-aligned frame edge replicated); inter prediction
//     with the regular, sharp and smooth 8-tap filters and the bilinear one,
//     1/16-pel chroma from the (averaged, below 8x8) luma vectors, compound
//     averaging, references replicated beyond their edge;
//   - the loop filter superblock by superblock, each plane's vertical edges
//     and then its horizontal ones, with masks from transform and block
//     edges and levels per segment, reference and mode;
//   - backward adaptation of the coefficient, mode and motion-vector
//     probabilities after each frame that allows it (the faster update just
//     after a key frame, counts saturated; the uncoded high-precision bit
//     counted as 1, as libvpx counts it);
//   - the crop to the frame's size and YUV 4:2:0 -> RGB as swscale does it
//     for OpenCV (swscale_rgb.h), with the key frame's matrix: BT.601
//     (colour space unknown, BT.601, SMPTE 170M) or BT.709.
// A frame with show_frame 0 updates the references and gives no frame.  A
// frame that is corrupt (a bad marker, sync code or tile size, a missing
// reference) gives no frame and leaves the references as they were, which
// ends the video where OpenCV's reader ends it.  Profiles 1-3, intra-only
// frames, a size change, a reference of another size (scaled prediction)
// and colour other than BT.601 or BT.709 limited range (SMPTE 240M,
// BT.2020, sRGB, full range) raise with the feature named.
//
// The constant tables are libvpx's (vp9_tables.h, under its BSD notice);
// the default probabilities libvpx keeps in code are written out below.
//
// C ABI; Python binds it through ctypes (io/vp9.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libvp9dec.so vp9.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <type_traits>
#include <vector>

#include "swscale_rgb.h"
#include "vp9_dsp.h"
#include "vp9_tables.h"
#include "vpx_rac.h"

namespace {

using namespace vp9_tables;
using vp9_dsp::clip8;

enum Status { kFrame = 0, kNoFrame = 1, kUnsupported = 2, kCorrupt = 3,
              kSmall = 4 };

struct Error {
  Status status;
  std::string msg;
};

[[noreturn]] void unsupported(const std::string& what) {
  throw Error{kUnsupported, "VP9 " + what + " is not decoded"};
}

[[noreturn]] void corrupt(const std::string& what) {
  throw Error{kCorrupt, "corrupt VP9 frame: " + what};
}

// ------------------------------------------------ defaults kept in code

const uint8_t kDefaultSkip[3] = {192, 128, 64};
const uint8_t kDefaultTx8[2][1] = {{100}, {66}};
const uint8_t kDefaultTx16[2][2] = {{20, 152}, {15, 101}};
const uint8_t kDefaultTx32[2][3] = {{3, 136, 37}, {5, 52, 13}};
const uint8_t kDefaultIntraInter[4] = {9, 102, 187, 225};
const uint8_t kDefaultCompInter[5] = {239, 183, 119, 96, 41};
const uint8_t kDefaultCompRef[5] = {50, 126, 123, 221, 226};
const uint8_t kDefaultMvJoints[3] = {32, 64, 96};
// per component (vertical, horizontal): sign, classes[10], class0[1],
// bits[10], class0_fp[2][3], fp[3], class0_hp, hp
const uint8_t kDefaultMvClasses[2][10] = {
    {224, 144, 192, 168, 192, 176, 192, 198, 198, 245},
    {216, 128, 176, 160, 176, 176, 192, 198, 198, 208}};
const uint8_t kDefaultMvClass0[2] = {216, 208};
const uint8_t kDefaultMvBits[10] = {136, 140, 148, 160, 176,
                                    192, 224, 234, 234, 240};
const uint8_t kDefaultMvClass0Fp[2][3] = {{128, 128, 64}, {96, 112, 64}};
const uint8_t kDefaultMvFp[3] = {64, 96, 64};

// the header's 2-bit filter: smooth, regular, sharp, bilinear
const int8_t kLiteralToFilter[4] = {1, 0, 2, 3};

enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64 };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32 };
enum { ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT };
enum { NEARESTMV = 10, NEARMV = 11, ZEROMV = 12, NEWMV = 13 };
enum { INTRA_FRAME = 0, LAST_FRAME = 1, GOLDEN_FRAME = 2, ALTREF_FRAME = 3 };
enum { SINGLE_REF, COMPOUND_REF, REF_SELECT };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT };
enum { SEG_ALT_Q, SEG_ALT_LF, SEG_REF, SEG_SKIP };
constexpr int kSwitchable = 4;

const int kBw4[13] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16};  // width in 4s
const int kBh4[13] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16};

// ---------------------------------------------------------- bit readers

// The uncompressed header, most significant bit first; past the end it
// reads zeros, as FFmpeg's padded reader does.
class Bits {
 public:
  Bits(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  int bit() {
    const size_t byte = pos_ >> 3;
    const int v = byte < n_ ? (p_[byte] >> (7 - (pos_ & 7))) & 1 : 0;
    ++pos_;
    return v;
  }
  int lit(int n) {
    int v = 0;
    while (n--) v = (v << 1) | bit();
    return v;
  }
  int signed_lit(int n) {  // magnitude, then the sign
    const int v = lit(n);
    return bit() ? -v : v;
  }
  size_t bytes() const { return (pos_ + 7) >> 3; }
  bool over() const { return pos_ > 8 * n_; }  // read past the end
  int pad() {  // the bits to the next byte boundary (FFmpeg wants zeros)
    int v = 0;
    while (pos_ & 7) v |= bit();
    return v;
  }

 private:
  const uint8_t* p_;
  size_t n_, pos_ = 0;
};

using vpx_rac::Bool;

// ------------------------------------------------- probabilities, counts

struct MvComp {
  uint8_t sign, classes[10], class0[1], bits[10], class0_fp[2][3], fp[3],
      class0_hp, hp;
};

struct Probs {
  uint8_t coef[4][2][2][6][6][3];
  uint8_t skip[3];
  uint8_t tx8[2][1], tx16[2][2], tx32[2][3];
  uint8_t inter_mode[7][3];
  uint8_t interp[4][2];
  uint8_t intra_inter[4];
  uint8_t comp_inter[5];
  uint8_t single_ref[5][2];
  uint8_t comp_ref[5];
  uint8_t y_mode[4][9];
  uint8_t uv_mode[10][9];
  uint8_t partition[16][3];
  uint8_t mv_joints[3];
  MvComp mv[2];
};

struct MvCompCounts {
  unsigned sign[2], classes[11], class0[2], bits[10][2], class0_fp[2][4],
      fp[4], class0_hp[2], hp[2];
};

struct Counts {
  unsigned coef[4][2][2][6][6][4];
  unsigned eob[4][2][2][6][6];
  unsigned skip[3][2];
  unsigned tx8[2][2], tx16[2][3], tx32[2][4];
  unsigned inter_mode[7][4];
  unsigned interp[4][3];
  unsigned intra_inter[4][2];
  unsigned comp_inter[5][2];
  unsigned single_ref[5][2][2];
  unsigned comp_ref[5][2];
  unsigned y_mode[4][10];
  unsigned uv_mode[10][10];
  unsigned partition[16][4];
  unsigned mv_joints[4];
  MvCompCounts mv[2];
};

Probs default_probs() {
  Probs p;
  std::memcpy(p.coef[0], default_coef_probs_4x4, sizeof(p.coef[0]));
  std::memcpy(p.coef[1], default_coef_probs_8x8, sizeof(p.coef[1]));
  std::memcpy(p.coef[2], default_coef_probs_16x16, sizeof(p.coef[2]));
  std::memcpy(p.coef[3], default_coef_probs_32x32, sizeof(p.coef[3]));
  std::memcpy(p.skip, kDefaultSkip, sizeof(p.skip));
  std::memcpy(p.tx8, kDefaultTx8, sizeof(p.tx8));
  std::memcpy(p.tx16, kDefaultTx16, sizeof(p.tx16));
  std::memcpy(p.tx32, kDefaultTx32, sizeof(p.tx32));
  std::memcpy(p.inter_mode, default_inter_mode_probs, sizeof(p.inter_mode));
  std::memcpy(p.interp, default_switchable_interp_prob, sizeof(p.interp));
  std::memcpy(p.intra_inter, kDefaultIntraInter, sizeof(p.intra_inter));
  std::memcpy(p.comp_inter, kDefaultCompInter, sizeof(p.comp_inter));
  std::memcpy(p.single_ref, default_single_ref_p, sizeof(p.single_ref));
  std::memcpy(p.comp_ref, kDefaultCompRef, sizeof(p.comp_ref));
  std::memcpy(p.y_mode, default_if_y_probs, sizeof(p.y_mode));
  std::memcpy(p.uv_mode, default_if_uv_probs, sizeof(p.uv_mode));
  std::memcpy(p.partition, default_partition_probs, sizeof(p.partition));
  std::memcpy(p.mv_joints, kDefaultMvJoints, sizeof(p.mv_joints));
  for (int i = 0; i < 2; ++i) {
    MvComp& c = p.mv[i];
    c.sign = 128;
    std::memcpy(c.classes, kDefaultMvClasses[i], 10);
    c.class0[0] = kDefaultMvClass0[i];
    std::memcpy(c.bits, kDefaultMvBits, 10);
    std::memcpy(c.class0_fp, kDefaultMvClass0Fp, 6);
    std::memcpy(c.fp, kDefaultMvFp, 3);
    c.class0_hp = 160;
    c.hp = 128;
  }
  return p;
}

// ---------------------------------------------------------- probability
// adaptation (vp9_entropy.c / vp9_entropymode.c / vp9_entropymv.c)

inline uint8_t get_prob(unsigned num, unsigned den) {
  const int p = static_cast<int>((uint64_t(num) * 256 + (den >> 1)) / den);
  return static_cast<uint8_t>(std::clamp(p, 1, 255));
}

inline uint8_t merge(uint8_t pre, unsigned c0, unsigned c1, unsigned sat,
                     unsigned max_factor) {
  const unsigned den = c0 + c1;
  if (!den) return pre;
  const unsigned factor = max_factor * std::min(den, sat) / sat;
  const int prob = get_prob(c0, den);
  return static_cast<uint8_t>((pre * (256 - factor) + prob * factor + 128) >>
                              8);
}

inline uint8_t merge_mode(uint8_t pre, unsigned c0, unsigned c1) {
  const unsigned den = c0 + c1;
  if (!den) return pre;
  const unsigned factor = count_to_update_factor[std::min(den, 20u)];
  const int prob = get_prob(c0, den);
  return static_cast<uint8_t>((pre * (256 - factor) + prob * factor + 128) >>
                              8);
}

unsigned tree_merge(const int8_t* tree, int i, const uint8_t* pre,
                    const unsigned* counts, uint8_t* probs) {
  const int l = tree[i], r = tree[i + 1];
  const unsigned lc = l <= 0 ? counts[-l] : tree_merge(tree, l, pre, counts, probs);
  const unsigned rc = r <= 0 ? counts[-r] : tree_merge(tree, r, pre, counts, probs);
  probs[i >> 1] = merge_mode(pre[i >> 1], lc, rc);
  return lc + rc;
}

// ------------------------------------------------------- frames and blocks

struct Frame {
  int w = 0, h = 0;     // the picture
  int stride = 0;       // luma stride; chroma's is half
  int rows = 0;         // luma rows allocated
  bool bt709 = false;   // the colour space of the key frame before it
  std::vector<uint8_t> y, u, v;
  void alloc(int width, int height) {
    w = width;
    h = height;
    stride = ((w + 63) & ~63) + 64;
    rows = ((h + 63) & ~63) + 64;
    y.assign(size_t(stride) * rows, 0);
    u.assign(size_t(stride / 2) * (rows / 2), 0);
    v.assign(size_t(stride / 2) * (rows / 2), 0);
  }
  uint8_t* plane(int p) { return p == 0 ? y.data() : p == 1 ? u.data() : v.data(); }
  const uint8_t* plane_const(int p) const {
    return p == 0 ? y.data() : p == 1 ? u.data() : v.data();
  }
  int pstride(int p) const { return p ? stride / 2 : stride; }
};
using FramePtr = std::shared_ptr<Frame>;

struct Mv {
  int16_t row = 0, col = 0;
  bool operator==(const Mv& o) const { return row == o.row && col == o.col; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

// what a block's mode info holds (copied into each 8x8 cell it covers)
struct MI {
  uint8_t sb_type = 0, mode = 0, uv_mode = 0, tx_size = 0, skip = 0,
          seg_id = 0, seg_pred = 0, filter = 0;
  uint8_t bmode[4] = {};
  int8_t ref[2] = {0, -1};
  Mv mv[2];
  Mv bmv[4][2];
};

inline bool is_inter(const MI& m) { return m.ref[0] > INTRA_FRAME; }
inline bool has_second(const MI& m) { return m.ref[1] > INTRA_FRAME; }

// the last frame's vectors, per 8x8 cell
struct MvRef {
  int8_t ref[2] = {0, -1};
  Mv mv[2];
};

struct Segmentation {
  bool enabled = false, update_map = false, temporal = false,
       abs_delta = false;
  uint8_t tree_probs[7] = {255, 255, 255, 255, 255, 255, 255};
  uint8_t pred_probs[3] = {255, 255, 255};
  bool feature[8][4] = {};
  int data[8][4] = {};
};

struct TileCtx {
  Bool b;
  int col_start = 0, col_end = 0;  // in 8x8 cells
  uint8_t left_nz[3][16];          // per plane, per 4x4 row
  uint8_t left_part[8];
};

}  // namespace

namespace {

class Decoder {
 public:
  int width = 0, height = 0;
  FramePtr shown;  // the last frame given
  bool bt709_ = false;  // the last key frame's colour space

  Status decode(const uint8_t* data, int64_t n);

  // what the stream has used so far (io/vp9.py's Decoder.stats names them)
  enum { kStatFrames, kStatHidden, kStatShowExisting, kStatCompound,
         kStatAdapted, kStatTileCols, kStatTileRows, kStatSwitchable,
         kStatSegmented, kStatLossless, kStatErrorResilient,
         kStatSubblockInter, kStats };
  int64_t stats[kStats] = {};

 private:
  Status decode_one(const uint8_t* data, size_t n, const uint8_t* end);
  int uncompressed_header(Bits& r);
  void past_independence();
  void setup_size(int w, int h);
  void compressed_header(Bool& b);
  void diff_update(Bool& b, uint8_t& p);
  void coef_probs(Bool& b);
  void mv_probs(Bool& b);
  void decode_tiles(const uint8_t* data, size_t n, const uint8_t* end);
  void decode_partition(TileCtx& t, int row, int col, int bsize);
  void decode_block(TileCtx& t, int row, int col, int bsize);
  void intra_frame_mode_info(TileCtx& t, MI& m, int row, int col);
  void inter_frame_mode_info(TileCtx& t, MI& m, int row, int col);
  int read_segment_id(TileCtx& t);
  int predicted_segment(int row, int col, int bw, int bh) const;
  void write_segment(int row, int col, int bw, int bh, int id);
  int read_tx_size(TileCtx& t, const MI& m, int row, int col,
                   bool allow_select);
  int kf_y_mode(TileCtx& t, const MI& m, int row, int col, int b);
  void read_ref_frames(TileCtx& t, MI& m, int row, int col);
  void read_inter_block(TileCtx& t, MI& m, int row, int col);
  int mode_context(const MI& m, int row, int col, const TileCtx& t) const;
  void find_mv_refs(const TileCtx& t, const MI& m, int row, int col, int ref,
                    int block, Mv list[2]) const;
  void read_mv(TileCtx& t, Mv& mv, const Mv& ref);
  int read_mv_component(TileCtx& t, int comp, bool hp);
  void reconstruct_intra(TileCtx& t, MI& m, int row, int col);
  bool reconstruct_inter(TileCtx& t, MI& m, int row, int col);
  int decode_coefs(TileCtx& t, int plane, int tx_size, int tx_type,
                   bool inter, int ctx, int seg, int16_t* out);
  int tokens(TileCtx& t, const MI& m, int plane, int x4, int y4, int tx_size,
             int tx_type, int max_w4, int max_h4, int16_t* out);
  void predict_intra(int plane, int mode, int tx_size, int row, int col,
                     int x4, int y4, int bw4, bool have_left);
  void predict_inter(const MI& m, int row, int col);
  void predict_plane(int plane, const Frame& ref, const Mv& mv, int x, int y,
                     int w, int h, int filter, bool avg, int row, int col,
                     int bw8, int bh8);
  void loop_filter();
  void filter_superblock(int plane, int row, int col);
  void adapt();
  int qindex(int seg) const;

  const MI* above(int row, int col) const {
    return row > 0 ? &mi_[size_t(row - 1) * mi_cols_ + col] : nullptr;
  }
  const MI* left(const TileCtx& t, int row, int col) const {
    return col > t.col_start ? &mi_[size_t(row) * mi_cols_ + col - 1]
                             : nullptr;
  }
  MI& at(int row, int col) { return mi_[size_t(row) * mi_cols_ + col]; }

  // state carried from frame to frame
  FramePtr refs_[8];
  Probs ctx_[4];
  Segmentation seg_;
  int lf_ref_deltas_[4] = {1, 0, -1, -1}, lf_mode_deltas_[2] = {0, 0};
  std::vector<uint8_t> seg_prev_, seg_cur_;
  std::vector<MvRef> prev_mvs_, cur_mvs_;
  bool last_key_ = false, have_key_ = false;
  int last_w_ = 0, last_h_ = 0;

  // this frame
  bool key_ = false, show_ = false, error_res_ = false;
  int refresh_ = 0, ref_idx_[3] = {}, sign_bias_[4] = {};
  bool hp_ = false, refresh_ctx_ = false, parallel_ = false;
  int filter_ = 0, ctx_idx_ = 0;
  int lf_level_ = 0, sharpness_ = 0;
  bool lf_deltas_ = false;
  int base_q_ = 0, ydc_dq_ = 0, uvdc_dq_ = 0, uvac_dq_ = 0;
  bool lossless_ = false;
  int log2_tile_cols_ = 0, log2_tile_rows_ = 0;
  int tx_mode_ = 0, ref_mode_ = SINGLE_REF, comp_fixed_ = 0,
      comp_var_[2] = {};
  bool use_prev_mvs_ = false;
  Probs p_{};
  Counts c_{};
  int mi_cols_ = 0, mi_rows_ = 0, sb_cols_ = 0;
  std::vector<MI> mi_;
  std::vector<uint8_t> above_nz_[3], above_part_;
  int16_t dq_[8][2][2] = {};  // segment, luma/chroma, dc/ac
  uint8_t lf_lvl_[8][4][2] = {};  // segment, reference, mode (ZEROMV or not)
  vp9_dsp::Thresh lf_thresh_[64] = {};
  FramePtr cur_;
  alignas(16) int16_t coef_[32 * 32] = {};
};

// --------------------------------------------------------------- headers

void Decoder::past_independence() {
  seg_ = Segmentation{};
  std::fill(seg_prev_.begin(), seg_prev_.end(), 0);
  std::fill(seg_cur_.begin(), seg_cur_.end(), 0);
  lf_ref_deltas_[0] = 1;
  lf_ref_deltas_[1] = 0;
  lf_ref_deltas_[2] = lf_ref_deltas_[3] = -1;
  lf_mode_deltas_[0] = lf_mode_deltas_[1] = 0;
  const Probs d = default_probs();
  for (auto& c : ctx_) c = d;  // key frames and error resilience reset all
  ctx_idx_ = 0;
}

void Decoder::setup_size(int w, int h) {
  if (have_key_ && (w != width || h != height))
    unsupported("frame size change (" + std::to_string(width) + "x" +
                std::to_string(height) + " to " + std::to_string(w) + "x" +
                std::to_string(h) + ")");
  width = w;
  height = h;
  mi_cols_ = (w + 7) >> 3;
  mi_rows_ = (h + 7) >> 3;
  sb_cols_ = (mi_cols_ + 7) >> 3;
  const size_t cells = size_t(mi_cols_) * mi_rows_;
  if (seg_prev_.size() != cells) {
    seg_prev_.assign(cells, 0);
    seg_cur_.assign(cells, 0);
    prev_mvs_.assign(cells, MvRef{});
  }
}

// The uncompressed header; returns the compressed header's size, or -1 for
// show_existing_frame (which has set `shown`).
int Decoder::uncompressed_header(Bits& r) {
  if (r.lit(2) != 2) corrupt("frame marker");
  int profile = r.bit();
  profile |= r.bit() << 1;
  if (profile == 3) profile += r.bit();
  if (profile > 3) corrupt("profile");
  if (profile != 0)
    unsupported("profile " + std::to_string(profile) +
                " (4:2:2/4:4:4/4:4:0 or 10/12-bit); only profile 0 (8-bit "
                "4:2:0) is");
  if (r.bit()) {  // show_existing_frame
    const FramePtr& f = refs_[r.lit(3)];
    if (r.over() || r.pad()) corrupt("truncated header");
    if (!f) corrupt("show_existing_frame of an empty slot");
    shown = f;
    return -1;
  }
  last_key_ = key_;
  const bool last_invisible = !show_;
  key_ = !r.bit();
  show_ = r.bit();
  error_res_ = r.bit();
  use_prev_mvs_ = !error_res_ && !last_invisible;
  if (key_) {
    if (r.lit(24) != 0x498342) corrupt("sync code");
    // OpenCV converts limited-range pictures with the colour space's
    // matrix as swscale_rgb.h does: BT.601 (unknown, BT.601, SMPTE 170M)
    // or BT.709; the other matrices and full range are not reproduced
    static const char* const kSpaces[8] = {
        "unknown", "BT.601", "BT.709", "SMPTE 170M", "SMPTE 240M",
        "BT.2020", "reserved", "sRGB"};
    const int cs = r.lit(3);
    if (cs != 0 && cs != 1 && cs != 2 && cs != 3)
      unsupported(std::string(kSpaces[cs]) + " colour space");
    bt709_ = cs == 2;
    if (r.bit()) unsupported("full-range colour");
    const int w = r.lit(16) + 1, h = r.lit(16) + 1;
    if (r.bit()) r.lit(32);  // render size
    if (r.over()) corrupt("truncated header");
    setup_size(w, h);
    refresh_ = 0xFF;
    have_key_ = true;
  } else {
    const bool intra_only = show_ ? false : r.bit();
    if (!error_res_) r.lit(2);  // reset_frame_context: for intra-only
    if (intra_only) unsupported("intra-only frame");
    if (!have_key_) corrupt("inter frame before the first key frame");
    refresh_ = r.lit(8);
    for (int i = 0; i < 3; ++i) {
      ref_idx_[i] = r.lit(3);
      sign_bias_[1 + i] = r.bit() && !error_res_;
      if (!refs_[ref_idx_[i]]) corrupt("missing reference");
    }
    int w = 0, h = 0;
    bool found = false;
    for (int i = 0; i < 3 && !found; ++i)
      if (r.bit()) {
        w = refs_[ref_idx_[i]]->w;
        h = refs_[ref_idx_[i]]->h;
        found = true;
      }
    if (!found) {
      w = r.lit(16) + 1;
      h = r.lit(16) + 1;
    }
    use_prev_mvs_ = use_prev_mvs_ && w == last_w_ && h == last_h_;
    if (r.bit()) r.lit(32);  // render size
    if (r.over()) corrupt("truncated header");
    for (int i = 0; i < 3; ++i) {
      const Frame& f = *refs_[ref_idx_[i]];
      if (f.w != w || f.h != h)
        unsupported("scaled reference (a " + std::to_string(f.w) + "x" +
                    std::to_string(f.h) + " reference for a " +
                    std::to_string(w) + "x" + std::to_string(h) + " frame)");
    }
    setup_size(w, h);
    hp_ = r.bit();
    filter_ = r.bit() ? kSwitchable : int(kLiteralToFilter[r.lit(2)]);
  }
  if (!error_res_) {
    refresh_ctx_ = r.bit();
    parallel_ = r.bit();
  } else {
    refresh_ctx_ = false;
    parallel_ = true;
  }
  ctx_idx_ = r.lit(2);
  if (key_) sign_bias_[1] = sign_bias_[2] = sign_bias_[3] = 0;
  if (key_ || error_res_) past_independence();
  // loop filter
  lf_level_ = r.lit(6);
  sharpness_ = r.lit(3);
  lf_deltas_ = r.bit();
  if (lf_deltas_ && r.bit()) {  // deltas updated
    for (int& d : lf_ref_deltas_)
      if (r.bit()) d = r.signed_lit(6);
    for (int& d : lf_mode_deltas_)
      if (r.bit()) d = r.signed_lit(6);
  }
  // quantiser
  base_q_ = r.lit(8);
  ydc_dq_ = r.bit() ? r.signed_lit(4) : 0;
  uvdc_dq_ = r.bit() ? r.signed_lit(4) : 0;
  uvac_dq_ = r.bit() ? r.signed_lit(4) : 0;
  lossless_ = base_q_ == 0 && ydc_dq_ == 0 && uvdc_dq_ == 0 && uvac_dq_ == 0;
  // segmentation
  seg_.update_map = false;
  if ((seg_.enabled = r.bit())) {
    if ((seg_.update_map = r.bit())) {
      for (uint8_t& p : seg_.tree_probs) p = r.bit() ? r.lit(8) : 255;
      if ((seg_.temporal = r.bit()))
        for (uint8_t& p : seg_.pred_probs) p = r.bit() ? r.lit(8) : 255;
      else
        for (uint8_t& p : seg_.pred_probs) p = 255;
    }
    if (r.bit()) {  // update_data
      seg_.abs_delta = r.bit();
      const int bits[4] = {8, 6, 2, 0};
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) {
          int v = 0;
          if ((seg_.feature[i][j] = r.bit())) {
            v = r.lit(bits[j]);
            if (j < 2 && r.bit()) v = -v;
          }
          seg_.data[i][j] = v;
        }
    }
  }
  // tiles
  int min_log2 = 0, max_log2 = 1;
  while ((64 << min_log2) < sb_cols_) ++min_log2;
  while ((sb_cols_ >> max_log2) >= 4) ++max_log2;
  --max_log2;
  log2_tile_cols_ = min_log2;
  while (log2_tile_cols_ < max_log2 && r.bit()) ++log2_tile_cols_;
  log2_tile_rows_ = r.bit();
  if (log2_tile_rows_) log2_tile_rows_ += r.bit();
  const int size = r.lit(16);
  if (r.over()) corrupt("truncated header");
  if (r.pad()) corrupt("nonzero bits after the header");
  if (!size) corrupt("compressed header size 0");
  return size;
}

void Decoder::diff_update(Bool& b, uint8_t& p) {
  if (!b.get(252)) return;
  int v;
  if (!b.get(128)) {
    v = b.literal(4);
  } else if (!b.get(128)) {
    v = b.literal(4) + 16;
  } else if (!b.get(128)) {
    v = b.literal(5) + 32;
  } else {
    v = b.literal(7);
    if (v >= 65) v = (v << 1) - 65 + b.get(128);
    v += 64;
  }
  v = inv_map_table[std::min(v, 254)];
  const int m = p - 1;
  auto recenter = [](int x, int c) {
    if (x > 2 * c) return x;
    return (x & 1) ? c - ((x + 1) >> 1) : c + (x >> 1);
  };
  p = static_cast<uint8_t>((m << 1) <= 255 ? 1 + recenter(v, m)
                                            : 255 - recenter(v, 254 - m));
}

void Decoder::coef_probs(Bool& b) {
  const int max_tx = tx_mode_to_biggest_tx_size[tx_mode_];
  for (int t = 0; t <= max_tx; ++t) {
    if (!b.get(128)) continue;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < (k ? 6 : 3); ++l)
            for (int m = 0; m < 3; ++m) diff_update(b, p_.coef[t][i][j][k][l][m]);
  }
}

void Decoder::mv_probs(Bool& b) {
  auto upd = [&](uint8_t* p, int n) {
    for (int i = 0; i < n; ++i)
      if (b.get(252)) p[i] = static_cast<uint8_t>((b.literal(7) << 1) | 1);
  };
  upd(p_.mv_joints, 3);
  for (MvComp& c : p_.mv) {
    upd(&c.sign, 1);
    upd(c.classes, 10);
    upd(c.class0, 1);
    upd(c.bits, 10);
  }
  for (MvComp& c : p_.mv) {
    for (auto& f : c.class0_fp) upd(f, 3);
    upd(c.fp, 3);
  }
  if (hp_)
    for (MvComp& c : p_.mv) {
      upd(&c.class0_hp, 1);
      upd(&c.hp, 1);
    }
}

void Decoder::compressed_header(Bool& b) {
  if (lossless_) {
    tx_mode_ = ONLY_4X4;
  } else {
    tx_mode_ = b.literal(2);
    if (tx_mode_ == ALLOW_32X32) tx_mode_ += b.get(128);
  }
  if (tx_mode_ == TX_MODE_SELECT) {
    for (auto& p : p_.tx8) diff_update(b, p[0]);
    for (auto& p : p_.tx16)
      for (uint8_t& q : p) diff_update(b, q);
    for (auto& p : p_.tx32)
      for (uint8_t& q : p) diff_update(b, q);
  }
  coef_probs(b);
  for (uint8_t& p : p_.skip) diff_update(b, p);
  if (key_) return;
  for (auto& p : p_.inter_mode)
    for (uint8_t& q : p) diff_update(b, q);
  if (filter_ == kSwitchable)
    for (auto& p : p_.interp)
      for (uint8_t& q : p) diff_update(b, q);
  for (uint8_t& p : p_.intra_inter) diff_update(b, p);
  // reference mode: compound only where two references differ in sign bias
  ref_mode_ = SINGLE_REF;
  if (sign_bias_[2] != sign_bias_[1] || sign_bias_[3] != sign_bias_[1])
    ref_mode_ = b.get(128) ? (b.get(128) ? REF_SELECT : COMPOUND_REF)
                           : SINGLE_REF;
  if (ref_mode_ != SINGLE_REF) {
    if (sign_bias_[LAST_FRAME] == sign_bias_[GOLDEN_FRAME]) {
      comp_fixed_ = ALTREF_FRAME;
      comp_var_[0] = LAST_FRAME;
      comp_var_[1] = GOLDEN_FRAME;
    } else if (sign_bias_[LAST_FRAME] == sign_bias_[ALTREF_FRAME]) {
      comp_fixed_ = GOLDEN_FRAME;
      comp_var_[0] = LAST_FRAME;
      comp_var_[1] = ALTREF_FRAME;
    } else {
      comp_fixed_ = LAST_FRAME;
      comp_var_[0] = GOLDEN_FRAME;
      comp_var_[1] = ALTREF_FRAME;
    }
  }
  if (ref_mode_ == REF_SELECT)
    for (uint8_t& p : p_.comp_inter) diff_update(b, p);
  if (ref_mode_ != COMPOUND_REF)
    for (auto& p : p_.single_ref) {
      diff_update(b, p[0]);
      diff_update(b, p[1]);
    }
  if (ref_mode_ != SINGLE_REF)
    for (uint8_t& p : p_.comp_ref) diff_update(b, p);
  for (auto& p : p_.y_mode)
    for (uint8_t& q : p) diff_update(b, q);
  for (auto& p : p_.partition)
    for (uint8_t& q : p) diff_update(b, q);
  mv_probs(b);
}

int Decoder::qindex(int seg) const {
  if (seg_.enabled && seg_.feature[seg][SEG_ALT_Q]) {
    const int d = seg_.data[seg][SEG_ALT_Q];
    return std::clamp(seg_.abs_delta ? d : base_q_ + d, 0, 255);
  }
  return base_q_;
}

}  // namespace

namespace {

// ------------------------------------------------------ tiles and blocks

int tile_offset(int idx, int mis, int log2) {
  const int sbs = (mis + 7) >> 3;
  return std::min(((idx * sbs) >> log2) << 3, mis);
}

void Decoder::decode_tiles(const uint8_t* data, size_t n,
                           const uint8_t* end) {
  const int tile_cols = 1 << log2_tile_cols_, tile_rows = 1 << log2_tile_rows_;
  for (int p = 0; p < 3; ++p) above_nz_[p].assign(size_t(sb_cols_) * 16 + 16, 0);
  above_part_.assign(size_t(sb_cols_) * 8 + 8, 0);
  std::vector<TileCtx> tiles(tile_cols);
  for (int tr = 0; tr < tile_rows; ++tr) {
    for (int tc = 0; tc < tile_cols; ++tc) {
      size_t size = n;
      if (tr != tile_rows - 1 || tc != tile_cols - 1) {
        if (n < 4) corrupt("tile size");
        size = (size_t(data[0]) << 24) | (size_t(data[1]) << 16) |
               (size_t(data[2]) << 8) | data[3];
        data += 4;
        n -= 4;
      }
      if (size > n || size < 1) corrupt("tile size");
      TileCtx& t = tiles[tc];
      t.b.init(data, int64_t(size), end);
      if (t.b.get(128)) corrupt("tile marker bit");
      t.col_start = tile_offset(tc, mi_cols_, log2_tile_cols_);
      t.col_end = tile_offset(tc + 1, mi_cols_, log2_tile_cols_);
      data += size;
      n -= size;
    }
    const int row_end = tile_offset(tr + 1, mi_rows_, log2_tile_rows_);
    for (int row = tile_offset(tr, mi_rows_, log2_tile_rows_); row < row_end;
         row += 8)
      for (TileCtx& t : tiles) {
        std::memset(t.left_nz, 0, sizeof(t.left_nz));
        std::memset(t.left_part, 0, sizeof(t.left_part));
        for (int col = t.col_start; col < t.col_end; col += 8)
          decode_partition(t, row, col, BLOCK_64X64);
      }
  }
}

void Decoder::decode_partition(TileCtx& t, int row, int col, int bsize) {
  if (row >= mi_rows_ || col >= mi_cols_) return;
  const int n8 = num_8x8_blocks_wide_lookup[bsize], hbs = n8 >> 1;
  const int bsl = bsize == BLOCK_8X8 ? 0 : bsize == BLOCK_16X16 ? 1
                  : bsize == BLOCK_32X32 ? 2 : 3;
  const int a = (above_part_[col] >> bsl) & 1;
  const int l = (t.left_part[row & 7] >> bsl) & 1;
  const int ctx = l * 2 + a + bsl * 4;
  const uint8_t* probs = key_ ? vp9_kf_partition_probs[ctx] : p_.partition[ctx];
  const bool has_rows = row + hbs < mi_rows_, has_cols = col + hbs < mi_cols_;
  int part;
  if (has_rows && has_cols)
    part = t.b.tree(vp9_partition_tree, probs);
  else if (!has_rows && has_cols)
    part = t.b.get(probs[1]) ? PARTITION_SPLIT : PARTITION_HORZ;
  else if (has_rows && !has_cols)
    part = t.b.get(probs[2]) ? PARTITION_SPLIT : PARTITION_VERT;
  else
    part = PARTITION_SPLIT;
  ++c_.partition[ctx][part];
  const int sub = subsize_lookup[part][bsize];
  if (!hbs) {
    decode_block(t, row, col, sub);
  } else {
    switch (part) {
      case PARTITION_NONE:
        decode_block(t, row, col, sub);
        break;
      case PARTITION_HORZ:
        decode_block(t, row, col, sub);
        if (has_rows) decode_block(t, row + hbs, col, sub);
        break;
      case PARTITION_VERT:
        decode_block(t, row, col, sub);
        if (has_cols) decode_block(t, row, col + hbs, sub);
        break;
      default:
        decode_partition(t, row, col, sub);
        decode_partition(t, row, col + hbs, sub);
        decode_partition(t, row + hbs, col, sub);
        decode_partition(t, row + hbs, col + hbs, sub);
    }
  }
  if (bsize == BLOCK_8X8 || part != PARTITION_SPLIT) {
    std::memset(&above_part_[col], partition_context_lookup[sub][0], n8);
    std::memset(&t.left_part[row & 7], partition_context_lookup[sub][1],
                std::min(n8, 8 - (row & 7)));
  }
}

void Decoder::decode_block(TileCtx& t, int row, int col, int bsize) {
  MI m;
  m.sb_type = static_cast<uint8_t>(bsize);
  if (key_)
    intra_frame_mode_info(t, m, row, col);
  else
    inter_frame_mode_info(t, m, row, col);
  const int bw4 = std::max(2, kBw4[bsize]), bh4 = std::max(2, kBh4[bsize]);
  if (m.skip)
    for (int p = 0; p < 3; ++p) {
      const int s = p ? 1 : 0;
      std::memset(&above_nz_[p][(col * 2) >> s], 0, bw4 >> s);
      std::memset(&t.left_nz[p][((row & 7) * 2) >> s], 0, bh4 >> s);
    }
  if (!is_inter(m)) {
    reconstruct_intra(t, m, row, col);
  } else {
    predict_inter(m, row, col);
    stats[kStatCompound] += has_second(m);
    stats[kStatSubblockInter] += bsize < BLOCK_8X8;
    if (!m.skip && !reconstruct_inter(t, m, row, col) && bsize >= BLOCK_8X8)
      m.skip = 1;  // no coefficient: the loop filter skips its inner edges
  }
  const int bw8 = std::max(1, bw4 >> 1), bh8 = std::max(1, bh4 >> 1);
  const int xe = std::min(bw8, mi_cols_ - col), ye = std::min(bh8, mi_rows_ - row);
  MvRef mr;
  mr.ref[0] = m.ref[0];
  mr.ref[1] = m.ref[1];
  mr.mv[0] = m.mv[0];
  mr.mv[1] = m.mv[1];
  for (int y = 0; y < ye; ++y)
    for (int x = 0; x < xe; ++x) {
      at(row + y, col + x) = m;
      cur_mvs_[size_t(row + y) * mi_cols_ + col + x] = mr;
    }
}

// --------------------------------------------------------------- segments

int Decoder::predicted_segment(int row, int col, int bw, int bh) const {
  int id = 7;
  for (int y = 0; y < bh; ++y)
    for (int x = 0; x < bw; ++x)
      id = std::min<int>(id, seg_prev_[size_t(row + y) * mi_cols_ + col + x]);
  return id;
}

void Decoder::write_segment(int row, int col, int bw, int bh, int id) {
  for (int y = 0; y < bh; ++y)
    for (int x = 0; x < bw; ++x)
      seg_cur_[size_t(row + y) * mi_cols_ + col + x] = static_cast<uint8_t>(id);
}

int Decoder::read_segment_id(TileCtx& t) {
  return t.b.tree(vp9_segment_tree, seg_.tree_probs);
}

}  // namespace

namespace {

// --------------------------------------------------------------- mode info

int Decoder::read_tx_size(TileCtx& t, const MI& m, int row, int col,
                          bool allow_select) {
  const int max_tx = max_txsize_lookup[m.sb_type];
  if (!(allow_select && tx_mode_ == TX_MODE_SELECT && m.sb_type >= BLOCK_8X8))
    return std::min<int>(max_tx, tx_mode_to_biggest_tx_size[tx_mode_]);
  // the context: the neighbours' sizes (the largest where they skip)
  const MI* a = above(row, col);
  const MI* l = left(t, row, col);
  int actx = a && !a->skip ? a->tx_size : max_tx;
  int lctx = l && !l->skip ? l->tx_size : max_tx;
  if (!l) lctx = actx;
  if (!a) actx = lctx;
  const int ctx = actx + lctx > max_tx;
  const uint8_t* probs = max_tx == TX_8X8 ? p_.tx8[ctx]
                         : max_tx == TX_16X16 ? p_.tx16[ctx] : p_.tx32[ctx];
  int tx = t.b.get(probs[0]);
  if (tx && max_tx >= TX_16X16) {
    tx += t.b.get(probs[1]);
    if (tx != TX_8X8 && max_tx >= TX_32X32) tx += t.b.get(probs[2]);
  }
  if (max_tx == TX_8X8)
    ++c_.tx8[ctx][tx];
  else if (max_tx == TX_16X16)
    ++c_.tx16[ctx][tx];
  else
    ++c_.tx32[ctx][tx];
  return tx;
}

// A key frame's luma mode of 4x4 block b (or of the whole block, b 0),
// from the modes above and to the left of it.
int Decoder::kf_y_mode(TileCtx& t, const MI& m, int row, int col, int b) {
  int am, lm;
  if (b < 2) {
    const MI* a = above(row, col);
    am = !a ? 0 : a->sb_type < BLOCK_8X8 ? a->bmode[b + 2] : a->mode;
  } else {
    am = m.bmode[b - 2];
  }
  if (!(b & 1)) {
    const MI* l = left(t, row, col);
    lm = !l ? 0 : l->sb_type < BLOCK_8X8 ? l->bmode[b + 1] : l->mode;
  } else {
    lm = m.bmode[b - 1];
  }
  return t.b.tree(vp9_intra_mode_tree, vp9_kf_y_mode_prob[am][lm]);
}

void Decoder::intra_frame_mode_info(TileCtx& t, MI& m, int row, int col) {
  const int bw = std::min<int>(num_8x8_blocks_wide_lookup[m.sb_type], mi_cols_ - col);
  const int bh = std::min<int>(num_8x8_blocks_high_lookup[m.sb_type], mi_rows_ - row);
  m.seg_id = 0;
  if (seg_.enabled) {
    if (seg_.update_map) {
      m.seg_id = static_cast<uint8_t>(read_segment_id(t));
      write_segment(row, col, bw, bh, m.seg_id);
    } else {
      for (int y = 0; y < bh; ++y)
        for (int x = 0; x < bw; ++x) {
          const size_t i = size_t(row + y) * mi_cols_ + col + x;
          seg_cur_[i] = seg_prev_[i];
        }
    }
  }
  if (seg_.enabled && seg_.feature[m.seg_id][SEG_SKIP]) {
    m.skip = 1;
  } else {
    const MI* a = above(row, col);
    const MI* l = left(t, row, col);
    const int ctx = (a ? a->skip : 0) + (l ? l->skip : 0);
    m.skip = static_cast<uint8_t>(t.b.get(p_.skip[ctx]));
    ++c_.skip[ctx][m.skip];
  }
  m.tx_size = static_cast<uint8_t>(read_tx_size(t, m, row, col, true));
  m.ref[0] = INTRA_FRAME;
  m.ref[1] = -1;
  switch (m.sb_type) {
    case BLOCK_4X4:
      for (int b = 0; b < 4; ++b)
        m.bmode[b] = static_cast<uint8_t>(kf_y_mode(t, m, row, col, b));
      break;
    case BLOCK_4X8:
      m.bmode[0] = m.bmode[2] = static_cast<uint8_t>(kf_y_mode(t, m, row, col, 0));
      m.bmode[1] = m.bmode[3] = static_cast<uint8_t>(kf_y_mode(t, m, row, col, 1));
      break;
    case BLOCK_8X4:
      m.bmode[0] = m.bmode[1] = static_cast<uint8_t>(kf_y_mode(t, m, row, col, 0));
      m.bmode[2] = m.bmode[3] = static_cast<uint8_t>(kf_y_mode(t, m, row, col, 2));
      break;
    default:
      m.bmode[0] = static_cast<uint8_t>(kf_y_mode(t, m, row, col, 0));
      m.bmode[1] = m.bmode[2] = m.bmode[3] = m.bmode[0];
  }
  m.mode = m.bmode[3];
  m.uv_mode = static_cast<uint8_t>(
      t.b.tree(vp9_intra_mode_tree, vp9_kf_uv_mode_prob[m.mode]));
}

void Decoder::inter_frame_mode_info(TileCtx& t, MI& m, int row, int col) {
  const int bw = std::min<int>(num_8x8_blocks_wide_lookup[m.sb_type], mi_cols_ - col);
  const int bh = std::min<int>(num_8x8_blocks_high_lookup[m.sb_type], mi_rows_ - row);
  const MI* a = above(row, col);
  const MI* l = left(t, row, col);
  m.seg_id = 0;
  if (seg_.enabled) {
    const int pred = predicted_segment(row, col, bw, bh);
    if (!seg_.update_map) {
      for (int y = 0; y < bh; ++y)
        for (int x = 0; x < bw; ++x) {
          const size_t i = size_t(row + y) * mi_cols_ + col + x;
          seg_cur_[i] = seg_prev_[i];
        }
      m.seg_id = static_cast<uint8_t>(pred);
    } else {
      if (seg_.temporal) {
        const int ctx = (a ? a->seg_pred : 0) + (l ? l->seg_pred : 0);
        m.seg_pred = static_cast<uint8_t>(t.b.get(seg_.pred_probs[ctx]));
        m.seg_id = static_cast<uint8_t>(m.seg_pred ? pred : read_segment_id(t));
      } else {
        m.seg_id = static_cast<uint8_t>(read_segment_id(t));
      }
      write_segment(row, col, bw, bh, m.seg_id);
    }
  }
  const bool* feat = seg_.enabled ? seg_.feature[m.seg_id] : nullptr;
  if (feat && feat[SEG_SKIP]) {
    m.skip = 1;
  } else {
    const int ctx = (a ? a->skip : 0) + (l ? l->skip : 0);
    m.skip = static_cast<uint8_t>(t.b.get(p_.skip[ctx]));
    ++c_.skip[ctx][m.skip];
  }
  bool inter;
  if (feat && feat[SEG_REF]) {
    inter = seg_.data[m.seg_id][SEG_REF] != INTRA_FRAME;
  } else {
    int ctx;
    if (a && l) {
      const bool ai = !is_inter(*a), li = !is_inter(*l);
      ctx = ai && li ? 3 : (ai || li);
    } else if (a || l) {
      ctx = 2 * !is_inter(a ? *a : *l);
    } else {
      ctx = 0;
    }
    inter = t.b.get(p_.intra_inter[ctx]);
    ++c_.intra_inter[ctx][inter];
  }
  m.tx_size = static_cast<uint8_t>(read_tx_size(t, m, row, col, !m.skip || !inter));
  if (inter) {
    read_inter_block(t, m, row, col);
    return;
  }
  m.ref[0] = INTRA_FRAME;
  m.ref[1] = -1;
  auto ymode = [&](int group) {
    const int v = t.b.tree(vp9_intra_mode_tree, p_.y_mode[group]);
    ++c_.y_mode[group][v];
    return static_cast<uint8_t>(v);
  };
  switch (m.sb_type) {
    case BLOCK_4X4:
      for (int b = 0; b < 4; ++b) m.bmode[b] = ymode(0);
      break;
    case BLOCK_4X8:
      m.bmode[0] = m.bmode[2] = ymode(0);
      m.bmode[1] = m.bmode[3] = ymode(0);
      break;
    case BLOCK_8X4:
      m.bmode[0] = m.bmode[1] = ymode(0);
      m.bmode[2] = m.bmode[3] = ymode(0);
      break;
    default:
      m.bmode[0] = m.bmode[1] = m.bmode[2] = m.bmode[3] =
          ymode(size_group_lookup[m.sb_type]);
  }
  m.mode = m.bmode[3];
  m.uv_mode = static_cast<uint8_t>(t.b.tree(vp9_intra_mode_tree, p_.uv_mode[m.mode]));
  ++c_.uv_mode[m.mode][m.uv_mode];
}

void Decoder::read_ref_frames(TileCtx& t, MI& m, int row, int col) {
  if (seg_.enabled && seg_.feature[m.seg_id][SEG_REF]) {
    m.ref[0] = static_cast<int8_t>(seg_.data[m.seg_id][SEG_REF]);
    m.ref[1] = -1;
    return;
  }
  const MI* a = above(row, col);
  const MI* l = left(t, row, col);
  int mode = ref_mode_;
  if (ref_mode_ == REF_SELECT) {
    int ctx;
    if (a && l) {
      if (!has_second(*a) && !has_second(*l))
        ctx = (a->ref[0] == comp_fixed_) ^ (l->ref[0] == comp_fixed_);
      else if (!has_second(*a))
        ctx = 2 + (a->ref[0] == comp_fixed_ || !is_inter(*a));
      else if (!has_second(*l))
        ctx = 2 + (l->ref[0] == comp_fixed_ || !is_inter(*l));
      else
        ctx = 4;
    } else if (a || l) {
      const MI& e = a ? *a : *l;
      ctx = !has_second(e) ? e.ref[0] == comp_fixed_ : 3;
    } else {
      ctx = 1;
    }
    mode = t.b.get(p_.comp_inter[ctx]);
    ++c_.comp_inter[ctx][mode];
  }
  if (mode == COMPOUND_REF) {
    const int fix = sign_bias_[comp_fixed_], var = !fix;
    int ctx;
    if (a && l) {
      const bool ai = !is_inter(*a), li = !is_inter(*l);
      if (ai && li) {
        ctx = 2;
      } else if (ai || li) {
        const MI& e = ai ? *l : *a;
        ctx = !has_second(e) ? 1 + 2 * (e.ref[0] != comp_var_[1])
                             : 1 + 2 * (e.ref[var] != comp_var_[1]);
      } else {
        const bool lsg = !has_second(*l), asg = !has_second(*a);
        const int vrfa = asg ? a->ref[0] : a->ref[var];
        const int vrfl = lsg ? l->ref[0] : l->ref[var];
        if (vrfa == vrfl && comp_var_[1] == vrfa) {
          ctx = 0;
        } else if (lsg && asg) {
          if ((vrfa == comp_fixed_ && vrfl == comp_var_[0]) ||
              (vrfl == comp_fixed_ && vrfa == comp_var_[0]))
            ctx = 4;
          else if (vrfa == vrfl)
            ctx = 3;
          else
            ctx = 1;
        } else if (lsg || asg) {
          const int vrfc = lsg ? vrfa : vrfl;
          const int rfs = asg ? vrfa : vrfl;
          if (vrfc == comp_var_[1] && rfs != comp_var_[1])
            ctx = 1;
          else if (rfs == comp_var_[1] && vrfc != comp_var_[1])
            ctx = 2;
          else
            ctx = 4;
        } else if (vrfa == vrfl) {
          ctx = 4;
        } else {
          ctx = 2;
        }
      }
    } else if (a || l) {
      const MI& e = a ? *a : *l;
      if (!is_inter(e))
        ctx = 2;
      else if (has_second(e))
        ctx = 4 * (e.ref[var] != comp_var_[1]);
      else
        ctx = 3 * (e.ref[0] != comp_var_[1]);
    } else {
      ctx = 2;
    }
    const int bit = t.b.get(p_.comp_ref[ctx]);
    ++c_.comp_ref[ctx][bit];
    m.ref[fix] = static_cast<int8_t>(comp_fixed_);
    m.ref[!fix] = static_cast<int8_t>(comp_var_[bit]);
    return;
  }
  // single reference: LAST, or GOLDEN / ALTREF
  int ctx;
  if (a && l) {
    const bool ai = !is_inter(*a), li = !is_inter(*l);
    if (ai && li) {
      ctx = 2;
    } else if (ai || li) {
      const MI& e = ai ? *l : *a;
      ctx = !has_second(e) ? 4 * (e.ref[0] == LAST_FRAME)
                           : 1 + (e.ref[0] == LAST_FRAME || e.ref[1] == LAST_FRAME);
    } else {
      const bool a2 = has_second(*a), l2 = has_second(*l);
      const int a0 = a->ref[0], a1 = a->ref[1], l0 = l->ref[0], l1 = l->ref[1];
      if (a2 && l2) {
        ctx = 1 + (a0 == LAST_FRAME || a1 == LAST_FRAME || l0 == LAST_FRAME ||
                   l1 == LAST_FRAME);
      } else if (a2 || l2) {
        const int rfs = !a2 ? a0 : l0;
        const int crf1 = a2 ? a0 : l0, crf2 = a2 ? a1 : l1;
        ctx = rfs == LAST_FRAME ? 3 + (crf1 == LAST_FRAME || crf2 == LAST_FRAME)
                                : (crf1 == LAST_FRAME || crf2 == LAST_FRAME);
      } else {
        ctx = 2 * (a0 == LAST_FRAME) + 2 * (l0 == LAST_FRAME);
      }
    }
  } else if (a || l) {
    const MI& e = a ? *a : *l;
    if (!is_inter(e))
      ctx = 2;
    else if (!has_second(e))
      ctx = 4 * (e.ref[0] == LAST_FRAME);
    else
      ctx = 1 + (e.ref[0] == LAST_FRAME || e.ref[1] == LAST_FRAME);
  } else {
    ctx = 2;
  }
  const int bit0 = t.b.get(p_.single_ref[ctx][0]);
  ++c_.single_ref[ctx][0][bit0];
  m.ref[1] = -1;
  if (!bit0) {
    m.ref[0] = LAST_FRAME;
    return;
  }
  if (a && l) {
    const bool ai = !is_inter(*a), li = !is_inter(*l);
    if (ai && li) {
      ctx = 2;
    } else if (ai || li) {
      const MI& e = ai ? *l : *a;
      if (!has_second(e))
        ctx = e.ref[0] == LAST_FRAME ? 3 : 4 * (e.ref[0] == GOLDEN_FRAME);
      else
        ctx = 1 + 2 * (e.ref[0] == GOLDEN_FRAME || e.ref[1] == GOLDEN_FRAME);
    } else {
      const bool a2 = has_second(*a), l2 = has_second(*l);
      const int a0 = a->ref[0], a1 = a->ref[1], l0 = l->ref[0], l1 = l->ref[1];
      if (a2 && l2) {
        if (a0 == l0 && a1 == l1)
          ctx = 3 * (a0 == GOLDEN_FRAME || a1 == GOLDEN_FRAME ||
                     l0 == GOLDEN_FRAME || l1 == GOLDEN_FRAME);
        else
          ctx = 2;
      } else if (a2 || l2) {
        const int rfs = !a2 ? a0 : l0;
        const int crf1 = a2 ? a0 : l0, crf2 = a2 ? a1 : l1;
        if (rfs == GOLDEN_FRAME)
          ctx = 3 + (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
        else if (rfs == ALTREF_FRAME)
          ctx = crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME;
        else
          ctx = 1 + 2 * (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
      } else {
        if (a0 == LAST_FRAME && l0 == LAST_FRAME) {
          ctx = 3;
        } else if (a0 == LAST_FRAME || l0 == LAST_FRAME) {
          const int e0 = a0 == LAST_FRAME ? l0 : a0;
          ctx = 4 * (e0 == GOLDEN_FRAME);
        } else {
          ctx = 2 * (a0 == GOLDEN_FRAME) + 2 * (l0 == GOLDEN_FRAME);
        }
      }
    }
  } else if (a || l) {
    const MI& e = a ? *a : *l;
    if (!is_inter(e) || (e.ref[0] == LAST_FRAME && !has_second(e)))
      ctx = 2;
    else if (!has_second(e))
      ctx = 4 * (e.ref[0] == GOLDEN_FRAME);
    else
      ctx = 3 * (e.ref[0] == GOLDEN_FRAME || e.ref[1] == GOLDEN_FRAME);
  } else {
    ctx = 2;
  }
  const int bit1 = t.b.get(p_.single_ref[ctx][1]);
  ++c_.single_ref[ctx][1][bit1];
  m.ref[0] = bit1 ? ALTREF_FRAME : GOLDEN_FRAME;
}

}  // namespace

namespace {

// ------------------------------------------------------- motion vectors

const int kSubblockOfNeighbour[4][2] = {{1, 2}, {1, 3}, {3, 2}, {3, 3}};

int Decoder::mode_context(const MI& m, int row, int col,
                          const TileCtx& t) const {
  const int32_t(*pos)[2] = mv_ref_blocks[m.sb_type];
  int counter = 0;
  for (int i = 0; i < 2; ++i) {
    const int r = row + pos[i][0], c = col + pos[i][1];
    if (r >= 0 && r < mi_rows_ && c >= t.col_start && c < t.col_end)
      counter += mode_2_counter[mi_[size_t(r) * mi_cols_ + c].mode];
  }
  return counter_to_context[counter];
}

// The two candidate vectors for reference `ref` (libvpx's find_mv_refs),
// clamped to 16 pixels beyond the frame; `block` >= 0 takes the nearest
// neighbours' 4x4 vectors for that 4x4 block of a block below 8x8.
void Decoder::find_mv_refs(const TileCtx& t, const MI& m, int row, int col,
                           int ref, int block, Mv list[2]) const {
  const int32_t(*pos)[2] = mv_ref_blocks[m.sb_type];
  list[0] = list[1] = Mv{};
  int count = 0;
  bool different = false;
  auto add = [&](const Mv& mv) {
    if (count) {
      if (mv != list[0]) {
        list[1] = mv;
        count = 2;
        return true;
      }
      return false;
    }
    list[count++] = mv;
    return false;
  };
  auto scaled = [&](int r, Mv mv) {
    if (sign_bias_[r] != sign_bias_[ref]) {
      mv.row = static_cast<int16_t>(-mv.row);
      mv.col = static_cast<int16_t>(-mv.col);
    }
    return mv;
  };
  auto cand = [&](int i) -> const MI* {
    const int r = row + pos[i][0], c = col + pos[i][1];
    if (r < 0 || r >= mi_rows_ || c < t.col_start || c >= t.col_end)
      return nullptr;
    return &mi_[size_t(r) * mi_cols_ + c];
  };
  const MvRef* prev =
      use_prev_mvs_ ? &prev_mvs_[size_t(row) * mi_cols_ + col] : nullptr;
  bool done = false;
  for (int i = 0; i < 8 && !done; ++i) {
    const MI* c = cand(i);
    if (!c) continue;
    different = true;
    for (int w = 0; w < 2; ++w)
      if (c->ref[w] == ref) {
        Mv mv = c->mv[w];
        if (i < 2 && block >= 0 && c->sb_type < BLOCK_8X8)
          mv = c->bmv[kSubblockOfNeighbour[block][pos[i][1] == 0]][w];
        done = add(mv);
        break;
      }
  }
  if (!done && prev) {
    if (prev->ref[0] == ref)
      done = add(prev->mv[0]);
    else if (prev->ref[1] == ref)
      done = add(prev->mv[1]);
  }
  if (!done && different)
    for (int i = 0; i < 8 && !done; ++i) {
      const MI* c = cand(i);
      if (!c || !is_inter(*c)) continue;
      if (c->ref[0] != ref) done = add(scaled(c->ref[0], c->mv[0]));
      if (!done && has_second(*c) && c->ref[1] != ref && c->mv[1] != c->mv[0])
        done = add(scaled(c->ref[1], c->mv[1]));
    }
  if (!done && prev) {
    if (prev->ref[0] != ref && prev->ref[0] > INTRA_FRAME)
      done = add(scaled(prev->ref[0], prev->mv[0]));
    if (!done && prev->ref[1] > INTRA_FRAME && prev->ref[1] != ref &&
        prev->mv[1] != prev->mv[0])
      add(scaled(prev->ref[1], prev->mv[1]));
  }
  const int bw8 = std::max(1, int(num_8x8_blocks_wide_lookup[m.sb_type]));
  const int bh8 = std::max(1, int(num_8x8_blocks_high_lookup[m.sb_type]));
  const int lo_c = -(col * 64) - 128, hi_c = (mi_cols_ - bw8 - col) * 64 + 128;
  const int lo_r = -(row * 64) - 128, hi_r = (mi_rows_ - bh8 - row) * 64 + 128;
  for (int i = 0; i < 2; ++i) {
    list[i].col = static_cast<int16_t>(std::clamp<int>(list[i].col, lo_c, hi_c));
    list[i].row = static_cast<int16_t>(std::clamp<int>(list[i].row, lo_r, hi_r));
  }
}

inline Mv lower_precision(Mv mv, bool allow_hp) {
  const bool use_hp = allow_hp && std::abs(mv.row) < 64 && std::abs(mv.col) < 64;
  if (!use_hp) {
    if (mv.row & 1) mv.row = static_cast<int16_t>(mv.row + (mv.row > 0 ? -1 : 1));
    if (mv.col & 1) mv.col = static_cast<int16_t>(mv.col + (mv.col > 0 ? -1 : 1));
  }
  return mv;
}

int Decoder::read_mv_component(TileCtx& t, int comp, bool hp) {
  const MvComp& p = p_.mv[comp];
  MvCompCounts& c = c_.mv[comp];
  const int sign = t.b.get(p.sign);
  const int cls = t.b.tree(vp9_mv_class_tree, p.classes);
  ++c.sign[sign];
  ++c.classes[cls];
  int n;
  if (cls) {
    n = 0;
    for (int m = 0; m < cls; ++m) {
      const int bit = t.b.get(p.bits[m]);
      n |= bit << m;
      ++c.bits[m][bit];
    }
    n <<= 3;
    const int fr = t.b.tree(vp9_mv_fp_tree, p.fp);
    ++c.fp[fr];
    n |= fr << 1;
    if (hp) {
      const int bit = t.b.get(p.hp);
      ++c.hp[bit];
      n |= bit;
    } else {
      n |= 1;
      ++c.hp[1];  // counted although not coded, as libvpx counts it
    }
    n += 8 << cls;  // the class base, 2 << (cls + 2)
  } else {
    const int d = t.b.get(p.class0[0]);
    ++c.class0[d];
    const int fr = t.b.tree(vp9_mv_fp_tree, p.class0_fp[d]);
    ++c.class0_fp[d][fr];
    n = (d << 3) | (fr << 1);
    if (hp) {
      const int bit = t.b.get(p.class0_hp);
      ++c.class0_hp[bit];
      n |= bit;
    } else {
      n |= 1;
      ++c.class0_hp[1];
    }
  }
  return sign ? -(n + 1) : n + 1;
}

void Decoder::read_mv(TileCtx& t, Mv& mv, const Mv& ref) {
  const int joint = t.b.tree(vp9_mv_joint_tree, p_.mv_joints);
  ++c_.mv_joints[joint];
  const bool hp = hp_ && std::abs(ref.row) < 64 && std::abs(ref.col) < 64;
  int dr = 0, dc = 0;
  if (joint == 2 || joint == 3) dr = read_mv_component(t, 0, hp);
  if (joint == 1 || joint == 3) dc = read_mv_component(t, 1, hp);
  mv.row = static_cast<int16_t>(ref.row + dr);
  mv.col = static_cast<int16_t>(ref.col + dc);
}

void Decoder::read_inter_block(TileCtx& t, MI& m, int row, int col) {
  read_ref_frames(t, m, row, col);
  const bool compound = has_second(m);
  const int ctx = mode_context(m, row, col, t);
  const bool seg_skip = seg_.enabled && seg_.feature[m.seg_id][SEG_SKIP];
  auto read_mode = [&]() {
    if (seg_skip) return int(ZEROMV);
    const int off = t.b.tree(vp9_inter_mode_tree, p_.inter_mode[ctx]);
    ++c_.inter_mode[ctx][off];
    return NEARESTMV + off;
  };
  if (m.sb_type >= BLOCK_8X8) m.mode = static_cast<uint8_t>(read_mode());
  if (filter_ == kSwitchable) {
    const MI* a = above(row, col);
    const MI* l = left(t, row, col);
    const int lt = l && is_inter(*l) ? l->filter : 3;
    const int at_ = a && is_inter(*a) ? a->filter : 3;
    const int fctx = lt == at_ ? lt : lt == 3 ? at_ : at_ == 3 ? lt : 3;
    m.filter = static_cast<uint8_t>(t.b.tree(vp9_switchable_interp_tree, p_.interp[fctx]));
    ++c_.interp[fctx][m.filter];
  } else {
    m.filter = static_cast<uint8_t>(filter_);
  }
  Mv best[2];
  if (m.sb_type < BLOCK_8X8) {
    const int w4 = m.sb_type == BLOCK_8X4 ? 2 : 1;
    const int h4 = m.sb_type == BLOCK_4X8 ? 2 : 1;
    bool have_best = false;
    int b_mode = ZEROMV;
    for (int y = 0; y < 2; y += h4)
      for (int x = 0; x < 2; x += w4) {
        const int j = y * 2 + x;
        b_mode = read_mode();
        Mv mv[2];
        if (b_mode == NEARESTMV || b_mode == NEARMV) {
          for (int r = 0; r < 1 + compound; ++r) {
            Mv list[2];
            find_mv_refs(t, m, row, col, m.ref[r], j, list);
            Mv nearest, near_mv;
            if (j == 0) {
              nearest = list[0];
              near_mv = list[1];
            } else if (j < 3) {
              nearest = m.bmv[0][r];
              for (const Mv& c : list)
                if (c != nearest) {
                  near_mv = c;
                  break;
                }
            } else {
              nearest = m.bmv[2][r];
              const Mv cands[4] = {m.bmv[1][r], m.bmv[0][r], list[0], list[1]};
              for (const Mv& c : cands)
                if (c != nearest) {
                  near_mv = c;
                  break;
                }
            }
            mv[r] = b_mode == NEARESTMV ? nearest : near_mv;
          }
        } else if (b_mode == NEWMV) {
          if (!have_best) {
            for (int r = 0; r < 1 + compound; ++r) {
              Mv list[2];
              find_mv_refs(t, m, row, col, m.ref[r], -1, list);
              best[r] = lower_precision(list[0], hp_);
            }
            have_best = true;
          }
          for (int r = 0; r < 1 + compound; ++r) read_mv(t, mv[r], best[r]);
        }
        m.bmode[j] = static_cast<uint8_t>(b_mode);
        m.bmv[j][0] = mv[0];
        m.bmv[j][1] = mv[1];
        if (h4 == 2) {
          m.bmode[j + 2] = m.bmode[j];
          m.bmv[j + 2][0] = mv[0];
          m.bmv[j + 2][1] = mv[1];
        }
        if (w4 == 2) {
          m.bmode[j + 1] = m.bmode[j];
          m.bmv[j + 1][0] = mv[0];
          m.bmv[j + 1][1] = mv[1];
        }
      }
    m.mode = static_cast<uint8_t>(b_mode);
    m.mv[0] = m.bmv[3][0];
    m.mv[1] = m.bmv[3][1];
    return;
  }
  if (m.mode != ZEROMV)
    for (int r = 0; r < 1 + compound; ++r) {
      Mv list[2];
      find_mv_refs(t, m, row, col, m.ref[r], -1, list);
      best[r] = lower_precision(list[m.mode == NEARMV ? 1 : 0], hp_);
    }
  for (int r = 0; r < 1 + compound; ++r) {
    if (m.mode == NEWMV)
      read_mv(t, m.mv[r], best[r]);
    else if (m.mode != ZEROMV)
      m.mv[r] = best[r];
  }
  for (int j = 0; j < 4; ++j) {
    m.bmv[j][0] = m.mv[0];
    m.bmv[j][1] = m.mv[1];
  }
}

}  // namespace

namespace {

// ------------------------------------------------------ residual tokens

const int16_t* scan_of(int tx, int tx_type, const int16_t** nb) {
  // tx_type 1 (ADST down the columns) reads rows first, 2 columns first
  switch (tx) {
    case TX_4X4:
      if (tx_type == 1) { *nb = row_scan_4x4_neighbors; return row_scan_4x4; }
      if (tx_type == 2) { *nb = col_scan_4x4_neighbors; return col_scan_4x4; }
      *nb = default_scan_4x4_neighbors;
      return default_scan_4x4;
    case TX_8X8:
      if (tx_type == 1) { *nb = row_scan_8x8_neighbors; return row_scan_8x8; }
      if (tx_type == 2) { *nb = col_scan_8x8_neighbors; return col_scan_8x8; }
      *nb = default_scan_8x8_neighbors;
      return default_scan_8x8;
    case TX_16X16:
      if (tx_type == 1) { *nb = row_scan_16x16_neighbors; return row_scan_16x16; }
      if (tx_type == 2) { *nb = col_scan_16x16_neighbors; return col_scan_16x16; }
      *nb = default_scan_16x16_neighbors;
      return default_scan_16x16;
    default:
      *nb = default_scan_32x32_neighbors;
      return default_scan_32x32;
  }
}

int Decoder::decode_coefs(TileCtx& t, int plane, int tx, int tx_type,
                          bool inter, int ctx, int seg, int16_t* out) {
  const int type = plane > 0;
  const uint8_t(*probs)[6][3] = p_.coef[tx][type][inter];
  unsigned(*counts)[6][4] = c_.coef[tx][type][inter];
  unsigned(*eobs)[6] = c_.eob[tx][type][inter];
  const int16_t* nb;
  const int16_t* scan = scan_of(tx, tx_type, &nb);
  const uint8_t* bands = tx == TX_4X4 ? vp9_coefband_trans_4x4 : vp9_coefband_trans_8x8plus;
  const int16_t* dq = dq_[seg][type];
  const int shift = tx == TX_32X32;
  const int max_eob = 16 << (tx << 1);
  uint8_t cache[32 * 32];
  int dqv = dq[0];
  int c = 0;
  Bool& b = t.b;
  while (c < max_eob) {
    int band = bands[c];
    const uint8_t* prob = probs[band][ctx];
    ++eobs[band][ctx];
    if (!b.get(prob[0])) {
      ++counts[band][ctx][3];
      break;
    }
    while (!b.get(prob[1])) {
      ++counts[band][ctx][0];
      dqv = dq[1];
      cache[scan[c]] = 0;
      if (++c >= max_eob) return c;
      ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1;
      band = bands[c];
      prob = probs[band][ctx];
    }
    int token, val;
    if (!b.get(prob[2])) {
      ++counts[band][ctx][1];
      token = 1;
      val = 1;
    } else {
      ++counts[band][ctx][2];
      token = b.tree(vp9_coef_con_tree, vp9_pareto8_full[prob[2] - 1]);
      auto extra = [&](const uint8_t* p, int n) {
        int v = 0;
        for (int i = 0; i < n; ++i) v = (v << 1) | b.get(p[i]);
        return v;
      };
      switch (token) {
        case 2: case 3: case 4: val = token; break;
        case 5: val = 5 + extra(vp9_cat1_prob, 1); break;
        case 6: val = 7 + extra(vp9_cat2_prob, 2); break;
        case 7: val = 11 + extra(vp9_cat3_prob, 3); break;
        case 8: val = 19 + extra(vp9_cat4_prob, 4); break;
        case 9: val = 35 + extra(vp9_cat5_prob, 5); break;
        default: val = 67 + extra(vp9_cat6_prob, 14); break;
      }
    }
    const int v = (val * dqv) >> shift;
    out[scan[c]] = static_cast<int16_t>(b.get(128) ? -v : v);
    cache[scan[c]] = vp9_pt_energy_class[token];
    ++c;
    ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1;
    dqv = dq[1];
  }
  return c;
}

// The tokens of the transform block at (x4, y4) (in 4x4 units of the
// plane, from the frame's corner) with the nonzero contexts above and to
// the left; entries past the frame's edge (max_w4, max_h4: the first
// column and row beyond it) are left 0.
int Decoder::tokens(TileCtx& t, const MI& m, int plane, int x4, int y4,
                    int tx, int tx_type, int max_w4, int max_h4,
                    int16_t* out) {
  const int n = 1 << tx;
  uint8_t* a = &above_nz_[plane][x4];
  uint8_t* l = &t.left_nz[plane][y4 & (plane ? 7 : 15)];
  int ca = 0, cl = 0;
  for (int i = 0; i < n; ++i) {
    ca |= a[i];
    cl |= l[i];
  }
  const int eob = decode_coefs(t, plane, tx, tx_type, is_inter(m), ca + cl,
                               m.seg_id, out);
  const uint8_t nz = eob > 0;
  for (int i = 0; i < n; ++i) {
    a[i] = x4 + i < max_w4 ? nz : 0;
    l[i] = y4 + i < max_h4 ? nz : 0;
  }
  return eob;
}

// ------------------------------------------------------------ reconstruction

void Decoder::predict_intra(int plane, int mode, int tx, int row, int col,
                            int x4, int y4, int bw4, bool have_left) {
  const int ss = plane ? 1 : 0;
  const int bs = 4 << tx;
  const int fw = (mi_cols_ * 8) >> ss, fh = (mi_rows_ * 8) >> ss;
  const int x0 = ((col * 8) >> ss) + x4 * 4, y0 = ((row * 8) >> ss) + y4 * 4;
  const int stride = cur_->pstride(plane);
  uint8_t* dst = cur_->plane(plane) + size_t(y0) * stride + x0;
  const bool have_top = y4 > 0 || row > 0;
  const bool have_right = x4 + (1 << tx) < bw4;
  uint8_t left_col[32], above_buf[64 + 1];
  uint8_t* above_row = above_buf + 1;
  if (have_left) {
    const int avail = std::min(bs, fh - y0);
    for (int i = 0; i < avail; ++i) left_col[i] = dst[i * stride - 1];
    for (int i = avail; i < bs; ++i) left_col[i] = left_col[avail - 1];
  } else {
    std::memset(left_col, 129, bs);
  }
  if (have_top) {
    const uint8_t* ref = dst - stride;
    const int want = bs == 4 && have_right ? 8 : bs;
    const int take = std::min(want, fw - x0);
    std::memcpy(above_row, ref, take);
    std::memset(above_row + take, above_row[take - 1], 2 * bs - take);
    above_row[-1] = have_left ? ref[-1] : 129;
  } else {
    std::memset(above_buf, 127, 2 * bs + 1);
  }
  vp9_dsp::intra_predict(mode, bs, above_row, left_col, have_top, have_left,
                         dst, stride);
}

void Decoder::reconstruct_intra(TileCtx& t, MI& m, int row, int col) {
  const int bsize = m.sb_type;
  const int bw8 = std::max(1, int(num_8x8_blocks_wide_lookup[bsize]));
  const int bh8 = std::max(1, int(num_8x8_blocks_high_lookup[bsize]));
  const bool have_left = col > t.col_start;
  for (int plane = 0; plane < 3; ++plane) {
    const int ss = plane ? 1 : 0;
    const int tx = plane ? uv_txsize_lookup[bsize][m.tx_size][1][1] : m.tx_size;
    const int n4w = (bw8 * 2) >> ss, n4h = (bh8 * 2) >> ss;
    const int max_w = n4w + std::min(0, ((mi_cols_ - bw8 - col) * 2) >> ss);
    const int max_h = n4h + std::min(0, ((mi_rows_ - bh8 - row) * 2) >> ss);
    const int step = 1 << tx;
    const int bx4 = (col * 2) >> ss, by4 = (row * 2) >> ss;
    const int stride = cur_->pstride(plane);
    for (int r = 0; r < max_h; r += step)
      for (int c = 0; c < max_w; c += step) {
        int mode = plane ? m.uv_mode : m.mode;
        if (!plane && bsize < BLOCK_8X8) mode = m.bmode[(r << 1) + c];
        predict_intra(plane, mode, tx, row, col, c, r, n4w, have_left || c > 0);
        if (m.skip) continue;
        const int tx_type = plane || lossless_ || tx == TX_32X32
                                ? 0 : intra_mode_to_tx_type_lookup[mode];
        const int eob = tokens(t, m, plane, bx4 + c, by4 + r, tx, tx_type,
                               bx4 + max_w, by4 + max_h, coef_);
        if (eob > 0) {
          uint8_t* dst = cur_->plane(plane) +
                         size_t(by4 + r) * 4 * stride + (bx4 + c) * 4;
          if (lossless_)
            vp9_dsp::iwht4_add(coef_, dst, stride);
          else
            vp9_dsp::inverse_add(coef_, 4 << tx, tx_type, dst, stride);
          std::memset(coef_, 0, sizeof(int16_t) << (4 + 2 * tx));
        }
      }
  }
}

bool Decoder::reconstruct_inter(TileCtx& t, MI& m, int row, int col) {
  const int bsize = m.sb_type;
  const int bw8 = std::max(1, int(num_8x8_blocks_wide_lookup[bsize]));
  const int bh8 = std::max(1, int(num_8x8_blocks_high_lookup[bsize]));
  int total = 0;
  for (int plane = 0; plane < 3; ++plane) {
    const int ss = plane ? 1 : 0;
    const int tx = plane ? uv_txsize_lookup[bsize][m.tx_size][1][1] : m.tx_size;
    const int n4w = (bw8 * 2) >> ss, n4h = (bh8 * 2) >> ss;
    const int max_w = n4w + std::min(0, ((mi_cols_ - bw8 - col) * 2) >> ss);
    const int max_h = n4h + std::min(0, ((mi_rows_ - bh8 - row) * 2) >> ss);
    const int step = 1 << tx;
    const int bx4 = (col * 2) >> ss, by4 = (row * 2) >> ss;
    const int stride = cur_->pstride(plane);
    for (int r = 0; r < max_h; r += step)
      for (int c = 0; c < max_w; c += step) {
        const int eob = tokens(t, m, plane, bx4 + c, by4 + r, tx, 0,
                               bx4 + max_w, by4 + max_h, coef_);
        if (eob > 0) {
          uint8_t* dst = cur_->plane(plane) +
                         size_t(by4 + r) * 4 * stride + (bx4 + c) * 4;
          if (lossless_)
            vp9_dsp::iwht4_add(coef_, dst, stride);
          else
            vp9_dsp::inverse_add(coef_, 4 << tx, 0, dst, stride);
          std::memset(coef_, 0, sizeof(int16_t) << (4 + 2 * tx));
        }
        total += eob;
      }
  }
  return total > 0;
}

// One plane's prediction of a w*h block at (x, y) from `ref` displaced by
// the vector `mv` (1/16 pel of the plane), clamped as libvpx clamps it,
// reading the reference replicated beyond its edge.
void Decoder::predict_plane(int plane, const Frame& ref, const Mv& mv, int x,
                            int y, int w, int h, int filter, bool avg,
                            int row, int col, int bw8, int bh8) {
  const int ss = plane ? 1 : 0;
  const int bw = (bw8 * 8) >> ss, bh = (bh8 * 8) >> ss;
  const int mul = 2 >> ss;  // 1/8 luma pel to 1/16 of the plane
  const int left = -(col * 64) * mul - ((4 + bw) << 4);
  const int right = (mi_cols_ - bw8 - col) * 64 * mul + ((4 + bw) << 4) - 16;
  const int top = -(row * 64) * mul - ((4 + bh) << 4);
  const int bottom = (mi_rows_ - bh8 - row) * 64 * mul + ((4 + bh) << 4) - 16;
  const int mc = std::clamp(mv.col * mul, left, right);
  const int mr = std::clamp(mv.row * mul, top, bottom);
  const int x16 = (x << 4) + mc, y16 = (y << 4) + mr;
  const int ix = x16 >> 4, iy = y16 >> 4, fx = x16 & 15, fy = y16 & 15;
  const int pw = plane ? (ref.w + 1) >> 1 : ref.w;
  const int ph = plane ? (ref.h + 1) >> 1 : ref.h;
  const int rs = ref.pstride(plane);
  const uint8_t* src = ref.plane_const(plane);
  uint8_t patch[(64 + 8) * (64 + 8)];
  const uint8_t* s;
  int ss_stride;
  if (ix - 3 >= 0 && iy - 3 >= 0 && ix + w + 4 <= pw && iy + h + 4 <= ph) {
    s = src + size_t(iy) * rs + ix;
    ss_stride = rs;
  } else {
    const int pw_ = w + 8;
    for (int r = 0; r < h + 8; ++r) {
      const int sy = std::clamp(iy - 3 + r, 0, ph - 1);
      for (int c = 0; c < w + 8; ++c)
        patch[r * pw_ + c] = src[size_t(sy) * rs + std::clamp(ix - 3 + c, 0, pw - 1)];
    }
    s = patch + 3 * pw_ + 3;
    ss_stride = pw_;
  }
  const int16_t(*k)[8] = filter == 0 ? sub_pel_filters_8
                         : filter == 1 ? sub_pel_filters_8lp
                         : filter == 2 ? sub_pel_filters_8s : bilinear_filters;
  const int ds = cur_->pstride(plane);
  vp9_dsp::convolve(s, ss_stride, cur_->plane(plane) + size_t(y) * ds + x, ds,
                    w, h, k, fx, fy, avg);
}

void Decoder::predict_inter(const MI& m, int row, int col) {
  const int bsize = m.sb_type;
  const int bw8 = std::max(1, int(num_8x8_blocks_wide_lookup[bsize]));
  const int bh8 = std::max(1, int(num_8x8_blocks_high_lookup[bsize]));
  for (int r = 0; r < 1 + has_second(m); ++r) {
    const Frame& ref = *refs_[ref_idx_[m.ref[r] - 1]];
    const bool avg = r == 1;
    if (bsize < BLOCK_8X8) {
      for (int j = 0; j < 4; ++j)
        predict_plane(0, ref, m.bmv[j][r], col * 8 + (j & 1) * 4,
                      row * 8 + (j >> 1) * 4, 4, 4, m.filter, avg, row, col,
                      1, 1);
      int sr = 0, sc = 0;
      for (int j = 0; j < 4; ++j) {
        sr += m.bmv[j][r].row;
        sc += m.bmv[j][r].col;
      }
      Mv uv;
      uv.row = static_cast<int16_t>((sr < 0 ? sr - 2 : sr + 2) / 4);
      uv.col = static_cast<int16_t>((sc < 0 ? sc - 2 : sc + 2) / 4);
      for (int p = 1; p < 3; ++p)
        predict_plane(p, ref, uv, col * 4, row * 4, 4, 4, m.filter, avg, row,
                      col, 1, 1);
    } else {
      predict_plane(0, ref, m.mv[r], col * 8, row * 8, bw8 * 8, bh8 * 8,
                    m.filter, avg, row, col, bw8, bh8);
      for (int p = 1; p < 3; ++p)
        predict_plane(p, ref, m.mv[r], col * 4, row * 4, bw8 * 4, bh8 * 4,
                      m.filter, avg, row, col, bw8, bh8);
    }
  }
}

}  // namespace

namespace {

// ------------------------------------------------------------ loop filter

void Decoder::loop_filter() {
  if (!lf_level_) return;
  // per-level thresholds from the sharpness
  for (int lvl = 0; lvl < 64; ++lvl) {
    int lim = lvl >> ((sharpness_ > 0) + (sharpness_ > 4));
    if (sharpness_ > 0) lim = std::min(lim, 9 - sharpness_);
    lim = std::max(lim, 1);
    lf_thresh_[lvl] = {2 * (lvl + 2) + lim, lim, lvl >> 4};
  }
  for (int row = 0; row < mi_rows_; row += 8)
    for (int col = 0; col < mi_cols_; col += 8)
      for (int plane = 0; plane < 3; ++plane) filter_superblock(plane, row, col);
}

// One plane of the superblock at (row, col) in 8x8 cells, as libvpx's
// vp9_filter_block_plane_non420 does it: the masks of 16-, 8- and 4-wide
// filters on transform and block edges (none inside a block that is inter
// and has no coefficient, none on the frame's left and top edges, at most
// 8 wide on the last chroma row and column of an odd-sized frame, 8 wide
// where a 4x4 transform meets a 32-pixel boundary), then every vertical
// edge left to right, then every horizontal edge top to bottom.
void Decoder::filter_superblock(int plane, int row, int col) {
  const int ss = plane ? 1 : 0, step = 1 << ss;
  const int stride = cur_->pstride(plane);
  uint8_t* base = cur_->plane(plane) + size_t((row * 8) >> ss) * stride +
                  ((col * 8) >> ss);
  const vp9_dsp::Thresh* th = lf_thresh_;
  unsigned m16[8] = {}, m8[8] = {}, m4[8] = {}, m4i[8] = {};
  unsigned c16[8] = {}, c8[8] = {}, c4[8] = {};
  uint8_t lfl[8][8] = {};
  for (int r = 0; r < 8 && row + r < mi_rows_; r += step) {
    for (int c = 0; c < 8 && col + c < mi_cols_; c += step) {
      const MI& m = at(row + r, col + c);
      const int bs = m.sb_type;
      const bool skip = m.skip && is_inter(m);
      const int n8w = num_8x8_blocks_wide_lookup[bs];
      const int n8h = num_8x8_blocks_high_lookup[bs];
      const bool edge_left = kBw4[bs] > 1 ? !(c & (n8w - 1)) : true;
      const bool edge_above = kBh4[bs] > 1 ? !(r & (n8h - 1)) : true;
      const bool skip_c = skip && !edge_left, skip_r = skip && !edge_above;
      const int tx = plane ? uv_txsize_lookup[bs][m.tx_size][1][1] : m.tx_size;
      const bool border_c = ss && col + c == mi_cols_ - 1;
      const bool border_r = ss && row + r == mi_rows_ - 1;
      const int cc = c >> ss, rr = r >> ss;
      const int lvl = lf_lvl_[m.seg_id][m.ref[0]][mode_lf_lut[m.mode]];
      lfl[r][cc] = static_cast<uint8_t>(lvl);
      if (!lvl) continue;
      const unsigned bit = 1u << cc;
      if (tx == TX_32X32 || tx == TX_16X16) {
        const int align = tx == TX_32X32 ? 3 : 1;
        if (!skip_c && (cc & align) == 0) (border_c ? c8[r] : c16[r]) |= bit;
        if (!skip_r && (rr & align) == 0) (border_r ? m8[r] : m16[r]) |= bit;
      } else {
        if (!skip_c) ((tx == TX_8X8 || (cc & 3) == 0) ? c8[r] : c4[r]) |= bit;
        if (!skip_r) ((tx == TX_8X8 || (rr & 3) == 0) ? m8[r] : m4[r]) |= bit;
        if (!skip && tx < TX_8X8 && !border_c) m4i[r] |= bit;
      }
    }
  }
  const unsigned border = col == 0 ? ~1u : ~0u;
  for (int r = 0; r < 8 && row + r < mi_rows_; r += step) {
    uint8_t* s = base + size_t((r >> ss) * 8) * stride;
    const unsigned v16 = c16[r] & border, v8 = c8[r] & border,
                   v4 = c4[r] & border, vi = m4i[r];
    for (int k = 0; k < 8; ++k, s += 8) {
      const unsigned bit = 1u << k;
      const vp9_dsp::Thresh& t = th[lfl[r][k]];
      const int wd = (v16 & bit) ? 16 : (v8 & bit) ? 8 : (v4 & bit) ? 4 : 0;
      if (wd)
        for (int y = 0; y < 8; ++y) vp9_dsp::filter_line(s + y * stride, 1, wd, t);
      if (vi & bit)
        for (int y = 0; y < 8; ++y)
          vp9_dsp::filter_line(s + 4 + y * stride, 1, 4, t);
    }
  }
  for (int r = 0; r < 8 && row + r < mi_rows_; r += step) {
    uint8_t* s = base + size_t((r >> ss) * 8) * stride;
    const bool border_r = ss && row + r == mi_rows_ - 1;
    const unsigned vi = border_r ? 0 : m4i[r];
    const bool top = row + r == 0;
    const unsigned h16 = top ? 0 : m16[r], h8 = top ? 0 : m8[r],
                   h4 = top ? 0 : m4[r];
    for (int k = 0; k < 8; ++k, s += 8) {
      const unsigned bit = 1u << k;
      const vp9_dsp::Thresh& t = th[lfl[r][k]];
      const int wd = (h16 & bit) ? 16 : (h8 & bit) ? 8 : (h4 & bit) ? 4 : 0;
      if (wd)
        for (int x = 0; x < 8; ++x) vp9_dsp::filter_line(s + x, stride, wd, t);
      if (vi & bit)
        for (int x = 0; x < 8; ++x)
          vp9_dsp::filter_line(s + 4 * stride + x, stride, 4, t);
    }
  }
}

// ------------------------------------------------------------- adaptation

void Decoder::adapt() {
  const Probs& pre = ctx_[ctx_idx_];
  const unsigned uf = key_ ? 112 : last_key_ ? 128 : 112;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < (k ? 6 : 3); ++l) {
            const unsigned* n = c_.coef[t][i][j][k][l];
            const unsigned e = c_.eob[t][i][j][k][l];
            const uint8_t* pp = pre.coef[t][i][j][k][l];
            uint8_t* q = p_.coef[t][i][j][k][l];
            q[0] = merge(pp[0], n[3], e - n[3], 24, uf);
            q[1] = merge(pp[1], n[0], n[1] + n[2], 24, uf);
            q[2] = merge(pp[2], n[1], n[2], 24, uf);
          }
  if (key_) return;
  for (int i = 0; i < 4; ++i)
    p_.intra_inter[i] = merge_mode(pre.intra_inter[i], c_.intra_inter[i][0], c_.intra_inter[i][1]);
  for (int i = 0; i < 5; ++i) {
    p_.comp_inter[i] = merge_mode(pre.comp_inter[i], c_.comp_inter[i][0], c_.comp_inter[i][1]);
    p_.comp_ref[i] = merge_mode(pre.comp_ref[i], c_.comp_ref[i][0], c_.comp_ref[i][1]);
    for (int j = 0; j < 2; ++j)
      p_.single_ref[i][j] = merge_mode(pre.single_ref[i][j], c_.single_ref[i][j][0],
                                       c_.single_ref[i][j][1]);
  }
  for (int i = 0; i < 7; ++i)
    tree_merge(vp9_inter_mode_tree, 0, pre.inter_mode[i], c_.inter_mode[i], p_.inter_mode[i]);
  for (int i = 0; i < 4; ++i)
    tree_merge(vp9_intra_mode_tree, 0, pre.y_mode[i], c_.y_mode[i], p_.y_mode[i]);
  for (int i = 0; i < 10; ++i)
    tree_merge(vp9_intra_mode_tree, 0, pre.uv_mode[i], c_.uv_mode[i], p_.uv_mode[i]);
  for (int i = 0; i < 16; ++i)
    tree_merge(vp9_partition_tree, 0, pre.partition[i], c_.partition[i], p_.partition[i]);
  if (filter_ == kSwitchable)
    for (int i = 0; i < 4; ++i)
      tree_merge(vp9_switchable_interp_tree, 0, pre.interp[i], c_.interp[i], p_.interp[i]);
  if (tx_mode_ == TX_MODE_SELECT)
    for (int i = 0; i < 2; ++i) {
      const unsigned* a = c_.tx8[i];
      p_.tx8[i][0] = merge_mode(pre.tx8[i][0], a[0], a[1]);
      const unsigned* b = c_.tx16[i];
      p_.tx16[i][0] = merge_mode(pre.tx16[i][0], b[0], b[1] + b[2]);
      p_.tx16[i][1] = merge_mode(pre.tx16[i][1], b[1], b[2]);
      const unsigned* c = c_.tx32[i];
      p_.tx32[i][0] = merge_mode(pre.tx32[i][0], c[0], c[1] + c[2] + c[3]);
      p_.tx32[i][1] = merge_mode(pre.tx32[i][1], c[1], c[2] + c[3]);
      p_.tx32[i][2] = merge_mode(pre.tx32[i][2], c[2], c[3]);
    }
  for (int i = 0; i < 3; ++i)
    p_.skip[i] = merge_mode(pre.skip[i], c_.skip[i][0], c_.skip[i][1]);
  tree_merge(vp9_mv_joint_tree, 0, pre.mv_joints, c_.mv_joints, p_.mv_joints);
  for (int i = 0; i < 2; ++i) {
    const MvComp& a = pre.mv[i];
    MvComp& q = p_.mv[i];
    const MvCompCounts& c = c_.mv[i];
    q.sign = merge_mode(a.sign, c.sign[0], c.sign[1]);
    tree_merge(vp9_mv_class_tree, 0, a.classes, c.classes, q.classes);
    tree_merge(vp9_mv_class0_tree, 0, a.class0, c.class0, q.class0);
    for (int j = 0; j < 10; ++j) q.bits[j] = merge_mode(a.bits[j], c.bits[j][0], c.bits[j][1]);
    for (int j = 0; j < 2; ++j)
      tree_merge(vp9_mv_fp_tree, 0, a.class0_fp[j], c.class0_fp[j], q.class0_fp[j]);
    tree_merge(vp9_mv_fp_tree, 0, a.fp, c.fp, q.fp);
    if (hp_) {
      q.class0_hp = merge_mode(a.class0_hp, c.class0_hp[0], c.class0_hp[1]);
      q.hp = merge_mode(a.hp, c.hp[0], c.hp[1]);
    }
  }
}

// ------------------------------------------------------------ frames

Status Decoder::decode_one(const uint8_t* data, size_t n, const uint8_t* end) {
  Bits r(data, n);
  const int hsize = uncompressed_header(r);
  if (hsize < 0) {  // show_existing_frame
    ++stats[kStatShowExisting];
    return kFrame;
  }
  const size_t off = r.bytes();
  if (off + size_t(hsize) > n) corrupt("compressed header size");
  p_ = ctx_[ctx_idx_];
  std::memset(&c_, 0, sizeof(c_));
  Bool b;
  b.init(data + off, hsize, end);
  if (b.get(128)) corrupt("compressed header marker bit");
  compressed_header(b);
  cur_ = std::make_shared<Frame>();
  cur_->alloc(width, height);
  cur_->bt709 = bt709_;
  const size_t cells = size_t(mi_cols_) * mi_rows_;
  mi_.assign(cells, MI{});
  cur_mvs_.assign(cells, MvRef{});
  for (int s = 0; s < 8; ++s) {
    const int q = qindex(s);
    dq_[s][0][0] = dc_qlookup[std::clamp(q + ydc_dq_, 0, 255)];
    dq_[s][0][1] = ac_qlookup[q];
    dq_[s][1][0] = dc_qlookup[std::clamp(q + uvdc_dq_, 0, 255)];
    dq_[s][1][1] = ac_qlookup[std::clamp(q + uvac_dq_, 0, 255)];
  }
  // filter levels per segment, reference and mode
  const int scale = 1 << (lf_level_ >> 5);
  for (int s = 0; s < 8; ++s) {
    int lvl = lf_level_;
    if (seg_.enabled && seg_.feature[s][SEG_ALT_LF]) {
      const int d = seg_.data[s][SEG_ALT_LF];
      lvl = std::clamp(seg_.abs_delta ? d : lvl + d, 0, 63);
    }
    for (int ref = 0; ref < 4; ++ref)
      for (int mode = 0; mode < 2; ++mode) {
        int v = lvl;
        if (lf_deltas_) {
          v += lf_ref_deltas_[ref] * scale;
          if (ref) v += lf_mode_deltas_[mode] * scale;
        }
        lf_lvl_[s][ref][mode] = static_cast<uint8_t>(std::clamp(v, 0, 63));
      }
  }
  decode_tiles(data + off + hsize, n - off - hsize, end);
  loop_filter();
  if (!error_res_ && !parallel_) {
    adapt();
    ++stats[kStatAdapted];
  }
  ++stats[kStatFrames];
  stats[kStatHidden] += !show_;
  stats[kStatTileCols] = std::max<int64_t>(stats[kStatTileCols], 1 << log2_tile_cols_);
  stats[kStatTileRows] = std::max<int64_t>(stats[kStatTileRows], 1 << log2_tile_rows_);
  stats[kStatSwitchable] += filter_ == kSwitchable && !key_;
  stats[kStatSegmented] += seg_.enabled;
  stats[kStatLossless] += lossless_;
  stats[kStatErrorResilient] += error_res_;
  if (refresh_ctx_) ctx_[ctx_idx_] = p_;
  for (int i = 0; i < 8; ++i)
    if (refresh_ & (1 << i)) refs_[i] = cur_;
  if (seg_.enabled) std::swap(seg_prev_, seg_cur_);
  std::swap(prev_mvs_, cur_mvs_);
  last_w_ = width;
  last_h_ = height;
  if (!show_) return kNoFrame;
  shown = cur_;
  return kFrame;
}

// FFmpeg parses each frame it is given with its coded-bitstream reader
// before decoding it, which takes a last byte of the form 110xxxxx for a
// superframe index: one whose sizes do not fit the frame fails it.
void check_index(const uint8_t* d, size_t n) {
  const uint8_t c = d[n - 1];
  if ((c & 0xE0) != 0xC0) return;
  const size_t index = 2 + size_t(((c >> 3) & 3) + 1) * ((c & 7) + 1);
  if (index > n) corrupt("superframe index");
  const uint8_t* p = d + n - index;
  const int mag = ((p[0] >> 3) & 3) + 1, count = (p[0] & 7) + 1;
  if (2 + size_t(mag) * count > index) corrupt("superframe index");
  size_t pos = 0;
  for (int i = 0; i < count; ++i) {
    size_t size = 0;
    for (int j = 0; j < mag; ++j) size |= size_t(p[1 + i * mag + j]) << (8 * j);
    if (!size || pos + size > n || (d[pos] >> 6) != 2)
      corrupt("superframe index");
    pos += size;
  }
}

// A packet: one frame, or a superframe (frames and an index of their sizes
// at its end, split as FFmpeg's vp9_superframe_split filter splits it);
// the last shown frame is given.
Status Decoder::decode(const uint8_t* data, int64_t n) {
  std::vector<std::pair<const uint8_t*, size_t>> frames;
  if (n > 0) {
    const uint8_t c = data[n - 1];
    if ((c & 0xE0) == 0xC0) {
      const int count = (c & 7) + 1, mag = ((c >> 3) & 3) + 1;
      const int64_t index = 2 + int64_t(mag) * count;
      if (n >= index && data[n - index] == c) {
        const uint8_t* p = data + n - index + 1;
        int64_t total = 0;
        for (int i = 0; i < count; ++i) {
          int64_t size = 0;
          for (int j = 0; j < mag; ++j) size |= int64_t(*p++) << (8 * j);
          if (size <= 0 || total + size > n - index)
            corrupt("superframe index");
          frames.emplace_back(data + total, size_t(size));
          total += size;
        }
      }
    }
  }
  if (frames.empty()) frames.emplace_back(data, size_t(std::max<int64_t>(n, 0)));
  Status out = kNoFrame;
  for (const auto& f : frames) {
    if (!f.second) corrupt("empty frame");
    check_index(f.first, f.second);
    if (decode_one(f.first, f.second, data + n) == kFrame) out = kFrame;
  }
  return out;
}

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0)
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", s.c_str());
}

template <typename A>
int copy_table(const A& t, int32_t* out, int cap) {
  using E = std::remove_all_extents_t<A>;
  const E* p = reinterpret_cast<const E*>(&t);
  const int n = static_cast<int>(sizeof(A) / sizeof(E));
  if (out)
    for (int i = 0; i < std::min(n, cap); ++i) out[i] = p[i];
  return n;
}

}  // namespace

extern "C" {

// A decoder (no headers: a VP9 stream carries them in its frames).
void* vp9dec_open() { return new Decoder(); }

// Decode one packet (a frame or a superframe).  0: a frame, *w and *h set;
// 1: no frame (hidden frames only); 2: a feature it does not decode (msg
// names it); 3: a corrupt frame (no frame; the references stay).
int vp9dec_decode(void* handle, const uint8_t* data, int64_t n, int* w,
                  int* h, char* msg, int msg_len) {
  Decoder* d = static_cast<Decoder*>(handle);
  try {
    const Status st = d->decode(data, n);
    if (st == kFrame) {
      *w = d->shown->w;
      *h = d->shown->h;
    }
    return st;
  } catch (const Error& e) {
    put_msg(e.msg, msg, msg_len);
    return e.status;
  } catch (const std::bad_alloc&) {
    put_msg("out of memory", msg, msg_len);
    return kCorrupt;
  }
}

// The last frame given as h*w*3 RGB bytes.  0: done; 4: cap too small.
int vp9dec_rgb(void* handle, uint8_t* rgb, int64_t cap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->shown || int64_t(d->shown->w) * d->shown->h * 3 > cap) return kSmall;
  const Frame& f = *d->shown;
  swscale_rgb::to_rgb(f.y.data(), f.stride, f.u.data(), f.v.data(),
                      f.stride / 2, f.w, f.h, rgb, false,
                      f.bt709 ? swscale_rgb::kBt709 : swscale_rgb::kBt601);
  return kFrame;
}

// The last frame's I420 planes, cropped: y (h*w), u and v
// (ceil(h/2)*ceil(w/2) each).  0: done; 4: a cap too small.
int vp9dec_planes(void* handle, uint8_t* y, uint8_t* u, uint8_t* v,
                  int64_t ycap, int64_t ccap) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d->shown) return kSmall;
  const Frame& f = *d->shown;
  const int w = f.w, h = f.h, cw = (w + 1) / 2, ch = (h + 1) / 2;
  if (int64_t(w) * h > ycap || int64_t(cw) * ch > ccap) return kSmall;
  for (int j = 0; j < h; ++j)
    std::memcpy(y + int64_t(j) * w, &f.y[size_t(j) * f.stride], w);
  for (int j = 0; j < ch; ++j) {
    std::memcpy(u + int64_t(j) * cw, &f.u[size_t(j) * (f.stride / 2)], cw);
    std::memcpy(v + int64_t(j) * cw, &f.v[size_t(j) * (f.stride / 2)], cw);
  }
  return kFrame;
}

void vp9dec_close(void* handle) { delete static_cast<Decoder*>(handle); }

// The decoder's counters (Decoder::stats) into out[0..cap); their number.
int vp9dec_stats(void* handle, int64_t* out, int cap) {
  const Decoder* d = static_cast<const Decoder*>(handle);
  for (int i = 0; i < std::min<int>(cap, Decoder::kStats); ++i) out[i] = d->stats[i];
  return Decoder::kStats;
}

// The entries of one of the decoder's constant tables (libvpx's symbol
// names, and the defaults kept in code), flattened in C order, into
// out[0..cap); the number of entries, or -1 for another name.
int vp9dec_table(const char* name, int32_t* out, int cap) {
  const std::string n(name);
#define VP9_TABLE_CASE(t) \
  if (n == #t) return copy_table(t, out, cap);
  VP9_TABLES(VP9_TABLE_CASE)
#undef VP9_TABLE_CASE
  if (n == "default_skip_probs") return copy_table(kDefaultSkip, out, cap);
  if (n == "default_tx_probs_8x8") return copy_table(kDefaultTx8, out, cap);
  if (n == "default_tx_probs_16x16") return copy_table(kDefaultTx16, out, cap);
  if (n == "default_tx_probs_32x32") return copy_table(kDefaultTx32, out, cap);
  if (n == "default_intra_inter_p") return copy_table(kDefaultIntraInter, out, cap);
  if (n == "default_comp_inter_p") return copy_table(kDefaultCompInter, out, cap);
  if (n == "default_comp_ref_p") return copy_table(kDefaultCompRef, out, cap);
  if (n == "default_mv_joints") return copy_table(kDefaultMvJoints, out, cap);
  if (n == "default_mv_classes") return copy_table(kDefaultMvClasses, out, cap);
  if (n == "default_mv_bits") return copy_table(kDefaultMvBits, out, cap);
  return -1;
}

}  // extern "C"
