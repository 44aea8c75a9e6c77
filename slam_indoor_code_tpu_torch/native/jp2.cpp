// jp2 — JPEG 2000 decoding with no library but the C++ standard library,
// as OpenJPEG 2.5 decodes a JP2 file or a raw J2K codestream for OpenCV's
// imread (its default, whole-image decode):
//
// - the JP2 boxes (signature, ftyp, jp2h with ihdr, colr, pclr, cmap,
//   cdef; jp2c), the palette and channel definitions applied as
//   opj_jp2_apply_pclr / opj_jp2_apply_cdef apply them;
// - the codestream's main and tile-part headers (SIZ, COD, COC, QCD, QCC,
//   RGN, POC, PPM, PPT; TLM, PLM, PLT, CRG, COM skipped), several tiles and
//   tile-parts, each tile's tile-parts joined in the order they come;
// - tier 2: the five progression orders and POC as opj_pi iterates them,
//   precincts, layers, SOP/EPH, packet headers with their tag trees;
// - tier 1: the MQ decoder and the three coding passes with the midpoint
//   reconstruction (values kept at twice their scale, as opj_t1 keeps
//   them), the max-shift ROI;
// - dequantisation, the inverse 5/3 (integer) and 9/7 (float32, OpenJPEG's
//   constants, K and 2/K scaling before the four lifting steps) wavelet,
//   horizontal before vertical at each level, RCT/ICT, and the DC level
//   shift with lrintf and clamping.
//
// Code-block styles other than 0 (bypass, reset, termall, vertical causal,
// predictable termination, segmentation symbols), HTJ2K and Part 2
// extensions are refused by name.  One thread; no state outside a decode.
//
// C ABI; Python binds it through ctypes (io/jp2.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libjp2dec.so jp2.cpp

// vectorised loops (element by element, so the float results are the
// same); contraction to fused multiply-adds stays off, as OpenJPEG's
// SSE build has none
#pragma GCC optimize("O3", "fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Failure {
  int code;  // 1: corrupt (OpenJPEG fails), 2: refused by name
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{1, m}; }
[[noreturn]] void refuse(const std::string& m) { throw Failure{2, m}; }

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) {
  return (a + (int64_t(1) << b) - 1) >> b;
}
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------- MQ coder

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18
// uniform
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18;

struct Mqc {
  const uint8_t* bp;
  uint32_t a, c, ct;
  uint8_t st[19], mps[19];

  // `data` holds `len` bytes followed by two of 0xFF (opj_mqc_init_dec's
  // synthetic marker, which stops byte input at the end)
  void init(const uint8_t* data, size_t len) {
    for (int i = 0; i < 19; ++i) st[i] = mps[i] = 0;
    st[kCtxUni] = 46;
    st[kCtxAgg] = 3;
    st[0] = 4;
    bp = data;
    c = len == 0 ? 0xffu << 16 : uint32_t(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(*bp) << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[st[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        st[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// ---------------------------------------------------------------- tier 1

// flag bits of a coefficient: which of its 8 neighbours are significant
// (NW N NE W E SW S SE), the signs of its 4 direct neighbours, its own
// state
enum : uint16_t {
  kNW = 1, kN = 2, kNE = 4, kW = 8, kE = 16, kSW = 32, kS = 64, kSE = 128,
  kNbr = 255,
  kSgnN = 256, kSgnS = 512, kSgnW = 1024, kSgnE = 2048,
  kSig = 4096, kVisit = 8192, kRefined = 16384
};

struct Luts {
  uint8_t zc[4][256];  // by band number (0 LL, 1 HL, 2 LH, 3 HH)
  uint8_t sc[4096];    // by the 12 neighbour bits: context | xor << 7
  Luts() {
    for (int orient = 0; orient < 4; ++orient) {
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & kW) + !!(f & kE);
        int v = !!(f & kN) + !!(f & kS);
        const int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
        int n = 0;
        if (orient == 1) std::swap(h, v);
        if (orient != 3) {
          if (h == 0) {
            n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        } else {
          const int hv = h + v;
          if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        }
        zc[orient][f] = static_cast<uint8_t>(n);
      }
    }
    for (int f = 0; f < 4096; ++f) {
      auto contrib = [&](int sig, int neg) { return sig ? (neg ? -1 : 1) : 0; };
      int h = contrib(f & kW, f & kSgnW) + contrib(f & kE, f & kSgnE);
      int v = contrib(f & kN, f & kSgnN) + contrib(f & kS, f & kSgnS);
      h = std::clamp(h, -1, 1);
      v = std::clamp(v, -1, 1);
      int ctx, x = 0;
      if (h == 0 && v == 0) ctx = 0;
      else if (h == 0) { ctx = 1; x = v < 0; }
      else if (h > 0) ctx = v > 0 ? 4 : v == 0 ? 3 : 2;
      else { ctx = v < 0 ? 4 : v == 0 ? 3 : 2; x = 1; }
      sc[f] = static_cast<uint8_t>((kCtxSc + ctx) | (x << 7));
    }
  }
};

const Luts& luts() {
  static const Luts l;
  return l;
}

// Decodes one code-block's passes into `out` (w*h values at twice their
// scale, opj_t1_decode_cblk's convention).
void t1_decode(const uint8_t* data, size_t len, int passes, int bpno_plus_one,
               int orient, int w, int h, int32_t* out) {
  std::fill(out, out + size_t(w) * h, 0);
  if (passes <= 0 || bpno_plus_one < 1) return;
  const Luts& L = luts();
  const int fw = w + 2;
  // scratch kept per thread (the photo workers decode in parallel)
  thread_local std::vector<uint16_t> flags;
  thread_local std::vector<uint8_t> buf;
  flags.assign(size_t(fw) * (h + 2), 0);
  buf.assign(data, data + len);
  buf.push_back(0xff);
  buf.push_back(0xff);
  Mqc mq;
  mq.init(buf.data(), len);
  const uint8_t* zc = L.zc[orient];

  auto flag = [&](int x, int y) -> uint16_t& {
    return flags[size_t(y + 1) * fw + (x + 1)];
  };
  auto make_sig = [&](int x, int y, int neg) {
    uint16_t* f = &flag(x, y);
    *f |= kSig;
    f[-fw - 1] |= kSE;
    f[-fw] |= kS | (neg ? kSgnS : 0);
    f[-fw + 1] |= kSW;
    f[-1] |= kE | (neg ? kSgnE : 0);
    f[1] |= kW | (neg ? kSgnW : 0);
    f[fw - 1] |= kNE;
    f[fw] |= kN | (neg ? kSgnN : 0);
    f[fw + 1] |= kNW;
  };
  auto decode_sign = [&](int x, int y) {
    const uint8_t s = L.sc[flag(x, y) & 4095];
    return mq.decode(s & 127) ^ (s >> 7);
  };

  int passtype = 2;
  for (int pass = 0; pass < passes && bpno_plus_one >= 1; ++pass) {
    const int32_t one = int32_t(1) << bpno_plus_one;
    const int32_t half = one >> 1, oneplushalf = one | half;
    if (passtype == 0) {  // significance propagation
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x)
          for (int y = y0; y < std::min(y0 + 4, h); ++y) {
            uint16_t& f = flag(x, y);
            if ((f & kSig) || !(f & kNbr)) continue;
            if (mq.decode(zc[f & kNbr])) {
              const int neg = decode_sign(x, y);
              out[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
              make_sig(x, y, neg);
            }
            f |= kVisit;
          }
    } else if (passtype == 1) {  // magnitude refinement
      const int32_t poshalf = one >> 1;
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x)
          for (int y = y0; y < std::min(y0 + 4, h); ++y) {
            uint16_t& f = flag(x, y);
            if ((f & (kSig | kVisit)) != kSig) continue;
            const int cx = (f & kRefined) ? kCtxMag + 2
                           : (f & kNbr)   ? kCtxMag + 1
                                          : kCtxMag;
            const int v = mq.decode(cx);
            int32_t& d = out[size_t(y) * w + x];
            d += (v ^ (d < 0)) ? poshalf : -poshalf;
            f |= kRefined;
          }
    } else {  // cleanup
      for (int y0 = 0; y0 < h; y0 += 4)
        for (int x = 0; x < w; ++x) {
          int y = y0;
          const int y1 = std::min(y0 + 4, h);
          if (y1 - y0 == 4 && !(flag(x, y0) | flag(x, y0 + 1) |
                                flag(x, y0 + 2) | flag(x, y0 + 3))) {
            if (!mq.decode(kCtxAgg)) continue;
            int r = mq.decode(kCtxUni) << 1;
            r |= mq.decode(kCtxUni);
            y = y0 + r;
            const int neg = decode_sign(x, y);
            out[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
            make_sig(x, y, neg);
            ++y;
          }
          for (; y < y1; ++y) {
            const uint16_t f = flag(x, y);
            if (f & (kSig | kVisit)) continue;
            if (mq.decode(zc[f & kNbr])) {
              const int neg = decode_sign(x, y);
              out[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
              make_sig(x, y, neg);
            }
          }
          for (int yy = y0; yy < y1; ++yy) flag(x, yy) &= ~kVisit;
        }
    }
    if (++passtype == 3) {
      passtype = 0;
      --bpno_plus_one;
    }
  }
}

// ---------------------------------------------------------------- tier 2

// the packet-header bit reader (opj_bio): a byte after 0xFF gives 7 bits;
// past the end it reads zeros
struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return size_t(bp - start); }
};

struct TagTree {
  struct Node {
    int parent;
    int value, low;
  };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw{w}, lh{h};
    while (lw.back() > 1 || lh.back() > 1) {
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    std::vector<int> base;
    int total = 0;
    for (size_t k = 0; k < lw.size(); ++k) {
      base.push_back(total);
      total += lw[k] * lh[k];
    }
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t k = 0; k + 1 < lw.size(); ++k)
      for (int j = 0; j < lh[k]; ++j)
        for (int i = 0; i < lw[k]; ++i)
          nodes[base[k] + j * lw[k] + i].parent =
              base[k + 1] + (j / 2) * lw[k + 1] + i / 2;
  }
  void reset() {
    for (Node& n : nodes) {
      n.value = 999;
      n.low = 0;
    }
  }
  // opj_tgt_decode
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[32], sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& n = nodes[node];
      if (low > n.low) n.low = low;
      else low = n.low;
      while (low < threshold && low < n.value) {
        if (bio.bit()) n.value = low;
        else ++low;
      }
      n.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold;
  }
};

// a code-block: its bytes (t1 reads those of the first segment, which
// holds up to 109 passes without a code-block style) and passes so far
struct Cblk {
  int x0, y0, x1, y1;
  std::vector<uint8_t> data;
  int numpasses = 0, numbps = 0, numlenbits = 0;
  int numsegs = 0, seg_passes = 0;  // segments, passes in the last one
  size_t seg0_len = 0;
  bool included = false;
  int newpasses = 0;
  std::vector<std::pair<int, uint32_t>> newsegs;  // (passes, bytes)
};

struct Precinct {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<Cblk> cblks;
};

struct Band {
  int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
  int x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> precs;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
  int x0, y0, x1, y1, pw = 0, ph = 0, pdx, pdy, numbands;
  Band bands[3];
};

struct Stepsize {
  int expn, mant;
};

// per component coding and quantisation parameters
struct Tccp {
  int csty = 0, numresolutions = 6, cblkw = 6, cblkh = 6, cblksty = 0;
  int qmfbid = 0, qntsty = 0, numgbits = 2, roishift = 0;
  int prcw[33], prch[33];
  Stepsize steps[97];
  Tccp() {
    for (int i = 0; i < 33; ++i) prcw[i] = prch[i] = 15;
    for (auto& s : steps) s = {0, 0};
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;  // COD sets them
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<uint8_t> ppt, data;
  bool has_ppt = false, seen = false;
  int parts_seen = 0;
};

struct Comp {
  int dx, dy, prec, sgnd;
};

struct Image {
  int x0, y0, x1, y1;
  std::vector<Comp> comps;
};

struct Codestream {
  uint32_t ihdr_w = 0, ihdr_h = 0;  // a JP2's ihdr size, which SIZ must equal
  Image img;
  int64_t tdx, tdy;  // a tile may be larger than the image
  int tx0, ty0, tw, th;
  Tcp def;
  std::vector<Tcp> tiles;
  bool ppm = false;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;
  std::vector<std::vector<int32_t>> out;  // each component's samples
  std::vector<int> out_w, out_h, out_x0, out_y0;
};

// --------------------------------------------------------------- parsing

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* d, size_t len) : p(d), n(len) {}
  bool has(size_t k) const { return pos + k <= n; }
  uint32_t u8() {
    if (!has(1)) corrupt("marker segment cut short");
    return p[pos++];
  }
  uint32_t u16() { uint32_t v = u8() << 8; return v | u8(); }
  uint32_t u32() { uint32_t v = u16() << 16; return v | u16(); }
};

void read_spco(Reader& r, Tccp& t, bool precincts) {
  t.numresolutions = int(r.u8()) + 1;
  if (t.numresolutions > 33) corrupt("too many decomposition levels");
  t.cblkw = int(r.u8()) + 2;
  t.cblkh = int(r.u8()) + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    corrupt("code-block size");
  t.cblksty = int(r.u8());
  t.qmfbid = int(r.u8());
  if (t.qmfbid > 1) corrupt("wavelet transform");
  for (int i = 0; i < t.numresolutions; ++i) {
    if (precincts) {
      const int v = int(r.u8());
      t.prcw[i] = v & 15;
      t.prch[i] = v >> 4;
      if (i > 0 && (t.prcw[i] == 0 || t.prch[i] == 0))
        corrupt("precinct size");
    } else {
      t.prcw[i] = t.prch[i] = 15;
    }
  }
}

void read_sqc(Reader& r, size_t end, Tccp& t) {
  const int sq = int(r.u8());
  t.qntsty = sq & 31;
  t.numgbits = sq >> 5;
  if (t.qntsty > 2) corrupt("quantisation style");
  if (t.qntsty == 1) {
    const uint32_t v = r.u16();
    t.steps[0] = {int(v >> 11), int(v & 0x7ff)};
    for (int b = 1; b < 97; ++b) {
      const int e = t.steps[0].expn - (b - 1) / 3;
      t.steps[b] = {e > 0 ? e : 0, t.steps[0].mant};
    }
    return;
  }
  int b = 0;
  while (r.pos < end && b < 97) {
    if (t.qntsty == 0) {
      t.steps[b++] = {int(r.u8() >> 3), 0};
    } else {
      const uint32_t v = r.u16();
      t.steps[b++] = {int(v >> 11), int(v & 0x7ff)};
    }
  }
}

int read_comp_index(Reader& r, const Codestream& cs) {
  const int c = cs.img.comps.size() <= 256 ? int(r.u8()) : int(r.u16());
  if (c >= int(cs.img.comps.size())) corrupt("component index");
  return c;
}

// One marker segment of a main (tcp == &cs.def) or tile-part header.
void read_segment(uint32_t marker, const uint8_t* seg, size_t len,
                  Codestream& cs, Tcp& tcp, bool main) {
  Reader r(seg, len);
  const size_t end = len;
  switch (marker) {
    case 0xff52: {  // COD
      const int scod = int(r.u8());
      tcp.csty = scod;
      tcp.prg = int(r.u8());
      if (tcp.prg > 4) corrupt("progression order");
      tcp.numlayers = int(r.u16());
      if (tcp.numlayers < 1) corrupt("number of layers");
      tcp.mct = int(r.u8());
      if (tcp.mct > 1) corrupt("multiple component transform");
      Tccp t = tcp.tccps[0];
      read_spco(r, t, scod & 1);
      for (Tccp& c : tcp.tccps) {
        c.csty = scod & 1;
        c.numresolutions = t.numresolutions;
        c.cblkw = t.cblkw;
        c.cblkh = t.cblkh;
        c.cblksty = t.cblksty;
        c.qmfbid = t.qmfbid;
        std::copy(t.prcw, t.prcw + 33, c.prcw);
        std::copy(t.prch, t.prch + 33, c.prch);
      }
      break;
    }
    case 0xff53: {  // COC
      const int c = read_comp_index(r, cs);
      const int scoc = int(r.u8());
      tcp.tccps[c].csty = scoc & 1;
      read_spco(r, tcp.tccps[c], scoc & 1);
      break;
    }
    case 0xff5c:  // QCD
      {
        Tccp t;
        read_sqc(r, end, t);
        for (Tccp& c : tcp.tccps) {
          c.qntsty = t.qntsty;
          c.numgbits = t.numgbits;
          std::copy(t.steps, t.steps + 97, c.steps);
        }
      }
      break;
    case 0xff5d: {  // QCC
      const int c = read_comp_index(r, cs);
      read_sqc(r, end, tcp.tccps[c]);
      break;
    }
    case 0xff5e: {  // RGN
      const int c = read_comp_index(r, cs);
      if (r.u8() != 0) refuse("JPEG 2000 regions of interest other than max-shift");
      tcp.tccps[c].roishift = int(r.u8());
      break;
    }
    case 0xff5f: {  // POC
      const bool wide = cs.img.comps.size() > 256;
      const size_t each = wide ? 9 : 7;
      if (len % each != 0) corrupt("POC length");
      for (size_t k = 0; k < len / each; ++k) {
        Poc p;
        p.resno0 = int(r.u8());
        p.compno0 = wide ? int(r.u16()) : int(r.u8());
        p.layno1 = int(r.u16());
        p.resno1 = int(r.u8());
        p.compno1 = wide ? int(r.u16()) : int(r.u8());
        p.prg = int(r.u8());
        if (p.compno1 == 0) p.compno1 = 256;
        p.resno1 = std::min(p.resno1, 33);
        p.compno1 = std::min(p.compno1, int(cs.img.comps.size()));
        p.layno1 = std::min(p.layno1, tcp.numlayers);
        if (p.prg > 4) corrupt("POC progression order");
        tcp.pocs.push_back(p);
      }
      break;
    }
    case 0xff60:  // PPM: the packet headers, Nppm counts dropped
      if (!main) corrupt("PPM in a tile-part header");
      {
        if (len < 1) corrupt("PPM length");
        r.u8();
        cs.ppm = true;
        while (r.pos + 4 <= end) {
          const uint32_t n = r.u32();
          const size_t take = std::min<size_t>(n, end - r.pos);
          cs.ppm_data.insert(cs.ppm_data.end(), seg + r.pos, seg + r.pos + take);
          r.pos += take;
        }
      }
      break;
    case 0xff61:  // PPT
      if (main || len < 1) corrupt("PPT");
      tcp.has_ppt = true;
      tcp.ppt.insert(tcp.ppt.end(), seg + 1, seg + len);
      break;
    case 0xff50:  // CAP
      refuse("HTJ2K (JPEG 2000 Part 15)");
    default:
      break;  // TLM, PLM, PLT, CRG, COM, ...: nothing the decode needs
  }
}

void read_siz(Reader& r, Codestream& cs) {
  const uint32_t rsiz = r.u16();
  if (rsiz & 0x4000) refuse("HTJ2K (JPEG 2000 Part 15)");
  if (rsiz & 0x8000) refuse("JPEG 2000 Part 2 extensions");
  const int64_t x1 = r.u32(), y1 = r.u32(), x0 = r.u32(), y0 = r.u32();
  const int64_t tdx = r.u32(), tdy = r.u32(), tx0 = r.u32(), ty0 = r.u32();
  const int nc = int(r.u16());
  if (x0 >= x1 || y0 >= y1 || tdx == 0 || tdy == 0 || nc == 0 || nc > 16384)
    corrupt("SIZ");
  if (tx0 > x0 || ty0 > y0 || tx0 + tdx <= x0 || ty0 + tdy <= y0)
    corrupt("SIZ tile offset");
  if (x1 > 0x7fffffff || y1 > 0x7fffffff) corrupt("SIZ size");
  cs.img = {int(x0), int(y0), int(x1), int(y1), {}};
  for (int c = 0; c < nc; ++c) {
    const int s = int(r.u8()), dx = int(r.u8()), dy = int(r.u8());
    if (dx == 0 || dy == 0) corrupt("SIZ subsampling");
    const int prec = (s & 0x7f) + 1;
    if (prec > 31) corrupt("SIZ precision");
    cs.img.comps.push_back({dx, dy, prec, s >> 7});
  }
  cs.tdx = tdx;
  cs.tdy = tdy;
  cs.tx0 = int(tx0);
  cs.ty0 = int(ty0);
  cs.tw = int(ceildiv(x1 - tx0, tdx));
  cs.th = int(ceildiv(y1 - ty0, tdy));
  if (int64_t(cs.tw) * cs.th > 65535) corrupt("too many tiles");
  cs.def.tccps.assign(nc, Tccp());
}

// ------------------------------------------------------------ tile coder

struct TileCoder {
  Codestream& cs;
  Tcp& tcp;
  int tileno;
  int tx0, ty0, tx1, ty1;
  struct TileComp {
    int x0, y0, x1, y1;
    std::vector<Resolution> res;
    std::vector<int32_t> idata;  // reversible
    std::vector<float> fdata;    // irreversible
  };
  std::vector<TileComp> comps;

  TileCoder(Codestream& c, Tcp& t, int no) : cs(c), tcp(t), tileno(no) {
    const int p = no % cs.tw, q = no / cs.tw;
    tx0 = int(std::max<int64_t>(int64_t(cs.tx0) + int64_t(p) * cs.tdx, cs.img.x0));
    ty0 = int(std::max<int64_t>(int64_t(cs.ty0) + int64_t(q) * cs.tdy, cs.img.y0));
    tx1 = int(std::min<int64_t>(int64_t(cs.tx0) + int64_t(p + 1) * cs.tdx, cs.img.x1));
    ty1 = int(std::min<int64_t>(int64_t(cs.ty0) + int64_t(q + 1) * cs.tdy, cs.img.y1));
  }

  void init() {
    const size_t nc = cs.img.comps.size();
    comps.resize(nc);
    for (size_t c = 0; c < nc; ++c) {
      const Comp& ic = cs.img.comps[c];
      const Tccp& tc = tcp.tccps[c];
      if (tc.cblksty != 0) {
        const int s = tc.cblksty;
        std::string names;
        const char* bits[] = {"selective arithmetic coding bypass",
                              "reset of context probabilities",
                              "termination on each coding pass",
                              "vertically causal context",
                              "predictable termination",
                              "segmentation symbols", "HT code-blocks"};
        for (int b = 0; b < 7; ++b)
          if (s & (1 << b)) names += (names.empty() ? "" : ", ") + std::string(bits[b]);
        if (s & 0x40) refuse("HTJ2K (JPEG 2000 Part 15) code-blocks");
        refuse("JPEG 2000 code-block styles (" + names + ")");
      }
      TileComp& t = comps[c];
      t.x0 = int(ceildiv(tx0, ic.dx));
      t.y0 = int(ceildiv(ty0, ic.dy));
      t.x1 = int(ceildiv(tx1, ic.dx));
      t.y1 = int(ceildiv(ty1, ic.dy));
      const int nres = tc.numresolutions;
      t.res.resize(nres);
      for (int r = 0; r < nres; ++r) {
        Resolution& res = t.res[r];
        const int level = nres - 1 - r;
        res.x0 = int(ceildivpow2(t.x0, level));
        res.y0 = int(ceildivpow2(t.y0, level));
        res.x1 = int(ceildivpow2(t.x1, level));
        res.y1 = int(ceildivpow2(t.y1, level));
        res.pdx = tc.prcw[r];
        res.pdy = tc.prch[r];
        const int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
        const int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
        const int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
        const int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : int((px1 - px0) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : int((py1 - py0) >> res.pdy);
        if (int64_t(res.pw) * res.ph > (1 << 24)) corrupt("too many precincts");
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0;
          cbgy0 = py0;
          cbgw = res.pdx;
          cbgh = res.pdy;
          res.numbands = 1;
        } else {
          cbgx0 = ceildivpow2(px0, 1);
          cbgy0 = ceildivpow2(py0, 1);
          cbgw = res.pdx - 1;
          cbgh = res.pdy - 1;
          res.numbands = 3;
        }
        const int cbw = std::min(tc.cblkw, cbgw), cbh = std::min(tc.cblkh, cbgh);
        for (int b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          band.bandno = r == 0 ? 0 : b + 1;
          const int xob = band.bandno & 1, yob = band.bandno >> 1;
          if (r == 0) {
            band.x0 = res.x0;
            band.y0 = res.y0;
            band.x1 = res.x1;
            band.y1 = res.y1;
          } else {
            band.x0 = int(ceildivpow2(int64_t(t.x0) - (int64_t(xob) << level), level + 1));
            band.y0 = int(ceildivpow2(int64_t(t.y0) - (int64_t(yob) << level), level + 1));
            band.x1 = int(ceildivpow2(int64_t(t.x1) - (int64_t(xob) << level), level + 1));
            band.y1 = int(ceildivpow2(int64_t(t.y1) - (int64_t(yob) << level), level + 1));
          }
          const Stepsize& ss = tc.steps[r ? 3 * (r - 1) + b + 1 : 0];
          const int rb = ic.prec;  // the decoder's log2 gain is 0 (OpenJPEG)
          band.stepsize = float((1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
          band.numbps = ss.expn + tc.numgbits - 1;
          band.precs.assign(size_t(res.pw) * res.ph, Precinct());
          for (int pn = 0; pn < res.pw * res.ph; ++pn) {
            Precinct& pr = band.precs[pn];
            const int64_t sx = cbgx0 + int64_t(pn % res.pw) * (int64_t(1) << cbgw);
            const int64_t sy = cbgy0 + int64_t(pn / res.pw) * (int64_t(1) << cbgh);
            pr.x0 = int(std::max<int64_t>(sx, band.x0));
            pr.y0 = int(std::max<int64_t>(sy, band.y0));
            pr.x1 = int(std::min<int64_t>(sx + (int64_t(1) << cbgw), band.x1));
            pr.y1 = int(std::min<int64_t>(sy + (int64_t(1) << cbgh), band.y1));
            if (pr.x1 <= pr.x0 || pr.y1 <= pr.y0) {
              pr.cw = pr.ch = 0;
              continue;
            }
            const int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw;
            const int64_t by0 = floordivpow2(pr.y0, cbh) << cbh;
            const int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw;
            const int64_t by1 = ceildivpow2(pr.y1, cbh) << cbh;
            pr.cw = int((bx1 - bx0) >> cbw);
            pr.ch = int((by1 - by0) >> cbh);
            pr.incl.build(pr.cw, pr.ch);
            pr.imsb.build(pr.cw, pr.ch);
            pr.cblks.resize(size_t(pr.cw) * pr.ch);
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
              Cblk& cb = pr.cblks[k];
              const int64_t cx = bx0 + int64_t(k % pr.cw) * (int64_t(1) << cbw);
              const int64_t cy = by0 + int64_t(k / pr.cw) * (int64_t(1) << cbh);
              cb.x0 = int(std::max<int64_t>(cx, pr.x0));
              cb.y0 = int(std::max<int64_t>(cy, pr.y0));
              cb.x1 = int(std::min<int64_t>(cx + (int64_t(1) << cbw), pr.x1));
              cb.y1 = int(std::min<int64_t>(cy + (int64_t(1) << cbh), pr.y1));
            }
          }
        }
      }
    }
  }

  // ---- the progression (opj_pi_next_*), as a list of packets
  struct Packet {
    int layno, resno, compno, precno;
  };

  void positions(int compno_only, uint32_t& dx, uint32_t& dy) {
    dx = dy = 0;
    for (size_t c = 0; c < comps.size(); ++c) {
      if (compno_only >= 0 && int(c) != compno_only) continue;
      const Comp& ic = cs.img.comps[c];
      const int nres = int(comps[c].res.size());
      for (int r = 0; r < nres; ++r) {
        const Resolution& res = comps[c].res[r];
        const int e = res.pdx + nres - 1 - r;
        if (e < 32 && uint64_t(ic.dx) << e <= 0xffffffffu) {
          const uint32_t v = uint32_t(ic.dx) << e;
          dx = dx == 0 ? v : std::min(dx, v);
        }
        const int f = res.pdy + nres - 1 - r;
        if (f < 32 && uint64_t(ic.dy) << f <= 0xffffffffu) {
          const uint32_t v = uint32_t(ic.dy) << f;
          dy = dy == 0 ? v : std::min(dy, v);
        }
      }
    }
  }

  // the precinct of (x, y) at (compno, resno), or -1 where opj_pi skips
  int precinct_at(int compno, int resno, uint32_t x, uint32_t y) {
    const Comp& ic = cs.img.comps[compno];
    const Resolution& res = comps[compno].res[resno];
    const int levelno = int(comps[compno].res.size()) - 1 - resno;
    const uint64_t cdx = uint64_t(ic.dx) << levelno, cdy = uint64_t(ic.dy) << levelno;
    const uint64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
    const uint64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
    const int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 63 || rpy >= 63) return -1;
    if (!((uint64_t(y) % (uint64_t(ic.dy) << rpy) == 0) ||
          (y == uint32_t(ty0) && ((try0 << levelno) % (uint64_t(1) << rpy)))))
      return -1;
    if (!((uint64_t(x) % (uint64_t(ic.dx) << rpx) == 0) ||
          (x == uint32_t(tx0) && ((trx0 << levelno) % (uint64_t(1) << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    const uint64_t prci = (ceildiv(x, cdx) >> res.pdx) - (trx0 >> res.pdx);
    const uint64_t prcj = (ceildiv(y, cdy) >> res.pdy) - (try0 >> res.pdy);
    return int(prci + prcj * uint64_t(res.pw));
  }

  std::vector<Packet> progression() {
    const int nc = int(comps.size());
    int maxres = 0, maxprec = 0;
    for (auto& t : comps) {
      maxres = std::max(maxres, int(t.res.size()));
      for (auto& r : t.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    std::vector<Poc> pocs = tcp.pocs;
    if (pocs.empty())
      pocs.push_back({0, 0, tcp.numlayers, maxres, nc, tcp.prg});
    const size_t step_c = size_t(std::max(maxprec, 1)), step_r = nc * step_c,
                 step_l = maxres * step_r;
    std::vector<uint8_t> include(size_t(tcp.numlayers) * step_l, 0);
    std::vector<Packet> out;
    auto emit = [&](int l, int r, int c, int p) {
      const size_t k = l * step_l + r * step_r + c * step_c + p;
      if (k >= include.size()) corrupt("packet index");
      if (!include[k]) {
        include[k] = 1;
        out.push_back({l, r, c, p});
      }
    };
    for (const Poc& pc : pocs) {
      const int l1 = std::min(pc.layno1, tcp.numlayers);
      const int r0 = pc.resno0, r1 = pc.resno1, c0 = pc.compno0,
                c1 = std::min(pc.compno1, nc);
      if (c0 >= nc) corrupt("POC component");
      switch (pc.prg) {
        case 0:  // LRCP
          for (int l = 0; l < l1; ++l)
            for (int r = r0; r < r1; ++r)
              for (int c = c0; c < c1; ++c) {
                if (r >= int(comps[c].res.size())) continue;
                const Resolution& res = comps[c].res[r];
                for (int p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
              }
          break;
        case 1:  // RLCP
          for (int r = r0; r < r1; ++r)
            for (int l = 0; l < l1; ++l)
              for (int c = c0; c < c1; ++c) {
                if (r >= int(comps[c].res.size())) continue;
                const Resolution& res = comps[c].res[r];
                for (int p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
              }
          break;
        case 2: {  // RPCL
          uint32_t dx, dy;
          positions(-1, dx, dy);
          if (dx == 0 || dy == 0) corrupt("precinct steps");
          for (int r = r0; r < r1; ++r)
            for (uint32_t y = ty0; y < uint32_t(ty1); y += dy - (y % dy))
              for (uint32_t x = tx0; x < uint32_t(tx1); x += dx - (x % dx))
                for (int c = c0; c < c1; ++c) {
                  if (r >= int(comps[c].res.size())) continue;
                  const int p = precinct_at(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; ++l) emit(l, r, c, p);
                }
          break;
        }
        case 3: {  // PCRL
          uint32_t dx, dy;
          positions(-1, dx, dy);
          if (dx == 0 || dy == 0) corrupt("precinct steps");
          for (uint32_t y = ty0; y < uint32_t(ty1); y += dy - (y % dy))
            for (uint32_t x = tx0; x < uint32_t(tx1); x += dx - (x % dx))
              for (int c = c0; c < c1; ++c)
                for (int r = r0; r < std::min(r1, int(comps[c].res.size())); ++r) {
                  const int p = precinct_at(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; ++l) emit(l, r, c, p);
                }
          break;
        }
        case 4: {  // CPRL
          for (int c = c0; c < c1; ++c) {
            uint32_t dx, dy;
            positions(c, dx, dy);
            if (dx == 0 || dy == 0) corrupt("precinct steps");
            for (uint32_t y = ty0; y < uint32_t(ty1); y += dy - (y % dy))
              for (uint32_t x = tx0; x < uint32_t(tx1); x += dx - (x % dx))
                for (int r = r0; r < std::min(r1, int(comps[c].res.size())); ++r) {
                  const int p = precinct_at(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; ++l) emit(l, r, c, p);
                }
          }
          break;
        }
      }
    }
    return out;
  }

  static int numpasses(Bio& bio) {
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    uint32_t n = bio.read(2);
    if (n != 3) return 3 + int(n);
    n = bio.read(5);
    if (n != 31) return 6 + int(n);
    return 37 + int(bio.read(7));
  }

  static int floorlog2(uint32_t v) {
    int l = 0;
    while (v >>= 1) ++l;
    return l;
  }

  // one packet: its header from `hdr` (the body, or PPM/PPT data), its
  // code-block bytes from the body; returns false where OpenJPEG stops
  void packet(const Packet& pk, const uint8_t* body, size_t body_len,
              size_t& body_pos, const uint8_t* hdr, size_t hdr_len,
              size_t& hdr_pos, bool separate_headers) {
    Resolution& res = comps[pk.compno].res[pk.resno];
    if (pk.layno == 0) {
      for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Precinct& pr = band.precs[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (Cblk& cb : pr.cblks) cb.included = false;
      }
    }
    if (tcp.csty & 2) {  // SOP
      if (body_len - body_pos >= 6 && body[body_pos] == 0xff &&
          body[body_pos + 1] == 0x91)
        body_pos += 6;
    }
    if (!separate_headers) hdr_pos = body_pos;
    Bio bio(hdr + hdr_pos, hdr_len - std::min(hdr_pos, hdr_len));
    const bool present = bio.read(1);
    if (present) {
      for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Precinct& pr = band.precs[pk.precno];
        for (int k = 0; k < pr.cw * pr.ch; ++k) {
          Cblk& cb = pr.cblks[k];
          int included;
          if (!cb.included) included = pr.incl.decode(bio, k, pk.layno + 1);
          else included = bio.read(1);
          if (!included) {
            cb.newpasses = 0;
            continue;
          }
          if (!cb.included) {
            int i = 0;
            while (!pr.imsb.decode(bio, k, i)) ++i;
            cb.numbps = band.numbps + 1 - i;
            cb.numlenbits = 3;
            cb.numsegs = 0;
          }
          cb.newpasses = numpasses(bio);
          int inc = 0;
          while (bio.read(1)) ++inc;
          cb.numlenbits += inc;
          // opj_t2_read_packet_header: a length for each segment the new
          // passes reach
          if (cb.numsegs == 0 || cb.seg_passes == 109) {
            ++cb.numsegs;
            cb.seg_passes = 0;
          }
          cb.newsegs.clear();
          int n = cb.newpasses, sp = cb.seg_passes;
          while (n > 0) {
            const int take = std::min(109 - sp, n);
            const int bits = cb.numlenbits + floorlog2(uint32_t(take));
            if (bits > 32) corrupt("code-block length");
            cb.newsegs.push_back({take, bio.read(bits)});
            n -= take;
            sp = 0;
          }
          cb.included = true;
        }
      }
    }
    if ((bio.buf & 0xff) == 0xff && bio.bp >= bio.end)
      corrupt("packet header cut short");
    bio.inalign();
    hdr_pos += bio.numbytes();
    if (tcp.csty & 4) {  // EPH
      if (hdr_len - std::min(hdr_pos, hdr_len) >= 2 && hdr[hdr_pos] == 0xff &&
          hdr[hdr_pos + 1] == 0x92)
        hdr_pos += 2;
    }
    if (!separate_headers) body_pos = hdr_pos;
    if (!present) return;
    // the body: each included block's new bytes (OpenJPEG's strict mode,
    // which OpenCV keeps: a segment past the tile's data fails the decode)
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precs[pk.precno];
      for (Cblk& cb : pr.cblks) {
        if (cb.newpasses == 0) continue;
        for (size_t k = 0; k < cb.newsegs.size(); ++k) {
          const auto [passes, bytes] = cb.newsegs[k];
          if (bytes > body_len - body_pos) corrupt("code-block segment too long");
          cb.data.insert(cb.data.end(), body + body_pos, body + body_pos + bytes);
          body_pos += bytes;
          if (k > 0) {
            ++cb.numsegs;
            cb.seg_passes = 0;
          }
          if (cb.numsegs == 1) {
            cb.seg0_len += bytes;
            cb.numpasses += passes;
          }
          cb.seg_passes += passes;
        }
        cb.newpasses = 0;
      }
    }
  }

  void decode() {
    init();
    const std::vector<Packet> order = progression();
    const uint8_t* body = tcp.data.data();
    size_t body_len = tcp.data.size(), body_pos = 0;
    const uint8_t* hdr = body;
    size_t hdr_len = body_len, hdr_pos = 0;
    bool separate = false;
    size_t* hpos = &hdr_pos;
    if (cs.ppm) {
      hdr = cs.ppm_data.data();
      hdr_len = cs.ppm_data.size();
      hpos = &cs.ppm_pos;
      separate = true;
    } else if (tcp.has_ppt) {
      hdr = tcp.ppt.data();
      hdr_len = tcp.ppt.size();
      separate = true;
    }
    for (const Packet& pk : order) {
      packet(pk, body, body_len, body_pos, hdr, hdr_len, *hpos, separate);
    }
    t1_all();
    idwt_all();
    mct();
    level_shift_and_store();
  }

  void t1_all() {
    std::vector<int32_t> blk;
    for (size_t c = 0; c < comps.size(); ++c) {
      TileComp& t = comps[c];
      const Tccp& tc = tcp.tccps[c];
      const int w = t.x1 - t.x0, h = t.y1 - t.y0;
      if (tc.qmfbid == 1) t.idata.assign(size_t(w) * h, 0);
      else t.fdata.assign(size_t(w) * h, 0.0f);
      for (size_t r = 0; r < t.res.size(); ++r) {
        Resolution& res = t.res[r];
        for (int b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          if (band.empty()) continue;
          int xoff = -band.x0, yoff = -band.y0;
          if (band.bandno & 1) xoff += t.res[r - 1].x1 - t.res[r - 1].x0;
          if (band.bandno & 2) yoff += t.res[r - 1].y1 - t.res[r - 1].y0;
          const float step = 0.5f * band.stepsize;
          for (Precinct& pr : band.precs)
            for (Cblk& cb : pr.cblks) {
              const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
              if (cw <= 0 || ch <= 0) continue;
              blk.resize(size_t(cw) * ch);
              // opj_t1_decode_cblk fails the block past 30 bit-planes; a
              // negative count (more zero bit-planes than the band has)
              // decodes no pass
              if (tc.roishift + cb.numbps >= 31)
                corrupt("code-block with too many bit-planes");
              t1_decode(cb.data.data(), cb.seg0_len, cb.numpasses,
                        tc.roishift + cb.numbps, band.bandno, cw, ch,
                        blk.data());
              if (tc.roishift) {
                if (tc.roishift >= 31) {
                  std::fill(blk.begin(), blk.end(), 0);
                } else {
                  const int32_t thresh = int32_t(1) << tc.roishift;
                  for (int32_t& v : blk) {
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                      mag >>= tc.roishift;
                      v = v < 0 ? -mag : mag;
                    }
                  }
                }
              }
              for (int y = 0; y < ch; ++y) {
                const size_t row = size_t(cb.y0 + yoff + y) * w + (cb.x0 + xoff);
                const int32_t* src = blk.data() + size_t(y) * cw;
                if (tc.qmfbid == 1) {
                  for (int x = 0; x < cw; ++x) t.idata[row + x] = src[x] / 2;
                } else {
                  for (int x = 0; x < cw; ++x)
                    t.fdata[row + x] = float(src[x]) * step;
                }
              }
            }
        }
      }
    }
  }

  // ---- inverse wavelet

  // One level of the inverse wavelet along n rows of m values each (row k
  // at X + k*m; m = 1 for a line), the low band on rows of parity `cas`:
  // the same arithmetic on every one of the m columns, in the order
  // OpenJPEG does it.
  static const int32_t* mirror(const int32_t* X, int k, int n, int m) {
    if (k < 0) k = -k;
    if (k >= n) k = 2 * (n - 1) - k;
    return X + size_t(k) * m;
  }
  static const float* mirror(const float* X, int k, int n, int m) {
    if (k < 0) k = -k;
    if (k >= n) k = 2 * (n - 1) - k;
    return X + size_t(k) * m;
  }

  static void idwt53(int32_t* X, int n, int m, int cas) {
    if (n == 1) {
      if (cas)
        for (int i = 0; i < m; ++i) X[i] /= 2;
      return;
    }
    for (int k = cas; k < n; k += 2) {  // the low band
      int32_t* __restrict x = X + size_t(k) * m;
      const int32_t* __restrict a = mirror(X, k - 1, n, m);
      const int32_t* __restrict b = mirror(X, k + 1, n, m);
      for (int i = 0; i < m; ++i) x[i] -= (a[i] + b[i] + 2) >> 2;
    }
    for (int k = 1 - cas; k < n; k += 2) {
      int32_t* __restrict x = X + size_t(k) * m;
      const int32_t* __restrict a = mirror(X, k - 1, n, m);
      const int32_t* __restrict b = mirror(X, k + 1, n, m);
      for (int i = 0; i < m; ++i) x[i] += (a[i] + b[i]) >> 1;
    }
  }

  static void idwt97(float* X, int n, int m, int cas) {
    const int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
    if (cas == 0) {
      if (!(dn > 0 || sn > 1)) return;
    } else {
      if (!(sn > 0 || dn > 1)) return;
    }
    const float K = 1.230174105f, two_invK = 1.625732422f;
    const float delta = -0.443506852f, gamma = -0.882911075f,
                beta = 0.052980118f, alpha = 1.586134342f;
    for (int k = 0; k < n; ++k) {
      float* x = X + size_t(k) * m;
      const float f = ((k - cas) & 1) ? two_invK : K;
      for (int i = 0; i < m; ++i) x[i] = x[i] * f;
    }
    auto lift = [&](int start, float c) {
      for (int k = start; k < n; k += 2) {
        float* __restrict x = X + size_t(k) * m;
        const float* __restrict a = mirror(X, k - 1, n, m);
        const float* __restrict b = mirror(X, k + 1, n, m);
        for (int i = 0; i < m; ++i) x[i] = x[i] + (a[i] + b[i]) * c;
      }
    };
    lift(cas, delta);
    lift(1 - cas, gamma);
    lift(cas, beta);
    lift(1 - cas, alpha);
  }

  // Each level: every row (horizontally), then the rows as vectors
  // (vertically), as opj_dwt_decode_tile does.
  template <typename T, typename F>
  static void idwt_levels(std::vector<T>& data, int w,
                          const std::vector<Resolution>& res, F lift) {
    std::vector<T> line, tmp;
    for (size_t r = 1; r < res.size(); ++r) {
      const int sn_h = res[r - 1].x1 - res[r - 1].x0;
      const int sn_v = res[r - 1].y1 - res[r - 1].y0;
      const int rw = res[r].x1 - res[r].x0, rh = res[r].y1 - res[r].y0;
      const int cas_h = res[r].x0 & 1, cas_v = res[r].y0 & 1;
      if (rw <= 0 || rh <= 0) continue;
      line.resize(rw);
      for (int j = 0; j < rh; ++j) {
        T* row = data.data() + size_t(j) * w;
        for (int i = 0; i < sn_h; ++i) line[cas_h + 2 * i] = row[i];
        for (int i = 0; i < rw - sn_h; ++i)
          line[1 - cas_h + 2 * i] = row[sn_h + i];
        lift(line.data(), rw, 1, cas_h);
        std::copy(line.begin(), line.end(), row);
      }
      tmp.resize(size_t(rw) * rh);
      for (int j = 0; j < rh; ++j) {
        const int to = j < sn_v ? cas_v + 2 * j : 1 - cas_v + 2 * (j - sn_v);
        std::copy(data.data() + size_t(j) * w, data.data() + size_t(j) * w + rw,
                  tmp.data() + size_t(to) * rw);
      }
      lift(tmp.data(), rh, rw, cas_v);
      for (int j = 0; j < rh; ++j)
        std::copy(tmp.data() + size_t(j) * rw, tmp.data() + size_t(j + 1) * rw,
                  data.data() + size_t(j) * w);
    }
  }

  void idwt_all() {
    for (size_t c = 0; c < comps.size(); ++c) {
      TileComp& t = comps[c];
      const int w = t.x1 - t.x0;
      if (tcp.tccps[c].qmfbid == 1)
        idwt_levels(t.idata, w, t.res, idwt53);
      else
        idwt_levels(t.fdata, w, t.res, idwt97);
    }
  }

  void mct() {
    if (!tcp.mct || comps.size() < 3) return;
    const size_t n = comps[0].idata.size() + comps[0].fdata.size();
    for (int c = 1; c < 3; ++c)
      if (comps[c].idata.size() + comps[c].fdata.size() != n)
        corrupt("components of the colour transform differ in size");
    if (tcp.tccps[0].qmfbid == 1) {
      if (comps[1].idata.size() != n || comps[2].idata.size() != n) return;
      int32_t *c0 = comps[0].idata.data(), *c1 = comps[1].idata.data(),
              *c2 = comps[2].idata.data();
      for (size_t i = 0; i < n; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      if (comps[1].fdata.size() != n || comps[2].fdata.size() != n) return;
      float *c0 = comps[0].fdata.data(), *c1 = comps[1].fdata.data(),
            *c2 = comps[2].fdata.data();
      for (size_t i = 0; i < n; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + v * 1.402f;
        float g = y - u * 0.34413f;
        g = g - v * 0.71414f;
        const float b = y + u * 1.772f;
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }

  void level_shift_and_store() {
    for (size_t c = 0; c < comps.size(); ++c) {
      TileComp& t = comps[c];
      const Comp& ic = cs.img.comps[c];
      const int32_t lo = ic.sgnd ? -(int32_t(1) << (ic.prec - 1)) : 0;
      const int32_t hi = ic.sgnd ? (int32_t(1) << (ic.prec - 1)) - 1
                                 : int32_t((int64_t(1) << ic.prec) - 1);
      const int32_t shift = ic.sgnd ? 0 : int32_t(1) << (ic.prec - 1);
      const int w = t.x1 - t.x0, h = t.y1 - t.y0;
      std::vector<int32_t>& out = cs.out[c];
      const int ow = cs.out_w[c];
      for (int y = 0; y < h; ++y) {
        int32_t* o = out.data() + size_t(t.y0 - cs.out_y0[c] + y) * ow +
                     (t.x0 - cs.out_x0[c]);
        if (tcp.tccps[c].qmfbid == 1) {
          const int32_t* s = t.idata.data() + size_t(y) * w;
          for (int x = 0; x < w; ++x)
            o[x] = std::clamp(s[x] + shift, lo, hi);
        } else {
          const float* s = t.fdata.data() + size_t(y) * w;
          for (int x = 0; x < w; ++x) {
            const float v = s[x];
            if (v > float(INT32_MAX)) o[x] = hi;
            else if (v < float(INT32_MIN)) o[x] = lo;
            else {
              const int64_t iv = int64_t(std::lrintf(v)) + shift;
              o[x] = int32_t(std::clamp<int64_t>(iv, lo, hi));
            }
          }
        }
      }
    }
  }
};

// ------------------------------------------------------------ codestream

// The header states OpenJPEG's marker table allows a marker in (1: main
// header, 2: tile-part header), 0 for one allowed in neither, -1 for one
// the table does not hold (SOD, EOC, SOC, EPH and any other).
constexpr int kMain = 1, kTilePart = 2;
int marker_states(uint32_t m) {
  switch (m) {
    case 0xff52: case 0xff53: case 0xff5e: case 0xff5c: case 0xff5d:
    case 0xff5f: case 0xff64: case 0xff74: case 0xff75: case 0xff77:
      return kMain | kTilePart;  // COD COC RGN QCD QCC POC COM MCT MCC MCO
    case 0xff90: case 0xff55: case 0xff57: case 0xff60: case 0xff63:
    case 0xff78: case 0xff50: case 0xff59:
      return kMain;              // SOT TLM PLM PPM CRG CBD CAP CPF
    case 0xff58: case 0xff61:
      return kTilePart;          // PLT PPT
    case 0xff51: case 0xff91:
      return 0;                  // SIZ (only first), SOP
    default:
      return -1;
  }
}

// opj_j2k_read_unk: after an unknown marker at `pos`, the next pair of
// bytes (two at a time) that is a marker of the table; fails where it is
// not allowed in `state` or the stream ends first.  Returns its position.
size_t skip_unknown(const uint8_t* d, size_t n, size_t pos, int state) {
  for (size_t p = pos + 2;; p += 2) {
    if (p + 2 > n) corrupt("stream too short after an unknown marker");
    const uint32_t v = uint32_t(d[p]) << 8 | d[p + 1];
    if (v < 0xff00) continue;
    const int st = marker_states(v);
    if (st < 0) continue;
    if (!(st & state)) corrupt("marker not compliant with its position");
    return p;
  }
}

void decode_codestream(const uint8_t* d, size_t n, Codestream& cs) {
  if (n < 4 || d[0] != 0xff || d[1] != 0x4f || d[2] != 0xff || d[3] != 0x51)
    corrupt("no SOC/SIZ");
  size_t pos = 4;
  auto seglen = [&](size_t at) -> size_t {
    if (at + 2 > n) corrupt("marker segment cut short");
    const size_t l = size_t(d[at]) << 8 | d[at + 1];
    if (l < 2 || at + l > n) corrupt("marker segment cut short");
    return l;
  };
  {
    const size_t l = seglen(pos);
    Reader r(d + pos + 2, l - 2);
    read_siz(r, cs);
    if (cs.ihdr_w && (uint32_t(cs.img.x1 - cs.img.x0) != cs.ihdr_w ||
                      uint32_t(cs.img.y1 - cs.img.y0) != cs.ihdr_h))
      corrupt("SIZ and ihdr sizes differ");
    pos += l;
  }
  bool have_cod = false, have_qcd = false;
  // main header
  for (;;) {
    if (pos + 2 > n) corrupt("main header cut short");
    const uint32_t m = uint32_t(d[pos]) << 8 | d[pos + 1];
    if (m == 0xff90) break;
    if (m < 0xff00) corrupt("expected a marker");
    const int st = marker_states(m);
    if (st < 0) {
      pos = skip_unknown(d, n, pos, kMain);
      continue;
    }
    if (!(st & kMain)) corrupt("marker not compliant with its position");
    const size_t l = seglen(pos + 2);
    if (m == 0xff52) have_cod = true;
    if (m == 0xff5c) have_qcd = true;
    read_segment(m, d + pos + 4, l - 2, cs, cs.def, true);
    pos += 2 + l;
  }
  if (!have_cod || !have_qcd) corrupt("main header without COD or QCD");
  const int ntiles = cs.tw * cs.th;
  cs.tiles.assign(ntiles, Tcp());
  // tile-parts
  // after each tile-part OpenJPEG reads two more bytes: EOC ends the
  // tiles; so does any other marker with nothing after it; anything else
  // but a whole SOT fails
  for (;;) {
    if (pos + 2 > n) corrupt("stream too short");
    const uint32_t m = uint32_t(d[pos]) << 8 | d[pos + 1];
    if (m == 0xffd9 || pos + 2 == n) break;
    if (m != 0xff90 || pos + 12 > n) corrupt("stream too short, expected SOT");
    const size_t l = size_t(d[pos + 2]) << 8 | d[pos + 3];
    if (l != 10) corrupt("SOT length");
    const int isot = int(d[pos + 4]) << 8 | d[pos + 5];
    const uint32_t psot = uint32_t(d[pos + 6]) << 24 | uint32_t(d[pos + 7]) << 16 |
                          uint32_t(d[pos + 8]) << 8 | d[pos + 9];
    if (isot >= ntiles) corrupt("tile index");
    Tcp& tcp = cs.tiles[isot];
    if (!tcp.seen) {
      tcp.csty = cs.def.csty;
      tcp.prg = cs.def.prg;
      tcp.numlayers = cs.def.numlayers;
      tcp.mct = cs.def.mct;
      tcp.tccps = cs.def.tccps;
      tcp.pocs = cs.def.pocs;
      tcp.seen = true;
    }
    // opj_j2k_read_sot: each tile's parts in order
    if (d[pos + 10] != tcp.parts_seen) corrupt("tile-part index");
    ++tcp.parts_seen;
    const size_t sot_at = pos;
    pos += 12;
    // tile-part header
    for (;;) {
      if (pos + 2 > n) corrupt("tile-part header cut short");
      const uint32_t mm = uint32_t(d[pos]) << 8 | d[pos + 1];
      if (mm == 0xff93) {
        pos += 2;
        break;
      }
      if (mm < 0xff00) corrupt("expected a marker");
      const int st = marker_states(mm);
      if (st < 0) {
        pos = skip_unknown(d, n, pos, kTilePart);
        continue;
      }
      if (!(st & kTilePart)) corrupt("marker not compliant with its position");
      const size_t ll = seglen(pos + 2);
      read_segment(mm, d + pos + 4, ll - 2, cs, tcp, false);
      pos += 2 + ll;
    }
    size_t end = psot == 0 ? n : sot_at + psot;
    if (psot == 0) {
      // to EOC (the last two bytes) or the end
      if (n >= 2 && d[n - 2] == 0xff && d[n - 1] == 0xd9) end = n - 2;
    }
    if (end < pos) corrupt("tile-part length");
    if (end > n) corrupt("tile-part length past the stream");
    tcp.data.insert(tcp.data.end(), d + pos, d + end);
    pos = end;
  }
  // the output image, as opj_j2k_update_image_data places tiles
  const size_t nc = cs.img.comps.size();
  cs.out.resize(nc);
  cs.out_w.resize(nc);
  cs.out_h.resize(nc);
  cs.out_x0.resize(nc);
  cs.out_y0.resize(nc);
  for (size_t c = 0; c < nc; ++c) {
    const Comp& ic = cs.img.comps[c];
    cs.out_x0[c] = int(ceildiv(cs.img.x0, ic.dx));
    cs.out_y0[c] = int(ceildiv(cs.img.y0, ic.dy));
    cs.out_w[c] = int(ceildiv(cs.img.x1, ic.dx)) - cs.out_x0[c];
    cs.out_h[c] = int(ceildiv(cs.img.y1, ic.dy)) - cs.out_y0[c];
    if (int64_t(cs.out_w[c]) * cs.out_h[c] > (int64_t(1) << 30))
      corrupt("image too large");
    cs.out[c].assign(size_t(cs.out_w[c]) * cs.out_h[c], 0);
  }
  bool any = false;
  for (int t = 0; t < ntiles; ++t) {
    if (!cs.tiles[t].seen) continue;
    any = true;
    TileCoder tc(cs, cs.tiles[t], t);
    tc.decode();
    std::vector<uint8_t>().swap(cs.tiles[t].data);
  }
  if (!any) corrupt("no tile decoded");
}

// ------------------------------------------------------------------ JP2

struct Jp2 {
  uint32_t ihdr_w = 0, ihdr_h = 0;
  int enumcs = 0;
  bool has_colr = false;
  std::vector<std::vector<uint32_t>> pclr;  // [entry][channel]
  std::vector<int> pclr_bits, pclr_sign;
  bool has_pclr = false;
  struct CmapEntry { int cmp, mtyp, pcol; };
  std::vector<CmapEntry> cmap;
  bool has_cmap = false;
  struct CdefEntry { int cn, typ, asoc; };
  std::vector<CdefEntry> cdef;
  bool has_cdef = false;
};

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

void read_jp2h(const uint8_t* p, size_t n, Jp2& j) {
  size_t pos = 0;
  bool ihdr = false;
  while (pos + 8 <= n) {
    uint64_t len = be32(p + pos);
    const uint32_t type = be32(p + pos + 4);
    size_t hl = 8;
    if (len == 1) {
      if (pos + 16 > n) corrupt("box cut short");
      len = uint64_t(be32(p + pos + 8)) << 32 | be32(p + pos + 12);
      hl = 16;
    } else if (len == 0) {
      len = n - pos;
    }
    if (len < hl || pos + len > n) corrupt("box length");
    const uint8_t* b = p + pos + hl;
    const size_t bl = size_t(len - hl);
    if (type == 0x69686472) {  // ihdr
      if (bl != 14) corrupt("ihdr");
      j.ihdr_h = be32(b);
      j.ihdr_w = be32(b + 4);
      ihdr = true;
    } else if (type == 0x636f6c72) {  // colr: the first one counts
      if (bl < 3) corrupt("colr");
      if (!j.has_colr) {
        j.has_colr = true;
        if (b[0] == 1) {
          if (bl < 7) corrupt("colr");
          j.enumcs = int(be32(b + 3));
        }
      }
    } else if (type == 0x70636c72) {  // pclr
      if (j.has_pclr) corrupt("two pclr boxes");
      if (bl < 3) corrupt("pclr");
      const int ne = int(b[0]) << 8 | b[1], npc = b[2];
      if (ne == 0 || ne > 1024 || npc == 0) corrupt("pclr");
      size_t q = 3;
      if (bl < q + npc) corrupt("pclr");
      for (int k = 0; k < npc; ++k) {
        j.pclr_bits.push_back((b[q] & 0x7f) + 1);
        j.pclr_sign.push_back(b[q] >> 7);
        ++q;
      }
      j.pclr.assign(ne, std::vector<uint32_t>(npc, 0));
      for (int e = 0; e < ne; ++e)
        for (int k = 0; k < npc; ++k) {
          const int bytes = (j.pclr_bits[k] + 7) / 8;
          if (bytes > 4 || q + bytes > bl) corrupt("pclr cut short");
          uint32_t v = 0;
          for (int i = 0; i < bytes; ++i) v = (v << 8) | b[q++];
          j.pclr[e][k] = v;
        }
      j.has_pclr = true;
    } else if (type == 0x636d6170) {  // cmap
      if (j.has_cmap) corrupt("two cmap boxes");
      for (size_t q = 0; q + 4 <= bl; q += 4)
        j.cmap.push_back({int(b[q]) << 8 | b[q + 1], b[q + 2], b[q + 3]});
      j.has_cmap = true;
    } else if (type == 0x63646566) {  // cdef
      if (j.has_cdef || bl < 2) corrupt("cdef");
      const int nd = int(b[0]) << 8 | b[1];
      if (nd == 0 || bl < size_t(2 + 6 * nd)) corrupt("cdef");
      for (int k = 0; k < nd; ++k) {
        const uint8_t* e = b + 2 + 6 * k;
        j.cdef.push_back({int(e[0]) << 8 | e[1], int(e[2]) << 8 | e[3],
                          int(e[4]) << 8 | e[5]});
      }
      j.has_cdef = true;
    }
    pos += size_t(len);
  }
  if (!ihdr) corrupt("jp2h without ihdr");
}

struct Decoded {
  int color_space = 0;  // OpenJPEG's OPJ_COLOR_SPACE: -1 unknown, 0
                        // unspecified, 1 sRGB, 2 gray, 3 sYCC, 4 eYCC, 5 CMYK
  struct C {
    int w, h, dx, dy, x0, y0, prec, sgnd, alpha;
    std::vector<int32_t> data;
  };
  std::vector<C> comps;
};

void from_codestream(Codestream& cs, Decoded& out) {
  for (size_t c = 0; c < cs.img.comps.size(); ++c) {
    const Comp& ic = cs.img.comps[c];
    out.comps.push_back({cs.out_w[c], cs.out_h[c], ic.dx, ic.dy, cs.out_x0[c],
                         cs.out_y0[c], ic.prec, ic.sgnd, 0,
                         std::move(cs.out[c])});
  }
}

void decode_jp2(const uint8_t* d, size_t n, Decoded& out) {
  size_t pos = 0;
  Jp2 j;
  bool sig = false, ftyp = false, jp2h = false;
  const uint8_t* cstream = nullptr;
  size_t clen = 0;
  while (pos + 8 <= n) {
    uint64_t len = be32(d + pos);
    const uint32_t type = be32(d + pos + 4);
    size_t hl = 8;
    if (len == 1) {
      if (pos + 16 > n) corrupt("box cut short");
      len = uint64_t(be32(d + pos + 8)) << 32 | be32(d + pos + 12);
      hl = 16;
    } else if (len == 0) {
      len = n - pos;
    }
    if (len < hl) corrupt("box length");
    const uint8_t* b = d + pos + hl;
    size_t bl = size_t(std::min<uint64_t>(len, n - pos) - hl);
    if (type == 0x6a502020) {  // signature
      if (bl != 4 || be32(b) != 0x0d0a870a) corrupt("JP2 signature");
      sig = true;
    } else if (type == 0x66747970) {  // ftyp
      ftyp = true;
    } else if (type == 0x6a703268) {  // jp2h
      if (pos + len > n) corrupt("jp2h cut short");
      read_jp2h(b, bl, j);
      jp2h = true;
    } else if (type == 0x6a703263) {  // jp2c
      cstream = b;
      clen = bl;
      break;
    }
    if (pos + len > n) break;
    pos += size_t(len);
  }
  if (!sig || !ftyp) corrupt("JP2 without signature or ftyp");
  if (!jp2h) corrupt("JP2 without a jp2h box");
  if (!cstream) corrupt("JP2 without a codestream");
  Codestream cs;
  cs.ihdr_w = j.ihdr_w;
  cs.ihdr_h = j.ihdr_h;
  decode_codestream(cstream, clen, cs);
  from_codestream(cs, out);
  const int nc = int(out.comps.size());
  // opj_jp2_check_color
  if (j.has_pclr && !j.has_cmap) corrupt("pclr without cmap");
  if (j.has_cdef) {
    int nr = nc;
    if (j.has_pclr) nr = int(j.pclr_bits.size());
    for (const auto& e : j.cdef) {
      if (e.cn >= nr) corrupt("cdef channel");
      if (e.asoc == 65535) continue;
      if (e.asoc > 0 && e.asoc - 1 >= nr) corrupt("cdef association");
    }
    for (; nr > 0; --nr) {
      bool found = false;
      for (const auto& e : j.cdef) found |= e.cn == nr - 1;
      if (!found) corrupt("incomplete channel definitions");
    }
  }
  if (j.has_pclr) {
    const int npc = int(j.pclr_bits.size());
    if (int(j.cmap.size()) != npc) corrupt("cmap and pclr disagree");
    bool sane = true;
    std::vector<uint8_t> used(npc, 0);
    for (int i = 0; i < npc; ++i)
      if (j.cmap[i].cmp >= nc) sane = false;
    for (int i = 0; i < npc; ++i) {
      const int mtyp = j.cmap[i].mtyp, pcol = j.cmap[i].pcol;
      if ((mtyp != 0 && mtyp != 1) || pcol >= npc || (used[pcol] && mtyp == 1) ||
          (mtyp == 0 && pcol != 0) || (mtyp == 1 && pcol != i))
        sane = false;
      else
        used[pcol] = 1;
    }
    for (int i = 0; i < npc; ++i)
      if (!used[i] && j.cmap[i].mtyp != 0) sane = false;
    if (sane && nc == 1) {  // OpenJPEG's correction of a weird cmap
      bool all = true;
      for (int i = 0; i < npc; ++i) all &= used[i] != 0;
      if (!all)
        for (int i = 0; i < npc; ++i) j.cmap[i] = {j.cmap[i].cmp, 1, i};
    }
    if (!sane) corrupt("cmap");
    // opj_jp2_apply_pclr
    std::vector<Decoded::C> nw;
    const int top = int(j.pclr.size()) - 1;
    for (const auto& e : j.cmap) {
      Decoded::C c = out.comps[e.cmp];
      if (e.mtyp == 1) {
        c.prec = j.pclr_bits[e.pcol];
        c.sgnd = j.pclr_sign[e.pcol];
        for (int32_t& v : c.data) {
          const int k = std::clamp(v, 0, top);
          v = int32_t(j.pclr[k][e.pcol]);
        }
      }
      nw.push_back(std::move(c));
    }
    out.comps = std::move(nw);
  }
  if (j.has_cdef) {
    // opj_jp2_apply_cdef
    auto info = j.cdef;
    const int n2 = int(out.comps.size());
    for (size_t i = 0; i < info.size(); ++i) {
      const int asoc = info[i].asoc, cn = info[i].cn;
      if (cn >= n2) continue;
      if (asoc == 0 || asoc == 65535) {
        out.comps[cn].alpha = info[i].typ;
        continue;
      }
      const int acn = asoc - 1;
      if (acn >= n2) continue;
      if (cn != acn && info[i].typ == 0) {
        std::swap(out.comps[cn], out.comps[acn]);
        for (size_t k = i + 1; k < info.size(); ++k) {
          if (info[k].cn == cn) info[k].cn = acn;
          else if (info[k].cn == acn) info[k].cn = cn;
        }
      }
      out.comps[cn].alpha = info[i].typ;
    }
  }
  switch (j.enumcs) {
    case 16: out.color_space = 1; break;
    case 17: out.color_space = 2; break;
    case 18: out.color_space = 3; break;
    case 24: out.color_space = 4; break;
    case 12: out.color_space = 5; break;
    default: out.color_space = -1;
  }
}

void put_msg(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0) std::snprintf(msg, size_t(msg_len), "%s", s.c_str());
}

}  // namespace

extern "C" {

// Decodes a JP2 file or a raw codestream.  Returns a handle (free it with
// jp2dec_free) and *status 0; or null and *status 1 (OpenJPEG fails: a
// corrupt file) or 2 (refused: msg names what).
void* jp2dec_decode(const uint8_t* data, int64_t n, int* status, char* msg,
                    int msg_len) {
  auto out = std::make_unique<Decoded>();
  try {
    if (n >= 4 && data[0] == 0xff && data[1] == 0x4f) {
      Codestream cs;
      decode_codestream(data, size_t(n), cs);
      from_codestream(cs, *out);
      out->color_space = 0;
    } else {
      decode_jp2(data, size_t(n), *out);
    }
  } catch (const Failure& f) {
    *status = f.code;
    put_msg(f.msg, msg, msg_len);
    return nullptr;
  } catch (const std::exception& e) {  // out of memory, a size past max
    *status = 1;
    put_msg(e.what(), msg, msg_len);
    return nullptr;
  }
  *status = 0;
  return out.release();
}

// [number of components, colour space] then for each component
// [w, h, dx, dy, x0, y0, prec, sgnd, alpha]; returns the ints written.
int jp2dec_info(void* handle, int32_t* info, int cap) {
  const Decoded& d = *static_cast<Decoded*>(handle);
  const int need = 2 + 9 * int(d.comps.size());
  if (cap < need) return -need;
  info[0] = int32_t(d.comps.size());
  info[1] = d.color_space;
  for (size_t c = 0; c < d.comps.size(); ++c) {
    const auto& k = d.comps[c];
    int32_t* o = info + 2 + 9 * c;
    o[0] = k.w; o[1] = k.h; o[2] = k.dx; o[3] = k.dy; o[4] = k.x0;
    o[5] = k.y0; o[6] = k.prec; o[7] = k.sgnd; o[8] = k.alpha;
  }
  return need;
}

// Component `c`'s w*h samples into `out`.
void jp2dec_component(void* handle, int c, int32_t* out) {
  const Decoded& d = *static_cast<Decoded*>(handle);
  std::memcpy(out, d.comps[c].data.data(), d.comps[c].data.size() * 4);
}

void jp2dec_free(void* handle) { delete static_cast<Decoded*>(handle); }

}  // extern "C"
