// fax3 — CCITT bilevel TIFF strips (compressions 2, 3, 4 and 32771) with no
// library but the C++ standard library, decoded as libtiff 4.7's tif_fax3.c
// decodes them for OpenCV, damaged data included:
//   - Modified Huffman rows (CCITT RLE, 2: each row from a byte boundary;
//     RLEW, 32771: from a 16-bit boundary of the mapped file), Fax3DecodeRLE;
//   - T.4 one-dimensional rows after an EOL (Group 3, 3), Fax3Decode1D:
//     each row starts by scanning for eleven zero bits, skipping zero fill
//     and the EOL's one bit;
//   - T.4 two-dimensional rows, each after an EOL and its tag bit (Group 3
//     with T4Options bit 0), Fax3Decode2D;
//   - T.6 rows (Group 4), Fax4Decode, ending at an EOL or EOFB.
// The code tables are those libtiff's mkg3states generates: 7-bit (2D
// modes), 12-bit (white runs) and 13-bit (black runs) lookups indexed by
// the next bits, first bit lowest; an index no code fills decodes as a
// zero-width "bad code word".  Damage is read as libtiff reads it: a bad
// code word ends the row, which is cut or padded to its width with white
// ("Line length mismatch"), and G3 resynchronises at the next EOL; data
// that runs out is padded with zero bits while any remain, and the row in
// progress is then written and the strip fails.  A failed strip keeps the
// rows written (the rest of the zeroed buffer stays zero), as libtiff's
// RGBA reader keeps it for OpenCV.
//
// C ABI; Python binds it through ctypes (io/tiff.py).  Build:
//   g++ -O2 -fPIC -std=c++17 -shared -o libfax3dec.so fax3.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t State = S_Null;
  uint8_t Width = 0;
  uint32_t Param = 0;
};

// One code: its bits as written (first bit first), its run or parameter.
struct Code {
  const char* bits;
  uint32_t param;
};

const Code kTermW[] = {
    {"00110101", 0},  {"000111", 1},    {"0111", 2},      {"1000", 3},
    {"1011", 4},      {"1100", 5},      {"1110", 6},      {"1111", 7},
    {"10011", 8},     {"10100", 9},     {"00111", 10},    {"01000", 11},
    {"001000", 12},   {"000011", 13},   {"110100", 14},   {"110101", 15},
    {"101010", 16},   {"101011", 17},   {"0100111", 18},  {"0001100", 19},
    {"0001000", 20},  {"0010111", 21},  {"0000011", 22},  {"0000100", 23},
    {"0101000", 24},  {"0101011", 25},  {"0010011", 26},  {"0100100", 27},
    {"0011000", 28},  {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43},
    {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55},
    {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kMakeUpW[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},
    {"0110111", 256},    {"00110110", 320},   {"00110111", 384},
    {"01100100", 448},   {"01100101", 512},   {"01101000", 576},
    {"01100111", 640},   {"011001100", 704},  {"011001101", 768},
    {"011010010", 832},  {"011010011", 896},  {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152},
    {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},    {"010011011", 1728}};
const Code kTermB[] = {
    {"0000110111", 0},    {"010", 1},           {"11", 2},
    {"10", 3},            {"011", 4},           {"0011", 5},
    {"0010", 6},          {"00011", 7},         {"000101", 8},
    {"000100", 9},        {"0000100", 10},      {"0000101", 11},
    {"0000111", 12},      {"00000100", 13},     {"00000111", 14},
    {"000011000", 15},    {"0000010111", 16},   {"0000011000", 17},
    {"0000001000", 18},   {"00001100111", 19},  {"00001101000", 20},
    {"00001101100", 21},  {"00000110111", 22},  {"00000101000", 23},
    {"00000010111", 24},  {"00000011000", 25},  {"000011001010", 26},
    {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32},
    {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41},
    {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50},
    {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56},
    {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62},
    {"000001100111", 63}};
const Code kMakeUpB[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},  {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},  {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
// the extended make-up codes both colours share
const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// the 2D mode codes: vertical offsets as the parameter
const Code kPass[] = {{"0001", 0}};
const Code kHoriz[] = {{"001", 0}};
const Code kV0[] = {{"1", 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Code kExt[] = {{"0000001", 0}};
const Code kEolV[] = {{"0000000", 0}};   // seven zero bits, in the 2D table
const Code kEolH[] = {{"00000000000", 0}};  // eleven, in the run tables

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  // mkg3states FillTable: every index whose low bits are the code, first
  // bit lowest
  template <size_t N>
  static void fill(TabEnt* t, int size, const Code (&codes)[N], int state) {
    for (const Code& c : codes) {
      const int width = static_cast<int>(std::strlen(c.bits));
      int code = 0;
      for (int i = 0; i < width; ++i)
        if (c.bits[i] == '1') code |= 1 << i;
      for (int k = code; k < (1 << size); k += 1 << width)
        t[k] = {static_cast<uint8_t>(state), static_cast<uint8_t>(width),
                c.param};
    }
  }
  Tables() {
    fill(main, 7, kPass, S_Pass);
    fill(main, 7, kHoriz, S_Horiz);
    fill(main, 7, kV0, S_V0);
    fill(main, 7, kVR, S_VR);
    fill(main, 7, kVL, S_VL);
    fill(main, 7, kExt, S_Ext);
    fill(main, 7, kEolV, S_EOL);
    fill(white, 12, kMakeUpW, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    fill(white, 12, kTermW, S_TermW);
    fill(white, 12, kEolH, S_EOL);
    fill(black, 13, kMakeUpB, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    fill(black, 13, kTermB, S_TermB);
    fill(black, 13, kEolH, S_EOL);
  }
};
const Tables kTab;

// _TIFFFax3fillruns: white runs clear bits, black runs set them, first
// pixel in the high bit, each run cut at the row's width.
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      for (uint32_t i = x; i < x + run; ++i) {
        const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
        if (colour)
          buf[i >> 3] |= bit;
        else
          buf[i >> 3] &= static_cast<uint8_t>(~bit);
      }
      x += runs[colour];
    }
  }
}

enum Kind { kRle = 0, kRlew = 1, kG3 = 2, kG3_2D = 3, kG4 = 4 };

// One strip: `rows` rows of `rowbytes` bytes, `width` pixels, into `buf`
// (zeroed).  1: the strip decoded; 0: it failed.
int decode(const uint8_t* data, int64_t n, uint8_t* buf, int64_t rows,
           uint32_t width, int64_t rowbytes, int kind, bool lsb_first,
           int64_t file_offset, int* noeol_mode, uint32_t* runs) {
  // the decoder reads each byte's bits lowest first: FillOrder 1 data is
  // bit-reversed first (libtiff's TIFFBitRevTable)
  std::vector<uint8_t> raw(data, data + n);
  if (!lsb_first)
    for (auto& b : raw) {
      uint8_t r = 0;
      for (int i = 0; i < 8; ++i) r |= static_cast<uint8_t>(((b >> i) & 1) << (7 - i));
      b = r;
    }
  const uint8_t* const base = raw.data();
  const uint8_t* cp = base;
  const uint8_t* const ep = base + n;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  const int lastx = static_cast<int>(width);
  const bool refline = kind == kG3_2D || kind == kG4;
  uint32_t nruns = (width + 1 + 31) / 32 * 32;
  if (refline) nruns *= 2;
  // the run arrays last the whole file, as libtiff allocates them once:
  // a strip starts on a white reference row whose entries past the first
  // two are the last strip's
  uint32_t* curruns = runs;
  uint32_t* refruns = refline ? runs + nruns : nullptr;
  if (refruns) {
    refruns[0] = width;
    refruns[1] = 0;
  }
  int64_t occ = rows * rowbytes;
  int a0 = 0, RunLength = 0, b1 = 0;
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
  const TabEnt* TabEnt = nullptr;
  const int64_t start_line = 0;
  int64_t line = 0;
  int is1D = 0;

#define EndOfData() (cp >= ep)
#define NeedBits8(nb, eoflab)                                   \
  do {                                                          \
    if (BitsAvail < (nb)) {                                     \
      if (EndOfData()) {                                        \
        if (BitsAvail == 0) goto eoflab;                        \
        BitsAvail = (nb);                                       \
      } else {                                                  \
        BitAcc |= static_cast<uint32_t>(*cp++) << BitsAvail;    \
        BitsAvail += 8;                                         \
      }                                                         \
    }                                                           \
  } while (0)
#define NeedBits16(nb, eoflab)                                  \
  do {                                                          \
    if (BitsAvail < (nb)) {                                     \
      if (EndOfData()) {                                        \
        if (BitsAvail == 0) goto eoflab;                        \
        BitsAvail = (nb);                                       \
      } else {                                                  \
        BitAcc |= static_cast<uint32_t>(*cp++) << BitsAvail;    \
        if ((BitsAvail += 8) < (nb)) {                          \
          if (EndOfData()) {                                    \
            BitsAvail = (nb);                                   \
          } else {                                              \
            BitAcc |= static_cast<uint32_t>(*cp++) << BitsAvail; \
            BitsAvail += 8;                                     \
          }                                                     \
        }                                                       \
      }                                                         \
    }                                                           \
  } while (0)
#define GetBits(nb) (BitAcc & ((1u << (nb)) - 1))
#define ClrBits(nb)      \
  do {                   \
    BitsAvail -= (nb);   \
    BitAcc >>= (nb);     \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)       \
  do {                                  \
    NeedBits8(wid, eoflab);             \
    TabEnt = (tab) + GetBits(wid);      \
    ClrBits(TabEnt->Width);             \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)      \
  do {                                  \
    NeedBits16(wid, eoflab);            \
    TabEnt = (tab) + GetBits(wid);      \
    ClrBits(TabEnt->Width);             \
  } while (0)
  // a run appended to the row, or the strip fails ("Buffer overflow")
#define SETVALUE(x)                                             \
  do {                                                          \
    if (pa >= thisrun + nruns) return 0;                        \
    *pa++ = static_cast<uint32_t>(RunLength + (x));             \
    a0 += (x);                                                  \
    RunLength = 0;                                              \
  } while (0)
  // the row's runs cut or padded with white to its width
#define CLEANUP_RUNS()                                          \
  do {                                                          \
    if (RunLength) SETVALUE(0);                                 \
    if (a0 != lastx) {                                          \
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;           \
      if (a0 < lastx) {                                         \
        if (a0 < 0) a0 = 0;                                     \
        if ((pa - thisrun) & 1) SETVALUE(0);                    \
        SETVALUE(lastx - a0);                                   \
      } else if (a0 > lastx) {                                  \
        SETVALUE(lastx);                                        \
        SETVALUE(0);                                            \
      }                                                         \
    }                                                           \
  } while (0)
  // scan for an EOL (unless one was just read), skip zero fill and take
  // the EOL's one bit
#define SYNC_EOL(eoflab)                                        \
  do {                                                          \
    if (EOLcnt == 0) {                                          \
      for (;;) {                                                \
        NeedBits16(11, eoflab);                                 \
        if (GetBits(11) == 0) break;                            \
        ClrBits(1);                                             \
      }                                                         \
    }                                                           \
    for (;;) {                                                  \
      NeedBits8(8, eoflab);                                     \
      if (GetBits(8)) break;                                    \
      ClrBits(8);                                               \
    }                                                           \
    while (GetBits(1) == 0) ClrBits(1);                         \
    ClrBits(1);                                                 \
    EOLcnt = 0;                                                 \
  } while (0)
#define CHECK_b1                                                \
  do {                                                          \
    if (pa != thisrun)                                          \
      while (b1 <= a0 && b1 < lastx) {                          \
        if (pb + 1 >= refruns + nruns) return 0;                \
        b1 += pb[0] + pb[1];                                    \
        pb += 2;                                                \
      }                                                         \
  } while (0)
#define EXPAND1D(eoflab)                                        \
  do {                                                          \
    for (;;) {                                                  \
      for (;;) {                                                \
        LOOKUP16(12, kTab.white, eof1d_##eoflab);               \
        switch (TabEnt->State) {                                \
          case S_EOL:                                           \
            EOLcnt = 1;                                         \
            goto done1d_##eoflab;                               \
          case S_TermW:                                         \
            SETVALUE(static_cast<int>(TabEnt->Param));          \
            goto doneWhite1d_##eoflab;                          \
          case S_MakeUpW:                                       \
          case S_MakeUp:                                        \
            a0 += TabEnt->Param;                                \
            RunLength += TabEnt->Param;                         \
            break;                                              \
          default:                                              \
            goto done1d_##eoflab;                               \
        }                                                       \
      }                                                         \
    doneWhite1d_##eoflab:                                       \
      if (a0 >= lastx) goto done1d_##eoflab;                    \
      for (;;) {                                                \
        LOOKUP16(13, kTab.black, eof1d_##eoflab);               \
        switch (TabEnt->State) {                                \
          case S_EOL:                                           \
            EOLcnt = 1;                                         \
            goto done1d_##eoflab;                               \
          case S_TermB:                                         \
            SETVALUE(static_cast<int>(TabEnt->Param));          \
            goto doneBlack1d_##eoflab;                          \
          case S_MakeUpB:                                       \
          case S_MakeUp:                                        \
            a0 += TabEnt->Param;                                \
            RunLength += TabEnt->Param;                         \
            break;                                              \
          default:                                              \
            goto done1d_##eoflab;                               \
        }                                                       \
      }                                                         \
    doneBlack1d_##eoflab:                                       \
      if (a0 >= lastx) goto done1d_##eoflab;                    \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;            \
    }                                                           \
  eof1d_##eoflab:                                               \
    CLEANUP_RUNS();                                             \
    goto eoflab;                                                \
  done1d_##eoflab:                                              \
    CLEANUP_RUNS();                                             \
  } while (0)
#define EXPAND2D(eoflab)                                        \
  do {                                                          \
    while (a0 < lastx) {                                        \
      if (pa >= thisrun + nruns) return 0;                      \
      LOOKUP8(7, kTab.main, eof2d_##eoflab);                    \
      switch (TabEnt->State) {                                  \
        case S_Pass:                                            \
          CHECK_b1;                                             \
          if (pb + 1 >= refruns + nruns + 2) return 0;          \
          b1 += *pb++;                                          \
          RunLength += b1 - a0;                                 \
          a0 = b1;                                              \
          b1 += *pb++;                                          \
          break;                                                \
        case S_Horiz:                                           \
          if ((pa - thisrun) & 1) {                             \
            for (;;) {                                          \
              LOOKUP16(13, kTab.black, eof2d_##eoflab);         \
              switch (TabEnt->State) {                          \
                case S_TermB:                                   \
                  SETVALUE(static_cast<int>(TabEnt->Param));    \
                  goto doneWhite2da_##eoflab;                   \
                case S_MakeUpB:                                 \
                case S_MakeUp:                                  \
                  a0 += TabEnt->Param;                          \
                  RunLength += TabEnt->Param;                   \
                  break;                                        \
                default:                                        \
                  goto eol2d_##eoflab;                          \
              }                                                 \
            }                                                   \
          doneWhite2da_##eoflab:;                               \
            for (;;) {                                          \
              LOOKUP16(12, kTab.white, eof2d_##eoflab);         \
              switch (TabEnt->State) {                          \
                case S_TermW:                                   \
                  SETVALUE(static_cast<int>(TabEnt->Param));    \
                  goto doneBlack2da_##eoflab;                   \
                case S_MakeUpW:                                 \
                case S_MakeUp:                                  \
                  a0 += TabEnt->Param;                          \
                  RunLength += TabEnt->Param;                   \
                  break;                                        \
                default:                                        \
                  goto eol2d_##eoflab;                          \
              }                                                 \
            }                                                   \
          doneBlack2da_##eoflab:;                               \
          } else {                                              \
            for (;;) {                                          \
              LOOKUP16(12, kTab.white, eof2d_##eoflab);         \
              switch (TabEnt->State) {                          \
                case S_TermW:                                   \
                  SETVALUE(static_cast<int>(TabEnt->Param));    \
                  goto doneWhite2db_##eoflab;                   \
                case S_MakeUpW:                                 \
                case S_MakeUp:                                  \
                  a0 += TabEnt->Param;                          \
                  RunLength += TabEnt->Param;                   \
                  break;                                        \
                default:                                        \
                  goto eol2d_##eoflab;                          \
              }                                                 \
            }                                                   \
          doneWhite2db_##eoflab:;                               \
            for (;;) {                                          \
              LOOKUP16(13, kTab.black, eof2d_##eoflab);         \
              switch (TabEnt->State) {                          \
                case S_TermB:                                   \
                  SETVALUE(static_cast<int>(TabEnt->Param));    \
                  goto doneBlack2db_##eoflab;                   \
                case S_MakeUpB:                                 \
                case S_MakeUp:                                  \
                  a0 += TabEnt->Param;                          \
                  RunLength += TabEnt->Param;                   \
                  break;                                        \
                default:                                        \
                  goto eol2d_##eoflab;                          \
              }                                                 \
            }                                                   \
          doneBlack2db_##eoflab:;                               \
          }                                                     \
          CHECK_b1;                                             \
          break;                                                \
        case S_V0:                                              \
          CHECK_b1;                                             \
          SETVALUE(b1 - a0);                                    \
          if (pb >= refruns + nruns + 2) return 0;              \
          b1 += *pb++;                                          \
          break;                                                \
        case S_VR:                                              \
          CHECK_b1;                                             \
          SETVALUE(b1 - a0 + static_cast<int>(TabEnt->Param));  \
          if (pb >= refruns + nruns + 2) return 0;              \
          b1 += *pb++;                                          \
          break;                                                \
        case S_VL:                                              \
          CHECK_b1;                                             \
          if (b1 < static_cast<int>(a0 + TabEnt->Param))        \
            goto eol2d_##eoflab;                                \
          SETVALUE(b1 - a0 - static_cast<int>(TabEnt->Param));  \
          b1 -= *--pb;                                          \
          break;                                                \
        case S_Ext:                                             \
          *pa++ = static_cast<uint32_t>(lastx - a0);            \
          goto eol2d_##eoflab;                                  \
        case S_EOL:                                             \
          *pa++ = static_cast<uint32_t>(lastx - a0);            \
          NeedBits8(4, eof2d_##eoflab);                         \
          ClrBits(4);                                           \
          EOLcnt = 1;                                           \
          goto eol2d_##eoflab;                                  \
        default:                                                \
          goto eol2d_##eoflab;                                  \
      }                                                         \
    }                                                           \
    if (RunLength) {                                            \
      if (RunLength + a0 < lastx) {                             \
        NeedBits8(1, eof2d_##eoflab);                           \
        if (!GetBits(1)) goto eol2d_##eoflab;                   \
        ClrBits(1);                                             \
      }                                                         \
      SETVALUE(0);                                              \
    }                                                           \
    goto eol2d_##eoflab;                                        \
  eof2d_##eoflab:                                               \
    CLEANUP_RUNS();                                             \
    goto eoflab;                                                \
  eol2d_##eoflab:                                               \
    CLEANUP_RUNS();                                             \
  } while (0)

  if (kind == kRle || kind == kRlew) {
    thisrun = curruns;
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      EXPAND1D(EOFRLE);
      fill_runs(buf, thisrun, pa, width);
      {  // to the next byte (or 16-bit word) of the data
        const int drop = BitsAvail & (kind == kRle ? 7 : 15);
        ClrBits(drop);
        // isAligned(cp, uint16_t): the mapped file's address parity
        if (kind == kRlew && BitsAvail == 0 &&
            ((file_offset + (cp - base)) & 1))
          cp++;
      }
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOFRLE:
      fill_runs(buf, thisrun, pa, width);
      return 0;
    }
    return 1;
  }
  // Group 3.  A strip whose data runs out while an EOL is sought is read
  // again from its start as Group 3 data without EOLs (libtiff 4.7: "Try
  // to decode (read) fax Group 3 data without EOL"), from the row it had
  // reached: each row then its tag bit (2D) and codes, no EOL sought; data
  // that runs out again ends the strip, which counts as read.  libtiff
  // keeps that mode for the file's later strips (`noeol_mode`).
  bool noeol = *noeol_mode != 0;
  if (kind == kG3) {
    thisrun = curruns;
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      if (noeol) {
        EXPAND1D(EOF1Dn);
      } else {
        SYNC_EOL(EOF1D);
        EXPAND1D(EOF1Da);
      }
      fill_runs(buf, thisrun, pa, width);
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOF1D:
      noeol = true;
      *noeol_mode = 1;
      cp = base;
      BitAcc = 0;
      BitsAvail = 0;
      EOLcnt = 0;
      continue;
    EOF1Dn:
      fill_runs(buf, thisrun, pa, width);
      return 1;
    EOF1Da:
      fill_runs(buf, thisrun, pa, width);
      return 0;
    }
    return 1;
  }
  if (kind == kG3_2D) {
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      if (noeol) {
        NeedBits8(1, EOF2Dt);
      } else {
        SYNC_EOL(EOF2D);
        NeedBits8(1, EOF2D);
      }
      is1D = static_cast<int>(GetBits(1));
      ClrBits(1);
      pb = refruns;
      b1 = static_cast<int>(*pb++);
      if (noeol) {
        if (is1D)
          EXPAND1D(EOF2Dn);
        else
          EXPAND2D(EOF2Dn);
      } else {
        if (is1D)
          EXPAND1D(EOF2Da);
        else
          EXPAND2D(EOF2Da);
      }
      fill_runs(buf, thisrun, pa, width);
      if (pa < thisrun + nruns) SETVALUE(0);
      std::swap(curruns, refruns);
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOF2D:
      if (!noeol) {
        noeol = true;
        *noeol_mode = 1;
        cp = base;
        BitAcc = 0;
        BitsAvail = 0;
        EOLcnt = 0;
        continue;
      }
    EOF2Dt:
      CLEANUP_RUNS();
    EOF2Dn:
      fill_runs(buf, thisrun, pa, width);
      return 1;
    EOF2Da:
      fill_runs(buf, thisrun, pa, width);
      return 0;
    }
    return 1;
  }
  // Group 4
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = static_cast<int>(*pb++);
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    if (((lastx + 7) >> 3) > occ) return 0;
    fill_runs(buf, thisrun, pa, width);
    SETVALUE(0);
    std::swap(curruns, refruns);
    buf += rowbytes;
    occ -= rowbytes;
    ++line;
    continue;
  EOFG4:
    NeedBits16(13, BADG4);
  BADG4:
    ClrBits(13);
    if (((lastx + 7) >> 3) > occ) return 0;
    fill_runs(buf, thisrun, pa, width);
    return line != start_line;   // a badly terminated strip is no error
  }
  return 1;
#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef CLEANUP_RUNS
#undef SYNC_EOL
#undef CHECK_b1
#undef EXPAND1D
#undef EXPAND2D
}

}  // namespace

extern "C" {

// One CCITT strip or tile `in` (n bytes, at `file_offset` in the file) into
// `out` (zeroed, rows x rowbytes): `kind` 0 RLE (2), 1 RLEW (32771), 2 G3
// 1D, 3 G3 2D (3), 4 G4 (4); `lsb_first` for FillOrder 2; `noeol_mode`
// the file's Group 3 without-EOL mode, 0 for its first strip, carried from
// strip to strip; `runs` the file's run arrays (fax_runs_size entries,
// zeroed for its first strip), carried too.  1: decoded; 0: libtiff's
// decoder fails (the rows written stay).
int fax_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t rows,
               int32_t width, int64_t rowbytes, int kind, int lsb_first,
               int64_t file_offset, int* noeol_mode, uint32_t* runs) {
  if (width <= 0 || rowbytes < (int64_t(width) + 7) / 8) return 0;
  return decode(in, n, out, rows, static_cast<uint32_t>(width), rowbytes,
                kind, lsb_first != 0, file_offset, noeol_mode, runs);
}

// Entries of the run arrays fax_decode needs for rows of `width` pixels.
int64_t fax_runs_size(int32_t width) {
  return 4 * ((int64_t(width) + 1 + 31) / 32 * 32);
}

}  // extern "C"
