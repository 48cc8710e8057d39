// TIFF pieces of the service's image codec (onnxocr_tpu_torch/utils/
// imcodec.py) that cv2.imdecode reaches through libtiff 4.7's
// TIFFReadRGBA*, on a machine without cv2:
//
// * CCITT bilevel decoding (tif_fax3.c): compression 2 (Modified Huffman
//   run lengths, each row byte-aligned), 3 (T.4, 1D or 2D by T4Options
//   bit 0, EOL codes and fill bits) and 4 (T.6). The decoder is libtiff's
//   step by step: its bit accumulator fed LSB-first through the bit
//   reversal table (FillOrder 1) or as read (FillOrder 2), its state
//   tables built from the T.4 code tables as mkg3states builds them, the
//   run arrays and their bounds, EXPAND1D / EXPAND2D / SYNC_EOL /
//   CLEANUP_RUNS, and its recovery: a bad code word or a premature EOL
//   ends the row, which is filled out white, and decoding goes on (T.4
//   resynchronises on the next EOL; T.6 repeats the failure); running out
//   of data fills the row and stops the strip. The rows are written as
//   _TIFFFax3fillruns writes them (black runs as 1 bits) into a buffer
//   the caller zeroes first, as libtiff's strip buffer is.
// * CIELab -> RGB (tif_color.c: TIFFCIELabToXYZ / TIFFCIELab16ToXYZ,
//   TIFFXYZToRGB with the sRGB display of tif_getimage.c and the
//   TIFFCIELabToRGBInit gamma tables), in libtiff's float arithmetic.
// * Deflate (tif_zip.c's ZIPDecode): zlib's inflate into the strip's
//   buffer, which keeps what zlib wrote before a fault, with libtiff's
//   verdicts (a zlib error, data that end before the output is full).
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2,
// linked with -lz

// no fused multiply-add: libtiff's colour arithmetic rounds each product
#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

// ------------------------------------------------------------ CCITT fax
enum State {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// A code as ITU-T T.4 writes it (first bit transmitted first) and its run
// length (or mode parameter).
struct Code {
  const char* bits;
  int param;
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
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63},
    {nullptr, 0}};

const Code kMakeUpW[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},
    {"0110111", 256},    {"00110110", 320},   {"00110111", 384},
    {"01100100", 448},   {"01100101", 512},   {"01101000", 576},
    {"01100111", 640},   {"011001100", 704},  {"011001101", 768},
    {"011010010", 832},  {"011010011", 896},  {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152},
    {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},    {"010011011", 1728},
    {nullptr, 0}};

const Code kTermB[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},
    {"10", 3},           {"011", 4},          {"0011", 5},
    {"0010", 6},         {"00011", 7},        {"000101", 8},
    {"000100", 9},       {"0000100", 10},     {"0000101", 11},
    {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},
    {"0000001000", 18},  {"00001100111", 19}, {"00001101000", 20},
    {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26},
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
    {"000001100111", 63}, {nullptr, 0}};

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
    {"0000001100100", 1664}, {"0000001100101", 1728}, {nullptr, 0}};

// the extended make-up codes of both colours
const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}, {nullptr, 0}};

// the 2D mode codes
const Code kPass[] = {{"0001", 0}, {nullptr, 0}};
const Code kHoriz[] = {{"001", 0}, {nullptr, 0}};
const Code kV0[] = {{"1", 0}, {nullptr, 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}, {nullptr, 0}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}, {nullptr, 0}};
const Code kExt[] = {{"0000001", 0}, {nullptr, 0}};
const Code kEOLV[] = {{"0000000", 0}, {nullptr, 0}};
const Code kEOLH[] = {{"00000000000", 0}, {nullptr, 0}};

// mkg3states' FillTable: every index whose low `len` bits are the code,
// read LSB-first, takes the entry
void fill_table(TabEnt* t, int size, const Code* codes, State st) {
  for (const Code* c = codes; c->bits; ++c) {
    const int len = static_cast<int>(std::strlen(c->bits));
    int code = 0;
    for (int i = 0; i < len; ++i)
      if (c->bits[i] == '1') code |= 1 << i;
    for (int k = code; k < (1 << size); k += 1 << len) {
      t[k].state = static_cast<uint8_t>(st);
      t[k].width = static_cast<uint8_t>(len);
      t[k].param = static_cast<uint32_t>(c->param);
    }
  }
}

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  uint8_t rev[256], same[256];
  Tables() {
    fill_table(main, 7, kPass, S_Pass);
    fill_table(main, 7, kHoriz, S_Horiz);
    fill_table(main, 7, kV0, S_V0);
    fill_table(main, 7, kVR, S_VR);
    fill_table(main, 7, kVL, S_VL);
    fill_table(main, 7, kExt, S_Ext);
    fill_table(main, 7, kEOLV, S_EOL);
    fill_table(white, 12, kMakeUpW, S_MakeUpW);
    fill_table(white, 12, kMakeUp, S_MakeUp);
    fill_table(white, 12, kTermW, S_TermW);
    fill_table(white, 12, kEOLH, S_EOL);
    fill_table(black, 13, kMakeUpB, S_MakeUpB);
    fill_table(black, 13, kMakeUp, S_MakeUp);
    fill_table(black, 13, kTermB, S_TermB);
    fill_table(black, 13, kEOLH, S_EOL);
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      rev[i] = static_cast<uint8_t>(r);
      same[i] = static_cast<uint8_t>(i);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; runs
// past the row are clipped in the run array itself, and an odd count gets
// a 0 appended (both change the reference line of a 2D row)
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                  0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (colour) *cp++ |= static_cast<uint8_t>(0xff >> bx);
          else *cp++ &= static_cast<uint8_t>(0xff << (8 - bx));
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        std::memset(cp, colour ? 0xff : 0x00, n);
        cp += n;
        if (run & 7) {
          if (colour) cp[0] |= static_cast<uint8_t>(0xff00 >> (run & 7));
          else cp[0] &= static_cast<uint8_t>(0xff >> (run & 7));
        }
      } else {
        if (colour) cp[0] |= static_cast<uint8_t>(masks[run] >> bx);
        else cp[0] &= static_cast<uint8_t>(~(masks[run] >> bx));
      }
      x += runs[colour];
    }
  }
}

enum Outcome { kRowDone, kEof, kAbort };
const int kNoEol = 1;  // the codec's FAXMODE_NOEOL

// One strip or tile of tif_fax3.c's decoders; the macros of tif_fax3.h are
// the methods below, over the same state.
struct Fax {
  const Tables& T = tables();
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* bitmap;
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  int a0 = 0, lastx = 0, run_length = 0, b1 = 0;
  uint32_t* runs = nullptr;
  const uint32_t* runs_lo = nullptr;  // the first entry a walk may read
  uint32_t nruns = 0;
  uint32_t *curruns = nullptr, *refruns = nullptr, *thisrun = nullptr,
           *pa = nullptr, *pb = nullptr;

  // NeedBits8 / NeedBits16: false where no valid bit is left (the
  // end-of-data label); past the end the accumulator is padded with zeros
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  const TabEnt* lookup8(int w, const TabEnt* tab) {
    if (!need8(w)) return nullptr;
    const TabEnt* e = tab + get(w);
    clr(e->width);
    return e;
  }
  const TabEnt* lookup16(int w, const TabEnt* tab) {
    if (!need16(w)) return nullptr;
    const TabEnt* e = tab + get(w);
    clr(e->width);
    return e;
  }
  void setvalue(uint32_t x) {
    *pa++ = static_cast<uint32_t>(run_length) + x;
    a0 = static_cast<int>(static_cast<uint32_t>(a0) + x);
    run_length = 0;
  }

  // SYNC_EOL: 0 at the end of the data before 11 zero bits, 1 past the
  // EOL. Where the data ends after the zeros, before the EOL's 1 bit,
  // libtiff takes the data for T.4 without EOLs ("Try to decode (read) fax
  // Group 3 data without EOL"): FAXMODE_NOEOL in the codec's mode, which
  // lasts for the rest of the image, and the row decoded again from the
  // start of the strip (2).
  int sync_eol(int& mode) {
    if (mode & kNoEol) return 1;
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return 0;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) {
        mode |= kNoEol;
        return 2;
      }
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
    return 1;
  }

  void cleanup_runs() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun)
        a0 = static_cast<int>(static_cast<uint32_t>(a0) - *--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(static_cast<uint32_t>(lastx - a0));
      } else if (a0 > lastx) {
        setvalue(static_cast<uint32_t>(lastx));
        setvalue(0);
      }
    }
  }

  // the run of one colour: make-up codes then a terminating code; false
  // on a code of another kind (0: end of data, 1: a bad code, 2: an EOL)
  int colour_run(bool black, bool allow_eol) {
    for (;;) {
      const TabEnt* e = black ? lookup16(13, T.black) : lookup16(12, T.white);
      if (!e) return 0;
      switch (e->state) {
        case S_TermW:
        case S_TermB:
          if ((e->state == S_TermB) != black) return 1;
          setvalue(e->param);
          return 3;
        case S_MakeUpW:
        case S_MakeUpB:
          if ((e->state == S_MakeUpB) != black) return 1;
          // fall through
        case S_MakeUp:
          a0 = static_cast<int>(static_cast<uint32_t>(a0) + e->param);
          run_length = static_cast<int>(static_cast<uint32_t>(run_length) +
                                        e->param);
          break;
        case S_EOL:
          if (allow_eol) return 2;
          return 1;
        default:
          return 1;
      }
    }
  }

  // EXPAND1D
  Outcome expand1d() {
    for (;;) {
      int r = colour_run(false, true);
      if (r == 0) goto eof1d;
      if (r == 2) {
        eolcnt = 1;
        goto done1d;
      }
      if (r == 1) goto done1d;
      if (a0 >= lastx) goto done1d;
      r = colour_run(true, true);
      if (r == 0) goto eof1d;
      if (r == 2) {
        eolcnt = 1;
        goto done1d;
      }
      if (r == 1) goto done1d;
      if (a0 >= lastx) goto done1d;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  eof1d:
    cleanup_runs();
    return kEof;
  done1d:
    cleanup_runs();
    return kRowDone;
  }

  // CHECK_b1: false on libtiff's "Buffer overflow" (the decode returns -1)
  bool check_b1() {
    if (pa != thisrun) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 = static_cast<int>(static_cast<uint32_t>(b1) + pb[0] + pb[1]);
        pb += 2;
      }
    }
    return true;
  }

  // EXPAND2D
  Outcome expand2d() {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kAbort;
      const TabEnt* e = lookup8(7, T.main);
      if (!e) goto eof2d;
      switch (e->state) {
        case S_Pass:
          if (!check_b1()) return kAbort;
          if (pb + 1 >= refruns + nruns) return kAbort;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          run_length = static_cast<int>(static_cast<uint32_t>(run_length) +
                                        static_cast<uint32_t>(b1 - a0));
          a0 = b1;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          break;
        case S_Horiz: {
          const bool black_first = (pa - thisrun) & 1;
          int r = colour_run(black_first, false);
          if (r == 0) goto eof2d;
          if (r != 3) goto eol2d;
          r = colour_run(!black_first, false);
          if (r == 0) goto eof2d;
          if (r != 3) goto eol2d;
          if (!check_b1()) return kAbort;
          break;
        }
        case S_V0:
          if (!check_b1()) return kAbort;
          setvalue(static_cast<uint32_t>(b1 - a0));
          if (pb >= refruns + nruns) return kAbort;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          break;
        case S_VR:
          if (!check_b1()) return kAbort;
          setvalue(static_cast<uint32_t>(b1 - a0) + e->param);
          if (pb >= refruns + nruns) return kAbort;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          break;
        case S_VL:
          if (!check_b1()) return kAbort;
          if (b1 < static_cast<int>(a0 + e->param)) goto eol2d;
          // a corrupt row's walk back past the allocation: libtiff reads
          // the heap there; the row ends here
          if (pb - 1 < runs_lo) goto eol2d;
          setvalue(static_cast<uint32_t>(b1 - a0) - e->param);
          b1 = static_cast<int>(static_cast<uint32_t>(b1) - *--pb);
          break;
        case S_Ext:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          goto eol2d;
        case S_EOL:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          if (!need8(4)) goto eof2d;
          clr(4);
          eolcnt = 1;
          goto eol2d;
        default:
          goto eol2d;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // expect a final V0
        if (!need8(1)) goto eof2d;
        if (!get(1)) goto eol2d;
        clr(1);
      }
      setvalue(0);
    }
  eol2d:
    cleanup_runs();
    return kRowDone;
  eof2d:
    cleanup_runs();
    return kEof;
  }
};

}  // namespace

extern "C" {

// One strip or tile of CCITT data (comp 2, 3 or 4; t4opts: T4Options;
// lsb_first: FillOrder 2) into `rows` rows of `rowbytes` bytes of `out`,
// `width` pixels each, as libtiff's decoder leaves its buffer: rows it
// reaches are written whole, the rest left as they were. What outlives a
// strip in libtiff's codec is the caller's, zeroed before the first strip:
// *mode, and `runs` (nruns_total entries: 8 of slack, the run arrays,
// whose stale entries a corrupt 2D row can read past its reference line,
// and 8 more). → 1 where
// the decoder succeeds, 0 where it fails (libtiff then still converts the
// buffer), -1 where libtiff refuses the layout before decoding.
int ocr_tiff_fax(const uint8_t* in, long long n, int comp, int t4opts,
                 int lsb_first, int width, long long rowbytes, int rows,
                 int* mode, uint32_t* runs, long long nruns_total,
                 uint8_t* out) try {
  if (width <= 0 || rowbytes < (width + 7LL) / 8 || rows < 0) return -1;
  Fax f;
  f.cp = in;
  f.ep = in + n;
  f.bitmap = lsb_first ? tables().same : tables().rev;
  const bool two_d = comp == 4 || (comp == 3 && (t4opts & 1));
  f.lastx = width;
  f.nruns = ((static_cast<uint32_t>(width) + 1 + 31) / 32) * 32;
  if (two_d) f.nruns *= 2;
  // libtiff allocates 2 * nruns entries; the slack past them takes the
  // writes its fill and cleanup can make one entry beyond a full array
  if (nruns_total < 2LL * f.nruns + 16) return -1;
  f.runs_lo = runs;
  f.runs = runs + 8;
  f.curruns = f.runs;
  if (two_d) {
    f.refruns = f.runs + f.nruns;
    f.refruns[0] = static_cast<uint32_t>(width);
    f.refruns[1] = 0;
  }
  for (int line = 0; line < rows; ++line) {
    uint8_t* buf = out + static_cast<size_t>(line) * rowbytes;
    f.a0 = 0;
    f.run_length = 0;
    f.thisrun = f.curruns;
    f.pa = f.thisrun;
    Outcome o;
    if (comp == 2) {                       // Fax3DecodeRLE
      o = f.expand1d();
      if (o == kEof) {
        fill_runs(buf, f.thisrun, f.pa, width);
        return 0;
      }
      fill_runs(buf, f.thisrun, f.pa, width);
      const int drop = f.avail - (f.avail & ~7);  // FAXMODE_BYTEALIGN
      f.clr(drop);
      continue;
    }
    if (comp == 3) {                       // Fax3Decode1D / Fax3Decode2D
      const int sync = f.sync_eol(*mode);
      if (sync == 0) {                     // EOF1D / EOF2D
        f.cleanup_runs();
        fill_runs(buf, f.thisrun, f.pa, width);
        return 0;
      }
      if (sync == 2) {                     // from the strip's first byte
        f.cp = in;
        f.acc = 0;
        f.avail = 0;
      }
      bool is1d = true;
      if (two_d) {
        if (!f.need8(1)) {
          f.cleanup_runs();
          fill_runs(buf, f.thisrun, f.pa, width);
          return 0;
        }
        is1d = f.get(1);
        f.clr(1);
        f.pb = f.refruns;
        f.b1 = static_cast<int>(*f.pb++);
      }
      o = is1d ? f.expand1d() : f.expand2d();
      if (o == kAbort) return 0;
      fill_runs(buf, f.thisrun, f.pa, width);
      if (o == kEof) return 0;
      if (two_d) {
        if (f.pa < f.thisrun + f.nruns) f.setvalue(0);
        std::swap(f.curruns, f.refruns);
      }
      continue;
    }
    // Fax4Decode
    f.pb = f.refruns;
    f.b1 = static_cast<int>(*f.pb++);
    o = f.expand2d();
    if (o == kAbort) return 0;
    if (o == kEof || f.eolcnt) {           // EOFG4
      f.need16(13);
      f.clr(13);
      fill_runs(buf, f.thisrun, f.pa, width);
      return line ? 1 : 0;
    }
    fill_runs(buf, f.thisrun, f.pa, width);
    if (f.pa < f.thisrun + f.nruns) f.setvalue(0);
    std::swap(f.curruns, f.refruns);
  }
  return 1;
} catch (...) {  // out of memory
  return -1;
}

// CIELab samples (chunky L, a, b: 8-bit with a, b signed, or 16-bit in
// host order with a, b signed) of n pixels into BGR, as TIFFReadRGBA
// converts them: putcontig8bitCIELab8 / 16 with the sRGB display and the
// reference white of WhitePoint (wx, wy).
int ocr_tiff_lab(const void* px, long long n, int bits16, float wx, float wy,
                 uint8_t* out) try {
  // tif_getimage.c's display_sRGB
  static const float mat[9] = {3.2410F,  -1.5374F, -0.4986F,
                               -0.9692F, 1.8760F,  0.0416F,
                               0.0556F,  -0.2040F, 1.0570F};
  const float YCR = 100.0F, Y0R = 1.0F, gamma = 2.4F;
  const uint32_t Vrw = 255;
  const int range = 1500;
  if (wy == 0.0F) return -1;  // "Invalid value for WhitePoint tag"
  float X0, Y0, Z0;
  {
    float ref1 = 100.0F;
    X0 = wx / wy * ref1;
    Y0 = ref1;
    Z0 = (1.0F - wx - wy) / wy * ref1;
  }
  // TIFFCIELabToRGBInit: the three guns share the display's values
  std::vector<float> Y2v(range + 1);
  const double dfGamma = 1.0 / gamma;
  const float step = (YCR - Y0R) / range;
  for (int i = 0; i <= range; ++i)
    Y2v[i] = Vrw * static_cast<float>(
                       std::pow(static_cast<double>(i) / range, dfGamma));
  auto rint_u = [](float r) {
    return static_cast<uint32_t>(r > 0 ? (r + 0.5) : (r - 0.5));
  };
  for (long long k = 0; k < n; ++k) {
    uint32_t l;
    int32_t a, b;
    if (bits16) {
      const uint16_t* p = static_cast<const uint16_t*>(px) + 3 * k;
      l = p[0];
      a = static_cast<int16_t>(p[1]);
      b = static_cast<int16_t>(p[2]);
    } else {
      const uint8_t* p = static_cast<const uint8_t*>(px) + 3 * k;
      l = static_cast<uint32_t>(p[0]) * 257;
      a = static_cast<int8_t>(p[1]) * 256;
      b = static_cast<int8_t>(p[2]) * 256;
    }
    // TIFFCIELab16ToXYZ
    float L = static_cast<float>(l) * 100.0F / 65535.0F;
    float X, Y, Z, cby, tmp;
    if (L < 8.856F) {
      Y = (L * Y0) / 903.292F;
      cby = 7.787F * (Y / Y0) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = Y0 * cby * cby * cby;
    }
    tmp = static_cast<float>(a) / 256.0F / 500.0F + cby;
    if (tmp < 0.2069F)
      X = X0 * (tmp - 0.13793F) / 7.787F;
    else
      X = X0 * tmp * tmp * tmp;
    tmp = cby - static_cast<float>(b) / 256.0F / 200.0F;
    if (tmp < 0.2069F)
      Z = Z0 * (tmp - 0.13793F) / 7.787F;
    else
      Z = Z0 * tmp * tmp * tmp;
    // TIFFXYZToRGB
    float Yc[3];
    for (int c = 0; c < 3; ++c) {
      float v = mat[3 * c] * X + mat[3 * c + 1] * Y + mat[3 * c + 2] * Z;
      v = v > Y0R ? v : Y0R;
      v = v < YCR ? v : YCR;
      Yc[c] = v;
    }
    uint8_t* o = out + 3 * k;
    for (int c = 0; c < 3; ++c) {
      int i = static_cast<int>((Yc[c] - Y0R) / step);
      i = std::min(range, i);
      uint32_t v = rint_u(Y2v[i]);
      v = std::min(v, Vrw);
      o[2 - c] = static_cast<uint8_t>(v);
    }
  }
  return 0;
} catch (...) {
  return -1;
}


// One Deflate strip or tile (compression 8 or 32946) as libtiff's
// ZIPDecode inflates it: `in` (n bytes) into out (`need` bytes, zeroed by
// the caller). → need, or -1 where libtiff fails, with what zlib wrote
// before the fault left in out. A fault fails the strip even with the
// output full (zlib decodes on until it needs room); data that run out
// fail it only when the output is short.
long long ocr_tiff_inflate(const uint8_t* in, long long n, uint8_t* out,
                           long long need) {
  z_stream s{};
  if (inflateInit(&s) != Z_OK) return -1;
  s.next_in = const_cast<Bytef*>(in);
  s.next_out = out;
  int state = Z_OK;
  do {
    const uInt in_before = uInt(std::min<long long>(n, 0xFFFFFFFFu));
    const uInt out_before = uInt(std::min<long long>(need, 0xFFFFFFFFu));
    s.avail_in = in_before;
    s.avail_out = out_before;
    state = inflate(&s, Z_PARTIAL_FLUSH);
    n -= in_before - s.avail_in;
    need -= out_before - s.avail_out;
  } while (state == Z_OK && need > 0);
  inflateEnd(&s);
  return (state == Z_OK || state == Z_STREAM_END) && need == 0
             ? (long long)(s.next_out - out)
             : -1;
}

}  // extern "C"
