// Host image codec of the service (onnxocr_tpu_torch/utils/imcodec.py):
// the parts of cv2.imdecode / cv2.imencode that the HTTP routes and the
// crop writer need, on a machine without cv2 or PIL.
//
// * PNG: unfiltering (None, Sub, Up, Average, Paeth) and Adam7
//   de-interlacing of the inflated stream (zlib inflates in Python); every
//   bit depth, 16-bit samples reduced to their high byte as cv2 does.
// * JPEG decoder: baseline and progressive Huffman, 8-bit, 1, 3 or 4
//   components (4: CMYK, or YCCK under an Adobe transform 2, both to CMYK
//   as libjpeg converts them), any integral sampling factors, restart
//   intervals. It
//   computes what libjpeg-turbo computes at cv2's settings: the integer
//   "islow" IDCT, "fancy" triangular chroma upsampling (h2v1, h1v2, h2v2;
//   replication otherwise) and the fixed-point YCbCr -> BGR tables. Its
//   Huffman tables are checked as libjpeg checks them, before use.
// * JPEG encoder: baseline 4:2:0 with the Annex K tables scaled for the
//   quality as libjpeg scales them, libjpeg-turbo's fixed-point BGR ->
//   YCbCr, h2v2 downsampling, "islow" forward DCT, reciprocal
//   quantization and the standard Huffman tables.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries so that a corrupt run past 63 lands on 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int fix16(double x) { return static_cast<int>(x * 65536.0 + 0.5); }

// ---------------------------------------------------------------- PNG
inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Unfilter h rows of `stride` bytes (each preceded by its filter byte)
// from src into rows; false on a bad filter type.
bool unfilter(const uint8_t* src, int h, size_t stride, int bpp,
              std::vector<uint8_t>& rows) {
  rows.assign(static_cast<size_t>(h) * stride, 0);
  std::vector<uint8_t> zero(stride, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * (stride + 1);
    int ftype = in[0];
    ++in;
    uint8_t* cur = &rows[static_cast<size_t>(y) * stride];
    const uint8_t* prev = y ? cur - stride : zero.data();
    const size_t head = std::min(static_cast<size_t>(bpp), stride);
    switch (ftype) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 1:
        std::memcpy(cur, in, head);
        for (size_t i = head; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < head; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (prev[i] >> 1));
        for (size_t i = head; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + ((cur[i - bpp] + prev[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < head; ++i)  // left and upper-left are 0
          cur[i] = static_cast<uint8_t>(in[i] + prev[i]);
        for (size_t i = head; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(
              in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        break;
      default:
        return false;
    }
  }
  return true;
}

// sample `c` of pixel `x` of an unfiltered row, 16-bit to its high byte
inline uint8_t png_sample(const uint8_t* row, size_t x, int c, int ch,
                          int depth) {
  if (depth == 8) return row[x * ch + c];
  if (depth == 16) return row[(x * ch + c) * 2];
  size_t bit = x * depth;  // depth < 8: one channel
  int shift = 8 - depth - (bit & 7);
  return static_cast<uint8_t>((row[bit >> 3] >> shift) & ((1 << depth) - 1));
}

// The standard Huffman tables (Annex K.3): the encoder's, and the
// decoder's for a scan whose table 0 or 1 no DHT defined (libjpeg-turbo's
// jpeg_std_huff_table, for Motion-JPEG frames)
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------- JPEG decode
struct Huff {
  bool defined = false;  // a DHT segment (or the standard table) gave it
  bool present = false;  // defined and accepted
  uint8_t vals[256];
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t fast_len[512];  // 9-bit lookahead: code length (0: slow path)
  uint8_t fast_val[512];
};

// A decoding table from a DHT segment's counts and values, left absent
// (present false) where libjpeg's jdhuff.c refuses it: a code that does
// not fit its length (the all-ones code included) or a DC category above
// 15. Each code is checked before it is entered, so the lookahead tables
// are never written out of range.
void build_huff(Huff& t, const uint8_t* bits, const uint8_t* vals, int n,
                bool is_dc) {
  t.defined = true;
  t.present = false;
  if (n > 256) return;
  if (is_dc)
    for (int i = 0; i < n; ++i)
      if (vals[i] > 15) return;
  std::memcpy(t.vals, vals, n);
  std::memset(t.fast_len, 0, sizeof(t.fast_len));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valptr[len] = k;
    t.mincode[len] = code;
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      if (code >= (1 << len) - 1) return;  // over-subscribed
      if (len <= 9) {
        int lo = code << (9 - len), cnt = 1 << (9 - len);
        for (int j = 0; j < cnt; ++j) {
          t.fast_len[lo + j] = static_cast<uint8_t>(len);
          t.fast_val[lo + j] = vals[k];
        }
      }
    }
    t.maxcode[len] = bits[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.present = true;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;        // blocks of the component's own samples
  int abw = 0, abh = 0;      // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;        // downsampled width and height
  std::vector<int16_t> coef;  // abh * abw * 64, natural order
  int dc_pred = 0;
};

struct Bits {
  const uint8_t* data;
  size_t size, pos;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;   // a marker (or the end) stops the data
  bool truncated = false;   // the buffer ended inside entropy data
  bool short_data = false;  // bits were needed past the marker

  void fill() {
    while (nbits <= 56 && !at_marker) {
      if (pos >= size) {
        at_marker = true;
        truncated = true;
        break;
      }
      uint8_t b = data[pos];
      if (b == 0xFF) {
        size_t p = pos + 1;
        while (p < size && data[p] == 0xFF) ++p;
        if (p >= size) {
          at_marker = true;
          truncated = true;
          break;
        }
        if (data[p] != 0) {  // a marker: leave pos on its 0xFF
          pos = p - 1;
          at_marker = true;
          break;
        }
        pos = p + 1;
      } else {
        ++pos;
      }
      buf |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (nbits < n) fill();
    if (nbits < n) short_data = true;
    int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    nbits = std::max(0, nbits - n);
    return v;
  }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    if (nbits < n) short_data = true;
    buf <<= n;
    nbits = std::max(0, nbits - n);
  }
  int decode(const Huff& t) {
    int look = peek(9);
    int len = t.fast_len[look];
    if (len) {
      skip(len);
      return t.fast_val[look];
    }
    int code = peek(16);
    for (int l = 10; l <= 16; ++l) {
      int c = code >> (16 - l);
      if (c <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valptr[l] + c - t.mincode[l]];
      }
    }
    skip(16);  // libjpeg: a bad code decodes as 0
    get(1);
    return 0;
  }
  void align() {  // a restart drops the rest of the byte-padded segment
    buf = 0;
    nbits = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 2;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, have_frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Comp comp[4];
  bool done = false;

  int u16(size_t p) const { return (data[p] << 8) | data[p + 1]; }

  // the next marker code at or after pos (skipping stray bytes and fill),
  // pos moved past it; -1 at the end of the buffer
  int next_marker() {
    while (pos < size && data[pos] != 0xFF) ++pos;
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) return -1;
    return data[pos++];
  }

  bool read_sof(size_t p, size_t n, int marker) {
    if (have_frame || n < 6) return false;
    if (data[p] != 8) return false;  // 12-bit samples are not read
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = data[p + 5];
    if (width == 0 || height == 0) return false;
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return false;
    if (n < 6 + 3u * ncomp) return false;
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.id = data[p + 6 + 3 * i];
      c.h = data[p + 7 + 3 * i] >> 4;
      c.v = data[p + 7 + 3 * i] & 15;
      c.tq = data[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return false;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) return false;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.abw = mcux * c.h;
      c.abh = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.abw) * c.abh * 64, 0);
    }
    have_frame = true;
    return true;
  }

  bool read_dqt(size_t p, size_t n) {
    size_t end = p + n;
    while (p < end) {
      int pq = data[p] >> 4, tq = data[p] & 15;
      ++p;
      if (tq > 3 || pq > 1 || p + (pq ? 128 : 64) > end) return false;
      for (int k = 0; k < 64; ++k) {
        qt[tq][kNatural[k]] =
            static_cast<uint16_t>(pq ? u16(p + 2 * k) : data[p + k]);
      }
      p += pq ? 128 : 64;
      qt_present[tq] = true;
    }
    return true;
  }

  bool read_dht(size_t p, size_t n) {
    size_t end = p + n;
    while (p < end) {
      if (p + 17 > end) return false;
      int tc = data[p] >> 4, th = data[p] & 15;
      if (tc > 1 || th > 3) return false;
      const uint8_t* bits = data + p + 1;
      int count = 0;
      for (int i = 0; i < 16; ++i) count += bits[i];
      if (count > 256 || p + 17 + count > end) return false;
      // a table jdhuff.c refuses stays absent: libjpeg builds tables when
      // a scan uses them, so only a scan that uses it fails
      build_huff(tc ? ac[th] : dc[th], bits, data + p + 17, count, tc == 0);
      p += 17 + count;
    }
    return true;
  }

  int16_t* block(Comp& c, int by, int bx) {
    return &c.coef[(static_cast<size_t>(by) * c.abw + bx) * 64];
  }

  // whether a scan can decode with table `no`: one a DHT gave and
  // jdhuff.c accepts, or else the standard table 0 or 1
  static bool usable(Huff* tables, int no, bool is_dc) {
    Huff& t = tables[no];
    if (!t.defined && no <= 1) {
      const uint8_t* bits = is_dc ? (no ? kDcChromaBits : kDcLumaBits)
                                  : (no ? kAcChromaBits : kAcLumaBits);
      const uint8_t* vals = is_dc ? kDcVals
                                  : (no ? kAcChromaVals : kAcLumaVals);
      build_huff(t, bits, vals, is_dc ? 12 : 162, is_dc);
    }
    return t.present;
  }

  // one scan; pos is past the SOS header
  bool read_scan(const int* ids, int ns, int ss, int se, int ah, int al) {
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) sc[i] = &comp[ids[i]];
    if (progressive) {
      bool dcband = ss == 0;
      if (dcband ? se != 0 : (ss > se || se > 63 || ns != 1)) return false;
      if ((ah != 0 && al != ah - 1) || al > 13) return false;
    }
    for (int i = 0; i < ns; ++i) {
      if (!qt_present[sc[i]->tq]) return false;
      bool need_dc = !progressive || ss == 0;
      bool need_ac = !progressive ? true : ss > 0;
      if (progressive && ss == 0 && ah != 0) need_dc = false;
      if (need_dc && !usable(dc, sc[i]->td, true)) return false;
      if (need_ac && !usable(ac, sc[i]->ta, false)) return false;
      sc[i]->dc_pred = 0;
    }
    Bits br{data, size, pos};
    int eobrun = 0;
    long long total;
    int mw;
    if (ns == 1) {
      mw = sc[0]->bw;
      total = static_cast<long long>(sc[0]->bw) * sc[0]->bh;
    } else {
      mw = mcux;
      total = static_cast<long long>(mcux) * mcuy;
    }
    bool halted = false;  // out of data until the next restart
    for (long long m = 0; m < total; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        br.align();
        // the expected restart marker, or resynchronise on the next one
        if (!br.at_marker) {
          size_t p = br.pos;
          while (p + 1 < size && !(data[p] == 0xFF && data[p + 1] != 0 &&
                                   data[p + 1] != 0xFF))
            ++p;
          br.pos = p;
          br.at_marker = true;
          if (p + 1 >= size) return false;
        }
        size_t p = br.pos;
        while (p < size && data[p] == 0xFF) ++p;
        if (p >= size) return false;
        int mk = data[p];
        if (mk >= 0xD0 && mk <= 0xD7) {
          br.pos = p + 1;
          br.at_marker = false;
          halted = false;
        } else {
          halted = true;
        }
        br.short_data = false;
        eobrun = 0;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      }
      int my = static_cast<int>(m / mw), mx = static_cast<int>(m % mw);
      if (halted || br.short_data) continue;
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
        for (int yy = 0; yy < nv; ++yy) {
          for (int xx = 0; xx < nh; ++xx) {
            int by = ns == 1 ? my : my * c.v + yy;
            int bx = ns == 1 ? mx : mx * c.h + xx;
            int16_t* b = block(c, by, bx);
            if (!progressive) {
              int s = br.decode(dc[c.td]);
              int d = s ? extend(br.get(s), s) : 0;
              c.dc_pred += d;
              b[0] = static_cast<int16_t>(c.dc_pred);
              const Huff& t = ac[c.ta];
              for (int k = 1; k < 64; ++k) {
                int rs = br.decode(t);
                int r = rs >> 4;
                s = rs & 15;
                if (s) {
                  k += r;
                  b[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
                } else {
                  if (r != 15) break;
                  k += 15;
                }
              }
            } else if (ss == 0) {
              if (ah == 0) {
                int s = br.decode(dc[c.td]);
                int d = s ? extend(br.get(s), s) : 0;
                c.dc_pred += d;
                b[0] = static_cast<int16_t>(
                    static_cast<uint32_t>(c.dc_pred) << al);
              } else if (br.get(1)) {
                b[0] = static_cast<int16_t>(b[0] | (1 << al));
              }
            } else if (ah == 0) {
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              const Huff& t = ac[c.ta];
              for (int k = ss; k <= se; ++k) {
                int rs = br.decode(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  k += r;
                  b[kNatural[k]] = static_cast<int16_t>(
                      static_cast<uint32_t>(extend(br.get(s), s)) << al);
                } else {
                  if (r < 15) {
                    eobrun = (1 << r) - 1;
                    if (r) eobrun += br.get(r);
                    break;
                  }
                  k += 15;
                }
              }
            } else {
              int p1 = 1 << al, m1 = -1 * (1 << al);
              int k = ss;
              const Huff& t = ac[c.ta];
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = br.decode(t);
                  int r = rs >> 4, s = rs & 15;
                  if (s) {
                    s = br.get(1) ? p1 : m1;
                  } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                  }
                  do {
                    int16_t* co = b + kNatural[k];
                    if (*co != 0) {
                      if (br.get(1) && (*co & p1) == 0)
                        *co = static_cast<int16_t>(*co >= 0 ? *co + p1
                                                            : *co + m1);
                    } else {
                      if (--r < 0) break;
                    }
                    ++k;
                  } while (k <= se);
                  if (s) b[kNatural[k]] = static_cast<int16_t>(s);
                }
              }
              if (eobrun > 0) {
                for (; k <= se; ++k) {
                  int16_t* co = b + kNatural[k];
                  if (*co != 0 && br.get(1) && (*co & p1) == 0)
                    *co = static_cast<int16_t>(*co >= 0 ? *co + p1 : *co + m1);
                }
                --eobrun;
              }
            }
          }
        }
      }
      if (br.truncated) return false;
    }
    if (br.truncated) return false;
    // continue the marker loop at the marker that ended the data
    pos = br.pos;
    return true;
  }

  bool read_sos(size_t p, size_t n) {
    if (!have_frame || n < 1) return false;
    int ns = data[p];
    if (ns < 1 || ns > 4 || n < 4 + 2u * ns) return false;
    int ids[4];
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      int cid = data[p + 1 + 2 * i];
      int k = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) k = j;
      if (k < 0) return false;
      ids[i] = k;
      comp[k].td = data[p + 2 + 2 * i] >> 4;
      comp[k].ta = data[p + 2 + 2 * i] & 15;
      if (comp[k].td > 3 || comp[k].ta > 3) return false;
      blocks += comp[k].h * comp[k].v;
    }
    if (ns > 1 && blocks > 10) return false;
    size_t q = p + 1 + 2 * ns;
    int ss = data[q], se = data[q + 1], ah = data[q + 2] >> 4,
        al = data[q + 2] & 15;
    pos = p + n;
    return read_scan(ids, ns, ss, se, ah, al);
  }

  bool parse() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return false;
    for (;;) {
      int m = next_marker();
      if (m < 0) return false;  // no EOI
      if (m == 0xD9) return have_frame && done;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > size) return false;
      size_t n = u16(pos);
      if (n < 2 || pos + n > size) return false;
      size_t p = pos + 2;
      n -= 2;
      pos = p + n;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (!read_sof(p, n, m)) return false;
      } else if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                  m != 0xCC) || m == 0xCC) {
        return false;  // lossless, hierarchical, arithmetic coding
      } else if (m == 0xC4) {
        if (!read_dht(p, n)) return false;
      } else if (m == 0xDB) {
        if (!read_dqt(p, n)) return false;
      } else if (m == 0xDD) {
        if (n < 2) return false;
        restart = u16(p);
      } else if (m == 0xDA) {
        if (!read_sos(p, n)) return false;
        done = true;
      } else if (m == 0xE0) {
        if (n >= 14 && std::memcmp(data + p, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (n >= 12 && std::memcmp(data + p, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[p + 11];
        }
      } else if (m == 0xDC) {
        return false;  // DNL is not read
      }
    }
  }
};

// ---- the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
              F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
              F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (static_cast<int64_t>(1) << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
  int idx = static_cast<int>(x) & 1023;
  int v = idx < 512 ? idx : idx - 1024;
  return static_cast<uint8_t>(clamp255(v + 128));
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int out_stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (!(ip[8] | ip[16] | ip[24] | ip[32] | ip[40] | ip[48] | ip[56])) {
      const int dc = ip[0] * qp[0] * 4;  // AC terms all zero
      for (int k = 0; k < 64; k += 8) w[k] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
            t12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = static_cast<int>(descale(t10 + tmp3, 11));
    w[56] = static_cast<int>(descale(t10 - tmp3, 11));
    w[8] = static_cast<int>(descale(t11 + tmp2, 11));
    w[48] = static_cast<int>(descale(t11 - tmp2, 11));
    w[16] = static_cast<int>(descale(t12 + tmp1, 11));
    w[40] = static_cast<int>(descale(t12 - tmp1, 11));
    w[24] = static_cast<int>(descale(t13 + tmp0, 11));
    w[32] = static_cast<int>(descale(t13 - tmp0, 11));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * out_stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      const uint8_t dc = idct_limit(descale(w[0], 5));
      std::memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * 8192;
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * 8192;
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
            t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(t10 + tmp3, 18));
    o[7] = idct_limit(descale(t10 - tmp3, 18));
    o[1] = idct_limit(descale(t11 + tmp2, 18));
    o[6] = idct_limit(descale(t11 - tmp2, 18));
    o[2] = idct_limit(descale(t12 + tmp1, 18));
    o[5] = idct_limit(descale(t12 - tmp1, 18));
    o[3] = idct_limit(descale(t13 + tmp0, 18));
    o[4] = idct_limit(descale(t13 - tmp0, 18));
  }
}

// A component's samples upsampled to width x height (libjpeg-turbo's
// jdsample.c methods; edges replicate, as its context rows do).
void upsample(const std::vector<uint8_t>& plane, int pstride, const Comp& c,
              int hs, int vs, int width, int height,
              std::vector<uint8_t>& out) {
  out.resize(static_cast<size_t>(width) * height);
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int y) {
    return &plane[static_cast<size_t>(std::min(std::max(y, 0), dh - 1)) *
                  pstride];
  };
  // fancy vertical (h1v2, h2v2): column sums 3 * near + far, edges
  // replicated one column either side
  std::vector<int> sums(dw + 2);
  const bool fancy_v = vs == 2 && (hs == 1 || (hs == 2 && dw > 2));
  const bool fancy_h = hs == 2 && dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = &out[static_cast<size_t>(y) * width];
    if (fancy_v) {
      const uint8_t* near = row(y >> 1);
      const uint8_t* far = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      for (int x = 0; x < dw; ++x) sums[x + 1] = near[x] * 3 + far[x];
      sums[0] = sums[1];
      sums[dw + 1] = sums[dw];
      if (hs == 1) {
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((sums[x + 1] + bias) >> 2);
      } else {
        for (int x = 0; x < width; ++x) {
          const int* t = &sums[(x >> 1) + 1];
          o[x] = static_cast<uint8_t>(
              (x & 1) ? (t[0] * 3 + t[1] + 7) >> 4 : (t[0] * 3 + t[-1] + 8) >> 4);
        }
      }
    } else if (fancy_h && vs == 1) {
      const uint8_t* r = row(y);
      for (int x = 0; x < dw; ++x) sums[x + 1] = r[x];
      sums[0] = sums[1];
      sums[dw + 1] = sums[dw];
      for (int x = 0; x < width; ++x) {
        const int* t = &sums[(x >> 1) + 1];
        o[x] = static_cast<uint8_t>(
            (x & 1) ? (t[0] * 3 + t[1] + 2) >> 2 : (t[0] * 3 + t[-1] + 1) >> 2);
      }
    } else {
      const uint8_t* r = row(y / vs);
      if (hs == 1) {
        std::memcpy(o, r, width);
      } else {
        for (int x = 0; x < width; ++x) o[x] = r[x / hs];
      }
    }
  }
}

// ---------------------------------------------------------- JPEG encode
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;  // pending bits, right-aligned
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int len) {  // len <= 16
    acc = (acc << len) | (bits & ((1u << len) - 1));
    n += len;
    while (n >= 8) {
      n -= 8;
      const uint8_t b = static_cast<uint8_t>(acc >> n);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
  }
  void flush() {
    if (n) put(0x7F, 8 - n);
  }
};

// the quantized forward DCT of one 8 x 8 block of samples
void fdct_quant(const int* samples, const uint16_t* recip,
                const uint16_t* corr, const int* shift, int16_t* out) {
  int d[64];
  for (int i = 0; i < 64; ++i) d[i] = samples[i] - 128;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k = 0; k < 8; ++k) {
      int s = pass ? 8 : 1;  // element stride
      int* p = pass ? d + k : d + 8 * k;
      int64_t tmp0 = p[0] + p[7 * s], tmp7 = p[0] - p[7 * s];
      int64_t tmp1 = p[s] + p[6 * s], tmp6 = p[s] - p[6 * s];
      int64_t tmp2 = p[2 * s] + p[5 * s], tmp5 = p[2 * s] - p[5 * s];
      int64_t tmp3 = p[3 * s] + p[4 * s], tmp4 = p[3 * s] - p[4 * s];
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
              t12 = tmp1 - tmp2;
      int sh = pass ? 15 : 11;  // CONST_BITS -/+ PASS1_BITS
      if (pass) {
        p[0] = static_cast<int>(descale(t10 + t11, 2));
        p[4 * s] = static_cast<int>(descale(t10 - t11, 2));
      } else {
        p[0] = static_cast<int>((t10 + t11) * 4);
        p[4 * s] = static_cast<int>((t10 - t11) * 4);
      }
      int64_t z1 = (t12 + t13) * F0541;
      p[2 * s] = static_cast<int>(descale(z1 + t13 * F0765, sh));
      p[6 * s] = static_cast<int>(descale(z1 + t12 * (-F1847), sh));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * s] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
      p[5 * s] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
      p[3 * s] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
      p[s] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
    }
  }
  for (int i = 0; i < 64; ++i) {
    int t = static_cast<int16_t>(d[i]);
    bool neg = t < 0;
    uint32_t a = static_cast<uint32_t>(neg ? -t : t);
    uint32_t prod = (a + corr[i]) * recip[i];
    int v = static_cast<int>(static_cast<uint16_t>(prod >> (shift[i] + 16)));
    out[i] = static_cast<int16_t>(neg ? -v : v);
  }
}

// libjpeg-turbo's compute_reciprocal for a 16-bit DCTELEM
void reciprocal(int divisor, uint16_t* recip, uint16_t* corr, int* shift) {
  int b = 0;
  while ((divisor >> (b + 1)) > 0) ++b;  // floor(log2)
  int r = 16 + b;
  uint64_t fq = (static_cast<uint64_t>(1) << r) / divisor;
  uint64_t fr = (static_cast<uint64_t>(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= static_cast<uint64_t>(divisor / 2)) {
    ++c;
  } else {
    ++fq;
  }
  *recip = static_cast<uint16_t>(fq);
  *corr = static_cast<uint16_t>(c);
  *shift = r - 16;
}

void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  auto nbits_of = [](int v) {
    int n = 0;
    while (v) {
      ++n;
      v >>= 1;
    }
    return n;
  };
  int t = blk[0] - *last_dc;
  *last_dc = blk[0];
  int t2 = t;
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = nbits_of(t);
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(t2) & ((1u << nb) - 1), nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    t = blk[kNatural[k]];
    if (t == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      --t2;
    }
    nb = nbits_of(t);
    int sym = (r << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(t2) & ((1u << nb) - 1), nb);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 255));
}

void encode_jpeg(const uint8_t* bgr, int h, int w, int quality,
                 std::vector<uint8_t>& out) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((t ? kStdChromaQ[i] : kStdLumaQ[i]) * static_cast<long>(scale) +
                50L) / 100L;
      q[t][i] = static_cast<uint16_t>(std::min(std::max(v, 1L), 255L));
    }
  uint16_t recip[2][64], corr[2][64];
  int shift[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i)
      reciprocal(q[t][i] << 3, &recip[t][i], &corr[t][i], &shift[t][i]);

  // BGR -> YCbCr (jccolor.c tables)
  const int Y_R = fix16(0.29900), Y_G = fix16(0.58700), Y_B = fix16(0.11400);
  const int CB_R = fix16(0.16874), CB_G = fix16(0.33126);
  const int CR_G = fix16(0.41869), CR_B = fix16(0.08131);
  const int HALF = fix16(0.5);
  const int64_t CBCR_OFF = (128 << 16) + (1 << 15) - 1;
  size_t npx = static_cast<size_t>(h) * w;
  std::vector<uint8_t> Y(npx), Cb(npx), Cr(npx);
  for (size_t i = 0; i < npx; ++i) {
    int b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
    Y[i] = static_cast<uint8_t>((Y_R * r + Y_G * g + Y_B * b + (1 << 15)) >> 16);
    Cb[i] = static_cast<uint8_t>((-CB_R * r - CB_G * g + HALF * b + CBCR_OFF) >> 16);
    Cr[i] = static_cast<uint8_t>((HALF * r - CR_G * g - CR_B * b + CBCR_OFF) >> 16);
  }
  // h2v2 downsampling: full-size columns replicate to the chroma blocks'
  // width, rows to an even count; the chroma rows past ceil(h / 2)
  // replicate the last computed one
  int ybw = (w + 7) / 8, ybh = (h + 7) / 8;
  int cbw = (w + 15) / 16, cbh = (h + 15) / 16;
  int cw = cbw * 8, ch = cbh * 8, hd = (h + 1) / 2;
  std::vector<uint8_t> dcb(static_cast<size_t>(cw) * ch),
      dcr(static_cast<size_t>(cw) * ch);
  for (int y = 0; y < ch; ++y) {
    int yy = std::min(y, hd - 1);
    int r0 = std::min(2 * yy, h - 1), r1 = std::min(2 * yy + 1, h - 1);
    for (int x = 0; x < cw; ++x) {
      int c0 = std::min(2 * x, w - 1), c1 = std::min(2 * x + 1, w - 1);
      int bias = 1 + (x & 1);
      size_t a = static_cast<size_t>(r0) * w, b = static_cast<size_t>(r1) * w;
      dcb[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
          (Cb[a + c0] + Cb[a + c1] + Cb[b + c0] + Cb[b + c1] + bias) >> 2);
      dcr[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
          (Cr[a + c0] + Cr[a + c1] + Cr[b + c0] + Cr[b + c1] + bias) >> 2);
    }
  }

  // headers: SOI, JFIF, DQT x2, SOF0, DHT x4, SOS (libjpeg's order)
  out.clear();
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0,   16,  'J', 'F', 'I',
                          'F',  0,    1,    1,    0,   0,   1,   0,   1,
                          0,    0};
  out.insert(out.end(), jfif, jfif + sizeof(jfif));
  for (int t = 0; t < 2; ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k)
      out.push_back(static_cast<uint8_t>(q[t][kNatural[k]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 17);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), comps, comps + 9);
  struct Tbl {
    int idx;
    const uint8_t* bits;
    const uint8_t* vals;
  } tbls[4] = {{0x00, kDcLumaBits, kDcVals},
               {0x10, kAcLumaBits, kAcLumaVals},
               {0x01, kDcChromaBits, kDcVals},
               {0x11, kAcChromaBits, kAcChromaVals}};
  for (const Tbl& t : tbls) {
    int count = 0;
    for (int i = 0; i < 16; ++i) count += t.bits[i];
    out.push_back(0xFF);
    out.push_back(0xC4);
    put16(out, 19 + count);
    out.push_back(static_cast<uint8_t>(t.idx));
    out.insert(out.end(), t.bits, t.bits + 16);
    out.insert(out.end(), t.vals, t.vals + count);
  }
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11,
                         0,    63,   0};
  out.insert(out.end(), sos, sos + sizeof(sos));

  HuffEnc dcl, acl, dcc, acc;
  dcl.build(kDcLumaBits, kDcVals);
  acl.build(kAcLumaBits, kAcLumaVals);
  dcc.build(kDcChromaBits, kDcVals);
  acc.build(kAcChromaBits, kAcChromaVals);
  BitWriter bw(out);
  int last[3] = {0, 0, 0};
  int samples[64];
  int16_t blk[4][64], cblk[64];
  for (int my = 0; my < cbh; ++my) {
    for (int mx = 0; mx < cbw; ++mx) {
      // luma: 2 x 2 blocks, dummy blocks (AC 0, DC of the block before)
      // past the image's blocks
      for (int yi = 0; yi < 2; ++yi) {
        for (int xi = 0; xi < 2; ++xi) {
          int by = 2 * my + yi, bx = 2 * mx + xi, n = 2 * yi + xi;
          if (by < ybh && bx < ybw) {
            for (int r = 0; r < 8; ++r) {
              int y = std::min(by * 8 + r, h - 1);
              for (int c = 0; c < 8; ++c)
                samples[8 * r + c] =
                    Y[static_cast<size_t>(y) * w + std::min(bx * 8 + c, w - 1)];
            }
            fdct_quant(samples, recip[0], corr[0], shift[0], blk[n]);
          } else {
            std::memset(blk[n], 0, sizeof(blk[n]));
            blk[n][0] = blk[n - 1][0];
          }
          encode_block(bw, blk[n], &last[0], dcl, acl);
        }
      }
      for (int ci = 0; ci < 2; ++ci) {
        const std::vector<uint8_t>& pl = ci ? dcr : dcb;
        for (int r = 0; r < 8; ++r)
          for (int c = 0; c < 8; ++c)
            samples[8 * r + c] =
                pl[static_cast<size_t>(my * 8 + r) * cw + mx * 8 + c];
        fdct_quant(samples, recip[1], corr[1], shift[1], cblk);
        encode_block(bw, cblk, &last[1 + ci], dcc, acc);
      }
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

}  // namespace

extern "C" {

// raw: the inflated PNG stream (filter byte + row, per pass with Adam7).
// out: for RGB / RGBA h * w * 3 BGR bytes (alpha dropped), else h * w *
// channels raw samples (grey, grey + alpha, palette indices; depths below
// 8 unscaled); 16-bit samples give their high byte. → 0, -1 (too little
// data) or -2 (a bad filter type).
int ocr_png_unpack(const uint8_t* raw, long long n, int w, int h, int depth,
                   int channels, int interlace, uint8_t* out) try {
  const int bits_pp = depth * channels;
  const int bpp = std::max(1, bits_pp / 8);
  static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
  const int passes = interlace ? 7 : 1;
  const bool color = channels >= 3;
  const size_t oc = color ? 3 : channels;
  size_t off = 0;
  std::vector<uint8_t> rows;
  for (int p = 0; p < passes; ++p) {
    int x0 = interlace ? X0[p] : 0, y0 = interlace ? Y0[p] : 0;
    int dx = interlace ? DX[p] : 1, dy = interlace ? DY[p] : 1;
    int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t stride = (static_cast<size_t>(pw) * bits_pp + 7) / 8;
    const size_t need = static_cast<size_t>(ph) * (stride + 1);
    if (n < 0 || need > static_cast<size_t>(n) - off) return -1;
    if (!unfilter(raw + off, ph, stride, bpp, rows)) return -2;
    off += need;
    for (int y = 0; y < ph; ++y) {
      const uint8_t* row = &rows[static_cast<size_t>(y) * stride];
      uint8_t* o = out + static_cast<size_t>(y0 + y * dy) * w * oc;
      if (color) {
        for (int x = 0; x < pw; ++x) {
          uint8_t* px = o + (static_cast<size_t>(x0) + x * dx) * 3;
          px[0] = png_sample(row, x, 2, channels, depth);
          px[1] = png_sample(row, x, 1, channels, depth);
          px[2] = png_sample(row, x, 0, channels, depth);
        }
      } else if (depth == 8 && dx == 1) {
        std::memcpy(o, row, static_cast<size_t>(pw) * channels);
      } else {
        for (int x = 0; x < pw; ++x)
          for (int c = 0; c < channels; ++c)
            o[(static_cast<size_t>(x0) + x * dx) * channels + c] =
                png_sample(row, x, c, channels, depth);
      }
    }
  }
  return 0;
} catch (...) {  // out of memory: no exception crosses into the caller
  return -3;
}

// The frame size of a JPEG from its markers up to the first SOFn, without
// decoding: → 0 with *h and *w, or -1.
int ocr_jpeg_size(const uint8_t* buf, long long n, int* h, int* w) {
  Jpeg j;
  j.data = buf;
  j.size = static_cast<size_t>(n);
  if (j.size < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;
  for (;;) {
    int m = j.next_marker();
    if (m < 0 || m == 0xD9 || m == 0xDA) return -1;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (j.pos + 2 > j.size) return -1;
    size_t len = j.u16(j.pos);
    if (len < 2 || j.pos + len > j.size) return -1;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (len < 8) return -1;
      *h = j.u16(j.pos + 3);
      *w = j.u16(j.pos + 5);
      return 0;
    }
    j.pos += len;
  }
}

}  // extern "C"

namespace {

// libjpeg's YCbCr -> RGB tables (jdcolor.c, SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      int x = i - 128;
      cr_r[i] = (fix16(1.40200) * x + (1 << 15)) >> 16;
      cb_b[i] = (fix16(1.77200) * x + (1 << 15)) >> 16;
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + (1 << 15);
    }
  }
};

// The components of a JPEG after libjpeg's colour conversion to its
// default output space: grey (1), RGB (3, from YCbCr unless the file says
// RGB) or CMYK (4, from YCCK under an Adobe transform 2), interleaved
// into `out` (h * w * ncomp). → ncomp, or -1.
int decode_native(const uint8_t* buf, long long n, int h, int w,
                  std::vector<uint8_t>& out) {
  Jpeg j;
  j.data = buf;
  j.size = static_cast<size_t>(n);
  if (!j.parse() || j.height != h || j.width != w) return -1;
  const int W = j.width, H = j.height, nc = j.ncomp;
  std::vector<uint8_t> planes[4];
  for (int ci = 0; ci < nc; ++ci) {
    Comp& c = j.comp[ci];
    int pstride = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pstride) * c.bh * 8);
    const uint16_t* q = j.qt[c.tq];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(j.block(c, by, bx), q,
                   &plane[static_cast<size_t>(by) * 8 * pstride + bx * 8],
                   pstride);
    std::vector<int16_t>().swap(c.coef);  // its samples are all it needs now
    upsample(plane, pstride, c, j.hmax / c.h, j.vmax / c.v, W, H, planes[ci]);
  }
  size_t npx = static_cast<size_t>(W) * H;
  out.resize(npx * nc);
  if (nc == 1) {
    std::memcpy(out.data(), planes[0].data(), npx);
    return 1;
  }
  // jdapimin.c default_decompress_parms: which space the file is in
  bool convert;
  if (nc == 3) {
    if (j.jfif) convert = true;
    else if (j.adobe) convert = j.adobe_transform != 0;
    else convert = !(j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
                     j.comp[2].id == 'B');
  } else {
    convert = j.adobe && j.adobe_transform != 0;  // YCCK, else CMYK
  }
  static const YccTables t;
  for (size_t i = 0; i < npx; ++i) {
    uint8_t* o = &out[i * nc];
    if (!convert) {
      for (int c = 0; c < nc; ++c) o[c] = planes[c][i];
      continue;
    }
    int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
    int r = y + t.cr_r[cr];
    int g = y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16);
    int b = y + t.cb_b[cb];
    if (nc == 3) {
      o[0] = static_cast<uint8_t>(clamp255(r));
      o[1] = static_cast<uint8_t>(clamp255(g));
      o[2] = static_cast<uint8_t>(clamp255(b));
    } else {  // ycck_cmyk_convert: inverted RGB, K passed through
      o[0] = static_cast<uint8_t>(clamp255(255 - r));
      o[1] = static_cast<uint8_t>(clamp255(255 - g));
      o[2] = static_cast<uint8_t>(clamp255(255 - b));
      o[3] = planes[3][i];
    }
  }
  return nc;
}

}  // namespace

extern "C" {

// Decode a JPEG of the size ocr_jpeg_size gave into out (h * w * 3 BGR, in
// the stored orientation; the caller applies the EXIF tag), as cv2's
// IMREAD_COLOR converts libjpeg's output (CMYK by icvCvt_CMYK2BGR). → 0,
// or -1 where cv2.imdecode gives None (or the format is not read).
int ocr_jpeg_decode(const uint8_t* buf, long long n, int h, int w,
                    uint8_t* out) try {
  std::vector<uint8_t> px;
  int nc = decode_native(buf, n, h, w, px);
  if (nc < 0) return -1;
  size_t npx = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t* s = &px[i * nc];
    uint8_t* o = &out[3 * i];
    if (nc == 1) {
      o[0] = o[1] = o[2] = s[0];
    } else if (nc == 3) {
      o[0] = s[2]; o[1] = s[1]; o[2] = s[0];
    } else {
      int k = s[3];
      o[2] = static_cast<uint8_t>(k - ((255 - s[0]) * k >> 8));
      o[1] = static_cast<uint8_t>(k - ((255 - s[1]) * k >> 8));
      o[0] = static_cast<uint8_t>(k - ((255 - s[2]) * k >> 8));
    }
  }
  return 0;
} catch (...) {  // out of memory
  return -1;
}

// The JPEG's components in libjpeg's output space (grey, RGB or CMYK,
// stored orientation) into out (h * w * 4 bytes at most): → their number,
// or -1.
int ocr_jpeg_decode_native(const uint8_t* buf, long long n, int h, int w,
                           uint8_t* out) try {
  std::vector<uint8_t> px;
  int nc = decode_native(buf, n, h, w, px);
  if (nc < 0) return -1;
  std::memcpy(out, px.data(), px.size());
  return nc;
} catch (...) {
  return -1;
}

// Baseline 4:2:0 JPEG of an h x w BGR image at `quality` into out (cap
// bytes). → its length, minus the length needed when cap is too small, or
// 0 when memory ran out.
long long ocr_jpeg_encode(const uint8_t* bgr, int h, int w, int quality,
                          uint8_t* out, long long cap) try {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(h) * w / 2 + 1024);
  encode_jpeg(bgr, h, w, quality, buf);
  long long n = static_cast<long long>(buf.size());
  if (n > cap) return -n;
  std::memcpy(out, buf.data(), buf.size());
  return n;
} catch (...) {
  return 0;
}

}  // extern "C"
