// Host image codec of the service (onnxocr_tpu_torch/utils/imcodec.py):
// the parts of cv2.imdecode / cv2.imencode that the HTTP routes and the
// crop writer need, on a machine without cv2 or PIL.
//
// * PNG: unfiltering (None, Sub, Up, Average, Paeth) and Adam7
//   de-interlacing of the inflated stream (zlib inflates in Python); every
//   bit depth, 16-bit samples reduced to their high byte as cv2 does.
// * JPEG decoder: baseline and progressive, Huffman or arithmetic
//   coding (the QM decoder of jdarith.c, with DAC conditioning), 8-bit, 1, 3 or 4
//   components (4: CMYK, or YCCK under an Adobe transform 2, both to CMYK
//   as libjpeg converts them), any integral sampling factors, restart
//   intervals. It
//   computes what libjpeg-turbo computes at cv2's settings: the integer
//   "islow" IDCT (as its AVX2 code computes it, which wraps and saturates
//   a corrupt file's coefficients), "fancy" triangular chroma upsampling (h2v1, h1v2, h2v2;
//   replication otherwise) and the fixed-point YCbCr -> BGR tables. Its
//   Huffman tables are checked as libjpeg checks them, before use. A
//   baseline frame whose first scan holds every component streams as
//   libjpeg's single-scan mode does: each MCU row is decoded, transformed
//   into a ring of three MCU rows of samples (the row above and below
//   that fancy upsampling reads, as jdsample.c's context rows) and
//   converted into the output as its rows complete, so a decode holds the
//   output and O(width x 3 MCU rows). Progressive frames and baseline
//   frames of several scans keep every coefficient, as libjpeg's buffered
//   mode does, and are transformed the same way at the end.
// * TIFF: the LZW and PackBits decoders of libtiff (the rest of the TIFF
//   reader is numpy in imcodec.py).
// * Netpbm: the numbers of the header and of P1–P3's ASCII samples, read
//   as cv2's ReadNumber reads them.
// * JPEG encoder: baseline 4:2:0 with the Annex K tables scaled for the
//   quality as libjpeg scales them, libjpeg-turbo's fixed-point BGR ->
//   YCbCr, h2v2 downsampling, "islow" forward DCT, reciprocal
//   quantization and the standard Huffman tables.
// * WebP decoder (lossy, lossless, alpha, an animation's first frame): see
//   its section.
// * GIF decoder (cv2 5.0's GifDecoder: the block walk, LZW, the first frame
//   on the logical screen) and Radiance HDR decoder (rgbe.c's header and
//   RLE scanlines, cv2's float -> 8-bit conversion), and PFM's header
//   words: see their sections at the end.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
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
  int maxval = 0;        // its largest value (a DC category up to 16 is
                         // accepted here; lossy scans refuse 16)
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
// 16 (above 15 in a lossy scan: `usable`). Each code is checked before it
// is entered, so the lookahead tables are never written out of range.
void build_huff(Huff& t, const uint8_t* bits, const uint8_t* vals, int n,
                bool is_dc) {
  t.defined = true;
  t.present = false;
  if (n > 256) return;
  t.maxval = 0;
  for (int i = 0; i < n; ++i) t.maxval = std::max<int>(t.maxval, vals[i]);
  if (is_dc && t.maxval > 16) return;
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
  // the coefficients (natural order): of the whole component (abh * abw
  // blocks) when buffered, of one MCU row (v * abw blocks) when streamed
  std::vector<int16_t> coef;
  int srows = 1;              // block rows of the one-row buffer
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

// ---- arithmetic decoding (ITU T.81 Annexes D, F and G as libjpeg's
// jdarith.c lays them out)
// Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
// of the sign and refinement bits.
const uint16_t kQe[114][4] = {  // Qe, NMPS, NLPS, SWITCH
    {0x5a1d, 1, 1, 1},    {0x2586, 2, 14, 0},   {0x1114, 3, 16, 0},
    {0x080b, 4, 18, 0},   {0x03d8, 5, 20, 0},   {0x01da, 6, 23, 0},
    {0x00e5, 7, 25, 0},   {0x006f, 8, 28, 0},   {0x0036, 9, 30, 0},
    {0x001a, 10, 33, 0},  {0x000d, 11, 35, 0},  {0x0006, 12, 9, 0},
    {0x0003, 13, 10, 0},  {0x0001, 13, 12, 0},  {0x5a7f, 15, 15, 1},
    {0x3f25, 16, 36, 0},  {0x2cf2, 17, 38, 0},  {0x207c, 18, 39, 0},
    {0x17b9, 19, 40, 0},  {0x1182, 20, 42, 0},  {0x0cef, 21, 43, 0},
    {0x09a1, 22, 45, 0},  {0x072f, 23, 46, 0},  {0x055c, 24, 48, 0},
    {0x0406, 25, 49, 0},  {0x0303, 26, 51, 0},  {0x0240, 27, 52, 0},
    {0x01b1, 28, 54, 0},  {0x0144, 29, 56, 0},  {0x00f5, 30, 57, 0},
    {0x00b7, 31, 59, 0},  {0x008a, 32, 60, 0},  {0x0068, 33, 62, 0},
    {0x004e, 34, 63, 0},  {0x003b, 35, 32, 0},  {0x002c, 9, 33, 0},
    {0x5ae1, 37, 37, 1},  {0x484c, 38, 64, 0},  {0x3a0d, 39, 65, 0},
    {0x2ef1, 40, 67, 0},  {0x261f, 41, 68, 0},  {0x1f33, 42, 69, 0},
    {0x19a8, 43, 70, 0},  {0x1518, 44, 72, 0},  {0x1177, 45, 73, 0},
    {0x0e74, 46, 74, 0},  {0x0bfb, 47, 75, 0},  {0x09f8, 48, 77, 0},
    {0x0861, 49, 78, 0},  {0x0706, 50, 79, 0},  {0x05cd, 51, 48, 0},
    {0x04de, 52, 50, 0},  {0x040f, 53, 50, 0},  {0x0363, 54, 51, 0},
    {0x02d4, 55, 52, 0},  {0x025c, 56, 53, 0},  {0x01f8, 57, 54, 0},
    {0x01a4, 58, 55, 0},  {0x0160, 59, 56, 0},  {0x0125, 60, 57, 0},
    {0x00f6, 61, 58, 0},  {0x00cb, 62, 59, 0},  {0x00ab, 63, 61, 0},
    {0x008f, 32, 61, 0},  {0x5b12, 65, 65, 1},  {0x4d04, 66, 80, 0},
    {0x412c, 67, 81, 0},  {0x37d8, 68, 82, 0},  {0x2fe8, 69, 83, 0},
    {0x293c, 70, 84, 0},  {0x2379, 71, 86, 0},  {0x1edf, 72, 87, 0},
    {0x1aa9, 73, 87, 0},  {0x174e, 74, 72, 0},  {0x1424, 75, 72, 0},
    {0x119c, 76, 74, 0},  {0x0f6b, 77, 74, 0},  {0x0d51, 78, 75, 0},
    {0x0bb6, 79, 77, 0},  {0x0a40, 48, 77, 0},  {0x5832, 81, 80, 1},
    {0x4d1c, 82, 88, 0},  {0x438e, 83, 89, 0},  {0x3bdd, 84, 90, 0},
    {0x34ee, 85, 91, 0},  {0x2eae, 86, 92, 0},  {0x299a, 87, 93, 0},
    {0x2516, 71, 86, 0},  {0x5570, 89, 88, 1},  {0x4ca9, 90, 95, 0},
    {0x44d9, 91, 96, 0},  {0x3e22, 92, 97, 0},  {0x3824, 93, 99, 0},
    {0x32b4, 94, 99, 0},  {0x2e17, 86, 93, 0},  {0x56a8, 96, 95, 1},
    {0x4f46, 97, 101, 0}, {0x47e5, 98, 102, 0}, {0x41cf, 99, 103, 0},
    {0x3c3d, 100, 104, 0}, {0x375e, 93, 99, 0}, {0x5231, 102, 105, 0},
    {0x4c0f, 103, 106, 0}, {0x4639, 104, 107, 0}, {0x415e, 99, 103, 0},
    {0x5627, 106, 105, 1}, {0x50e7, 107, 108, 0}, {0x4b85, 103, 109, 0},
    {0x5597, 109, 110, 0}, {0x504f, 107, 111, 0}, {0x5a10, 111, 110, 1},
    {0x5522, 109, 112, 0}, {0x59eb, 111, 112, 1}, {0x5a1d, 113, 113, 0}};

// The QM decoder's registers and its byte source: the compressed data up
// to the next marker, then zeros (a marker ends an arithmetic segment
// legally); `ct` -1 is libjpeg's error state, in which the rest of the
// segment decodes nothing.
struct Arith {
  const uint8_t* data;
  size_t size, pos;
  bool at_marker = false;   // pos is on the 0xFF of the marker reached
  bool truncated = false;   // the buffer ended inside entropy data
  bool short_data = false;  // (the Huffman reader's; never set here)
  int64_t c = 0, a = 0;
  int ct = -16;

  void align() {  // a restart: two new bytes fill C
    c = 0;
    a = 0;
    ct = -16;
  }
  int byte() {
    if (at_marker) return 0;
    if (pos >= size) {
      truncated = true;
      return 0;
    }
    int d = data[pos];
    if (d != 0xFF) {
      ++pos;
      return d;
    }
    size_t p = pos + 1;
    while (p < size && data[p] == 0xFF) ++p;
    if (p >= size) {
      truncated = true;
      return 0;
    }
    if (data[p] == 0) {  // a stuffed zero
      pos = p + 1;
      return 0xFF;
    }
    pos = p - 1;  // a marker: zeros from here on
    at_marker = true;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const uint16_t* e = kQe[sv & 0x7F];
    int64_t qe = e[0];
    int nm = e[1], nl = e[2] | (e[3] << 7);
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
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
  bool arith = false;  // SOF9 / SOF10: arithmetic coding
  // SOF3: lossless (Huffman): the samples of each component after
  // undifferencing, before the point transform of the scan that wrote
  // them (comp_pt). A frame whose first scan leaves out a component is
  // read scan by scan to its EOI (libjpeg's has_multiple_scans), each
  // scan writing the planes it names; one that any scan left out is
  // refused, as libjpeg's read of the unwritten rows of its full-image
  // buffer is (JERR_BAD_VIRTUAL_ACCESS).
  bool lossless = false, multiscan = false;
  int precision = 8, point_transform = 0;
  int comp_pt[4] = {0, 0, 0, 0};
  std::vector<uint16_t> planes[4];
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  // the arithmetic conditioning (DAC; libjpeg's defaults L 0, U 1, Kx 5)
  // and statistics of its 16 tables
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  int dc_context[4] = {0, 0, 0, 0};
  Comp comp[4];
  // libjpeg's progression status for block smoothing: the Al of the last
  // scan of each of a component's zigzag coefficients 0-9 (-1 before any),
  // their values before its last scan, the scans read, and the last iMCU
  // row decoded with the data it needed (master->last_good_iMCU_row)
  int coef_bits[4][10], prev_bits[4][10];
  int scans = 0;
  int last_good_row = 0;

  Jpeg() {
    std::fill(dc_l, dc_l + 16, 0);
    std::fill(dc_u, dc_u + 16, 1);
    std::fill(ac_k, ac_k + 16, 5);
    std::fill(&coef_bits[0][0], &coef_bits[0][0] + 40, -1);
    std::fill(&prev_bits[0][0], &prev_bits[0][0] + 40, 0);
  }
  bool done = false;
  // streaming: the first scan of a baseline frame holds every component;
  // `on_row(k)` takes each decoded MCU row k (the coefficients in each
  // component's one-row buffer) and `on_end()` follows the last
  bool streaming = false, buffered = false;
  std::function<bool(int)> on_row;
  std::function<bool()> on_end;
  // JPEG-in-TIFF: libtiff's checks of the frame before the first scan
  // (false: the strip is refused), the colour space it imposes (-1: the
  // file's own, as libjpeg guesses it; 0: none; 1: YCbCr -> RGB), and
  // whether decoding of entropy data began (a failure after that keeps the
  // rows already out)
  std::function<bool()> on_frame;
  int force_convert = -1;
  bool started = false;

  int u16(size_t p) const { return (data[p] << 8) | data[p + 1]; }

  // the next marker code at or after pos (skipping stray bytes and fill),
  // pos moved past it; -1 at the end of the buffer
  int next_marker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return -1;
      if (data[pos] != 0) return data[pos++];
      ++pos;  // a stuffed zero (FF 00) left by a scan: skipped
    }
  }

  bool read_sof(size_t p, size_t n, int marker) {
    if (have_frame || n < 6) return false;
    lossless = marker == 0xC3;
    precision = data[p];
    // 12-bit lossy samples are not read; lossless ones only up to 8 bits,
    // as libjpeg-turbo's 8-bit interface reads them
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      return false;
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = data[p + 5];
    if (width == 0 || height == 0) return false;
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return false;
    if (n != 6 + 3u * ncomp) return false;
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
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
    const int unit = lossless ? 1 : 8;  // a lossless data unit: 1 sample
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) return false;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.bw = (c.dw + unit - 1) / unit;
      c.bh = (c.dh + unit - 1) / unit;
      c.abw = mcux * c.h;
      c.abh = mcuy * c.v;
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

  // DAC: conditioning of arithmetic tables (libjpeg's get_dac)
  bool read_dac(size_t p, size_t n) {
    if (n & 1) return false;
    for (size_t e = p + n; p < e; p += 2) {
      int index = data[p], val = data[p + 1];
      if (index >= 32) return false;
      if (index >= 16) {
        ac_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l[index] = static_cast<uint8_t>(val & 15);
        dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l[index] > dc_u[index]) return false;
      }
    }
    return true;
  }

  int16_t* block(Comp& c, int by, int bx) {
    if (streaming) by %= c.srows;  // the one MCU row held
    return &c.coef[(static_cast<size_t>(by) * c.abw + bx) * 64];
  }

  // whether a scan can decode with table `no`: one a DHT gave and
  // jdhuff.c accepts, or else in a sequential frame the standard table 0
  // or 1 (jinit_huff_decoder's std_huff_tables; jdphuff.c has none)
  bool usable(Huff* tables, int no, bool is_dc) {
    Huff& t = tables[no];
    if (!t.defined && no <= 1 && !progressive) {
      const uint8_t* bits = is_dc ? (no ? kDcChromaBits : kDcLumaBits)
                                  : (no ? kAcChromaBits : kAcLumaBits);
      const uint8_t* vals = is_dc ? kDcVals
                                  : (no ? kAcChromaVals : kAcLumaVals);
      build_huff(t, bits, vals, is_dc ? 12 : 162, is_dc);
    }
    return t.present && !(is_dc && !lossless && t.maxval > 15);
  }

  // one scan; pos is past the SOS header
  bool read_scan(const int* ids, int ns, int ss, int se, int ah, int al) {
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) sc[i] = &comp[ids[i]];
    if (progressive) {
      bool dcband = ss == 0;
      if (dcband ? se != 0 : (ss > se || se > 63 || ns != 1)) return false;
      if ((ah != 0 && al != ah - 1) || al > 13) return false;
      // jdphuff.c / jdarith.c's start_pass: the progression status
      for (int i = 0; i < ns; ++i) {
        int* bits = coef_bits[sc[i] - comp];
        int* prev = prev_bits[sc[i] - comp];
        for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), 9); ++k)
          prev[k] = scans > 1 ? bits[k] : 0;
        for (int k = ss; k <= std::min(se, 9); ++k) bits[k] = al;
      }
    }
    for (int i = 0; i < ns; ++i) {
      if (!qt_present[sc[i]->tq]) return false;
      sc[i]->dc_pred = 0;
      if (arith) continue;
      // jdhuff.c / jdphuff.c's start_pass: only the tables the scan reads
      // are checked (a DC refinement scan reads none)
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if (need_dc && (sc[i]->td > 3 || !usable(dc, sc[i]->td, true)))
        return false;
      if (need_ac && (sc[i]->ta > 3 || !usable(ac, sc[i]->ta, false)))
        return false;
    }
    if (arith) {
      // jdarith.c's start_pass and process_restart: statistics and DC
      // predictions start afresh with the scan and at each restart
      auto reset = [&]() {
        for (int i = 0; i < ns; ++i) {
          if (!progressive || (ss == 0 && ah == 0)) {
            std::memset(dc_stats[sc[i]->td], 0, 64);
            sc[i]->dc_pred = 0;
            dc_context[i] = 0;
          }
          if (!progressive || ss)
            std::memset(ac_stats[sc[i]->ta], 0, 256);
        }
      };
      reset();
      Arith ar{data, size, pos};
      uint8_t fixed_bin = 113;
      bool ok = scan_units(ar, sc, ns, [&](int my, int mx) {
        if (ar.ct != -1)
          decode_mcu_arith(ar, sc, ns, my, mx, ss, se, ah, al, fixed_bin);
      }, reset, false);
      if (!ok) return false;
      // the marker reader goes on past the bytes the decoder left
      pos = ar.pos;
      return true;
    }
    Bits br{data, size, pos};
    int eobrun = 0;
    bool ok = scan_units(br, sc, ns, [&](int my, int mx) {
      decode_mcu(br, sc, ns, my, mx, ss, se, ah, al, eobrun);
    }, [&]() {
      eobrun = 0;
      for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    }, true);
    if (!ok) return false;
    // continue the marker loop at the marker that ended the data
    pos = br.pos;
    return true;
  }

  // The MCUs of a scan in order, with the restart intervals: `decode(my,
  // mx)` reads one, `reset()` restarts the entropy state. A Huffman reader
  // (`halts`) skips the MCUs after its data ran out until a restart marker
  // is read (one that a restart leaves unread keeps it out of data, and
  // the first MCU after it decodes from zeros unless it already was); the
  // arithmetic reader decodes them from zeros.
  template <class Reader, class Decode, class Reset>
  bool scan_units(Reader& rd, Comp** sc, int ns, Decode decode, Reset reset,
                  bool halts) {
    long long total;
    int mw;
    if (ns == 1) {
      mw = sc[0]->bw;
      total = static_cast<long long>(sc[0]->bw) * sc[0]->bh;
    } else {
      mw = mcux;
      total = static_cast<long long>(mcux) * mcuy;
    }
    int rst_next = 0;     // the number of the next restart marker
    const int rows_units = ns == 1 ? sc[0]->bh : mcuy;
    const int unit_rows = ns == 1 ? sc[0]->v : 1;  // units an iMCU row
    started = true;
    for (long long m = 0; m < total; ++m) {
      if (streaming && m % mw == 0) {  // a new MCU row: clear its blocks
        for (int i = 0; i < ns; ++i)
          std::fill(sc[i]->coef.begin(), sc[i]->coef.end(), 0);
      }
      if (restart && m > 0 && m % restart == 0) {
        if (!restart_marker(rd, rst_next)) return false;
        reset();
      }
      int my = static_cast<int>(m / mw), mx = static_cast<int>(m % mw);
      bool skip = halts && rd.short_data;
      if (streaming && mx == mw - 1) {
        // after this MCU the row is complete (a skipped one stays zero)
        if (!skip) decode(my, mx);
        if (rd.truncated) return false;
        if (!on_row(my)) return false;
        continue;
      }
      if (skip) continue;
      last_good_row = my / unit_rows;  // an MCU the data reaches
      decode(my, mx);
      if (rd.truncated) return false;
    }
    if (rd.truncated) return false;
    if (streaming && (rows_units <= 0 || !on_end())) return false;
    return true;
  }

  // A restart: the reader's bits dropped, then libjpeg's
  // read_restart_marker: the expected RSTn, or else jpeg_resync_to_restart's
  // choice among the markers that follow; false where none follows.
  template <class Reader>
  bool restart_marker(Reader& rd, int& rst_next) {
    rd.align();
    if (!rd.at_marker && !scan_to_marker(rd)) return false;
    for (;;) {
      size_t p = rd.pos;
      while (p < size && data[p] == 0xFF) ++p;
      if (p >= size) return false;
      int mk = data[p];
      int action = 1;
      if (mk != 0xD0 + rst_next) {
        if (mk < 0xC0) {
          action = 2;  // not a valid marker
        } else if (mk < 0xD0 || mk > 0xD7) {
          action = 3;  // a marker other than a restart
        } else if (mk == 0xD0 + ((rst_next + 1) & 7) ||
                   mk == 0xD0 + ((rst_next + 2) & 7)) {
          action = 3;  // one of the next two restarts
        } else if (mk == 0xD0 + ((rst_next - 1) & 7) ||
                   mk == 0xD0 + ((rst_next - 2) & 7)) {
          action = 2;  // a prior restart
        }
      }
      if (action == 1) {  // swallowed; the data goes on after it
        rd.pos = p + 1;
        rd.at_marker = false;
        rd.short_data = false;
      } else if (action == 2) {  // scan to the next marker, decide again
        rd.pos = p + 1;
        if (!scan_to_marker(rd)) return false;
        continue;
      }  // else left unread: the segment is empty
      break;
    }
    rst_next = (rst_next + 1) & 7;
    return true;
  }

  // A scan of a lossless frame (jdlhuff.c, jddiffct.c, jdpred.c), of any
  // of its components: each MCU row's sample differences (category 16 is
  // 32768), none once the data ran out (they stay 0), then each component
  // row undifferenced — the first row of the scan and of each restart
  // interval from 2^(P - Pt - 1) and its left neighbour, the others'
  // first column from the row above and the rest by predictor `ps` —
  // modulo 2^16. A scan of one component has MCUs of one sample, so its
  // restart interval counts that component's rows; a component a later
  // scan names again is written again.
  bool read_lossless(const int* ids, int ns, int ps, int se, int ah, int al) {
    if (ps < 1 || ps > 7 || se != 0 || ah != 0 || al >= precision)
      return false;
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      sc[i] = &comp[ids[i]];
      if (sc[i]->td > 3 || !usable(dc, sc[i]->td, true)) return false;
    }
    const int mw = ns == 1 ? sc[0]->dw : mcux;
    const int mh = ns == 1 ? sc[0]->dh : mcuy;
    if (restart % mw) return false;  // libjpeg's JERR_BAD_RESTART
    point_transform = al;
    std::vector<int> diff[4];
    bool first[4];
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      const int rows = ns == 1 ? 1 : c.v;
      diff[i].assign(static_cast<size_t>(rows) * (ns == 1 ? c.dw : c.abw),
                     0);
      planes[ids[i]].assign(static_cast<size_t>(c.dw) * c.dh, 0);
      comp_pt[ids[i]] = al;
      first[i] = true;
    }
    started = true;
    Bits br{data, size, pos};
    int rst_next = 0, rows_to_go = restart ? restart / mw : 0;
    for (int my = 0; my < mh; ++my) {
      if (restart && rows_to_go == 0) {
        if (!restart_marker(br, rst_next)) return false;
        for (int i = 0; i < ns; ++i) first[i] = true;
        rows_to_go = restart / mw;
      }
      for (int i = 0; i < ns; ++i) std::fill(diff[i].begin(), diff[i].end(), 0);
      if (!br.short_data) {
        for (int mx = 0; mx < mw; ++mx) {
          for (int i = 0; i < ns; ++i) {
            const Comp& c = *sc[i];
            const int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
            const size_t stride = ns == 1 ? c.dw : c.abw;
            for (int yy = 0; yy < nv; ++yy)
              for (int xx = 0; xx < nh; ++xx) {
                const int s = br.decode(dc[c.td]);
                diff[i][yy * stride + static_cast<size_t>(mx) * nh + xx] =
                    s == 16 ? 32768 : s ? extend(br.get(s), s) : 0;
              }
          }
          if (br.truncated) return false;
        }
      }
      if (restart) --rows_to_go;
      for (int i = 0; i < ns; ++i) {
        const Comp& c = *sc[i];
        const int nv = ns == 1 ? 1 : c.v;
        const size_t stride = ns == 1 ? c.dw : c.abw;
        for (int yy = 0; yy < nv; ++yy) {
          const int row = my * nv + yy;
          if (row >= c.dh) break;
          undifference(ids[i], row, &diff[i][yy * stride], first[i], ps);
          first[i] = false;
        }
      }
    }
    pos = br.pos;
    return true;
  }

  void undifference(int ci, int row, const int* d, bool first, int ps) {
    const int w = comp[ci].dw;
    uint16_t* out = &planes[ci][static_cast<size_t>(row) * w];
    if (first) {
      int ra = (d[0] + (1 << (precision - point_transform - 1))) & 0xFFFF;
      out[0] = static_cast<uint16_t>(ra);
      for (int x = 1; x < w; ++x) {
        ra = (d[x] + ra) & 0xFFFF;
        out[x] = static_cast<uint16_t>(ra);
      }
      return;
    }
    const uint16_t* prev = out - w;
    int rb = prev[0];
    int ra = (d[0] + rb) & 0xFFFF;
    out[0] = static_cast<uint16_t>(ra);
    for (int x = 1; x < w; ++x) {
      const int rc = rb;
      rb = prev[x];
      int p;
      switch (ps) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      ra = (d[x] + p) & 0xFFFF;
      out[x] = static_cast<uint16_t>(ra);
    }
  }

  // libjpeg's next_marker from rd.pos: past bytes other than 0xFF and
  // stuffed zeros to the 0xFF of the next marker; false at the end
  template <class Reader>
  bool scan_to_marker(Reader& rd) {
    size_t p = rd.pos;
    for (;;) {
      while (p < size && data[p] != 0xFF) ++p;
      size_t q = p;
      while (q < size && data[q] == 0xFF) ++q;
      if (q >= size) return false;
      if (data[q] != 0) break;
      p = q + 1;
    }
    rd.pos = p;
    rd.at_marker = true;
    return true;
  }

  // jdarith.c's decode of the magnitude and sign of a nonzero value after
  // its category bin `st` (Figures F.21-F.24); 0 on a magnitude overflow
  // (the decoder then stops, ct -1)
  static bool arith_value(Arith& ar, uint8_t* st, uint8_t* mag_stats,
                          int sign, int* out) {
    int m = ar.decode(st);
    if (m) {
      if (ar.decode(st)) {
        m <<= 1;
        st = mag_stats;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  // the blocks of MCU (my, mx) of an arithmetic-coded scan (jdarith.c's
  // decode_mcu, decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine)
  void decode_mcu_arith(Arith& ar, Comp** sc, int ns, int my, int mx, int ss,
                        int se, int ah, int al, uint8_t& fixed_bin) {
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
      for (int yy = 0; yy < nv; ++yy) {
        for (int xx = 0; xx < nh; ++xx) {
          int by = ns == 1 ? my : my * c.v + yy;
          int bx = ns == 1 ? mx : mx * c.h + xx;
          int16_t* b = block(c, by, bx);
          if (!progressive || (ss == 0 && ah == 0)) {
            // DC (Figure F.19; the DC statistics of Table F.4)
            uint8_t* dcs = dc_stats[c.td];
            uint8_t* st = dcs + dc_context[i];
            if (ar.decode(st) == 0) {
              dc_context[i] = 0;
            } else {
              int sign = ar.decode(st + 1);
              st += 2 + sign;
              int m = ar.decode(st);
              if (m != 0) {
                st = dcs + 20;
                while (ar.decode(st)) {
                  if ((m <<= 1) == 0x8000) {
                    ar.ct = -1;
                    return;
                  }
                  st += 1;
                }
              }
              if (m < static_cast<int>((1L << dc_l[c.td]) >> 1))
                dc_context[i] = 0;
              else if (m > static_cast<int>((1L << dc_u[c.td]) >> 1))
                dc_context[i] = 12 + sign * 4;
              else
                dc_context[i] = 4 + sign * 4;
              int v = m;
              st += 14;
              while (m >>= 1)
                if (ar.decode(st)) v |= m;
              v += 1;
              if (sign) v = -v;
              c.dc_pred = progressive ? c.dc_pred + v
                                      : (c.dc_pred + v) & 0xffff;
            }
            b[0] = static_cast<int16_t>(
                progressive ? static_cast<uint32_t>(c.dc_pred) << al
                            : static_cast<uint32_t>(c.dc_pred));
            if (progressive) continue;
          } else if (ss == 0) {  // DC refinement: the next bit
            if (ar.decode(&fixed_bin)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
            continue;
          }
          uint8_t* acs = ac_stats[c.ta];
          int kx = ac_k[c.ta];
          if (!progressive || ah == 0) {  // AC (Figure F.20)
            int k0 = progressive ? ss : 1, k1 = progressive ? se : 63;
            for (int k = k0; k <= k1; ++k) {
              uint8_t* st = acs + 3 * (k - 1);
              if (ar.decode(st)) break;  // EOB
              while (ar.decode(st + 1) == 0) {
                st += 3;
                ++k;
                if (k > k1) {
                  ar.ct = -1;  // spectral overflow
                  return;
                }
              }
              int sign = ar.decode(&fixed_bin), v;
              if (!arith_value(ar, st + 2, acs + (k <= kx ? 189 : 217), sign,
                               &v))
                return;
              b[kNatural[k]] = static_cast<int16_t>(
                  static_cast<uint32_t>(v) << (progressive ? al : 0));
            }
          } else {  // AC refinement (Section G.1.3.3)
            int p1 = 1 << al, m1 = -1 * (1 << al);
            int kex = se;
            for (; kex > 0; --kex)
              if (b[kNatural[kex]]) break;
            for (int k = ss; k <= se; ++k) {
              uint8_t* st = acs + 3 * (k - 1);
              if (k > kex && ar.decode(st)) break;  // EOB
              for (;;) {
                int16_t* co = b + kNatural[k];
                if (*co) {
                  if (ar.decode(st + 2))
                    *co = static_cast<int16_t>(*co < 0 ? *co + m1 : *co + p1);
                  break;
                }
                if (ar.decode(st + 1)) {
                  *co = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
                  break;
                }
                st += 3;
                ++k;
                if (k > se) {
                  ar.ct = -1;
                  return;
                }
              }
            }
          }
        }
      }
    }
  }

  // the blocks of MCU (my, mx) of the scan (one block when ns is 1)
  void decode_mcu(Bits& br, Comp** sc, int ns, int my, int mx, int ss,
                  int se, int ah, int al, int& eobrun) {
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
              return;  // one block a MCU in AC scans
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
  }

  // jdcoefct.c's smoothing_ok: block smoothing runs on a progressive
  // frame whose every component has had a DC scan and whose coefficients
  // 1-9 are not all complete, unless a quantiser it divides by is zero
  bool smoothing() const {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < ncomp; ++ci) {
      const uint16_t* q = qt[comp[ci].tq];
      for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (q[k] == 0) return false;
      if (coef_bits[ci][0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= coef_bits[ci][k] != 0;
    }
    return useful;
  }

  // libjpeg-turbo's decompress_smooth_data for block (by, bx) of component
  // ci: its coefficients into ws, those of 1-9 that are zero and not
  // complete estimated from the DC values of the 5 x 5 blocks around it
  // (the DC too, where no AC scan of the component arrived). The rows
  // around it follow libjpeg's bounds, which in a short last iMCU row count
  // that row's blocks as if every row were as short.
  void smooth_block(int ci, int by, int bx, int16_t* ws) {
    Comp& c = comp[ci];
    std::memcpy(ws, block(c, by, bx), 64 * sizeof(int16_t));
    const int r = by / c.v, b = by % c.v;
    int brows = c.v;
    if (r == mcuy - 1 && c.bh % c.v) brows = c.bh % c.v;
    const long long q = static_cast<long long>(r) * brows + b,
                    qrows = static_cast<long long>(brows) * mcuy;
    const int up1 = q > 0 ? by - 1 : by, up2 = q > 1 ? by - 2 : up1;
    const int dn1 = q < qrows - 1 ? by + 1 : by,
              dn2 = q < qrows - 2 ? by + 2 : dn1;
    const int rows[5] = {up2, up1, by, dn1, dn2};
    int d[26];  // d[1] .. d[25]: libjpeg's DC01 .. DC25
    for (int i = 0; i < 5; ++i)
      for (int k = 0; k < 5; ++k)
        d[1 + 5 * i + k] =
            block(c, rows[i], std::min(std::max(bx + k - 2, 0), c.bw - 1))[0];
    // the row is past the last one decoded: the bits before the
    // component's last scan, all -1 when there was only one scan
    static const int kNone[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
    const int* bits = r <= last_good_row ? coef_bits[ci]
                      : scans > 1       ? prev_bits[ci]
                                        : kNone;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
    const uint16_t* qv = qt[c.tq];
    const int64_t q00 = qv[0];
    // num * q00 / (qk * 256), rounded half away from zero
    auto predict = [&](int64_t num, int64_t qk) {
      num *= q00;
      return ((qk << 7) + (num < 0 ? -num : num)) / (qk << 8);
    };
    // coefficient k (zigzag; natural position pos) from num, below 2^Al
    auto estimate = [&](int k, int pos, int64_t num) {
      const int al = bits[k];
      if (al == 0 || ws[pos] != 0) return;
      int64_t pred = predict(num, qv[pos]);
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      ws[pos] = static_cast<int16_t>(num < 0 ? -pred : pred);
    };
    if (change_dc) {
      estimate(1, 1, -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] -
                         13 * d[9] + 3 * d[10] - 3 * d[11] + 38 * d[12] -
                         38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                         13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] +
                         d[25]);
      estimate(2, 8, -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] +
                         13 * d[7] + 38 * d[8] + 13 * d[9] - d[10] + d[16] -
                         13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] +
                         d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]);
      estimate(3, 16, d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] -
                          14 * d[13] - 5 * d[14] + 2 * d[17] + 7 * d[18] +
                          2 * d[19] + d[23]);
      estimate(4, 9, -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] +
                         9 * d[19] + d[21] - d[25]);
      estimate(5, 2, 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] -
                         14 * d[13] + 7 * d[14] + d[15] + 2 * d[17] -
                         5 * d[18] + 2 * d[19]);
      estimate(6, 3, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
      estimate(7, 10, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
      estimate(8, 17, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
      estimate(9, 24, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
      const int64_t num =
          -2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] +
          6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] +
          42 * d[12] + 152 * d[13] + 42 * d[14] - 8 * d[15] - 6 * d[16] +
          6 * d[17] + 42 * d[18] + 6 * d[19] - 6 * d[20] - 2 * d[21] -
          6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25];
      const int64_t pred = predict(num, q00);
      ws[0] = static_cast<int16_t>(num < 0 ? -pred : pred);
    } else {
      estimate(1, 1, -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
      estimate(2, 8, -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
      estimate(3, 16, -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
      estimate(4, 9, d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] +
                         d[22] - d[24] + d[4] - d[6] + 10 * d[7] -
                         10 * d[9]);
      estimate(5, 2, -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
    }
  }

  bool read_sos(size_t p, size_t n) {
    if (!have_frame || n < 1) return false;
    int ns = data[p];
    if (ns < 1 || ns > 4 || n != 4 + 2u * ns) return false;
    int ids[4];
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      // libjpeg-turbo's get_sos: the first component of that ID whose
      // index is not below the scan position (it tests cur_comp_info[ci],
      // the scan's slot of the component's index, for being still empty)
      int cid = data[p + 1 + 2 * i];
      int k = -1;
      for (int j = i; j < ncomp && k < 0; ++j)
        if (comp[j].id == cid) k = j;
      if (k < 0) return false;
      // a component twice in one scan: cv2 gives None
      for (int e = 0; e < i; ++e)
        if (ids[e] == k) return false;
      ids[i] = k;
      comp[k].td = data[p + 2 + 2 * i] >> 4;
      comp[k].ta = data[p + 2 + 2 * i] & 15;
      blocks += comp[k].h * comp[k].v;
    }
    if (ns > 1 && blocks > 10) return false;
    if (scans == 0 && on_frame && !on_frame()) return false;
    if (lossless) {
      size_t q = p + 1 + 2 * ns;
      pos = p + n;
      if (scans++ == 0) multiscan = ns < ncomp;
      return read_lossless(ids, ns, data[q], data[q + 1], data[q + 2] >> 4,
                           data[q + 2] & 15);
    }
    if (streaming) return false;  // a single-scan frame has one scan
    if (!buffered) {
      if (!progressive && ns == ncomp && on_row) {
        // libjpeg's single-scan mode: one MCU row of coefficients
        streaming = true;
        for (int i = 0; i < ncomp; ++i) {
          comp[i].srows = ns == 1 ? 1 : comp[i].v;
          comp[i].coef.assign(
              static_cast<size_t>(comp[i].abw) * comp[i].srows * 64, 0);
        }
      } else {
        buffered = true;
        for (int i = 0; i < ncomp; ++i)
          comp[i].coef.assign(static_cast<size_t>(comp[i].abw) *
                                  comp[i].abh * 64, 0);
      }
    }
    size_t q = p + 1 + 2 * ns;
    int ss = data[q], se = data[q + 1], ah = data[q + 2] >> 4,
        al = data[q + 2] & 15;
    pos = p + n;
    ++scans;
    return read_scan(ids, ns, ss, se, ah, al);
  }

  bool parse() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return false;
    for (;;) {
      int m = next_marker();
      if (m < 0) return false;  // no EOI
      if (m == 0xD9) {
        if (multiscan)
          for (int i = 0; i < ncomp; ++i)
            if (planes[i].empty()) return false;
        return have_frame && done;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > size) return false;
      size_t n = u16(pos);
      if (pos + n > size) return false;
      if (n < 2) {
        // libjpeg skips an APPn or COM segment of a bogus length from
        // after its length bytes; any other segment is refused
        if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) return false;
        pos += 2;
        continue;
      }
      size_t p = pos + 2;
      n -= 2;
      pos = p + n;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA) {
        if (!read_sof(p, n, m)) return false;
      } else if (m >= 0xC5 && m <= 0xCF && m != 0xC8 && m != 0xCC) {
        return false;  // hierarchical, arithmetic lossless
      } else if (m == 0xCC) {
        if (!read_dac(p, n)) return false;
      } else if (m == 0xC4) {
        if (!read_dht(p, n)) return false;
      } else if (m == 0xDB) {
        if (!read_dqt(p, n)) return false;
      } else if (m == 0xDD) {
        if (n != 2) return false;
        restart = u16(p);
      } else if (m == 0xDA) {
        if (!read_sos(p, n)) return false;
        done = true;
        // a single-scan frame is whole once its rows are out: cv2 keeps
        // the image whatever follows (libjpeg reads on only in
        // jpeg_finish_decompress, whose failure cv2 ignores)
        if (streaming || (lossless && !multiscan)) return true;
      } else if (m == 0xE0) {
        if (n >= 14 && std::memcmp(data + p, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (n >= 12 && std::memcmp(data + p, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[p + 11];
        }
      } else if (m == 0xDC) {
        return false;  // DNL is not read
      } else if (m == 0xD8 || (m < 0xE0 && m != 0xDD) || (m > 0xEF && m != 0xFE)) {
        return false;  // libjpeg's read_markers: a second SOI, an unknown marker
      }
    }
  }

  // A tables-only stream (TIFF's JPEGTables): SOI, DQT / DHT / DRI and
  // APPn / COM segments, EOI. False where jpeg_read_header(FALSE) would
  // not return JPEG_HEADER_TABLES_ONLY (libtiff's "Bogus JPEGTables").
  bool parse_tables() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return false;
    for (;;) {
      int m = next_marker();
      if (m < 0) return false;
      if (m == 0xD9) return true;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > size) return false;
      size_t n = u16(pos);
      if (n < 2 || pos + n > size) return false;
      size_t p = pos + 2;
      n -= 2;
      pos = p + n;
      if (m == 0xC4) {
        if (!read_dht(p, n)) return false;
      } else if (m == 0xDB) {
        if (!read_dqt(p, n)) return false;
      } else if (m == 0xDD) {
        if (n != 2) return false;
        restart = u16(p);
      } else if (m == 0xCC) {
        if (!read_dac(p, n)) return false;
      } else if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) {
        return false;
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

// One 8-point pass of libjpeg-turbo's AVX2 jsimd_idct_islow (the SIMD
// path cv2's libjpeg-turbo takes on x86-64): jidctint.c's arithmetic with
// the products paired as vpmaddwd pairs them, the sums in0 + in4,
// in0 - in4, in3 + in7 and in1 + in5 in 16-bit lanes (vpaddw wraps), the
// 32-bit sums wrapping (vpaddd), each output descaled by `shift` and
// saturated to int16 (vpackssdw). For a valid file every step stays in
// range and this is jidctint.c's result; a corrupt one's garbage
// coefficients wrap and saturate here as they do in cv2. A vector whose
// inputs 1-7 are zero gives in0 << 13 descaled, as the full pass does.
inline int32_t wrap16(int32_t v) { return static_cast<int16_t>(v); }
inline int32_t add32(int32_t a, int32_t b) {  // vpaddd: wraps
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

inline void idct_pass(const int16_t* in, int step, int16_t* out, int out_step,
                      int shift) {
  const int32_t x0 = in[0], x1 = in[step], x2 = in[2 * step],
                x3 = in[3 * step], x4 = in[4 * step], x5 = in[5 * step],
                x6 = in[6 * step], x7 = in[7 * step];
  const int32_t round = 1 << (shift - 1);
  if (!(x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
    const int16_t v = sat16((x0 * 8192 + round) >> shift);
    for (int k = 0; k < 8; ++k) out[k * out_step] = v;
    return;
  }
  // even part (vpmaddwd pairs fit in 32 bits)
  const int32_t tmp3 = x2 * int32_t(F0541 + F0765) + x6 * int32_t(F0541);
  const int32_t tmp2 = x2 * int32_t(F0541) + x6 * int32_t(F0541 - F1847);
  const int32_t tmp0 = wrap16(x0 + x4) * 8192;
  const int32_t tmp1 = wrap16(x0 - x4) * 8192;
  const int32_t t10 = add32(tmp0, tmp3), t13 = sub32(tmp0, tmp3),
                t11 = add32(tmp1, tmp2), t12 = sub32(tmp1, tmp2);
  // odd part
  const int32_t z3 = wrap16(x7 + x3), z4 = wrap16(x5 + x1);
  const int32_t z3s = z3 * int32_t(F1175 - F1961) + z4 * int32_t(F1175);
  const int32_t z4s = z3 * int32_t(F1175) + z4 * int32_t(F1175 - F0390);
  const int32_t o0 =
      add32(x7 * int32_t(F0298 - F0899) + x1 * int32_t(-F0899), z3s);
  const int32_t o1 =
      add32(x5 * int32_t(F2053 - F2562) + x3 * int32_t(-F2562), z4s);
  const int32_t o3 =
      add32(x7 * int32_t(-F0899) + x1 * int32_t(F1501 - F0899), z4s);
  const int32_t o2 =
      add32(x5 * int32_t(-F2562) + x3 * int32_t(F3072 - F2562), z3s);
  auto put = [&](int k, int32_t v) {
    out[k * out_step] = sat16(add32(v, round) >> shift);
  };
  put(0, add32(t10, o3));
  put(7, sub32(t10, o3));
  put(1, add32(t11, o2));
  put(6, sub32(t11, o2));
  put(2, add32(t12, o1));
  put(5, sub32(t12, o1));
  put(3, add32(t13, o0));
  put(4, sub32(t13, o0));
}

// The islow inverse DCT of one block as cv2's libjpeg-turbo computes it
// (see idct_pass): coefficients dequantised in 16 bits (vpmullw), columns
// (a block whose rows 1-7 are all zero takes row 0's DC << 2 in 16 bits
// down each column), then rows, the result saturated to int8 and offset
// by 128.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int out_stride) {
  int16_t dq[64], ws[64], res[8];
  int ac = 0;
  for (int k = 0; k < 64; ++k) {
    dq[k] = static_cast<int16_t>(int32_t(in[k]) * int32_t(q[k]));
    if (k >= 8) ac |= in[k];
  }
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = static_cast<int16_t>(int32_t(dq[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) idct_pass(dq + c, 8, ws + c, 8, 11);
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, 1, res, 1, 18);
    uint8_t* o = out + r * out_stride;
    for (int c = 0; c < 8; ++c) {
      const int v = res[c] < -128 ? -128 : res[c] > 127 ? 127 : res[c];
      o[c] = static_cast<uint8_t>(v + 128);
    }
  }
}

// Output row y of a component upsampled to `width` (libjpeg-turbo's
// jdsample.c methods; edges replicate, as its context rows do): `row(k)`
// is the component's sample row k, k clamped to [0, dh) here; `sums` holds
// dw + 2 ints.
template <typename RowFn>
void upsample_row(const RowFn& row, const Comp& c, int hs, int vs,
                  int width, int y, int* sums, uint8_t* o) {
  const int dw = c.dw, dh = c.dh;
  auto at = [&](int k) { return row(std::min(std::max(k, 0), dh - 1)); };
  // fancy vertical (h1v2, h2v2): column sums 3 * near + far, edges
  // replicated one column either side
  const bool fancy_v = vs == 2 && (hs == 1 || (hs == 2 && dw > 2));
  const bool fancy_h = hs == 2 && dw > 2;
  if (fancy_v) {
    const uint8_t* near = at(y >> 1);
    const uint8_t* far = at((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
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
    const uint8_t* r = at(y);
    for (int x = 0; x < dw; ++x) sums[x + 1] = r[x];
    sums[0] = sums[1];
    sums[dw + 1] = sums[dw];
    for (int x = 0; x < width; ++x) {
      const int* t = &sums[(x >> 1) + 1];
      o[x] = static_cast<uint8_t>(
          (x & 1) ? (t[0] * 3 + t[1] + 2) >> 2 : (t[0] * 3 + t[-1] + 1) >> 2);
    }
  } else {
    const uint8_t* r = at(y / vs);
    if (hs == 1) {
      std::memcpy(o, r, width);
    } else {
      for (int x = 0; x < width; ++x) o[x] = r[x / hs];
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
    if (j.pos + len > j.size) return -1;
    if (len < 2) {  // an APPn or COM of a bogus length is skipped (parse())
      if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) return -1;
      len = 2;
    }
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      // what get_sof and initial_setup refuse while cv2 reads the header
      if (len < 8) return -1;
      const int nc = buf[j.pos + 7];
      if (nc < 1 || nc > 10 || len != 8 + 3u * nc) return -1;
      for (int i = 0; i < nc; ++i) {
        const int hv = buf[j.pos + 9 + 3 * i];
        if ((hv >> 4) < 1 || (hv >> 4) > 4 || (hv & 15) < 1 || (hv & 15) > 4)
          return -1;
      }
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

// One output row from its components' upsampled rows: as they are, or
// YCbCr -> RGB (3 components), YCCK -> CMYK (4), as libjpeg converts.
void convert_row(const uint8_t* const* up, int W, int nc, bool convert,
                 uint8_t* px) {
  static const YccTables t;
  uint8_t* o = px;
  for (int x = 0; x < W; ++x, o += nc) {
    if (!convert) {
      for (int ci = 0; ci < nc; ++ci) o[ci] = up[ci][x];
      continue;
    }
    int yy = up[0][x], cb = up[1][x], cr = up[2][x];
    int r = yy + t.cr_r[cr];
    int g = yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16);
    int b = yy + t.cb_b[cb];
    if (nc == 3) {
      o[0] = static_cast<uint8_t>(clamp255(r));
      o[1] = static_cast<uint8_t>(clamp255(g));
      o[2] = static_cast<uint8_t>(clamp255(b));
    } else {  // ycck_cmyk_convert: inverted RGB, K passed through
      o[0] = static_cast<uint8_t>(clamp255(255 - r));
      o[1] = static_cast<uint8_t>(clamp255(255 - g));
      o[2] = static_cast<uint8_t>(clamp255(255 - b));
      o[3] = up[3][x];
    }
  }
}

// MCU rows of samples to output rows: each unit (an MCU row; a block row
// of a single-component frame) is transformed by the islow IDCT into a
// ring of three units a component, and a unit's output rows are upsampled
// and colour-converted once the unit below it is in the ring (or is the
// last), as libjpeg's context rows allow.
struct Rows {
  Jpeg& j;
  int W, H, nc, units, out_rows;
  int U[4], pstride[4];
  bool convert = false;
  std::vector<uint8_t> ring[4], up[4], px;
  std::vector<int> sums;
  std::function<void(int, const uint8_t*, int)> sink;  // (y, W * nc, nc)
  bool smooth = false;  // libjpeg's block smoothing (a buffered frame)

  Rows(Jpeg& jp, std::function<void(int, const uint8_t*, int)> s)
      : j(jp), W(jp.width), H(jp.height), nc(jp.ncomp), sink(std::move(s)) {
    smooth = j.buffered && j.smoothing();
    const bool single = nc == 1;
    units = single ? j.comp[0].bh : j.mcuy;
    out_rows = single ? 8 : 8 * j.vmax;
    int widest = 0;
    for (int ci = 0; ci < nc; ++ci) {
      const Comp& c = j.comp[ci];
      U[ci] = single ? 8 : 8 * c.v;
      pstride[ci] = c.bw * 8;
      ring[ci].assign(static_cast<size_t>(3) * U[ci] * pstride[ci], 0);
      up[ci].assign(W, 0);
      widest = std::max(widest, c.dw);
    }
    sums.assign(widest + 2, 0);
    px.assign(static_cast<size_t>(W) * nc, 0);
    // jdapimin.c default_decompress_parms: which space the file is in
    if (j.force_convert >= 0) {
      convert = j.force_convert && nc == 3;
    } else if (nc == 3) {
      if (j.jfif) convert = true;
      else if (j.adobe) convert = j.adobe_transform != 0;
      else convert = !(j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
                       j.comp[2].id == 'B');
    } else if (nc == 4) {
      convert = j.adobe && j.adobe_transform != 0;  // YCCK, else CMYK
    }
  }

  const uint8_t* row(int ci, int k) const {
    const int u = U[ci];
    return &ring[ci][(static_cast<size_t>(k / u % 3) * u + k % u) *
                     pstride[ci]];
  }

  // the samples of unit k, from the coefficients j.block() gives
  void transform(int k) {
    for (int ci = 0; ci < nc; ++ci) {
      Comp& c = j.comp[ci];
      const uint16_t* q = j.qt[c.tq];
      const int brows = U[ci] / 8, ps = pstride[ci];
      uint8_t* base = &ring[ci][static_cast<size_t>(k % 3) * U[ci] * ps];
      for (int lb = 0; lb < brows; ++lb) {
        const int by = k * brows + lb;
        if (by >= c.bh) break;
        int16_t ws[64];
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* coef = j.block(c, by, bx);
          if (smooth) {
            j.smooth_block(ci, by, bx, ws);
            coef = ws;
          }
          idct_islow(coef, q, base + static_cast<size_t>(lb) * 8 * ps + bx * 8,
                     ps);
        }
      }
    }
  }

  // the output rows of unit k, upsampled and converted, to the sink
  void emit(int k) {
    const int y1 = std::min((k + 1) * out_rows, H);
    for (int y = k * out_rows; y < y1; ++y) {
      for (int ci = 0; ci < nc; ++ci) {
        const Comp& c = j.comp[ci];
        upsample_row([&](int r) { return row(ci, r); }, c, j.hmax / c.h,
                     j.vmax / c.v, W, y, sums.data(), up[ci].data());
      }
      const uint8_t* rows[4] = {up[0].data(), up[1].data(), up[2].data(),
                                nc > 3 ? up[3].data() : nullptr};
      convert_row(rows, W, nc, convert, px.data());
      sink(y, px.data(), nc);
    }
  }

  // unit k has been transformed: the unit above it can go out
  void push(int k) {
    transform(k);
    if (k > 0) emit(k - 1);
  }
};

// Whether libjpeg-turbo decodes a lossless frame into the output space
// asked for (`colour`: cv2's BGR; else the file's own space): it converts
// no colour space in lossless mode, and takes three components for RGB
// unless a JFIF marker or an Adobe transform says YCbCr (its
// default_decompress_parms; component IDs 1, 2, 3 mean RGB here), four for
// CMYK unless Adobe's transform 2 says YCCK.
bool lossless_space_ok(const Jpeg& j, bool colour) {
  if (j.ncomp == 1) return !colour;
  if (j.ncomp == 3)
    return !j.jfif && !(j.adobe && j.adobe_transform != 0);
  return !(j.adobe && j.adobe_transform == 2);
}

// The rows of a decoded lossless frame: each sample shifted left by the
// point transform and cut to 8 bits (libjpeg-turbo's scaler into 8-bit
// samples), components upsampled by replication (libjpeg gives no fancy
// upsampling to 1-sample data units), no colour conversion.
void emit_lossless(Jpeg& j,
                   const std::function<void(int, const uint8_t*, int)>& sink) {
  const int W = j.width, nc = j.ncomp;
  std::vector<uint8_t> up[4], px(static_cast<size_t>(W) * nc);
  for (int ci = 0; ci < nc; ++ci) up[ci].assign(W, 0);
  for (int y = 0; y < j.height; ++y) {
    for (int ci = 0; ci < nc; ++ci) {
      const Comp& c = j.comp[ci];
      const int hs = j.hmax / c.h, vs = j.vmax / c.v;
      const uint16_t* r =
          &j.planes[ci][static_cast<size_t>(y / vs) * c.dw];
      for (int x = 0; x < W; ++x)
        up[ci][x] = static_cast<uint8_t>(r[x / hs] << j.comp_pt[ci]);
    }
    const uint8_t* rows[4] = {up[0].data(), nc > 1 ? up[1].data() : nullptr,
                              nc > 2 ? up[2].data() : nullptr,
                              nc > 3 ? up[3].data() : nullptr};
    convert_row(rows, W, nc, false, px.data());
    sink(y, px.data(), nc);
  }
}

// The components of a JPEG of the frame size h x w after libjpeg's colour
// conversion to its default output space — grey (1), RGB (3, from YCbCr
// unless the file says RGB) or CMYK (4, from YCCK under an Adobe transform
// 2) — row by row to `sink(y, row, ncomp)` (w * ncomp samples). → ncomp,
// or -1 (rows already sunk are then to be discarded).
int decode_native(const uint8_t* buf, long long n, int h, int w,
                  const std::function<void(int, const uint8_t*, int)>& sink,
                  bool colour = false) {
  Jpeg j;
  j.data = buf;
  j.size = static_cast<size_t>(n);
  std::unique_ptr<Rows> rows;
  // a baseline frame whose first scan holds every component streams
  j.on_row = [&](int k) {
    if (!rows) {
      if (j.height != h || j.width != w) return false;
      rows.reset(new Rows(j, sink));
    }
    rows->push(k);
    return true;
  };
  j.on_end = [&]() {
    if (!rows) return false;
    rows->emit(rows->units - 1);
    return true;
  };
  if (!j.parse() || j.height != h || j.width != w) return -1;
  if (j.lossless) {
    if (!lossless_space_ok(j, colour)) return -1;
    emit_lossless(j, sink);
  } else if (j.buffered) {
    Rows r(j, sink);
    for (int k = 0; k < r.units; ++k) r.push(k);
    r.emit(r.units - 1);
    for (int ci = 0; ci < j.ncomp; ++ci)
      std::vector<int16_t>().swap(j.comp[ci].coef);
  } else if (!rows) {
    return -1;
  }
  return j.ncomp;
}

// One strip or tile of a JPEG-compressed TIFF as libtiff's tif_jpeg.c
// decodes it: the JPEGTables stream read first (its tables kept), the
// strip's own header checked as JPEGPreDecode checks it (components,
// sampling factors of TIFF's YCbCrSubsampling, a frame no larger than the
// segment unless a last strip is taller), the colour space libtiff sets
// (YCbCr -> RGB, or none), a fake EOI where the data ends, and the rows
// written into the strip buffer (out_rows rows of bpl bytes, no row's copy
// longer than bpl) as they come. → 1, 0 where decoding failed after the first scan began (the rows
// out are kept, as TIFFReadRGBA* keeps its buffer), -1 where libtiff
// refuses the strip before decoding.
int jpeg_tiff(const uint8_t* tables, long long tn, const uint8_t* buf,
              long long n, int seg_w, int seg_h, int taller_ok, int ncomp,
              int hs, int vs, int ycc, uint8_t* out, long long bpl,
              int out_rows) {
  std::vector<uint8_t> strip(buf, buf + n);
  strip.push_back(0xFF);
  strip.push_back(0xD9);
  Jpeg j;
  // libtiff's tables source ends in a fake EOI too, which it hands libjpeg
  // again at each read past the end: a segment that runs past the tables
  // reads FF D9 pairs to its length (up to 64 KiB), tried only where the
  // tables do not parse without them
  std::vector<uint8_t> tabs(tables, tables + std::max(0LL, tn));
  tabs.push_back(0xFF);
  tabs.push_back(0xD9);
  if (tn > 0) {
    j.data = tabs.data();
    j.size = tabs.size();
    if (!j.parse_tables()) {
      j = Jpeg();
      for (int k = 0; k < 32768; ++k) {
        tabs.push_back(0xFF);
        tabs.push_back(0xD9);
      }
      j.data = tabs.data();
      j.size = tabs.size();
      if (!j.parse_tables()) return -1;
    }
  }
  j.data = strip.data();
  j.size = strip.size();
  j.pos = 2;
  j.force_convert = ycc ? 1 : 0;
  j.on_frame = [&]() {
    if (j.lossless || j.ncomp != ncomp || j.comp[0].h != hs ||
        j.comp[0].v != vs)
      return false;
    for (int ci = 1; ci < j.ncomp; ++ci)
      if (j.comp[ci].h != 1 || j.comp[ci].v != 1) return false;
    if (j.width > seg_w || j.height > seg_h)
      return j.width == seg_w && taller_ok;
    return true;
  };
  auto sink = [&](int y, const uint8_t* px, int nc) {
    if (y < out_rows)
      std::memcpy(out + static_cast<size_t>(y) * bpl, px,
                  std::min(static_cast<size_t>(j.width) * nc,
                           static_cast<size_t>(bpl)));
  };
  std::unique_ptr<Rows> rows;
  j.on_row = [&](int k) {
    if (!rows) rows.reset(new Rows(j, sink));
    rows->push(k);
    return true;
  };
  j.on_end = [&]() {
    if (!rows) return false;
    rows->emit(rows->units - 1);
    return true;
  };
  const bool ok = j.parse();
  if (!ok) return j.started && !j.buffered ? 0 : -1;
  if (j.buffered) {
    Rows r(j, sink);
    for (int k = 0; k < r.units; ++k) r.push(k);
    r.emit(r.units - 1);
  }
  return 1;
}

// Netpbm's ASCII numbers as cv2's PxMDecoder reads them (ReadNumber, in
// grfmt_pxm.cpp): n numbers from buf[*pos] into out, each min(v, clip).
// Before a number, whitespace and '#' comments (to a '\n' or '\r', which
// is read too) are skipped and any other byte is an error. A number is its
// digits, only the first one when `single` (P1's samples); otherwise the
// byte after the digits, whatever it is, is read too. → 0 with *pos past
// what was read, or -1 where cv2 raises: another byte before a number, a
// value past INT_MAX, the end of the data.
template <typename T>
int pxm_numbers(const uint8_t* buf, long long size, long long* pos,
                       long long n, int single, long long clip, T* out) {
  long long p = *pos;
  auto space = [](int c) { return c == ' ' || (c >= '\t' && c <= '\r'); };
  auto digit = [](int c) { return c >= '0' && c <= '9'; };
  for (long long i = 0; i < n; ++i) {
    if (p >= size) return -1;
    int code = buf[p++];
    while (!digit(code)) {
      if (code == '#') {
        do {
          if (p >= size) return -1;
          code = buf[p++];
        } while (code != '\n' && code != '\r');
        if (p >= size) return -1;
        code = buf[p++];
      } else if (space(code)) {
        while (space(code)) {
          if (p >= size) return -1;
          code = buf[p++];
        }
      } else {
        return -1;
      }
    }
    long long v = 0;
    for (;;) {
      v = v * 10 + (code - '0');
      if (v > 0x7FFFFFFF) return -1;
      if (single) break;
      if (p >= size) return -1;
      code = buf[p++];
      if (!digit(code)) break;
    }
    out[i] = static_cast<T>(std::min(v, clip));
  }
  *pos = p;
  return 0;
}

}  // namespace

extern "C" {

// Decode a JPEG of the size ocr_jpeg_size gave into out (h * w * 3 BGR, in
// the stored orientation; the caller applies the EXIF tag), as cv2's
// IMREAD_COLOR converts libjpeg's output (CMYK by icvCvt_CMYK2BGR). → 0,
// or -1 where cv2.imdecode gives None (or the format is not read).
int ocr_jpeg_decode(const uint8_t* buf, long long n, int h, int w,
                    uint8_t* out) try {
  const size_t W = static_cast<size_t>(w);
  auto bgr = [&](int y, const uint8_t* px, int nc) {
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    for (size_t x = 0; x < W; ++x, o += 3) {
      const uint8_t* s = px + x * nc;
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
  };
  return decode_native(buf, n, h, w, bgr, true) < 0 ? -1 : 0;
} catch (...) {  // out of memory
  return -1;
}

// The JPEG's components in libjpeg's output space (grey, RGB or CMYK,
// stored orientation) into out (h * w * 4 bytes at most): → their number,
// or -1.
int ocr_jpeg_decode_native(const uint8_t* buf, long long n, int h, int w,
                           uint8_t* out) try {
  const size_t W = static_cast<size_t>(w);
  return decode_native(buf, n, h, w, [&](int y, const uint8_t* px, int nc) {
    std::memcpy(out + static_cast<size_t>(y) * W * nc, px, W * nc);
  });
} catch (...) {
  return -1;
}

// One strip or tile of a JPEG-compressed TIFF: jpeg_tiff's answer.
int ocr_jpeg_tiff(const uint8_t* tables, long long tn, const uint8_t* buf,
                  long long n, int seg_w, int seg_h, int taller_ok, int ncomp,
                  int hs, int vs, int ycc, uint8_t* out, long long bpl,
                  int out_rows) try {
  return jpeg_tiff(tables, tn, buf, n, seg_w, seg_h, taller_ok, ncomp, hs, vs,
                   ycc, out, bpl, out_rows);
} catch (...) {  // out of memory
  return -1;
}

// TIFF LZW as libtiff 4.7's LZWDecode reads a strip or tile: `in` (n
// bytes, MSB-first codes) into out (`need` bytes, zeroed by the caller).
// Codes start at 9 bits and widen one code early (at 511, 1023, 2047), up
// to 12; 256 clears the table and 257 ends the data. The data must start
// with a clear (the table starts with no free entry), and the table takes
// entries up to 5118, past which any code but a clear is refused. Data
// past `need` is ignored, as libtiff stops there. → need, or -1 where
// libtiff fails, with the bytes decoded before the fault left in out: a
// code past the next free one ("Using code not yet in table"), data that
// ends before an end code ("not terminated with EOI code") or an end code
// before `need` bytes ("Not enough data").
long long ocr_tiff_lzw(const uint8_t* in, long long n, uint8_t* out,
                       long long need) try {
  const int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  struct Entry {
    int next, length;
    uint8_t value, firstchar;
  };
  std::vector<Entry> tab(kSize);
  for (int c = 0; c < 256; ++c) tab[c] = {-1, 1, uint8_t(c), uint8_t(c)};
  tab[kClear] = tab[kEoi] = {-1, 0, 0, 0};
  long long bitpos = 0, total_bits = n * 8, op = 0;
  int nbits = 9, free_ent = -1, old = 0;
  int maxcode = (1 << nbits) - 2;  // the last entry before widening
  auto read_code = [&](int& code) {
    if (bitpos + nbits > total_bits) return false;
    int v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos)
      v = (v << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    code = v;
    return true;
  };
  auto add = [&](uint8_t value) {  // a new entry: old's string + value
    Entry& e = tab[free_ent];
    e = {old, tab[old].length + 1, value, tab[old].firstchar};
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, 12);
      maxcode = (1 << nbits) - 2;
      if (free_ent >= kSize) free_ent = -1;
    }
  };
  auto emit = [&](int code) {  // the string of `code`, clipped to need
    long long end = op + tab[code].length;
    int c = code;
    for (long long k = end - 1; k >= op; --k, c = tab[c].next)
      if (k < need) out[k] = tab[c].value;
    op = std::min(end, need);
  };
  while (op < need) {
    int code;
    if (!read_code(code)) return -1;
    if (code == kEoi) return -1;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = 9;
      maxcode = (1 << nbits) - 2;
      do {
        if (!read_code(code)) return -1;
      } while (code == kClear);
      if (code == kEoi || code > kEoi) return -1;
      out[op++] = uint8_t(code);
      old = code;
      continue;
    }
    if (code < 256) {
      if (free_ent < 0) return -1;
      add(uint8_t(code));
    } else {
      if (free_ent < 0 || code > free_ent) return -1;
      add(code == free_ent ? tab[old].firstchar : tab[code].firstchar);
    }
    old = code;
    emit(code);
  }
  return need;
} catch (...) {
  return -1;
}

// Old-style TIFF LZW as libtiff 4.7's LZWDecodeCompat reads a strip: codes
// LSB-first, widening at 511, 1023, 2047 (no early change), up to 12
// bits; the data must start with a clear. Each code adds an entry without
// checking it against the next free one, so a code past the table names
// an empty entry ("Wrong length of decoded string"). → need, or -1 where
// libtiff fails, the bytes decoded before the fault left in out (zeroed
// by the caller).
long long ocr_tiff_lzw_compat(const uint8_t* in, long long n, uint8_t* out,
                              long long need) try {
  const int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  struct Entry {
    int next, length;
    uint8_t value, firstchar;
  };
  std::vector<Entry> tab(kSize, Entry{-1, 0, 0, 0});
  for (int c = 0; c < 256; ++c) tab[c] = {-1, 1, uint8_t(c), uint8_t(c)};
  long long bitpos = 0, total_bits = n * 8, op = 0;
  int nbits = 9, free_ent = -1, old = 0, maxcode = (1 << 9) - 2;
  auto read_code = [&]() {
    if (bitpos + nbits > total_bits) return kEoi;  // "not terminated"
    int v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos)
      v |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << k;
    return v;
  };
  while (op < need) {
    int code = read_code();
    if (code == kEoi) return -1;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        std::fill(tab.begin() + kFirst, tab.end(), Entry{-1, 0, 0, 0});
        nbits = 9;
        maxcode = (1 << nbits) - 1;
        code = read_code();
      } while (code == kClear);
      if (code == kEoi || code > kClear) return -1;
      out[op++] = uint8_t(code);
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kSize) return -1;  // corrupted table
    Entry& e = tab[free_ent];
    e = {old, tab[old].length + 1, 0, tab[old].firstchar};
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, 12);
      maxcode = (1 << nbits) - 1;
    }
    old = code;
    if (code < 256) {
      out[op++] = uint8_t(code);
      continue;
    }
    const int len = tab[code].length;
    if (len == 0) return -1;  // wrong length of decoded string
    long long end = op + len;
    int c = code;
    for (long long k = end - 1; k >= op && c >= 0; --k, c = tab[c].next)
      if (k < need) out[k] = tab[c].value;
    op = std::min(end, need);
  }
  return need;
} catch (...) {
  return -1;
}

// TIFF PackBits (tif_packbits.c): `in` into out (`need` bytes, zeroed by
// the caller), a run clipped where it would pass `need`. → need, or -1
// where the data end first ("Not enough data"), the runs decoded before
// that left in out (a literal run the data cut short is dropped whole).
long long ocr_tiff_packbits(const uint8_t* in, long long n, uint8_t* out,
                            long long need) {
  long long ip = 0, op = 0;
  while (ip < n && op < need) {
    int c = int8_t(in[ip++]);
    if (c < 0) {
      if (c == -128) continue;
      long long run = std::min<long long>(-c + 1, need - op);
      if (ip >= n) break;
      std::memset(out + op, in[ip++], size_t(run));
      op += run;
    } else {
      long long run = std::min<long long>(c + 1, need - op);
      if (n - ip < run) break;
      std::memcpy(out + op, in + ip, size_t(run));
      op += run;
      ip += run;
    }
  }
  return op < need ? -1 : need;
}

int ocr_pxm_header(const uint8_t* buf, long long size, long long* pos,
                   long long n, int32_t* out) {
  return pxm_numbers(buf, size, pos, n, 0, 0x7FFFFFFF, out);
}

// The samples of a P1–P3 file, clipped to 65535 (no maxval goes higher).
int ocr_pxm_samples(const uint8_t* buf, long long size, long long* pos,
                    long long n, int single, uint16_t* out) {
  return pxm_numbers(buf, size, pos, n, single, 65535, out);
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

// ------------------------------------------------------------------ WebP
//
// libwebp's decoder as cv2.imdecode drives it (WebPGetFeatures on the first
// 32 bytes, WebPDecodeBGRInto / BGRAInto on the whole buffer, and for an
// animated file WebPDemux + WebPAnimDecoder's first frame on a zeroed
// canvas), with the colour channels kept and alpha dropped:
// * VP8L (lossless): prefix codes (simple and normal, the meta prefix
//   image), LZ77 copies with the 120-entry 2-D distance map, the colour
//   cache, the predictor (14 modes), cross-colour, subtract-green and
//   colour-indexing (pixel bundling) transforms. Decoded pixels live in a
//   ring of 2^21 (the longest copy distance is 2^20 - 120), transformed and
//   written out row by row.
// * VP8 (lossy, RFC 6386 key frames): boolean decoder, segments, token
//   partitions, coefficient probability updates, intra prediction, inverse
//   DCT / WHT, simple and normal loop filters with their deltas; macroblock
//   rows are filtered in a cache of 16 + 8 rows and converted with
//   libwebp's "fancy" 4:2:0 upsampler and 14-bit YUV -> BGR.
// * The ALPH chunk (raw or VP8L-coded) is decoded, so that a file whose
//   alpha libwebp refuses is refused, and dropped.
// The probability, quantiser and distance tables are RFC 6386's and the
// WebP lossless specification's.

namespace {
namespace wp {

const uint8_t kWpDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kWpAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kWpCoeffsUpdate[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kWpCoeffs0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kWpBModes[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kWpCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (static_cast<uint32_t>(p[3]) << 24);
}

// ---- VP8L

// LSB-first bit reader. Past the end it reads zeros; libwebp flags the
// end of the stream once more bits were read than exist (and no sooner
// than 64 bits into a stream shorter than 8 bytes, its window).
struct LBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0, avail;
  LBits(const uint8_t* d, size_t len)
      : p(d), n(len), avail(std::max<uint64_t>(uint64_t(len) * 8, 64)) {}
  uint64_t window() const {
    const uint64_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n) {
      for (int i = 7; i >= 0; --i) v = (v << 8) | p[byte + i];
    } else {
      for (uint64_t i = 0; i < 8 && byte + i < n; ++i)
        v |= static_cast<uint64_t>(p[byte + i]) << (8 * i);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = static_cast<uint32_t>(window() & ((1ull << k) - 1));
    pos += k;
    return v;
  }
  bool eos() const { return pos > avail; }
};

// A prefix-code lookup table as libwebp builds it: a root table indexed
// by the next `root` bits; entries of longer codes point to a second
// level table (bits = root + its size, value = offset from the entry).
struct HCode {
  uint8_t bits;
  uint16_t value;
};

struct HTree {
  uint32_t off = 0;
  int root = 0;
};

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HCode* t, int step, int end, HCode c) {
  do {
    end -= step;
    t[end] = c;
  } while (end > 0);
}

// VP8LBuildHuffmanTable: false where libwebp refuses the lengths (a
// length above 15, none set, or an incomplete / over-full code that is not
// a single symbol). The root is min(8, longest code) bits wide.
bool build_tree(std::vector<HCode>& pool, const int* len, int n, HTree* t) {
  int count[16] = {0}, offset[16];
  for (int s = 0; s < n; ++s) {
    if (len[s] > 15 || len[s] < 0) return false;
    ++count[len[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int l = 1; l < 15; ++l) {
    if (count[l] > (1 << l)) return false;
    offset[l + 1] = offset[l] + count[l];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (len[s] > 0) sorted[offset[len[s]]++] = static_cast<uint16_t>(s);
  const int nsym = offset[15];
  const uint32_t base = static_cast<uint32_t>(pool.size());
  t->off = base;
  if (nsym == 1) {
    t->root = 0;
    pool.push_back({0, sorted[0]});
    return true;
  }
  int maxlen = 0;
  for (int l = 1; l <= 15; ++l)
    if (count[l]) maxlen = l;
  const int root = std::min(8, maxlen);
  t->root = root;
  pool.resize(base + (1u << root));
  int cnt[16];
  std::copy(count, count + 16, cnt);
  uint32_t key = 0;
  int num_nodes = 1, num_open = 1, sym = 0;
  int len_ = 1, step = 2;
  for (; len_ <= root; ++len_, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= cnt[len_];
    if (num_open < 0) return false;
    for (; cnt[len_] > 0; --cnt[len_]) {
      replicate(&pool[base + key], step, 1 << root,
                {static_cast<uint8_t>(len_), sorted[sym++]});
      key = next_key(key, len_);
    }
  }
  const uint32_t mask = (1u << root) - 1;
  uint32_t low = 0xffffffffu, table = base;
  int table_size = 1 << root;
  for (len_ = root + 1, step = 2; len_ <= 15; ++len_, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= cnt[len_];
    if (num_open < 0) return false;
    for (; cnt[len_] > 0; --cnt[len_]) {
      if ((key & mask) != low) {
        table += table_size;
        int l = len_, left = 1 << (l - root);
        while (l < 15) {
          left -= cnt[l];
          if (left <= 0) break;
          ++l;
          left <<= 1;
        }
        const int table_bits = l - root;
        table_size = 1 << table_bits;
        pool.resize(table + table_size);
        low = key & mask;
        pool[base + low] = {static_cast<uint8_t>(table_bits + root),
                            static_cast<uint16_t>(table - base - low)};
      }
      replicate(&pool[table + (key >> root)], step, table_size,
                {static_cast<uint8_t>(len_ - root), sorted[sym++]});
      key = next_key(key, len_);
    }
  }
  return num_nodes == 2 * nsym - 1;
}

inline int read_symbol(LBits& br, const HCode* pool, const HTree& t) {
  uint64_t val = br.window();
  const HCode* e = pool + t.off + (val & ((1u << t.root) - 1));
  const int nbits = e->bits - t.root;
  if (nbits > 0) {
    br.pos += t.root;
    val >>= t.root;
    e += e->value + (val & ((1u << nbits) - 1));
  }
  br.pos += e->bits;
  return e->value;
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};

// ReadHuffmanCode(Lengths): one prefix code of `alphabet` symbols into the
// pool. lens is scratch of >= 2328 entries (a simple code may name a
// symbol up to 255 whatever the alphabet; libwebp ignores it then).
bool read_code(LBits& br, int alphabet, int* lens, std::vector<HCode>& pool,
               HTree* t) {
  std::fill(lens, lens + alphabet, 0);
  if (br.read(1)) {  // simple code
    const int num = br.read(1) + 1;
    const int first_8bit = br.read(1);
    lens[br.read(first_8bit ? 8 : 1)] = 1;
    if (num == 2) lens[br.read(8)] = 1;
  } else {
    int cl[19] = {0};
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    std::vector<HCode> lpool;
    HTree lt;
    if (!build_tree(lpool, cl, 19, &lt)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) return false;
    }
    int prev = 8, sym = 0;
    while (sym < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = read_symbol(br, lpool.data(), lt);
      if (c < 16) {
        lens[sym++] = c;
        if (c) prev = c;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = br.read(kExtra[c - 16]) + kOffset[c - 16];
        if (sym + repeat > alphabet) return false;
        const int v = c == 16 ? prev : 0;
        while (repeat-- > 0) lens[sym++] = v;
      }
    }
  }
  if (br.eos()) return false;
  return build_tree(pool, lens, alphabet, t);
}

inline int sub_size(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}


// The prefix codes of one image stream (its colour cache and
// ReadHuffmanCodes): 5 trees a group, the group of a pixel read from the
// meta image (level 0 only).
struct Codes {
  int cache_bits = 0;
  int meta_bits = 0, meta_w = 0;
  std::vector<uint32_t> meta;  // tree-group index of each meta pixel
  std::vector<HTree> trees;    // 5 a group: green, red, blue, alpha, dist
  std::vector<HCode> pool;
  bool trivial_rba = true;     // every red, blue and alpha code 1 symbol
};

const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

bool decode_sub(LBits& br, int w, int h, std::vector<uint32_t>& out);

bool read_codes(LBits& br, int w, int h, bool level0, Codes& c) {
  if (br.read(1)) {
    c.cache_bits = br.read(4);
    if (c.cache_bits < 1 || c.cache_bits > 11) return false;
  }
  int num_groups = 1;
  std::vector<int32_t> map;  // group -> stored index, -1 where unused
  if (level0 && br.read(1)) {
    c.meta_bits = br.read(3) + 2;
    c.meta_w = sub_size(w, c.meta_bits);
    if (!decode_sub(br, c.meta_w, sub_size(h, c.meta_bits), c.meta))
      return false;
    for (uint32_t& g : c.meta) {
      g = (g >> 8) & 0xffff;
      num_groups = std::max<int>(num_groups, g + 1);
    }
    map.assign(num_groups, -1);
    for (uint32_t g : c.meta) map[g] = 0;
    int used = 0;
    for (int32_t& m : map)
      if (m == 0) m = used++;
    for (uint32_t& g : c.meta) g = map[g];
  }
  std::vector<int> lens(256 + 24 + 2048 + 256);
  std::vector<HCode> scratch;
  for (int g = 0; g < num_groups; ++g) {
    const bool keep = map.empty() || map[g] >= 0;
    for (int j = 0; j < 5; ++j) {
      const int alphabet =
          kAlphabet[j] + (j == 0 && c.cache_bits ? 1 << c.cache_bits : 0);
      HTree t;
      if (keep) {
        if (!read_code(br, alphabet, lens.data(), c.pool, &t)) return false;
        c.trees.push_back(t);
        if (j >= 1 && j <= 3 && c.pool[t.off].bits > 0) c.trivial_rba = false;
      } else {
        scratch.clear();
        if (!read_code(br, alphabet, lens.data(), scratch, &t)) return false;
      }
    }
  }
  return true;
}

inline int copy_value(int sym, LBits& br) {  // GetCopyDistance / Length
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + br.read(extra) + 1;
}

inline int plane_to_dist(int w, int code) {
  if (code > 120) return code - 120;
  const int d = kWpCodeToPlane[code - 1];
  const int dist = (d >> 4) * w + (8 - (d & 0xf));
  return dist >= 1 ? dist : 1;
}

// The entropy-coded pixels of a w x h image into ring[pos & mask]
// (mask = all ones: no wrap), row_done(y) after each row completes. The
// stream fails (false) as libwebp's DecodeImageData fails: a copy from
// before the start or past the end, or more bits read than the stream
// holds; with alpha8b, as DecodeAlphaData (the end of the stream may be
// passed in the step that writes the last pixel).
template <class RowFn>
bool run_pixels(LBits& br, const Codes& c, int w, int h, uint32_t* ring,
                uint64_t mask, bool alpha8b, RowFn row_done) {
  const uint64_t total = uint64_t(w) * h;
  std::vector<uint32_t> cache(c.cache_bits ? 1u << c.cache_bits : 0);
  const int cache_shift = 32 - c.cache_bits;
  const int len_limit = 256 + 24;
  const HCode* pool = c.pool.data();
  uint64_t pos = 0;
  int col = 0, row = 0;
  auto put = [&](uint32_t px) {
    ring[pos & mask] = px;
    if (c.cache_bits) cache[(px * 0x1e35a7bdu) >> cache_shift] = px;
    ++pos;
  };
  auto advance_rows = [&]() -> bool {
    while (col >= w) {
      col -= w;
      row_done(row++);
      if (!alpha8b && br.eos()) return false;
    }
    return true;
  };
  while (pos < total) {
    const HTree* g = c.trees.data();
    if (c.meta_bits)
      g += 5 * c.meta[(row >> c.meta_bits) * c.meta_w + (col >> c.meta_bits)];
    const int code = read_symbol(br, pool, g[0]);
    if (code < 256) {
      const uint32_t r = read_symbol(br, pool, g[1]);
      const uint32_t b = read_symbol(br, pool, g[2]);
      const uint32_t a = read_symbol(br, pool, g[3]);
      put((a << 24) | (r << 16) | (uint32_t(code) << 8) | b);
      ++col;
    } else if (code < len_limit) {
      const int length = copy_value(code - 256, br);
      const int dist =
          plane_to_dist(w, copy_value(read_symbol(br, pool, g[4]), br));
      if (!alpha8b && br.eos()) return false;
      if (pos < uint64_t(dist) || total - pos < uint64_t(length)) return false;
      for (int i = 0; i < length; ++i) put(ring[(pos - dist) & mask]);
      col += length;
    } else {
      put(cache[code - len_limit]);
      ++col;
    }
    if (!advance_rows()) return false;
    if (alpha8b && br.eos() && pos < total) return false;
  }
  return alpha8b || !br.eos();
}

bool decode_sub(LBits& br, int w, int h, std::vector<uint32_t>& out) {
  Codes c;
  if (!read_codes(br, w, h, false, c)) return false;
  out.assign(size_t(w) * h, 0);
  return run_pixels(br, c, w, h, out.data(), ~0ull, false, [](int) {});
}

// ---- VP8L transforms

enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndex = 3 };

struct Transform {
  int type, bits, xsize;  // xsize: the width this inverse transform makes
  std::vector<uint32_t> data;
};

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) {
  return std::abs(b - c) - std::abs(a - c);
}
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // T, L, TL
  const int d = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t o = 0;
  for (int s = 0; s < 32; s += 8)
    o |= clip255(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) -
                 ((c2 >> s) & 0xff)) << s;
  return o;
}
inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = avg2(c0, c1);
  uint32_t o = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    o |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return o;
}

inline uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return avg2(avg2(L, top[1]), top[0]);
    case 6: return avg2(L, top[-1]);
    case 7: return avg2(L, top[0]);
    case 8: return avg2(top[-1], top[0]);
    case 9: return avg2(top[0], top[1]);
    case 10: return avg2(avg2(L, top[-1]), avg2(top[0], top[1]));
    case 11: return select(top[0], L, top[-1]);
    case 12: return add_sub_full(L, top[0], top[-1]);
    case 13: return add_sub_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14, 15 as libwebp pads them
  }
}

inline int color_delta(int8_t t, int8_t c) { return (int(t) * int(c)) >> 5; }

// One row y of transform t: in (its input width) -> out (t.xsize). prev
// is the predictor's previous output row (t.xsize + 1 entries).
void inverse_row(const Transform& t, int y, const uint32_t* in,
                 uint32_t* out, std::vector<uint32_t>& prev) {
  const int w = t.xsize;
  switch (t.type) {
    case kPredictor: {
      uint32_t* top = prev.data() + 1;  // top[-1] valid from x = 1
      if (y == 0) {
        out[0] = add_px(in[0], 0xff000000u);
        for (int x = 1; x < w; ++x) out[x] = add_px(in[x], out[x - 1]);
      } else {
        const int tiles = sub_size(w, t.bits);
        const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
        out[0] = add_px(in[0], top[0]);
        top[w] = out[0];
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          out[x] = add_px(in[x], predict(mode, out[x - 1], top + x));
        }
      }
      std::copy(out, out + w, top);
      break;
    }
    case kCrossColor: {
      const int tiles = sub_size(w, t.bits);
      const uint32_t* m = t.data.data() + size_t(y >> t.bits) * tiles;
      for (int x = 0; x < w; ++x) {
        const uint32_t code = m[x >> t.bits];
        const int8_t g2r = code & 0xff, g2b = (code >> 8) & 0xff,
                     r2b = (code >> 16) & 0xff;
        const uint32_t argb = in[x];
        const int8_t green = static_cast<int8_t>(argb >> 8);
        int r = (argb >> 16) & 0xff, b = argb & 0xff;
        r = (r + color_delta(g2r, green)) & 0xff;
        b = (b + color_delta(g2b, green) +
             color_delta(r2b, static_cast<int8_t>(r))) & 0xff;
        out[x] = (argb & 0xff00ff00u) | (uint32_t(r) << 16) | uint32_t(b);
      }
      break;
    }
    case kSubtractGreen:
      for (int x = 0; x < w; ++x) {
        const uint32_t argb = in[x], g = (argb >> 8) & 0xff;
        out[x] = (argb & 0xff00ff00u) |
                 (((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu);
      }
      break;
    default: {  // colour indexing
      const uint32_t* map = t.data.data();
      if (t.bits == 0) {
        for (int x = 0; x < w; ++x) out[x] = map[(in[x] >> 8) & 0xff];
      } else {
        const int bpp = 8 >> t.bits, count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bpp) - 1;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*in++ >> 8) & 0xff;
          out[x] = map[packed & bit_mask];
          packed >>= bpp;
        }
      }
    }
  }
}

// A level-0 image stream (transforms, then codes and pixels) of w x h.
// emit(y, argb row) receives the final rows; nullptr skips the transforms
// (the alpha plane, whose values are dropped). → false where libwebp fails.
bool decode_level0(LBits& br, int w, int h, bool is_alpha,
                   const std::function<void(int, const uint32_t*)>* emit) {
  std::vector<Transform> ts;
  int xs = w;
  unsigned seen = 0;
  while (br.read(1)) {
    const int type = br.read(2);
    if (seen & (1u << type)) return false;
    seen |= 1u << type;
    Transform t{type, 0, xs, {}};
    if (type == kPredictor || type == kCrossColor) {
      t.bits = br.read(3) + 2;
      if (!decode_sub(br, sub_size(xs, t.bits), sub_size(h, t.bits), t.data))
        return false;
    } else if (type == kColorIndex) {
      const int n = br.read(8) + 1;
      t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
      xs = sub_size(xs, t.bits);
      std::vector<uint32_t> pal;
      if (!decode_sub(br, n, 1, pal)) return false;
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      uint8_t* d = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* s = reinterpret_cast<const uint8_t*>(pal.data());
      std::copy(s, s + 4, d);
      for (int i = 4; i < 4 * n; ++i) d[i] = static_cast<uint8_t>(s[i] + d[i - 4]);
    }
    ts.push_back(std::move(t));
  }
  Codes c;
  if (!read_codes(br, xs, h, true, c)) return false;
  const bool alpha8b = is_alpha && ts.size() == 1 &&
                       ts[0].type == kColorIndex && c.cache_bits == 0 &&
                       c.trivial_rba;
  const uint64_t total = uint64_t(xs) * h;
  uint64_t size = 1;
  while (size < total && size < (1ull << 21)) size <<= 1;
  std::vector<uint32_t> ring(size);
  const uint64_t mask = size - 1;
  std::vector<uint32_t> a(w + 1), b(w + 1), prev(w + 2), in(xs);
  return run_pixels(br, c, xs, h, ring.data(), mask, alpha8b, [&](int y) {
    if (!emit) return;
    const uint64_t start = uint64_t(y) * xs;
    for (int x = 0; x < xs; ++x) in[x] = ring[(start + x) & mask];
    const uint32_t* cur = in.data();
    for (size_t i = ts.size(); i-- > 0;) {
      uint32_t* out = (cur == a.data()) ? b.data() : a.data();
      inverse_row(ts[i], y, cur, out, prev);
      cur = out;
    }
    (*emit)(y, cur);
  });
}

// Reads the VP8L header (signature, 14-bit sides, alpha bit, version 0).
bool vp8l_info(const uint8_t* d, size_t n, int* w, int* h) {
  if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return false;
  LBits br(d, n);
  br.read(8);
  *w = br.read(14) + 1;
  *h = br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0) return false;
  return !br.eos();
}

bool vp8l_decode(const uint8_t* d, size_t n, uint8_t* out, size_t stride) {
  int w, h;
  if (!vp8l_info(d, n, &w, &h)) return false;
  LBits br(d, n);
  br.pos = 40;
  const std::function<void(int, const uint32_t*)> emit =
      [&](int y, const uint32_t* px) {
        uint8_t* o = out + size_t(y) * stride;
        for (int x = 0; x < w; ++x, o += 3) {
          o[0] = px[x] & 0xff;
          o[1] = (px[x] >> 8) & 0xff;
          o[2] = (px[x] >> 16) & 0xff;
        }
      };
  return decode_level0(br, w, h, false, &emit);
}

// ALPHInit + ALPHDecode's verdict on an ALPH payload for a w x h frame.
bool alpha_ok(const uint8_t* d, size_t n, int w, int h) {
  if (n <= 1) return false;
  const int method = d[0] & 3, pre = (d[0] >> 4) & 3, rsrv = d[0] >> 6;
  if (method > 1 || pre > 1 || rsrv) return false;
  if (method == 0) return n - 1 >= size_t(w) * h;
  LBits br(d + 1, n - 1);
  return decode_level0(br, w, h, true, nullptr);
}

// ---- VP8

// libwebp's boolean decoder on a 64-bit host: range - 1 in `range`, 7
// bytes loaded at a time while 8 remain, then byte by byte; reading past
// the end pads one zero byte and sets eof. A corrupt stream (a partition
// led by 0xFF) leaves more in `value` than the range holds; the loads then
// drop high bits as libwebp's do. What is decoded then decides how far the
// decoder reads, so whether it meets the end of the data: cv2's verdict on
// the file. A byte-by-byte decoder answers otherwise on a third of such
// files.
struct BoolDec {
  const uint8_t *buf = nullptr, *end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;
  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  // VP8GetSigned: the sign of v, read as libwebp's shortcut for prob 0x80.
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * prob) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> bits);
    int b;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int get() { return bit(0x80); }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return get() ? -v : v;
  }
};

enum {
  B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
  DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // stride of the macroblock work area

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ---- prediction (libwebp dec.c), on the work area at dst with BPS stride

inline uint8_t avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline uint8_t avg2b(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction.
void predict_block(uint8_t* dst, int size, int mode) {
  const int sh = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case B_DC:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, (dc + size) >> (sh + 1));
      break;
    case DC_NOTOP:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, (dc + (size >> 1)) >> sh);
      break;
    case DC_NOLEFT:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, (dc + (size >> 1)) >> sh);
      break;
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    default:  // B_HE
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * BPS, dst[-1 + j * BPS], size);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7], X = top[-1];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                            avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2b(X, A);
      DST(1, 0) = DST(2, 2) = avg2b(A, B);
      DST(2, 0) = DST(3, 2) = avg2b(B, C);
      DST(3, 0) = avg2b(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2b(A, B);
      DST(1, 0) = DST(0, 2) = avg2b(B, C);
      DST(2, 0) = DST(1, 2) = avg2b(C, D);
      DST(3, 0) = DST(2, 2) = avg2b(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2b(I, X);
      DST(0, 1) = DST(2, 2) = avg2b(J, I);
      DST(0, 2) = DST(2, 3) = avg2b(K, J);
      DST(0, 3) = avg2b(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2b(I, J);
      DST(2, 0) = DST(0, 1) = avg2b(J, K);
      DST(2, 1) = DST(0, 2) = avg2b(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
  }
}
#undef DST

// ---- transforms

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: the inverse DCT of in (natural order) added to dst.
void idct_add(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// TransformWHT: the 16 luma DCs from the Y2 block, into out[16 * i].
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// ---- loop filters (libwebp dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t ||
         std::abs(p[step] - p[0]) > t;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step],
            p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
            q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// across an edge at p (hstride: step across it, vstride: along it)
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void filter_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      do_filter2(p, hstride);
    else if (mb_edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

// ---- YUV -> BGR (libwebp yuv.h) and the fancy upsampler (upsampling.c)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) {
  return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}
inline void yuv_to_bgr(int y, int u, int v, uint8_t* o) {
  o[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  o[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) -
                  mult_hi(v, 13320) + 8708);
  o[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
}

// One output row: luma row y, the nearest chroma rows (nu, nv) and the
// other neighbour (fu, fv), weighted 9-3-3-1 as libwebp's line pairs do.
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                  const uint8_t* fu, const uint8_t* fv, uint8_t* out,
                  int len) {
  auto edge = [](int n, int f) { return (3 * n + f + 2) >> 2; };
  yuv_to_bgr(y[0], edge(nu[0], fu[0]), edge(nv[0], fv[0]), out);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    int u0, u1, v0, v1;
    {
      const int tl = nu[x - 1], t = nu[x], l = fu[x - 1], uv = fu[x];
      const int avg = tl + t + l + uv + 8;
      const int d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + uv)) >> 3;
      u0 = (d12 + tl) >> 1;
      u1 = (d03 + t) >> 1;
    }
    {
      const int tl = nv[x - 1], t = nv[x], l = fv[x - 1], uv = fv[x];
      const int avg = tl + t + l + uv + 8;
      const int d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + uv)) >> 3;
      v0 = (d12 + tl) >> 1;
      v1 = (d03 + t) >> 1;
    }
    yuv_to_bgr(y[2 * x - 1], u0, v0, out + (2 * x - 1) * 3);
    yuv_to_bgr(y[2 * x], u1, v1, out + 2 * x * 3);
  }
  if (!(len & 1))
    yuv_to_bgr(y[len - 1], edge(nu[last_pair], fu[last_pair]),
               edge(nv[last_pair], fv[last_pair]), out + (len - 1) * 3);
}

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

struct MBMode {
  bool i4x4, skip;
  uint8_t segment, uvmode;
  uint8_t imodes[16];
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment, filter and quantiser headers
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t seg_probs[3] = {255, 255, 255};
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int num_parts = 1;
  BoolDec br, parts[8];
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrength[4][2];
};

// VP8GetHeaders on the frame (io->data: the payload to the buffer's end).
bool vp8_headers(Vp8& d, const uint8_t* buf, size_t n) {
  if (n < 4) return false;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key = !(bits & 1);
  const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t part_len = bits >> 5;
  if (profile > 3 || !show) return false;
  buf += 3;
  n -= 3;
  if (key) {
    if (n < 7 || buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
      return false;
    d.width = le16(buf + 3) & 0x3fff;
    d.height = le16(buf + 5) & 0x3fff;
    buf += 7;
    n -= 7;
    d.mb_w = (d.width + 15) >> 4;
    d.mb_h = (d.height + 15) >> 4;
    std::memcpy(d.proba, kWpCoeffs0, sizeof(d.proba));
  }
  if (part_len > n) return false;
  BoolDec& br = d.br;
  br.init(buf, part_len);
  buf += part_len;
  n -= part_len;
  if (key) {
    br.get();  // colour space
    br.get();  // clamping type (libwebp always clamps)
  }
  d.use_segment = br.get();
  if (d.use_segment) {
    d.update_map = br.get();
    if (br.get()) {
      d.absolute_delta = br.get();
      for (int& q : d.quantizer) q = br.get() ? br.signed_value(7) : 0;
      for (int& f : d.filter_strength) f = br.get() ? br.signed_value(6) : 0;
    }
    if (d.update_map)
      for (uint8_t& p : d.seg_probs) p = br.get() ? br.value_bits(8) : 255;
  } else {
    d.update_map = false;
  }
  if (br.eof) return false;
  d.simple = br.get();
  d.level = br.value_bits(6);
  d.sharpness = br.value_bits(3);
  d.use_lf_delta = br.get();
  if (d.use_lf_delta && br.get()) {
    for (int& v : d.ref_lf_delta)
      if (br.get()) v = br.signed_value(6);
    for (int& v : d.mode_lf_delta)
      if (br.get()) v = br.signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return false;
  // partitions: the sizes of all but the last, the last to the end
  d.num_parts = 1 << br.value_bits(2);
  const size_t last = d.num_parts - 1;
  if (n < 3 * last) return false;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  size_t left = n - 3 * last;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = le24(sz);
    if (psize > left) psize = left;
    d.parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  d.parts[last].init(start, left);
  if (start >= buf + n) return false;
  // quantisers
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.get() ? br.signed_value(4) : 0;
  const int dqy2_dc = br.get() ? br.signed_value(4) : 0;
  const int dqy2_ac = br.get() ? br.signed_value(4) : 0;
  const int dquv_dc = br.get() ? br.signed_value(4) : 0;
  const int dquv_ac = br.get() ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i] + (d.absolute_delta ? 0 : base_q0);
    } else if (i > 0) {
      std::memcpy(d.y1[i], d.y1[0], sizeof(d.y1[0]));
      std::memcpy(d.y2[i], d.y2[0], sizeof(d.y2[0]));
      std::memcpy(d.uv[i], d.uv[0], sizeof(d.uv[0]));
      continue;
    } else {
      q = base_q0;
    }
    d.y1[i][0] = kWpDcTable[clip(q + dqy1_dc, 127)];
    d.y1[i][1] = kWpAcTable[clip(q, 127)];
    d.y2[i][0] = kWpDcTable[clip(q + dqy2_dc, 127)] * 2;
    d.y2[i][1] = std::max(8, (kWpAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16);
    d.uv[i][0] = kWpDcTable[clip(q + dquv_dc, 117)];
    d.uv[i][1] = kWpAcTable[clip(q + dquv_ac, 127)];
  }
  if (!key) return false;  // not a key frame
  br.get();                // refresh entropy probabilities: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          if (br.bit(kWpCoeffsUpdate[i])) d.proba[t][b][c][p] = br.value_bits(8);
        }
  d.use_skip = br.get();
  if (d.use_skip) d.skip_p = br.value_bits(8);
  // filter strengths (PrecomputeFilterStrengths)
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = d.level;
      if (d.use_segment)
        base = d.filter_strength[s] + (d.absolute_delta ? 0 : d.level);
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = d.fstrength[s][i4];
        int level = base;
        if (d.use_lf_delta) {
          level += d.ref_lf_delta[0];
          if (i4) level += d.mode_lf_delta[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (d.sharpness > 0) {
            ilevel >>= d.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * level + ilevel;
          f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }
  return true;
}

// GetCoeffs: the tokens of one 4x4 block from position n into out
// (natural order, dequantised as libwebp stores them: int16). → the
// position after the last token (libwebp's "nz").
int get_coeffs(BoolDec& br, const uint8_t (*bands)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t (*next)[11] = bands[kBands[n + 1]];
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      if (!br.bit(p[3])) {
        if (!br.bit(p[4]))
          v = 2;
        else
          v = 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        const int bit1 = br.bit(p[8]);
        const int bit0 = br.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
          v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = next[2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

// ParseResiduals: the coefficients of one macroblock into coeffs (384,
// zeroed), updating the non-zero contexts; 2 bits a block in non_zero_y /
// _uv (3: > 3 tokens, 2: > 1, 1: a DC only). → true where every block is
// zero (libwebp then skips the inner-edge filtering of a 16x16 block).
bool parse_residuals(Vp8& d, BoolDec& tb, const MBMode& m, uint8_t& top_nz,
                     uint8_t& top_dc, uint8_t& left_nz, uint8_t& left_dc,
                     int16_t* coeffs, uint32_t& non_zero_y,
                     uint32_t& non_zero_uv) {
  const int* y1 = d.y1[m.segment];
  const int* y2 = d.y2[m.segment];
  const int* uvq = d.uv[m.segment];
  int16_t* dst = coeffs;
  non_zero_y = non_zero_uv = 0;
  auto nz_code = [](uint32_t acc, int nz, bool dc_nz) {
    return (acc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
  };
  int first;
  const uint8_t(*ac_bands)[3][11];
  if (!m.i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top_dc + left_dc;
    const int nz = get_coeffs(tb, d.proba[1], ctx, y2, 0, dc);
    top_dc = left_dc = nz > 0;
    if (nz > 1) {
      iwht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_bands = d.proba[0];
  } else {
    first = 0;
    ac_bands = d.proba[3];
  }
  uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nzc = 0;
    for (int x = 0; x < 4; ++x, dst += 16) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tb, ac_bands, ctx, y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      nzc = nz_code(nzc, nz, dst[0] != 0);
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nzc;
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nzc = 0;
    tnz = top_nz >> (4 + ch);
    lnz = left_nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x, dst += 16) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, d.proba[2], ctx, uvq, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        nzc = nz_code(nzc, nz, dst[0] != 0);
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nzc << (4 * ch);
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  top_nz = static_cast<uint8_t>(out_t);
  left_nz = static_cast<uint8_t>(out_l);
  return !(non_zero_y | non_zero_uv);
}

// DoTransform: a luma block's residual where its 2-bit code has one.
inline void add_residual(uint32_t code, const int16_t* c, uint8_t* dst) {
  if (code & 3) idct_add(c, dst);
}

// Decodes a VP8 key frame (data to the end of the buffer) as BGR into out
// (row stride `stride`); w, h: the frame's size, checked by the caller.
bool vp8_decode(const uint8_t* data, size_t n, int w, int h, uint8_t* out,
                size_t stride) {
  Vp8 d;
  if (!vp8_headers(d, data, n)) return false;
  if (d.width != w || d.height != h || !w || !h) return false;
  const int mb_w = d.mb_w, mb_h = d.mb_h;
  const int extra = d.filter_type == 2 ? 8 : d.filter_type == 1 ? 2 : 0;
  const int cw = (w + 1) >> 1, ch = (h + 1) >> 1;
  const size_t ys = size_t(mb_w) * 16, uvs = size_t(mb_w) * 8;
  std::vector<uint8_t> ycache(ys * (extra + 16)), ucache(uvs * (extra / 2 + 8)),
      vcache(uvs * (extra / 2 + 8));
  constexpr int kYRing = 64, kCRing = 32;
  std::vector<uint8_t> yring(size_t(w) * kYRing), uring(size_t(cw) * kCRing),
      vring(size_t(cw) * kCRing);
  // contexts: above (a column each) and left
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC), nz_t(mb_w, 0), nzdc_t(mb_w, 0);
  std::vector<uint8_t> top_y(ys), top_u(uvs), top_v(uvs);
  uint8_t intra_l[4];
  std::vector<MBMode> modes(mb_w);
  std::vector<FInfo> finfo(mb_w);
  uint8_t work[BPS * 17 + BPS * 9];
  uint8_t* const yd = work + BPS * 1 + 8;
  uint8_t* const ud = yd + BPS * 16 + BPS;
  uint8_t* const vd = ud + 16;
  alignas(16) int16_t coeffs[384];
  int y_fin = 0, c_fin = 0, next_out = 0;

  auto emit_rows = [&](int yend, int cend) {
    while (next_out < yend && std::min(ch - 1, (next_out + 1) >> 1) < cend) {
      const int r = next_out++;
      const int nr = r >> 1;
      const int fr = std::max(0, std::min(ch - 1, (r & 1) ? nr + 1 : nr - 1));
      upsample_row(&yring[size_t(r % kYRing) * w],
                   &uring[size_t(nr % kCRing) * cw],
                   &vring[size_t(nr % kCRing) * cw],
                   &uring[size_t(fr % kCRing) * cw],
                   &vring[size_t(fr % kCRing) * cw], out + size_t(r) * stride, w);
    }
  };

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // intra modes of the row (partition 0)
    std::memset(intra_l, B_DC, 4);
    BoolDec& br = d.br;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBMode& m = modes[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      m.segment = d.update_map
                      ? (!br.bit(d.seg_probs[0]) ? br.bit(d.seg_probs[1])
                                                 : br.bit(d.seg_probs[2]) + 2)
                      : 0;
      m.skip = d.use_skip ? br.bit(d.skip_p) : false;
      m.i4x4 = !br.bit(145);
      if (!m.i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                      : (br.bit(163) ? B_VE : B_DC);
        m.imodes[0] = ymode;
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        uint8_t* im = m.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* p = kWpBModes + (top[x] * 10 + ymode) * 9;
            ymode = !br.bit(p[0])   ? B_DC
                    : !br.bit(p[1]) ? B_TM
                    : !br.bit(p[2]) ? B_VE
                    : !br.bit(p[3])
                        ? (!br.bit(p[4]) ? B_HE : (!br.bit(p[5]) ? B_RD : B_VR))
                        : (!br.bit(p[6])
                               ? B_LD
                               : (!br.bit(p[7]) ? B_VL
                                                : (!br.bit(p[8]) ? B_HD : B_HU)));
            top[x] = static_cast<uint8_t>(ymode);
          }
          std::memcpy(im, top, 4);
          im += 4;
          intra_l[y] = static_cast<uint8_t>(ymode);
        }
      }
      m.uvmode = !br.bit(142)   ? B_DC
                 : !br.bit(114) ? B_VE
                 : br.bit(183)  ? B_TM
                                : B_HE;
    }
    if (br.eof) return false;

    // tokens, reconstruction, into the cache
    BoolDec& tb = d.parts[mb_y & (d.num_parts - 1)];
    uint8_t left_nz = 0, left_dc = 0;
    for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) ud[j * BPS - 1] = vd[j * BPS - 1] = 129;
    if (mb_y > 0) {
      yd[-1 - BPS] = ud[-1 - BPS] = vd[-1 - BPS] = 129;
    } else {
      std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
      std::memset(ud - BPS - 1, 127, 8 + 1);
      std::memset(vd - BPS - 1, 127, 8 + 1);
    }
    uint8_t* const yrow = &ycache[ys * extra];
    uint8_t* const urow = &ucache[uvs * (extra / 2)];
    uint8_t* const vrow = &vcache[uvs * (extra / 2)];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBMode& m = modes[mb_x];
      bool skip = m.skip;
      uint32_t nzy = 0, nzuv = 0;
      std::memset(coeffs, 0, sizeof(coeffs));
      if (!skip) {
        skip = parse_residuals(d, tb, m, nz_t[mb_x], nzdc_t[mb_x], left_nz,
                               left_dc, coeffs, nzy, nzuv);
      } else {
        left_nz = nz_t[mb_x] = 0;
        if (!m.i4x4) left_dc = nzdc_t[mb_x] = 0;
      }
      if (d.filter_type > 0) {
        finfo[mb_x] = d.fstrength[m.segment][m.i4x4];
        finfo[mb_x].inner |= !skip;
      }
      if (tb.eof) return false;

      // left samples from the previous block, top samples from above
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(yd + j * BPS - 4, yd + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(ud + j * BPS - 4, ud + j * BPS + 4, 4);
          std::memcpy(vd + j * BPS - 4, vd + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(yd - BPS, &top_y[16 * mb_x], 16);
        std::memcpy(ud - BPS, &top_u[8 * mb_x], 8);
        std::memcpy(vd - BPS, &top_v[8 * mb_x], 8);
      }
      auto check_mode = [&](int mode) {
        if (mode != B_DC) return mode;
        if (mb_x == 0) return mb_y == 0 ? int(DC_NOTOPLEFT) : int(DC_NOLEFT);
        return mb_y == 0 ? int(DC_NOTOP) : int(B_DC);
      };
      if (m.i4x4) {
        uint8_t* top_right = yd - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            std::memset(top_right, top_y[16 * mb_x + 15], 4);
          else
            std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int k = 1; k <= 3; ++k)
          std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int b = 0; b < 16; ++b) {
          uint8_t* dst = yd + (b & 3) * 4 + (b >> 2) * 4 * BPS;
          predict4(dst, m.imodes[b]);
          add_residual(nzy >> (30 - 2 * b), coeffs + b * 16, dst);
        }
      } else {
        predict_block(yd, 16, check_mode(m.imodes[0]));
        for (int b = 0; b < 16; ++b)
          add_residual(nzy >> (30 - 2 * b), coeffs + b * 16,
                       yd + (b & 3) * 4 + (b >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(m.uvmode);
      predict_block(ud, 8, uvmode);
      predict_block(vd, 8, uvmode);
      for (int p = 0; p < 2; ++p) {  // DoUVTransform
        const uint32_t bits = nzuv >> (8 * p);
        uint8_t* base = p ? vd : ud;
        if (!(bits & 0xff)) continue;
        for (int b = 0; b < 4; ++b) {
          const int16_t* c = coeffs + 256 + 64 * p + b * 16;
          uint8_t* dst = base + (b & 1) * 4 + (b >> 1) * 4 * BPS;
          idct_add(c, dst);
        }
      }
      if (mb_y < mb_h - 1) {
        std::memcpy(&top_y[16 * mb_x], yd + 15 * BPS, 16);
        std::memcpy(&top_u[8 * mb_x], ud + 7 * BPS, 8);
        std::memcpy(&top_v[8 * mb_x], vd + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(yrow + j * ys + 16 * mb_x, yd + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(urow + j * uvs + 8 * mb_x, ud + j * BPS, 8);
        std::memcpy(vrow + j * uvs + 8 * mb_x, vd + j * BPS, 8);
      }
    }

    // loop filter (DoFilter), macroblock by macroblock
    if (d.filter_type > 0) {
      const int S = static_cast<int>(ys), U = static_cast<int>(uvs);
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[mb_x];
        if (f.limit == 0) continue;
        uint8_t* y = yrow + 16 * mb_x;
        if (d.filter_type == 1) {
          if (mb_x > 0) simple_edge(y, 1, S, f.limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, S, f.limit);
          if (mb_y > 0) simple_edge(y, S, 1, f.limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k)
              simple_edge(y + 4 * k * S, S, 1, f.limit);
        } else {
          uint8_t* u = urow + 8 * mb_x;
          uint8_t* v = vrow + 8 * mb_x;
          const int il = f.ilevel, hv = f.hev;
          if (mb_x > 0) {
            filter_edge(y, 1, S, 16, f.limit + 4, il, hv, true);
            filter_edge(u, 1, U, 8, f.limit + 4, il, hv, true);
            filter_edge(v, 1, U, 8, f.limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k)
              filter_edge(y + 4 * k, 1, S, 16, f.limit, il, hv, false);
            filter_edge(u + 4, 1, U, 8, f.limit, il, hv, false);
            filter_edge(v + 4, 1, U, 8, f.limit, il, hv, false);
          }
          if (mb_y > 0) {
            filter_edge(y, S, 1, 16, f.limit + 4, il, hv, true);
            filter_edge(u, U, 1, 8, f.limit + 4, il, hv, true);
            filter_edge(v, U, 1, 8, f.limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k)
              filter_edge(y + 4 * k * S, S, 1, 16, f.limit, il, hv, false);
            filter_edge(u + 4 * U, U, 1, 8, f.limit, il, hv, false);
            filter_edge(v + 4 * U, U, 1, 8, f.limit, il, hv, false);
          }
        }
      }
    }

    // rows that no later filtering changes: to the rings, then out
    const bool last = mb_y == mb_h - 1;
    const int yend = last ? h : std::min(h, 16 * mb_y + 16 - extra);
    const int cend = last ? ch : std::min(ch, 8 * mb_y + 8 - extra / 2);
    for (; y_fin < yend; ++y_fin)
      std::memcpy(&yring[size_t(y_fin % kYRing) * w],
                  &ycache[ys * (extra + y_fin - 16 * mb_y)], w);
    for (; c_fin < cend; ++c_fin) {
      const size_t row = uvs * (extra / 2 + c_fin - 8 * mb_y);
      std::memcpy(&uring[size_t(c_fin % kCRing) * cw], &ucache[row], cw);
      std::memcpy(&vring[size_t(c_fin % kCRing) * cw], &vcache[row], cw);
    }
    emit_rows(yend, cend);
    std::memmove(ycache.data(), &ycache[ys * 16], ys * extra);
    std::memmove(ucache.data(), &ucache[uvs * 8], uvs * (extra / 2));
    std::memmove(vcache.data(), &vcache[uvs * 8], uvs * (extra / 2));
  }
  return next_out == h;
}

// ---- the container (webp_dec.c ParseHeadersInternal, demux.c)

enum Status { kOk = 0, kNeedData, kError };
constexpr uint32_t kMaxChunk = ~0u - 8 - 1;  // MAX_CHUNK_PAYLOAD
constexpr uint32_t kAnimFlag = 0x02;

struct Headers {
  int width = 0, height = 0;
  bool has_animation = false;
  bool lossless = false;
  size_t offset = 0;  // of the VP8 / VP8L payload
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
};

bool vp8_info(const uint8_t* d, size_t n, size_t chunk, int* w, int* h) {
  if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
  const uint32_t bits = le24(d);
  if (bits & 1) return false;  // not a key frame
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk)
    return false;
  *w = le16(d + 6) & 0x3fff;
  *h = le16(d + 8) & 0x3fff;
  return *w && *h;
}

// ParseHeadersInternal. want: WebPDecode's call (headers != NULL).
Status parse_headers(const uint8_t* data, size_t size, bool have_all,
                     bool want, Headers& out) {
  const uint8_t* const start = data;
  if (size < 12) return kNeedData;
  size_t riff = 0;
  if (!std::memcmp(data, "RIFF", 4)) {
    if (std::memcmp(data + 8, "WEBP", 4)) return kError;
    const uint32_t s = le32(data + 4);
    if (s < 12 || s > kMaxChunk) return kError;
    if (have_all && s > size - 8) return kNeedData;
    riff = s;
    data += 12;
    size -= 12;
  }
  bool vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  if (size < 8) return kNeedData;
  if (!std::memcmp(data, "VP8X", 4)) {
    if (le32(data + 4) != 10) return kError;
    if (size < 18) return kNeedData;
    flags = le32(data + 8);
    canvas_w = 1 + le24(data + 12);
    canvas_h = 1 + le24(data + 15);
    if (uint64_t(canvas_w) * canvas_h >= (1ull << 32)) return kError;
    data += 18;
    size -= 18;
    vp8x = true;
  }
  if (!riff && vp8x) return kError;
  const bool animation = flags & kAnimFlag;
  out.has_animation = animation;
  int w = canvas_w, h = canvas_h;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  bool lossless = false;
  auto finish = [&](Status s) {
    if (s == kOk || (s == kNeedData && vp8x && !want)) {
      out.width = w;
      out.height = h;
      return kOk;
    }
    return s;
  };
  if (vp8x && animation && !want) return finish(kOk);
  if (size < 4) return finish(kNeedData);
  if ((riff && vp8x) || (!riff && !vp8x && !std::memcmp(data, "ALPH", 4))) {
    uint32_t total = 4 + 8 + 10;
    while (true) {
      if (size < 8) return finish(kNeedData);
      const uint32_t cs = le32(data + 4);
      if (cs > kMaxChunk) return finish(kError);
      const uint32_t disk = (8 + cs + 1) & ~1u;
      total += disk;
      if (riff > 0 && total > riff) return finish(kError);
      if (!std::memcmp(data, "VP8 ", 4) || !std::memcmp(data, "VP8L", 4)) break;
      if (size < disk) return finish(kNeedData);
      if (!std::memcmp(data, "ALPH", 4)) {
        alpha = data + 8;
        alpha_size = cs;
      }
      data += disk;
      size -= disk;
    }
  }
  // the VP8 / VP8L chunk header, or a raw bitstream
  if (size < 8) return finish(kNeedData);
  size_t compressed;
  const bool is_vp8 = !std::memcmp(data, "VP8 ", 4);
  const bool is_vp8l = !std::memcmp(data, "VP8L", 4);
  if (is_vp8 || is_vp8l) {
    const uint32_t s = le32(data + 4);
    if (riff >= 12 && s > riff - 12) return finish(kError);
    if (have_all && s > size - 8) return finish(kNeedData);
    compressed = s;
    data += 8;
    size -= 8;
    lossless = is_vp8l;
  } else {
    lossless = size >= 5 && data[0] == 0x2f && (data[4] >> 5) == 0;
    compressed = size;
  }
  if (compressed > kMaxChunk) return kError;
  if (!lossless) {
    if (size < 10) return finish(kNeedData);
    if (!vp8_info(data, size, compressed, &w, &h)) return kError;
  } else {
    if (size < 5) return finish(kNeedData);
    if (!vp8l_info(data, size, &w, &h)) return kError;
  }
  if (vp8x && (canvas_w != w || canvas_h != h)) return kError;
  out.lossless = lossless;
  out.offset = data - start;
  out.alpha = alpha;
  out.alpha_size = alpha_size;
  return finish(kOk);
}

// WebPDecode of one image (a whole file, or an animation frame's
// fragment) as BGR into out; w x h: the size the caller allocated.
bool decode_image(const uint8_t* data, size_t n, int w, int h, uint8_t* out,
                  size_t stride) {
  Headers hd;
  if (parse_headers(data, n, true, true, hd) != kOk || hd.has_animation)
    return false;
  if (hd.width != w || hd.height != h) return false;
  const uint8_t* payload = data + hd.offset;
  const size_t size = n - hd.offset;
  if (hd.lossless) return vp8l_decode(payload, size, out, stride);
  if (!vp8_decode(payload, size, w, h, out, stride)) return false;
  return !hd.alpha || alpha_ok(hd.alpha, hd.alpha_size, w, h);
}

// WebPDemux (whole file, no partial data) of an animation: its canvas and
// where the first frame's fragment lies. False where it refuses the file.
struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  size_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
  bool complete = false;
  int num = 0;
};

bool demux_animation(const uint8_t* buf, size_t n, int* cw, int* ch,
                     Frame* first) {
  if (n < 20 || std::memcmp(buf, "RIFF", 4) || std::memcmp(buf + 8, "WEBP", 4))
    return false;
  const uint32_t riff_size = le32(buf + 4);
  if (riff_size < 8 || riff_size > kMaxChunk) return false;
  const size_t riff_end = size_t(riff_size) + 8;
  if (n < riff_end) return false;  // partial
  const size_t end = riff_end;
  size_t pos = 12;
  auto avail = [&]() { return end - pos; };
  auto size_invalid = [&](size_t s) { return s > riff_end - pos; };
  if (std::memcmp(buf + pos, "VP8X", 4)) return false;
  if (avail() < 8) return false;
  uint32_t vsz = le32(buf + pos + 4);
  pos += 8;
  if (vsz > kMaxChunk || vsz < 10) return false;
  vsz += vsz & 1;
  if (size_invalid(vsz) || avail() < vsz) return false;
  const uint32_t flags = buf[pos];
  *cw = 1 + le24(buf + pos + 4);
  *ch = 1 + le24(buf + pos + 7);
  if (uint64_t(*cw) * *ch >= (1ull << 32)) return false;
  pos += vsz;
  if (size_invalid(8) || avail() < 8) return false;
  if (!(flags & kAnimFlag)) return false;  // only animations come here
  std::vector<Frame> frames;
  int anim_chunks = 0;
  // StoreFrame: ALPH and / or one VP8 / VP8L chunk of a frame
  auto store_frame = [&](int num, size_t min_size, Frame& f) -> Status {
    if (avail() < 8 || avail() < min_size) return kNeedData;
    int alpha_chunks = 0, image_chunks = 0;
    Status st = kOk;
    bool done = false;
    do {
      const size_t chunk_start = pos;
      const uint32_t psize = le32(buf + pos + 4);
      pos += 8;
      if (psize > kMaxChunk) return kError;
      const size_t padded = size_t(psize) + (psize & 1);
      const size_t payload_avail = std::min(padded, avail());
      const size_t chunk_size = 8 + payload_avail;
      if (size_invalid(padded)) return kError;
      if (padded > avail()) st = kNeedData;
      const uint8_t* tag = buf + chunk_start;
      if (!std::memcmp(tag, "ALPH", 4) && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_off = chunk_start;
        f.alpha_size = chunk_size;
        f.num = num;
        pos += payload_avail;
      } else if (!std::memcmp(tag, "VP8L", 4) && alpha_chunks > 0) {
        return kError;  // VP8L carries its own alpha
      } else if ((!std::memcmp(tag, "VP8L", 4) || !std::memcmp(tag, "VP8 ", 4)) &&
                 image_chunks == 0) {
        Headers hd;
        const Status fs = parse_headers(buf + chunk_start, chunk_size, false,
                                        false, hd);
        if (st == kNeedData && fs == kNeedData) return kNeedData;
        if (fs != kOk) return kError;
        ++image_chunks;
        f.img_off = chunk_start;
        f.img_size = chunk_size;
        f.w = hd.width;
        f.h = hd.height;
        f.num = num;
        f.complete = st == kOk;
        pos += payload_avail;
      } else {
        pos -= 8;
        done = true;
      }
      if (pos == riff_end)
        done = true;
      else if (avail() < 8)
        st = kNeedData;
    } while (!done && st == kOk);
    return st;
  };
  Status st = kOk;
  do {
    const uint32_t csz = le32(buf + pos + 4);
    const uint8_t* tag = buf + pos;
    pos += 8;
    if (csz > kMaxChunk) return false;
    const size_t padded = size_t(csz) + (csz & 1);
    if (size_invalid(padded)) return false;
    if (!std::memcmp(tag, "VP8X", 4)) return false;
    if (!std::memcmp(tag, "ALPH", 4) || !std::memcmp(tag, "VP8 ", 4) ||
        !std::memcmp(tag, "VP8L", 4)) {
      return false;  // an animation holds its images in ANMF chunks
    } else if (!std::memcmp(tag, "ANIM", 4)) {
      if (padded < 6) return false;
      if (avail() < padded) {
        st = kNeedData;
      } else {
        ++anim_chunks;
        pos += padded;  // background colour and loop count: unused
      }
    } else if (!std::memcmp(tag, "ANMF", 4)) {
      if (anim_chunks == 0) return false;
      // ParseAnimationFrame
      if (size_invalid(16) || padded < 16) return false;
      if (avail() < 16) {
        st = kNeedData;
      } else {
        Frame f;
        f.x = 2 * le24(buf + pos);
        f.y = 2 * le24(buf + pos + 3);
        const uint64_t fw = 1 + le24(buf + pos + 6), fh = 1 + le24(buf + pos + 9);
        if (fw * fh >= (1ull << 32)) return false;
        pos += 16;
        const size_t start_off = pos;
        st = store_frame(static_cast<int>(frames.size()) + 1, padded - 16, f);
        if (st != kError && pos - start_off > padded - 16) st = kError;
        if (st == kError) return false;
        if (f.num > 0) {
          if (!frames.empty() && !frames.back().complete) return false;
          frames.push_back(f);
        }
      }
    } else {  // ICCP, EXIF, XMP and unknown chunks are skipped
      if (padded <= avail())
        pos += padded;
      else
        st = kNeedData;
    }
    if (pos == riff_end) break;
    if (avail() < 8) st = kNeedData;
  } while (st == kOk);
  if (st != kOk) return false;  // a complete file was asked for
  // IsValidExtendedFormat
  if (flags & ~0x3eu) return false;
  if (frames.empty()) return false;
  for (const Frame& f : frames) {
    if (!f.complete || f.w <= 0 || f.h <= 0) return false;
    if (f.alpha_size > 0 && f.alpha_off > f.img_off) return false;
    if (f.w + f.x > *cw || f.h + f.y > *ch) return false;
  }
  *first = frames[0];
  return true;
}

}  // namespace wp
}  // namespace

extern "C" {

// The size cv2.imdecode reads a WebP at (WebPGetFeatures on its first 32
// bytes; an animation's canvas after WebPDemux accepts the file) into
// w, h. → 0, or -1 where cv2 gives None.
int ocr_webp_info(const uint8_t* buf, long long n, int* w, int* h) try {
  if (n < 32) return -1;
  wp::Headers hd;
  if (wp::parse_headers(buf, 32, false, false, hd) != wp::kOk) return -1;
  if (hd.has_animation) {
    wp::Frame f;
    return wp::demux_animation(buf, size_t(n), w, h, &f) ? 0 : -1;
  }
  *w = hd.width;
  *h = hd.height;
  return 0;
} catch (...) {
  return -1;
}

// Decodes the WebP ocr_webp_info sized (h x w) into out (h * w * 3 BGR):
// a still image as WebPDecodeBGRInto / BGRAInto decodes it, an animation's
// first frame on a zeroed canvas as WebPAnimDecoder composes it. → 0, or
// -1 where cv2 gives None.
int ocr_webp_decode(const uint8_t* buf, long long n, int h, int w,
                    uint8_t* out) try {
  wp::Headers hd;
  if (n < 32 || wp::parse_headers(buf, 32, false, false, hd) != wp::kOk)
    return -1;
  const size_t stride = size_t(w) * 3;
  if (!hd.has_animation)
    return wp::decode_image(buf, size_t(n), w, h, out, stride) ? 0 : -1;
  int cw, ch;
  wp::Frame f;
  if (!wp::demux_animation(buf, size_t(n), &cw, &ch, &f) || cw != w || ch != h)
    return -1;
  std::memset(out, 0, stride * h);
  size_t start = f.img_off, size = f.img_size;
  if (f.alpha_size > 0) {
    size += f.alpha_size + (f.img_off - (f.alpha_off + f.alpha_size));
    start = f.alpha_off;
  }
  return wp::decode_image(buf + start, size, f.w, f.h,
                          out + size_t(f.y) * stride + size_t(f.x) * 3, stride)
             ? 0
             : -1;
} catch (...) {
  return -1;
}

}  // extern "C"

// ---------------------------------------------------------------- GIF
// cv2 5.0's GifDecoder at IMREAD_COLOR: the file's block structure is
// walked to its trailer first (a truncated file, or a byte that starts no
// block, gives None); then the first frame is decoded onto the logical
// screen. The screen starts as the global table's background colour, or
// black without a global table; pixels of the transparent index keep it.
// An index indexes the global table overwritten by the frame's local one
// and must lie inside the larger of the two; with neither table, index i
// is grey i but 1, which is white (cv2's default table). The LZW stream
// must give the frame's pixels and no more, with codes of 3 to 12 bits.
namespace {
namespace gf {

// Bytes read past the end read as 0 and set `bad`, which every loop checks.
struct Reader {
  const uint8_t* b;
  size_t n, pos;
  bool bad = false;
  int byte() {
    if (pos >= n) {
      bad = true;
      return 0;
    }
    return b[pos++];
  }
  int word() {
    int lo = byte();
    return lo | (byte() << 8);
  }
  void skip(size_t k) {
    if (k > n - std::min(pos, n)) {
      bad = true;
      pos = n;
      return;
    }
    pos += k;
  }
  void skip_blocks() {  // data sub-blocks up to their terminator
    for (int len = byte(); len && !bad; len = byte()) skip(size_t(len));
  }
};

// An extension block after its label. An application extension other than
// NETSCAPE2.0 is skipped to its first zero byte, counting from the block
// size byte when that is not 11, and one of block size 3 fails (cv2's
// getFrameCount_); the others are skipped by their sub-blocks.
void skip_extension(Reader& r, int label) {
  if (label == 0xFF) {
    int len = r.byte();
    if (len == 3) r.bad = true;
    if (len == 11) {
      char id[11];
      for (char& c : id) c = char(r.byte());
      if (!std::memcmp(id, "NETSCAPE2.0", 11)) {
        r.skip_blocks();
        return;
      }
    }
    while (len && !r.bad) len = r.byte();
    return;
  }
  r.skip_blocks();
}

struct Screen {
  int w = 0, h = 0, bg = 0, gct_size = 0;
  uint8_t gct[256 * 3] = {};
  size_t body = 0;  // first byte after the global table
};

// The header and the global table; then every block up to the trailer, as
// cv2's readHeader / getFrameCount_ walk them. → false where cv2 fails.
bool read_screen(Reader& r, Screen& s) {
  if (r.n < 6 ||
      (std::memcmp(r.b, "GIF87a", 6) && std::memcmp(r.b, "GIF89a", 6)))
    return false;
  r.pos = 6;
  s.w = r.word();
  s.h = r.word();
  const int flags = r.byte();
  s.bg = r.byte();
  r.skip(1);
  if (r.bad || s.w <= 0 || s.h <= 0) return false;
  if (flags & 0x80) {
    s.gct_size = 1 << ((flags & 7) + 1);
    for (int i = 0; i < 3 * s.gct_size; ++i) s.gct[i] = uint8_t(r.byte());
    if (s.bg >= s.gct_size) return false;
  }
  s.body = r.pos;
  for (int type = r.byte(); !r.bad && type != 0x3B; type = r.byte()) {
    if (type == 0x21) {
      skip_extension(r, r.byte());
    } else if (type == 0x2C) {
      r.skip(8);
      const int f = r.byte();
      if (f & 0x80) r.skip(3 * (size_t(1) << ((f & 7) + 1)));
      r.skip(1);
      r.skip_blocks();
    } else {
      return false;
    }
  }
  return !r.bad;
}

// GIF's LZW into idx (n indices), as cv2's lzwDecode reads it: a byte at a
// time when the bits in hand do not make a code, every code those bits make
// decoded at once. An end-of-information code resets the code size and the
// table and decoding goes on. Before the frame is full a code must be in
// the table and its string must fit; once it is full, codes are counted
// and not checked, and reading another byte after one of them fails. →
// false where cv2 refuses the stream.
bool lzw(Reader& r, int min_size, uint8_t* idx, size_t n) {
  if (min_size < 2 || min_size > 11) return false;
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int c = 0; c < clear; ++c) suffix[c] = first[c] = uint8_t(c);
  int size = min_size + 1, next = eoi + 1, prev = -1;
  uint32_t bits = 0;
  int nbits = 0;
  size_t out = 0;
  for (int len = r.byte(); len && !r.bad;) {
    if (out > n) return false;
    if (nbits < size) {
      bits |= uint32_t(r.byte()) << nbits;
      nbits += 8;
      --len;
    }
    while (nbits >= size) {
      const int code = int(bits & ((1u << size) - 1));
      bits >>= size;
      nbits -= size;
      if (code == clear || code == eoi) {
        size = min_size + 1;
        next = eoi + 1;
        prev = -1;
        if (code == eoi) break;
        continue;
      }
      if (out >= n) {  // past the frame: counted, not checked
        ++out;
        continue;
      }
      if (code > next || (code == next && prev < 0)) return false;
      int c = code, top = 0;
      if (code == next) {  // KwKwK: the previous string and its first
        stack[top++] = first[prev];
        c = prev;
      }
      while (c >= clear) {
        stack[top++] = suffix[c];
        c = prefix[c];
      }
      stack[top++] = uint8_t(c);
      if (size_t(top) > n - out) return false;
      while (top) idx[out++] = stack[--top];
      if (prev >= 0 && next < 4096) {
        prefix[next] = uint16_t(prev);
        suffix[next] = uint8_t(c);
        first[next] = first[prev];
        if (++next == (1 << size) && size < 12) ++size;
      }
      prev = code;
    }
    if (!len) len = r.byte();
  }
  return !r.bad && out >= n;
}

// The first frame onto the (s.h x s.w) screen, BGR. → false where cv2
// gives None.
bool first_frame(Reader& r, const Screen& s, uint8_t* out) {
  r.pos = s.body;
  bool has_transparent = false;
  int transparent = 0, disposal = 0;
  int type = r.byte();
  for (; type == 0x21 && !r.bad; type = r.byte()) {
    const int label = r.byte();
    if (label != 0xF9) {
      skip_extension(r, label);
      continue;
    }
    if (r.byte() != 4) return false;
    const int f = r.byte();
    r.skip(2);
    transparent = r.byte();
    disposal = (f >> 2) & 7;
    has_transparent = f & 1;
    r.skip_blocks();
  }
  if (r.bad || type != 0x2C || disposal > 3) return false;
  const int left = r.word(), top = r.word(), w = r.word(), h = r.word();
  if (r.bad || w <= 0 || h <= 0 || left + w > s.w || top + h > s.h)
    return false;
  const size_t stride = size_t(s.w) * 3;
  uint8_t bg[3] = {0, 0, 0};
  if (s.gct_size)
    for (int k = 0; k < 3; ++k) bg[k] = s.gct[s.bg * 3 + 2 - k];
  for (size_t i = 0; i < size_t(s.w) * s.h; ++i)
    std::memcpy(out + i * 3, bg, 3);
  uint8_t table[256 * 3];
  int limit = s.gct_size;
  if (s.gct_size) {
    std::memcpy(table, s.gct, sizeof table);
  } else {
    for (int i = 0; i < 256; ++i)
      std::memset(table + 3 * i, i == 1 ? 255 : i, 3);
  }
  const int flags = r.byte();
  if (flags & 0x80) {
    const int lct = 1 << ((flags & 7) + 1);
    for (int i = 0; i < 3 * lct; ++i) table[i] = uint8_t(r.byte());
    limit = std::max(limit, lct);
  }
  if (r.bad) return false;
  if (!limit) limit = 256;
  std::vector<uint8_t> idx(size_t(w) * h);
  if (!lzw(r, r.byte(), idx.data(), idx.size())) return false;
  std::vector<int> rows(h);
  if (flags & 0x40) {  // interlaced: 0, 8, ..; 4, 12, ..; 2, 6, ..; 1, 3, ..
    int k = 0;
    for (int pass = 0; pass < 4; ++pass)
      for (int y = (pass ? 8 >> pass : 0); y < h; y += (pass ? 16 >> pass : 8))
        rows[k++] = y;
  } else {
    for (int y = 0; y < h; ++y) rows[y] = y;
  }
  for (int k = 0; k < h; ++k) {
    const uint8_t* src = idx.data() + size_t(k) * w;
    uint8_t* dst = out + size_t(top + rows[k]) * stride + size_t(left) * 3;
    for (int x = 0; x < w; ++x, dst += 3) {
      const int v = src[x];
      if (has_transparent && v == transparent) continue;
      if (v >= limit) return false;
      dst[0] = table[3 * v + 2];
      dst[1] = table[3 * v + 1];
      dst[2] = table[3 * v];
    }
  }
  return true;
}

}  // namespace gf

// ----------------------------------------------------------- Radiance HDR
// cv2 5.0's HdrDecoder (Greg Ward's rgbe.c, read through a temporary file)
// at IMREAD_COLOR: the header lines as fgets reads them into a 128-byte
// buffer, FORMAT=32-bit_rle_rgbe, a blank line, "-Y h +X w"; flat RGBE
// pixels, or new-style RLE scanlines when 8 <= w <= 32767 (a scanline
// that does not start 2 2 turns the rest of the image flat); each pixel
// r, g, b times 2^(e - 136) in float, then convertTo(CV_8U, 255): the
// product rounded to nearest even and saturated, where cvRound's overflow
// (|v| >= 2^31, NaN) gives INT_MIN and so 0.
namespace hd {

bool fgets128(const uint8_t* b, size_t n, size_t& pos, char* line) {
  if (pos >= n) return false;
  int k = 0;
  while (k < 127 && pos < n) {
    const char c = char(b[pos++]);
    line[k++] = c;
    if (c == '\n') break;
  }
  line[k] = 0;
  return true;
}

bool header(const uint8_t* b, size_t n, size_t& pos, int* w, int* h) {
  char line[128];
  pos = 0;
  if (!fgets128(b, n, pos, line)) return false;
  for (;;) {
    if (line[0] == 0 || line[0] == '\n') return false;
    if (std::strcmp(line, "FORMAT=32-bit_rle_rgbe\n") == 0) break;
    if (!fgets128(b, n, pos, line)) return false;
  }
  if (!fgets128(b, n, pos, line) || std::strcmp(line, "\n") != 0) return false;
  if (!fgets128(b, n, pos, line)) return false;
  int hh = 0, ww = 0;
  if (std::sscanf(line, "-Y %d +X %d", &hh, &ww) < 2) return false;
  *w = ww;
  *h = hh;
  return true;
}

inline uint8_t to_u8(float v) {
  const float t = v * 255.0f;
  if (!(t > -2147483648.0f && t < 2147483648.0f)) return 0;
  const float r = std::nearbyint(t);
  return uint8_t(r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r));
}

inline void put(const uint8_t* rgbe, uint8_t* bgr) {
  if (!rgbe[3]) {
    bgr[0] = bgr[1] = bgr[2] = 0;
    return;
  }
  const float f = float(std::ldexp(1.0, int(rgbe[3]) - (128 + 8)));
  bgr[0] = to_u8(float(rgbe[2]) * f);
  bgr[1] = to_u8(float(rgbe[1]) * f);
  bgr[2] = to_u8(float(rgbe[0]) * f);
}

bool flat(const uint8_t* b, size_t n, size_t& pos, uint8_t* out, size_t count) {
  if (count > (n - pos) / 4) return false;
  for (size_t i = 0; i < count; ++i, pos += 4, out += 3) put(b + pos, out);
  return true;
}

bool pixels(const uint8_t* b, size_t n, size_t pos, int w, int h,
            uint8_t* out) {
  if (w < 8 || w > 0x7fff) return flat(b, n, pos, out, size_t(w) * h);
  std::vector<uint8_t> line(size_t(w) * 4);
  for (int y = 0; y < h; ++y) {
    if (n - pos < 4) return false;
    const uint8_t* px = b + pos;
    pos += 4;
    if (px[0] != 2 || px[1] != 2 || (px[2] & 0x80)) {
      put(px, out);
      return flat(b, n, pos, out + 3, size_t(w) * (h - y) - 1);
    }
    if (((int(px[2]) << 8) | px[3]) != w) return false;
    for (int c = 0; c < 4; ++c) {
      uint8_t* p = line.data() + size_t(c) * w;
      uint8_t* end = p + w;
      while (p < end) {
        if (n - pos < 2) return false;
        int count = b[pos];
        const uint8_t v = b[pos + 1];
        pos += 2;
        if (count > 128) {
          count -= 128;
          if (count > end - p) return false;
          std::memset(p, v, size_t(count));
          p += count;
        } else {
          if (count == 0 || count > end - p) return false;
          *p++ = v;
          if (--count > 0) {
            if (n - pos < size_t(count)) return false;
            std::memcpy(p, b + pos, size_t(count));
            p += count;
            pos += size_t(count);
          }
        }
      }
    }
    for (int x = 0; x < w; ++x, out += 3) {
      const uint8_t q[4] = {line[x], line[x + w], line[x + 2 * size_t(w)],
                            line[x + 3 * size_t(w)]};
      put(q, out);
    }
  }
  return true;
}

}  // namespace hd
}  // namespace

extern "C" {

// The header of a PFM as cv2 5.0's PFMDecoder reads it: "P", "F" or "f", a
// line feed, then three words, each up to the next white-space byte (a
// byte >= 128 fails), read by atoi, atoi and atof. → 0 with the offset of
// the samples in pos, or -1 where cv2 gives None.
int ocr_pfm_header(const uint8_t* buf, long long n, int* w, int* h,
                   double* scale, long long* pos) try {
  if (n < 3 || buf[0] != 'P' || (buf[1] != 'f' && buf[1] != 'F') ||
      buf[2] != '\n')
    return -1;
  long long p = 3;
  std::string words[3];
  for (auto& word : words) {
    for (int i = 0; i < 2048; ++i) {
      if (p >= n || buf[p] >= 128) return -1;
      const char c = char(buf[p++]);
      if (std::isspace(static_cast<unsigned char>(c))) break;
      word.push_back(c);
    }
  }
  *w = std::atoi(words[0].c_str());
  *h = std::atoi(words[1].c_str());
  *scale = std::atof(words[2].c_str());
  *pos = p;
  return 0;
} catch (...) {
  return -1;
}

// The logical screen of a GIF cv2 reads (every block walked to the
// trailer) into w, h. → 0, or -1 where cv2 gives None.
int ocr_gif_info(const uint8_t* buf, long long n, int* w, int* h) try {
  gf::Reader r{buf, size_t(n), 0};
  gf::Screen s;
  if (!gf::read_screen(r, s)) return -1;
  *w = s.w;
  *h = s.h;
  return 0;
} catch (...) {
  return -1;
}

// The first frame of the GIF ocr_gif_info sized (h x w) on its screen, into
// out (h * w * 3 BGR). → 0, or -1 where cv2 gives None.
int ocr_gif_decode(const uint8_t* buf, long long n, int h, int w,
                   uint8_t* out) try {
  gf::Reader r{buf, size_t(n), 0};
  gf::Screen s;
  if (!gf::read_screen(r, s) || s.w != w || s.h != h) return -1;
  return gf::first_frame(r, s, out) ? 0 : -1;
} catch (...) {
  return -1;
}

// The size of a Radiance HDR cv2 reads into w, h and the offset of its
// pixels into pos. → 0, or -1 where cv2 gives None.
int ocr_hdr_info(const uint8_t* buf, long long n, int* w, int* h,
                 long long* pos) try {
  size_t p = 0;
  if (!hd::header(buf, size_t(n), p, w, h)) return -1;
  *pos = (long long)p;
  return 0;
} catch (...) {
  return -1;
}

// The (h x w) pixels of a Radiance HDR from pos into out (h * w * 3 BGR).
// → 0, or -1 where cv2 gives None.
int ocr_hdr_decode(const uint8_t* buf, long long n, long long pos, int h,
                   int w, uint8_t* out) try {
  return hd::pixels(buf, size_t(n), size_t(pos), w, h, out) ? 0 : -1;
} catch (...) {
  return -1;
}

}  // extern "C"
