// The TrueType font reader shared by the host rasterisers (ttf.cc, PIL's
// path through FreeType's bytecode interpreter, and autohint.cc,
// matplotlib's path through FreeType 2.6.1's auto-hinter): FreeType's
// fixed-point helpers, the tables head, hhea, maxp, OS/2, hmtx, loca,
// glyf and cmap, and glyph outlines in font units.

#ifndef ONNXOCR_TTF_FONT_H_
#define ONNXOCR_TTF_FONT_H_

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <map>
#include <memory>
#include <mutex>
#include <vector>

namespace {

typedef long long i64;

// ------------------------------------------------------------ fixed point
// FreeType's FT_MulFix / FT_DivFix (round half away from zero)
i64 mulfix(i64 a, i64 b) {
  int s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  i64 c = (a * b + 0x8000) >> 16;
  return s > 0 ? c : -c;
}

i64 divfix(i64 a, i64 b) {
  int s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  i64 q = b ? ((a << 16) + (b >> 1)) / b : 0x7FFFFFFF;
  return s > 0 ? q : -q;
}

inline i64 pix_round(i64 x) { return (x + 32) & ~i64(63); }
inline i64 pix_floor(i64 x) { return x & ~i64(63); }
inline i64 pix_ceil(i64 x) { return (x + 63) & ~i64(63); }

// --------------------------------------------------------------- reading
struct Reader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  bool ok(size_t off, size_t len) const { return off <= n && len <= n - off; }
  uint32_t u8(size_t o) const { return ok(o, 1) ? d[o] : 0; }
  uint32_t u16(size_t o) const {
    return ok(o, 2) ? (uint32_t(d[o]) << 8) | d[o + 1] : 0;
  }
  int32_t s16(size_t o) const { return int16_t(u16(o)); }
  uint32_t u32(size_t o) const {
    return ok(o, 4) ? (uint32_t(d[o]) << 24) | (uint32_t(d[o + 1]) << 16) |
                          (uint32_t(d[o + 2]) << 8) | d[o + 3]
                    : 0;
  }
};

struct Point { i64 x, y; bool on; };

struct Outline {
  std::vector<Point> pts;
  std::vector<int> ends;  // index of the last point of each contour
};

struct Hinter;

struct Font {
  std::vector<uint8_t> bytes;
  mutable std::mutex mu;
  mutable std::map<int, std::shared_ptr<Hinter>> hinters;     // by ppem
  mutable std::map<std::pair<int, int>, Outline> outlines;    // (ppem, gid)
  Reader r;
  size_t head = 0, hhea = 0, maxp = 0, hmtx = 0, loca = 0, glyf = 0,
         os2 = 0, cmap = 0, gdef = 0, gsub = 0, gpos = 0;
  size_t glyf_len = 0, loca_len = 0, hmtx_len = 0;
  size_t cvt = 0, fpgm = 0, prep = 0;              // TrueType programs
  size_t cvt_len = 0, fpgm_len = 0, prep_len = 0;
  int upem = 1000, num_glyphs = 0, loca_long = 0, num_hmetrics = 0;
  int ascender = 0, descender = 0;
  size_t cmap4 = 0, cmap12 = 0;
};

bool load(Font& f) {
  Reader& r = f.r;
  r.d = f.bytes.data();
  r.n = f.bytes.size();
  if (r.n < 12) return false;
  int ntables = r.u16(4);
  if (!r.ok(12, size_t(ntables) * 16)) return false;
  for (int i = 0; i < ntables; ++i) {
    size_t rec = 12 + size_t(i) * 16;
    uint32_t tag = r.u32(rec), off = r.u32(rec + 8), len = r.u32(rec + 12);
    if (!r.ok(off, len)) continue;
    switch (tag) {
      case 0x68656164: f.head = off; break;                      // head
      case 0x68686561: f.hhea = off; break;                      // hhea
      case 0x6D617870: f.maxp = off; break;                      // maxp
      case 0x686D7478: f.hmtx = off; f.hmtx_len = len; break;    // hmtx
      case 0x6C6F6361: f.loca = off; f.loca_len = len; break;    // loca
      case 0x676C7966: f.glyf = off; f.glyf_len = len; break;    // glyf
      case 0x4F532F32: f.os2 = off; break;                       // OS/2
      case 0x636D6170: f.cmap = off; break;                      // cmap
      case 0x47444546: f.gdef = off; break;                      // GDEF
      case 0x47535542: f.gsub = off; break;                      // GSUB
      case 0x47504F53: f.gpos = off; break;                      // GPOS
      case 0x63767420: f.cvt = off; f.cvt_len = len; break;      // cvt
      case 0x6670676D: f.fpgm = off; f.fpgm_len = len; break;    // fpgm
      case 0x70726570: f.prep = off; f.prep_len = len; break;    // prep
    }
  }
  if (!f.head || !f.hhea || !f.maxp || !f.hmtx || !f.loca || !f.glyf ||
      !f.cmap)
    return false;
  f.upem = r.u16(f.head + 18);
  f.loca_long = r.s16(f.head + 50);
  f.num_glyphs = r.u16(f.maxp + 4);
  f.num_hmetrics = r.u16(f.hhea + 34);
  if (f.upem < 16 || f.num_hmetrics < 1) return false;
  // FreeType: hhea's ascender/descender, else OS/2 typo, else OS/2 win
  f.ascender = r.s16(f.hhea + 4);
  f.descender = r.s16(f.hhea + 6);
  if (!f.ascender && !f.descender && f.os2) {
    f.ascender = r.s16(f.os2 + 68);
    f.descender = r.s16(f.os2 + 70);
    if (!f.ascender && !f.descender) {
      f.ascender = r.u16(f.os2 + 74);
      f.descender = -int(r.u16(f.os2 + 76));
    }
  }
  // cmap: (3,10)/(0,4|6) format 12 first, then (3,1)/(0,*) format 4
  int nsub = r.u16(f.cmap + 2);
  for (int i = 0; i < nsub; ++i) {
    size_t rec = f.cmap + 4 + size_t(i) * 8;
    int pid = r.u16(rec), eid = r.u16(rec + 2);
    size_t off = f.cmap + r.u32(rec + 4);
    int fmt = r.u16(off);
    bool unicode = pid == 0 || (pid == 3 && (eid == 1 || eid == 10));
    if (!unicode) continue;
    if (fmt == 12 && !f.cmap12) f.cmap12 = off;
    if (fmt == 4 && !f.cmap4) f.cmap4 = off;
  }
  return f.cmap12 || f.cmap4;
}

int glyph_of(const Font& f, uint32_t cp) {
  const Reader& r = f.r;
  if (f.cmap12) {
    uint32_t n = r.u32(f.cmap12 + 12);
    size_t lo = 0, hi = n;
    while (lo < hi) {
      size_t mid = (lo + hi) / 2, g = f.cmap12 + 16 + mid * 12;
      uint32_t start = r.u32(g), end = r.u32(g + 4);
      if (cp < start) hi = mid;
      else if (cp > end) lo = mid + 1;
      else {
        uint32_t gid = r.u32(g + 8) + (cp - start);
        return gid < uint32_t(f.num_glyphs) ? int(gid) : 0;
      }
    }
    return 0;
  }
  if (cp > 0xFFFF) return 0;
  size_t t = f.cmap4;
  int segx2 = r.u16(t + 6);
  size_t ends = t + 14, starts = ends + segx2 + 2, deltas = starts + segx2,
         ranges = deltas + segx2;
  for (int s = 0; s < segx2 / 2; ++s) {
    uint32_t end = r.u16(ends + 2 * s);
    if (cp > end) continue;
    uint32_t start = r.u16(starts + 2 * s);
    if (cp < start) return 0;
    int delta = r.s16(deltas + 2 * s);
    uint32_t ro = r.u16(ranges + 2 * s);
    uint32_t gid;
    if (!ro) {
      gid = (cp + delta) & 0xFFFF;
    } else {
      size_t at = ranges + 2 * s + ro + 2 * (cp - start);
      gid = r.u16(at);
      if (gid) gid = (gid + delta) & 0xFFFF;
    }
    return gid < uint32_t(f.num_glyphs) ? int(gid) : 0;
  }
  return 0;
}

int advance_units(const Font& f, int gid) {
  int i = std::min(gid, f.num_hmetrics - 1);
  return f.r.u16(f.hmtx + size_t(i) * 4);
}

// ---------------------------------------------------------------- glyphs
bool glyph_range(const Font& f, int gid, size_t* off, size_t* len) {
  if (gid < 0 || gid >= f.num_glyphs) return false;
  const Reader& r = f.r;
  size_t a, b;
  if (f.loca_long) {
    a = r.u32(f.loca + size_t(gid) * 4);
    b = r.u32(f.loca + size_t(gid) * 4 + 4);
  } else {
    a = size_t(r.u16(f.loca + size_t(gid) * 2)) * 2;
    b = size_t(r.u16(f.loca + size_t(gid) * 2 + 2)) * 2;
  }
  if (b < a || b > f.glyf_len) return false;
  *off = f.glyf + a;
  *len = b - a;
  return true;
}

inline int lsb_units(const Font& f, int gid) {
  if (gid < f.num_hmetrics) return f.r.s16(f.hmtx + size_t(gid) * 4 + 2);
  return f.r.s16(f.hmtx + size_t(f.num_hmetrics) * 4 +
                 size_t(gid - f.num_hmetrics) * 2);
}

// The unscaled outline of a simple glyph, as FT_LOAD_NO_SCALE loads it
// (points in font units, on-curve flags, contour ends); false for a
// composite or broken glyph, true with no points for an empty one.
bool glyph_units(const Font& f, int gid, Outline& out) {
  out.pts.clear();
  out.ends.clear();
  size_t off, len;
  if (!glyph_range(f, gid, &off, &len)) return false;
  if (len == 0) return true;
  const Reader& r = f.r;
  int ncont = r.s16(off);
  if (ncont < 0) return false;
  size_t p = off + 10;
  std::vector<int> ends(ncont);
  for (int i = 0; i < ncont; ++i) ends[i] = r.u16(p + 2 * i);
  p += 2 * size_t(ncont);
  for (int i = 1; i < ncont; ++i)
    if (ends[i] < ends[i - 1]) return false;
  int npts = ncont ? ends[ncont - 1] + 1 : 0;
  p += 2 + r.u16(p);
  std::vector<uint8_t> flags(npts);
  for (int i = 0; i < npts;) {
    if (!r.ok(p, 1)) return false;
    uint8_t fl = r.u8(p++);
    flags[i++] = fl;
    if (fl & 8) {
      int rep = r.u8(p++);
      while (rep-- > 0 && i < npts) flags[i++] = fl;
    }
  }
  out.pts.resize(npts);
  i64 v = 0;
  for (int i = 0; i < npts; ++i) {
    uint8_t fl = flags[i];
    if (fl & 2) { int d = r.u8(p++); v += (fl & 16) ? d : -d; }
    else if (!(fl & 16)) { v += r.s16(p); p += 2; }
    out.pts[i].x = v;
    out.pts[i].on = fl & 1;
  }
  v = 0;
  for (int i = 0; i < npts; ++i) {
    uint8_t fl = flags[i];
    if (fl & 4) { int d = r.u8(p++); v += (fl & 32) ? d : -d; }
    else if (!(fl & 32)) { v += r.s16(p); p += 2; }
    out.pts[i].y = v;
  }
  out.ends = ends;
  return true;
}

}  // namespace

#endif  // ONNXOCR_TTF_FONT_H_
