// TrueType font reader, shaper and glyph rasteriser of utils/font.py: the
// parts of FreeType + HarfBuzz (through PIL's ImageFont.truetype with the
// RAQM layout) that the text panel of draw_ocr and the PDF rasteriser use,
// on a machine without PIL.
//
// * Font: the tables head, hhea, maxp, OS/2, hmtx, loca, glyf (simple and
//   composite glyphs), cmap (formats 4 and 12), GDEF glyph classes, GSUB
//   and GPOS.
// * Size: FreeType's integer-ppem scales (16.16, FT_DivFix) and its
//   grid-fitted size metrics; advances and outline points scaled by
//   FT_MulFix to 26.6.
// * Shaping: HarfBuzz's default (Latin) shaper on one run of one script —
//   the GSUB lookups of the features ccmp, locl, rlig, calt, clig, liga and
//   rclt (single, ligature and chain-context substitutions), then the GPOS
//   kern lookups (pair adjustment, formats 1 and 2), with offsets scaled as
//   hb-ft scales them. Mark positioning (mark, mkmk) is not applied.
// * Hinting: FreeType's TrueType bytecode interpreter as its default v40
//   runs it for an anti-aliased load (fpgm, prep, glyph programs; backward
//   compatibility mode: points move along y only), so outlines are the
//   ones PIL's FT_LOAD_DEFAULT loads.
// * Rasterising: the exact-area coverage accumulation of FreeType's smooth
//   renderer (ftgrays: 24.8 cells, quadratic arcs split as it splits them,
//   non-zero winding), on the outline moved to its bitmap's origin.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
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

// ------------------------------------------------------------------ sizes
struct Size {
  i64 x_scale, y_scale;  // 16.16, font units -> 26.6
  i64 ascender, descender;  // 26.6
  i64 hb_x_mult;          // HarfBuzz's em multiplier of hb-ft's scale
};

Size make_size(const Font& f, int ppem) {
  Size s;
  // FT_Request_Size(NOMINAL, ppem*64); TrueType fonts with integer ppem
  // (head flags bit 3) then recompute the scales from the rounded ppem
  s.x_scale = divfix(i64(ppem) * 64, f.upem);
  s.y_scale = s.x_scale;
  s.ascender = pix_ceil(mulfix(f.ascender, s.y_scale));
  s.descender = pix_floor(mulfix(f.descender, s.y_scale));
  // hb_ft_font: scale = (x_scale * upem + 2^15) >> 16; x_mult = scale<<16/upem
  i64 hb_scale = (s.x_scale * f.upem + (1 << 15)) >> 16;
  s.hb_x_mult = (hb_scale << 16) / f.upem;
  return s;
}

inline i64 hb_em_scale(const Size& s, int v) {
  return (i64(v) * s.hb_x_mult + 32768) >> 16;
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

// ------------------------------------------------------------ hinting
// FreeType's TrueType bytecode interpreter (ttinterp.c) as its default v40
// ("minimal subpixel hinting") runs it for an anti-aliased load: the
// font's fpgm and prep, then each glyph's instructions, in backward
// compatibility mode (no moves along x; no moves at all once IUP ran on
// both axes), non-pedantic (stack underflow reads zeros, bad references
// are skipped).

i64 muldiv(i64 a, i64 b, i64 c) {  // FT_MulDiv: a * b / c, rounded
  int s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  if (c < 0) { c = -c; s = -s; }
  i64 d = c > 0 ? (i64)(((__int128)a * b + (c >> 1)) / c) : 0x7FFFFFFFL;
  return s > 0 ? d : -d;
}

i64 muldiv_no_round(i64 a, i64 b, i64 c) {
  int s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  if (c < 0) { c = -c; s = -s; }
  i64 d = c > 0 ? (i64)((__int128)a * b / c) : 0x7FFFFFFFL;
  return s > 0 ? d : -d;
}

inline i64 mulfix14(i64 a, int b) {  // TT_MulFix14
  i64 ab = a * b;
  ab += 0x2000 + (ab >> 63);
  return ab >> 14;
}

inline i64 dotfix14(i64 ax, i64 ay, int bx, int by) {  // TT_DotFix14
  i64 t = ax * bx + ay * by;
  t += 0x2000 + (t >> 63);
  return t >> 14;
}

int msb32(uint32_t z) {
  int s = 0;
  while (z >>= 1) ++s;
  return s;
}

// FT_Vector_NormLen: (x, y) scaled to unit length in 16.16
void norm_len(i64* vx, i64* vy) {
  int32_t x_ = int32_t(*vx), y_ = int32_t(*vy);
  uint32_t x = uint32_t(x_), y = uint32_t(y_);
  int sx = 1, sy = 1;
  if (x_ < 0) { x = uint32_t(-x_); sx = -1; }
  if (y_ < 0) { y = uint32_t(-y_); sy = -1; }
  if (x == 0) {
    if (y > 0) *vy = sy * 0x10000;
    return;
  }
  if (y == 0) {
    if (x > 0) *vx = sx * 0x10000;
    return;
  }
  uint32_t l = x > y ? x + (y >> 1) : y + (x >> 1);
  int shift = 31 - msb32(l);
  shift -= 15 + (l >= (0xAAAAAAAAUL >> shift));
  if (shift > 0) {
    x <<= shift;
    y <<= shift;
    l = x > y ? x + (y >> 1) : y + (x >> 1);
  } else {
    x >>= -shift;
    y >>= -shift;
    l >>= -shift;
  }
  int32_t b = 0x10000 - int32_t(l);
  x_ = int32_t(x);
  y_ = int32_t(y);
  uint32_t u, v;
  int32_t z;
  do {
    u = uint32_t(x_ + (int32_t)((int64_t(x_) * b) >> 16));
    v = uint32_t(y_ + (int32_t)((int64_t(y_) * b) >> 16));
    z = -int32_t(u * u + v * v) / 0x200;
    z = int32_t(int64_t(z) * ((0x10000 + b) >> 8) / 0x10000);
    b += z;
  } while (z > 0);
  *vx = sx < 0 ? -i64(u) : i64(u);
  *vy = sy < 0 ? -i64(v) : i64(v);
}

struct Vec { i64 x, y; };

struct Zone {
  std::vector<Vec> orus, org, cur;
  std::vector<uint8_t> tags;   // 1 on curve, 8 touched x, 16 touched y
  std::vector<int> ends;       // contour end points (zone-relative)
  int n_points() const { return int(cur.size()); }
};

const uint8_t kTouchX = 8, kTouchY = 16;

struct GState {
  int rp0 = 0, rp1 = 0, rp2 = 0;
  int dual_x = 0x4000, dual_y = 0, proj_x = 0x4000, proj_y = 0,
      free_x = 0x4000, free_y = 0;
  i64 loop = 1;
  i64 min_dist = 64;
  int round_state = 1;
  bool auto_flip = true;
  i64 cvt_cutin = 68, sw_cutin = 0, sw_value = 0;
  int delta_base = 9, delta_shift = 3;
  int instruct_control = 0;
  int gep0 = 1, gep1 = 1, gep2 = 1;
};

struct FuncDef { int range = 0; i64 start = 0; bool active = false; };

struct Program { const uint8_t* code = nullptr; i64 size = 0; };

struct Hinter {
  const Font& f;
  int ppem = 0;
  i64 scale = 0;                 // 16.16
  std::vector<i64> cvt;          // 26.6, per size
  std::vector<i64> storage;
  std::vector<FuncDef> fdefs;
  std::map<int, FuncDef> idefs;
  GState size_gs;                // after prep
  Zone twilight, pts;
  Zone* zp[3];
  GState gs;
  std::vector<i64> stack;
  i64 top = 0;
  Program ranges[4];             // 1 fpgm, 2 prep, 3 glyph
  int cur_range = 0, ini_range = 0;
  i64 ip = 0;
  int opcode = 0;
  bool step = true, error = false;
  bool iupx = false, iupy = false;
  bool composite = false;
  bool backward = true;
  i64 period = 64, phase = 0, threshold = 32;
  i64 f_dot_p = 0x4000;
  i64 metrics_scale = 0;        // x_scale during a glyph (1.0 for composites)
  struct Call { int range; i64 ip; i64 count; FuncDef def; };
  std::vector<Call> calls;
  bool ok = false;              // hinting possible at this size

  explicit Hinter(const Font& font) : f(font) {}

  // --- rounding
  i64 round(i64 d) const {
    switch (gs.round_state) {
      case 0: {  // half grid
        i64 v;
        if (d >= 0) { v = pix_floor(d) + 32; if (v < 0) v = 32; }
        else { v = -(pix_floor(-d) + 32); if (v > 0) v = -32; }
        return v;
      }
      case 1: {
        i64 v;
        if (d >= 0) { v = pix_round(d); if (v < 0) v = 0; }
        else { v = -pix_round(-d); if (v > 0) v = 0; }
        return v;
      }
      case 2: {  // double grid
        i64 v;
        if (d >= 0) { v = (d + 16) & ~i64(31); if (v < 0) v = 0; }
        else { v = -((-d + 16) & ~i64(31)); if (v > 0) v = 0; }
        return v;
      }
      case 3: {  // down
        i64 v;
        if (d >= 0) { v = pix_floor(d); if (v < 0) v = 0; }
        else { v = -pix_floor(-d); if (v > 0) v = 0; }
        return v;
      }
      case 4: {  // up
        i64 v;
        if (d >= 0) { v = pix_ceil(d); if (v < 0) v = 0; }
        else { v = -pix_ceil(-d); if (v > 0) v = 0; }
        return v;
      }
      case 5: return d;  // off
      case 6: {  // super
        i64 v;
        if (d >= 0) {
          v = ((d - phase + threshold) & -period) + phase;
          if (v < 0) v = phase;
        } else {
          v = -(((-d - phase + threshold) & -period) + phase);
          if (v > 0) v = -phase;
        }
        return v;
      }
      default: {  // super 45
        i64 v;
        if (d >= 0) {
          v = ((d - phase + threshold) / period) * period + phase;
          if (v < 0) v = phase;
        } else {
          v = -((((-d - phase + threshold) / period) * period) + phase);
          if (v > 0) v = -phase;
        }
        return v;
      }
    }
  }
  static i64 round_none(i64 d) { return d; }

  void super_round(i64 grid, i64 sel) {
    switch (sel & 0xC0) {
      case 0: period = grid / 2; break;
      case 0x40: period = grid; break;
      case 0x80: period = grid * 2; break;
      default: period = grid; break;
    }
    switch (sel & 0x30) {
      case 0: phase = 0; break;
      case 0x10: phase = period / 4; break;
      case 0x20: phase = period / 2; break;
      default: phase = period * 3 / 4; break;
    }
    if ((sel & 0x0F) == 0) threshold = period - 1;
    else threshold = (int(sel & 0x0F) - 4) * period / 8;
    period >>= 8;
    phase >>= 8;
    threshold >>= 8;
  }

  // --- projections and moves
  i64 project(i64 dx, i64 dy) const {
    if (gs.proj_x == 0x4000) return dx;
    if (gs.proj_y == 0x4000) return dy;
    return dotfix14(dx, dy, gs.proj_x, gs.proj_y);
  }
  i64 dualproj(i64 dx, i64 dy) const {
    if (gs.dual_x == 0x4000) return dx;
    if (gs.dual_y == 0x4000) return dy;
    return dotfix14(dx, dy, gs.dual_x, gs.dual_y);
  }
  void compute_funcs() {
    if (gs.free_x == 0x4000) f_dot_p = gs.proj_x;
    else if (gs.free_y == 0x4000) f_dot_p = gs.proj_y;
    else
      f_dot_p = (i64(gs.proj_x) * gs.free_x + i64(gs.proj_y) * gs.free_y) >>
                14;
    if ((f_dot_p < 0 ? -f_dot_p : f_dot_p) < 0x400) f_dot_p = 0x4000;
  }
  bool post_iup() const { return backward && iupx && iupy; }

  void move(Zone& z, int p, i64 d) {
    if (f_dot_p == 0x4000 && gs.free_x == 0x4000) {  // Direct_Move_X
      if (!backward) z.cur[p].x += d;
      z.tags[p] |= kTouchX;
      return;
    }
    if (f_dot_p == 0x4000 && gs.free_y == 0x4000) {  // Direct_Move_Y
      if (!post_iup()) z.cur[p].y += d;
      z.tags[p] |= kTouchY;
      return;
    }
    if (gs.free_x) {
      if (!backward) z.cur[p].x += muldiv(d, gs.free_x, f_dot_p);
      z.tags[p] |= kTouchX;
    }
    if (gs.free_y) {
      if (!post_iup()) z.cur[p].y += muldiv(d, gs.free_y, f_dot_p);
      z.tags[p] |= kTouchY;
    }
  }
  void move_orig(Zone& z, int p, i64 d) {
    if (f_dot_p == 0x4000 && gs.free_x == 0x4000) { z.org[p].x += d; return; }
    if (f_dot_p == 0x4000 && gs.free_y == 0x4000) { z.org[p].y += d; return; }
    if (gs.free_x) z.org[p].x += muldiv(d, gs.free_x, f_dot_p);
    if (gs.free_y) z.org[p].y += muldiv(d, gs.free_y, f_dot_p);
  }
  void move_zp2(int p, i64 dx, i64 dy, bool touch) {
    Zone& z = *zp[2];
    if (gs.free_x) {
      if (!backward) z.cur[p].x += dx;
      if (touch) z.tags[p] |= kTouchX;
    }
    if (gs.free_y) {
      if (!post_iup()) z.cur[p].y += dy;
      if (touch) z.tags[p] |= kTouchY;
    }
  }

  static bool bad(i64 p, int n) { return p < 0 || p >= n; }

  void normalize(i64 vx, i64 vy, int* rx, int* ry) {
    if (vx == 0 && vy == 0) return;
    norm_len(&vx, &vy);
    *rx = int(int16_t(vx / 4));
    *ry = int(int16_t(vy / 4));
  }

  // --- code
  int length_at(const Program& pr, i64 at) const {
    int op = pr.code[at];
    if (op == 0x40) return at + 1 < pr.size ? 2 + pr.code[at + 1] : -1;
    if (op == 0x41) return at + 1 < pr.size ? 2 + 2 * pr.code[at + 1] : -1;
    if (op >= 0xB0 && op <= 0xB7) return 2 + (op - 0xB0);
    if (op >= 0xB8 && op <= 0xBF) return 1 + 2 * (op - 0xB8 + 1);
    return 1;
  }
  // move to the next instruction; its opcode in `opcode`
  bool skip_code() {
    const Program& pr = ranges[cur_range];
    int len = length_at(pr, ip);
    if (len < 0) return false;
    ip += len;
    if (ip >= pr.size) return false;
    opcode = pr.code[ip];
    return true;
  }

  i64 read_cvt(i64 i) const { return i >= 0 && i < i64(cvt.size()) ? cvt[i] : 0; }

  bool call(i64 fn, i64 count) {
    if (fn < 0 || fn >= i64(fdefs.size()) || !fdefs[fn].active) return false;
    if (calls.size() >= 32) return false;
    if (count > 0) {
      calls.push_back({cur_range, ip + 1, count, fdefs[fn]});
      cur_range = fdefs[fn].range;
      ip = fdefs[fn].start;
      step = false;
    }
    return true;
  }

  // Run a program (range 1 fpgm, 2 prep, 3 glyph) → false on an error
  // that stops it.
  bool run(int range) {
    cur_range = ini_range = range;
    ip = 0;
    top = 0;
    calls.clear();
    iupx = iupy = false;
    zp[0] = zp[1] = zp[2] = &pts;
    gs.gep0 = gs.gep1 = gs.gep2 = 1;
    compute_funcs();
    long counter = 0;
    while (ip < ranges[cur_range].size) {
      if (++counter > 1000000) return false;
      if (!exec_one()) return false;
      if (ip >= ranges[cur_range].size && !calls.empty()) return false;
    }
    return true;
  }

  bool exec_one();
  bool setup(int ppem_);
  void hint(Zone& z, const uint8_t* ins, int n_ins, bool is_comp);
  void iup(bool x_axis);
  bool displacement(i64* dx, i64* dy, Zone** zone, int* refp);
  void mdrp(i64* a);
  void mirp(i64* a);
};

// pops (high nibble) and pushes (low nibble) of each opcode (FreeType's
// Pop_Push_Count)
const uint8_t kPopPush[256] = {
    /* 0x00 */ 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x20, 0x20,
    /* 0x08 */ 0x20, 0x20, 0x20, 0x20, 0x02, 0x02, 0x00, 0x50,
    /* 0x10 */ 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
    /* 0x18 */ 0x00, 0x00, 0x10, 0x00, 0x10, 0x10, 0x10, 0x10,
    /* 0x20 */ 0x12, 0x10, 0x00, 0x22, 0x01, 0x11, 0x10, 0x20,
    /* 0x28 */ 0x00, 0x10, 0x20, 0x10, 0x10, 0x00, 0x10, 0x10,
    /* 0x30 */ 0x00, 0x00, 0x00, 0x00, 0x10, 0x10, 0x10, 0x10,
    /* 0x38 */ 0x10, 0x00, 0x20, 0x20, 0x00, 0x00, 0x20, 0x20,
    /* 0x40 */ 0x00, 0x00, 0x20, 0x11, 0x20, 0x11, 0x11, 0x11,
    /* 0x48 */ 0x20, 0x21, 0x21, 0x01, 0x01, 0x00, 0x00, 0x10,
    /* 0x50 */ 0x21, 0x21, 0x21, 0x21, 0x21, 0x21, 0x11, 0x11,
    /* 0x58 */ 0x10, 0x00, 0x21, 0x21, 0x11, 0x10, 0x10, 0x10,
    /* 0x60 */ 0x21, 0x21, 0x21, 0x21, 0x11, 0x11, 0x11, 0x11,
    /* 0x68 */ 0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x11,
    /* 0x70 */ 0x20, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
    /* 0x78 */ 0x20, 0x20, 0x00, 0x00, 0x00, 0x00, 0x10, 0x10,
    /* 0x80 */ 0x00, 0x20, 0x20, 0x00, 0x00, 0x10, 0x20, 0x20,
    /* 0x88 */ 0x11, 0x10, 0x33, 0x21, 0x21, 0x10, 0x20, 0x00,
    /* 0x90 */ 0x00, 0x00, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00,
    /* 0x98 */ 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    /* 0xA0 */ 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    /* 0xA8 */ 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    /* 0xB0 */ 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
    /* 0xB8 */ 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
    /* 0xC0 */ 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
    /* 0xC8 */ 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
    /* 0xD0 */ 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
    /* 0xD8 */ 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x10,
    /* 0xE0 */ 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20,
    /* 0xE8 */ 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20,
    /* 0xF0 */ 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20,
    /* 0xF8 */ 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20};

bool Hinter::exec_one() {
  const Program& pr = ranges[cur_range];
  opcode = pr.code[ip];
  int len = length_at(pr, ip);
  if (len < 0 || ip + len > pr.size) return false;
  int pops = kPopPush[opcode] >> 4, pushes = kPopPush[opcode] & 15;
  i64 args = top - pops;
  if (args < 0) {  // non-pedantic: missing arguments read as zeros
    for (int i = 0; i < pops; ++i) stack[i] = 0;
    args = 0;
  }
  i64 new_top = args + pushes;
  if (new_top > i64(stack.size())) return false;
  i64* a = &stack[args];
  step = true;
  bool fail = false;
  Zone& z0 = *zp[0];
  Zone& z1 = *zp[1];
  Zone& z2 = *zp[2];
  int op = opcode;
  switch (op) {
    case 0x00: case 0x01: case 0x02: case 0x03: case 0x04: case 0x05: {
      int aa = (op & 1) << 14, bb = aa ^ 0x4000;
      if (op < 4) { gs.proj_x = gs.dual_x = aa; gs.proj_y = gs.dual_y = bb; }
      if ((op & 2) == 0) { gs.free_x = aa; gs.free_y = bb; }
      compute_funcs();
      break;
    }
    case 0x06: case 0x07: case 0x08: case 0x09: {  // SPVTL, SFVTL
      i64 i1 = a[1], i2 = a[0];
      if (bad(i1, z2.n_points()) || bad(i2, z1.n_points())) break;
      i64 A = z1.cur[i2].x - z2.cur[i1].x, B = z1.cur[i2].y - z2.cur[i1].y;
      int o = op;
      if (A == 0 && B == 0) { A = 0x4000; o = 0; }
      if (o & 1) { i64 C = B; B = A; A = -C; }
      if (op < 8) {
        normalize(A, B, &gs.proj_x, &gs.proj_y);
        gs.dual_x = gs.proj_x; gs.dual_y = gs.proj_y;
      } else {
        normalize(A, B, &gs.free_x, &gs.free_y);
      }
      compute_funcs();
      break;
    }
    case 0x0A:  // SPVFS
      normalize(int16_t(a[0]), int16_t(a[1]), &gs.proj_x, &gs.proj_y);
      gs.dual_x = gs.proj_x; gs.dual_y = gs.proj_y;
      compute_funcs();
      break;
    case 0x0B:
      normalize(int16_t(a[0]), int16_t(a[1]), &gs.free_x, &gs.free_y);
      compute_funcs();
      break;
    case 0x0C: a[0] = gs.proj_x; a[1] = gs.proj_y; break;
    case 0x0D: a[0] = gs.free_x; a[1] = gs.free_y; break;
    case 0x0E:
      gs.free_x = gs.proj_x; gs.free_y = gs.proj_y;
      compute_funcs();
      break;
    case 0x0F: {  // ISECT
      i64 point = a[0], a0 = a[1], a1 = a[2], b0 = a[3], b1 = a[4];
      if (bad(b0, z0.n_points()) || bad(b1, z0.n_points()) ||
          bad(a0, z1.n_points()) || bad(a1, z1.n_points()) ||
          bad(point, z2.n_points()))
        break;
      i64 dbx = z0.cur[b1].x - z0.cur[b0].x, dby = z0.cur[b1].y - z0.cur[b0].y;
      i64 dax = z1.cur[a1].x - z1.cur[a0].x, day = z1.cur[a1].y - z1.cur[a0].y;
      i64 dx = z0.cur[b0].x - z1.cur[a0].x, dy = z0.cur[b0].y - z1.cur[a0].y;
      i64 disc = muldiv(dax, -dby, 0x40) + muldiv(day, dbx, 0x40);
      i64 dot = muldiv(dax, dbx, 0x40) + muldiv(day, dby, 0x40);
      if (19 * (disc < 0 ? -disc : disc) > (dot < 0 ? -dot : dot)) {
        i64 val = muldiv(dx, -dby, 0x40) + muldiv(dy, dbx, 0x40);
        z2.cur[point].x = z1.cur[a0].x + muldiv(val, dax, disc);
        z2.cur[point].y = z1.cur[a0].y + muldiv(val, day, disc);
      } else {
        z2.cur[point].x = (z1.cur[a0].x + z1.cur[a1].x + z0.cur[b0].x +
                           z0.cur[b1].x) / 4;
        z2.cur[point].y = (z1.cur[a0].y + z1.cur[a1].y + z0.cur[b0].y +
                           z0.cur[b1].y) / 4;
      }
      z2.tags[point] |= kTouchX | kTouchY;
      break;
    }
    case 0x10: gs.rp0 = int(uint16_t(a[0])); break;
    case 0x11: gs.rp1 = int(uint16_t(a[0])); break;
    case 0x12: gs.rp2 = int(uint16_t(a[0])); break;
    case 0x13: case 0x14: case 0x15: case 0x16: {  // SZP0-2, SZPS
      if (a[0] != 0 && a[0] != 1) { fail = true; break; }
      Zone* zz = a[0] ? &pts : &twilight;
      int g = int(a[0]);
      if (op == 0x13) { zp[0] = zz; gs.gep0 = g; }
      else if (op == 0x14) { zp[1] = zz; gs.gep1 = g; }
      else if (op == 0x15) { zp[2] = zz; gs.gep2 = g; }
      else {
        zp[0] = zp[1] = zp[2] = zz;
        gs.gep0 = gs.gep1 = gs.gep2 = g;
      }
      break;
    }
    case 0x17:
      if (a[0] >= 0) gs.loop = a[0] > 0xFFFF ? 0xFFFF : a[0];
      break;
    case 0x18: gs.round_state = 1; break;
    case 0x19: gs.round_state = 0; break;
    case 0x1A: gs.min_dist = a[0]; break;
    case 0x1B: {  // ELSE: skip to the matching EIF
      int n = 1;
      do {
        if (!skip_code()) { fail = true; break; }
        if (opcode == 0x58) n++;
        else if (opcode == 0x59) n--;
      } while (n != 0);
      break;
    }
    case 0x1C: case 0x78: case 0x79: {  // JMPR, JROT, JROF
      if (op == 0x78 && a[1] == 0) break;
      if (op == 0x79 && a[1] != 0) break;
      if (a[0] == 0 && args == 0) { fail = true; break; }
      ip += a[0];
      if (ip < 0 || (calls.empty() && ip > pr.size)) { fail = true; break; }
      step = false;
      break;
    }
    case 0x1D: gs.cvt_cutin = a[0]; break;
    case 0x1E: gs.sw_cutin = a[0]; break;
    case 0x1F: gs.sw_value = mulfix(a[0], scale); break;
    case 0x20: a[1] = a[0]; break;
    case 0x21: break;
    case 0x22: new_top = 0; break;
    case 0x23: { i64 t = a[0]; a[0] = a[1]; a[1] = t; break; }
    case 0x24: a[0] = top; break;
    case 0x25: {  // CINDEX
      i64 l = a[0];
      a[0] = (l <= 0 || l > args) ? 0 : stack[args - l];
      break;
    }
    case 0x26: {  // MINDEX
      i64 l = a[0];
      if (l <= 0 || l > args) break;
      i64 k = stack[args - l];
      for (i64 i = args - l; i < args - 1; ++i) stack[i] = stack[i + 1];
      stack[args - 1] = k;
      break;
    }
    case 0x27: {  // ALIGNPTS
      i64 p1 = a[0], p2 = a[1];
      if (bad(p1, z1.n_points()) || bad(p2, z0.n_points())) break;
      i64 d = project(z0.cur[p2].x - z1.cur[p1].x,
                      z0.cur[p2].y - z1.cur[p1].y) / 2;
      move(z1, int(p1), d);
      move(z0, int(p2), -d);
      break;
    }
    case 0x29: {  // UTP
      i64 p = a[0];
      if (bad(p, z0.n_points())) break;
      uint8_t mask = 0xFF;
      if (gs.free_x) mask &= ~kTouchX;
      if (gs.free_y) mask &= ~kTouchY;
      z0.tags[p] &= mask;
      break;
    }
    case 0x2A:  // LOOPCALL
      if (!call(a[1], a[0])) fail = true;
      break;
    case 0x2B:
      if (!call(a[0], 1)) fail = true;
      break;
    case 0x2C: case 0x89: {  // FDEF, IDEF
      i64 n = a[0];
      FuncDef d{cur_range, ip + 1, true};
      if (op == 0x2C) {
        if (n < 0 || n >= i64(fdefs.size())) { fail = true; break; }
        fdefs[n] = d;
      } else {
        idefs[int(n)] = d;
      }
      for (;;) {
        if (!skip_code()) { fail = true; break; }
        if (opcode == 0x89 || opcode == 0x2C) { fail = true; break; }
        if (opcode == 0x2D) break;
      }
      break;
    }
    case 0x2D: {  // ENDF
      if (calls.empty()) { fail = true; break; }
      Call& c = calls.back();
      c.count--;
      step = false;
      if (c.count > 0) {
        ip = c.def.start;
      } else {
        cur_range = c.range;
        ip = c.ip;
        calls.pop_back();
      }
      break;
    }
    case 0x2E: case 0x2F: {  // MDAP
      i64 p = a[0];
      if (bad(p, z0.n_points())) break;
      i64 d = 0;
      if (op & 1) {
        i64 c = project(z0.cur[p].x, z0.cur[p].y);
        d = round(c) - c;
      }
      move(z0, int(p), d);
      gs.rp0 = gs.rp1 = int(p);
      break;
    }
    case 0x30: case 0x31: {  // IUP
      if (pts.ends.empty()) break;
      if (backward) {
        if (iupx && iupy) break;
        if (op & 1) iupx = true; else iupy = true;
      }
      iup(op & 1);
      break;
    }
    case 0x32: case 0x33: {  // SHP
      if (top < gs.loop) { gs.loop = 1; new_top = top; break; }
      i64 dx, dy;
      Zone* rz;
      int refp;
      i64 av = top;
      if (!displacement(&dx, &dy, &rz, &refp)) break;
      while (gs.loop > 0) {
        av--;
        i64 p = stack[av];
        if (!bad(p, z2.n_points())) move_zp2(int(p), dx, dy, true);
        gs.loop--;
      }
      gs.loop = 1;
      new_top = av;
      break;
    }
    case 0x34: case 0x35: {  // SHC
      i64 c = a[0];
      if (c < 0 || c >= i64(z2.ends.size()) ) break;
      i64 dx, dy;
      Zone* rz;
      int refp;
      if (!displacement(&dx, &dy, &rz, &refp)) break;
      int start = c == 0 ? 0 : z2.ends[c - 1] + 1;
      int limit = gs.gep2 == 0 ? z2.n_points() : z2.ends[c] + 1;
      for (int i = start; i < limit; ++i)
        if (rz != zp[2] || refp != i) move_zp2(i, dx, dy, true);
      break;
    }
    case 0x36: case 0x37: {  // SHZ
      if (a[0] < 0 || a[0] > 1) break;
      i64 dx, dy;
      Zone* rz;
      int refp;
      if (!displacement(&dx, &dy, &rz, &refp)) break;
      int limit = 0;
      if (gs.gep2 == 0) limit = z2.n_points();
      else if (gs.gep2 == 1 && !z2.ends.empty()) limit = z2.ends.back() + 1;
      for (int i = 0; i < limit; ++i)
        if (rz != zp[2] || refp != i) move_zp2(i, dx, dy, false);
      break;
    }
    case 0x38: {  // SHPIX
      if (top < gs.loop + 1) { gs.loop = 1; new_top = args; break; }
      bool in_twilight = gs.gep0 == 0 && gs.gep1 == 0 && gs.gep2 == 0;
      i64 dx = mulfix14(a[0], gs.free_x), dy = mulfix14(a[0], gs.free_y);
      i64 av = args;
      while (gs.loop > 0) {
        av--;
        i64 p = stack[av];
        if (!bad(p, z2.n_points())) {
          if (backward) {
            if (in_twilight ||
                (!(iupx && iupy) &&
                 ((composite && gs.free_y != 0) || (z2.tags[p] & kTouchY))))
              move_zp2(int(p), 0, dy, true);
          } else {
            move_zp2(int(p), dx, dy, true);
          }
        }
        gs.loop--;
      }
      gs.loop = 1;
      new_top = av;
      break;
    }
    case 0x39: {  // IP
      if (top < gs.loop) { gs.loop = 1; new_top = top; break; }
      bool tw = gs.gep0 == 0 || gs.gep1 == 0 || gs.gep2 == 0;
      i64 old_range = 0, cur_range_d = 0;
      Vec ob{0, 0}, cb{0, 0};
      bool refs = !(bad(gs.rp1, z0.n_points()) || bad(gs.rp2, z1.n_points()));
      if (refs) {
        ob = tw ? z0.org[gs.rp1] : z0.orus[gs.rp1];
        cb = z0.cur[gs.rp1];
        const Vec& o2 = tw ? z1.org[gs.rp2] : z1.orus[gs.rp2];
        old_range = dualproj(o2.x - ob.x, o2.y - ob.y);
        cur_range_d = project(z1.cur[gs.rp2].x - cb.x, z1.cur[gs.rp2].y - cb.y);
      }
      i64 av = top;
      while (gs.loop > 0) {
        av--;
        i64 p = stack[av];
        gs.loop--;
        if (bad(p, z2.n_points())) continue;
        const Vec& op_ = tw ? z2.org[p] : z2.orus[p];
        i64 org_dist = refs ? dualproj(op_.x - ob.x, op_.y - ob.y) : 0;
        i64 cur_dist = refs ? project(z2.cur[p].x - cb.x, z2.cur[p].y - cb.y)
                            : 0;
        i64 new_dist;
        if (org_dist) {
          new_dist = old_range ? muldiv(org_dist, cur_range_d, old_range)
                               : org_dist;
        } else {
          new_dist = 0;
        }
        move(z2, int(p), new_dist - cur_dist);
      }
      gs.loop = 1;
      new_top = av;
      break;
    }
    case 0x3A: case 0x3B: {  // MSIRP
      i64 p = a[0];
      if (bad(p, z1.n_points()) || bad(gs.rp0, z0.n_points())) break;
      if (gs.gep1 == 0) {
        z1.org[p] = z0.org[gs.rp0];
        move_orig(z1, int(p), a[1]);
        z1.cur[p] = z1.org[p];
      }
      i64 d = project(z1.cur[p].x - z0.cur[gs.rp0].x,
                      z1.cur[p].y - z0.cur[gs.rp0].y);
      move(z1, int(p), a[1] - d);
      gs.rp1 = gs.rp0;
      gs.rp2 = int(p);
      if (op & 1) gs.rp0 = int(p);
      break;
    }
    case 0x3C: {  // ALIGNRP
      if (top < gs.loop || bad(gs.rp0, z0.n_points())) {
        gs.loop = 1; new_top = top; break;
      }
      i64 av = top;
      while (gs.loop > 0) {
        av--;
        i64 p = stack[av];
        if (!bad(p, z1.n_points())) {
          i64 d = project(z1.cur[p].x - z0.cur[gs.rp0].x,
                          z1.cur[p].y - z0.cur[gs.rp0].y);
          move(z1, int(p), -d);
        }
        gs.loop--;
      }
      gs.loop = 1;
      new_top = av;
      break;
    }
    case 0x3D: gs.round_state = 2; break;
    case 0x3E: case 0x3F: {  // MIAP
      i64 e = a[1], p = a[0];
      if (bad(p, z0.n_points()) || e < 0 || e >= i64(cvt.size())) {
        gs.rp0 = gs.rp1 = int(uint16_t(p));
        break;
      }
      i64 d = read_cvt(e);
      if (gs.gep0 == 0) {
        z0.org[p].x = mulfix14(d, gs.free_x);
        z0.org[p].y = mulfix14(d, gs.free_y);
        z0.cur[p] = z0.org[p];
      }
      i64 org_dist = project(z0.cur[p].x, z0.cur[p].y);
      if (op & 1) {
        i64 delta = d - org_dist;
        if (delta < 0) delta = -delta;
        if (delta > gs.cvt_cutin) d = org_dist;
        d = round(d);
      }
      move(z0, int(p), d - org_dist);
      gs.rp0 = gs.rp1 = int(p);
      break;
    }
    case 0x40: case 0x41: {  // NPUSHB, NPUSHW
      int n = pr.code[ip + 1];
      if (top + n > i64(stack.size())) { fail = true; break; }
      for (int i = 0; i < n; ++i)
        stack[top + i] = op == 0x40
            ? i64(pr.code[ip + 2 + i])
            : i64(int16_t((pr.code[ip + 2 + 2 * i] << 8) |
                          pr.code[ip + 3 + 2 * i]));
      new_top = top + n;
      break;
    }
    case 0x42:
      if (a[0] >= 0 && a[0] < i64(storage.size())) storage[a[0]] = a[1];
      break;
    case 0x43:
      a[0] = (a[0] >= 0 && a[0] < i64(storage.size())) ? storage[a[0]] : 0;
      break;
    case 0x44:
      if (a[0] >= 0 && a[0] < i64(cvt.size())) cvt[a[0]] = a[1];
      break;
    case 0x45: a[0] = read_cvt(a[0]); break;
    case 0x46: case 0x47: {  // GC
      i64 l = a[0];
      if (bad(l, z2.n_points())) { a[0] = 0; break; }
      a[0] = (op & 1) ? dualproj(z2.org[l].x, z2.org[l].y)
                      : project(z2.cur[l].x, z2.cur[l].y);
      break;
    }
    case 0x48: {  // SCFS
      i64 l = a[0];
      if (bad(l, z2.n_points())) break;
      i64 k = project(z2.cur[l].x, z2.cur[l].y);
      move(z2, int(l), a[1] - k);
      if (gs.gep2 == 0) z2.org[l] = z2.cur[l];
      break;
    }
    case 0x49: case 0x4A: {  // MD
      i64 k = a[1], l = a[0], d = 0;
      if (!(bad(l, z0.n_points()) || bad(k, z1.n_points()))) {
        if (op & 1) {
          d = project(z0.cur[l].x - z1.cur[k].x, z0.cur[l].y - z1.cur[k].y);
        } else if (gs.gep0 == 0 || gs.gep1 == 0) {
          d = dualproj(z0.org[l].x - z1.org[k].x, z0.org[l].y - z1.org[k].y);
        } else {
          d = dualproj(z0.orus[l].x - z1.orus[k].x,
                       z0.orus[l].y - z1.orus[k].y);
          d = mulfix(d, metrics_scale);
        }
      }
      a[0] = d;
      break;
    }
    case 0x4B: a[0] = ppem; break;
    case 0x4C: a[0] = i64(ppem) * 64; break;
    case 0x4D: gs.auto_flip = true; break;
    case 0x4E: gs.auto_flip = false; break;
    case 0x4F: break;
    case 0x50: a[0] = a[0] < a[1]; break;
    case 0x51: a[0] = a[0] <= a[1]; break;
    case 0x52: a[0] = a[0] > a[1]; break;
    case 0x53: a[0] = a[0] >= a[1]; break;
    case 0x54: a[0] = a[0] == a[1]; break;
    case 0x55: a[0] = a[0] != a[1]; break;
    case 0x56: a[0] = (round(a[0]) & 127) == 64; break;
    case 0x57: a[0] = (round(a[0]) & 127) == 0; break;
    case 0x58: {  // IF
      if (a[0] != 0) break;
      int n = 1;
      bool out = false;
      do {
        if (!skip_code()) { fail = true; break; }
        if (opcode == 0x58) n++;
        else if (opcode == 0x1B) out = n == 1;
        else if (opcode == 0x59) { n--; out = n == 0; }
      } while (!out);
      break;
    }
    case 0x59: break;
    case 0x5A: a[0] = a[0] && a[1]; break;
    case 0x5B: a[0] = a[0] || a[1]; break;
    case 0x5C: a[0] = !a[0]; break;
    case 0x5D: case 0x71: case 0x72: {  // DELTAP
      i64 n = a[0];
      i64 av = args;
      for (i64 k = 1; k <= n; ++k) {
        if (av < 2) { av = 0; break; }
        av -= 2;
        i64 p = i64(uint16_t(stack[av + 1])), b = stack[av];
        if (bad(p, z0.n_points())) continue;
        i64 c = (uint64_t(b) & 0xF0) >> 4;
        if (op == 0x71) c += 16;
        if (op == 0x72) c += 32;
        c += gs.delta_base;
        if (ppem != c) continue;
        b = i64(uint64_t(b) & 0xF) - 8;
        if (b >= 0) b++;
        b *= i64(1) << (6 - gs.delta_shift);
        if (backward) {
          if (!(iupx && iupy) &&
              ((composite && gs.free_y != 0) || (z0.tags[p] & kTouchY)))
            move(z0, int(p), b);
        } else {
          move(z0, int(p), b);
        }
      }
      new_top = av;
      break;
    }
    case 0x5E: gs.delta_base = int(uint16_t(a[0])); break;
    case 0x5F:
      if (uint64_t(a[0]) > 6) fail = true; else gs.delta_shift = int(a[0]);
      break;
    case 0x60: a[0] += a[1]; break;
    case 0x61: a[0] -= a[1]; break;
    case 0x62:
      if (a[1] == 0) fail = true; else a[0] = muldiv_no_round(a[0], 64, a[1]);
      break;
    case 0x63: a[0] = muldiv(a[0], a[1], 64); break;
    case 0x64: a[0] = a[0] < 0 ? -a[0] : a[0]; break;
    case 0x65: a[0] = -a[0]; break;
    case 0x66: a[0] = pix_floor(a[0]); break;
    case 0x67: a[0] = pix_ceil(a[0]); break;
    case 0x68: case 0x69: case 0x6A: case 0x6B: a[0] = round(a[0]); break;
    case 0x6C: case 0x6D: case 0x6E: case 0x6F: a[0] = round_none(a[0]); break;
    case 0x70:
      if (a[0] >= 0 && a[0] < i64(cvt.size())) cvt[a[0]] = mulfix(a[1], scale);
      break;
    case 0x73: case 0x74: case 0x75: {  // DELTAC
      i64 n = a[0];
      i64 av = args;
      for (i64 k = 1; k <= n; ++k) {
        if (av < 2) { av = 0; break; }
        av -= 2;
        i64 e = stack[av + 1], b = stack[av];
        if (e < 0 || e >= i64(cvt.size())) continue;
        i64 c = (uint64_t(b) & 0xF0) >> 4;
        if (op == 0x74) c += 16;
        if (op == 0x75) c += 32;
        c += gs.delta_base;
        if (ppem != c) continue;
        b = i64(uint64_t(b) & 0xF) - 8;
        if (b >= 0) b++;
        b *= i64(1) << (6 - gs.delta_shift);
        cvt[e] += b;
      }
      new_top = av;
      break;
    }
    case 0x76: super_round(0x4000, a[0]); gs.round_state = 6; break;
    case 0x77: super_round(0x2D41, a[0]); gs.round_state = 7; break;
    case 0x7A: gs.round_state = 5; break;
    case 0x7C: gs.round_state = 4; break;
    case 0x7D: gs.round_state = 3; break;
    case 0x7E: case 0x7F: break;
    case 0x80: {  // FLIPPT
      if (post_iup()) { gs.loop = 1; new_top = top; break; }
      if (top < gs.loop) { gs.loop = 1; new_top = top; break; }
      i64 av = top;
      while (gs.loop > 0) {
        av--;
        i64 p = stack[av];
        if (!bad(p, pts.n_points())) pts.tags[p] ^= 1;
        gs.loop--;
      }
      gs.loop = 1;
      new_top = av;
      break;
    }
    case 0x81: case 0x82: {  // FLIPRGON, FLIPRGOFF
      if (post_iup()) break;
      i64 k = a[1], l = a[0];
      if (bad(k, pts.n_points()) || bad(l, pts.n_points())) break;
      for (i64 i = l; i <= k; ++i) {
        if (op == 0x81) pts.tags[i] |= 1; else pts.tags[i] &= ~1;
      }
      break;
    }
    case 0x85: case 0x8D: break;  // SCANCTRL, SCANTYPE: drop-out
                                   // control, not used by the smooth
                                   // renderer
    case 0x86: case 0x87: {  // SDPVTL
      i64 p1 = a[1], p2 = a[0];
      if (bad(p2, z1.n_points()) || bad(p1, z2.n_points())) break;
      int o = op;
      i64 A = z1.org[p2].x - z2.org[p1].x, B = z1.org[p2].y - z2.org[p1].y;
      if (A == 0 && B == 0) { A = 0x4000; o = 0; }
      if (o & 1) { i64 C = B; B = A; A = -C; }
      normalize(A, B, &gs.dual_x, &gs.dual_y);
      o = op;
      A = z1.cur[p2].x - z2.cur[p1].x;
      B = z1.cur[p2].y - z2.cur[p1].y;
      if (A == 0 && B == 0) { A = 0x4000; o = 0; }
      if (o & 1) { i64 C = B; B = A; A = -C; }
      normalize(A, B, &gs.proj_x, &gs.proj_y);
      compute_funcs();
      break;
    }
    case 0x88: {  // GETINFO
      i64 k = 0, s = a[0];
      if (s & 1) k = 40;
      if (s & 64) k |= 1 << 13;
      if (s & 1024) k |= 1 << 17;
      if (s & 2048) k |= 1 << 18;
      if (s & 4096) k |= 1 << 19;
      a[0] = k;
      break;
    }
    case 0x8A: { i64 t = a[2]; a[2] = a[0]; a[0] = a[1]; a[1] = t; break; }
    case 0x8B: a[0] = std::max(a[0], a[1]); break;
    case 0x8C: a[0] = std::min(a[0], a[1]); break;
    case 0x92: a[0] = 17; break;  // GETDATA
    case 0x8E: {  // INSTCTRL
      i64 k = a[1], l = a[0];
      if (k < 1 || k > 3) { fail = true; break; }
      k = i64(1) << (k - 1);
      if (l != 0) l = k;
      if (ini_range == 2) {
        gs.instruct_control &= ~int(k);
        gs.instruct_control |= int(l);
      } else if (ini_range == 3 && k == 4) {
        backward = l != 4;
      }
      break;
    }
    default:
      if (op >= 0xB0 && op <= 0xBF) {  // PUSHB, PUSHW
        int n = (op & 7) + 1;
        for (int i = 0; i < n; ++i)
          a[i] = op < 0xB8 ? i64(pr.code[ip + 1 + i])
                           : i64(int16_t((pr.code[ip + 1 + 2 * i] << 8) |
                                         pr.code[ip + 2 + 2 * i]));
      } else if (op >= 0xC0 && op <= 0xDF) {
        mdrp(a);
      } else if (op >= 0xE0) {
        mirp(a);
      } else {
        auto it = idefs.find(op);
        if (it == idefs.end() || calls.size() >= 32) { fail = true; break; }
        calls.push_back({cur_range, ip + 1, 1, it->second});
        cur_range = it->second.range;
        ip = it->second.start;
        step = false;
      }
  }
  if (fail) return false;
  top = new_top;
  if (step) ip += len;
  return true;
}

// IUP on one axis (x when `x_axis`): FreeType's _iup_worker_*
void iup_axis(Zone& z, bool x_axis, uint8_t mask) {
  auto X = [x_axis](Vec& v) -> i64& { return x_axis ? v.x : v.y; };
  int n = z.n_points();
  auto shift = [&](int p1, int p2, int p) {
    i64 d = X(z.cur[p]) - X(z.org[p]);
    if (!d) return;
    for (int i = p1; i < p; ++i) X(z.cur[i]) += d;
    for (int i = p + 1; i <= p2; ++i) X(z.cur[i]) += d;
  };
  auto interp = [&](int p1, int p2, int r1, int r2) {
    if (p1 > p2 || r1 < 0 || r2 < 0 || r1 >= n || r2 >= n) return;
    i64 o1 = X(z.orus[r1]), o2 = X(z.orus[r2]);
    if (o1 > o2) { std::swap(o1, o2); std::swap(r1, r2); }
    i64 g1 = X(z.org[r1]), g2 = X(z.org[r2]);
    i64 c1 = X(z.cur[r1]), c2 = X(z.cur[r2]);
    i64 d1 = c1 - g1, d2 = c2 - g2;
    if (c1 == c2 || o1 == o2) {
      for (int i = p1; i <= p2; ++i) {
        i64 x = X(z.org[i]);
        if (x <= g1) x += d1;
        else if (x >= g2) x += d2;
        else x = c1;
        X(z.cur[i]) = x;
      }
    } else {
      i64 sc = 0;
      bool valid = false;
      for (int i = p1; i <= p2; ++i) {
        i64 x = X(z.org[i]);
        if (x <= g1) x += d1;
        else if (x >= g2) x += d2;
        else {
          if (!valid) { valid = true; sc = divfix(c2 - c1, o2 - o1); }
          x = c1 + mulfix(X(z.orus[i]) - o1, sc);
        }
        X(z.cur[i]) = x;
      }
    }
  };
  int point = 0;
  for (size_t c = 0; c < z.ends.size(); ++c) {
    int end = z.ends[c];
    int first = point;
    if (end < 0 || end >= n) end = n - 1;
    while (point <= end && !(z.tags[point] & mask)) point++;
    if (point <= end) {
      int first_t = point, cur_t = point;
      point++;
      while (point <= end) {
        if (z.tags[point] & mask) {
          interp(cur_t + 1, point - 1, cur_t, point);
          cur_t = point;
        }
        point++;
      }
      if (cur_t == first_t) {
        shift(first, end, cur_t);
      } else {
        interp(cur_t + 1, end, cur_t, first_t);
        if (first_t > 0) interp(first, first_t - 1, cur_t, first_t);
      }
    }
  }
}

void Hinter::iup(bool x_axis) {
  iup_axis(pts, x_axis, x_axis ? kTouchX : kTouchY);
}

bool Hinter::displacement(i64* dx, i64* dy, Zone** zone, int* refp) {
  Zone* z = (opcode & 1) ? zp[0] : zp[1];
  int p = (opcode & 1) ? gs.rp1 : gs.rp2;
  if (bad(p, z->n_points())) { *refp = 0; return false; }
  *zone = z;
  *refp = p;
  i64 d = project(z->cur[p].x - z->org[p].x, z->cur[p].y - z->org[p].y);
  *dx = muldiv(d, gs.free_x, f_dot_p);
  *dy = muldiv(d, gs.free_y, f_dot_p);
  return true;
}

void Hinter::mdrp(i64* a) {
  Zone& z0 = *zp[0];
  Zone& z1 = *zp[1];
  i64 p = a[0];
  if (bad(p, z1.n_points()) || bad(gs.rp0, z0.n_points())) {
    gs.rp1 = gs.rp0;
    gs.rp2 = int(uint16_t(p));
    if (opcode & 16) gs.rp0 = int(uint16_t(p));
    return;
  }
  i64 org_dist;
  if (gs.gep0 == 0 || gs.gep1 == 0) {
    org_dist = dualproj(z1.org[p].x - z0.org[gs.rp0].x,
                        z1.org[p].y - z0.org[gs.rp0].y);
  } else {
    org_dist = dualproj(z1.orus[p].x - z0.orus[gs.rp0].x,
                        z1.orus[p].y - z0.orus[gs.rp0].y);
    org_dist = mulfix(org_dist, metrics_scale);
  }
  if (gs.sw_cutin > 0 && org_dist < gs.sw_value + gs.sw_cutin &&
      org_dist > gs.sw_value - gs.sw_cutin)
    org_dist = org_dist >= 0 ? gs.sw_value : -gs.sw_value;
  i64 distance = (opcode & 4) ? round(org_dist) : round_none(org_dist);
  if (opcode & 8) {
    if (org_dist >= 0) {
      if (distance < gs.min_dist) distance = gs.min_dist;
    } else if (distance > -gs.min_dist) {
      distance = -gs.min_dist;
    }
  }
  i64 cur = project(z1.cur[p].x - z0.cur[gs.rp0].x,
                    z1.cur[p].y - z0.cur[gs.rp0].y);
  move(z1, int(p), distance - cur);
  gs.rp1 = gs.rp0;
  gs.rp2 = int(p);
  if (opcode & 16) gs.rp0 = int(p);
}

void Hinter::mirp(i64* a) {
  Zone& z0 = *zp[0];
  Zone& z1 = *zp[1];
  i64 p = a[0];
  i64 e = a[1] + 1;
  if (bad(p, z1.n_points()) || e < 0 || e >= i64(cvt.size()) + 1 ||
      bad(gs.rp0, z0.n_points())) {
    gs.rp1 = gs.rp0;
    if (opcode & 16) gs.rp0 = int(uint16_t(p));
    gs.rp2 = int(uint16_t(p));
    return;
  }
  i64 cvt_dist = e ? read_cvt(e - 1) : 0;
  i64 delta = cvt_dist - gs.sw_value;
  if (delta < 0) delta = -delta;
  if (delta < gs.sw_cutin) cvt_dist = cvt_dist >= 0 ? gs.sw_value : -gs.sw_value;
  if (gs.gep1 == 0) {
    z1.org[p].x = z0.org[gs.rp0].x + mulfix14(cvt_dist, gs.free_x);
    z1.org[p].y = z0.org[gs.rp0].y + mulfix14(cvt_dist, gs.free_y);
    z1.cur[p] = z1.org[p];
  }
  i64 org_dist = dualproj(z1.org[p].x - z0.org[gs.rp0].x,
                          z1.org[p].y - z0.org[gs.rp0].y);
  i64 cur_dist = project(z1.cur[p].x - z0.cur[gs.rp0].x,
                         z1.cur[p].y - z0.cur[gs.rp0].y);
  if (gs.auto_flip && (org_dist ^ cvt_dist) < 0) cvt_dist = -cvt_dist;
  i64 distance;
  if (opcode & 4) {
    if (gs.gep0 == gs.gep1) {
      i64 d = cvt_dist - org_dist;
      if (d < 0) d = -d;
      if (d > gs.cvt_cutin) cvt_dist = org_dist;
    }
    distance = round(cvt_dist);
  } else {
    distance = round_none(cvt_dist);
  }
  if (opcode & 8) {
    if (org_dist >= 0) {
      if (distance < gs.min_dist) distance = gs.min_dist;
    } else if (distance > -gs.min_dist) {
      distance = -gs.min_dist;
    }
  }
  move(z1, int(p), distance - cur_dist);
  gs.rp1 = gs.rp0;
  if (opcode & 16) gs.rp0 = int(p);
  gs.rp2 = int(p);
}

// ------------------------------------------------ hinted glyph loading
bool Hinter::setup(int ppem_) {
  const Reader& r = f.r;
  ppem = ppem_;
  scale = make_size(f, ppem).x_scale;
  if (r.u32(f.maxp) < 0x00010000) return false;  // no TrueType programs
  int max_twilight = r.u16(f.maxp + 16), max_storage = r.u16(f.maxp + 18),
      max_fdefs = r.u16(f.maxp + 20), max_stack = r.u16(f.maxp + 24);
  stack.assign(size_t(max_stack) + 32, 0);
  fdefs.assign(size_t(max_fdefs), FuncDef());
  cvt.assign(f.cvt_len / 2, 0);
  for (size_t i = 0; i < f.cvt_len / 2; ++i)
    cvt[i] = mulfix(r.s16(f.cvt + 2 * i), scale);
  ranges[1] = {r.d + f.fpgm, f.fpgm ? i64(f.fpgm_len) : 0};
  ranges[2] = {r.d + f.prep, f.prep ? i64(f.prep_len) : 0};
  twilight = Zone();
  twilight.orus.assign(max_twilight, Vec{0, 0});
  twilight.org = twilight.cur = twilight.orus;
  twilight.tags.assign(max_twilight, 0);
  pts = Zone();
  gs = GState();
  period = 64; phase = 0; threshold = 0;
  // fpgm at ppem 0, scale 0
  int keep_ppem = ppem;
  i64 keep_scale = scale;
  ppem = 0;
  scale = 0;
  metrics_scale = 0;
  if (ranges[1].size && !run(1)) return false;
  ppem = keep_ppem;
  scale = keep_scale;
  metrics_scale = scale;
  storage.assign(size_t(max_storage), 0);
  gs = GState();
  if (ranges[2].size) run(2);
  gs.dual_x = gs.proj_x = gs.free_x = 0x4000;
  gs.dual_y = gs.proj_y = gs.free_y = 0;
  gs.rp0 = gs.rp1 = gs.rp2 = 0;
  gs.gep0 = gs.gep1 = gs.gep2 = 1;
  gs.loop = 1;
  size_gs = gs;
  return true;
}

// TT_Hint_Glyph: the glyph's (or composite's) program over `z` (points
// + 4 phantom points)
void Hinter::hint(Zone& z, const uint8_t* ins, int n_ins, bool is_comp) {
  if (n_ins > 0) z.org = z.cur;
  gs = size_gs;
  if (is_comp) {
    metrics_scale = 0x10000;
    z.orus = z.cur;
  } else {
    metrics_scale = scale;
  }
  int n = z.n_points();
  z.cur[n - 4].x = pix_round(z.cur[n - 4].x);
  z.cur[n - 3].x = pix_round(z.cur[n - 3].x);
  z.cur[n - 2].y = pix_round(z.cur[n - 2].y);
  z.cur[n - 1].y = pix_round(z.cur[n - 1].y);
  if (n_ins <= 0) return;
  ranges[3] = {ins, n_ins};
  composite = is_comp;
  backward = !(size_gs.instruct_control & 4);
  std::swap(pts, z);
  gs.proj_x = gs.free_x = gs.dual_x = 0x4000;
  gs.proj_y = gs.free_y = gs.dual_y = 0;
  gs.round_state = 1;
  gs.loop = 1;
  run(3);
  std::swap(pts, z);
}

int lsb_units(const Font& f, int gid) {
  if (gid < f.num_hmetrics) return f.r.s16(f.hmtx + size_t(gid) * 4 + 2);
  return f.r.s16(f.hmtx + size_t(f.num_hmetrics) * 4 +
                 size_t(gid - f.num_hmetrics) * 2);
}

// phantom points of glyph `gid` with header bbox at `off` (font units)
void phantoms(const Font& f, int gid, size_t off, Vec pp[4]) {
  const Reader& r = f.r;
  int x_min = r.s16(off + 2), y_max = r.s16(off + 8);
  int asc, desc;
  if (f.os2 && r.u16(f.os2) != 0xFFFF) {
    asc = r.s16(f.os2 + 68);
    desc = r.s16(f.os2 + 70);
  } else {
    asc = r.s16(f.hhea + 4);
    desc = r.s16(f.hhea + 6);
  }
  int tsb = asc - y_max, vadv = std::abs(asc - desc);
  pp[0] = {x_min - lsb_units(f, gid), 0};
  pp[1] = {pp[0].x + advance_units(f, gid), 0};
  pp[2] = {0, y_max + tsb};
  pp[3] = {0, pp[2].y - vadv};
}

// Load glyph `gid` at the hinter's size as FreeType's load_truetype_glyph
// loads it — hinted where the hinter is ready, else only scaled: points
// FT_MulFix-scaled, components transformed then offset. Points and
// contours are appended to `out`, the phantom points put in `pp`.
bool load_glyph(Hinter& H, int gid, const Size& s, Outline& out, Vec pp[4],
                int depth) {
  const Font& f = H.f;
  if (depth > 8) return false;
  size_t off, len;
  if (!glyph_range(f, gid, &off, &len)) return false;
  const Reader& r = f.r;
  if (len == 0) {  // empty glyph: no points to hint
    pp[0] = pp[2] = pp[3] = {0, 0};
    pp[1] = {mulfix(advance_units(f, gid), s.x_scale), 0};
    return true;
  }
  int ncont = r.s16(off);
  Vec fpp[4];
  phantoms(f, gid, off, fpp);
  if (ncont >= 0) {
    size_t p = off + 10;
    std::vector<int> ends(ncont);
    for (int i = 0; i < ncont; ++i) ends[i] = r.u16(p + 2 * i);
    p += 2 * size_t(ncont);
    int npts = ncont ? ends[ncont - 1] + 1 : 0;
    for (int i = 1; i < ncont; ++i)
      if (ends[i] < ends[i - 1]) return false;
    int n_ins = r.u16(p);
    size_t ins = p + 2;
    p += 2 + n_ins;
    if (!r.ok(ins, n_ins)) return false;
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
    Zone z;
    z.orus.resize(npts + 4);
    i64 v = 0;
    for (int i = 0; i < npts; ++i) {
      uint8_t fl = flags[i];
      if (fl & 2) { int d = r.u8(p++); v += (fl & 16) ? d : -d; }
      else if (!(fl & 16)) { v += r.s16(p); p += 2; }
      z.orus[i].x = v;
    }
    v = 0;
    for (int i = 0; i < npts; ++i) {
      uint8_t fl = flags[i];
      if (fl & 4) { int d = r.u8(p++); v += (fl & 32) ? d : -d; }
      else if (!(fl & 32)) { v += r.s16(p); p += 2; }
      z.orus[i].y = v;
    }
    for (int k = 0; k < 4; ++k) z.orus[npts + k] = fpp[k];
    z.cur.resize(npts + 4);
    for (int i = 0; i < npts + 4; ++i)
      z.cur[i] = {mulfix(z.orus[i].x, s.x_scale),
                  mulfix(z.orus[i].y, s.y_scale)};
    z.tags.resize(npts + 4, 0);
    for (int i = 0; i < npts; ++i) z.tags[i] = flags[i] & 1;
    z.ends = ends;
    for (int k = 0; k < 4; ++k) pp[k] = z.cur[npts + k];
    if (H.ok) {
      H.hint(z, r.d + ins, n_ins, false);
      if (!H.backward)
        for (int k = 0; k < 4; ++k) pp[k] = z.cur[npts + k];
    }
    int base = int(out.pts.size());
    for (int i = 0; i < npts; ++i)
      out.pts.push_back({z.cur[i].x, z.cur[i].y, (z.tags[i] & 1) != 0});
    for (int e : ends) out.ends.push_back(base + e);
    return true;
  }
  // composite
  pp[0] = {mulfix(fpp[0].x, s.x_scale), 0};
  pp[1] = {mulfix(fpp[1].x, s.x_scale), 0};
  pp[2] = {0, mulfix(fpp[2].y, s.y_scale)};
  pp[3] = {0, mulfix(fpp[3].y, s.y_scale)};
  size_t first_pt = out.pts.size(), first_ct = out.ends.size();
  size_t p = off + 10;
  int last_flags = 0;
  for (;;) {
    int fl = r.u16(p), sub = r.u16(p + 2);
    last_flags = fl;
    p += 4;
    i64 a1, a2;
    if (fl & 1) { a1 = r.s16(p); a2 = r.s16(p + 2); p += 4; }
    else if (fl & 2) { a1 = int8_t(r.u8(p)); a2 = int8_t(r.u8(p + 1)); p += 2; }
    else { a1 = r.u8(p); a2 = r.u8(p + 1); p += 2; }
    i64 xx = 0x10000, xy = 0, yx = 0, yy = 0x10000;
    bool transform = false;
    if (fl & 8) { xx = yy = i64(r.s16(p)) * 4; p += 2; transform = true; }
    else if (fl & 0x40) {
      xx = i64(r.s16(p)) * 4; yy = i64(r.s16(p + 2)) * 4; p += 4;
      transform = true;
    } else if (fl & 0x80) {
      xx = i64(r.s16(p)) * 4; yx = i64(r.s16(p + 2)) * 4;
      xy = i64(r.s16(p + 4)) * 4; yy = i64(r.s16(p + 6)) * 4; p += 8;
      transform = true;
    }
    Vec saved[4] = {pp[0], pp[1], pp[2], pp[3]};
    size_t first = out.pts.size();
    if (!load_glyph(H, sub, s, out, pp, depth + 1)) return false;
    if (!(fl & 0x200))
      for (int k = 0; k < 4; ++k) pp[k] = saved[k];
    size_t last = out.pts.size();
    if (transform)
      for (size_t i = first; i < last; ++i) {
        i64 x = out.pts[i].x, y = out.pts[i].y;
        out.pts[i].x = mulfix(x, xx) + mulfix(y, xy);
        out.pts[i].y = mulfix(x, yx) + mulfix(y, yy);
      }
    i64 dx = 0, dy = 0;
    if (fl & 2) {
      dx = mulfix(a1, s.x_scale);
      dy = mulfix(a2, s.y_scale);
      if ((fl & 4) && H.ok) dy = pix_round(dy);  // ROUND_XY_TO_GRID: y
                                                  // only, under v40
    } else {
      size_t pa = first_pt + size_t(a1), pb = first + size_t(a2);
      if (pa < first && pb < last) {
        dx = out.pts[pa].x - out.pts[pb].x;
        dy = out.pts[pa].y - out.pts[pb].y;
      }
    }
    if (dx || dy)
      for (size_t i = first; i < last; ++i) {
        out.pts[i].x += dx;
        out.pts[i].y += dy;
      }
    if (!(fl & 0x20)) break;
    if (!r.ok(p, 4)) return false;
  }
  size_t npts = out.pts.size() - first_pt;
  if (H.ok && (last_flags & 0x100) && npts > 0) {
    int n_ins = r.u16(p);
    if (!r.ok(p + 2, n_ins)) return false;
    Zone z;
    z.cur.resize(npts + 4);
    z.tags.resize(npts + 4, 0);
    for (size_t i = 0; i < npts; ++i) {
      const Point& q = out.pts[first_pt + i];
      z.cur[i] = {q.x, q.y};
      z.tags[i] = q.on ? 1 : 0;
    }
    for (int k = 0; k < 4; ++k) z.cur[npts + k] = pp[k];
    for (size_t c = first_ct; c < out.ends.size(); ++c)
      z.ends.push_back(out.ends[c] - int(first_pt));
    H.hint(z, r.d + p + 2, n_ins, true);
    for (size_t i = 0; i < npts; ++i) {
      out.pts[first_pt + i].x = z.cur[i].x;
      out.pts[first_pt + i].y = z.cur[i].y;
      out.pts[first_pt + i].on = z.tags[i] & 1;
    }
    if (!H.backward)
      for (int k = 0; k < 4; ++k) pp[k] = z.cur[npts + k];
  }
  return true;
}

// The glyph's outline at `ppem` as PIL loads it (FT_LOAD_DEFAULT: hinted,
// unless the font's programs fail or its prep turns hinting off), cached
// per size.
bool glyph_outline(const Font& f, int gid, int ppem, Outline& o) {
  std::lock_guard<std::mutex> lock(f.mu);
  auto key = std::make_pair(ppem, gid);
  auto it = f.outlines.find(key);
  if (it != f.outlines.end()) {
    o = it->second;
    return true;
  }
  Size s = make_size(f, ppem);
  std::shared_ptr<Hinter>& h = f.hinters[ppem];
  if (!h) {
    h = std::make_shared<Hinter>(f);
    // hinting as FreeType does it, unless prep turned it off (INSTCTRL)
    h->ok = h->setup(ppem) && !(h->size_gs.instruct_control & 1);
  }
  Outline res;
  Vec pp[4];
  if (!load_glyph(*h, gid, s, res, pp, 0)) return false;
  f.outlines[key] = res;
  o = std::move(res);
  return true;
}

// --------------------------------------------------------------- layout
struct Glyph {
  int gid;
  int cluster;
  i64 x_adv, x_off, y_off;  // 26.6
  bool hidden;              // a default-ignorable character
};

// HarfBuzz's default-ignorable code points (hb-unicode.hh)
bool default_ignorable(uint32_t c) {
  if (c >> 16 == 0) {
    switch (c >> 8) {
      case 0x00: return c == 0xAD;
      case 0x03: return c == 0x34F;
      case 0x06: return c == 0x61C;
      case 0x17: return c == 0x17B4 || c == 0x17B5;
      case 0x18: return c >= 0x180B && c <= 0x180E;
      case 0x20:
        return (c >= 0x200B && c <= 0x200F) || (c >= 0x202A && c <= 0x202E) ||
               (c >= 0x2060 && c <= 0x206F);
      case 0xFE: return (c >= 0xFE00 && c <= 0xFE0F) || c == 0xFEFF;
      case 0xFF: return c >= 0xFFF0 && c <= 0xFFF8;
      default: return false;
    }
  }
  return (c >= 0x1D173 && c <= 0x1D17A) || (c >= 0xE0000 && c <= 0xE0FFF);
}

// Coverage table index of glyph g, -1 when not covered.
int coverage(const Reader& r, size_t cov, int g) {
  int fmt = r.u16(cov);
  if (fmt == 1) {
    int n = r.u16(cov + 2), lo = 0, hi = n;
    while (lo < hi) {
      int mid = (lo + hi) / 2, v = r.u16(cov + 4 + 2 * mid);
      if (g < v) hi = mid;
      else if (g > v) lo = mid + 1;
      else return mid;
    }
  } else if (fmt == 2) {
    int n = r.u16(cov + 2), lo = 0, hi = n;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      size_t rec = cov + 4 + 6 * size_t(mid);
      int a = r.u16(rec), b = r.u16(rec + 2);
      if (g < a) hi = mid;
      else if (g > b) lo = mid + 1;
      else return int(r.u16(rec + 4)) + (g - a);
    }
  }
  return -1;
}

int class_of(const Reader& r, size_t cd, int g) {
  if (!cd) return 0;
  int fmt = r.u16(cd);
  if (fmt == 1) {
    int start = r.u16(cd + 2), n = r.u16(cd + 4);
    if (g >= start && g < start + n) return r.u16(cd + 6 + 2 * (g - start));
  } else if (fmt == 2) {
    int n = r.u16(cd + 2), lo = 0, hi = n;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      size_t rec = cd + 4 + 6 * size_t(mid);
      int a = r.u16(rec), b = r.u16(rec + 2);
      if (g < a) hi = mid;
      else if (g > b) lo = mid + 1;
      else return r.u16(rec + 4);
    }
  }
  return 0;
}

struct Layout {
  const Font& f;
  size_t gdef_classes = 0, gdef_marks = 0;
  Layout(const Font& font) : f(font) {
    if (f.gdef) {
      const Reader& r = f.r;
      int o = r.u16(f.gdef + 4);
      if (o) gdef_classes = f.gdef + o;
      int m = r.u16(f.gdef + 10);
      if (m) gdef_marks = f.gdef + m;
    }
  }
  int gclass(int g) const { return class_of(f.r, gdef_classes, g); }
  // LookupFlag: 2 ignore base, 4 ignore ligatures, 8 ignore marks,
  // 0xFF00 mark attachment class filter
  bool skip(int g, int flag) const {
    if (!flag || !gdef_classes) return false;
    int c = gclass(g);
    if ((flag & 2) && c == 1) return true;
    if ((flag & 4) && c == 2) return true;
    if (c == 3) {
      if (flag & 8) return true;
      int mac = flag >> 8;
      if (mac && class_of(f.r, gdef_marks, g) != mac) return true;
    }
    return false;
  }
};

// The lookups (index order) of the features `tags` in the table's LangSys
// for `script` (falling back to DFLT, dflt, latn as HarfBuzz does).
std::vector<int> feature_lookups(const Reader& r, size_t table,
                                 uint32_t script,
                                 const std::vector<uint32_t>& tags) {
  std::vector<int> out;
  if (!table) return out;
  size_t scripts = table + r.u16(table + 4);
  size_t features = table + r.u16(table + 6);
  int nscripts = r.u16(scripts);
  size_t chosen = 0;
  const uint32_t order[4] = {script, 0x44464C54 /*DFLT*/, 0x64666C74 /*dflt*/,
                             0x6C61746E /*latn*/};
  for (uint32_t want : order) {
    for (int i = 0; i < nscripts && !chosen; ++i) {
      size_t rec = scripts + 2 + 6 * size_t(i);
      if (r.u32(rec) == want) chosen = scripts + r.u16(rec + 4);
    }
    if (chosen) break;
  }
  if (!chosen) return out;
  int dl = r.u16(chosen);
  if (!dl) return out;
  size_t langsys = chosen + dl;
  std::vector<int> idx;
  int req = r.u16(langsys + 2);
  if (req != 0xFFFF) idx.push_back(req);
  int nf = r.u16(langsys + 4);
  for (int i = 0; i < nf; ++i) idx.push_back(r.u16(langsys + 6 + 2 * i));
  int nfeat = r.u16(features);
  for (int fi : idx) {
    if (fi >= nfeat) continue;
    size_t rec = features + 2 + 6 * size_t(fi);
    uint32_t tag = r.u32(rec);
    if (std::find(tags.begin(), tags.end(), tag) == tags.end() &&
        fi != req)
      continue;
    size_t feat = features + r.u16(rec + 4);
    int nl = r.u16(feat + 2);
    for (int k = 0; k < nl; ++k) out.push_back(r.u16(feat + 4 + 2 * k));
  }
  std::sort(out.begin(), out.end());
  out.erase(std::unique(out.begin(), out.end()), out.end());
  return out;
}

struct Shaper {
  const Font& f;
  const Layout& L;
  const Reader& r;
  std::vector<Glyph>& buf;
  Shaper(const Font& font, const Layout& lay, std::vector<Glyph>& b)
      : f(font), L(lay), r(font.r), buf(b) {}

  size_t lookup_at(size_t table, int li, int* type, int* flag, int* nsub) {
    size_t list = table + r.u16(table + 8);
    if (li >= int(r.u16(list))) return 0;
    size_t lk = list + r.u16(list + 2 + 2 * li);
    *type = r.u16(lk);
    *flag = r.u16(lk + 2);
    *nsub = r.u16(lk + 4);
    return lk;
  }

  // subtable offset k of lookup lk, through extension subtables (GSUB 7,
  // GPOS 9)
  size_t subtable(size_t lk, int k, int ext_type, int* type) {
    size_t st = lk + r.u16(lk + 6 + 2 * k);
    if (*type == ext_type) {
      *type = r.u16(st + 2);
      st = st + r.u32(st + 4);
    }
    return st;
  }

  // next index after i not skipped by `flag`, or -1
  int next(int i, int flag, int end) const {
    for (int j = i + 1; j < end; ++j)
      if (!buf[j].hidden && !L.skip(buf[j].gid, flag)) return j;
    return -1;
  }
  int prev(int i, int flag) const {
    for (int j = i - 1; j >= 0; --j)
      if (!buf[j].hidden && !L.skip(buf[j].gid, flag)) return j;
    return -1;
  }

  // --- GSUB
  bool gsub_single(size_t st, int i) {
    int fmt = r.u16(st);
    int c = coverage(r, st + r.u16(st + 2), buf[i].gid);
    if (c < 0) return false;
    if (fmt == 1) buf[i].gid = (buf[i].gid + r.s16(st + 4)) & 0xFFFF;
    else if (fmt == 2 && c < int(r.u16(st + 4)))
      buf[i].gid = r.u16(st + 6 + 2 * c);
    else return false;
    return true;
  }

  bool gsub_ligature(size_t st, int i, int flag) {
    int c = coverage(r, st + r.u16(st + 2), buf[i].gid);
    if (c < 0 || c >= int(r.u16(st + 4))) return false;
    size_t set = st + r.u16(st + 6 + 2 * c);
    int nlig = r.u16(set);
    for (int k = 0; k < nlig; ++k) {
      size_t lig = set + r.u16(set + 2 + 2 * k);
      int ncomp = r.u16(lig + 2);
      std::vector<int> at{i};
      int j = i;
      bool match = true;
      for (int m = 1; m < ncomp && match; ++m) {
        j = next(j, flag, int(buf.size()));
        if (j < 0 || buf[j].gid != int(r.u16(lig + 4 + 2 * (m - 1))))
          match = false;
        else at.push_back(j);
      }
      if (!match) continue;
      buf[i].gid = r.u16(lig);
      for (int m = int(at.size()) - 1; m >= 1; --m)
        buf.erase(buf.begin() + at[m]);
      return true;
    }
    return false;
  }

  // nested lookups of a matched context at the input positions `pos`
  // (shifted as nested ligatures shorten the buffer)
  void apply_nested(size_t table, std::vector<int>& pos, size_t records,
                    int nrec) {
    for (int k = 0; k < nrec; ++k) {
      int seq = r.u16(records + 4 * k), li = r.u16(records + 4 * k + 2);
      if (seq >= int(pos.size())) continue;
      int before = int(buf.size());
      if (pos[seq] < before) apply_gsub_lookup_at(table, li, pos[seq]);
      int delta = int(buf.size()) - before;
      if (delta)
        for (size_t m = seq + 1; m < pos.size(); ++m) pos[m] += delta;
    }
  }

  bool match_seq(int start, int flag, int n,
                 const std::function<bool(int, int)>& test,
                 std::vector<int>* pos) {
    int j = start;
    for (int k = 0; k < n; ++k) {
      j = next(j, flag, int(buf.size()));
      if (j < 0 || !test(k, buf[j].gid)) return false;
      if (pos) pos->push_back(j);
    }
    return true;
  }

  // chain context (formats 1-3) → index after the input, or -1
  int gsub_chain(size_t table, size_t st, int i, int flag) {
    int fmt = r.u16(st);
    if (fmt == 3) {
      size_t p = st + 2;
      int nb = r.u16(p);
      size_t back = p + 2;
      p = back + 2 * nb;
      int ni = r.u16(p);
      size_t in = p + 2;
      p = in + 2 * ni;
      int nl = r.u16(p);
      size_t ahead = p + 2;
      p = ahead + 2 * nl;
      int nrec = r.u16(p);
      size_t recs = p + 2;
      if (!ni || coverage(r, st + r.u16(in), buf[i].gid) < 0) return -1;
      std::vector<int> pos{i};
      if (!match_seq(i, flag, ni - 1, [&](int k, int g) {
            return coverage(r, st + r.u16(in + 2 * (k + 1)), g) >= 0;
          }, &pos))
        return -1;
      if (!match_seq(pos.back(), flag, nl, [&](int k, int g) {
            return coverage(r, st + r.u16(ahead + 2 * k), g) >= 0;
          }, nullptr))
        return -1;
      int b = i;
      for (int k = 0; k < nb; ++k) {
        b = prev(b, flag);
        if (b < 0 || coverage(r, st + r.u16(back + 2 * k), buf[b].gid) < 0)
          return -1;
      }
      int n0 = int(buf.size()), last = pos.back();
      apply_nested(table, pos, recs, nrec);
      return last + 1 + int(buf.size()) - n0;
    }
    if (fmt != 1 && fmt != 2) return -1;
    int c = coverage(r, st + r.u16(st + 2), buf[i].gid);
    if (c < 0) return -1;
    size_t bcd = 0, icd = 0, lcd = 0, sets = st + 6;
    int setidx = c, nsets = r.u16(st + 4);
    if (fmt == 2) {
      if (r.u16(st + 4)) bcd = st + r.u16(st + 4);
      icd = st + r.u16(st + 6);
      if (r.u16(st + 8)) lcd = st + r.u16(st + 8);
      nsets = r.u16(st + 10);
      sets = st + 12;
      setidx = class_of(r, icd, buf[i].gid);
    }
    if (setidx >= nsets || !r.u16(sets + 2 * setidx)) return -1;
    size_t set = st + r.u16(sets + 2 * setidx);
    auto val = [&](size_t cd, int g) {
      return fmt == 2 ? class_of(r, cd, g) : g;
    };
    int nrules = r.u16(set);
    for (int k = 0; k < nrules; ++k) {
      size_t p = set + r.u16(set + 2 + 2 * k);
      int nb = r.u16(p);
      size_t back = p + 2;
      p = back + 2 * nb;
      int ni = r.u16(p);
      size_t in = p + 2;
      p = in + 2 * (ni > 0 ? ni - 1 : 0);
      int nl = r.u16(p);
      size_t ahead = p + 2;
      p = ahead + 2 * nl;
      int nrec = r.u16(p);
      size_t recs = p + 2;
      std::vector<int> pos{i};
      if (!match_seq(i, flag, ni - 1, [&](int m, int g) {
            return val(icd, g) == int(r.u16(in + 2 * m));
          }, &pos))
        continue;
      if (!match_seq(pos.back(), flag, nl, [&](int m, int g) {
            return val(lcd, g) == int(r.u16(ahead + 2 * m));
          }, nullptr))
        continue;
      int b = i;
      bool ok = true;
      for (int m = 0; m < nb && ok; ++m) {
        b = prev(b, flag);
        ok = b >= 0 && val(bcd, buf[b].gid) == int(r.u16(back + 2 * m));
      }
      if (!ok) continue;
      int n0 = int(buf.size()), last = pos.back();
      apply_nested(table, pos, recs, nrec);
      return last + 1 + int(buf.size()) - n0;
    }
    return -1;
  }

  int nesting = 0;  // contexts within contexts (HarfBuzz stops at 64)

  // lookup `li` at i → the index to go on from, or -1 when it did not apply
  int apply_gsub_lookup_at(size_t table, int li, int i) {
    int type, flag, nsub;
    size_t lk = lookup_at(table, li, &type, &flag, &nsub);
    if (!lk || buf[i].hidden || L.skip(buf[i].gid, flag)) return -1;
    if (nesting >= 64) return -1;
    for (int k = 0; k < nsub; ++k) {
      int t = type;
      size_t st = subtable(lk, k, 7, &t);
      if (t == 1 && gsub_single(st, i)) return i + 1;
      if (t == 4 && gsub_ligature(st, i, flag)) return i + 1;
      if (t == 6) {
        nesting++;
        int nx = gsub_chain(table, st, i, flag);
        nesting--;
        if (nx >= 0) return std::max(nx, i + 1);
      }
    }
    return -1;
  }

  void gsub(size_t table, const std::vector<int>& lookups) {
    for (int li : lookups) {
      int i = 0;
      while (i < int(buf.size())) {
        int nx = apply_gsub_lookup_at(table, li, i);
        i = nx > i ? nx : i + 1;
      }
    }
  }

  // --- GPOS
  static int value_size(int vf) {
    int n = 0;
    for (int b = 0; b < 8; ++b) n += (vf >> b) & 1;
    return 2 * n;
  }
  void apply_value(const Size& s, size_t v, int vf, Glyph& g) {
    size_t p = v;
    if (vf & 1) { g.x_off += hb_em_scale(s, r.s16(p)); p += 2; }
    if (vf & 2) { g.y_off += hb_em_scale(s, r.s16(p)); p += 2; }
    if (vf & 4) { g.x_adv += hb_em_scale(s, r.s16(p)); p += 2; }
  }

  // → index to continue from, or -1 when the subtable does not apply
  int gpos_pair(const Size& s, size_t st, int i, int flag) {
    int fmt = r.u16(st);
    int c = coverage(r, st + r.u16(st + 2), buf[i].gid);
    if (c < 0) return -1;
    int vf1 = r.u16(st + 4), vf2 = r.u16(st + 6);
    int j = next(i, flag, int(buf.size()));
    if (j < 0) return -1;
    int sz1 = value_size(vf1), sz2 = value_size(vf2);
    if (fmt == 1) {
      if (c >= int(r.u16(st + 8))) return -1;
      size_t set = st + r.u16(st + 10 + 2 * c);
      int n = r.u16(set), rec = 2 + sz1 + sz2;
      int lo = 0, hi = n;
      while (lo < hi) {
        int mid = (lo + hi) / 2;
        size_t pr = set + 2 + size_t(mid) * rec;
        int g2 = r.u16(pr);
        if (buf[j].gid < g2) hi = mid;
        else if (buf[j].gid > g2) lo = mid + 1;
        else {
          apply_value(s, pr + 2, vf1, buf[i]);
          apply_value(s, pr + 2 + sz1, vf2, buf[j]);
          return vf2 ? j + 1 : j;
        }
      }
      return -1;
    }
    if (fmt == 2) {
      size_t cd1 = st + r.u16(st + 8), cd2 = st + r.u16(st + 10);
      int n1 = r.u16(st + 12), n2 = r.u16(st + 14);
      int k1 = class_of(r, cd1, buf[i].gid), k2 = class_of(r, cd2, buf[j].gid);
      if (k1 >= n1 || k2 >= n2) return -1;
      size_t pr = st + 16 + (size_t(k1) * n2 + k2) * (sz1 + sz2);
      apply_value(s, pr, vf1, buf[i]);
      apply_value(s, pr + sz1, vf2, buf[j]);
      return vf2 ? j + 1 : j;
    }
    return -1;
  }

  void gpos(const Size& s, size_t table, const std::vector<int>& lookups) {
    for (int li : lookups) {
      int type, flag, nsub;
      size_t lk = lookup_at(table, li, &type, &flag, &nsub);
      if (!lk) continue;
      int i = 0;
      while (i < int(buf.size())) {
        int nxt = -1;
        if (!buf[i].hidden && !L.skip(buf[i].gid, flag))
          for (int k = 0; k < nsub && nxt < 0; ++k) {
            int t = type;
            size_t st = subtable(lk, k, 9, &t);
            if (t == 2) nxt = gpos_pair(s, st, i, flag);
          }
        i = nxt > i ? nxt : i + 1;
      }
    }
  }
};

uint32_t tag(const char* t) {
  return (uint32_t(uint8_t(t[0])) << 24) | (uint32_t(uint8_t(t[1])) << 16) |
         (uint32_t(uint8_t(t[2])) << 8) | uint8_t(t[3]);
}

// ---------------------------------------------------------- rasteriser
// FreeType's ftgrays cell accumulation (PIXEL_BITS 8, 24.8 coordinates).
const int kPixelBits = 8;
const i64 kOnePixel = 1 << kPixelBits;

struct Raster {
  int min_ex, max_ex, min_ey, max_ey;  // cell box (pixels)
  int w, h;
  std::vector<i64> area, cover;       // per cell of the box (+1 left column)
  i64 x = 0, y = 0;                   // 24.8
  int ex = 0, ey = 0;
  i64 c_area = 0, c_cover = 0;
  bool invalid = true;

  void init(int x0, int y0, int x1, int y1) {
    min_ex = x0; max_ex = x1; min_ey = y0; max_ey = y1;
    w = x1 - x0 + 1;  // column 0 collects cells left of the box
    h = y1 - y0;
    area.assign(size_t(w) * h, 0);
    cover.assign(size_t(w) * h, 0);
  }
  void record() {
    if (invalid || (!c_area && !c_cover)) return;
    if (ey < min_ey || ey >= max_ey || ex >= max_ex) return;
    int cx = std::max(ex, min_ex - 1) - (min_ex - 1);
    size_t k = size_t(ey - min_ey) * w + cx;
    area[k] += c_area;
    cover[k] += c_cover;
  }
  void set_cell(int nx, int ny) {
    if (nx < min_ex) nx = min_ex - 1;  // cells left of the box collapse
    if (invalid || nx != ex || ny != ey) {
      record();
      ex = nx; ey = ny;
      c_area = c_cover = 0;
      invalid = false;
    }
  }
  static int trunc(i64 v) { return int(v >> kPixelBits); }
  static i64 fract(i64 v) { return v & (kOnePixel - 1); }

  void move_to(i64 tx, i64 ty) {
    record();
    invalid = true;
    x = tx; y = ty;
    set_cell(trunc(tx), trunc(ty));
  }

  static i64 udiv(i64 a, unsigned long long recip) {
    return i64((unsigned long long)(a) * recip >> (64 - kPixelBits));
  }

  void line_to(i64 to_x, i64 to_y) {
    int ex1 = trunc(x), ex2 = trunc(to_x), ey1 = trunc(y), ey2 = trunc(to_y);
    if ((ey1 >= max_ey && ey2 >= max_ey) || (ey1 < min_ey && ey2 < min_ey)) {
      x = to_x; y = to_y;
      return;
    }
    i64 fx1 = fract(x), fy1 = fract(y), fx2, fy2;
    i64 dx = to_x - x, dy = to_y - y;
    if (ex1 == ex2 && ey1 == ey2) {
    } else if (dy == 0) {
      set_cell(ex2, ey2);
      x = to_x; y = to_y;
      return;
    } else if (dx == 0) {
      if (dy > 0)
        do {
          fy2 = kOnePixel;
          c_cover += fy2 - fy1;
          c_area += (fy2 - fy1) * fx1 * 2;
          fy1 = 0;
          ey1++;
          set_cell(ex1, ey1);
        } while (ey1 != ey2);
      else
        do {
          fy2 = 0;
          c_cover += fy2 - fy1;
          c_area += (fy2 - fy1) * fx1 * 2;
          fy1 = kOnePixel;
          ey1--;
          set_cell(ex1, ey1);
        } while (ey1 != ey2);
    } else {
      i64 prod = dx * fy1 - dy * fx1;
      const unsigned long long kMax = ~0ULL >> kPixelBits;
      unsigned long long dx_r = ex1 != ex2 ? kMax / (unsigned long long)(
                                                 dx < 0 ? -dx : dx) : 0;
      unsigned long long dy_r = ey1 != ey2 ? kMax / (unsigned long long)(
                                                 dy < 0 ? -dy : dy) : 0;
      do {
        if (prod - dx * kOnePixel > 0 && prod <= 0) {  // left
          fx2 = 0;
          fy2 = udiv(-prod, dx_r);
          prod -= dy * kOnePixel;
          c_cover += fy2 - fy1;
          c_area += (fy2 - fy1) * (fx1 + fx2);
          fx1 = kOnePixel;
          fy1 = fy2;
          ex1--;
        } else if (prod - dx * kOnePixel + dy * kOnePixel > 0 &&
                   prod - dx * kOnePixel <= 0) {  // up
          prod -= dx * kOnePixel;
          fx2 = udiv(-prod, dy_r);
          fy2 = kOnePixel;
          c_cover += fy2 - fy1;
          c_area += (fy2 - fy1) * (fx1 + fx2);
          fx1 = fx2;
          fy1 = 0;
          ey1++;
        } else if (prod + dy * kOnePixel >= 0 &&
                   prod - dx * kOnePixel + dy * kOnePixel <= 0) {  // right
          prod += dy * kOnePixel;
          fx2 = kOnePixel;
          fy2 = udiv(prod, dx_r);
          c_cover += fy2 - fy1;
          c_area += (fy2 - fy1) * (fx1 + fx2);
          fx1 = 0;
          fy1 = fy2;
          ex1++;
        } else {  // down
          fx2 = udiv(prod, dy_r);
          prod += dx * kOnePixel;
          fy2 = 0;
          c_cover += fy2 - fy1;
          c_area += (fy2 - fy1) * (fx1 + fx2);
          fx1 = fx2;
          fy1 = kOnePixel;
          ey1--;
        }
        set_cell(ex1, ey1);
      } while (ex1 != ex2 || ey1 != ey2);
    }
    fx2 = fract(to_x);
    fy2 = fract(to_y);
    c_cover += fy2 - fy1;
    c_area += (fy2 - fy1) * (fx1 + fx2);
    x = to_x; y = to_y;
  }

  // gray_render_conic: the arc as 2^n lines, by forward differences
  void conic_to(i64 cx, i64 cy, i64 to_x, i64 to_y) {
    i64 p0x = x, p0y = y;
    if ((trunc(p0y) >= max_ey && trunc(cy) >= max_ey &&
         trunc(to_y) >= max_ey) ||
        (trunc(p0y) < min_ey && trunc(cy) < min_ey && trunc(to_y) < min_ey)) {
      x = to_x; y = to_y;
      return;
    }
    i64 bx = cx - p0x, by = cy - p0y;
    i64 ax = to_x - cx - bx, ay = to_y - cy - by;
    i64 dx = ax < 0 ? -ax : ax, dy = ay < 0 ? -ay : ay;
    if (dx < dy) dx = dy;
    if (dx <= kOnePixel / 4) {
      line_to(to_x, to_y);
      return;
    }
    int shift = 16;
    do {
      dx >>= 2;
      shift -= 1;
    } while (dx > kOnePixel / 4);
    auto lsh = [](i64 v, int n) {
      return i64((unsigned long long)(v) << n);
    };
    i64 rx = lsh(ax, shift + shift), ry = lsh(ay, shift + shift);
    i64 qx = lsh(bx, shift + 17) + rx, qy = lsh(by, shift + 17) + ry;
    rx *= 2;
    ry *= 2;
    i64 px = lsh(p0x, 32), py = lsh(p0y, 32);
    unsigned count = 1u << (16 - shift);
    do {
      px += qx;
      py += qy;
      qx += rx;
      qy += ry;
      line_to(px >> 32, py >> 32);
    } while (--count);
  }

  // coverage of each pixel of the box (non-zero winding) into `out`
  // (rows top-down: row 0 is y = max_ey - 1), composed over the bitmap.
  void sweep(uint8_t* out, int ow, int oh, int col0, int row0) {
    record();
    invalid = true;
    for (int cy = 0; cy < h; ++cy) {
      i64 cov = 0;
      int row = row0 + (max_ey - 1 - (min_ey + cy));
      bool row_in = row >= 0 && row < oh;
      for (int cx = 0; cx < w; ++cx) {
        size_t k = size_t(cy) * w + cx;
        cov += cover[k] * (kOnePixel * 2);
        i64 a = cov - area[k];
        if (cx == 0) continue;  // the collapsed left column
        if (!a || !row_in) continue;
        i64 c = a >> (kPixelBits * 2 + 1 - 8);
        if (c < 0) c = ~c;
        if (c >= 256) c = 255;
        int col = col0 + (min_ex + cx - 1);
        if (col < 0 || col >= ow) continue;
        // PIL composes a glyph over the mask as coverage over coverage
        uint8_t& o = out[size_t(row) * ow + col];
        o = uint8_t(c + o - (c * o + 127) / 255);
      }
    }
  }
};

// cbox of an outline (26.6)
void cbox(const Outline& o, i64* x0, i64* y0, i64* x1, i64* y1) {
  if (o.pts.empty()) { *x0 = *y0 = *x1 = *y1 = 0; return; }
  *x0 = *x1 = o.pts[0].x;
  *y0 = *y1 = o.pts[0].y;
  for (const Point& p : o.pts) {
    *x0 = std::min(*x0, p.x); *x1 = std::max(*x1, p.x);
    *y0 = std::min(*y0, p.y); *y1 = std::max(*y1, p.y);
  }
}

// FT_Outline_Decompose onto the raster (24.8 = 26.6 * 4)
void decompose(const Outline& o, Raster& ras) {
  int first = 0;
  auto up = [](i64 v) { return v * (kOnePixel >> 6); };
  for (int end : o.ends) {
    if (end < first) { first = end + 1; continue; }
    const Point* p = &o.pts[first];
    int n = end - first + 1;
    Point v_start = p[0], v_last = p[n - 1];
    int i0 = 0, last = n - 1;
    if (!v_start.on) {
      if (v_last.on) {
        v_start = v_last;
        last--;
      } else {
        v_start.x = (v_start.x + v_last.x) / 2;
        v_start.y = (v_start.y + v_last.y) / 2;
      }
      i0 = -1;  // first point is a control point: start from it below
    }
    ras.move_to(up(v_start.x), up(v_start.y));
    int i = i0 < 0 ? 0 : 1;
    if (i0 < 0) i = 0;
    while (i <= last) {
      const Point& pt = p[i];
      if (pt.on) {
        ras.line_to(up(pt.x), up(pt.y));
        ++i;
        continue;
      }
      Point ctrl = pt;
      ++i;
      for (;;) {
        if (i > last) {
          ras.conic_to(up(ctrl.x), up(ctrl.y), up(v_start.x), up(v_start.y));
          goto close;
        }
        const Point& q = p[i];
        if (q.on) {
          ras.conic_to(up(ctrl.x), up(ctrl.y), up(q.x), up(q.y));
          ++i;
          break;
        }
        i64 mx = (ctrl.x + q.x) / 2, my = (ctrl.y + q.y) / 2;
        ras.conic_to(up(ctrl.x), up(ctrl.y), up(mx), up(my));
        ctrl = q;
        ++i;
      }
    }
    ras.line_to(up(v_start.x), up(v_start.y));
  close:
    first = end + 1;
  }
}

}  // namespace

extern "C" {

void* ttf_open(const uint8_t* data, long long n) {
  if (!data || n <= 0) return nullptr;
  Font* f = new Font();
  f->bytes.assign(data, data + n);
  if (!load(*f)) {
    delete f;
    return nullptr;
  }
  return f;
}

void ttf_close(void* h) { delete static_cast<Font*>(h); }

// out: ascender, descender (26.6) at `ppem`
void ttf_size_metrics(void* h, int ppem, long long* out) {
  Size s = make_size(*static_cast<Font*>(h), ppem);
  out[0] = s.ascender;
  out[1] = s.descender;
}

// Shape one run of `n` code points of one script (an OpenType script tag,
// 0 for Common) at `ppem`: → the number of glyphs written (gid, cluster,
// x_advance, x_offset, y_offset in 26.6), or -(needed) when cap is short.
int ttf_shape(void* h, const unsigned* cps, int n, unsigned script, int ppem,
              int* gids, int* clusters, long long* xadv, long long* xoff,
              long long* yoff, int cap) {
  const Font& f = *static_cast<Font*>(h);
  Size s = make_size(f, ppem);
  std::vector<Glyph> buf;
  buf.reserve(n);
  for (int i = 0; i < n; ++i)
    buf.push_back({glyph_of(f, cps[i]), i, 0, 0, 0,
                   default_ignorable(cps[i])});
  Layout L(f);
  Shaper sh(f, L, buf);
  std::vector<uint32_t> gsub_tags = {tag("rvrn"), tag("ccmp"), tag("locl"),
                                     tag("rlig"), tag("calt"), tag("clig"),
                                     tag("liga"), tag("rclt"), tag("ltra"),
                                     tag("ltrm")};
  std::vector<uint32_t> gpos_tags = {tag("kern")};
  uint32_t sc = script ? script : tag("DFLT");
  if (f.gsub) sh.gsub(f.gsub, feature_lookups(f.r, f.gsub, sc, gsub_tags));
  for (Glyph& g : buf)
    g.x_adv = L.gclass(g.gid) == 3 ? 0 : mulfix(advance_units(f, g.gid),
                                                s.x_scale);
  if (f.gpos) sh.gpos(s, f.gpos, feature_lookups(f.r, f.gpos, sc, gpos_tags));
  // default ignorables: zero width, drawn as the (empty) space glyph
  int space = glyph_of(f, 0x20);
  for (Glyph& g : buf)
    if (g.hidden) {
      g.gid = space;
      g.x_adv = g.x_off = g.y_off = 0;
    }
  int m = int(buf.size());
  if (m > cap) return -m;
  for (int i = 0; i < m; ++i) {
    gids[i] = buf[i].gid; clusters[i] = buf[i].cluster;
    xadv[i] = buf[i].x_adv; xoff[i] = buf[i].x_off; yoff[i] = buf[i].y_off;
  }
  return m;
}

// The 26.6 control box of glyph `gid` at `ppem` (its hinted outline),
// translated by (dx, dy). → 0 for an empty glyph, 1 otherwise, -1 on error.
int ttf_glyph_cbox(void* h, int gid, int ppem, long long dx, long long dy,
                   long long* box) {
  const Font& f = *static_cast<Font*>(h);
  Outline o;
  if (!glyph_outline(f, gid, ppem, o)) return -1;
  if (o.pts.empty()) return 0;
  i64 x0, y0, x1, y1;
  cbox(o, &x0, &y0, &x1, &y1);
  box[0] = x0 + dx; box[1] = y0 + dy; box[2] = x1 + dx; box[3] = y1 + dy;
  return 1;
}

// Rasterise glyph `gid` at `ppem`, its outline translated by (dx, dy) in
// 26.6 (y up), into the (oh, ow) 8-bit mask whose top-left pixel is the
// pixel (x0, y0 - 1) of the glyph's pixel grid; coverage c is composed over
// the mask's m as PIL composes glyphs, c + m - (c m + 127) / 255.
// → 0 on success, -1 on error.
int ttf_render_glyph(void* h, int gid, int ppem, long long dx, long long dy,
                     int x0, int y0, unsigned char* out, int ow, int oh) {
  const Font& f = *static_cast<Font*>(h);
  Outline o;
  if (!glyph_outline(f, gid, ppem, o)) return -1;
  if (o.pts.empty()) return 0;
  for (Point& p : o.pts) { p.x += dx; p.y += dy; }
  i64 bx0, by0, bx1, by1;
  cbox(o, &bx0, &by0, &bx1, &by1);
  int px0 = int(pix_floor(bx0) >> 6), py0 = int(pix_floor(by0) >> 6);
  int px1 = int(pix_ceil(bx1) >> 6), py1 = int(pix_ceil(by1) >> 6);
  if (px1 <= px0 || py1 <= py0) return 0;
  if (i64(px1 - px0) * (py1 - py0) > (i64(1) << 26)) return -1;
  // as FreeType's smooth renderer: the outline moved to the bitmap's
  // origin first (conic midpoints then round as they do there)
  for (Point& p : o.pts) { p.x -= i64(px0) * 64; p.y -= i64(py0) * 64; }
  Raster ras;
  ras.init(0, 0, px1 - px0, py1 - py0);
  decompose(o, ras);
  // mask column of pixel x: x - x0; mask row of pixel row y: y0 - 1 - y
  ras.sweep(out, ow, oh, px0 - x0, y0 - py1);
  return 0;
}

}  // extern "C"
