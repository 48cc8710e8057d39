// The part of Anti-Grain Geometry 2.4 that matplotlib's Agg backend runs
// for utils/mpl_page.py, on a machine without matplotlib: the scanline
// rasteriser (24.8 cells as rasterizer_cells_aa walks them, the sweep and
// calculate_alpha with the non-zero rule, no gamma), vcgen_stroke's square
// caps for a straight two-point stroke, and matplotlib's plain RGBA
// blender (fixed_blender_rgba_plain) behind pixfmt_alpha_blend_rgba's
// hspan and hline calls, on an RGBA buffer whose rows run top down.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>

namespace {

const int kShift = 8, kScale = 1 << kShift, kMask = kScale - 1;

inline int iround(double v) { return int(v < 0.0 ? v - 0.5 : v + 0.5); }
inline unsigned uround(double v) { return unsigned(v + 0.5); }

// rasterizer_cells_aa: cells (x, y) with cover and area
struct Cells {
  struct Cell { int cover = 0; int area = 0; };
  std::map<std::pair<int, int>, Cell> cells;  // (y, x) -> summed cell
  int cx = 0x7FFFFFFF, cy = 0x7FFFFFFF;
  Cell cur;

  void flush() {
    if (cur.area | cur.cover) {
      Cell& c = cells[{cy, cx}];
      c.area += cur.area;
      c.cover += cur.cover;
    }
    cur = Cell();
  }
  void set_cell(int x, int y) {
    if (x != cx || y != cy) {
      flush();
      cx = x;
      cy = y;
    }
  }
  void render_hline(int ey, int x1, int y1, int x2, int y2) {
    int ex1 = x1 >> kShift, ex2 = x2 >> kShift;
    int fx1 = x1 & kMask, fx2 = x2 & kMask;
    if (y1 == y2) {
      set_cell(ex2, ey);
      return;
    }
    if (ex1 == ex2) {
      int delta = y2 - y1;
      cur.cover += delta;
      cur.area += (fx1 + fx2) * delta;
      return;
    }
    long long p = (long long)(kScale - fx1) * (y2 - y1);
    int first = kScale, incr = 1;
    long long dx = (long long)x2 - x1;
    if (dx < 0) {
      p = (long long)fx1 * (y2 - y1);
      first = 0;
      incr = -1;
      dx = -dx;
    }
    long long delta = p / dx, mod = p % dx;
    if (mod < 0) {
      --delta;
      mod += dx;
    }
    cur.cover += int(delta);
    cur.area += int((fx1 + first) * delta);
    ex1 += incr;
    set_cell(ex1, ey);
    y1 += int(delta);
    if (ex1 != ex2) {
      p = (long long)kScale * (y2 - y1 + delta);
      long long lift = p / dx, rem = p % dx;
      if (rem < 0) {
        --lift;
        rem += dx;
      }
      mod -= dx;
      while (ex1 != ex2) {
        delta = lift;
        mod += rem;
        if (mod >= 0) {
          mod -= dx;
          ++delta;
        }
        cur.cover += int(delta);
        cur.area += int(kScale * delta);
        y1 += int(delta);
        ex1 += incr;
        set_cell(ex1, ey);
      }
    }
    delta = y2 - y1;
    cur.cover += int(delta);
    cur.area += int((fx2 + kScale - first) * delta);
  }
  void line(int x1, int y1, int x2, int y2) {
    long long dx = (long long)x2 - x1, dy = (long long)y2 - y1;
    int ex1 = x1 >> kShift, ey1 = y1 >> kShift, ey2 = y2 >> kShift;
    int fy1 = y1 & kMask, fy2 = y2 & kMask;
    set_cell(ex1, ey1);
    if (ey1 == ey2) {
      render_hline(ey1, x1, fy1, x2, fy2);
      return;
    }
    int incr = 1;
    if (dx == 0) {
      int ex = x1 >> kShift;
      int two_fx = (x1 - (ex << kShift)) << 1;
      int first = kScale;
      if (dy < 0) {
        first = 0;
        incr = -1;
      }
      int delta = first - fy1;
      cur.cover += delta;
      cur.area += two_fx * delta;
      ey1 += incr;
      set_cell(ex, ey1);
      delta = first + first - kScale;
      int area = two_fx * delta;
      while (ey1 != ey2) {
        cur.cover = delta;
        cur.area = area;
        ey1 += incr;
        set_cell(ex, ey1);
      }
      delta = fy2 - kScale + first;
      cur.cover += delta;
      cur.area += two_fx * delta;
      return;
    }
    long long p = (long long)(kScale - fy1) * dx;
    int first = kScale;
    if (dy < 0) {
      p = (long long)fy1 * dx;
      first = 0;
      incr = -1;
      dy = -dy;
    }
    long long delta = p / dy, mod = p % dy;
    if (mod < 0) {
      --delta;
      mod += dy;
    }
    int x_from = x1 + int(delta);
    render_hline(ey1, x1, fy1, x_from, first);
    ey1 += incr;
    set_cell(x_from >> kShift, ey1);
    if (ey1 != ey2) {
      p = (long long)kScale * dx;
      long long lift = p / dy, rem = p % dy;
      if (rem < 0) {
        --lift;
        rem += dy;
      }
      mod -= dy;
      while (ey1 != ey2) {
        delta = lift;
        mod += rem;
        if (mod >= 0) {
          mod -= dy;
          ++delta;
        }
        int x_to = x_from + int(delta);
        render_hline(ey1, x_from, kScale - first, x_to, first);
        x_from = x_to;
        ey1 += incr;
        set_cell(x_from >> kShift, ey1);
      }
    }
    render_hline(ey1, x_from, kScale - first, x2, fy2);
  }
};

// matplotlib's fixed_blender_rgba_plain under pixfmt_alpha_blend_rgba:
// a covered pixel of an opaque colour is set, any other is blended with
// alpha = colour alpha x cover
void blend(uint8_t* p, const uint8_t c[4], unsigned cover) {
  if (c[3] == 0) return;
  if (c[3] == 255 && cover == 255) {
    std::memcpy(p, c, 4);
    return;
  }
  unsigned t = c[3] * cover + 128;
  unsigned alpha = ((t >> 8) + t) >> 8;
  if (alpha == 0) return;
  unsigned a = p[3];
  unsigned r = p[0] * a, g = p[1] * a, b = p[2] * a;
  a = ((alpha + a) << 8) - alpha * a;
  p[3] = uint8_t(a >> 8);
  p[0] = uint8_t((((unsigned(c[0]) << 8) - r) * alpha + (r << 8)) / a);
  p[1] = uint8_t((((unsigned(c[1]) << 8) - g) * alpha + (g << 8)) / a);
  p[2] = uint8_t((((unsigned(c[2]) << 8) - b) * alpha + (b << 8)) / a);
}

// the sweep: each row's cells in x order, calculate_alpha of the
// non-zero rule, spans blended into the buffer
void render(Cells& cells, uint8_t* buf, int w, int h, const uint8_t c[4]) {
  cells.flush();
  auto alpha_of = [](long long area) {
    long long cover = area >> (kShift * 2 + 1 - 8);
    if (cover < 0) cover = -cover;
    if (cover > 255) cover = 255;
    return unsigned(cover);
  };
  auto it = cells.cells.begin();
  while (it != cells.cells.end()) {
    int y = it->first.first;
    long long cover = 0;
    auto row_end = it;
    while (row_end != cells.cells.end() && row_end->first.first == y) ++row_end;
    for (; it != row_end;) {
      int x = it->first.second;
      cover += it->second.cover;
      long long area = it->second.area;
      ++it;
      if (y >= 0 && y < h) {
        if (area) {
          unsigned a = alpha_of((cover << (kShift + 1)) - area);
          if (a && x >= 0 && x < w) blend(buf + (size_t(y) * w + x) * 4, c, a);
          ++x;
        }
        if (it != row_end && it->first.second > x) {
          unsigned a = alpha_of(cover << (kShift + 1));
          if (a)
            for (int xx = std::max(x, 0); xx < std::min(it->first.second, w);
                 ++xx)
              blend(buf + (size_t(y) * w + xx) * 4, c, a);
        }
      }
    }
  }
}

void to_rgba8(const double* c, uint8_t out[4]) {
  for (int k = 0; k < 4; ++k) out[k] = uint8_t(uround(c[k] * 255.0));
}

}  // namespace

extern "C" {

// Fill a closed polygon of n vertices (x, y pixel pairs, y down) with
// colour `rgba` (0..1 doubles): its points upscaled to integer subpixels
// as ras_conv_int rounds them, no clipping box.
void agg_fill(uint8_t* buf, int w, int h, const double* xy, int n,
              const double* rgba) {
  if (n < 1) return;
  Cells cells;
  int x0 = iround(xy[0] * kScale), y0 = iround(xy[1] * kScale);
  int px = x0, py = y0;
  for (int i = 1; i <= n; ++i) {
    int k = i % n;
    int x = iround(xy[2 * k] * kScale), y = iround(xy[2 * k + 1] * kScale);
    cells.line(px, py, x, y);
    px = x;
    py = y;
  }
  uint8_t c[4];
  to_rgba8(rgba, c);
  render(cells, buf, w, h, c);
}

// Stroke the segment (x0, y0)-(x1, y1) at `width` pixels with square
// (projecting) caps, as vcgen_stroke outlines it.
void agg_stroke_segment(uint8_t* buf, int w, int h, const double* seg,
                        double width, const double* rgba) {
  double x0 = seg[0], y0 = seg[1], x1 = seg[2], y1 = seg[3];
  double len = std::sqrt((x1 - x0) * (x1 - x0) + (y1 - y0) * (y1 - y0));
  if (len <= 1e-14) return;  // vertex_dist drops coincident points
  double half = width * 0.5;
  // math_stroke::calc_cap with square caps
  auto cap_at = [&](double ax, double ay, double bx, double by, double* out) {
    double dx1 = (by - ay) / len * half, dy1 = (bx - ax) / len * half;
    double dx2 = dy1, dy2 = dx1;
    out[0] = ax - dx1 - dx2;
    out[1] = ay + dy1 - dy2;
    out[2] = ax + dx1 - dx2;
    out[3] = ay - dy1 - dy2;
  };
  double poly[8];
  cap_at(x0, y0, x1, y1, poly);
  cap_at(x1, y1, x0, y0, poly + 4);
  agg_fill(buf, w, h, poly, 4, rgba);
}

// RendererAgg::draw_text_image at angle 0: the glyph image (ih x iw) with
// its bottom row above row y, from column x, blended in `rgba` through
// the canvas bounds.
void agg_text_image(uint8_t* buf, int w, int h, const uint8_t* img, int ih,
                    int iw, int x, int y, const double* rgba) {
  uint8_t c[4];
  to_rgba8(rgba, c);
  int deltay = y - ih;
  int tx1 = x, ty1 = deltay, tx2 = x + iw, ty2 = y;
  tx2 = std::min(tx2, w);
  ty2 = std::min(ty2, h);
  tx1 = std::max(tx1, 0);
  ty1 = std::max(ty1, 0);
  if (tx2 <= tx1) return;
  int deltax2 = tx1 - x;
  for (int yi = ty1; yi < ty2; ++yi) {
    const uint8_t* cov = img + size_t(yi - deltay) * iw + deltax2;
    uint8_t* p = buf + (size_t(yi) * w + tx1) * 4;
    for (int k = 0; k < tx2 - tx1; ++k, p += 4) {
      if (cov[k] == 0 && c[3] == 255) continue;
      blend(p, c, cov[k]);
    }
  }
}

}  // extern "C"
