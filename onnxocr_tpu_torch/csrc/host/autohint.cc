// matplotlib's text path (utils/ft2font.py): what its FT2Font, built on
// FreeType 2.6.1, computes when backend_agg draws text, on a machine
// without matplotlib.
//
// * Sizes: FT_Set_Char_Size(face, pt * 64, 0, dpi * hinting_factor, dpi)
//   (FT_Request_Metrics, and tt_size_reset's integer ppem where the
//   font's head flags ask for it), then FT_Set_Transform's 1/hf x-scale.
// * Auto-hinting: FT_Load_Glyph(FT_LOAD_FORCE_AUTOHINT |
//   FT_LOAD_TARGET_NORMAL) on the Latin writing system of 2.6.1's
//   autofit module — the global metrics (standard widths from 'o', the
//   blue zones of the Latin blue strings), their scaling (the x-height
//   fit of the vertical scale, blue zones rounded), then per glyph: the
//   in/out directions with near points merged and the topology
//   simplified, segments, segment links and serifs, edges, blue edges,
//   stem widths and edge hinting, and the edge, strong and weak point
//   passes; the loader's side-bearing rounding (pp1, pp2) and advance;
//   then the transform. No horizontal hinting for an italic face. Where
//   the rules of 2.6.1's sources were not at hand they were read off
//   FT2Font's outlines: every glyph the held-out page generator draws
//   equals FT2Font's point for point (tests/test_torch_heldout_synth.py).
// * FT2Font: set_text's pen (26.6, no kerning: the five faces have no
//   'kern' table), glyph control boxes and string bbox, and
//   draw_glyphs_to_bitmap: each glyph rendered by 2.6.1's smooth
//   rasteriser (ftgrays: 24.8 cells, its line and conic-split
//   arithmetic, non-zero winding) and OR-ed into the string image.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <tuple>
#include <vector>

#include "ttf_font.h"

namespace {

i64 muldiv(i64 a, i64 b, i64 c) {  // FT_MulDiv (rounded)
  int s = 1;
  if (a < 0) { a = -a; s = -s; }
  if (b < 0) { b = -b; s = -s; }
  if (c < 0) { c = -c; s = -s; }
  i64 d = c > 0 ? (a * b + (c >> 1)) / c : 0x7FFFFFFF;
  return s > 0 ? d : -d;
}

inline i64 iabs(i64 x) { return x < 0 ? -x : x; }

// ------------------------------------------------------------ hint data
enum { DIR_NONE = 4, DIR_RIGHT = 1, DIR_LEFT = -1, DIR_UP = 2, DIR_DOWN = -2 };
enum {
  FLAG_CONIC = 1, FLAG_CUBIC = 2, FLAG_CONTROL = 3, FLAG_TOUCH_X = 4,
  FLAG_TOUCH_Y = 8, FLAG_WEAK = 16
};
enum { EDGE_NORMAL = 0, EDGE_ROUND = 1, EDGE_SERIF = 2, EDGE_DONE = 4 };
enum { BLUE_TOP = 1, BLUE_ACTIVE = 2, BLUE_ADJUSTMENT = 4 };

struct APoint {
  int flags = 0;
  int in_dir = DIR_NONE, out_dir = DIR_NONE;
  i64 ox = 0, oy = 0;  // scaled, unhinted
  i64 fx = 0, fy = 0;  // font units
  i64 x = 0, y = 0;    // hinted
  i64 u = 0, v = 0;
  APoint* next = nullptr;
  APoint* prev = nullptr;
};

struct AEdge;

struct ASeg {
  int flags = EDGE_NORMAL, dir = 0;
  i64 pos = 0, min_coord = 0, max_coord = 0, height = 0;
  i64 score = 32000;
  ASeg* link = nullptr;
  ASeg* serif = nullptr;
  AEdge* edge = nullptr;
  ASeg* edge_next = nullptr;
  APoint* first = nullptr;
  APoint* last = nullptr;
};

struct AWidth { i64 org = 0, cur = 0, fit = 0; };

struct AEdge {
  i64 fpos = 0, opos = 0, pos = 0;
  int flags = 0, dir = 0;
  i64 scale = 0;
  AWidth* blue_edge = nullptr;
  AEdge* link = nullptr;
  AEdge* serif = nullptr;
  ASeg* first = nullptr;
  ASeg* last = nullptr;
};

struct Axis {
  std::vector<ASeg> segments;
  std::vector<AEdge> edges;
  int num_edges = 0;
  int major_dir = 0;
};

struct LatinBlue {
  AWidth ref, shoot;
  int flags = 0;
};

struct LatinAxis {
  i64 scale = 0, delta = 0;
  std::vector<AWidth> widths;
  i64 edge_distance_threshold = 0, standard_width = 0;
  bool extra_light = false;
  std::vector<LatinBlue> blues;  // vertical axis only
  i64 org_scale = 0, org_delta = 0;
};

struct Hints {
  int upem = 1000;
  std::vector<APoint> points;
  std::vector<APoint*> contours;
  Axis axis[2];
  i64 x_scale = 0x10000, y_scale = 0x10000;
  bool do_horizontal = true;
};

// FT_Outline_Get_Orientation on font-unit points: true for PostScript
// (counter-clockwise outer contours)
bool postscript_orientation(const Outline& o) {
  if (o.pts.empty()) return false;
  i64 x0 = o.pts[0].x, x1 = x0, y0 = o.pts[0].y, y1 = y0;
  for (const Point& p : o.pts) {
    x0 = std::min(x0, p.x); x1 = std::max(x1, p.x);
    y0 = std::min(y0, p.y); y1 = std::max(y1, p.y);
  }
  if (x0 == x1 || y0 == y1) return false;
  auto msb = [](uint32_t z) { int s = 0; while (z >>= 1) ++s; return s; };
  int xs = std::max(msb(uint32_t(iabs(x1) | iabs(x0))) - 14, 0);
  int ys = std::max(msb(uint32_t(y1 - y0)) - 14, 0);
  i64 area = 0;
  int first = 0;
  for (int last : o.ends) {
    i64 px = o.pts[last].x >> xs, py = o.pts[last].y >> ys;
    for (int n = first; n <= last; ++n) {
      i64 cx = o.pts[n].x >> xs, cy = o.pts[n].y >> ys;
      area += (cy - py) * (cx + px);
      px = cx;
      py = cy;
    }
    first = last + 1;
  }
  return area > 0;
}

int direction_compute(i64 dx, i64 dy) {
  i64 ll, ss;
  int dir;
  if (dy >= dx) {
    if (dy >= -dx) { dir = DIR_UP; ll = dy; ss = dx; }
    else { dir = DIR_LEFT; ll = -dx; ss = dy; }
  } else {
    if (dy >= -dx) { dir = DIR_RIGHT; ll = dx; ss = dy; }
    else { dir = DIR_DOWN; ll = dy; ss = dx; }
  }
  ss *= 14;
  if (iabs(ll) <= iabs(ss)) dir = DIR_NONE;
  return dir;
}

i64 hypot_approx(i64 x, i64 y) {  // FT_HYPOT
  x = iabs(x);
  y = iabs(y);
  return x > y ? x + (3 * y >> 3) : y + (3 * x >> 3);
}

bool corner_is_flat(i64 in_x, i64 in_y, i64 out_x, i64 out_y) {
  i64 ax = in_x + out_x, ay = in_y + out_y;
  i64 d_in = hypot_approx(in_x, in_y), d_out = hypot_approx(out_x, out_y),
      d_hypot = hypot_approx(ax, ay);
  return (d_in + d_out - d_hypot) < (d_hypot >> 4);
}

// af_glyph_hints_reload
void hints_reload(Hints& h, const Outline& o) {
  int n = int(o.pts.size());
  h.points.assign(n, APoint());
  h.contours.clear();
  h.axis[0].segments.clear();
  h.axis[1].segments.clear();
  h.axis[0].num_edges = h.axis[1].num_edges = 0;
  h.axis[0].major_dir = DIR_UP;
  h.axis[1].major_dir = DIR_LEFT;
  if (postscript_orientation(o)) {
    h.axis[0].major_dir = DIR_DOWN;
    h.axis[1].major_dir = DIR_RIGHT;
  }
  if (n == 0) return;
  APoint* points = h.points.data();
  APoint* limit = points + n;
  int near_limit = 20 * h.upem / 2048;
  {
    int ci = 0;
    APoint* end = points + o.ends[0];
    APoint* prev = end;
    for (int i = 0; i < n; ++i) {
      APoint* p = points + i;
      p->fx = o.pts[i].x;
      p->fy = o.pts[i].y;
      p->ox = p->x = mulfix(p->fx, h.x_scale);
      p->oy = p->y = mulfix(p->fy, h.y_scale);
      p->flags = o.pts[i].on ? 0 : FLAG_CONIC;
      p->prev = prev;
      prev->next = p;
      prev = p;
      if (p == end && ++ci < int(o.ends.size())) {
        end = points + o.ends[ci];
        prev = end;
      }
    }
  }
  int idx = 0;
  for (int e : o.ends) {
    h.contours.push_back(points + idx);
    idx = e + 1;
  }
  int near_limit2 = 2 * near_limit - 1;
  // the point each contour's direction walk starts from (its first point
  // after a run of near points)
  std::vector<bool> contour_start(n, false);
  for (APoint* first : h.contours) {
    APoint* point = first;
    APoint* prev = first->prev;
    while (prev != first) {
      i64 out_x = point->fx - prev->fx, out_y = point->fy - prev->fy;
      if (iabs(out_x) + iabs(out_y) >= near_limit2) break;
      point = prev;
      prev = prev->prev;
    }
    first = point;
    contour_start[first - points] = true;
    APoint* curr = first;
    APoint* next = first;
    i64 out_x = 0, out_y = 0;
    do {
      point = next;
      next = point->next;
      out_x += next->fx - point->fx;
      out_y += next->fy - point->fy;
      if (iabs(out_x) + iabs(out_y) < near_limit) {
        next->flags |= FLAG_WEAK;
        continue;
      }
      curr->u = next - curr;
      next->v = -curr->u;
      int out_dir = direction_compute(out_x, out_y);
      curr->out_dir = out_dir;
      for (curr = curr->next; curr != next; curr = curr->next) {
        curr->in_dir = out_dir;
        curr->out_dir = out_dir;
      }
      next->in_dir = out_dir;
      out_x = 0;
      out_y = 0;
    } while (next != first);
  }
  // a series of non-horizontal, non-vertical vectors into one quadrant
  // is one vector: the points between are weak
  for (APoint* point = points; point < limit; ++point) {
    if (point->flags & FLAG_WEAK) continue;
    if (point->in_dir == DIR_NONE && point->out_dir == DIR_NONE) {
      APoint* next_u = point + point->u;
      APoint* prev_v = point + point->v;
      i64 in_x = point->fx - prev_v->fx, in_y = point->fy - prev_v->fy;
      i64 out_x = next_u->fx - point->fx, out_y = next_u->fy - point->fy;
      if ((in_x ^ out_x) >= 0 && (in_y ^ out_y) >= 0) {
        point->flags |= FLAG_WEAK;
        prev_v->u = next_u - prev_v;
        next_u->v = -prev_v->u;
      }
    }
  }
  for (APoint* point = points; point < limit; ++point) {
    if (point->flags & FLAG_WEAK) continue;
    bool weak = false;
    if (point->flags & FLAG_CONTROL) {
      weak = true;
    } else if (point->out_dir == point->in_dir) {
      // the walk's start point on a straight or flat run is weak
      // whatever its neighbours: 2.6.1's outlines show it so
      if (point->out_dir != DIR_NONE || contour_start[point - points]) {
        weak = true;
      } else {
        APoint* next_u = point + point->u;
        APoint* prev_v = point + point->v;
        if (corner_is_flat(point->fx - prev_v->fx, point->fy - prev_v->fy,
                           next_u->fx - point->fx, next_u->fy - point->fy)) {
          prev_v->u = next_u - prev_v;
          next_u->v = -prev_v->u;
          weak = true;
        }
      }
    } else if (point->in_dir == -point->out_dir) {
      weak = true;
    }
    if (weak) point->flags |= FLAG_WEAK;
  }
}

// ------------------------------------------------------------- latin
struct LatinMetrics {
  int upem = 1000;
  LatinAxis axis[2];
};

i64 latin_constant(int upem, i64 c) { return c * upem / 2048; }

// af_latin_hints_compute_segments
void compute_segments(Hints& h, int upem, int dim) {
  Axis& axis = h.axis[dim];
  int major_dir = std::abs(axis.major_dir), segment_dir = major_dir;
  i64 flat_threshold = upem / 14;
  axis.segments.clear();
  axis.segments.reserve(h.points.size());
  for (APoint& p : h.points) {
    p.u = dim == 0 ? p.fx : p.fy;
    p.v = dim == 0 ? p.fy : p.fx;
  }
  for (APoint* start : h.contours) {
    APoint* point = start;
    APoint* last = point->prev;
    bool on_edge = false;
    i64 min_pos = 32000, max_pos = -32000;
    i64 min_on_pos = 32000, max_on_pos = -32000;
    ASeg* segment = nullptr;
    if (point == last) continue;
    if (std::abs(last->out_dir) == major_dir &&
        std::abs(point->out_dir) == major_dir) {
      last = point;
      for (;;) {
        point = point->prev;
        if (std::abs(point->out_dir) != major_dir) {
          point = point->next;
          break;
        }
        if (point == last) break;
      }
    }
    last = point;
    bool passed = false;
    for (;;) {
      if (on_edge) {
        i64 u = point->u;
        if (u < min_pos) min_pos = u;
        if (u > max_pos) max_pos = u;
        if (!(point->flags & FLAG_CONTROL)) {
          i64 v = point->v;
          if (v < min_on_pos) min_on_pos = v;
          if (v > max_on_pos) max_on_pos = v;
        }
        if (point->out_dir != segment_dir || point == last) {
          segment->last = point;
          segment->pos = (min_pos + max_pos) >> 1;
          if (((segment->first->flags | point->flags) & FLAG_CONTROL) &&
              (max_on_pos - min_on_pos) < flat_threshold)
            segment->flags |= EDGE_ROUND;
          min_pos = max_pos = point->v;
          i64 v = segment->first->v;
          if (v < min_pos) min_pos = v;
          if (v > max_pos) max_pos = v;
          segment->min_coord = min_pos;
          segment->max_coord = max_pos;
          segment->height = segment->max_coord - segment->min_coord;
          on_edge = false;
          segment = nullptr;
        }
      }
      if (point == last) {
        if (passed) break;
        passed = true;
      }
      if (!on_edge && std::abs(point->out_dir) == major_dir) {
        segment_dir = point->out_dir;
        axis.segments.emplace_back();
        segment = &axis.segments.back();
        segment->dir = segment_dir;
        segment->first = point;
        segment->last = point;
        min_pos = max_pos = point->u;
        if (point->flags & FLAG_CONTROL) {
          min_on_pos = 32000;
          max_on_pos = -32000;
        } else {
          min_on_pos = max_on_pos = point->v;
        }
        on_edge = true;
      }
      point = point->next;
    }
  }
  for (ASeg& s : axis.segments) {
    APoint* first = s.first;
    APoint* last = s.last;
    i64 first_v = first->v, last_v = last->v;
    if (first_v < last_v) {
      APoint* p = first->prev;
      if (p->v < first_v) s.height += (first_v - p->v) >> 1;
      p = last->next;
      if (p->v > last_v) s.height += (p->v - last_v) >> 1;
    } else {
      APoint* p = first->prev;
      if (p->v > first_v) s.height += (p->v - first_v) >> 1;
      p = last->next;
      if (p->v < last_v) s.height += (last_v - p->v) >> 1;
    }
    s.height = int16_t(s.height);
  }
}

// af_latin_hints_link_segments
void link_segments(Hints& h, int upem, const std::vector<AWidth>* widths,
                   int dim) {
  Axis& axis = h.axis[dim];
  std::vector<ASeg>& segs = axis.segments;
  i64 max_width = widths && !widths->empty() ? widths->back().org : 0;
  i64 len_threshold = latin_constant(upem, 8);
  if (len_threshold == 0) len_threshold = 1;
  i64 len_score = latin_constant(upem, 6000);
  i64 dist_score = 3000;
  for (ASeg& seg1 : segs) {
    if (seg1.dir != axis.major_dir) continue;
    for (ASeg& seg2 : segs) {
      i64 pos1 = seg1.pos, pos2 = seg2.pos;
      if (seg1.dir + seg2.dir == 0 && pos2 > pos1) {
        i64 mn = std::max(seg1.min_coord, seg2.min_coord);
        i64 mx = std::min(seg1.max_coord, seg2.max_coord);
        i64 len = mx - mn;
        if (len >= len_threshold) {
          i64 dist = pos2 - pos1, dist_demerit;
          if (max_width) {
            i64 delta = (dist << 10) / max_width - (1 << 10);
            if (delta > 10000) dist_demerit = 32000;
            else if (delta > 0) dist_demerit = delta * delta / dist_score;
            else dist_demerit = 0;
          } else {
            dist_demerit = dist;
          }
          i64 score = dist_demerit + len_score / len;
          if (score < seg1.score) {
            seg1.score = score;
            seg1.link = &seg2;
          }
          if (score < seg2.score) {
            seg2.score = score;
            seg2.link = &seg1;
          }
        }
      }
    }
  }
  for (ASeg& seg1 : segs) {
    ASeg* seg2 = seg1.link;
    if (seg2 && seg2->link != &seg1) {
      seg1.link = nullptr;
      seg1.serif = seg2->link;
    }
  }
}

// af_latin_hints_compute_edges
void compute_edges(Hints& h, const LatinAxis& laxis, int dim) {
  Axis& axis = h.axis[dim];
  i64 scale = dim == 0 ? h.x_scale : h.y_scale;
  i64 segment_length_threshold = dim == 0 ? divfix(64, h.y_scale) : 0;
  i64 edt = mulfix(laxis.edge_distance_threshold, scale);
  if (edt > 64 / 4) edt = 64 / 4;
  edt = divfix(edt, scale);
  axis.edges.assign(axis.segments.size() + 1, AEdge());
  axis.num_edges = 0;
  AEdge* edges = axis.edges.data();
  for (ASeg& seg : axis.segments) {
    if (seg.height < segment_length_threshold) continue;
    if (seg.serif && 2 * seg.height < 3 * segment_length_threshold) continue;
    AEdge* found = nullptr;
    for (int ee = 0; ee < axis.num_edges; ++ee) {
      AEdge* edge = edges + ee;
      i64 dist = iabs(seg.pos - edge->fpos);
      if (dist < edt && edge->dir == seg.dir) {
        found = edge;
        break;
      }
    }
    if (!found) {
      // insert sorted by position; at a tie, the minor direction first
      AEdge* edge = edges + axis.num_edges;
      while (edge > edges) {
        if (edge[-1].fpos < seg.pos) break;
        if (edge[-1].fpos == seg.pos && seg.dir == axis.major_dir) break;
        edge[0] = edge[-1];
        --edge;
      }
      ++axis.num_edges;
      *edge = AEdge();
      edge->first = &seg;
      edge->last = &seg;
      edge->dir = seg.dir;
      edge->fpos = seg.pos;
      edge->opos = edge->pos = mulfix(seg.pos, scale);
      seg.edge_next = &seg;
    } else {
      seg.edge_next = found->first;
      found->last->edge_next = &seg;
      found->last = &seg;
    }
  }
  AEdge* edge_limit = edges + axis.num_edges;
  for (AEdge* edge = edges; edge < edge_limit; ++edge) {
    ASeg* seg = edge->first;
    if (seg) do {
        seg->edge = edge;
        seg = seg->edge_next;
      } while (seg != edge->first);
  }
  for (AEdge* edge = edges; edge < edge_limit; ++edge) {
    int is_round = 0, is_straight = 0;
    ASeg* seg = edge->first;
    do {
      if (seg->flags & EDGE_ROUND) ++is_round;
      else ++is_straight;
      bool is_serif = seg->serif && seg->serif->edge &&
                      seg->serif->edge != edge;
      if ((seg->link && seg->link->edge) || is_serif) {
        AEdge* edge2 = edge->link;
        ASeg* seg2 = seg->link;
        if (is_serif) {
          seg2 = seg->serif;
          edge2 = edge->serif;
        }
        if (edge2) {
          i64 edge_delta = iabs(edge->fpos - edge2->fpos);
          i64 seg_delta = iabs(seg->pos - seg2->pos);
          if (seg_delta < edge_delta) edge2 = seg2->edge;
        } else {
          edge2 = seg2->edge;
        }
        if (is_serif) {
          edge->serif = edge2;
          edge2->flags |= EDGE_SERIF;
        } else {
          edge->link = edge2;
        }
      }
      seg = seg->edge_next;
    } while (seg != edge->first);
    edge->flags = EDGE_NORMAL;
    if (is_round > 0 && is_round >= is_straight) edge->flags |= EDGE_ROUND;
    if (edge->serif && edge->link) edge->serif = nullptr;
  }
}

// af_latin_hints_compute_blue_edges
void compute_blue_edges(Hints& h, LatinMetrics& m) {
  Axis& axis = h.axis[1];
  LatinAxis& latin = m.axis[1];
  i64 scale = latin.scale;
  for (int e = 0; e < axis.num_edges; ++e) {
    AEdge* edge = &axis.edges[e];
    AWidth* best_blue = nullptr;
    i64 best_dist = mulfix(m.upem / 40, scale);
    if (best_dist > 64 / 2) best_dist = 64 / 2;
    for (LatinBlue& blue : latin.blues) {
      if (!(blue.flags & BLUE_ACTIVE)) continue;
      bool is_top_blue = (blue.flags & BLUE_TOP) != 0;
      bool is_major_dir = edge->dir == axis.major_dir;
      if (is_top_blue ^ is_major_dir) {
        i64 dist = mulfix(iabs(edge->fpos - blue.ref.org), scale);
        if (dist < best_dist) {
          best_dist = dist;
          best_blue = &blue.ref;
        }
        if ((edge->flags & EDGE_ROUND) && dist != 0) {
          bool is_under_ref = edge->fpos < blue.ref.org;
          if (is_top_blue ^ is_under_ref) {
            dist = mulfix(iabs(edge->fpos - blue.shoot.org), scale);
            if (dist < best_dist) {
              best_dist = dist;
              best_blue = &blue.shoot;
            }
          }
        }
      }
    }
    if (best_blue) edge->blue_edge = best_blue;
  }
}

// af_latin_compute_stem_width (anti-aliased target: light quantisation)
i64 compute_stem_width(const LatinMetrics& m, int dim, i64 width,
                       int base_flags, int stem_flags) {
  const LatinAxis& axis = m.axis[dim];
  i64 dist = width;
  bool sign = false, vertical = dim == 1;
  if (axis.extra_light) return width;
  if (dist < 0) {
    dist = -width;
    sign = true;
  }
  if ((stem_flags & EDGE_SERIF) && vertical && dist < 3 * 64) goto done;
  if (base_flags & EDGE_ROUND) {
    if (dist < 80) dist = 64;
  } else if (dist < 56) {
    dist = 56;
  }
  if (!axis.widths.empty()) {
    i64 delta = iabs(dist - axis.widths[0].cur);
    if (delta < 40) {
      dist = axis.widths[0].cur;
      if (dist < 48) dist = 48;
      goto done;
    }
    if (dist < 3 * 64) {
      delta = dist & 63;
      dist &= -64;
      if (delta < 10) dist += delta;
      else if (delta < 32) dist += 10;
      else if (delta < 54) dist += 54;
      else dist += delta;
    } else {
      dist = (dist + 32) & ~i64(63);
    }
  }
done:
  return sign ? -dist : dist;
}

void align_linked_edge(const LatinMetrics& m, int dim, AEdge* base,
                       AEdge* stem) {
  i64 dist = stem->opos - base->opos;
  stem->pos = base->pos +
              compute_stem_width(m, dim, dist, base->flags, stem->flags);
}

// af_latin_hint_edges
void hint_edges(Hints& h, const LatinMetrics& m, int dim) {
  Axis& axis = h.axis[dim];
  AEdge* edges = axis.edges.data();
  AEdge* edge_limit = edges + axis.num_edges;
  AEdge* anchor = nullptr;
  int has_serifs = 0;
  if (dim == 1) {
    for (AEdge* edge = edges; edge < edge_limit; ++edge) {
      if (edge->flags & EDGE_DONE) continue;
      AEdge* edge1 = nullptr;
      AEdge* edge2 = edge->link;
      AWidth* blue = edge->blue_edge;
      if (blue) {
        edge1 = edge;
      } else if (edge2 && edge2->blue_edge) {
        blue = edge2->blue_edge;
        edge1 = edge2;
        edge2 = edge;
      }
      if (!edge1) continue;
      edge1->pos = blue->fit;
      edge1->flags |= EDGE_DONE;
      if (edge2 && !edge2->blue_edge) {
        align_linked_edge(m, dim, edge1, edge2);
        edge2->flags |= EDGE_DONE;
      }
      if (!anchor) anchor = edge;
    }
  }
  for (AEdge* edge = edges; edge < edge_limit; ++edge) {
    if (edge->flags & EDGE_DONE) continue;
    AEdge* edge2 = edge->link;
    if (!edge2) {
      ++has_serifs;
      continue;
    }
    if (edge2->blue_edge) {
      align_linked_edge(m, dim, edge2, edge);
      edge->flags |= EDGE_DONE;
      continue;
    }
    if (!anchor) {
      i64 org_len = edge2->opos - edge->opos;
      i64 cur_len = compute_stem_width(m, dim, org_len, edge->flags,
                                       edge2->flags);
      i64 u_off, d_off;
      if (cur_len <= 64) { u_off = 32; d_off = 32; }
      else { u_off = 38; d_off = 26; }
      if (cur_len < 96) {
        i64 org_center = edge->opos + (org_len >> 1);
        i64 cur_pos1 = pix_round(org_center);
        i64 error1 = iabs(org_center - (cur_pos1 - u_off));
        i64 error2 = iabs(org_center - (cur_pos1 + d_off));
        if (error1 < error2) cur_pos1 -= u_off;
        else cur_pos1 += d_off;
        edge->pos = cur_pos1 - cur_len / 2;
        edge2->pos = edge->pos + cur_len;
      } else {
        edge->pos = pix_round(edge->opos);
      }
      anchor = edge;
      edge->flags |= EDGE_DONE;
      align_linked_edge(m, dim, edge, edge2);
    } else {
      i64 org_pos = anchor->pos + (edge->opos - anchor->opos);
      i64 org_len = edge2->opos - edge->opos;
      i64 org_center = org_pos + (org_len >> 1);
      i64 cur_len = compute_stem_width(m, dim, org_len, edge->flags,
                                       edge2->flags);
      if (edge2->flags & EDGE_DONE) {
        edge->pos = edge2->pos - cur_len;
      } else if (cur_len < 96) {
        i64 cur_pos1 = pix_round(org_center), u_off, d_off;
        if (cur_len <= 64) { u_off = 32; d_off = 32; }
        else { u_off = 38; d_off = 26; }
        i64 delta1 = iabs(org_center - (cur_pos1 - u_off));
        i64 delta2 = iabs(org_center - (cur_pos1 + d_off));
        if (delta1 < delta2) cur_pos1 -= u_off;
        else cur_pos1 += d_off;
        edge->pos = cur_pos1 - cur_len / 2;
        edge2->pos = cur_pos1 + cur_len / 2;
      } else {
        i64 cur_pos1 = pix_round(org_pos);
        i64 delta1 = iabs(cur_pos1 + (cur_len >> 1) - org_center);
        i64 cur_pos2 = pix_round(org_pos + org_len) - cur_len;
        i64 delta2 = iabs(cur_pos2 + (cur_len >> 1) - org_center);
        edge->pos = delta1 < delta2 ? cur_pos1 : cur_pos2;
        edge2->pos = edge->pos + cur_len;
      }
      edge->flags |= EDGE_DONE;
      edge2->flags |= EDGE_DONE;
      if (edge > edges && edge->pos < edge[-1].pos) edge->pos = edge[-1].pos;
    }
  }
  // lowercase m's symmetry
  int n_edges = axis.num_edges;
  if (dim == 0 && (n_edges == 6 || n_edges == 12)) {
    AEdge *edge1, *edge2, *edge3;
    if (n_edges == 6) {
      edge1 = edges; edge2 = edges + 2; edge3 = edges + 4;
    } else {
      edge1 = edges + 1; edge2 = edges + 5; edge3 = edges + 9;
    }
    i64 dist1 = edge2->opos - edge1->opos, dist2 = edge3->opos - edge2->opos;
    i64 span = iabs(dist1 - dist2);
    if (span < 8) {
      i64 delta = edge3->pos - (2 * edge2->pos - edge1->pos);
      edge3->pos -= delta;
      if (edge3->link) edge3->link->pos -= delta;
      if (n_edges == 12) {
        (edges + 8)->pos -= delta;
        (edges + 11)->pos -= delta;
      }
      edge3->flags |= EDGE_DONE;
      if (edge3->link) edge3->link->flags |= EDGE_DONE;
    }
  }
  if (has_serifs || !anchor) {
    for (AEdge* edge = edges; edge < edge_limit; ++edge) {
      if (edge->flags & EDGE_DONE) continue;
      i64 delta = 1000;
      if (edge->serif) delta = iabs(edge->serif->opos - edge->opos);
      if (delta < 64 + 16) {
        edge->pos = edge->serif->pos + (edge->opos - edge->serif->opos);
      } else if (!anchor) {
        edge->pos = pix_round(edge->opos);
        anchor = edge;
      } else {
        AEdge *before, *after;
        for (before = edge - 1; before >= edges; --before)
          if (before->flags & EDGE_DONE) break;
        for (after = edge + 1; after < edge_limit; ++after)
          if (after->flags & EDGE_DONE) break;
        if (before >= edges && before < edge && after < edge_limit &&
            after > edge) {
          if (after->opos == before->opos)
            edge->pos = before->pos;
          else
            edge->pos = before->pos +
                        muldiv(edge->opos - before->opos,
                               after->pos - before->pos,
                               after->opos - before->opos);
        } else {
          edge->pos = anchor->pos +
                      ((edge->opos - anchor->opos + 16) & ~i64(31));
        }
      }
      edge->flags |= EDGE_DONE;
      if (edge > edges && edge->pos < edge[-1].pos) edge->pos = edge[-1].pos;
      if (edge + 1 < edge_limit && (edge[1].flags & EDGE_DONE) &&
          edge->pos > edge[1].pos)
        edge->pos = edge[1].pos;
    }
  }
}

// af_glyph_hints_align_edge_points
void align_edge_points(Hints& h, int dim) {
  for (ASeg& seg : h.axis[dim].segments) {
    AEdge* edge = seg.edge;
    if (!edge) continue;
    APoint* point = seg.first;
    for (;;) {
      if (dim == 0) { point->x = edge->pos; point->flags |= FLAG_TOUCH_X; }
      else { point->y = edge->pos; point->flags |= FLAG_TOUCH_Y; }
      if (point == seg.last) break;
      point = point->next;
    }
  }
}

// af_glyph_hints_align_strong_points
void align_strong_points(Hints& h, int dim) {
  Axis& axis = h.axis[dim];
  AEdge* edges = axis.edges.data();
  AEdge* edge_limit = edges + axis.num_edges;
  int touch_flag = dim == 0 ? FLAG_TOUCH_X : FLAG_TOUCH_Y;
  if (edges >= edge_limit) return;
  for (APoint& pt : h.points) {
    APoint* point = &pt;
    if (point->flags & touch_flag) continue;
    if (point->flags & FLAG_WEAK) continue;
    i64 u, ou;
    if (dim == 1) { u = point->fy; ou = point->oy; }
    else { u = point->fx; ou = point->ox; }
    i64 fu = u;
    AEdge* edge = edges;
    if (edge->fpos - u >= 0) {
      u = edge->pos - (edge->opos - ou);
      goto store;
    }
    edge = edge_limit - 1;
    if (u - edge->fpos >= 0) {
      u = edge->pos + (ou - edge->opos);
      goto store;
    }
    {
      std::ptrdiff_t mn = 0, mx = edge_limit - edges;
      if (mx <= 8) {
        std::ptrdiff_t nn;
        for (nn = 0; nn < mx; ++nn)
          if (edges[nn].fpos >= u) break;
        if (edges[nn].fpos == u) {
          u = edges[nn].pos;
          goto store;
        }
        mn = nn;
      } else {
        while (mn < mx) {
          std::ptrdiff_t mid = (mx + mn) >> 1;
          edge = edges + mid;
          i64 fpos = edge->fpos;
          if (u < fpos) mx = mid;
          else if (u > fpos) mn = mid + 1;
          else {
            u = edge->pos;
            goto store;
          }
        }
      }
      AEdge* before = edges + mn - 1;
      AEdge* after = edges + mn;
      if (before->scale == 0)
        before->scale = divfix(after->pos - before->pos,
                               after->fpos - before->fpos);
      u = before->pos + mulfix(fu - before->fpos, before->scale);
    }
  store:
    if (dim == 0) point->x = u;
    else point->y = u;
    point->flags |= touch_flag;
  }
}

void iup_shift(APoint* p1, APoint* p2, APoint* ref) {
  i64 delta = ref->u - ref->v;
  if (delta == 0) return;
  for (APoint* p = p1; p < ref; ++p) p->u = p->v + delta;
  for (APoint* p = ref + 1; p <= p2; ++p) p->u = p->v + delta;
}

void iup_interp(APoint* p1, APoint* p2, APoint* ref1, APoint* ref2) {
  if (p1 > p2) return;
  if (ref1->v > ref2->v) std::swap(ref1, ref2);
  i64 v1 = ref1->v, v2 = ref2->v, u1 = ref1->u, u2 = ref2->u;
  i64 d1 = u1 - v1, d2 = u2 - v2;
  if (u1 == u2 || v1 == v2) {
    for (APoint* p = p1; p <= p2; ++p) {
      i64 u = p->v;
      if (u <= v1) u += d1;
      else if (u >= v2) u += d2;
      else u = u1;
      p->u = u;
    }
  } else {
    i64 scale = divfix(u2 - u1, v2 - v1);
    for (APoint* p = p1; p <= p2; ++p) {
      i64 u = p->v;
      if (u <= v1) u += d1;
      else if (u >= v2) u += d2;
      else u = u1 + mulfix(u - v1, scale);
      p->u = u;
    }
  }
}

// af_glyph_hints_align_weak_points
void align_weak_points(Hints& h, int dim) {
  APoint* points = h.points.data();
  APoint* point_limit = points + h.points.size();
  int touch_flag = dim == 0 ? FLAG_TOUCH_X : FLAG_TOUCH_Y;
  for (APoint* p = points; p < point_limit; ++p) {
    p->u = dim == 0 ? p->x : p->y;
    p->v = dim == 0 ? p->ox : p->oy;
  }
  for (APoint* first_point : h.contours) {
    APoint* point = first_point;
    APoint* end_point = point->prev;
    APoint* first_touched;
    APoint* last_touched;
    for (;;) {
      if (point > end_point) goto next_contour;
      if (point->flags & touch_flag) break;
      ++point;
    }
    first_touched = point;
    for (;;) {
      while (point < end_point && (point[1].flags & touch_flag)) ++point;
      last_touched = point;
      ++point;
      for (;;) {
        if (point > end_point) goto end_contour;
        if (point->flags & touch_flag) break;
        ++point;
      }
      iup_interp(last_touched + 1, point - 1, last_touched, point);
    }
  end_contour:
    if (last_touched == first_touched) {
      iup_shift(first_point, end_point, first_touched);
    } else {
      if (last_touched < end_point)
        iup_interp(last_touched + 1, end_point, last_touched, first_touched);
      if (first_touched > points)
        iup_interp(first_point, first_touched - 1, last_touched,
                   first_touched);
    }
  next_contour:;
  }
  for (APoint* p = points; p < point_limit; ++p) {
    if (dim == 0) p->x = p->u;
    else p->y = p->u;
  }
}

void sort_and_quantize_widths(std::vector<AWidth>& table, i64 threshold) {
  unsigned count = unsigned(table.size());
  if (count <= 1) return;
  for (unsigned i = 1; i < count; ++i)
    for (unsigned j = i; j > 0; --j) {
      if (table[j].org >= table[j - 1].org) break;
      std::swap(table[j], table[j - 1]);
    }
  unsigned cur_idx = 0;
  i64 cur_val = table[cur_idx].org;
  for (unsigned i = 1; i < count; ++i) {
    if (table[i].org - cur_val > threshold || i == count - 1) {
      i64 sum = 0;
      if (table[i].org - cur_val <= threshold && i == count - 1) ++i;
      unsigned j;
      for (j = cur_idx; j < i; ++j) {
        sum += table[j].org;
        table[j].org = 0;
      }
      table[cur_idx].org = sum / i64(j);
      if (i < count - 1) {
        cur_idx = i + 1;
        cur_val = table[cur_idx].org;
      }
    }
  }
  cur_idx = 1;
  for (unsigned i = 1; i < count; ++i)
    if (table[i].org) table[cur_idx++] = table[i];
  table.resize(cur_idx);
}

// ---------------------------------------------------------------- faces
struct Face {
  Font f;
  bool italic = false;
  bool integer_ppem = false;  // head flags bit 3
  LatinMetrics metrics;
  std::mutex mu;
  // hinted glyphs by (char width 26.6, hres, vres, gid)
  struct Glyph {
    std::vector<i64> xy;  // 26.6, after the transform
    std::vector<uint8_t> tags;
    std::vector<int> ends;
    i64 advance_x = 0;    // 26.6, transformed
  };
  std::map<std::tuple<i64, int, int, int>, Glyph> cache;
};

// af_latin_metrics_init_widths
void init_widths(Face& F) {
  LatinMetrics& m = F.metrics;
  m.axis[0].widths.clear();
  m.axis[1].widths.clear();
  Outline o;
  int gid = glyph_of(F.f, 'o');
  if (gid && glyph_units(F.f, gid, o) && !o.pts.empty()) {
    Hints h;
    h.upem = m.upem;
    hints_reload(h, o);
    for (int dim = 0; dim < 2; ++dim) {
      compute_segments(h, m.upem, dim);
      link_segments(h, m.upem, nullptr, dim);
      std::vector<AWidth>& w = m.axis[dim].widths;
      for (ASeg& seg : h.axis[dim].segments) {
        ASeg* link = seg.link;
        if (link && link->link == &seg && link > &seg) {
          i64 dist = iabs(seg.pos - link->pos);
          if (w.size() < 16) w.push_back(AWidth{dist, 0, 0});
        }
      }
      sort_and_quantize_widths(w, m.upem / 100);
    }
  }
  for (int dim = 0; dim < 2; ++dim) {
    LatinAxis& axis = m.axis[dim];
    i64 stdw = !axis.widths.empty() ? axis.widths[0].org
                                    : latin_constant(m.upem, 50);
    axis.edge_distance_threshold = stdw / 5;
    axis.standard_width = stdw;
    axis.extra_light = false;
  }
}

// af_latin_metrics_init_blues: the Latin blue strings of 2.6.1's
// af_blue.dat (capital top and bottom, small-f top, small top with the
// x-height flag, small bottom, small descender)
void init_blues(Face& F) {
  struct BlueString { const char* s; int flags; };
  static const BlueString kBlues[] = {
      {"THEZOCQS", BLUE_TOP}, {"HEZLOCUS", 0}, {"fijkdbh", BLUE_TOP},
      {"xzroesc", BLUE_TOP | BLUE_ADJUSTMENT}, {"xzroesc", 0},
      {"pqgjy", 0}};
  LatinMetrics& m = F.metrics;
  LatinAxis& axis = m.axis[1];
  axis.blues.clear();
  i64 flat_threshold = m.upem / 14;
  for (const BlueString& bs : kBlues) {
    bool top = bs.flags & BLUE_TOP;
    std::vector<i64> flats, rounds;
    for (const char* p = bs.s; *p; ++p) {
      int gid = glyph_of(F.f, uint32_t(*p));
      if (!gid) continue;
      Outline o;
      if (!glyph_units(F.f, gid, o) || o.pts.empty()) continue;
      int best_point = -1, best_first = 0, best_last = 0;
      i64 best_y = 0;
      int first = 0;
      for (size_t c = 0; c < o.ends.size(); first = o.ends[c] + 1, ++c) {
        int last = o.ends[c];
        int old_best = best_point;
        if (last <= first) continue;
        for (int pp = first; pp <= last; ++pp) {
          if (best_point < 0 ||
              (top ? o.pts[pp].y > best_y : o.pts[pp].y < best_y)) {
            best_point = pp;
            best_y = o.pts[pp].y;
          }
        }
        if (best_point != old_best) {
          best_first = first;
          best_last = last;
        }
      }
      if (best_point < 0) continue;
      i64 best_x = o.pts[best_point].x;
      int on_first = -1, on_last = -1;
      if (o.pts[best_point].on) on_first = on_last = best_point;
      // the extremum's segment: the points on either side within 5 units
      // of its height or at a small angle (20 units across a unit up)
      int prev = best_point, next = best_point;
      int seg_first = best_point, seg_last = best_point;
      do {
        prev = prev > best_first ? prev - 1 : best_last;
        i64 dist = iabs(o.pts[prev].y - best_y);
        if (dist > 5 && iabs(o.pts[prev].x - best_x) <= 20 * dist) break;
        seg_first = prev;
        if (o.pts[prev].on) {
          on_first = prev;
          if (on_last < 0) on_last = prev;
        }
      } while (prev != best_point);
      do {
        next = next < best_last ? next + 1 : best_first;
        i64 dist = iabs(o.pts[next].y - best_y);
        if (dist > 5 && iabs(o.pts[next].x - best_x) <= 20 * dist) break;
        seg_last = next;
        if (o.pts[next].on) {
          on_last = next;
          if (on_first < 0) on_first = next;
        }
      } while (next != best_point);
      // flat where its on-curve points span more than the flat
      // threshold, else round where the segment starts or ends off-curve
      bool round;
      if (on_first >= 0 && on_last >= 0 &&
          iabs(o.pts[on_last].x - o.pts[on_first].x) > flat_threshold)
        round = false;
      else
        round = !o.pts[seg_first].on || !o.pts[seg_last].on;
      (round ? rounds : flats).push_back(best_y);
    }
    if (flats.empty() && rounds.empty()) continue;
    std::stable_sort(rounds.begin(), rounds.end());
    std::stable_sort(flats.begin(), flats.end());
    LatinBlue blue;
    if (flats.empty()) {
      blue.ref.org = blue.shoot.org = rounds[rounds.size() / 2];
    } else if (rounds.empty()) {
      blue.ref.org = blue.shoot.org = flats[flats.size() / 2];
    } else {
      blue.ref.org = flats[flats.size() / 2];
      blue.shoot.org = rounds[rounds.size() / 2];
    }
    if (blue.shoot.org != blue.ref.org) {
      i64 ref = blue.ref.org, shoot = blue.shoot.org;
      bool over_ref = shoot > ref;
      if (top ^ over_ref) blue.ref.org = blue.shoot.org = (shoot + ref) / 2;
    }
    blue.flags = bs.flags & (BLUE_TOP | BLUE_ADJUSTMENT);
    axis.blues.push_back(blue);
  }
}

bool init_face(Face& F) {
  if (!load(F.f)) return false;
  const Reader& r = F.f.r;
  F.metrics.upem = F.f.upem;
  F.integer_ppem = (r.u16(F.f.head + 16) & 8) != 0;
  if (F.f.os2 && r.u16(F.f.os2) != 0xFFFF)
    F.italic = (r.u16(F.f.os2 + 62) & (1 | 512)) != 0;
  else
    F.italic = (r.u16(F.f.head + 44) & 2) != 0;
  init_widths(F);
  init_blues(F);
  return true;
}

// ----------------------------------------------------------------- sizes
struct SizeMetrics {
  i64 x_scale, y_scale;
  int x_ppem, y_ppem;
};

// FT_Set_Char_Size(face, w, 0, hres, vres): FT_Request_Metrics, then
// tt_size_reset's scales from the rounded ppem where head flags bit 3
SizeMetrics size_metrics(const Face& F, i64 char_w, int hres, int vres) {
  if (char_w < 64) char_w = 64;
  i64 scaled_w = (char_w * hres + 36) / 72;
  i64 scaled_h = (char_w * vres + 36) / 72;
  SizeMetrics s;
  s.x_scale = divfix(scaled_w, F.f.upem);
  s.y_scale = divfix(scaled_h, F.f.upem);
  s.x_ppem = int((scaled_w + 32) >> 6);
  s.y_ppem = int((scaled_h + 32) >> 6);
  if (F.integer_ppem) {
    s.x_scale = divfix(i64(s.x_ppem) << 6, F.f.upem);
    s.y_scale = divfix(i64(s.y_ppem) << 6, F.f.upem);
  }
  return s;
}

// af_latin_metrics_scale_dim for both dimensions; the vertical scale fit
// so that the x-height overshoot lands on the pixel grid
void scale_metrics(LatinMetrics& m, const SizeMetrics& s) {
  for (int dim = 0; dim < 2; ++dim) {
    i64 scale = dim == 0 ? s.x_scale : s.y_scale;
    LatinAxis& axis = m.axis[dim];
    const LatinBlue* blue = nullptr;
    for (const LatinBlue& b : m.axis[1].blues)
      if (b.flags & BLUE_ADJUSTMENT) {
        blue = &b;
        break;
      }
    if (blue) {
      i64 scaled = mulfix(blue->shoot.org, s.y_scale);
      i64 fitted = (scaled + 40) & ~i64(63);
      if (scaled != fitted && dim == 1) scale = muldiv(scale, fitted, scaled);
    }
    axis.scale = scale;
    axis.delta = 0;
    for (AWidth& w : axis.widths) w.cur = w.fit = mulfix(w.org, scale);
    axis.extra_light = mulfix(axis.standard_width, scale) < 32 + 8;
    if (dim == 1) {
      for (LatinBlue& b : axis.blues) {
        b.ref.cur = b.ref.fit = mulfix(b.ref.org, scale);
        b.shoot.cur = b.shoot.fit = mulfix(b.shoot.org, scale);
        b.flags &= ~BLUE_ACTIVE;
        i64 dist = mulfix(b.ref.org - b.shoot.org, scale);
        if (dist <= 48 && dist >= -48) {
          i64 delta2 = iabs(dist);
          if (delta2 < 32) delta2 = 0;
          else if (delta2 < 48) delta2 = 32;
          else delta2 = 64;
          if (dist < 0) delta2 = -delta2;
          b.ref.fit = pix_round(b.ref.cur);
          b.shoot.fit = b.ref.fit - delta2;
          b.flags |= BLUE_ACTIVE;
        }
      }
    }
  }
}

// af_loader_load_g + FT_Load_Glyph's transform: the hinted outline of
// `gid` in 26.6, its x scaled by xx / 65536 afterwards, and its advance
bool load_hinted(Face& F, i64 char_w, int hres, int vres, i64 xx, int gid,
                 Face::Glyph& g) {
  Outline o;
  if (!glyph_units(F.f, gid, o)) return false;
  SizeMetrics sm = size_metrics(F, char_w, hres, vres);
  LatinMetrics m = F.metrics;
  scale_metrics(m, sm);
  Hints h;
  h.upem = m.upem;
  h.x_scale = m.axis[0].scale;
  h.y_scale = m.axis[1].scale;
  h.do_horizontal = !F.italic;
  i64 adv_units = advance_units(F.f, gid);
  i64 pp1x = 0, pp2x = mulfix(adv_units, h.x_scale);
  hints_reload(h, o);
  int n = int(o.pts.size());
  if (n > 0) {
    if (h.do_horizontal) {
      compute_segments(h, m.upem, 0);
      link_segments(h, m.upem, &m.axis[0].widths, 0);
      compute_edges(h, m.axis[0], 0);
    }
    compute_segments(h, m.upem, 1);
    link_segments(h, m.upem, &m.axis[1].widths, 1);
    compute_edges(h, m.axis[1], 1);
    compute_blue_edges(h, m);
    for (int dim = 0; dim < 2; ++dim) {
      if (dim == 0 && !h.do_horizontal) continue;
      hint_edges(h, m, dim);
      align_edge_points(h, dim);
      align_strong_points(h, dim);
      align_weak_points(h, dim);
    }
    // the side bearings after hinting
    Axis& axis = h.axis[0];
    if (axis.num_edges > 1) {
      AEdge* edge1 = &axis.edges[0];
      AEdge* edge2 = &axis.edges[axis.num_edges - 1];
      i64 old_rsb = pp2x - edge2->opos;
      i64 old_lsb = edge1->opos;
      i64 new_lsb = edge1->pos;
      i64 pp1x_uh = new_lsb - old_lsb;
      i64 pp2x_uh = edge2->pos + old_rsb;
      if (old_lsb < 24) pp1x_uh -= 8;
      if (old_rsb < 24) pp2x_uh += 8;
      pp1x = pix_round(pp1x_uh);
      pp2x = pix_round(pp2x_uh);
      if (pp1x >= new_lsb && old_lsb > 0) pp1x -= 64;
      if (pp2x <= edge2->pos && old_rsb > 0) pp2x += 64;
    } else {
      pp1x = pix_round(pp1x);
      pp2x = pix_round(pp2x);
    }
  }
  i64 hadv = adv_units ? pp2x - pp1x : 0;
  hadv = pix_round(hadv);
  g.xy.resize(2 * size_t(n));
  g.tags.resize(n);
  for (int i = 0; i < n; ++i) {
    const APoint& p = h.points[i];
    g.xy[2 * i] = mulfix(p.x - pp1x, xx);
    g.xy[2 * i + 1] = p.y;
    g.tags[i] = (p.flags & FLAG_CONIC) ? 0 : 1;
  }
  g.ends = o.ends;
  g.advance_x = mulfix(hadv, xx);
  return true;
}

const Face::Glyph* glyph(Face& F, i64 char_w, int hres, int vres, i64 xx,
                         int gid) {
  std::lock_guard<std::mutex> lock(F.mu);
  auto key = std::make_tuple(char_w, hres, vres, gid);
  auto it = F.cache.find(key);
  if (it != F.cache.end()) return &it->second;
  Face::Glyph g;
  if (!load_hinted(F, char_w, hres, vres, xx, gid, g)) return nullptr;
  return &(F.cache[key] = std::move(g));
}

// ------------------------------------------------ FreeType 2.6.1 ftgrays
// The smooth rasteriser's cells (24.8), line walk and conic splitting as
// 2.6.1 writes them, into a bitmap of the outline's pixel-aligned cbox.
struct Gray {
  struct Cell { int x; int cover; i64 area; };
  int min_ex, max_ex, min_ey, max_ey, count_ex, count_ey;
  std::vector<std::vector<Cell>> rows;
  i64 area = 0;
  int cover = 0;
  int ex = 0, ey = 0;
  bool invalid = true;
  i64 x = 0, y = 0, last_ey = 0;

  static int trunc(i64 v) { return int(v >> 8); }
  static i64 subpix(i64 v) { return v << 8; }

  void record_cell() {
    if (area | cover) {
      std::vector<Cell>& row = rows[ey];
      auto it = std::lower_bound(row.begin(), row.end(), ex,
                                 [](const Cell& c, int x) { return c.x < x; });
      if (it != row.end() && it->x == ex) {
        it->area += area;
        it->cover += cover;
      } else {
        row.insert(it, Cell{ex, cover, area});
      }
    }
  }
  void set_cell(int nex, int ney) {
    ney -= min_ey;
    if (nex > max_ex) nex = max_ex;
    nex -= min_ex;
    if (nex < 0) nex = -1;
    if (nex != ex || ney != ey) {
      if (!invalid) record_cell();
      area = 0;
      cover = 0;
      ex = nex;
      ey = ney;
    }
    invalid = unsigned(ney) >= unsigned(count_ey) || nex >= count_ex;
  }
  void start_cell(int nex, int ney) {
    if (nex > max_ex) nex = max_ex;
    if (nex < min_ex) nex = min_ex - 1;
    area = 0;
    cover = 0;
    ex = nex - min_ex;
    ey = ney - min_ey;
    last_ey = subpix(ney);
    invalid = false;
    set_cell(nex, ney);
  }
  void render_scanline(int ey_, i64 x1, i64 y1, i64 x2, i64 y2) {
    i64 dx = x2 - x1;
    int ex1 = trunc(x1), ex2 = trunc(x2);
    i64 fx1 = x1 - subpix(ex1), fx2 = x2 - subpix(ex2);
    if (y1 == y2) {
      set_cell(ex2, ey_);
      return;
    }
    if (ex1 == ex2) {
      i64 delta = y2 - y1;
      area += (fx1 + fx2) * delta;
      cover += int(delta);
      return;
    }
    i64 p = (256 - fx1) * (y2 - y1), first = 256;
    int incr = 1;
    if (dx < 0) {
      p = fx1 * (y2 - y1);
      first = 0;
      incr = -1;
      dx = -dx;
    }
    i64 delta = p / dx, mod = p % dx;
    if (mod < 0) {
      --delta;
      mod += dx;
    }
    area += (fx1 + first) * delta;
    cover += int(delta);
    ex1 += incr;
    set_cell(ex1, ey_);
    y1 += delta;
    if (ex1 != ex2) {
      p = 256 * (y2 - y1 + delta);
      i64 lift = p / dx, rem = p % dx;
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
        area += 256 * delta;
        cover += int(delta);
        y1 += delta;
        ex1 += incr;
        set_cell(ex1, ey_);
      }
    }
    delta = y2 - y1;
    area += (fx2 + 256 - first) * delta;
    cover += int(delta);
  }
  void render_line(i64 to_x, i64 to_y) {
    int ey1 = trunc(last_ey), ey2 = trunc(to_y);
    i64 fy1 = y - last_ey, fy2 = to_y - subpix(ey2);
    i64 dx = to_x - x, dy = to_y - y;
    {
      int mn = std::min(ey1, ey2), mx = std::max(ey1, ey2);
      if (mn >= max_ey || mx < min_ey) goto end;
    }
    if (ey1 == ey2) {
      render_scanline(ey1, x, fy1, to_x, fy2);
      goto end;
    }
    {
      int incr = 1;
      if (dx == 0) {
        int ex_ = trunc(x);
        i64 two_fx = (x - subpix(ex_)) << 1;
        i64 first = 256;
        if (dy < 0) {
          first = 0;
          incr = -1;
        }
        i64 delta = first - fy1;
        area += two_fx * delta;
        cover += int(delta);
        ey1 += incr;
        set_cell(ex_, ey1);
        delta = first + first - 256;
        i64 a = two_fx * delta;
        while (ey1 != ey2) {
          area += a;
          cover += int(delta);
          ey1 += incr;
          set_cell(ex_, ey1);
        }
        delta = fy2 - 256 + first;
        area += two_fx * delta;
        cover += int(delta);
        goto end;
      }
      i64 p = (256 - fy1) * dx, first = 256;
      if (dy < 0) {
        p = fy1 * dx;
        first = 0;
        incr = -1;
        dy = -dy;
      }
      i64 delta = p / dy, mod = p % dy;
      if (mod < 0) {
        --delta;
        mod += dy;
      }
      i64 xx = x + delta;
      render_scanline(ey1, x, fy1, xx, first);
      ey1 += incr;
      set_cell(trunc(xx), ey1);
      if (ey1 != ey2) {
        p = 256 * dx;
        i64 lift = p / dy, rem = p % dy;
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
          i64 x2 = xx + delta;
          render_scanline(ey1, xx, 256 - first, x2, first);
          xx = x2;
          ey1 += incr;
          set_cell(trunc(xx), ey1);
        }
      }
      render_scanline(ey1, xx, 256 - first, to_x, fy2);
    }
  end:
    x = to_x;
    y = to_y;
    last_ey = subpix(ey2);
  }
  // gray_split_conic: (x, y) pairs, 0 the end, 1 the control, 2 the
  // start; 2..4 become the first half
  static void split_conic(i64* base) {
    for (int k = 0; k < 2; ++k) {
      i64 a, b;
      base[8 + k] = base[4 + k];
      b = base[2 + k];
      a = base[6 + k] = (base[4 + k] + b) / 2;
      b = base[2 + k] = (base[0 + k] + b) / 2;
      base[4 + k] = (a + b) / 2;
    }
  }
  void render_conic(i64 cx, i64 cy, i64 tx, i64 ty) {
    i64 stack[2 * (32 * 2 + 1)];
    int levels[32];
    i64* arc = stack;
    arc[0] = tx << 2; arc[1] = ty << 2;   // UPSCALE: 26.6 -> 24.8
    arc[2] = cx << 2; arc[3] = cy << 2;
    arc[4] = x; arc[5] = y;
    int top = 0;
    i64 dx = iabs(arc[4] + arc[0] - 2 * arc[2]);
    i64 dy = iabs(arc[5] + arc[1] - 2 * arc[3]);
    if (dx < dy) dx = dy;
    if (dx < 256 / 4) {
      render_line(arc[0], arc[1]);
      return;
    }
    i64 mn = arc[1], mx = arc[1];
    for (int k : {3, 5}) {
      mn = std::min(mn, arc[k]);
      mx = std::max(mx, arc[k]);
    }
    if (trunc(mn) >= max_ey || trunc(mx) < min_ey) {
      render_line(arc[0], arc[1]);
      return;
    }
    int level = 0;
    do {
      dx >>= 2;
      ++level;
    } while (dx > 256 / 4);
    levels[0] = level;
    do {
      level = levels[top];
      if (level > 0) {
        split_conic(arc);
        arc += 4;
        ++top;
        levels[top] = levels[top - 1] = level - 1;
        continue;
      }
      render_line(arc[0], arc[1]);
      --top;
      arc -= 4;
    } while (top >= 0);
  }
  void move_to(i64 tx, i64 ty) {  // 24.8
    if (!invalid) record_cell();
    start_cell(trunc(tx), trunc(ty));
    x = tx;
    y = ty;
  }
};

// FT_Glyph_To_Bitmap(FT_RENDER_MODE_NORMAL) of an outline in 26.6: the
// bitmap of the grid-fitted cbox, its left and top
void render_outline(const std::vector<i64>& xy, const std::vector<uint8_t>& tags,
                    const std::vector<int>& ends, std::vector<uint8_t>& bmp,
                    int* width, int* rows, int* left, int* top) {
  int n = int(tags.size());
  *width = *rows = *left = *top = 0;
  bmp.clear();
  if (n == 0) return;
  i64 x0 = xy[0], x1 = xy[0], y0 = xy[1], y1 = xy[1];
  for (int i = 1; i < n; ++i) {
    x0 = std::min(x0, xy[2 * i]); x1 = std::max(x1, xy[2 * i]);
    y0 = std::min(y0, xy[2 * i + 1]); y1 = std::max(y1, xy[2 * i + 1]);
  }
  x0 = pix_floor(x0); y0 = pix_floor(y0);
  x1 = pix_ceil(x1); y1 = pix_ceil(y1);
  int w = int((x1 - x0) >> 6), h = int((y1 - y0) >> 6);
  *left = int(x0 >> 6);
  *top = int(y1 >> 6);
  *width = w;
  *rows = h;
  if (w <= 0 || h <= 0) return;
  bmp.assign(size_t(w) * h, 0);
  Gray g;
  g.min_ex = 0; g.max_ex = w; g.min_ey = 0; g.max_ey = h;
  g.count_ex = w; g.count_ey = h;
  g.rows.assign(h, {});
  auto P = [&](int i, i64* px, i64* py) {
    *px = xy[2 * i] - x0;
    *py = xy[2 * i + 1] - y0;
  };
  // FT_Outline_Decompose for quadratic contours
  int first = 0;
  for (int last : ends) {
    i64 vsx, vsy, vlx, vly;
    P(first, &vsx, &vsy);
    P(last, &vlx, &vly);
    int start = first;
    bool start_on = tags[first];
    bool skip_last = false;
    if (!start_on) {
      if (tags[last]) {
        vsx = vlx; vsy = vly;
        skip_last = true;
      } else {
        vsx = (vsx + vlx) / 2;
        vsy = (vsy + vly) / 2;
      }
      start = first - 1;
    }
    int limit = skip_last ? last - 1 : last;
    g.move_to(vsx << 2, vsy << 2);
    int i = start;
    while (i < limit) {
      ++i;
      i64 px, py;
      P(i, &px, &py);
      if (tags[i]) {
        g.render_line(px << 2, py << 2);
        continue;
      }
      i64 cx = px, cy = py;
      for (;;) {
        if (i < limit) {
          ++i;
          i64 qx, qy;
          P(i, &qx, &qy);
          if (tags[i]) {
            g.render_conic(cx, cy, qx, qy);
            break;
          }
          i64 mx = (cx + qx) / 2, my = (cy + qy) / 2;
          g.render_conic(cx, cy, mx, my);
          cx = qx;
          cy = qy;
          continue;
        }
        g.render_conic(cx, cy, vsx, vsy);
        goto closed;
      }
    }
    g.render_line(vsx << 2, vsy << 2);
  closed:
    first = last + 1;
  }
  if (!g.invalid) g.record_cell();
  // gray_sweep: coverage of each span, rows bottom-up into a top-down
  // bitmap
  for (int yi = 0; yi < h; ++yi) {
    uint8_t* row = bmp.data() + size_t(h - 1 - yi) * w;
    int cover = 0, x = 0;
    auto hline = [&](int hx, i64 area, int acount) {
      int coverage = int(area >> (8 * 2 + 1 - 8));
      if (coverage < 0) coverage = -coverage;
      if (coverage >= 256) coverage = 255;
      if (!coverage) return;
      if (hx < 0) { acount += hx; hx = 0; }
      for (int k = hx; k < hx + acount && k < w; ++k)
        row[k] = uint8_t(coverage);
    };
    for (const Gray::Cell& c : g.rows[yi]) {
      if (c.x > x && cover != 0) hline(x, i64(cover) * (256 * 2), c.x - x);
      cover += c.cover;
      i64 area = i64(cover) * (256 * 2) - c.area;
      if (area != 0 && c.x >= 0) hline(c.x, area, 1);
      x = c.x + 1;
    }
    if (cover != 0) hline(x, i64(cover) * (256 * 2), g.count_ex - x);
  }
}

}  // namespace

extern "C" {

void* ah_open(const uint8_t* data, long long n) {
  try {
    std::unique_ptr<Face> F(new Face);
    F->f.bytes.assign(data, data + n);
    if (!init_face(*F)) return nullptr;
    return F.release();
  } catch (...) {
    return nullptr;
  }
}

void ah_close(void* h) { delete static_cast<Face*>(h); }

int ah_glyph_index(void* h, unsigned cp) {
  return glyph_of(static_cast<Face*>(h)->f, cp);
}

// The hinted outline of glyph `gid` as FT2Font's load_glyph leaves it at
// set_size(pt, dpi) (char width `char_w` in 26.6, resolutions hres / vres,
// x transform xx): → the point count (-1 on failure); `xy` (2 x cap, 26.6),
// `tags` (1 on-curve), `ends` (cap) and `meta` = {contours, advance.x}.
int ah_load_glyph(void* h, long long char_w, int hres, int vres, long long xx,
                  int gid, long long* xy, unsigned char* tags, int* ends,
                  int cap, long long* meta) {
  try {
    Face& F = *static_cast<Face*>(h);
    const Face::Glyph* g = glyph(F, char_w, hres, vres, xx, gid);
    if (!g) return -1;
    int n = int(g->tags.size());
    if (n > cap || int(g->ends.size()) > cap) return -1;
    for (int i = 0; i < 2 * n; ++i) xy[i] = g->xy[i];
    for (int i = 0; i < n; ++i) tags[i] = g->tags[i];
    for (size_t i = 0; i < g->ends.size(); ++i) ends[i] = g->ends[i];
    meta[0] = (long long)g->ends.size();
    meta[1] = g->advance_x;
    return n;
  } catch (...) {
    return -1;
  }
}

// FT2Font::set_text (angle 0) over `n` glyph ids: the string bbox (xMin,
// yMin, xMax, yMax; 26.6) and the final pen x into `out` (5). → 0, or -1.
int ah_set_text(void* h, long long char_w, int hres, int vres, long long xx,
                const int* gids, int n, long long* out) {
  try {
    Face& F = *static_cast<Face*>(h);
    i64 bx0 = 32000, by0 = 32000, bx1 = -32000, by1 = -32000, pen = 0;
    for (int i = 0; i < n; ++i) {
      const Face::Glyph* g = glyph(F, char_w, hres, vres, xx, gids[i]);
      if (!g) return -1;
      int np = int(g->tags.size());
      i64 cx0 = 0, cy0 = 0, cx1 = 0, cy1 = 0;
      for (int k = 0; k < np; ++k) {
        i64 px = g->xy[2 * k] + pen, py = g->xy[2 * k + 1];
        if (k == 0) { cx0 = cx1 = px; cy0 = cy1 = py; }
        cx0 = std::min(cx0, px); cx1 = std::max(cx1, px);
        cy0 = std::min(cy0, py); cy1 = std::max(cy1, py);
      }
      bx0 = std::min(bx0, cx0); bx1 = std::max(bx1, cx1);
      by0 = std::min(by0, cy0); by1 = std::max(by1, cy1);
      pen += g->advance_x;
    }
    if (bx0 > bx1) bx0 = by0 = bx1 = by1 = 0;
    out[0] = bx0; out[1] = by0; out[2] = bx1; out[3] = by1; out[4] = pen;
    return 0;
  } catch (...) {
    return -1;
  }
}

// FT2Font::draw_glyphs_to_bitmap (antialiased) after ah_set_text with the
// same arguments: into `image` (rows x cols, zeroed by the caller), each
// glyph rendered at its pen and OR-ed in. → 0, or -1.
int ah_draw_text(void* h, long long char_w, int hres, int vres, long long xx,
                 const int* gids, int n, const long long* bbox,
                 unsigned char* image, int rows, int cols) {
  try {
    Face& F = *static_cast<Face*>(h);
    i64 pen = 0;
    std::vector<uint8_t> bmp;
    for (int i = 0; i < n; ++i) {
      const Face::Glyph* g = glyph(F, char_w, hres, vres, xx, gids[i]);
      if (!g) return -1;
      std::vector<i64> moved(g->xy);
      for (size_t k = 0; k < moved.size(); k += 2) moved[k] += pen;
      pen += g->advance_x;
      int w, hh, left, top;
      render_outline(moved, g->tags, g->ends, bmp, &w, &hh, &left, &top);
      int x = int(left - bbox[0] * (1. / 64.));
      int y = int(bbox[3] * (1. / 64.) - top + 1);
      int x1 = std::min(std::max(x, 0), cols);
      int y1 = std::min(std::max(y, 0), rows);
      int x2 = std::min(std::max(x + w, 0), cols);
      int y2 = std::min(std::max(y + hh, 0), rows);
      int x_start = std::max(0, -x);
      int y_offset = y1 - std::max(0, -y);
      for (int r = y1; r < y2; ++r) {
        uint8_t* dst = image + size_t(r) * cols + x1;
        const uint8_t* src = bmp.data() + size_t(r - y_offset) * w + x_start;
        for (int c = x1; c < x2; ++c) *dst++ |= *src++;
      }
    }
    return 0;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
