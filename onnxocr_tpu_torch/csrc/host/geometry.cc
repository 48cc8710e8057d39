// Host-side geometry kernels for DB postprocessing.
//
// Replaces the third-party native dependencies the reference leans on for
// box extraction (onnxocr/db_postprocess.py:104-180): OpenCV findContours /
// minAreaRect and pyclipper's round-join polygon offset. Own copy of
// onnxocr_tpu/runtime/native/geometry.cc, loaded from Python via ctypes
// (onnxocr_tpu_torch/ops/native.py); the numpy implementations in
// onnxocr_tpu_torch/ops/geometry.py are the plain versions.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// ---------------------------------------------------------------- contours
// Suzuki-Abe border following (the algorithm behind cv2.findContours),
// RETR_LIST semantics: every outer border and hole border is emitted.
// 8-connectivity. Coordinates are (x, y).

// clockwise neighbor ring starting east
const int DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int DY[8] = {0, 1, 1, 1, 0, -1, -1, -1};

}  // namespace

extern "C" {

// bitmap: h*w uint8 (0/nonzero). Emits contours as a flat (x, y) int32
// array; lens[i] = number of points in contour i. Returns the number of
// contours (or -1 on overflow).
//
// min_bbox_area / max_index (filtered variant): a traced contour is
// emitted only when (ptp_x * ptp_y) >= min_bbox_area — the exact DB
// speckle prefilter (min-area-rect sside <= sqrt(bbox area)) — and
// tracing stops once max_index contours have been TRACED (emitted or
// not), preserving the reference's `contours[:max_candidates]` slice
// semantics by ORIGINAL raster index. Noisy prob maps produce thousands
// of 1-2 px speckle contours; filtering here keeps them out of the
// Python loop and out of the output capacity.
static int trace_contours(const uint8_t* bitmap, int h, int w,
                          int32_t* out_pts, int32_t* out_lens,
                          int max_points, int max_contours,
                          double min_bbox_area, long long max_index) {
  // f: signed labels per Suzuki-Abe. Pad by 1 pixel border of zeros.
  const int W = w + 2, H = h + 2;
  std::vector<int> f(static_cast<size_t>(W) * H, 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      if (bitmap[y * w + x]) f[(y + 1) * W + (x + 1)] = 1;

  int nbd = 1;
  int n_contours = 0;
  int n_points = 0;
  long long traced = 0;

  auto at = [&](int x, int y) -> int& { return f[y * W + x]; };

  // emit-or-rewind after a contour finishes tracing; returns false when
  // the traced-index budget is exhausted
  auto finish = [&](int contour_start) -> bool {
    ++traced;
    int minx = out_pts[2 * contour_start], maxx = minx;
    int miny = out_pts[2 * contour_start + 1], maxy = miny;
    for (int i = contour_start + 1; i < n_points; ++i) {
      int px = out_pts[2 * i], py = out_pts[2 * i + 1];
      if (px < minx) minx = px;
      if (px > maxx) maxx = px;
      if (py < miny) miny = py;
      if (py > maxy) maxy = py;
    }
    double area = double(maxx - minx) * double(maxy - miny);
    if (area >= min_bbox_area)
      out_lens[n_contours++] = n_points - contour_start;
    else
      n_points = contour_start;  // rewind: filtered out
    return traced < max_index;
  };

  for (int y = 1; y <= h; ++y) {
    int lnbd = 1;
    for (int x = 1; x <= w; ++x) {
      int fv = at(x, y);
      if (fv == 0) continue;
      bool outer = (fv == 1 && at(x - 1, y) == 0);
      bool hole = (fv >= 1 && at(x + 1, y) == 0);
      if (!outer && !hole) {
        if (fv != 1) lnbd = fv < 0 ? -fv : fv;
        continue;
      }
      ++nbd;
      // starting direction: outer borders look west (index 4), holes east (0)
      int dir_from = outer ? 4 : 0;

      if (n_contours >= max_contours) return n_contours;
      int contour_start = n_points;

      // find first nonzero neighbor clockwise from dir_from
      int i0 = -1;
      for (int k = 0; k < 8; ++k) {
        int d = (dir_from + k) % 8;
        if (at(x + DX[d], y + DY[d]) != 0) {
          i0 = d;
          break;
        }
      }
      if (i0 < 0) {
        // isolated pixel
        if (n_points + 1 > max_points) return -1;
        out_pts[2 * n_points] = x - 1;
        out_pts[2 * n_points + 1] = y - 1;
        ++n_points;
        at(x, y) = -nbd;
        if (!finish(contour_start)) return n_contours;
        if (fv != 1) lnbd = fv < 0 ? -fv : fv;
        continue;
      }

      // border following
      int cx = x, cy = y;          // current border pixel
      int px = x + DX[i0], py = y + DY[i0];  // previous neighbor (i2 in paper)
      int first_x = cx, first_y = cy;
      int second_x = -1, second_y = -1;
      bool first_iter = true;
      while (true) {
        // search counter-clockwise from the previous neighbor for the next
        // nonzero neighbor of (cx, cy)
        int start_dir = 0;
        for (int d = 0; d < 8; ++d)
          if (cx + DX[d] == px && cy + DY[d] == py) {
            start_dir = d;
            break;
          }
        int nx = -1, ny = -1;
        bool passed_east_zero = false;
        for (int k = 1; k <= 8; ++k) {
          int d = (start_dir - k + 16) % 8;  // counter-clockwise
          int tx = cx + DX[d], ty = cy + DY[d];
          if (at(tx, ty) != 0) {
            nx = tx;
            ny = ty;
            break;
          }
          if (d == 0) passed_east_zero = true;  // east neighbor examined & 0
        }
        // mark
        if (passed_east_zero)
          at(cx, cy) = -nbd;
        else if (at(cx, cy) == 1)
          at(cx, cy) = nbd;
        // emit point
        if (n_points + 1 > max_points) return -1;
        out_pts[2 * n_points] = cx - 1;
        out_pts[2 * n_points + 1] = cy - 1;
        ++n_points;

        if (nx < 0) break;  // isolated (shouldn't happen here)
        if (first_iter) {
          second_x = nx;
          second_y = ny;
          first_iter = false;
        } else if (cx == first_x && cy == first_y && nx == second_x &&
                   ny == second_y) {
          // returned to start and repeating: done (drop the duplicate point)
          --n_points;
          break;
        }
        px = cx;
        py = cy;
        cx = nx;
        cy = ny;
        if (n_points - contour_start > 4 * (h * w)) break;  // safety
      }
      if (!finish(contour_start)) return n_contours;
      if (fv != 1) lnbd = fv < 0 ? -fv : fv;
      (void)lnbd;
    }
  }
  return n_contours;
}

int ocr_find_contours(const uint8_t* bitmap, int h, int w, int32_t* out_pts,
                      int32_t* out_lens, int max_points, int max_contours) {
  return trace_contours(bitmap, h, w, out_pts, out_lens, max_points,
                        max_contours, -1.0, (1LL << 60));
}

int ocr_find_contours_filtered(const uint8_t* bitmap, int h, int w,
                               int32_t* out_pts, int32_t* out_lens,
                               int max_points, int max_contours,
                               double min_bbox_area, long long max_index) {
  return trace_contours(bitmap, h, w, out_pts, out_lens, max_points,
                        max_contours, min_bbox_area, max_index);
}

// ------------------------------------------------------------ minAreaRect
// pts: n (x, y) float pairs. out: cx, cy, w, h, angle_degrees — cv2
// convention (angle in (0, 90]).
void ocr_min_area_rect(const float* pts, int n, float* out) {
  std::vector<Pt> p(n);
  for (int i = 0; i < n; ++i) p[i] = {pts[2 * i], pts[2 * i + 1]};
  // dedup + lexicographic sort
  std::sort(p.begin(), p.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  p.erase(std::unique(p.begin(), p.end(),
                      [](const Pt& a, const Pt& b) {
                        return a.x == b.x && a.y == b.y;
                      }),
          p.end());
  n = static_cast<int>(p.size());
  auto cross = [](const Pt& o, const Pt& a, const Pt& b) {
    return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
  };
  std::vector<Pt> hull;
  if (n <= 2) {
    hull = p;
  } else {
    hull.resize(2 * n);
    int k = 0;
    for (int i = 0; i < n; ++i) {
      while (k >= 2 && cross(hull[k - 2], hull[k - 1], p[i]) <= 0) --k;
      hull[k++] = p[i];
    }
    int lower = k + 1;
    for (int i = n - 2; i >= 0; --i) {
      while (k >= lower && cross(hull[k - 2], hull[k - 1], p[i]) <= 0) --k;
      hull[k++] = p[i];
    }
    hull.resize(k - 1);
  }
  int m = static_cast<int>(hull.size());
  if (m == 0) {
    out[0] = out[1] = out[2] = out[3] = out[4] = 0;
    return;
  }
  if (m == 1) {
    out[0] = hull[0].x;
    out[1] = hull[0].y;
    out[2] = out[3] = 0;
    out[4] = 90.0f;
    return;
  }
  double best_area = 1e300, best_theta = 0, best_w = 0, best_h = 0,
         best_cx = 0, best_cy = 0;
  for (int i = 0; i < m; ++i) {
    Pt e = {hull[(i + 1) % m].x - hull[i].x, hull[(i + 1) % m].y - hull[i].y};
    double len = std::hypot(e.x, e.y);
    if (len < 1e-12) continue;
    double theta = std::fmod(std::atan2(e.y, e.x), M_PI / 2);
    if (theta < 0) theta += M_PI / 2;
    double c = std::cos(theta), s = std::sin(theta);
    double minu = 1e300, maxu = -1e300, minv = 1e300, maxv = -1e300;
    for (const Pt& q : hull) {
      double u = c * q.x + s * q.y;
      double v = -s * q.x + c * q.y;
      minu = std::min(minu, u);
      maxu = std::max(maxu, u);
      minv = std::min(minv, v);
      maxv = std::max(maxv, v);
    }
    double area = (maxu - minu) * (maxv - minv);
    if (area < best_area - 1e-12) {
      best_area = area;
      best_theta = theta;
      best_w = maxu - minu;
      best_h = maxv - minv;
      double cu = (minu + maxu) / 2, cv = (minv + maxv) / 2;
      best_cx = c * cu - s * cv;
      best_cy = s * cu + c * cv;
    }
  }
  double angle = best_theta * 180.0 / M_PI;
  if (angle == 0.0) {
    angle = 90.0;
    std::swap(best_w, best_h);
  }
  out[0] = static_cast<float>(best_cx);
  out[1] = static_cast<float>(best_cy);
  out[2] = static_cast<float>(best_w);
  out[3] = static_cast<float>(best_h);
  out[4] = static_cast<float>(angle);
}

// ----------------------------------------------------------- round offset
// Outward offset with round joins (pyclipper JT_ROUND equivalent for the
// convex quads DB feeds it). poly: n (x, y) doubles; out: up to max_out
// points. Returns point count (or -1 on overflow).
int ocr_offset_polygon(const double* poly, int n, double distance,
                       double* out, int max_out) {
  if (n < 3 || distance <= 0) {
    if (n > max_out) return -1;
    std::memcpy(out, poly, sizeof(double) * 2 * n);
    return n;
  }
  std::vector<Pt> pts(n);
  for (int i = 0; i < n; ++i) pts[i] = {poly[2 * i], poly[2 * i + 1]};
  // ensure CCW (shoelace > 0)
  double area2 = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& a = pts[i];
    const Pt& b = pts[(i + 1) % n];
    area2 += a.x * b.y - b.x * a.y;
  }
  if (area2 < 0) std::reverse(pts.begin(), pts.end());

  const double arc_tol = 0.25;
  double steps_per_circle =
      std::max(6.0, M_PI / std::acos(std::max(
                        -1.0, std::min(1.0, 1 - arc_tol /
                                                std::max(distance, 1e-9)))));
  int count = 0;
  auto emit = [&](double x, double y) -> bool {
    if (count >= max_out) return false;
    out[2 * count] = x;
    out[2 * count + 1] = y;
    ++count;
    return true;
  };
  for (int i = 0; i < n; ++i) {
    Pt pp = pts[(i - 1 + n) % n];
    Pt p = pts[i];
    Pt pn = pts[(i + 1) % n];
    Pt e0 = {p.x - pp.x, p.y - pp.y};
    Pt e1 = {pn.x - p.x, pn.y - p.y};
    double l0 = std::max(std::hypot(e0.x, e0.y), 1e-12);
    double l1 = std::max(std::hypot(e1.x, e1.y), 1e-12);
    Pt n0 = {e0.y / l0, -e0.x / l0};
    Pt n1 = {e1.y / l1, -e1.x / l1};
    double cross_z = e0.x * e1.y - e0.y * e1.x;
    if (cross_z >= 0) {
      double a0 = std::atan2(n0.y, n0.x);
      double a1 = std::atan2(n1.y, n1.x);
      double da = a1 - a0;
      while (da > M_PI) da -= 2 * M_PI;
      while (da < -M_PI) da += 2 * M_PI;
      int steps = std::max(
          1, static_cast<int>(
                 std::ceil(std::fabs(da) * steps_per_circle / (2 * M_PI))));
      for (int k = 0; k <= steps; ++k) {
        double ang = a0 + da * k / steps;
        if (!emit(p.x + distance * std::cos(ang),
                  p.y + distance * std::sin(ang)))
          return -1;
      }
    } else {
      Pt q0 = {p.x + n0.x * distance, p.y + n0.y * distance};
      Pt q1 = {p.x + n1.x * distance, p.y + n1.y * distance};
      Pt d0 = {e0.x / l0, e0.y / l0};
      Pt d1 = {e1.x / l1, e1.y / l1};
      double denom = d0.x * d1.y - d0.y * d1.x;
      if (std::fabs(denom) < 1e-12) {
        if (!emit(q0.x, q0.y) || !emit(q1.x, q1.y)) return -1;
      } else {
        double dx = q1.x - q0.x, dy = q1.y - q0.y;
        double t = (dx * d1.y - dy * d1.x) / denom;
        if (!emit(q0.x + d0.x * t, q0.y + d0.y * t)) return -1;
      }
    }
  }
  return count;
}

// Mean of prob inside an n-vertex polygon (DB box_score_fast/slow,
// onnxocr/db_postprocess.py:182-218). Even-odd pixel-center test with
// int-truncated vertices, mirroring ops/geometry.py fill_poly_mask so the
// native and numpy paths score identically.
double ocr_box_score(const float* prob, int h, int w, const double* poly,
                     int n) {
  if (n < 3) return 0.0;
  double minx = poly[0], maxx = poly[0], miny = poly[1], maxy = poly[1];
  for (int i = 1; i < n; ++i) {
    minx = std::min(minx, poly[2 * i]);
    maxx = std::max(maxx, poly[2 * i]);
    miny = std::min(miny, poly[2 * i + 1]);
    maxy = std::max(maxy, poly[2 * i + 1]);
  }
  int xmin = std::min(std::max(static_cast<int>(std::floor(minx)), 0), w - 1);
  int xmax = std::min(std::max(static_cast<int>(std::ceil(maxx)), 0), w - 1);
  int ymin = std::min(std::max(static_cast<int>(std::floor(miny)), 0), h - 1);
  int ymax = std::min(std::max(static_cast<int>(std::ceil(maxy)), 0), h - 1);
  if (xmax < xmin || ymax < ymin) return 0.0;

  // shifted, int-truncated vertices (numpy .astype(int32) semantics)
  std::vector<double> vx(n), vy(n);
  for (int i = 0; i < n; ++i) {
    vx[i] = static_cast<double>(static_cast<int>(poly[2 * i] - xmin));
    vy[i] = static_cast<double>(static_cast<int>(poly[2 * i + 1] - ymin));
  }

  double sum = 0.0;
  long count = 0;
  for (int y = ymin; y <= ymax; ++y) {
    double py = y - ymin;
    // collect crossings for this scanline (even-odd rule)
    for (int x = xmin; x <= xmax; ++x) {
      double px = x - xmin;
      bool inside = false;
      int j = n - 1;
      for (int i = 0; i < n; ++i) {
        if ((vy[i] > py) != (vy[j] > py)) {
          double xints =
              (vx[j] - vx[i]) * (py - vy[i]) / (vy[j] - vy[i]) + vx[i];
          if (px < xints) inside = !inside;
        }
        j = i;
      }
      if (inside) {
        sum += prob[y * w + x];
        ++count;
      }
    }
  }
  return count ? sum / count : 0.0;
}

}  // extern "C"
