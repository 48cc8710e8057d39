// cv2.remap(src, map_x, map_y, INTER_CUBIC, BORDER_REPLICATE) on a uint8
// image with float32 maps, as cv2 5.0 computes it on a host with AVX2 and
// FMA (its SSE-only kernels round some values the other way). The sampler
// of utils/cv_ops.remap_cubic and warp_perspective_cubic (the host crops).
//
// Every step is a float32 operation in cv2's order, an FMA where cv2 fuses
// one (std::fma: correctly rounded whether or not the CPU has the
// instruction). Built at first use by ops/native.py: g++ -std=c++17
// -shared -fPIC -O2 -ffp-contract=off (no product and sum may be fused
// beyond those).

#include <cmath>
#include <cstdint>

namespace {

const float A = -0.75f;

// cv2 5.0's cubic weights at the fraction t, s = 1 - t: a·t·s², the FMA
// polynomial ((a + 2)·t − (a + 3))·t² + 1, a·t²·s, and 1 less the other
// three
inline void weights(float t, float w[4]) {
  const float s = 1.0f - t, t2 = t * t;
  w[0] = A * (t * (s * s));
  w[1] = std::fma(std::fma(A + 2.0f, t, -(A + 3.0f)), t2, 1.0f);
  w[3] = A * (t2 * s);
  w[2] = 1.0f - w[0] - w[1] - w[3];
}

// a position clamped to [-k, 2k], k = max(n, 16), NaN to -k
inline float clamp_position(float v, int n) {
  const float k = static_cast<float>(n > 16 ? n : 16);
  if (std::isnan(v)) return -k;
  return v < -k ? -k : (v > 2.0f * k ? 2.0f * k : v);
}

inline int clamp_index(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

}  // namespace

extern "C" void ocr_remap_cubic(const uint8_t* src, int h, int w, int c,
                                const float* map_x, const float* map_y,
                                int64_t n, uint8_t* out) {
  for (int64_t p = 0; p < n; ++p) {
    const float x = clamp_position(map_x[p], w);
    const float y = clamp_position(map_y[p], h);
    const float x0 = std::floor(x), y0 = std::floor(y);
    float wx[4], wy[4];
    weights(x - x0, wx);
    weights(y - y0, wy);
    int cols[4], rows[4];
    for (int k = 0; k < 4; ++k) {
      cols[k] = clamp_index(static_cast<int>(x0) - 1 + k, w) * c;
      rows[k] = clamp_index(static_cast<int>(y0) - 1 + k, h);
    }
    for (int ch = 0; ch < c; ++ch) {
      float sum = 0.0f;
      for (int j = 0; j < 4; ++j) {
        const uint8_t* row = src + static_cast<int64_t>(rows[j]) * w * c + ch;
        // the row from the left: its first term a product, then FMAs
        float acc = static_cast<float>(row[cols[0]]) * wx[0];
        for (int k = 1; k < 4; ++k)
          acc = std::fma(static_cast<float>(row[cols[k]]), wx[k], acc);
        // the rows from the top the same way
        sum = j == 0 ? acc * wy[0] : std::fma(acc, wy[j], sum);
      }
      // saturate_cast<uchar>: round half to even, then clamp
      const float r = std::nearbyint(sum);
      out[p * c + ch] = static_cast<uint8_t>(r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r));
    }
  }
}
