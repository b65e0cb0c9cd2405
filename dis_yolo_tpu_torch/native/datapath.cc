// Native host data-path kernels for dis_yolo_tpu_torch (a copy of the JAX
// package's datapath.cc; the port imports nothing of that package).
//
// The reference's data pipeline is pure Python (cv2/skimage/numpy) and was
// its training bottleneck (SURVEY.md §3.1: per-epoch polygon rasterization
// on the hot path).  These C kernels implement the same documented
// semantics as dis_yolo_tpu_torch/data/rasterize.py (even-odd scanline fill over
// pixel centers + boundary-inclusive outline) and augment.resize_bilinear
// (half-pixel-center bilinear, cv2.INTER_LINEAR-compatible), exposed via a
// plain C ABI for ctypes.
//
// Built by native/__init__.py with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Even-odd scanline polygon fill + boundary outline, matching
// rasterize.fill_polygon_scanline / _draw_edges semantics exactly.
// xs/ys: n vertices (float64). out: h*w uint8 mask, OR-accumulated (callers
// zero it first; holes are handled by the caller like the Python path).
void fill_polygon(const double* xs, const double* ys, int64_t n,
                  uint8_t* out, int64_t h, int64_t w) {
  if (n < 3) return;
  double ymin = ys[0], ymax = ys[0];
  for (int64_t i = 1; i < n; ++i) {
    ymin = std::min(ymin, ys[i]);
    ymax = std::max(ymax, ys[i]);
  }
  int64_t y0 = std::max<int64_t>((int64_t)std::floor(ymin), 0);
  int64_t y1 = std::min<int64_t>((int64_t)std::ceil(ymax), h - 1);

  std::vector<double> xcross;
  xcross.reserve(16);
  for (int64_t r = y0; r <= y1; ++r) {
    xcross.clear();
    for (int64_t i = 0; i < n; ++i) {
      int64_t j = (i + 1 == n) ? 0 : i + 1;
      double yi = ys[i], yj = ys[j];
      bool c1 = (yi <= r) && (yj > r);
      bool c2 = (yj <= r) && (yi > r);
      if (!(c1 || c2)) continue;
      double t = (r - yi) / (yj - yi);
      xcross.push_back(xs[i] + t * (xs[j] - xs[i]));
    }
    std::sort(xcross.begin(), xcross.end());
    for (size_t i = 0; i + 1 < xcross.size(); i += 2) {
      int64_t a = std::max<int64_t>((int64_t)std::ceil(xcross[i]), 0);
      int64_t b = std::min<int64_t>((int64_t)std::floor(xcross[i + 1]), w - 1);
      if (b >= a) std::memset(out + r * w + a, 1, (size_t)(b - a + 1));
    }
  }

  // boundary-inclusive outline (same sampling as rasterize._draw_edges:
  // n_steps = max(|dx|,|dy|)+1 intervals, endpoints rounded half-to-even)
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = (i + 1 == n) ? 0 : i + 1;
    double dx = xs[j] - xs[i], dy = ys[j] - ys[i];
    int64_t steps = (int64_t)std::max(std::fabs(dx), std::fabs(dy)) + 1;
    for (int64_t s = 0; s <= steps; ++s) {
      double t = (double)s / (double)steps;
      // nearbyint with default rounding mode = ties-to-even (np.round)
      int64_t px = (int64_t)std::nearbyint(xs[i] + t * dx);
      int64_t py = (int64_t)std::nearbyint(ys[i] + t * dy);
      px = std::min(std::max(px, (int64_t)0), w - 1);
      py = std::min(std::max(py, (int64_t)0), h - 1);
      out[py * w + px] = 1;
    }
  }
}

// Subtract a hole polygon: clears the filled interior+outline region, then
// the caller re-draws the rim (parity with instance_mask's 'in' handling
// is done in Python by composing fill_polygon calls).
void clear_polygon(const double* xs, const double* ys, int64_t n,
                   uint8_t* mask, int64_t h, int64_t w) {
  std::vector<uint8_t> tmp((size_t)(h * w), 0);
  fill_polygon(xs, ys, n, tmp.data(), h, w);
  for (int64_t i = 0; i < h * w; ++i)
    if (tmp[i]) mask[i] = 0;
}

// Half-pixel-center bilinear resize, float32 HWC (cv2.INTER_LINEAR
// compatible up to border clamping).
void resize_bilinear_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                         float* dst, int64_t dh, int64_t dw) {
  const double sy = (double)sh / dh, sx = (double)sw / dw;
  for (int64_t y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int64_t y0 = (int64_t)std::floor(fy);
    double wy = fy - y0;
    if (y0 < 0) { y0 = 0; wy = 0.0; }
    int64_t y1 = std::min(y0 + 1, sh - 1);
    if (y0 > sh - 1) { y0 = sh - 1; wy = 0.0; }
    for (int64_t x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int64_t x0 = (int64_t)std::floor(fx);
      double wx = fx - x0;
      if (x0 < 0) { x0 = 0; wx = 0.0; }
      int64_t x1 = std::min(x0 + 1, sw - 1);
      if (x0 > sw - 1) { x0 = sw - 1; wx = 0.0; }
      const float* p00 = src + (y0 * sw + x0) * c;
      const float* p01 = src + (y0 * sw + x1) * c;
      const float* p10 = src + (y1 * sw + x0) * c;
      const float* p11 = src + (y1 * sw + x1) * c;
      float* d = dst + (y * dw + x) * c;
      for (int64_t k = 0; k < c; ++k) {
        double top = p00[k] * (1.0 - wx) + p01[k] * wx;
        double bot = p10[k] * (1.0 - wx) + p11[k] * wx;
        d[k] = (float)(top * (1.0 - wy) + bot * wy);
      }
    }
  }
}

// Letterbox: resize into (new_h, new_w) then paste at (dy, dx) of a
// pad-filled (net_h, net_w) canvas — the whole val/test image prep
// (val_data.py:36-63) in one native call.
void letterbox_f32(const float* src, int64_t sh, int64_t sw, int64_t c,
                   float* dst, int64_t net_h, int64_t net_w,
                   int64_t new_h, int64_t new_w, int64_t dy, int64_t dx,
                   float pad_value) {
  for (int64_t i = 0; i < net_h * net_w * c; ++i) dst[i] = pad_value;
  std::vector<float> tmp((size_t)(new_h * new_w * c));
  resize_bilinear_f32(src, sh, sw, c, tmp.data(), new_h, new_w);
  for (int64_t y = 0; y < new_h; ++y) {
    int64_t ty = y + dy;
    if (ty < 0 || ty >= net_h) continue;
    int64_t x_lo = std::max<int64_t>(0, -dx);
    int64_t x_hi = std::min<int64_t>(new_w, net_w - dx);
    if (x_hi <= x_lo) continue;
    std::memcpy(dst + (ty * net_w + (x_lo + dx)) * c,
                tmp.data() + (y * new_w + x_lo) * c,
                (size_t)(x_hi - x_lo) * c * sizeof(float));
  }
}

}  // extern "C"
