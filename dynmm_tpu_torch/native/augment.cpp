// dynmm_tpu native preprocessing kernels.
//
// Host-side hot loop of the RGB-D input pipeline (resize / normalize /
// flip), built as a small shared library and bound via ctypes. The reference
// runs this path through cv2 inside 32 torch DataLoader worker processes
// (prepare_data.py:146); here one OpenMP-parallel C++ pass per sample keeps
// the TPU fed without a process pool.
//
// Interpolation semantics match OpenCV (the reference's cv2 calls, which the
// published mIoU numbers depend on):
//  * bilinear: half-pixel centers, src = (dst + 0.5) * scale - 0.5, edge clamp
//  * nearest:  src = floor(dst * scale), edge clamp
//
// All buffers are contiguous row-major (H, W, C) float32 or int32.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// ---------------------------------------------------------------- bilinear
void resize_bilinear_f32(const float* src, int sh, int sw, int c,
                         float* dst, int dh, int dw) {
  const double scale_y = static_cast<double>(sh) / dh;
  const double scale_x = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < dh; ++dy) {
    double fy = (dy + 0.5) * scale_y - 0.5;
    int y0 = static_cast<int>(std::floor(fy));
    double wy = fy - y0;
    int y1 = y0 + 1;
    y0 = std::clamp(y0, 0, sh - 1);
    y1 = std::clamp(y1, 0, sh - 1);
    for (int dx = 0; dx < dw; ++dx) {
      double fx = (dx + 0.5) * scale_x - 0.5;
      int x0 = static_cast<int>(std::floor(fx));
      double wx = fx - x0;
      int x1 = x0 + 1;
      x0 = std::clamp(x0, 0, sw - 1);
      x1 = std::clamp(x1, 0, sw - 1);
      const float* p00 = src + (static_cast<int64_t>(y0) * sw + x0) * c;
      const float* p01 = src + (static_cast<int64_t>(y0) * sw + x1) * c;
      const float* p10 = src + (static_cast<int64_t>(y1) * sw + x0) * c;
      const float* p11 = src + (static_cast<int64_t>(y1) * sw + x1) * c;
      float* out = dst + (static_cast<int64_t>(dy) * dw + dx) * c;
      for (int ch = 0; ch < c; ++ch) {
        double top = p00[ch] * (1.0 - wx) + p01[ch] * wx;
        double bot = p10[ch] * (1.0 - wx) + p11[ch] * wx;
        out[ch] = static_cast<float>(top * (1.0 - wy) + bot * wy);
      }
    }
  }
}

// ----------------------------------------------------------------- nearest
void resize_nearest_f32(const float* src, int sh, int sw, int c,
                        float* dst, int dh, int dw) {
  const double scale_y = static_cast<double>(sh) / dh;
  const double scale_x = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < dh; ++dy) {
    int sy = std::min(static_cast<int>(std::floor(dy * scale_y)), sh - 1);
    for (int dx = 0; dx < dw; ++dx) {
      int sx = std::min(static_cast<int>(std::floor(dx * scale_x)), sw - 1);
      const float* in = src + (static_cast<int64_t>(sy) * sw + sx) * c;
      float* out = dst + (static_cast<int64_t>(dy) * dw + dx) * c;
      for (int ch = 0; ch < c; ++ch) out[ch] = in[ch];
    }
  }
}

void resize_nearest_i32(const int32_t* src, int sh, int sw, int c,
                        int32_t* dst, int dh, int dw) {
  const double scale_y = static_cast<double>(sh) / dh;
  const double scale_x = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int dy = 0; dy < dh; ++dy) {
    int sy = std::min(static_cast<int>(std::floor(dy * scale_y)), sh - 1);
    for (int dx = 0; dx < dw; ++dx) {
      int sx = std::min(static_cast<int>(std::floor(dx * scale_x)), sw - 1);
      const int32_t* in = src + (static_cast<int64_t>(sy) * sw + sx) * c;
      int32_t* out = dst + (static_cast<int64_t>(dy) * dw + dx) * c;
      for (int ch = 0; ch < c; ++ch) out[ch] = in[ch];
    }
  }
}

// ----------------------------------------------------- fused rgb normalize
// (x / 255 - mean) / std per channel, optionally horizontally flipped.
void normalize_rgb_f32(const float* src, int h, int w,
                       const float* mean, const float* stddev, int flip,
                       float* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int sx = flip ? (w - 1 - x) : x;
      const float* in = src + (static_cast<int64_t>(y) * w + sx) * 3;
      float* out = dst + (static_cast<int64_t>(y) * w + x) * 3;
      for (int ch = 0; ch < 3; ++ch)
        out[ch] = (in[ch] / 255.0f - mean[ch]) / stddev[ch];
    }
  }
}

// depth z-score; if keep_zeros != 0, zero (invalid) pixels stay zero.
void normalize_depth_f32(const float* src, int h, int w, float mean,
                         float stddev, int keep_zeros, int flip, float* dst) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int sx = flip ? (w - 1 - x) : x;
      float v = src[static_cast<int64_t>(y) * w + sx];
      float out = (v - mean) / stddev;
      if (keep_zeros && v == 0.0f) out = 0.0f;
      dst[static_cast<int64_t>(y) * w + x] = out;
    }
  }
}

// ------------------------------------------------------- space-to-depth
// 2x2 space-to-depth packing for the serving input pipeline: (N, H, W, C)
// -> (N, H/2, W/2, 4C) with channel order (row parity, col parity, c),
// layout-identical to models/resnet.py::space_to_depth_host (whose numpy
// transpose costs ~23 ms for a bs=8 480x640 rgb+depth batch -- more than
// the 10.5 ms device step it feeds). Memory-bound strided copy; parallel
// over output rows.
void space_to_depth_f32(const float* src, int n, int h, int w, int c,
                        float* dst) {
  const int oh = h / 2, ow = w / 2;
  const int64_t in_img = static_cast<int64_t>(h) * w * c;
  const int64_t out_img = static_cast<int64_t>(oh) * ow * 4 * c;
#pragma omp parallel for schedule(static) collapse(2)
  for (int img = 0; img < n; ++img) {
    for (int y = 0; y < oh; ++y) {
      const float* r0 = src + img * in_img + static_cast<int64_t>(2 * y) * w * c;
      const float* r1 = r0 + static_cast<int64_t>(w) * c;
      float* out = dst + img * out_img + static_cast<int64_t>(y) * ow * 4 * c;
      for (int x = 0; x < ow; ++x) {
        const float* p00 = r0 + static_cast<int64_t>(2 * x) * c;
        float* o = out + static_cast<int64_t>(x) * 4 * c;
        for (int ch = 0; ch < c; ++ch) o[ch] = p00[ch];
        for (int ch = 0; ch < c; ++ch) o[c + ch] = p00[c + ch];
        const float* p10 = r1 + static_cast<int64_t>(2 * x) * c;
        for (int ch = 0; ch < c; ++ch) o[2 * c + ch] = p10[ch];
        for (int ch = 0; ch < c; ++ch) o[3 * c + ch] = p10[c + ch];
      }
    }
  }
}

}  // extern "C"
