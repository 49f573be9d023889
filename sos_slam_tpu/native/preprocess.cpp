// Native host-side frame preprocessing.
//
// The reference's per-frame host pipeline (cv_bridge 8-bit conversion ->
// photometric response G + vignette division -> bilinear undistortion remap;
// src/util/Undistort.cpp:160-237,362-441) fused into one OpenMP pass so the
// device receives a single ready irradiance image per frame. This is the
// framework's native runtime component: the device computes, the host feeds.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see native/__init__.py)

#include <cstdint>
#include <cmath>

extern "C" {

// raw: (h_in, w_in) uint8 or uint16 source image
// G: 256-entry (uint8) / 65536-entry (uint16) response LUT, already 0..255
// vig_inv: (h_in, w_in) inverse vignette (or nullptr)
// rx, ry: (h, w) float sample coordinates into the source image
// valid: (h, w) uint8 mask
// out: (h, w) float irradiance
void preprocess_frame_u8(const uint8_t* raw, int h_in, int w_in,
                         const float* G, const float* vig_inv,
                         const float* rx, const float* ry,
                         const uint8_t* valid, int h, int w, float* out) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int i = y * w + x;
      if (!valid[i]) { out[i] = 0.f; continue; }
      float fx = rx[i], fy = ry[i];
      int x0 = (int)fx, y0 = (int)fy;
      if (x0 < 0) x0 = 0; if (x0 > w_in - 2) x0 = w_in - 2;
      if (y0 < 0) y0 = 0; if (y0 > h_in - 2) y0 = h_in - 2;
      float dx = fx - x0, dy = fy - y0;
      if (dx < 0) dx = 0; if (dx > 1) dx = 1;
      if (dy < 0) dy = 0; if (dy > 1) dy = 1;
      const int base = y0 * w_in + x0;
      // photometric correction happens in the SOURCE image domain
      // (processFrame runs before the geometric remap in the reference)
      float tl = G[raw[base]];
      float tr = G[raw[base + 1]];
      float bl = G[raw[base + w_in]];
      float br = G[raw[base + w_in + 1]];
      if (vig_inv) {
        tl *= vig_inv[base];
        tr *= vig_inv[base + 1];
        bl *= vig_inv[base + w_in];
        br *= vig_inv[base + w_in + 1];
      }
      out[i] = tl * (1 - dx) * (1 - dy) + tr * dx * (1 - dy)
             + bl * (1 - dx) * dy + br * dx * dy;
    }
  }
}

// float input variant (already-decoded intensity images)
void preprocess_frame_f32(const float* raw, int h_in, int w_in,
                          const float* G, const float* vig_inv,
                          const float* rx, const float* ry,
                          const uint8_t* valid, int h, int w, float* out) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int i = y * w + x;
      if (!valid[i]) { out[i] = 0.f; continue; }
      float fx = rx[i], fy = ry[i];
      int x0 = (int)fx, y0 = (int)fy;
      if (x0 < 0) x0 = 0; if (x0 > w_in - 2) x0 = w_in - 2;
      if (y0 < 0) y0 = 0; if (y0 > h_in - 2) y0 = h_in - 2;
      float dx = fx - x0, dy = fy - y0;
      if (dx < 0) dx = 0; if (dx > 1) dx = 1;
      if (dy < 0) dy = 0; if (dy > 1) dy = 1;
      const int base = y0 * w_in + x0;
      auto lut = [&](float v) -> float {
        if (!G) return v;
        int k = (int)v;
        if (k < 0) k = 0; if (k > 254) k = 254;
        float f = v - k;
        return G[k] * (1 - f) + G[k + 1] * f;
      };
      float tl = lut(raw[base]);
      float tr = lut(raw[base + 1]);
      float bl = lut(raw[base + w_in]);
      float br = lut(raw[base + w_in + 1]);
      if (vig_inv) {
        tl *= vig_inv[base];
        tr *= vig_inv[base + 1];
        bl *= vig_inv[base + w_in];
        br *= vig_inv[base + w_in + 1];
      }
      out[i] = tl * (1 - dx) * (1 - dy) + tr * dx * (1 - dy)
             + bl * (1 - dx) * dy + br * dx * dy;
    }
  }
}

}  // extern "C"
