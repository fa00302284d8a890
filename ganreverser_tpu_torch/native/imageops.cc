// Native host-side image ops for the data pipeline and artifact rendering.
//
// A copy of ganreverser_tpu/native/imageops.cc, with the same functions
// and C signatures. The reference consumes torch's C `image` library for
// decode/scale/colorspace (dataset.lua:148-151, nn_utils.lua:133-246); this
// is the native equivalent for the host side of the pipeline: bilinear
// resize, the custom rgb->y mix (0.21/0.72/0.07), rgb<->yuv, [-1,1]
// normalize, and image-grid assembly. All buffers are float32 HWC / NHWC,
// C-contiguous; bindings in imageops.py (ctypes), which keeps the numpy
// paths for hosts without a compiler. Parity tests:
// tests/test_torch_port_native.py.
//
// Build (imageops.py does it at first use, into build/native/):
//   g++ -O3 -shared -fPIC -o libimageops.so imageops.cc

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Bilinear resize, align-corners=false (PIL/torch image.scale convention).
// src: (sh, sw, c), dst: (dh, dw, c)
void resize_bilinear(const float* src, int sh, int sw, int c,
                     float* dst, int dh, int dw) {
  const float sy = (float)sh / dh;
  const float sx = (float)sw / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(y0 + 1, sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(x0 + 1, sw - 1);
      const float* p00 = src + (y0c * sw + x0c) * c;
      const float* p01 = src + (y0c * sw + x1c) * c;
      const float* p10 = src + (y1c * sw + x0c) * c;
      const float* p11 = src + (y1c * sw + x1c) * c;
      float* out = dst + (y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] * (1 - wx) + p01[k] * wx;
        float bot = p10[k] * (1 - wx) + p11[k] * wx;
        out[k] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

// Batched resize: src (n, sh, sw, c) -> dst (n, dh, dw, c)
void resize_bilinear_batch(const float* src, int n, int sh, int sw, int c,
                           float* dst, int dh, int dw) {
  const long in_stride = (long)sh * sw * c;
  const long out_stride = (long)dh * dw * c;
  for (int i = 0; i < n; ++i) {
    resize_bilinear(src + i * in_stride, sh, sw, c,
                    dst + i * out_stride, dh, dw);
  }
}

// The reference's custom grayscale mix (nn_utils.lua:237-239).
// src: (n, h, w, 3) -> dst: (n, h, w, 1)
void rgb2y(const float* src, long n_pixels, float* dst) {
  for (long i = 0; i < n_pixels; ++i) {
    const float* p = src + i * 3;
    dst[i] = 0.21f * p[0] + 0.72f * p[1] + 0.07f * p[2];
  }
}

// torch image.rgb2yuv matrix
void rgb2yuv(const float* src, long n_pixels, float* dst) {
  for (long i = 0; i < n_pixels; ++i) {
    const float* p = src + i * 3;
    float* o = dst + i * 3;
    o[0] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    o[1] = -0.14713f * p[0] - 0.28886f * p[1] + 0.436f * p[2];
    o[2] = 0.615f * p[0] - 0.51499f * p[1] - 0.10001f * p[2];
  }
}

void yuv2rgb(const float* src, long n_pixels, float* dst) {
  for (long i = 0; i < n_pixels; ++i) {
    const float* p = src + i * 3;
    float* o = dst + i * 3;
    o[0] = p[0] + 1.13983f * p[2];
    o[1] = p[0] - 0.39465f * p[1] - 0.58060f * p[2];
    o[2] = p[0] + 2.03211f * p[1];
  }
}

// NN_UTILS.normalize (nn_utils.lua:363-379): x*2-1, clamp to [-1,1], inplace
void normalize_pm1(float* data, long n) {
  for (long i = 0; i < n; ++i) {
    float v = data[i] * 2.0f - 1.0f;
    data[i] = std::min(std::max(v, -1.0f), 1.0f);
  }
}

// Grid assembly (nn_utils.lua:490-516): tile (n, ih, iw, c) images into a
// zero-initialized (gh*ih + strip, gw*iw, c) canvas; strip rows for the
// epoch stamp are left to the caller.
void assemble_grid(const float* images, int n, int ih, int iw, int c,
                   float* grid, int gh, int gw, int strip) {
  const int H = gh * ih + strip;
  const int W = gw * iw;
  std::memset(grid, 0, (long)H * W * c * sizeof(float));
  const int count = std::min(n, gh * gw);
  for (int i = 0; i < count; ++i) {
    int gy = i / gw, gx = i % gw;
    for (int y = 0; y < ih; ++y) {
      const float* srow = images + ((long)i * ih * iw + (long)y * iw) * c;
      float* drow = grid + ((long)(gy * ih + y) * W + (long)gx * iw) * c;
      std::memcpy(drow, srow, (long)iw * c * sizeof(float));
    }
  }
}

}  // extern "C"
