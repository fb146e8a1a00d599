// Shared by the deformable-conv kernels: csrc/deform_conv.cu (the forward,
// K5/K5b) and csrc/deform_conv_bwd.cu (the backward, K6/K6b and K7/K7b).
//
// One definition of a tap's bilinear sample and of the four-corner blend, so
// the patch rows the backward rebuilds for dW are bit-identical to the rows
// the forward multiplied by W. Semantics are those of the plain version,
// mxdetection_tpu_torch/ops/dcn.py (the port of the JAX gather path,
// mxdetection_tpu/ops/dcn.py:24-95):
//   sy = (i*stride + ty*dil - pad) + dy, y0 = floor(sy), ly = sy - y0 (x alike);
//   corner weights (1-ly)(1-lx), (1-ly)lx, ly(1-lx), ly*lx, each zero when its
//   corner lies outside the map; the patch value is the f32 sum of the four
//   corner products in that order.
// Offsets are exact unless radius >= 0, which clamps them to +-radius first
// (the Pallas kernels' documented deviation, R = 3).
//
// Coordinates and weights use explicitly rounded operations (__fadd_rn,
// __fsub_rn, __fmul_rn) so nvcc cannot contract them into FMAs.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mxdet_dcn {

constexpr int kTaps = 9;  // 3x3

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geometry {
  int H, W, Cin, Ho, Wo, Cout, M, stride, dil, pad;
  float radius;  // < 0: no clamp
};

// The bilinear sample of one tap at one output pixel.
struct TapSample {
  long long off[4];  // element offset of each corner's pixel in x, clamped into the map
  float w[4];        // its bilinear weight, zero when the corner lies outside the map
  bool inb[4];       // the corner lies inside the map
  float ly, lx;      // the fractional parts of the sample position
  bool keep_y, keep_x;  // the offset lies inside [-radius, radius]: the clip passes its gradient
};

__device__ __forceinline__ void corner(const Geometry& g, int b, float yi, float xi, float w,
                                       long long* off, float* wt, bool* inb) {
  const float hmax = (float)(g.H - 1), wmax = (float)(g.W - 1);
  *inb = yi >= 0.0f && yi <= hmax && xi >= 0.0f && xi <= wmax;
  const int yc = (int)fminf(fmaxf(yi, 0.0f), hmax);
  const int xc = (int)fminf(fmaxf(xi, 0.0f), wmax);
  *off = (((long long)b * g.H + yc) * g.W + xc) * g.Cin;
  *wt = *inb ? w : 0.0f;
}

// Tap t (row-major in the 3x3 window) at output pixel m (flattened b, i, j),
// 0 <= m < g.M, displaced by its offset (dy, dx).
__device__ __forceinline__ TapSample sample_tap_at(const Geometry& g, int m, int t, float dy,
                                                   float dx) {
  TapSample s;
  const int b = m / (g.Ho * g.Wo);
  const int rem = m - b * g.Ho * g.Wo;
  const int i = rem / g.Wo;
  const int j = rem - i * g.Wo;
  const int ty = t / 3, tx = t - 3 * (t / 3);
  s.keep_y = s.keep_x = true;
  if (g.radius >= 0.0f) {
    s.keep_y = dy >= -g.radius && dy <= g.radius;
    s.keep_x = dx >= -g.radius && dx <= g.radius;
    dy = fminf(fmaxf(dy, -g.radius), g.radius);
    dx = fminf(fmaxf(dx, -g.radius), g.radius);
  }
  const float sy = __fadd_rn((float)(i * g.stride + ty * g.dil - g.pad), dy);
  const float sx = __fadd_rn((float)(j * g.stride + tx * g.dil - g.pad), dx);
  const float y0 = floorf(sy), x0 = floorf(sx);
  const float ly = __fsub_rn(sy, y0), lx = __fsub_rn(sx, x0);
  const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
  const float y1 = __fadd_rn(y0, 1.0f), x1 = __fadd_rn(x0, 1.0f);
  corner(g, b, y0, x0, __fmul_rn(hy, hx), &s.off[0], &s.w[0], &s.inb[0]);
  corner(g, b, y0, x1, __fmul_rn(hy, lx), &s.off[1], &s.w[1], &s.inb[1]);
  corner(g, b, y1, x0, __fmul_rn(ly, hx), &s.off[2], &s.w[2], &s.inb[2]);
  corner(g, b, y1, x1, __fmul_rn(ly, lx), &s.off[3], &s.w[3], &s.inb[3]);
  s.ly = ly;
  s.lx = lx;
  return s;
}

// The same with the offset read from offsets (M, 18) f32, (dy, dx) per tap.
__device__ __forceinline__ TapSample sample_tap(const Geometry& g,
                                                const float* __restrict__ offsets, int m, int t) {
  return sample_tap_at(g, m, t, offsets[(size_t)m * (2 * kTaps) + 2 * t],
                       offsets[(size_t)m * (2 * kTaps) + 2 * t + 1]);
}

// The integer position (y0, x0) of the top-left corner of tap t at output
// pixel m, from sample_tap's f32 operations. sample_tap clamps each corner
// into the map for its address; here nothing is clamped into the map, the
// position is only pinned to [-2, H] x [-2, W] (a corner pair beyond that
// weighs zero either way), so it fits a small integer. NaN pins to -2.
__device__ __forceinline__ int2 tap_corner(const Geometry& g, const float* __restrict__ offsets,
                                           int m, int t) {
  const int b = m / (g.Ho * g.Wo);
  const int rem = m - b * g.Ho * g.Wo;
  const int i = rem / g.Wo;
  const int j = rem - i * g.Wo;
  const int ty = t / 3, tx = t - 3 * (t / 3);
  float dy = offsets[(size_t)m * (2 * kTaps) + 2 * t];
  float dx = offsets[(size_t)m * (2 * kTaps) + 2 * t + 1];
  if (g.radius >= 0.0f) {
    dy = fminf(fmaxf(dy, -g.radius), g.radius);
    dx = fminf(fmaxf(dx, -g.radius), g.radius);
  }
  const float y0 = floorf(__fadd_rn((float)(i * g.stride + ty * g.dil - g.pad), dy));
  const float x0 = floorf(__fadd_rn((float)(j * g.stride + tx * g.dil - g.pad), dx));
  return make_int2((int)fminf(fmaxf(y0, -2.0f), (float)g.H),
                   (int)fminf(fmaxf(x0, -2.0f), (float)g.W));
}

// The patch value of one channel: the corner values (read at the clamped
// addresses) times their masked weights, summed in the plain version's order.
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                       const float w[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v00, w[0]), __fmul_rn(v01, w[1])),
                             __fmul_rn(v10, w[2])),
                   __fmul_rn(v11, w[3]));
}

}  // namespace mxdet_dcn
