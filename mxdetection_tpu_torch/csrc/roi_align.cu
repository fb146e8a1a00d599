// Multilevel RoIAlign forward (aligned=False) over an FPN pyramid, sm_90a.
//
// Replaces the TPU kernel mxdetection_tpu/ops/pallas/roi_align.py::_kernel
// (windowed DMA + MXU contractions). Semantics are those of the plain
// version, mxdetection_tpu_torch/ops/roi_align.py::multilevel_roi_align_plain
// (itself the port of mxdetection_tpu/ops/roi_align.py):
//   roi_w/h = max(x2*scale - x1*scale, 1); sample j of bin i at
//   start + (i + (j + .5)/S) * bin; samples inside [-1, size] are clamped to
//   [0, size-1] with hi = min(lo+1, size-1), samples beyond contribute 0;
//   each bin is the mean of its S*S samples; invalid rois give zeros.
//
// Work layout: one block per (image, roi), threads over channels. Levels are
// channels-last (B, H_l, W_l, C), so a warp's 32 neighbouring channels of one
// bilinear tap are one contiguous read. Each level is read in place through
// its own pointer and extents: no concat and no windows (the TPU's 40x32
// windows, coverage passes and drain queue existed to fit VMEM). The bound is
// the gather traffic: P*P*S*S*4 taps of C values per roi, mostly served by L2
// because the taps of one roi overlap; accumulation is f32 in registers.
//
// The roi's level comes in precomputed (int32) from the shared torch
// fpn_level_assign, so kernel and plain version agree at level boundaries.
// Sample coordinates use explicitly rounded operations (__fmul_rn, __fadd_rn,
// __fdiv_rn) so nvcc cannot contract them into FMAs: the taps and weights are
// then bit-identical to the plain version's, and only the summation order of
// the (at most 4*S*S) products differs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // P * S per axis

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Tap indices and bilinear weights of one sample coordinate along one axis.
__device__ __forceinline__ void axis_weights(float coord, int size, int* lo_i, int* hi_i,
                                             float* lo_w, float* hi_w) {
  const float size_f = (float)size;
  const bool inside = (coord >= -1.0f) && (coord <= size_f);
  const float cc = fminf(fmaxf(coord, 0.0f), __fsub_rn(size_f, 1.0f));
  const float lo = floorf(cc);
  const float hi = fminf(__fadd_rn(lo, 1.0f), __fsub_rn(size_f, 1.0f));
  const float hw = __fsub_rn(cc, lo);
  const float lw = __fsub_rn(1.0f, hw);
  *lo_i = (int)lo;
  *hi_i = (int)hi;
  *lo_w = inside ? lw : 0.0f;
  *hi_w = inside ? hw : 0.0f;
}

template <typename T>
__global__ void roi_align_fwd_kernel(Levels lv, const float* __restrict__ rois,
                                     const int* __restrict__ levels,
                                     const uint8_t* __restrict__ valid, T* __restrict__ out,
                                     int R, int C, int P, int S) {
  __shared__ int y_lo[kMaxSamples], y_hi[kMaxSamples], x_lo[kMaxSamples], x_hi[kMaxSamples];
  __shared__ float wy_lo[kMaxSamples], wy_hi[kMaxSamples], wx_lo[kMaxSamples], wx_hi[kMaxSamples];

  const int item = blockIdx.x;  // image * R + roi
  const int b = item / R;
  T* dst = out + (size_t)item * P * P * C;

  if (!valid[item]) {
    for (int e = threadIdx.x; e < P * P * C; e += blockDim.x) dst[e] = from_f32<T>(0.0f);
    return;
  }

  const int l = levels[item];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const float scale = lv.scale[l];
  const T* feat = static_cast<const T*>(lv.ptr[l]) + (size_t)b * H * W * C;

  const float* roi = rois + (size_t)item * 4;
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(roi[2], scale), x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(roi[3], scale), y1), 1.0f);
  const float bin_w = __fdiv_rn(roi_w, (float)P);
  const float bin_h = __fdiv_rn(roi_h, (float)P);

  // P*S sample coordinates per axis, shared by every channel of the block.
  const int n = P * S;
  for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
    const int k = t % n;
    const float frac = __fadd_rn((float)(k / S),
                                 __fdiv_rn(__fadd_rn((float)(k % S), 0.5f), (float)S));
    if (t < n) {
      axis_weights(__fadd_rn(y1, __fmul_rn(frac, bin_h)), H, &y_lo[k], &y_hi[k], &wy_lo[k], &wy_hi[k]);
    } else {
      axis_weights(__fadd_rn(x1, __fmul_rn(frac, bin_w)), W, &x_lo[k], &x_hi[k], &wx_lo[k], &wx_hi[k]);
    }
  }
  __syncthreads();

  const float count = (float)(S * S);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T* fc = feat + c;
    for (int ph = 0; ph < P; ++ph) {
      for (int pw = 0; pw < P; ++pw) {
        float acc = 0.0f;
        for (int iy = 0; iy < S; ++iy) {
          const int ky = ph * S + iy;
          const T* row_lo = fc + (size_t)y_lo[ky] * W * C;
          const T* row_hi = fc + (size_t)y_hi[ky] * W * C;
          const float a_lo = wy_lo[ky];
          const float a_hi = wy_hi[ky];
          for (int ix = 0; ix < S; ++ix) {
            const int kx = pw * S + ix;
            const size_t o_lo = (size_t)x_lo[kx] * C;
            const size_t o_hi = (size_t)x_hi[kx] * C;
            const float b_lo = wx_lo[kx];
            const float b_hi = wx_hi[kx];
            acc += to_f32(row_lo[o_lo]) * __fmul_rn(a_lo, b_lo)
                 + to_f32(row_lo[o_hi]) * __fmul_rn(a_lo, b_hi)
                 + to_f32(row_hi[o_lo]) * __fmul_rn(a_hi, b_lo)
                 + to_f32(row_hi[o_hi]) * __fmul_rn(a_hi, b_hi);
          }
        }
        dst[((size_t)ph * P + pw) * C + c] = from_f32<T>(acc / count);
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. level_* are HOST arrays of
// num_levels entries; every other pointer is device memory. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int mxdet_roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                                   const int* level_w, const float* level_scale,
                                   int num_levels, const float* rois, const int* levels,
                                   const uint8_t* valid, void* out, int num_items, int R,
                                   int C, int P, int S, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || P * S > kMaxSamples || C < 1 || C > 1024)
    return (int)cudaErrorInvalidValue;
  if (num_items == 0) return 0;
  Levels lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : 0;
    lv.ptr[i] = level_ptrs[j];
    lv.h[i] = level_h[j];
    lv.w[i] = level_w[j];
    lv.scale[i] = level_scale[j];
  }
  const int threads = ((C + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<num_items, threads, 0, s>>>(
        lv, rois, levels, valid, static_cast<__nv_bfloat16*>(out), R, C, P, S);
  } else {
    roi_align_fwd_kernel<float><<<num_items, threads, 0, s>>>(
        lv, rois, levels, valid, static_cast<float*>(out), R, C, P, S);
  }
  return (int)cudaGetLastError();
}
