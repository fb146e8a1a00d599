// Multilevel RoIAlign backward (aligned=False) over an FPN pyramid, and the
// f32 -> bf16 convert of its accumulators, sm_90a.
//
// Replaces two TPU kernels of mxdetection_tpu/ops/pallas/roi_align.py:
//  - _bwd_kernel (K3): per roi, fetch a 40x32 window of the level's grad
//    into VMEM, add Wx-scatter(Wy^T @ g), write it back, on a sequential
//    grid (so windows could not race), with coverage passes and a budget
//    lax.cond for rois wider than one window;
//  - kern in _convert_pallas (K3b): the f32 -> bf16 convert of the
//    accumulators, a firewall against XLA's bf16 propagation.
// Semantics are the transpose of csrc/roi_align.cu (K1) and equal torch
// autograd of mxdetection_tpu_torch/ops/roi_align.py::multilevel_roi_align_plain:
// every sample of every bin scatters g / (S*S) times its bilinear weight
// wy * wx into the sample's four taps on the roi's level. Invalid rois
// contribute nothing. There is no roi gradient (reference CUDA semantics).
//
// K3 work layout: one block per (image, roi), threads over channels, exactly
// as K1; the sample taps and weights are computed by the same code, with the
// same explicitly rounded operations, from the same precomputed level id, so
// each product g * w equals the plain version's. The four taps of a sample
// are f32 atomicAdd (RED) into zeroed per-level f32 buffers: blocks run in
// parallel in no order, and rois overlap. Only the order of the sums differs
// from the plain version, and it changes from run to run. No windows, no
// passes: every roi is exact at any aspect ratio. Bound: the atomics,
// P*P*S*S*4 per (roi, channel) (784 at P = 7, S = 2), served by L2; the
// bytes the function must move (g in, level grads out) take far less.
//
// K3b: a grid-stride convert, four floats per thread, round to nearest even
// as torch's .to(torch.bfloat16). Bound: bytes (read f32, write bf16).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // P * S per axis

struct GradLevels {
  float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Tap indices and bilinear weights of one sample coordinate along one axis
// (the same function as K1's).
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

__device__ __forceinline__ void scatter(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

template <typename TG>
__global__ void roi_align_bwd_kernel(GradLevels lv, const float* __restrict__ rois,
                                     const int* __restrict__ levels,
                                     const uint8_t* __restrict__ valid,
                                     const TG* __restrict__ g, int R, int C, int P, int S) {
  __shared__ int y_lo[kMaxSamples], y_hi[kMaxSamples], x_lo[kMaxSamples], x_hi[kMaxSamples];
  __shared__ float wy_lo[kMaxSamples], wy_hi[kMaxSamples], wx_lo[kMaxSamples], wx_hi[kMaxSamples];

  const int item = blockIdx.x;  // image * R + roi
  if (!valid[item]) return;
  const int b = item / R;
  const int l = levels[item];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const float scale = lv.scale[l];
  float* grad = lv.ptr[l] + (size_t)b * H * W * C;

  const float* roi = rois + (size_t)item * 4;
  const float x1 = __fmul_rn(roi[0], scale);
  const float y1 = __fmul_rn(roi[1], scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(roi[2], scale), x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(roi[3], scale), y1), 1.0f);
  const float bin_w = __fdiv_rn(roi_w, (float)P);
  const float bin_h = __fdiv_rn(roi_h, (float)P);

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
  const TG* gi = g + (size_t)item * P * P * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float* fc = grad + c;
    for (int ph = 0; ph < P; ++ph) {
      for (int pw = 0; pw < P; ++pw) {
        const float gv = __fdiv_rn(to_f32(gi[((size_t)ph * P + pw) * C + c]), count);
        if (gv == 0.0f) continue;
        for (int iy = 0; iy < S; ++iy) {
          const int ky = ph * S + iy;
          float* row_lo = fc + (size_t)y_lo[ky] * W * C;
          float* row_hi = fc + (size_t)y_hi[ky] * W * C;
          const float a_lo = wy_lo[ky];
          const float a_hi = wy_hi[ky];
          for (int ix = 0; ix < S; ++ix) {
            const int kx = pw * S + ix;
            const size_t o_lo = (size_t)x_lo[kx] * C;
            const size_t o_hi = (size_t)x_hi[kx] * C;
            const float b_lo = wx_lo[kx];
            const float b_hi = wx_hi[kx];
            scatter(row_lo + o_lo, __fmul_rn(gv, __fmul_rn(a_lo, b_lo)));
            scatter(row_lo + o_hi, __fmul_rn(gv, __fmul_rn(a_lo, b_hi)));
            scatter(row_hi + o_lo, __fmul_rn(gv, __fmul_rn(a_hi, b_lo)));
            scatter(row_hi + o_hi, __fmul_rn(gv, __fmul_rn(a_hi, b_hi)));
          }
        }
      }
    }
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                   long long n) {
  const long long n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += step) {
    const float4 v = s4[i];
    d2[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    d2[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.
//
// mxdet_roi_align_bwd: level_* are HOST arrays of num_levels entries;
// grad_ptrs point at zeroed (B, H_l, W_l, C) f32 device buffers that the
// kernel accumulates into; rois (B*R, 4) f32, levels (B*R) int32, valid
// (B*R) bool and g (B*R, P, P, C) f32 or bf16 are device memory.
extern "C" int mxdet_roi_align_bwd(void* const* grad_ptrs, const int* level_h,
                                   const int* level_w, const float* level_scale, int num_levels,
                                   const float* rois, const int* levels, const uint8_t* valid,
                                   const void* g, int num_items, int R, int C, int P, int S,
                                   int g_is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || P * S > kMaxSamples || C < 1 || C > 1024)
    return (int)cudaErrorInvalidValue;
  if (num_items == 0) return 0;
  GradLevels lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : 0;
    lv.ptr[i] = static_cast<float*>(grad_ptrs[j]);
    lv.h[i] = level_h[j];
    lv.w[i] = level_w[j];
    lv.scale[i] = level_scale[j];
  }
  const int threads = ((C + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    roi_align_bwd_kernel<__nv_bfloat16><<<num_items, threads, 0, s>>>(
        lv, rois, levels, valid, static_cast<const __nv_bfloat16*>(g), R, C, P, S);
  } else {
    roi_align_bwd_kernel<float><<<num_items, threads, 0, s>>>(
        lv, rois, levels, valid, static_cast<const float*>(g), R, C, P, S);
  }
  return (int)cudaGetLastError();
}

// mxdet_f32_to_bf16: dst[i] = bf16(src[i]) for n elements of device memory;
// src 16-byte and dst 8-byte aligned (fresh torch allocations are).
extern "C" int mxdet_f32_to_bf16(const float* src, void* dst, long long n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks_needed = (n / 4 + threads - 1) / threads;
  const int blocks = (int)(blocks_needed < 132 * 16 ? (blocks_needed > 0 ? blocks_needed : 1)
                                                    : 132 * 16);
  f32_to_bf16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<__nv_bfloat16*>(dst), n);
  return (int)cudaGetLastError();
}
