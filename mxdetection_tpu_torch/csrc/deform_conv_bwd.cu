// Deformable convolution v1 backward (3x3), sm_90a: the two kernels that
// follow dpatch = g @ W^T in the backward of ops/dcn.py::DeformConvFunction.
//
// Replaces the four TPU kernels of mxdetection_tpu/ops/pallas/dcn.py:
//   _patches_kernel (K6, stride 1, :261) and _patches_kernel_s2 (K6b, stride
//   2, :894) -> deform_patches_doffsets_kernel;
//   _dx_kernel (K7, stride 1, :345) and _dx_kernel_s2 (K7b, stride 2, :804)
//   -> deform_col2im_kernel.
// Each serves both strides (and any dilation), with stride and dilation as
// arguments, as the forward (csrc/deform_conv.cu) does. The tap samples and
// the four-corner blend are the forward's (deform_common.cuh), so the
// rebuilt patches are bit-identical to the rows the forward multiplied by W.
// Semantics are those of the plain versions, ops/dcn.py::
// deform_patches_doffsets and deform_col2im, whose gradient convention is
// autodiff's of the gather: ly = sy - floor(sy) with the floor contributing
// nothing (at an integer sample position the derivative is one-sided,
// v(y0 + 1) - v(y0)), and a corner outside the map weighs zero in value and
// in derivative.
//
// deform_patches_doffsets_kernel writes the patch rows (for dW = patches^T g,
// a torch.matmul outside the kernel) and the offset gradient
//   doy = sum_c dpatch * ((1-lx)(v10-v00) + lx(v11-v01)),
//   dox = sum_c dpatch * ((1-ly)(v01-v00) + ly(v11-v10)).
// The TPU kernel wrote the derivative samples dsy and dsx, each 9x the
// activation, and XLA reduced dpatch*dsy over channels afterwards
// (pallas/dcn.py:572-579). Fused here, dsy and dsx never reach device memory:
// each warp reduces its tap's channels in registers and writes two floats.
// That is the same gradient and saves two 9C-wide writes and reads a layer.
//
// deform_col2im_kernel is the transpose of the sampling: each tap's dpatch
// row times each corner's weight, added with atomics into a zeroed f32 dx.
// Exact offsets are unbounded, so an input pixel cannot know which outputs
// sample it (the TPU kernel walked a clamped +-R window for that) and a
// gather form of dx does not exist: atomics are the design, as in K3.
//
// What the TPU kernels did to fit VMEM and the MXU (banded one-hot matrices,
// the (2R+2)^2 displacement walk, the column-parity lane split, the packed
// offset planes) has no counterpart: a warp reads exactly its four corners.
//
// Work layout, both kernels: one warp per (output pixel, tap); its lanes walk
// the channels four at a time (8-byte bf16 or 16-byte f32 vectors,
// neighbouring lanes on neighbouring channels of one NHWC pixel).
//
// Bound: both move much more than they compute (about 20 and 8 f32
// operations per sampled value), so bytes bound them. A stage-3 layer of the
// Cascade R101-DCN path at batch 8 (52x84x256, bf16) reads dpatch (161 MB)
// and x and writes the patches (161 MB): 0.10 ms at 3.35 TB/s for K6; K7
// reads dpatch and writes a 36 MB f32 dx: 0.06 ms. The corner reads hit L2
// (x is 18 MB), and K7's atomics resolve in L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "deform_common.cuh"

namespace {

using namespace mxdet_dcn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // (pixel, tap) tasks a block
constexpr int kVec = 4;                // channels a lane handles a step
// Ragged tails: a block's last warps may lie past the M * 9 tasks and leave
// together (a warp's lanes share one task); the entry point refuses a channel
// count that is not a whole number of vectors.
static_assert(kThreads % 32 == 0, "a block is whole warps");
// No shared memory is used: each warp keeps its tap sample in registers.

__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[kVec]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[kVec]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_patches_doffsets_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                               const T* __restrict__ dpatch, T* __restrict__ patches,
                               float* __restrict__ doffsets, Geometry g) {
  const long long task = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= (long long)g.M * kTaps) return;  // the whole warp leaves
  const int lane = threadIdx.x % 32;
  const int m = (int)(task / kTaps);
  const int t = (int)(task - (long long)m * kTaps);
  const TapSample s = sample_tap(g, offsets, m, t);
  const float hy = 1.0f - s.ly, hx = 1.0f - s.lx;
  const size_t row = (size_t)task * g.Cin;  // (m * 9 + t) * C: tap-major patch rows
  float doy = 0.0f, dox = 0.0f;
  for (int c = lane * kVec; c < g.Cin; c += 32 * kVec) {
    float v[4][kVec], d[kVec], p[kVec];
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(x + s.off[q] + c, v[q]);  // clamped: always valid
    load4(dpatch + row + c, d);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      p[e] = blend(v[0][e], v[1][e], v[2][e], v[3][e], s.w);  // the forward's value
      const float v00 = s.inb[0] ? v[0][e] : 0.0f, v01 = s.inb[1] ? v[1][e] : 0.0f;
      const float v10 = s.inb[2] ? v[2][e] : 0.0f, v11 = s.inb[3] ? v[3][e] : 0.0f;
      doy = fmaf(d[e], hx * (v10 - v00) + s.lx * (v11 - v01), doy);
      dox = fmaf(d[e], hy * (v01 - v00) + s.ly * (v11 - v10), dox);
    }
    store4(patches + row + c, p);
  }
#pragma unroll
  for (int k = 16; k > 0; k /= 2) {
    doy += __shfl_xor_sync(0xffffffffu, doy, k);
    dox += __shfl_xor_sync(0xffffffffu, dox, k);
  }
  if (lane == 0) {
    doffsets[(size_t)m * (2 * kTaps) + 2 * t] = s.keep_y ? doy : 0.0f;
    doffsets[(size_t)m * (2 * kTaps) + 2 * t + 1] = s.keep_x ? dox : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_col2im_kernel(const T* __restrict__ dpatch, const float* __restrict__ offsets,
                     float* __restrict__ dx, Geometry g) {
  const long long task = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= (long long)g.M * kTaps) return;
  const int lane = threadIdx.x % 32;
  const int m = (int)(task / kTaps);
  const int t = (int)(task - (long long)m * kTaps);
  const TapSample s = sample_tap(g, offsets, m, t);
  const size_t row = (size_t)task * g.Cin;
  for (int c = lane * kVec; c < g.Cin; c += 32 * kVec) {
    float d[kVec];
    load4(dpatch + row + c, d);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (s.w[q] == 0.0f) continue;  // outside the map, or on the far side of an integer
      const float4 add = make_float4(__fmul_rn(d[0], s.w[q]), __fmul_rn(d[1], s.w[q]),
                                     __fmul_rn(d[2], s.w[q]), __fmul_rn(d[3], s.w[q]));
      atomicAdd(reinterpret_cast<float4*>(dx + s.off[q] + c), add);  // sm_90: one vector atomic
    }
  }
}

bool geometry(int B, int H, int W, int C, int Ho, int Wo, int stride, int dilation,
              float radius, Geometry* g, unsigned* blocks) {
  if (B < 0 || H < 1 || W < 1 || Ho < 0 || Wo < 0 || C < kVec || C % kVec != 0 ||
      stride < 1 || dilation < 1)
    return false;
  const long long m = (long long)B * Ho * Wo;
  const long long n_blocks = (m * kTaps + kWarps - 1) / kWarps;
  if (m > 0x7fffffffLL || n_blocks > 0x7fffffffLL) return false;
  *g = Geometry{H, W, C, Ho, Wo, 0, (int)m, stride, dilation, dilation, radius};
  *blocks = (unsigned)n_blocks;
  return true;
}

}  // namespace

// Plain C entry points, loaded with ctypes. x (B, H, W, C); offsets
// (B, Ho, Wo, 18) f32; dpatch and patches (B, Ho, Wo, 9 * C); doffsets
// (B, Ho, Wo, 18) f32; dx (B, H, W, C) f32, zeroed by the caller. Device
// memory, contiguous, 16-byte aligned; x, dpatch and patches all bf16
// (is_bf16) or all f32. radius < 0: no clamp. Each launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int mxdet_deform_patches_doffsets(const void* x, const float* offsets,
                                             const void* dpatch, void* patches,
                                             float* doffsets, int B, int H, int W, int C,
                                             int Ho, int Wo, int stride, int dilation,
                                             float radius, int is_bf16, void* stream) {
  Geometry g;
  unsigned blocks;
  if (!geometry(B, H, W, C, Ho, Wo, stride, dilation, radius, &g, &blocks))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    deform_patches_doffsets_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), offsets, static_cast<const __nv_bfloat16*>(dpatch),
        static_cast<__nv_bfloat16*>(patches), doffsets, g);
  } else {
    deform_patches_doffsets_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), offsets, static_cast<const float*>(dpatch),
        static_cast<float*>(patches), doffsets, g);
  }
  return (int)cudaGetLastError();
}

extern "C" int mxdet_deform_col2im(const void* dpatch, const float* offsets, float* dx, int B,
                                   int H, int W, int C, int Ho, int Wo, int stride,
                                   int dilation, float radius, int is_bf16, void* stream) {
  Geometry g;
  unsigned blocks;
  if (!geometry(B, H, W, C, Ho, Wo, stride, dilation, radius, &g, &blocks))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    deform_col2im_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dpatch), offsets, dx, g);
  } else {
    deform_col2im_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dpatch), offsets, dx, g);
  }
  return (int)cudaGetLastError();
}
