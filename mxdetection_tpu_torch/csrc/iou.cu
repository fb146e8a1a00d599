// Batched pairwise IoU matrix, sm_90a.
//
// Replaces the TPU kernel mxdetection_tpu/ops/pallas/iou.py::_iou_kernel
// (a (256, K) slab per grid step, built with VPU broadcasts in VMEM).
// Contract: out[b, n, g] = iou(boxes1[b, n], boxes2[b, g]) equals
// mxdetection_tpu_torch/ops/boxes.py::pairwise_iou bit for bit, because the
// assigner downstream compares iou >= gt_best - 1e-7 and breaks argmax ties
// by index: an ulp of difference would move a low-quality match.
//
// Work layout: one block per (image, tile of kRows rows of boxes1). The
// image's G boxes of boxes2 and their areas sit in shared memory, as do the
// tile's rows; the block's threads then walk the tile's kRows * G outputs in
// memory order, so a warp writes 32 consecutive floats. Bound: the output,
// B * N * G * 4 bytes written once (893.7 MB for 8 x 279,279 anchors x 100
// gt); each IoU is ~15 flops, far below the byte bound.
//
// The arithmetic follows pairwise_iou operation for operation in f32 with
// explicitly rounded intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn)
// so nvcc cannot contract it into FMAs; min/max propagate NaN like
// torch.minimum/torch.maximum and clamp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kThreads = 256;
constexpr int kMaxCols = 2048;  // shared memory: 5 floats per box of boxes2

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// box_area: clamp(x2 - x1 + 0, min 0) * clamp(y2 - y1 + 0, min 0)
__device__ __forceinline__ float area(float x1, float y1, float x2, float y2) {
  const float w = max_nan(__fadd_rn(__fsub_rn(x2, x1), 0.0f), 0.0f);
  const float h = max_nan(__fadd_rn(__fsub_rn(y2, y1), 0.0f), 0.0f);
  return __fmul_rn(w, h);
}

__global__ void pairwise_iou_kernel(const float* __restrict__ boxes1, long long stride1,
                                    const float* __restrict__ boxes2, int N, int G,
                                    float* __restrict__ out) {
  __shared__ float col[kMaxCols * 4];
  __shared__ float col_area[kMaxCols];
  __shared__ float row[kRows * 4];
  __shared__ float row_area[kRows];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(N - row0, kRows);
  const float* pa = boxes1 + (size_t)b * stride1 + (size_t)row0 * 4;
  const float* pb = boxes2 + (size_t)b * G * 4;

  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float x1 = pb[g * 4], y1 = pb[g * 4 + 1], x2 = pb[g * 4 + 2], y2 = pb[g * 4 + 3];
    col[g * 4] = x1; col[g * 4 + 1] = y1; col[g * 4 + 2] = x2; col[g * 4 + 3] = y2;
    col_area[g] = area(x1, y1, x2, y2);
  }
  for (int n = threadIdx.x; n < rows; n += blockDim.x) {
    const float x1 = pa[n * 4], y1 = pa[n * 4 + 1], x2 = pa[n * 4 + 2], y2 = pa[n * 4 + 3];
    row[n * 4] = x1; row[n * 4 + 1] = y1; row[n * 4 + 2] = x2; row[n * 4 + 3] = y2;
    row_area[n] = area(x1, y1, x2, y2);
  }
  __syncthreads();

  float* dst = out + ((size_t)b * N + row0) * G;
  for (int e = threadIdx.x; e < rows * G; e += blockDim.x) {
    const int n = e / G;
    const int g = e - n * G;
    const float* a = &row[n * 4];
    const float* c = &col[g * 4];
    const float lt_x = max_nan(a[0], c[0]);
    const float lt_y = max_nan(a[1], c[1]);
    const float rb_x = min_nan(a[2], c[2]);
    const float rb_y = min_nan(a[3], c[3]);
    const float iw = max_nan(__fadd_rn(__fsub_rn(rb_x, lt_x), 0.0f), 0.0f);
    const float ih = max_nan(__fadd_rn(__fsub_rn(rb_y, lt_y), 0.0f), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(row_area[n], col_area[g]), inter);
    dst[e] = uni > 0.0f ? __fdiv_rn(inter, max_nan(uni, 1e-12f)) : 0.0f;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. boxes1 (B, N, 4) f32 with a batch
// stride of `stride1` floats (0: one set shared by every image), boxes2
// (B, G, 4) f32 contiguous, out (B, N, G) f32; all device memory. Launches
// on `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int mxdet_pairwise_iou(const float* boxes1, long long stride1, const float* boxes2,
                                  int B, int N, int G, float* out, void* stream) {
  if (G > kMaxCols) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0 || G == 0) return 0;
  const dim3 grid((N + kRows - 1) / kRows, B);
  pairwise_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes1, stride1, boxes2, N, G, out);
  return (int)cudaGetLastError();
}
