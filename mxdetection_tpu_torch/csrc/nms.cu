// Exact greedy NMS over batches of score-sorted, padded box sets, sm_90a.
//
// Replaces the TPU kernel mxdetection_tpu/ops/pallas/nms.py::_nms_kernel
// (an N-step VPU sweep held in VMEM). Contract: the keep mask equals
// mxdetection_tpu_torch/ops/nms.py::nms_mask_sorted_plain bit for bit, i.e.
// the full greedy sweep of mxdetection_tpu/ops/nms.py::nms_mask. There is no
// max_keep early exit, so no unverified tail: any top-k of the mask is exact.
//
// Two phases, one launch each, for all P problems of a call (the RPN's
// B x levels problems, or the test NMS's B class-aware problems):
//  (a) nms_mask_kernel: one 64-thread block per (problem, row tile, column
//      tile) writes the upper-triangular suppression bitmask
//      (P, N, ceil(N/64)) uint64: bit j of row i is set iff j > i, row i is
//      valid, and iou(i, j) > thr. Tiles below the diagonal are all zero.
//      Bound: N^2/2 IoUs per problem, about 20 flops each, from boxes staged
//      in shared memory; trivially parallel.
//  (b) nms_sweep_kernel: one warp per problem walks the rows in score order
//      with the removed-set (ceil(N/64) words) in shared memory; a row that
//      is not removed is kept and ORs its mask row into the set, one word per
//      lane. Bound: the sequential chain of N steps, one L2 read of a mask row
//      per kept box. The keep mask stays on the device: no host sync.
//
// IoU follows ops/boxes.py::pairwise_iou operation for operation in f32, with
// explicitly rounded intrinsics so nvcc cannot contract it into FMAs: a box
// right at the threshold decides the same way as in the plain version.
// min/max propagate NaN like torch.minimum/torch.maximum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float area(const float* b) {
  return __fmul_rn(max_nan(__fsub_rn(b[2], b[0]), 0.0f), max_nan(__fsub_rn(b[3], b[1]), 0.0f));
}

// iou(a, b) > thr, exactly as the plain version decides it.
__device__ __forceinline__ bool iou_over(const float* a, float area_a, const float* b,
                                         float area_b, float thr) {
  const float lt_x = max_nan(a[0], b[0]);
  const float lt_y = max_nan(a[1], b[1]);
  const float rb_x = min_nan(a[2], b[2]);
  const float rb_y = min_nan(a[3], b[3]);
  const float iw = max_nan(__fsub_rn(rb_x, lt_x), 0.0f);
  const float ih = max_nan(__fsub_rn(rb_y, lt_y), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, max_nan(uni, 1e-12f)) : 0.0f;
  return iou > thr;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                                int N, int col_blocks, float thr,
                                unsigned long long* __restrict__ mask) {
  const int p = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  const int row = row_block * kTile + threadIdx.x;
  const int col_start = col_block * kTile;
  const int cols = min(N - col_start, kTile);
  const float* pb = boxes + (size_t)p * N * 4;

  __shared__ float sbox[kTile * 4];
  __shared__ float sarea[kTile];
  if (col_block >= row_block && threadIdx.x < cols) {
    const float* src = pb + (size_t)(col_start + threadIdx.x) * 4;
    for (int k = 0; k < 4; ++k) sbox[threadIdx.x * 4 + k] = src[k];
    sarea[threadIdx.x] = area(src);
  }
  __syncthreads();
  if (row >= N) return;

  unsigned long long bits = 0ULL;
  if (col_block >= row_block && valid[(size_t)p * N + row]) {
    const float* a = pb + (size_t)row * 4;
    const float ab[4] = {a[0], a[1], a[2], a[3]};
    const float area_a = area(ab);
    const int start = (col_block == row_block) ? threadIdx.x + 1 : 0;
    for (int k = start; k < cols; ++k) {
      if (iou_over(ab, area_a, &sbox[k * 4], sarea[k], thr)) bits |= 1ULL << k;
    }
  }
  mask[((size_t)p * N + row) * col_blocks + col_block] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int N, int col_blocks,
                                 uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* pv = valid + (size_t)p * N;
  const unsigned long long* pm = mask + (size_t)p * N * col_blocks;
  uint8_t* pk = keep + (size_t)p * N;

  // invalid rows (and the ragged tail of the last word) start removed
  for (int w = lane; w < col_blocks; w += 32) {
    unsigned long long r = 0ULL;
    for (int k = 0; k < kTile; ++k) {
      const int i = w * kTile + k;
      if (i >= N || !pv[i]) r |= 1ULL << k;
    }
    removed[w] = r;
  }
  __syncwarp();

  for (int i = 0; i < N; ++i) {
    const int word = i / kTile;
    const bool alive = !((removed[word] >> (i % kTile)) & 1ULL);
    __syncwarp();
    if (lane == 0) pk[i] = alive ? 1 : 0;
    if (alive) {
      // mask row i only has bits for j > i, so words before `word` are zero
      for (int w = word + lane; w < col_blocks; w += 32) removed[w] |= pm[(size_t)i * col_blocks + w];
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device memory:
// boxes (P, N, 4) f32 score-sorted, valid (P, N) bool, mask scratch
// (P, N, ceil(N/64)) uint64, keep (P, N) bool. Launches both phases on
// `stream` and returns the first cudaError_t (0 on success).
extern "C" int mxdet_nms_mask_sorted(const float* boxes, const uint8_t* valid, int P, int N,
                                     float thr, unsigned long long* mask, uint8_t* keep,
                                     void* stream) {
  if (P == 0 || N == 0) return 0;
  const int col_blocks = (N + kTile - 1) / kTile;
  const size_t smem = (size_t)col_blocks * sizeof(unsigned long long);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(col_blocks, col_blocks, P), kTile, 0, s>>>(boxes, valid, N, col_blocks,
                                                                    thr, mask);
  int err = (int)cudaGetLastError();
  if (err) return err;
  nms_sweep_kernel<<<P, 32, smem, s>>>(mask, valid, N, col_blocks, keep);
  return (int)cudaGetLastError();
}
