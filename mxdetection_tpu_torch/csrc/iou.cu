// Max-IoU assigner, batched over images, sm_90a.
//
// Replaces the TPU kernel mxdetection_tpu/ops/pallas/iou.py::_iou_kernel
// (a (256, K) slab of the IoU matrix per grid step, built with VPU
// broadcasts in VMEM) together with what its callers did with the matrix:
// every caller only reduces it. So the matrix is never written. The kernel
// computes each row's IoUs in registers and reduces them at once, in the
// schedule of the JAX package's chunked assigner
// (mxdetection_tpu/ops/matching.py::assign_max_iou): pass A gives each row
// its max IoU and first argmax (sample_rois, relabel_rois, the RPN without
// the low-quality force) or each gt its best IoU over the rows (the RPN);
// pass B recomputes the row's IoUs to force the boxes that tie a gt's best,
// and writes the final labels. Its plain version is the dense
// mxdetection_tpu_torch/ops/matching.py::assign_max_iou_dense, which it
// matches bit for bit.
//
// Exactness. The IoU follows ops/boxes.py::pairwise_iou operation for
// operation in f32 with explicitly rounded intrinsics (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn), so nvcc cannot contract it into FMAs, and min/max
// propagate NaN like torch.minimum/torch.maximum and clamp: the assigner
// compares iou >= gt_best - 1e-7 and breaks ties by index, so an ulp would
// move a match. A pair whose clamped width or height is not positive has
// IoU exactly +0 whatever the union (its intersection is +0, or NaN and then
// so is the union, which the plain version's where(union > 0) maps to 0), so
// its multiply and division are skipped. For the same
// reason an IoU is never NaN, so maxima over non-negative IoUs can be taken
// on their bits as unsigned integers (__reduce_max_sync, atomicMax): the max
// of floats is exact in any order, and gt_best equals iou.amax(dim=1) of the
// dense form bit for bit. Invalid gt (IoU -1 in the dense form) never beat a
// valid one (IoU >= 0): the block lists the image's valid gt in index order
// and walks only them; a row of an image without one gets max -1, index 0,
// as the dense argmax over all -1.
//
// Work layout: one block per (image, tile of kRows rows of boxes1), two
// rows a thread (kRowsPerThread: a gt's shared-memory reads serve both).
// The image's valid gt, their areas and (pass B) their thresholds sit in
// dynamic shared memory, read by every thread in turn (broadcasts). A warp
// skips every gt that lies beyond the bounding box of its rows (the cull):
// such a pair's IoU is exactly +0, as above, and neighbouring anchors make
// small boxes. Bound: operations, not bytes. The rows are read once (an
// anchor set shared by the images is read in place: stride 0) and each
// row's outputs written once, 36 MB at 8 x 279,279 anchors; the IoUs are
// ~14 f32 operations a (row, valid gt) pair, twice with the low-quality
// force, less what the cull and the skip leave out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;
constexpr int kRows = kThreads * kRowsPerThread;
constexpr int kMaxCols = 1024;

// What a launch computes and writes.
enum Mode : int {
  kRowMax = 0,        // max_iou (-1 without a valid gt) and matched of each row
  kGtBest = 1,        // pass A of the low-quality force: gt_best only
  kLabels = 2,        // one pass, no force: labels, matched, max_iou.clamp(min=0)
  kLabelsForced = 3,  // pass B: the same with the boxes tying a gt's best forced
};

struct Thresholds {
  float pos, neg, min_pos;
};

// max/min that return NaN if either side is NaN, as torch.maximum/minimum
// and clamp (sm_80's max.NaN / min.NaN: one instruction)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// box_area: clamp(x2 - x1 + 0, min 0) * clamp(y2 - y1 + 0, min 0)
__device__ __forceinline__ float area(float4 a) {
  const float w = max_nan(__fadd_rn(__fsub_rn(a.z, a.x), 0.0f), 0.0f);
  const float h = max_nan(__fadd_rn(__fsub_rn(a.w, a.y), 0.0f), 0.0f);
  return __fmul_rn(w, h);
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 c, float area_c) {
  const float iw = max_nan(__fadd_rn(__fsub_rn(min_nan(a.z, c.z), max_nan(a.x, c.x)), 0.0f), 0.0f);
  const float ih = max_nan(__fadd_rn(__fsub_rn(min_nan(a.w, c.w), max_nan(a.y, c.y)), 0.0f), 0.0f);
  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f;  // disjoint: exactly +0
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  return uni > 0.0f ? __fdiv_rn(inter, max_nan(uni, 1e-12f)) : 0.0f;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) max_iou_kernel(
    const float* __restrict__ boxes1, long long stride1, const float* __restrict__ boxes2,
    const uint8_t* __restrict__ gt_valid, const uint8_t* __restrict__ box_valid, int N, int G,
    Thresholds thr, unsigned* __restrict__ gt_best, float* __restrict__ max_iou,
    long long* __restrict__ matched, int* __restrict__ labels) {
  extern __shared__ float4 smem[];
  float4* col = smem;                                          // G boxes
  float* col_area = reinterpret_cast<float*>(col + G);         // G areas
  unsigned* col_aux = reinterpret_cast<unsigned*>(col_area + G);  // best bits / thresholds
  int* col_id = reinterpret_cast<int*>(col_aux + G);           // gt index of list entry j
  __shared__ int n_valid;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {  // list the image's valid gt in index order
    int base = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const bool v = g < G && gt_valid[(size_t)b * G + g];
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) col_id[base + __popc(mask & ((1u << lane) - 1u))] = g;
      base += __popc(mask);
    }
    if (lane == 0) n_valid = base;
  }
  __syncthreads();
  const int nv = n_valid;
  for (int j = threadIdx.x; j < nv; j += kThreads) {
    const int g = col_id[j];
    const float4 c = reinterpret_cast<const float4*>(boxes2)[(size_t)b * G + g];
    col[j] = c;
    col_area[j] = area(c);
    if (kMode == kGtBest) col_aux[j] = 0u;
    if (kMode == kLabelsForced)
      col_aux[j] = __float_as_uint(__fsub_rn(__uint_as_float(gt_best[(size_t)b * G + g]), 1e-7f));
  }
  __syncthreads();

  const float4* rows = reinterpret_cast<const float4*>(boxes1 + (size_t)b * stride1);
  float4 a[kRowsPerThread];
  float aa[kRowsPerThread];
  int n[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    n[r] = blockIdx.x * kRows + r * kThreads + threadIdx.x;
    // a zero box past the end: IoU +0 with everything, so it moves no gt's best
    a[r] = n[r] < N ? rows[n[r]] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    aa[r] = area(a[r]);
  }
  // The warp's rows' bounding box (NaN coordinates left out: such a row has
  // IoU 0 with everything). A gt beyond one of its edges has a clamped
  // width or height of exactly +0 with every row of the warp, so IoU +0,
  // and the whole warp skips it. With a negative min_pos_iou an IoU of 0
  // could be forced, so pass B then computes every pair.
  float4 wb = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (n[r] < N) {
      wb = make_float4(fminf(wb.x, a[r].x), fminf(wb.y, a[r].y), fmaxf(wb.z, a[r].z),
                       fmaxf(wb.w, a[r].w));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wb.x = fminf(wb.x, __shfl_xor_sync(0xffffffffu, wb.x, o));
    wb.y = fminf(wb.y, __shfl_xor_sync(0xffffffffu, wb.y, o));
    wb.z = fmaxf(wb.z, __shfl_xor_sync(0xffffffffu, wb.z, o));
    wb.w = fmaxf(wb.w, __shfl_xor_sync(0xffffffffu, wb.w, o));
  }
  const bool cull = kMode != kLabelsForced || thr.min_pos >= 0.0f;
  auto outside = [&](const float4& c) {
    return cull && (c.x >= wb.z || c.z <= wb.x || c.y >= wb.w || c.w <= wb.y);
  };

  if (kMode == kGtBest) {
    for (int j = 0; j < nv; ++j) {
      const float4 c = col[j];
      if (outside(c)) continue;
      const float ca = col_area[j];
      unsigned m = 0u;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) m = max(m, __float_as_uint(iou(a[r], aa[r], c, ca)));
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0 && m != 0u) atomicMax(&col_aux[j], m);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nv; j += kThreads) {
      if (col_aux[j] != 0u) atomicMax(&gt_best[(size_t)b * G + col_id[j]], col_aux[j]);
    }
    return;
  }

  // every valid gt has IoU >= 0: start from the first one at 0, so a skipped
  // gt counts as its +0
  float best[kRowsPerThread];
  int best_j[kRowsPerThread], forced_j[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    best[r] = nv > 0 ? 0.0f : -1.0f;
    best_j[r] = 0;
    forced_j[r] = -1;
  }
  for (int j = 0; j < nv; ++j) {
    const float4 c = col[j];
    if (outside(c)) continue;
    const float ca = col_area[j];
    const float t = __uint_as_float(col_aux[j]);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float v = iou(a[r], aa[r], c, ca);
      if (v > best[r]) {  // the first of equal maxima, as argmax
        best[r] = v;
        best_j[r] = j;
      }
      if (kMode == kLabelsForced && v >= t && v > thr.min_pos) forced_j[r] = j;  // the last
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (n[r] >= N) continue;
    const size_t o = (size_t)b * N + n[r];
    long long idx = nv > 0 ? col_id[best_j[r]] : 0;
    if (kMode == kRowMax) {
      max_iou[o] = best[r];
      matched[o] = idx;
      continue;
    }
    int lab = -1;
    if (best[r] < thr.neg) lab = 0;
    if (best[r] >= thr.pos) lab = 1;
    if (kMode == kLabelsForced && forced_j[r] >= 0) {
      lab = 1;
      idx = col_id[forced_j[r]];
    }
    if (nv == 0) lab = 0;
    if (box_valid != nullptr && !box_valid[o]) lab = -2;
    labels[o] = lab;
    matched[o] = idx;
    max_iou[o] = fmaxf(best[r], 0.0f);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. boxes1 (B, N, 4) f32 with a batch
// stride of `stride1` floats (0: one set shared by every image), boxes2
// (B, G, 4) f32 contiguous, gt_valid (B, G) and box_valid (B, N, or null)
// bool; gt_best (B, G) u32, zeroed before a kGtBest launch and read by
// kLabelsForced; max_iou (B, N) f32, matched (B, N) int64, labels (B, N)
// int32 (unused by kRowMax); all device memory, 16-byte aligned boxes.
// Launches `mode` on `stream` and returns the cudaError_t of the launch.
extern "C" int mxdet_max_iou(const float* boxes1, long long stride1, const float* boxes2,
                             const uint8_t* gt_valid, const uint8_t* box_valid, int B, int N,
                             int G, int mode, float pos_thr, float neg_thr, float min_pos_iou,
                             unsigned* gt_best, float* max_iou, long long* matched, int* labels,
                             void* stream) {
  if (G < 1 || G > kMaxCols || mode < kRowMax || mode > kLabelsForced)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kRows - 1) / kRows, B);
  const size_t smem = (size_t)G * (sizeof(float4) + sizeof(float) + sizeof(unsigned) + sizeof(int));
  const Thresholds thr{pos_thr, neg_thr, min_pos_iou};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXDET_LAUNCH(M)                                                                     \
  max_iou_kernel<M><<<grid, kThreads, smem, s>>>(boxes1, stride1, boxes2, gt_valid, box_valid, \
                                                 N, G, thr, gt_best, max_iou, matched, labels)
  switch (mode) {
    case kRowMax: MXDET_LAUNCH(kRowMax); break;
    case kGtBest: MXDET_LAUNCH(kGtBest); break;
    case kLabels: MXDET_LAUNCH(kLabels); break;
    default: MXDET_LAUNCH(kLabelsForced); break;
  }
#undef MXDET_LAUNCH
  return (int)cudaGetLastError();
}
