// Exact greedy NMS over batches of score-sorted, padded box sets, sm_90a.
//
// Replaces the TPU kernel mxdetection_tpu/ops/pallas/nms.py::_nms_kernel
// (an N-step VPU sweep held in VMEM). Contract: the keep mask equals
// mxdetection_tpu_torch/ops/nms.py::nms_mask_sorted_plain bit for bit, i.e.
// the full greedy sweep of mxdetection_tpu/ops/nms.py::nms_mask. There is no
// max_keep early exit, so no unverified tail: any top-k of the mask is exact.
// Its model, tile for tile, is nms_mask_tiles in tests/test_torch_port_nms_tiles.py.
//
// Two launches for all P problems of a call (the RPN's B x levels problems,
// or the test NMS's B class-aware problems), cb = ceil(N/64):
//  (a) nms_mask_kernel: one 64-thread block per (problem, upper tile): row
//      tile t, word column w >= t, cb(cb+1)/2 tiles a problem; the tiles
//      below the diagonal, which the sweep never reads, are not launched.
//      Thread r writes the word of row t*64+r: bit k is set iff column
//      j = w*64+k > row, the row is valid and iou(row, j) > thr. Packed
//      layout, in the order the sweep reads it: a problem's tiles row tile
//      by row tile (w = t..cb-1 within one), each tile its 64 row words
//      (512 B), so row tile t's block is one run of (cb - t) * 512 bytes
//      starting tile_offset(t, cb) tiles in (k2_variants' `square`, a
//      tile-major layout whose lower blocks exit at once, is slower on an
//      H100 at the main path's shapes).
//      The wrapper sizes the scratch by mxdet_nms_scratch_words. Bound:
//      N^2/2 IoUs a problem from boxes staged in shared memory, spread over
//      the card.
//  (b) nms_sweep_kernel: one block per problem resolves 64 rows a step, so
//      the dependent chain is cb steps of shared-memory work. A ring of
//      kStages stages holds the next row tiles' blocks, kChunk word columns
//      at a time, copied whole (kept rows or not, so a copy never waits on
//      a decision) by cp.async.bulk onto an mbarrier. At row tile t:
//        1. every thread loads the tile's 64 diagonal words into registers
//           (the same shared-memory words for all: broadcasts) and resolves
//           the tile's rows from removed[t], ORing in the diagonal word of
//           each row not yet removed;
//        2. warp 0 writes the tile's 64 keep bytes;
//        3. each word w > t has one owning warp, which ORs the words of the
//           tile's kept rows (two per lane, then __reduce_or_sync on each
//           32-bit half) into removed[w]: no atomics;
//      then one __syncthreads, and thread 0 refills the freed stage.
//      Invalid rows and the ragged tail start removed; their mask rows are
//      zero and never read. The keep mask stays on the device.
//
// IoU follows ops/boxes.py::pairwise_iou operation for operation in f32, with
// explicitly rounded intrinsics so nvcc cannot contract it into FMAs: a box
// right at the threshold decides the same way as in the plain version.
// min/max propagate NaN like torch.minimum/torch.maximum. A pair with no
// intersection decides without the division: its IoU is +0 whatever the union.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace mxdet_hopper;

constexpr int kTile = 64;        // rows of a row tile, bits of a word
constexpr int kChunk = 32;       // word columns a ring stage holds
constexpr int kStages = 4;       // ring stages of the sweep
constexpr int kSweepWarps = 4;   // warps of a sweep block
constexpr int kMaxWords = 6144;  // removed-set words: 48 KB of shared memory

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
  // iw or ih zero or NaN: the intersection is zero or NaN, and the IoU
  // below comes out zero either way
  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f > thr;  // disjoint: IoU +0
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, max_nan(uni, 1e-12f)) : 0.0f;
  return iou > thr;
}

// The mask scratch's layout lives in these three places: tiles of a
// problem's scratch, tiles before row tile t's block, and which tile a mask
// block writes (in nms_mask_kernel).
__host__ __device__ __forceinline__ size_t problem_tiles(int cb) {
  return (size_t)cb * (cb + 1) / 2;
}
__host__ __device__ __forceinline__ size_t tile_offset(int t, int cb) {
  return (size_t)t * (2 * cb - t + 1) / 2;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid, int N,
                int cb, float thr, unsigned long long* __restrict__ mask) {
  const int p = blockIdx.y;
  const size_t k = blockIdx.x;  // the tile of the problem this block writes
  // row tile t: the largest t with tile_offset(t) <= k
  const double c2 = 2.0 * cb + 1.0;
  int t = (int)((c2 - sqrt(c2 * c2 - 8.0 * (double)k)) * 0.5);
  t = max(0, min(t, cb - 1));
  while (t > 0 && tile_offset(t, cb) > k) --t;
  while (t + 1 < cb && tile_offset(t + 1, cb) <= k) ++t;
  const int w = t + (int)(k - tile_offset(t, cb));
  const int row = t * kTile + threadIdx.x;
  const int col_start = w * kTile;
  const int cols = min(N - col_start, kTile);
  const float* pb = boxes + (size_t)p * N * 4;

  __shared__ float sbox[kTile * 4];
  __shared__ float sarea[kTile];
  if (threadIdx.x < cols) {
    const float* src = pb + (size_t)(col_start + threadIdx.x) * 4;
    for (int q = 0; q < 4; ++q) sbox[threadIdx.x * 4 + q] = src[q];
    sarea[threadIdx.x] = area(src);
  }
  __syncthreads();

  unsigned long long bits = 0ULL;
  if (row < N && valid[(size_t)p * N + row]) {
    const float* a = pb + (size_t)row * 4;
    const float ab[4] = {a[0], a[1], a[2], a[3]};
    const float area_a = area(ab);
    const int start = (w == t) ? threadIdx.x + 1 : 0;
    for (int j = start; j < cols; ++j) {
      if (iou_over(ab, area_a, &sbox[j * 4], sarea[j], thr)) bits |= 1ULL << j;
    }
  }
  mask[((size_t)p * problem_tiles(cb) + k) * kTile + threadIdx.x] = bits;
}

// Dynamic shared memory of a sweep block: the ring, the removed set and the
// ring's mbarriers.
__host__ __device__ __forceinline__ size_t stage_words(int cb) {
  return (size_t)(cb < kChunk ? cb : kChunk) * kTile;
}
size_t sweep_smem(int cb) {
  return (kStages * stage_words(cb) + cb + kStages) * sizeof(unsigned long long);
}

__global__ void __launch_bounds__(kSweepWarps * 32)
nms_sweep_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                 int N, int cb, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned long long smem[];
  const size_t sw = stage_words(cb);
  unsigned long long* removed = smem + kStages * sw;
  uint64_t* bars = reinterpret_cast<uint64_t*>(removed + cb);
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long* pm = mask + (size_t)p * problem_tiles(cb) * kTile;
  const uint8_t* pv = valid + (size_t)p * N;
  uint8_t* pk = keep + (size_t)p * N;

  // the ring's items: (row tile t, chunk c) for c < ceil((cb - t) / kChunk)
  int items = 0;
  for (int t = 0; t < cb; ++t) items += (cb - t + kChunk - 1) / kChunk;
  int pt = 0, pc = 0;  // thread 0's copy cursor
  auto issue = [&](int s) {
    const int ncols = min(kChunk, cb - pt - pc * kChunk);
    const uint32_t bytes = (uint32_t)ncols * kTile * sizeof(unsigned long long);
    mbar_arrive_expect_tx(&bars[s], bytes);
    bulk_copy(smem + s * sw, pm + (tile_offset(pt, cb) + (size_t)pc * kChunk) * kTile, bytes,
              &bars[s]);
    if (++pc * kChunk >= cb - pt) {
      pc = 0;
      ++pt;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < items; ++s) issue(s);
  }
  // invalid rows and the ragged tail of the last word start removed
  for (int w = warp; w < cb; w += kSweepWarps) {
    const int i0 = w * kTile + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, i0 >= N || !pv[i0]);
    const unsigned hi = __ballot_sync(0xffffffffu, i1 >= N || !pv[i1]);
    if (lane == 0) removed[w] = lo | (unsigned long long)hi << 32;
  }
  __syncthreads();

  unsigned long long kept = 0ULL;  // the current row tile's kept rows
  int t = 0, c = 0;
  for (int i = 0; i < items; ++i) {
    const int s = i % kStages;
    mbar_wait(&bars[s], (uint32_t)(i / kStages) & 1u);
    const unsigned long long* st = smem + s * sw;
    const int ncols = min(kChunk, cb - t - c * kChunk);
    int j0 = 0;
    if (c == 0) {
      // 1. the tile's rows in order: a row not removed is kept and removes
      // the later rows of the tile that it overlaps (its diagonal word). The
      // words are read ahead of the chain, not under each row's test.
      unsigned long long d[kTile];
#pragma unroll
      for (int b = 0; b < kTile; b += 2) {
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(st + b);
        d[b] = v.x;
        d[b + 1] = v.y;
      }
      unsigned long long rem = removed[t];
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        if (!((rem >> b) & 1ULL)) rem |= d[b];
      }
      kept = ~rem;
      // 2. the keep bytes; rows past N are removed, so never kept
      if (warp == 0) {
        const int i0 = t * kTile + lane;
        if (i0 < N) pk[i0] = (uint8_t)((kept >> lane) & 1ULL);
        if (i0 + 32 < N) pk[i0 + 32] = (uint8_t)((kept >> (lane + 32)) & 1ULL);
      }
      j0 = 1;  // the diagonal word column is used up
    }
    // 3. the kept rows remove what they overlap in the later words
    if (kept) {
      for (int j = j0 + warp; j < ncols; j += kSweepWarps) {
        const unsigned long long* col = st + j * kTile;
        const unsigned long long v = (((kept >> lane) & 1ULL) ? col[lane] : 0ULL) |
                                     (((kept >> (lane + 32)) & 1ULL) ? col[lane + 32] : 0ULL);
        const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
        const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
        if (lane == 0) removed[t + c * kChunk + j] |= lo | (unsigned long long)hi << 32;
      }
    }
    __syncthreads();  // removed[] final for the next tile; stage s free
    if (tid == 0 && i + kStages < items) issue(s);
    if (++c * kChunk >= cb - t) {
      c = 0;
      ++t;
    }
  }
}

}  // namespace

// uint64 words of the mask scratch that mxdet_nms_mask_sorted needs for P
// problems of N boxes.
extern "C" long long mxdet_nms_scratch_words(int P, int N) {
  return (long long)P * (long long)problem_tiles((N + kTile - 1) / kTile) * kTile;
}

// Plain C entry point, loaded with ctypes. All pointers are device memory:
// boxes (P, N, 4) f32 score-sorted, valid (P, N) bool, mask scratch of
// mxdet_nms_scratch_words(P, N) uint64, keep (P, N) bool. Launches both
// phases on `stream` and returns the first cudaError_t (0 on success).
extern "C" int mxdet_nms_mask_sorted(const float* boxes, const uint8_t* valid, int P, int N,
                                     float thr, unsigned long long* mask, uint8_t* keep,
                                     void* stream) {
  if (P == 0 || N == 0) return 0;
  const int cb = (N + kTile - 1) / kTile;
  if (cb > kMaxWords || P > 65535) return (int)cudaErrorInvalidValue;
  const size_t tiles = problem_tiles(cb);
  const size_t smem = sweep_smem(cb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaFuncSetAttribute(nms_sweep_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  nms_mask_kernel<<<dim3((unsigned)tiles, P), kTile, 0, s>>>(boxes, valid, N, cb, thr, mask);
  err = (int)cudaGetLastError();
  if (err) return err;
  nms_sweep_kernel<<<P, kSweepWarps * 32, smem, s>>>(mask, valid, N, cb, keep);
  return (int)cudaGetLastError();
}
