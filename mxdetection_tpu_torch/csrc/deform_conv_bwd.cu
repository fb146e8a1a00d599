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
// row times each corner's weight, summed into a zeroed f32 dx. Exact offsets
// are unbounded, so an input pixel cannot know which outputs sample it (the
// TPU kernel walked a clamped +-R window of displacements for that with
// banded MXU products) and a gather form of dx does not exist: the sum is a
// scatter. Scattered straight into dx, one float4 atomic per (pixel, tap,
// corner, 4 channels), as this kernel first did, it ran at the L2's atomic
// rate (188 G vector atomics a second, 36 per output pixel and 4 channels),
// 7x its bytes bound.
//
// So a block owns an output tile of one image (kTH x kTW pixels) and a
// window of dx around it: every input cell that a corner of the tile's taps
// reaches with offsets of at most kReach cells per axis (at dilation 1). It
// builds the tile's tables once: sample_tap's weights and, from each tap's
// unclamped integer corner (tap_corner), the window cell of each corner; then
// it sorts the (entry, corner) terms with a nonzero weight by window cell (a
// counting sort in shared memory), with one more bucket for the corners
// outside the window (an offset beyond kReach, a dilation the window does not
// cover). Then, kCC channels at a time: the entries' dpatch rows are staged
// in shared memory (cp.async), a warp takes a window cell and sums its terms
// __fmul_rn(d, w) in registers, kCV channels a lane, and adds each sum to
// dx with one vector atomic a lane (neighbouring windows overlap, so the add
// stays atomic; a zero sum is skipped, a NaN is not); a spilled term goes
// straight to dx with its own atomic, so exact, unbounded offsets stay
// exact. Every term is the one the plain version adds; only the order of the
// f32 sums differs. Keeping the window's values in shared memory and adding
// each term with a shared f32 atomic was tried: that compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN) and ran no faster than the global
// atomics it replaced (PERF.md).
//
// What the TPU kernels did to fit VMEM and the MXU (banded one-hot matrices,
// the (2R+2)^2 displacement walk, the column-parity lane split, the packed
// offset planes) has no counterpart.
//
// Bound: both kernels move much more than they compute (about 20 and 8 f32
// operations per sampled value), so bytes bound them. A stage-3 layer of the
// Cascade R101-DCN path at batch 8 (52x84x256, bf16) reads dpatch (161 MB)
// and x and writes the patches (161 MB): 0.10 ms at 3.35 TB/s for K6; K7
// reads dpatch and writes a 36 MB f32 dx: 0.06 ms. K6's corner reads hit L2
// (x is 18 MB). K7 reads dpatch once, at the memory's rate, but not while it
// sums: a block stages a chunk, then sums it, and only the SM's second block
// overlaps the two. Its sums (a shared load and kCV multiplies and adds a
// term, 1.26 M terms a chunk at stage 3) and the per-block tables take the
// SMs' time; its atomics (one 4-channel vector per nonzero window cell, a
// few times dx's size, and the spills) resolve in L2. PERF.md gives the
// measured split.
//
// Work layout of K6: one warp per (output pixel, tap); its lanes walk the
// channels four at a time (8-byte bf16 or 16-byte f32 vectors, neighbouring
// lanes on neighbouring channels of one NHWC pixel).

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
// K6 uses no shared memory: each warp keeps its tap sample in registers.

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

// K7 / K7b. The window's margin: offsets of up to kReach cells per axis keep
// every corner of a tile's taps inside its window (at dilation 1).
constexpr int kReach = 3;
constexpr int kC2Threads = 512;   // threads of a col2im block
constexpr int kC2Warps = kC2Threads / 32;
constexpr int kCV = 4;            // channels a lane sums: kCV l .. kCV l + kCV - 1
constexpr int kCC = 32 * kCV;     // channels of a chunk
constexpr int kMinBlocks = 1024;  // ~4 waves of 2 blocks on each of 132 SMs

// A block's output tile, kTH x kTW pixels, per stride.
template <int S> struct Col2imTile;
template <> struct Col2imTile<1> { static constexpr int kTH = 8, kTW = 4; };
template <> struct Col2imTile<2> { static constexpr int kTH = 4, kTW = 8; };

template <typename T, int S> struct Col2imCfg {
  static constexpr int kTH = Col2imTile<S>::kTH, kTW = Col2imTile<S>::kTW;
  // Input rows of the window: the tile's S (kTH - 1) + 1 base rows, the
  // taps' +-1, the reach, and the far corner (y0 + 1); columns alike.
  static constexpr int kWR = S * (kTH - 1) + 2 * kReach + 4;
  static constexpr int kWC = S * (kTW - 1) + 2 * kReach + 4;
  static constexpr int kOrg = kReach + 1;  // the window's first cell: tile start * S - kOrg
  static constexpr int kCells = kWR * kWC;            // cell kCells: the spills
  static constexpr int kEntries = kTH * kTW * kTaps;  // (pixel, tap), pixel-major
  static constexpr int kStageBytes = kEntries * kCC * (int)sizeof(T);  // a chunk of dpatch
  static constexpr int kItemBytes = 4 * kEntries * 8;  // (entry << 2 | corner, weight)
  static constexpr int kSmemBytes =  // + weights, cells, starts, cursors
      kStageBytes + kItemBytes + kEntries * 20 + (2 * kCells + 3) * 4;
  static_assert(kSmemBytes <= 227 * 1024, "the block exceeds the 227 KB it can use");
  static_assert(kWR < 8192 && kWC < 8192, "window cells fit the table's 16-bit coordinates");
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// A lane's kCV channels of a staged dpatch row, as f32.
__device__ __forceinline__ void load_lane(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load_lane(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// dx[0 : kCV] += v, as 4-channel vector atomics (sm_90): with kCV = 2 the
// even lanes add their odd neighbour's pair too; a vector of zeros is
// skipped, a NaN is not. Called by the whole warp.
__device__ __forceinline__ void add_lane(float* dx, const float (&v)[2], int lane, bool live) {
  const float nx = __shfl_down_sync(0xffffffffu, v[0], 1);
  const float ny = __shfl_down_sync(0xffffffffu, v[1], 1);
  if (lane % 2 == 0 && live && (v[0] != 0.0f || v[1] != 0.0f || nx != 0.0f || ny != 0.0f))
    atomicAdd(reinterpret_cast<float4*>(dx), make_float4(v[0], v[1], nx, ny));
}
__device__ __forceinline__ void add_lane(float* dx, const float (&v)[4], int, bool live) {
  if (live && (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f))
    atomicAdd(reinterpret_cast<float4*>(dx), make_float4(v[0], v[1], v[2], v[3]));
}

// The window cell of corner q (0..3 as sample_tap's) of an entry whose
// corner 0 sits at window (row, col) `at`; kCells when outside the window.
template <class C>
__device__ __forceinline__ int corner_cell(short2 at, int q) {
  const int wy = at.x + (q >> 1), wx = at.y + (q & 1);
  if ((unsigned)wy < (unsigned)C::kWR && (unsigned)wx < (unsigned)C::kWC) return wy * C::kWC + wx;
  return C::kCells;
}

// Two blocks an SM with bf16 dpatch; the f32 stage takes twice the shared
// memory, so one, which leaves its threads more registers.
template <typename T, int S>
__global__ void __launch_bounds__(kC2Threads, sizeof(T) == 2 ? 2 : 1)
deform_col2im_kernel(const T* __restrict__ dpatch, const float* __restrict__ offsets,
                     float* __restrict__ dx, Geometry g, int tiles_y, int tiles_x,
                     int chunks_per_block) {
  using C = Col2imCfg<T, S>;
  extern __shared__ __align__(16) unsigned char c2_smem[];
  T* stage = reinterpret_cast<T*>(c2_smem);                 // [kEntries][kCC]
  int2* items = reinterpret_cast<int2*>(c2_smem + C::kStageBytes);  // [4 kEntries], by cell
  float4* wts = reinterpret_cast<float4*>(items + 4 * C::kEntries);   // [kEntries]
  short2* cell0 = reinterpret_cast<short2*>(wts + C::kEntries);       // corner 0's window cell
  int* start = reinterpret_cast<int*>(cell0 + C::kEntries);  // [kCells + 2]: a cell's first item
  int* cursor = start + C::kCells + 2;                       // [kCells + 1]

  const int chunks = (g.Cin + kCC - 1) / kCC;
  const int groups = (chunks + chunks_per_block - 1) / chunks_per_block;
  int bid = blockIdx.x;
  const int grp = bid % groups;
  bid /= groups;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int i0 = ty * C::kTH, j0 = tx * C::kTW;
  const int oy = i0 * S - C::kOrg, ox = j0 * S - C::kOrg;  // the window's first cell
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Stage chunk k's dpatch rows of the tile's entries (cp.async, 8 bytes a
  // copy); the first chunk's copies fly while the tables are built.
  const int k_begin = grp * chunks_per_block, k_end = min(chunks, k_begin + chunks_per_block);
  auto stage_chunk = [&](int k) {
    constexpr int kPer8 = 8 / (int)sizeof(T);  // channels a copy moves
    constexpr int kUnits = kCC / kPer8;        // copies a stage row
    const int c0 = k * kCC;
    for (int v = threadIdx.x; v < C::kEntries * kUnits; v += kC2Threads) {
      const int e = v / kUnits, cu = c0 + (v - e * kUnits) * kPer8;
      const int p = e / kTaps, t = e - p * kTaps;
      const int i = i0 + p / C::kTW, j = j0 + p % C::kTW;
      if (i < g.Ho && j < g.Wo && cu < g.Cin)
        cp_async8(stage + e * kCC + (cu - c0),
                  dpatch + ((size_t)((b * g.Ho + i) * g.Wo + j) * kTaps + t) * g.Cin + cu);
    }
  };
  stage_chunk(k_begin);

  // The tile's tables, once for all its chunks: each (entry, corner) with a
  // nonzero weight, sorted by the window cell it adds to (a counting sort).
  for (int v = threadIdx.x; v <= C::kCells; v += kC2Threads) cursor[v] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < C::kEntries; e += kC2Threads) {
    const int p = e / kTaps, t = e - p * kTaps;
    const int i = i0 + p / C::kTW, j = j0 + p % C::kTW;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // pixels past the map weigh 0
    short2 at = make_short2(0, 0);
    if (i < g.Ho && j < g.Wo) {
      const int m = (b * g.Ho + i) * g.Wo + j;
      const TapSample s = sample_tap(g, offsets, m, t);
      const int2 c = tap_corner(g, offsets, m, t);
      w = make_float4(s.w[0], s.w[1], s.w[2], s.w[3]);
      at = make_short2((short)(c.x - oy), (short)(c.y - ox));
    }
    wts[e] = w;
    cell0[e] = at;
    const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)  // a zero weight: outside the map, or past an integer
      if (wq[q] != 0.0f) atomicAdd(&cursor[corner_cell<C>(at, q)], 1);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts
    int carry = 0;
    for (int base = 0; base <= C::kCells; base += 32) {
      const int v = base + lane;
      const int n = v <= C::kCells ? cursor[v] : 0;
      int incl = n;
#pragma unroll
      for (int k = 1; k < 32; k *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, incl, k);
        if (lane >= k) incl += o;
      }
      if (v <= C::kCells) start[v] = cursor[v] = carry + incl - n;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) start[C::kCells + 1] = carry;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C::kEntries; e += kC2Threads) {
    const float4 w = wts[e];
    const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (wq[q] != 0.0f)
        items[atomicAdd(&cursor[corner_cell<C>(cell0[e], q)], 1)] =
            make_int2(e << 2 | q, __float_as_int(wq[q]));
  }
  __syncthreads();

  for (int k = k_begin; k < k_end; ++k) {
    const int c0 = k * kCC, c = c0 + kCV * lane;
    if (k > k_begin) stage_chunk(k);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // A warp sums a window cell's terms in registers for its kCC channels,
    // then adds them to dx with vector atomics.
    for (int cell = warp; cell < C::kCells; cell += kC2Warps) {
      const int lo = start[cell], hi = start[cell + 1];
      if (lo == hi) continue;
      float acc[kCV] = {};
      for (int it = lo; it < hi; ++it) {
        const int2 term = items[it];
        float d[kCV];
        load_lane(stage + (term.x >> 2) * kCC + kCV * lane, d);
#pragma unroll
        for (int v = 0; v < kCV; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(d[v], __int_as_float(term.y)));
      }
      const int y = oy + cell / C::kWC, x = ox + cell % C::kWC;  // in the map: it has terms
      add_lane(dx + ((size_t)(b * g.H + y) * g.W + x) * g.Cin + c, acc, lane, c < g.Cin);
    }
    // Spills: corners outside the window, one term a warp, straight into dx.
    for (int it = start[C::kCells] + warp; it < start[C::kCells + 1]; it += kC2Warps) {
      const int2 term = items[it];
      const int e = term.x >> 2, q = term.x & 3;
      const short2 at = cell0[e];
      const int y = oy + at.x + (q >> 1), x = ox + at.y + (q & 1);
      float d[kCV];
      load_lane(stage + e * kCC + kCV * lane, d);
#pragma unroll
      for (int v = 0; v < kCV; ++v) d[v] = __fmul_rn(d[v], __int_as_float(term.y));
      add_lane(dx + ((size_t)(b * g.H + y) * g.W + x) * g.Cin + c, d, lane, c < g.Cin);
    }
    __syncthreads();  // the stage is refilled
  }
}

template <typename T, int S>
cudaError_t launch_col2im(const T* dpatch, const float* offsets, float* dx, const Geometry& g,
                          int B, cudaStream_t stream) {
  using C = Col2imCfg<T, S>;
  cudaError_t err = cudaFuncSetAttribute(deform_col2im_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_y = (g.Ho + C::kTH - 1) / C::kTH, tiles_x = (g.Wo + C::kTW - 1) / C::kTW;
  const long long tiles = (long long)B * tiles_y * tiles_x;
  const int chunks = (g.Cin + kCC - 1) / kCC;
  // As many chunks a block as keeps kMinBlocks in the grid: a block builds
  // its tables once for all of them.
  int per = chunks;
  while (per > 1 && tiles * ((chunks + per - 1) / per) < kMinBlocks) per = (per + 1) / 2;
  const long long blocks = tiles * ((chunks + per - 1) / per);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  deform_col2im_kernel<T, S><<<(unsigned)blocks, kC2Threads, C::kSmemBytes, stream>>>(
      dpatch, offsets, dx, g, tiles_y, tiles_x, per);
  return cudaGetLastError();
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

// dx (B, H, W, C) f32, zeroed by the caller; stride 1 or 2; H and W at
// most 16384 (the tables keep window cells in 16 bits).
extern "C" int mxdet_deform_col2im(const void* dpatch, const float* offsets, float* dx, int B,
                                   int H, int W, int C, int Ho, int Wo, int stride,
                                   int dilation, float radius, int is_bf16, void* stream) {
  Geometry g;
  unsigned blocks;
  if (!geometry(B, H, W, C, Ho, Wo, stride, dilation, radius, &g, &blocks) ||
      (stride != 1 && stride != 2) || H > 16384 || W > 16384)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* d = static_cast<const __nv_bfloat16*>(dpatch);
    return (int)(stride == 1 ? launch_col2im<__nv_bfloat16, 1>(d, offsets, dx, g, B, s)
                             : launch_col2im<__nv_bfloat16, 2>(d, offsets, dx, g, B, s));
  }
  const auto* d = static_cast<const float*>(dpatch);
  return (int)(stride == 1 ? launch_col2im<float, 1>(d, offsets, dx, g, B, s)
                           : launch_col2im<float, 2>(d, offsets, dx, g, B, s));
}

// What the col2im kernel decides at this stride for bf16 (is_bf16) or f32
// dpatch, for the plain model (ops/cuda/deform_conv.py::col2im_config) to be
// held against: out = {tile rows, tile cols, window rows, window cols,
// window origin (kOrg), channels a chunk, dynamic shared memory in bytes}.
// Returns 0, or cudaErrorInvalidValue for a stride it does not take.
template <typename T, int S> int col2im_layout(int* out) {
  using C = Col2imCfg<T, S>;
  const int v[7] = {C::kTH, C::kTW, C::kWR, C::kWC, C::kOrg, kCC, C::kSmemBytes};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

extern "C" int mxdet_deform_col2im_layout(int stride, int is_bf16, int* out) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return stride == 1 ? col2im_layout<__nv_bfloat16, 1>(out)
                       : col2im_layout<__nv_bfloat16, 2>(out);
  return stride == 1 ? col2im_layout<float, 1>(out) : col2im_layout<float, 2>(out);
}
