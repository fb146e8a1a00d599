// Deformable convolution v1 backward (3x3), sm_90a: the two kernels that
// follow dpatch = g @ W^T in ops/dcn.py::deform_conv2d_backward.
//
// Replaces the four TPU kernels of mxdetection_tpu/ops/pallas/dcn.py:
//   _patches_kernel (K6, stride 1, :261) and _patches_kernel_s2 (K6b, stride
//   2, :894), with the XLA product dW = patches^T g and the channel
//   reductions of dpatch * dsy / dsx that follow them (:564-580, :1052-1067)
//   -> the fused weight-gradient kernels, wg::wgrad_kernel (bf16) and
//   wgf32::wgrad_f32_kernel (f32);
//   _dx_kernel (K7, stride 1, :345) and _dx_kernel_s2 (K7b, stride 2, :804)
//   -> deform_col2im_kernel.
// Each serves both strides (and any dilation), with stride and dilation as
// arguments, as the forward (csrc/deform_conv.cu) does. The tap samples and
// the four-corner blend are the forward's (deform_common.cuh), so the patch
// values the weight gradient multiplies are bit-identical to the rows the
// forward multiplied by W. Semantics are those of the plain versions,
// ops/dcn.py::deform_wgrad_doffsets and deform_col2im, whose gradient
// convention is autodiff's of the gather: ly = sy - floor(sy) with the floor
// contributing nothing (at an integer sample position the derivative is
// one-sided, v(y0 + 1) - v(y0)), and a corner outside the map weighs zero in
// value and in derivative.
//
// The weight gradient (K6 / K6b) computes, in one pass over the pixels,
//   dW[t C + c, n] = sum_m patch[m, t, c] g[m, n]       (f32, (9C, Cout)),
//   doy[m, t] = sum_c dpatch[m, t C + c] ((1-lx)(v10-v00) + lx(v11-v01)),
//   dox[m, t] = sum_c dpatch[m, t C + c] ((1-ly)(v01-v00) + ly(v11-v10)),
// with v the corner values (zero outside the map), the offset gradient zero
// where radius clamps the offset. The TPU kernel wrote the patch rows and the
// derivative samples dsy, dsx (each 9x the activation) for XLA to multiply and
// reduce; the kernel before this one still wrote the patch rows (161 MB of
// bf16 at a stage-3 layer of the Cascade R101-DCN path at batch 8) for a
// torch.matmul to read back. Here the patch values live only in shared
// memory, as the A operand of a tensor-core product.
//
// bf16 (wg::wgrad_kernel, the main path). A block owns a dW tile of 64 rows
// (one tap t, channels c0 .. c0 + 63) x BN output channels (all of Cout =
// 128, else 256: two column tiles at Cout = 512) and walks a slice of the
// M = B * Ho * Wo pixels in chunks of 64, the product's K. Three warpgroups,
// specialised, as the forward:
//  - two producer warpgroups. Every 4 chunks, one thread a pixel computes the
//    tap samples of the 4 chunks after the next into a table in shared
//    memory (corner offsets, weights, fractions), from offsets it loaded 4
//    chunks before; a barrier of the producers publishes each table. Per
//    chunk, 8 threads a pixel load its four corners' 64 channels as 16-byte
//    vectors, blend in f32 in the plain order, round to bf16 and store each
//    vector into the stage's A tile; from the same registers and the pixel's
//    dpatch vector (read past L1, so L1 keeps the corners' reuse) each thread
//    sums dpatch * v for each corner over its 8 channels; the 8 threads' sums
//    are added by shuffles and one thread turns them into the pixel's doy and
//    dox (offset_grad) and writes them to a partial per 64-channel chunk (only
//    column tile 0 does); one thread brings g's rows of the chunk into the
//    stage's B tile with one cp.async.bulk;
//  - one consumer warpgroup runs wgmma.mma_async m64 n{BN} k16 bf16 -> f32
//    over the stage, accumulators in registers;
//  - a ring of 3 stages (40 KB each at BN = 256) with a full and an empty
//    mbarrier each; 3 rather than 4, and no loads in flight across chunks,
//    measured faster: the shared memory a block leaves to L1 holds the
//    gather's reuse (PERF.md).
// Operand layout: the reduction index is the pixel, a pixel's 64 channels are
// one 128-byte row of A and g's rows are Cout-contiguous, so both operands
// are MN-major (hopper_common.cuh): A (64 channels x 64 pixels) is 64 rows
// of one pixel each, 16-byte chunk j of row r at chunk j ^ (r % 8), exactly
// the forward's A store; B is BN / 64 blocks of 64 pixel rows x 64 output
// channels in the same swizzle. The wgmma reads both with its transpose bits
// set. g reaches that layout by a pass over it before the kernel
// (g_tiles_kernel: one read and one write of g, 18 MB at stage 3, every
// 16-byte vector moved whole; plain version ops/cuda/deform_conv.py::
// wgmma_g_tiles), which also zero-fills the rows of the ragged last chunk, so
// a stage's B tile is one contiguous bulk copy and no tensor map (-lcuda) is
// needed; the producers zero the ragged chunk's A rows, so no product reads
// past M or multiplies garbage.
// Cross-block sums, deterministic: the slices of M write partial dW tiles to
// an f32 workspace [S, 9C, Cout] (or, with one slice, dW itself) and the
// (pixel, tap) offset gradient is split over the C / 64 channel chunks into a
// workspace [C / 64, M, 18]; wgrad_finish_kernel sums both in a fixed order
// and applies the clip mask. S is chosen by wgrad_slices so the grid is close
// to a whole number of waves of one block an SM (plain model:
// ops/cuda/deform_conv.py::wgrad_config, which reads the constants below).
// Registers: as the forward, an m64n256 wgmma needs 154 and ptxas gives 168
// at 384 threads, so a block has three warpgroups (setmaxnreg does not let
// ptxas compile the consumer above the launch bound's share; a block of two
// m64n128 consumers and three producer warpgroups, 640 threads, ran no
// faster, PERF.md).
//
// f32 (wgf32::wgrad_f32_kernel, used only by the card-vs-CPU checks): wgmma
// takes no f32 operands, so the same decomposition on CUDA cores: 64 dW rows
// x 64 columns a block of 128 threads, FMAs from static shared memory.
//
// Bound: a stage-3 layer reads x (18 MB), dpatch (161 MB), g (18 MB) and the
// offsets and writes dW and doffsets once: about 204 MB, 0.061 ms at 3.35
// TB/s; its product is 41.2 GFLOP, 0.042 ms on the tensor cores, and its
// blend and derivatives about 21 f32 operations a sampled value, 0.025 ms.
// What takes the time is the producers: the gather and blend, as in the
// forward but with a tap fixed a block, so corner lines are reused only
// between neighbouring pixels, and the offset gradient (the dpatch stream, 4
// FMAs a value and the shuffles), a third of it. PERF.md gives the measured
// split (ops/cuda/k6_variants.py).
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
// K7's bound: it reads dpatch and writes a 36 MB f32 dx (0.06 ms at stage 3)
// and does about 8 f32 operations per sampled value. It reads dpatch once,
// at the memory's rate, but not while it sums: a block stages a chunk, then
// sums it, and only the SM's second block overlaps the two. Its sums (a
// shared load and kCV multiplies and adds a term, 1.26 M terms a chunk at
// stage 3) and the per-block tables take the SMs' time; its atomics (one
// 4-channel vector per nonzero window cell, a few times dx's size, and the
// spills) resolve in L2. PERF.md gives the measured split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "deform_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace mxdet_dcn;
using namespace mxdet_hopper;

// ---------------------------------------------------------------- K6 / K6b

constexpr int kWgRows = 64;       // dW rows a block owns: one tap, 64 channels
constexpr int kWgPix = 64;        // pixels a chunk: the product's K
constexpr int kWgMinChunks = 32;  // chunks a slice of M walks at least
constexpr int kWgMaxSlices = 16;  // slices of M at most

// The slices of M for `tiles` output tiles of `chunks` pixel chunks each, on
// `sms` SMs with one block each: the S in [1, most] whose grid wastes the
// least of its last wave, ceil(tiles * S / sms) / S least, the fewest slices
// among equals; `most` keeps kWgMinChunks chunks a slice.
int wgrad_slices(int tiles, int chunks, int sms) {
  const int most = std::max(1, std::min(kWgMaxSlices, chunks / kWgMinChunks));
  int best = 1;
  long long best_waves = ((long long)tiles + sms - 1) / sms;
  for (int s = 2; s <= most; ++s) {
    const long long waves = ((long long)tiles * s + sms - 1) / sms;
    if (waves * best < best_waves * s) {
      best = s;
      best_waves = waves;
    }
  }
  return best;
}

// One output tile's place: the tap and first channel of its rows.
__device__ __forceinline__ void row_tile(const Geometry& g, int rt, int* t, int* c0) {
  *t = rt * kWgRows / g.Cin;
  *c0 = rt * kWgRows - *t * g.Cin;
}

namespace wg {

constexpr int kConsumerThreads = 128;  // one warpgroup issuing wgmma
constexpr int kProducerThreads = 256;  // two warpgroups gathering
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kRowBytes = 128;                      // 64 bf16 values: one swizzle row
constexpr int kRowsPerPass = kProducerThreads / 8;  // 8 producer threads a pixel
constexpr int kPasses = kWgPix / kRowsPerPass;      // pixels a producer thread blends a chunk
constexpr int kAhead = 0;  // chunks whose loads are in flight during a blend (PERF.md)
constexpr int kBatch = 4;  // chunks of one sample table: one producer thread a pixel
constexpr int kTabSlots = 3;  // tables: in use, published for the next batch, being filled
static_assert(65536 / kThreads / 8 * 8 >= 154, "the consumers' wgmma needs 154 registers");
static_assert(kWgRows * 2 == kRowBytes, "a pixel's 64 channels are one 128-byte swizzle row");
static_assert(kWgPix % kRowsPerPass == 0 && kWgPix % 16 == 0, "whole passes, whole k16 steps");
static_assert(kBatch * kWgPix == kProducerThreads, "one producer thread a pixel of a batch");
static_assert(kAhead <= kBatch, "a chunk's loads read this batch's table or the next one's");

// A pixel's sample of the block's tap: the element offsets of its four
// corners in x (the entry point refuses x of 2^31 elements or more), their
// masked bilinear weights, the fractions (ly, lx) and which corners lie in
// the map (bit q). A pixel past M is all zeros.
struct __align__(16) PixSample {
  int off[4];
  float w[4];
  float ly, lx;
  unsigned inb;
  unsigned pad;
};

// The offset gradient of a pixel from its four corners' channel sums
// S_q = sum_c dpatch_c v_q,c:
//   doy = -hx i00 S00 - lx i01 S01 + hx i10 S10 + lx i11 S11,
//   dox = -hy i00 S00 + hy i01 S01 - ly i10 S10 + ly i11 S11
// (hy = 1 - ly, hx = 1 - lx, iq = 1 if corner q lies in the map): the
// plain version's sum_c dpatch ((1-lx)(v10-v00) + lx(v11-v01)) and its dox
// counterpart, summed in another order.
__device__ __forceinline__ float2 offset_grad(const PixSample& e, const float (&sq)[4]) {
  const float hy = 1.0f - e.ly, hx = 1.0f - e.lx;
  const float cy[4] = {-hx, -e.lx, hx, e.lx}, cx[4] = {-hy, hy, -e.ly, e.ly};
  float doy = 0.0f, dox = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (e.inb & (1u << q)) {
      doy = fmaf(cy[q], sq[q], doy);
      dox = fmaf(cx[q], sq[q], dox);
    }
  return make_float2(doy, dox);
}

// 16 bytes of a stream read once (dpatch), kept out of L1 so the corner
// gather keeps it.
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int BN>
struct Cfg {
  static_assert(BN == 128 || BN == 256, "wgmma tiles of 128 or 256 output channels");
  // 3, not 4: the shared memory a block leaves to L1 holds the corner
  // gather's reuse (PERF.md)
  static constexpr int kStages = 3;
  static constexpr int kABytes = kWgPix * kRowBytes;  // 64 pixels x 64 channels
  static constexpr int kBlockBytes = kWgPix * kRowBytes;  // one 64-column block of B
  static constexpr int kBBytes = (BN / 64) * kBlockBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kTableBytes = kTabSlots * kBatch * kWgPix * (int)sizeof(PixSample);
  // + 1024: the dynamic base is rounded up to the swizzle's 1024-byte period
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kTableBytes + 2 * kStages * 8;
  static_assert(kStageBytes % 1024 == 0, "every A and B tile starts 1024-byte aligned");
  static_assert(kSmemBytes <= 227 * 1024, "the ring exceeds the 227 KB a block can use");
  static_assert(kSmemBytes > 48 * 1024, "dynamic shared memory above the static cap");
};

// The sample of pixel m for tap t displaced by `off`, or zeros where it is
// not `live` (past M, or past the block's chunks).
__device__ __forceinline__ PixSample pixel_sample(const Geometry& g, int m, int t, float2 off,
                                                  bool live) {
  PixSample e;
  e.pad = 0u;
  if (!live) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      e.off[q] = 0;
      e.w[q] = 0.0f;
    }
    e.ly = e.lx = 0.0f;
    e.inb = 0u;
    return e;
  }
  const TapSample s = sample_tap_at(g, m, t, off.x, off.y);
  e.inb = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    e.off[q] = (int)s.off[q];
    e.w[q] = s.w[q];
    e.inb |= (unsigned)s.inb[q] << q;
  }
  e.ly = s.ly;
  e.lx = s.lx;
  return e;
}

// What one producer thread loads for a chunk: for each of its pixels the
// four corners' 16-byte vector of its 8 channels, their weights, and the
// pixel's dpatch vector of the same channels.
struct Frag {
  uint4 q[kPasses][4];
  uint4 d[kPasses];
  float4 w[kPasses];
};

__device__ __forceinline__ void load_chunk(Frag& f, const Geometry& g,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ dpatch,
                                           const PixSample* tab, int kc, int t, int c0, int row0,
                                           int vec, bool with_doff) {
  const __nv_bfloat16* xv = x + c0 + vec * 8;
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int r = row0 + kRowsPerPass * u, m = kc * kWgPix + r;
    const int4 off = *reinterpret_cast<const int4*>(tab[r].off);  // 0 past M: a valid address
    f.w[u] = *reinterpret_cast<const float4*>(tab[r].w);
    f.q[u][0] = __ldg(reinterpret_cast<const uint4*>(xv + off.x));
    f.q[u][1] = __ldg(reinterpret_cast<const uint4*>(xv + off.y));
    f.q[u][2] = __ldg(reinterpret_cast<const uint4*>(xv + off.z));
    f.q[u][3] = __ldg(reinterpret_cast<const uint4*>(xv + off.w));
    f.d[u] = make_uint4(0u, 0u, 0u, 0u);
    if (with_doff && m < g.M)
      f.d[u] = load_stream(dpatch + (size_t)m * (kTaps * g.Cin) + t * g.Cin + c0 + vec * 8);
  }
}

// Blend a chunk's corners in f32 in the plain order, round to bf16 and store
// each vector at its swizzled place in the A tile `a` (zeros past M); with
// `with_doff`, sum dpatch * v over the thread's channels for each corner,
// add the sums of the pixel's 8 threads by shuffles and write the pixel's
// doy and dox to the partial of channel chunk `cc`.
__device__ __forceinline__ void store_chunk(const Frag& f, const Geometry& g, unsigned char* a,
                                            const PixSample* tab, float* __restrict__ doff_ws,
                                            int kc, int t, int cc, int row0, int vec,
                                            bool with_doff) {
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int r = row0 + kRowsPerPass * u, m = kc * kWgPix + r;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m < g.M) {
      const float w[4] = {f.w[u].x, f.w[u].y, f.w[u].z, f.w[u].w};
      __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
      const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&f.d[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = to_f32(reinterpret_cast<const __nv_bfloat16*>(&f.q[u][q])[e]);
        pe[e] = from_f32<__nv_bfloat16>(blend(v[0], v[1], v[2], v[3], w));
        if (with_doff) {
          const float d = to_f32(de[e]);
#pragma unroll
          for (int q = 0; q < 4; ++q) sq[q] = fmaf(d, v[q], sq[q]);
        }
      }
    }
    *reinterpret_cast<uint4*>(a + r * kRowBytes + ((vec ^ (r & 7)) << 4)) = packed;
    if (with_doff) {  // block-uniform: every lane of the warp shuffles
#pragma unroll
      for (int k = 1; k < 8; k *= 2)
#pragma unroll
        for (int q = 0; q < 4; ++q) sq[q] += __shfl_xor_sync(0xffffffffu, sq[q], k);
      if (vec == 0 && m < g.M)
        *reinterpret_cast<float2*>(doff_ws + ((size_t)cc * g.M + m) * (2 * kTaps) + 2 * t) =
            offset_grad(tab[r], sq);
    }
  }
}

// x (B, H, W, C) bf16; gtiles g's MN-major tiles (Cout / BN, chunks, BN / 64,
// 64, 64), see mxdet_deform_wgrad_doffsets; dw_part (slices, 9C, Cout) f32
// (dW itself when there is one slice); doff_ws (C / 64, M, 18) f32.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ offsets,
             const __nv_bfloat16* __restrict__ dpatch, const __nv_bfloat16* __restrict__ gtiles,
             float* __restrict__ dw_part, float* __restrict__ doff_ws, Geometry g, int slices) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  PixSample* tabs = reinterpret_cast<PixSample*>(smem + C::kStages * C::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(tabs + kTabSlots * kBatch * kWgPix);
  uint64_t* empty = full + C::kStages;

  const int rt = blockIdx.x, nt = blockIdx.y, slice = blockIdx.z;
  int t, c0;
  row_tile(g, rt, &t, &c0);
  const int chunks = (g.M + kWgPix - 1) / kWgPix;
  const int k_begin = (int)((long long)slice * chunks / slices);
  const int nk = (int)((long long)(slice + 1) * chunks / slices) - k_begin;
  const bool with_doff = nt == 0;  // one column tile writes the offset gradient

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], kProducerThreads + 1);  // + the g copy's expect_tx arrival
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producers. The samples of a batch of kBatch chunks, one thread a
    // pixel, go into table slot (batch % kTabSlots) two batches before the
    // batch is blended, from offsets loaded one batch before that; a barrier
    // of the producers at each batch publishes the table filled at the last
    // one and frees the slot of the batch before. A chunk's corner loads are
    // issued kAhead chunks before its blend (unrolled, so each fragment index
    // is a constant).
    const int p = threadIdx.x - kConsumerThreads;
    const int vec = p & 7, row0 = p >> 3;
    const int batches = (nk + kBatch - 1) / kBatch;
    const int pb = p / kWgPix;  // this thread's pixel of a batch: chunk pb, row p % kWgPix
    auto chunk_pixel = [&](int batch) { return (k_begin + batch * kBatch + pb) * kWgPix + p % kWgPix; };
    auto live = [&](int batch) {
      return batch < batches && batch * kBatch + pb < nk && chunk_pixel(batch) < g.M;
    };
    auto offset_of = [&](int batch) {
      return live(batch) ? *reinterpret_cast<const float2*>(
                               offsets + (size_t)chunk_pixel(batch) * (2 * kTaps) + 2 * t)
                         : make_float2(0.0f, 0.0f);
    };
    auto fill = [&](int batch, float2 off) {
      if (batch < batches)
        tabs[(batch % kTabSlots) * kBatch * kWgPix + p] =
            pixel_sample(g, chunk_pixel(batch), t, off, live(batch));
    };
    auto table = [&](int i) {  // chunk i's 64 entries
      return tabs + ((i / kBatch) % kTabSlots) * kBatch * kWgPix + (i % kBatch) * kWgPix;
    };
    fill(0, offset_of(0));
    fill(1, offset_of(1));
    float2 next_off = offset_of(2);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
    Frag f[kAhead + 1];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (j < nk)
        load_chunk(f[j], g, x, dpatch, table(j), k_begin + j, t, c0, row0, vec, with_doff);
    for (int i0 = 0; i0 < nk; i0 += kAhead + 1) {
#pragma unroll
      for (int j = 0; j <= kAhead; ++j) {
        const int i = i0 + j;
        if (i >= nk) break;
        if (i % kBatch == 0) {
          const int batch = i / kBatch;
          if (batch > 0) asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
          fill(batch + 2, next_off);
          next_off = offset_of(batch + 3);
        }
        if (i + kAhead < nk)
          load_chunk(f[(j + kAhead) % (kAhead + 1)], g, x, dpatch, table(i + kAhead),
                     k_begin + i + kAhead, t, c0, row0, vec, with_doff);
        const int s = i % C::kStages;
        mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
        unsigned char* a = smem + s * C::kStageBytes;
        if (p == 0) {
          mbar_arrive_expect_tx(&full[s], C::kBBytes);
          bulk_copy(a + C::kABytes,
                    gtiles + ((size_t)nt * chunks + k_begin + i) * kWgPix * BN, C::kBBytes,
                    &full[s]);
        }
        store_chunk(f[j], g, a, table(i), doff_ws, k_begin + i, t, c0 / kWgRows, row0, vec,
                    with_doff);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumer: wgmma over the ring (A and B MN-major), then the epilogue
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::kStages;
      mbar_wait(&full[s], (i / C::kStages) & 1);
      const uint32_t a = smem_u32(smem + s * C::kStageBytes);
      const uint32_t b = a + C::kABytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWgPix / 16; ++kk)  // k16 steps: 16 pixel rows, 2048 bytes
        wgmma_bf16<BN, 1>(acc, smem_desc_mn(a + 16 * kRowBytes * kk, C::kBlockBytes),
                          smem_desc_mn(b + 16 * kRowBytes * kk, C::kBlockBytes));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0) mbar_arrive(&empty[(i - 1) % C::kStages]);  // chunk i-1's products are done
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
    // 16w + l/4 and 16w + l/4 + 8 (channels), columns 8c + 2(l%4) + {0, 1}
    const int lane = threadIdx.x % 32;
    const int row = rt * kWgRows + (threadIdx.x / 32) * 16 + lane / 4;
    const int cout = g.Cout;
    float* o = dw_part + ((size_t)slice * kTaps * g.Cin + row) * cout + nt * BN + (lane % 4) * 2;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      *reinterpret_cast<float2*>(o + 8 * c) = make_float2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<float2*>(o + (size_t)8 * cout + 8 * c) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// g (M, Cout) row-major -> its MN-major swizzled tiles (see
// mxdet_deform_wgrad_doffsets); one thread a 16-byte vector of the tiles,
// which is a whole 16-byte vector of g or, past M, zeros.
__global__ void __launch_bounds__(256)
g_tiles_kernel(const __nv_bfloat16* __restrict__ gm, __nv_bfloat16* __restrict__ tiles, int M,
               int Cout, int BN, int chunks) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long long)chunks * kWgPix * Cout / 8) return;
  const int s = (int)(v % 8);
  const int k = (int)(v / 8 % kWgPix);
  const long long blk = v / (8 * kWgPix);  // ((j * chunks + kc) * BN / 64 + a)
  const int a = (int)(blk % (BN / 64));
  const int kc = (int)(blk / (BN / 64) % chunks), j = (int)(blk / (BN / 64) / chunks);
  const int m = kc * kWgPix + k;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (m < M)
    out = __ldg(reinterpret_cast<const uint4*>(gm + (size_t)m * Cout + BN * j + 64 * a +
                                               8 * (s ^ (k % 8))));
  reinterpret_cast<uint4*>(tiles)[v] = out;
}

// The bf16 kernel's output-channel tile for this Cout, 0 if it takes none.
int tile_n(int Cout) { return Cout == 128 ? 128 : Cout > 0 && Cout % 256 == 0 ? 256 : 0; }

template <int BN>
cudaError_t launch(const __nv_bfloat16* x, const float* offsets, const __nv_bfloat16* dpatch,
                   const __nv_bfloat16* gtiles, float* dw_part, float* doff_ws, const Geometry& g,
                   int slices, cudaStream_t stream) {
  using C = Cfg<BN>;
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(kTaps * g.Cin / kWgRows), (unsigned)(g.Cout / BN), (unsigned)slices);
  wgrad_kernel<BN><<<grid, kThreads, C::kSmemBytes, stream>>>(x, offsets, dpatch, gtiles, dw_part,
                                                              doff_ws, g, slices);
  return cudaGetLastError();
}

}  // namespace wg

namespace wgf32 {

constexpr int kBN = 64;  // output channels a block
constexpr int kThreads = 128;
constexpr unsigned kLive = 16;  // the pixel lies in M (bits 0-3: its corners in the map)

// The derivative terms of one channel: the corner values masked to zero
// outside the map, as the plain version's.
__device__ __forceinline__ void add_offset_terms(float d, float v00, float v01, float v10,
                                                 float v11, unsigned inb, float ly, float lx,
                                                 float* doy, float* dox) {
  const float m00 = (inb & 1) ? v00 : 0.0f, m01 = (inb & 2) ? v01 : 0.0f;
  const float m10 = (inb & 4) ? v10 : 0.0f, m11 = (inb & 8) ? v11 : 0.0f;
  *doy = fmaf(d, (1.0f - lx) * (m10 - m00) + lx * (m11 - m01), *doy);
  *dox = fmaf(d, (1.0f - ly) * (m01 - m00) + ly * (m11 - m10), *dox);
}

struct Smem {
  float a[kWgPix][kWgRows + 4];  // patch values: a pixel's 64 channels a row
  float b[kWgPix][kBN + 4];      // g's rows of the chunk
  long long corner_off[4][kWgPix];
  float corner_w[4][kWgPix];
  float ly[kWgPix], lx[kWgPix];
  unsigned flags[kWgPix];  // kLive | corner q in the map << q
};
// Static shared memory is capped at 48 KB a block.
static_assert(sizeof(Smem) <= 48 * 1024, "f32 tiles exceed static shared memory");

// The same decomposition as the bf16 kernel, on CUDA cores: a block owns 64
// dW rows x 64 columns and walks its slice of M 64 pixels at a time; 16
// threads a pixel gather 4 channels each (their doy and dox reduced by
// shuffles), then each thread adds a 4 x 8 block of dW with FMAs.
__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                 const float* __restrict__ dpatch, const float* __restrict__ gm,
                 float* __restrict__ dw_part, float* __restrict__ doff_ws, Geometry g, int slices) {
  __shared__ __align__(16) Smem s;
  const int rt = blockIdx.x, n0 = blockIdx.y * kBN, slice = blockIdx.z;
  int t, c0;
  row_tile(g, rt, &t, &c0);
  const int cc = c0 / kWgRows;
  const int chunks = (g.M + kWgPix - 1) / kWgPix;
  const int k_begin = (int)((long long)slice * chunks / slices);
  const int k_end = (int)((long long)(slice + 1) * chunks / slices);
  const bool with_doff = blockIdx.y == 0;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;  // rows tr*4.., cols tc*8..
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kc = k_begin; kc < k_end; ++kc) {
    const int m0 = kc * kWgPix;
    for (int r = threadIdx.x; r < kWgPix; r += kThreads) {
      unsigned flags = 0u;
      if (m0 + r < g.M) {
        const TapSample p = sample_tap(g, offsets, m0 + r, t);
        for (int q = 0; q < 4; ++q) {
          s.corner_off[q][r] = p.off[q];
          s.corner_w[q][r] = p.w[q];
          flags |= (unsigned)p.inb[q] << q;
        }
        s.ly[r] = p.ly;
        s.lx[r] = p.lx;
        flags |= kLive;
      } else {  // ragged tail: a zero row, read from a valid address
        for (int q = 0; q < 4; ++q) {
          s.corner_off[q][r] = 0;
          s.corner_w[q][r] = 0.0f;
        }
        s.ly[r] = s.lx[r] = 0.0f;
      }
      s.flags[r] = flags;
    }
    __syncthreads();
    // A: 16 threads a pixel, 4 channels each; every thread takes 8 (pixel,
    // 4 channels) a chunk, so the shuffles below see whole warps
    constexpr int kPerRow = kWgRows / 4;
    for (int v = threadIdx.x; v < kWgPix * kPerRow; v += kThreads) {
      const int r = v / kPerRow, cv = (v - r * kPerRow) * 4;
      const unsigned flags = s.flags[r];
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float doy = 0.0f, dox = 0.0f;
      if (flags & kLive) {
        const float* base = x + c0 + cv;
        float q[4][4];
        const float w[4] = {s.corner_w[0][r], s.corner_w[1][r], s.corner_w[2][r],
                            s.corner_w[3][r]};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 qv = __ldg(reinterpret_cast<const float4*>(base + s.corner_off[k][r]));
          q[k][0] = qv.x;
          q[k][1] = qv.y;
          q[k][2] = qv.z;
          q[k][3] = qv.w;
        }
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (with_doff) {
          const float4 dv = __ldg(reinterpret_cast<const float4*>(
              dpatch + (size_t)(m0 + r) * (kTaps * g.Cin) + t * g.Cin + c0 + cv));
          d[0] = dv.x;
          d[1] = dv.y;
          d[2] = dv.z;
          d[3] = dv.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = blend(q[0][e], q[1][e], q[2][e], q[3][e], w);
          if (with_doff)
            add_offset_terms(d[e], q[0][e], q[1][e], q[2][e], q[3][e], flags, s.ly[r], s.lx[r],
                             &doy, &dox);
        }
      }
      *reinterpret_cast<float4*>(&s.a[r][cv]) = make_float4(o[0], o[1], o[2], o[3]);
      if (with_doff) {  // block-uniform: whole warps shuffle
#pragma unroll
        for (int k = 1; k < kPerRow; k *= 2) {
          doy += __shfl_xor_sync(0xffffffffu, doy, k);
          dox += __shfl_xor_sync(0xffffffffu, dox, k);
        }
        if (cv == 0 && (flags & kLive))
          *reinterpret_cast<float2*>(doff_ws + ((size_t)cc * g.M + m0 + r) * (2 * kTaps) +
                                     2 * t) = make_float2(doy, dox);
      }
    }
    // B: g's rows of the chunk, zero past M
    for (int v = threadIdx.x; v < kWgPix * (kBN / 4); v += kThreads) {
      const int r = v / (kBN / 4), cv = (v - r * (kBN / 4)) * 4;
      float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + r < g.M)
        b = __ldg(reinterpret_cast<const float4*>(gm + (size_t)(m0 + r) * g.Cout + n0 + cv));
      *reinterpret_cast<float4*>(&s.b[r][cv]) = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kWgPix; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[k][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = s.b[k][tc * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* dst = dw_part + ((size_t)slice * kTaps * g.Cin + rt * kWgRows + tr * 4 + i) * g.Cout +
                 n0 + tc * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace wgf32

// dW = the sum of the slices' partials (n_dw4 float4s each; 0 when the one
// slice wrote dW itself), then doffsets = the sum of the channel chunks'
// partials, zero where radius clamped the offset; both summed in a fixed
// order, one thread a float4 of dW or a value of doffsets.
__global__ void __launch_bounds__(256)
wgrad_finish_kernel(const float4* __restrict__ dw_part, int slices, long long n_dw4,
                    float4* __restrict__ dw, const float* __restrict__ doff_ws, int chunks_c,
                    long long n_doff, const float* __restrict__ offsets, float radius,
                    float* __restrict__ doff) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw4) {
    const float4* src = dw_part + i;
    float4 acc = *src;
    for (int s = 1; s < slices; ++s) {
      src += n_dw4;
      const float4 v = *src;
      acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
    }
    dw[i] = acc;
    return;
  }
  const long long j = i - n_dw4;
  if (j >= n_doff) return;
  const float* src = doff_ws + j;
  float v = *src;
  for (int c = 1; c < chunks_c; ++c) {
    src += n_doff;
    v += *src;
  }
  if (radius >= 0.0f && !(offsets[j] >= -radius && offsets[j] <= radius)) v = 0.0f;
  doff[j] = v;
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
              float radius, int channel_multiple, Geometry* g) {
  if (B < 0 || H < 1 || W < 1 || Ho < 0 || Wo < 0 || C < channel_multiple ||
      C % channel_multiple != 0 || stride < 1 || dilation < 1)
    return false;
  const long long m = (long long)B * Ho * Wo;
  if (m > 0x7fffffffLL - kWgPix) return false;
  *g = Geometry{H, W, C, Ho, Wo, 0, (int)m, stride, dilation, dilation, radius};
  return true;
}

// The weight gradient's partition for this shape: {rows a block (one tap's
// 64 channels), output channels a block, pixels a chunk, slices of M,
// chunks of M, dynamic shared memory a block in bytes}; 0 on success,
// cudaErrorInvalidValue for a shape the kernel does not take.
int wgrad_layout(int C, int Cout, int M, int sms, int is_bf16, int* out) {
  const int bn = is_bf16 ? wg::tile_n(Cout) : (Cout > 0 && Cout % wgf32::kBN == 0 ? wgf32::kBN : 0);
  if (C < kWgRows || C % kWgRows != 0 || bn == 0 || M < 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (M + kWgPix - 1) / kWgPix;
  const int tiles = kTaps * C / kWgRows * (Cout / bn);
  const int smem = !is_bf16 ? 0 : bn == 128 ? wg::Cfg<128>::kSmemBytes : wg::Cfg<256>::kSmemBytes;
  const int v[6] = {kWgRows, bn, kWgPix, wgrad_slices(tiles, std::max(chunks, 1), sms), chunks, smem};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
  return 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. x (B, H, W, C); offsets
// (B, Ho, Wo, 18) f32; dpatch (B, Ho, Wo, 9 * C); doffsets (B, Ho, Wo, 18)
// f32; dx (B, H, W, C) f32, zeroed by the caller. Device memory, contiguous,
// 16-byte aligned; x and dpatch (and g) all bf16 (is_bf16) or all f32.
// radius < 0: no clamp. Each launches on `stream` and returns the
// cudaError_t of the launch (0 on success).

// K6 / K6b: dw (9 * C, Cout) f32 and doffsets from x, offsets, dpatch and g
// (M, Cout), M = B * Ho * Wo. C a multiple of 64; Cout 128 or a multiple of
// 256 (bf16), a multiple of 64 (f32); bf16 x under 2^31 elements. Scratch, sized by
// mxdet_deform_wgrad_layout(C, Cout, M, sms, is_bf16) = {.., bn, .., S,
// chunks, ..}: gtiles (bf16 only) chunks * 64 * Cout bf16, where g is laid
// out as MN-major tiles (Cout / bn, chunks, bn / 64, 64, 64) whose element
// (j, kc, a, k, 8 s + e) is g[64 kc + k, bn j + 64 a + 8 (s ^ (k % 8)) + e]
// (zero for 64 kc + k >= M; plain version ops/cuda/deform_conv.py::
// wgmma_g_tiles); dw_part S * 9C * Cout f32 when S > 1 (unused when S = 1);
// doff_ws (C / 64) * M * 18 f32. `sms`: the card's SM count, for the slices.
extern "C" int mxdet_deform_wgrad_doffsets(const void* x, const float* offsets,
                                           const void* dpatch, const void* gm, void* gtiles,
                                           float* dw_part, float* dw, float* doff_ws,
                                           float* doffsets, int B, int H, int W, int C, int Ho,
                                           int Wo, int Cout, int stride, int dilation,
                                           float radius, int sms, int is_bf16, void* stream) {
  Geometry g;
  int lay[6];
  if (!geometry(B, H, W, C, Ho, Wo, stride, dilation, radius, kWgRows, &g) ||
      wgrad_layout(C, Cout, g.M, sms, is_bf16, lay) != 0 ||
      (is_bf16 && (long long)B * H * W * C > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  g.Cout = Cout;
  const int bn = lay[1], slices = lay[3], chunks = lay[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_dw = (long long)kTaps * C * Cout;
  if (g.M == 0) return (int)cudaMemsetAsync(dw, 0, n_dw * sizeof(float), s);
  float* part = slices > 1 ? dw_part : dw;
  cudaError_t err;
  if (is_bf16) {
    auto* tb = static_cast<__nv_bfloat16*>(gtiles);
    const long long vectors = (long long)chunks * kWgPix * Cout / 8;
    wg::g_tiles_kernel<<<(unsigned)((vectors + 255) / 256), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gm), tb, g.M, Cout, bn, chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* db = static_cast<const __nv_bfloat16*>(dpatch);
    err = bn == 128 ? wg::launch<128>(xb, offsets, db, tb, part, doff_ws, g, slices, s)
                    : wg::launch<256>(xb, offsets, db, tb, part, doff_ws, g, slices, s);
  } else {
    const dim3 grid((unsigned)(kTaps * C / kWgRows), (unsigned)(Cout / bn), (unsigned)slices);
    wgf32::wgrad_f32_kernel<<<grid, wgf32::kThreads, 0, s>>>(
        static_cast<const float*>(x), offsets, static_cast<const float*>(dpatch),
        static_cast<const float*>(gm), part, doff_ws, g, slices);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const long long n_dw4 = slices > 1 ? n_dw / 4 : 0, n_doff = (long long)g.M * 2 * kTaps;
  wgrad_finish_kernel<<<(unsigned)((n_dw4 + n_doff + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(dw_part), slices, n_dw4, reinterpret_cast<float4*>(dw),
      doff_ws, C / kWgRows, n_doff, offsets, radius, doffsets);
  return (int)cudaGetLastError();
}

// What the weight gradient decides for this shape (see wgrad_layout), for
// the plain model (ops/cuda/deform_conv.py::wgrad_config) to be held against
// and for the wrapper to size its scratch: out = {rows a block, output
// channels a block, pixels a chunk, slices of M, chunks of M, dynamic shared
// memory a block in bytes (0 for f32)}. Launches nothing.
extern "C" int mxdet_deform_wgrad_layout(int C, int Cout, int M, int sms, int is_bf16, int* out) {
  return wgrad_layout(C, Cout, M, sms, is_bf16, out);
}

// dx (B, H, W, C) f32, zeroed by the caller; stride 1 or 2; H and W at
// most 16384 (the tables keep window cells in 16 bits).
extern "C" int mxdet_deform_col2im(const void* dpatch, const float* offsets, float* dx, int B,
                                   int H, int W, int C, int Ho, int Wo, int stride,
                                   int dilation, float radius, int is_bf16, void* stream) {
  Geometry g;
  if (!geometry(B, H, W, C, Ho, Wo, stride, dilation, radius, kCV, &g) ||
      (stride != 1 && stride != 2) || H > 16384 || W > 16384)
    return (int)cudaErrorInvalidValue;
  if (g.M == 0) return 0;
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
