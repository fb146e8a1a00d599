// Deformable convolution v1 forward (3x3), implicit GEMM, sm_90a.
//
// Replaces the two TPU kernels of mxdetection_tpu/ops/pallas/dcn.py:
// _kernel (K5, stride 1, :43) and _kernel_s2 (K5b, stride 2, :622). Both
// compute out = patches(x, offsets) @ W for a 3x3 DCNv1 layer; this one
// source does both, with stride and dilation as arguments. Semantics are
// those of the plain version, mxdetection_tpu_torch/ops/dcn.py::deform_conv2d;
// the tap samples and the four-corner blend live in deform_common.cuh, shared
// with the backward (csrc/deform_conv_bwd.cu), so every rounded patch value
// is bit-identical to the plain version's and to the row the backward
// rebuilds for dW; only the order of the GEMM's f32 sum differs. What the
// TPU kernels did to fit VMEM and the MXU (row windows, the (2R+2)^2 dense
// displacement walk, the column-parity split of K5b) has no counterpart
// here: a block gathers exactly the four corners each sample needs.
//
// What bounds it on an H100: a layer of the Cascade R101-DCN path at batch 8
// does 2 * M * 9 * Cin * Cout operations (41.2 GFLOP at stage 3, M = B * Ho
// * Wo output pixels), 0.04 ms on the tensor cores at 989 TFLOP/s, and must
// move x, the offsets, W and the output once (tens of MB). In practice the
// corner gather bounds it: every patch value is four 2-byte corner reads (A
// has M * 9 * Cin values, 80.5 M at stage 3, so one gather is 644 MB read
// from L2 or L1) and a blend of seven rounded f32 operations, plus W read
// once per row tile.
//
// bf16 (deform_conv_fwd_kernel, the main path). One block owns BM = 64
// output pixels x BN = Cout output channels (two column tiles of 256 when
// Cout = 512), so each patch value is gathered and blended once for all of
// Cout, not once per 64 output channels. Three warpgroups, specialised:
//  - two producer warpgroups compute the corner tables of all 9 taps of the
//    row tile once (shared memory), then walk K in 64-channel chunks, channel
//    chunk outer and tap inner so that neighbouring taps re-read the same
//    corners from L1; for each chunk they gather the four corners of every
//    pixel as 16-byte vectors, loaded kChunksAhead chunks before they are
//    blended, blend in f32 in the plain order, round to bf16 and store each
//    vector at its 128-byte-swizzled place (16-byte chunk index XOR row mod
//    8), while one thread brings W's (64 x BN) slice into the same stage
//    with cp.async.bulk. The entry point first lays W out as K-major tiles
//    already in that swizzled order (weight_tiles_kernel; plain version
//    ops/cuda/deform_conv.py::wgmma_weight_tiles), so one contiguous bulk
//    copy fills a stage and no tensor map (cuTensorMapEncodeTiled, -lcuda) is
//    needed;
//  - one consumer warpgroup runs wgmma.mma_async m64 n{BN} k16 bf16 -> f32
//    from shared-memory descriptors (A and B both K-major, 128-byte
//    swizzle), accumulators in registers;
//  - a ring of 4 stages in dynamic shared memory (40 KB each at BN = 256),
//    each with a full and an empty mbarrier, hands chunks from the producers
//    to the consumer, so the gather of chunk k+1 overlaps the wgmma of
//    chunk k.
// Registers: ptxas gives every thread the launch bound's share (168 at 384
// threads; setmaxnreg does not change what it allocates) and an m64n256
// wgmma needs 154, so a block has at most three warpgroups. Two of them
// gather, since the gather is the bound: a block of 128 pixels with two
// consumer warpgroups and one producer warpgroup, tried first, was slower.
// The epilogue rounds the accumulators to bf16 and stores NHWC, masking the
// ragged tail of M.
//
// f32 (deform_conv_fwd_f32_kernel, used only by the card-vs-CPU checks): the
// CUDA-core tile path, 64 pixels x 64 output channels a block of 128
// threads, corner tables a tap, the A and B tiles in static shared memory
// and FMAs; wgmma takes no f32 operands.
//
// Coordinates and weights use explicitly rounded operations (__fadd_rn,
// __fsub_rn, __fmul_rn) so nvcc cannot contract them into FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "deform_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace mxdet_dcn;
using namespace mxdet_hopper;

// ---------------------------------------------------------------- f32 path

namespace f32 {

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 64;       // input channels per chunk
constexpr int kThreads = 128;

struct Smem {
  float a[kBM][kBK + 4];         // patch rows of the chunk (rows 16-byte aligned)
  float b[kBK][kBN + 4];         // the matching rows of W
  long long corner_off[4][kBM];  // element offset of each corner pixel
  float corner_w[4][kBM];        // its masked bilinear weight
};
// Static shared memory is capped at 48 KB a block.
static_assert(sizeof(Smem) <= 48 * 1024, "f32 tiles exceed static shared memory");
// The entry point refuses Cin and Cout that are not whole tiles, and no
// 16-byte vector straddles a tile's edge.
static_assert(kBK % 4 == 0 && kBN % 4 == 0, "a 16-byte vector never straddles a tile edge");

// The four corners of tap t for the block's pixels m0 .. m0 + kBM - 1.
__device__ void tap_tables(const Geometry& g, const float* __restrict__ offsets, int m0, int t,
                           Smem& s) {
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m >= g.M) {  // ragged tail: a zero row, read from a valid address
      for (int q = 0; q < 4; ++q) {
        s.corner_off[q][r] = 0;
        s.corner_w[q][r] = 0.0f;
      }
      continue;
    }
    const TapSample p = sample_tap(g, offsets, m, t);
    for (int q = 0; q < 4; ++q) {
      s.corner_off[q][r] = p.off[q];
      s.corner_w[q][r] = p.w[q];
    }
  }
}

// A tile: patch values of channels c0 .. c0 + kBK - 1 of the tap.
__device__ void gather_a(const float* __restrict__ x, int c0, Smem& s) {
  constexpr int kPerRow = kBK / 4;
  for (int v = threadIdx.x; v < kBM * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int cv = (v - r * kPerRow) * 4;
    const float* base = x + c0 + cv;
    float4 q[4];
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = __ldg(reinterpret_cast<const float4*>(base + s.corner_off[k][r]));
      w[k] = s.corner_w[k][r];
    }
    float4 o;
    o.x = blend(q[0].x, q[1].x, q[2].x, q[3].x, w);
    o.y = blend(q[0].y, q[1].y, q[2].y, q[3].y, w);
    o.z = blend(q[0].z, q[1].z, q[2].z, q[3].z, w);
    o.w = blend(q[0].w, q[1].w, q[2].w, q[3].w, w);
    *reinterpret_cast<float4*>(&s.a[r][cv]) = o;
  }
}

// B tile: rows t*Cin + c0 .. + kBK - 1 of W (9*Cin, Cout), columns n0 .. n0 + kBN - 1.
__device__ void load_b(const float* __restrict__ wmat, const Geometry& g, int t, int c0, int n0,
                       Smem& s) {
  constexpr int kPerRow = kBN / 4;
  const float* src = wmat + ((size_t)t * g.Cin + c0) * g.Cout + n0;
  for (int v = threadIdx.x; v < kBK * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int cv = (v - r * kPerRow) * 4;
    *reinterpret_cast<float4*>(&s.b[r][cv]) =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)r * g.Cout + cv));
  }
}

__global__ void __launch_bounds__(kThreads)
deform_conv_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                           const float* __restrict__ wmat, float* __restrict__ out, Geometry g) {
  __shared__ __align__(16) Smem s;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;  // rows tr*4.., cols tc*8..
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < kTaps; ++t) {
    tap_tables(g, offsets, m0, t, s);  // the last chunk's trailing sync guards the tables
    __syncthreads();
    for (int c0 = 0; c0 < g.Cin; c0 += kBK) {
      gather_a(x, c0, s);
      load_b(wmat, g, t, c0, n0, s);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = s.a[tr * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = s.b[kk][tc * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= g.M) continue;
    float* dst = out + (size_t)m * g.Cout + n0 + tc * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace f32

// ---------------------------------------------------------------- bf16 path

namespace wg {

constexpr int kConsumers = 1;   // warpgroups issuing wgmma, 64 rows each
constexpr int kProducers = 2;   // warpgroups gathering
constexpr int kBM = 64 * kConsumers;  // output pixels per block
constexpr int kBK = 64;         // input channels per chunk: one 128-byte bf16 row
constexpr int kRowBytes = kBK * 2;
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerThreads = 128 * kProducers;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kRowsPerPass = kProducerThreads / 8;  // 8 producer threads a pixel
constexpr int kPasses = kBM / kRowsPerPass;         // 16-byte vectors a thread blends a chunk
constexpr int kChunksAhead = 2;  // chunks whose corner loads are in flight during a blend
// ptxas gives every thread of the block the same registers, 65536 / kThreads
// rounded down to 8; an m64n256 wgmma needs 154 (its accumulators take 128),
// which rules out more than 384 threads.
static_assert(65536 / kThreads / 8 * 8 >= 154, "the consumers' wgmma needs 154 registers");
static_assert(kRowBytes == 128, "a chunk row is one 128-byte swizzle row");
static_assert(kBM % kRowsPerPass == 0, "the producers cover the row tile in whole passes");

// The four corners of one (tap, pixel) sample: element offsets of the corner
// pixels in x (the entry point refuses x of 2^31 elements or more) and their
// masked bilinear weights.
struct __align__(16) Corners {
  int off[4];
  float w[4];
};

template <int BN>
struct Cfg {
  static_assert(BN == 128 || BN == 256, "wgmma tiles of 128 or 256 output channels");
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kTableBytes = kTaps * kBM * (int)sizeof(Corners);
  static constexpr int kBarrierBytes = 2 * kStages * 8;
  // + 1024: the dynamic base is rounded up to the 1024-byte alignment that
  // the 128-byte swizzle pattern repeats with
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kTableBytes + kBarrierBytes;
  static_assert(kStageBytes % 1024 == 0, "every A and B tile starts 1024-byte aligned");
  static_assert(kSmemBytes <= 227 * 1024, "the ring exceeds the 227 KB a block can use");
  static_assert(kSmemBytes > 48 * 1024, "dynamic shared memory above the static cap");
};

// The raw corner vectors of one chunk that one producer thread blends.
struct Frag {
  uint4 q[kPasses][4];
};

// Chunk i walks channel chunk i / 9 (outer) and tap i % 9 (inner), so that
// neighbouring taps re-read the same corners from L1.
__device__ __forceinline__ void chunk_of(int i, int* cc, int* t) {
  *cc = i / kTaps;
  *t = i - *cc * kTaps;
}

// Start the corner loads of chunk i: for each of the thread's pixels, the
// four corners' 16-byte vector of channels 64 cc + 8 vec .. + 7.
__device__ __forceinline__ void load_chunk(Frag& f, const __nv_bfloat16* __restrict__ x,
                                           const Corners* tab, int i, int row0, int vec) {
  int cc, t;
  chunk_of(i, &cc, &t);
  const __nv_bfloat16* xv = x + cc * kBK + vec * 8;
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int4 off = *reinterpret_cast<const int4*>(tab[t * kBM + row0 + kRowsPerPass * u].off);
    f.q[u][0] = __ldg(reinterpret_cast<const uint4*>(xv + off.x));
    f.q[u][1] = __ldg(reinterpret_cast<const uint4*>(xv + off.y));
    f.q[u][2] = __ldg(reinterpret_cast<const uint4*>(xv + off.z));
    f.q[u][3] = __ldg(reinterpret_cast<const uint4*>(xv + off.w));
  }
}

// Blend chunk i's corners in f32 in the plain order, round to bf16 and
// store each vector at its 128-byte-swizzled place in the A tile `a`.
__device__ __forceinline__ void store_chunk(const Frag& f, const Corners* tab, unsigned char* a,
                                            int i, int row0, int vec) {
  int cc, t;
  chunk_of(i, &cc, &t);
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int r = row0 + kRowsPerPass * u;
    const float4 wv = *reinterpret_cast<const float4*>(tab[t * kBM + r].w);
    const float w[4] = {wv.x, wv.y, wv.z, wv.w};
    uint4 packed;
    __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v00 = to_f32(reinterpret_cast<const __nv_bfloat16*>(&f.q[u][0])[e]);
      const float v01 = to_f32(reinterpret_cast<const __nv_bfloat16*>(&f.q[u][1])[e]);
      const float v10 = to_f32(reinterpret_cast<const __nv_bfloat16*>(&f.q[u][2])[e]);
      const float v11 = to_f32(reinterpret_cast<const __nv_bfloat16*>(&f.q[u][3])[e]);
      pe[e] = from_f32<__nv_bfloat16>(blend(v00, v01, v10, v11, w));
    }
    *reinterpret_cast<uint4*>(a + r * kRowBytes + ((vec ^ (r & 7)) << 4)) = packed;
  }
}

// x (B, H, W, Cin) bf16; wtiles the K-major swizzled tiles of W
// (Cout / BN, 9 * Cin / 64, BN, 64), see the entry point; out (M, Cout) bf16.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
deform_conv_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ offsets,
                       const __nv_bfloat16* __restrict__ wtiles, __nv_bfloat16* __restrict__ out,
                       Geometry g) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Corners* tab = reinterpret_cast<Corners*>(smem + C::kStages * C::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + kTaps * kBM);
  uint64_t* empty = full + C::kStages;

  const int m0 = blockIdx.x * kBM;
  const int nt = blockIdx.y;  // column tile: 0, or 0 and 1 when Cout = 512
  const int chunks = g.Cin / kBK;
  const int nk = kTaps * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], kProducerThreads + 1);  // + the W copy's expect_tx arrival
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group >= kConsumers) {
    // ---- producers: corner tables, then the gather ring
    const int p = threadIdx.x - kConsumerThreads;
    for (int e = p; e < kTaps * kBM; e += kProducerThreads) {
      const int t = e / kBM, r = e - t * kBM;
      Corners c;
      if (m0 + r < g.M) {
        const TapSample sp = sample_tap(g, offsets, m0 + r, t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c.off[q] = (int)sp.off[q];
          c.w[q] = sp.w[q];
        }
      } else {  // ragged tail: a zero row, read from a valid address
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c.off[q] = 0;
          c.w[q] = 0.0f;
        }
      }
      tab[e] = c;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");

    // The ring: chunk i's corners are loaded kChunksAhead chunks before its
    // blend, into one of kChunksAhead + 1 register fragments (unrolled, so
    // each fragment index is a constant).
    const int vec = p & 7, row0 = p >> 3;
    Frag f[kChunksAhead + 1];
#pragma unroll
    for (int j = 0; j < kChunksAhead; ++j)
      if (j < nk) load_chunk(f[j], x, tab, j, row0, vec);
    for (int i0 = 0; i0 < nk; i0 += kChunksAhead + 1) {
#pragma unroll
      for (int j = 0; j <= kChunksAhead; ++j) {
        const int i = i0 + j;
        if (i >= nk) break;
        if (i + kChunksAhead < nk)
          load_chunk(f[(j + kChunksAhead) % (kChunksAhead + 1)], x, tab, i + kChunksAhead, row0,
                     vec);
        const int s = i % C::kStages;
        mbar_wait(&empty[s], ((i / C::kStages) & 1) ^ 1);
        unsigned char* a = smem + s * C::kStageBytes;
        if (p == 0) {
          int cc, t;
          chunk_of(i, &cc, &t);
          mbar_arrive_expect_tx(&full[s], C::kBBytes);
          bulk_copy(a + C::kABytes, wtiles + ((size_t)nt * nk + t * chunks + cc) * BN * kBK,
                    C::kBBytes, &full[s]);
        }
        store_chunk(f[j], tab, a, i, row0, vec);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::kStages;
      mbar_wait(&full[s], (i / C::kStages) & 1);
      const uint32_t a = smem_u32(smem + s * C::kStageBytes + group * 64 * kRowBytes);
      const uint32_t b = smem_u32(smem + s * C::kStageBytes + C::kABytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // k16 steps: 32 bytes along the swizzled row
        wgmma_bf16<BN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0) mbar_arrive(&empty[(i - 1) % C::kStages]);  // chunk i-1's products are done
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
    // 16w + l/4 and 16w + l/4 + 8, columns 8c + 2(l%4) + {0, 1}
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = m0 + group * 64 + (t / 32) * 16 + lane / 4;
    __nv_bfloat16* o = out + (size_t)row * g.Cout + nt * BN + (lane % 4) * 2;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      if (row < g.M)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * c) =
            __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1]);
      if (row + 8 < g.M)
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)8 * g.Cout + 8 * c) =
            __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// W (9 * Cin, Cout) row-major -> its K-major swizzled tiles (see
// mxdet_deform_conv_weight_tiles); one thread a 16-byte vector of the tiles,
// eight threads writing each 128-byte row.
__global__ void __launch_bounds__(256)
weight_tiles_kernel(const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ tiles,
                    int K, int Cout, int BN) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long long)K * Cout / 8) return;
  const int s = (int)(v % 8);
  const long long row = v / 8;  // (j * K / 64 + kc) * BN + n
  const int n = (int)(row % BN);
  const long long tile = row / BN;
  const int kc = (int)(tile % (K / kBK)), j = (int)(tile / (K / kBK));
  const __nv_bfloat16* src = w + (size_t)(kBK * kc + 8 * (s ^ (n % 8))) * Cout + BN * j + n;
  uint4 packed;
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; ++e) pe[e] = src[(size_t)e * Cout];
  reinterpret_cast<uint4*>(tiles)[v] = packed;
}

// The bf16 kernel's output-channel tile for this Cout, 0 if it takes none.
int tile_n(int Cout) { return Cout == 128 ? 128 : Cout > 0 && Cout % 256 == 0 ? 256 : 0; }

cudaError_t launch_weight_tiles(const __nv_bfloat16* wmat, __nv_bfloat16* tiles, int Cin, int Cout,
                                cudaStream_t stream) {
  const long long vectors = 9LL * Cin * Cout / 8;
  weight_tiles_kernel<<<(unsigned)((vectors + 255) / 256), 256, 0, stream>>>(wmat, tiles, 9 * Cin,
                                                                          Cout, tile_n(Cout));
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch(const __nv_bfloat16* x, const float* offsets, const __nv_bfloat16* wtiles,
                   __nv_bfloat16* out, const Geometry& g, cudaStream_t stream) {
  using C = Cfg<BN>;
  cudaError_t err = cudaFuncSetAttribute(deform_conv_fwd_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.M + kBM - 1) / kBM), (unsigned)(g.Cout / BN));
  deform_conv_fwd_kernel<BN><<<grid, kThreads, C::kSmemBytes, stream>>>(x, offsets, wtiles, out, g);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device memory,
// contiguous, 16-byte aligned; each launches on `stream` and returns the
// cudaError_t of the launch (0 on success).

// The bf16 forward's layout of W = weight.reshape(9 * Cin, Cout) (the HWIO
// weight, bf16): K-major tiles in the 128-byte swizzle that the kernel's wgmma
// descriptors read, so one contiguous bulk copy fills a stage. tiles has the
// shape (Cout / BN, 9 * Cin / 64, BN, 64), BN = 128 if Cout = 128, else 256;
// element (j, kc, n, 8 * s + e) is W[64 * kc + 8 * (s ^ (n % 8)) + e, BN * j + n].
// Its plain version is ops/cuda/deform_conv.py::wgmma_weight_tiles.
extern "C" int mxdet_deform_conv_weight_tiles(const void* wmat, void* tiles, int Cin, int Cout,
                                              void* stream) {
  if (Cin < wg::kBK || Cin % wg::kBK != 0 || wg::tile_n(Cout) == 0)
    return (int)cudaErrorInvalidValue;
  return (int)wg::launch_weight_tiles(static_cast<const __nv_bfloat16*>(wmat),
                                      static_cast<__nv_bfloat16*>(tiles), Cin, Cout,
                                      static_cast<cudaStream_t>(stream));
}

// x (B, H, W, Cin), offsets (B, Ho, Wo, 18) f32, wmat the HWIO weight as
// (9 * Cin, Cout), out (B, Ho, Wo, Cout); x, wmat and out all bf16
// (is_bf16) or all f32. radius < 0: no clamp.
//  - f32: Cin and Cout multiples of 64; wtiles unused.
//  - bf16: Cin a multiple of 64, Cout 128 or a multiple of 256, x under
//    2^31 elements; wtiles is scratch of 9 * Cin * Cout elements, where
//    the weight's tiles are laid out (as mxdet_deform_conv_weight_tiles)
//    before the kernel reads them.
extern "C" int mxdet_deform_conv_fwd(const void* x, const float* offsets, const void* wmat,
                                     void* wtiles, void* out, int B, int H, int W, int Cin,
                                     int Ho, int Wo,
                                     int Cout, int stride, int dilation, float radius,
                                     int is_bf16, void* stream) {
  if (B < 0 || H < 1 || W < 1 || Ho < 0 || Wo < 0 || Cin % 64 != 0 || Cin < 64 || Cout < 64 ||
      stride < 1 || dilation < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 ? wg::tile_n(Cout) == 0 || (long long)B * H * W * Cin > 0x7fffffffLL
              : Cout % f32::kBN != 0)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)B * Ho * Wo;
  if (m > 0x7fffffffLL - wg::kBM) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Geometry g{H, W, Cin, Ho, Wo, Cout, (int)m, stride, dilation, dilation, radius};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* tb = static_cast<__nv_bfloat16*>(wtiles);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    const cudaError_t err =
        wg::launch_weight_tiles(static_cast<const __nv_bfloat16*>(wmat), tb, Cin, Cout, s);
    if (err != cudaSuccess) return (int)err;
    return (int)(wg::tile_n(Cout) == 128 ? wg::launch<128>(xb, offsets, tb, ob, g, s)
                                         : wg::launch<256>(xb, offsets, tb, ob, g, s));
  }
  const dim3 grid((unsigned)((m + f32::kBM - 1) / f32::kBM), (unsigned)(Cout / f32::kBN));
  f32::deform_conv_fwd_f32_kernel<<<grid, f32::kThreads, 0, s>>>(
      static_cast<const float*>(x), offsets, static_cast<const float*>(wmat),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of the bf16 kernel takes for this Cout
// (0 for a Cout it does not take).
extern "C" int mxdet_deform_conv_fwd_smem(int Cout) {
  switch (wg::tile_n(Cout)) {
    case 128: return wg::Cfg<128>::kSmemBytes;
    case 256: return wg::Cfg<256>::kSmemBytes;
    default: return 0;
  }
}
