// Deformable convolution v1 forward (3x3), implicit GEMM, sm_90a.
//
// Replaces the two TPU kernels of mxdetection_tpu/ops/pallas/dcn.py:
// _kernel (K5, stride 1, :43) and _kernel_s2 (K5b, stride 2, :622). Both
// compute out = patches(x, offsets) @ W for a 3x3 DCNv1 layer; this one
// source does both, with stride and dilation as arguments. Semantics are
// those of the plain version, mxdetection_tpu_torch/ops/dcn.py::deform_conv2d;
// the tap samples and the four-corner blend live in deform_common.cuh, shared
// with the backward (csrc/deform_conv_bwd.cu). The patch value is rounded to
// the compute dtype; the product with W accumulates in f32 and is written
// once in the compute dtype.
//
// What the TPU kernels did to fit VMEM and the MXU (row windows, the
// (2R+2)^2 dense displacement walk, the column-parity split of K5b) has no
// counterpart here: each block gathers exactly the four corners it needs.
//
// Work layout: one block of 128 threads computes a tile of 64 output pixels
// (flattened b, i, j) x 64 output channels. For each of the 9 taps it first
// computes, once per pixel, the four corner addresses and masked bilinear
// weights (shared memory); it then walks Cin in chunks of 64: every thread
// gathers 16-byte vectors of the four corners (neighbouring threads on
// neighbouring channels of one NHWC pixel), blends them in f32 in the plain
// order, rounds to the compute dtype into the A tile, loads the matching
// 64 x 64 slice of W into the B tile, and accumulates A @ B in f32:
// nvcuda::wmma bf16 16x16x16 tensor-core products for bf16, CUDA-core FMAs
// for f32. Only the epilogue writes the output, NHWC.
//
// Coordinates and weights use explicitly rounded operations (__fadd_rn,
// __fsub_rn, __fmul_rn) so nvcc cannot contract them into FMAs: every rounded
// patch value is bit-identical to the plain version's, and only the order of
// the GEMM's f32 sum differs.
//
// Bound: a layer of the Cascade R101-DCN path at batch 8 does
// 2 * M * 9 * Cin * Cout = 41.2 GFLOP (M = B * Ho * Wo output pixels) and
// must move its input, offsets, weight and output once (tens of MB, 143 MB
// for the stage-2 stride-2 input), so in bf16 it is bound by the tensor
// cores' 989 TFLOP/s (about 0.04 ms) except the stage-2 stride-2 layer,
// which is bound by its bytes. This simple kernel is far from that bound:
// it re-gathers the A tile for every 64-channel column block of the output
// (Cout / 64 times), blends on CUDA cores, and uses wmma from shared memory
// without a pipeline. wgmma, TMA and multi-stage pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "deform_common.cuh"

namespace {

using namespace mxdet_dcn;

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 64;       // input channels per chunk
constexpr int kThreads = 128;

template <typename T>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kPad = 16 / sizeof(T);  // keeps rows 16-byte aligned
  T a[kBM][kBK + kPad];                         // rounded patch rows of the chunk
  T b[kBK][kBN + kPad];                         // the matching rows of W
  float c[kBf16 ? kBM : 1][kBN + 4];            // bf16: accumulators for the epilogue
  long long corner_off[4][kBM];                 // element offset of each corner pixel
  float corner_w[4][kBM];                       // its masked bilinear weight
};
// Static shared memory is capped at 48 KB a block.
static_assert(sizeof(Smem<__nv_bfloat16>) <= 48 * 1024, "bf16 tiles exceed static shared memory");
static_assert(sizeof(Smem<float>) <= 48 * 1024, "f32 tiles exceed static shared memory");
// Ragged tails: the rows past M (the last block's tail) are zero rows read
// from valid addresses; the entry point refuses Cin and Cout that are not
// whole tiles, and no 16-byte vector straddles a tile's edge.
static_assert(kBK % 8 == 0 && kBN % 8 == 0, "a 16-byte vector never straddles a tile edge");

// The four corners of tap t for the block's pixels m0 .. m0 + kBM - 1.
template <typename T>
__device__ void tap_tables(const Geometry& g, const float* __restrict__ offsets, int m0, int t,
                           Smem<T>& s) {
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

// A tile: rounded patch values of channels c0 .. c0 + kBK - 1 of the tap.
template <typename T>
__device__ void gather_a(const T* __restrict__ x, int c0, Smem<T>& s) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kBK / kVec;
  for (int v = threadIdx.x; v < kBM * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int cv = (v - r * kPerRow) * kVec;
    const T* base = x + c0 + cv;
    uint4 q[4];
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = __ldg(reinterpret_cast<const uint4*>(base + s.corner_off[k][r]));
      w[k] = s.corner_w[k][r];
    }
    uint4 packed;
    T* pe = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float v00 = to_f32(reinterpret_cast<const T*>(&q[0])[e]);
      const float v01 = to_f32(reinterpret_cast<const T*>(&q[1])[e]);
      const float v10 = to_f32(reinterpret_cast<const T*>(&q[2])[e]);
      const float v11 = to_f32(reinterpret_cast<const T*>(&q[3])[e]);
      pe[e] = from_f32<T>(blend(v00, v01, v10, v11, w));
    }
    *reinterpret_cast<uint4*>(&s.a[r][cv]) = packed;
  }
}

// B tile: rows t*Cin + c0 .. + kBK - 1 of W (9*Cin, Cout), columns n0 .. n0 + kBN - 1.
template <typename T>
__device__ void load_b(const T* __restrict__ wmat, const Geometry& g, int t, int c0, int n0,
                       Smem<T>& s) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kBN / kVec;
  const T* src = wmat + ((size_t)t * g.Cin + c0) * g.Cout + n0;
  for (int v = threadIdx.x; v < kBK * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int cv = (v - r * kPerRow) * kVec;
    *reinterpret_cast<uint4*>(&s.b[r][cv]) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * g.Cout + cv));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                       const T* __restrict__ wmat, T* __restrict__ out, Geometry g) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char raw[sizeof(Smem<T>)];
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(raw);

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // the warp's 32x32 of the tile
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;   // f32: rows tr*4.., cols tc*8..

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc16[2][2];
  float acc32[4][8];
  if constexpr (Smem<T>::kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc16[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc32[i][j] = 0.0f;
  }

  for (int t = 0; t < kTaps; ++t) {
    tap_tables<T>(g, offsets, m0, t, s);  // the last chunk's trailing sync guards the tables
    __syncthreads();
    for (int c0 = 0; c0 < g.Cin; c0 += kBK) {
      gather_a<T>(x, c0, s);
      load_b<T>(wmat, g, t, c0, n0, s);
      __syncthreads();
      if constexpr (Smem<T>::kBf16) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], &s.a[wm + 16 * i][kk], kBK + Smem<T>::kPad);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], &s.b[kk][wn + 16 * j], kBN + Smem<T>::kPad);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc16[i][j], fa[i], fb[j], acc16[i][j]);
        }
      } else {
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          float av[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_f32(s.a[tr * 4 + i][kk]);
#pragma unroll
          for (int j = 0; j < 8; ++j) bv[j] = to_f32(s.b[kk][tc * 8 + j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc32[i][j] = fmaf(av[i], bv[j], acc32[i][j]);
        }
      }
      __syncthreads();
    }
  }

  if constexpr (Smem<T>::kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&s.c[wm + 16 * i][wn + 16 * j], acc16[i][j], kBN + 4,
                                wmma::mem_row_major);
    __syncthreads();
    constexpr int kPerRow = kBN / 8;
    for (int v = threadIdx.x; v < kBM * kPerRow; v += kThreads) {
      const int r = v / kPerRow;
      const int cv = (v - r * kPerRow) * 8;
      if (m0 + r >= g.M) continue;
      uint4 packed;
      __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&packed);
      for (int e = 0; e < 8; ++e) pe[e] = __float2bfloat16_rn(s.c[r][cv + e]);
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * g.Cout + n0 + cv) = packed;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tr * 4 + i;
      if (m >= g.M) continue;
      float* dst = reinterpret_cast<float*>(out) + (size_t)m * g.Cout + n0 + tc * 8;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc32[i][0], acc32[i][1], acc32[i][2], acc32[i][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc32[i][4], acc32[i][5], acc32[i][6], acc32[i][7]);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. x (B, H, W, Cin), offsets
// (B, Ho, Wo, 18) f32, wmat (9 * Cin, Cout) (the HWIO weight, reshaped), out
// (B, Ho, Wo, Cout): device memory, contiguous, 16-byte aligned; x, wmat and
// out all bf16 (is_bf16) or all f32. radius < 0: no clamp. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int mxdet_deform_conv_fwd(const void* x, const float* offsets, const void* wmat,
                                     void* out, int B, int H, int W, int Cin, int Ho, int Wo,
                                     int Cout, int stride, int dilation, float radius,
                                     int is_bf16, void* stream) {
  if (B < 0 || H < 1 || W < 1 || Ho < 0 || Wo < 0 || Cin % kBK != 0 || Cin < kBK ||
      Cout % kBN != 0 || Cout < kBN || stride < 1 || dilation < 1)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)B * Ho * Wo;
  if (m > 0x7fffffffLL - kBM) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Geometry g{H, W, Cin, Ho, Wo, Cout, (int)m, stride, dilation, dilation, radius};
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)(Cout / kBN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    deform_conv_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), offsets, static_cast<const __nv_bfloat16*>(wmat),
        static_cast<__nv_bfloat16*>(out), g);
  } else {
    deform_conv_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), offsets, static_cast<const float*>(wmat),
        static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}
