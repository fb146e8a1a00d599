// FrozenBN's per-channel affine with the ReLU and the residual add that
// follow it, as one pass over channels_last (NHWC-contiguous) activations,
// sm_90a; and its backward, one pass as well.
//
// Replaces no TPU kernel: the JAX package leaves the affine, the ReLU and the
// add to XLA, which fuses them into the convolutions' epilogues. On the card
// ATen ran each as its own pass over device memory (x * scale and + bias as
// broadcast kernels that do not vectorise, then the add and the ReLU), 3-4
// passes where one does. The function is
// mxdetection_tpu_torch/ops/norm_act.py::frozen_bn_act_plain, which is that
// op sequence; the kernel equals it bit for bit:
//
//   forward   A: y = relu(bf(bf(x s) + b))
//             B: y = relu(bf(u + r)), u = bf(bf(x s) + b), r the residual as
//                it is (mode 1) or bf(bf(r rs) + rb) (mode 2: the downsample
//                conv's raw output with its BN applied here)
//   backward  gm = y <= 0 ? 0 : g   (torch's threshold_backward of the ReLU)
//             dx = bf(gm s); mode 1: dr = gm; mode 2: dr = bf(gm rs)
//
// bf() rounds to the activation's dtype (round to nearest even; nothing for
// f32) exactly where ATen rounds: every product and sum is a separately
// rounded f32 operation (__fmul_rn, __fadd_rn), so nvcc cannot contract a
// multiply-add into an FMA across a rounding. ReLU is ATen's clamp_min:
// NaN passes through, anything else is fmaxf(v, 0).
//
// Bound: bytes. Every element is read once and written once; the kernel does
// a handful of f32 operations per element, under 1 an HBM byte. Design: a
// thread moves 8 channels at a time (16 bytes of bf16, two 16-byte vectors
// of f32); the grid (8 blocks of 256 threads an SM) strides over the map by a
// multiple of C / 8 vectors, so each thread sees the same 8 channels on every
// step and reads their scale and bias once into registers. No shared memory,
// no atomics, no synchronisation, no allocation. C must be a multiple of 8
// and every pointer 16-byte aligned (the wrapper checks both). More vectors
// in flight a thread, 4 or 16 blocks an SM and evict-first loads and stores
// each moved an R50 batch's time by under 2 % (norm_act_variants.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // channels a thread moves at once
constexpr int kThreads = 256;  // threads a block
constexpr int kBlocksPerSm = 8;

// Eight values of T in registers, in their own dtype; f(i) reads one as f32.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float f(int i) const {
    const uint32_t w = (&raw.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Vec8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float f(int i) const {
    return i < 4 ? (&lo.x)[i] : (&hi.x)[i - 4];
  }
};

// round an f32 to T and back (bf16: round to nearest even, as ATen's store)
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// store 8 f32 values that are already exact in T
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __float_as_uint(v[2 * k]) >> 16;
    const uint32_t hi = __float_as_uint(v[2 * k + 1]) & 0xffff0000u;
    (&o.x)[k] = lo | hi;
  }
  *reinterpret_cast<uint4*>(p) = o;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// ATen's relu (clamp_min(v, 0)): NaN passes, else fmaxf
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// the affine of one value, rounded as ATen's mul then add
template <typename T>
__device__ __forceinline__ float affine(float x, float s, float b) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, s)), b));
}

// kMode 0: no residual; 1: r added as it is; 2: r through (rs, rb) first.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    norm_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        const T* __restrict__ b, const T* __restrict__ r,
                        const T* __restrict__ rs, const T* __restrict__ rb,
                        T* __restrict__ y, int64_t nvec, int cvec, int64_t stride) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= stride) return;  // past the last whole multiple of cvec threads
  const int c0 = int(t % cvec) * kVec;  // this thread's channels, on every step
  Vec8<T> sv, bv, rsv, rbv;
  sv.load(s + c0);
  bv.load(b + c0);
  if (kMode == 2) {
    rsv.load(rs + c0);
    rbv.load(rb + c0);
  }
  for (int64_t v = t; v < nvec; v += stride) {
    Vec8<T> xv, rv;
    xv.load(x + v * kVec);
    if (kMode != 0) rv.load(r + v * kVec);
    float out[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float u = affine<T>(xv.f(i), sv.f(i), bv.f(i));
      if (kMode == 1) u = rnd<T>(__fadd_rn(u, rv.f(i)));
      if (kMode == 2) u = rnd<T>(__fadd_rn(u, affine<T>(rv.f(i), rsv.f(i), rbv.f(i))));
      out[i] = relu(u);
    }
    store8(y + v * kVec, out);
  }
}

// The gradient to x (and to the residual's input, kMode 1 or 2) from g and
// the forward's output y.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    norm_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                        const T* __restrict__ s, const T* __restrict__ rs,
                        T* __restrict__ dx, T* __restrict__ dr, int64_t nvec, int cvec,
                        int64_t stride) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= stride) return;
  const int c0 = int(t % cvec) * kVec;
  Vec8<T> sv, rsv;
  sv.load(s + c0);
  if (kMode == 2) rsv.load(rs + c0);
  for (int64_t v = t; v < nvec; v += stride) {
    Vec8<T> gv, yv;
    gv.load(g + v * kVec);
    yv.load(y + v * kVec);
    float gx[kVec], gr[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float gm = yv.f(i) <= 0.0f ? 0.0f : gv.f(i);
      gx[i] = rnd<T>(__fmul_rn(gm, sv.f(i)));
      gr[i] = kMode == 2 ? rnd<T>(__fmul_rn(gm, rsv.f(i))) : gm;
    }
    store8(dx + v * kVec, gx);
    if (kMode != 0) store8(dr + v * kVec, gr);
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

// (blocks, stride in vectors): a stride that is a multiple of cvec, so a
// thread's channels stay the same on every step of its loop
void grid_of(int64_t nvec, int cvec, int* blocks, int64_t* stride) {
  int64_t nb = (nvec + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sm_count()) * kBlocksPerSm;
  if (nb > cap) nb = cap;
  if (nb * kThreads < cvec) nb = (cvec + kThreads - 1) / kThreads;
  *blocks = int(nb);
  *stride = (nb * kThreads / cvec) * cvec;
}

template <typename T>
int launch_fwd(const void* x, const void* s, const void* b, const void* r, const void* rs,
               const void* rb, void* y, int64_t n, int c, int mode, cudaStream_t stream) {
  const int64_t nvec = n / kVec;
  const int cvec = c / kVec;
  int blocks;
  int64_t stride;
  grid_of(nvec, cvec, &blocks, &stride);
  auto X = static_cast<const T*>(x), S = static_cast<const T*>(s), B = static_cast<const T*>(b),
       R = static_cast<const T*>(r), RS = static_cast<const T*>(rs),
       RB = static_cast<const T*>(rb);
  auto Y = static_cast<T*>(y);
  if (mode == 0)
    norm_act_fwd_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(X, S, B, R, RS, RB, Y, nvec,
                                                               cvec, stride);
  else if (mode == 1)
    norm_act_fwd_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(X, S, B, R, RS, RB, Y, nvec,
                                                               cvec, stride);
  else
    norm_act_fwd_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(X, S, B, R, RS, RB, Y, nvec,
                                                               cvec, stride);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* g, const void* y, const void* s, const void* rs, void* dx, void* dr,
               int64_t n, int c, int mode, cudaStream_t stream) {
  const int64_t nvec = n / kVec;
  const int cvec = c / kVec;
  int blocks;
  int64_t stride;
  grid_of(nvec, cvec, &blocks, &stride);
  auto G = static_cast<const T*>(g), Y = static_cast<const T*>(y), S = static_cast<const T*>(s),
       RS = static_cast<const T*>(rs);
  auto DX = static_cast<T*>(dx), DR = static_cast<T*>(dr);
  if (mode == 0)
    norm_act_bwd_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(G, Y, S, RS, DX, DR, nvec, cvec,
                                                               stride);
  else if (mode == 1)
    norm_act_bwd_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(G, Y, S, RS, DX, DR, nvec, cvec,
                                                               stride);
  else
    norm_act_bwd_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(G, Y, S, RS, DX, DR, nvec, cvec,
                                                               stride);
  return int(cudaGetLastError());
}

}  // namespace

// x, r, y: n elements of NHWC memory whose last dimension is c (a multiple
// of 8); s, b, rs, rb: c values each; all of one dtype (bf16 if `bf16`, else
// f32) and 16-byte aligned. mode 0: no residual (r, rs, rb unused); 1: r
// added as it is; 2: r through (rs, rb) first. Returns cudaGetLastError().
extern "C" int mxdet_norm_act_fwd(const void* x, const void* s, const void* b, const void* r,
                                  const void* rs, const void* rb, void* y, long long n, int c,
                                  int bf16, int mode, void* stream) {
  if (n <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, s, b, r, rs, rb, y, n, c, mode, st)
              : launch_fwd<float>(x, s, b, r, rs, rb, y, n, c, mode, st);
}

// g, y (the forward's output), dx, dr: n elements as above; s, rs: c values.
// Writes dx, and dr with mode 1 or 2.
extern "C" int mxdet_norm_act_bwd(const void* g, const void* y, const void* s, const void* rs,
                                  void* dx, void* dr, long long n, int c, int bf16, int mode,
                                  void* stream) {
  if (n <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(g, y, s, rs, dx, dr, n, c, mode, st)
              : launch_bwd<float>(g, y, s, rs, dx, dr, n, c, mode, st);
}
