// Multilevel RoIAlign forward (aligned=False) over an FPN pyramid, sm_90a.
//
// Replaces the TPU kernel mxdetection_tpu/ops/pallas/roi_align.py::_kernel
// (windowed DMA + MXU contractions). Semantics are those of the plain
// version, mxdetection_tpu_torch/ops/roi_align.py::multilevel_roi_align_plain
// (itself the port of mxdetection_tpu/ops/roi_align.py):
//   roi_w/h = max(x2*scale - x1*scale, 1); sample j of bin i at
//   start + (i + (j + .5)/S) * bin; samples inside [-1, size] are clamped to
//   [0, size-1] with hi = min(lo+1, size-1), samples beyond contribute 0;
//   each bin is the mean of its S*S samples; invalid rois give zeros.
//
// Work layout: a warp owns one bin row of one roi (a warp a bin was slower:
// PERF.md section 6), and a lane owns 16 bytes of channels, 8 in bf16 or 4 in f32, so one warp
// load of a bilinear tap fetches 512 contiguous bytes of the channels-last
// level (B, H_l, W_l, C): 256 bf16 channels, four full lines. The loads of a
// group of two samples (8 taps) are all issued before the first is used, so
// each lane has 128 bytes in flight, and six blocks of 4 warps fit an SM
// (24 warps: more of them waiting on loads beat more loads a warp); the
// sums are f32 registers, 8 or 4 a lane. Bins of a roi, and rois of an image, are neighbours in the grid,
// so a roi's taps meet in L1 and an image's pyramid stays in L2. What bounds
// it is the gather: P*P*S*S*4 taps of C values a roi, mostly served from L2
// and L1 (about 3.2 GB of tap reads at 8 x 1000 rois and C = 256 in bf16,
// against ~0.45 GB of unique pyramid bytes and the 0.2 GB output). Each
// level is read in place through its own pointer and extents: no concat and
// no windows (the TPU's 40x32 windows, coverage passes and drain queue
// existed to fit VMEM).
//
// Widths: C that is not a multiple of the lane's 16 bytes (or a level not
// 16-byte aligned) takes the same loop with each lane's channels loaded and
// stored one by one, masked at C (`vec` false); C up to 1024, P*S <= 64.
//
// The roi's level comes in precomputed (int32) from the shared torch
// fpn_level_assign, so kernel and plain version agree at level boundaries.
// Sample coordinates use explicitly rounded operations (__fmul_rn, __fadd_rn,
// __fdiv_rn) so nvcc cannot contract them into FMAs: the taps and weights are
// then bit-identical to the plain version's, and only the summation order of
// the (at most 4*S*S) products differs. A channel's products are summed in
// the order of the earlier one-thread-a-channel kernel: samples by (iy, ix),
// the four taps of a sample together.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // P * S per axis
constexpr int kWarps = 4;        // warps a block
constexpr int kMinBlocks = 6;    // blocks an SM must hold (caps the registers)
constexpr int kGroup = 2;        // samples whose taps are loaded together

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

struct Tap {  // one sample coordinate along one axis
  int lo, hi;
  float w_lo, w_hi;
};

// Tap indices and bilinear weights of one sample coordinate along one axis.
__device__ __forceinline__ Tap axis_tap(float coord, int size) {
  const float size_f = (float)size;
  const bool inside = (coord >= -1.0f) && (coord <= size_f);
  const float cc = fminf(fmaxf(coord, 0.0f), __fsub_rn(size_f, 1.0f));
  const float lo = floorf(cc);
  const float hi = fminf(__fadd_rn(lo, 1.0f), __fsub_rn(size_f, 1.0f));
  const float hw = __fsub_rn(cc, lo);
  const float lw = __fsub_rn(1.0f, hw);
  return Tap{(int)lo, (int)hi, inside ? lw : 0.0f, inside ? hw : 0.0f};
}

// A lane's 16 bytes of channels: kV values of T.
template <typename T> struct Lane;
template <> struct Lane<float> {
  static constexpr int kV = 4;
  __device__ __forceinline__ static float get(const uint4& v, int j) {
    const unsigned w = j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
    return __uint_as_float(w);
  }
  __device__ __forceinline__ static uint4 load(const float* p, int n, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint4 v;
    v.x = n > 0 ? __float_as_uint(__ldg(p)) : 0u;
    v.y = n > 1 ? __float_as_uint(__ldg(p + 1)) : 0u;
    v.z = n > 2 ? __float_as_uint(__ldg(p + 2)) : 0u;
    v.w = n > 3 ? __float_as_uint(__ldg(p + 3)) : 0u;
    return v;
  }
  __device__ __forceinline__ static void store(float* p, const float* acc, int n, bool vec) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      return;
    }
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (j < n) p[j] = acc[j];
  }
};
template <> struct Lane<__nv_bfloat16> {
  static constexpr int kV = 8;
  __device__ __forceinline__ static float get(const uint4& v, int j) {
    const unsigned w = (j >> 1) == 0 ? v.x : (j >> 1) == 1 ? v.y : (j >> 1) == 2 ? v.z : v.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static uint4 load(const __nv_bfloat16* p, int n, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned h[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) h[j] = j < n ? (unsigned)__ldg(q + j) : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                      h[6] | (h[7] << 16));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* acc, int n, bool vec) {
    unsigned short h[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[j]));
    if (vec) {
      *reinterpret_cast<uint4*>(p) = make_uint4(
          h[0] | ((unsigned)h[1] << 16), h[2] | ((unsigned)h[3] << 16),
          h[4] | ((unsigned)h[5] << 16), h[6] | ((unsigned)h[7] << 16));
      return;
    }
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (j < n) q[j] = h[j];
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) roi_align_fwd_kernel(
    Levels lv, const float* __restrict__ rois, const int* __restrict__ levels,
    const uint8_t* __restrict__ valid, T* __restrict__ out, int num_items, int R, int C, int P,
    int S, int vec) {
  using L = Lane<T>;
  constexpr int kV = L::kV;
  __shared__ Tap tabs[kWarps][2 * kMaxSamples];  // a warp's y then x sample taps

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + warp;  // < 2^31: checked by the entry point
  if (unit >= num_items * P) return;
  const int item = unit / P;       // image * R + roi
  const int ph = unit - item * P;  // the warp's bin row
  T* dst = out + (size_t)unit * P * C;
  const bool vec_ok = vec != 0;

  if (!valid[item]) {
    float zero[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) zero[j] = 0.0f;
    for (int pw = 0; pw < P; ++pw)
      for (int c0 = lane * kV; c0 < C; c0 += 32 * kV)
        L::store(dst + (size_t)pw * C + c0, zero, C - c0, vec_ok);
    return;
  }

  const int b = item / R;
  const int l = levels[item];
  // the level's fields by selects: an index into the parameter struct would
  // copy it to local memory
  const void* base = lv.ptr[0];
  int H = lv.h[0], W = lv.w[0];
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (l == i) {
      base = lv.ptr[i];
      H = lv.h[i];
      W = lv.w[i];
      scale = lv.scale[i];
    }
  }
  const T* feat = static_cast<const T*>(base) + (size_t)b * H * W * C;

  const float* roi = rois + (size_t)item * 4;
  const float x1 = __fmul_rn(__ldg(roi), scale);
  const float y1 = __fmul_rn(__ldg(roi + 1), scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(__ldg(roi + 2), scale), x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(__ldg(roi + 3), scale), y1), 1.0f);
  const float bin_w = __fdiv_rn(roi_w, (float)P);
  const float bin_h = __fdiv_rn(roi_h, (float)P);

  // the warp's S y samples (bin row ph) and P * S x samples, a lane each
  Tap* ytab = tabs[warp];
  Tap* xtab = tabs[warp] + S;
  for (int t = lane; t < S + P * S; t += 32) {
    const bool is_y = t < S;
    const int kk = is_y ? ph * S + t : t - S;
    const float frac = __fadd_rn((float)(kk / S),
                                 __fdiv_rn(__fadd_rn((float)(kk % S), 0.5f), (float)S));
    tabs[warp][t] = is_y ? axis_tap(__fadd_rn(y1, __fmul_rn(frac, bin_h)), H)
                         : axis_tap(__fadd_rn(x1, __fmul_rn(frac, bin_w)), W);
  }
  __syncwarp();

  const float count = (float)(S * S);
  const int ss = S * S;
  for (int pw = 0; pw < P; ++pw) {
    for (int c0 = lane * kV; c0 < C; c0 += 32 * kV) {
      const int n = C - c0;
      const bool v16 = vec_ok;
      float acc[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) acc[j] = 0.0f;
      for (int q0 = 0; q0 < ss; q0 += kGroup) {
        uint4 t[4 * kGroup];
        float w[4 * kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int q = q0 + u;
          if (q < ss) {
            const int iy = q / S;
            const Tap ty = ytab[iy];
            const Tap tx = xtab[pw * S + (q - iy * S)];
            const T* r_lo = feat + (size_t)ty.lo * W * C + c0;
            const T* r_hi = feat + (size_t)ty.hi * W * C + c0;
            t[4 * u] = L::load(r_lo + (size_t)tx.lo * C, n, v16);
            t[4 * u + 1] = L::load(r_lo + (size_t)tx.hi * C, n, v16);
            t[4 * u + 2] = L::load(r_hi + (size_t)tx.lo * C, n, v16);
            t[4 * u + 3] = L::load(r_hi + (size_t)tx.hi * C, n, v16);
            w[4 * u] = __fmul_rn(ty.w_lo, tx.w_lo);
            w[4 * u + 1] = __fmul_rn(ty.w_lo, tx.w_hi);
            w[4 * u + 2] = __fmul_rn(ty.w_hi, tx.w_lo);
            w[4 * u + 3] = __fmul_rn(ty.w_hi, tx.w_hi);
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (q0 + u < ss) {
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              acc[j] += L::get(t[4 * u], j) * w[4 * u] + L::get(t[4 * u + 1], j) * w[4 * u + 1]
                      + L::get(t[4 * u + 2], j) * w[4 * u + 2]
                      + L::get(t[4 * u + 3], j) * w[4 * u + 3];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kV; ++j) acc[j] = acc[j] / count;
      L::store(dst + (size_t)pw * C + c0, acc, n, v16);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. level_* are HOST arrays of
// num_levels entries; every other pointer is device memory. `vec` != 0
// promises C a multiple of 16 bytes' worth of channels and 16-byte aligned
// levels and output. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success).
extern "C" int mxdet_roi_align_fwd(const void* const* level_ptrs, const int* level_h,
                                   const int* level_w, const float* level_scale,
                                   int num_levels, const float* rois, const int* levels,
                                   const uint8_t* valid, void* out, int num_items, int R,
                                   int C, int P, int S, int is_bf16, int vec, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || P < 1 || S < 1 || P * S > kMaxSamples ||
      C < 1 || C > 1024)
    return (int)cudaErrorInvalidValue;
  if (num_items == 0) return 0;
  Levels lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : 0;
    lv.ptr[i] = level_ptrs[j];
    lv.h[i] = level_h[j];
    lv.w[i] = level_w[j];
    lv.scale[i] = level_scale[j];
  }
  const long long units = (long long)num_items * P;  // bin rows
  if (units + kWarps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((units + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        lv, rois, levels, valid, static_cast<__nv_bfloat16*>(out), num_items, R, C, P, S, vec);
  } else {
    roi_align_fwd_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        lv, rois, levels, valid, static_cast<float*>(out), num_items, R, C, P, S, vec);
  }
  return (int)cudaGetLastError();
}
