// Multilevel RoIAlign backward (aligned=False) over an FPN pyramid, sm_90a:
// each block owns a tile of a level's gradient and gathers the terms of the
// rois that touch it, so the gradient is written once, in the caller's dtype.
//
// Replaces two TPU kernels of mxdetection_tpu/ops/pallas/roi_align.py:
//  - _bwd_kernel (K3): per roi, fetch a 40x32 window of the level's grad
//    into VMEM, add Wx-scatter(Wy^T @ g), write it back, on a sequential
//    grid (so windows could not race), with coverage passes and a budget
//    lax.cond for rois wider than one window;
//  - kern in _convert_pallas (K3b): the f32 -> bf16 convert of the
//    accumulators, a firewall against XLA's bf16 propagation. Here it is the
//    epilogue of K3: a tile's f32 sums are rounded to bf16 (nearest even, as
//    torch's .to(torch.bfloat16)) as they are stored.
// Semantics are the transpose of csrc/roi_align.cu (K1) and equal torch
// autograd of mxdetection_tpu_torch/ops/roi_align.py::multilevel_roi_align_plain:
// every sample of every bin scatters g / (S*S) times its bilinear weight
// wy * wx into the sample's four taps on the roi's level. Invalid rois
// contribute nothing. There is no roi gradient (reference CUDA semantics).
//
// Work layout: the scatter inverted into a gather, because blocks run in
// parallel in no order and rois overlap.
//  - roi_tables_kernel, a thread per (image, roi): the roi's axis tables,
//    for each sample its two taps, their weights (by the same explicitly
//    rounded operations as K1, so each term equals the plain version's) and
//    its bin; and its footprint, the rows and columns of its level that its
//    samples touch with a nonzero weight, as two ranges (empty for an
//    invalid roi, or one whose samples all lie outside the map: their
//    clamped taps carry weight 0). All the divisions of the route are here.
//  - roi_align_bwd_kernel, a block per (level, image, kTH x kTW tile of
//    cells, kChunk channels), coarsest level first (its tiles hold the
//    longest roi lists). The block compacts the rois of its image whose
//    footprint meets the tile, in roi-index order, 2 * kThreads at a time
//    (a ballot and popc prefix), and walks the list kGroup rois at a time:
//    warp q reads roi q's axis tables into shared memory and builds, per
//    tile row and column, the masks of the samples whose lo or hi tap lands
//    there with a nonzero weight (a ballot a row or column) and the
//    rectangle of bins in reach of the tile; the block copies those bins of
//    g (its channels) into a shared-memory stage with cp.async, as many
//    rois as fit; then warp w, owning tile row w, adds for each of its kTW
//    cells, roi by roi in list order, in the order (sample row, lo/hi,
//    sample column, lo/hi), the terms (g / S^2) * (wy * wx) of the roi's
//    bins into f32 registers, kCV channels a lane. The tile is written
//    once, as f32 or bf16; a tile no roi touches is written as zeros, which
//    is the whole of the zeroing.
// No global atomics, no zeroing pass, no convert pass: the order of every
// sum is fixed, so two runs give the same bits. The plain model of this
// partition and order is ops/cuda/roi_align.py::roi_align_bwd_tiles, which
// reads kTH, kTW and kCV from this file.
//
// Bound: the bytes the function must move, g of the valid rois read once
// and every level's gradient written once. The kernel reads each roi's g
// once per tile it touches (from L2, into the stage), and its time goes to
// the per-block and per-roi latencies (the list, the tables, the stage) and
// to the terms (P*P*S*S*4 per roi and channel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // P * S per axis
constexpr int kTH = 8, kTW = 4;  // a block's tile: rows, columns of cells
constexpr int kCV = 8;           // channels a lane
constexpr int kChunk = 32 * kCV;     // channels a block
constexpr int kThreads = 32 * kTH;   // a warp per tile row
constexpr int kMaxTile = kTH > kTW ? kTH : kTW;
constexpr int kMinBlocks = 3;        // blocks an SM holds at least: up to 80 registers
constexpr int kGroup = kTH;          // rois whose tables a block builds at once, a warp each
constexpr int kStageBytes = 52 * 1024;  // g of a group's bins in reach of the tile
constexpr int kTablesThreads = 128;
static_assert(kCV % 4 == 0, "g is read and the gradient written four channels at a time");

struct Levels {
  void* ptr[kMaxLevels];     // (B, H, W, C) gradient of each level
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int tiles_x[kMaxLevels];   // tiles across a row of the level
  int tiles[kMaxLevels];     // tiles of the level, one image
  int order[kMaxLevels];     // the level of each launch range, coarsest first
  int first_block[kMaxLevels + 1];  // first block of each launch range
  int num;
};

// Tap indices and bilinear weights of one sample coordinate along one axis
// (the same function as K1's).
__device__ __forceinline__ void axis_weights(float coord, int size, int* lo_i, int* hi_i,
                                             float* lo_w, float* hi_w) {
  const float size_f = (float)size;
  const bool inside = (coord >= -1.0f) && (coord <= size_f);
  const float cc = fminf(fmaxf(coord, 0.0f), __fsub_rn(size_f, 1.0f));
  const float lo = floorf(cc);
  const float hi = fminf(__fadd_rn(lo, 1.0f), __fsub_rn(size_f, 1.0f));
  const float hw = __fsub_rn(cc, lo);
  const float lw = __fsub_rn(1.0f, hw);
  *lo_i = (int)lo;
  *hi_i = (int)hi;
  *lo_w = inside ? lw : 0.0f;
  *hi_w = inside ? hw : 0.0f;
}

// Start and bin size of a roi along one axis (0: y, 1: x) on its level.
__device__ __forceinline__ void roi_axis(const float* roi, float scale, int P, int axis,
                                         float* start, float* bin) {
  const float a = __fmul_rn(roi[axis == 0 ? 1 : 0], scale);
  const float len = fmaxf(__fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], scale), a), 1.0f);
  *start = a;
  *bin = __fdiv_rn(len, (float)P);
}

// Coordinate of sample k (bin k / S, sample k % S in it): start + (i + (j + .5) / S) * bin.
__device__ __forceinline__ float sample_coord(float start, float bin, int k, int S) {
  const float frac = __fadd_rn((float)(k / S),
                               __fdiv_rn(__fadd_rn((float)(k % S), 0.5f), (float)S));
  return __fadd_rn(start, __fmul_rn(frac, bin));
}

// A footprint: {y0 | y1 << 16, x0 | x1 << 16, level, 0}, level -1 if empty.
__device__ __forceinline__ bool meets(int4 f, int l, int ty0, int tx0) {
  return f.z == l && (f.x & 0xffff) < ty0 + kTH && ty0 <= (f.x >> 16) &&
         (f.y & 0xffff) < tx0 + kTW && tx0 <= (f.y >> 16);
}

// Table entry of sample k on one axis: {lo | hi << 16, its bin along the
// axis (k / S), lo weight, hi weight}.
__global__ void roi_tables_kernel(Levels lv, const float* __restrict__ rois,
                                  const int* __restrict__ levels,
                                  const uint8_t* __restrict__ valid, int4* __restrict__ fp,
                                  int4* __restrict__ tables, int num_items, int P, int S) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= num_items) return;
  int4 out = make_int4(0, 0, -1, 0);  // empty
  const int l = levels[item];
  if (valid[item] && l >= 0 && l < lv.num) {
    const int n = P * S;
    int range[2][2];
    for (int axis = 0; axis < 2; ++axis) {
      float start, bin;
      roi_axis(rois + (size_t)item * 4, lv.scale[l], P, axis, &start, &bin);
      const int size = axis == 0 ? lv.h[l] : lv.w[l];
      int4* tab = tables + ((size_t)item * 2 + axis) * n;
      int first = 1 << 30, last = -1;
      for (int k = 0; k < n; ++k) {
        int lo, hi;
        float lw, hw;
        axis_weights(sample_coord(start, bin, k, S), size, &lo, &hi, &lw, &hw);
        tab[k] = make_int4(lo | (hi << 16), k / S, __float_as_int(lw), __float_as_int(hw));
        if (lw != 0.0f) {
          first = min(first, lo);
          last = max(last, lo);
        }
        if (hw != 0.0f) last = max(last, hi);
      }
      range[axis][0] = first;
      range[axis][1] = last;
    }
    if (range[0][0] <= range[0][1] && range[1][0] <= range[1][1])
      out = make_int4(range[0][0] | (range[0][1] << 16), range[1][0] | (range[1][1] << 16), l,
                      0);
  }
  fp[item] = out;
}

// kCV channels from p on: four at a time when vec (every run of four
// channels aligned to its size, checked by the entry point) and all kCV are
// below C (n, the channels left from p on, is at least kCV); else one by
// one, with channels past C read as 0.
__device__ __forceinline__ void load_g(const float* p, bool vec, int n, float* v) {
  if (vec && n >= kCV) {
#pragma unroll
    for (int j = 0; j < kCV; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCV; ++j) v[j] = j < n ? p[j] : 0.0f;
  }
}

__device__ __forceinline__ void load_g(const __nv_bfloat16* p, bool vec, int n, float* v) {
  if (vec && n >= kCV) {
#pragma unroll
    for (int j = 0; j < kCV; j += 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p + j);
      v[j] = __uint_as_float(q.x << 16);
      v[j + 1] = __uint_as_float(q.x & 0xffff0000u);
      v[j + 2] = __uint_as_float(q.y << 16);
      v[j + 3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCV; ++j) v[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
  }
}

__device__ __forceinline__ void store_out(float* p, bool vec, int n, const float* v) {
  if (vec && n >= kCV) {
#pragma unroll
    for (int j = 0; j < kCV; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCV; ++j)
      if (j < n) p[j] = v[j];
  }
}

// Rounded to nearest even, as torch's .to(torch.bfloat16).
__device__ __forceinline__ void store_out(__nv_bfloat16* p, bool vec, int n, const float* v) {
  if (vec && n >= kCV) {
#pragma unroll
    for (int j = 0; j < kCV; j += 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[j], v[j + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[j + 2], v[j + 3]);
      uint2 q;
      q.x = *reinterpret_cast<const unsigned*>(&lo);
      q.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(p + j) = q;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCV; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}

// The bins of a roi's g in reach of a tile, and where the term loop reads
// them: from the stage, or from g where they do not fit there.
struct RoiG {
  int r0, c0, nr, nc;  // the bins in reach of the tile (nr = 0: none)
  int staged;          // its offset in the stage, in TG elements, or -1: read from g
};

// One warp: roi ``item``'s axis tables into shared memory, per tile row (y)
// and column (x) the masks of the samples whose lo or hi tap lands there
// with a nonzero weight, and the rectangle of bins in reach of the tile.
__device__ __forceinline__ void build_roi(const int4* __restrict__ tables, int item, int n,
                                          int ty0, int tx0, float (*w)[2][kMaxSamples],
                                          int (*bin)[kMaxSamples],
                                          unsigned long long (*mask)[2][kMaxTile], RoiG* rg) {
  const int lane = threadIdx.x % 32;
  int4 e[2][2];  // [axis][half]: every table read in flight at once
#pragma unroll
  for (int axis = 0; axis < 2; ++axis)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      e[axis][h] = k < n ? tables[((size_t)item * 2 + axis) * n + k] : make_int4(0, 0, 0, 0);
    }
  int first[2], count[2];
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const int t0 = axis == 0 ? ty0 : tx0;
    const int extent = axis == 0 ? kTH : kTW;
    unsigned long long touched = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      if (k < n) {
        w[axis][0][k] = __int_as_float(e[axis][h].z);
        w[axis][1][k] = __int_as_float(e[axis][h].w);
        bin[axis][k] = e[axis][h].y;
      }
    }
#pragma unroll
    for (int t = 0; t < extent; ++t) {
      unsigned long long m_lo = 0, m_hi = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4 q = e[axis][h];
        m_lo |= (unsigned long long)__ballot_sync(
                    0xffffffffu, q.z != 0 && (q.x & 0xffff) == t0 + t) << (32 * h);
        m_hi |= (unsigned long long)__ballot_sync(
                    0xffffffffu, q.w != 0 && (q.x >> 16) == t0 + t) << (32 * h);
      }
      if (lane == 0) {
        mask[axis][0][t] = m_lo;
        mask[axis][1][t] = m_hi;
      }
      touched |= m_lo | m_hi;
    }
    // the bins from the first to the last sample that touches the tile
    first[axis] = count[axis] = 0;
    if (touched) {
      const int k0 = __ffsll((long long)touched) - 1;
      const int k1 = 63 - __clzll((long long)touched);
      first[axis] = __shfl_sync(0xffffffffu, k0 < 32 ? e[axis][0].y : e[axis][1].y, k0 % 32);
      count[axis] = __shfl_sync(0xffffffffu, k1 < 32 ? e[axis][0].y : e[axis][1].y, k1 % 32) -
                    first[axis] + 1;
    }
  }
  if (lane == 0) *rg = RoiG{first[0], first[1], count[1] ? count[0] : 0, count[0] ? count[1] : 0, -1};
}

// A mask of samples in registers: 32 bits when P * S <= 32 (the main
// path's 14), else 64; the shared-memory masks are 64 bits, low word first.
template <bool kWide>
struct Bits {
  using T = unsigned;
  static __device__ __forceinline__ int first(T m) { return __ffs((int)m) - 1; }
  static __device__ __forceinline__ T read(const unsigned long long* p) {
    return *static_cast<const volatile unsigned*>(reinterpret_cast<const unsigned*>(p));
  }
};

template <>
struct Bits<true> {
  using T = unsigned long long;
  static __device__ __forceinline__ int first(T m) { return __ffsll((long long)m) - 1; }
  static __device__ __forceinline__ T read(const unsigned long long* p) {
    return *static_cast<const volatile unsigned long long*>(p);
  }
};

// One warp: a roi's terms on its tile row (y masks y_lo, y_hi) into acc, in
// the order (sample row, lo/hi, sample column, lo/hi); bin (row, col) of g
// at gb + ((row - r0) * row_bins + col - c0) * bin_elems, n channels left.
// g / S^2 is rounded once to f32: a product with the f32 reciprocal where
// that is exact (kPow2), else in f64 and rounded to f32, which a quotient of
// a float by an integer up to 4096 never tells apart from the f32 division
// (it lies 2^-37 or more, relatively, from any float midpoint; the f64
// product is within 2^-52). No division here: its slow path is a call,
// which would spill the sums around it.
template <typename TG, bool kPow2, bool kStaged, bool kWide>
__device__ __forceinline__ void add_roi(const TG* gb, int row_bins, int bin_elems, int r0, int c0,
                                        bool vec, int nleft, double inv_count,
                                        float (*w)[2][kMaxSamples], int (*bin)[kMaxSamples],
                                        const unsigned long long* y_mask,
                                        unsigned long long (*x_mask)[kMaxTile],
                                        float (*acc)[kCV]) {
  const float inv_count_f = (float)inv_count;
  using M = Bits<kWide>;
  const typename M::T y_lo = M::read(y_mask), y_hi = M::read(y_mask + kMaxTile);
  typename M::T ym = y_lo | y_hi;
  while (ym) {
    const int ky = M::first(ym);
    ym &= ym - 1;
    const TG* grow = gb + (size_t)(bin[0][ky] - r0) * row_bins * bin_elems;
#pragma unroll
    for (int sy = 0; sy < 2; ++sy) {
      if (!(((sy ? y_hi : y_lo) >> ky) & 1u)) continue;
      const float a = w[0][sy][ky];
#pragma unroll
      for (int x = 0; x < kTW; ++x) {
        // read where used (volatile), not hoisted out of the loop into
        // registers
        const typename M::T x_lo = M::read(&x_mask[0][x]), x_hi = M::read(&x_mask[1][x]);
        typename M::T xm = x_lo | x_hi;
        while (xm) {
          const int kx = M::first(xm);
          xm &= xm - 1;
          float gv[kCV];
          // the stage holds whole, zero-padded slots: one vector read
          load_g(grow + (bin[1][kx] - c0) * bin_elems, kStaged || vec, kStaged ? kCV : nleft, gv);
#pragma unroll
          for (int j = 0; j < kCV; ++j)
            gv[j] = kPow2 ? __fmul_rn(gv[j], inv_count_f)
                          : __double2float_rn(__dmul_rn((double)gv[j], inv_count));
#pragma unroll
          for (int sx = 0; sx < 2; ++sx) {
            if (!(((sx ? x_hi : x_lo) >> kx) & 1u)) continue;
            const float ab = __fmul_rn(a, w[1][sx][kx]);
#pragma unroll
            for (int j = 0; j < kCV; ++j) acc[x][j] = __fadd_rn(acc[x][j], __fmul_rn(gv[j], ab));
          }
        }
      }
    }
  }
}

// A block's tile: its level, image, first row and column of cells, and its
// channels [c0, c0 + width). Decoded from blockIdx read through asm
// volatile, so the compiler recomputes it where it is used instead of
// holding it in registers through the term loop; the level's fields are
// picked with constant indices, so the parameter arrays stay in the
// constant bank.
struct Tile {
  int l, b, ty0, tx0, c0, width;
};

__device__ __forceinline__ Tile block_tile(const Levels& lv, int chunks, int C) {
  int bid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bid));
  Tile t;
  int first = 0;
  t.l = lv.order[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < lv.num && bid >= lv.first_block[i]) {
      t.l = lv.order[i];
      first = lv.first_block[i];
    }
  int tiles = 1, tiles_x = 1;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i == t.l) {
      tiles = lv.tiles[i];
      tiles_x = lv.tiles_x[i];
    }
  int rem = bid - first;
  t.c0 = (rem % chunks) * kChunk;
  t.width = min(kChunk, C - t.c0);
  rem /= chunks;
  const int tile = rem % tiles;
  t.b = rem / tiles;
  t.ty0 = (tile / tiles_x) * kTH;
  t.tx0 = (tile % tiles_x) * kTW;
  return t;
}

// Blocks an SM must hold, which sets the register budget: kMinBlocks (80
// registers) for the main paths' instantiations, S^2 a power of two, at
// most 32 samples an axis, g and gradients of one dtype; 2 (128 registers)
// for the rest, which need a few more (bf16 g summed into f32 gradients,
// the f64 quotient, 64-bit masks) and would spill in 80.
template <typename TG, typename TO, bool kPow2, bool kWide>
constexpr int min_blocks() {
  return kPow2 && !kWide && std::is_same<TG, TO>::value ? kMinBlocks : 2;
}

// kPow2: S^2 is a power of two (the main path's S = 2), so g / S^2 is a
// product with an exact reciprocal; kWide: P * S > 32 (64-bit masks).
// Dynamic shared memory: kStageBytes.
template <typename TG, typename TO, bool kPow2, bool kWide>
__global__ void __launch_bounds__(kThreads, (min_blocks<TG, TO, kPow2, kWide>()))
roi_align_bwd_kernel(Levels lv, const int4* __restrict__ fp, const int4* __restrict__ tables,
                     const TG* __restrict__ g, int R, int C, int P, int S, int chunks,
                     double inv_count, bool vec) {
  // The tables of a group of rois: [roi of the group][axis].
  __shared__ float s_w[kGroup][2][2][kMaxSamples];   // [.][.][lo, hi][sample] weights
  __shared__ int s_bin[kGroup][2][kMaxSamples];      // the sample's bin along the axis
  __shared__ unsigned long long s_mask[kGroup][2][2][kMaxTile];  // [.][.][lo, hi][row or col]
  __shared__ RoiG s_roi[kGroup];
  __shared__ int s_item[kGroup];
  __shared__ int s_list[2 * kThreads];
  __shared__ int s_count[2][kTH];
  extern __shared__ uint4 s_stage[];  // kStageBytes

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kVec = 16 / (int)sizeof(TG);   // channels a 16-byte copy moves

  float acc[kTW][kCV];
#pragma unroll
  for (int x = 0; x < kTW; ++x)
#pragma unroll
    for (int j = 0; j < kCV; ++j) acc[x][j] = 0.0f;

  for (int base = 0; base < R; base += 2 * kThreads) {
    // The rois of this image that touch the tile, in roi-index order, two a
    // thread, both footprints read at once.
    bool hit[2];
    {
      const Tile t = block_tile(lv, chunks, C);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = base + h * kThreads + (int)threadIdx.x;
        hit[h] = r < R && meets(fp[t.b * R + r], t.l, t.ty0, t.tx0);
      }
    }
    unsigned ballot[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ballot[h] = __ballot_sync(0xffffffffu, hit[h]);
      if (lane == 0) s_count[h][warp] = __popc(ballot[h]);
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int before = total;
#pragma unroll
      for (int w = 0; w < kTH; ++w) {
        before += w < warp ? s_count[h][w] : 0;
        total += s_count[h][w];
      }
      if (hit[h])
        s_list[before + __popc(ballot[h] & ((1u << lane) - 1u))] = base + h * kThreads +
                                                                    (int)threadIdx.x;
    }
    __syncthreads();

    for (int g0 = 0; g0 < total;) {
      const int gn = min(kGroup, total - g0);
      if (warp < gn) {
        const Tile t = block_tile(lv, chunks, C);
        const int item = t.b * R + s_list[g0 + warp];
        s_item[warp] = item;
        build_roi(tables, item, P * S, t.ty0, t.tx0, s_w[warp], s_bin[warp], s_mask[warp],
                  &s_roi[warp]);
      }
      __syncthreads();
      // Stage the bins in reach of the rois that fit, in list order; a roi
      // that would overflow the stage ends the group (the first one always
      // fits: its P * P bins take at most kStageBytes for P = 7); a roi
      // wider than the stage alone is read from g.
      int fit = 0;
      for (int q = 0, used = 0; q < gn; ++q) {
        const Tile t = block_tile(lv, chunks, C);
        const int c0 = t.c0, width = t.width;
        // A bin's slot in the stage: its channels, zero-padded to a whole lane's.
        const int bin_elems = (width + kCV - 1) / kCV * kCV, bin_vecs = bin_elems / kVec;
        const int bins = s_roi[q].nr * s_roi[q].nc;
        if ((used + bins) * bin_vecs * 16 > kStageBytes) {
          if (q == 0) fit = 1;  // read from g
          break;
        }
        const TG* src = g + (size_t)s_item[q] * P * P * C + c0;
        for (int i = threadIdx.x; i < bins * bin_vecs; i += kThreads) {
          const int bi = i / bin_vecs, v = i % bin_vecs;
          const int row = s_roi[q].r0 + bi / s_roi[q].nc, col = s_roi[q].c0 + bi % s_roi[q].nc;
          const TG* from = src + (size_t)(row * P + col) * C + v * kVec;
          uint4* to = s_stage + (used + bi) * bin_vecs + v;
          if (vec && v * kVec + kVec <= width) {
            cp_async16(to, from);
          } else {  // the ragged end of the chunk, or rows not 16-byte aligned
            TG* dst = reinterpret_cast<TG*>(to);
            for (int j = 0; j < kVec; ++j) dst[j] = v * kVec + j < width ? from[j] : TG(0.0f);
          }
        }
        if (threadIdx.x == 0) s_roi[q].staged = used * bin_elems;
        used += bins;
        fit = q + 1;
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      // Lanes past the chunk's channels sit the sums out: their stage reads
      // would run past a bin's slot.
      for (int q = 0; q < fit; ++q) {
        const RoiG rg = s_roi[q];
        const Tile t = block_tile(lv, chunks, C);
        const int c0 = t.c0, width = t.width, bin_elems = (width + kCV - 1) / kCV * kCV;
        if (rg.nr == 0 || lane * kCV >= width) continue;
        if (rg.staged >= 0) {
          add_roi<TG, kPow2, true, kWide>(
              reinterpret_cast<const TG*>(s_stage) + rg.staged + lane * kCV, rg.nc, bin_elems,
              rg.r0, rg.c0, true, kCV, inv_count, s_w[q], s_bin[q], &s_mask[q][0][0][warp],
              s_mask[q][1], acc);
        } else {
          add_roi<TG, kPow2, false, kWide>(
              g + (size_t)s_item[q] * P * P * C + c0 + lane * kCV +
                  (size_t)(rg.r0 * P + rg.c0) * C,
              P, C, rg.r0, rg.c0, vec, width - lane * kCV, inv_count, s_w[q], s_bin[q],
              &s_mask[q][0][0][warp], s_mask[q][1], acc);
        }
      }
      __syncthreads();  // the group's tables and stage are rewritten next
      g0 += fit;
    }
  }

  const Tile t = block_tile(lv, chunks, C);
  int H = 1, W = 1;
  void* out = nullptr;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i == t.l) {
      H = lv.h[i];
      W = lv.w[i];
      out = lv.ptr[i];
    }
  const int y = t.ty0 + warp, nleft = t.width - lane * kCV;
  if (y < H) {
    TO* row = static_cast<TO*>(out) + ((size_t)t.b * H + y) * W * C + t.c0 + lane * kCV;
#pragma unroll
    for (int x = 0; x < kTW; ++x)
      if (t.tx0 + x < W) store_out(row + (size_t)(t.tx0 + x) * C, vec, nleft, acc[x]);
  }
}

template <typename TG, typename TO, bool kPow2, bool kWide>
int launch_bwd(const Levels& lv, long long blocks, const int4* fp, const int4* tables,
               const void* g, int R, int C, int P, int S, int chunks, bool vec, cudaStream_t s) {
  auto kernel = roi_align_bwd_kernel<TG, TO, kPow2, kWide>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, kStageBytes, s>>>(
      lv, fp, tables, static_cast<const TG*>(g), R, C, P, S, chunks, 1.0 / (double)(S * S), vec);
  return (int)cudaGetLastError();
}

template <typename TG, typename TO>
int launch_bwd(const Levels& lv, long long blocks, const int4* fp, const int4* tables,
               const void* g, int R, int C, int P, int S, int chunks, bool vec, cudaStream_t s) {
  const bool pow2 = ((S * S) & (S * S - 1)) == 0, wide = P * S > 32;
  auto launch = pow2 ? (wide ? launch_bwd<TG, TO, true, true> : launch_bwd<TG, TO, true, false>)
                     : (wide ? launch_bwd<TG, TO, false, true> : launch_bwd<TG, TO, false, false>);
  return launch(lv, blocks, fp, tables, g, R, C, P, S, chunks, vec, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes.
//
// mxdet_roi_align_bwd: level_* are HOST arrays of num_levels entries;
// grad_ptrs point at (B, H_l, W_l, C) device buffers, f32 or bf16
// (out_is_bf16), that the kernel writes whole; rois (B*R, 4) f32, levels
// (B*R) int32, valid (B*R) bool and g (B*R, P, P, C) f32 or bf16
// (g_is_bf16) are device memory; scratch is (B*R) * (1 + 2 * P * S) int4
// of device memory (the footprints, then the axis tables).
extern "C" int mxdet_roi_align_bwd(void* const* grad_ptrs, const int* level_h,
                                   const int* level_w, const float* level_scale, int num_levels,
                                   const float* rois, const int* levels, const uint8_t* valid,
                                   const void* g, void* scratch, int B, int R, int C, int P,
                                   int S, int g_is_bf16, int out_is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || P < 1 || S < 1 || P * S > kMaxSamples ||
      C < 1 || C > 1024 || B < 0 || R < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  lv.num = num_levels;
  const int chunks = (C + kChunk - 1) / kChunk;
  for (int i = 0; i < num_levels; ++i) {
    if (level_h[i] < 1 || level_w[i] < 1 || level_h[i] > 32767 || level_w[i] > 32767)
      return (int)cudaErrorInvalidValue;  // cells are kept in 16 bits
    lv.ptr[i] = grad_ptrs[i];
    lv.h[i] = level_h[i];
    lv.w[i] = level_w[i];
    lv.scale[i] = level_scale[i];
    lv.tiles_x[i] = (level_w[i] + kTW - 1) / kTW;
    lv.tiles[i] = ((level_h[i] + kTH - 1) / kTH) * lv.tiles_x[i];
  }
  long long blocks = 0;
  for (int i = 0; i < num_levels; ++i) {
    const int l = num_levels - 1 - i;  // coarsest first
    lv.order[i] = l;
    lv.first_block[i] = (int)blocks;
    blocks += (long long)B * lv.tiles[l] * chunks;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = B * R;
  int4* fp = static_cast<int4*>(scratch);
  int4* tables = fp + items;
  if (items > 0) {
    roi_tables_kernel<<<(items + kTablesThreads - 1) / kTablesThreads, kTablesThreads, 0, s>>>(
        lv, rois, levels, valid, fp, tables, items, P, S);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // Vector loads and stores need every run of four channels aligned to its
  // size; the stage's 16-byte copies need C a multiple of 8 (bf16) or 4.
  const uintptr_t out_align = out_is_bf16 ? 8 : 16;
  bool vec = C % (g_is_bf16 ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  for (int i = 0; i < num_levels; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(grad_ptrs[i]) % out_align == 0;
  if (g_is_bf16)
    return out_is_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>(lv, blocks, fp, tables, g, R,
                                                                  C, P, S, chunks, vec, s)
                       : launch_bwd<__nv_bfloat16, float>(lv, blocks, fp, tables, g, R, C, P,
                                                          S, chunks, vec, s);
  return out_is_bf16 ? launch_bwd<float, __nv_bfloat16>(lv, blocks, fp, tables, g, R, C, P, S,
                                                        chunks, vec, s)
                     : launch_bwd<float, float>(lv, blocks, fp, tables, g, R, C, P, S, chunks,
                                                vec, s);
}

// mxdet_roi_align_bwd_layout: out[0..3] = the tile's rows and columns of
// cells, the channels a block sums (kChunk) and its threads. Launches nothing.
extern "C" int mxdet_roi_align_bwd_layout(int* out) {
  out[0] = kTH;
  out[1] = kTW;
  out[2] = kChunk;
  out[3] = kThreads;
  return 0;
}
