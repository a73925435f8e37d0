// Banded shared-memory resample for Hopper (sm_90a), shared by both
// preprocess kernels (fused_preprocess.cu, fused_preprocess_v2.cu).
//
// The function (ann3depth_tpu_torch/ops/fused_preprocess.py): per frame b, a
// [B, 8] f32 param row (y_start, y_scale, x_start, x_scale, out_scale,
// brightness, contrast, photo) drives a separable antialiased triangle
// resample with half-pixel centers,
//
//   R[o, k]      = sum_{i in band_y(o)} wy[o, i] X[i, k]      (k = j*C + c)
//   Z[o, p*C+c]  = sum_{j in band_x(p)} wx[p, j] R[o, j*C+c]
//
// then the per-channel normalization (image) or the validity renormalization
// (depth, C = 1: X is masked by its validity V on the raw grid and Rv, Zv
// resample V alike). The two kernels differ only in precision, a policy:
//
// - ExactF32 (v1): every value and weight in f32.
// - Bf16Operands (v2): R (and Rv) rounded to bf16, the x weights rounded to
//   bf16, their products (exact in f32) summed in f32; the normalization as
//   the TPU v2 kernel folds it (z * s_c + b_c).
//
// Bound: memory. At the train shape (u8 [16,480,640,3] -> f32
// [16,240,320,3]) the band's work is ~0.1 GFLOP (~2 us at 67 TFLOP/s f32)
// and the bytes are 29.5 MB (frames read once, output written once), 8.8 us
// at 3.35 TB/s. So what pays is moving each byte once: no tensor cores.
//
// Design, what it does about that bound:
// - Weights in the kernel. The band (first tap, tap count, normalized
//   weights) of each output row of a block's tile and of every output column
//   is computed once per block into shared memory, with the arithmetic of
//   ops/resize.py: src = start + (o + 0.5) * scale - 0.5 rounded step by
//   step, r = max(|scale|, 1), tri = max(0, 1 - |src - i| / r), divided by
//   the band's sum. The two divides are multiplies by reciprocals taken
//   once per band (triangle_matrix divides; the weights then differ by a
//   few f32 ulps, far inside v1's tolerance, and v2's bound allows a bf16
//   rounding flip of a weight). No weight matrix exists in device memory.
// - A block owns a tile of tile_rows output rows of one frame at full output
//   width. Full-width source rows are contiguous, so the source rows its
//   bands need are one contiguous range: it is copied into shared memory
//   with 16-byte cp.async (the unaligned head and tail, e.g. of 220-byte
//   depth rows, with plain loads) while the weights are computed. Two such
//   blocks of 256 threads share an SM at the train shape (107 KB of shared
//   memory and 64 registers a thread each), and their phases overlap.
// - Vertical pass once per source column: R for the tile, in shared memory.
// - Horizontal pass from shared memory, epilogue fused; the output tile is
//   staged in shared memory (where the source rows were) and written with
//   16-byte stores, since a tile's output rows are contiguous too.
// - The dynamic shared-memory layout comes from a plan that the wrapper
//   computes (ops/fused_preprocess.band_plan) from the shapes and the
//   largest |scale| the param rows may have. A block whose bands exceed the
//   plan (a param row outside the wrapper's contract) computes its outputs
//   straight from device memory instead, with the same arithmetic: slower,
//   never wrong.
// - The photometric mean spans the whole frame: one partial sum per block,
//   then the pass of photometric.cuh (2 launches in image mode, 1 in depth).
// A persistent variant (each block walking several tiles, the next tile's
// copy double-buffered under the current one's compute) fits one block an
// SM and measured slower on an H100 (PERF.md): the passes need the warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "photometric.cuh"

namespace a3d {

constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kMaxDevices = 64;

// compat/reference_spec.py
constexpr float kDepthEps = 1e-6f;
constexpr float kDepthCap = 70.0f;
constexpr float kValidThresh = 0.5f;

// The tiling plan (ops/fused_preprocess.band_plan): output rows a block
// owns, source rows it may stage, the most taps an output may have on each
// axis, and the dynamic shared memory of the layout below.
struct BandPlan {
  int tile_rows, stage_rows, taps_y, taps_x, smem_bytes;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared memory; band_plan mirrors this.
struct BandLayout {
  size_t wy, ylo, ynt, wx, xlo, xnt, r, stage, total;
};

__host__ __device__ inline BandLayout band_layout(const BandPlan& p, int W,
                                                  int C, int w, int itemsize,
                                                  bool depth) {
  const size_t tm = p.tile_rows, n = static_cast<size_t>(W) * C;
  BandLayout l;
  size_t off = 0;
  l.wy = off;   off += align16(tm * p.taps_y * 4);
  l.ylo = off;  off += align16(tm * 4);
  l.ynt = off;  off += align16(tm * 4);
  l.wx = off;   off += align16(static_cast<size_t>(w) * p.taps_x * 4);
  l.xlo = off;  off += align16(static_cast<size_t>(w) * 4);
  l.xnt = off;  off += align16(static_cast<size_t>(w) * 4);
  l.r = off;    off += align16((depth ? 2 : 1) * tm * n * 4);
  // The source rows (plus 16 bytes to keep their device-memory alignment),
  // later the output tile (plus 16 bytes, likewise).
  const size_t in_b = static_cast<size_t>(p.stage_rows) * n * itemsize + 16;
  const size_t out_b = tm * w * C * 4 + 16;
  l.stage = off;
  off += align16(in_b > out_b ? in_b : out_b);
  l.total = off;
  return l;
}

// One output index's source band on one axis: taps [lo, hi].
struct Band {
  float src, radius, inv_radius;
  int lo, hi;
};

__device__ __forceinline__ Band band_of(int o, int n_in, float start,
                                        float scale) {
  Band b;
  // src = start + (o + 0.5) * scale - 0.5, rounded step by step as
  // ops/resize.py computes it (no fused multiply-add).
  b.src = __fsub_rn(
      __fadd_rn(start, __fmul_rn(static_cast<float>(o) + 0.5f, scale)), 0.5f);
  b.radius = fmaxf(fabsf(scale), 1.0f);
  b.inv_radius = 1.0f / b.radius;
  b.lo = max(0, static_cast<int>(ceilf(b.src - b.radius)));
  b.hi = min(n_in - 1, static_cast<int>(floorf(b.src + b.radius)));
  return b;
}

__device__ __forceinline__ float tri(const Band& b, int i) {
  return fmaxf(0.0f,
               1.0f - fabsf(b.src - static_cast<float>(i)) * b.inv_radius);
}

// 1 / the band's weight sum (summed in increasing i, clamped as
// triangle_matrix clamps it).
__device__ __forceinline__ float band_inv_norm(const Band& b) {
  float sum = 0.0f;
  for (int i = b.lo; i <= b.hi; ++i) sum += tri(b, i);
  return 1.0f / fmaxf(sum, 1e-8f);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v1: exact f32.
struct ExactF32 {
  static __device__ __forceinline__ float row(float r) { return r; }
  static __device__ __forceinline__ float col_weight(float w) { return w; }
  // (z / 255 - mean) / sd, its divides as multiplies by the f32
  // reciprocals (within 2 f32 ulps of the divides; v1's tolerance is 1e-4).
  static __device__ __forceinline__ float normalize(float z, int c) {
    const float mean = c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
    const float inv_sd = c == 0 ? 1.0f / 0.229f
                                : (c == 1 ? 1.0f / 0.224f : 1.0f / 0.225f);
    return __fmul_rn(__fsub_rn(__fmul_rn(z, 1.0f / 255.0f), mean), inv_sd);
  }
};

// v2: R rounded to bf16, bf16 x weights, f32 sums; normalization constants
// folded as the TPU kernel folds them (f64 -> f32).
struct Bf16Operands {
  static __device__ __forceinline__ float row(float r) { return round_bf16(r); }
  static __device__ __forceinline__ float col_weight(float w) {
    return round_bf16(w);
  }
  static __device__ __forceinline__ float normalize(float z, int c) {
    const float s = c == 0 ? static_cast<float>(1.0 / (255.0 * 0.229))
                           : (c == 1 ? static_cast<float>(1.0 / (255.0 * 0.224))
                                     : static_cast<float>(1.0 / (255.0 * 0.225)));
    const float b = c == 0 ? static_cast<float>(-0.485 / 0.229)
                           : (c == 1 ? static_cast<float>(-0.456 / 0.224)
                                     : static_cast<float>(-0.406 / 0.225));
    return __fadd_rn(__fmul_rn(z, s), b);
  }
};

// Byte k of v as a float: 0x4B0000bb is 2^23 + bb exactly.
__device__ __forceinline__ float u8_to_f32(uint32_t v, int k) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | k)) -
         8388608.0f;
}

// Advances the (row, column) pair of a flattened item by kBandThreads
// items, without a divide where a row holds kBandThreads items or more.
__device__ __forceinline__ void step(int& row, int& col, int n) {
  col += kBandThreads;
  if (col < n) return;
  if (n >= kBandThreads) {
    col -= n;
    ++row;
  } else {
    row += col / n;
    col %= n;
  }
}

__device__ __forceinline__ float validity(float d) {
  return (d > kDepthEps && d <= kDepthCap) ? 1.0f : 0.0f;
}

template <class P, bool kDepth>
__device__ __forceinline__ float epilogue(float z, float zv, int c,
                                          float out_scale, bool norm) {
  if constexpr (kDepth) {
    return zv >= kValidThresh ? (z / fmaxf(zv, 1e-6f)) * out_scale : 0.0f;
  } else {
    return norm ? P::normalize(z, c) : __fmul_rn(z, 1.0f / 255.0f);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// One tile of tile_rows output rows of frame b: where its source rows lie
// (one contiguous range [row0, row0 + n_stage)) and whether its row bands
// fit the plan. Every thread works it out alike, so all agree without a
// barrier.
struct TileSrc {
  int b, t, o0, rows, row0, n_stage;
  bool fits;
};

__device__ __forceinline__ TileSrc tile_source(int tile, int tiles, int H,
                                               int h, const float* params,
                                               const BandPlan& plan) {
  TileSrc s;
  s.b = tile / tiles;
  s.t = tile - s.b * tiles;
  s.o0 = s.t * plan.tile_rows;
  s.rows = min(plan.tile_rows, h - s.o0);
  const float* p = params + 8 * s.b;
  int row0 = H, row_end = -1;
  bool fits = true;
  for (int i = 0; i < s.rows; ++i) {
    const Band by = band_of(s.o0 + i, H, p[0], p[1]);
    if (by.hi < by.lo) continue;
    row0 = min(row0, by.lo);
    row_end = max(row_end, by.hi);
    fits = fits && by.hi - by.lo + 1 <= plan.taps_y;
  }
  s.row0 = row_end >= row0 ? row0 : 0;
  s.n_stage = row_end >= row0 ? row_end - row0 + 1 : 0;
  s.fits = fits && s.n_stage <= plan.stage_rows;
  return s;
}

// Starts the copy of a tile's source rows into buf, 16 bytes at a time
// where both sides are aligned: the rows land at their device-memory
// address mod 16, which is returned. Plain loads for the unaligned head and
// tail. The caller commits the group.
template <typename T>
__device__ __forceinline__ int stage_rows(const T* frames, const TileSrc& s,
                                          int H, int N, unsigned char* buf,
                                          int tid) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      frames + (static_cast<size_t>(s.b) * H + s.row0) * N);
  const int pad = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  if (!s.fits) return pad;
  unsigned char* dst = buf + pad;
  const size_t nbytes = static_cast<size_t>(s.n_stage) * N * sizeof(T);
  const size_t lead = static_cast<size_t>((16 - pad) & 15);
  const size_t head = nbytes < lead ? nbytes : lead;
  const size_t body_end = head + ((nbytes - head) & ~static_cast<size_t>(15));
  for (size_t i = tid; i < head; i += kBandThreads) dst[i] = src[i];
  for (size_t i = head + 16 * static_cast<size_t>(tid); i < body_end;
       i += 16 * kBandThreads)
    cp_async16(dst + i, src + i);
  for (size_t i = body_end + tid; i < nbytes; i += kBandThreads)
    dst[i] = src[i];
  return pad;
}

// Grid B * ceil(h / tile_rows), one tile a block. Writes the tile's outputs
// and, for frames with photo set, its partial sum into partials[b, t].
template <class P, typename T, int C, bool kDepth>
__global__ void __launch_bounds__(kBandThreads)
    band_resample_kernel(const T* __restrict__ frames,
                         const float* __restrict__ params,
                         float* __restrict__ out, float* __restrict__ partials,
                         int H, int W, int h, int w, BandPlan plan,
                         bool norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_sums[kBandWarps];
  const int tid = threadIdx.x;
  const int N = W * C;
  const int wC = w * C;
  const int tiles = (h + plan.tile_rows - 1) / plan.tile_rows;
  const BandLayout L = band_layout(plan, W, C, w, sizeof(T), kDepth);
  float* wy = reinterpret_cast<float*>(smem + L.wy);
  int* ylo = reinterpret_cast<int*>(smem + L.ylo);
  int* ynt = reinterpret_cast<int*>(smem + L.ynt);
  float* wx = reinterpret_cast<float*>(smem + L.wx);
  int* xlo = reinterpret_cast<int*>(smem + L.xlo);
  int* xnt = reinterpret_cast<int*>(smem + L.xnt);
  float* R = reinterpret_cast<float*>(smem + L.r);
  float* Rv = R + static_cast<size_t>(plan.tile_rows) * N;  // depth only
  unsigned char* const stage = smem + L.stage;

  const TileSrc cur = tile_source(blockIdx.x, tiles, H, h, params, plan);
  const int pad = stage_rows(frames, cur, H, N, stage, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  const float* p = params + 8 * cur.b;
  // The weights, while the copies fly: one row band a thread ...
  if (cur.fits && tid < cur.rows) {
    const Band by = band_of(cur.o0 + tid, H, p[0], p[1]);
    const float inv_y = band_inv_norm(by);
    ylo[tid] = by.lo - cur.row0;
    ynt[tid] = max(0, by.hi - by.lo + 1);
    for (int i = by.lo; i <= by.hi; ++i)
      wy[tid * plan.taps_y + (i - by.lo)] = tri(by, i) * inv_y;
  }
  // ... and the columns.
  bool x_over = false;
  for (int px = tid; px < w; px += kBandThreads) {
    const Band bx = band_of(px, W, p[2], p[3]);
    const int nt = max(0, bx.hi - bx.lo + 1);
    if (nt > plan.taps_x) {
      x_over = true;
      break;
    }
    const float inv_x = band_inv_norm(bx);
    xlo[px] = bx.lo;
    xnt[px] = nt;
    for (int j = bx.lo; j <= bx.hi; ++j)
      wx[px * plan.taps_x + (j - bx.lo)] = P::col_weight(tri(bx, j) * inv_x);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  const bool fits = !__syncthreads_or(!cur.fits || x_over);

  const size_t g0 = (static_cast<size_t>(cur.b) * h + cur.o0) * wC;
  const int rows = cur.rows;
  float local = 0.0f;
  if (fits) {
    // Vertical pass, once per source column, summed in increasing i; the
    // (row, column) items flattened so the threads share them evenly.
    const unsigned char* xs = stage + pad;
    if (sizeof(T) == 1 && (N & 3) == 0 && (pad & 3) == 0) {
      // u8: 4 columns an item, from one 32-bit word.
      const int N4 = N / 4;
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs);
      int i = tid / N4, q = tid - i * N4;
      for (int item = tid; item < rows * N4;
           item += kBandThreads, step(i, q, N4)) {
        const float* wrow = wy + i * plan.taps_y;
        const uint32_t* col = xw + static_cast<size_t>(ylo[i]) * N4 + q;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int t = 0; t < ynt[i]; ++t) {
          const uint32_t v = col[static_cast<size_t>(t) * N4];
          const float wt = wrow[t];
          a0 = fmaf(wt, u8_to_f32(v, 0), a0);
          a1 = fmaf(wt, u8_to_f32(v, 1), a1);
          a2 = fmaf(wt, u8_to_f32(v, 2), a2);
          a3 = fmaf(wt, u8_to_f32(v, 3), a3);
        }
        *reinterpret_cast<float4*>(R + i * N + 4 * q) =
            make_float4(P::row(a0), P::row(a1), P::row(a2), P::row(a3));
      }
    } else {
      const T* xe = reinterpret_cast<const T*>(xs);
      int i = tid / N, k = tid - i * N;
      for (int item = tid; item < rows * N;
           item += kBandThreads, step(i, k, N)) {
        const float* wrow = wy + i * plan.taps_y;
        const T* xcol = xe + static_cast<size_t>(ylo[i]) * N + k;
        float acc = 0.0f, acc_v = 0.0f;
#pragma unroll 4
        for (int t = 0; t < ynt[i]; ++t) {
          const float x =
              static_cast<float>(xcol[static_cast<size_t>(t) * N]);
          if constexpr (kDepth) {
            const float v = validity(x);
            acc = fmaf(wrow[t], x * v, acc);
            acc_v = fmaf(wrow[t], v, acc_v);
          } else {
            acc = fmaf(wrow[t], x, acc);
          }
        }
        R[item] = P::row(acc);
        if constexpr (kDepth) Rv[item] = P::row(acc_v);
      }
    }
    __syncthreads();  // R is complete; this tile's source rows are dead.

    // Horizontal pass from shared memory into the output tile, which sits
    // where the source rows were, at the output's offset mod 16 bytes.
    const int opad = static_cast<int>(
        (reinterpret_cast<uintptr_t>(out + g0) & 15) / sizeof(float));
    float* ot = reinterpret_cast<float*>(stage) + opad;
    int i = tid / w, px = tid - i * w;  // an item: one pixel, all channels
    for (int item = tid; item < rows * w;
         item += kBandThreads, step(i, px, w)) {
      const float* wcol = wx + px * plan.taps_x;
      const int nt = xnt[px];
      const float* rp = R + i * N + xlo[px] * C;
      const float* rvp = Rv + i * N + xlo[px];
      float z[C], zv = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) z[c] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        const float wt = wcol[t];
#pragma unroll
        for (int c = 0; c < C; ++c) z[c] = fmaf(wt, rp[t * C + c], z[c]);
        if constexpr (kDepth) zv = fmaf(wt, rvp[t], zv);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float o = epilogue<P, kDepth>(z[c], zv, c, p[4], norm);
        ot[item * C + c] = o;
        local += o;
      }
    }
    __syncthreads();
    // The tile's output rows are one contiguous range: 16-byte stores.
    float* g = out + g0;
    const int n = rows * wC;
    const int head = min(n, (4 - opad) & 3);
    const int body_end = head + ((n - head) & ~3);
    for (int j = tid; j < head; j += kBandThreads) g[j] = ot[j];
    for (int j = head + 4 * tid; j < body_end; j += 4 * kBandThreads)
      *reinterpret_cast<float4*>(g + j) =
          *reinterpret_cast<const float4*>(ot + j);
    for (int j = body_end + tid; j < n; j += kBandThreads) g[j] = ot[j];
  } else {
    // Outside the plan: each output straight from device memory, with the
    // same weights, precision and order of sums.
    const T* frame = frames + static_cast<size_t>(cur.b) * H * N;
    for (int i = 0; i < rows; ++i) {
      const Band by = band_of(cur.o0 + i, H, p[0], p[1]);
      const float inv_y = band_inv_norm(by);
      for (int e = tid; e < wC; e += kBandThreads) {
        const int px = e / C, c = e - px * C;
        const Band bx = band_of(px, W, p[2], p[3]);
        const float inv_x = band_inv_norm(bx);
        float z = 0.0f, zv = 0.0f;
        for (int j = bx.lo; j <= bx.hi; ++j) {
          float col = 0.0f, col_v = 0.0f;
          for (int iy = by.lo; iy <= by.hi; ++iy) {
            const float wgt = tri(by, iy) * inv_y;
            const float x = static_cast<float>(
                frame[(static_cast<size_t>(iy) * W + j) * C + c]);
            if constexpr (kDepth) {
              const float v = validity(x);
              col = fmaf(wgt, x * v, col);
              col_v = fmaf(wgt, v, col_v);
            } else {
              col = fmaf(wgt, x, col);
            }
          }
          const float wj = P::col_weight(tri(bx, j) * inv_x);
          z = fmaf(wj, P::row(col), z);
          if constexpr (kDepth) zv = fmaf(wj, P::row(col_v), zv);
        }
        const float o = epilogue<P, kDepth>(z, zv, c, p[4], norm);
        out[g0 + static_cast<size_t>(i) * wC + e] = o;
        local += o;
      }
    }
  }

  if constexpr (!kDepth) {
    if (p[7] > 0.5f) {  // the same for every thread of the block
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        local += __shfl_down_sync(0xffffffffu, local, off);
      if ((tid & 31) == 0) warp_sums[tid >> 5] = local;
      __syncthreads();
      if (tid == 0) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kBandWarps; ++j) s += warp_sums[j];
        partials[static_cast<size_t>(cur.b) * tiles + cur.t] = s;
      }
    }
  }
}

template <class P, typename T, int C, bool kDepth>
cudaError_t launch_band(const void* frames, const float* params, float* out,
                        float* partials, int B, int H, int W, int h, int w,
                        const BandPlan& plan, bool norm, cudaStream_t s) {
  const BandLayout l = band_layout(plan, W, C, w, sizeof(T), kDepth);
  if (plan.tile_rows < 1 || plan.tile_rows > kBandThreads ||
      plan.stage_rows < 1 || plan.taps_y < 1 ||
      plan.taps_x < 1 || static_cast<size_t>(plan.smem_bytes) < l.total)
    return cudaErrorInvalidValue;
  auto kernel = band_resample_kernel<P, T, C, kDepth>;
  // The largest dynamic shared memory allowed so far, on each device:
  // setting the attribute costs host time, so only a plan that needs more
  // sets it.
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || plan.smem_bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = plan.smem_bytes;
  }
  const long long grid =
      static_cast<long long>(B) * ((h + plan.tile_rows - 1) / plan.tile_rows);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kBandThreads, plan.smem_bytes, s>>>(
      static_cast<const T*>(frames), params, out, partials, H, W, h, w, plan,
      norm);
  return cudaGetLastError();
}

// The whole preprocess with policy P: frames u8 (frames_u8 = 1) or f32
// [B, H, W, C]; params f32 [B, 8]; out f32 [B, h, w, C]; partials f32
// [B, tiles] scratch (tiles = ceil(h / tile_rows)). Image mode launches the
// resample and the photometric pass, depth mode (C = 1, f32) the resample.
// Returns the first error (0 on success).
template <class P>
int band_preprocess(const void* frames, int frames_u8, const void* params,
                    void* out, void* partials, int B, int H, int W, int C,
                    int h, int w, const BandPlan& plan, int norm,
                    int depth_mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  const bool nrm = norm != 0;
  cudaError_t err;
  if (depth_mode) {
    if (C != 1 || frames_u8) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_band<P, float, 1, true>(
        frames, p, o, part, B, H, W, h, w, plan, false, s));
  }
  if (frames_u8 && C == 3) {
    err = launch_band<P, uint8_t, 3, false>(frames, p, o, part, B, H, W, h, w,
                                            plan, nrm, s);
  } else if (frames_u8 && C == 1) {
    err = launch_band<P, uint8_t, 1, false>(frames, p, o, part, B, H, W, h, w,
                                            plan, nrm, s);
  } else if (!frames_u8 && C == 3) {
    err = launch_band<P, float, 3, false>(frames, p, o, part, B, H, W, h, w,
                                          plan, nrm, s);
  } else if (!frames_u8 && C == 1) {
    err = launch_band<P, float, 1, false>(frames, p, o, part, B, H, W, h, w,
                                          plan, nrm, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (h + plan.tile_rows - 1) / plan.tile_rows;
  return static_cast<int>(launch_photometric(
      p, part, o, tiles, static_cast<long long>(h) * w * C, B, s));
}

}  // namespace a3d
