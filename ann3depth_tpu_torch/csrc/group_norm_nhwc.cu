// GroupNorm + ReLU on NHWC bytes for Hopper (sm_90a), forward and backward.
//
// Replaces no TPU kernel. The JAX package's GroupNorm is flax's
// nn.GroupNorm, left to XLA (ann3depth_tpu/models/encdec.py, Stage), which
// keeps the activations' layout. It was added because PyTorch's CUDA
// group_norm copies a channels_last input to plain NCHW and returns NCHW:
// every conv after it then got NCHW activations, and cuDNN's bf16 engines
// transposed them to NHWC and back, and the skip adds mixed layouts. This
// kernel reads and writes the NHWC bytes of an NCHW channels_last tensor,
// so the encoder-decoder stays channels_last from its input to its head.
//
// The function (ann3depth_tpu_torch/ops/group_norm.py, plain_group_norm_relu,
// the Stage expression it replaces): for x [B, C, H, W] (bf16 or f32,
// channels_last), G groups of C/G channels, eps,
//
//   mean, var over each (image, group), f32, biased
//   y = relu(round_T((x - mean) * rsqrt(var + eps) * gamma + beta))
//
// with one rounding to the input's type. The backward takes dy, x, y (the
// ReLU mask: dz = dy where y > 0), the saved mean and rstd, and writes
//
//   dx = round_T(rstd * (dz gamma - mean(dz gamma) - xhat mean(dz gamma xhat)))
//   dgamma = sum dz xhat, dbeta = sum dz (f32, over images and pixels)
//
// with the means over the (image, group).
//
// Bound: memory. A bf16 element costs a few flops and at least 4 bytes
// forward (x read, y written) and 8 backward (dy, x, y read, dx written):
// at the train step's shapes (b16: 64ch at 60x80, 128ch at 30x40, 256ch at
// 15x20) 19.7, 9.8 and 4.9 MB forward, 5.9, 2.9 and 1.5 us at 3.35 TB/s.
// So what pays is moving each byte few times, in 16-byte accesses, with
// enough blocks in flight; the tensors fit in the 50 MB L2, so the second
// read of each pass mostly hits it.
//
// Design, what it does about that bound:
// - NHWC puts a pixel's C channels in one run of 128-512 bytes. A block
//   takes a tile of pixels of one image across all C channels: C / V
//   threads ("lanes") cover a pixel with 16-byte loads (V = 8 bf16 or 4
//   f32 values; V = 1 where C or a pointer does not allow it), and the
//   block's `prows` rows of lanes walk the tile's pixels, a few loads in
//   flight a thread. Every thread keeps its V channels' sums in registers.
// - Two passes, each one launch; no atomics: every sum is taken in a fixed
//   order, so two runs (and a CUDA graph's replays) agree bit for bit.
//   Forward pass 1 writes, for each (image, tile, group), the mean and
//   sum of squared deviations (M2): Welford within a thread, then the
//   group's (row, channel) entries at once, as Chan et al. combine many
//   partial results: the mean from the counts and means, then the M2s
//   plus each count times its mean's squared distance from the group's.
//   Forward pass 2 combines its image's tiles so in its prologue, then
//   normalises, applies the affine in f32, rounds once, applies the ReLU
//   and stores with 16-byte writes; the first tile's block writes the
//   image's mean and rstd for the backward. Each per-group sum is one
//   segment of lanes' (`Segments`): the lanes load in parallel and meet in
//   a fixed shuffle tree, so no serial chain of loads or divisions sits
//   between a block's loads and its stores, and a prologue's loads go out
//   before it.
// - Backward pass 1 writes per (image, tile, channel) the sums of dz and
//   dz xhat, and per (image, tile, group) the sums of dz gamma and
//   dz gamma xhat. Pass 2 combines its image's group sums in its prologue
//   and writes dx; a few more blocks of the same launch (scheduled first)
//   sum the channel partials over images and tiles into dgamma and dbeta.
// - The launch plan (ops/group_norm.py, launch_plan) follows the shape: the
//   pixels a block takes shrink until the grid holds twice as many blocks
//   as the card has SMs, so that the small maps (300 pixels at b16) still
//   fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "nhwc_vec.cuh"

namespace {

constexpr int kMaxThreads = 512;  // a block's threads, at most (128 registers)
constexpr int kFwdUnroll = 4;    // loads in flight a thread, forward
constexpr int kBwdUnroll = 2;    // pixels in flight a thread (3 loads each)

// The shape and the launch plan of one call.
struct Shape {
  int B, HW, C, G;
  int tile_px;  // pixels of a block's tile
  int tiles;    // tiles of an image
};

using a3d::Io;

constexpr unsigned kFullWarp = 0xffffffffu;

// The per-group sums go to segments of `width` lanes (a power of two up to
// 32) of the block's whole warps, as many segments as there are groups
// where the threads allow; a block's last warp may be partial (blockDim =
// lanes * prows) and takes none. A segment's lanes load in parallel and
// meet in a fixed shuffle tree (`seg_sum`), so no serial chain of loads or
// divisions sits between a block's loads and its stores.
struct Segments {
  int width, count, index, lane;
  bool in;
  __device__ explicit Segments(int groups) {
    const int whole = blockDim.x / 32 * 32;
    width = 32;
    while (width > 1 && whole / width < groups) width /= 2;
    count = whole / width;
    in = static_cast<int>(threadIdx.x) < whole;
    index = threadIdx.x / width;
    lane = threadIdx.x % width;
  }
};

// The sum of v over each segment of `width` lanes in a fixed tree: the
// segment's first lane's sum, for every lane of it. Every lane of the warp
// calls it.
__device__ __forceinline__ float seg_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_down_sync(kFullWarp, v, o, width);
  return __shfl_sync(kFullWarp, v, 0, width);
}

// The ReLU as torch computes it: 0 below 0, NaN kept.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// Where a thread sits: its image and tile, its V channels and its row.
template <int V>
struct Place {
  int b, t, p0, p1, c0, prow, prows;
  __device__ Place(const Shape& s, int block) {
    const int lanes = s.C / V;
    prows = blockDim.x / lanes;
    prow = threadIdx.x / lanes;
    c0 = (threadIdx.x - prow * lanes) * V;
    b = block / s.tiles;
    t = block - b * s.tiles;
    p0 = t * s.tile_px;
    p1 = min(p0 + s.tile_px, s.HW);
  }
  __device__ size_t offset(const Shape& s, int p) const {
    return (static_cast<size_t>(b) * s.HW + p) * s.C + c0;
  }
};

// Rows p, p + prows, ... (U of them, those inside the tile) of a thread's
// V channels.
template <typename T, int V, int U>
__device__ __forceinline__ void load_rows(const T* x, const Place<V>& at,
                                          const Shape& s, int p,
                                          float (&v)[U][V]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (p + u * at.prows < at.p1)
      Io<T, V>::load(x + at.offset(s, p + u * at.prows), v[u]);
}

// Forward pass 1: the (mean, M2) of each (image, tile, group) -> part
// [B * tiles, G]: Welford within a thread, then the group's rows and
// channels at once. Shared memory: 2 * prows * C + prows floats.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part,
                    Shape s) {
  extern __shared__ float smem[];
  const Place<V> at(s, blockIdx.x);
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  for (int p = at.p0 + at.prow; p < at.p1; p += kFwdUnroll * at.prows) {
    float v[kFwdUnroll][V];
    load_rows(x, at, s, p, v);
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (p + u * at.prows >= at.p1) break;
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[u][i] - mean[i];
        mean[i] += d * inv;
        m2[i] += d * (v[u][i] - mean[i]);
      }
    }
  }
  const int C = s.C;
  float* sm = smem;             // [prows][C] means
  float* sq = sm + at.prows * C;  // [prows][C] M2
  float* sn = sq + at.prows * C;  // [prows] counts
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sm[at.prow * C + at.c0 + i] = mean[i];
    sq[at.prow * C + at.c0 + i] = m2[i];
  }
  if (at.c0 == 0) sn[at.prow] = n;
  __syncthreads();
  // A group's (row, channel) entries, combined as Chan et al. combine many
  // at once: the mean from the counts and means, then the M2s plus each
  // count times its mean's squared distance from the group's.
  const int cpg = C / s.G, entries = at.prows * cpg;
  const float count = static_cast<float>((at.p1 - at.p0) * cpg);
  const Segments sg(s.G);
  if (!sg.in) return;
  for (int g0 = 0; g0 < s.G; g0 += sg.count) {
    const int g = g0 + sg.index;
    const bool active = g < s.G;
    float a = 0.f;
    if (active)
      for (int e = sg.lane; e < entries; e += sg.width) {
        const int r = e / cpg;
        a += sn[r] * sm[r * C + g * cpg + e - r * cpg];
      }
    const float gm = seg_sum(a, sg.width) / count;
    float q = 0.f;
    if (active)
      for (int e = sg.lane; e < entries; e += sg.width) {
        const int r = e / cpg, i = r * C + g * cpg + e - r * cpg;
        const float d = sm[i] - gm;
        q += sq[i] + sn[r] * d * d;
      }
    q = seg_sum(q, sg.width);
    if (active && sg.lane == 0)
      part[static_cast<size_t>(blockIdx.x) * s.G + g] = make_float2(gm, q);
  }
}

// Forward pass 2: y = relu(round(x * scale + shift)), the image's
// statistics combined from part; mean and rstd [B, G]
// from the image's first tile. Shared memory: 2 * G floats.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ part,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, Shape s, float eps) {
  extern __shared__ float smem[];
  const Place<V> at(s, blockIdx.x);
  const int cpg = s.C / s.G;
  // The first rows and the affine are loaded before the statistics are
  // combined: the barrier below would hold their loads back.
  const int first = at.p0 + at.prow;
  float v[kFwdUnroll][V], ga[V], be[V];
  load_rows(x, at, s, first, v);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ga[i] = gamma[at.c0 + i];
    be[i] = beta[at.c0 + i];
  }
  // The image's tiles, combined as pass 1 combines a tile's entries.
  const float count = static_cast<float>(s.HW) * static_cast<float>(cpg);
  const float2* pb = part + static_cast<size_t>(at.b) * s.tiles * s.G;
  const Segments sg(s.G);
  if (sg.in) {
    for (int g0 = 0; g0 < s.G; g0 += sg.count) {
      const int g = g0 + sg.index;
      const bool active = g < s.G;
      float a = 0.f;
      if (active)
        for (int u = sg.lane; u < s.tiles; u += sg.width)
          a += static_cast<float>(min(s.tile_px, s.HW - u * s.tile_px) *
                                  cpg) * pb[u * s.G + g].x;
      const float m = seg_sum(a, sg.width) / count;
      float q = 0.f;
      if (active)
        for (int u = sg.lane; u < s.tiles; u += sg.width) {
          const float2 pu = pb[u * s.G + g];
          const float d = pu.x - m;
          q += pu.y + static_cast<float>(min(s.tile_px, s.HW - u * s.tile_px)
                                         * cpg) * d * d;
        }
      q = seg_sum(q, sg.width);
      if (active && sg.lane == 0) {
        const float rstd = 1.f / sqrtf(q / count + eps);
        smem[g] = m;
        smem[s.G + g] = rstd;
        if (at.t == 0) {
          mean_out[at.b * s.G + g] = m;
          rstd_out[at.b * s.G + g] = rstd;
        }
      }
    }
  }
  __syncthreads();
  float scale[V], shift[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = (at.c0 + i) / cpg;
    scale[i] = smem[s.G + g] * ga[i];
    shift[i] = be[i] - smem[g] * scale[i];
  }
  for (int p = first; p < at.p1; p += kFwdUnroll * at.prows) {
    if (p != first) load_rows(x, at, s, p, v);
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (p + u * at.prows >= at.p1) break;
#pragma unroll
      for (int i = 0; i < V; ++i)
        v[u][i] = relu(v[u][i] * scale[i] + shift[i]);
      Io<T, V>::store(y + at.offset(s, p + u * at.prows), v[u]);
    }
  }
}

// The upstream gradient through the ReLU and x normalised, for V channels
// of one pixel: dz = dy where y > 0 (0 where y <= 0, NaN passed, as
// torch's threshold_backward), xhat = (x - mean) * rstd.
template <typename T, int V>
__device__ __forceinline__ void load_dz_xhat(const T* dy, const T* x,
                                             const T* y, size_t off,
                                             const float* mu,
                                             const float* rs, float* dz,
                                             float* xh) {
  float vy[V];
  Io<T, V>::load(dy + off, dz);
  Io<T, V>::load(x + off, xh);
  Io<T, V>::load(y + off, vy);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (vy[i] <= 0.f) dz[i] = 0.f;
    xh[i] = (xh[i] - mu[i]) * rs[i];
  }
}

// Backward pass 1: per (image, tile, channel) the sums of dz and dz xhat
// -> cpart [B * tiles, C]; per (image, tile, group) the sums of dz gamma
// and dz gamma xhat -> gpart [B * tiles, G]. Shared memory: 2 * prows * C
// floats.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_stats_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                        const T* __restrict__ y,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ gamma,
                        float2* __restrict__ cpart,
                        float2* __restrict__ gpart, Shape s) {
  extern __shared__ float smem[];
  const Place<V> at(s, blockIdx.x);
  const int C = s.C, cpg = C / s.G;
  float mu[V], rs[V], sa[V], sb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = (at.c0 + i) / cpg;
    mu[i] = mean[at.b * s.G + g];
    rs[i] = rstd[at.b * s.G + g];
    sa[i] = sb[i] = 0.f;
  }
  for (int p = at.p0 + at.prow; p < at.p1; p += kBwdUnroll * at.prows) {
    float dz[kBwdUnroll][V], xh[kBwdUnroll][V];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (p + u * at.prows < at.p1)
        load_dz_xhat<T, V>(dy, x, y, at.offset(s, p + u * at.prows), mu, rs,
                           dz[u], xh[u]);
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (p + u * at.prows >= at.p1) break;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sa[i] += dz[u][i];
        sb[i] += dz[u][i] * xh[u][i];
      }
    }
  }
  float* ra = smem;               // [prows][C] sums of dz
  float* rb = ra + at.prows * C;  // [prows][C] sums of dz xhat
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ra[at.prow * C + at.c0 + i] = sa[i];
    rb[at.prow * C + at.c0 + i] = sb[i];
  }
  __syncthreads();
  // A thread a channel sums its rows in order into row 0.
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < at.prows; ++r) {
      a += ra[r * C + c];
      b += rb[r * C + c];
    }
    ra[c] = a;
    rb[c] = b;
    cpart[static_cast<size_t>(blockIdx.x) * C + c] = make_float2(a, b);
  }
  __syncthreads();
  const Segments sg(s.G);
  if (!sg.in) return;
  for (int g0 = 0; g0 < s.G; g0 += sg.count) {
    const int g = g0 + sg.index;
    const bool active = g < s.G;
    float s1 = 0.f, s2 = 0.f;
    if (active)
      for (int c = g * cpg + sg.lane; c < (g + 1) * cpg; c += sg.width) {
        s1 += gamma[c] * ra[c];
        s2 += gamma[c] * rb[c];
      }
    s1 = seg_sum(s1, sg.width);
    s2 = seg_sum(s2, sg.width);
    if (active && sg.lane == 0)
      gpart[static_cast<size_t>(blockIdx.x) * s.G + g] = make_float2(s1, s2);
  }
}

// Backward pass 2. The first red_blocks blocks sum cpart over images and
// tiles into dbeta and dgamma, red_ch channels a block: thread (sub, cl)
// sums rows sub, sub + subs, ... of cpart, then thread (0, cl) sums the
// subs in order. The others write dx. Shared memory:
// max(2 * G, 2 * blockDim) floats.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gn_bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                        const T* __restrict__ y,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ gamma,
                        const float2* __restrict__ cpart,
                        const float2* __restrict__ gpart,
                        T* __restrict__ dx, float* __restrict__ dgamma,
                        float* __restrict__ dbeta, Shape s, int red_ch,
                        int red_blocks) {
  extern __shared__ float smem[];
  const int C = s.C, cpg = C / s.G;
  if (static_cast<int>(blockIdx.x) < red_blocks) {
    const int subs = blockDim.x / red_ch;
    const int sub = threadIdx.x / red_ch;
    const int cl = threadIdx.x - sub * red_ch;
    const int c = blockIdx.x * red_ch + cl;
    float sa = 0.f, sb = 0.f;
    if (sub < subs && c < C) {
      // Rows k = sub, sub + subs, ... of cpart [B * tiles, C], four loads
      // in flight.
      const int rows = s.B * s.tiles;
      int k = sub;
      for (; k + 3 * subs < rows; k += 4 * subs) {
        float2 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = cpart[static_cast<size_t>(k + j * subs) * C + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sa += v[j].x;
          sb += v[j].y;
        }
      }
      for (; k < rows; k += subs) {
        const float2 v = cpart[static_cast<size_t>(k) * C + c];
        sa += v.x;
        sb += v.y;
      }
    }
    smem[threadIdx.x] = sa;
    smem[blockDim.x + threadIdx.x] = sb;
    __syncthreads();
    if (sub == 0 && c < C) {
      float ta = 0.f, tb = 0.f;
      for (int k = 0; k < subs; ++k) {
        ta += smem[k * red_ch + cl];
        tb += smem[blockDim.x + k * red_ch + cl];
      }
      dbeta[c] = ta;
      dgamma[c] = tb;
    }
    return;
  }
  const Place<V> at(s, blockIdx.x - red_blocks);
  // The first rows and the statistics are loaded before the group sums are
  // combined: the barrier below would hold their loads back.
  float mu[V], rs[V], ga[V], k1[V], k2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = at.c0 + i, g = c / cpg;
    mu[i] = mean[at.b * s.G + g];
    rs[i] = rstd[at.b * s.G + g];
    ga[i] = gamma[c];
  }
  const int first = at.p0 + at.prow;
  float dz[kBwdUnroll][V], xh[kBwdUnroll][V];
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u)
    if (first + u * at.prows < at.p1)
      load_dz_xhat<T, V>(dy, x, y, at.offset(s, first + u * at.prows), mu,
                         rs, dz[u], xh[u]);
  const float n = static_cast<float>(s.HW) * static_cast<float>(cpg);
  const float2* pb = gpart + static_cast<size_t>(at.b) * s.tiles * s.G;
  const Segments sg(s.G);
  if (sg.in) {
    for (int g0 = 0; g0 < s.G; g0 += sg.count) {
      const int g = g0 + sg.index;
      const bool active = g < s.G;
      float s1 = 0.f, s2 = 0.f;
      if (active)
        for (int u = sg.lane; u < s.tiles; u += sg.width) {
          const float2 v = pb[u * s.G + g];
          s1 += v.x;
          s2 += v.y;
        }
      s1 = seg_sum(s1, sg.width);
      s2 = seg_sum(s2, sg.width);
      if (active && sg.lane == 0) {
        smem[g] = s1 / n;
        smem[s.G + g] = s2 / n;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = (at.c0 + i) / cpg;
    k1[i] = smem[g];
    k2[i] = smem[s.G + g];
  }
  for (int p = first; p < at.p1; p += kBwdUnroll * at.prows) {
    if (p != first) {
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        if (p + u * at.prows < at.p1)
          load_dz_xhat<T, V>(dy, x, y, at.offset(s, p + u * at.prows), mu,
                             rs, dz[u], xh[u]);
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (p + u * at.prows >= at.p1) break;
#pragma unroll
      for (int i = 0; i < V; ++i)
        dz[u][i] = rs[i] * (dz[u][i] * ga[i] - k1[i] - xh[u][i] * k2[i]);
      Io<T, V>::store(dx + at.offset(s, p + u * at.prows), dz[u]);
    }
  }
}

template <typename T, int V>
int forward(const void* x, const void* gamma, const void* beta, void* y,
            void* mean, void* rstd, void* part, const Shape& s, int threads,
            float eps, cudaStream_t stream) {
  const int prows = threads / (s.C / V);
  const unsigned blocks = static_cast<unsigned>(s.B) * s.tiles;
  gn_stats_kernel<T, V>
      <<<blocks, threads, (2 * prows * s.C + prows) * sizeof(float), stream>>>(
          static_cast<const T*>(x), static_cast<float2*>(part), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, V><<<blocks, threads, 2 * s.G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), s, eps);
  return cudaGetLastError();
}

template <typename T, int V>
int backward(const void* dy, const void* x, const void* y, const void* mean,
             const void* rstd, const void* gamma, void* dx, void* dgamma,
             void* dbeta, void* cpart, void* gpart, const Shape& s,
             int threads, int red_ch, int red_blocks, cudaStream_t stream) {
  const int prows = threads / (s.C / V);
  const unsigned blocks = static_cast<unsigned>(s.B) * s.tiles;
  gn_bwd_stats_kernel<T, V>
      <<<blocks, threads, 2 * prows * s.C * sizeof(float), stream>>>(
          static_cast<const T*>(dy), static_cast<const T*>(x),
          static_cast<const T*>(y), static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<const float*>(gamma),
          static_cast<float2*>(cpart), static_cast<float2*>(gpart), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * sizeof(float) * (s.G > threads ? s.G : threads);
  gn_bwd_apply_kernel<T, V><<<blocks + red_blocks, threads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float2*>(cpart), static_cast<const float2*>(gpart),
      static_cast<T*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), s, red_ch, red_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* group_norm_nhwc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: bf16 (bf16 = 1) or f32 [B, HW, C] (the bytes of channels_last
// [B, C, H, W]); gamma, beta: f32 [C]; y: x's type [B, HW, C]; mean, rstd:
// f32 [B, G]; part: f32 [B * tiles, G, 2] scratch. vec: 16-byte accesses
// (C a multiple of 16 bytes' elements, every pointer 16-byte aligned);
// threads, tile_px, tiles from ops/group_norm.launch_plan. Launches on
// `stream` and returns the first cudaError_t that is not 0 (0 on success).
int group_norm_nhwc_forward(const void* x, const void* gamma,
                            const void* beta, void* y, void* mean, void* rstd,
                            void* part, int bf16, int vec, int B, int HW,
                            int C, int G, int threads, int tile_px, int tiles,
                            float eps, void* stream) {
  const Shape s{B, HW, C, G, tile_px, tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? forward<__nv_bfloat16, 8>(x, gamma, beta, y, mean, rstd,
                                           part, s, threads, eps, st)
               : forward<__nv_bfloat16, 1>(x, gamma, beta, y, mean, rstd,
                                           part, s, threads, eps, st);
  return vec ? forward<float, 4>(x, gamma, beta, y, mean, rstd, part, s,
                                 threads, eps, st)
             : forward<float, 1>(x, gamma, beta, y, mean, rstd, part, s,
                                 threads, eps, st);
}

// dy, x, y, dx: x's type [B, HW, C]; mean, rstd: f32 [B, G] from the
// forward; gamma, dgamma, dbeta: f32 [C]; cpart: f32 [B * tiles, C, 2] and
// gpart: f32 [B * tiles, G, 2] scratch; red_ch, red_blocks: the dgamma and
// dbeta blocks of the plan. The rest as group_norm_nhwc_forward.
int group_norm_nhwc_backward(const void* dy, const void* x, const void* y,
                             const void* mean, const void* rstd,
                             const void* gamma, void* dx, void* dgamma,
                             void* dbeta, void* cpart, void* gpart, int bf16,
                             int vec, int B, int HW, int C, int G,
                             int threads, int tile_px, int tiles, int red_ch,
                             int red_blocks, void* stream) {
  const Shape s{B, HW, C, G, tile_px, tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? backward<__nv_bfloat16, 8>(dy, x, y, mean, rstd, gamma, dx,
                                            dgamma, dbeta, cpart, gpart, s,
                                            threads, red_ch, red_blocks, st)
               : backward<__nv_bfloat16, 1>(dy, x, y, mean, rstd, gamma, dx,
                                            dgamma, dbeta, cpart, gpart, s,
                                            threads, red_ch, red_blocks, st);
  return vec ? backward<float, 4>(dy, x, y, mean, rstd, gamma, dx, dgamma,
                                  dbeta, cpart, gpart, s, threads, red_ch,
                                  red_blocks, st)
             : backward<float, 1>(dy, x, y, mean, rstd, gamma, dx, dgamma,
                                  dbeta, cpart, gpart, s, threads, red_ch,
                                  red_blocks, st);
}

}  // extern "C"
