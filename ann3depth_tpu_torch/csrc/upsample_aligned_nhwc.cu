// Bilinear integer-factor upsample with align_corners=True on NHWC bytes for
// Hopper (sm_90a), forward and backward.
//
// Replaces no TPU kernel. The JAX package has no DPT-Large; its DPT family
// upsamples with jax.image.resize or fixed matmuls, left to XLA. The port's
// DPT-Large (models/dpt_large.py, `_up`) upsamples x2 five times a step, in
// its four fusion blocks and its head, bf16 NHWC. It ran as two batched
// GEMMs a pass with the weights held exact as a (hi, lo) bf16 pair, each
// product taken twice, a dense [2n, n] matrix that is nearly all zeros and
// a bf16 intermediate between the row and column passes: 5.9 ms a b16 step
// inside the step for a two-tap stencil.
//
// The function (ops/resize.py, upsample_aligned_nhwc; F.interpolate(...,
// mode="bilinear", align_corners=True)): x [B, h, w, C] -> y [B, h f, w f, C]
// for an integer factor f >= 1. On an axis of n inputs and N = n f outputs,
// output o samples the input at o (n - 1) / (N - 1), from integers:
//
//   num = o (n - 1), den = N - 1, left = num / den (integer division),
//   frac = (num - left den) / den in f32, right = min(left + 1, n - 1)
//
// (left = right = 0 and frac = 0 where N = 1), so the weights are exact to
// one f32 rounding and a row's sum to 1. Then, with lerp(a, b, t) = a + t (b
// - a) as one fma in f32 (a constant map stays constant in any dtype),
//
//   y[oy, ox] = lerp(lerp(x[y0, x0], x[y0, x1], fx),
//                    lerp(x[y1, x0], x[y1, x1], fx), fy)
//
// rounded once to the dtype. The backward is the transpose, as a gather:
//
//   dx[iy, ix] = sum_oy wy(oy, iy) sum_ox wx(ox, ix) dy[oy, ox]
//
// with w(o, i) = (1 - frac) where left(o) = i, plus frac where right(o) = i,
// over the outputs whose taps include the input (a contiguous range of about
// 2f on each axis), summed in f32 in a fixed order (ascending ox inside,
// ascending oy outside) and rounded once. No atomics: two runs, and a CUDA
// graph's replays, agree bit for bit. Nothing is saved for the backward but
// the shape.
//
// Bound: memory. A call reads its input once and writes its output once:
// at the step's five b16 shapes (12x12 ... 192x192 in, 256 or 128 channels)
// 1.256 GB a direction, 0.375 ms at 3.35 TB/s, 0.750 ms a step.
//
// Design, what it does about that bound:
// - A thread owns one pixel column's V channels (V = 8 bf16 or 4 f32: one
//   16-byte vector; the wrapper refuses a C or a pointer that does not
//   allow it) and walks a run of kRows rows, so that its x taps and their
//   weights are worked out once, each row step costs a few adds (`Walk`),
//   and what it has loaded is reused: the instructions per byte stay under
//   what the memory allows.
// - Forward: a block takes 256 (output column, vector) pairs of a run of
//   kRows output rows of one image. The thread lerps each input row it
//   meets along x once (two 16-byte loads, which neighbouring columns
//   share through L1), keeps the last two in registers, and writes each
//   output row with one lerp along y and one 16-byte store: the input
//   leaves device memory about once, the output is written once.
// - Backward: a block takes 256 (input column, vector) pairs of a run of
//   kRows input rows. The thread walks the output rows those rows' taps
//   cover, in order; for each it sums its x taps (the 2f or so output
//   columns whose taps include its column: 16-byte loads shared with the
//   neighbouring columns through L1) and adds that sum, weighted, to the
//   one or two input rows the output row taps, which it keeps in registers
//   and stores once complete. So a gradient byte leaves device memory about
//   once (a run's edge rows twice, the second time from L2), and no
//   intermediate goes to device memory (a separable pair of passes would
//   write one as large as dx).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "nhwc_vec.cuh"

namespace {

using a3d::Io;

constexpr int kThreads = 256;  // a block's threads
constexpr int kRows = 8;       // rows a block walks: output rows forward,
                               // input rows backward
constexpr int kMaxTaps = 8;    // x taps a backward thread keeps in registers

// The input's shape and the factor: x [B, h, w, C], y [B, H, W, C].
struct Shape {
  int B, h, w, C, H, W;
};

// One axis of n inputs and N outputs.
struct Axis {
  int n, N;

  // The first and last outputs whose taps include input i: those whose
  // left tap is i - 1 or i.
  __device__ __forceinline__ int first(int i) const {
    if (i == 0 || n == 1) return 0;
    return ((i - 1) * (N - 1) + n - 2) / (n - 1);
  }
  __device__ __forceinline__ int last(int i) const {
    if (n == 1) return N - 1;
    return min(N - 1, ((i + 1) * (N - 1) - 1) / (n - 1));
  }
};

// Output o's taps on an axis, then those of o + 1, o + 2, ... by additions:
// left and the remainder of o (n - 1) by den = N - 1 (n - 1 <= N - 1, so a
// step carries at most once).
struct Walk {
  int n, den, left, rem;

  __device__ Walk(const Axis& a, int o) : n(a.n), den(a.N - 1) {
    const int num = o * (n - 1);
    left = den ? num / den : 0;
    rem = num - left * den;
  }
  __device__ __forceinline__ void step() {
    rem += n - 1;
    if (den && rem >= den) {
      rem -= den;
      ++left;
    }
  }
  __device__ __forceinline__ int right() const {
    return min(left + 1, n - 1);
  }
  __device__ __forceinline__ float frac() const {
    return den ? __fdiv_rn(static_cast<float>(rem), static_cast<float>(den))
               : 0.f;
  }
};

// Input i's weight in an output with taps (left, right, frac).
__device__ __forceinline__ float weight(int i, int left, int right,
                                        float frac) {
  return (left == i ? 1.f - frac : 0.f) + (right == i ? frac : 0.f);
}

// a = lerp(a, b, t) = a + t (b - a), one fma a channel.
template <int V>
__device__ __forceinline__ void lerp(float (&a)[V], const float (&b)[V],
                                     float t) {
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = fmaf(t, b[i] - a[i], a[i]);
}

template <int V>
__device__ __forceinline__ void copy(float (&to)[V], const float (&from)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) to[i] = from[i];
}

// Grid: B * tiles * chunks blocks of kThreads threads: `chunks` blocks to
// the W * C / V (column, vector) pairs of a row, `tiles` runs of kRows
// output rows to an image.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    upsample_aligned_nhwc_fwd(const T* __restrict__ x, T* __restrict__ y,
                              Shape s, int chunks, int tiles) {
  int blk = blockIdx.x;
  const int chunk = blk % chunks;
  blk /= chunks;
  const int tile = blk % tiles;
  const int b = blk / tiles;
  const int lanes = s.C / V;
  const int j = chunk * kThreads + threadIdx.x;
  if (j >= s.W * lanes) return;
  const int ox = j / lanes;
  const int c = (j - ox * lanes) * V;
  const Walk wx(Axis{s.w, s.W}, ox);
  const float fx = wx.frac();
  const size_t row_in = static_cast<size_t>(s.w) * s.C;
  const T* xb = x + static_cast<size_t>(b) * s.h * row_in + c;
  const size_t x0 = static_cast<size_t>(wx.left) * s.C;
  const size_t x1 = static_cast<size_t>(wx.right()) * s.C;
  const int oy0 = tile * kRows, oy1 = min(oy0 + kRows, s.H);
  Walk wy(Axis{s.h, s.H}, oy0);
  // The x lerps of input rows r0 (top) and r1 (bottom).
  int r0 = -1, r1 = -1;
  float top[V], bottom[V];
  for (int oy = oy0; oy < oy1; ++oy, wy.step()) {
    const int y0 = wy.left, y1 = wy.right();
    float t[V], u[V];
    if (y0 == r0) {
      copy(t, top);
    } else if (y0 == r1) {
      copy(t, bottom);
    } else {
      Io<T, V>::load(xb + y0 * row_in + x0, t);
      Io<T, V>::load(xb + y0 * row_in + x1, u);
      lerp(t, u, fx);
    }
    if (y1 == y0) {
      copy(bottom, t);
    } else if (y1 != r1) {
      Io<T, V>::load(xb + y1 * row_in + x0, bottom);
      Io<T, V>::load(xb + y1 * row_in + x1, u);
      lerp(bottom, u, fx);
    }
    copy(top, t);
    r0 = y0;
    r1 = y1;
    lerp(t, bottom, wy.frac());
    Io<T, V>::store(
        y + ((static_cast<size_t>(b) * s.H + oy) * s.W + ox) * s.C + c, t);
  }
}

// Grid: B * tiles * chunks blocks of kThreads threads: `chunks` blocks to
// the w * C / V (input column, vector) pairs of a row, `tiles` runs of
// kRows input rows to an image.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    upsample_aligned_nhwc_bwd(const T* __restrict__ g, T* __restrict__ dx,
                              Shape s, int chunks, int tiles) {
  int blk = blockIdx.x;
  const int chunk = blk % chunks;
  blk /= chunks;
  const int tile = blk % tiles;
  const int b = blk / tiles;
  const int lanes = s.C / V;
  const int j = chunk * kThreads + threadIdx.x;
  if (j >= s.w * lanes) return;
  const int ix = j / lanes;
  const int c = (j - ix * lanes) * V;
  const Axis ax{s.w, s.W}, ay{s.h, s.H};
  // The output columns whose taps include ix, and their weights where they
  // fit registers (else worked out again at every row, in the same order).
  const int xlo = ax.first(ix), taps = ax.last(ix) - xlo + 1;
  float wxs[kMaxTaps];
  {
    Walk wx(ax, xlo);
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t, wx.step())
      wxs[t] = t < taps ? weight(ix, wx.left, wx.right(), wx.frac()) : 0.f;
  }
  const size_t row_out = static_cast<size_t>(s.W) * s.C;
  const size_t row_in = static_cast<size_t>(s.w) * s.C;
  const T* gb = g + static_cast<size_t>(b) * s.H * row_out +
                static_cast<size_t>(xlo) * s.C + c;
  T* db = dx + static_cast<size_t>(b) * s.h * row_in +
          static_cast<size_t>(ix) * s.C + c;
  const int iy0 = tile * kRows, iy1 = min(iy0 + kRows, s.h) - 1;
  // Input rows cur and cur + 1, summed so far.
  int cur = iy0;
  float a0[V], a1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a0[i] = a1[i] = 0.f;
  const int oy0 = ay.first(iy0), oy1 = ay.last(iy1);
  // The fast path's taps of row oy + 1 are fetched before row oy is summed,
  // so a thread has a row's loads in flight while it computes.
  using Raw = typename Io<T, V>::Raw;
  const bool fast = taps <= kMaxTaps;
  Raw next[kMaxTaps];
  auto fetch = [&](int oy) {
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t)
      if (t < taps)
        next[t] = Io<T, V>::fetch(gb + oy * row_out +
                                  static_cast<size_t>(t) * s.C);
  };
  if (fast) fetch(oy0);
  Walk wy(ay, oy0);
  for (int oy = oy0; oy <= oy1; ++oy, wy.step()) {
    const int left = wy.left, right = wy.right();
    while (left > cur) {  // every output that taps row cur is summed
      Io<T, V>::store(db + cur * row_in, a0);
      copy(a0, a1);
#pragma unroll
      for (int i = 0; i < V; ++i) a1[i] = 0.f;
      ++cur;
    }
    float sum[V], v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sum[i] = 0.f;
    if (fast) {
      Raw here[kMaxTaps];
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) here[t] = next[t];
      if (oy < oy1) fetch(oy + 1);
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t < taps) {
          Io<T, V>::unpack(here[t], v);
#pragma unroll
          for (int i = 0; i < V; ++i) sum[i] = fmaf(wxs[t], v[i], sum[i]);
        }
      }
    } else {
      Walk wx(ax, xlo);
      for (int t = 0; t < taps; ++t, wx.step()) {
        const float w = weight(ix, wx.left, wx.right(), wx.frac());
        Io<T, V>::load(gb + oy * row_out + static_cast<size_t>(t) * s.C, v);
#pragma unroll
        for (int i = 0; i < V; ++i) sum[i] = fmaf(w, v[i], sum[i]);
      }
    }
    const float frac = wy.frac();
    if (left == cur || right == cur) {
      const float w = weight(cur, left, right, frac);
#pragma unroll
      for (int i = 0; i < V; ++i) a0[i] = fmaf(w, sum[i], a0[i]);
    }
    if (cur < iy1 && right == cur + 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) a1[i] = fmaf(frac, sum[i], a1[i]);
    }
  }
  Io<T, V>::store(db + cur * row_in, a0);
  if (cur < iy1) Io<T, V>::store(db + (cur + 1) * row_in, a1);
}

// The blocks of kRows-row runs over an axis of n rows, each row `width`
// columns of C / V vectors.
template <int V>
unsigned grid(const Shape& s, int n, int width, int& chunks, int& tiles) {
  chunks = (width * (s.C / V) + kThreads - 1) / kThreads;
  tiles = (n + kRows - 1) / kRows;
  return static_cast<unsigned>(s.B) * tiles * chunks;
}

template <typename T, int V>
int forward(const void* x, void* y, const Shape& s, cudaStream_t stream) {
  int chunks, tiles;
  const unsigned blocks = grid<V>(s, s.H, s.W, chunks, tiles);
  upsample_aligned_nhwc_fwd<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s, chunks, tiles);
  return cudaGetLastError();
}

template <typename T, int V>
int backward(const void* g, void* dx, const Shape& s, cudaStream_t stream) {
  int chunks, tiles;
  const unsigned blocks = grid<V>(s, s.h, s.w, chunks, tiles);
  upsample_aligned_nhwc_bwd<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), s, chunks, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* upsample_aligned_nhwc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: bf16 (bf16 = 1) or f32 [B, h, w, C], contiguous, C a multiple of 16
// bytes' elements and both pointers 16-byte aligned (the wrapper checks);
// y: x's type [B, h f, w f, C]. Launches on `stream` and returns the first
// cudaError_t that is not 0 (0 on success).
int upsample_aligned_nhwc_forward(const void* x, void* y, int bf16, int B,
                                  int h, int w, int C, int factor,
                                  void* stream) {
  const Shape s{B, h, w, C, h * factor, w * factor};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? forward<__nv_bfloat16, 8>(x, y, s, st)
              : forward<float, 4>(x, y, s, st);
}

// g: the output's gradient, x's type [B, h f, w f, C]; dx: [B, h, w, C].
// The rest as the forward.
int upsample_aligned_nhwc_backward(const void* g, void* dx, int bf16, int B,
                                   int h, int w, int C, int factor,
                                   void* stream) {
  const Shape s{B, h, w, C, h * factor, w * factor};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? backward<__nv_bfloat16, 8>(g, dx, s, st)
              : backward<float, 4>(g, dx, s, st);
}

}  // extern "C"
