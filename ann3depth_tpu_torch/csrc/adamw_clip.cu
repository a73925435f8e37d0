// The update of a train step on Hopper (sm_90a): optax's global-norm clip
// folded into one pass of AdamW (or Adam) over every f32 leaf, in two
// kernels.
//
// Replaces no TPU kernel. The JAX package leaves optax's
// clip_by_global_norm and adamw to XLA, which fuses them. The port ran them
// as torch ops: a per-leaf pow, sum and add for the norm (about 1,080
// launches at DPT-Large's 360 leaves), a foreach multiply for the clip, and
// torch's capturable foreach AdamW, which makes about nine passes over the
// 341.8M parameters and a bias correction per leaf: 16.6 ms of a 93.6 ms b16
// step replayed from a CUDA graph.
//
// The function (ops/adamw_clip.py; train/step.py UpdateRule.apply):
//
//   norm   = sqrt(sum over every leaf and element of g^2)
//   factor = clip > 0 and not (norm < clip) ? (1 / norm) * clip : 1
//
// then, for each leaf with its own step count t (incremented first) and the
// group's learning rate lr (a device scalar), op for op as torch's
// capturable foreach Adam (torch/optim/adam.py, _multi_tensor_adam), each
// step rounded to f32 as its own kernel rounds it:
//
//   g  = g * factor
//   p  = p * (1 - lr wd)                       (decoupled decay, wd != 0)
//   m  = lerp(m, g, 1 - b1)
//   v  = v * b2;  v = v + (1 - b2) g g
//   s  = 1 / ((b1^t - 1) / lr);  c = sqrt(-(b2^t - 1))
//   p  = p + m / ((sqrt(v) / c + eps) / s)
//
// The gradient is read and scaled in registers: `.grad` keeps the unscaled
// gradient. No caller reads it after the update: train/step.py's
// `_finish_update`, parallel/zero1.py, shard_step.py and sharding_rules.py
// read `.grad` before it.
//
// Bound: memory. p, m and v are read and written once and the gradient read
// twice (once for the norm, once for the update): 32 bytes a parameter,
// 10.94 GB and 3.27 ms at 3.35 TB/s for DPT-Large's 341,848,257.
//
// Design, what it does about that bound:
// - Two launches a step, whatever the number of leaves (up to kMaxLeaves a
//   launch; more launch again): a fixed grid of blocks (a few an SM) walks
//   a table of chunks (`first`: each leaf's first chunk of
//   ops/adamw_clip.CHUNK elements, built on the host) that travels in the
//   kernel's arguments (__grid_constant__, so it is read in place from the
//   argument space). A captured CUDA graph
//   bakes the table with the arguments, which holds because a replayed
//   step's gradients keep their addresses.
// - 16-byte vector loads and stores where a leaf's pointers allow them,
//   one element at a time where they do not (a view at an odd offset, a
//   ragged tail of fewer than 4 elements); 0-element leaves have no chunk.
// - The norm: each thread sums squares in f64 (exact products, f64 sums),
//   each block reduces its threads in a fixed order into a partial, and
//   the last block to finish (a counter in device memory, set back to 0 by
//   that block) sums the partials in index order and writes the norm. No
//   float atomics: two runs agree bit for bit, as do a graph's replays.
// - The update: each block works out a chunk's bias corrections from its
//   leaf's step, scales, updates and stores p, m and v; the last block to
//   finish increments every leaf's step, after every block has read it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // a block's threads
constexpr int kMaxLeaves = 512;  // leaves a launch: the tables below fit
                                 // the 32 KB of a kernel's arguments

// The chunks of a launch's leaves: leaf i holds chunks [first[i],
// first[i + 1]) of `chunk` elements, its last one ragged.
struct Chunks {
  int first[kMaxLeaves + 1];
  int count;  // leaves
  int chunk;  // elements a chunk

  // The leaf of chunk c: the last with first[i] <= c, so that a leaf of 0
  // elements (no chunk) is never taken.
  __device__ __forceinline__ int leaf_of(int c) const {
    int lo = 0, hi = count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= c) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    return lo;
  }
  __device__ __forceinline__ int total() const { return first[count]; }
};

struct SumsqArgs {
  const float* g[kMaxLeaves];
  int64_t n[kMaxLeaves];
  Chunks chunks;
};

struct UpdateArgs {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* step[kMaxLeaves];
  int64_t n[kMaxLeaves];
  Chunks chunks;
};

// The group's constants, rounded to f32 as torch rounds its Python
// scalars: w1 = 1 - b1 and s2 = 1 - b2 taken in double first.
struct Hyper {
  float clip, beta1, beta2, w1, s2, eps, wd;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__device__ __forceinline__ double square(float x) {
  return static_cast<double>(x) * static_cast<double>(x);
}

// The sum of x over the block in a fixed order (warps by shuffles, then
// warp 0 over the warps' sums); the result is thread 0's.
__device__ double block_sum(double x, double* shared) {
  __syncthreads();  // `shared` may be in use by an earlier call
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  x = threadIdx.x < kThreads / 32 ? shared[threadIdx.x] : 0.0;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

// One block's share of the sum of squares into partials[blockIdx.x] (added
// to what is there when `accumulate`: the launches of one call run in
// turn); with `finish`, the last block to arrive writes sqrt of the sum of
// the partials to norm and sets the counter back to 0.
__global__ void __launch_bounds__(kThreads)
    adamw_clip_sumsq_kernel(const __grid_constant__ SumsqArgs a,
                            double* partials, unsigned* counter, float* norm,
                            int accumulate, int finish) {
  __shared__ double shared[kThreads / 32];
  __shared__ bool last;
  double acc = 0.0;
  const int total = a.chunks.total();
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int leaf = a.chunks.leaf_of(c);
    const int64_t begin =
        static_cast<int64_t>(c - a.chunks.first[leaf]) * a.chunks.chunk;
    const int len = static_cast<int>(
        min(static_cast<int64_t>(a.chunks.chunk), a.n[leaf] - begin));
    const float* g = a.g[leaf] + begin;
    int i = threadIdx.x;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (; i < len >> 2; i += kThreads) {
        const float4 x = g4[i];
        acc += square(x.x);
        acc += square(x.y);
        acc += square(x.z);
        acc += square(x.w);
      }
      i = ((len >> 2) << 2) + threadIdx.x;
    }
    for (; i < len; i += kThreads) acc += square(g[i]);
  }
  const double sum = block_sum(acc, shared);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] =
        accumulate ? __ldcg(partials + blockIdx.x) + sum : sum;
    if (finish) {
      __threadfence();
      last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
  }
  if (!finish) return;
  __syncthreads();
  if (!last) return;
  double all = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    all += __ldcg(partials + b);
  }
  all = block_sum(all, shared);
  if (threadIdx.x == 0) {
    *norm = static_cast<float>(sqrt(all));
    *counter = 0;
  }
}

// torch's lerp (ATen/native/Lerp.h) for a weight w in f32.
__device__ __forceinline__ float lerp(float self, float end, float w) {
  return fabsf(w) < 0.5f ? self + w * (end - self)
                         : end - (end - self) * (1.f - w);
}

// One element: the arithmetic of the note at the top, each foreach op of
// torch's rounded as it rounds it (__f*_rn: never fused with a neighbour).
struct Element {
  float factor, keep, step_size, bc2_sqrt;
  bool decay;
  Hyper h;

  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v) const {
    g = __fmul_rn(g, factor);
    if (decay) p = __fmul_rn(p, keep);
    m = lerp(m, g, h.w1);
    v = __fmul_rn(v, h.beta2);
    v = v + h.s2 * __fmul_rn(g, g);
    float d = __fdiv_rn(__fsqrt_rn(v), bc2_sqrt);
    d = __fdiv_rn(__fadd_rn(d, h.eps), step_size);
    p = __fadd_rn(p, __fdiv_rn(m, d));
  }
};

// One block's chunks of the update; the last block to arrive increments
// every leaf's step and sets the counter back to 0.
__global__ void __launch_bounds__(kThreads)
    adamw_clip_update_kernel(const __grid_constant__ UpdateArgs a,
                             const float* lr, const float* norm,
                             unsigned* counter, Hyper h) {
  __shared__ bool last;
  const float rate = *lr;
  const float n = *norm;
  Element e;
  e.h = h;
  e.factor = h.clip > 0.f && !(n < h.clip)
                 ? __fmul_rn(__fdiv_rn(1.f, n), h.clip)
                 : 1.f;
  e.decay = h.wd != 0.f;
  e.keep = __fsub_rn(1.f, __fmul_rn(rate, h.wd));
  const int total = a.chunks.total();
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int leaf = a.chunks.leaf_of(c);
    const float t = __fadd_rn(*a.step[leaf], 1.f);
    const float bc1 = __fdiv_rn(__fsub_rn(powf(h.beta1, t), 1.f), rate);
    e.step_size = __fdiv_rn(1.f, bc1);
    e.bc2_sqrt = __fsqrt_rn(-__fsub_rn(powf(h.beta2, t), 1.f));
    const int64_t begin =
        static_cast<int64_t>(c - a.chunks.first[leaf]) * a.chunks.chunk;
    const int len = static_cast<int>(
        min(static_cast<int64_t>(a.chunks.chunk), a.n[leaf] - begin));
    float* p = a.p[leaf] + begin;
    const float* g = a.g[leaf] + begin;
    float* m = a.m[leaf] + begin;
    float* v = a.v[leaf] + begin;
    int i = threadIdx.x;
    if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (; i < len >> 2; i += kThreads) {
        float4 pp = p4[i], mm = m4[i], vv = v4[i];
        const float4 gg = g4[i];
        e(pp.x, gg.x, mm.x, vv.x);
        e(pp.y, gg.y, mm.y, vv.y);
        e(pp.z, gg.z, mm.z, vv.z);
        e(pp.w, gg.w, mm.w, vv.w);
        p4[i] = pp;
        m4[i] = mm;
        v4[i] = vv;
      }
      i = ((len >> 2) << 2) + threadIdx.x;
    }
    for (; i < len; i += kThreads) e(p[i], g[i], m[i], v[i]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int leaf = threadIdx.x; leaf < a.chunks.count; leaf += kThreads) {
    *a.step[leaf] = __fadd_rn(*a.step[leaf], 1.f);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// The chunk table of leaves [lo, lo + count) from the call's table `first`
// (n + 1 entries, first[0] = 0).
Chunks chunks_of(const int* first, int lo, int count, int chunk) {
  Chunks c;
  for (int i = 0; i <= count; ++i) c.first[i] = first[lo + i] - first[lo];
  c.count = count;
  c.chunk = chunk;
  return c;
}

}  // namespace

extern "C" {

const char* adamw_clip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// norm: a device f32 scalar, written. grads, sizes: n leaves' f32 device
// pointers and element counts, and first: their chunk table (n + 1 entries;
// host arrays, read before the call returns). partials: `grid` device
// doubles; counter: a device unsigned that is 0 between calls. Launches on
// `stream` (one kernel for every kMaxLeaves leaves) and returns the first
// cudaError_t that is not 0 (0 on success).
int adamw_clip_sumsq(void* norm, const uint64_t* grads, const int64_t* sizes,
                     const int* first, int n, int chunk, void* partials,
                     void* counter, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int lo = 0; lo < n; lo += kMaxLeaves) {
    const int count = n - lo < kMaxLeaves ? n - lo : kMaxLeaves;
    SumsqArgs a;
    for (int i = 0; i < count; ++i) {
      a.g[i] = reinterpret_cast<const float*>(grads[lo + i]);
      a.n[i] = sizes[lo + i];
    }
    a.chunks = chunks_of(first, lo, count, chunk);
    adamw_clip_sumsq_kernel<<<grid, kThreads, 0, st>>>(
        a, static_cast<double*>(partials), static_cast<unsigned*>(counter),
        static_cast<float*>(norm), lo > 0, lo + count == n);
    const cudaError_t err = cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// lr, norm: device f32 scalars. leaves: 5 n device pointers, leaf by leaf
// (param, grad, exp_avg, exp_avg_sq, step: f32, the step one element);
// sizes, first as adamw_clip_sumsq. counter: a device unsigned that is 0
// between calls (not sumsq's). clip <= 0: no clip. The rest: the group's
// constants (Hyper). Launches on `stream` and returns as adamw_clip_sumsq.
int adamw_clip_update(const void* lr, const void* norm, const uint64_t* leaves,
                      const int64_t* sizes, const int* first, int n, int chunk,
                      void* counter, int grid, float clip, float beta1,
                      float beta2, float w1, float s2, float eps, float wd,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{clip, beta1, beta2, w1, s2, eps, wd};
  for (int lo = 0; lo < n; lo += kMaxLeaves) {
    const int count = n - lo < kMaxLeaves ? n - lo : kMaxLeaves;
    UpdateArgs a;
    for (int i = 0; i < count; ++i) {
      const uint64_t* leaf = leaves + 5 * static_cast<int64_t>(lo + i);
      a.p[i] = reinterpret_cast<float*>(leaf[0]);
      a.g[i] = reinterpret_cast<const float*>(leaf[1]);
      a.m[i] = reinterpret_cast<float*>(leaf[2]);
      a.v[i] = reinterpret_cast<float*>(leaf[3]);
      a.step[i] = reinterpret_cast<float*>(leaf[4]);
      a.n[i] = sizes[lo + i];
    }
    a.chunks = chunks_of(first, lo, count, chunk);
    adamw_clip_update_kernel<<<grid, kThreads, 0, st>>>(
        a, static_cast<const float*>(lr), static_cast<const float*>(norm),
        static_cast<unsigned*>(counter), h);
    const cudaError_t err = cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
