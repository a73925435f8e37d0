// Fused preprocess for Hopper (sm_90a): raw frames -> resized, normalized,
// augmented f32 frames, or mask-aware resampled depth.
//
// Replaces the TPU kernel ann3depth_tpu/ops/pallas_preprocess.py
// fused_preprocess (body _preprocess_kernel). The function is the one of
// ann3depth_tpu_torch/ops/fused_preprocess.py::plain_preprocess: per frame,
// a [B, 8] f32 param row (y_start, y_scale, x_start, x_scale, out_scale,
// brightness, contrast, photo) drives a separable antialiased triangle
// resample with half-pixel centers, then per-channel normalization and an
// optional photometric jitter around the frame mean (image mode), or a
// validity-masked renormalization (depth mode, C=1).
//
// Bound: memory. At the serving shape (u8 [32,480,640,3] -> f32
// [32,240,320,3]) the function must read 29.5 MB and write 29.5 MB, 17.6 us
// at 3.35 TB/s; its arithmetic (16 taps x 3 channels x 2 flops for each of
// 7.4 M outputs, 0.24 GFLOP) takes 3.5 us at 67 TFLOP/s f32.
//
// Design, and what it does about that bound:
// - The TPU kernel fed the MXU with a dense kron(Ax^T, I_C) matrix, two
//   thirds zeros for C=3. Here each thread computes one output pixel (all
//   its channels) straight from its own band of source taps: the triangle
//   weights are computed from (start, scale) as ops/resize.py does, over
//   [ceil(src - r), floor(src + r)] clipped to the frame, and divided by
//   the band's weight sum. No weight matrix exists in memory, so the only
//   device-memory traffic is the frame read and the output write.
// - uint8 is read directly, and all arithmetic is f32 (the TPU kernel ran
//   its column pass in bf16).
// - Neighbouring threads read neighbouring source pixels, and the 2x2
//   overlap of the bands of neighbouring outputs is served from L1/L2, so
//   each source byte leaves device memory about once.
// - The photometric mean spans the whole output frame, whose blocks run in
//   parallel. The resample kernel writes one partial sum per block; the
//   pass of photometric.cuh reduces a frame's partials (in f64) and applies
//   the jitter in place, on the frames whose photo flag is set. The device
//   decides per frame, so there is no host sync. That pass rereads and
//   rewrites the output of jittered frames; serving frames (photo = 0) skip
//   it.
// This first version is the simple one: one thread per output pixel, no
// shared-memory staging of the source rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "photometric.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

// compat/reference_spec.py
constexpr float kDepthEps = 1e-6f;
constexpr float kDepthCap = 70.0f;
constexpr float kValidThresh = 0.5f;

__device__ __forceinline__ float rgb_mean(int c) {
  return c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
}

__device__ __forceinline__ float rgb_std(int c) {
  return c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
}

// One output index's source band on one axis: the taps [lo, hi] with a
// non-zero triangle weight, and the weight sum that normalizes them.
struct Band {
  float src, radius, norm;
  int lo, hi;
};

__device__ __forceinline__ float tri(const Band& b, int i) {
  return fmaxf(0.0f, 1.0f - fabsf(b.src - static_cast<float>(i)) / b.radius);
}

__device__ __forceinline__ Band band_of(int o, int n_in, float start,
                                        float scale) {
  Band b;
  // src = start + (o + 0.5) * scale - 0.5, rounded step by step as
  // ops/resize.py computes it (no fused multiply-add).
  b.src = __fsub_rn(
      __fadd_rn(start, __fmul_rn(static_cast<float>(o) + 0.5f, scale)), 0.5f);
  b.radius = fmaxf(fabsf(scale), 1.0f);
  b.lo = max(0, static_cast<int>(ceilf(b.src - b.radius)));
  b.hi = min(n_in - 1, static_cast<int>(floorf(b.src + b.radius)));
  float sum = 0.0f;
  for (int i = b.lo; i <= b.hi; ++i) sum += tri(b, i);
  b.norm = fmaxf(sum, 1e-8f);
  return b;
}

// One thread per output pixel of frame blockIdx.z. Writes the normalized
// (image) or renormalized (depth) output, and, for frames with photo set,
// the block's partial sum of the output into partials[b, block].
template <typename T, int C, bool kDepth>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    resample_kernel(const T* __restrict__ frames,
                    const float* __restrict__ params,
                    float* __restrict__ out, float* __restrict__ partials,
                    int H, int W, int h, int w, bool norm) {
  const int b = blockIdx.z;
  const int ox = blockIdx.x * kBlockX + threadIdx.x;
  const int oy = blockIdx.y * kBlockY + threadIdx.y;
  const float* p = params + 8 * b;
  float local = 0.0f;
  if (ox < w && oy < h) {
    const Band by = band_of(oy, H, p[0], p[1]);
    const Band bx = band_of(ox, W, p[2], p[3]);
    const T* frame = frames + static_cast<size_t>(b) * H * W * C;
    float acc[C];
    float acc_v = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    // Row pass inside, column pass outside: the order of the reference's
    // two einsums (rows, then columns).
    for (int ix = bx.lo; ix <= bx.hi; ++ix) {
      float col[C];
      float col_v = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) col[c] = 0.0f;
      for (int iy = by.lo; iy <= by.hi; ++iy) {
        const float wy = tri(by, iy) / by.norm;
        const T* px = frame + (static_cast<size_t>(iy) * W + ix) * C;
        if constexpr (kDepth) {
          const float d = static_cast<float>(px[0]);
          const float v = (d > kDepthEps && d <= kDepthCap) ? 1.0f : 0.0f;
          col[0] += wy * (d * v);
          col_v += wy * v;
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) col[c] += wy * static_cast<float>(px[c]);
        }
      }
      const float wx = tri(bx, ix) / bx.norm;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += wx * col[c];
      if constexpr (kDepth) acc_v += wx * col_v;
    }
    float* o = out + ((static_cast<size_t>(b) * h + oy) * w + ox) * C;
    if constexpr (kDepth) {
      o[0] = acc_v >= kValidThresh ? (acc[0] / fmaxf(acc_v, 1e-6f)) * p[4]
                                   : 0.0f;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float n = norm ? (acc[c] / 255.0f - rgb_mean(c)) / rgb_std(c)
                             : acc[c] / 255.0f;
        o[c] = n;
        local += n;
      }
    }
  }
  if constexpr (!kDepth) {
    // The condition is the same for every thread of the block: all of them
    // belong to frame b.
    if (p[7] > 0.5f) {
      __shared__ float warp_sums[kWarps];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        local += __shfl_down_sync(0xffffffffu, local, off);
      const int tid = threadIdx.y * kBlockX + threadIdx.x;
      if ((tid & 31) == 0) warp_sums[tid >> 5] = local;
      __syncthreads();
      if (tid == 0) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) s += warp_sums[i];
        partials[static_cast<size_t>(b) * gridDim.x * gridDim.y +
                 blockIdx.y * gridDim.x + blockIdx.x] = s;
      }
    }
  }
}

template <typename T, int C, bool kDepth>
void launch_resample(const void* frames, const float* params, float* out,
                     float* partials, int B, int H, int W, int h, int w,
                     bool norm, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, B);
  resample_kernel<T, C, kDepth><<<grid, block, 0, stream>>>(
      static_cast<const T*>(frames), params, out, partials, H, W, h, w, norm);
}

}  // namespace

extern "C" {

// Partial sums per frame that fused_preprocess_launch writes: one for each
// block of the resample kernel.
int fused_preprocess_num_partials(int h, int w) {
  return ((w + kBlockX - 1) / kBlockX) * ((h + kBlockY - 1) / kBlockY);
}

const char* fused_preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames: u8 (frames_u8 = 1) or f32 [B, H, W, C]; params: f32 [B, 8];
// out: f32 [B, h, w, C]; partials: f32 [B, num_partials(h, w)] scratch.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int fused_preprocess_launch(const void* frames, int frames_u8,
                            const void* params, void* out, void* partials,
                            int B, int H, int W, int C, int h, int w,
                            int norm, int depth_mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  const bool nrm = norm != 0;
  if (depth_mode) {
    if (C != 1 || frames_u8) return static_cast<int>(cudaErrorInvalidValue);
    launch_resample<float, 1, true>(frames, p, o, part, B, H, W, h, w, nrm, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (frames_u8 && C == 3) {
    launch_resample<uint8_t, 3, false>(frames, p, o, part, B, H, W, h, w, nrm, s);
  } else if (frames_u8 && C == 1) {
    launch_resample<uint8_t, 1, false>(frames, p, o, part, B, H, W, h, w, nrm, s);
  } else if (!frames_u8 && C == 3) {
    launch_resample<float, 3, false>(frames, p, o, part, B, H, W, h, w, nrm, s);
  } else if (!frames_u8 && C == 1) {
    launch_resample<float, 1, false>(frames, p, o, part, B, H, W, h, w, nrm, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(a3d::launch_photometric(
      p, part, o, fused_preprocess_num_partials(h, w),
      static_cast<long long>(h) * w * C, B, s));
}

}  // extern "C"
