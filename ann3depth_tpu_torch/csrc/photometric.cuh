// Photometric jitter pass shared by the preprocess kernels
// (fused_preprocess.cu, fused_preprocess_v2.cu).
//
// The jitter (n - m) * contrast + m + brightness centres on the mean m of the
// whole output frame, whose blocks run in parallel. So the resample kernel
// writes one partial sum of its outputs per block (for frames with photo
// set), and this pass reduces a frame's partials in f64 and applies the
// jitter in place. The device decides per frame whether to jitter: no host
// sync. Frames with photo = 0 (eval, serving) return at once.

#pragma once

#include <cuda_runtime.h>

namespace a3d {

constexpr int kPhotoThreads = 256;
constexpr long long kPhotoMaxBlocks = 64;  // per frame
constexpr int kPhotoUnroll = 4;

// Grid (chunks, B). Every block of a frame with photo set reduces the
// frame's partials to its mean m, then applies the jitter to its chunk.
__global__ void __launch_bounds__(kPhotoThreads)
    photometric_kernel(const float* __restrict__ params,
                       const float* __restrict__ partials,
                       float* __restrict__ out, int n_partials,
                       long long per_frame) {
  const int b = blockIdx.y;
  const float* p = params + 8 * b;
  if (!(p[7] > 0.5f)) return;  // the same for the whole block
  __shared__ float mean;
  if (threadIdx.x < 32) {  // one warp reduces the frame's partials in f64
    double s = 0.0;
    for (int i = threadIdx.x; i < n_partials; i += 32)
      s += partials[static_cast<size_t>(b) * n_partials + i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0)
      mean = static_cast<float>(s / static_cast<double>(per_frame));
  }
  __syncthreads();
  const float m = mean;
  const float brightness = p[5];
  const float contrast = p[6];
  float* o = out + b * per_frame;
  const long long first =
      static_cast<long long>(blockIdx.x) * kPhotoThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kPhotoThreads;
  if (per_frame % 4 == 0) {  // the frame starts 16-byte aligned: float4
    float4* o4 = reinterpret_cast<float4*>(o);
    const long long n4 = per_frame / 4;
    // kPhotoUnroll loads in flight a thread before the first store.
    for (long long base = first; base < n4; base += kPhotoUnroll * stride) {
      float4 v[kPhotoUnroll];
#pragma unroll
      for (int k = 0; k < kPhotoUnroll; ++k)
        if (base + k * stride < n4) v[k] = o4[base + k * stride];
#pragma unroll
      for (int k = 0; k < kPhotoUnroll; ++k) {
        if (base + k * stride >= n4) break;
        v[k].x = (v[k].x - m) * contrast + m + brightness;
        v[k].y = (v[k].y - m) * contrast + m + brightness;
        v[k].z = (v[k].z - m) * contrast + m + brightness;
        v[k].w = (v[k].w - m) * contrast + m + brightness;
        o4[base + k * stride] = v[k];
      }
    }
  } else {
    for (long long i = first; i < per_frame; i += stride)
      o[i] = (o[i] - m) * contrast + m + brightness;
  }
}

// Launches the pass over out [B, per_frame]; returns cudaGetLastError().
inline cudaError_t launch_photometric(const float* params,
                                      const float* partials, float* out,
                                      int n_partials, long long per_frame,
                                      int B, cudaStream_t stream) {
  long long chunks = (per_frame + kPhotoThreads - 1) / kPhotoThreads;
  if (chunks > kPhotoMaxBlocks) chunks = kPhotoMaxBlocks;
  photometric_kernel<<<dim3(static_cast<unsigned>(chunks), B), kPhotoThreads,
                       0, stream>>>(params, partials, out, n_partials,
                                    per_frame);
  return cudaGetLastError();
}

}  // namespace a3d
