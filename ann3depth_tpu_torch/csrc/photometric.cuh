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
  __shared__ double red[kPhotoThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kPhotoThreads)
    s += partials[static_cast<size_t>(b) * n_partials + i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kPhotoThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  const float m = static_cast<float>(red[0] / static_cast<double>(per_frame));
  const float brightness = p[5];
  const float contrast = p[6];
  float* o = out + b * per_frame;
  for (long long i = static_cast<long long>(blockIdx.x) * kPhotoThreads +
                     threadIdx.x;
       i < per_frame; i += static_cast<long long>(gridDim.x) * kPhotoThreads)
    o[i] = (o[i] - m) * contrast + m + brightness;
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
