// Fused preprocess v2 for Hopper (sm_90a): raw frames and precomputed
// resample matrices -> resized, normalized, augmented f32 frames, or
// mask-aware resampled depth.
//
// Replaces the TPU kernel ann3depth_tpu/ops/pallas_preprocess.py
// fused_preprocess_v2 (body _preprocess_kernel_v2). The function is the one
// of ann3depth_tpu_torch/ops/fused_preprocess.py::plain_preprocess_v2. Per
// frame b, with X = frames[b] viewed as [H, W*C] (u8 or f32, converted on
// load), Ay = ay[b] f32 [h, H] and T = t[b] = kron(Ax^T, I_C) bf16
// [W*C, w*C], both built by the wrapper:
//
//   R = Ay . X                in f32, then rounded to bf16
//   Z = R_bf16 . T            bf16 x bf16 products, f32 sums
//   image: n = Z * s_c + b_c  (s_c = 1/(255 sd_c), b_c = -m_c/sd_c), or
//          Z / 255 without norm; then, where photo > 0.5, the jitter
//          (n - m) * contrast + m + brightness around the frame mean m;
//   depth (C = 1): V = validity of X on the raw grid, R = Ay . (X V) and
//          Rv = Ay . V as above, Z and Zv through T, out = Z / max(Zv, 1e-6)
//          * out_scale where Zv >= 0.5, else 0.
//
// Bound: operations. At the train shape (u8 [16,480,640,3] -> f32
// [16,240,320,3]) the function must move 96 MB (frames 14.7, Ay 7.4, T 59.0,
// out 14.7), 29 us at 3.35 TB/s; the dense row pass is 7.1 GFLOP of f32,
// 106 us at 67 TFLOP/s outside the tensor cores, and the column pass 14.2
// GFLOP of bf16, 14 us at 989 TFLOP/s. So the f32 row pass sets the bound,
// about 120 us.
//
// Design, the simple first version:
// - Row pass: a shared-memory-tiled f32 FFMA GEMM (64x64 tiles, k-steps of
//   16, 4x4 outputs a thread) that converts X on load, applies the validity
//   mask in depth mode, and writes R (and Rv) to a bf16 scratch tensor.
// - Column pass: bf16 tensor-core MMA through WMMA (m16n16k16, f32
//   accumulators; 64x64 tiles, 4 warps of 32x32). The normalization or the
//   depth epilogue is fused: the accumulators go through shared memory,
//   where each output element finds its row and column. Blocks that share a
//   T tile are neighbours in the grid, so T is read from L2 after the first.
// - Photometric mean: one partial sum per column-pass block, then the pass
//   of photometric.cuh, as in fused_preprocess.cu. No host sync.
// Launches: 3 in image mode (row, column, photometric), 2 in depth mode.
// Not yet: wgmma, TMA, a tensor-core row pass; the banded structure of Ay
// and T (both mostly zeros) is not exploited.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "photometric.cuh"

namespace {

using bf16 = __nv_bfloat16;

// compat/reference_spec.py
constexpr float kDepthEps = 1e-6f;
constexpr float kDepthCap = 70.0f;
constexpr float kValidThresh = 0.5f;

// Row pass tiling.
constexpr int kRowBM = 64;
constexpr int kRowBN = 64;
constexpr int kRowBK = 16;
constexpr int kRowThreads = 256;  // 16 x 16, each 4 x 4 outputs

// Column pass tiling.
constexpr int kColBM = 64;
constexpr int kColBN = 64;
constexpr int kColBK = 32;
constexpr int kColThreads = 128;  // 4 warps in 2 x 2, each 32 x 32
constexpr int kLdA = kColBK + 8;  // bf16 elements; WMMA wants multiples of 8
constexpr int kLdB = kColBN + 8;
constexpr int kLdC = kColBN + 4;  // f32 elements; multiples of 4
constexpr int kABytes = kColBM * kLdA * 2;
constexpr int kBBytes = kColBK * kLdB * 2;
constexpr int kCBytes = kColBM * kLdC * 4;
constexpr int kLoopBytes = 2 * kABytes + kBBytes;
constexpr int kSmemBytes = kLoopBytes > 2 * kCBytes ? kLoopBytes : 2 * kCBytes;

// Normalization constants, as the TPU kernel folds them (f64 -> f32).
__device__ __forceinline__ float norm_scale(int c) {
  return c == 0 ? static_cast<float>(1.0 / (255.0 * 0.229))
                : (c == 1 ? static_cast<float>(1.0 / (255.0 * 0.224))
                          : static_cast<float>(1.0 / (255.0 * 0.225)));
}

__device__ __forceinline__ float norm_bias(int c) {
  return c == 0 ? static_cast<float>(-0.485 / 0.229)
                : (c == 1 ? static_cast<float>(-0.456 / 0.224)
                          : static_cast<float>(-0.406 / 0.225));
}

// R[b] = Ay[b] . X[b] over [h, N] (N = W*C), rounded to bf16. In depth mode
// also Rv[b] = Ay[b] . V[b], with X masked by V.
template <typename T, bool kDepth>
__global__ void __launch_bounds__(kRowThreads)
    row_pass_kernel(const T* __restrict__ frames, const float* __restrict__ ay,
                    bf16* __restrict__ r, bf16* __restrict__ rv, int H, int N,
                    int h) {
  __shared__ float As[kRowBK][kRowBM + 1];  // As[k][m]; +1 against conflicts
  __shared__ float Bs[kRowBK][kRowBN];
  __shared__ float Vs[kDepth ? kRowBK : 1][kRowBN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kRowBM;
  const int n0 = blockIdx.x * kRowBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* A = ay + static_cast<size_t>(b) * h * H;
  const T* X = frames + static_cast<size_t>(b) * H * N;
  float acc[4][4];
  float acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc_v[i][j] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += kRowBK) {
    for (int i = tid; i < kRowBM * kRowBK; i += kRowThreads) {
      const int m = i / kRowBK, k = i % kRowBK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < h && gk < H) ? A[static_cast<size_t>(gm) * H + gk]
                                    : 0.0f;
    }
    for (int i = tid; i < kRowBK * kRowBN; i += kRowThreads) {
      const int k = i / kRowBN, n = i % kRowBN;
      const int gk = k0 + k, gn = n0 + n;
      const float x = (gk < H && gn < N)
                          ? static_cast<float>(X[static_cast<size_t>(gk) * N + gn])
                          : 0.0f;
      if constexpr (kDepth) {
        const float v = (x > kDepthEps && x <= kDepthCap) ? 1.0f : 0.0f;
        Bs[k][n] = x * v;
        Vs[k][n] = v;
      } else {
        Bs[k][n] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowBK; ++k) {
      float a[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      if constexpr (kDepth) {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = Vs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_v[i][j] = fmaf(a[i], x[j], acc_v[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= h) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const size_t o = (static_cast<size_t>(b) * h + gm) * N + gn;
      r[o] = __float2bfloat16_rn(acc[i][j]);
      if constexpr (kDepth) rv[o] = __float2bfloat16_rn(acc_v[i][j]);
    }
  }
}

// Z[b] = R[b] . T[b] over [h, Nout] (Nout = w*C) with the epilogue fused.
// Writes one partial sum of the image output per block for frames with
// photo set.
template <bool kDepth>
__global__ void __launch_bounds__(kColThreads)
    col_pass_kernel(const bf16* __restrict__ r, const bf16* __restrict__ rv,
                    const bf16* __restrict__ t,
                    const float* __restrict__ params, float* __restrict__ out,
                    float* __restrict__ partials, int K, int Nout, int h,
                    int C, bool norm) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  auto As = reinterpret_cast<bf16 (*)[kLdA]>(smem);
  auto Avs = reinterpret_cast<bf16 (*)[kLdA]>(smem + kABytes);
  auto Bs = reinterpret_cast<bf16 (*)[kLdB]>(smem + 2 * kABytes);
  auto Cs = reinterpret_cast<float (*)[kLdC]>(smem);
  auto Cvs = reinterpret_cast<float (*)[kLdC]>(smem + kCBytes);

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kColBM;  // neighbours in x share the T tile
  const int n0 = blockIdx.y * kColBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const bf16* R = r + static_cast<size_t>(b) * h * K;
  const bf16* Rv = kDepth ? rv + static_cast<size_t>(b) * h * K : nullptr;
  const bf16* Tb = t + static_cast<size_t>(b) * K * Nout;
  const bf16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_v[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if constexpr (kDepth) wmma::fill_fragment(acc_v[i][j], 0.0f);
    }

  for (int k0 = 0; k0 < K; k0 += kColBK) {
    for (int i = tid; i < kColBM * kColBK; i += kColThreads) {
      const int m = i / kColBK, k = i % kColBK;
      const int gm = m0 + m, gk = k0 + k;
      const bool in = gm < h && gk < K;
      const size_t src = static_cast<size_t>(gm) * K + gk;
      As[m][k] = in ? R[src] : zero;
      if constexpr (kDepth) Avs[m][k] = in ? Rv[src] : zero;
    }
    for (int i = tid; i < kColBK * kColBN; i += kColThreads) {
      const int k = i / kColBN, n = i % kColBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < Nout)
                     ? Tb[static_cast<size_t>(gk) * Nout + gn]
                     : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kColBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk][wn + 16 * j], kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], &As[wm + 16 * i][kk], kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      if constexpr (kDepth) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(fa[i], &Avs[wm + 16 * i][kk], kLdA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc_v[i][j], fa[i], fb[j], acc_v[i][j]);
        }
      }
    }
    __syncthreads();
  }
  // The loop's tiles are dead: the accumulators take their place.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], kLdC,
                              wmma::mem_row_major);
      if constexpr (kDepth)
        wmma::store_matrix_sync(&Cvs[wm + 16 * i][wn + 16 * j], acc_v[i][j],
                                kLdC, wmma::mem_row_major);
    }
  __syncthreads();

  const float* p = params + 8 * b;
  float local = 0.0f;
  for (int i = tid; i < kColBM * kColBN; i += kColThreads) {
    const int m = i / kColBN, n = i % kColBN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm >= h || gn >= Nout) continue;
    const float z = Cs[m][n];
    float o;
    if constexpr (kDepth) {
      const float zv = Cvs[m][n];
      o = zv >= kValidThresh ? (z / fmaxf(zv, 1e-6f)) * p[4] : 0.0f;
    } else {
      const int c = gn % C;
      o = norm ? z * norm_scale(c) + norm_bias(c) : z / 255.0f;
      local += o;
    }
    out[(static_cast<size_t>(b) * h + gm) * Nout + gn] = o;
  }
  if constexpr (!kDepth) {
    if (p[7] > 0.5f) {  // the same for every thread of the block
      __shared__ float warp_sums[kColThreads / 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        local += __shfl_down_sync(0xffffffffu, local, off);
      if ((tid & 31) == 0) warp_sums[tid >> 5] = local;
      __syncthreads();
      if (tid == 0) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kColThreads / 32; ++i) s += warp_sums[i];
        partials[static_cast<size_t>(b) * gridDim.x * gridDim.y +
                 blockIdx.y * gridDim.x + blockIdx.x] = s;
      }
    }
  }
}

template <typename T, bool kDepth>
cudaError_t launch_row(const void* frames, const float* ay, bf16* r, bf16* rv,
                       int B, int H, int N, int h, cudaStream_t s) {
  const dim3 grid((N + kRowBN - 1) / kRowBN, (h + kRowBM - 1) / kRowBM, B);
  row_pass_kernel<T, kDepth><<<grid, kRowThreads, 0, s>>>(
      static_cast<const T*>(frames), ay, r, rv, H, N, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partial sums per frame that fused_preprocess_v2_launch writes: one for
// each block of the column pass.
int fused_preprocess_v2_num_partials(int h, int w, int C) {
  return ((h + kColBM - 1) / kColBM) * ((w * C + kColBN - 1) / kColBN);
}

const char* fused_preprocess_v2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames: u8 (frames_u8 = 1) or f32 [B, H, W, C]; params: f32 [B, 8];
// ay: f32 [B, h, H]; t: bf16 [B, W*C, w*C]; r (and rv in depth mode): bf16
// [B, h, W*C] scratch; out: f32 [B, h, w, C]; partials: f32
// [B, num_partials(h, w, C)] scratch. Launches on `stream` and returns the
// first cudaGetLastError() that is not 0 (0 on success).
int fused_preprocess_v2_launch(const void* frames, int frames_u8,
                               const void* params, const void* ay,
                               const void* t, void* r, void* rv, void* out,
                               void* partials, int B, int H, int W, int C,
                               int h, int w, int norm, int depth_mode,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  const float* a = static_cast<const float*>(ay);
  const bf16* tt = static_cast<const bf16*>(t);
  bf16* rr = static_cast<bf16*>(r);
  bf16* rrv = static_cast<bf16*>(rv);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  const int N = W * C;
  const int Nout = w * C;
  const dim3 col_grid((h + kColBM - 1) / kColBM, (Nout + kColBN - 1) / kColBN,
                      B);
  cudaError_t err;
  if (depth_mode) {
    if (C != 1 || frames_u8 || rv == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_row<float, true>(frames, a, rr, rrv, B, H, N, h, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    col_pass_kernel<true><<<col_grid, kColThreads, 0, s>>>(
        rr, rrv, tt, p, o, part, N, Nout, h, C, false);
    return static_cast<int>(cudaGetLastError());
  }
  if (frames_u8) {
    err = launch_row<uint8_t, false>(frames, a, rr, nullptr, B, H, N, h, s);
  } else {
    err = launch_row<float, false>(frames, a, rr, nullptr, B, H, N, h, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  col_pass_kernel<false><<<col_grid, kColThreads, 0, s>>>(
      rr, nullptr, tt, p, o, part, N, Nout, h, C, norm != 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(a3d::launch_photometric(
      p, part, o, fused_preprocess_v2_num_partials(h, w, C),
      static_cast<long long>(h) * w * C, B, s));
}

}  // extern "C"
