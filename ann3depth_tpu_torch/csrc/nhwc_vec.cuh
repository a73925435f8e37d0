// Vector loads and stores of NHWC channels, shared by the NHWC kernels
// (group_norm_nhwc.cu, upsample_aligned_nhwc.cu): V consecutive elements of
// bf16 or f32 as f32, in one 16-byte access where V > 1 (V = 8 bf16 or 4
// f32), one element where V = 1. Stores round once to the element type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace a3d {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements of T as f32, at an address 16-byte aligned where
// V > 1: `load` = `unpack(fetch(p))`, where `fetch` brings the bytes (a
// `Raw`, 16 bytes or one element) that `unpack` widens, so that a kernel
// can have loads in flight before it needs their values.
template <typename T, int V>
struct Io {
  static_assert(V == 1, "vector widths are specialised below");
  using Raw = T;
  __device__ static Raw fetch(const T* p) { return *p; }
  __device__ static void unpack(const Raw& r, float* v) { v[0] = to_f(r); }
  __device__ static void load(const T* p, float* v) { unpack(fetch(p), v); }
  __device__ static void store(T* p, const float* v) { put(p, v[0]); }
};

template <>
struct Io<float, 4> {
  using Raw = float4;
  __device__ static Raw fetch(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void unpack(const Raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static void load(const float* p, float* v) {
    unpack(fetch(p), v);
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw fetch(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const Raw& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], sizeof(h));
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    unpack(fetch(p), v);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      memcpy(&w[i], &h, sizeof(h));
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

}  // namespace a3d
