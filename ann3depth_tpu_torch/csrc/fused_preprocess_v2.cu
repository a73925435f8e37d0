// Fused preprocess for Hopper (sm_90a), v2: the function of v1 with the TPU
// v2 kernel's precision.
//
// Replaces the TPU kernel ann3depth_tpu/ops/pallas_preprocess.py
// fused_preprocess_v2 (body _preprocess_kernel_v2). The function is the one
// of ann3depth_tpu_torch/ops/fused_preprocess.py::plain_preprocess_v2: per
// frame, with X = frames[b] viewed as [H, W*C],
//
//   R = Ay . X                in f32, then rounded to bf16
//   Z = R_bf16 . T            T = kron(Ax^T, I_C) in bf16, f32 sums
//   image: n = Z * s_c + b_c  (s_c = 1/(255 sd_c), b_c = -m_c/sd_c), or
//          Z / 255 without norm; then the photometric jitter;
//   depth (C = 1): R and Rv = Ay . V of the masked X, Z and Zv through T,
//          out = Z / max(Zv, 1e-6) * out_scale where Zv >= 0.5, else 0.
//
// The TPU kernel took Ay and T as dense operands because its matrix unit
// wanted them. Here they never exist: the kernel is band_resample.cuh with
// the Bf16Operands policy, which builds each band's weights in the kernel,
// rounds the x weights and R to bf16 and sums their exact products in f32.
// Its bound is v1's: memory, 8.8 us at the train shape.

#include "band_resample.cuh"

extern "C" {

const char* fused_preprocess_v2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Arguments as fused_preprocess_launch (fused_preprocess.cu).
int fused_preprocess_v2_launch(const void* frames, int frames_u8,
                               const void* params, void* out, void* partials,
                               int B, int H, int W, int C, int h, int w,
                               int tile_rows, int stage_rows, int taps_y,
                               int taps_x, int smem_bytes, int norm,
                               int depth_mode, void* stream) {
  const a3d::BandPlan plan{tile_rows, stage_rows, taps_y, taps_x, smem_bytes};
  return a3d::band_preprocess<a3d::Bf16Operands>(
      frames, frames_u8, params, out, partials, B, H, W, C, h, w, plan, norm,
      depth_mode, stream);
}

}  // extern "C"
