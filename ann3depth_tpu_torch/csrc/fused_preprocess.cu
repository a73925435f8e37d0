// Fused preprocess for Hopper (sm_90a), v1: raw frames -> resized,
// normalized, augmented f32 frames, or mask-aware resampled depth, all in
// exact f32.
//
// Replaces the TPU kernel ann3depth_tpu/ops/pallas_preprocess.py
// fused_preprocess (body _preprocess_kernel). The function is the one of
// ann3depth_tpu_torch/ops/fused_preprocess.py::plain_preprocess. The kernel
// is band_resample.cuh with the ExactF32 policy; its design and its bound
// (memory: 8.8 us at the train shape, 17.6 us at serving b32) are described
// there.

#include "band_resample.cuh"

extern "C" {

const char* fused_preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames: u8 (frames_u8 = 1) or f32 [B, H, W, C]; params: f32 [B, 8];
// out: f32 [B, h, w, C]; partials: f32 [B, ceil(h / tile_rows)] scratch in
// image mode (unused in depth mode); the plan from
// ops/fused_preprocess.band_plan. Launches on `stream` and returns
// the first cudaError_t that is not 0 (0 on success).
int fused_preprocess_launch(const void* frames, int frames_u8,
                            const void* params, void* out, void* partials,
                            int B, int H, int W, int C, int h, int w,
                            int tile_rows, int stage_rows, int taps_y,
                            int taps_x, int smem_bytes, int norm,
                            int depth_mode, void* stream) {
  const a3d::BandPlan plan{tile_rows, stage_rows, taps_y, taps_x, smem_bytes};
  return a3d::band_preprocess<a3d::ExactF32>(frames, frames_u8, params, out,
                                             partials, B, H, W, C, h, w, plan,
                                             norm, depth_mode, stream);
}

}  // extern "C"
