#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printed as it runs; any failure exits non-zero before the
last line is printed:

1. Build every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together) and print the build time and the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it and at the eval depth
   shape, and at the shapes of the other families' paths (dpt-384: 480x640
   frames and NYU-shaped depth to 384x384, Make3D's grid upsampled on both
   axes to 384x384; make3d-small: b1 frames, Make3D's grid to 30x40 with a
   21-tap row band). Time each kernel on the device (torch.profiler: its
   resample and photometric launches apart), through its wrapper with CUDA
   events, the plain version with CUDA events, and the closest PyTorch
   call(s) on the device. Report each case's bound.
2b. Hold the NHWC GroupNorm + ReLU kernel (csrc/group_norm_nhwc.cu), forward
   and backward, against its plain version at the encdec train step's three
   norm shapes in bf16, and time it on the device and with CUDA events
   beside the plain version and `F.group_norm` + ReLU on the bf16 tensor.
2c. Hold the align_corners upsample kernels (csrc/upsample_aligned_nhwc.cu),
   forward and backward, against F.interpolate(align_corners=True) in f64
   at DPT-Large's five b16 shapes in bf16, and time them on the device and
   with CUDA events beside the (hi, lo) GEMM pair the CPU runs and
   F.interpolate; then train the dpt-large preset (b16, K=1, device pool)
   for 8 steps, as the eager twin and replaying its step graph: five
   launches of each kernel an eager step, five of each in the traced steps
   and in each traced replay, no baddbmm and no upsample_bilinear2d; the
   same runs count the update's two kernels (csrc/adamw_clip.cu), one
   launch of each an eager step and one of each in the traced steps and in
   each traced replay, by name.
2d. Hold the update's kernels (csrc/adamw_clip.cu: the global norm, then
   the clip folded into AdamW) at DPT-Large's 360 leaves (341,848,257 f32
   params) against torch's capturable foreach AdamW after `global_norm`
   and the clip: 3 updates given torch's norm, p, m and v bit for bit, and
   the kernels' own norm within rel 1e-6. Time the update on the device
   and with CUDA events, eager and replayed from a CUDA graph, beside the
   bound (32 bytes a param at the HBM rate), the plain version, the port's
   path before the kernels, and torch's fused AdamW after `_foreach_norm`
   and `_foreach_mul_` (`library_ms`, a yardstick the port never calls).
3. Serve make3d-encdec at full width (random weights from the config's
   seed) through the port's `service_from_config` and `DepthServer`, POST
   8 concurrent single frames and one 4-frame body to /v1/depth (a first
   round, then the measured one), check the answers against the same model
   fed by the plain preprocess, and check that the path launched the
   kernel.
4. Train make3d-encdec at full width, b16, on synthetic scenes at Make3D's
   raw shapes (RGB 480x640, laser grid 305x55) with augmentation, through
   `train.loop.train`: 40 steps, then a resume to 50, each run's first
   step eager and the rest replays of a CUDA graph of the step (phase
   16). Check that the losses are finite and fall, that the resume
   continues the step counter and that every step ran the v1 kernel twice
   (launched in the eager step, recorded twice into the graph and run at
   each replay), and that every step ran the GroupNorm kernels once a
   Stage each way (launched in the eager step, recorded into the graph;
   in the eval graphs and grids forward only; `gn_runs`); time the eager
   train step and its preprocess on a fixed device batch (its profile
   holding each GroupNorm kernel once a Stage); hold one step fed by the
   kernel against one fed by the plain preprocess. Phase 7 holds the same
   counts for its families (multiscale five Stages, the others none).
5. The v2 kernel inside the train step: from one state and one raw batch,
   K steps of `step_on_batch` fed by v1, by v2 and by the plain
   preprocess, each timed, with the same augmentation draws; check that v2
   launched in every step and that the v1- and v2-fed losses agree.
6. Eval, infer and live on phase 4's checkpoint (50 steps, full width):
   `cli eval` plain, with a report and tta, and with two protocols (finite
   metrics, two kernel calls a batch; the plain run against the same eval
   fed by the plain preprocess, and against a control that is one source
   pixel off); serving the checkpoint, one round, then each of its batches
   against the restored model fed by the plain preprocess; the headless
   live viewer on the `live` config at 640x480, 30 fps, 300 frames,
   without and with smoothing (fps, latency p50/p99, the native ring, a
   kernel call every frame), the engine's device-program latency and
   latency decomposition and its frames (one of uniform noise) against
   plain-fed `live_step`; the `infer --image` device helper and the
   transcode device loop at batch 8 on 64 frames. The v1 kernel is held
   and timed at the live (b1, uniform noise) and eval (b16) image shapes.
7. The other model families at full width, each on its own checkpoints:
   dpt-384 (23,408,641 params, b16, 384x384 in and out, synthetic scenes at
   NYU's raw shapes, 480x640 RGB and depth) trains 30 steps and resumes to
   40 with phase 4's checks, its step timed (FLOPs and MFU against the
   dense bf16 peak, the card's busy share), then runs K v2-fed steps as in
   phase 5, `cli eval` against its plain-fed twin and the control, one
   serving round, the `infer --image` helper and 30 frames of `cli live`;
   make3d-multiscale (b16, Make3D's raw shapes) trains, resumes and serves
   a round; make3d-small (b1) trains, resumes and serves a round. Phases 4
   and 7 also run 20 steps twice from one state and one feed in the
   default mode and report how far the two loss curves part.
8. NYU and packed records, several datasets, grad accumulation,
   distillation and the loop's stop/best/rollback/trace options, through
   the CLI at full width: an NYU labeled file in its v7.3 layout at NYU's
   raw shapes (48 synthetic scenes, a splits.mat) through `cli prepare`
   (packed as records directly where h5py is missing) and Make3D-shaped
   scenes packed as records; nyu-encdec-aug (b16, augmented) trains on
   both, batch by batch, at grad_accum 2 with in-loop eval, early stopping,
   the best-eval checkpoint, TensorBoard and a profiler window, rolls back
   to a middle checkpoint and runs on, and `cli eval` scores each dataset;
   one accumulated step is held against one full-batch step; dpt-384 trains
   from the NYU records at grad_accum 2; make3d-small distills phase 4's
   encdec checkpoint; the loop's rate reading records is taken against
   phase 4's. Phase 2 holds and times v1 at this path's new shapes.
9. The input pipeline and the K-step CUDA graph: make3d-encdec (b16, full
   width) from a device pool of 64 Make3D-shaped scenes, 40 steps at K=1
   (the eager twin, `eager_twin`) and at K=10 (replays of a CUDA graph of
   the step), plain and at
   grad_accum 2, and nyu-encdec-aug from phase 8's NYU records, each K=10
   run held against its K=1 twin (params within the JAX scan test's rtol
   2e-5 / atol 2e-6, loss within 2e-4); the v1 kernel's launches in the
   replayed steps counted from the loop's profiler trace; dpt-384 from the
   NYU records at K=1 four times and K=5, held to twice the largest gap
   between its K=1 runs; a window pool (96 scenes, windows of 32) with
   echo 2 and K=4, every example seen twice a pass, then `--window-epochs
   auto` (its factor, staging and pass times, the sidecar; calibrated on
   the replayed step); the host feed (DeviceFeed) and `--use-grain
   --num-workers 2` through the CLI at K=1 (step graph replays), the
   losses falling; `eval --cache-device` on phase 4's checkpoint against
   the host-fed eval; and each feed's step ms, images/s, busy share,
   launches a step and peak memory.

10. int8 and the exported serving program: qconv at make3d-encdec's 12
   int8 convs at the b32 serving shapes and qmatmul at dpt-384's
   projection and MLP shapes at b16, each equal to its CPU result and
   timed against the bf16 cuDNN conv or cuBLAS matmul of the shapes;
   phase 4's checkpoint and phase 7's dpt-384 served at `--quant int8`
   (one round, each batch against the plain-fed int8 model), their int8
   against bf16 log-depth divergence and the serving fn's device ms, int8
   against bf16; `cli eval` (against its plain-fed twin and the control),
   the `infer --image` helper and 30 frames of `cli live`, all at int8;
   `cli train --quant int8-qat` (20 steps, host feed) and the same from a
   device pool at K=1 and K=10 (phase 9's tolerances), the losses falling,
   the QAT checkpoint served at int8 against its int8-qat forward; `cli
   export` of phase 4's checkpoint for any batch, at batch 8 and at int8,
   each through `serve --artifact` (one round, one kernel launch a batch),
   its answers against the eager serving fn within 1e-6, and the exported
   against the eager program's device ms at b32. Phase 2 also times the v1
   wrapper's host dispatch through the registered op, straight to the
   launch, and through a `torch.library.custom_op` twin.

11. The parallel modes (parallel/), each rank a child process running the
   port's CLI on this card: make3d-encdec b16 on two ranks over gloo (b8
   each, the v1 kernel twice a step in every rank) against one process at
   b16 fed the same rows, each logged loss within STEP_LOSS_RTOL; ZeRO-1
   on two ranks against that run (params within the JAX ZeRO-1 test's
   tolerances, each rank holding half the optimizer state); phase 9's
   plain encdec pair again in a one-rank NCCL group at K=1 and K=10 (the
   all-reduce captured in the graph), equal to phase 9's bit for bit;
   dpt-384 b16 at --tp 2 on two ranks against the tp=1 run that computes
   each block as tp=2 does (`sharding_rules.tp_twin`), held to twice the
   largest gap of four plain tp=1 runs (the gap to a plain run reported),
   with the model-axis all-reduces a step and their time, and the same
   run with an in-loop eval refused before its first step (gloo's
   model-axis all-reduces cannot be captured in the eval step's graph);
   `serve --dp 0` against --dp 1 (and --dp 2 refused on one card); `eval`
   on two ranks (b8 each) against one process at b8 within
   EVAL_METRIC_RTOL. Each rank times a gradient all-reduce of its model's
   size on gloo. Phase 2 holds v1 at the per-rank shapes.

12. The tools, through the port's CLI at full width: `info --flops` of
   make3d-encdec, make3d-multiscale, make3d-small and dpt-384 (the params
   the training phases count, the output shape the model gives, the
   card's bf16 peak); `sweep` of make3d-encdec (b16, Make3D-shaped
   synthetic scenes) over two learning rates and two losses, 20 steps and
   2 eval batches a trial, each trial's v1 launches, wall time, images/s
   and peak memory (within 10% of the first trial's), then the same grid
   again (every trial skipped, no launch), and trial 0 against `train` +
   `eval` of its overrides in fresh directories, bit for bit; `download`
   of four staged Make3D archives (48 scenes: 480x640 JPEGs and 55x305x4
   Position3DGrid .mat files, 32 train and 16 test), recording then
   verifying their sums, and of NYU's staged labeled file (phase 8's, or
   a v7.3 header stand-in where h5py is missing), then 10 train steps of
   make3d-encdec from the extracted tree and `eval` of its Test134/; and
   5 train steps at each `--preprocess-impl`, equal bit for bit. The TF
   checkpoint import (compat/tf_ckpt_import.py) is not driven: the card's
   machine has no tensorflow (tests/test_torch_tf_import.py holds it on
   the CPU).

13. The models' variant fields at full width, each model reached by a
   registry name this script registers on a subclass with the field set
   (`_register_variants`): dpt-384 at upsample "matmul" from phase 8's NYU
   records in the device pool (augmented), in the default mode four K=1
   runs and a K=DPT_K graph run held as phase 9 holds "resize" (twice
   the largest K=1 pair gap), their gaps beside phase 9's; under
   torch.use_deterministic_algorithms(True), in a child process, two K=1
   runs that must be equal bit for bit and a K=DPT_K graph run held to
   the fixed GRAPH_* tolerances; the eager and graph step ms and busy
   share in both modes, and the upsamples' share of the device time
   against "resize" (phase 9's runs and a traced one), v1 twice a step;
   phase 7's dpt-384 checkpoint served at b16 under each attention_impl
   (serving fn device ms and kernels a batch, log-depth against "flax"
   held to its jitter control, "fused" loading the "flax" state strictly);
   make3d-encdec (b16) from phase 9's pool at norm "none", at upsample
   "resize" and with refine on both decoder stages, VARIANT_STEPS steps
   each, the losses falling; the default encdec's forward and backward
   device ms with its upsamples as `upsample_matmul` (einsums) and as
   `upsample_matmul_nhwc` (batched GEMMs); `--optimizer sgd` at K=1 against K=POOL_K
   within the GRAPH_* tolerances, its step ms and busy share beside phase
   9's adamw; and Make3D's four archives at their true scale
   (tools/synth_real_scale.py: 2272x1704 JPEGs, Test134Depth in the
   (305, 55, 4) orientation, TRUE_SCALE_SPLIT scenes) through `download`,
   TRUE_SCALE_STEPS train steps of make3d-encdec and `eval`.

14. `bench` at full width: `cli bench --config make3d-encdec` (train,
   b16, 100 steps: eager steps, then K=50 blocks of BlockRunner's CUDA
   graph), `cli bench --serving --config make3d-encdec --batch-size 32`,
   plain and at `--quant int8` (a CUDA graph of the serving fn a pool
   entry), and bench/train.py and bench/infer.py on dpt-384 (50 steps;
   serving b16). Each prints its JSON line with the card. Checks: every
   loss finite; 0 < mfu <= 1; the v1 kernel's launches outside the graphs
   exactly those of the eager calls, and its calls recorded into the
   graphs (2 a captured step, 1 a serving graph); step_ms and batch_ms at
   least BENCH_DEVICE_SHARE of the device time (device_profile of eager
   steps on a fresh state; of one replay a pool entry, whose v1 resample
   the trace must show); a serving graph's output against the eager
   serving fn within EXPORT_RTOL.

15. The compiled programs (utils/graphs.py: the serve, live, transcode,
   eval and infer steps as CUDA graphs, one capture a key), at full
   width: the serve ladder (1...32) of phase 4's make3d-encdec and phase
   7's dpt-384 checkpoints, captured by `BatchingService.warmup` in this
   thread and replayed by the dispatch thread, its peak memory; phase
   10's exported program (`serve --artifact`) at b1, b8 and b32; the live
   engine without and with smoothing, its frames also replayed from
   another thread; the transcode loop at b8 with a tail of 3; the eval
   step plain and at tta+align+crop; `infer_image`, plain and at tta
   "flip". Each graph equal to its eager call bit for bit, the v1 kernel
   recorded into each (one call a graph, two an eval batch; traced in
   the exported program's replay); the served, live and eval graphs
   against plain-fed twins built inside `fed_by`, each shifted-window
   control failing the same tolerance. Each path prints eager against
   graph: wall and device ms a call, busy share, device kernels and host
   launches a call; also a serving burst's requests/s, the live
   `device_step_latency` and phase 6's viewer p50/p99 at 30 fps, eval
   images/s.

The serve, live, transcode, eval, infer and train paths of every phase
run graphs on the card: the v1 wrapper counts only the launches
outside them (each capture's warm call, eager steps), and `graph_runs`
counts the calls recorded into the graphs and their replays, so each
path's check holds its v1 runs (`v1_runs`: the eager launches and a
graph's recorded calls at each replay) to what it held before.

16. The train step and the report eval as CUDA graphs (train/dispatch.py,
   `loop.eval_report_graphs`): each K=1 loop replaying its step graph held
   bit for bit against its eager twin (`eager_twin`: the same loop with
   the step eager) from one seed, feed and draws: make3d-encdec b16 from
   phase 8's Make3D records on the host feed at the preset's own flags
   (no augmentation: `train`'s defaults), and augmented from the device
   pool, at grad_accum 2 and distilled from phase 4's checkpoint, and
   nyu-encdec-aug on the NYU and Make3D records (a graph of each raw
   shape); dpt-384 at K=1: under torch's deterministic mode at upsample
   "matmul" (phase 13's child) equal to its eager K=1 run bit for bit,
   and from phase 9's pool in the default mode, timed against phase 9's
   eager runs (its gap to them reported: those runs part);
   `evaluate` with a report (tta "flip") on phase 4's checkpoint, graph
   against eager bit for bit (metrics and files). Each run's step ms,
   busy share, host launches a step and peak memory, eager against graph,
   its v1 calls recorded into each step graph (2 a microbatch) and the
   resamples in each traced replay; its GroupNorm calls recorded into
   each step graph (3 a microbatch each way, the teacher's 3 forward
   besides where distilled) and each GroupNorm kernel's runs in each
   traced replay.

The K=1 references that phases 9, 10, 11 and 13 hold K-step graphs (and
the parallel ranks) against are eager runs: `pool_run` at K=1 and the
one-process runs of phase 11 run the loop's step eagerly (`eager_twin`).
Every other train run replays its step graph; `graph_runs` counts the
step graphs' captures, replays and recorded v1 calls apart from the
GraphCaches', and `train_v1` holds a run's v1 runs to 2 a microbatch a
step.

The last lines are one `{"kernels": [...]}` JSON line, the nvidia-smi line
of the card, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
H100 = "NVIDIA H100 80GB HBM3"  # whose dense bf16 peak utils/flops.py holds
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
IMAGE_TOL = 1e-4              # normalized units; both sides are f32
DEPTH_TOL = 1e-3              # metres
DEPTH_DECISION_BAND = 1e-5    # |zv - 0.5| within which decisions may differ
# Served vs. the same model fed by the plain preprocess, in log-depth. The
# inputs agree to ~1e-6, but they are rounded to bf16 and go through bf16
# convs whose algorithm (and so summation order) cuDNN picks per batch
# size: on an H100 the same frames at buckets 1..32 differ from batch 12
# by up to 8.3e-3 (bf16_log_depth_spread_by_bucket below). 2e-2 leaves
# twice that.
SERVE_LOG_TOL = 2e-2
# Phase 7. A DPT checkpoint's bf16 answers move much further than the
# encdec family's when its inputs move by f32 rounding: with its images
# moved by uniform noise of JITTER (the size by which the kernel's and the
# plain preprocess's differ, phase 2: ~1e-6 at most), a 40-step dpt-384
# moved 0.115 in log-depth at most and 0.018 in mean, as far as the kernel-
# against plain-fed answers did (0.102, 0.018). So the models of
# JITTER_HELD are held, in max and in mean, to twice that control,
# measured on the same frames in every run; the others to SERVE_LOG_TOL.
# So are int8 models (phase 10): a per-tensor activation scale puts a value
# that moves by a bf16 rounding on the neighbouring int8 step, 1/127 of the
# tensor's range, where bf16 moves it by 2^-8 of itself (make3d-encdec at
# int8, kernel- against plain-fed: 0.036 at most, 8.7e-4 in mean).
JITTER = 1e-6
JITTER_HELD = ("dpt", "dpt-small")


def jitter_held(model_cfg):
    """Whether a model's same-batch checks are held to its jitter control:
    the DPT family and every int8 model."""
    return model_cfg.name in JITTER_HELD or model_cfg.quant != "none"

# v2 against plain_preprocess_v2: both round the f32 row pass to bf16, and
# the kernel builds its own weights (f32 ulps from triangle_matrix's), so
# they may differ by one bf16 ulp of a row value carried through the column
# weights, or by one bf16 ulp of each column weight of a band times the
# largest row value (fp.v2_error_bound(..., weights_apart=True), per case);
# in mean, far less, since such a flip needs a value within f32 rounding of
# a bf16 rounding boundary.
V2_IMAGE_MEAN_TOL = 1e-4      # normalized units
V2_DEPTH_MEAN_TOL = 1e-3      # metres
# One train step fed by the kernel vs the plain preprocess, same state and
# batch: the inputs agree to f32 summation order, the model rounds to bf16
# (2^-8) after every conv.
STEP_LOSS_RTOL = 1e-2
# After K steps fed by v1 and by v2: v2's inputs carry a bf16 rounding of
# the row pass (~2^-9 relative, the size of the rounding the model applies
# to its input anyway), and K Adam steps carry it on.
K_STEPS = 20
INSTEP_LOSS_RTOL = 5e-2
TRAIN_STEPS, RESUME_STEPS = 40, 50
RAW_HW, MAKE3D_DEPTH_HW, NYU_DEPTH_HW = (480, 640), (305, 55), (480, 640)
# Phase 6. Eval fed by the kernel vs the plain preprocess, same restored
# model and batches: the inputs agree to f32 summation order and the model
# rounds them to bf16, so a metric moves only where an input rounds to the
# other bf16 neighbour. The tolerance lies between the largest such reading
# and that of a control whose image window is one source pixel off
# (`_shifted_window`), which every run checks it fails. Each model has its
# own. DPT's 12 attention blocks carry such a flip further than encdec's
# convs do, and its delta metrics (shares of pixels within a ratio of the
# truth) are reported but not held: at a 40-step checkpoint enough pixels
# sit at those thresholds that rounding alone moved delta1 by 1.2e-2
# relative (0.04% of the pixels), a third of what the control moved it,
# where the other metrics moved 1.2e-4 against the control's 1.6e-2.
# A DPT checkpoint is not the same from run to run (its F.interpolate
# backward sums with atomics), and how far rounding moves its metrics
# varies with it: the plain-fed readings of nine runs lay at 1.4e-4-6.0e-4
# against controls of 1.5e-2-1.6e-2, and one at 2.4e-3 (sq_rel) against a
# control of 5.8e-2. So for the models of JITTER_HELD the tolerance is the
# larger of the preset's and twice the largest move of two jitter controls
# (the plain-fed eval with its images moved by uniform noise of JITTER),
# measured on the same checkpoint and batches in every run; the off-by-one
# control must still fail it. An int8 model (phase 10) is held to its
# preset's tolerance without jitter controls: jittering every pixel moves
# an int8 eval far more than the kernel does (make3d-encdec at int8:
# 5.2e-3 and 7.1e-3 (sq_rel) against the plain-fed 2.0e-4, control
# 1.0e-2); its delta metrics are reported, not held, as DPT's (an int8
# flip moves a pixel by a step of its tensor's range: delta3 moved 2.0e-4
# where the continuous metrics moved 3.1e-5 at most).
EVAL_METRIC_RTOL = {"make3d-encdec": 3e-4, "dpt-384": 2e-3}
EVAL_DELTAS = ("delta1", "delta2", "delta3")
EVAL_JITTER_SEEDS = (0, 1)
EVAL_METRICS_NOT_HELD = {"dpt-384": EVAL_DELTAS}
EVAL_BATCHES = 2
LIVE_FRAMES = 300
# Phase 7: (preset, raw depth grid, steps, resumed to, log/checkpoint/eval
# cadence, warmup steps) of each other model family, each at its preset's
# batch. DPT keeps its preset's warmup (100 steps): with 10, its early
# steps overshoot and leave a model whose bf16 answers jump with inputs
# that move by f32 rounding.
FAMILIES = (("dpt-384", NYU_DEPTH_HW, 30, 40, (10, 15, 15), None),
            ("make3d-multiscale", MAKE3D_DEPTH_HW, 30, 40, (10, 15, 15), 10),
            ("make3d-small", MAKE3D_DEPTH_HW, 20, 25, (5, 10, 10), 10))
FAMILY_LIVE_FRAMES = 30
TRANSCODE_BATCH, TRANSCODE_FRAMES = 8, 64
# Phase 8. NYU-layout scenes (32 train, 16 test: the split of the written
# splits.mat) and Make3D-shaped scenes packed as records; nyu-encdec-aug
# trains SLICE6_STEPS steps at grad_accum ACCUM, then rolls back to
# ROLLBACK_TO and runs to ROLLBACK_STEPS.
NYU_SPLIT, MAKE3D_SPLIT = (32, 16), (32, 16)
ACCUM = 2
SLICE6_STEPS, ROLLBACK_TO, ROLLBACK_STEPS = 40, 20, 30
SLICE6_EVERY = 10          # log, checkpoint and eval cadence
SLICE6_PATIENCE = 2        # early stop after 2 evals without a gain
DPT_ACCUM_STEPS, DISTILL_STEPS, RECORDS_LOOP_STEPS = 10, 20, 20
# Phase 9. make3d-encdec from a device pool of POOL_SCENES Make3D-shaped
# scenes, POOL_STEPS steps at K=1 (eager) and K=POOL_K (CUDA graph
# replays); dpt-384 from phase 8's NYU records, DPT_POOL_STEPS steps at K=1
# (DPT_CONTROL_RUNS times) and K=DPT_K; a window pool of WINDOW_SCENES
# scenes in windows of WINDOW_EXAMPLES, echo WINDOW_EPOCHS, K=WINDOW_K, then
# auto; the host feed and the worker loader (FEED_WORKERS processes) from
# phase 8's Make3D records. The loop's profiler traces PROFILE_STEPS steps
# of each timed run.
POOL_SCENES, POOL_STEPS, POOL_K = 64, 40, 10
DPT_POOL_STEPS, DPT_K, DPT_CONTROL_RUNS = 10, 5, 4
WINDOW_SCENES, WINDOW_EXAMPLES, WINDOW_K, WINDOW_EPOCHS = 96, 32, 4, 2
WINDOW_STEPS, AUTO_STEPS = 24, 16
FEED_STEPS, FEED_WORKERS, PROFILE_STEPS = 40, 2, 10
# A K-step block against K eager steps from one pool stream: the JAX scan
# test's tolerances (tests/test_scan_dispatch.py:41). dpt-384 is held to
# twice the largest gap between its eager runs (its F.interpolate backward
# sums with atomics), and never tighter than these.
GRAPH_PARAM_RTOL, GRAPH_PARAM_ATOL, GRAPH_LOSS_RTOL = 2e-5, 2e-6, 2e-4
# eval --cache-device reads the bytes the host feed reads, in its order.
EVAL_POOL_RTOL = 1e-6
# Phase 10. int8 serving at each preset's serving batch; int8-qat trains
# QAT_STEPS steps through the CLI from the host feed, then QAT_POOL_STEPS
# from a device pool of QAT_POOL_SCENES scenes at K=1 and K=QAT_K (phase
# 9's tolerances) with torch.backends.cudnn.deterministic set. By default
# cuDNN picks f32 conv kernels whose sums may fall in another order from
# run to run (bf16 ones did not, phase 9), and a fake-quant flip carries
# such a rounding on: on an NVIDIA H100 80GB HBM3 at 700 W three K=1 QAT
# runs parted by 1.3e-4-4.3e-3 in loss after 30 steps, as far as a K=10
# run from them. Three artifacts of phase 4's checkpoint: any batch,
# EXPORT_BATCH, int8. An exported program runs the eager program's ops on
# the same weights (cuDNN may still pick another algorithm for a traced
# conv): EXPORT_RTOL relative in linear depth.
QUANT_BATCH = {"make3d-encdec": 32, "dpt-384": 16}
QAT_STEPS, QAT_POOL_STEPS, QAT_K, QAT_POOL_SCENES = 20, 30, 10, 32
EXPORT_BATCH, EXPORT_RTOL = 8, 1e-6
# Phase 12. `info` of each family must count the params its training
# prints; the sweep runs the grid of SWEEP_PARAMS (4 trials of SWEEP_STEPS
# steps, SWEEP_EVAL_BATCHES eval batches each), every trial's peak memory
# within SWEEP_PEAK_RTOL of the first's; the Make3D tree holds TREE_SPLIT
# scenes (train, test) and trains TREE_STEPS steps; each --preprocess-impl
# value trains IMPL_STEPS steps.
INFO_PARAMS = {"make3d-encdec": 1_417_665, "make3d-multiscale": 1_454_082,
               "make3d-small": 21_505, "dpt-384": 23_408_641}
SWEEP_PARAMS = ("train.learning_rate=1e-4,3e-4", "train.loss=si,berhu")
SWEEP_STEPS, SWEEP_EVAL_BATCHES, SWEEP_PEAK_RTOL = 20, 2, 0.10
TREE_SPLIT, TREE_STEPS, IMPL_STEPS = (32, 16), 10, 5
# Phase 13. encdec variants train VARIANT_STEPS steps (warmup
# VARIANT_WARMUP; the mean loss of the last FALL_WINDOW steps must be
# below that of the first); sgd runs momentum SGD_B1 and weight decay
# SGD_WD; the true-scale Make3D tree holds TRUE_SCALE_SPLIT scenes and
# trains TRUE_SCALE_STEPS steps.
VARIANT_STEPS, VARIANT_WARMUP, FALL_WINDOW = 10, 2, 3
SGD_B1, SGD_WD = 0.9, 1e-4
TRUE_SCALE_SPLIT, TRUE_SCALE_STEPS = (32, 16), 10
# In the default mode the matmul DPT's runs still part: cuDNN attention's
# backward sums in no fixed order (torch says so in deterministic mode),
# and so do some of cuDNN's default algorithms for the fusion head's
# channels_last convs. So its default-mode graph run is held as phase 9
# holds "resize" (`dpt_graph_control`). Under
# torch.use_deterministic_algorithms(True), which picks cuDNN attention's
# deterministic algorithm, it repeats bit for bit, and its graph run is
# held there to the fixed GRAPH_* tolerances (in a child process: the
# mode needs CUBLAS_WORKSPACE_CONFIG before the first cuBLAS handle).


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(lines, "nvidia-smi printed no card")
    return lines[0]


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(fp, frames, params, out_hw, depth_mode):
    """(bound_ms, bound_by) of the preprocess function, v1 or v2 alike: the
    larger of the bytes it must move (frames and param rows read once, the
    output written once) over the HBM rate and its multiply-adds on this
    run's bands (fp.band_bounds, as the kernels compute them) over the f32
    rate."""
    b, h_in, w_in, c = frames.shape
    h, w = out_hw
    p = params.float().cpu()
    taps = []
    for n_out, n_in, start, scale in ((h, h_in, p[:, 0], p[:, 1]),
                                      (w, w_in, p[:, 2], p[:, 3])):
        lo, hi = fp.band_bounds(n_out, n_in, start, scale)
        taps.append((hi - lo + 1).clamp(min=0).sum(1))
    accumulators = 2 if depth_mode else c
    flops = float((taps[0] * taps[1]).sum()) * accumulators * 2
    nbytes = (frames.numel() * frames.element_size() + params.numel() * 4
              + b * h * w * c * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, iters=20, warmup=3, attempts=3):
    """Device time per call of `fn` from torch.profiler: the durations of
    the CUDA kernels it launches, summed over `iters` calls, in total and by
    kind ("resample", "photometric" for the port's kernels, else the
    kernel's name). A trace now and then comes back without its device
    activity; it is taken again, up to `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_kind = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if (e.device_type != DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            kind = ("resample" if "band_resample_kernel" in e.name else
                    "photometric" if "photometric_kernel" in e.name else
                    e.name[:60])
            dur = (e.time_range.end - e.time_range.start) / 1e3 / iters
            by_kind[kind] = by_kind.get(kind, 0.0) + dur
        if by_kind:
            break
    check(by_kind, f"the profiler recorded no kernel in {attempts} traces")
    return sum(by_kind.values()), by_kind


def host_ms(torch, fn, iters=50):
    """Host time per call of `fn`: the enqueue, before the closing sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def timings(torch, kernel, plain, plain_iters=20):
    """The kernel's device time per call (torch.profiler; its resample and
    photometric launches apart), the wrapper's time per call with CUDA
    events (the host's gaps included) and on the host's clock, and the
    plain version's with CUDA events."""
    ms, by_kind = device_ms(torch, kernel)
    return dict(ms=ms, resample_ms=by_kind.get("resample", 0.0),
                photometric_ms=by_kind.get("photometric", 0.0),
                event_ms=time_ms(kernel), host_ms=host_ms(torch, kernel),
                plain_ms=time_ms(plain, iters=plain_iters))


def image_case(torch, fp, name, src, params, library, out_hw=(240, 320)):
    """One image case of the v1 kernel: held against plain_preprocess, its
    timings and bound, and with `library` the time of the antialiased
    resize alone through F.interpolate."""
    got = fp.fused_preprocess(src, params, out_hw=out_hw)
    want = fp.plain_preprocess(src, params, out_hw=out_hw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= IMAGE_TOL, f"{name}: max abs err {err} > {IMAGE_TOL}")
    bound_ms, bound_by = bound(fp, src, params, out_hw, False)
    case = dict(
        case=name, max_abs_err=err, tol=IMAGE_TOL,
        photo_frames=int((params[:, 7] > 0.5).sum()),
        **timings(torch,
                  lambda: fp.fused_preprocess(src, params, out_hw=out_hw),
                  lambda: fp.plain_preprocess(src, params, out_hw=out_hw),
                  plain_iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    if library:
        # The resize alone, antialiased, on the frames already in f32.
        case["library_ms"] = interpolate_ms(
            torch, src.permute(0, 3, 1, 2).float(), out_hw)
        case["library_call"] = ("F.interpolate(bilinear, antialias) of "
                                "the f32 frames (resize only)")
    print(json.dumps(case), flush=True)
    return case


def kernel_cases(torch, fp, resize, ref):
    """Phase 2: fused_preprocess vs plain_preprocess on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (32, 480, 640, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    cases = []

    train_gen = torch.Generator(device=dev).manual_seed(16)
    for name, src, params in (
            ("image u8 [32,480,640,3] -> [240,320], identity rows", frames,
             fp.identity_params(32, (480, 640), (240, 320), device=dev)),
            ("image u8 [32,480,640,3] -> [240,320], augment rows", frames,
             fp.augment_params(gen, 32, (480, 640), (240, 320), device=dev)),
            ("image u8 [16,480,640,3] -> [240,320], augment rows (train)",
             frames[:16], fp.augment_params(train_gen, 16, (480, 640),
                                            (240, 320), device=dev))):
        cases.append(image_case(
            torch, fp, name, src, params,
            library="identity" in name or "train" in name))

    # Eval depth: Make3D laser grid with a saturated band and missing
    # pixels; frame 0 is the no-blend probe (constant 50 m, right half 81 m).
    depth = make3d_depth(torch, gen, 16)
    depth[0] = 50.0
    depth[0, :, 27:] = 81.0
    params = fp.identity_params(16, (305, 55), (120, 160), device=dev)
    name = "depth f32 [16,305,55,1] -> [120,160], saturated band"
    case = depth_case(torch, fp, resize, ref, name, depth, params,
                      (120, 160), library=False)
    probe = fp.fused_preprocess(depth, params, out_hw=(120, 160),
                                depth_mode=True)[0, ..., 0]
    check(bool(((probe - 50.0).abs().lt(1e-3) | (probe == 0)).all()),
          f"{name}: saturated pixels blended into valid ones")
    cases.append(case)
    return cases


# The encdec train step's three norms at b16 (240x320 in): (B, C, H, W).
GN_SHAPES = ((16, 64, 60, 80), (16, 128, 30, 40), (16, 256, 15, 20))
GN_GROUPS = 8
GN_EPS = 1e-6


def group_norm_cases(torch, card):
    """Phase 2b: the NHWC GroupNorm + ReLU kernel (ops/group_norm.py) at the
    train step's shapes in bf16, forward and backward, against the plain
    version (the Stage expression it replaced, through autograd; dy zeroed
    where the two ReLU masks part, at outputs ~0): y within
    one bf16 rounding (rtol 2^-7, atol 1e-5), dx within that plus 1e-4 of
    its largest value, dgamma and dbeta within 1e-5 of the largest channel
    sum of the terms' magnitudes (tests/test_torch_group_norm.py gives the
    reasons). Times the kernel's two passes a direction on the device
    (torch.profiler) and with CUDA events, the plain version's forward and
    forward + backward with CUDA events and on the device, and beside them
    `F.group_norm` on the bf16 tensor + ReLU (`library_ms`, a yardstick the
    port never calls). Bound: x read and y written once forward; dy, x, y
    read and dx written once backward."""
    import torch.nn.functional as F

    from ann3depth_tpu_torch.ops import group_norm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    cases = []
    for shape in GN_SHAPES:
        b, c, h, w = shape
        x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        weight = 1 + 0.5 * torch.randn(c, generator=gen, device=dev)
        bias = 0.5 * torch.randn(c, generator=gen, device=dev)
        args = (GN_GROUPS, GN_EPS)
        # Where a pre-activation lies within an f32 rounding of 0 the two
        # ReLU masks may part, and the element's dy passes on one side
        # only: dy is zeroed there (about one element in a million).
        with torch.no_grad():
            parted = ((gn.group_norm_relu(x, weight, bias, *args) > 0)
                      != (gn.plain_group_norm_relu(x, weight, bias, *args)
                          > 0))
        check(int(parted.sum()) <= 2 + x.numel() // 100_000,
              f"group_norm {shape}: {int(parted.sum())} ReLU decisions part")
        dy = torch.where(parted, torch.zeros_like(dy), dy)

        def run(fn):
            xs, ws, bs = (t.detach().clone().requires_grad_()
                          for t in (x, weight, bias))
            y = fn(xs, ws, bs, *args)
            return (y.detach(), *torch.autograd.grad(y, (xs, ws, bs), dy))

        launches = (gn.group_norm_relu.launches,
                    gn.group_norm_relu_backward.launches)
        got = run(gn.group_norm_relu)
        check((gn.group_norm_relu.launches - launches[0],
               gn.group_norm_relu_backward.launches - launches[1]) == (1, 1),
              f"group_norm {shape}: the kernels did not run once each")
        want = run(gn.plain_group_norm_relu)
        torch.cuda.synchronize()
        y, dx, dw, db = (t.float() for t in got)
        y_w, dx_w, dw_w, db_w = (t.float() for t in want)
        xg = x.float().reshape(b, GN_GROUPS, -1)
        var, mean = torch.var_mean(xg, dim=-1, correction=0, keepdim=True)
        xhat = ((xg - mean) * (var + GN_EPS).rsqrt()).reshape(shape)
        dz = torch.where(y_w > 0, dy.float(), torch.zeros_like(y_w))
        errs = dict(
            y=float(((y - y_w).abs() - 2.0 ** -7 * y_w.abs()).max()),
            dx=float(((dx - dx_w).abs() - 2.0 ** -7 * dx_w.abs()).max()),
            dgamma=float((dw - dw_w).abs().max()),
            dbeta=float((db - db_w).abs().max()))
        tols = dict(y=1e-5, dx=1e-4 * float(dx_w.abs().max()),
                    dgamma=1e-5 * float((dz * xhat).abs().sum((0, 2, 3))
                                        .max()),
                    dbeta=1e-5 * float(dz.abs().sum((0, 2, 3)).max()))
        for k, err in errs.items():
            check(err <= tols[k], f"group_norm {shape}: {k} off by {err} "
                  f"beyond one bf16 rounding (tolerance {tols[k]})")

        y, mean, rstd = torch.ops.ann3depth.group_norm_relu(x, weight, bias,
                                                            *args)

        def fwd():
            return torch.ops.ann3depth.group_norm_relu(x, weight, bias, *args)

        def bwd():
            return torch.ops.ann3depth.group_norm_relu_backward(
                dy, x, y, mean, rstd, weight, GN_GROUPS)

        def plain_fwd():
            with torch.no_grad():
                return gn.plain_group_norm_relu(x, weight, bias, *args)

        weight_bf16, bias_bf16 = weight.bfloat16(), bias.bfloat16()

        def library_fwd():
            with torch.no_grad():
                return F.relu(F.group_norm(x, GN_GROUPS, weight_bf16,
                                           bias_bf16, GN_EPS))

        fwd_ms, fwd_by = device_ms(torch, fwd)
        bwd_ms, bwd_by = device_ms(torch, bwd)
        plain_dev_ms, _ = device_ms(torch, lambda: run(
            gn.plain_group_norm_relu))
        nbytes = x.numel() * x.element_size()
        case = dict(
            case=f"group_norm_relu bf16 {list(shape)}, {GN_GROUPS} groups",
            max_err=errs, tol=tols, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
            fwd_kernels=fwd_by, bwd_kernels=bwd_by,
            fwd_event_ms=time_ms(fwd), bwd_event_ms=time_ms(bwd),
            fwd_bwd_event_ms=time_ms(lambda: run(gn.group_norm_relu)),
            fwd_bound_ms=2 * nbytes / HBM_BYTES_PER_S * 1e3,
            bwd_bound_ms=4 * nbytes / HBM_BYTES_PER_S * 1e3,
            plain_ms=time_ms(plain_fwd),
            plain_fwd_bwd_ms=time_ms(lambda: run(gn.plain_group_norm_relu)),
            plain_fwd_bwd_device_ms=plain_dev_ms,
            library_ms=time_ms(library_fwd),
            library_fwd_bwd_ms=time_ms(lambda: run(
                lambda xs, ws, bs, *_: F.relu(F.group_norm(
                    xs, GN_GROUPS, ws.bfloat16(), bs.bfloat16(), GN_EPS)))),
            library_call="F.group_norm on the bf16 tensor (bf16 weight and "
                         "bias: torch's CUDA group_norm takes one dtype), "
                         "then F.relu",
            card=card)
        print(json.dumps(case), flush=True)
        cases.append(case)
    return cases


# DPT-Large's five align_corners x2 upsamples a b16 step (per image: h, w,
# C in), refinenet4 ... refinenet1, then the head.
UP_SHAPES = ((16, 12, 12, 256), (16, 24, 24, 256), (16, 48, 48, 256),
             (16, 96, 96, 256), (16, 192, 192, 128))


def _up_reference(torch, x, g):
    """F.interpolate(align_corners=True) x2 in f64 on NCHW views: the
    output, the input's gradient and its sum of |weight * grad|, NHWC."""
    import torch.nn.functional as F

    xs = x.double().permute(0, 3, 1, 2).requires_grad_()
    y = F.interpolate(xs, scale_factor=2, mode="bilinear", align_corners=True)
    gd = g.double().permute(0, 3, 1, 2)
    dx, = torch.autograd.grad(y, xs, gd)
    mag, = torch.autograd.grad(y, xs, gd.abs())
    return (y.detach().permute(0, 2, 3, 1), dx.permute(0, 2, 3, 1),
            mag.permute(0, 2, 3, 1))


def _up_errors(got, x, want):
    """Each output's error beyond what one bf16 rounding and a chain of f32
    roundings allow (tests/test_torch_upsample_aligned.py gives the
    reasons): > 0 where a value is out of bounds."""
    y_ref, dx_ref, mag = want
    y, dx = (t.double() for t in got)
    return dict(
        y=float(((y - y_ref).abs() - 2.0 ** -8 * y_ref.abs()
                 - 2.0 ** -21 * float(x.double().abs().max())).max()),
        dx=float(((dx - dx_ref).abs() - 2.0 ** -8 * dx_ref.abs()
                  - 2.0 ** -18 * mag).max()))


def upsample_cases(torch, np, fp, card):
    """Phase 2c: the align_corners upsample kernels (ops/resize.py) at
    DPT-Large's five b16 shapes in bf16, forward and backward, held to
    F.interpolate in f64 within one bf16 rounding; their device time
    (torch.profiler) and CUDA-event time a call beside the (hi, lo) GEMM
    pair (`_PairUpsample`, the CPU path, run here on the card) and
    `F.interpolate` (`library_ms`, a yardstick the port never calls), and
    the bound: input read and output written once each way. Then the
    dpt-large preset through `train.loop.train` on the main path, as its
    eager twin and replaying its step graph (`dpt_large_run`): the
    kernels' launches and their kernels by name in the traced steps and
    replays, five each way a step. Returns the cases and the two runs."""
    import torch.nn.functional as F

    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
    from ann3depth_tpu_torch.ops import resize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cases = []
    for shape in UP_SHAPES:
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device=dev).bfloat16()
        g = torch.randn((b, 2 * h, 2 * w, c), generator=gen,
                        device=dev).bfloat16()
        ay = resize._aligned_upsample_matrix(h, 2, x.dtype, dev)
        ax = resize._aligned_upsample_matrix(w, 2, x.dtype, dev)

        def pair(xs, _factor):
            return resize._PairUpsample.apply(xs, *ay, *ax)

        def interp(xs, _factor):
            return F.interpolate(xs.permute(0, 3, 1, 2), scale_factor=2,
                                 mode="bilinear", align_corners=True
                                 ).permute(0, 2, 3, 1)

        def run(fn):
            xs = x.detach().clone().requires_grad_()
            y = fn(xs, 2)
            return y.detach(), torch.autograd.grad(y, xs, g)[0]

        launches = (resize.upsample_aligned_nhwc.launches,
                    resize.upsample_aligned_nhwc_backward.launches)
        got = run(resize.upsample_aligned_nhwc)
        check((resize.upsample_aligned_nhwc.launches - launches[0],
               resize.upsample_aligned_nhwc_backward.launches
               - launches[1]) == (1, 1),
              f"upsample {shape}: the kernels did not run once each")
        want = _up_reference(torch, x, g)
        errs = _up_errors(got, x, want)
        for k, err in errs.items():
            check(err <= 0, f"upsample {shape}: {k} off by {err} beyond one "
                  f"bf16 rounding")
        pair_errs = _up_errors(run(pair), x, want)
        interp_errs = _up_errors(run(interp), x, want)
        del want

        def timers(fn):
            """fn's forward without autograd, and its backward."""
            xs = x.detach().clone().requires_grad_()
            y = fn(xs, 2)

            def fwd():
                with torch.no_grad():
                    return fn(x, 2)

            def bwd():
                return torch.autograd.grad(y, xs, g, retain_graph=True)

            return fwd, bwd

        fwd, bwd = timers(resize.upsample_aligned_nhwc)
        pair_fwd, pair_bwd = timers(pair)
        lib_fwd, lib_bwd = timers(interp)
        fwd_ms, fwd_by = device_ms(torch, fwd)
        bwd_ms, bwd_by = device_ms(torch, bwd)
        pair_fwd_dev, _ = device_ms(torch, pair_fwd)
        pair_bwd_dev, _ = device_ms(torch, pair_bwd)
        nbytes = 5 * x.numel() * x.element_size()
        case = dict(
            case=f"upsample_aligned_nhwc bf16 {list(shape)} x2",
            max_err_over_tol=errs, pair_err_over_tol=pair_errs,
            interpolate_err_over_tol=interp_errs,
            fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_kernels=fwd_by,
            bwd_kernels=bwd_by, fwd_event_ms=time_ms(fwd),
            bwd_event_ms=time_ms(bwd),
            fwd_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bwd_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            pair_fwd_ms=pair_fwd_dev, pair_bwd_ms=pair_bwd_dev,
            pair_fwd_event_ms=time_ms(pair_fwd),
            pair_bwd_event_ms=time_ms(pair_bwd),
            library_fwd_ms=time_ms(lib_fwd), library_bwd_ms=time_ms(lib_bwd),
            library_call="F.interpolate(bilinear, align_corners=True) on "
                         "the NCHW view (channels_last), and its backward",
            card=card)
        print(json.dumps(case), flush=True)
        cases.append(case)
        del x, g, fwd, bwd, pair_fwd, pair_bwd, lib_fwd, lib_bwd

    with tempfile.TemporaryDirectory() as tmp:
        scenes = _InMemory(np, SyntheticDepthDataset(
            n=DPTL_SCENES, img_hw=RAW_HW, depth_hw=MAKE3D_DEPTH_HW, seed=0))
        runs = {kind: dpt_large_run(torch, fp, scenes, tmp, kind == "graph")
                for kind in ("eager", "graph")}
    print("dpt-large train upsamples: " + json.dumps(dict(runs, card=card)),
          flush=True)
    return cases, runs


# Phase 2c's DPT-Large train runs: K=1 steps of the dpt-large preset (b16)
# from a device pool of synthetic scenes, with the loop's profiler over
# steps 5-7 (train/loop.py).
DPTL_SCENES, DPTL_STEPS, DPTL_PROFILE_STEPS = 32, 8, 3
UP_PER_STEP = dict(fwd=5, bwd=5)  # four fusion blocks and the head
UPDATE_PER_STEP = dict(sumsq=1, update=1)  # the norm, then the update


def upsample_trace(path, steps):
    """DPT-Large's upsamples in one Chrome trace of the loop's profiler
    window of `steps` steps: the kernels' launches by name a traced step
    and in each graph replay (its kernels carry the correlation id of its
    graph launch), the kernels' distinct names, and the aten ops of the
    (hi, lo) pair (`aten::bmm`, `aten::baddbmm`) and of F.interpolate
    (`upsample_bilinear2d`, op or kernel); the update's kernels
    (csrc/adamw_clip.cu) the same way, and the step's kernels, foreach
    (`multi_tensor_apply`) kernels and `pow` kernels a traced step."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"]

    def ups(names):
        return dict(fwd=sum("upsample_aligned_nhwc_fwd" in n for n in names),
                    bwd=sum("upsample_aligned_nhwc_bwd" in n for n in names))

    def updates(names):
        return dict(sumsq=sum("adamw_clip_sumsq" in n for n in names),
                    update=sum("adamw_clip_update" in n for n in names))

    by_launch = {}
    for e in kernels:
        by_launch.setdefault(e.get("args", {}).get("correlation"),
                             []).append(e["name"])
    launches = [e.get("args", {}).get("correlation")
                for e in sorted(events, key=lambda e: e["ts"])
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "GraphLaunch" in e["name"]]
    names = [e["name"] for e in kernels]
    total = ups(names)
    return dict(
        traced_steps=steps,
        per_step={k: v / steps for k, v in total.items()},
        per_replay=[ups(by_launch.get(c, [])) for c in launches],
        names=sorted({n for n in names if "upsample_aligned_nhwc" in n}),
        update_per_step={k: v / steps for k, v in updates(names).items()},
        update_per_replay=[updates(by_launch.get(c, [])) for c in launches],
        update_names=sorted({n for n in names if "adamw_clip_" in n}),
        multi_tensor_apply_per_step=sum(
            "multi_tensor_apply" in n for n in names) / steps,
        pow_per_step=sum("pow_tensor" in n for n in names) / steps,
        kernels_per_step=len(names) / steps,
        aten_bmm=ops.count("aten::bmm"),
        aten_baddbmm=ops.count("aten::baddbmm"),
        upsample_bilinear2d=sum("upsample_bilinear2d" in n
                                for n in ops + names))


def dpt_large_run(torch, fp, scenes, tmp, graphed):
    """One `train.loop.train` run of the dpt-large preset (b16, K=1,
    DPTL_STEPS steps, the device pool, as the benchmark's dptl.train.pool
    runs it), replaying its step graph or (`graphed` False) as the eager
    twin, with both upsample counters set to 0 just before it: the
    counters (UP_PER_STEP an eager step; a step graph's capture and
    replays count nothing), the step graphs, the logged losses, and
    `upsample_trace` of the loop's profiler window: UP_PER_STEP kernels a
    traced eager step and in every replay but the window's first (which
    may lose its first kernels to the profiler), no op of the pair and
    none of F.interpolate. The update's two kernels are held the same way,
    UPDATE_PER_STEP."""
    import dataclasses
    import glob

    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.ops import adamw_clip, resize
    from ann3depth_tpu_torch.train import loop

    kind = "graph" if graphed else "eager"
    work = f"{tmp}/dptl_{kind}"
    cfg = get_config("dpt-large")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, datasets=("make3d",),
                                      cache_device=True),
        train=dataclasses.replace(
            cfg.train, steps=DPTL_STEPS, log_every=4, checkpoint_every=0,
            eval_every=0, ckpt_dir=f"{work}/ckpt",
            profile_dir=f"{work}/trace", profile_steps=DPTL_PROFILE_STEPS))
    fwd = resize.upsample_aligned_nhwc
    bwd = resize.upsample_aligned_nhwc_backward
    fwd.launches = bwd.launches = 0
    adamw_clip.adamw_clip_sumsq.launches = 0
    adamw_clip.adamw_clip_update.launches = 0
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as seen, \
            contextlib.nullcontext() if graphed else eager_twin():
        state, last = loop.train(cfg, workdir=work, dataset=scenes,
                                 progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fwd=fwd.launches, bwd=bwd.launches)
    update_launches = dict(sumsq=adamw_clip.adamw_clip_sumsq.launches,
                           update=adamw_clip.adamw_clip_update.launches)
    eager_steps = DPTL_STEPS - seen["steps_replayed"]
    with open(f"{work}/metrics.jsonl") as f:
        logged = [(r["step"], r["loss"]) for r in map(json.loads, f)
                  if "loss" in r]
    first, end = _traced_steps(DPTL_STEPS, 1, DPTL_PROFILE_STEPS)
    traces = glob.glob(f"{work}/trace/*.json")
    check(len(traces) == 1, f"dpt-large {kind}: trace files {traces}")
    traced = upsample_trace(traces[0], end - first)
    del state
    torch.cuda.empty_cache()
    label = f"dpt-large train {kind}"
    check(seen["steps_captured"] == int(graphed)
          and eager_steps == (1 if graphed else DPTL_STEPS),
          f"{label}: step graphs {seen}")
    check(launches == {k: n * eager_steps for k, n in UP_PER_STEP.items()},
          f"{label}: upsample launches {launches} in {eager_steps} eager "
          f"steps, {UP_PER_STEP} a step expected")
    check(graphed or traced["per_step"] == UP_PER_STEP,
          f"{label}: upsample kernels a traced step {traced['per_step']}")
    check(not graphed or (traced["per_replay"] and all(
        r == UP_PER_STEP for r in traced["per_replay"][1:])),
          f"{label}: upsample kernels in the traced replays "
          f"{traced['per_replay']}")
    check(traced["aten_baddbmm"] == traced["upsample_bilinear2d"] == 0,
          f"{label}: the pair's or F.interpolate's ops in the trace: "
          f"{traced}")
    check(update_launches == {k: n * eager_steps
                              for k, n in UPDATE_PER_STEP.items()},
          f"{label}: update launches {update_launches} in {eager_steps} "
          f"eager steps, {UPDATE_PER_STEP} a step expected")
    check(graphed or traced["update_per_step"] == UPDATE_PER_STEP,
          f"{label}: update kernels a traced step "
          f"{traced['update_per_step']}")
    check(not graphed or (traced["update_per_replay"] and all(
        r == UPDATE_PER_STEP for r in traced["update_per_replay"][1:])),
          f"{label}: update kernels in the traced replays "
          f"{traced['update_per_replay']}")
    check(all(math.isfinite(loss) for _, loss in logged),
          f"{label}: logged losses {logged}")
    return dict(steps=DPTL_STEPS, eager_steps=eager_steps,
                steps_captured=seen["steps_captured"],
                steps_replayed=seen["steps_replayed"], launches=launches,
                update_launches=update_launches, trace=traced,
                logged=logged, seconds=seconds)


def dpt_large_leaves():
    """The shapes of DPT-Large's 360 leaves (341,848,257 params, its
    position embedding at 384x384's 577 tokens), from the model on the
    meta device."""
    import torch

    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.models import registry

    with torch.device("meta"):
        model = registry.build(get_config("dpt-large").model)
    return [(1, 577, 1024) if name == "pos_embed" else tuple(p.shape)
            for name, p in model.named_parameters()]


def adamw_clip_cases(torch, card, clip_norm=1.0, weight_decay=1e-2):
    """Phase 2d: the update's kernels (ops/adamw_clip.py) at DPT-Large's
    leaves. Held: 3 updates of `ClippedAdamW.clipped_step` against torch's
    capturable foreach AdamW after `global_norm` and the clip, given
    torch's norm (p, m, v and the step counts bit for bit,
    tests/test_torch_adamw_clip.py gives the reasons), and the kernels' own
    norm within rel 1e-6. Timed: the update's device time a call
    (torch.profiler, by kernel) and its CUDA-event time, eager and
    replayed from a CUDA graph (as the step graph replays it); the same of
    the port's path before the kernels (`torch_path`) and of torch's fused
    AdamW after `_foreach_norm` and `_foreach_mul_` (`library`, a
    yardstick the port never calls); the plain version's event time; the
    bound. Returns the case."""
    from ann3depth_tpu_torch.ops import adamw_clip
    from ann3depth_tpu_torch.train import step as steplib

    dev = torch.device("cuda")
    shapes = dpt_large_leaves()
    n_params = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(23)
    grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
              capturable=True)

    def leaves(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.nn.Parameter(torch.randn(s, generator=g, device=dev))
                for s in shapes]

    def torch_step(opt, params, norm=None):
        """global_norm, the clip by `norm` (else its own) and `opt.step()`:
        the port's update before the kernels."""
        gs = [p.grad for p in params]
        own = steplib.global_norm(gs)
        torch._foreach_mul_(gs, adamw_clip.clip_factor(
            own if norm is None else norm, clip_norm))
        opt.step()
        return own

    mine, theirs = leaves(24), leaves(24)
    ours = steplib.ClippedAdamW(mine, lr=torch.full((), 1e-4, device=dev),
                                **kw)
    ref = torch.optim.AdamW(theirs, lr=torch.full((), 1e-4, device=dev),
                            foreach=True, **kw)
    norm_rel = 0.0
    for s in range(3):
        step_grads = [g * (s + 1) for g in grads]
        for p, g in zip(mine, step_grads):
            p.grad = g
        for p, g in zip(theirs, step_grads):
            p.grad = g.clone()
        own = adamw_clip.adamw_clip_sumsq(step_grads)
        norm = torch_step(ref, theirs)
        ours.clipped_step(clip_norm, norm=norm)
        norm_rel = max(norm_rel, abs(float(own) / float(norm) - 1))
    torch.cuda.synchronize()
    differ = {}
    for key in ("param", "exp_avg", "exp_avg_sq", "step"):
        differ[key] = sum(
            int((a.detach() if key == "param" else ours.state[a][key])
                .ne(b.detach() if key == "param" else ref.state[b][key])
                .sum()) for a, b in zip(mine, theirs))
    check(norm_rel <= 1e-6, f"adamw_clip: norm off by rel {norm_rel}")
    check(not any(differ.values()),
          f"adamw_clip: elements that differ from torch's {differ}")
    del ref, theirs, step_grads
    torch.cuda.empty_cache()

    def graph_ms(fn):
        """fn captured into a CUDA graph, its replay's CUDA-event time."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return time_ms(graph.replay), graph

    for p, g in zip(mine, grads):
        p.grad = g

    def kernels():
        return ours.clipped_step(clip_norm)

    ms, by_kernel = device_ms(torch, kernels)
    graph_replay_ms, graph = graph_ms(kernels)
    del graph
    case = dict(
        case=f"adamw_clip f32 {len(shapes)} leaves, {n_params} params, "
             f"clip {clip_norm}, weight decay {weight_decay}",
        leaves=len(shapes), params=n_params, norm_rel_err=norm_rel,
        elements_differ=differ, ms=ms,
        kernels={k[:60]: v for k, v in by_kernel.items()},
        event_ms=time_ms(kernels), graph_ms=graph_replay_ms,
        host_ms=host_ms(torch, kernels),
        bound_ms=32 * n_params / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    states = [ours.state[p] for p in mine]
    steps_ = [st["step"] for st in states]
    lr = ours.param_groups[0]["lr"]
    plain_params = [p.detach() for p in mine]

    def plain():
        norm = adamw_clip.plain_sumsq(grads)
        adamw_clip.plain_update(
            plain_params, grads, [st["exp_avg"] for st in states],
            [st["exp_avg_sq"] for st in states], steps_, lr, norm,
            clip_norm, 0.9, 0.999, 1e-8, weight_decay)

    case["plain_ms"] = time_ms(plain, iters=3, warmup=1)
    del ours, states, steps_, plain_params
    torch.cuda.empty_cache()

    theirs = leaves(24)
    for p, g in zip(theirs, grads):
        p.grad = g.clone()
    ref = torch.optim.AdamW(theirs, lr=torch.full((), 1e-4, device=dev),
                            foreach=True, **kw)

    def torch_path():
        return torch_step(ref, theirs)

    case["torch_path_ms"], _ = device_ms(torch, torch_path, iters=5)
    case["torch_path_event_ms"] = time_ms(torch_path, iters=5)
    case["torch_path_graph_ms"], graph = graph_ms(torch_path)
    del ref, graph
    torch.cuda.empty_cache()
    fused = torch.optim.AdamW(theirs, lr=torch.full((), 1e-4, device=dev),
                              fused=True, **kw)

    def library():
        gs = [p.grad for p in theirs]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        torch._foreach_mul_(gs, adamw_clip.clip_factor(norm, clip_norm))
        fused.step()

    case["library_ms"] = time_ms(library)
    case["library_device_ms"], _ = device_ms(torch, library)
    case["library_graph_ms"], graph = graph_ms(library)
    case["library_call"] = ("torch.optim.AdamW(fused=True, capturable=True) "
                            "after torch._foreach_norm and _foreach_mul_")
    case["card"] = card
    del fused, theirs, graph, grads, mine
    torch.cuda.empty_cache()
    print("adamw_clip: " + json.dumps(case), flush=True)
    return case


def make3d_depth(torch, gen, b):
    """Make3D-like laser grids [b,305,55,1]: uniform 1-60 m, a saturated
    band (81 m, over the cap) and missing pixels."""
    depth = 1.0 + 59.0 * torch.rand((b, 305, 55, 1), device="cuda",
                                    generator=gen)
    depth[:, :, 20:26] = 81.0
    depth[:, ::7, ::5] = 0.0
    return depth


def nyu_depth(torch, gen, b):
    """NYU-shaped depth [b,480,640,1]: uniform 0.5-10 m, missing pixels."""
    depth = 0.5 + 9.5 * torch.rand((b, 480, 640, 1), device="cuda",
                                   generator=gen)
    depth[:, ::7, ::5] = 0.0
    return depth


def interpolate_ms(torch, x, out_hw):
    """Device time of the antialiased bilinear resize alone through
    F.interpolate, on f32 operands built beforehand: the NHWC maps as an
    NCHW view (channels_last), as the kernels read them."""
    import torch.nn.functional as F

    return device_ms(torch, lambda: F.interpolate(
        x, size=out_hw, mode="bilinear", antialias=True,
        align_corners=False))[0]


def depth_case(torch, fp, resize, ref, name, depth, params, out_hw,
               library=True):
    """One depth case of the v1 kernel: held against plain_preprocess (the
    validity decisions may differ only within DEPTH_DECISION_BAND of zv =
    0.5, the values elsewhere within DEPTH_TOL), its timings and bound, and
    with `library` the resize of the two maps it resamples (d*v and v)
    through F.interpolate."""
    b, h_in, w_in, _ = depth.shape
    h, w = out_hw
    got = fp.fused_preprocess(depth, params, out_hw=out_hw, depth_mode=True)
    want = fp.plain_preprocess(depth, params, out_hw=out_hw,
                               depth_mode=True)
    torch.cuda.synchronize()
    v = ((depth > ref.DEPTH_EPS) & (depth <= ref.MAKE3D_DEPTH_CAP)).float()
    ay = resize.triangle_matrix(h, h_in, params[:, 0], params[:, 1])
    ax = resize.triangle_matrix(w, w_in, params[:, 2], params[:, 3])
    zv = torch.einsum("bpw,bowc->bopc", ax,
                      torch.einsum("boh,bhwc->bowc", ay, v))
    differ = (got > 0) != (want > 0)
    check(bool((zv[differ] - 0.5).abs().le(DEPTH_DECISION_BAND).all()),
          f"{name}: validity decisions differ away from zv = 0.5")
    err = float((got[~differ] - want[~differ]).abs().max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= DEPTH_TOL, f"{name}: max abs err {err} > {DEPTH_TOL}")
    bound_ms, bound_by = bound(fp, depth, params, out_hw, True)
    case = dict(
        case=name, max_abs_err=err, tol=DEPTH_TOL,
        decisions_differ=int(differ.sum()),
        decision_band=DEPTH_DECISION_BAND,
        **timings(torch,
                  lambda: fp.fused_preprocess(depth, params, out_hw=out_hw,
                                              depth_mode=True),
                  lambda: fp.plain_preprocess(depth, params, out_hw=out_hw,
                                              depth_mode=True)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    if library:
        x = torch.cat([depth * v, v], dim=3).permute(0, 3, 1, 2)
        case["library_ms"] = interpolate_ms(torch, x, out_hw)
        case["library_call"] = ("F.interpolate(bilinear, antialias) of d*v "
                                "and v as two f32 channels (resize only)")
    print(json.dumps(case), flush=True)
    return case


def family_specs(torch, fp):
    """The kernels' cases at the shapes of the other model families, as
    (name, frames, params, out_hw, depth_mode): dpt-384 (480x640 frames and
    NYU-shaped depth to 384x384, Make3D's grid upsampled on both axes to
    384x384) and make3d-small (b1 frames to 240x320, Make3D's grid to
    30x40: a 21-tap row band)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    frames = torch.randint(0, 256, (16, 480, 640, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    nyu, grid = nyu_depth(torch, gen, 16), make3d_depth(torch, gen, 16)
    ident, aug = fp.identity_params, fp.augment_params
    return (
        ("image u8 [16,480,640,3] -> [384,384], identity rows (dpt)",
         frames, ident(16, RAW_HW, (384, 384), device=dev), (384, 384),
         False),
        ("image u8 [16,480,640,3] -> [384,384], augment rows (dpt)",
         frames, aug(gen, 16, RAW_HW, (384, 384), device=dev), (384, 384),
         False),
        ("image u8 [1,480,640,3] -> [240,320], augment rows (small b1)",
         frames[:1], aug(gen, 1, RAW_HW, (240, 320), device=dev),
         (240, 320), False),
        ("depth f32 [16,480,640,1] -> [384,384], augment rows (dpt, NYU "
         "shape)", nyu, aug(gen, 16, NYU_DEPTH_HW, (384, 384), device=dev),
         (384, 384), True),
        ("depth f32 [16,305,55,1] -> [384,384], augment rows (dpt, Make3D "
         "grid, upsampled on both axes)", grid,
         aug(gen, 16, MAKE3D_DEPTH_HW, (384, 384), device=dev), (384, 384),
         True),
        ("depth f32 [1,305,55,1] -> [30,40], identity rows (small b1, "
         "21-tap row band)", grid[:1],
         ident(1, MAKE3D_DEPTH_HW, (30, 40), device=dev), (30, 40), True))


def slice6_specs(torch, fp):
    """The v1 kernel's cases at the shapes the phase-8 paths give it:
    nyu-encdec-aug's microbatch of 8 under grad_accum 2, its NYU depth
    480x640 -> 120x160 and its frames 480x640 -> 240x320, augment rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    frames = torch.randint(0, 256, (8, 480, 640, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    aug = fp.augment_params
    return (
        ("depth f32 [8,480,640,1] -> [120,160], augment rows (nyu-encdec-"
         "aug microbatch, NYU shape)", nyu_depth(torch, gen, 8),
         aug(gen, 8, NYU_DEPTH_HW, (120, 160), device=dev), (120, 160),
         True),
        ("image u8 [8,480,640,3] -> [240,320], augment rows (microbatch "
         "of 8)", frames, aug(gen, 8, RAW_HW, (240, 320), device=dev),
         (240, 320), False))


def parallel_specs(torch, fp):
    """The v1 kernel's cases at the per-rank shapes of phase 11's data
    parallelism (b16 on two ranks: b8 each): make3d-encdec's Make3D grid
    to 120x160, and dpt-384's frames and NYU depth to 384x384 (its image
    b8 at 240x320 is slice6's), augment rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    frames = torch.randint(0, 256, (8, 480, 640, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    aug = fp.augment_params
    return (
        ("depth f32 [8,305,55,1] -> [120,160], augment rows (make3d-encdec "
         "b16 on two ranks)", make3d_depth(torch, gen, 8),
         aug(gen, 8, MAKE3D_DEPTH_HW, (120, 160), device=dev), (120, 160),
         True),
        ("image u8 [8,480,640,3] -> [384,384], augment rows (dpt-384 b16 "
         "on two data ranks)", frames,
         aug(gen, 8, RAW_HW, (384, 384), device=dev), (384, 384), False),
        ("depth f32 [8,480,640,1] -> [384,384], augment rows (dpt-384 b16 "
         "on two data ranks, NYU shape)", nyu_depth(torch, gen, 8),
         aug(gen, 8, NYU_DEPTH_HW, (384, 384), device=dev), (384, 384),
         True))


def family_cases(torch, fp, resize, ref, specs):
    """Phase 2, the v1 kernel on `family_specs`, each case against
    F.interpolate at its shape."""
    return [depth_case(torch, fp, resize, ref, name, x, params, out_hw)
            if depth_mode else
            image_case(torch, fp, name, x, params, library=True,
                       out_hw=out_hw)
            for name, x, params, out_hw, depth_mode in specs]


def v2_cases(torch, fp, ref):
    """Phase 2, v2: fused_preprocess_v2 vs plain_preprocess_v2 at the train
    shapes (b16), against the cuBLAS pair on prebuilt operands."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randint(0, 256, (16, 480, 640, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    depth = make3d_depth(torch, gen, 16)
    return v2_held(torch, fp, ref, (
        ("v2 image u8 [16,480,640,3] -> [240,320], identity rows",
         frames, fp.identity_params(16, (480, 640), (240, 320), device=dev),
         (240, 320), False),
        ("v2 image u8 [16,480,640,3] -> [240,320], augment rows (train)",
         frames, fp.augment_params(gen, 16, (480, 640), (240, 320),
                                   device=dev), (240, 320), False),
        ("v2 depth f32 [16,305,55,1] -> [120,160], saturated band",
         depth, fp.augment_params(gen, 16, (305, 55), (120, 160),
                                  device=dev), (120, 160), True)),
        library="bmm")


def v2_held(torch, fp, ref, specs, library):
    """Each (name, frames, params, out_hw, depth_mode) of `specs` through
    the v2 kernel, held against plain_preprocess_v2 within
    v2_error_bound(..., weights_apart=True) and the mean tolerances, with
    its timings, bound and library time: `library` "bmm" times cuBLAS's
    f32 row product and bf16 column product on prebuilt Ay/T, "interpolate"
    the antialiased F.interpolate of the maps it resamples. The wrapper
    must build no Ay or T on the card."""
    cases = []
    for name, x, params, out_hw, depth_mode in specs:
        b, h_in, w_in, c = x.shape
        operand_builds = []
        v2_operands = fp.v2_operands
        fp.v2_operands = lambda *a, **k: operand_builds.append(a)
        try:
            got = fp.fused_preprocess_v2(x, params, out_hw=out_hw,
                                         depth_mode=depth_mode)
        finally:
            fp.v2_operands = v2_operands
        check(not operand_builds,
              f"{name}: the CUDA path built the Ay/T operands")
        want = fp.plain_preprocess_v2(x, params, out_hw=out_hw,
                                      depth_mode=depth_mode)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        ay, t = fp.v2_operands(params, (h_in, w_in), out_hw, c)
        tol = fp.v2_error_bound(t, depth_mode=depth_mode,
                                weights_apart=True)
        x32 = x.reshape(b, h_in, w_in * c).float()
        if depth_mode:
            v = ((x32 > ref.DEPTH_EPS)
                 & (x32 <= ref.MAKE3D_DEPTH_CAP)).float()
            zv = torch.bmm(torch.bmm(ay, v).to(torch.bfloat16).float(),
                           t.float()).reshape(got.shape)
            differ = (got > 0) != (want > 0)
            check(bool((zv[differ] - 0.5).abs().le(
                tol["decision_band"]).all()),
                f"{name}: validity decisions differ outside the band")
            diff = (got - want).abs()[~differ]
            mean_tol = V2_DEPTH_MEAN_TOL
            operands = (x32 * v, v)
        else:
            differ = torch.zeros_like(got, dtype=torch.bool)
            diff = (got - want).abs()
            mean_tol = V2_IMAGE_MEAN_TOL
            operands = (x32,)
        err, mean_err = float(diff.max()), float(diff.mean())
        check(err <= tol["max_abs"],
              f"{name}: max abs err {err} > {tol['max_abs']}")
        check(mean_err <= mean_tol,
              f"{name}: mean abs err {mean_err} > {mean_tol}")

        def bmm_pair():
            # cuBLAS f32 bmm for the rows, bf16 for the columns, on
            # operands built beforehand.
            for op in operands:
                torch.bmm(torch.bmm(ay, op).to(torch.bfloat16), t)

        if library == "bmm":
            library_ms = device_ms(torch, bmm_pair)[0]
            library_call = ("torch.bmm f32 (Ay . X), then torch.bmm bf16 "
                            "(R . T), per resampled map, on prebuilt "
                            "operands")
        else:
            maps = torch.stack([op.reshape(b, h_in, w_in, c)
                                for op in operands], dim=3)
            maps = maps.reshape(b, h_in, w_in, -1)
            library_ms = interpolate_ms(torch, maps.permute(0, 3, 1, 2),
                                        out_hw)
            library_call = ("F.interpolate(bilinear, antialias) of the "
                            "maps it resamples, f32 (resize only)")
        del ay, t, operands
        bound_ms, bound_by = bound(fp, x, params, out_hw, depth_mode)
        case = dict(
            case=name, max_abs_err=err, tol=tol["max_abs"],
            mean_abs_err=mean_err, mean_tol=mean_tol,
            decisions_differ=int(differ.sum()),
            decision_band=tol["decision_band"],
            photo_frames=int((params[:, 7] > 0.5).sum()),
            **timings(torch,
                      lambda: fp.fused_preprocess_v2(
                          x, params, out_hw=out_hw, depth_mode=depth_mode),
                      lambda: fp.plain_preprocess_v2(
                          x, params, out_hw=out_hw, depth_mode=depth_mode),
                      plain_iters=5),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            library_call=library_call)
        cases.append(case)
        print(json.dumps(case), flush=True)
    return cases


def serve_slice(torch, np, fp, card):
    """Phase 3: the served path of make3d-encdec at full width."""
    from ann3depth_tpu_torch import server, serving
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.probe_serving import (http_round, request_bodies,
                                                   round_stats)
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.train import step as steplib

    cfg = get_config("make3d-encdec")
    raw_hw = (480, 640)
    t0 = time.perf_counter()
    srv = None
    with graph_runs(torch, fp) as seen:
        svc = server.service_from_config(cfg, init=True, raw_hw=raw_hw,
                                         max_batch=32, max_delay_s=0.005,
                                         device="cuda")
        try:
            server.warmup(svc)
            warm_s = time.perf_counter() - t0
            srv = server.DepthServer(svc, host="127.0.0.1", port=0)
            srv.serve_background()
            url = f"http://127.0.0.1:{srv.port}/v1/depth"
            frames = np.random.default_rng(1).integers(
                0, 256, (12, *raw_hw, 3), dtype=np.uint8)
            bodies = request_bodies(frames)
            # The process's first HTTP traffic pays a host-side cost of
            # its own (ann3depth_tpu_torch/probe_serving.py); it is
            # reported apart, and the measured round is the second.
            cold, cold_s = http_round(url, bodies)
            hist0 = svc.stats()["batch_size_hist"]
            results, elapsed = http_round(url, bodies)
            batches = svc.stats()["batches"]
        finally:
            if srv is not None:
                srv.close()
            else:
                svc.close()
    # Every bucket captured in the warm-up (its warm call the only
    # launches), every batch a replay of a graph holding one v1 call.
    launches = seen["launches"]
    runs = v1_runs(seen, 1, "serve")
    check(launches == seen["captures"] == len(svc._buckets) and runs
          == batches, f"the served path: {seen}, {batches} batches of "
          f"buckets {svc._buckets}")

    answers = [np.load(io.BytesIO(r[0])) for r in results[:8]]
    answers += list(np.load(io.BytesIO(results[8][0])))
    for i, a in enumerate(answers):
        check(a.shape == (120, 160), f"answer {i} has shape {a.shape}")
        check(bool(np.isfinite(a).all() and (a > 0).all()),
              f"answer {i} is not finite and positive")

    # The same model (same seed), fed by the plain preprocess on the card.
    model = serving.prepare_model(
        steplib.init_params(registry.build(cfg.model), cfg.data.input_hw,
                            cfg.train.seed),
        torch.device("cuda"))
    x = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        params = fp.identity_params(12, raw_hw, cfg.data.input_hw,
                                    device=x.device)
        images = fp.plain_preprocess(x, params, out_hw=cfg.data.input_hw)
        want_log = model(images)[..., 0]
        want = torch.exp(want_log).cpu().numpy()
        # How far the bf16 answers move with the batch they run in (cuDNN
        # picks its algorithms per shape): each bucket against batch 12.
        spread = {}
        for b in svc._buckets:
            pred_log = model(images[torch.arange(b) % 12])[..., 0]
            n = min(b, 12)
            spread[b] = float((pred_log[:n] - want_log[:n]).abs().max())
    err = float(np.abs(np.log(np.stack(answers)) - np.log(want)).max())
    check(err <= SERVE_LOG_TOL,
          f"served depth differs from the plain path by {err} in log-depth")
    hist = {k: v - hist0.get(k, 0)
            for k, v in svc.stats()["batch_size_hist"].items()
            if v > hist0.get(k, 0)}
    out = dict(
        requests=len(bodies), frames=len(answers),
        requests_per_s=len(bodies) / elapsed,
        frames_per_s=len(answers) / elapsed,
        **round_stats(results, elapsed), batch_size_hist=hist,
        first_round=round_stats(cold, cold_s),
        max_log_depth_err_vs_plain=err, tol=SERVE_LOG_TOL,
        fused_preprocess_launches=launches, graphs=seen, v1_runs=runs,
        warmup_s=warm_s,
        bf16_log_depth_spread_by_bucket=spread, card=card)
    print("slice: " + json.dumps(out), flush=True)
    return launches


def _train_config(tmp, preset="make3d-encdec", depth_hw=MAKE3D_DEPTH_HW,
                  steps=TRAIN_STEPS, every=(10, 20, 20), warmup=10):
    """A preset at full width and its own batch, on synthetic scenes at a
    dataset's raw shapes (RGB 480x640, depth `depth_hw`), augmented;
    `steps` steps with `warmup` warmup steps (None: the preset's) and
    cadences `every` (log, checkpoint, eval). The default: make3d-encdec,
    b16, Make3D's shapes, 40 steps, warmup 10, 10/20/20."""
    import dataclasses

    from ann3depth_tpu_torch.config import get_config

    cfg = get_config(preset)
    data = dataclasses.replace(cfg.data, datasets=("synthetic",),
                               synth_img_hw=RAW_HW, synth_depth_hw=depth_hw,
                               synth_n=64, augment=True)
    log_every, checkpoint_every, eval_every = every
    if warmup is None:
        warmup = cfg.train.warmup_steps
    train = dataclasses.replace(cfg.train, steps=steps, warmup_steps=warmup,
                                log_every=log_every,
                                checkpoint_every=checkpoint_every,
                                eval_every=eval_every,
                                ckpt_dir=f"{tmp}/ckpt")
    return dataclasses.replace(cfg, data=data, train=train)


def _preprocessed(fp, fn, img, dep, draw, input_hw, target_hw):
    """(images, depths) of one raw batch through `fn` (a preprocess of the
    fused_preprocess signature), with one augmentation draw on both grids."""
    ip = fp.params_from_draw(draw, img.shape[1:3], input_hw)
    dp = fp.params_from_draw(draw, dep.shape[1:3], target_hw)
    images = fn(img, ip, out_hw=input_hw)
    depths = fn(dep[..., None].contiguous(), dp, out_hw=target_hw,
                depth_mode=True)[..., 0]
    return images, depths


def device_profile(torch, fn, steps, step_ms):
    """Device time per call of `fn` from torch.profiler: the union of the
    CUDA kernels' intervals over `steps` calls, the busy share of an
    unprofiled call of `step_ms`, and the kernels that take the most time.
    Returns None when the profiler recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # Device-side user ranges (e.g. "Optimizer.step#AdamW.step") span
    # their kernels and the gaps between them: only kernels count.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None
    busy, end = 0.0, float("-inf")
    by_name, count = {}, {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[e.name] = by_name.get(e.name, 0.0) + (stop - start)
        count[e.name] = count.get(e.name, 0) + 1
    busy_ms = busy / steps / 1e3
    resample = sum(n for k, n in count.items() if "band_resample_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    most = sorted(count.items(), key=lambda kv: -kv[1])[:8]
    return dict(kernels_per_step=len(kernels) / steps,
                v1_resample_per_step=resample / steps,
                gn_kernels_per_step={
                    k: n / steps for k, n in gn_kernels(
                        [e.name for e in kernels]).items()},
                device_busy_ms_per_step=busy_ms,
                busy_share=busy_ms / step_ms,
                top_kernels_ms_per_step={k[:90]: v / steps / 1e3
                                         for k, v in top},
                most_launched_per_step={k[:90]: n / steps for k, n in most})


def train_slice(torch, np, fp, card, tmp, cfg=None,
                resume_steps=RESUME_STEPS, label="train"):
    """Phase 4 (and 7): the training path of `cfg` (default phase 4's,
    `_train_config`) through `train.loop.train`, its steps then a resume
    to `resume_steps`, with the metrics and grids in `tmp` and the
    checkpoints in cfg.train.ckpt_dir for the phases after it. Checks the
    losses (finite; falling from the first 10 steps to the last 10 before
    the resume, where there are 20 steps and more than one image a step),
    the resumed step counter, the logged, saved and evaluated steps, and
    two v1 launches a step and a grid or eval batch; then times the step
    on one device-resident batch and holds one kernel-fed step against a
    plain-fed one."""
    import dataclasses

    from ann3depth_tpu_torch.pipeline import preprocess
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib
    from ann3depth_tpu_torch.train.checkpoint import CheckpointManager
    from ann3depth_tpu_torch.utils import flops as flopslib

    dev = torch.device("cuda")
    seen = []  # every step's loss, as device scalars (no extra host sync)
    cfg = cfg or _train_config(tmp)
    steps, batch = cfg.train.steps, cfg.train.batch_size
    resumed = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=resume_steps, resume=True))
    with step_losses(steplib, seen):
        fp.fused_preprocess_v2.launches = 0
        t0 = time.perf_counter()
        with graph_runs(torch, fp) as graphed, gn_runs(torch) as gn_run:
            state, _ = loop.train(cfg, workdir=tmp, progress=False)
        first_s = time.perf_counter() - t0
        launches = graphed["launches"]
        v2_in_loop = fp.fused_preprocess_v2.launches
        with graph_runs(torch, fp) as resume_graphed, \
                gn_runs(torch) as gn_resume:
            state2, last = loop.train(resumed, workdir=tmp, progress=False)
        resume_launches = resume_graphed["launches"]
    with open(f"{tmp}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    saved = CheckpointManager(cfg.train.ckpt_dir).all_steps()
    grids = sorted(p for p in os.listdir(tmp) if p.startswith("triples_"))

    t = cfg.train

    def every(n, upto):
        return [s for s in range(1, upto + 1) if n and s % n == 0]

    losses = torch.stack(seen).float().cpu().numpy()
    check(len(losses) == resume_steps, f"{len(losses)} steps ran, not "
          f"{resume_steps}: the resume did not continue at step {steps}")
    check(bool(np.isfinite(losses).all()), f"non-finite losses: {losses}")
    first10 = float(losses[:10].mean())
    last10 = float(losses[max(steps - 10, 0):steps].mean())
    if steps >= 20 and batch > 1:
        check(last10 < first10, f"the loss did not fall: mean of steps 1-10 "
              f"{first10}, of steps {steps - 9}-{steps} {last10}")
    check(state.step == steps and state2.step == resume_steps,
          f"steps {state.step} and {state2.step} after the run and resume")
    logged = [r["step"] for r in records if "loss" in r]
    want = sorted(set(every(t.log_every, resume_steps)) | {steps,
                                                           resume_steps})
    check(logged == want, f"logged steps {logged}, not {want}")
    evals = [r["eval_rmse"] for r in records if "eval_rmse" in r]
    eval_steps = every(t.eval_every, resume_steps)
    check(len(evals) == len(eval_steps) and bool(np.isfinite(evals).all()),
          f"in-loop evals {evals} at {eval_steps}")
    want = sorted(set(every(t.checkpoint_every, resume_steps))
                  | {steps, resume_steps})[-3:]
    check(saved == want, f"checkpoints at {saved}, not {want}")
    want = [f"triples_step{s:07d}.png" for s in eval_steps]
    check(grids == want, f"eval grids {grids}, not {want}")
    # Each run: its first step eager, then one capture of the step and a
    # replay a step; each in-loop eval replays its eval step's graph once
    # a batch (a capture for each batch shape, its warm call eager) and
    # renders its rgb|gt|pred grid eagerly: one more batch.
    group_norm, per_forward = {}, gn_per_forward(cfg)
    for label, run, gn_seen, n_steps, n_evals in (
            ("run", graphed, gn_run, steps,
             len([s for s in eval_steps if s <= steps])),
            ("resume", resume_graphed, gn_resume, resume_steps - steps,
             len([s for s in eval_steps if s > steps]))):
        train_v1(run, n_steps, 2, f"train {label}", evals=n_evals)
        check(run["steps_captured"] == 1
              and run["steps_replayed"] == n_steps - 1,
              f"train {label}: the step was not replayed from one graph: "
              f"{run}")
        group_norm[label] = train_gn(gn_seen, run, n_steps,
                                     f"train {label}", per_forward,
                                     evals=n_evals)
    check(v2_in_loop == 0, "the loop ran the v2 kernel")

    # Steady step time on one device-resident batch (the loop above also
    # pays for generating the synthetic scenes on the host).
    img_np, dep_np = next(loop.build_dataset(cfg).batches(batch, steps=1))
    img = torch.from_numpy(img_np).to(dev)
    dep = torch.from_numpy(dep_np).to(dev)
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg))
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = loop.create_state(cfg, dev)
    for _ in range(3):
        steplib.train_step(timed, img, dep, gen, augment=True, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 20

    def per_iter_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3, out

    step_ms, _ = per_iter_ms(lambda: steplib.train_step(
        timed, img, dep, gen, augment=True, **kw))
    peak = torch.cuda.max_memory_allocated()
    pre_ms, (images, depths) = per_iter_ms(
        lambda: preprocess.preprocess_batch(
            img, dep, kw["input_hw"], kw["target_hw"], generator=gen))
    update_ms, _ = per_iter_ms(lambda: steplib.step_on_batch(
        timed, images, depths))
    profiled = device_profile(torch, lambda: steplib.train_step(
        timed, img, dep, gen, augment=True, **kw), 5, step_ms)
    if profiled:
        check(set(profiled["gn_kernels_per_step"].values())
              == {per_forward},
              f"{label}: GroupNorm kernels a profiled step "
              f"{profiled['gn_kernels_per_step']}")
    flops = step_flops(steplib, timed, images, depths)
    peak_flops = flopslib.PEAK_BF16_FLOPS[H100]

    # One step from the same state and batch, fed by the kernel and by the
    # plain preprocess, with the same augmentation draw.
    a, b = loop.create_state(cfg, dev), loop.create_state(cfg, dev)
    _, m_kernel = steplib.train_step(
        a, img, dep, torch.Generator(device=dev).manual_seed(5),
        augment=True, **kw)
    draw = fp.draw_augment(torch.Generator(device=dev).manual_seed(5), batch,
                           device=dev)
    images, depths = _preprocessed(fp, fp.plain_preprocess, img, dep, draw,
                                   kw["input_hw"], kw["target_hw"])
    _, m_plain = steplib.step_on_batch(b, images, depths)
    l_kernel, l_plain = float(m_kernel["loss"]), float(m_plain["loss"])
    check(abs(l_kernel - l_plain) <= STEP_LOSS_RTOL * abs(l_plain),
          f"kernel-fed step loss {l_kernel} vs plain-fed {l_plain}")

    out = dict(
        steps=steps, resumed_to=resume_steps, batch=batch,
        params=sum(p.numel() for p in timed.model.parameters()),
        losses_first10_mean=first10, losses_last10_mean=last10,
        losses=[float(x) for x in losses], eval_rmse=evals,
        fused_preprocess_launches=launches,
        resume_launches=resume_launches, group_norm_calls=group_norm,
        eval_graphs=dict(
            run=graphed, resume=resume_graphed), first_run_s=first_s,
        loop_images_per_s=[r["images_per_sec"] for r in records
                           if "images_per_sec" in r],
        step_ms=step_ms, images_per_s=batch / step_ms * 1e3,
        preprocess_ms=pre_ms, fwd_bwd_update_ms=update_ms,
        fwd_bwd_flops=flops,
        mfu_of_step=flops / (step_ms * 1e-3) / peak_flops,
        mfu_of_fwd_bwd_update=flops / (update_ms * 1e-3) / peak_flops,
        max_memory_allocated_bytes=peak,
        device_profile=profiled or "not measured: no kernel in the trace",
        step_loss_kernel=l_kernel, step_loss_plain=l_plain,
        step_loss_rtol=STEP_LOSS_RTOL, card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out, cfg, img, dep


def step_flops(steplib, state, images, depths):
    """FLOPs of one forward and backward of the model on this batch (2 a
    multiply-add, matmuls, convolutions and attention), as
    utils/flops.step_flops counts them."""
    from ann3depth_tpu_torch.utils import flops

    def fwd_bwd():
        loss, _ = steplib.loss_fn(state.model, images, depths, 0.5)
        loss.backward()

    n = flops.step_flops(fwd_bwd)
    state.optimizer.zero_grad(set_to_none=True)
    return n


def v2_in_step(torch, fp, cfg, img, dep, card, label="instep"):
    """Phase 5 (and 7): K steps of step_on_batch fed by v1, v2 and the
    plain preprocess, from one state and one raw batch, with the same
    draws; in turns v1, v2, plain, plain, v2, v1. The v1- and v2-fed
    losses agree within STEP_LOSS_RTOL at the first step (one forward from
    the same params) and within INSTEP_LOSS_RTOL at the K-th."""
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    dev = img.device
    input_hw = tuple(cfg.data.input_hw)
    target_hw = loop.resolved_target_hw(cfg)
    feeds = {"v1": fp.fused_preprocess, "v2": fp.fused_preprocess_v2,
             "plain": fp.plain_preprocess}

    def run(impl):
        state = loop.create_state(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        fp.fused_preprocess.launches = 0
        fp.fused_preprocess_v2.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(K_STEPS):
            draw = fp.draw_augment(gen, img.shape[0], device=dev)
            images, depths = _preprocessed(fp, feeds[impl], img, dep, draw,
                                           input_hw, target_hw)
            state, metrics = steplib.step_on_batch(state, images, depths)
            if i == 0:
                first = metrics["loss"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / K_STEPS * 1e3
        return dict(ms_per_step=ms, first_loss=float(first),
                    loss=float(metrics["loss"]),
                    v1_launches=fp.fused_preprocess.launches,
                    v2_launches=fp.fused_preprocess_v2.launches)

    runs = {}
    for impl in ("v1", "v2", "plain", "plain", "v2", "v1"):
        runs.setdefault(impl, []).append(run(impl))
    v1, v2 = runs["v1"][0], runs["v2"][0]
    for r in runs["v2"]:
        check(r["v2_launches"] == 2 * K_STEPS and r["v1_launches"] == 0,
              f"v2-fed steps launched v2 {r['v2_launches']} and v1 "
              f"{r['v1_launches']} times in {K_STEPS} steps")
    check(abs(v2["first_loss"] - v1["first_loss"])
          <= STEP_LOSS_RTOL * abs(v1["first_loss"]),
          f"first step: v2-fed loss {v2['first_loss']}, v1-fed "
          f"{v1['first_loss']}")
    # Two runs of one feed part too: cuDNN's and the upsample's backward
    # sum in no fixed order, and K Adam steps carry that on.
    spread = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in (runs[k] for k in ("v1", "v2", "plain")))
    check(abs(v2["loss"] - v1["loss"]) <= INSTEP_LOSS_RTOL * abs(v1["loss"]),
          f"after {K_STEPS} steps: v2-fed loss {v2['loss']}, v1-fed "
          f"{v1['loss']}")
    out = dict(k_steps=K_STEPS, batch=int(img.shape[0]), runs=runs,
               same_feed_spread=spread, first_loss_rtol=STEP_LOSS_RTOL,
               loss_rtol=INSTEP_LOSS_RTOL, card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def _cli_json(cli, argv):
    """Run the port's CLI; its last line of output, as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _all_finite(np, metrics):
    return bool(metrics) and all(
        _all_finite(np, v) if isinstance(v, dict) else bool(np.isfinite(v))
        for v in metrics.values())


@contextlib.contextmanager
def fed_by(fp, preprocess_fn):
    """Within the block every path's v1 preprocess (the pipeline calls
    `fp.fused_preprocess` through the module) runs `preprocess_fn`, a
    function of its signature: `fp.plain_preprocess` gives the plain-fed
    path that a kernel-fed one is held against.

    A CUDA graph captured before the block keeps the kernel: a twin that
    replayed one would hold the kernel against itself. So no GraphCache
    that existed before the block may replay within it (the twin's must
    be built inside, and capture `preprocess_fn`), and those built inside
    are emptied when it ends."""
    from ann3depth_tpu_torch.utils import graphs

    kernel = fp.fused_preprocess
    before = {c: c.replays for c in graphs.caches()}
    fp.fused_preprocess = preprocess_fn
    try:
        yield
    finally:
        fp.fused_preprocess = kernel
        stale = [c.fn for c, n in before.items() if c.replays != n]
        for c in graphs.caches():
            if c not in before:
                c.clear()
    check(not stale, f"graphs captured before a fed_by block replayed in "
          f"it: {stale}")


@contextlib.contextmanager
def graph_runs(torch, fp):
    """Within the block: the v1 wrapper's launches (its count set to 0),
    and the GraphCaches' captures and replays, and the v1 calls recorded
    into their captures (which the wrapper does not count: a recorded
    call runs at every replay, where no Python runs); and apart, the
    train loop's step graphs (train/dispatch.BlockRunner made in the
    block): `steps_captured`, `steps_replayed` (a step a replay) and
    `steps_recorded` (the v1 calls recorded into them). Yields a dict
    that is filled when the block ends."""
    from ann3depth_tpu_torch.train import dispatch
    from ann3depth_tpu_torch.utils import graphs

    seen = dict(launches=0, recorded=0, captures=0, replays=0,
                steps_captured=0, steps_replayed=0, steps_recorded=0)
    kernel = fp.fused_preprocess
    before = {c: (c.captures, c.replays) for c in graphs.caches()}
    made, runners, in_step = [], [], [False]
    init = graphs.GraphCache.__init__
    runner_init, runner_capture = (dispatch.BlockRunner.__init__,
                                   dispatch.BlockRunner._capture)

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def kept_runner(self, *a, **kw):
        runner_init(self, *a, **kw)
        runners.append(self)

    def capture_step(self, entry):
        in_step[0] = True
        try:
            return runner_capture(self, entry)
        finally:
            in_step[0] = False

    def recorded(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            seen["steps_recorded" if in_step[0] else "recorded"] += 1
        return kernel(*a, **kw)

    kernel.launches = 0
    graphs.GraphCache.__init__ = kept
    dispatch.BlockRunner.__init__ = kept_runner
    dispatch.BlockRunner._capture = capture_step
    fp.fused_preprocess = recorded
    try:
        yield seen
    finally:
        fp.fused_preprocess = kernel
        graphs.GraphCache.__init__ = init
        dispatch.BlockRunner.__init__ = runner_init
        dispatch.BlockRunner._capture = runner_capture
        seen["launches"] = kernel.launches
        for c in set(made) | set(before):
            c0, r0 = before.get(c, (0, 0))
            seen["captures"] += c.captures - c0
            seen["replays"] += c.replays - r0
        for r in runners:
            seen["steps_captured"] += r.captures
            seen["steps_replayed"] += r.replays
        made.clear()
        runners.clear()


def step_v1(seen, per_step, label):
    """The v1 runs of the replayed train steps of a `graph_runs` block
    whose step graphs each record `per_step` v1 calls (2 a microbatch):
    checks what each capture recorded, returns per_step a replayed step."""
    check(seen["steps_recorded"] == per_step * seen["steps_captured"],
          f"{label}: {seen['steps_recorded']} v1 calls recorded into "
          f"{seen['steps_captured']} step graphs, {per_step} a graph "
          "expected")
    return per_step * seen["steps_replayed"]


def train_v1(seen, steps, per_step, label, evals=0):
    """The v1 runs of `steps` K=1 train steps and `evals` in-loop evals in
    a `graph_runs` block. An eager step (a key's first, or every step
    where the loop steps eagerly) launches `per_step`, a replayed one
    runs the `per_step` calls its graph recorded; an eval renders its
    grid (2 launches) and runs EVAL_SAMPLE_BATCHES batches of its eval
    graphs (2 each; each capture's warm call launches 2). Checks all of
    that, and that every step graph followed an eager step of its key;
    returns the v1 runs."""
    from ann3depth_tpu_torch.train import loop

    replayed = step_v1(seen, per_step, label)
    eager_steps = steps - seen["steps_replayed"]
    check(seen["launches"] - 2 * seen["captures"]
          == per_step * eager_steps + 2 * evals
          and seen["replays"] == loop.EVAL_SAMPLE_BATCHES * evals
          and eager_steps >= max(seen["steps_captured"], 1),
          f"{label}: v1 launched {seen['launches']} times in {steps} steps "
          f"({eager_steps} eager) and {evals} evals: {seen}")
    return v1_runs(seen, 2, label) + replayed


GN_KERNELS = ("gn_stats_kernel", "gn_apply_kernel", "gn_bwd_stats_kernel",
              "gn_bwd_apply_kernel")


@contextlib.contextmanager
def gn_runs(torch):
    """Within the block: the GroupNorm kernels' launches outside CUDA
    graph capture (`fwd`, `bwd`: the wrappers' counts), and the calls
    recorded into the train loop's step graphs (`steps_recorded_*`,
    inside `BlockRunner._capture`) and into other graphs (`recorded_*`:
    the eval graphs), which the wrappers do not count. Yields a dict that
    is filled when the block ends."""
    from ann3depth_tpu_torch.ops import _kernels
    from ann3depth_tpu_torch.ops import group_norm as gn
    from ann3depth_tpu_torch.train import dispatch

    wrappers = (gn.group_norm_relu, gn.group_norm_relu_backward)
    seen = dict(fwd=0, bwd=0, recorded_fwd=0, recorded_bwd=0,
                steps_recorded_fwd=0, steps_recorded_bwd=0)
    in_step = [False]
    count, capture = _kernels.count, dispatch.BlockRunner._capture

    def counted(wrapper):
        if wrapper in wrappers and torch.cuda.is_current_stream_capturing():
            kind = "fwd" if wrapper is wrappers[0] else "bwd"
            seen[("steps_recorded_" if in_step[0] else "recorded_")
                 + kind] += 1
        count(wrapper)

    def capture_step(self, entry):
        in_step[0] = True
        try:
            return capture(self, entry)
        finally:
            in_step[0] = False

    before = [w.launches for w in wrappers]
    _kernels.count = counted
    dispatch.BlockRunner._capture = capture_step
    try:
        yield seen
    finally:
        _kernels.count = count
        dispatch.BlockRunner._capture = capture
        seen["fwd"], seen["bwd"] = (w.launches - n
                                    for w, n in zip(wrappers, before))


def gn_per_forward(cfg):
    """GroupNorm calls a forward of cfg's model makes: one a `Stage` with a
    norm (encdec 3, multiscale 5, the others 0)."""
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.models.encdec import Stage

    return sum(isinstance(m, Stage) and m.norm is not None
               for m in registry.build(cfg.model).modules())


def train_gn(seen, runs, steps, label, per_forward, microbatches=1,
             forwards=1, evals=0):
    """The GroupNorm calls of `steps` K=1 train steps and `evals` in-loop
    evals of a model that makes `per_forward` calls a forward, from a
    `gn_runs` block `seen` and the `graph_runs` block `runs` around it: an
    eager step launches `per_forward` backward calls a microbatch and
    `forwards` times as many forward ones (a distilled step runs its
    teacher too), and a step graph records as many; an eval graph's
    capture records a forward's calls after a warm call that launches
    them, and each eval's grid launches them once more. Checks all of
    that; returns `seen` with the calls a replayed step runs."""
    eager = steps - runs["steps_replayed"]
    bwd = per_forward * microbatches
    fwd = bwd * forwards
    want = dict(
        fwd=fwd * eager + per_forward * (runs["captures"] + evals),
        bwd=bwd * eager, recorded_fwd=per_forward * runs["captures"],
        recorded_bwd=0, steps_recorded_fwd=fwd * runs["steps_captured"],
        steps_recorded_bwd=bwd * runs["steps_captured"])
    check(seen == want, f"{label}: GroupNorm calls {seen}, not {want} "
          f"({steps} steps, {eager} eager, {evals} evals, graphs {runs})")
    return dict(seen, per_replayed_step=dict(fwd=fwd, bwd=bwd),
                eager_steps=eager)


def gn_kernels(names):
    """How many of each GroupNorm kernel `names` (device kernel names)
    hold."""
    return {k: sum(f"{k}<" in n for n in names) for k in GN_KERNELS}


def v1_runs(seen, calls, label, recorded=True):
    """The v1 runs of a `graph_runs` block whose graphs each hold `calls`
    v1 calls: the eager launches (the wrapper's count less the warm call
    before each capture, which runs the step once) plus `calls` a replay.
    recorded: check that each capture recorded `calls` v1 calls (an
    exported program calls the op directly, where no recorder sees it)."""
    warm = calls * seen["captures"]
    check(not recorded or seen["recorded"] == warm,
          f"{label}: {seen['recorded']} v1 calls recorded into "
          f"{seen['captures']} graphs, {calls} a graph expected")
    eager = seen["launches"] - warm
    check(eager >= 0, f"{label}: {seen}")
    return eager + calls * seen["replays"]


def _shifted_window(fp):
    """plain_preprocess with each image's source window moved one source
    pixel down and right (a band off by one), depth as it is: the control
    that EVAL_METRIC_RTOL must fail."""
    def shifted(frames, params, *, out_hw, norm=True, depth_mode=False):
        if not depth_mode:
            params = params.clone()
            params[:, 0] += 1.0
            params[:, 2] += 1.0
        return fp.plain_preprocess(frames, params, out_hw=out_hw, norm=norm,
                                   depth_mode=depth_mode)
    return shifted


def _jittered(torch, fp, seed):
    """plain_preprocess with its images moved by uniform noise of JITTER
    drawn from `seed`, depth as it is: how far the model's metrics move
    when its inputs move as far as the kernel's and the plain
    preprocess's differ. The noise of each shape is drawn once, at its
    first call, so that a CUDA graph of the eval step (captured after a
    warm call) holds no draw: every batch of a shape gets that noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = {}

    def jittered(frames, params, *, out_hw, norm=True, depth_mode=False):
        out = fp.plain_preprocess(frames, params, out_hw=out_hw, norm=norm,
                                  depth_mode=depth_mode)
        if depth_mode:
            return out
        if out.shape not in noise:
            noise[out.shape] = JITTER * (2 * torch.rand(
                out.shape, device=out.device, generator=gen) - 1)
        return out + noise[out.shape]
    return jittered


def _rel_metrics(got, want):
    return {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-3)
            for k in want}


def eval_phase(torch, np, fp, cfg, tmp, card, preset="make3d-encdec",
               full=True, label="eval"):
    """Phase 6 (and 7, 10), eval: `cli eval --config preset` on the
    checkpoint of `cfg` at its quant (plain; with `full` also with a
    report and tta, and with two
    protocols); the plain run against the same eval fed by the plain
    preprocess and against the `_shifted_window` control; with `full` the
    device rate of the eval step and the kernel at the eval image
    shape."""
    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    flags = ["--config", preset, "--datasets", "synthetic",
             "--synth-hw", *map(str, cfg.data.synth_img_hw),
             "--synth-depth-hw", *map(str, cfg.data.synth_depth_hw),
             "--ckpt-dir", cfg.train.ckpt_dir, "--quant", cfg.model.quant,
             "--max-batches", str(EVAL_BATCHES)]
    report = f"{tmp}/report"
    runs = {}
    for name, extra, n_protocols in (
            ("plain", [], 1),
            ("report_tta", ["--report-dir", report, "--tta", "flip"], 1),
            ("protocols", ["--protocols", "plain,tta+align+crop"], 2),
    )[:3 if full else 1]:
        t0 = time.perf_counter()
        with graph_runs(torch, fp) as seen:
            metrics = _cli_json(cli, ["eval"] + flags + extra)
        seconds = time.perf_counter() - t0
        launches = seen["launches"]
        check(_all_finite(np, metrics), f"eval {name}: {metrics}")
        # eval_stats_step: a graph a protocol; eval_report_step: a graph
        runs_v1 = v1_runs(seen, 2, f"eval {name}")
        check(runs_v1 == 2 * EVAL_BATCHES * n_protocols
              and seen["captures"] == n_protocols,
              f"eval {name} ran the kernel {runs_v1} times in "
              f"{EVAL_BATCHES * n_protocols} batches: {seen}")
        runs[name] = dict(metrics=metrics, seconds=seconds,
                          launches=launches, graphs=seen, v1_runs=runs_v1)
    if full:
        with open(f"{report}/per_image.jsonl") as f:
            rows = len(f.readlines())
        check(rows == 16 * EVAL_BATCHES and os.path.exists(
            f"{report}/worst.png") and os.path.exists(
                f"{report}/summary.json"),
            f"eval report: {rows} rows, {os.listdir(report)}")
        check(sorted(runs["protocols"]["metrics"]) == ["plain",
                                                        "tta+align+crop"],
              "eval protocols")

    # The plain run against the same eval fed by plain_preprocess, and
    # against the control, a resample off by one source pixel; for the
    # models of JITTER_HELD also the plain-fed run against jitter controls.
    state = loop.restore_state_for_eval(cfg)
    kernel = runs["plain"]["metrics"]
    fed = {}
    for name, fn in (("plain_fed", fp.plain_preprocess),
                     ("shifted_window_control", _shifted_window(fp))):
        with fed_by(fp, fn):
            fed[name] = loop.evaluate(cfg, state=state,
                                      max_batches=EVAL_BATCHES)
    rel = {name: _rel_metrics(kernel, m) for name, m in fed.items()}
    jitter_rel = {}
    if cfg.model.name in JITTER_HELD:
        for seed in EVAL_JITTER_SEEDS:
            with fed_by(fp, _jittered(torch, fp, seed)):
                moved = loop.evaluate(cfg, state=state,
                                      max_batches=EVAL_BATCHES)
            jitter_rel[f"jitter_control_{seed}"] = _rel_metrics(
                moved, fed["plain_fed"])
    not_held = EVAL_METRICS_NOT_HELD.get(preset, ())
    if cfg.model.quant != "none":
        not_held = EVAL_DELTAS
    worst = {name: max(v for k, v in r.items() if k not in not_held)
             for name, r in {**rel, **jitter_rel}.items()}
    rtol = max([EVAL_METRIC_RTOL[preset]]
               + [2 * worst[name] for name in jitter_rel])
    check(worst["plain_fed"] <= rtol < worst["shifted_window_control"],
          f"eval metrics, largest relative difference of the kernel-fed "
          f"run: {worst} (tolerance {rtol} must hold the plain-fed run and "
          f"fail the control); by metric {rel}, jitter controls "
          f"{jitter_rel}")
    if not full:
        out = dict(runs=runs, rel_to=rel, jitter_rel_to=jitter_rel,
                   largest_rel=worst, rtol=rtol, card=card)
        print(f"{label}: " + json.dumps(out), flush=True)
        return out, None

    # Device rate of the eval step on one device-resident b16 batch.
    img_np, dep_np = next(loop.build_dataset(cfg, "test").batches(
        16, steps=1, shuffle=False))
    img = torch.from_numpy(img_np).cuda()
    dep = torch.from_numpy(dep_np).cuda()
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg),
              si_lambda=cfg.train.si_lambda)
    rate = {}
    for tta in ("", "flip"):
        ms = time_ms(lambda: steplib.eval_stats_step(state, img, dep,
                                                     tta=tta, **kw))
        rate[tta or "plain"] = dict(ms_per_batch=ms,
                                    images_per_s=16 / ms * 1e3)
    case = image_case(
        torch, fp, "image u8 [16,480,640,3] -> [240,320], identity rows "
        "(eval)", img, fp.identity_params(16, (480, 640), (240, 320),
                                          device=img.device), library=True)
    out = dict(runs=runs, report_rows=rows, rel_to=rel,
               jitter_rel_to=jitter_rel, largest_rel=worst, rtol=rtol,
               eval_step_device_rate=rate, card=card)
    print("eval: " + json.dumps(out), flush=True)
    return out, case


def _plain_log_depth(torch, fp, model, input_hw, frames, jitter=0.0):
    """The model's log-depth of u8 numpy frames fed by the plain
    preprocess, as one batch; with `jitter`, its inputs moved by uniform
    noise of that size (the control of how far the model's answers move
    when its inputs move as little as the kernel's and the plain
    preprocess's do)."""
    from ann3depth_tpu_torch.pipeline import preprocess

    with torch.inference_mode(), fed_by(fp, fp.plain_preprocess):
        x = torch.from_numpy(frames).cuda()
        images = preprocess.preprocess_image(x, input_hw)
        if jitter:
            gen = torch.Generator(device="cuda").manual_seed(0)
            images = images + jitter * (2 * torch.rand(
                images.shape, device="cuda", generator=gen) - 1)
        return model(images)[..., 0].cpu().numpy()


def log_depth_tol(torch, np, fp, model, model_cfg, input_hw, frames, want):
    """The tolerance, in max and in mean, of a same-batch comparison with
    `want` (the plain-fed log-depth of u8 numpy `frames` by `model`, the
    model of ModelConfig `model_cfg`): SERVE_LOG_TOL, or for jitter_held models
    twice the jitter control on these frames (returned too, else None),
    for an int8 model no less than SERVE_LOG_TOL."""
    if not jitter_held(model_cfg):
        return dict(max=SERVE_LOG_TOL, mean=SERVE_LOG_TOL), None
    moved = np.abs(_plain_log_depth(torch, fp, model, input_hw, frames,
                                    JITTER) - want)
    control = dict(max=float(moved.max()), mean=float(moved.mean()))
    tol = {k: 2 * v for k, v in control.items()}
    if model_cfg.quant != "none":  # never tighter than a bf16 model's
        tol = {k: max(v, SERVE_LOG_TOL) for k, v in tol.items()}
    return tol, control


def check_log_close(np, got, want, tol, name):
    """Log-depths `got` and `want` within `tol` (log_depth_tol) in max and
    in mean; returns the errors."""
    diff = np.abs(got - want)
    err = dict(max=float(diff.max()), mean=float(diff.mean()))
    check(err["max"] <= tol["max"] and err["mean"] <= tol["mean"],
          f"{name}: log-depth err {err}, tolerance {tol}")
    return err


def serve_checkpoint(torch, np, fp, cfg, card, label="serve_ckpt"):
    """Phase 6 (and 7), serve from the checkpoint of `cfg`: one HTTP round
    of 12 frames; after it, each dispatched batch against the restored
    model fed by the plain preprocess on the same batch (cuDNN picks its
    algorithms per batch size, so the same batch is the yardstick)."""
    from ann3depth_tpu_torch import server, serving
    from ann3depth_tpu_torch.probe_serving import (http_round, request_bodies,
                                                   round_stats)
    from ann3depth_tpu_torch.train import loop

    raw_hw = (480, 640)
    model = serving.model_from_checkpoint(cfg, device="cuda")
    dispatched = []

    def recorded(frames):
        out = served(frames)
        dispatched.append((frames, out))  # the batcher stacks a new array
        return out

    srv = None
    with graph_runs(torch, fp) as seen:
        svc = server.service_from_config(cfg, raw_hw=raw_hw, max_batch=32,
                                         max_delay_s=0.005, device="cuda")
        try:
            server.warmup(svc)
            served, svc._fn = svc._fn, recorded
            srv = server.DepthServer(svc, host="127.0.0.1", port=0)
            srv.serve_background()
            frames = np.random.default_rng(2).integers(
                0, 256, (12, *raw_hw, 3), dtype=np.uint8)
            results, elapsed = http_round(
                f"http://127.0.0.1:{srv.port}/v1/depth",
                request_bodies(frames))
            batches = svc.stats()["batches"]
        finally:
            if srv is not None:
                srv.close()
            else:
                svc.close()
    launches = seen["launches"]
    runs = v1_runs(seen, 1, label)
    check(launches == seen["captures"] == len(svc._buckets)
          and runs == batches, f"the served checkpoint: {seen}, "
          f"{batches} batches")
    answers = [np.load(io.BytesIO(r[0])) for r in results[:8]]
    answers += list(np.load(io.BytesIO(results[8][0])))
    answers = np.stack(answers)
    out_hw = loop.resolved_target_hw(cfg)
    check(answers.shape == (12, *out_hw) and bool(
        np.isfinite(answers).all() and (answers > 0).all()),
        f"served answers {answers.shape}, not (12, {out_hw})")
    check(dispatched, "the round dispatched no batch")
    batches = []
    for i, (batch, out) in enumerate(dispatched):
        want = _plain_log_depth(torch, fp, model, cfg.data.input_hw, batch)
        tol, control = log_depth_tol(torch, np, fp, model, cfg.model,
                                     cfg.data.input_hw, batch, want)
        err = check_log_close(np, np.log(out), want, tol,
                              f"served checkpoint, batch {i}")
        batches.append(dict(size=len(batch), err=err, tol=tol,
                            jitter_control=control))
    out = dict(frames=12, out_hw=out_hw, launches=launches, graphs=seen,
               v1_runs=runs, frames_per_s=12 / elapsed,
               **round_stats(results, elapsed),
               log_depth_vs_plain_same_batch=batches, card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def _live_close(np, live, got, want, name, tol=None):
    """(depth, rendered) numpy pairs: log-depth within `tol` (default
    SERVE_LOG_TOL: a bf16 model, inputs that agree to f32 summation order,
    the same batch size), and LUT indices within what that depth difference
    can move them: the normalized depth moves by at most 3 err / (hi - lo)
    for a log-depth error err (the value, the min and the range), the
    display resize is a convex combination, and the int cast adds 1."""
    (gd, gr), (wd, wr) = got, want
    tol = tol or dict(max=SERVE_LOG_TOL, mean=SERVE_LOG_TOL)
    err = check_log_close(np, np.log(gd), np.log(wd), tol, name)["max"]
    logd = np.log(wd).reshape(-1, *wd.shape[-2:])
    span = max(float((logd.max(axis=(1, 2))
                      - logd.min(axis=(1, 2))).min()), 1e-6)
    index_tol = 1 + int(255 * 3 * err / span)
    d = live.lut_index_distance(gr, wr)
    check(int(d.max()) <= index_tol,
          f"{name}: LUT index distance {int(d.max())} > {index_tol}")
    return dict(log_err=err, index_max=int(d.max()), index_tol=index_tol,
                index_differ_share=float((d > 0).mean()))


def live_runs(seen, frames, label):
    """The v1 runs of a live engine's `graph_runs` block that showed
    `frames` frames: the engine's eager warm-up frame and its one capture
    (a warm call before it), then a replay for the constructor's step,
    every frame shown, and at most one frame in flight."""
    runs = v1_runs(seen, 1, label)
    check(seen["launches"] == 2 and seen["captures"] == 1
          and frames + 1 <= seen["replays"] <= frames + 2,
          f"{label}: {seen} for {frames} frames")
    return runs


def live_phase(torch, np, fp, cfg, card):
    """Phase 6, live: the headless viewer on the `live` config at 640x480,
    30 fps, without and with smoothing; the engine's device-program latency
    and latency decomposition; the engine against plain-fed live_step; the
    kernel at the live shape (b1)."""
    import dataclasses

    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.live import infer as live
    from ann3depth_tpu_torch.live import viewer
    from ann3depth_tpu_torch.live.capture import SyntheticSource

    base = get_config("live")
    live_cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, ckpt_dir=cfg.train.ckpt_dir))
    frame_hw, input_hw = live_cfg.live.frame_hw, live_cfg.data.input_hw
    model = serving.model_from_checkpoint(live_cfg, device="cuda")
    runs, launches = {}, 0
    for smooth in (0.0, 0.8):
        c = dataclasses.replace(live_cfg, live=dataclasses.replace(
            live_cfg.live, smooth=smooth))
        with graph_runs(torch, fp) as seen:
            stats = viewer.run(c, display=False, max_frames=LIVE_FRAMES,
                               source=SyntheticSource(
                                   frame_hw, fps=c.live.target_fps),
                               model=model)
        check(stats["frames"] == LIVE_FRAMES and stats["ring_native"],
              f"live (smooth {smooth}): {stats}")
        n = live_runs(seen, LIVE_FRAMES, f"live (smooth {smooth})")
        runs[f"smooth_{smooth}"] = dict(stats, launches=seen["launches"],
                                        graphs=seen, v1_runs=n)
        launches += seen["launches"]

    engine = live.LiveEngine(model, frame_hw, input_hw)
    # The engine alone, one frame at a time from the host, no capture
    # thread: what a frame costs outside the viewer's loop.
    frame = SyntheticSource(frame_hw, seed=3).read()
    alone = [engine.infer(frame)[2] * 1e3 for _ in range(100)]
    engine_alone = dict(p50_ms=float(np.percentile(alone, 50)),
                        p99_ms=float(np.percentile(alone, 99)))
    program_ms = engine.device_step_latency(200) * 1e3
    decomposition = engine.latency_decomposition()
    # A uniform-noise frame: the synthetic source's rows are constant, so
    # its frames cannot tell one resample from another.
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = torch.randint(0, 256, (1, *frame_hw, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    profile = device_profile(torch, lambda: engine._step(noise), 20,
                             program_ms)

    src = SyntheticSource(frame_hw, seed=1)
    frames = [noise[0].cpu().numpy()] + [src.read() for _ in range(2)]
    plain_kw = dict(input_hw=input_hw, display_hw=frame_hw)
    parity = {}
    for i, f in enumerate(frames):
        d, r, _ = engine.infer(f, fetch_depth=True)
        with fed_by(fp, fp.plain_preprocess):
            wd, wr = live.live_step(model, torch.from_numpy(f)[None].cuda(),
                                    **plain_kw)
        parity[f"frame{i}"] = _live_close(
            np, live, (d, r), (wd[0].cpu().numpy(), wr[0].cpu().numpy()),
            f"live frame {i}")
    smoothed = live.LiveEngine(model, frame_hw, input_hw, smooth=0.8)
    carry = torch.zeros((1, input_hw[0] // 2, input_hw[1] // 2),
                        device="cuda")
    for i, f in enumerate(frames):
        d, r, _ = smoothed.infer(f, fetch_depth=True)
        with fed_by(fp, fp.plain_preprocess):
            wd, wr, carry = live.live_step(
                model, torch.from_numpy(f)[None].cuda(), smooth=0.8,
                prev_log=carry, has_prev=torch.tensor(float(i > 0),
                                                      device="cuda"),
                **plain_kw)
        parity[f"smooth_frame{i}"] = _live_close(
            np, live, (d, r), (wd[0].cpu().numpy(), wr[0].cpu().numpy()),
            f"smoothed live frame {i}")

    case = image_case(
        torch, fp, "image u8 [1,480,640,3] -> [240,320], identity rows "
        "(live, uniform noise)", noise,
        fp.identity_params(1, frame_hw, input_hw, device=noise.device),
        library=True)
    out = dict(runs=runs, engine_infer_alone=engine_alone,
               device_step_latency_ms=program_ms,
               latency_decomposition=decomposition,
               device_profile=profile or "not measured: no kernel in the "
               "trace", parity_vs_plain_fed=parity, card=card)
    print("live: " + json.dumps(out), flush=True)
    return out, case, launches


def infer_phase(torch, np, fp, model_cfg, card, transcode=True,
                label="infer"):
    """Phase 6 (and 7), infer: the `infer --image` device helper on raw
    frames and, with `transcode`, the transcode device loop at batch 8 on
    64 frames, each against the plain-fed path."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.live import infer as live
    from ann3depth_tpu_torch.live.capture import SyntheticSource
    from ann3depth_tpu_torch.live.transcode import render_batches
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    model = serving.model_from_checkpoint(model_cfg, device="cuda")
    input_hw = tuple(model_cfg.data.input_hw)
    out_hw = loop.resolved_target_hw(model_cfg)
    src = SyntheticSource((480, 640), seed=2)
    frames = np.stack([src.read() for _ in range(TRANSCODE_FRAMES)])
    frames[:4] = np.random.default_rng(3).integers(0, 256, frames[:4].shape,
                                                   dtype=np.uint8)

    steplib.infer_image(model, frames[0], input_hw=input_hw)  # capture
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as seen:
        depths = [steplib.infer_image(model, f, input_hw=input_hw)
                  for f in frames[:4]]
    image_ms = (time.perf_counter() - t0) / 4 * 1e3
    image_launches = v1_runs(seen, 1, "infer")
    check(image_launches == seen["replays"] == 4 and not seen["launches"],
          f"infer ran the kernel {image_launches} times: {seen}")
    got = np.stack(depths)
    check(got.shape == (4, *out_hw) and bool(np.isfinite(got).all()),
          f"infer depths {got.shape}")
    image_errs = []
    for i in range(4):  # one frame at a time, as infer_image
        want = _plain_log_depth(torch, fp, model, input_hw, frames[i:i + 1])
        tol, control = log_depth_tol(torch, np, fp, model, model_cfg.model,
                                     input_hw, frames[i:i + 1], want)
        err = check_log_close(np, np.log(got[i:i + 1]), want, tol,
                              f"infer frame {i} vs plain-fed")
        image_errs.append(dict(err=err, tol=tol, jitter_control=control))
    res = dict(image_ms=image_ms, image_launches=image_launches,
               image_log_err_vs_plain=image_errs, card=card)
    if not transcode:
        print(f"{label}: " + json.dumps(res), flush=True)
        return res

    batches = [(frames[i:i + TRANSCODE_BATCH], TRANSCODE_BATCH)
               for i in range(0, TRANSCODE_FRAMES, TRANSCODE_BATCH)]
    list(render_batches(model, iter(batches[:1]), input_hw=input_hw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as seen:
        out = list(render_batches(model, iter(batches), input_hw=input_hw))
    loop_s = time.perf_counter() - t0
    # one graph of the batch's shape (its capture in the timed loop)
    loop_launches = v1_runs(seen, 1, "transcode")
    check(loop_launches == seen["replays"] == len(batches)
          and seen["captures"] == 1,
          f"the transcode loop ran the kernel {loop_launches} times: "
          f"{seen}")
    check(sum(r.shape[0] for _, r, _ in out) == TRANSCODE_FRAMES,
          "transcode frames")
    # batch 0: four uniform-noise frames and four synthetic ones
    x = torch.from_numpy(batches[0][0]).cuda()
    with fed_by(fp, fp.plain_preprocess):
        wd, wr = live.live_step(model, x, input_hw=input_hw,
                                display_hw=(480, 640))
    loop_parity = _live_close(np, live, (out[0][2], out[0][1]),
                              (wd.cpu().numpy(), wr.cpu().numpy()),
                              "transcode batch 0")
    res.update(transcode_batch=TRANSCODE_BATCH,
               transcode_frames=TRANSCODE_FRAMES,
               transcode_frames_per_s=TRANSCODE_FRAMES / loop_s,
               transcode_launches=loop_launches,
               transcode_parity_vs_plain_fed=loop_parity)
    print(f"{label}: " + json.dumps(res), flush=True)
    return res


def live_cli(torch, np, fp, cfg, preset, tmp, card, label="live"):
    """Phase 7 (and 10), live: `cli live --config preset` at the quant of
    `cfg` headless for FAMILY_LIVE_FRAMES frames on the checkpoint of `cfg`
    (the synthetic source: the machine has no camera), then the engine on
    one uniform-noise frame against plain-fed live_step."""
    import dataclasses

    from ann3depth_tpu_torch import cli, serving
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.live import infer as live

    base = get_config(preset)
    live_cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, quant=cfg.model.quant),
        train=dataclasses.replace(base.train, ckpt_dir=cfg.train.ckpt_dir))
    n_frames = FAMILY_LIVE_FRAMES
    with graph_runs(torch, fp) as seen:
        stats = _cli_json(cli, [
            "live", "--config", preset, "--ckpt-dir", cfg.train.ckpt_dir,
            "--quant", cfg.model.quant, "--no-display", "--max-frames",
            str(n_frames), "--video", f"{tmp}/no-camera.avi"])
    launches = seen["launches"]
    check(stats["frames"] == n_frames and stats["ring_native"],
          f"{label}: {stats}")
    n_runs = live_runs(seen, n_frames, label)

    frame_hw, input_hw = live_cfg.live.frame_hw, live_cfg.data.input_hw
    model = serving.model_from_checkpoint(live_cfg, device="cuda")
    engine = live.LiveEngine(model, frame_hw, input_hw)
    gen = torch.Generator(device="cuda").manual_seed(5)
    noise = torch.randint(0, 256, (1, *frame_hw, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    d, r, _ = engine.infer(noise[0].cpu().numpy(), fetch_depth=True)
    with fed_by(fp, fp.plain_preprocess):
        wd, wr = live.live_step(model, noise, input_hw=input_hw,
                                display_hw=frame_hw)
    tol, control = log_depth_tol(torch, np, fp, model, cfg.model,
                                 input_hw, noise.cpu().numpy(),
                                 np.log(wd.cpu().numpy()))
    parity = _live_close(np, live, (d, r),
                         (wd[0].cpu().numpy(), wr[0].cpu().numpy()),
                         f"{label} noise frame", tol)
    parity.update(tol=tol, jitter_control=control)
    out = dict(stats, launches=launches, graphs=seen, v1_runs=n_runs,
               display_hw=list(frame_hw),
               depth_hw=list(d.shape),
               device_step_latency_ms=engine.device_step_latency(50) * 1e3,
               parity_vs_plain_fed=parity, card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def family_phase(torch, np, fp, card, tmp):
    """Phase 7: the other model families at full width. dpt-384 (b16,
    384x384 in and out, on scenes at NYU's raw shapes) trains, resumes,
    runs v2 in the step, evaluates, serves, infers and runs live;
    make3d-multiscale (b16, Make3D's raw shapes) trains, resumes and
    serves; make3d-small (b1) trains, resumes and serves. Returns the v1
    and v2 launches of each path."""
    launches = {}
    for preset, depth_hw, steps, resume, every, warmup in FAMILIES:
        d = f"{tmp}/{preset}"
        cfg = _train_config(d, preset, depth_hw, steps=steps, every=every,
                            warmup=warmup)
        train, cfg, img, dep = train_slice(torch, np, fp, card, d, cfg,
                                           resume, label=f"train {preset}")
        runs = dict(train=train["fused_preprocess_launches"],
                    resume=train["resume_launches"])
        if preset != "make3d-small":
            double_run(torch, cfg, img, dep, card, label=f"repeat {preset}")
        if preset == "dpt-384":
            instep = v2_in_step(torch, fp, cfg, img, dep, card,
                                label=f"instep {preset}")
            runs["v2_instep"] = instep["runs"]["v2"][0]["v2_launches"]
            evals, _ = eval_phase(torch, np, fp, cfg, d, card, preset=preset,
                                  full=False, label=f"eval {preset}")
            runs["eval"] = evals["runs"]["plain"]["launches"]
        runs["serve_ckpt"] = serve_checkpoint(
            torch, np, fp, cfg, card, label=f"serve_ckpt {preset}")[
                "launches"]
        if preset == "dpt-384":
            runs["infer"] = infer_phase(torch, np, fp, cfg, card,
                                        transcode=False,
                                        label=f"infer {preset}")[
                                            "image_launches"]
            runs["live"] = live_cli(torch, np, fp, cfg, preset, d, card,
                                    label=f"live {preset}")["launches"]
        launches[preset] = runs
    return launches


def double_run(torch, cfg, img, dep, card, steps=K_STEPS, label="repeat"):
    """`steps` augmented train steps of cfg's model, twice from one state
    and one device-resident feed, in the default mode (cuDNN may pick
    nondeterministic algorithms): the largest relative difference of the
    two loss curves, and whether they are equal bit for bit."""
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg), augment=True)
    curves = []
    for _ in range(2):
        state = loop.create_state(cfg, img.device)
        draws, losses = torch.Generator(device=img.device), []
        for i in range(steps):
            draws.manual_seed(i)
            state, m = steplib.train_step(state, img, dep, draws, **kw)
            losses.append(m["loss"])
        curves.append(torch.stack(losses).float().cpu())
    a, b = curves
    out = dict(preset_model=cfg.model.name, steps=steps,
               bitwise_equal=bool(torch.equal(a, b)),
               max_rel_spread=float(((a - b).abs() / b.abs()).max()),
               last_losses=[float(a[-1]), float(b[-1])], card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


class _Named:
    """A dataset under another name (records.pack names a pack by it)."""

    def __init__(self, name, dataset):
        self.name, self._ds = name, dataset

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return self._ds[i]


def _nyu_scenes(np, n, seed):
    """Synthetic scenes at NYU's raw shapes (RGB and depth 480x640), depth
    scaled into NYU's indoor range (0.4-10 m)."""
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset

    class Scenes(SyntheticDepthDataset):
        def __getitem__(self, i):
            img, depth = super().__getitem__(i)
            return img, depth * np.float32(10.0 / 52.0)

    return Scenes(n=n, img_hw=NYU_DEPTH_HW, depth_hw=NYU_DEPTH_HW, seed=seed)


def write_nyu_mat(np, data_dir, n_train, n_test):
    """`nyu_depth_v2_labeled.mat` in NYU's MATLAB v7.3 layout (HDF5:
    `images` (N,3,640,480) uint8, `depths` (N,640,480) f32, `scenes` as
    object references to char arrays, four frames a scene) and a
    `splits.mat` (1-based trainNdxs/testNdxs) under data_dir/nyu."""
    import h5py
    import scipy.io

    n = n_train + n_test
    h, w = NYU_DEPTH_HW
    scenes = _nyu_scenes(np, n, seed=5)
    os.makedirs(f"{data_dir}/nyu", exist_ok=True)
    with h5py.File(f"{data_dir}/nyu/nyu_depth_v2_labeled.mat", "w") as f:
        images = f.create_dataset("images", (n, 3, w, h), np.uint8)
        depths = f.create_dataset("depths", (n, w, h), np.float32)
        refs = []
        for i in range(n):
            img, depth = scenes[i]
            images[i] = img.transpose(2, 1, 0)
            depths[i] = depth.T
            name = f"scene_{i // 4:04d}"
            refs.append(f.create_dataset(f"#refs#/s{i}", data=np.array(
                [[ord(c)] for c in name], dtype=np.uint16)).ref)
        f.create_dataset("scenes", data=np.array(
            refs, dtype=h5py.ref_dtype).reshape(1, -1))
    scipy.io.savemat(f"{data_dir}/nyu/splits.mat", {
        "trainNdxs": np.arange(1, n_train + 1).reshape(-1, 1),
        "testNdxs": np.arange(n_train + 1, n + 1).reshape(-1, 1)})


def slice6_data(torch, np, cli, data_dir):
    """Phase 8 data: NYU through its loader and `cli prepare` when h5py is
    there (else the same scenes packed as nyu records), Make3D-shaped
    scenes (480x640 RGB, 305x55 grid) packed as make3d records. Returns
    which NYU route ran."""
    from ann3depth_tpu_torch.data import records
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset

    out = f"{data_dir}/records"
    try:
        import h5py  # noqa: F401
        route = "nyu_depth_v2_labeled.mat + cli prepare"
    except ImportError:
        route = "nyu records packed directly (no h5py)"
    t0 = time.perf_counter()
    if route.startswith("nyu_depth"):
        write_nyu_mat(np, data_dir, *NYU_SPLIT)
        for split, n in zip(("train", "test"), NYU_SPLIT):
            line = _cli_json(cli, ["prepare", "--dataset", "nyu",
                                   "--data-dir", data_dir, "--split", split])
            check(line["examples"] == n and line["index"] == (
                f"{out}/nyu-{split}-index.json"), f"prepare nyu: {line}")
    else:
        scenes = _nyu_scenes(np, sum(NYU_SPLIT), seed=5)
        for split, idx in (("train", range(NYU_SPLIT[0])),
                           ("test", range(NYU_SPLIT[0], sum(NYU_SPLIT)))):
            records.pack(_Named("nyu", [scenes[i] for i in idx]), out, split)
    for split, n, seed in (("train", MAKE3D_SPLIT[0], 3),
                           ("test", MAKE3D_SPLIT[1], 4)):
        records.pack(_Named("make3d", SyntheticDepthDataset(
            n=n, img_hw=RAW_HW, depth_hw=MAKE3D_DEPTH_HW, seed=seed)),
            out, split)
    seconds = time.perf_counter() - t0
    print(f"slice6 nyu data: {route}", flush=True)
    return route, seconds


@contextlib.contextmanager
def step_losses(steplib, losses):
    """Within the block: every train or distill step's loss (device
    scalars) appended to `losses`: an eager step's from the step, a
    replayed K=1 step's from its `BlockRunner` call (a replay runs no
    Python; a K-step block's replays are not seen)."""
    from ann3depth_tpu_torch.train import dispatch

    inner = steplib.train_step, steplib.distill_train_step
    run, in_call = dispatch.BlockRunner.run, [False]

    def wrap(fn):
        def step(*args, **kw):
            state, metrics = fn(*args, **kw)
            if not in_call[0]:
                losses.append(metrics["loss"])
            return state, metrics
        return step

    def call(self, item, more=True):
        if self.k != 1:
            return run(self, item, more)
        in_call[0] = True
        try:
            metrics = run(self, item, more)
        finally:
            in_call[0] = False
        losses.append(metrics["loss"])
        return metrics

    steplib.train_step, steplib.distill_train_step = map(wrap, inner)
    dispatch.BlockRunner.run = call
    try:
        yield losses
    finally:
        steplib.train_step, steplib.distill_train_step = inner
        dispatch.BlockRunner.run = run


@contextlib.contextmanager
def eager_twin():
    """Within the block the train loop runs its K=1 steps eagerly on the
    card, as the twin that a step graph is held against (a K-step block
    still replays its graph)."""
    from ann3depth_tpu_torch.train import dispatch

    real = dispatch.eager_reason
    dispatch.eager_reason = lambda state, device: "held as the eager twin"
    try:
        yield
    finally:
        dispatch.eager_reason = real


@contextlib.contextmanager
def _recording(fp, steplib):
    """Within the block: every loss of a train or distill step (device
    scalars, `step_losses`), the shape and mode of every v1 call run in
    Python (eager, or recorded into a graph), and the loop's log messages
    at WARNING and above."""
    import logging

    seen = dict(losses=[], calls=[], warnings=[])
    kernel = fp.fused_preprocess

    def recorded(x, params, *, out_hw, depth_mode=False, **kw):
        seen["calls"].append((tuple(x.shape), depth_mode))
        return kernel(x, params, out_hw=out_hw, depth_mode=depth_mode, **kw)

    class Handler(logging.Handler):
        def emit(self, record):
            seen["warnings"].append(record.getMessage())

    handler = Handler(logging.WARNING)
    logging.getLogger("ann3depth_tpu_torch").addHandler(handler)
    try:
        with step_losses(steplib, seen["losses"]), fed_by(fp, recorded):
            yield seen
    finally:
        logging.getLogger("ann3depth_tpu_torch").removeHandler(handler)


def _losses_fall(np, losses, n, label):
    losses = np.asarray([float(x) for x in losses])
    check(bool(np.isfinite(losses).all()), f"{label}: non-finite losses")
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    check(last < first, f"{label}: the loss did not fall: mean of the first "
          f"{n} steps {first}, of the last {n} {last}")
    return first, last


def _step_cost(torch, fn, iters=10):
    """(ms per call between two synchronizations after 2 warm calls, peak
    memory allocated in those calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / iters * 1e3,
            torch.cuda.max_memory_allocated())


def _fixed_batch(torch, cfg):
    """The first batch of cfg's first training set, in order, on the card,
    and the step's shape arguments."""
    from ann3depth_tpu_torch.train import loop

    img_np, dep_np = next(loop.build_dataset(cfg).batches(
        cfg.train.batch_size, steps=1, shuffle=False))
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg))
    return (torch.from_numpy(img_np).cuda(), torch.from_numpy(dep_np).cuda(),
            kw)


def accum_costs(torch, cfg):
    """Time a step and peak memory at grad_accum 1 and ACCUM, from fresh
    states, on one fixed batch, augment off."""
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    img, dep, kw = _fixed_batch(torch, cfg)
    costs = {}
    for a in (1, ACCUM):
        state = loop.create_state(cfg, img.device)
        ms, peak = _step_cost(torch, lambda: steplib.train_step(
            state, img, dep, grad_accum=a, **kw))
        costs[f"accum{a}"] = dict(step_ms=ms, images_per_s=len(img) / ms
                                  * 1e3, max_memory_allocated_bytes=peak)
        del state
    return costs


def accum_parity(torch, np, cfg, card, label):
    """From one state and one fixed batch of the config's first training
    set, augment off: one grad_accum=ACCUM step against one full-batch
    step (loss within STEP_LOSS_RTOL; params within 2 lr everywhere and
    lr/2 on all but 1% of the entries, as a flipped first Adam step
    allows), then each step's time and peak memory."""
    import dataclasses

    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_steps=0))
    img, dep, kw = _fixed_batch(torch, cfg)
    dev = img.device
    full, accum = loop.create_state(cfg, dev), loop.create_state(cfg, dev)
    _, m_full = steplib.train_step(full, img, dep, **kw)
    _, m_accum = steplib.train_step(accum, img, dep, grad_accum=ACCUM, **kw)
    lr = cfg.train.learning_rate
    with torch.no_grad():
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(
            full.model.parameters(), accum.model.parameters())])
    l_full, l_accum = float(m_full["loss"]), float(m_accum["loss"])
    check(abs(l_accum - l_full) <= STEP_LOSS_RTOL * abs(l_full),
          f"{label}: accum-{ACCUM} loss {l_accum}, full-batch {l_full}")
    share = float((diff > lr / 2).float().mean())
    check(float(diff.max()) <= 2 * lr + 1e-6 and share <= 0.01,
          f"{label}: params part by {float(diff.max())} (lr {lr}); "
          f"{share} of them by more than lr/2")
    del full, accum
    out = dict(batch=len(img), loss_full=l_full, loss_accum=l_accum,
               params_max_abs_diff=float(diff.max()),
               params_share_over_half_lr=share, lr=lr,
               loss_rtol=STEP_LOSS_RTOL, cost=accum_costs(torch, cfg),
               card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def slice6_phase(torch, np, fp, card, tmp, encdec_ckpt, phase4_loop_ips):
    """Phase 8: NYU and packed records, multi-dataset training, grad
    accumulation, distillation and the loop's stop/best/rollback/trace
    options at full width, through the CLI. Returns the v1 launches of
    each path."""
    import dataclasses
    import glob
    import importlib.util

    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib
    from ann3depth_tpu_torch.train.checkpoint import CheckpointManager

    data = f"{tmp}/data"
    route, data_s = slice6_data(torch, np, cli, data)
    launches = {}

    # nyu-encdec-aug at full width, b16 in microbatches of 8, on NYU and
    # Make3D records batch by batch, with every option of the loop.
    ck, wd, prof = f"{tmp}/s6_ckpt", f"{tmp}/s6_work", f"{tmp}/s6_trace"
    every = str(SLICE6_EVERY)
    base = ["train", "--config", "nyu-encdec-aug", "--datasets", "nyu",
            "make3d", "--data-dir", data, "--ckpt-dir", ck, "--workdir", wd,
            "--grad-accum", str(ACCUM), "--warmup-steps", "10",
            "--log-every", every, "--checkpoint-every", every,
            "--eval-every", every, "--early-stop-patience",
            str(SLICE6_PATIENCE), "--save-best"]
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as graphed, _recording(fp, steplib) as seen:
        _cli_json(cli, base + ["--steps", str(SLICE6_STEPS), "--tensorboard",
                               "--profile", prof, "--profile-steps", "3"])
    train_s = time.perf_counter() - t0
    n_train = graphed["launches"]
    steps_run = len(seen["losses"])
    first, last = _losses_fall(np, seen["losses"], 10, "slice6 train")
    with open(f"{wd}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    evals = [r["step"] for r in records if "eval_rmse" in r]
    stopped_early = steps_run < SLICE6_STEPS
    check(steps_run == SLICE6_STEPS or (stopped_early and evals
                                        and evals[-1] == steps_run),
          f"slice6 train ran {steps_run} steps; evals at {evals}")
    # The step: eager at each dataset's first batch, then a graph of each
    # raw shape (NYU's, Make3D's) replayed; each in-loop eval: the eval
    # step's graphs (a capture for each batch shape, its warm call eager),
    # a replay a batch, and viz's forward.
    v1_train = train_v1(graphed, steps_run, 2 * ACCUM, "slice6 train",
                        evals=len(evals))
    check(graphed["steps_captured"] == 2
          and graphed["steps_replayed"] == steps_run - 2,
          f"slice6 train: not a graph of each raw shape: {graphed}")
    cli_batch = get_config("nyu-encdec-aug").train.batch_size
    micro = cli_batch // ACCUM
    depth_shapes = {s for s, d in seen["calls"] if d and s[0] == micro}
    want = {(micro, *NYU_DEPTH_HW, 1), (micro, *MAKE3D_DEPTH_HW, 1)}
    check(depth_shapes == want, f"slice6 train: the kernel took depth "
          f"microbatches {sorted(depth_shapes)}, not {sorted(want)}")
    check(os.path.exists(f"{ck}/best_metric.json")
          and CheckpointManager(f"{ck}/best").all_steps(),
          "slice6 train: no best/ checkpoint or best_metric.json")
    with open(f"{ck}/best_metric.json") as f:
        best = json.load(f)
    tb_present = importlib.util.find_spec("tensorboard") is not None
    events = glob.glob(f"{wd}/tb/events.out.tfevents.*")
    check(events if tb_present else any(
        "tensorboard unavailable" in m for m in seen["warnings"]),
        f"slice6 train: tensorboard {tb_present}, events {events}")
    traces = glob.glob(f"{prof}/*.json")
    check(len(traces) == 1, f"slice6 train: trace files {traces}")
    with open(traces[0]) as f:
        trace_text = f.read()
    before = CheckpointManager(ck).all_steps()

    # Roll back to ROLLBACK_TO and run on to ROLLBACK_STEPS.
    with graph_runs(torch, fp) as rolled_graphs, \
            _recording(fp, steplib) as rolled:
        _cli_json(cli, base + ["--steps", str(ROLLBACK_STEPS),
                               "--resume-step", str(ROLLBACK_TO)])
    n_rollback = rolled_graphs["launches"]
    rolled_evals = len([s for s in range(ROLLBACK_TO + 1,
                                         ROLLBACK_STEPS + 1)
                        if s % SLICE6_EVERY == 0])
    v1_rollback = train_v1(rolled_graphs, ROLLBACK_STEPS - ROLLBACK_TO,
                           2 * ACCUM, "slice6 rollback",
                           evals=rolled_evals)
    after = CheckpointManager(ck).all_steps()
    deleted = sorted(int(m.rsplit(" ", 1)[1]) for m in rolled["warnings"]
                     if m.startswith("rollback resume: deleting"))
    check(deleted == [s for s in before if s > ROLLBACK_TO]
          and len(rolled["losses"]) == ROLLBACK_STEPS - ROLLBACK_TO
          and after[-1] == ROLLBACK_STEPS
          and all(s <= ROLLBACK_STEPS for s in after),
          f"rollback: checkpoints {before} -> {after}, deleted {deleted}, "
          f"{len(rolled['losses'])} steps")

    # Per-dataset eval of the rolled-back checkpoint.
    with graph_runs(torch, fp) as graphed:
        metrics = _cli_json(cli, ["eval", "--config", "nyu-encdec-aug",
                                  "--datasets", "nyu", "make3d",
                                  "--data-dir", data, "--ckpt-dir", ck,
                                  "--max-batches", "1"])
    n_eval = v1_runs(graphed, 2, "slice6 eval")
    check(sorted(metrics) == ["make3d", "nyu"] and _all_finite(np, metrics)
          and n_eval == 4, f"slice6 eval: {n_eval} v1 runs, {graphed}, "
          f"{metrics}")
    train_out = dict(
        nyu_route=route, data_s=data_s, steps=steps_run,
        stopped_early=stopped_early, batch=cli_batch, grad_accum=ACCUM,
        losses_first10_mean=first, losses_last10_mean=last,
        losses=[float(x) for x in seen["losses"]], first_run_s=train_s,
        eval_rmse=[(r["step"], r["eval_rmse"]) for r in records
                   if "eval_rmse" in r],
        loop_images_per_s=[r["images_per_sec"] for r in records
                           if "images_per_sec" in r],
        launches=n_train, v1_runs=v1_train, step_graphs=graphed,
        depth_microbatches=sorted(depth_shapes),
        best=best, tensorboard_present=tb_present, event_files=len(events),
        trace_file_bytes=len(trace_text),
        trace_has_kernel="band_resample_kernel" in trace_text,
        rollback=dict(before=before, after=after, deleted=deleted,
                      launches=n_rollback, v1_runs=v1_rollback),
        eval=dict(metrics=metrics, launches=n_eval), card=card)
    print("slice6 train: " + json.dumps(train_out), flush=True)
    launches.update(nyu_encdec_train=n_train, rollback=n_rollback,
                    eval=n_eval)

    base_cfg = get_config("nyu-encdec-aug")
    nyu_cfg = dataclasses.replace(
        base_cfg, data=dataclasses.replace(base_cfg.data, data_dir=data,
                                           augment=False))
    accum_parity(torch, np, nyu_cfg, card, "slice6 accum")

    # dpt-384 from the NYU records, b16 in microbatches of 8.
    dpt = get_config("dpt-384")
    dpt = dataclasses.replace(
        dpt, data=dataclasses.replace(dpt.data, data_dir=data, augment=True),
        train=dataclasses.replace(dpt.train, steps=DPT_ACCUM_STEPS,
                                  grad_accum=ACCUM, log_every=5,
                                  checkpoint_every=0, eval_every=0,
                                  ckpt_dir=f"{tmp}/s6_dpt"))
    with graph_runs(torch, fp) as dpt_graphs, \
            _recording(fp, steplib) as seen:
        loop.train(dpt, workdir=f"{tmp}/s6_dpt", progress=False)
    n_dpt = dpt_graphs["launches"]
    dpt_losses = [float(x) for x in seen["losses"]]
    v1_dpt = train_v1(dpt_graphs, DPT_ACCUM_STEPS, 2 * ACCUM, "slice6 dpt")
    check(len(dpt_losses) == DPT_ACCUM_STEPS
          and bool(np.isfinite(dpt_losses).all()),
          f"slice6 dpt: {len(dpt_losses)} steps, losses {dpt_losses}")
    print("slice6 dpt: " + json.dumps(dict(
        steps=DPT_ACCUM_STEPS, losses=dpt_losses, launches=n_dpt,
        v1_runs=v1_dpt, step_graphs=dpt_graphs,
        cost=accum_costs(torch, dpt), card=card)), flush=True)
    launches["dpt_train"] = n_dpt

    # make3d-small (b1) distilled from phase 4's encdec checkpoint.
    dwd = f"{tmp}/s6_distill"
    with graph_runs(torch, fp) as distill_graphs, \
            _recording(fp, steplib) as seen:
        _cli_json(cli, ["train", "--config", "make3d-small", "--datasets",
                        "make3d", "--data-dir", data, "--ckpt-dir", dwd,
                        "--workdir", dwd, "--steps", str(DISTILL_STEPS),
                        "--warmup-steps", "0", "--learning-rate", "1e-3",
                        "--log-every", "1", "--checkpoint-every", "0",
                        "--eval-every", "0", "--distill-from", encdec_ckpt,
                        "--distill-model", "encdec"])
    n_distill = distill_graphs["launches"]
    v1_distill = train_v1(distill_graphs, DISTILL_STEPS, 2, "slice6 distill")
    with open(f"{dwd}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == DISTILL_STEPS and all(
        np.isfinite(r[k]) for r in rows for k in ("distill", "gt_loss")),
        f"slice6 distill: {rows[-1:]}")
    d_first, d_last = _losses_fall(np, [r["loss"] for r in rows], 5,
                                   "slice6 distill")
    print("slice6 distill: " + json.dumps(dict(
        steps=DISTILL_STEPS, teacher=encdec_ckpt, loss_first5_mean=d_first,
        loss_last5_mean=d_last, gt_loss=[r["gt_loss"] for r in rows],
        distill=[r["distill"] for r in rows], launches=n_distill,
        v1_runs=v1_distill, step_graphs=distill_graphs,
        card=card)), flush=True)
    launches["distill"] = n_distill

    # The loop's rate reading records, against phase 4's host-made scenes.
    enc = get_config("make3d-encdec")
    enc = dataclasses.replace(
        enc, data=dataclasses.replace(enc.data, data_dir=data, augment=True),
        train=dataclasses.replace(enc.train, steps=RECORDS_LOOP_STEPS,
                                  warmup_steps=10, log_every=10,
                                  checkpoint_every=0, eval_every=0,
                                  ckpt_dir=f"{tmp}/s6_rate"))
    with graph_runs(torch, fp) as rate_graphs:
        loop.train(enc, workdir=f"{tmp}/s6_rate", progress=False)
    n_rate = rate_graphs["launches"]
    with open(f"{tmp}/s6_rate/metrics.jsonl") as f:
        rates = [json.loads(line)["images_per_sec"] for line in f]
    v1_rate = train_v1(rate_graphs, RECORDS_LOOP_STEPS, 2, "records loop")
    print("slice6 loop rate: " + json.dumps(dict(
        records_images_per_s=rates, host_scenes_images_per_s=phase4_loop_ips,
        v1_runs=v1_rate,
        batch=enc.train.batch_size, card=card)), flush=True)
    launches["records_loop"] = n_rate
    return launches


class _InMemory:
    """The examples of a dataset, made once and held in host memory (every
    run of phase 9 reads them), with the loader protocol's `batches`. With
    `mark`, pixel (0, 0) of each image carries the example's index in its
    first two channels (index % 256, index // 256)."""

    def __init__(self, np, dataset, mark=False):
        self.items = []
        for i in range(len(dataset)):
            img, dep = dataset[i]
            img = np.array(img)
            if mark:
                img[0, 0, :2] = (i % 256, i // 256)
            self.items.append((img, np.asarray(dep)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def batches(self, batch_size, **kw):
        from ann3depth_tpu_torch.data.batching import iter_batches
        return iter_batches(self, batch_size, **kw)


def trace_stats(path, steps):
    """What one Chrome trace of the loop's profiler window holds, per
    traced step: CUDA kernels (all, and the v1 kernel's resample and
    photometric launches), the device's busy time (the union of the
    kernels' intervals) and its share of the window (first event to last),
    and the host's kernel-launch and graph-launch calls; and the v1
    resample launches of each graph replay, in order. Kernels that a
    graph replay runs appear in the trace one by one, as eager ones do."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    calls = [e["name"] for e in runtime]
    # A replay's kernels carry the correlation id of its graph launch.
    resample, by_launch = {}, {}
    for e in kernels:
        c = e.get("args", {}).get("correlation")
        if "band_resample_kernel" in e["name"]:
            resample[c] = resample.get(c, 0) + 1
        by_launch.setdefault(c, []).append(e["name"])
    launches = [e.get("args", {}).get("correlation")
                for e in sorted(runtime, key=lambda e: e["ts"])
                if "GraphLaunch" in e["name"]]
    per_replay = [resample.get(c, 0) for c in launches]
    gn_per_replay = [list(gn_kernels(by_launch.get(c, [])).values())
                     for c in launches]
    busy, end = 0.0, float("-inf")
    for e in kernels:
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) if events else 0.0
    return dict(
        traced_steps=steps, kernels_per_step=len(kernels) / steps,
        v1_resample_per_step=sum("band_resample_kernel" in e["name"]
                                 for e in kernels) / steps,
        v1_photometric_per_step=sum("photometric_kernel" in e["name"]
                                    for e in kernels) / steps,
        v1_resample_per_replay=per_replay,
        gn_kernels_per_replay=gn_per_replay,
        device_busy_ms_per_step=busy / 1e3 / steps,
        window_ms_per_step=span / 1e3 / steps,
        busy_share=busy / span if span else None,
        kernel_launch_calls_per_step=sum("LaunchKernel" in n
                                         for n in calls) / steps,
        graph_launch_calls_per_step=sum("GraphLaunch" in n
                                        for n in calls) / steps)


def _traced_steps(steps, k, profile_steps):
    """(first, end) step of the loop's profiler window (train/loop.py):
    it traces steps first .. end - 1."""
    n_iters = steps // k
    start = min(5 if k == 1 else 1, max(0, n_iters - 1))
    stop = min(start + max(1, -(-profile_steps // k)), n_iters)
    return start * k, stop * k


def _steady_ms(rows, batch, after):
    """Step ms from the loop's logged images/s over the log intervals that
    start at or after step `after` (past the warm-up and the profiler
    window), else the last interval."""
    ips, prev = [], 0
    for r in rows:
        if "images_per_sec" in r:
            if prev >= after:
                ips.append(r["images_per_sec"])
            prev = r["step"]
    if not ips:
        ips = [[r["images_per_sec"] for r in rows
                if "images_per_sec" in r][-1]]
    return batch / (sum(ips) / len(ips)) * 1e3


def pool_run(torch, fp, cfg, tmp, name, dataset=None, profile=True,
             eager=True):
    """One `train.loop.train` run of phase 9 in its own directory (at K=1
    the eager twin, `eager_twin`, unless `eager` is False: the reference a
    K-step graph is held against, in phases 9, 10, 11 and 13): its
    state and last metrics, seconds, v1 calls counted in Python, peak
    memory above what was allocated when it started, logged losses and
    images/s, the step time of the unprofiled log intervals past the
    warm-up and the profiler window, and (with `profile`) the stats of
    the loop's profiler window over PROFILE_STEPS steps."""
    import dataclasses
    import glob

    from ann3depth_tpu_torch.train import loop

    work = f"{tmp}/p9_{name}"
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=f"{work}/ckpt",
        profile_dir=f"{work}/trace" if profile else "",
        profile_steps=PROFILE_STEPS))
    k = cfg.train.steps_per_dispatch
    fp.fused_preprocess.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier runs' states, kept
    t0 = time.perf_counter()
    with eager_twin() if k == 1 and eager else contextlib.nullcontext():
        state, last = loop.train(cfg, workdir=work, dataset=dataset,
                                 progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(f"{work}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    first, end = _traced_steps(cfg.train.steps, k, PROFILE_STEPS)
    out = dict(
        steps=cfg.train.steps, k=k, seconds=seconds,
        v1_calls_counted=fp.fused_preprocess.launches,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated() - held,
        logged=[(r["step"], r["loss"]) for r in rows if "loss" in r],
        loop_images_per_s=[r["images_per_sec"] for r in rows
                           if "images_per_sec" in r],
        step_ms=_steady_ms(rows, cfg.train.batch_size,
                           end if profile else max(k, 5)))
    if profile:
        traces = glob.glob(f"{work}/trace/*.json")
        check(len(traces) == 1, f"{name}: trace files {traces}")
        out["trace"] = trace_stats(traces[0], end - first)
    return state, last, out


def param_gap(torch, a, b):
    """(largest |a - b| over the params, largest excess of |a - b| over
    GRAPH_PARAM_ATOL + GRAPH_PARAM_RTOL |b|; <= 0 is within)."""
    worst = excess = float("-inf")
    with torch.no_grad():
        for x, y in zip(a.model.parameters(), b.model.parameters()):
            d = (x - y).abs()
            worst = max(worst, float(d.max()))
            excess = max(excess, float((d - GRAPH_PARAM_ATOL
                                        - GRAPH_PARAM_RTOL * y.abs()).max()))
    return worst, excess


def graph_pair(torch, np, fp, cfg, tmp, name, k, card, dataset=None,
               profile=False, keep=None):
    """cfg's run at K=1 (eager) and at K=k (graph replays) from one seed
    and one pool: params within GRAPH_PARAM_RTOL/ATOL, the last loss
    within GRAPH_LOSS_RTOL, and the v1 kernel called in every eager step
    (2 a step and microbatch) and in no replayed one (replays run no
    Python; the profiler counts them). Returns both runs' records; with a
    `keep` dict, also puts {K: (host params, last metrics)} of both runs
    there (phase 11 reruns them in a process group)."""
    import dataclasses

    accum = cfg.train.grad_accum
    eager, m1, r1 = pool_run(torch, fp, cfg, tmp, f"{name}_k1", dataset,
                             profile)
    graph, mk, rk = pool_run(torch, fp, dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, steps_per_dispatch=k)),
        tmp, f"{name}_k{k}", dataset, profile)
    worst, excess = param_gap(torch, graph, eager)
    loss_gap = abs(mk["loss"] - m1["loss"]) / abs(m1["loss"])
    steps = cfg.train.steps
    check(eager.step == graph.step == steps, f"{name}: steps {eager.step}, "
          f"{graph.step}")
    check(bool(np.isfinite([m1["loss"], mk["loss"]]).all()),
          f"{name}: losses {m1['loss']}, {mk['loss']}")
    check(r1["v1_calls_counted"] == 2 * accum * steps
          and rk["v1_calls_counted"] == 2 * accum * k,
          f"{name}: v1 called {r1['v1_calls_counted']} times eagerly and "
          f"{rk['v1_calls_counted']} times at K={k} in {steps} steps")
    out = dict(preset_model=cfg.model.name, batch=cfg.train.batch_size,
               grad_accum=accum, augment=cfg.data.augment, k=k,
               params_max_abs_diff=worst, params_excess_over_tol=excess,
               loss_rel_diff=loss_gap, eager=r1, graph=rk, card=card)
    if keep is not None:
        for kk, state, last in ((1, eager, m1), (k, graph, mk)):
            keep[kk] = ({n: v.detach().cpu() for n, v
                         in state.model.state_dict().items()}, last)
    del eager, graph
    torch.cuda.empty_cache()
    return out


def _pair_gap(torch, x, y):
    """(largest |param gap|, relative gap of the last loss) of two
    pool_run results."""
    return (param_gap(torch, x[0], y[0])[0],
            abs(x[1]["loss"] - y[1]["loss"]) / abs(y[1]["loss"]))


def dpt_graph_control(torch, fp, cfg, tmp, name, card, profile=False):
    """A DPT whose runs part (phases 9 and 13a): cfg at K=1
    DPT_CONTROL_RUNS times (the control) and once at K=DPT_K, the graph
    run held against the first K=1 run within twice the largest gap of
    the K=1 pairs (never tighter than GRAPH_*), the v1 kernel twice an
    eager step. With `profile`, the first K=1 run and the graph run are
    traced. Returns the record, the K=1 runs and the graph run."""
    import dataclasses

    steps = cfg.train.steps
    eager = [pool_run(torch, fp, cfg, tmp, f"{name}_k1_{i}",
                      profile=profile and i == 0)
             for i in range(DPT_CONTROL_RUNS)]
    graph = pool_run(torch, fp, dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, steps_per_dispatch=DPT_K)),
        tmp, f"{name}_k{DPT_K}", profile=profile)
    pairs = [_pair_gap(torch, eager[i], eager[j])
             for i in range(DPT_CONTROL_RUNS) for j in range(i)]
    control = tuple(max(p[m] for p in pairs) for m in (0, 1))
    graph_gap = _pair_gap(torch, graph, eager[0])
    allowed = (max(2 * control[0], GRAPH_PARAM_ATOL),
               max(2 * control[1], GRAPH_LOSS_RTOL))
    check(graph_gap[0] <= allowed[0] and graph_gap[1] <= allowed[1]
          and graph[2]["v1_calls_counted"] == 2 * DPT_K
          and all(r[2]["v1_calls_counted"] == 2 * steps for r in eager),
          f"{name}: K={DPT_K} against K=1 apart by {graph_gap} (params max "
          f"abs, loss rel), allowed {allowed} (twice the largest K=1 pair "
          f"gap, of {pairs}); v1 calls "
          f"{[r[2]['v1_calls_counted'] for r in eager]}, "
          f"{graph[2]['v1_calls_counted']}")
    record = dict(steps=steps, k=DPT_K, control_pairs=pairs,
                  control_gap=control, graph_gap=graph_gap, allowed=allowed,
                  eager=eager[0][2],
                  eager_step_ms=[r[2]["step_ms"] for r in eager],
                  graph=graph[2], card=card)
    return record, eager, graph


def _window_mb(ex_bytes, examples, batch):
    """The smallest --cache-window-mb whose window holds `examples` rows
    by the sampler's own arithmetic (pipeline/streaming_pool.py)."""
    mb = -(-examples * ex_bytes // (1 << 20))
    check(((mb << 20) // ex_bytes) // batch * batch == examples,
          f"no window of {examples} examples at {mb} MB")
    return mb


@contextlib.contextmanager
def _window_ids(torch, streaming_pool, seen):
    """Within the block: the example index of every row each index block
    of a window pool gathers (read from the active window's marked pixel
    just before the block runs)."""
    cls = streaming_pool.StreamingPoolSampler
    real = cls.index_blocks

    def spy(self, k):
        for block in real(self, k):
            px = self.pool_img[block.reshape(-1)][:, 0, 0, :2].long().cpu()
            seen.extend((px[:, 0] + 256 * px[:, 1]).tolist())
            yield block

    cls.index_blocks = spy
    try:
        yield seen
    finally:
        cls.index_blocks = real


@contextlib.contextmanager
def _auto_record():
    """Within the block: the (staging s, pass s, batches, factor) of each
    `--window-epochs auto` calibration the streaming pool logs."""
    import logging

    seen = []

    class Handler(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("auto window-epochs:"):
                seen.append(record.args[:4])

    logger = logging.getLogger("ann3depth_tpu_torch.pipeline.streaming_pool")
    handler, level = Handler(logging.INFO), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _cli_feed_run(torch, np, fp, cli, steplib, data, tmp, name, extra):
    """`cli train` of make3d-encdec (b16, augmented) from phase 8's Make3D
    records, FEED_STEPS steps through the host feed (DeviceFeed), with
    `extra` flags; the losses must fall."""
    import glob

    work = f"{tmp}/p9_{name}"
    argv = ["train", "--config", "make3d-encdec", "--datasets", "make3d",
            "--data-dir", data, "--steps", str(FEED_STEPS),
            "--warmup-steps", "10", "--log-every", "10",
            "--checkpoint-every", str(FEED_STEPS), "--eval-every", "0",
            "--augment", "--profile", f"{work}/trace", "--profile-steps",
            str(PROFILE_STEPS), "--ckpt-dir", f"{work}/ckpt", "--workdir",
            work, *extra]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as graphed, _recording(fp, steplib) as seen:
        last = _cli_json(cli, argv)
    seconds = time.perf_counter() - t0
    v1 = train_v1(graphed, FEED_STEPS, 2, name)
    check(len(seen["losses"]) == FEED_STEPS and graphed["steps_captured"]
          == 1, f"{name}: {len(seen['losses'])} steps, {graphed}")
    first, last10 = _losses_fall(np, seen["losses"], 10, name)
    with open(f"{work}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    traces = glob.glob(f"{work}/trace/*.json")
    check(len(traces) == 1, f"{name}: trace files {traces}")
    traced, end = _traced_steps(FEED_STEPS, 1, PROFILE_STEPS)
    return dict(flags=extra, seconds=seconds, loss=last["loss"],
                v1_runs=v1, step_graphs=graphed,
                losses_first10_mean=first, losses_last10_mean=last10,
                loop_images_per_s=[r["images_per_sec"] for r in rows],
                step_ms=_steady_ms(rows, 16, end),
                max_memory_allocated_bytes=(torch.cuda.max_memory_allocated()
                                            - held),
                trace=trace_stats(traces[0], end - traced))


def dpt_pool_config(data):
    """dpt-384 (b16, augmented) from phase 8's NYU records under `data` in
    the device pool, DPT_POOL_STEPS steps at K=1 (phases 9 and 13)."""
    import dataclasses

    from ann3depth_tpu_torch.config import get_config

    dpt = get_config("dpt-384")
    return dataclasses.replace(
        dpt, data=dataclasses.replace(dpt.data, data_dir=data,
                                      cache_device=True, augment=True),
        train=dataclasses.replace(dpt.train, steps=DPT_POOL_STEPS,
                                  log_every=5, checkpoint_every=0,
                                  eval_every=0))


def pipeline_phase(torch, np, fp, card, tmp, encdec_cfg, handoff):
    """Phase 9: the input pipeline and the K-step CUDA graph at full
    width. Returns the v1 launches of its paths: counted in Python for the
    eager steps, and per step from the profiler's trace of replayed
    blocks. Puts the plain encdec pair's config, scenes and results in
    `handoff` (phase 11 reruns it in a one-rank process group)."""
    import dataclasses

    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
    from ann3depth_tpu_torch.pipeline import streaming_pool
    from ann3depth_tpu_torch.train import step as steplib

    data = f"{tmp}/data"  # phase 8's records
    out, launches = {}, {}

    # make3d-encdec (b16, full width) from a device pool of 64 scenes at
    # Make3D's raw shapes: K=1 against K=POOL_K, plain, at grad_accum 2.
    t0 = time.perf_counter()
    scenes = _InMemory(np, SyntheticDepthDataset(
        n=POOL_SCENES, img_hw=RAW_HW, depth_hw=MAKE3D_DEPTH_HW, seed=0))
    scenes_s = time.perf_counter() - t0
    enc = get_config("make3d-encdec")
    enc = dataclasses.replace(
        enc, data=dataclasses.replace(enc.data, cache_device=True),
        train=dataclasses.replace(enc.train, steps=POOL_STEPS,
                                  warmup_steps=10, log_every=10,
                                  checkpoint_every=POOL_STEPS, eval_every=0))
    pool_bytes = sum(a.nbytes + b.nbytes for a, b in scenes.items)
    for name, accum, profile in (("encdec", 1, True),
                                 ("encdec_accum", ACCUM, False)):
        cfg = dataclasses.replace(enc, train=dataclasses.replace(
            enc.train, grad_accum=accum))
        keep = {} if name == "encdec" else None
        pair = graph_pair(torch, np, fp, cfg, tmp, name, POOL_K, card,
                          scenes, profile, keep)
        if keep is not None:
            handoff.update(cfg=cfg, scenes=scenes, runs=keep)
        pair["pool_bytes"] = pool_bytes
        out[name] = pair
    # Every replayed step launches v1's resample twice. The profiler may
    # miss the first kernels of its window (seen on an H100 in eager and
    # replayed windows alike: the window's first step lost its first
    # kernels), so the first replay is reported, not held (where the trace
    # carries no correlation ids: all but one step's worth, in total).
    g = out["encdec"]["graph"]["trace"]
    replays, n = g["v1_resample_per_replay"], g["traced_steps"]
    check(len(replays) == n and (
        min(replays[1:]) >= 2 if any(replays)
        else g["v1_resample_per_step"] * n >= 2 * (n - 1)),
        f"replayed encdec steps: the profiler saw {g}")

    # nyu-encdec-aug (augmented) from phase 8's NYU records.
    aug = get_config("nyu-encdec-aug")
    aug = dataclasses.replace(
        aug, data=dataclasses.replace(aug.data, data_dir=data,
                                      cache_device=True),
        train=dataclasses.replace(aug.train, steps=POOL_STEPS,
                                  warmup_steps=10, log_every=10,
                                  checkpoint_every=POOL_STEPS, eval_every=0))
    out["nyu_aug"] = graph_pair(torch, np, fp, aug, tmp, "nyu_aug", POOL_K,
                                card)
    for name in ("encdec", "encdec_accum", "nyu_aug"):
        p = out[name]
        check(p["params_excess_over_tol"] <= 0
              and p["loss_rel_diff"] <= GRAPH_LOSS_RTOL,
              f"{name}: K={POOL_K} graph against K=1 eager: params apart "
              f"by {p['params_max_abs_diff']} (excess "
              f"{p['params_excess_over_tol']}), loss by "
              f"{p['loss_rel_diff']}")
        print(f"graph {name}: " + json.dumps(p), flush=True)

    # dpt-384 (b16) from the NYU records (its F.interpolate backward sums
    # with atomics, and two runs' losses part by 2e-5 to 1e-3 from one
    # pair to the next).
    out["dpt"], eager, graph = dpt_graph_control(
        torch, fp, dpt_pool_config(data), tmp, "dpt", card)
    print("graph dpt: " + json.dumps(out["dpt"]), flush=True)
    handoff.update(dpt=out["dpt"], encdec=out["encdec"], dpt_k1=(
        {n: v.detach().cpu() for n, v in eager[0][0].model.state_dict()
         .items()}, eager[0][1]))
    del eager, graph
    torch.cuda.empty_cache()

    # A window pool over 96 Make3D-shaped scenes in windows of 32, with
    # echoing (E=2) and K=WINDOW_K, then `--window-epochs auto`.
    wscenes = _InMemory(np, SyntheticDepthDataset(
        n=WINDOW_SCENES, img_hw=RAW_HW, depth_hw=MAKE3D_DEPTH_HW, seed=11),
        mark=True)
    img0, dep0 = wscenes[0]
    mb_ = _window_mb(img0.nbytes + dep0.nbytes, WINDOW_EXAMPLES, 16)
    wcfg = dataclasses.replace(
        enc, data=dataclasses.replace(enc.data, cache_window_mb=mb_,
                                      window_epochs=WINDOW_EPOCHS),
        train=dataclasses.replace(enc.train, steps=WINDOW_STEPS,
                                  steps_per_dispatch=WINDOW_K,
                                  log_every=WINDOW_K,
                                  checkpoint_every=WINDOW_STEPS))
    with _window_ids(torch, streaming_pool, []) as ids:
        state, _, window = pool_run(torch, fp, wcfg, tmp, "window", wscenes)
    per_pass = WINDOW_SCENES // WINDOW_EXAMPLES * (
        WINDOW_EXAMPLES // 16) * WINDOW_EPOCHS * 16
    counts = [np.bincount(ids[p:p + per_pass], minlength=WINDOW_SCENES)
              for p in range(0, len(ids), per_pass)]
    check(len(ids) == WINDOW_STEPS * 16 and len(counts) == 2 and all(
        (c == WINDOW_EPOCHS).all() for c in counts),
        f"window pool: {len(ids)} rows, per-pass counts "
        f"{[np.unique(c).tolist() for c in counts]}")
    window.update(cache_window_mb=mb_, window_examples=WINDOW_EXAMPLES,
                  scenes=WINDOW_SCENES, window_epochs=WINDOW_EPOCHS,
                  every_example_twice_a_pass=True, card=card)
    print("window pool: " + json.dumps(window), flush=True)
    del state
    acfg = dataclasses.replace(wcfg, data=dataclasses.replace(
        wcfg.data, window_epochs=0), train=dataclasses.replace(
        wcfg.train, steps=AUTO_STEPS, checkpoint_every=AUTO_STEPS))
    with _auto_record() as cal:
        state, _, auto = pool_run(torch, fp, acfg, tmp, "window_auto",
                                  wscenes, profile=False)
    with open(f"{tmp}/p9_window_auto/ckpt/window_epochs.json") as f:
        sidecar = json.load(f)
    check(len(cal) == 1 and sidecar["window_epochs"] == cal[0][3]
          and state.step == AUTO_STEPS,
          f"window auto: calibrations {cal}, sidecar {sidecar}")
    t_stage, t_pass, batches, factor = cal[0]
    auto.update(window_epochs=factor, staging_s=t_stage, pass_s=t_pass,
                batches_per_window=batches, sidecar=sidecar, card=card)
    print("window auto: " + json.dumps(auto), flush=True)
    del state
    torch.cuda.empty_cache()

    # The host feed (DeviceFeed) and the worker loader, through the CLI.
    feeds = {}
    for name, extra in (("host_feed", []),
                        ("worker_loader", ["--use-grain", "--num-workers",
                                           str(FEED_WORKERS)])):
        feeds[name] = _cli_feed_run(torch, np, fp, cli, steplib, data, tmp,
                                    name, extra)
        print(f"feed {name}: " + json.dumps({**feeds[name], "card": card}),
              flush=True)

    # eval --cache-device against the host-fed eval of phase 4's
    # checkpoint: the same bytes in the same order.
    flags = ["eval", "--config", "make3d-encdec", "--datasets", "synthetic",
             "--synth-hw", *map(str, encdec_cfg.data.synth_img_hw),
             "--synth-depth-hw", *map(str, encdec_cfg.data.synth_depth_hw),
             "--ckpt-dir", encdec_cfg.train.ckpt_dir]
    evals = {}
    for name, extra in (("host", []), ("cache_device", ["--cache-device"])):
        t0 = time.perf_counter()
        with graph_runs(torch, fp) as seen:
            metrics = _cli_json(cli, flags + extra)
        evals[name] = dict(metrics=metrics, seconds=time.perf_counter() - t0,
                           v1_calls=v1_runs(seen, 2, f"eval {name}"),
                           graphs=seen)
    host, pooled = evals["host"]["metrics"], evals["cache_device"]["metrics"]
    rel = max(abs(pooled[k] - host[k]) / max(abs(host[k]), 1e-12)
              for k in host)
    check(sorted(pooled) == sorted(host) and _all_finite(np, host)
          and rel <= EVAL_POOL_RTOL and evals["host"]["v1_calls"]
          == evals["cache_device"]["v1_calls"] > 0,
          f"eval --cache-device against host eval: {rel} relative; {evals}")
    print("eval pool: " + json.dumps(dict(runs=evals, largest_rel=rel,
                                          rtol=EVAL_POOL_RTOL, card=card)),
          flush=True)

    def row(r):
        t = r.get("trace", {})
        return dict(step_ms=r["step_ms"],
                    loop_images_per_s=r["loop_images_per_s"],
                    busy_share=t.get("busy_share"),
                    device_busy_ms_per_step=t.get("device_busy_ms_per_step"),
                    kernels_per_step=t.get("kernels_per_step"),
                    kernel_launch_calls_per_step=t.get(
                        "kernel_launch_calls_per_step"),
                    graph_launch_calls_per_step=t.get(
                        "graph_launch_calls_per_step"),
                    max_memory_allocated_bytes=r[
                        "max_memory_allocated_bytes"])

    timings = dict(host_feed=row(feeds["host_feed"]),
                   worker_loader=row(feeds["worker_loader"]),
                   pool_k1=row(out["encdec"]["eager"]),
                   **{f"graph_k{POOL_K}": row(out["encdec"]["graph"])},
                   **{f"window_k{WINDOW_K}": row(window)},
                   dpt_pool_k1=row(out["dpt"]["eager"]),
                   **{f"dpt_graph_k{DPT_K}": row(out["dpt"]["graph"])},
                   scenes_made_s=scenes_s, batch=16, card=card)
    print("pipeline timings: " + json.dumps(timings), flush=True)
    launches.update(
        pool_k1=out["encdec"]["eager"]["v1_calls_counted"],
        graph_eager_block=out["encdec"]["graph"]["v1_calls_counted"],
        graph_replayed_resample_per_step=g["v1_resample_per_step"],
        graph_replayed_photometric_per_step=g["v1_photometric_per_step"],
        encdec_accum_k1=out["encdec_accum"]["eager"]["v1_calls_counted"],
        nyu_aug_k1=out["nyu_aug"]["eager"]["v1_calls_counted"],
        dpt_k1=out["dpt"]["eager"]["v1_calls_counted"],
        window=window["v1_calls_counted"],
        window_replayed_resample_per_step=window["trace"][
            "v1_resample_per_step"],
        host_feed=feeds["host_feed"]["v1_runs"],
        worker_loader=feeds["worker_loader"]["v1_runs"],
        eval_pool=evals["cache_device"]["v1_calls"],
        method=("eager calls counted by the wrapper; a replayed graph runs "
                "no Python, so its launches are the band_resample_kernel "
                "and photometric_kernel events per step in the torch."
                "profiler trace of the loop's --profile window over "
                "replayed blocks"))
    return launches


def v1_host_dispatch(torch, fp, card):
    """Phase 2: the v1 wrapper's host time a call at the train shape, in
    turns: through the registered op (`fp.fused_preprocess`, the path),
    straight to the launch as before the registration (`fp._launch_band`),
    and through a `torch.library.custom_op` twin of the op."""
    @torch.library.custom_op("chip_smoke::v1_twin", mutates_args=(),
                             schema=fp._SCHEMA)
    def twin(frames, params, out_hw, norm, depth_mode):
        return fp._launch_band("fused_preprocess", frames, params,
                               out_hw=out_hw, norm=norm,
                               depth_mode=depth_mode)

    gen = torch.Generator(device="cuda").manual_seed(9)
    frames = torch.randint(0, 256, (16, *RAW_HW, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    params = fp.augment_params(gen, 16, RAW_HW, (240, 320), device="cuda")
    fns = dict(
        op=lambda: fp.fused_preprocess(frames, params, out_hw=(240, 320)),
        direct=lambda: fp._launch_band("fused_preprocess", frames, params,
                                       out_hw=(240, 320)),
        custom_op=lambda: twin(frames, params, [240, 320], True, False))
    runs = {k: [] for k in fns}
    for name in ("op", "direct", "custom_op", "custom_op", "direct", "op"):
        fns[name]()
        runs[name].append(host_ms(torch, fns[name], iters=200))
    out = dict({f"{k}_host_ms": min(v) for k, v in runs.items()},
               runs=runs, card=card)
    print("v1 host dispatch: " + json.dumps(out), flush=True)
    return out


def graph_ms(torch, fn, iters=20):
    """Device time a call of `fn`: `iters` calls captured in one CUDA
    graph, its replays timed with CUDA events (no host gaps between the
    kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def _op_times(torch, fns):
    """Each fn's time a call with CUDA events around eager calls (host
    gaps included) and as replays of a CUDA graph (the device's time)."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_device_ms"] = graph_ms(torch, fn)
    return out


def quant_op_cases(torch, np, card):
    """Phase 10.1: qconv at every int8 conv of make3d-encdec at the b32
    serving shapes and qmatmul at dpt-384's q/k/v/out and MLP shapes at
    b16, each against its CPU result (equal: exact int32 sums, the same f32
    quantize and dequantize) and timed with CUDA events beside the bf16
    product cuDNN or cuBLAS computes for the same shapes, and beside the
    torch._int_mm inside it alone."""
    import dataclasses

    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.models import encdec, registry
    from ann3depth_tpu_torch.ops import quant
    from ann3depth_tpu_torch.train import step as steplib

    enc = get_config("make3d-encdec")
    model = steplib.init_params(registry.build(dataclasses.replace(
        enc.model, quant="int8")), enc.data.input_hw, 0)
    layers = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args, n=n: layers.append(
            (n, args[0].shape[1:], tuple(m.weight.shape), m.stride)))
        for n, m in model.named_modules() if isinstance(m, quant.QConv)]
    with torch.no_grad():
        model(torch.zeros((1, *enc.data.input_hw, 3)))
    for h in hooks:
        h.remove()
    check(len(layers) == 12, f"encdec has {len(layers)} int8 convs")

    gen = torch.Generator().manual_seed(0)
    b = QUANT_BATCH["make3d-encdec"]
    convs, mms = [], []
    for name, chw, wshape, stride in layers:
        x = torch.randn((b, *chw), generator=gen).to(
            dtype=torch.bfloat16, memory_format=torch.channels_last)
        w = 0.05 * torch.randn(wshape, generator=gen)
        want = quant.qconv(x, w, stride)
        xc, wc = x.cuda(), w.cuda()
        got = quant.qconv(xc, wc, stride)
        check(torch.equal(got.cpu(), want),
              f"qconv {name} on the card differs from the CPU by "
              f"{float((got.cpu() - want).abs().max())}")
        m = b * want.shape[2] * want.shape[3]
        k = wshape[1] * wshape[2] * wshape[3]
        a8 = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                           device="cuda")
        w8 = torch.randint(-127, 128, (wshape[0], k), dtype=torch.int8,
                           device="cuda")
        wb = wc.to(torch.bfloat16)
        fns = dict(int8=lambda: quant.qconv(xc, wc, stride),
                   bf16_cudnn=lambda: encdec.conv2d_same(xc, wb, None,
                                                         stride),
                   int_mm=lambda: torch._int_mm(a8, w8.t()))
        convs.append(dict(layer=name, x=[b, *chw], weight=list(wshape),
                          stride=stride, **_op_times(torch, fns)))
    tokens = QUANT_BATCH["dpt-384"] * 576
    for k, n, what in ((384, 384, "q/k/v/out"), (384, 1536, "fc1"),
                       (1536, 384, "fc2")):
        x = torch.randn((QUANT_BATCH["dpt-384"], 576, k),
                        generator=gen).to(torch.bfloat16)
        w = 0.05 * torch.randn((n, k), generator=gen)
        want = quant.qmatmul(x, w)
        xc, wc = x.cuda(), w.cuda()
        got = quant.qmatmul(xc, wc)
        check(torch.equal(got.cpu(), want),
              f"qmatmul {what} on the card differs from the CPU by "
              f"{float((got.cpu() - want).abs().max())}")
        wb = wc.to(torch.bfloat16)
        a8 = torch.randint(-127, 128, (tokens, k), dtype=torch.int8,
                           device="cuda")
        w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           device="cuda")
        fns = dict(int8=lambda: quant.qmatmul(xc, wc),
                   bf16_matmul=lambda: torch.matmul(xc, wb.t()),
                   int_mm=lambda: torch._int_mm(a8, w8.t()))
        mms.append(dict(proj=what, m=tokens, k=k, n=n,
                        **_op_times(torch, fns)))
    total = {k: sum(c[k] for c in convs) for k in convs[0]
             if k.endswith("_ms")}
    out = dict(qconv_b32=convs, qmatmul_b16=mms, qconv_total=total,
               card=card)
    print("int8 ops: " + json.dumps(out), flush=True)
    return out


def _with_quant(cfg, quant):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, quant=quant))


def quant_serving(torch, np, fp, cfg, preset, card, label):
    """Phase 10.2: the checkpoint of `cfg` served at int8 (one HTTP round,
    each batch against the int8 model fed by the plain preprocess, as
    `serve_checkpoint` holds bf16), then on QUANT_BATCH training scenes the
    int8 against bf16 log-depth divergence of that checkpoint and the
    device and event ms of the serving fn, int8 and bf16 in turns."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.train import loop

    served = serve_checkpoint(torch, np, fp, _with_quant(cfg, "int8"), card,
                              label=f"{label} serve_ckpt")
    b = QUANT_BATCH[preset]
    img, _ = next(loop.build_dataset(cfg, "train").batches(
        b, steps=1, shuffle=False))
    x = torch.from_numpy(img).cuda()
    fns = {q: serving.make_serving_fn(serving.model_from_checkpoint(
        _with_quant(cfg, q), device="cuda"), cfg.data.input_hw)
        for q in ("none", "int8")}
    logs = {q: torch.log(fn(x)).cpu().numpy() for q, fn in fns.items()}
    diff = np.abs(logs["int8"] - logs["none"])
    runs = {q: [] for q in fns}
    for q in ("none", "int8", "int8", "none"):
        # Few calls a trace: the profiler's own host cost grows with the
        # ops it records, thousands a call here.
        ms, by_kind = device_ms(torch, lambda: fns[q](x), iters=5)
        runs[q].append(dict(device_ms=ms, event_ms=time_ms(lambda: fns[q](x)),
                            kernels=len(by_kind)))
    out = dict(preset=preset, batch=b, served_launches=served["launches"],
               served_log_err=served["log_depth_vs_plain_same_batch"],
               int8_vs_bf16_log_depth=dict(max=float(diff.max()),
                                           mean=float(diff.mean())),
               serving_fn=runs, card=card)
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def qat_phase(torch, np, fp, card, tmp):
    """Phase 10.4: `cli train --quant int8-qat` of make3d-encdec (full
    width, b16, augmented, Make3D's raw shapes) for QAT_STEPS steps from
    the host feed, the losses falling and v1 called twice a step; then
    from a device pool at K=1 and K=QAT_K with cuDNN's deterministic
    algorithms (`graph_pair`: phase 9's tolerances), the losses falling;
    the CLI run's checkpoint served at int8 against its own int8-qat
    forward (and against bf16)."""
    import dataclasses

    from ann3depth_tpu_torch import cli, serving
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset

    d = f"{tmp}/qat"
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as qat_graphs:
        _cli_json(cli, [
            "train", "--config", "make3d-encdec", "--quant", "int8-qat",
            "--datasets", "synthetic", "--synth-hw", *map(str, RAW_HW),
            "--synth-depth-hw", *map(str, MAKE3D_DEPTH_HW), "--synth-n",
            "64", "--augment", "--steps", str(QAT_STEPS), "--warmup-steps",
            "10", "--log-every", "1", "--checkpoint-every", str(QAT_STEPS),
            "--eval-every", "0", "--ckpt-dir", f"{d}/ckpt", "--workdir",
            f"{d}/work"])
    seconds = time.perf_counter() - t0
    launches = qat_graphs["launches"]
    qat_v1 = train_v1(qat_graphs, QAT_STEPS, 2, "qat")
    with open(f"{d}/work/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    cli_losses = [r["loss"] for r in rows if "loss" in r]
    check(len(cli_losses) == QAT_STEPS, f"qat: {len(cli_losses)} losses")
    cli_fall = _losses_fall(np, cli_losses, 5, "qat cli")

    scenes = _InMemory(np, SyntheticDepthDataset(
        n=QAT_POOL_SCENES, img_hw=RAW_HW, depth_hw=MAKE3D_DEPTH_HW, seed=3))
    enc = _with_quant(get_config("make3d-encdec"), "int8-qat")
    pool_cfg = dataclasses.replace(
        enc, data=dataclasses.replace(enc.data, cache_device=True),
        train=dataclasses.replace(enc.train, steps=QAT_POOL_STEPS,
                                  warmup_steps=10, log_every=QAT_K,
                                  checkpoint_every=QAT_POOL_STEPS,
                                  eval_every=0))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pair = graph_pair(torch, np, fp, pool_cfg, tmp, "qat", QAT_K, card,
                          scenes)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(pair["params_excess_over_tol"] <= 0
          and pair["loss_rel_diff"] <= GRAPH_LOSS_RTOL,
          f"qat: K={QAT_K} against K=1: params {pair['params_max_abs_diff']}"
          f" (excess {pair['params_excess_over_tol']}), loss "
          f"{pair['loss_rel_diff']}")
    pool_fall = {k: _losses_fall(np, [l for _, l in pair[k]["logged"]], 1,
                                 f"qat pool {k}")
                 for k in ("eager", "graph")}

    cfg = dataclasses.replace(enc, train=dataclasses.replace(
        enc.train, ckpt_dir=f"{d}/ckpt"))
    x = torch.from_numpy(np.stack([scenes[i][0] for i in range(
        QUANT_BATCH["make3d-encdec"])])).cuda()
    logs = {}
    for q in ("int8-qat", "int8", "none"):
        fn = serving.make_serving_fn(serving.model_from_checkpoint(
            _with_quant(cfg, q), device="cuda"), cfg.data.input_hw)
        logs[q] = torch.log(fn(x)).cpu().numpy()

    def gap(a, b):
        diff = np.abs(logs[a] - logs[b])
        return dict(max=float(diff.max()), mean=float(diff.mean()))

    out = dict(cli=dict(steps=QAT_STEPS, seconds=seconds, v1_calls=launches,
                        v1_runs=qat_v1, step_graphs=qat_graphs,
                        loss_first_last=cli_fall),
               pool=dict(steps=QAT_POOL_STEPS, k=QAT_K,
                         cudnn_deterministic=True,
                         eager_step_ms=pair["eager"]["step_ms"],
                         graph_step_ms=pair["graph"]["step_ms"],
                         graph_images_per_s=pair["graph"][
                             "loop_images_per_s"],
                         eager_peak_bytes=pair["eager"][
                             "max_memory_allocated_bytes"],
                         graph_peak_bytes=pair["graph"][
                             "max_memory_allocated_bytes"],
                         params_max_abs_diff=pair["params_max_abs_diff"],
                         loss_rel_diff=pair["loss_rel_diff"],
                         loss_first_last=pool_fall,
                         v1_calls=[pair["eager"]["v1_calls_counted"],
                                   pair["graph"]["v1_calls_counted"]]),
               int8_vs_qat_log_depth=gap("int8", "int8-qat"),
               int8_vs_bf16_log_depth=gap("int8", "none"), card=card)
    print("qat: " + json.dumps(out), flush=True)
    return out


def export_phase(torch, np, fp, cfg, tmp, card):
    """Phase 10.5: `cli export` of phase 4's checkpoint for any batch, at
    EXPORT_BATCH and at int8; each artifact through `serve --artifact`
    (one HTTP round, the kernel launched once a dispatched batch), its
    answers against the eager serving fn of the same weights (within
    EXPORT_RTOL) at batches 1, 8 and 32 (its own batch if fixed), and for
    the any-batch artifacts the device ms of the exported against the
    eager program at b32, in turns."""
    from ann3depth_tpu_torch import cli, server, serving
    from ann3depth_tpu_torch.probe_serving import http_round, request_bodies

    frames = np.random.default_rng(4).integers(
        0, 256, (32, *RAW_HW, 3), dtype=np.uint8)
    x32 = torch.from_numpy(frames).cuda()
    out, launches = {}, {}
    for name, extra in (("any", []),
                        (f"b{EXPORT_BATCH}",
                         ["--serving-batch", str(EXPORT_BATCH)]),
                        ("int8", ["--quant", "int8"])):
        art = f"{tmp}/artifact_{name}"
        t0 = time.perf_counter()
        meta = _cli_json(cli, ["export", "--config", "make3d-encdec",
                               "--ckpt-dir", cfg.train.ckpt_dir,
                               "--out-dir", art] + extra)
        export_s = time.perf_counter() - t0
        srv = None
        with graph_runs(torch, fp) as seen:
            svc = cli.make_service(cli.build_parser().parse_args(
                ["serve", "--artifact", art, "--max-batch", "32"]))
            try:
                server.warmup(svc)
                srv = server.DepthServer(svc, host="127.0.0.1", port=0)
                srv.serve_background()
                before = svc.stats()["batches"]
                results, elapsed = http_round(
                    f"http://127.0.0.1:{srv.port}/v1/depth",
                    request_bodies(frames))
                batches = svc.stats()["batches"] - before
                all_batches = svc.stats()["batches"]
                buckets = list(svc._buckets)
            finally:
                if srv is not None:
                    srv.close()
                else:
                    svc.close()
        # The exported program calls the registered op itself: a capture
        # records it unseen, so a graph holding it is taken on trust here
        # and shown by phase 15's trace of a replay.
        n = v1_runs(seen, 1, f"artifact {name}", recorded=False)
        check(n == all_batches > batches > 0 and seen["launches"]
              == seen["captures"] == len(buckets),
              f"artifact {name}: {n} v1 runs in {all_batches} batches: "
              f"{seen}")
        answers = [np.load(io.BytesIO(r[0])) for r in results]
        check(all(np.isfinite(a).all() and (a > 0).all() for a in answers),
              f"artifact {name}: answers not finite and positive")
        loaded = serving.load_serving(art)
        eager = serving.make_serving_fn(serving.model_from_checkpoint(
            _with_quant(cfg, meta["quant"]), device="cuda"),
            cfg.data.input_hw)
        rel = {}
        for b in ((EXPORT_BATCH,) if meta["batch"] else (1, 8, 32)):
            got = loaded.predict(frames[:b])
            want = eager(x32[:b]).cpu().numpy()
            rel[b] = float(np.abs(got / want - 1).max())
        check(max(rel.values()) <= EXPORT_RTOL,
              f"artifact {name} against the eager fn: {rel}")
        res = dict(meta=meta, export_s=export_s, buckets=buckets,
                   round_s=elapsed, round_batches=batches, launches=n,
                   graphs=seen,
                   rel_err_vs_eager=rel)
        if meta["batch"] is None:
            timed = {"exported": [], "eager": []}
            with torch.inference_mode():
                for k in ("exported", "eager", "eager", "exported"):
                    fn = loaded.model if k == "exported" else eager.fn
                    timed[k].append(dict(
                        device_ms=device_ms(torch, lambda: fn(x32),
                                            iters=5)[0],
                        event_ms=time_ms(lambda: fn(x32))))
            res["b32"] = timed
        out[name], launches[name] = res, n
    print("export: " + json.dumps(dict(out, card=card)), flush=True)
    return out, launches


def quant_export_phase(torch, np, fp, card, tmp, encdec_cfg):
    """Phase 10: int8 ops, int8 serving, int8 eval/infer/live, int8-qat
    training and the exported serving program, each part's seconds
    printed. Returns the v1 launches of its paths."""
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    ops = timed("ops", quant_op_cases, torch, np, card)
    dpt = _train_config(f"{tmp}/dpt-384", "dpt-384", NYU_DEPTH_HW)
    served = {preset: timed(f"serve {preset}", quant_serving, torch, np,
                            fp, cfg, preset, card, f"int8 {preset}")
              for preset, cfg in (("make3d-encdec", encdec_cfg),
                                  ("dpt-384", dpt))}
    cfg8 = _with_quant(encdec_cfg, "int8")
    evals, _ = timed("eval", eval_phase, torch, np, fp, cfg8, tmp, card,
                     full=False, label="eval int8")
    infer = timed("infer", infer_phase, torch, np, fp, cfg8, card,
                  transcode=False, label="infer int8")
    live = timed("live", live_cli, torch, np, fp, cfg8, "make3d-encdec",
                 tmp, card, label="live int8")
    qat = timed("qat", qat_phase, torch, np, fp, card, tmp)
    exported, export_launches = timed("export", export_phase, torch, np,
                                      fp, encdec_cfg, tmp, card)
    print("phase 10 seconds: " + json.dumps(seconds), flush=True)
    quant_launches = dict(
        serve_encdec=served["make3d-encdec"]["served_launches"],
        serve_dpt=served["dpt-384"]["served_launches"],
        eval=evals["runs"]["plain"]["launches"],
        infer=infer["image_launches"], live=live["launches"],
        qat_cli=qat["cli"]["v1_calls"], qat_pool=qat["pool"]["v1_calls"])
    return dict(ops=ops, quant_launches=quant_launches,
                export_launches=export_launches)


# ---------------------------------------------------------------------------
# Phase 11: the parallel modes (parallel/) on the one card.
# ---------------------------------------------------------------------------

# make3d-encdec b16 from phase 8's Make3D records on two ranks over gloo
# (b8 each), PAR_STEPS steps logged every PAR_EVERY, rank 0's profiler
# tracing steps PAR_EVERY..2*PAR_EVERY-1; ZeRO-1 the same; dpt-384 b16 at
# --tp 2 from the NYU records, TP_STEPS steps. ZeRO-1 against replicated
# data parallelism: the JAX test's tolerances (tests/test_zero1.py:28).
PAR_STEPS, PAR_EVERY, TP_STEPS = 15, 5, 5
ZERO1_RTOL, ZERO1_ATOL = 5e-4, 1e-3

# One rank: the port's CLI run through its `main`, with the v1 wrapper's
# launches and input shapes recorded, the optimizer state's bytes of the
# trained state, the model-axis all-reduces of tensor parallelism, and the
# time of an all-reduce of each given size on the run's backend (taken
# before the run: the CLI leaves the process group when it ends).
_RANK_MAIN = r"""
import json, sys, time
import torch
import torch.distributed as dist
from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.parallel import multihost, sharding_rules
from ann3depth_tpu_torch.train import loop
from ann3depth_tpu_torch.utils import graphs

argv, sizes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
args = cli.build_parser().parse_args(argv)
cli._join_group(args)
dev = multihost.local_device(args.device)
out = dict(rank=multihost.process_index(), world=multihost.process_count(),
           backend=multihost.backend(), device=str(dev), all_reduce=[])
for n in sizes:
    x = torch.ones(n, device=dev)
    for _ in range(3):
        dist.all_reduce(x)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize(dev)
    out["all_reduce"].append(dict(floats=n, bytes=4 * n,
                                  ms=(time.perf_counter() - t0) * 1e2))
    del x
calls = []
kernel = fp.fused_preprocess

def recorded(x, params, *, out_hw, depth_mode=False, **kw):
    calls.append((tuple(x.shape), bool(depth_mode)))
    return kernel(x, params, out_hw=out_hw, depth_mode=depth_mode, **kw)

train = loop.train

def kept(*a, **kw):
    state, metrics = train(*a, **kw)
    opt = state.optimizer
    out["optimizer_state_bytes"] = (
        opt.state_bytes() if hasattr(opt, "state_bytes") else sum(
            v.numel() * v.element_size() for st in opt.state.values()
            for v in st.values() if torch.is_tensor(v)))
    out["local_params"] = sum(p.numel() for p in state.model.parameters())
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return state, metrics

made = []
init = graphs.GraphCache.__init__

def made_cache(self, *a, **kw):
    init(self, *a, **kw)
    made.append(self)

graphs.GraphCache.__init__ = made_cache
fp.fused_preprocess, loop.train = recorded, kept
sharding_rules.collectives.update(forward=0, backward=0, update=0)
kernel.launches = 0
t0 = time.perf_counter()
rc = cli.main(argv)
torch.cuda.synchronize(dev)
out.update(rc=rc, seconds=time.perf_counter() - t0,
           v1_launches=kernel.launches, v1_calls=len(calls),
           graph_captures=sum(c.captures for c in made),
           graph_replays=sum(c.replays for c in made),
           v1_shapes=sorted({f"{list(s)}:{d}" for s, d in calls}),
           tp_collectives=dict(sharding_rules.collectives))
print("RANK " + json.dumps(out), flush=True)
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_runs(argv, sizes=(), world=2, timeout=400, refused=None):
    """The port's CLI on `world` ranks of one process group (child
    processes on this card, each through _RANK_MAIN); every child is
    stopped when this returns. Returns the ranks' records, each with the
    lines its run printed. With `refused` (an error's text), every rank
    must instead fail with that error; returns each rank's line of
    standard error that holds it."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, json.dumps(
            argv + ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                    str(world), "--process-id", str(r)]),
         json.dumps(list(sizes))],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if refused is not None:
        said = [[x for x in stderr.splitlines() if refused in x]
                for _, stderr in outs]
        check(all(p.returncode not in (0, None) and lines
                  for p, lines in zip(procs, said)),
              f"{argv[:3]} on {world} ranks: exits "
              f"{[p.returncode for p in procs]}, not refused with "
              f"{refused!r}:\n{outs[0][1][-2000:]}")
        return [lines[-1] for lines in said]
    records = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} of {argv[:3]} exited "
              f"{p.returncode}:\n{stderr[-4000:]}")
        lines = stdout.strip().splitlines()
        rec = [json.loads(x[5:]) for x in lines if x.startswith("RANK ")]
        check(len(rec) == 1, f"rank {r}: no record in {lines[-5:]}")
        records.append({**rec[0], "printed": [
            x for x in lines if not x.startswith("RANK ")]})
    return records


class _RankRows:
    """A dataset's batches as n data ranks read them, concatenated in rank
    order: rank r's rows of each step (its strided shard's `batches` at
    batch/n), so one process at the full batch takes the same feed."""

    def __init__(self, dataset, n):
        from ann3depth_tpu_torch.data.batching import ProcessShardView

        self.views = [ProcessShardView(dataset, r, n) for r in range(n)]

    def batches(self, batch_size, **kw):
        import numpy as np

        n = len(self.views)
        for parts in zip(*(v.batches(batch_size // n, **kw)
                           for v in self.views)):
            yield tuple(np.concatenate(x) for x in zip(*parts))


def _restored(torch, cfg, ckpt_dir, dev):
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train.checkpoint import CheckpointManager

    state = loop.create_state(cfg, dev)
    _, step = CheckpointManager(ckpt_dir).restore_params(state)
    check(step == cfg.train.steps, f"{ckpt_dir}: restored step {step}")
    return state


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if "loss" in r}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _v1_at(np, records, batch, steps, label):
    """Every rank launched v1 twice a step (image and depth), all at the
    per-rank batch."""
    for r in records:
        lead = {int(s.split(",")[0].strip("[")) for s in r["v1_shapes"]}
        check(r["v1_launches"] == r["v1_calls"] == 2 * steps
              and lead == {batch}, f"{label} rank {r['rank']}: v1 "
              f"{r['v1_launches']} launches, {r['v1_calls']} calls at "
              f"{r['v1_shapes']}, want {2 * steps} at batch {batch}")


def _nccl_one_rank(torch, fp, tmp, handoff, card):
    """Phase 9's plain encdec pair (K=1 and K=POOL_K) again in a one-rank
    NCCL group: the step all-reduces its gradients and metrics (captured
    in the graph under K > 1), which moves no value, so both runs must
    equal phase 9's bit for bit."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    out = {}
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        for k, (params, last) in sorted(handoff["runs"].items()):
            cfg = handoff["cfg"]
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, steps_per_dispatch=k))
            state, metrics, rec = pool_run(torch, fp, cfg, tmp, f"nccl_k{k}",
                                           handoff["scenes"], profile=False)
            got = {n: v.detach().cpu()
                   for n, v in state.model.state_dict().items()}
            same = all(torch.equal(got[n], v) for n, v in params.items())
            check(same and metrics == last, f"one-rank NCCL K={k}: params "
                  f"equal {same}, metrics {metrics} against {last}")
            out[f"k{k}"] = dict(bitwise_equal=True, step_ms=rec["step_ms"],
                                v1_calls_counted=rec["v1_calls_counted"],
                                loss=metrics["loss"])
            del state
    finally:
        dist.destroy_process_group()
    out["card"] = card
    return out


def _data_parallel(torch, np, fp, tmp, data):
    """make3d-encdec b16 on two ranks over gloo (b8 each) against one
    process at b16 fed the same rows (`_RankRows`), then ZeRO-1 on two
    ranks against that two-rank run. Returns (records, v1 launches)."""
    import glob

    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.train import loop

    dev = torch.device("cuda")
    work = f"{tmp}/p11"
    enc = ["train", "--config", "make3d-encdec", "--datasets", "make3d",
           "--data-dir", data, "--steps", str(PAR_STEPS), "--log-every",
           str(PAR_EVERY), "--checkpoint-every", str(PAR_STEPS),
           "--eval-every", "0"]
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        enc + ["--ckpt-dir", f"{work}/ref"]))
    n_enc = sum(p.numel() for p in loop.create_state(cfg, dev).model
                .parameters())
    dp = rank_runs(enc + ["--ckpt-dir", f"{work}/dp", "--workdir",
                          f"{work}/dp_wd", "--profile", f"{work}/dp_trace",
                          "--profile-steps", str(PAR_EVERY),
                          "--dist-backend", "gloo"], sizes=[n_enc])
    _v1_at(np, dp, 8, PAR_STEPS, "data parallel")
    fp.fused_preprocess.launches = 0
    ref, _ = loop.train(cfg, workdir=f"{work}/ref_wd", progress=False,
                        dataset=_RankRows(loop.build_dataset(cfg), 2))
    ref_launches = fp.fused_preprocess.launches
    want, got = _losses(f"{work}/ref_wd/metrics.jsonl"), _losses(
        f"{work}/dp_wd/metrics.jsonl")
    gaps = {s: _rel(got[s], want[s]) for s in want}
    check(sorted(got) == sorted(want) and max(gaps.values())
          <= STEP_LOSS_RTOL, f"two ranks against one process: losses "
          f"{got} against {want}")
    two = _restored(torch, cfg, f"{work}/dp", dev)
    worst, _ = param_gap(torch, two, ref)
    del two, ref
    traces = glob.glob(f"{work}/dp_trace/*.json")
    check(len(traces) == 1, f"rank 0 trace files {traces}")
    with open(f"{work}/dp_wd/metrics.jsonl") as f:
        rows = [json.loads(x) for x in f]
    out = dict(data_parallel=dict(
        ranks=2, backend="gloo", batch=16, per_rank_batch=8,
        steps=PAR_STEPS, loss_rel_gap=gaps, loss_rtol=STEP_LOSS_RTOL,
        params_max_abs_diff=worst,
        rank0_step_ms=_steady_ms(rows, 16, 2 * PAR_EVERY),
        rank0_trace=trace_stats(traces[0], PAR_EVERY),
        grad_all_reduce=[r["all_reduce"][0] for r in dp], params=n_enc,
        rank_seconds=[r["seconds"] for r in dp],
        peak_memory_bytes=[r["peak_memory_bytes"] for r in dp],
        one_process_v1_launches=ref_launches))
    launches = dict(data_parallel_per_rank=[r["v1_launches"] for r in dp])

    z1 = rank_runs(enc + ["--ckpt-dir", f"{work}/z1", "--workdir",
                          f"{work}/z1_wd", "--zero1", "--dist-backend",
                          "gloo"])
    _v1_at(np, z1, 8, PAR_STEPS, "zero1")
    a = _restored(torch, cfg, f"{work}/z1", dev)
    b = _restored(torch, cfg, f"{work}/dp", dev)
    close = all(torch.allclose(x, y, rtol=ZERO1_RTOL, atol=ZERO1_ATOL)
                for x, y in zip(a.model.parameters(), b.model.parameters()))
    worst, _ = param_gap(torch, a, b)
    del a, b
    zl = _losses(f"{work}/z1_wd/metrics.jsonl")
    check(close and max(_rel(zl[s], got[s]) for s in got) <= 1e-4,
          f"zero1 against replicated: params within rtol {ZERO1_RTOL} / "
          f"atol {ZERO1_ATOL}: {close} (max {worst}); losses {zl} {got}")
    zb = [r["optimizer_state_bytes"] for r in z1]
    rb = [r["optimizer_state_bytes"] for r in dp]
    check(all(z <= 0.5 * r + 64 * 1024 for z, r in zip(zb, rb)),
          f"zero1 optimizer bytes per rank {zb} against replicated {rb}")
    out["zero1"] = dict(params_max_abs_diff=worst, rtol=ZERO1_RTOL,
                        atol=ZERO1_ATOL, losses=zl,
                        optimizer_state_bytes_per_rank=zb,
                        replicated_optimizer_state_bytes_per_rank=rb,
                        rank_seconds=[r["seconds"] for r in z1])
    launches["zero1_per_rank"] = [r["v1_launches"] for r in z1]
    return out, launches


def _tensor_parallel(torch, np, fp, tmp, data):
    """dpt-384 b16 at --tp 2 on two ranks over gloo against tp=1 in one
    process: held to twice the largest gap of DPT_CONTROL_RUNS plain tp=1
    runs (their F.interpolate backward sums with atomics), as phase 9
    holds DPT, against the tp=1 run that computes each block as tp=2 does
    (`sharding_rules.tp_twin`: the same partial products, f32 sums and
    roundings); its gap to a plain tp=1 run (another order of the same
    sums, which DPT's first steps carry a long way in bf16) is reported
    beside the twin's. Returns (record, v1 launches)."""
    import dataclasses

    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.parallel import sharding_rules
    from ann3depth_tpu_torch.train import loop

    dev = torch.device("cuda")
    work = f"{tmp}/p11tp"
    tpf = ["train", "--config", "dpt-384", "--datasets", "nyu", "--data-dir",
           data, "--steps", str(TP_STEPS), "--log-every", "1",
           "--checkpoint-every", str(TP_STEPS), "--eval-every", "0"]
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        tpf + ["--ckpt-dir", f"{work}/tp1"]))
    create = loop.create_state

    def twin_state(c, device=None):
        state = create(c, device)
        sharding_rules.tp_twin(state.model, 2)
        return state

    runs = {}
    plain = [f"tp1_{i}" for i in range(DPT_CONTROL_RUNS)]
    for name in plain + ["twin"]:
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, ckpt_dir=f"{work}/{name}"))
        loop.create_state = twin_state if name == "twin" else create
        try:
            state, _ = loop.train(c, workdir=f"{work}/{name}",
                                  progress=False)
        finally:
            loop.create_state = create
        runs[name] = (state, _losses(f"{work}/{name}/metrics.jsonl"))
    n_dpt = sum(p.numel() for p in runs["tp1_0"][0].model.parameters())
    tokens = (cfg.data.input_hw[0] // 16) * (cfg.data.input_hw[1] // 16)
    act = cfg.train.batch_size * tokens * runs["tp1_0"][0].model.dim
    tp = rank_runs(tpf + ["--tp", "2", "--ckpt-dir", f"{work}/tp2",
                          "--workdir", f"{work}/tp2_wd", "--dist-backend",
                          "gloo"], sizes=[n_dpt, act])
    _v1_at(np, tp, 16, TP_STEPS, "tp")
    runs["tp2"] = (_restored(torch, cfg, f"{work}/tp2", dev),
                   _losses(f"{work}/tp2_wd/metrics.jsonl"))

    def gap(a, b):
        (sa, la), (sb, lb) = runs[a], runs[b]
        return (param_gap(torch, sa, sb)[0],
                max(_rel(la[s], lb[s]) for s in lb))

    gaps = {f"{a}_vs_{b}": gap(a, b) for i, a in enumerate(plain)
            for b in plain[:i]}
    param_tol = max(2 * max(g[0] for g in gaps.values()), GRAPH_PARAM_ATOL)
    loss_tol = max(2 * max(g[1] for g in gaps.values()), GRAPH_LOSS_RTOL)
    gaps.update(tp2_vs_twin=gap("tp2", "twin"),
                tp2_vs_tp1=gap("tp2", "tp1_0"),
                twin_vs_tp1=gap("twin", "tp1_0"))
    # With an in-loop eval, the gloo run is refused before its first step:
    # the eval step's model-axis all-reduces would run on the host, where a
    # CUDA graph cannot capture them (loop.eval_stats_graphs).
    eval_refusal = rank_runs(
        tpf[:-1] + [str(TP_STEPS), "--tp", "2", "--ckpt-dir",
                    f"{work}/tp2_eval", "--workdir", f"{work}/tp2_eval_wd",
                    "--dist-backend", "gloo"],
        refused="ValueError: eval captures its step in a CUDA graph, and "
        "the gloo backend's model-axis all-reduces")
    worst, loss_gap = gaps["tp2_vs_twin"]
    check(worst <= param_tol and loss_gap <= loss_tol,
          f"tp=2 against its tp=1 twin: params {worst} (tol {param_tol}), "
          f"loss {loss_gap} (tol {loss_tol}); gaps {gaps}")
    per_step = {k: v / TP_STEPS for k, v in tp[0]["tp_collectives"].items()}
    check(per_step["forward"] > 0 and per_step["backward"] > 0,
          f"tp collectives {per_step}")
    with open(f"{work}/tp2_wd/metrics.jsonl") as f:
        rows = [json.loads(x) for x in f]
    out = dict(
        tp=2, batch=16, steps=TP_STEPS, params=n_dpt,
        local_params_per_rank=[r["local_params"] for r in tp],
        gaps={k: dict(params_max_abs_diff=v[0], loss_rel_gap=v[1])
              for k, v in gaps.items()},
        param_tol=param_tol, loss_tol=loss_tol,
        losses={k: v[1] for k, v in runs.items()},
        model_axis_all_reduces_per_step=per_step,
        rank0_step_ms=_steady_ms(rows, cfg.train.batch_size, 2),
        gloo_in_loop_eval_refused=eval_refusal,
        activation_all_reduce=[r["all_reduce"][1] for r in tp],
        grad_all_reduce_dpt=[r["all_reduce"][0] for r in tp],
        rank_seconds=[r["seconds"] for r in tp],
        peak_memory_bytes=[r["peak_memory_bytes"] for r in tp])
    del runs
    torch.cuda.empty_cache()
    return out, dict(tensor_parallel_per_rank=[r["v1_launches"] for r in tp])


def _serve_dp(torch, np, fp):
    """`serve --dp 0` (on one card: dp=1) against --dp 1 on one batch of 8
    frames; --dp 2 refused with the JAX package's error."""
    from ann3depth_tpu_torch import cli

    frames = np.random.default_rng(11).integers(
        0, 256, (8, *RAW_HW, 3), dtype=np.uint8)
    answers, launches = {}, {}
    for dp in ("1", "0"):
        svc = cli.make_service(cli.build_parser().parse_args(
            ["serve", "--config", "make3d-encdec", "--init", "--dp", dp,
             "--max-batch", "8", "--no-warmup"]))
        try:
            with graph_runs(torch, fp) as seen:
                futs = [svc.submit(f) for f in frames]
                answers[dp] = np.stack([f.result(timeout=120) for f in futs])
            # one batch of 8: its bucket's capture (--no-warmup), a replay
            launches[f"serve_dp{dp}"] = v1_runs(seen, 1, f"serve --dp {dp}")
        finally:
            svc.close()
    gap = float(np.abs(np.log(answers["0"]) - np.log(answers["1"])).max())
    check(gap <= SERVE_LOG_TOL and launches["serve_dp0"] == 1,
          f"serve --dp 0 against --dp 1: {gap} in log-depth")
    try:
        cli.make_service(cli.build_parser().parse_args(
            ["serve", "--config", "make3d-encdec", "--init", "--dp", "2"]))
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused == "dp=2 needs 2 devices, have 1",
          f"serve --dp 2 on one card: {refused!r}")
    return dict(devices=torch.cuda.device_count(), log_gap=gap,
                tol=SERVE_LOG_TOL, dp2_refusal=refused), launches


def _eval_ranks(torch, fp, data, encdec_cfg):
    """`eval` on two ranks (each its strided half of the Make3D test
    records at b8, the statistics summed) against one process on phase
    4's checkpoint, within EVAL_METRIC_RTOL: one process at b8, whose
    convs pick the ranks' algorithms (each image's answer depends on the
    batch's shape, not on the other images); its b16 reading, where cuDNN
    picks others (the bf16 rounding moves sq_rel ~4e-4), is reported.
    Each rank runs as many batches as the one process at b16."""
    from ann3depth_tpu_torch import cli

    ev = ["eval", "--config", "make3d-encdec", "--datasets", "make3d",
          "--data-dir", data, "--ckpt-dir", encdec_cfg.train.ckpt_dir]
    with graph_runs(torch, fp) as seen:
        one = _cli_json(cli, ev)
    one_launches = v1_runs(seen, 2, "eval at b16")
    at8 = _cli_json(cli, ev + ["--batch-size", "8"])
    ranks = rank_runs(ev + ["--dist-backend", "gloo"])
    two = json.loads(ranks[0]["printed"][-1])
    tol = EVAL_METRIC_RTOL["make3d-encdec"]
    gaps = {k: _rel(two[k], at8[k]) for k in at8}
    # each rank: its eval step's graph (2 v1 calls a capture, a warm call
    # before it) replayed as many times as the one process's
    rank_runs_v1 = [r["v1_launches"] + 2 * (r["graph_replays"]
                                            - r["graph_captures"])
                    for r in ranks]
    check(sorted(two) == sorted(at8) and max(gaps.values()) <= tol
          and all(r["v1_calls"] == 4 * r["graph_captures"] for r in ranks)
          and all(n == one_launches > 0 for n in rank_runs_v1),
          f"eval on two ranks against one process at b8: {gaps} (rtol "
          f"{tol}); v1 runs {rank_runs_v1} against {one_launches}")
    return (dict(rel_gaps_to_one_process_b8=gaps, rtol=tol, metrics=two,
                 rel_gaps_to_one_process_b16={
                     k: _rel(two[k], one[k]) for k in one}),
            dict(eval_per_rank=rank_runs_v1))


def parallel_phase(torch, np, fp, card, tmp, encdec_cfg, handoff):
    """Phase 11: data parallelism on two ranks (gloo, this card) against
    one process at the full batch; ZeRO-1 against it; a one-rank NCCL
    group against phase 9; dpt-384 at --tp 2 against tp=1; `serve --dp`;
    `eval` on two ranks against one process. Returns the v1 launches of
    its runs."""
    data = f"{tmp}/data"  # phase 8's records
    out, launches, seconds = {}, {}, {}
    t0 = time.perf_counter()
    rec, n = _data_parallel(torch, np, fp, tmp, data)
    out.update(rec)
    launches.update(n)
    seconds["data_parallel_and_zero1"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["nccl_one_rank"] = _nccl_one_rank(torch, fp, tmp, handoff, card)
    launches["nccl_one_rank_eager"] = {
        k: v["v1_calls_counted"] for k, v in out["nccl_one_rank"].items()
        if k != "card"}
    seconds["nccl_one_rank"] = time.perf_counter() - t0

    for name, fn, args in (
            ("tensor_parallel", _tensor_parallel, (torch, np, fp, tmp, data)),
            ("serve_dp", _serve_dp, (torch, np, fp)),
            ("eval", _eval_ranks, (torch, fp, data, encdec_cfg))):
        t0 = time.perf_counter()
        out[name], n = fn(*args)
        launches.update(n)
        seconds[name] = time.perf_counter() - t0
    out.update(seconds=seconds, card=card,
               note="two ranks share one card: times show the "
               "collectives' cost, not scaling")
    print("parallel: " + json.dumps(out), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the tools (sweep, info, download, --preprocess-impl).
# ---------------------------------------------------------------------------

def _encdec_argv(*extra):
    """`cli` flags of make3d-encdec (b16, full width) on synthetic scenes
    at Make3D's raw shapes (RGB 480x640, laser grid 305x55)."""
    return ["--config", "make3d-encdec", "--datasets", "synthetic",
            "--synth-hw", *map(str, RAW_HW), "--synth-depth-hw",
            *map(str, MAKE3D_DEPTH_HW), *extra]


def info_runs(torch, cli, train):
    """`cli info --flops` of each family at full width on the card: its
    params must be the counts the training phases print, its output the
    shape the model produces, its peak the card's, and the rest what
    `info --device cpu` prints (FLOPs are counted from shapes)."""
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.utils import flops

    kind = torch.cuda.get_device_name(0)
    peak = flops.PEAK_BF16_FLOPS.get(kind)
    out = {}
    for preset, params in INFO_PARAMS.items():
        info = _cli_json(cli, ["info", "--config", preset, "--flops"])
        hw = list(registry.output_hw(info["model"], info["input_hw"]))
        check(info["params"] == params, f"info {preset}: {info['params']} "
              f"params, the training phases count {params}")
        check(info["output_hw"] == hw == info["target_hw"],
              f"info {preset}: output {info['output_hw']}, model {hw}")
        check(info.get("device_peak_tflops") == (peak and peak / 1e12)
              and info.get("device_kind") == (peak and kind),
              f"info {preset}: peak {info.get('device_peak_tflops')} on "
              f"{kind}")
        cpu = _cli_json(cli, ["info", "--config", preset, "--flops",
                              "--device", "cpu"])
        check(cpu == {k: v for k, v in info.items() if k not in (
            "device_peak_tflops", "device_kind")},
            f"info {preset}: the card's {info}, the CPU's {cpu}")
        out[preset] = {k: info[k] for k in (
            "params", "input_hw", "output_hw", "forward_gflops_per_image")}
    # Phase 4 counts a forward and backward of its b16 batch: about three
    # forwards an image.
    out["encdec_fwd_bwd_over_forward"] = train["fwd_bwd_flops"] / (
        train["batch"] * out["make3d-encdec"]["forward_gflops_per_image"]
        * 1e9)
    out["device_peak_tflops"] = peak and peak / 1e12
    return out


def sweep_run(torch, np, fp, cli, tmp):
    """`cli sweep` of make3d-encdec over SWEEP_PARAMS, each trial's train
    and eval launches, wall time and peak memory read around its
    `loop.train` and `loop.evaluate`; then the same grid again, which must
    train nothing; then trial 0 as `cli train` + `cli eval`, which must
    score the same metrics bit for bit."""
    from ann3depth_tpu_torch.train import loop

    out_dir = f"{tmp}/sweep"
    argv = ["sweep", *_encdec_argv("--steps", str(SWEEP_STEPS),
                                   "--max-eval-batches",
                                   str(SWEEP_EVAL_BATCHES), "--out-dir",
                                   out_dir)]
    for spec in SWEEP_PARAMS:
        argv += ["--param", spec]
    trials = []
    inner_train, inner_eval = loop.train, loop.evaluate

    def train(cfg, **kw):
        torch.cuda.synchronize()
        rec = dict(allocated_before_bytes=torch.cuda.memory_allocated(),
                   steps=cfg.train.steps, batch=cfg.train.batch_size)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with graph_runs(torch, fp) as seen:
            result = inner_train(cfg, **kw)
        torch.cuda.synchronize()
        rec["train_s"] = time.perf_counter() - t0
        rec.update(train_launches=seen["launches"], train_graphs=seen,
                   train_v1_runs=train_v1(seen, cfg.train.steps, 2,
                                          "sweep train"))
        trials.append(rec)
        return result

    def evaluate(cfg, **kw):
        with graph_runs(torch, fp) as seen:
            result = inner_eval(cfg, **kw)
        torch.cuda.synchronize()
        trials[-1].update(eval_launches=seen["launches"], eval_graphs=seen,
                          eval_v1_runs=v1_runs(seen, 2, "sweep eval"),
                          peak_bytes=torch.cuda.max_memory_allocated())
        return result

    loop.train, loop.evaluate = train, evaluate
    try:
        t0 = time.perf_counter()
        first = _cli_json(cli, argv)
        sweep_s = time.perf_counter() - t0
        fp.fused_preprocess.launches = 0
        again = _cli_json(cli, argv)
        rerun_launches = fp.fused_preprocess.launches
    finally:
        loop.train, loop.evaluate = inner_train, inner_eval
    with open(f"{out_dir}/sweep.jsonl") as f:
        rows = [json.loads(line) for line in f]
    n = int(np.prod([len(s.split("=")[1].split(",")) for s in SWEEP_PARAMS]))
    check(len(rows) == n == first["n_trials"] == len(trials),
          f"sweep: {len(rows)} ledger rows, {len(trials)} trials run")
    best = min(rows, key=lambda r: r["eval"]["rmse"])
    with open(first["summary"]) as f:
        summary = json.load(f)
    check(summary["best"] == best == first["best"],
          f"sweep: best {first['best']['trial']}, argmin {best['trial']}")
    for i, rec in enumerate(trials):
        check(rec["train_v1_runs"] == 2 * SWEEP_STEPS
              and rec["eval_v1_runs"] == 2 * SWEEP_EVAL_BATCHES,
              f"sweep trial {i}: v1 ran {rec['train_v1_runs']} times "
              f"in {SWEEP_STEPS} steps, {rec['eval_v1_runs']} times in "
              f"{SWEEP_EVAL_BATCHES} eval batches")
        check(abs(rec["peak_bytes"] - trials[0]["peak_bytes"])
              <= SWEEP_PEAK_RTOL * trials[0]["peak_bytes"],
              f"sweep trial {i}: peak {rec['peak_bytes']} B against trial "
              f"0's {trials[0]['peak_bytes']} B")
        with open(f"{out_dir}/trial_{i:03d}/metrics.jsonl") as f:
            logged = [r["images_per_sec"] for r in map(json.loads, f)
                      if "images_per_sec" in r]
        rec.update(overrides=rows[i]["overrides"], rmse=rows[i]["eval"][
            "rmse"], images_per_s=rec["steps"] * rec["batch"]
            / rec["train_s"], loop_images_per_s=logged)
    check(again["best"] == first["best"] and rerun_launches == 0,
          f"sweep rerun: v1 launched {rerun_launches} times, best "
          f"{again['best']['trial']}")

    # Trial 0 standalone, in fresh directories, through train and eval.
    flags = []
    for path, value in rows[0]["overrides"].items():
        flags += [{"train.learning_rate": "--learning-rate",
                   "train.loss": "--loss"}[path], str(value)]
    ckpt = f"{tmp}/sweep_alone"
    _cli_json(cli, ["train", *_encdec_argv("--steps", str(SWEEP_STEPS),
                                           "--ckpt-dir", ckpt, *flags)])
    alone = _cli_json(cli, ["eval", *_encdec_argv(
        "--ckpt-dir", ckpt, "--max-batches", str(SWEEP_EVAL_BATCHES),
        *flags)])
    check(alone == rows[0]["eval"], f"sweep trial 0 scored "
          f"{rows[0]['eval']}, its train + eval {alone}")
    return dict(trials=trials, sweep_s=sweep_s, best=first["best"],
                rerun_launches=rerun_launches, alone_equal=True)


def _stage_make3d_tree(np, root, seed=6):
    """The four Make3D archives under <root>/make3d/, from TREE_SPLIT
    synthetic scenes at Make3D's raw shapes: 480x640 JPEGs and
    Position3DGrid (55, 305, 4) .mat files, depth in channel 3."""
    import tarfile

    import scipy.io
    from PIL import Image

    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset

    scenes = SyntheticDepthDataset(n=sum(TREE_SPLIT), img_hw=RAW_HW,
                                   depth_hw=MAKE3D_DEPTH_HW, seed=seed)
    src, base = f"{root}/src", f"{root}/make3d"
    layout = (("Train400Img.tar.gz", "Train400Img", 0),
              ("Train400Depth.tgz", "Train400Depth", 0),
              ("Test134.tar.gz", "Test134", 1),
              ("Test134Depth.tar.gz", "Gridlaserdata", 1))
    for _, sub, _ in layout:
        os.makedirs(f"{src}/{sub}")
    for i in range(len(scenes)):
        img, depth = scenes[i]
        test = i >= TREE_SPLIT[0]
        sid = f"{'test' if test else 'train'}scene-{i:03d}"
        Image.fromarray(img).save(
            f"{src}/{'Test134' if test else 'Train400Img'}/img-{sid}.jpg")
        grid = np.zeros((*MAKE3D_DEPTH_HW[::-1], 4), np.float32)
        grid[..., 3] = depth.T
        scipy.io.savemat(f"{src}/{'Gridlaserdata' if test else 'Train400Depth'}"
                         f"/depth_sph_corr-{sid}.mat",
                         {"Position3DGrid": grid})
    os.makedirs(base)
    for archive, sub, _ in layout:
        with tarfile.open(f"{base}/{archive}", "w:gz") as tf:
            tf.add(f"{src}/{sub}", arcname=sub)
    return [archive for archive, _, _ in layout]


def _stage_nyu(data_dir, root):
    """NYU's labeled file staged under <root>/nyu: phase 8's v7.3 .mat
    where it wrote one (h5py), else a stand-in with only what `download`
    reads, a MATLAB 7.3 userblock and the HDF5 signature at byte 512."""
    import shutil

    src = f"{data_dir}/nyu/nyu_depth_v2_labeled.mat"
    dst = f"{root}/nyu/nyu_depth_v2_labeled.mat"
    os.makedirs(f"{root}/nyu")
    if os.path.exists(src):
        shutil.copy(src, dst)
        return "phase 8's nyu_depth_v2_labeled.mat"
    with open(dst, "wb") as f:
        f.write(b"MATLAB 7.3 MAT-file".ljust(116, b" ") + b" " * 8
                + b"\x00\x02IM" + b"\x00" * 384 + b"\x89HDF\r\n\x1a\n")
    return "v7.3 header stand-in (no h5py)"


def download_run(torch, np, fp, cli, steplib, tmp, train):
    """`cli download` of staged Make3D archives (recording, then verifying
    their sums) and of NYU's staged .mat; then make3d-encdec (b16) trains
    TREE_STEPS steps from the extracted tree and `cli eval` scores its
    Test134/."""
    from ann3depth_tpu_torch.data import download

    root = f"{tmp}/tree"
    t0 = time.perf_counter()
    archives = _stage_make3d_tree(np, root)
    stage_s = time.perf_counter() - t0
    base = ["download", "--dataset", "make3d", "--data-dir", root]
    t0 = time.perf_counter()
    check(cli.main(base + ["--record-checksums"]) == 0
          and cli.main(base) == 0, "download make3d")
    download_s = time.perf_counter() - t0
    with open(f"{root}/make3d/{download.RECORDED_NAME}") as f:
        sums = json.load(f)
    check(sorted(sums) == sorted(archives), f"recorded sums of {sorted(sums)}")
    nyu_route = _stage_nyu(f"{tmp}/data", root)
    check(cli.main(["download", "--dataset", "nyu", "--data-dir", root,
                    "--record-checksums"]) == 0, "download nyu")

    ckpt = f"{tmp}/tree_ckpt"
    argv = ["--config", "make3d-encdec", "--datasets", "make3d",
            "--data-dir", root, "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as tree_graphs, \
            _recording(fp, steplib) as seen:
        last = _cli_json(cli, ["train", *argv, "--steps", str(TREE_STEPS),
                               "--log-every", "5"])
    train_s = time.perf_counter() - t0
    launches = tree_graphs["launches"]
    losses = [float(x) for x in seen["losses"]]
    tree_v1 = train_v1(tree_graphs, TREE_STEPS, 2, "make3d tree")
    check(len(losses) == TREE_STEPS and bool(np.isfinite(losses).all()),
          f"make3d tree: {len(losses)} steps, {launches} v1 launches, "
          f"losses {losses}")
    check(all(c == ((16, *RAW_HW, 3), False) or c == (
        (16, *MAKE3D_DEPTH_HW, 1), True) for c in seen["calls"]),
        f"make3d tree: v1 calls {set(seen['calls'])}")
    with open(f"{ckpt}/metrics.jsonl") as f:
        ips = [r["images_per_sec"] for r in map(json.loads, f)
               if "images_per_sec" in r]
    with graph_runs(torch, fp) as seen:
        ev = _cli_json(cli, ["eval", *argv])
    eval_launches = v1_runs(seen, 2, "make3d tree eval")
    n_batches = TREE_SPLIT[1] // 16
    check(_all_finite(np, ev) and eval_launches == 2 * n_batches,
          f"make3d tree eval: {eval_launches} v1 runs, {seen}, {ev}")
    return dict(scenes=TREE_SPLIT, stage_s=stage_s, download_s=download_s,
                nyu_route=nyu_route, steps=TREE_STEPS, train_s=train_s,
                losses=losses, last=last, loop_images_per_s=ips,
                phase4_loop_images_per_s=train["loop_images_per_s"],
                launches=launches, v1_runs=tree_v1, step_graphs=tree_graphs,
                eval=ev, eval_launches=eval_launches)


def impl_runs(torch, np, fp, cli, steplib, tmp):
    """`cli train` for IMPL_STEPS steps with --preprocess-impl xla and
    pallas from one seed: both must launch v1 twice a step and end on the
    same losses and params, bit for bit."""
    out, params = {}, []
    for impl in ("xla", "pallas"):
        ckpt = f"{tmp}/impl_{impl}"
        with graph_runs(torch, fp) as graphed, \
                _recording(fp, steplib) as seen:
            _cli_json(cli, ["train", *_encdec_argv(
                "--steps", str(IMPL_STEPS), "--ckpt-dir", ckpt,
                "--preprocess-impl", impl)])
        out[impl] = dict(losses=[float(x) for x in seen["losses"]],
                         launches=graphed["launches"],
                         v1_runs=train_v1(graphed, IMPL_STEPS, 2,
                                          f"--preprocess-impl {impl}"))
        check(len(out[impl]["losses"]) == IMPL_STEPS,
              f"--preprocess-impl {impl}: {out[impl]}")
        saved = torch.load(f"{ckpt}/ckpt_{IMPL_STEPS}.pt", map_location="cpu",
                           weights_only=False)["model"]
        params.append(saved)
    same = out["xla"]["losses"] == out["pallas"]["losses"] and all(
        torch.equal(params[0][k], params[1][k]) for k in params[0])
    check(same, f"--preprocess-impl xla and pallas differ: {out}")
    return dict(out, bitwise_equal=same)


def tools_phase(torch, np, fp, card, tmp, train, handoff):
    """Phase 12: `info --flops` of the four families, a `sweep` of
    make3d-encdec (4 trials) and its rerun, `download` into a Make3D tree
    that the card trains from, and `--preprocess-impl xla|pallas`. Returns
    the v1 launches of its paths."""
    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.train import step as steplib

    seconds, out = {}, {}
    for name, fn, args in (
            ("info", info_runs, (torch, cli, train)),
            ("sweep", sweep_run, (torch, np, fp, cli, tmp)),
            ("download", download_run,
             (torch, np, fp, cli, steplib, tmp, train)),
            ("preprocess_impl", impl_runs, (torch, np, fp, cli, steplib,
                                            tmp))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    out.update(seconds=seconds, card=card)
    print("tools: " + json.dumps(out), flush=True)
    handoff["tree_images_per_s"] = out["download"]["loop_images_per_s"]
    return dict(
        sweep_launches=[dict(train=t["train_launches"],
                             eval=t["eval_launches"])
                        for t in out["sweep"]["trials"]],
        sweep_rerun_launches=out["sweep"]["rerun_launches"],
        make3d_tree_launches=dict(train=out["download"]["launches"],
                                  eval=out["download"]["eval_launches"]),
        preprocess_impl_launches={k: out["preprocess_impl"][k]["launches"]
                                  for k in ("xla", "pallas")})


# ---------------------------------------------------------------------------
# Phase 13: the models' variant fields.
# ---------------------------------------------------------------------------

def _register_variants():
    """Registry names for the variant fields, as a caller reaches a field
    no preset sets: a subclass with the field fixed, registered under its
    own name (`registry.register`). The registry builds each with its
    family's keywords ("dpt-*" as a DPT, the encdec ones at width 1)."""
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.models.dpt import DPTDepthNet
    from ann3depth_tpu_torch.models.encdec import EncDecDepthNet, UpStage

    def fixed(base, **fields):
        class Variant(base):
            def __init__(self, **kw):
                super().__init__(**kw, **fields)
        return Variant

    class Refined(EncDecDepthNet):
        """Both decoder stages with refine=True."""

        def __init__(self, **kw):
            super().__init__(**kw)
            w0, w1, w2 = self.widths
            self.dec0 = UpStage(w2, w1, w1, refine=True)
            self.dec1 = UpStage(w1, w0, w0, refine=True)

    for name, cls in (
            ("dpt-matmul", fixed(DPTDepthNet, upsample="matmul")),
            ("dpt-jnn", fixed(DPTDepthNet, attention_impl="jnn")),
            ("dpt-fused", fixed(DPTDepthNet, attention_impl="fused")),
            ("encdec-nonorm", fixed(EncDecDepthNet, norm="none")),
            ("encdec-resize", fixed(EncDecDepthNet, upsample="resize")),
            ("encdec-refine", Refined)):
        registry.register(name)(cls)


def _with_model(cfg, name):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              name=name))


def _with_train(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


def upsample_costs(torch, impl, batch=16, features=128, grid=24):
    """Device ms (torch.profiler) of dpt-384's fusion-head upsamples at
    `batch`, 384x384, through `models.dpt._up(..., impl)`: the six calls of
    a forward (fuse3/fuse2/fuse1 outputs x2, skips x2 and x4, the f32
    head's x2) with their backward, and the forwards that remat repeats in
    the backward (the three inside the fusion blocks)."""
    from ann3depth_tpu_torch.models.dpt import _up

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [((batch, features, grid, grid), 2, bf16, True),
              ((batch, features, grid, grid), 2, bf16, False),
              ((batch, features, 2 * grid, 2 * grid), 2, bf16, True),
              ((batch, features, grid, grid), 4, bf16, False),
              ((batch, features, 4 * grid, 4 * grid), 2, bf16, True),
              ((batch, 1, 8 * grid, 8 * grid), 2, f32, False)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for shape, f, dt, in_block in shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(dt).to(
            memory_format=torch.channels_last).requires_grad_()
        out = (*shape[:2], shape[2] * f, shape[3] * f)
        g = torch.randn(out, generator=gen, device="cuda").to(dt).to(
            memory_format=torch.channels_last)
        cases.append((x, f, g, in_block))

    def fwd_bwd():
        for x, f, g, _ in cases:
            x.grad = None
            torch.autograd.backward(_up(x, f, impl), g)

    def refwd():
        with torch.no_grad():
            for x, f, _, in_block in cases:
                if in_block:
                    _up(x, f, impl)

    return dict(fwd_bwd_ms=device_ms(torch, fwd_bwd, iters=10)[0],
                remat_refwd_ms=device_ms(torch, refwd, iters=10)[0])


_DETERMINISTIC_CHILD = r"""
import json, sys
import torch
torch.use_deterministic_algorithms(True)
import chip_smoke
print(json.dumps(chip_smoke.deterministic_dpt_runs(sys.argv[1])))
"""


def deterministic_dpt_runs(tmp):
    """Run in a process under torch.use_deterministic_algorithms(True):
    dpt-384 at upsample "matmul" from phase 9's pool of the NYU records in
    `tmp`, two K=1 runs and a traced K=DPT_K graph run, then a K=1 run
    replaying its step graph (phase 16). Returns whether the pair is equal
    bit for bit, the graph run's gap to the first (the largest param gap
    and its excess over GRAPH_*, the relative loss gap), the v1 launches,
    the K=1 runs' step ms, the graph run's traced figures and its trace,
    and whether the K=1 graph run equals the first K=1 run bit for bit,
    with its step ms, step graphs and v1 runs."""
    import torch

    from ann3depth_tpu_torch.device import resolve_device
    from ann3depth_tpu_torch.ops import fused_preprocess as fp

    resolve_device("cuda")
    _register_variants()
    mm = _with_model(dpt_pool_config(f"{tmp}/data"), "dpt-matmul")
    eager = [pool_run(torch, fp, mm, tmp, f"mm_det_k1_{i}", profile=False)
             for i in range(2)]
    graph = pool_run(torch, fp, _with_train(mm, steps_per_dispatch=DPT_K),
                     tmp, f"mm_det_k{DPT_K}")
    with graph_runs(torch, fp) as seen:
        k1_graph = pool_run(torch, fp, mm, tmp, "mm_det_k1_graph",
                            profile=False, eager=False)
    worst, excess = param_gap(torch, graph[0], eager[0][0])
    return dict(k1_graph_bitwise_equal=_same_run(torch, k1_graph, eager[0]),
                k1_graph_step_ms=k1_graph[2]["step_ms"],
                k1_graph_steps=seen,
                k1_graph_v1_runs=train_v1(seen, mm.train.steps, 2,
                                          "deterministic dpt K=1 graph"),
                k1_pair_bitwise_equal=_same_run(torch, eager[0], eager[1]),
                k1_pair_gap=_pair_gap(torch, eager[1], eager[0]),
                graph_params_max_abs_diff=worst,
                graph_params_excess_over_tol=excess,
                graph_loss_rel_diff=_pair_gap(torch, graph, eager[0])[1],
                eager_step_ms=[r[2]["step_ms"] for r in eager],
                graph=_traced_row(graph[2]),
                v1_calls=[r[2]["v1_calls_counted"] for r in eager + [graph]],
                graph_trace=graph[2]["trace"])


def _traced_row(r):
    t = r.get("trace", {})
    return dict(step_ms=r["step_ms"], busy_share=t.get("busy_share"),
                device_busy_ms_per_step=t.get("device_busy_ms_per_step"),
                kernels_per_step=t.get("kernels_per_step"),
                window_ms_per_step=t.get("window_ms_per_step"))


def _same_run(torch, x, y):
    """Whether two pool_run results have equal params and logged losses,
    bit for bit."""
    return all(torch.equal(a, b) for a, b in zip(
        x[0].model.state_dict().values(),
        y[0].model.state_dict().values())) and [
        v for _, v in x[2]["logged"]] == [v for _, v in y[2]["logged"]]


def _replays_ok(trace):
    """Every replayed step of a traced graph run launched v1's resample
    twice (the first replay reported, not held: phase 9)."""
    replays = trace["v1_resample_per_replay"]
    return bool(replays) and (
        min(replays[1:]) >= 2 if any(replays)
        else trace["v1_resample_per_step"] * len(replays)
        >= 2 * (len(replays) - 1))


def variant_dpt(torch, np, fp, tmp, card, handoff):
    """Phase 13a: dpt-384 at upsample "matmul" from phase 9's pool of NYU
    records (augmented). In the default mode, where its runs part,
    `dpt_graph_control` as phase 9 runs it for "resize" (the first K=1
    run and the graph run traced). Then in a child process under
    torch.use_deterministic_algorithms(True) two K=1 runs that must be
    equal bit for bit and a traced K=DPT_K graph run held to the fixed
    GRAPH_* tolerances. Step ms: the untraced K=1 runs'; the graph runs'
    window ms and device busy ms a step from their traces. A traced K=1
    run at "resize" and the upsamples' device ms in both modes give their
    share of the step."""
    base = dpt_pool_config(f"{tmp}/data")
    mm = _with_model(base, "dpt-matmul")
    steps = base.train.steps
    default, eager, graph = dpt_graph_control(torch, fp, mm, tmp, "mm", card,
                                              profile=True)
    resize = pool_run(torch, fp, base, tmp, "rs_k1_traced")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, "-c", _DETERMINISTIC_CHILD, tmp],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"deterministic dpt runs: {proc.stderr[-3000:]}")
    det = json.loads(proc.stdout.strip().splitlines()[-1])
    counted = ([r[2]["v1_calls_counted"] for r in eager + [graph, resize]]
               + det["v1_calls"])
    t = det.pop("graph_trace")
    costs = {impl: upsample_costs(torch, impl) for impl in ("resize",
                                                             "matmul")}
    busy = {"resize": resize[2]["trace"]["device_busy_ms_per_step"],
            "matmul": eager[0][2]["trace"]["device_busy_ms_per_step"]}
    for impl, c in costs.items():
        c["share_of_device_step"] = ((c["fwd_bwd_ms"] + c["remat_refwd_ms"])
                                     / busy[impl])
    p9 = handoff["dpt"]

    def window(row):
        """A traced run's figures from its trace: its step_ms, read from
        a log interval that holds the trace's export when no interval
        follows the window (10 steps), is dropped."""
        return {k: v for k, v in row.items() if k != "step_ms"}

    out = dict(
        steps=steps, k=DPT_K,
        default_mode=dict(
            k1_pair_bitwise_equal=_same_run(torch, eager[0], eager[1]),
            control_pairs=default["control_pairs"],
            control_gap=default["control_gap"],
            graph_gap=default["graph_gap"], allowed=default["allowed"],
            phase9_resize_control_gap=p9["control_gap"],
            phase9_resize_graph_gap=p9["graph_gap"]),
        deterministic_mode=det,
        v1_calls=dict(counted=counted, replayed_resample_per_replay=t[
            "v1_resample_per_replay"]),
        step_ms=dict(matmul_eager=default["eager_step_ms"][1:],
                     matmul_eager_deterministic=det["eager_step_ms"],
                     resize_eager_phase9=p9["eager_step_ms"],
                     resize_graph_phase9=p9["graph"]["step_ms"]),
        traced=dict(matmul_k1=window(_traced_row(eager[0][2])),
                    matmul_graph=window(_traced_row(graph[2])),
                    matmul_graph_deterministic=window(det["graph"]),
                    resize_k1=window(_traced_row(resize[2]))),
        upsample=costs, card=card)
    print("variant dpt matmul: " + json.dumps(out), flush=True)
    handoff["dpt_deterministic"] = det  # phase 16 holds its K=1 graph
    losses = [r[1]["loss"] for r in eager + [graph, resize]]
    check(bool(np.isfinite(losses).all()), f"dpt variants: losses {losses}")
    check(det["k1_pair_bitwise_equal"]
          and det["graph_params_excess_over_tol"] <= 0
          and det["graph_loss_rel_diff"] <= GRAPH_LOSS_RTOL,
          f"matmul dpt in deterministic mode: {det}; GRAPH_* tolerances")
    n = DPT_CONTROL_RUNS
    check(counted == [2 * steps] * n + [2 * DPT_K, 2 * steps]
          + [2 * steps] * 2 + [2 * DPT_K] and _replays_ok(t),
          f"matmul dpt: v1 calls {counted}, replays "
          f"{t['v1_resample_per_replay']}")
    launches = dict(default_k1=counted[:n], default_graph_eager_block=
                    counted[n], resize_k1=counted[n + 1],
                    deterministic_k1=counted[n + 2:n + 4],
                    deterministic_graph_eager_block=counted[n + 4],
                    deterministic_replayed_resample_per_step=t[
                        "v1_resample_per_step"])
    del eager, graph, resize
    torch.cuda.empty_cache()
    return launches


def _call_stats(torch, fn, iters=5):
    """(device ms, CUDA kernels) a call of `fn`, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    check(kernels, "the profiler recorded no kernel")
    ms = sum((e.time_range.end - e.time_range.start) for e in kernels) / 1e3
    return ms / iters, len(kernels) / iters


def variant_attention(torch, np, fp, tmp, card):
    """Phase 13b: phase 7's dpt-384 checkpoint under each attention_impl,
    served at b16: the serving fn's device ms and kernels a batch, and the
    log-depth of 16 training frames (plain-fed) against "flax" within its
    jitter control; "fused" and "jnn" load the "flax" state strictly."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.train import loop

    preset, depth_hw, steps, _, every, warmup = FAMILIES[0]
    cfg = _train_config(f"{tmp}/{preset}", preset, depth_hw, steps=steps,
                        every=every, warmup=warmup)
    img, _ = next(loop.build_dataset(cfg, "train").batches(
        16, steps=1, shuffle=False))
    x = torch.from_numpy(img).cuda()
    input_hw = cfg.data.input_hw
    names = {"flax": cfg.model.name, "jnn": "dpt-jnn", "fused": "dpt-fused"}
    models = {impl: serving.model_from_checkpoint(_with_model(cfg, name),
                                                  device="cuda")
              for impl, name in names.items()}
    flax_sd = models["flax"].state_dict()
    for impl in ("jnn", "fused"):
        models[impl].load_state_dict(flax_sd, strict=True)
    want = _plain_log_depth(torch, fp, models["flax"], input_hw, img)
    tol, control = log_depth_tol(torch, np, fp, models["flax"], cfg.model,
                                 input_hw, img, want)
    runs = {}
    for impl, model in models.items():
        got = _plain_log_depth(torch, fp, model, input_hw, img)
        fn = serving.make_serving_fn(model, input_hw)
        with graph_runs(torch, fp) as seen, torch.inference_mode():
            fn(x)  # the capture
        launches = v1_runs(seen, 1, f"attention {impl}")
        ms, kernels = _call_stats(torch, lambda: fn(x))
        runs[impl] = dict(
            log_depth_vs_flax=check_log_close(np, got, want, tol,
                                              f"attention {impl}"),
            bitwise_equal_to_flax=bool(np.array_equal(got, want)),
            serving_device_ms=ms, serving_kernels=kernels,
            serving_event_ms=time_ms(lambda: fn(x), iters=10),
            v1_launches_a_batch=launches)
        check(launches == 1, f"attention {impl}: v1 called {launches} "
              "times a batch")
    out = dict(batch=16, tol=tol, jitter_control=control, runs=runs,
               card=card)
    print("variant dpt attention: " + json.dumps(out), flush=True)
    del models
    torch.cuda.empty_cache()
    return {impl: r["v1_launches_a_batch"] for impl, r in runs.items()}


def encdec_upsample_forms(torch, cfg, batch=16):
    """Device ms of one forward and backward of cfg's encdec (random
    frames at `batch`) with its x2 upsamples as `ops.resize.upsample_matmul`
    (two einsums: what the model runs) and, swapped in for this
    measurement only, as `upsample_matmul_nhwc` (DPT's batched GEMMs)."""
    from ann3depth_tpu_torch.models import encdec, registry
    from ann3depth_tpu_torch.ops import resize
    from ann3depth_tpu_torch.train import step as steplib

    model = steplib.init_params(registry.build(cfg.model),
                                cfg.data.input_hw, 0, device="cuda")
    x = torch.randn((batch, *cfg.data.input_hw, 3), device="cuda")

    def fwd_bwd():
        model(x).float().mean().backward()

    out = {}
    try:
        for name in ("upsample_matmul", "upsample_matmul_nhwc"):
            encdec.upsample_matmul = getattr(resize, name)
            out[f"{name}_fwd_bwd_ms"] = device_ms(torch, fwd_bwd, iters=10)[0]
    finally:
        encdec.upsample_matmul = resize.upsample_matmul
    del model
    return out


def variant_encdec(torch, np, fp, tmp, card, handoff):
    """Phase 13c and d: make3d-encdec (b16) from phase 9's pool of 64
    scenes at norm "none", upsample "resize" and refine on both decoder
    stages, VARIANT_STEPS steps each; the default encdec's forward and
    backward under both upsample forms; then `--optimizer sgd` at K=1 and
    K=POOL_K (graph_pair: the GRAPH_* tolerances)."""
    enc, scenes = handoff["cfg"], handoff["scenes"]
    runs, launches = {}, {}
    for name in ("encdec-nonorm", "encdec-resize", "encdec-refine"):
        # Logged every step: the loss curve (and a host sync a step).
        cfg = _with_train(_with_model(enc, name), steps=VARIANT_STEPS,
                          warmup_steps=VARIANT_WARMUP, log_every=1,
                          checkpoint_every=VARIANT_STEPS)
        state, _, run = pool_run(torch, fp, cfg, tmp, name, scenes,
                                 profile=False)
        losses = [v for _, v in run["logged"]]
        first, last = _losses_fall(np, losses, FALL_WINDOW, name)
        check(run["v1_calls_counted"] == 2 * VARIANT_STEPS
              and len(losses) == VARIANT_STEPS,
              f"{name}: {run['v1_calls_counted']} v1 calls in "
              f"{len(losses)} steps")
        runs[name] = dict(params=sum(p.numel() for p in
                                     state.model.parameters()),
                          losses=losses, first_mean=first, last_mean=last,
                          step_ms=run["step_ms"], seconds=run["seconds"])
        launches[name] = run["v1_calls_counted"]
        del state
    forms = encdec_upsample_forms(torch, enc)
    print("variant encdec: " + json.dumps(dict(runs=runs, batch=16,
                                               upsample_forms=forms,
                                               card=card)), flush=True)

    sgd = _with_train(enc, optimizer="sgd", adam_b1=SGD_B1,
                      weight_decay=SGD_WD)
    pair = graph_pair(torch, np, fp, sgd, tmp, "sgd", POOL_K, card, scenes,
                      profile=True)
    g = pair["graph"]["trace"]
    check(pair["params_excess_over_tol"] <= 0
          and pair["loss_rel_diff"] <= GRAPH_LOSS_RTOL and _replays_ok(g),
          f"sgd: K={POOL_K} graph against K=1 eager: params apart by "
          f"{pair['params_max_abs_diff']} (excess "
          f"{pair['params_excess_over_tol']}), loss by "
          f"{pair['loss_rel_diff']}; replays {g['v1_resample_per_replay']}")
    adamw = handoff["encdec"]
    print("variant sgd: " + json.dumps(dict(
        b1=SGD_B1, weight_decay=SGD_WD, pair=pair,
        sgd_k1=_traced_row(pair["eager"]),
        **{f"sgd_k{POOL_K}": _traced_row(pair["graph"]),
           f"adamw_k{POOL_K}_phase9": _traced_row(adamw["graph"])},
        adamw_k1_phase9=_traced_row(adamw["eager"]), card=card)),
        flush=True)
    launches.update(sgd_k1=pair["eager"]["v1_calls_counted"],
                    sgd_graph_eager_block=pair["graph"]["v1_calls_counted"],
                    sgd_replayed_resample_per_step=g["v1_resample_per_step"])
    return launches


def true_scale_make3d(torch, np, fp, tmp, card, handoff):
    """Phase 13e: Make3D's four archives at their true scale from
    tools/synth_real_scale.py (2272x1704 JPEGs, Test134Depth in the
    (305, 55, 4) orientation) through `cli download`, TRUE_SCALE_STEPS
    train steps of make3d-encdec (b16) from the tree (the losses falling,
    the loader's frames 480x640 and its grids 305x55 at every v1 call) and
    `cli eval` of Test134/."""
    import importlib.util

    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.train import step as steplib

    root = f"{tmp}/true_scale"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "synth_real_scale.py")
    spec = importlib.util.spec_from_file_location("synth_real_scale", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tool.synth_make3d(root, n_train=TRUE_SCALE_SPLIT[0],
                          n_test=TRUE_SCALE_SPLIT[1])
    write_s = time.perf_counter() - t0
    archive_mb = sum(os.path.getsize(os.path.join(root, "make3d", f))
                     for f in os.listdir(f"{root}/make3d")) / 1e6
    t0 = time.perf_counter()
    check(cli.main(["download", "--dataset", "make3d", "--data-dir", root])
          == 0, "download of the true-scale Make3D archives")
    download_s = time.perf_counter() - t0
    ckpt = f"{tmp}/true_scale_ckpt"
    argv = ["--config", "make3d-encdec", "--datasets", "make3d",
            "--data-dir", root, "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as true_graphs, \
            _recording(fp, steplib) as seen:
        _cli_json(cli, ["train", *argv, "--steps", str(TRUE_SCALE_STEPS),
                        "--log-every", "5", "--warmup-steps",
                        str(VARIANT_WARMUP)])
    train_s = time.perf_counter() - t0
    launches = true_graphs["launches"]
    true_v1 = train_v1(true_graphs, TRUE_SCALE_STEPS, 2, "true-scale make3d")
    first, last = _losses_fall(np, seen["losses"], FALL_WINDOW,
                               "true-scale make3d")
    check(len(seen["losses"]) == TRUE_SCALE_STEPS and all(
              c in (((16, *RAW_HW, 3), False),
                    ((16, *MAKE3D_DEPTH_HW, 1), True))
              for c in seen["calls"]),
          f"true-scale make3d: {len(seen['losses'])} steps, {launches} v1 "
          f"launches, calls {set(seen['calls'])}")
    with open(f"{ckpt}/metrics.jsonl") as f:
        ips = [r["images_per_sec"] for r in map(json.loads, f)
               if "images_per_sec" in r]
    with graph_runs(torch, fp) as graphed:
        ev = _cli_json(cli, ["eval", *argv])
    eval_launches = v1_runs(graphed, 2, "true-scale make3d eval")
    check(_all_finite(np, ev)
          and eval_launches == 2 * (TRUE_SCALE_SPLIT[1] // 16),
          f"true-scale make3d eval: {eval_launches} v1 runs, {graphed}, "
          f"{ev}")
    out = dict(scenes=TRUE_SCALE_SPLIT, image_wh=list(tool.MAKE3D_IMG_WH),
               archives_mb=archive_mb, write_s=write_s,
               download_s=download_s, train_s=train_s,
               losses=[float(v) for v in seen["losses"]],
               first_mean=first, last_mean=last, loop_images_per_s=ips,
               phase12_tree_images_per_s=handoff["tree_images_per_s"],
               eval=ev, launches=launches, v1_runs=true_v1,
               step_graphs=true_graphs, eval_launches=eval_launches,
               card=card)
    print("true-scale make3d: " + json.dumps(out), flush=True)
    return dict(train=launches, eval=eval_launches)


def variants_phase(torch, np, fp, card, tmp, handoff):
    """Phase 13: the models' variant fields (13a-d) and the true-scale
    Make3D tree (13e). Returns the v1 launches of its paths."""
    _register_variants()
    seconds, launches = {}, {}
    for name, fn, args in (
            ("dpt_matmul", variant_dpt, (torch, np, fp, tmp, card, handoff)),
            ("dpt_attention", variant_attention, (torch, np, fp, tmp, card)),
            ("encdec", variant_encdec, (torch, np, fp, tmp, card, handoff)),
            ("true_scale_make3d", true_scale_make3d,
             (torch, np, fp, tmp, card, handoff))):
        t0 = time.perf_counter()
        launches[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    print("phase 13 seconds: " + json.dumps(dict(seconds, card=card)),
          flush=True)
    return launches


# Phase 14. `bench` through the CLI on make3d-encdec (train, b16, the
# default 100 steps; serving b32, plain and int8) and bench/train.py and
# bench/infer.py on dpt-384 (DPT_BENCH_STEPS steps, serving b16). A timed
# step or batch may not be shorter than BENCH_DEVICE_SHARE of its device
# time: the replays do at least the work the card does eagerly.
DPT_BENCH_STEPS, DPT_SERVING_BATCH = 50, 16
BENCH_DEVICE_SHARE = 0.9
BENCH_PROFILE_STEPS = 3


@contextlib.contextmanager
def _bench_graphs(train_bench, infer_bench):
    """Within the block, the BlockRunner of each train bench and the replays
    of each serving bench are kept in `made`."""
    made = dict(runners=[], replays=[])
    runner_cls, graphs = train_bench.BlockRunner, infer_bench.serving_graphs

    class Kept(runner_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["runners"].append(self)

    def kept(fn, pool):
        made["replays"].append(graphs(fn, pool))
        return made["replays"][-1]

    train_bench.BlockRunner, infer_bench.serving_graphs = Kept, kept
    try:
        yield made
    finally:
        train_bench.BlockRunner = runner_cls
        infer_bench.serving_graphs = graphs


def _bench_train_device(torch, cfg, result):
    """device_profile of BENCH_PROFILE_STEPS eager train steps of `cfg` on a
    fresh state and the bench's pool entry 0, at the bench's step ms."""
    from ann3depth_tpu_torch.bench import train as train_bench
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    state = loop.create_state(cfg, "cuda")
    img, dep = train_bench.make_pool(cfg.train.batch_size, (480, 640), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = train_bench.step_kwargs(cfg)

    def step():
        steplib.train_step(state, img[0], dep[0], gen, **kw)

    step()
    return device_profile(torch, step, BENCH_PROFILE_STEPS,
                          result["step_ms"])


def _bench_run(np, fp, label, fn, expect_eager, expect_captured, train_run):
    """One bench run under `_recording` with the v1 count set to 0 just
    before it: its JSON line, its v1 launches outside the captures (which
    must be `expect_eager`), its v1 calls recorded into CUDA graphs (which
    must be `expect_captured`: the graphs replay them) and, of a serving
    run, its replays; the recorded losses finite and 0 < mfu <= 1."""
    from ann3depth_tpu_torch.bench import infer as infer_bench
    from ann3depth_tpu_torch.bench import train as train_bench
    from ann3depth_tpu_torch.train import step as steplib

    kernel = fp.fused_preprocess  # _recording counts on, and swaps, it
    kernel.launches = 0
    with _recording(fp, steplib) as seen, \
            _bench_graphs(train_bench, infer_bench) as made:
        result = fn()
    launches = kernel.launches
    captured = len(seen["calls"]) - launches
    check(launches == expect_eager, f"bench {label}: {launches} v1 launches "
          f"outside the graphs, {expect_eager} expected")
    check(captured == expect_captured, f"bench {label}: {captured} v1 calls "
          f"captured, {expect_captured} expected")
    check(0 < result.get("mfu", 0) <= 1, f"bench {label}: mfu "
          f"{result.get('mfu')} outside (0, 1]")
    if train_run:
        losses = [float(x) for x in seen["losses"]] + [result["final_loss"]]
        check(bool(np.isfinite(losses).all()),
              f"bench {label}: non-finite losses")
        check(len(made["runners"]) == 1 and made["runners"][0].captures
              == 1, f"bench {label}: the step was not captured")
        return result, launches, captured, None
    check(len(made["replays"]) == 1 and all(
        r.graph is not None for r in made["replays"][0]),
        f"bench {label}: the serving fn was not captured")
    return result, launches, captured, made["replays"][0]


def _bench_serving_checks(torch, label, result, replays):
    """The replays of a serving bench: device_profile of one pass over the
    pool entries (every replay but the profiler's first must show the v1
    resample), `batch_ms` against that device time, and entry 0's replayed
    output against the eager serving fn on the same frames (EXPORT_RTOL)."""
    prof = device_profile(torch, lambda: [r() for r in replays], 1,
                          result["batch_ms"] * len(replays))
    check(prof is not None, f"bench {label}: the profiler saw no kernel")
    per_batch = prof["device_busy_ms_per_step"] / len(replays)
    check(prof["v1_resample_per_step"] >= len(replays) - 1,
          f"bench {label}: {prof['v1_resample_per_step']} v1 resample "
          f"launches in {len(replays)} replays")
    check(result["batch_ms"] >= BENCH_DEVICE_SHARE * per_batch,
          f"bench {label}: batch_ms {result['batch_ms']} below "
          f"{BENCH_DEVICE_SHARE} x its device time {per_batch}")
    first = replays[0]
    got = first().clone()
    want = first.fn(first.x)
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= EXPORT_RTOL, f"bench {label}: the replay is {rel} from the "
          "eager serving fn")
    return dict(device_ms_per_batch=per_batch,
                v1_resample_in_replays=prof["v1_resample_per_step"],
                replay_vs_eager_rel=rel, replay_equals_eager=rel == 0.0)


def bench_phase(torch, np, fp, card):
    """Phase 14: `bench` (train and serving) on make3d-encdec through the
    CLI and on dpt-384 through bench/train.py and bench/infer.py. Returns
    the v1 launches outside the graphs of each run."""
    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.bench import infer as infer_bench
    from ann3depth_tpu_torch.bench import train as train_bench
    from ann3depth_tpu_torch.config import get_config

    encdec, dpt = get_config("make3d-encdec"), get_config("dpt-384")

    def train_launches(steps, warmup=10):
        """2 a step outside the graph: warm-up (the FLOP-counted step
        first), the eager steps and the first block, which runs eagerly."""
        return 2 * (warmup + min(steps, 100) + max(20, min(steps, 50)))

    serving_launches = 1 + infer_bench.POOL_ENTRIES  # FLOP count, warm-up
    runs = (
        ("encdec_train", encdec, True, 100,
         lambda: _cli_json(cli, ["bench", "--config", "make3d-encdec"])),
        ("encdec_serving", encdec, False, None,
         lambda: _cli_json(cli, ["bench", "--serving", "--config",
                                 "make3d-encdec", "--batch-size", "32"])),
        ("encdec_serving_int8", encdec, False, None,
         lambda: _cli_json(cli, ["bench", "--serving", "--config",
                                 "make3d-encdec", "--batch-size", "32",
                                 "--quant", "int8"])),
        ("dpt384_train", dpt, True, DPT_BENCH_STEPS,
         lambda: train_bench.run(dpt, steps=DPT_BENCH_STEPS, device="cuda")),
        ("dpt384_serving", dpt, False, None,
         lambda: infer_bench.run(dpt, batch=DPT_SERVING_BATCH,
                                 device="cuda")))
    launches = {}
    for label, cfg, train_run, steps, fn in runs:
        t0 = time.perf_counter()
        result, n, captured, replays = _bench_run(
            np, fp, label, fn,
            train_launches(steps) if train_run else serving_launches,
            2 if train_run else infer_bench.POOL_ENTRIES, train_run)
        if train_run:
            prof = _bench_train_device(torch, cfg, result)
            check(prof is not None, f"bench {label}: no kernel profiled")
            device_ms = prof["device_busy_ms_per_step"]
            check(result["step_ms"] >= BENCH_DEVICE_SHARE * device_ms,
                  f"bench {label}: step_ms {result['step_ms']} below "
                  f"{BENCH_DEVICE_SHARE} x its device time {device_ms}")
            extra = dict(device_ms_per_step=device_ms,
                         kernels_per_step=prof["kernels_per_step"])
        else:
            extra = _bench_serving_checks(torch, label, result, replays)
            del replays  # their graphs' memory
        launches[label] = n
        print(f"bench {label}: " + json.dumps(dict(
            result, v1_launches_eager=n, v1_calls_captured=captured,
            seconds=time.perf_counter() - t0, card=card, **extra)),
            flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the compiled programs, as CUDA graphs.
# ---------------------------------------------------------------------------

PROGRAM_ITERS = 10       # calls a timing reads (one profiled pass, one timed)
PROGRAM_FRAMES = 4       # live and infer frames held bit for bit
PROGRAM_BURST = 96       # single-frame requests of a serving burst
TRANSCODE_TAIL = 3       # frames in the transcode loop's short last batch
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cudaMemcpy", "cudaMemset")


def call_profile(torch, fn, iters=PROGRAM_ITERS):
    """A call of `fn` on the card: its wall time (host clock, synchronized,
    PROGRAM_ITERS calls), and from torch.profiler over as many calls the
    device busy time (the union of the kernels' intervals), the busy share
    of the wall time, the kernels and the v1 resamples on the device, and
    the launches the host made (CUDA runtime kernel, graph, copy and set
    calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
    check(kernels, "the profiler recorded no kernel")
    busy, end = 0.0, float("-inf")
    for e in kernels:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    device_ms = busy / iters / 1e3
    return dict(
        wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
        kernels=len(kernels) / iters,
        v1_resample=sum("band_resample_kernel" in e.name
                        for e in kernels) / iters,
        host_launches=sum(e.device_type == DeviceType.CPU
                          and e.name.startswith(HOST_LAUNCHES)
                          for e in events) / iters)


def eager_vs_graph(torch, eager, graph):
    """`call_profile` of a path's eager call and of its graph's replay on
    the same inputs, in turns."""
    return {"eager": call_profile(torch, eager),
            "graph": call_profile(torch, graph)}


def _equal(torch, np, got, want, label):
    """Graph and eager outputs (tensors or numpy arrays, or dicts or tuples
    of them) equal bit for bit."""
    if isinstance(got, dict):
        for k in want:
            _equal(torch, np, got[k], want[k], f"{label} {k}")
        return
    if isinstance(got, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(torch, np, g, w, f"{label} [{i}]")
        return
    got, want = (t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                 for t in (got, want))
    check(got.shape == want.shape and np.array_equal(got, want),
          f"{label}: the graph's output differs from the eager call's")


def _control_fails(np, got, want, tol, label):
    """The off-by-one-pixel control's log-depth `got` against the
    plain-fed `want`: it must fail `tol` (log_depth_tol), in max or mean;
    returns its errors."""
    diff = np.abs(got - want)
    err = dict(max=float(diff.max()), mean=float(diff.mean()))
    check(err["max"] > tol["max"] or err["mean"] > tol["mean"],
          f"{label}: the shifted-window control passes {tol}: {err}")
    return err


def program_ladder(torch, np, fp, cfg):
    """The serve ladder of cfg's checkpoint: `BatchingService.warmup` in
    this thread captures every bucket (1...32) and the peak memory of the
    ladder is read; a burst of single frames, replayed by the dispatch
    thread, equals the eager program on each dispatched batch; every
    bucket's graph equals the eager program; a plain-fed twin built
    inside `fed_by` holds b16, the shifted-window control fails; requests/s
    of a burst, graph against a warmed eager service; eager against graph
    at b32."""
    from ann3depth_tpu_torch import server, serving

    input_hw = tuple(cfg.data.input_hw)
    model = serving.model_from_checkpoint(cfg, device="cuda")
    frames = np.random.default_rng(15).integers(
        0, 256, (32, *RAW_HW, 3), dtype=np.uint8)
    x = torch.from_numpy(frames).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dispatched = []
    with graph_runs(torch, fp) as seen:
        fn = serving.make_serving_fn(model, input_hw)
        predict = serving.numpy_predictor(fn)

        def recorded(batch):
            out = predict(batch)
            dispatched.append((batch, out))
            return out

        svc = server.BatchingService(recorded, RAW_HW, max_batch=32)
        try:
            svc.warmup()
            torch.cuda.synchronize()
            ladder_peak = torch.cuda.max_memory_allocated() - held
            dispatched.clear()
            futs = [svc.submit(f) for f in frames[:12]]
            for f in futs:
                f.result(timeout=120)
            buckets = list(svc._buckets)
        finally:
            svc.close()
    v1_runs(seen, 1, f"ladder {cfg.model.name}")
    check(seen["captures"] == len(buckets) == 6 and dispatched,
          f"ladder {cfg.model.name}: {seen}, buckets {buckets}")
    with torch.inference_mode():
        for batch, out in dispatched:  # replayed by the dispatch thread
            _equal(torch, np, out, fn.fn(torch.from_numpy(batch).cuda()),
                   f"ladder {cfg.model.name} dispatched b{len(batch)}")
        for b in buckets:
            _equal(torch, np, fn(x[:b]), fn.fn(x[:b]),
                   f"ladder {cfg.model.name} b{b}")
        got = np.log(fn(x[:16]).cpu().numpy())
        with fed_by(fp, fp.plain_preprocess):
            want = np.log(serving.make_serving_fn(model, input_hw)(
                x[:16]).cpu().numpy())
        with fed_by(fp, _shifted_window(fp)):
            shifted = np.log(serving.make_serving_fn(model, input_hw)(
                x[:16]).cpu().numpy())
    tol, control = log_depth_tol(torch, np, fp, model, cfg.model, input_hw,
                                 frames[:16], want)
    err = check_log_close(np, got, want, tol,
                          f"ladder {cfg.model.name} b16 vs plain-fed")
    ctrl = _control_fails(np, shifted, want, tol,
                          f"ladder {cfg.model.name} b16")

    def eager_predict(batch):
        with torch.inference_mode():
            return fn.fn(torch.from_numpy(batch).cuda()).cpu().numpy()

    rates = {}
    for kind, serve_fn in (("graph", predict), ("eager", eager_predict)):
        svc = server.BatchingService(serve_fn, RAW_HW, max_batch=32)
        try:
            server.warmup(svc)
            t0 = time.perf_counter()
            futs = [svc.submit(frames[i % 32])
                    for i in range(PROGRAM_BURST)]
            for f in futs:
                f.result(timeout=120)
            rates[kind] = dict(requests_per_s=PROGRAM_BURST / (
                time.perf_counter() - t0), **svc.stats())
        finally:
            svc.close()
    with torch.inference_mode():
        timing = eager_vs_graph(torch, lambda: fn.fn(x), lambda: fn(x))
    check(timing["graph"]["v1_resample"] >= 0.9,
          f"ladder {cfg.model.name}: no v1 resample in the b32 replay")
    return dict(model=cfg.model.name, buckets=buckets, graphs=seen,
                ladder_peak_bytes=ladder_peak, held_bytes=held,
                dispatched=[len(b) for b, _ in dispatched],
                log_depth_vs_plain_b16=err, tol=tol, jitter_control=control,
                shifted_control=ctrl, burst=rates, b32=timing)


def program_artifact(torch, np, fp, tmp):
    """`serve --artifact`'s program: phase 10's exported make3d-encdec (any
    batch) through `load_serving`'s GraphCache at b1, b8 and b32, each
    graph equal to the exported program run eagerly; the v1 resample in a
    traced replay; eager against graph at b32."""
    from ann3depth_tpu_torch import serving

    loaded = serving.load_serving(f"{tmp}/artifact_any")
    frames = np.random.default_rng(16).integers(
        0, 256, (32, *RAW_HW, 3), dtype=np.uint8)
    x = torch.from_numpy(frames).cuda()
    with graph_runs(torch, fp) as seen, torch.inference_mode():
        for b in (1, 8, 32):
            _equal(torch, np, loaded.fn(x[:b]), loaded.fn.fn(x[:b]),
                   f"artifact b{b}")
    # the program calls the op itself; the warm calls and the eager
    # references launch it, a capture records it unseen
    check(seen["captures"] == 3 and seen["launches"] == 6,
          f"artifact graphs: {seen}")
    with torch.inference_mode():
        timing = eager_vs_graph(torch, lambda: loaded.fn.fn(x),
                                lambda: loaded.fn(x))
    check(timing["graph"]["v1_resample"] >= 0.9,
          "artifact: no v1 resample in the b32 replay")
    return dict(graphs=seen, b32=timing)


def program_live(torch, np, fp, cfg, lives):
    """`LiveEngine` on the `live` config and phase 4's checkpoint, without
    and with smoothing: one capture (one v1 call recorded) in the
    constructor; PROGRAM_FRAMES frames (one of uniform noise) equal to
    eager `live_step` with the carry passed by hand, bit for bit; the same
    frames replayed from another thread after `reset_smoothing`, equal
    again; a plain-fed twin engine built inside `fed_by` within
    `_live_close`, the shifted-window engine failing SERVE_LOG_TOL; eager
    against graph a frame, `device_step_latency`, and phase 6's viewer
    percentiles at 30 fps."""
    import dataclasses
    import threading

    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.live import infer as live
    from ann3depth_tpu_torch.live.capture import SyntheticSource

    base = get_config("live")
    live_cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, ckpt_dir=cfg.train.ckpt_dir))
    frame_hw, input_hw = live_cfg.live.frame_hw, live_cfg.data.input_hw
    model = serving.model_from_checkpoint(live_cfg, device="cuda")
    src = SyntheticSource(frame_hw, seed=15)
    frames = [np.random.default_rng(17).integers(
        0, 256, (*frame_hw, 3), dtype=np.uint8)]
    frames += [src.read() for _ in range(PROGRAM_FRAMES - 1)]
    kw = dict(input_hw=input_hw, display_hw=frame_hw)
    out = {}
    for smooth in (0.0, 0.8):
        label = f"live smooth {smooth}"
        with graph_runs(torch, fp) as seen:
            engine = live.LiveEngine(model, frame_hw, input_hw, smooth=smooth)
        v1_runs(seen, 1, label)
        check(seen["captures"] == 1, f"{label}: {seen}")
        got = [engine.infer(f, fetch_depth=True)[:2] for f in frames]
        carry = None
        for i, f in enumerate(frames):
            xf = torch.from_numpy(f)[None].cuda()
            if smooth:
                if carry is None:
                    carry = torch.zeros((1, *got[0][0].shape), device="cuda")
                d, r, carry = live.live_step(
                    model, xf, smooth=smooth, prev_log=carry,
                    has_prev=torch.tensor(float(i > 0), device="cuda"), **kw)
            else:
                d, r = live.live_step(model, xf, **kw)
            _equal(torch, np, got[i], (d[0], r[0]), f"{label} frame {i}")
        engine.reset_smoothing()
        other = []
        worker = threading.Thread(target=lambda: other.extend(
            engine.infer(f, fetch_depth=True)[:2] for f in frames))
        worker.start()
        worker.join(timeout=120)
        check(len(other) == len(frames), f"{label}: the other thread hung")
        _equal(torch, np, other, got, f"{label} from another thread")
        twins = {}
        for name, pre in (("plain", fp.plain_preprocess),
                          ("shifted", _shifted_window(fp))):
            with fed_by(fp, pre):
                twin = live.LiveEngine(model, frame_hw, input_hw,
                                       smooth=smooth)
                twins[name] = [twin.infer(f, fetch_depth=True)[:2]
                               for f in frames]
                del twin
        parity = [_live_close(np, live, g, w, f"{label} frame {i} vs "
                              "plain-fed") for i, (g, w) in enumerate(
                                  zip(got, twins["plain"]))]
        ctrl = _control_fails(
            np, np.log(np.stack([d for d, _ in twins["shifted"]])),
            np.log(np.stack([d for d, _ in twins["plain"]])),
            dict(max=SERVE_LOG_TOL, mean=SERVE_LOG_TOL), f"{label}")
        noise = torch.from_numpy(frames[0])[None].cuda()
        engine.reset_smoothing()
        smoothed = dict(smooth=smooth, prev_log=torch.zeros(
            (1, *got[0][0].shape), device="cuda"), has_prev=torch.ones(
                (), device="cuda")) if smooth else {}
        timing = eager_vs_graph(
            torch, lambda: live.live_step(model, noise, **kw, **smoothed),
            lambda: engine._step(noise))
        check(timing["graph"]["v1_resample"] >= 0.9,
              f"{label}: no v1 resample in the replay")
        viewer = lives["runs"][f"smooth_{smooth}"]
        out[f"live_smooth_{smooth}"] = dict(
            graphs=seen, parity_vs_plain_fed=parity, shifted_control=ctrl,
            frame=timing,
            device_step_latency_ms=engine.device_step_latency(100) * 1e3,
            viewer_30fps=dict(frames=viewer["frames"], fps=viewer["fps"],
                              p50_ms=viewer["latency_p50_ms"],
                              p99_ms=viewer["latency_p99_ms"]))
    return out


def program_transcode(torch, np, fp, cfg):
    """The transcode loop at batch TRANSCODE_BATCH with a tail of
    TRANSCODE_TAIL frames: one graph for each shape, every batch equal to
    eager `live_step`; eager against graph a full batch."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.live import infer as live
    from ann3depth_tpu_torch.live.transcode import render_batches
    from ann3depth_tpu_torch.utils import graphs

    model = serving.model_from_checkpoint(cfg, device="cuda")
    input_hw = tuple(cfg.data.input_hw)
    n = 2 * TRANSCODE_BATCH + TRANSCODE_TAIL
    frames = np.random.default_rng(18).integers(0, 256, (n, *RAW_HW, 3),
                                                dtype=np.uint8)
    batches = [(frames[i:i + TRANSCODE_BATCH], min(TRANSCODE_BATCH, n - i))
               for i in range(0, n, TRANSCODE_BATCH)]
    with graph_runs(torch, fp) as seen:
        out = list(render_batches(model, iter(batches), input_hw=input_hw))
    v1_runs(seen, 1, "transcode")
    check(seen["captures"] == 2 and seen["replays"] == len(batches),
          f"transcode graphs: {seen}")
    kw = dict(input_hw=input_hw, display_hw=RAW_HW)
    for i, ((x, k), (_, rendered, depth)) in enumerate(zip(batches, out)):
        d, r = live.live_step(model, torch.from_numpy(x).cuda(), **kw)
        _equal(torch, np, (depth, rendered),
               (d[:k].cpu().numpy(), r[:k].cpu().numpy()),
               f"transcode batch {i}")
    x = torch.from_numpy(frames[:TRANSCODE_BATCH]).cuda()
    step = graphs.GraphCache(
        lambda f, **k: live.live_step(model, f, **k), device="cuda")
    timing = eager_vs_graph(torch, lambda: live.live_step(model, x, **kw),
                            lambda: step(x, **kw))
    return dict(batches=[k for _, k in batches], graphs=seen,
                batch=timing)


def program_eval(torch, np, fp, cfg):
    """The eval step on phase 4's checkpoint at b16: a graph of each
    protocol's `eval_stats_step` equal to the eager step on every batch,
    `evaluate`'s metrics equal to the eager step's summed; a plain-fed
    `evaluate` inside `fed_by` within EVAL_METRIC_RTOL, the shifted-window
    control failing it; eager against graph a batch, and images/s."""
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib
    from ann3depth_tpu_torch.utils import graphs

    state = loop.restore_state_for_eval(cfg)
    batch = cfg.train.batch_size
    data = [tuple(torch.from_numpy(a).cuda() for a in pair)
            for pair in loop.build_dataset(cfg, "test").batches(
                batch, steps=EVAL_BATCHES, shuffle=False)]
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg),
              si_lambda=cfg.train.si_lambda, loss_kind=cfg.train.loss)
    out = {}
    for name, extra in (("plain", {}), ("tta+align+crop", dict(
            tta="flip", align="median", crop="eigen"))):
        with graph_runs(torch, fp) as seen:
            cache = graphs.GraphCache(
                lambda i, d, **k: steplib.eval_stats_step(state, i, d, **k),
                device="cuda")
            totals = {}
            for img, dep in data:
                got = cache(img, dep, **kw, **extra)
                want = steplib.eval_stats_step(state, img, dep, **kw, **extra)
                _equal(torch, np, got, want, f"eval {name}")
                for k, v in want.items():
                    totals[k] = totals[k] + v if k in totals else v
        v1_runs(seen, 2, f"eval {name}")
        check(seen["captures"] == 1, f"eval {name}: {seen}")
        eager = loop.losses.finalize_depth_metrics(
            {k: float(v) for k, v in totals.items()})
        metrics = loop.evaluate(cfg, state=state, max_batches=EVAL_BATCHES,
                                **extra)
        check(metrics == eager, f"eval {name}: evaluate {metrics}, the "
              f"eager step's sums {eager}")
        img, dep = data[0]
        timing = eager_vs_graph(
            torch, lambda: steplib.eval_stats_step(state, img, dep, **kw,
                                                   **extra),
            lambda: cache(img, dep, **kw, **extra))
        for t in timing.values():
            t["images_per_s"] = batch / t["wall_ms"] * 1e3
        out[name] = dict(graphs=seen, metrics=metrics, batch=timing)
    fed = {}
    for name, pre in (("plain_fed", fp.plain_preprocess),
                      ("shifted_window_control", _shifted_window(fp))):
        with fed_by(fp, pre):
            fed[name] = loop.evaluate(cfg, state=state,
                                      max_batches=EVAL_BATCHES)
    rel = {name: _rel_metrics(out["plain"]["metrics"], m)
           for name, m in fed.items()}
    worst = {name: max(r.values()) for name, r in rel.items()}
    rtol = EVAL_METRIC_RTOL["make3d-encdec"]
    check(worst["plain_fed"] <= rtol < worst["shifted_window_control"],
          f"eval graphs against plain-fed: {worst} (rtol {rtol})")
    out.update(largest_rel=worst, rtol=rtol)
    return out


def program_infer(torch, np, fp, cfg):
    """`infer_image`'s graphs of `infer_step` on phase 4's checkpoint: one
    capture, PROGRAM_FRAMES frames equal to the eager step, and a frame at
    tta "flip" (its own graph); eager against graph a frame."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.train import step as steplib

    model = serving.model_from_checkpoint(cfg, device="cuda")
    input_hw = tuple(cfg.data.input_hw)
    frames = np.random.default_rng(19).integers(
        0, 256, (PROGRAM_FRAMES, *RAW_HW, 3), dtype=np.uint8)
    with graph_runs(torch, fp) as seen:
        got = [steplib.infer_image(model, f, input_hw=input_hw)
               for f in frames]
        flip = steplib.infer_image(model, frames[0], input_hw=input_hw,
                                   tta="flip")
    v1_runs(seen, 1, "infer")
    check(seen["captures"] == 2 and seen["replays"] == PROGRAM_FRAMES + 1,
          f"infer graphs: {seen}")
    for i, f in enumerate(frames):
        _equal(torch, np, got[i], steplib.infer_step(
            model, torch.from_numpy(f)[None].cuda(), input_hw=input_hw)[0],
            f"infer frame {i}")
    _equal(torch, np, flip, steplib.infer_step(
        model, torch.from_numpy(frames[0])[None].cuda(), input_hw=input_hw,
        tta="flip")[0], "infer tta flip")
    x = torch.from_numpy(frames[:1]).cuda()
    cache = steplib.infer_graphs(model)
    timing = eager_vs_graph(
        torch, lambda: steplib.infer_step(model, x, input_hw=input_hw),
        lambda: cache(x, input_hw=input_hw, tta=""))
    return dict(graphs=seen, frame=timing)


def programs_phase(torch, np, fp, card, tmp, encdec_cfg, lives):
    """Phase 15: the serve, live, transcode, eval and infer paths as CUDA
    graphs (utils/graphs.py), each held bit for bit against its eager
    call, with the v1 kernel recorded into every graph; the served, live
    and eval graphs against plain-fed twins built inside `fed_by`, whose
    shifted-window controls fail. Returns the v1 runs of each path."""
    preset, depth_hw, steps, _, every, warmup = FAMILIES[0]
    dpt_cfg = _train_config(f"{tmp}/{preset}", preset, depth_hw, steps=steps,
                            every=every, warmup=warmup)
    seconds, launches = {}, {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(torch, np, fp, *args)
        seconds[name] = time.perf_counter() - t0
        print(f"programs {name}: " + json.dumps(dict(res, card=card)),
              flush=True)
        return res

    for cfg in (encdec_cfg, dpt_cfg):
        name = f"serve_{cfg.model.name}"
        launches[name] = run(name, program_ladder, cfg)["graphs"]
    launches["serve_artifact"] = run("serve_artifact", program_artifact,
                                     tmp)["graphs"]
    for name, res in run("live", program_live, encdec_cfg, lives).items():
        launches[name] = res["graphs"]
    for name, fn in (("transcode", program_transcode),
                     ("eval", program_eval), ("infer", program_infer)):
        res = run(name, fn, encdec_cfg)
        launches[name] = res.get("graphs") or {
            k: v["graphs"] for k, v in res.items() if isinstance(v, dict)
            and "graphs" in v}
    print("phase 15 seconds: " + json.dumps(dict(seconds, card=card)),
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the train step and the report eval as CUDA graphs.
# ---------------------------------------------------------------------------

STEP_GRAPH_STEPS = 30    # steps of each phase 16 run (logged every 10)


def step_run(torch, fp, cfg, tmp, name, graphed):
    """One K=1 `train.loop.train` run of phase 16, replaying its step
    graph or (`graphed` False) the eager twin, with the loop's profiler
    over PROFILE_STEPS steps: (state, last metrics, record): its v1 runs
    (`train_v1`), step graphs, logged losses, step ms past the window,
    the window's busy share, kernels and host launches a step (kernel and
    graph launch calls), the v1 resamples of each replay, and peak memory
    above what was allocated when it started."""
    import dataclasses
    import glob

    from ann3depth_tpu_torch.train import loop

    kind = "graph" if graphed else "eager"
    work = f"{tmp}/p16_{name}_{kind}"
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=f"{work}/ckpt", profile_dir=f"{work}/trace",
        profile_steps=PROFILE_STEPS))
    steps = cfg.train.steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as seen, gn_runs(torch) as gn_seen, \
            contextlib.nullcontext() if graphed else eager_twin():
        state, last = loop.train(cfg, workdir=work, progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    label = f"step graphs {name} {kind}"
    v1 = train_v1(seen, steps, 2 * cfg.train.grad_accum, label)
    # A microbatch runs the model's Stages each way, and a distilled step
    # its teacher's (the same preset's) forward besides.
    group_norm = train_gn(gn_seen, seen, steps, label, gn_per_forward(cfg),
                          microbatches=cfg.train.grad_accum,
                          forwards=2 if cfg.train.distill_from else 1)
    with open(f"{work}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    first, end = _traced_steps(steps, 1, PROFILE_STEPS)
    traces = glob.glob(f"{work}/trace/*.json")
    check(len(traces) == 1, f"{label}: trace files {traces}")
    t = trace_stats(traces[0], end - first)
    return state, last, dict(
        steps=steps, seconds=seconds, v1_runs=v1, graphs=seen,
        group_norm_calls=group_norm,
        logged=[(r["step"], r["loss"]) for r in rows if "loss" in r],
        step_ms=_steady_ms(rows, cfg.train.batch_size, end),
        busy_share=t["busy_share"],
        device_busy_ms_per_step=t["device_busy_ms_per_step"],
        kernels_per_step=t["kernels_per_step"],
        host_launches_per_step=(t["kernel_launch_calls_per_step"]
                                + t["graph_launch_calls_per_step"]),
        graph_launch_calls_per_step=t["graph_launch_calls_per_step"],
        v1_resample_per_step=t["v1_resample_per_step"],
        v1_resample_per_replay=t["v1_resample_per_replay"],
        gn_kernels_per_replay=t["gn_kernels_per_replay"],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated() - held)


def step_pair(torch, np, fp, cfg, tmp, name, captures=1):
    """cfg at K=1 as the eager twin and replaying its step graph, from one
    seed, feed and draws: equal bit for bit (params, EMA, logged losses,
    last metrics); the graph run captured `captures` keys after an eager
    first step each and replayed the rest, each replay's trace holding
    the v1 resample twice a microbatch (the window's first replay may
    lose its first kernels to the profiler, as in phase 9)."""
    eager, m_eager, r_eager = step_run(torch, fp, cfg, tmp, name, False)
    graph, m_graph, r_graph = step_run(torch, fp, cfg, tmp, name, True)
    g = r_graph["graphs"]
    check(r_eager["graphs"]["steps_captured"] == 0
          and g["steps_captured"] == captures
          and g["steps_replayed"] == cfg.train.steps - captures,
          f"{name}: eager twin {r_eager['graphs']}, graph run {g}")
    same = (m_graph == m_eager and r_graph["logged"] == r_eager["logged"]
            and all(torch.equal(x, y) for x, y in zip(
                graph.model.state_dict().values(),
                eager.model.state_dict().values()))
            and (graph.ema_params is None or all(
                torch.equal(graph.ema_params[k], eager.ema_params[k])
                for k in eager.ema_params)))
    worst, _ = param_gap(torch, graph, eager)
    check(same, f"{name}: the graphed loop differs from its eager twin: "
          f"params by {worst}, logged {r_graph['logged']} against "
          f"{r_eager['logged']}")
    per = 2 * cfg.train.grad_accum
    replays = r_graph["v1_resample_per_replay"]
    check(replays and min(replays[1:] or replays) >= per,
          f"{name}: v1 resamples in the traced replays {replays}")
    # Each replay runs the calls its step graph recorded, two kernels a
    # call each way.
    calls = r_graph["group_norm_calls"]["per_replayed_step"]
    want = [calls["fwd"], calls["fwd"], calls["bwd"], calls["bwd"]]
    gn_replays = r_graph["gn_kernels_per_replay"]
    check(gn_replays and all(n == want for n in gn_replays[1:]),
          f"{name}: GroupNorm kernels ({', '.join(GN_KERNELS)}) in the "
          f"traced replays {gn_replays}, {want} each expected")
    del eager, graph
    torch.cuda.empty_cache()
    return dict(preset_model=cfg.model.name, batch=cfg.train.batch_size,
                grad_accum=cfg.train.grad_accum, datasets=list(
                    cfg.data.datasets), cache_device=cfg.data.cache_device,
                distill=bool(cfg.train.distill_from), bitwise_equal=same,
                eager=r_eager, graph=r_graph)


def _records_config(preset, data, datasets, augment=True, **train):
    """`preset` (b16, augmented unless `augment` is None: the preset's
    own) on phase 8's records under `data`, STEP_GRAPH_STEPS steps at K=1,
    logged every 10."""
    import dataclasses

    from ann3depth_tpu_torch.config import get_config

    cfg = get_config(preset)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, data_dir=data, datasets=datasets,
            augment=cfg.data.augment if augment is None else augment),
        train=dataclasses.replace(cfg.train, **{**dict(
            steps=STEP_GRAPH_STEPS, warmup_steps=10, log_every=10,
            checkpoint_every=STEP_GRAPH_STEPS, eval_every=0), **train}))


def step_graph_dpt(torch, np, fp, tmp, handoff):
    """dpt-384 at K=1 replaying its step graph. Held as phase 13 holds the
    matmul DPT: under torch.use_deterministic_algorithms(True) at upsample
    "matmul", phase 13's child ran a K=1 graph run after its two eager K=1
    runs, and it must equal the first bit for bit (one capture, 9 replays,
    v1 twice a step). In the default mode ("resize", from phase 9's pool
    of the NYU records) the runs part (F.interpolate's backward sums with
    atomics): its graph run's step ms against phase 9's eager runs', and
    its gap to phase 9's first eager run beside twice the largest gap of
    phase 9's eager pairs, reported."""
    import dataclasses

    from ann3depth_tpu_torch.train import loop

    det = handoff["dpt_deterministic"]
    g = det["k1_graph_steps"]
    check(det["k1_graph_bitwise_equal"] and g["steps_captured"] == 1
          and g["steps_replayed"] == DPT_POOL_STEPS - 1
          and det["k1_graph_v1_runs"] == 2 * DPT_POOL_STEPS,
          f"deterministic matmul dpt: the K=1 graph run against the eager "
          f"K=1 run: {det}")
    p9 = handoff["dpt"]
    params, m_eager = handoff["dpt_k1"]
    cfg = dpt_pool_config(f"{tmp}/data")
    work = f"{tmp}/p16_dpt"
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=f"{work}/ckpt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graph_runs(torch, fp) as seen:
        state, last = loop.train(cfg, workdir=work, progress=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    v1 = train_v1(seen, cfg.train.steps, 2, "step graphs dpt")
    check(seen["steps_captured"] == 1 and bool(np.isfinite(last["loss"])),
          f"dpt K=1 graph: {seen}, {last}")
    with open(f"{work}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    gap = 0.0
    with torch.no_grad():
        for n, v in state.model.state_dict().items():
            gap = max(gap, float((v.cpu() - params[n]).abs().max()))
    del state
    torch.cuda.empty_cache()
    return dict(steps=cfg.train.steps, seconds=seconds, v1_runs=v1,
                graphs=seen, deterministic_matmul=dict(
                    k1_graph_bitwise_equal=True, steps=g,
                    graph_step_ms=det["k1_graph_step_ms"],
                    eager_step_ms=det["eager_step_ms"]),
                default_mode_params_max_abs_diff=gap,
                default_mode_loss_rel_diff=abs(last["loss"] - m_eager[
                    "loss"]) / abs(m_eager["loss"]),
                phase9_twice_control_gap=[2 * x for x in p9["control_gap"]],
                graph_step_ms=_steady_ms(rows, cfg.train.batch_size, 5),
                eager_step_ms=p9["eager_step_ms"])


def report_graph(torch, np, fp, cfg, tmp):
    """`evaluate` with a report (tta "flip") on phase 4's checkpoint at
    b16, EVAL_BATCHES batches: through its `eval_report_graphs` cache (one
    capture, a replay a batch) and eagerly, the metrics, per_image.jsonl,
    summary.json and worst.png equal bit for bit; eager against graph a
    batch (`call_profile`)."""
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    state = loop.restore_state_for_eval(cfg)
    out, files = {}, {}
    for kind in ("graph", "eager"):
        report = f"{tmp}/p16_report_{kind}"
        inner = loop.eval_report_graphs
        if kind == "eager":
            loop.eval_report_graphs = lambda st, dev: (
                lambda i, d, **k: steplib.eval_report_step(
                    st, i.to(dev), d.to(dev), **k))
        try:
            with graph_runs(torch, fp) as seen:
                metrics = loop.evaluate(cfg, state=state,
                                        max_batches=EVAL_BATCHES,
                                        report_dir=report, tta="flip")
        finally:
            loop.eval_report_graphs = inner
        runs_v1 = v1_runs(seen, 2, f"report {kind}")
        check(runs_v1 == 2 * EVAL_BATCHES and seen["captures"] == (
            1 if kind == "graph" else 0), f"report {kind}: {seen}")
        files[kind] = [open(f"{report}/{n}", "rb").read() for n in (
            "per_image.jsonl", "summary.json", "worst.png")]
        out[kind] = dict(metrics=metrics, graphs=seen, v1_runs=runs_v1)
    check(out["graph"]["metrics"] == out["eager"]["metrics"]
          and files["graph"] == files["eager"],
          "report eval: the graph's report differs from the eager one")
    img_np, dep_np = next(loop.build_dataset(cfg, "test").batches(
        cfg.train.batch_size, steps=1, shuffle=False))
    img, dep = torch.from_numpy(img_np).cuda(), torch.from_numpy(
        dep_np).cuda()
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg),
              si_lambda=cfg.train.si_lambda, loss_kind=cfg.train.loss,
              tta="flip")
    cache = loop.eval_report_graphs(state, img.device)
    timing = eager_vs_graph(
        torch, lambda: steplib.eval_report_step(state, img, dep, **kw),
        lambda: cache(img, dep, **kw))
    check(timing["graph"]["v1_resample"] >= 0.9,
          "report eval: no v1 resample in the replay")
    return dict(runs=out, rows=files["graph"][0].count(b"\n"),
                bitwise_equal=True, batch=timing)


def step_graphs_phase(torch, np, fp, card, tmp, encdec_cfg, handoff):
    """Phase 16: the train loop at K=1 on the card replays a CUDA graph of
    its step on every feed (train/dispatch.py), held bit for bit against
    its eager twin (`eager_twin`) from one seed, feed and draws: encdec
    b16 from phase 8's Make3D records on the host feed at the preset's
    own flags (no augmentation), and augmented from the device pool, at
    grad_accum 2 and distilled from phase 4's checkpoint, and
    nyu-encdec-aug on the NYU and Make3D records batch by batch (a graph
    of each raw shape); dpt-384 at K=1 (`step_graph_dpt`: bit for bit in
    torch's deterministic mode, timed in the default mode); the report
    eval (`report_graph`). Each run's step
    ms, busy share, host launches a step and peak memory, eager against
    graph. Returns the v1 runs of each path, and the GroupNorm calls
    and kernels a replay of each records-fed run's step graph."""
    data = f"{tmp}/data"
    runs, seconds = {}, {}
    for name, preset, datasets, extra, captures in (
            ("host_feed", "make3d-encdec", ("make3d",), {"augment": None},
             1),
            ("pool", "make3d-encdec", ("make3d",), {"cache_device": True}, 1),
            ("grad_accum", "make3d-encdec", ("make3d",), {"grad_accum": 2},
             1),
            ("distill", "make3d-encdec", ("make3d",),
             {"distill_from": encdec_cfg.train.ckpt_dir}, 1),
            ("two_shapes", "nyu-encdec-aug", ("nyu", "make3d"), {}, 2)):
        import dataclasses

        t0 = time.perf_counter()
        train = {k: v for k, v in extra.items()
                 if k not in ("cache_device", "augment")}
        cfg = _records_config(preset, data, datasets,
                              augment=extra.get("augment", True), **train)
        if extra.get("cache_device"):
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, cache_device=True))
        runs[name] = step_pair(torch, np, fp, cfg, tmp, name, captures)
        seconds[name] = time.perf_counter() - t0
        print(f"step graphs {name}: " + json.dumps(dict(runs[name],
                                                        card=card)),
              flush=True)
    t0 = time.perf_counter()
    runs["dpt"] = step_graph_dpt(torch, np, fp, tmp, handoff)
    seconds["dpt"] = time.perf_counter() - t0
    print("step graphs dpt: " + json.dumps(dict(runs["dpt"], card=card)),
          flush=True)
    t0 = time.perf_counter()
    runs["report"] = report_graph(torch, np, fp, encdec_cfg, tmp)
    seconds["report"] = time.perf_counter() - t0
    print("step graphs report: " + json.dumps(dict(runs["report"],
                                                   card=card)), flush=True)

    def row(r):
        return {k: r[k] for k in (
            "step_ms", "busy_share", "device_busy_ms_per_step",
            "kernels_per_step", "host_launches_per_step",
            "max_memory_allocated_bytes")}

    timings = {name: dict(eager=row(r["eager"]), graph=row(r["graph"]))
               for name, r in runs.items() if "eager" in r}
    timings["dpt"] = dict(eager_step_ms=runs["dpt"]["eager_step_ms"],
                          graph_step_ms=runs["dpt"]["graph_step_ms"],
                          deterministic_matmul=runs["dpt"][
                              "deterministic_matmul"])
    timings["report_batch"] = runs["report"]["batch"]
    print("step graphs timings: " + json.dumps(dict(
        timings, seconds=seconds, card=card)), flush=True)
    launches = {name: dict(eager=r["eager"]["v1_runs"],
                           graph=r["graph"]["v1_runs"])
                for name, r in runs.items() if "eager" in r}
    launches.update(dpt=runs["dpt"]["v1_runs"], report={
        kind: r["v1_runs"] for kind, r in runs["report"]["runs"].items()})
    group_norm = {name: dict(
        calls=r["graph"]["group_norm_calls"],
        kernels_per_replay=r["graph"]["gn_kernels_per_replay"])
        for name, r in runs.items() if "eager" in r}
    return launches, group_norm


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from ann3depth_tpu_torch.compat import reference_spec as ref
    from ann3depth_tpu_torch.device import resolve_device
    from ann3depth_tpu_torch.ops import _kernels, resize
    from ann3depth_tpu_torch.ops import fused_preprocess as fp

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    resolve_device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    logs = _kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    print(f"build: {build_s:.2f} s for {list(_kernels.KERNELS)}", flush=True)
    print(f"card: {card}", flush=True)

    cases = kernel_cases(torch, fp, resize, ref)
    gn_cases = group_norm_cases(torch, card)
    up_cases, up_train = upsample_cases(torch, np, fp, card)
    update_case = adamw_clip_cases(torch, card)
    dispatch = v1_host_dispatch(torch, fp, card)
    cases_v2 = v2_cases(torch, fp, ref)
    specs = family_specs(torch, fp)
    family = family_cases(torch, fp, resize, ref, specs)
    family_v2 = v2_held(torch, fp, ref, [("v2 " + spec[0], *spec[1:])
                                         for spec in specs],
                        library="interpolate")
    del specs
    slice6 = family_cases(torch, fp, resize, ref, slice6_specs(torch, fp))
    parallel = family_cases(torch, fp, resize, ref,
                            parallel_specs(torch, fp))
    serve_launches = serve_slice(torch, np, fp, card)
    with tempfile.TemporaryDirectory() as tmp:
        train, cfg, img, dep = train_slice(torch, np, fp, card, tmp)
        double_run(torch, cfg, img, dep, card)
        instep = v2_in_step(torch, fp, cfg, img, dep, card)
        evals, eval_case = eval_phase(torch, np, fp, cfg, tmp, card)
        served = serve_checkpoint(torch, np, fp, cfg, card)
        lives, live_case, live_launches = live_phase(torch, np, fp, cfg,
                                                     card)
        infer_phase(torch, np, fp, cfg, card)
        phase7 = family_phase(torch, np, fp, card, tmp)
        phase8 = slice6_phase(torch, np, fp, card, tmp, cfg.train.ckpt_dir,
                              train["loop_images_per_s"])
        handoff = {}
        phase9 = pipeline_phase(torch, np, fp, card, tmp, cfg, handoff)
        t10 = time.perf_counter()
        phase10 = quant_export_phase(torch, np, fp, card, tmp, cfg)
        print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)
        t11 = time.perf_counter()
        with eager_twin():  # its one-process references stay eager
            phase11 = parallel_phase(torch, np, fp, card, tmp, cfg, handoff)
        print(f"phase 11: {time.perf_counter() - t11:.1f} s", flush=True)
        t12 = time.perf_counter()
        phase12 = tools_phase(torch, np, fp, card, tmp, train, handoff)
        print(f"phase 12: {time.perf_counter() - t12:.1f} s", flush=True)
        t13 = time.perf_counter()
        phase13 = variants_phase(torch, np, fp, card, tmp, handoff)
        print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
        t14 = time.perf_counter()
        phase14 = bench_phase(torch, np, fp, card)
        print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
        t15 = time.perf_counter()
        phase15 = programs_phase(torch, np, fp, card, tmp, cfg, lives)
        print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)
        t16 = time.perf_counter()
        phase16, phase16_gn = step_graphs_phase(torch, np, fp, card, tmp,
                                                cfg, handoff)
        print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)

    def entry(case, **kw):
        """One kernel's entry of the kernels line, from its train case."""
        keys = ("ms", "resample_ms", "photometric_ms", "event_ms", "host_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        return dict(route="cuda", **kw, **{k: case[k] for k in keys},
                    card=card)

    v1 = entry(
        cases[2],  # the train shape, b16 augment rows
        name="fused_preprocess",
        source="ann3depth_tpu_torch/csrc/fused_preprocess.cu",
        replaces="ann3depth_tpu/ops/pallas_preprocess.py:218",
        launches=train["fused_preprocess_launches"],
        serve_launches=serve_launches,
        eval_launches=sum(r["launches"] for r in evals["runs"].values()),
        serve_ckpt_launches=served["launches"], live_launches=live_launches,
        max_abs_err=max(c["max_abs_err"] for c in cases[:3]), cases=cases,
        live=live_case, eval_image=eval_case, family_cases=family,
        family_launches={k: {p: n for p, n in v.items() if p != "v2_instep"}
                         for k, v in phase7.items()},
        slice6_cases=slice6, slice6_launches=phase8,
        pipeline_launches=phase9, host_dispatch=dispatch,
        quant_launches=phase10["quant_launches"],
        export_launches=phase10["export_launches"],
        parallel_cases=parallel, parallel_launches=phase11,
        variant_launches=phase13, bench_launches=phase14,
        program_graphs=phase15, step_graph_launches=phase16, **phase12)
    v2 = entry(
        cases_v2[1],  # the train shape, b16 augment rows
        name="fused_preprocess_v2",
        source="ann3depth_tpu_torch/csrc/fused_preprocess_v2.cu",
        replaces="ann3depth_tpu/ops/pallas_preprocess.py:337",
        launches=instep["runs"]["v2"][0]["v2_launches"],
        dpt_instep_launches=phase7["dpt-384"]["v2_instep"],
        max_abs_err=max(c["max_abs_err"] for c in cases_v2[:2]),
        cases=cases_v2, family_cases=family_v2)
    # The train step's three norms (the cases), forward and backward.
    group_norm = dict(
        name="group_norm_nhwc", route="cuda",
        source="ann3depth_tpu_torch/csrc/group_norm_nhwc.cu",
        replaces=None,
        ms=sum(c["fwd_ms"] + c["bwd_ms"] for c in gn_cases),
        event_ms=sum(c["fwd_bwd_event_ms"] for c in gn_cases),
        bound_ms=sum(c["fwd_bound_ms"] + c["bwd_bound_ms"]
                     for c in gn_cases), bound_by="bytes",
        plain_ms=sum(c["plain_fwd_bwd_ms"] for c in gn_cases),
        plain_device_ms=sum(c["plain_fwd_bwd_device_ms"] for c in gn_cases),
        library_ms=sum(c["library_fwd_bwd_ms"] for c in gn_cases),
        library_call=gn_cases[0]["library_call"],
        launches=train["group_norm_calls"],
        profiled_step_kernels=train["device_profile"]["gn_kernels_per_step"]
        if isinstance(train["device_profile"], dict) else None,
        step_graph_replays=phase16_gn, cases=gn_cases, card=card)
    # DPT-Large's five upsamples (the cases), forward and backward; the
    # launches of its eager twin's 8 steps and a replayed step's kernels.
    upsample = dict(
        name="upsample_aligned_nhwc", route="cuda",
        source="ann3depth_tpu_torch/csrc/upsample_aligned_nhwc.cu",
        replaces=None,
        ms=sum(c["fwd_ms"] + c["bwd_ms"] for c in up_cases),
        event_ms=sum(c["fwd_event_ms"] + c["bwd_event_ms"] for c in up_cases),
        bound_ms=sum(c["fwd_bound_ms"] + c["bwd_bound_ms"]
                     for c in up_cases), bound_by="bytes",
        pair_ms=sum(c["pair_fwd_ms"] + c["pair_bwd_ms"] for c in up_cases),
        pair_event_ms=sum(c["pair_fwd_event_ms"] + c["pair_bwd_event_ms"]
                          for c in up_cases),
        library_ms=sum(c["library_fwd_ms"] + c["library_bwd_ms"]
                       for c in up_cases),
        library_call=up_cases[0]["library_call"],
        launches=up_train["eager"]["launches"],
        profiled_step_kernels=up_train["eager"]["trace"]["per_step"],
        step_graph_launches=up_train["graph"]["launches"],
        step_graph_replays=up_train["graph"]["trace"]["per_replay"],
        kernel_names=up_train["graph"]["trace"]["names"],
        cases=up_cases, card=card)
    # DPT-Large's update (the case); the launches of phase 2c's eager twin
    # (8 steps) and its step graph's traced replays, by name.
    adamw = dict(
        name="adamw_clip", route="cuda",
        source="ann3depth_tpu_torch/csrc/adamw_clip.cu", replaces=None,
        **{k: update_case[k] for k in (
            "ms", "event_ms", "graph_ms", "host_ms", "bound_ms", "bound_by",
            "plain_ms", "torch_path_ms", "torch_path_graph_ms", "library_ms",
            "library_graph_ms", "library_call")},
        launches=up_train["eager"]["update_launches"],
        profiled_step_kernels=up_train["eager"]["trace"]["update_per_step"],
        step_graph_launches=up_train["graph"]["update_launches"],
        step_graph_replays=up_train["graph"]["trace"]["update_per_replay"],
        kernel_names=up_train["graph"]["trace"]["update_names"],
        cases=[update_case], card=card)
    print(json.dumps({"kernels": [v1, v2, group_norm, upsample, adamw]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
