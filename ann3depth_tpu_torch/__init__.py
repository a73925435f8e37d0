"""ann3depth_tpu_torch: the PyTorch/CUDA port of ann3depth_tpu.

It runs beside the JAX package, which stays the reference, and imports
nothing of it (nor JAX). Ported so far, for every model of the JAX
registry (`small`, `encdec`, `multiscale`, `dpt`, `dpt-small`) and so
every preset: serving (random weights, a JAX artifact's or a checkpoint's;
`--dp` over several cards), training, eval, infer and the live depth view,
with the preprocess in hand-written CUDA kernels (ops/fused_preprocess.py,
csrc/); training and eval also across processes, one per device
(parallel/: data parallelism, ZeRO-1, DPT tensor parallelism).
`python -m ann3depth_tpu_torch {train,eval,infer,live,serve,export,prepare}`.
"""
