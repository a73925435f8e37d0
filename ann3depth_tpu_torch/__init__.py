"""ann3depth_tpu_torch: the PyTorch/CUDA port of ann3depth_tpu.

It runs beside the JAX package, which stays the reference, and imports
nothing of it (nor JAX). Ported so far: the serving path of
`make3d-encdec` -- preprocess with a hand-written CUDA kernel
(ops/fused_preprocess.py, csrc/fused_preprocess.cu), `EncDecDepthNet`,
the flax-params converter, the batching server and the `serve` CLI.
"""
