"""portbench: the benchmark of ann3depth_tpu_torch on NVIDIA H100 cards.

`python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (run.py). Nothing
here imports JAX or the JAX package; reference/ imports nothing of the
program either.
"""
