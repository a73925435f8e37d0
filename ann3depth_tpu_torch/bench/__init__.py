"""Throughput benchmarks of the port: `train` (the train step) and `infer`
(the serving program), run by `python -m ann3depth_tpu_torch bench`."""
