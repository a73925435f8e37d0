"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

BF16_DENSE_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
