"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""
BF16_FLOPS = 989.4e12       # bf16 tensor cores, FLOP/s
INT8_OPS = 1979e12          # int8 tensor cores, OP/s
F32_FLOPS = 67e12           # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12         # HBM3, bytes/s
