"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12      # bf16 and fp16 on the tensor cores, FLOP/s
FP32_SIMT_FLOPS = 67e12  # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12      # HBM3, bytes/s
