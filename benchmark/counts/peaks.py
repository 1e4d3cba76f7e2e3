"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

H100_BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3
