"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""
BF16_FLOPS = 989e12        # tensor cores, bf16 / fp16 dense
F32_OPS = 67e12            # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12  # HBM3
