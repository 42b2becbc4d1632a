"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity; at the full 700 W power limit)."""

BF16_FLOP_PER_S = 989e12  # tensor cores
F32_FLOP_PER_S = 67e12  # outside the tensor cores, an FMA counted as 2
HBM_BYTES_PER_S = 3.35e12
