"""Published figures of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its full 700 W power limit; a card set lower
runs slower under load, so the result line names the card's limit)."""

BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
