"""Published figures of the card the port runs on, for bounds and
projections (the JAX package's `utils/hw.py` holds its TPU's).

Each figure is NVIDIA's data sheet for the H100 SXM part (dense rates, no
sparsity), which assumes the card's full power limit; the card that every
measurement in PERF.md names is an "NVIDIA H100 80GB HBM3" at 700 W. A
card set below 700 W runs slower under load, so a projection from these
figures is a bound or a projection, never a measurement.
"""

from __future__ import annotations

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0

# tensor-core bf16 and CUDA-core fp32 operations per second
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

# HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12

# NVLink 4: 900 GB/s to the other cards of the host, 450 GB/s each way
NVLINK_BYTES_PER_S = 4.5e11

# the card's smallest DRAM access (an L2 sector): a gathered or scattered
# row moves at least this many bytes
SECTOR_BYTES = 32
