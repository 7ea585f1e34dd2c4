"""The query–support pairs of the decoder's kernel-path k-NN calls, and
the all-pairs bound: 32 bf16 operations a pair (the kernel's split
products) at the card's bf16 peak. Printed beside the roofline, never its
numerator: a k-NN that prunes pairs does less than all pairs."""

from __future__ import annotations

from work.levels import decoder_calls
from work.knn3_bytes import KERNEL_METHODS

OPS_PER_PAIR = 32


def knn3_pairs(cfg: dict, batch: int) -> int:
    return sum(batch * q * s for q, s, _, method in decoder_calls(cfg)
               if method in KERNEL_METHODS)
