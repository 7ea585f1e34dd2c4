"""The bytes that any correct k-NN of the decoder's kernel path has to
move: each query's and support's xyz (float32) and mask (1 byte) read
once, each neighbour's index (int32) and weight (float32) written once,
over the stages whose method is the kernel's ("pallas")."""

from __future__ import annotations

from work.levels import decoder_calls

KERNEL_METHODS = ("pallas",)


def knn3_bytes(cfg: dict, batch: int) -> int:
    total = 0
    for q, s, k, method in decoder_calls(cfg):
        if method in KERNEL_METHODS:
            total += batch * ((q + s) * (3 * 4 + 1) + q * k * (4 + 4))
    return total
