"""The decoder k-NN kernels' share of their roofline, per request: the bytes
any correct k-NN moves for the configuration's decoder calls at the card's
HBM rate over the kernels' traced device time (readers.knn3_roofline)."""

from harness import readers

UNIT, MOVES, LAYER = "%", "serve_latency_p95_ms", "kernels"
KERNELS = ("knn3_mxu_kernel", "mxu_pack_kernel")


def read(run):
    return readers.knn3_roofline(run, "serve", KERNELS)


def info(run):
    return readers.knn3_info(run, "serve", KERNELS)
