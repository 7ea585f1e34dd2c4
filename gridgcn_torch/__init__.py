"""gridgcn_torch — the PyTorch + CUDA port of the JAX package, for one
NVIDIA H100.

It serves whole-scene segmentation (the `scannet_whole_scene` preset):
CAGQ (voxel table, threshold RVS, packed-key node gather), GridConv/GCA with
folded BatchNorm, and a decoder whose 3-NN query is a hand-written CUDA
kernel (`kernels/knn.py`, `csrc/knn.cu`). It imports torch, numpy and the
standard library only. Entry point: `gridgcn_torch.api.Predictor`.
"""

__version__ = "0.1.0"
