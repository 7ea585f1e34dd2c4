"""gridgcn_torch — the PyTorch + CUDA port of the JAX package, for one
NVIDIA H100.

It serves every preset of the JAX package (whole-scene segmentation, the
`scannet_whole_scene` preset, is the main path): CAGQ (voxel tables,
RVS/CAS sampling, node gathers), GridConv/GCA with folded BatchNorm, and a
decoder whose 3-NN query is a hand-written CUDA kernel (`kernels/knn.py`,
`csrc/knn.cu`); it trains them (`train/steps.py`), and the trainer and
evaluator CLIs drive both with the datasets, checkpoints and metric logs.
It imports torch, numpy and the standard library only (h5py and
tensorboard when asked for). Entry points: `gridgcn_torch.api.Predictor`
and `load_predictor`, `gridgcn_torch.train.steps`, and
`python -m gridgcn_torch.train.train` / `.evaluate`.
"""

__version__ = "0.1.0"
