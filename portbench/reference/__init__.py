"""The benchmark's plain reference of the Grid-GCN networks: plain
PyTorch, run in float32 with TF32 off, that imports nothing of the port.
Its modules are a frozen copy of the port's plain code (the jaxrng
threefry draws, CAGQ's ops, the layers and the segmentation network, the
BatchNorm fold, the augmentation, optax's Adam), so that a change to the
port cannot change the yardstick; the decoder's 3-NN is the exact
brute-force query in place of the port's CUDA kernel. A configuration
names its network as `"<module>:<Class>"` of a file here
(`harness/spec.reference_network`; `segmentation.py`'s by default).
`serve.py` and `train.py` are its entry points."""
