"""Experiment presets — the port's own copy of the JAX package's preset
table, value for value. They mirror the reference's config matrix
(BASELINE.json `configs`, SURVEY.md §2.3 F-17 and §6).

Exact per-layer (grid, nv, M, K, channels) values in the reference are not
recoverable (empty reference mount, SURVEY §0); these presets are
paper-plausible defaults kept entirely in config.
"""

from __future__ import annotations

import dataclasses

from gridgcn_torch.configs.base import (
    Config,
    DataConfig,
    GridLayerSpec,
    ModelConfig,
    TrainConfig,
    UpLayerSpec,
)


def modelnet40_full() -> Config:
    """BASELINE config 1: ModelNet40 cls, 1024 pts, CAGQ-RVS + 3 GridConv."""
    layers = (
        GridLayerSpec(resolution=16, nv=8, n_centers=512, k_neighbors=32,
                      sampler="rvs", mlp=(64, 128), context_channels=32),
        GridLayerSpec(resolution=8, nv=16, n_centers=128, k_neighbors=32,
                      sampler="rvs", mlp=(128, 256), context_channels=64),
        GridLayerSpec(resolution=4, nv=32, n_centers=32, k_neighbors=32,
                      sampler="rvs", mlp=(256, 512), context_channels=128),
    )
    return Config(
        name="modelnet40_full",
        model=ModelConfig(task="cls", num_classes=40, layers=layers,
                          head=(512, 256), dropout=0.5,
                          eval_dtype="bfloat16"),
        data=DataConfig(dataset="modelnet40", num_points=1024, batch_size=16),
        train=TrainConfig(epochs=250, lr=1e-3, lr_schedule="cosine"),
    )


def modelnet40_cas() -> Config:
    """BASELINE config 2: ModelNet40 cls, CAS sampling + coverage-weighted GCA."""
    cfg = modelnet40_full()
    layers = tuple(
        GridLayerSpec(**{**spec.__dict__, "sampler": "cas", "cas_iters": 2})
        for spec in cfg.model.layers
    )
    return Config(
        name="modelnet40_cas",
        model=ModelConfig(**{**cfg.model.__dict__, "layers": layers}),
        data=cfg.data,
        train=cfg.train,
    )


def modelnet40_compact() -> Config:
    """Latency-oriented compact variant (SURVEY §6 latency row)."""
    layers = (
        GridLayerSpec(resolution=16, nv=8, n_centers=256, k_neighbors=16,
                      sampler="rvs", mlp=(32, 64), context_channels=16,
                      use_context_pool=False),
        GridLayerSpec(resolution=8, nv=16, n_centers=64, k_neighbors=16,
                      sampler="rvs", mlp=(64, 128), context_channels=32,
                      use_context_pool=False),
        GridLayerSpec(resolution=4, nv=32, n_centers=16, k_neighbors=16,
                      sampler="rvs", mlp=(128, 256), context_channels=64,
                      use_context_pool=False),
    )
    return Config(
        name="modelnet40_compact",
        model=ModelConfig(task="cls", num_classes=40, layers=layers,
                          head=(256, 128), dropout=0.4,
                          eval_dtype="bfloat16"),
        data=DataConfig(dataset="modelnet40", num_points=1024, batch_size=16),
        train=TrainConfig(epochs=250, lr=1e-3),
    )


def s3dis_seg() -> Config:
    """BASELINE config 3: S3DIS semantic seg, 4096 pts/block, encoder-decoder."""
    layers = (
        GridLayerSpec(resolution=32, nv=8, n_centers=1024, k_neighbors=32,
                      sampler="cas", cas_iters=2, mlp=(64, 64),
                      context_channels=32),
        GridLayerSpec(resolution=16, nv=8, n_centers=256, k_neighbors=32,
                      sampler="cas", cas_iters=2, mlp=(128, 128),
                      context_channels=64),
        GridLayerSpec(resolution=8, nv=16, n_centers=64, k_neighbors=32,
                      sampler="rvs", mlp=(256, 256), context_channels=64),
        GridLayerSpec(resolution=4, nv=32, n_centers=16, k_neighbors=16,
                      sampler="rvs", mlp=(512, 512), context_channels=128),
    )
    up_layers = (
        UpLayerSpec(resolution=4, nv=32, mlp=(256, 256), method="pallas"),
        UpLayerSpec(resolution=8, nv=16, mlp=(256, 256), method="pallas"),
        UpLayerSpec(resolution=16, nv=8, mlp=(256, 128), method="pallas"),
        UpLayerSpec(resolution=32, nv=8, mlp=(128, 128, 128),
                    method="pallas"),
    )
    return Config(
        name="s3dis_seg",
        model=ModelConfig(task="seg", num_classes=13, in_channels=6,
                          layers=layers, up_layers=up_layers, head=(128,),
                          dropout=0.5),
        data=DataConfig(dataset="s3dis", num_points=4096, batch_size=8,
                        num_feats=6, feat_geo_channels=(3, 4, 5)),
        train=TrainConfig(epochs=100, lr=1e-3),
    )


def scannet_seg() -> Config:
    """BASELINE config 4: ScanNet seg, 8192-pt crops, multi-scale voxel grids.
    Trains with bf16 matmuls and the BatchNorm island in f32."""
    layers = (
        GridLayerSpec(resolution=40, nv=8, n_centers=2048, k_neighbors=32,
                      sampler="cas", cas_iters=3, mlp=(64, 64),
                      context_channels=32),
        GridLayerSpec(resolution=20, nv=8, n_centers=512, k_neighbors=32,
                      sampler="cas", cas_iters=3, mlp=(128, 128),
                      context_channels=64),
        GridLayerSpec(resolution=10, nv=16, n_centers=128, k_neighbors=32,
                      sampler="rvs", mlp=(256, 256), context_channels=64),
        GridLayerSpec(resolution=5, nv=32, n_centers=32, k_neighbors=16,
                      sampler="rvs", mlp=(512, 512), context_channels=128),
    )
    up_layers = (
        UpLayerSpec(resolution=5, nv=32, mlp=(256, 256), method="pallas"),
        UpLayerSpec(resolution=10, nv=16, mlp=(256, 256), method="pallas"),
        UpLayerSpec(resolution=20, nv=8, mlp=(256, 128), method="pallas"),
        UpLayerSpec(resolution=40, nv=8, mlp=(128, 128, 128),
                    method="pallas"),
    )
    return Config(
        name="scannet_seg",
        model=ModelConfig(task="seg", num_classes=21, in_channels=0,
                          layers=layers, up_layers=up_layers, head=(128,),
                          dropout=0.5, ignore_label=0,
                          dtype="bfloat16", bn_dtype="float32"),
        data=DataConfig(dataset="scannet", num_points=8192, batch_size=8),
        train=TrainConfig(epochs=200, lr=1e-3),
    )


def scannet_seg_bf16() -> Config:
    """`scannet_seg` with blanket bf16 compute, BatchNorm included — the
    precision study's starting point, kept for reproducibility."""
    base = scannet_seg()
    return dataclasses.replace(
        base, name="scannet_seg_bf16",
        model=dataclasses.replace(base.model, dtype="bfloat16",
                                  bn_dtype=""))


def scannet_whole_scene() -> Config:
    """BASELINE config 5: whole-scene ScanNet inference, 81920 pts/scene —
    the port's main path (SURVEY §3.4, §6)."""
    layers = (
        GridLayerSpec(resolution=64, nv=16, n_centers=8192, k_neighbors=32,
                      sampler="rvs", mlp=(64, 64), context_channels=32,
                      approx_select=True, approx_topk=True),
        GridLayerSpec(resolution=32, nv=16, n_centers=2048, k_neighbors=32,
                      sampler="rvs", mlp=(128, 128), context_channels=64,
                      approx_select=True, approx_topk=True),
        GridLayerSpec(resolution=16, nv=16, n_centers=512, k_neighbors=32,
                      sampler="rvs", mlp=(256, 256), context_channels=64,
                      approx_select=True, approx_topk=True),
        GridLayerSpec(resolution=8, nv=32, n_centers=128, k_neighbors=16,
                      sampler="rvs", mlp=(512, 512), context_channels=128,
                      approx_select=True, approx_topk=True),
    )
    up_layers = (
        UpLayerSpec(resolution=8, nv=32, mlp=(256, 256), approx_knn=True,
                    method="pallas"),
        UpLayerSpec(resolution=16, nv=16, mlp=(256, 256), approx_knn=True,
                    method="pallas"),
        UpLayerSpec(resolution=32, nv=16, mlp=(256, 128), approx_knn=True,
                    method="pallas"),
        UpLayerSpec(resolution=64, nv=16, mlp=(128, 128, 128),
                    approx_knn=True, method="pallas"),
    )
    return Config(
        name="scannet_whole_scene",
        model=ModelConfig(task="seg", num_classes=21, in_channels=0,
                          layers=layers, up_layers=up_layers, head=(128,),
                          dropout=0.0, dtype="bfloat16", ignore_label=0),
        data=DataConfig(dataset="scannet", num_points=81920, batch_size=1,
                        augment=False),
        train=TrainConfig(),
    )


def synthetic_tiny() -> Config:
    """Tiny config for tests and the overfit integration gate (SURVEY §4.2)."""
    layers = (
        GridLayerSpec(resolution=8, nv=8, n_centers=64, k_neighbors=16,
                      sampler="rvs", mlp=(32, 64), context_channels=16),
        GridLayerSpec(resolution=4, nv=16, n_centers=16, k_neighbors=16,
                      sampler="rvs", mlp=(64, 128), context_channels=32),
    )
    return Config(
        name="synthetic_tiny",
        model=ModelConfig(task="cls", num_classes=4, layers=layers,
                          head=(64,), dropout=0.0),
        data=DataConfig(dataset="synthetic", num_points=256, batch_size=8,
                        augment=False),
        train=TrainConfig(epochs=5, lr=3e-3, log_every=10),
    )


def synthetic_tiny_seg() -> Config:
    """Tiny segmentation config for tests."""
    layers = (
        GridLayerSpec(resolution=8, nv=8, n_centers=64, k_neighbors=16,
                      sampler="rvs", mlp=(32, 64), context_channels=16),
        GridLayerSpec(resolution=4, nv=16, n_centers=16, k_neighbors=8,
                      sampler="rvs", mlp=(64, 128), context_channels=32),
    )
    up_layers = (
        UpLayerSpec(resolution=4, nv=16, mlp=(64, 64)),
        UpLayerSpec(resolution=8, nv=8, mlp=(64, 64)),
    )
    return Config(
        name="synthetic_tiny_seg",
        model=ModelConfig(task="seg", num_classes=4, layers=layers,
                          up_layers=up_layers, head=(64,), dropout=0.0),
        data=DataConfig(dataset="synthetic", num_points=256, batch_size=4,
                        augment=False),
        train=TrainConfig(epochs=5, lr=3e-3, log_every=10),
    )


def synthetic_scene_seg() -> Config:
    """Surface-scene segmentation stand-in (floor/ceiling/wall/object)."""
    layers = (
        GridLayerSpec(resolution=24, nv=16, n_centers=1024, k_neighbors=32,
                      sampler="rvs", mlp=(64, 64), context_channels=32),
        GridLayerSpec(resolution=12, nv=16, n_centers=256, k_neighbors=16,
                      sampler="rvs", mlp=(128, 128), context_channels=64),
    )
    up_layers = (
        UpLayerSpec(resolution=12, nv=16, mlp=(128, 128)),
        UpLayerSpec(resolution=24, nv=16, mlp=(128, 64)),
    )
    return Config(
        name="synthetic_scene_seg",
        model=ModelConfig(task="seg", num_classes=4, layers=layers,
                          up_layers=up_layers, head=(64,), dropout=0.0),
        data=DataConfig(dataset="synthetic_scene", num_points=4096,
                        batch_size=4, augment=False),
        train=TrainConfig(epochs=20, lr=2e-3),
    )


PRESETS = {
    "modelnet40_full": modelnet40_full,
    "modelnet40_cas": modelnet40_cas,
    "modelnet40_compact": modelnet40_compact,
    "s3dis_seg": s3dis_seg,
    "scannet_seg": scannet_seg,
    "scannet_seg_bf16": scannet_seg_bf16,
    "scannet_whole_scene": scannet_whole_scene,
    "synthetic_scene_seg": synthetic_scene_seg,
    "synthetic_tiny": synthetic_tiny,
    "synthetic_tiny_seg": synthetic_tiny_seg,
}


def get(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset '{name}'; available: {sorted(PRESETS)}")
    return PRESETS[name]()
