"""Typed configuration system — the port's own copy of the JAX package's
`configs/base.py` (component F-17, SURVEY.md §2.3).

Every experiment is a frozen dataclass tree: presets live in
`gridgcn_torch.configs.presets`, CLI overrides are dotted-path key=value
pairs. The dataclasses, field names and defaults are identical to the JAX
package's, so `to_dict` of one package's config builds the same config in
the other with `from_dict`. Standard library only.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class GridLayerSpec:
    """One GridConv downsampling stage: CAGQ sampling + GCA aggregation.

    Mirrors the per-layer knobs of the reference's gridify op + GCA module
    (SURVEY §2.1 F-01..F-04, §2.2 F-07/F-08).
    """

    # --- CAGQ (index-building) side ---
    resolution: int = 32           # voxel grid is resolution^3
    nv: int = 16                   # max stored points per voxel (capacity)
    n_centers: int = 512           # M: number of group centers sampled
    k_neighbors: int = 32          # K: node points gathered per center
    context: int = 3               # context neighborhood edge (3 => 3x3x3 voxels)
    sampler: str = "rvs"           # 'rvs' | 'cas'  (F-02 / F-03)
    cas_iters: int = 1             # CAS challenge rounds over occupied voxels
    max_occupied: int = 0          # 0 => no compact occupied list needed (RVS via mask)
    center_mode: str = "barycenter"  # 'barycenter' | 'voxel_center' (paper §3.1 ambiguity)
    # threshold sampling instead of an exact Gumbel top-k for the random
    # center selection (ops/sampling.py) — the whole-scene setting
    approx_select: bool = False
    # node selection over the packed keys through an approximate top-k in
    # the JAX package; the port selects the exact top-k of the same keys
    approx_topk: bool = False
    # combined [key|x|y|z] selection-table gathers (ops/gather.py
    # `_gather_sel`): the same values as the packed path
    coord_match: bool = False
    coord_payload: bool = False

    # --- GCA (aggregation) side ---
    mlp: Tuple[int, ...] = (64, 64)   # edge-MLP channel stack (last = output width)
    use_coverage: bool = True          # coverage-weighted attention (F-07)
    use_context_pool: bool = True      # grid-context pooling (F-07)
    context_channels: int = 32         # width of the pooled context summary
    # 'nodes' pools the K selected nodes (cheap, default); 'candidates'
    # pools ALL stored context points like the paper's Fig. 3 (gathers
    # [M, context³·nv] candidate features — use on small models)
    context_pool_source: str = "nodes"
    att_hidden: int = 16               # hidden width of the attention MLP
    att_activation: str = "softmax"    # 'softmax' | 'sigmoid' over K
    pool: str = "max"                  # 'max' | 'maxsum'


@dataclass(frozen=True)
class UpLayerSpec:
    """One decoder (feature-propagation) stage: gridify_up + 3-NN interp (F-05)."""

    resolution: int = 32           # grid used to index the *coarse* level
    nv: int = 16                   # capacity of the coarse-level voxel table
    k_interp: int = 3              # nearest neighbors for inverse-distance interp
    context: int = 3               # context neighborhood for the inverse query
    mlp: Tuple[int, ...] = (128, 128)  # post-concat shared MLP
    # 'dense' = exact brute-force k-NN (streamed blocks); 'pallas' = the
    # fused flash-kNN kernel (in the port: the hand-written CUDA kernel of
    # kernels/knn.py); 'grid' = voxel-table context query (the reference's
    # gridify_up; scales to huge supports); 'auto' picks dense vs grid by
    # support size.
    method: str = "auto"
    # dense path only: single-matmul + approx_min_k (~0.95 recall/neighbor)
    # instead of the exact streamed scan — the big-scene inference setting.
    approx_knn: bool = False

    def __post_init__(self):
        if self.method not in ("auto", "dense", "grid", "pallas"):
            raise ValueError(
                f"UpLayerSpec.method must be one of auto/dense/grid/pallas, "
                f"got {self.method!r}")


@dataclass(frozen=True)
class ModelConfig:
    task: str = "cls"                    # 'cls' | 'seg'
    num_classes: int = 40
    in_channels: int = 0                 # extra per-point features beyond xyz
    layers: Tuple[GridLayerSpec, ...] = ()
    up_layers: Tuple[UpLayerSpec, ...] = ()   # seg only; paired with layers reversed
    head: Tuple[int, ...] = (512, 256)   # FC head widths (cls) / point head (seg)
    dropout: float = 0.5
    bn_momentum: float = 0.9
    dtype: str = "float32"               # compute dtype for the dense GCA math
    # selective mixed precision (VERDICT r3 #1): compute dtype of the GCA
    # attention path — geometry encoding, coverage normalization, context
    # summary, attention MLP + softmax ("" = follow `dtype`). Lets bf16
    # training keep its precision-sensitive island in f32 while the
    # matmul-heavy edge/up/head MLPs (the FLOP carriers, SURVEY §3.3) run
    # bf16. BN batch statistics are f32 regardless (flax computes them in
    # f32 and stores batch_stats in f32).
    att_dtype: str = ""
    # compute dtype of the decoder's 3-NN inverse-distance weighted sum
    # ("" = follow `dtype`); f32 here keeps the interpolation accumulation
    # exact while features still flow bf16 into the up-MLPs.
    interp_dtype: str = ""
    # compute dtype of every BatchNorm ("" = follow `dtype`). f32 with
    # dtype=bfloat16 gives "bf16 matmuls only": Dense runs bf16, BN
    # normalization/affine and the relu after it run f32 (batch statistics
    # are f32 either way — flax computes and stores them in f32).
    bn_dtype: str = ""
    # inference-only compute dtype ("" = same as dtype). Consumed by
    # models.fold.fold_inference, i.e. every inference surface that folds
    # (serving Predictor, AOT export, bench): presets that TRAIN in f32 can
    # still serve in bf16 (fidelity bound: tests/test_models.py
    # test_bfloat16_* — argmax agreement >= 0.98, logit atol 10% of range).
    eval_dtype: str = ""
    use_xyz_feature: bool = True         # feed raw xyz as an input feature
    remat: bool = False                  # recompute each GridConv stage in backward
    # seg only: label value excluded from the loss, class weights, and every
    # metric (the reference ScanNet protocol scores annotated points only —
    # label 0 = unannotated; None disables)
    ignore_label: Any = None
    # inference-only: BatchNorms are folded into the preceding Dense weights
    # (models.fold.fold_inference) and skipped in the graph. Never set for
    # training.
    fold_bn: bool = False


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"     # 'modelnet40' | 's3dis' | 'scannet' | 'synthetic'
    root: str = "data"
    num_points: int = 1024
    batch_size: int = 16
    eval_batch_size: int = 16
    # augmentation (F-14) — applied on device inside jit
    augment: bool = True
    rotate: bool = True            # random rotation about the up axis
    jitter_sigma: float = 0.01
    jitter_clip: float = 0.05
    scale_low: float = 0.8
    scale_high: float = 1.25
    shift_range: float = 0.1
    dropout_max: float = 0.0       # random point dropout ratio upper bound
    shuffle_points: bool = True    # randomizes voxel-slot retention (F-01 semantics)
    num_feats: int = 0             # extra feature channels provided by the dataset
    # s3dis hdf5 layout: held-out area ("Area_5" = the reference protocol;
    # set "Area_k" per fold for the paper's 6-fold cross-validation)
    s3dis_holdout: str = "Area_5"
    # feature columns that are xyz-like (e.g. s3dis normalized room xyz,
    # feat cols 3:6) and must be rotated WITH the cloud during rotation
    # voting / rotation augmentation — else each vote sees inconsistent
    # inputs (rotated positions, stale xyz-derived features)
    feat_geo_channels: Tuple[int, ...] = ()
    # synthetic datasets only: training-split example count (0 = the
    # generator's default; eval split scales to 1/4). Lets preset-scale
    # convergence gates (VERDICT r2 #3) and the capacity sweep train on
    # more than the hermetic-test default without touching code.
    synthetic_size: int = 0


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    epochs: int = 250
    steps_per_epoch: int = 0       # 0 => derive from dataset size
    lr: float = 1e-3
    lr_schedule: str = "cosine"    # 'cosine' | 'step' | 'const'
    lr_decay_rate: float = 0.7
    lr_decay_steps: int = 20_000
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    label_smoothing: float = 0.0
    class_weighting: bool = False  # seg: weight CE by inverse class frequency
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 1            # epochs between checkpoints (0: final only)
    keep_ckpts: int = 3
    eval_every: int = 1            # epochs between evals (0: disabled)
    log_every: int = 50            # steps between metric lines (0: disabled)
    # mixed precision lives on ModelConfig.dtype ('bfloat16' runs the dense
    # GCA/decoder math in bf16 with f32 params/optimizer — flax Dense
    # semantics); override from the CLI with model.dtype=bfloat16


@dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# (De)serialization + CLI overrides
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def to_json(cfg: Config) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)


def _build(cls, data: Any) -> Any:
    if not dataclasses.is_dataclass(cls) or not isinstance(data, dict):
        return data
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if f.name == "layers":
            kwargs[f.name] = tuple(_build(GridLayerSpec, x) for x in v)
        elif f.name == "up_layers":
            kwargs[f.name] = tuple(_build(UpLayerSpec, x) for x in v)
        elif dataclasses.is_dataclass(f.type) or f.name in ("model", "data", "train"):
            sub = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig}[f.name]
            kwargs[f.name] = _build(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def from_dict(data: dict) -> Config:
    return _build(Config, data)


def from_json(s: str) -> Config:
    return from_dict(json.loads(s))


def apply_overrides(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {'train.lr': 3e-4, 'data.batch_size': 32}."""
    d = to_dict(cfg)
    for path, value in overrides.items():
        node = d
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[k]
        leaf = keys[-1]
        if leaf not in node:
            raise KeyError(f"unknown config key: {path}")
        old = node[leaf]
        if isinstance(old, bool):
            value = value if isinstance(value, bool) else str(value).lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            value = int(value)
        elif isinstance(old, float):
            value = float(value)
        elif isinstance(old, (list, tuple)):
            if isinstance(value, str):
                value = [type(old[0])(x) for x in value.split(",")] if old else value.split(",")
        node[leaf] = value
    return from_dict(d)


def parse_cli_overrides(args: list[str]) -> dict[str, Any]:
    """Parse ['train.lr=3e-4', ...] into an override dict."""
    out: dict[str, Any] = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got: {a}")
        k, v = a.split("=", 1)
        out[k] = v
    return out
