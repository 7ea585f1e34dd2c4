from gridgcn_torch.configs.base import (
    Config,
    DataConfig,
    GridLayerSpec,
    ModelConfig,
    TrainConfig,
    UpLayerSpec,
)
from gridgcn_torch.configs import presets

__all__ = [
    "GridLayerSpec",
    "UpLayerSpec",
    "ModelConfig",
    "DataConfig",
    "TrainConfig",
    "Config",
    "presets",
]
