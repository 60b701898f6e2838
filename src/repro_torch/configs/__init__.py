from repro_torch.configs.base import (
    MeshConfig,
    ModelConfig,
    RunConfig,
    SedarConfig,
    ServeConfig,
    TrainConfig,
    reduce_for_smoke,
)
from repro_torch.configs.registry import get_config, list_archs

__all__ = [
    "MeshConfig",
    "ModelConfig",
    "RunConfig",
    "SedarConfig",
    "ServeConfig",
    "TrainConfig",
    "reduce_for_smoke",
    "get_config",
    "list_archs",
]
