from repro_torch.configs.base import (
    ModelConfig,
    RunConfig,
    SedarConfig,
    ServeConfig,
    TrainConfig,
    reduce_for_smoke,
)
from repro_torch.configs.registry import get_config, list_archs

__all__ = [
    "ModelConfig",
    "RunConfig",
    "SedarConfig",
    "ServeConfig",
    "TrainConfig",
    "reduce_for_smoke",
    "get_config",
    "list_archs",
]
