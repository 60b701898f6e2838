from repro_torch.configs.base import (
    SHAPE_BY_NAME,
    SHAPES,
    MeshConfig,
    ModelConfig,
    RunConfig,
    SedarConfig,
    ServeConfig,
    ShapeSpec,
    TrainConfig,
    reduce_for_smoke,
    shape_applicable,
)
from repro_torch.configs.registry import get_config, list_archs

__all__ = [
    "SHAPES",
    "SHAPE_BY_NAME",
    "ShapeSpec",
    "shape_applicable",
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
