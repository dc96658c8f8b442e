from repro_torch.configs.base import (
    ALL_SHAPES,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    TrainConfig,
    shape_applicable,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    get_config,
    get_shape,
    get_smoke_config,
    iter_cells,
)

__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "TrainConfig",
    "get_config",
    "get_shape",
    "get_smoke_config",
    "iter_cells",
    "shape_applicable",
]
