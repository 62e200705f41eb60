from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ShapeCell,
    all_configs,
    cells_for,
    get_config,
    reduced_config,
)

__all__ = ["ARCH_IDS", "SHAPES", "MambaConfig", "ModelConfig", "MoEConfig",
           "ShapeCell", "all_configs", "cells_for", "get_config",
           "reduced_config"]
