from repro_torch.configs.base import (
    ARCH_IDS,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    get_config,
    reduced_config,
)

__all__ = ["ARCH_IDS", "MambaConfig", "ModelConfig", "MoEConfig",
           "get_config", "reduced_config"]
