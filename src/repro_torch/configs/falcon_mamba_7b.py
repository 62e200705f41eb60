"""falcon-mamba-7b: attention-free Mamba-1. [arXiv:2410.05355; unverified]

64L d_model=4096 (d_inner 8192, dt_rank 256), ssm_state=16, d_conv=4,
vocab=65024 (a multiple of 256, so the head needs no padding).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
    source="[arXiv:2410.05355; unverified]",
)
