"""qwen3-1.7b: dense, qk_norm, GQA, tied embeddings. [hf:Qwen/Qwen3-8B; hf]

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_1_7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
