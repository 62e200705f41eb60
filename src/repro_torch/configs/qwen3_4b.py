"""qwen3-4b: dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936. head_dim=128
(qwen3 uses a fixed 128 head_dim decoupled from d_model).  The values are
the reference package's, kept as they are: its source names Qwen3-8B, it
leaves ``tie_embeddings`` unset and ``norm_eps`` at 1e-5.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
