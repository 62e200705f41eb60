"""phi3-medium-14b: dense RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]

40L d_model=5120 40H (GQA kv=10, 4 query heads a kv head; head_dim 128)
d_ff=17920 vocab=100352.  The values and the "unverified" source tag are
the reference package's, kept as they are.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3_medium_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17_920,
    vocab_size=100_352,
    rope_theta=1e4,
    source="[arXiv:2404.14219; unverified]",
)
