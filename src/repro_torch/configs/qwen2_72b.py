"""qwen2-72b: dense GQA with QKV bias. [arXiv:2407.10671; hf]

80L d_model=8192 64H (GQA kv=8, 8 query heads a kv head; head_dim 128)
d_ff=29568 vocab=152064.  72.7B parameters, 145 GB in bf16: one card
serves it cut in depth (32 layers, 61.2 GB).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1e6,
    source="[arXiv:2407.10671; hf]",
)
