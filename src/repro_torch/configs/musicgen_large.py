"""musicgen-large: decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

48L d_model=2048 32H (kv=32, i.e. MHA; head_dim 64) d_ff=8192 vocab=2048.
Audio: the EnCodec frontend is a stub, as in the reference: a training
batch carries 64 precomputed frame embeddings a sample
(``frontend_prefix``, the conditioning prefix); the decoder runs on
codec-token ids, and serving on those alone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen_large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=1e4,
    frontend_prefix=64,
    source="[arXiv:2306.05284; hf]",
)
