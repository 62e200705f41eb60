"""internvl2-26b: InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

48L d_model=6144 48H (GQA kv=8, 6 query heads a kv head; head_dim 128)
d_ff=16384 vocab=92553 (padded to 92672).  VLM: the InternViT frontend is
a stub, as in the reference: a training batch carries 256 precomputed
patch embeddings a sample at d_model (``frontend_prefix``), prepended to
the text tokens; serving runs on text tokens alone, as the reference's
serve launcher does.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2_26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    rope_theta=1e6,
    frontend_prefix=256,
    source="[arXiv:2404.16821; hf]",
)
