"""jamba-1.5-large-398b: Mamba+attention 1:7 interleave, MoE. [arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 every
2nd layer; one attention layer per 8 (offset 4), rest Mamba; factored
second-moment optimizer.  The port runs it only reduced (``reduced_config``):
at full width it does not fit one card -- one MoE layer alone holds
16 x 3 x 8192 x 24576 = 9.66B expert parameters, 155 GB of fp32 AdamW state.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="jamba_1_5_large_398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24_576, moe_every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    attn_offset=4,
    optimizer="adafactor",
    source="[arXiv:2403.19887; hf]",
)
