"""moonshot-v1-16b-a3b: kimi/moonlight MoE. [hf:moonshotai/Moonlight-16B-A3B; hf]

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
Primary paper-representative config: EP dispatch/combine on every layer.
The port holds itself to the reference's 48-layer variant, without shared
experts (the published Moonlight has fewer layers and shared experts).
The published model is the port's own ``moonlight_16b_a3b``
(``configs/moonlight_16b_a3b.py``: MLA, a dense first layer, 2 shared
experts, sigmoid routing).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot_v1_16b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,  # all-MoE FFN
    vocab_size=163_840,
    rope_theta=5e4,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, moe_every=1),
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)
