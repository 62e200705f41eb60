"""qwen2-moe-a2.7b: Qwen1.5-MoE-A2.7B. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L d_model=2048 16H (kv=16) d_expert=1408 vocab=151936, MoE 60e top-4,
plus 4 shared experts (fused into one d_shared=4*1408 SwiGLU that bypasses
EP).  60 routed experts are padded to 64 (the router masks the pads).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen2_moe_a2_7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4,
                  d_expert=1408, d_shared=4 * 1408, moe_every=1),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
