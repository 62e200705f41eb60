"""moonlight-16b-a3b: Moonlight-16B-A3B as published (``model_type``
``deepseek_v3``), https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json

27 layers, d_model 2048, 16 heads of multi-head latent attention (q
projected directly, ``q_lora_rank`` null; a 512-wide normalised latent
and a 64-wide RoPE key shared by the heads; q/k 128 + 64 wide, v 128), a
dense first layer (``first_k_dense_replace`` 1, an 11,264-wide SwiGLU),
then 26 MoE layers of 64 routed experts, top-6, 1,408 wide, beside 2
shared experts (one 2,816-wide SwiGLU); sigmoid scoring with the
selection bias on the scores (``noaux_tc``, one group), the chosen scores
renormalised (``norm_topk_prob``) and scaled by 2.446; RoPE theta 50,000,
RMSNorm eps 1e-5, vocab 163,840, untied head.  15.96B parameters.

A configuration of the port alone (``PORT_ARCH_IDS``): the JAX package
has no MLA; its ``moonshot_v1_16b_a3b`` is a 48-layer MHA variant.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonlight_16b_a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11_264,                 # the dense first layer
    vocab_size=163_840,
    rope_theta=5e4,
    norm_eps=1e-5,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
                  d_shared=2816, moe_every=1, scoring="sigmoid",
                  routed_scale=2.446),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    source="https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/"
           "config.json",
)
