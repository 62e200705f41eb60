"""Model configs for the port: the subset of ``repro.configs.base`` the
serving and training slices need, kept as a copy so the port never imports
``repro``."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one model."""

    n_experts: int = 0                 # routed experts
    top_k: int = 0
    d_expert: int = 0                  # per-expert FFN hidden dim
    d_shared: int = 0                  # fused always-on shared-expert hidden dim
    moe_every: int = 1                 # MoE layer every Nth layer (1 = all)
    capacity_factor: float = 2.0       # train/prefill capacity factor
    ll_capacity_factor: float = 4.0    # decode (LL) capacity factor
    router_aux_free_bias: bool = True  # DeepSeek aux-loss-free balancing bias
    aux_loss_weight: float = 1e-2      # Switch-style load-balance loss weight
    # EP transport backend (repro_torch.core.backend registry)
    ep_backend: str = "torch_collectives"
    # dispatch payload wire dtype: "fp32" | "fp8" | "int8" (block-quantized
    # with inline per-128-feature scales; combines stay fp32)
    wire_dtype: str = "fp32"

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 SSM settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field names follow ``repro.configs.base``."""

    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 0                     # dense FFN hidden (0 for pure-MoE)
    vocab_size: int = 32000
    qk_norm: bool = False             # RMSNorm of q and k per head
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False      # the head is embed.T
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=lambda: MambaConfig(d_state=0))
    # hybrid (jamba): one attention layer per `attn_every` layers; rest mamba
    attn_every: int = 0               # 0 = all layers attention (or none if n_heads==0)
    attn_offset: int = 0              # index within the period that is attention
    source: str = ""
    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"      # the only one the port trains in
    optimizer: str = "adamw"          # adamw | adafactor (factored 2nd moment)
    remat: bool = True                # recompute each layer in the backward

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return _round_up(self.vocab_size, multiple)

    def is_attn_layer(self, layer_idx: int) -> bool:
        if self.attention_free:
            return False
        if self.attn_every <= 1:
            return True
        return layer_idx % self.attn_every == self.attn_offset

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe.enabled:
            return False
        return layer_idx % self.moe.moe_every == (self.moe.moe_every - 1)


ARCH_IDS = ("qwen2_moe_a2_7b", "falcon_mamba_7b", "jamba_1_5_large_398b",
            "qwen3_4b", "qwen3_1_7b")
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"ported: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
                   n_experts: int = 8, vocab: int = 512) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (same rule as the JAX
    package's ``reduced_config``: no heads when attention-free, a hybrid
    interleave period of at most 2 so two layers cover both kinds)."""
    heads = 0 if cfg.attention_free else 4
    kv = 0 if cfg.attention_free else (2 if cfg.n_kv_heads < cfg.n_heads else 4)
    moe = cfg.moe
    if moe.enabled:
        moe = dataclasses.replace(
            moe, n_experts=n_experts, top_k=min(moe.top_k, 2),
            d_expert=d_model, d_shared=d_model if moe.d_shared else 0)
    attn_every = min(cfg.attn_every, 2) if cfg.attn_every else 0
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        head_dim=d_model // heads if heads else 0,
        d_ff=d_model * 2 if cfg.d_ff else 0, vocab_size=vocab, moe=moe,
        attn_every=attn_every, attn_offset=0)
