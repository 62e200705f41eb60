"""Model configs for the port: a copy of ``repro.configs.base`` (the
configs, the shape cells, the parameter counts), kept so the port never
imports ``repro``.  Only the EP backend's default name differs
(``torch_collectives`` for the reference's ``jax_collectives``)."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Sequence


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one model."""

    n_experts: int = 0                 # routed experts
    top_k: int = 0
    n_shared_experts: int = 0          # always-on shared experts (qwen2-moe)
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
    # the port's own (the JAX package has neither): "softmax" over the
    # logits, or "sigmoid" (DeepSeek-V3: the selection bias added to the
    # scores, the chosen scores renormalised), whose combine weights are
    # then multiplied by ``routed_scale``
    scoring: str = "softmax"
    routed_scale: float = 1.0

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
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
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
    # modality frontend stub: prefix embedding positions a training batch
    # carries ("vlm": patch embeddings, "audio": frame embeddings)
    frontend_prefix: int = 0
    source: str = ""
    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"      # the only one the port trains in
    optimizer: str = "adamw"          # adamw | adafactor (factored 2nd moment)
    remat: bool = True                # recompute each layer in the backward
    # sub-quadratic attention available? (pure full-attention archs: False)
    subquadratic: bool = False
    # the port's own (the JAX package has no MLA): multi-head latent
    # attention when ``kv_lora_rank`` > 0 (DeepSeek-V2/V3, ``models/mla.py``:
    # q projected directly, a ``kv_lora_rank``-wide normalised latent and a
    # ``qk_rope_head_dim``-wide RoPE key shared by the heads), and the
    # leading layers whose FFN is the dense ``d_ff`` SwiGLU
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense: int = 0

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return _round_up(self.vocab_size, multiple)

    def padded_experts(self, ep_degree: int) -> int:
        """Routed experts padded up so EP sharding divides evenly."""
        if not self.moe.enabled:
            return 0
        return _round_up(self.moe.n_experts, ep_degree)

    def is_attn_layer(self, layer_idx: int) -> bool:
        if self.attention_free:
            return False
        if self.attn_every <= 1:
            return True
        return layer_idx % self.attn_every == self.attn_offset

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe.enabled or layer_idx < self.first_k_dense:
            return False
        return layer_idx % self.moe.moe_every == (self.moe.moe_every - 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), as the
        reference counts it."""
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            n += self._block_params(i)
        return n

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE: top_k + shared experts only)."""
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            n += self._block_params(i, active_only=True)
        return n

    def _block_params(self, i: int, active_only: bool = False) -> int:
        d = self.d_model
        n = 0
        if self.is_attn_layer(i) and self.mla:
            h, r = self.n_heads, self.qk_rope_head_dim
            c, nope, v = self.kv_lora_rank, self.qk_nope_head_dim, self.v_head_dim
            n += d * h * (nope + r) + d * (c + r) + c   # wq, w_dkv, kv_norm
            n += c * h * (nope + v) + h * v * d          # w_ukv, wo
        elif self.is_attn_layer(i):
            hd = self.head_dim_
            n += 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            if self.qkv_bias:
                n += (self.n_heads + 2 * self.n_kv_heads) * hd
        elif self.mamba.enabled:
            di = self.mamba.expand * d
            dtr = self.mamba.dt_rank or -(-d // 16)
            n += d * di * 2                              # in_proj (x and z)
            n += di * self.mamba.d_conv                  # depthwise conv
            n += di * (dtr + 2 * self.mamba.d_state)     # x_proj
            n += dtr * di + di                           # dt_proj
            n += di * self.mamba.d_state + di            # A_log, D
            n += di * d                                  # out_proj
        if self.is_moe_layer(i):
            e = self.moe.top_k if active_only else self.moe.n_experts
            n += e * 3 * d * self.moe.d_expert
            if self.moe.d_shared:
                n += 3 * d * self.moe.d_shared
            n += d * self.moe.n_experts                  # router
        elif self.d_ff:
            n += 3 * d * self.d_ff                       # SwiGLU
        n += 2 * d                                       # 2 RMSNorms
        return n


@dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell of the reference's assignment."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# the JAX package's configurations, which the port holds to its own
ARCH_IDS: Sequence[str] = (
    "moonshot_v1_16b_a3b",
    "qwen2_moe_a2_7b",
    "qwen3_1_7b",
    "phi3_medium_14b",
    "qwen2_72b",
    "qwen3_4b",
    "internvl2_26b",
    "musicgen_large",
    "falcon_mamba_7b",
    "jamba_1_5_large_398b",
)
# the port's own configurations, which the JAX package cannot run (MLA,
# sigmoid routing); ``get_config`` finds them, ``all_configs`` keeps to
# ``ARCH_IDS``
PORT_ARCH_IDS: Sequence[str] = (
    "moonlight_16b_a3b",
)
_ALIASES = {a.replace("_", "-"): a for a in (*ARCH_IDS, *PORT_ARCH_IDS)}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS and arch not in PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{[*ARCH_IDS, *PORT_ARCH_IDS]}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
                   n_experts: int = 8, vocab: int = 512) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (same rule as the JAX
    package's ``reduced_config``: no heads when attention-free, a hybrid
    interleave period of at most 2 so two layers cover both kinds, a
    frontend prefix of at most 4).  An MLA config keeps its kind at latent
    32, RoPE 8, nope 16 and value 16 wide, and one leading dense layer
    before ``n_layers`` MoE layers."""
    heads = 0 if cfg.attention_free else 4
    kv = 0 if cfg.attention_free else (2 if cfg.n_kv_heads < cfg.n_heads else 4)
    moe = cfg.moe
    if moe.enabled:
        moe = dataclasses.replace(
            moe, n_experts=n_experts, top_k=min(moe.top_k, 2),
            d_expert=d_model, d_shared=d_model if moe.d_shared else 0)
    attn_every = min(cfg.attn_every, 2) if cfg.attn_every else 0
    if cfg.mla:
        dense = min(cfg.first_k_dense, 1)
        cfg = dataclasses.replace(cfg, kv_lora_rank=32, qk_rope_head_dim=8,
                                  qk_nope_head_dim=16, v_head_dim=16,
                                  first_k_dense=dense)
        n_layers += dense
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        head_dim=d_model // heads if heads else 0,
        d_ff=d_model * 2 if cfg.d_ff else 0, vocab_size=vocab, moe=moe,
        attn_every=attn_every, attn_offset=0,
        frontend_prefix=min(cfg.frontend_prefix, 4))


def cells_for(cfg: ModelConfig) -> list[str]:
    """Shape cells this arch runs (long_500k only for sub-quadratic archs)."""
    return [name for name in SHAPES
            if name != "long_500k" or cfg.subquadratic]
