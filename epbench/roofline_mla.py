"""The yardstick's arithmetic for the MLA cells, frozen here beside
``roofline.py`` (whose peaks it takes) so that a change to the program
cannot move it: the parameters (all, and active a token without the
input embedding), a decode step's model FLOPs with the absorbed
attention's, the bytes one decode step must move, and the least time of
an absorbed-MLA decode kernel's call.

A latent cache row is kv_lora_rank + rope values (1,152 bytes in bf16 at
Moonlight's 512 + 64); the absorbed attention costs 2 H (pos + 1)
(kv_lora_rank + rope + kv_lora_rank) FLOP a layer and sequence: scores
over the whole row, the output over the latent.
"""
from __future__ import annotations

from epbench.roofline import BF16_FLOP_PER_S, HBM_BYTES_PER_S


def _attn_params(cfg) -> int:
    d, h = cfg.d_model, cfg.n_heads
    c, r = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nope, v = cfg.qk_nope_head_dim, cfg.v_head_dim
    return (d * h * (nope + r) + d * (c + r) + c + c * h * (nope + v)
            + h * v * d)


def param_counts(cfg) -> tuple[int, int]:
    """(all, active a token) parameters: the head, per layer the MLA
    projections and the latent norm, the dense SwiGLU of a leading layer or
    the routed experts (all, or top-k), the shared experts and the router
    of an MoE layer, two norms; ``all`` also counts the input embedding,
    which ``active`` leaves out."""
    d = cfg.d_model
    active = cfg.vocab_size * d
    total = active * (1 if cfg.tie_embeddings else 2)
    for i in range(cfg.n_layers):
        rest = _attn_params(cfg) + 2 * d
        if i < cfg.first_k_dense:
            total += rest + 3 * d * cfg.d_ff
            active += rest + 3 * d * cfg.d_ff
            continue
        rest += 3 * d * cfg.moe.d_shared + d * cfg.moe.n_experts
        per = 3 * d * cfg.moe.d_expert
        total += rest + cfg.moe.n_experts * per
        active += rest + cfg.moe.top_k * per
    return total, active


def cache_row_bytes(cfg, weight_bytes: int = 2) -> int:
    """Bytes of one latent row of one layer."""
    return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * weight_bytes


def attention_flops(cfg, pos: float) -> float:
    """The absorbed attention's FLOPs a sequence and layer at ``pos``."""
    c, r = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return 2.0 * cfg.n_heads * (pos + 1) * (2 * c + r)


def decode_step_flops(cfg, batch: int, pos: float) -> float:
    """One decode step of ``batch`` sequences at ``pos``: 2 N_active a
    token and the absorbed attention of every layer."""
    _, n = param_counts(cfg)
    return batch * (2.0 * n + cfg.n_layers * attention_flops(cfg, pos))


def decode_step_bytes(cfg, batch: int, pos: float, experts_read: float,
                      weight_bytes: int = 2) -> float:
    """Bytes one decode step at ``pos`` must read and write: every weight
    once (the MLA projections, the latent norm and the router in fp32, the
    dense layer's SwiGLU, ``experts_read`` routed experts an MoE layer, the
    shared experts, the head, the batch's embedding rows, the norm
    scales), the pos + 1 live latent rows of every layer, the step's new
    row, and the fp32 logits written."""
    d = cfg.d_model
    vp = -(-cfg.vocab_size // 256) * 256
    c = cfg.kv_lora_rank
    total = 0.0
    for i in range(cfg.n_layers):
        layer = (_attn_params(cfg) - c) * weight_bytes + c * 4 + 2 * d * 4
        if i < cfg.first_k_dense:
            layer += 3 * d * cfg.d_ff * weight_bytes
        else:
            layer += (3 * d * cfg.moe.d_shared
                      + experts_read * 3 * d * cfg.moe.d_expert) * weight_bytes
            layer += d * cfg.moe.n_experts * 4
        layer += batch * (pos + 2) * cache_row_bytes(cfg, weight_bytes)
        total += layer
    head = d * vp * weight_bytes + batch * d * weight_bytes + d * 4
    return total + head + batch * vp * 4


def mla_kernel_bound(B: int, H: int, pos: int, dk: int, dv: int,
                     elem_bytes: int = 2) -> float:
    """Least seconds of one absorbed-MLA decode call: the larger of its
    bytes (the pos + 1 live rows of dk values, q read, the output written)
    over 3.35 TB/s and its FLOPs (2 B H (pos + 1) (dk + dv)) over the bf16
    peak."""
    live = pos + 1
    nbytes = (B * live * dk + B * H * dk + B * H * dv) * elem_bytes
    flops = 2.0 * B * H * live * (dk + dv)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
