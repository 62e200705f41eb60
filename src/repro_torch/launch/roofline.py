"""Roofline terms on the card's constants: the port of
``repro.launch.roofline``'s ``model_flops``, ``decode_ideal_bytes`` and
``roofline_terms`` (``repro/launch/roofline.py:67-142``) over the port's
``ShapeCell`` and ``SHAPES``, with the H100 figures of
:mod:`repro_torch.launch.mesh` in place of the TPU v5e ones:

  t_compute    = flops_per_device / PEAK_FLOPS_BF16
  t_memory     = bytes_per_device / HBM_BW
  t_collective = collective_bytes_per_device / NVLINK_BW

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) gives the useful-compute
ratio.  The reference takes ``rec["cost"]`` from the cost analysis of a
compiled XLA module; the port's caller passes measured or counted figures
under the same keys (``chips``, ``cost.flops``, ``cost.bytes_accessed``,
optionally ``cost.bytes_accessed_kernel_adj``, and
``collectives.total_bytes``).

``collective_bytes_from_hlo`` (``roofline.py:51``) parses XLA's
SPMD-partitioned HLO text, which torch does not produce; it has no
counterpart here.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed."""
    n = cfg.active_param_count() if cfg.moe.enabled else cfg.param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens          # fwd only
    return 2.0 * n * cell.global_batch   # one token per sequence


def decode_ideal_bytes(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Minimum memory traffic for one decode step (global): read the active
    params once (bf16) and the live KV/SSM cache once.  Decode is
    memory-bound by construction, so its roofline fraction is measured
    against this."""
    n = cfg.active_param_count() if cfg.moe.enabled else cfg.param_count()
    params = n * 2                                     # bf16
    B, S = cell.global_batch, cell.seq_len
    cache = 0.0
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            cache += 2 * B * S * cfg.n_kv_heads * cfg.head_dim_ * 2
        elif cfg.mamba.enabled:
            di = cfg.mamba.expand * cfg.d_model
            cache += B * di * cfg.mamba.d_state * 4 + \
                B * (cfg.mamba.d_conv - 1) * di * 2
    return params + cache


_DOMINANT = {"t_compute_s": "compute", "t_memory_s": "memory",
             "t_collective_s": "collective"}


def roofline_terms(cfg: ModelConfig, cell: ShapeCell, rec: dict) -> dict:
    """The three terms, the dominant one, the useful-flops ratio and the
    roofline fraction of one record (per-device figures, ``chips``
    devices), as the reference computes them."""
    chips = rec["chips"]
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    coll_dev = rec["collectives"]["total_bytes"]
    t_comp = flops_dev / PEAK_FLOPS_BF16
    t_mem = bytes_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    terms = {"t_compute_s": t_comp, "t_memory_s": t_mem,
             "t_collective_s": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)
    total = flops_dev * chips
    bound = max(t_comp, t_mem, t_coll)
    # roofline fraction: useful model flops at peak vs. the step's bound time
    t_ideal = mf / (chips * PEAK_FLOPS_BF16)
    if cell.is_decode:
        # decode is memory-bound by construction: the ideal step time is
        # one pass over active params + live cache, not a FLOP bound
        t_ideal = max(t_ideal,
                      decode_ideal_bytes(cfg, cell) / (chips * HBM_BW))
    out = {
        **terms,
        "dominant": _DOMINANT[dom],
        "model_flops": mf,
        "hlo_flops_total": total,
        "useful_flops_ratio": mf / total if total else 0.0,
        "t_ideal_s": t_ideal,
        "roofline_fraction": t_ideal / bound if bound else 0.0,
    }
    # kernel-adjusted view: the memory term without the traffic a fused
    # attention kernel keeps on chip, where the caller counts it apart
    adj = rec["cost"].get("bytes_accessed_kernel_adj")
    if adj is not None:
        t_mem_k = adj / HBM_BW
        bound_k = max(t_comp, t_mem_k, t_coll)
        terms_k = {"t_compute_s": t_comp, "t_memory_s": t_mem_k,
                   "t_collective_s": t_coll}
        out["t_memory_kernel_s"] = t_mem_k
        out["dominant_kernel"] = _DOMINANT[max(terms_k, key=terms_k.get)]
        out["roofline_fraction_kernel"] = t_ideal / bound_k if bound_k else 0.0
    return out
