"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the H100's peaks, the least time of each EP kernel's call
(its bytes over the memory rate or its operations over the peak, the
larger), the model FLOPs (6 N_active T for training, 2 N_active T
forward) and the bytes one decode step must read.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 67 TFLOP/s
fp32 outside the tensor cores, 3.35 TB/s HBM3.  The kernels' bounds copy
the rules the port's own checks used (each input read once, each output
written once, only the rows a call's counts occupy, each occupied
expert's weights read once; the backward: 16 D F flops an occupied row).
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
WIRE_BLOCK = 128

# the EP kernels by the port's wrapper names, and the device kernels each
# launches, by a fragment of their names (the backward's passes live in
# the ``swiglu_bwd`` namespace and name ``swiglu_tiles::Args`` in their
# signature, so they are matched first)
EP_KERNELS = ("grouped_swiglu", "gather_swiglu_scatter",
              "gather_swiglu_scatter_bwd", "grouped_swiglu_bwd",
              "gather_quantize", "dequantize")
DEVICE_KINDS = (("ep_backward", ("swiglu_bwd::",)),
                ("ep_forward", ("swiglu_tiles::tile_kernel",)),
                ("wire", ("gather_quantize_kernel", "dequantize_kernel")))


def device_kind(name: str) -> str | None:
    for kind, frags in DEVICE_KINDS:
        if any(f in name for f in frags):
            if kind == "wire" and "_bwd" in name:
                return None
            return kind
    return None


def occupied_rows(counts, G: int, C: int) -> tuple[int, int]:
    """(occupied rows, groups with one) of G groups of C rows under flat
    (G,) or bucketed (G, B) counts (None: all)."""
    if counts is None:
        return G * C, G
    cnt = counts.reshape(G, -1)
    cnt = cnt.clamp(max=C // cnt.shape[1])
    return int(cnt.sum()), int((cnt.sum(1) > 0).sum())


def occupied_slots(src, counts) -> torch.Tensor:
    """(n,) bool: the slots below their bucket's count (counts (E,) over
    E buckets of n // E slots; all without counts)."""
    n = src.shape[0]
    if counts is None:
        return torch.ones(n, dtype=torch.bool, device=src.device)
    E = counts.numel()
    ar = torch.arange(n // E, device=src.device)
    return (ar[None, :] < counts.reshape(E, 1).clamp(max=n // E)).reshape(-1)


def named_table_rows(x_ext, src, counts) -> tuple[int, int]:
    """(occupied slots, distinct table rows they name)."""
    occ = occupied_slots(src, counts)
    return int(occ.sum()), int(torch.unique(
        src[occ].clamp(0, x_ext.shape[0] - 1)).numel())


def kernel_bound(name: str, args: tuple) -> tuple[float, dict]:
    """Least seconds one call of EP kernel ``name`` with the positional
    ``args`` of its wrapper can take, and the work counted."""
    if name in ("grouped_swiglu", "gather_swiglu_scatter"):
        if name == "grouped_swiglu":
            x, wg, wu, wd, counts = args[:5]
            G, C, D = x.shape
            out_bytes = x.numel() * 2
        else:
            x_ext, src, w_slot, wg, wu, wd, counts = args[:7]
            D = x_ext.shape[1]
            G = wg.shape[0]
            C = src.shape[0] // G
            out_bytes = (x_ext.shape[0] - 1) * D * 4
        F = wg.shape[2]
        rows, experts = occupied_rows(counts, G, C)
        nbytes = rows * D * 2 + experts * 3 * D * F * 2 + out_bytes + rows * 8
        flops = 6.0 * D * F * rows
        t_ops = flops / BF16_FLOP_PER_S
        work = {"rows": rows, "experts": experts, "flops": flops}
    elif name in ("grouped_swiglu_bwd", "gather_swiglu_scatter_bwd"):
        if name == "grouped_swiglu_bwd":
            x, wg, wu, wd, counts, dy = args[:6]
            G, C, D = x.shape
            row_bytes = 2 * D + dy.element_size() * D
            dx_bytes = x.numel() * x.element_size()
        else:
            x_ext, src, w_slot, wg, wu, wd, counts, dout = args[:8]
            D = x_ext.shape[1]
            G = wg.shape[0]
            C = src.shape[0] // G
            row_bytes = 2 * D + 4 * D + 8
            dx_bytes = x_ext.numel() * x_ext.element_size() + src.shape[0] * 4
        E, _, F = wg.shape
        rows, experts = occupied_rows(counts, G, C)
        nbytes = (rows * row_bytes + experts * 3 * D * F * 2 + dx_bytes
                  + E * 3 * D * F * 2)
        flops = 16.0 * D * F * rows
        t_ops = flops / BF16_FLOP_PER_S
        work = {"rows": rows, "experts": experts, "flops": flops}
    elif name == "gather_quantize":
        x_ext, src, counts = args[:3]
        D = x_ext.shape[1]
        n = src.shape[0]
        nb = -(-D // WIRE_BLOCK)
        rows, table_rows = named_table_rows(x_ext, src, counts)
        nbytes = (table_rows * D * 4 + rows * 4
                  + (0 if counts is None else counts.numel() * 4)
                  + n * D + n * nb * 4)
        t_ops = 4.0 * rows * D / FP32_FLOP_PER_S
        work = {"slots": n, "rows": rows, "table_rows": table_rows}
    elif name == "dequantize":
        q, scales = args[:2]
        nbytes = q.numel() * 5 + scales.numel() * 4
        t_ops = 1.0 * q.numel() / FP32_FLOP_PER_S
        work = {"elements": q.numel()}
    else:
        raise KeyError(f"no bound for {name!r}")
    work["bytes"] = nbytes
    return max(nbytes / HBM_BYTES_PER_S, t_ops), work


# ------------------------------------------------------------ model work --
def param_counts(cfg) -> tuple[int, int]:
    """(all, active a token) parameters: the head, per layer the attention
    projections and biases, the routed experts (all, or top-k), the
    shared expert, the router, two norms; ``all`` also counts the input
    embedding, which ``active`` leaves out: a token's row lookup is no
    multiply (the port's own count and the reference package's charge
    it as one)."""
    d = cfg.d_model
    active = cfg.vocab_size * d
    total = active * (1 if cfg.tie_embeddings else 2)
    hd = cfg.head_dim_
    for _ in range(cfg.n_layers):
        n = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
        if cfg.qkv_bias:
            n += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        shared = 3 * d * cfg.moe.d_shared if cfg.moe.d_shared else 0
        rest = n + shared + d * cfg.moe.n_experts + 2 * d
        per = 3 * d * cfg.moe.d_expert
        total += rest + cfg.moe.n_experts * per
        active += rest + cfg.moe.top_k * per
    return total, active


def model_flops(cfg, tokens: int, kind: str) -> float:
    """6 N_active T (train) or 2 N_active T (forward)."""
    _, n = param_counts(cfg)
    return (6.0 if kind == "train" else 2.0) * n * tokens


def decode_step_bytes(cfg, batch: int, pos: float, experts_read: float,
                      weight_bytes: int = 2) -> float:
    """Bytes one decode step at position ``pos`` must read and write at
    batch ``batch``: every weight once (the attention
    projections, the router in fp32, ``experts_read`` routed experts a
    layer, the shared expert, the head, the batch's embedding rows, the
    norm scales), the pos + 1 live K and V rows of every layer, the step's
    new K and V rows, and the fp32 logits written."""
    d, hd = cfg.d_model, cfg.head_dim_
    vp = -(-cfg.vocab_size // 256) * 256
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + (cfg.n_heads + 2 * cfg.n_kv_heads) * hd * cfg.qkv_bias
                 + 3 * d * cfg.moe.d_shared
                 + experts_read * 3 * d * cfg.moe.d_expert) * weight_bytes
    per_layer += d * cfg.moe.n_experts * 4 + 2 * d * 4
    kv_row = 2 * cfg.n_kv_heads * hd * weight_bytes
    per_layer += batch * (pos + 2) * kv_row
    head = d * vp * weight_bytes + batch * d * weight_bytes + d * 4
    logits = batch * vp * 4
    return cfg.n_layers * per_layer + head + logits
