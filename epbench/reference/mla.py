"""The plain reference of the benchmark's MLA models (DeepSeek-V3's
layout, as Moonlight-16B-A3B publishes it): fp32 PyTorch, no kernels, no
cache, no absorption, and nothing of the port imported.

Each layer: RMSNorm; multi-head latent attention in the published,
non-absorbed form (q projected directly; the compressed row x @ w_dkv
split into the latent c, normalised by ``kv_norm``, and the RoPE key
k_pe; the heads' keys [c @ W_uk_h, k_pe] and values c @ W_uv_h expanded
from the latent; RoPE on the two halves of q's and k's RoPE parts; causal
softmax attention at scale 1 / sqrt(nope + rope)); RMSNorm; then the
FFN: the dense SwiGLU in the leading ``first_dense`` layers, else the
sigmoid router (DeepSeek-V3's ``noaux_tc`` with one group: sigmoid of
the fp32 logits, the selection bias added to the scores, top-k, the
chosen scores renormalised and times ``routed_scale``), the routed
experts under the capacity rule of the mode and through the wire, and
the shared experts (one SwiGLU).  The final norm and the head close it.

What the port derives from those inputs is worked out again here or
taken from ``model.py`` unedited: ``keep_ll`` (LL's capacity), the fp8
``wire_fp8``, ``experts``, ``rmsnorm``, ``rope``, ``attention``, ``mm``
(``precision="fp8"``: the control) and ``head``.

Weights in the port's layout (``epbench/weights_mla.py``): ``attn``
holds ``wq`` (d, H, nope + rope), ``w_dkv`` (d, c + rope), ``kv_norm``
(c,), ``w_ukv`` (c, H, nope + v), ``wo`` (H, v, d); a dense layer
``mlp``; an MoE layer ``moe`` as ``model.py`` takes it.
"""
from __future__ import annotations

import torch

from epbench.reference import model as M

F32 = torch.float32


def sizes(port: dict, traffic: dict) -> dict:
    """``model.sizes`` and the MLA widths, the leading dense layers and the
    router's rule, from a configuration's ``port`` block."""
    sz = M.sizes(port, traffic)
    moe = port["moe"]
    sz.update(kv_lora=port["kv_lora_rank"], rope=port["qk_rope_head_dim"],
              nope=port["qk_nope_head_dim"], v_head=port["v_head_dim"],
              first_dense=port.get("first_k_dense", 0),
              d_ff=port.get("d_ff", 0),
              routed_scale=moe.get("routed_scale", 1.0))
    return sz


def route_sigmoid(h, rw, rb, n_real: int, k: int, scale: float):
    """fp32 sigmoid router: (ids (N, k), weights (N, k), probs (N, E))."""
    scores = torch.sigmoid(h @ rw)
    e = rw.shape[1]
    pad = torch.arange(e, device=h.device) >= n_real
    scores = scores.masked_fill(pad, 0.0)
    sel = scores if rb is None else scores + rb
    sel = sel.masked_fill(pad, float("-inf"))
    ids = torch.topk(sel.detach(), k, dim=-1).indices
    top = torch.gather(scores, -1, ids)
    w = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9) * scale
    probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    return ids, w, probs


def layer_weights(block: dict) -> dict:
    """One layer's weights in fp32 (what is fp32 already is kept)."""
    out = {"ln1": block["ln1"].to(F32), "ln2": block["ln2"].to(F32)}
    out.update({k: v.to(F32) for k, v in block["attn"].items()})
    if "mlp" in block:
        out.update({f"d_{k}": v.to(F32) for k, v in block["mlp"].items()})
        return out
    m = block["moe"]
    out.update({k: v.to(F32) for k, v in m.items() if k != "shared"})
    if "shared" in m:
        out.update({f"s_{k}": v.to(F32) for k, v in m["shared"].items()})
    return out


def latent_rows(h, Wl, sz: dict, precision: str = "fp32"):
    """The latent rows (B, S, c + rope) of normed inputs h (B, S, D): the
    normalised c and the RoPE'd k_pe, what a decode cache holds."""
    S, L = h.shape[1], sz["kv_lora"]
    pos = torch.arange(S, device=h.device)
    kv = M.mm(h, Wl["w_dkv"], precision)
    c = M.rmsnorm(kv[..., :L], Wl["kv_norm"], sz["eps"])
    k_pe = M.rope(kv[..., None, L:], pos, sz["theta"])[..., 0, :]
    return torch.cat([c, k_pe], -1)


def mla(h, Wl, sz: dict, precision: str = "fp32"):
    """Causal multi-head latent attention of normed h (B, S, D), the
    non-absorbed form -> (B, S, D)."""
    B, S, D = h.shape
    H, L = sz["n_heads"], sz["kv_lora"]
    nope, r, v = sz["nope"], sz["rope"], sz["v_head"]
    pos = torch.arange(S, device=h.device)
    q = M.mm(h, Wl["wq"].reshape(D, H * (nope + r)), precision).reshape(
        B, S, H, nope + r)
    q = torch.cat([q[..., :nope], M.rope(q[..., nope:], pos, sz["theta"])],
                  -1)
    rows = latent_rows(h, Wl, sz, precision)
    ukv = M.mm(rows[..., :L], Wl["w_ukv"].reshape(L, H * (nope + v)),
               precision).reshape(B, S, H, nope + v)
    k = torch.cat([ukv[..., :nope],
                   rows[..., None, L:].expand(B, S, H, r)], -1)
    o = M.attention(q, k, ukv[..., nope:]).reshape(B, S, H * v)
    return M.mm(o, Wl["wo"].reshape(H * v, D), precision)


def swiglu(x, w_gate, w_up, w_down, precision: str):
    g = M.mm(x, w_gate, precision)
    u = M.mm(x, w_up, precision)
    return M.mm(torch.nn.functional.silu(g) * u, w_down, precision)


def block(x, Wl, sz: dict, mode: str, precision: str = "fp32"):
    """One layer over x (B, S, D) fp32.  ``mode``: "ll" keeps the routed
    choices by the LL decode rule (``model.keep_ll``), "all" keeps every
    one (no EP world: the port's dense oracle)."""
    B, S, D = x.shape
    x = x + mla(M.rmsnorm(x, Wl["ln1"], sz["eps"]), Wl, sz, precision)
    h = M.rmsnorm(x, Wl["ln2"], sz["eps"])
    flat = h.reshape(B * S, D)
    if "d_w_gate" in Wl:
        y = swiglu(flat, Wl["d_w_gate"], Wl["d_w_up"], Wl["d_w_down"],
                   precision)
        return x + y.reshape(B, S, D)
    K = sz["top_k"]
    ids, w, _ = route_sigmoid(flat, Wl["router_w"], Wl.get("router_b"),
                              sz["n_experts"], K, sz["routed_scale"])
    if mode == "ll":
        keep = M.keep_ll(ids.reshape(B, S, K), sz).reshape(B * S, K)
    elif mode == "all":
        keep = torch.ones_like(ids, dtype=torch.bool)
    else:
        raise ValueError(f"mode {mode!r}: 'll' or 'all'")
    xin = M.wire_fp8(flat) if sz["wire"] == "fp8" else flat
    y = M.experts(xin, ids, w, keep, Wl, precision, sz["n_experts"])
    if sz["d_shared"]:
        y = y + swiglu(flat, Wl["s_w_gate"], Wl["s_w_up"], Wl["s_w_down"],
                       precision)
    return x + y.reshape(B, S, D)


def hidden(W: dict, tokens: torch.Tensor, sz: dict, mode: str,
           precision: str = "fp32"):
    """The final-norm hidden states (B, S, D) fp32 of token rows
    ``tokens`` (B, S), layer by layer."""
    x = W["embed"][tokens].to(F32)
    for b in W["blocks"][:sz["n_layers"]]:
        x = block(x, layer_weights(b), sz, mode, precision)
    return M.rmsnorm(x, W["final_ln"].to(F32), sz["eps"])


def cache_rows(W: dict, tokens: torch.Tensor, sz: dict, n_layers: int,
               mode: str, precision: str = "fp32") -> list:
    """The latent rows (B, S, c + rope) fp32 that layers 0..n_layers - 1 of
    a decode cache hold after token rows ``tokens`` (B, S): each layer's
    from its normed input, the layers before it run over the same
    tokens."""
    x = W["embed"][tokens].to(F32)
    out = []
    for i, b in enumerate(W["blocks"][:n_layers]):
        Wl = layer_weights(b)
        out.append(latent_rows(M.rmsnorm(x, Wl["ln1"], sz["eps"]), Wl, sz,
                               precision))
        if i + 1 < n_layers:
            x = block(x, Wl, sz, mode, precision)
    return out


def head(W: dict, h: torch.Tensor, sz: dict, precision: str = "fp32"):
    """Logits over the real vocabulary, fp32."""
    return M.head(W, h, sz, precision)


def loss(W: dict, tokens, labels, sz: dict):
    """Mean next-token cross entropy over the real vocabulary, every
    choice kept (the training forward without an EP world)."""
    logits = head(W, hidden(W, tokens, sz, "all"), sz)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
