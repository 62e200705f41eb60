"""The plain reference of the benchmark's MoE models: fp32 PyTorch, no
kernels, no cache, no batching tricks, and nothing of the port imported.

It takes the cell's sizes as a plain dict (:func:`sizes`) and the weights
the benchmark drew (``epbench.weights``), upcasts one layer at a time to
fp32, and computes the whole step: the embedding, the RMSNorms, causal
attention over the full sequence (q/k/v biases, RoPE on the two halves of
each head), the fp32 router (softmax over the real experts, a selection
bias, top-k, the chosen probabilities renormalised), the routed experts
(SwiGLU each), the shared expert, the final norm and the head.

What the port derives from those inputs, the reference works out again
from frozen plain copies of the rules:

* the capacity of an expert-parallel dispatch (``cap``), and which
  choices it keeps: LL (decode) keeps, for each expert and each step, the
  first choices in (sequence, k) order; HT (prefill and training) lays the
  tokens out over the EP ranks as sequence slices, keeps a (token, rank)
  entry while its rank's bucket has room, then keeps an expert's choices
  in (source rank, token, k) order up to the expert capacity;
* the fp8 wire: each token row crossing to its experts block-quantized,
  one absmax scale per 128 features, rounded f32 -> f16 -> e4m3, and
  dequantized;
* (``train.py``) the loss, AdamW and the router-bias rule.

``precision="fp8"`` is the control: every bf16 product of the model (not
the fp32 router) takes its operands rounded to e4m3 with a scale a row
of the activations and a column of the weights, as an fp8 GEMM would.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
FP8_MAX = 448.0
# the wire's scale factor: a multiply by the f32-rounded reciprocal
QINV_FP8 = float(torch.tensor(1.0, dtype=F32) / torch.tensor(FP8_MAX,
                                                                 dtype=F32))
WIRE_BLOCK = 128


def sizes(port: dict, traffic: dict) -> dict:
    """The reference's plain view of a configuration file's ``port`` block
    and a traffic mix."""
    moe = port["moe"]
    n = moe["n_experts"]
    return {"n_layers": traffic.get("layers", port["n_layers"]),
            "d_model": port["d_model"], "n_heads": port["n_heads"],
            "n_kv_heads": port["n_kv_heads"],
            "head_dim": port.get("head_dim") or port["d_model"] // port[
                "n_heads"],
            "vocab": port["vocab_size"], "eps": port.get("norm_eps", 1e-5),
            "theta": port["rope_theta"], "qkv_bias": port.get("qkv_bias",
                                                              False),
            "n_experts": n, "e_pad": -(-n // (32 if n >= 32 else 16))
            * (32 if n >= 32 else 16), "top_k": moe["top_k"],
            "d_shared": moe.get("d_shared", 0),
            "aux_weight": moe.get("aux_loss_weight", 1e-2),
            "ep_world": traffic.get("ep_world", 4),
            "cf": traffic.get("capacity_factor", 2.0),
            "ll_cf": traffic.get("ll_capacity_factor", 4.0),
            "wire": traffic.get("wire_dtype", "fp32")}


def cap(n: float, cf: float, hard_max: int, multiple: int = 8) -> int:
    """A bucket's capacity: n * cf rounded up to ``multiple``, at most
    ``hard_max``, at least 32 (or ``hard_max`` if smaller)."""
    c = int(math.ceil(n * cf / multiple)) * multiple
    return max(min(hard_max, 32), min(c, hard_max))


# ------------------------------------------------------------ numerics --
def _e4m3(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float8_e4m3fn).to(F32)


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 under one absmax scale along ``dim``; the
    gradient passes straight through."""
    s = x.detach().abs().amax(dim=dim, keepdim=True) / FP8_MAX
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = _e4m3(torch.clamp(x.detach() / s, -FP8_MAX, FP8_MAX)) * s
    return x + (q - x.detach())


def mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., K) @ w (K, N), fp32; fp8 rounds a's rows and w's columns."""
    if precision == "fp8":
        a, w = fake_fp8(a, -1), fake_fp8(w, 0)
    return a @ w


def wire_fp8(x: torch.Tensor) -> torch.Tensor:
    """Token rows (N, D) through the fp8 wire: quantize a 128-feature
    block at a time, dequantize to fp32."""
    N, D = x.shape
    nb = -(-D // WIRE_BLOCK)
    xb = torch.nn.functional.pad(x, (0, nb * WIRE_BLOCK - D)).reshape(
        N, nb, WIRE_BLOCK)
    scale = xb.abs().amax(-1) * QINV_FP8
    s = torch.where(scale == 0, torch.ones_like(scale), scale)
    y = torch.clamp(xb / s[..., None], -FP8_MAX, FP8_MAX)
    return (_e4m3(y) * scale[..., None]).reshape(N, nb * WIRE_BLOCK)[:, :D]


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x (B, S, H, hd), positions (S,): the two halves of each head
    rotated by position * theta^(-2i/hd)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                          device=x.device) / hd))
    ang = positions.to(F32)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, chunk: int = 8):
    """Causal softmax attention, q (B, S, H, hd), k/v (B, S, Hkv, hd),
    a few sequences at a time."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    outs = []
    for b in range(0, B, chunk):
        qb = q[b:b + chunk].transpose(1, 2)
        kb = k[b:b + chunk].repeat_interleave(rep, 2).transpose(1, 2)
        vb = v[b:b + chunk].repeat_interleave(rep, 2).transpose(1, 2)
        s = (qb @ kb.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        outs.append((torch.softmax(s, -1) @ vb).transpose(1, 2))
    return torch.cat(outs, 0)


def route(h, rw, rb, n_real: int, k: int):
    """fp32 router: (ids (N, k), weights (N, k), probs (N, E))."""
    logits = h @ rw
    e = rw.shape[1]
    if e > n_real:
        pad = torch.arange(e, device=h.device) >= n_real
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, -1)
    sel = logits if rb is None else logits + rb
    ids = torch.topk(sel.detach(), k, dim=-1).indices
    top_p = torch.gather(probs, -1, ids)
    w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return ids, w, probs


def _rank_in_order(ids: torch.Tensor, valid: torch.Tensor, n: int):
    """Rows of choices ``ids`` (G, M) in order: each choice's count of
    earlier valid choices of its expert in its row."""
    oh = torch.nn.functional.one_hot(ids.clamp(min=0).long(), n).to(
        torch.int32) * valid[..., None].to(torch.int32)
    before = oh.cumsum(1) - oh
    return torch.gather(before, 2, ids.clamp(min=0).long()[..., None])[..., 0]


def keep_ll(ids: torch.Tensor, sz: dict) -> torch.Tensor:
    """LL decode: ids (B, S, K) of B sequences at S steps.  Each step runs
    the B tokens (every rank holds all of them); an expert keeps its first
    C choices in (sequence, k) order."""
    B, S, K = ids.shape
    E = sz["e_pad"]
    C = cap(B * K / E, sz["ll_cf"], hard_max=B * K)
    per_step = ids.permute(1, 0, 2).reshape(S, B * K)
    r = _rank_in_order(per_step, torch.ones_like(per_step, dtype=torch.bool),
                       E)
    return (r < C).reshape(S, B, K).permute(1, 0, 2)


def ht_layout(B: int, S: int, R: int):
    """Token order of each EP rank for a (B, S) batch: rank m holds the
    sequence slice m of every sequence (S > 1 and divisible by R),
    flattened (sequence, position).  Returns (R, T) indices into the
    flattened (B*S) tokens."""
    if S <= 1 or S % R:
        raise ValueError(f"HT lays a ({B}, {S}) batch over {R} ranks by "
                         "sequence slices")
    idx = torch.arange(B * S).reshape(B, R, S // R)
    return idx.permute(1, 0, 2).reshape(R, -1)


def keep_ht(ids: torch.Tensor, sz: dict) -> torch.Tensor:
    """HT: ids (R, T, K) in each rank's token order -> keep (R, T, K).
    Group level (the ranks): a (token, rank) entry is kept while the
    source's bucket for that rank has room (C); expert level: an expert
    keeps its first Ce kept choices in (source rank, token, k) order."""
    R, T, K = ids.shape
    E = sz["e_pad"]
    eps = E // R
    frac = 1.0 - (1.0 - 1.0 / R) ** K
    C = cap(T * frac, sz["cf"], hard_max=T)
    group = ids // eps                                         # (R, T, K)
    has = torch.nn.functional.one_hot(group.long(), R).amax(2)  # (R, T, R)
    rank_e = has.cumsum(1) - has                               # entry rank
    keep_entry = (rank_e < C) & (has > 0)
    gkeep = torch.gather(keep_entry, 2, group.long())          # (R, T, K)
    Ce = cap(T * K / eps, sz["cf"], hard_max=R * C * K)
    flat = ids.reshape(1, R * T * K)
    r = _rank_in_order(flat, gkeep.reshape(1, -1), E).reshape(R, T, K)
    return gkeep & (r < Ce)


def experts(x, ids, w, keep, Wl, precision: str, n_real: int):
    """Sum over each token's kept choices of weight * SwiGLU_e(x): x (N, D)
    (the rows as they cross the wire), ids/w/keep (N, K)."""
    out = torch.zeros_like(x)
    for e in range(n_real):
        tok, kk = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        g = mm(xe, Wl["w_gate"][e], precision)
        u = mm(xe, Wl["w_up"][e], precision)
        y = mm(torch.nn.functional.silu(g) * u, Wl["w_down"][e], precision)
        out = out.index_add(0, tok, y * w[tok, kk][:, None])
    return out


def layer_weights(block: dict) -> dict:
    """One layer's weights in fp32 (what is fp32 already is kept)."""
    a, m = block["attn"], block["moe"]
    out = {"ln1": block["ln1"].to(F32), "ln2": block["ln2"].to(F32)}
    out.update({k: v.to(F32) for k, v in a.items()})
    out.update({k: v.to(F32) for k, v in m.items() if k != "shared"})
    if "shared" in m:
        out.update({f"s_{k}": v.to(F32) for k, v in m["shared"].items()})
    return out


def block(x, Wl, sz: dict, mode: str, precision: str = "fp32",
          stats: dict | None = None):
    """One layer over x (B, S, D) fp32: attention, then the MoE FFN with
    the capacity rule of ``mode`` ("ll" or "ht").  ``stats`` (training)
    collects the router's aux loss and the experts' loads."""
    B, S, D = x.shape
    H, Hkv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, Wl["ln1"], sz["eps"])
    q = mm(h, Wl["wq"].reshape(D, H * hd), precision).reshape(B, S, H, hd)
    k = mm(h, Wl["wk"].reshape(D, Hkv * hd), precision).reshape(B, S, Hkv,
                                                                 hd)
    v = mm(h, Wl["wv"].reshape(D, Hkv * hd), precision).reshape(B, S, Hkv,
                                                                 hd)
    if sz["qkv_bias"]:
        q, k, v = q + Wl["bq"], k + Wl["bk"], v + Wl["bv"]
    q, k = rope(q, pos, sz["theta"]), rope(k, pos, sz["theta"])
    o = attention(q, k, v).reshape(B, S, H * hd)
    x = x + mm(o, Wl["wo"].reshape(H * hd, D), precision)
    h = rmsnorm(x, Wl["ln2"], sz["eps"])
    flat = h.reshape(B * S, D)
    ids, w, probs = route(flat, Wl["router_w"], Wl.get("router_b"),
                          sz["n_experts"], sz["top_k"])
    K = sz["top_k"]
    if mode == "ll":
        keep = keep_ll(ids.reshape(B, S, K), sz).reshape(B * S, K)
    else:
        order = ht_layout(B, S, sz["ep_world"]).to(x.device)  # (R, T)
        keep_r = keep_ht(ids[order], sz)                       # (R, T, K)
        keep = torch.empty_like(keep_r.reshape(-1, K))
        keep[order.reshape(-1)] = keep_r.reshape(-1, K)
        if stats is not None:
            R = order.shape[0]
            oh = torch.nn.functional.one_hot(ids[order].long(),
                                             sz["e_pad"]).to(F32).sum(-2)
            f = oh.mean(1)                                     # (R, E)
            pbar = probs[order].mean(1)
            aux = sz["n_experts"] * (f * pbar).sum(-1) * sz["aux_weight"]
            stats.setdefault("aux", []).append(aux.mean())
            stats.setdefault("loads", []).append(
                torch.bincount(ids.reshape(-1), minlength=sz["e_pad"]))
            stats.setdefault("dropped", []).append(
                1.0 - keep.to(F32).mean())
            del R
    xin = wire_fp8(flat) if sz["wire"] == "fp8" else flat
    y = experts(xin, ids, w, keep, Wl, precision, sz["n_experts"])
    if sz["d_shared"]:
        g = mm(flat, Wl["s_w_gate"], precision)
        u = mm(flat, Wl["s_w_up"], precision)
        y = y + mm(torch.nn.functional.silu(g) * u, Wl["s_w_down"],
                   precision)
    return x + y.reshape(B, S, D)


def hidden(W: dict, tokens: torch.Tensor, sz: dict, mode: str,
           precision: str = "fp32", stats: dict | None = None):
    """The final-norm hidden states (B, S, D) fp32 of token rows
    ``tokens`` (B, S), layer by layer."""
    x = W["embed"][tokens].to(F32)
    for b in W["blocks"][:sz["n_layers"]]:
        x = block(x, layer_weights(b), sz, mode, precision, stats)
    return rmsnorm(x, W["final_ln"].to(F32), sz["eps"])


def head(W: dict, h: torch.Tensor, sz: dict, precision: str = "fp32"):
    """Logits over the real vocabulary, fp32."""
    return mm(h, W["lm_head"][:, :sz["vocab"]].to(F32), precision)


@torch.no_grad()
def served_logits(W, tokens, sz, mode, rows, positions,
                  precision: str = "fp32"):
    """Logits (len(rows), len(positions), V) of sequences ``rows`` of the
    batch ``tokens`` (B, S) at ``positions``: the whole batch runs, since
    the capacity rules couple its sequences."""
    h = hidden(W, tokens, sz, mode, precision)
    sel = h[rows][:, positions]
    return head(W, sel, sz, precision)
