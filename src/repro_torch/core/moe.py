"""MoE FFN layer: router + UCCL-EP dispatch/combine + grouped expert SwiGLU,
plus the always-on shared expert that bypasses dispatch (qwen2-moe style):
the port of ``repro.core.moe``.

With an EP world (``dist.ep_axes``) the layer lays its ``(B, S)`` tokens
out over the ranks as the reference's ``x_spec = P(bd, sq, None)`` does
(:func:`token_layout`) and runs the backend over the rank-stacked world;
without one (``dist=None`` or ``mode="ref"``) it runs the dense oracle
:func:`~repro_torch.core.ep.moe_ref`, as the JAX package does without a
mesh.  A host backend (``jit_compatible`` False: ``simulated_rdma``) takes
:func:`_moe_host_sim` first, whatever ``dist`` is, as the reference's
does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, _round_up
from repro_torch.core import plan as planlib
from repro_torch.core.backend import get_backend
from repro_torch.core.ep import EPSpec, moe_ref
from repro_torch.core.routing import RouterParams, route, router_init
from repro_torch.distributed.sharding import DistCtx
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import mlp_init, swiglu

Tensor = torch.Tensor


def padded_experts_static(cfg: ModelConfig) -> int:
    """Mesh-independent padded expert count (divisible by 16, and by 32
    when the model has >= 32 experts)."""
    e = cfg.moe.n_experts
    return _round_up(e, 32) if e >= 32 else _round_up(e, 16)


def moe_init(cfg: ModelConfig, gen: torch.Generator, device,
             dtype: Optional[torch.dtype] = None) -> dict:
    """With ``dtype``, each expert weight is cast as soon as it is made, so
    that the fp32 peak is one weight, not the layer's three (at jamba's
    widths one fp32 weight is 12.9 GB)."""
    m = cfg.moe
    e_pad = padded_experts_static(cfg)
    d, f = cfg.d_model, m.d_expert
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    r = router_init(d, e_pad, gen, m.router_aux_free_bias, device)

    def mk(shape, sc):
        w = torch.randn(shape, generator=gen, device=device).mul_(sc)
        return w if dtype is None else w.to(dtype)
    out = {
        "router_w": r.w,
        "w_gate": mk((e_pad, d, f), s),
        "w_up": mk((e_pad, d, f), s),
        "w_down": mk((e_pad, f, d), so),
    }
    if r.bias is not None:
        out["router_b"] = r.bias
    if m.d_shared:
        out["shared"] = mlp_init(d, m.d_shared, gen, device)
    return out


def _expert_fn(wg: Tensor, wu: Tensor, wd: Tensor):
    """Occupancy-carrying expert_fn over the whole rank-stacked world:
    ``fn(tokens, counts)`` applies the grouped SwiGLU to (E, C, D) buffers,
    skipping rows beyond each bucket's count, and ``fn.fused`` is the fused
    gather -> SwiGLU -> scatter the HT compute uses."""
    def fn(tokens, counts=None):
        return kops.grouped_swiglu(tokens, wg, wu, wd, counts)

    def fused(x_ext, src_of_slot, w_slot, counts=None):
        return kops.gather_swiglu_scatter(x_ext, src_of_slot, w_slot,
                                          wg, wu, wd, counts)
    fn.fused = fused
    return fn


def make_ep_spec(cfg: ModelConfig, dist: DistCtx, *, mode: str,
                 chunks: int = 1, dtype=torch.bfloat16) -> EPSpec:
    cf = (cfg.moe.ll_capacity_factor if mode == "ll"
          else cfg.moe.capacity_factor)
    return EPSpec(axes=tuple(dist.ep_axes), sizes=tuple(dist.ep_sizes),
                  n_experts=padded_experts_static(cfg), top_k=cfg.moe.top_k,
                  capacity_factor=cf, chunks=chunks, dtype=dtype,
                  mode=("ll" if mode == "ll" else "ht"),
                  wire_dtype=cfg.moe.wire_dtype)


def moe_apply(cfg: ModelConfig, dist: Optional[DistCtx], p: dict, x: Tensor,
              *, mode: str = "ht", chunks: int = 1,
              backend=None) -> tuple[Tensor, dict]:
    """x: (B, S, D) -> (y, aux).  mode: "ht" | "ll" | "ref".  ``backend``
    (default ``cfg.moe.ep_backend``) is a registered name (an unknown one
    raises) or an :class:`~repro_torch.core.backend.EPBackend` instance:
    the persistent-session path, where a model passes ONE instance to all
    its MoE layers (DESIGN §16)."""
    B, S, D = x.shape
    mcfg = cfg.moe
    e_pad = p["w_gate"].shape[0]
    rparams = RouterParams(w=p["router_w"], bias=p.get("router_b"))
    be = backend if backend is not None else mcfg.ep_backend
    ep_be = get_backend(be) if isinstance(be, str) else be

    if not ep_be.jit_compatible and mode != "ref":
        y, aux = _moe_host_sim(cfg, dist, rparams, p, x, mode, ep_be)
    elif dist is None or not dist.ep_axes or mode == "ref":
        t = x.reshape(-1, D)
        rout = route(mcfg, rparams, t, mcfg.n_experts)
        y = moe_ref(t, rout.top_idx, rout.top_w, p["w_gate"], p["w_up"],
                    p["w_down"]).reshape(B, S, D)
        load = planlib.expert_load(rout.top_idx, e_pad)
        # imbalance over the real experts: pads never receive tokens
        aux = {"aux_loss": rout.aux_loss,
               "dropped": torch.zeros((), device=x.device),
               "load": load,
               "imbalance": planlib.load_imbalance(load[:mcfg.n_experts])}
    else:
        y, aux = _moe_dist(cfg, dist, rparams, p, x, mode, chunks, ep_be)

    if mcfg.d_shared and "shared" in p:
        y = y + swiglu(p["shared"], x)
    return y, aux


def _host_expert_fn(wg: Tensor, wu: Tensor, wd: Tensor):
    """The host substrate's expert function: ``fn(tokens, counts)`` takes
    the received rows (numpy fp32 (E, N, D)) to the weights' device and
    dtype, runs ``ops.grouped_swiglu`` with the substrate's per-expert (E,)
    or bucketed (E, B) counts (the CUDA kernel on the card, its plain
    version on the CPU) and returns fp32 numpy."""
    def fn(tokens, counts=None):
        x = torch.from_numpy(np.ascontiguousarray(tokens, np.float32)).to(
            device=wg.device, dtype=wg.dtype)
        c = (None if counts is None else torch.from_numpy(
            np.ascontiguousarray(counts, np.int32)).to(wg.device))
        y = kops.grouped_swiglu(x, wg, wu, wd, c)
        return y.to(torch.float32).cpu().numpy()
    return fn


def _moe_host_sim(cfg: ModelConfig, dist: Optional[DistCtx],
                  rparams: RouterParams, p: dict, x: Tensor, mode: str,
                  ep_be) -> tuple[Tensor, dict]:
    """Host-backend path: the MoE layer's dispatch/combine on numpy arrays
    (the simulated-RDMA substrate), its expert compute on the weights'
    device through :func:`_host_expert_fn`.  The (B*S) tokens split
    row-major over the ranks; the spec comes from :func:`make_ep_spec`
    with an EP world, else its degree is the largest of 1, 2 and 4 that
    divides both the token count and the padded experts.  The substrate
    carries no gradient: under autograd it raises."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            isinstance(v, Tensor) and v.requires_grad for v in p.values())):
        raise RuntimeError(
            f"moe_apply: the {ep_be.name} backend runs on the host and "
            "carries no gradient; run it under torch.no_grad() or "
            "torch.inference_mode()")
    B, S, D = x.shape
    mcfg = cfg.moe
    t = x.reshape(-1, D)
    rout = route(mcfg, rparams, t, mcfg.n_experts)
    e_pad = p["w_gate"].shape[0]
    if dist is not None and dist.ep_axes:
        spec = make_ep_spec(cfg, dist, mode=mode, dtype=x.dtype)
    else:
        degree = max(d for d in (1, 2, 4) if (B * S) % d == 0
                     and e_pad % d == 0)
        spec = EPSpec(axes=("sim",), sizes=(degree,), n_experts=e_pad,
                      top_k=mcfg.top_k, mode=mode,
                      wire_dtype=mcfg.wire_dtype)
    res = ep_be.dispatch_combine(
        spec, t.to(torch.float32).cpu().numpy(),
        rout.top_idx.cpu().numpy(),
        rout.top_w.to(torch.float32).cpu().numpy(),
        _host_expert_fn(p["w_gate"], p["w_up"], p["w_down"]))
    load = planlib.expert_load(rout.top_idx, e_pad)
    # with a replicated placement the backend's physical-slot stat is the
    # truth; without one, report over the real (unpadded) logical experts
    if spec.placement is not None:
        imb = torch.tensor(float(res.aux["imbalance"]), device=x.device)
    else:
        imb = planlib.load_imbalance(load[:mcfg.n_experts])
    aux = {"aux_loss": rout.aux_loss,
           "dropped": torch.tensor(float(res.aux["dropped"]),
                                   device=x.device),
           "load": load, "imbalance": imb}
    y = torch.from_numpy(np.asarray(res.out, np.float32)).to(
        device=x.device, dtype=x.dtype)
    return y.reshape(B, S, D), aux


def token_layout(dist: DistCtx, B: int, S: int) -> tuple[int, int]:
    """(batch groups, sequence slices) of a (B, S) token batch over the EP
    world, as the reference shards it (``x_spec = P(bd, sq, None)``,
    repro/core/moe.py): the batch splits over the "pod" axis when the pod
    count divides B (else every pod holds the whole batch), the sequence
    over the "model" axis when S > 1 and the model count divides S (else,
    decode included, every model rank holds the same tokens).  Rank (p, m)
    holds batch group p (or all), sequence slice m (or all), its tokens
    flattened row-major."""
    pods, models = dist.axis_size("pod"), dist.axis_size("model")
    groups = pods if B % pods == 0 else 1
    slices = models if S > 1 and S % models == 0 else 1
    return groups, slices


def to_ranks(dist: DistCtx, x: Tensor) -> Tensor:
    """x (B, S, D) -> the (R, T, D) tokens each rank holds
    (:func:`token_layout`); replicated ranks hold copies."""
    B, S, D = x.shape
    nb, ns = token_layout(dist, B, S)
    pods, models = dist.axis_size("pod"), dist.axis_size("model")
    t = x.reshape(nb, B // nb, ns, S // ns, D).transpose(1, 2)
    return t.expand(pods, models, B // nb, S // ns, D).reshape(
        pods * models, (B // nb) * (S // ns), D)


def from_ranks(dist: DistCtx, y: Tensor, B: int, S: int) -> Tensor:
    """The inverse of :func:`to_ranks`: y (R, T, D) -> (B, S, D), read from
    the first of each set of replicated ranks (they compute the same
    values), so gradients flow through that one."""
    nb, ns = token_layout(dist, B, S)
    pods, models = dist.axis_size("pod"), dist.axis_size("model")
    D = y.shape[-1]
    y = y.reshape(pods, models, B // nb, S // ns, D)[:nb, :ns]
    return y.transpose(1, 2).reshape(B, S, D)


def _moe_dist(cfg: ModelConfig, dist: DistCtx, rparams: RouterParams,
              p: dict, x: Tensor, mode: str, chunks: int,
              ep_backend) -> tuple[Tensor, dict]:
    B, S, D = x.shape
    mcfg = cfg.moe
    spec = make_ep_spec(cfg, dist, mode=mode, chunks=chunks, dtype=x.dtype)
    t = to_ranks(dist, x)
    rout = route(mcfg, rparams, t, mcfg.n_experts)
    fn = _expert_fn(p["w_gate"], p["w_up"], p["w_down"])
    res = ep_backend.dispatch_combine(spec, t, rout.top_idx, rout.top_w, fn)
    # means over every rank, replicas included, as the reference's psums
    # over the mesh divided by its size
    load = planlib.expert_load(rout.top_idx, spec.n_experts)
    aux = {"aux_loss": rout.aux_loss.mean(),
           "dropped": res.aux["dropped"].mean(),
           "occupancy": res.aux["occupancy"].to(torch.float32).mean(),
           "load": load,
           "imbalance": planlib.load_imbalance(load[:mcfg.n_experts])}
    return from_ranks(dist, res.out, B, S), aux
