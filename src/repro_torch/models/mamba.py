"""Mamba-1 block (falcon-mamba / jamba mamba layers): init, the sequence
apply for training, and the one-token decode step with a carried (conv,
ssm) state, the port of ``repro.models.mamba`` (``mamba_dims``,
``mamba_init``, ``_ssm_inputs``, ``mamba_apply``, ``MambaCache``,
``mamba_init_cache``, ``mamba_decode_step``).

The dtypes are those of the reference: the projections and the causal
depthwise conv run in the compute dtype; the step sizes ``dts``, ``A``,
``Bs``, ``Cs`` and the scan input are fp32; the scan output is cast back,
then gated by ``silu(z)``.  The scan is ``kernels.ops.mamba_scan``.  The
decode step keeps the conv history in the cache dtype and the ssm state in
fp32, and updates both in place, so that a CUDA graph that captured the
step replays it on the same cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_model, d_inner, dt_rank, d_state)."""
    d = cfg.d_model
    di = cfg.mamba.expand * d
    dtr = cfg.mamba.dt_rank or -(-d // 16)
    return d, di, dtr, cfg.mamba.d_state


def mamba_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random fp32 parameters from ``gen`` in the reference's layout and
    scales (the numbers differ from ``jax.random``'s)."""
    d, di, dtr, n = mamba_dims(cfg)
    dc = cfg.mamba.d_conv

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((di,), generator=gen, device=device) * (hi - lo) + lo
    return {
        "in_proj": randn((d, di), 1.0 / math.sqrt(d)),
        "z_proj": randn((d, di), 1.0 / math.sqrt(d)),
        "conv_w": randn((dc, di), 1.0 / math.sqrt(dc)),
        "conv_b": torch.zeros((di,), device=device),
        "x_proj": randn((di, dtr + 2 * n), 1.0 / math.sqrt(di)),
        "dt_w": randn((dtr, di), 1.0 / math.sqrt(dtr)),
        # softplus-inverse of step sizes in ~[1e-3, 1e-1]
        "dt_b": torch.log(torch.expm1(torch.exp(u))),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device)[None].expand(di, n)
                           .contiguous()),
        "D": torch.ones((di,), device=device),
        "out_proj": randn((di, d), 1.0 / math.sqrt(di)),
    }


def _ssm_inputs(cfg: ModelConfig, p: dict, xc: Tensor):
    """xc: post-conv activations (B, S, Di) -> fp32 (dts, A, Bs, Cs)."""
    _, _, dtr, n = mamba_dims(cfg)
    f32 = torch.float32
    proj = xc @ p["x_proj"].to(xc.dtype)                        # (B,S,R+2N)
    dt_raw, Bs, Cs = torch.split(proj, [dtr, n, n], dim=-1)
    dts = F.softplus(dt_raw.to(f32) @ p["dt_w"].to(f32) + p["dt_b"])
    A = -torch.exp(p["A_log"])                                   # (Di, N)
    return dts, A, Bs.to(f32), Cs.to(f32)


def mamba_apply(cfg: ModelConfig, p: dict, x: Tensor) -> Tensor:
    """Training/prefill: x (B, S, d_model) -> (B, S, d_model)."""
    dt = x.dtype
    xi = x @ p["in_proj"].to(dt)                                 # (B,S,Di)
    z = x @ p["z_proj"].to(dt)
    # causal depthwise conv over the sequence
    dc = cfg.mamba.d_conv
    S = xi.shape[1]
    xpad = F.pad(xi, (0, 0, dc - 1, 0))
    xc = sum(xpad[:, i:i + S] * p["conv_w"][i].to(dt)
             for i in range(dc)) + p["conv_b"].to(dt)
    xc = F.silu(xc)
    dts, A, Bs, Cs = _ssm_inputs(cfg, p, xc)
    y = kops.mamba_scan(xc.to(torch.float32), dts, A, Bs, Cs, p["D"])
    y = y.to(dt) * F.silu(z)
    return y @ p["out_proj"].to(dt)


class MambaCache(NamedTuple):
    conv: Tensor   # (B, d_conv - 1, Di) trailing conv inputs, cache dtype
    ssm: Tensor    # (B, Di, N) recurrent state, fp32


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> MambaCache:
    _, di, _, n = mamba_dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.mamba.d_conv - 1, di), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, di, n), dtype=torch.float32, device=device))


def mamba_decode_step(cfg: ModelConfig, p: dict, x: Tensor,
                      cache: MambaCache) -> tuple[Tensor, MambaCache]:
    """x (B, 1, d_model), one token -> (y (B, 1, d_model), cache), the
    cache's two tensors updated in place.  The conv dot over the d_conv
    taps sums in fp32 and rounds once to the compute dtype."""
    dt = x.dtype
    f32 = torch.float32
    xi = x[:, 0] @ p["in_proj"].to(dt)                           # (B, Di)
    z = x[:, 0] @ p["z_proj"].to(dt)
    hist = torch.cat([cache.conv, xi[:, None]], dim=1)          # (B,dc,Di)
    xc = ((hist.to(f32) * p["conv_w"].to(dt).to(f32)).sum(1).to(dt)
          + p["conv_b"].to(dt))
    xc = F.silu(xc)
    dts, A, Bs, Cs = _ssm_inputs(cfg, p, xc[:, None])
    dts, Bs, Cs = dts[:, 0], Bs[:, 0], Cs[:, 0]                  # (B,Di)/(B,N)
    xf = xc.to(f32)
    dA = torch.exp(dts[..., None] * A)                           # (B,Di,N)
    dBx = dts[..., None] * Bs[:, None, :] * xf[..., None]
    h = dA * cache.ssm + dBx
    y = torch.einsum("bdn,bn->bd", h, Cs) + xf * p["D"]
    y = y.to(dt) * F.silu(z)
    out = (y @ p["out_proj"].to(dt))[:, None]
    # hist is a new tensor: the shift copies from it, never a slice of the
    # cache onto itself
    cache.conv.copy_(hist[:, 1:])
    cache.ssm.copy_(h)
    return out, cache
