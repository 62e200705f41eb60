#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the hand-written CUDA kernels (src/repro_torch/csrc) built with
   nvcc for sm_90a, and the seconds it took;
3. serve (the main path): qwen2-moe-a2.7b at full width and depth (24
   layers; random weights from a seed) served through
   ``repro_torch.launch.serve.generate`` over a rank-stacked EP world of 4:
   batch 4, prompt 256, 16 generated tokens on the fp32 wire, then a
   shorter run (4 tokens) on the fp8 wire.  Batched HT prefill and LL
   decode go through the four kernels; every kernel's launch count is set
   to 0 just before and read just after, and must be > 0;
4. profile: the fp32 serve once more (run-to-run spread), then one
   prefill and one decode step under torch.profiler (device busy share,
   the device activities and host operators that take the most time);
5. moe_served: HT at the served shape (1024 tokens), on the MoE inputs
   one prefill recorded: per-layer drops, and layer 0 and the layer that
   drops most against the dense oracle with no choice dropped;
6. kernels: each kernel, on the inputs of the first call of each kind
   (shapes) it had in the main path — for the wire kernels, the HT prefill
   and the LL decode dispatch — against its plain PyTorch version:
   gather_quantize and dequantize bit for bit, grouped_swiglu and
   gather_swiglu_scatter within a stated tolerance; with CUDA-event times
   (median of 20 after 3 warm-ups) of the kernel and the plain version,
   and the bound the card's peak rates set for the same work;
7. moe_layer: the routed part of ``moe_apply`` (the shared expert, which
   bypasses EP, left out) at full width (256 tokens) against the port's
   dense oracle ``moe_ref`` for LL/HT, one-level P=4 and two-level (2, 2),
   fp32/fp8/int8 wires, with no dropped tokens.

Then the kernels line ``{"kernels": [...]}``, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and the exit code is not 0.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

KERNEL_INFO = {  # name: (source, the TPU kernel it replaces)
    "grouped_swiglu": ("src/repro_torch/csrc/grouped_swiglu.cu",
                       "src/repro/kernels/grouped_matmul.py:179"),
    "gather_swiglu_scatter": ("src/repro_torch/csrc/gather_swiglu_scatter.cu",
                              "src/repro/kernels/grouped_matmul.py:368"),
    "gather_quantize": ("src/repro_torch/csrc/gather_quantize.cu",
                        "src/repro/kernels/quantize_pack.py:105"),
    "dequantize": ("src/repro_torch/csrc/dequantize.cu",
                   "src/repro/kernels/quantize_pack.py:161"),
}
# max |kernel - plain| allowed, as a fraction of max |plain| (None: bitwise)
KERNEL_TOL = {
    # h and y round to bf16 (2^-8 relative each) on both sides, after fp32
    # sums taken in another order, so a rounding may land one ulp apart
    "grouped_swiglu": 1e-2,
    # h rounds to bf16 on both sides; the fp32 atomics add in any order
    "gather_swiglu_scatter": 5e-3,
    "gather_quantize": None,
    "dequantize": None,
}
# moe_apply vs the dense oracle, max error over max |oracle|: the fp32
# wire keeps bf16 activations (h, the LL expert output and the combined
# output each round to bf16); fp8/int8 as the reference's DESIGN.md §14
MOE_TOL = {"fp32": 2e-2, "fp8": 0.2, "int8": 0.05}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Stands in for a kernel wrapper during the main path: calls it and
    keeps a copy of the inputs of the first call of each kind — the
    arguments' shapes, with None for an absent one — so that, e.g., both
    the HT prefill dispatch and the LL decode dispatch (occupied counts,
    empty slots) of ``gather_quantize`` are held to the plain version."""

    def __init__(self, fn):
        self.fn, self.cases = fn, {}

    def __call__(self, *args, **kwargs):
        key = (tuple(tuple(a.shape) if hasattr(a, "shape") else a
                     for a in args), tuple(sorted(kwargs.items())))
        if key not in self.cases:
            self.cases[key] = (tuple(a.clone() if hasattr(a, "clone") else a
                                     for a in args), dict(kwargs))
        return self.fn(*args, **kwargs)


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    t = sorted(a.elapsed_time(b) for a, b in ev)
    return t[n // 2]


def bound(name: str, args, kwargs) -> tuple[float, str, dict]:
    """Least time the card could take for this call's work: the larger of
    its bytes (each input read once, each output written once, counting
    only the rows this call's counts occupy) over the memory rate and its
    operations over the peak rate for their type."""
    import torch
    if name in ("grouped_swiglu", "gather_swiglu_scatter"):
        if name == "grouped_swiglu":
            x, wg, wu, wd, counts = args
            G, C, D = x.shape
            out_bytes = x.numel() * 2
        else:
            x_ext, src, w_slot, wg, wu, wd, counts = args
            D = x_ext.shape[1]
            G = wg.shape[0]
            C = src.shape[0] // G
            out_bytes = (x_ext.shape[0] - 1) * D * 4
        E, _, F = wg.shape
        cnt = (torch.full((G, 1), C, device=wg.device) if counts is None
               else counts.reshape(G, -1).clamp(max=C // counts.reshape(
                   G, -1).shape[1]))
        rows = int(cnt.sum())
        experts = int((cnt.sum(1) > 0).sum())
        nbytes = (rows * D * 2 + experts * 3 * D * F * 2 + out_bytes
                  + rows * 8)
        flops = 6.0 * D * F * rows
        t_ops = flops / BF16_FLOP_PER_S
        work = {"occupied_rows": rows, "occupied_experts": experts}
    elif name == "gather_quantize":
        x_ext, src, counts = args
        D = x_ext.shape[1]
        n = src.shape[0]
        nb = -(-D // 128)
        rows = n if counts is None else int(
            counts.clamp(max=n // counts.numel()).sum())
        nbytes = rows * D * 4 + n * D + n * nb * 4 + n * 4
        t_ops = 4.0 * rows * D / FP32_FLOP_PER_S
        work = {"slots": n, "occupied_slots": rows}
    else:
        q, scales = args
        nbytes = q.numel() * 5 + scales.numel() * 4
        t_ops = 1.0 * q.numel() / FP32_FLOP_PER_S
        work = {"elements": q.numel()}
    t_bytes = nbytes / HBM_BYTES_PER_S
    work["bytes"] = nbytes
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def check_case(name, args, kwargs) -> dict:
    """One recorded call of kernel ``name`` against its plain version on
    the same inputs, and both timed."""
    import torch

    from repro_torch.kernels import ops
    cuda, plain = ops.KERNELS[name]
    got, ref = cuda(*args, **kwargs), plain(*args, **kwargs)
    torch.cuda.synchronize()
    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    tol = KERNEL_TOL[name]
    err = 0.0
    for g, r in pairs:
        if tol is None:
            same = torch.equal(g.view(torch.uint8) if g.element_size() == 1
                               else g, r.view(torch.uint8)
                               if r.element_size() == 1 else r)
            if not same:
                raise AssertionError(f"{name}: not bit-identical to plain")
        gf, rf = g.float(), r.float()
        if not torch.isfinite(gf).all():
            raise AssertionError(f"{name}: non-finite output")
        e = float((gf - rf).abs().max()) if gf.numel() else 0.0
        err = max(err, e)
        if tol is not None:
            scale = float(rf.abs().max())
            if e > tol * scale:
                raise AssertionError(f"{name}: max |err| {e} > {tol} * {scale}")
    bound_ms, bound_by, work = bound(name, args, kwargs)
    return {"max_abs_err": err, "ms": cuda_ms(lambda: cuda(*args, **kwargs)),
            "plain_ms": cuda_ms(lambda: plain(*args, **kwargs)),
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work}


def check_kernel(name, rec, launches) -> dict:
    """Every kind of call the main path made to kernel ``name``; the first
    kind's numbers stand for the kernel in the kernels line."""
    if not rec.cases:
        raise RuntimeError(f"{name}: the main path never called it")
    cases = [check_case(name, a, kw) for a, kw in rec.cases.values()]
    src, replaces = KERNEL_INFO[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "library_ms": None, "tolerance": KERNEL_TOL[name],
            "cases": cases}


def profile_step(what: str, step) -> dict:
    """``step()`` once under torch.profiler: the device's busy share of the
    step's wall time (the union of the device activities' intervals: the
    kernels, copies and fills the card ran), the device activities with the
    most time, and the host operators with the most self time.  Host
    operators (``aten::mm``, ...) also carry the device time of the kernels
    they launch; only device rows count as device time here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()                                               # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    dev_rows, host_rows = [], []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_rows.append((ev.self_device_time_total, ev.key, ev.count))
        else:
            host_rows.append((ev.self_cpu_time_total, ev.key, ev.count))
    dev_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    busy_ms = busy_us / 1e3
    return {"phase": "profile", "what": what, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if spans else None,
            "device_busy_share": (busy_ms / (wall * 1e3)) if spans else None,
            "device_activities": len(spans),
            "top_device": [{"name": k[:80], "device_ms": us / 1e3,
                            "calls": c} for us, k, c in dev_rows[:8]],
            "top_host_self": [{"name": k[:80], "host_ms": us / 1e3,
                               "calls": c} for us, k, c in host_rows[:8]]}


def profile_serve(cfg, params, prompts, dist) -> list:
    """Profiles of one batched HT prefill and one LL decode step."""
    import torch

    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape
    cache = Z.init_cache(cfg, B, S + 3, dtype=Z.compute_dtype(cfg),
                         device=prompts.device)
    out = [profile_step("one HT prefill (batch 4 x 256)", lambda: Z.prefill(
        cfg, params, cache, prompts, dist=dist))]
    tok = prompts[:, -1:]
    out.append(profile_step("one LL decode step (batch 4)",
                            lambda: Z.decode_step(cfg, params, cache, tok, S,
                                                  dist=dist)))
    return out


def moe_served(cfg, params, prompts, dist) -> dict:
    """HT at the served shape.  One fp32 prefill records every MoE layer's
    input (batch x prompt tokens), its dropped fraction and its routing
    imbalance.  Then, for layer 0 and the layer that dropped most, the
    routed part of ``moe_apply`` (HT) runs again on that input: at the
    configured capacity factor it must drop what the prefill dropped, and
    with the capacity factor raised until no choice can drop it must match
    the dense oracle ``moe_ref``."""
    import torch

    from repro_torch.core.moe import moe_apply
    from repro_torch.models import blocks
    from repro_torch.models import model_zoo as Z

    seen = []

    def record(c, d, p, x, *, mode, chunks):
        y, aux = moe_apply(c, d, p, x, mode=mode, chunks=chunks)
        seen.append((x.clone(), float(aux["dropped"]),
                     float(aux["imbalance"])))
        return y, aux

    B, S = prompts.shape
    cache = Z.init_cache(cfg, B, S, dtype=Z.compute_dtype(cfg),
                         device=prompts.device)
    blocks.moe_apply = record
    try:
        Z.prefill(cfg, params, cache, prompts, dist=dist, moe_mode="ht")
    finally:
        blocks.moe_apply = moe_apply
    drops = [d for _, d, _ in seen]
    worst = max(range(len(drops)), key=drops.__getitem__)
    # every token chooses an expert at most once, so an expert receives at
    # most B*S choices; an expert's capacity is cf x its mean load
    # (B*S*K/E), so cf = E/K lifts every capacity to B*S
    cf_all = float(params["blocks"][0]["moe"]["w_gate"].shape[0]
                   / cfg.moe.top_k)
    cfg_all = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf_all))
    checks = []
    for layer in sorted({0, worst}):
        x = seen[layer][0]
        p = {k: v for k, v in params["blocks"][layer]["moe"].items()
             if k != "shared"}
        y_ref, _ = moe_apply(cfg, None, p, x, mode="ref")
        _, aux = moe_apply(cfg, dist, p, x, mode="ht")
        y, aux_all = moe_apply(cfg_all, dist, p, x, mode="ht")
        scale = float(y_ref.float().abs().max())
        err = float((y.float() - y_ref.float()).abs().max()) / scale
        checks.append({"layer": layer, "dropped_at_cf": float(aux["dropped"]),
                       "dropped_in_prefill": drops[layer],
                       "dropped_at_cf_all": float(aux_all["dropped"]),
                       "rel_err_at_cf_all": err, "tol": MOE_TOL["fp32"]})
        if float(aux["dropped"]) != drops[layer]:
            raise AssertionError(f"layer {layer}: HT dropped {aux['dropped']}"
                                 f" on replay, {drops[layer]} in prefill")
        if float(aux_all["dropped"]) != 0.0 or not err <= MOE_TOL["fp32"]:
            raise AssertionError(f"layer {layer} at the served shape: rel "
                                 f"err {err}, dropped {aux_all['dropped']}")
    return {"phase": "moe_served", "tokens": B * S, "mode": "ht",
            "wire": cfg.moe.wire_dtype,
            "capacity_factor": cfg.moe.capacity_factor,
            "capacity_factor_all": cf_all,
            "dropped_per_layer": drops,
            "imbalance_per_layer": [i for _, _, i in seen],
            "checks": checks}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.core.moe import moe_apply
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    so = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.last_build_seconds, "library": so.name,
          "sources": [p.name for p in build.sources()]})

    # ---------------------------------------------------- main path ------
    cfg = get_config("qwen2_moe_a2_7b")
    cfg_fp8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, wire_dtype="fp8"))
    dist = make_dist_ctx(cfg, model=4)
    t0 = time.perf_counter()
    params = Z.init_params(cfg, seed=0, device=dev,
                           dtype=Z.compute_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(0)
    B, S, N_GEN, N_GEN_FP8 = 4, 256, 16, 4
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    # warm-up: first launches, library loads, allocator growth
    generate(cfg, params, prompts[:, :32], 2, dist=dist)
    generate(cfg_fp8, params, prompts[:, :32], 2, dist=dist)
    torch.cuda.synchronize()

    originals = dict(ops.KERNELS)
    recorders = {n: Recorder(c) for n, (c, _) in originals.items()}
    for n, (c, p) in originals.items():
        ops.KERNELS[n] = (recorders[n], p)
    cudas = {n: c for n, (c, _) in originals.items()}
    for c in cudas.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        res = generate(cfg, params, prompts, N_GEN, dist=dist)
        after_fp32 = {n: c.launches for n, c in cudas.items()}
        res8 = generate(cfg_fp8, params, prompts, N_GEN_FP8, dist=dist)
        launches = {n: c.launches for n, c in cudas.items()}
    finally:
        ops.KERNELS.update(originals)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for n, k in launches.items():
        if k <= 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
    for r, n_gen in ((res, N_GEN), (res8, N_GEN_FP8)):
        if r["tokens"].shape != (B, n_gen) or not torch.isfinite(
                r["logits"]).all():
            raise AssertionError("serve produced a wrong shape or non-finite "
                                 "logits")
        if not ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all():
            raise AssertionError("serve produced a token outside the vocab")
    for r, wire, n_gen, counts in (
            (res, "fp32", N_GEN, after_fp32),
            (res8, "fp8", N_GEN_FP8,
             {n: launches[n] - after_fp32[n] for n in launches})):
        emit({"phase": "serve", "model": "qwen2_moe_a2_7b", "width": "full",
              "layers": cfg.n_layers, "ep_world": "model=4", "batch": B,
              "prompt": S, "generated": n_gen, "wire": wire,
              "tokens_per_s": r["tokens_per_s"],
              "decode_tokens_per_s": r["decode_tokens_per_s"],
              "ttft_s": r["ttft_s"], "total_s": r["total_s"],
              "prefill_dropped": r["prefill_dropped"],
              "prefill_dropped_per_layer": r["prefill_dropped_per_layer"],
              "decode_dropped": r["decode_dropped"],
              "launches": counts, "first_tokens": r["tokens"][0].tolist(),
              "init_params_s": init_s, "peak_mem_gb": peak_gb})

    # the same fp32 serve once more, outside the counted window: its
    # tokens/s beside the first run's shows the run-to-run spread
    rep = generate(cfg, params, prompts, N_GEN, dist=dist)
    emit({"phase": "serve_repeat", "wire": "fp32",
          "tokens_per_s": rep["tokens_per_s"],
          "decode_tokens_per_s": rep["decode_tokens_per_s"],
          "ttft_s": rep["ttft_s"]})
    for prof in profile_serve(cfg, params, prompts, dist):
        emit(prof)
    emit(moe_served(cfg, params, prompts, dist))

    # ---------------------------------------------- kernels vs plain -----
    kernels = [check_kernel(n, recorders[n], launches) for n in KERNEL_INFO]
    for k in kernels:
        emit({"phase": "kernel", **k})

    # ---------------------------------------------- MoE layer vs oracle --
    p = {k: v for k, v in params["blocks"][0]["moe"].items()
         if k != "shared"}
    xg = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1, 256, cfg.d_model), generator=xg, device=dev).to(
        Z.compute_dtype(cfg))
    y_ref, _ = moe_apply(cfg, None, p, x, mode="ref")
    scale = float(y_ref.float().abs().max())
    cases = []
    for world, d in (("model=4", make_dist_ctx(cfg, model=4)),
                     ("pod=2,model=2", make_dist_ctx(cfg, model=2, pod=2))):
        for mode in ("ll", "ht"):
            for wire in ("fp32", "fp8", "int8"):
                c = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, wire_dtype=wire))
                y, aux = moe_apply(c, d, p, x, mode=mode)
                err = float((y.float() - y_ref.float()).abs().max()) / scale
                dropped = float(aux["dropped"])
                ms = cuda_ms(lambda: moe_apply(c, d, p, x, mode=mode), n=5,
                             warmup=1)
                cases.append({"world": world, "mode": mode, "wire": wire,
                              "rel_err": err, "tol": MOE_TOL[wire],
                              "dropped": dropped, "ms": ms})
                if not err <= MOE_TOL[wire] or dropped != 0.0:
                    raise AssertionError(f"moe_apply {world}/{mode}/{wire}: "
                                         f"rel err {err}, dropped {dropped}")
    emit({"phase": "moe_layer", "tokens": 256, "oracle": "moe_ref",
          "oracle_ms": cuda_ms(lambda: moe_apply(cfg, None, p, x,
                                                 mode="ref"), n=5, warmup=1),
          "cases": cases})

    emit({"kernels": [{k: v for k, v in kk.items()
                       if k not in ("tolerance", "cases")} for kk in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
