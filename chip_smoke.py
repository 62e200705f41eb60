#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the hand-written CUDA kernels (src/repro_torch/csrc) built with
   nvcc for sm_90a, and the seconds it took;
3. serve (the serving path): qwen2-moe-a2.7b at full width and depth (24
   layers; random weights from a seed) served through
   ``repro_torch.launch.serve.generate`` over a rank-stacked EP world of 4:
   batch 4, prompt 256, 16 generated tokens on the fp32 wire, then a
   shorter run (4 tokens) on the fp8 wire.  Batched HT prefill
   (``batched_prefill=True``) and LL decode go through the four EP
   kernels, and their norms and attention
   (MHA, 16 heads) through the RMSNorm, flash attention and flash decoding
   kernels; ``generate`` captures the decode step in a CUDA graph and
   replays it.  The launch counts of all seven are set to 0 just before and
   read just after, a captured kernel's counted at capture times the
   replays, and must be > 0;
4. profile: the fp32 serve once more (run-to-run spread); then
   serve_eager_vs_graph: the fp32 and fp8 serves through the eager step
   (``cuda_graph=False``; decode tokens/s beside the graph's), and their
   tokens decoded from one prefill through the eager step and through the
   graph, which must agree bit for bit; then
   serve_local_per_token: ``generate`` by the reference's rule over the
   EP world (a model axis), so the prompt runs through LL decode steps, as
   the reference's ``serve --mesh local`` does: batch 4, prompt 16, 4
   generated, the kernels' launches counted, eager and graph tokens bit
   for bit; the logits at the last prompt
   position against the batched HT prefill's with every capacity lifted,
   within ``SERVE_PLAIN_TOL`` of their largest; then one prefill, one
   decode step, and one decode step replayed from its CUDA graph under
   torch.profiler (device busy share, device time by kind, the device
   activities and host operators that take the most time), and one decode
   step on the fp8 wire replayed from its own graph;
5. moe_served: HT at the served shape (1024 tokens), on the MoE inputs
   one prefill recorded: per-layer drops, and for layer 0 and the layer
   that drops most, the output at the configured capacity against the
   dense oracle restricted to the choices the plan keeps
   (``restricted_check``: a dropped (token, rank) entry weighs 0 for all
   its choices, a choice past its expert's capacity alone; the plan's
   dropped count must be HT's), and with every capacity lifted against the
   dense oracle with no choice dropped; then
   ht_unfused: layer 0's input through ``dispatch_combine_ht`` with a
   plain ``fn(tokens, counts)`` (no ``.fused``), once under
   ``REPRO_SWIGLU_DB=1`` (``grouped_swiglu_db`` launches) and once without
   (it does not), against the fused path (drops equal, outputs within
   ``gather_swiglu_scatter``'s tolerance plus one bf16 ulp), and
   ``ops.grouped_matmul`` (``x @ w_gate``) driven on the gathered buffer;
   then combine_reduce: ``ops.combine_reduce`` of layer 0's 1024 tokens x
   4 expert outputs (bf16) with the router's weights (fp32) against the
   dense oracle; the launch counts of the three kernels are set to 0 just
   before and read just after each driven call, and must be > 0;
6. kernel (EP): each EP kernel, on the inputs of the first call of each
   kind (shapes) it had in the serving path -- for the wire kernels, the
   HT prefill and the LL decode dispatch -- against its plain PyTorch
   version: gather_quantize and dequantize bit for bit, grouped_swiglu and
   gather_swiglu_scatter within a stated tolerance; with CUDA-event times
   (median of 20 after 3 warm-ups) of the kernel and the plain version,
   the kernel's device time from the profiler (``device_ms``: without the
   host's time to issue the call), and the bound the card's peak rates set
   for the same work; then the norm and attention kernels on this path's
   recorded inputs (MHA prefill; decoding with one query head a kv head),
   as in phase 12;
7. moe_layer: the routed part of ``moe_apply`` (the shared expert, which
   bypasses EP, left out) at full width (256 tokens) against the port's
   dense oracle ``moe_ref`` for LL/HT, one-level P=4 and two-level (2, 2),
   fp32/fp8/int8 wires, with no dropped tokens;
8. train (the training path): the serving model is freed, then
   falcon-mamba-7b at full width (d_model 4096, d_inner 8192, vocab
   65,024) and 16 of its 64 layers (the depth the card's memory allows
   for fp32 AdamW state), random fp32 weights from a seed, takes 5 AdamW
   steps (peak lr 3e-4, warm-up 1) on batch 4 x 1024 synthetic tokens
   through ``repro_torch.training.train_loop``.  Per step: loss, grad norm
   and seconds; tokens/s over steps 2-5; peak device memory; the launch
   counts of ``mamba_scan`` and ``mamba_scan_bwd`` (set to 0 just before,
   read just after, both > 0).  Every loss and grad norm must be finite,
   and the last loss below the first;
9. train_profile: one more step under torch.profiler, and the time of
   one AdamW update of every parameter;
10. kernel (scan): ``mamba_scan`` on the inputs of its first call of each
   kind in the train phase against the plain version (y, and the states
   it saves at every chunk boundary), and ``mamba_scan_bwd`` on the same
   inputs with a seeded dy against ``torch.autograd.grad`` through the
   plain version, all six gradients; both timed (CUDA events and device
   time) beside their bound (the forward's counting the states it saves,
   as every training call does) and the plain version's time;
11. serve-qwen3 (the dense GQA serving path): qwen3-4b at full width and
   all 36 layers (random bf16 weights from seed 0) served through
   ``generate``: batch 4, prompts of 2048 random tokens, 32 greedy tokens.
   Prefill and decode run their norms and attention through the RMSNorm,
   flash attention and flash decoding kernels, whose launch counts are set
   to 0 just before and read just after (all > 0); TTFT, decode tokens/s
   (the step replayed from a CUDA graph), peak memory.  Then
   serve_qwen3_eager_vs_graph: decode tokens/s through the eager step, and
   the tokens of both paths from one prefill, bit for bit.  Then
   serve_qwen3_plain: one prefill and one decode step
   of 4 x 256 tokens through the kernels against the same through their
   plain versions (logits within ``SERVE_PLAIN_TOL`` of their largest), and
   serve_qwen3_profile: one prefill, one decode step and one replayed
   decode step under the profiler;
12. kernel (norm and attention): ``rmsnorm`` on each kind of call the path
   made (d_model and head-dim rows, prefill and decode), ``flash_attention``
   on the prefill's and at serve-fp32's prefill shape (batch 4 x 256, 16
   MHA heads), ``decode_attention`` on the first decode call's, the last
   step's (pos 2078), and the last step's inputs at pos 0 and S - 1
   (``pos`` a 0-d int32 on the card), against
   their plain versions row by row (each output row within its tolerance
   of that row's largest plain value), timed beside their bound, the plain
   version and one PyTorch library call computing the same function
   (``library_ms``, and its device time; for ``rmsnorm``,
   ``flash_attention``, ``decode_attention``, ``combine_reduce`` and
   ``decode_attention_paged`` also cold (the library call's where there is one), each call on one of
   ``COLD_CACHES`` input sets, ``cold_device_ms``); then
   decode_graph: the
   ``decode_attention`` kernel captured once in a CUDA graph and replayed
   at pos 0, the last step's and S - 1, against the plain version; then
   paged_decode: the last decode step's query and
   last layer's cache copied into block pools whose tables a
   ``KVBlockPool`` makes (ragged positions 2078, 2047, 1031, 17; 16-token
   blocks; unread rows NaN), through ``ops.decode_attention_paged``
   (launches counted as above); the paged kernel captured once in a CUDA
   graph there and replayed with the tables' rows reordered and other
   positions written in place, and back, against the plain version; and
   at one position for all four against the contiguous kernel.
   ``grouped_swiglu_db``, ``grouped_matmul``, ``combine_reduce`` and
   ``decode_attention_paged`` are checked and timed as the kernels of
   phase 6, on the inputs of phases 5 and 12; ``rmsnorm`` also on the
   4 x 4096 decode rows phase 13 recorded;
13. serve-falcon-mamba (serving a Mamba model; runs after phase 7, before
   phase 11): falcon-mamba-7b at full width (d_model 4096, d_inner 8192,
   dt_rank 256, d_state 16, d_conv 4, vocab 65,024) and all 64 layers,
   random bf16 weights from seed 0, served through ``generate``: batch 4,
   a prompt of 64 random tokens through 63 decode steps replayed from the
   captured graph, 32 greedy tokens.  ``rmsnorm``'s launches are set to 0
   just before and read just after (> 0); prompt steps/s, decode tokens/s,
   ``capture_s``, peak memory, and the bytes a step must move beside the
   step's time.  The same through the eager step: its decode tokens/s,
   and the tokens of both paths bit for bit (``eager_vs_graph``: the
   graph's prompt runs after its capture's warm-up steps, so this fails
   unless the capture leaves the cache as ``init_cache`` made it).  Then
   serve_falcon_mamba_plain:
   every prompt step's logits through the kernel against the plain
   version's, within ``SERVE_PLAIN_TOL``; and one decode step eager and
   replayed under the profiler;
14. serve-jamba-reduced: the jamba hybrid at its published widths, cut
   to its first 5 layers (``JAMBA_LAYERS``; attention, Mamba and MoE
   layers, each with its own cache), over an EP world of 4, on the fp32
   and the fp8 wire: batch 4,
   a prompt of 16 through replayed decode steps, 8 greedy tokens, each
   run's kernels' launches counted (``JAMBA_KERNELS``: the fp8 run all
   five), eager and replayed bit for bit, the logits through the kernels
   against the plain versions (the plain run taking the kernel run's MoE
   routing choices), one decode step profiled, and the five kernels on
   the fp8 run's recorded inputs against their plain versions;
15. serve_backward_launches: the launches of the four EP backward kernels
   over all the serving phases above, which must be 0 (serving calls the
   forward wrappers under inference mode, never an autograd Function);
16. train-qwen2moe-ep (expert-parallel training; after phase 10, the
   falcon model freed): qwen2-moe-a2.7b at full width (d_model 2048, 60
   experts padded to 64, top-4, d_expert 1408, shared SwiGLU 5632, vocab
   151,936) and 4 of its 24 layers (fp32 AdamW state), random fp32 weights
   from a seed, over a rank-stacked EP world of 4 (``--mesh local``), HT on
   the fp32 wire at capacity factor 2.0: 5 AdamW steps (peak lr 3e-4,
   warm-up 1) on batch 4 x 1024 synthetic tokens through ``train_loop``.
   Per step: loss, grad norm, the dropped fraction and seconds; tokens/s
   over steps 2-5; peak device memory; the launch counts of the EP kernels
   and their backward kernels, set to 0 just before and read just after
   (``gather_swiglu_scatter`` and its backward > 0).  Then, on the same
   state, 2 steps with LL (``grouped_swiglu`` and its backward launch) and
   2 HT steps on the fp8 wire (``gather_quantize``, ``dequantize`` and
   both wire backwards launch), each counted the same way.  Every loss and
   grad norm finite, the 5 HT steps' last loss below the first.  Then
   train_qwen2moe_ep_profile: one HT step under the profiler, and one AdamW
   update of every parameter timed;
17. kernel (EP backward): each of the four backward kernels on the inputs
   of its first call of each kind in phase 16, against its plain backward
   (``KERNEL_TOL``) and timed as the kernels of phase 6 (the two SwiGLU
   backwards also by pass, ``pass_device_ms``, as the profiled HT step's
   ``ep_backward_passes``), and against
   ``torch.autograd.grad`` through the plain forward on the same inputs
   in fp32 (``autograd_rel_err``, within the same tolerance); then each
   of the four EP forwards on the inputs of its first call of each kind in
   phase 16 (the training shapes), against its plain version within its
   ``KERNEL_TOL`` and timed, the cases joining its entry of phase 6.

18. serve-dense-wide (after phase 12, before phase 15): the four dense
   configs no earlier phase serves (``DENSE_WIDE``), one at a time, each
   freed before the next, at full width with random bf16 weights from
   seed 0 through ``generate``: batch 4, 1024-token prompts through the
   batched prefill, 16 tokens from the replayed decode step.
   phi3-medium-14b (40 layers; 40 query heads over 10 kv heads),
   internvl2-26b (48 layers; 48 over 8: 6 a kv head) and musicgen-large
   (48 layers; 32 heads, MHA, head dim 64) at all their layers,
   qwen2-72b (q/k/v biases, 64 over 8) at 32 of its 80 (``DENSE_LAYERS``:
   the whole model is 145 GB in bf16).  Per model: params, TTFT, decode
   tokens/s replayed and eager (their tokens bit for bit), ``capture_s``,
   the RMSNorm, flash attention and flash decoding launches (set to 0
   just before and read just after, each > 0), peak memory; the last
   prefill logits and one decode step on 4 x 256 tokens against the
   plain versions (``SERVE_PLAIN_TOL``); the recorded calls of the three
   kernels (and the last decode step's) against their plain versions
   and timed as in phase 12, joining their entries of the kernels line as
   cases of the model's path (``path_cases``); for musicgen and
   internvl2, ``paged_decode`` on the last decode step's cache at ragged
   positions (1038, 1023, 515, 17), the same way.  The phase's seconds;
19. train-musicgen-prefix (after phase 15, before phase 8): musicgen-large
   at full width and 12 of its 48 layers, fp32 parameters, 5 AdamW steps
   through ``train_loop`` on one seeded batch of 4 sequences, each its 64
   frontend-prefix embeddings before 960 text tokens: per step loss,
   grad norm and seconds, text tokens/s and positions/s over steps 2-5,
   peak memory; the serving kernels launch 0 times (training keeps its
   norms and attention in tensor code); losses and grad norms finite, the
   last loss below the first;
20. serve-rdma (last, after phase 17's kernel checks): qwen2-moe-a2.7b at
   full width and all 24 layers, random bf16 weights from seed 0, served
   through ``generate`` with ``moe.ep_backend = "simulated_rdma"`` over
   an EP world of 4: every MoE layer's dispatch and combine on the host
   transport substrate (FIFO rings, CPU proxies, the SRD network model),
   its experts through the ``grouped_swiglu`` kernel.  Batch 4, a 64-token
   prompt through the batched HT prefill, 8 greedy tokens through eager
   LL decode steps (a host backend cannot run inside a captured graph) on
   the fp32 wire, then 4 on the fp8 wire.  The launches of
   ``RDMA_KERNELS`` (> 0) and ``RDMA_IDLE_KERNELS`` (exactly 0), set to 0
   just before and read just after; TTFT, eager decode tokens/s, each MoE
   layer's host seconds beside its expert kernel's device ms, peak memory
   and the process's peak RSS.  Layer 0's MoE output through the substrate
   (HT and LL, fp32 and fp8 wires) against the dense oracle within
   ``MOE_TOL``; the last prefill logits against the collectives' HT
   prefill with every capacity lifted, on the substrate run's routing
   choices (``pinned_prefill``: bf16 near-ties), within
   ``SERVE_PLAIN_TOL`` (and, reported, without the pin); the
   substrate's counters (commands, messages, wire bytes, drains, clock)
   on layer 0's routing through the CPU world and the card run's, equal;
   and the substrate's first LL (bucketed counts) and HT (flat counts)
   grouped_swiglu calls against the plain version, timed, joining that
   kernel's entry as cases of this path; the phase's seconds.

Then the kernels line ``{"kernels": [...]}`` (all seventeen kernels), the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check raises and the exit code is not 0.  Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
# the L2 (50 MB): repeated calls on one input may find this much of it there
L2_BYTES = 50 * 2 ** 20
# input sets a cold timing cycles through (cold_device_ms), and the
# arguments it draws afresh for each: the cache, the rows, the parts, the
# pools, q, k and v
COLD_CACHES = 8
COLD_ARGS = {"decode_attention": (1, 2), "rmsnorm": (0,),
             "combine_reduce": (0,), "decode_attention_paged": (1, 2),
             "flash_attention": (0, 1, 2)}

KERNEL_INFO = {  # name: (source, the TPU kernel it replaces)
    "grouped_swiglu": ("src/repro_torch/csrc/grouped_swiglu.cu",
                       "src/repro/kernels/grouped_matmul.py:179"),
    "gather_swiglu_scatter": ("src/repro_torch/csrc/gather_swiglu_scatter.cu",
                              "src/repro/kernels/grouped_matmul.py:368"),
    "gather_quantize": ("src/repro_torch/csrc/gather_quantize.cu",
                        "src/repro/kernels/quantize_pack.py:105"),
    "dequantize": ("src/repro_torch/csrc/dequantize.cu",
                   "src/repro/kernels/quantize_pack.py:161"),
    # the TPU package has no backward kernel: it differentiates the oracle
    # of the kernel below, which mamba_scan_bwd replaces on the card
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:53"),
    "mamba_scan_bwd": ("src/repro_torch/csrc/mamba_scan.cu",
                       "src/repro/kernels/mamba_scan.py:53"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:67"),
    "grouped_swiglu_db": ("src/repro_torch/csrc/grouped_swiglu_db.cu",
                          "src/repro/kernels/grouped_matmul.py:269"),
    "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul.py:105"),
    "combine_reduce": ("src/repro_torch/csrc/combine_reduce.cu",
                       "src/repro/kernels/combine_reduce.py:22"),
    "decode_attention_paged": ("src/repro_torch/csrc/decode_attention_paged.cu",
                               "src/repro/kernels/decode_attention.py:149"),
    # the TPU package has no backward kernels: its training differentiates
    # the oracles of the kernels below, which these replace on the card
    "grouped_swiglu_bwd": ("src/repro_torch/csrc/swiglu_bwd.cu",
                           "src/repro/kernels/grouped_matmul.py:179"),
    "gather_swiglu_scatter_bwd": ("src/repro_torch/csrc/swiglu_bwd.cu",
                                  "src/repro/kernels/grouped_matmul.py:368"),
    "gather_quantize_bwd": ("src/repro_torch/csrc/wire_bwd.cu",
                            "src/repro/kernels/quantize_pack.py:105"),
    "dequantize_bwd": ("src/repro_torch/csrc/wire_bwd.cu",
                       "src/repro/kernels/quantize_pack.py:161"),
}
EP_BWD_KERNELS = ("gather_swiglu_scatter_bwd", "grouped_swiglu_bwd",
                  "gather_quantize_bwd", "dequantize_bwd")
EP_KERNELS = ("grouped_swiglu", "gather_swiglu_scatter", "gather_quantize",
              "dequantize")
NORM_ATTN_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# max |kernel - plain| allowed, as a fraction of max |plain| (None: bitwise);
# for ROW_KERNELS, of each output row's own max |plain|
KERNEL_TOL = {
    # h and y round to bf16 (2^-8 relative each) on both sides, after fp32
    # sums taken in another order, so a rounding may land one ulp apart
    "grouped_swiglu": 1e-2,
    # h rounds to bf16 on both sides; the fp32 atomics add in any order
    "gather_swiglu_scatter": 5e-3,
    "gather_quantize": None,
    "dequantize": None,
    # fp32 on both sides (y, and the chunk states it saves); ex2.approx and
    # FMA contraction differ from torch's exp and separate roundings by
    # ulps, which the decaying recurrence carries
    "mamba_scan": 1e-5,
    # per gradient: dA, dB, dC and dD are sums over thousands of terms
    # (time and batch, or channels) added with fp32 atomics in any order
    "mamba_scan_bwd": 1e-4,
    # the same fp32 value up to summation order and rsqrtf, rounded once to
    # bf16: at most one bf16 ulp (2^-7 of a value) apart
    "rmsnorm": 2.0 ** -7,
    # the reference's bf16 tolerance for its attention kernels
    # (tests/test_kernels.py:235-236): P rounds to bf16 against a running
    # max that differs between the two, sums in another order
    "flash_attention": 2e-2,
    "decode_attention": 2e-2,
    # as grouped_swiglu: fp32 sums in another order, bf16 roundings
    "grouped_swiglu_db": 1e-2,
    "grouped_matmul": 1e-2,
    # "ulp": each element within one ulp of the output dtype at the plain
    # value (both sum in fp32 in k order, products and sums rounded apart,
    # so they agree bit for bit; one rounding of the output may differ)
    "combine_reduce": "ulp",
    "decode_attention_paged": 2e-2,
    # per gradient: the same bf16 roundings as the plain backward (h, dy,
    # dg, du) after fp32 sums in another order, dx's atomics in any order;
    # against autograd through the plain forward in fp32 (no bf16 rounding
    # of h, dh, dg or du), the same limit
    "grouped_swiglu_bwd": 1e-2,
    "gather_swiglu_scatter_bwd": 1e-2,
    # fp32 sums of 128 products in another order
    "dequantize_bwd": 1e-5,
    # the same values at the same absmax elements; fp32 atomics add a row's
    # slots in any order
    "gather_quantize_bwd": 1e-5,
}
# kernels held row by row (a normed row; one query's head): a causal row
# averages the values of every key it sees, so its magnitude falls with
# its position, and a limit taken from the largest row (row 0 is v[0])
# would let a late row's error be as large as the row itself
ROW_KERNELS = NORM_ATTN_KERNELS + ("decode_attention_paged",)
# exponentials run on the special-function units: 16 per SM per clock,
# 132 SMs, 1.98 GHz boost (H100 SXM); one accurate expf is at least one
SFU_OP_PER_S = 16 * 132 * 1.98e9
# the scan's fp32 operations per (b, t, d, n): forward dt*A, dt*B*x (2),
# the state FMA (2) and the output FMA (2); backward the forward's 7 to
# recompute h, and 19 to carry dh and form the five gradient terms and
# their sums.  Exponentials per (b, t, d, n): forward 1, backward 2
SCAN_FWD_OPS, SCAN_BWD_OPS = 7, 26
SCAN_FWD_EXPS, SCAN_BWD_EXPS = 1, 2
# the training path: 16 of falcon-mamba-7b's 64 layers at full width (the
# depth whose fp32 AdamW state fits the card), batch 4 x 1024, 5 steps
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 4, 1024, 5
# moe_apply vs the dense oracle, max error over max |oracle|: the fp32
# wire keeps bf16 activations (h, the LL expert output and the combined
# output each round to bf16); fp8/int8 as the reference's DESIGN.md §14
MOE_TOL = {"fp32": 2e-2, "fp8": 0.2, "int8": 0.05}
# the dense GQA serving path: qwen3-4b, batch 4, prompts of 2048, 32 tokens
QWEN3_BATCH, QWEN3_PROMPT, QWEN3_GEN = 4, 2048, 32
# qwen3-4b's logits through the kernels against through their plain
# versions, max error over max |plain|: each kernel agrees to a bf16
# rounding, and 36 layers of bf16 carry such differences to the logits
# (0.020 measured on an H100, the same in every run: no kernel on the path
# adds in a varying order); twice that, where a typical |logit| is a sixth
# of the largest
SERVE_PLAIN_TOL = 0.04
# serving qwen2-moe as the reference's ``serve --mesh local`` does: the
# prompt through decode steps over the EP world
SERVE_LOCAL_PROMPT, SERVE_LOCAL_GEN = 16, 4
# serving falcon-mamba-7b at full width and all 64 layers: batch 4, a
# prompt of 64 tokens through 63 replayed decode steps, 32 greedy tokens
FALCON_BATCH, FALCON_PROMPT, FALCON_GEN = 4, 64, 32
# the jamba hybrid at its published widths (d_model 8192, 64 query heads
# on 8 kv heads of 128, d_inner 16384, dt_rank 512, d_ff and d_expert
# 24,576, all 16 experts top-2, the vocab of 65,536), cut in depth only:
# its first 5 of 72 layers in the published order (Mamba + MLP, Mamba +
# MoE, twice, then attention + MLP at attn_offset 4), the fewest that hold
# an attention layer.  A whole period of 8 does not fit: its four MoE
# layers alone are 77 GB in bf16; these 5 hold two (38.6 GB of 48.1 GB).
# Over an EP world of 4 on the card (--mesh local): 4 experts a rank
JAMBA_LAYERS = 5
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = 4, 16, 8
JAMBA_KERNELS = ("rmsnorm", "decode_attention", "grouped_swiglu",
                 "gather_quantize", "dequantize")
# moonshot-v1-16b-a3b at full width and all 48 layers (28.06B parameters,
# 56.1 GB in bf16: the card holds it whole), served as serve-fp32 serves
# qwen2-moe: an EP world of 4 (16 experts a rank), batch 4, 256-token
# prompts through the batched HT prefill, 16 greedy tokens from the
# replayed decode step, fp32 wire; the plain check over the first 16
# prompt positions' decode steps; placements of its 64 experts over 80
# physical slots (greedy on the served load) and 128 (2 replicas each)
MOONSHOT_BATCH, MOONSHOT_PROMPT, MOONSHOT_GEN = 4, 256, 16
MOONSHOT_PLAIN_STEPS = 16
MOONSHOT_PHYSICAL = 80
MOONSHOT_KERNELS = ("gather_swiglu_scatter", "grouped_swiglu",
                    "flash_attention", "decode_attention", "rmsnorm")
# expert-parallel training: qwen2-moe at full width (d_model 2048, 60
# experts padded to 64, top-4, d_expert 1408, shared 5632, vocab 151,936),
# 4 of its 24 layers (the depth whose fp32 AdamW state fits the card), over
# a rank-stacked EP world of 4, HT on the fp32 wire, capacity factor 2.0;
# batch 4 x 1024, 5 AdamW steps; then 2 steps each with LL and on the fp8
# wire
EP_TRAIN_LAYERS, EP_TRAIN_BATCH, EP_TRAIN_SEQ, EP_TRAIN_STEPS = 4, 4, 1024, 5
EP_TRAIN_MORE_STEPS = 2
# paged decoding at qwen3-4b's decode shape: ragged per-sequence positions
# and 16-token blocks; a CUDA graph captured there is replayed with the
# table rows in PAGED_REPLAY_ORDER and these positions, each at most that
# of the sequence whose rows it takes over
PAGED_POS, PAGED_BLOCK = (2078, 2047, 1031, 17), 16
PAGED_REPLAY_POS, PAGED_REPLAY_ORDER = (12, 931, 2040, 1999), (3, 2, 1, 0)
# serving the four dense configs the earlier slices left out, one at a
# time, at full width: batch 4, 1024-token prompts through the batched
# prefill, 16 tokens from the replayed decode step.  All layers but
# qwen2-72b's: its 80 (72.7B parameters, 145 GB in bf16) do not fit the
# card, its first 32 (30.6B, 61.2 GB) leave room for the cache and the
# plain check.  The plain check runs on the first 256 prompt tokens
DENSE_WIDE = ("phi3_medium_14b", "qwen2_72b", "internvl2_26b",
              "musicgen_large")
DENSE_LAYERS = {"qwen2_72b": 32}
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 1024, 16
DENSE_PLAIN_TOKENS = 256
# paged decoding on the last cache of the two models whose decode shapes
# are new to it: musicgen-large's (head dim 64, MHA) and internvl2-26b's
# (6 query heads a kv head); the last step's pos is 1038
DENSE_PAGED = ("musicgen_large", "internvl2_26b")
DENSE_PAGED_POS, DENSE_PAGED_REPLAY_POS = (1038, 1023, 515, 17), (12, 500,
                                                                  1000, 1030)
# training with a frontend prefix: musicgen-large at full width, 12 of its
# 48 layers, its 64 frame-embedding positions before 960 text positions,
# batch 4, 5 AdamW steps on one batch
PREFIX_TRAIN_LAYERS, PREFIX_TRAIN_BATCH, PREFIX_TRAIN_SEQ = 12, 4, 960
PREFIX_TRAIN_STEPS = 5
# serving qwen2-moe through the host transport substrate (simulated_rdma):
# full width and all 24 layers over an EP world of 4, batch 4, a 64-token
# prompt through the batched HT prefill, 8 greedy tokens through eager LL
# decode steps on the fp32 wire, then 4 on the fp8 wire.  The prompt is
# 64, not serve's 256: the substrate runs every MoE layer's dispatch and
# combine in numpy on the host, and the phase is to stay near a minute
RDMA_BATCH, RDMA_PROMPT, RDMA_GEN, RDMA_GEN_FP8 = 4, 64, 8, 4
# the kernels this path launches (each > 0) and those it must not (each
# exactly 0): the substrate neither fuses the expert gather/scatter nor
# quantizes on the card (its codec encodes on the host)
RDMA_KERNELS = ("grouped_swiglu", "flash_attention", "decode_attention",
                "rmsnorm")
RDMA_IDLE_KERNELS = ("gather_swiglu_scatter", "gather_quantize",
                     "dequantize")
RDMA_PATH = "qwen2_moe_a2_7b simulated_rdma"


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
    keeps a copy of the inputs of the first call of each kind — the tensor
    arguments' shapes, None for any other argument (an absent tensor, a
    position, eps) — so that, e.g., both the HT prefill dispatch and the LL
    decode dispatch (occupied counts, empty slots) of ``gather_quantize``
    are held to the plain version.  A tensor whose storage starts at one
    of ``weights`` (data pointers of the served model's parameters, which
    no step writes) is kept by reference, not copied: one MoE layer's
    experts are 19.3 GB at jamba's widths."""

    def __init__(self, fn, weights=frozenset()):
        self.fn, self.cases, self.weights = fn, {}, weights

    def __call__(self, *args, **kwargs):
        key = (tuple(tuple(a.shape) if hasattr(a, "shape") else None
                     for a in args), tuple(sorted(kwargs.items())))
        if key not in self.cases:
            self.cases[key] = (tuple(
                a if not hasattr(a, "clone") or a.data_ptr() in self.weights
                else a.detach().clone() for a in args), dict(kwargs))
        return self.fn(*args, **kwargs)


def ulp(t):
    """The spacing of ``t``'s dtype (bf16 or fp32) at each |value|, in
    fp32 (the smallest normal's spacing at 0)."""
    import torch
    mant = {torch.float32: 23, torch.bfloat16: 7}[t.dtype]
    _, e = torch.frexp(t.float().abs().clamp_min(torch.finfo(t.dtype).tiny))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 1 - mant)


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


def device_ms(fn, n: int = 10, tries: int = 3, floor_ms: float = 0.0):
    """Device time of one ``fn()`` from ``n`` calls under torch.profiler.
    Where the host takes longer to issue a call than the card to run it,
    CUDA events around the call (``cuda_ms``) read the host; this reads
    the card.

    The profiler can lose device records: late in a long process every
    trace lacks the same few (3, later 7, whatever its length), so a sum
    over the trace reads short.  So each kind of device activity (by name)
    counts ``round(count / n)`` a call, at the mean time of the records
    kept; where records were lost, these must account for every launch,
    copy and fill call the host made (``LAUNCH_CALLS``).  A trace that
    does not, or that reads under ``floor_ms`` (``hbm_floor_ms``: no call
    can be faster), is taken again with twice the calls, up to ``tries``
    times, then reported as None: not measured.  ``device_ms.last`` holds
    each trace's calls, device records, host launches and reading."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    device_ms.last = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        launches = sum(e.name.startswith(LAUNCH_CALLS) for e in prof.events()
                       if e.device_type == DeviceType.CPU)
        kinds = [(e.count, e.self_device_time_total, round(e.count / n))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        ms = sum(m * us / c for c, us, m in kinds) / 1e3
        device_ms.last.append({"calls": n, "records": sum(c for c, _, _ in
                                                          kinds),
                               "launches": launches, "ms": ms})
        whole = all(c == m * n for c, _, m in kinds)
        if (kinds and all(m > 0 for _, _, m in kinds)
                and (whole or n * sum(m for _, _, m in kinds) == launches)
                and ms >= floor_ms):
            return ms
        n *= 2
    return None


device_ms.last = []
# the host's calls that each make one device activity
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def hbm_floor_ms(nbytes: int) -> float:
    """The least time a call that moves ``nbytes`` can take when repeated
    on the same inputs: what does not fit the L2 comes from memory."""
    return max(0, nbytes - L2_BYTES) / HBM_BYTES_PER_S * 1e3


def bound(name: str, args, kwargs) -> tuple[float, str, dict]:
    """Least time the card could take for this call's work: the larger of
    its bytes (each input read once, each output written once, counting
    only the rows this call's counts occupy) over the memory rate and its
    operations over the peak rate for their type."""
    import torch
    if name in NORM_ATTN_KERNELS + ("decode_attention_paged",):
        return norm_attn_bound(name, args, kwargs)
    if name in EP_BWD_KERNELS:
        return ep_bwd_bound(name, args, kwargs)
    if name == "grouped_matmul":
        x, w, counts = args
        G, M, K = x.shape
        N = w.shape[2]
        cnt = (torch.full((G,), M, device=x.device) if counts is None
               else counts.clamp(0, M))
        rows = int(cnt.sum())
        groups = int((cnt > 0).sum())
        # occupied rows and groups' weights read, the whole output written
        nbytes = rows * K * 2 + groups * K * N * 2 + G * M * N * 2 + G * 4
        t_ops = 2.0 * K * N * rows / BF16_FLOP_PER_S
        work = {"occupied_rows": rows, "occupied_groups": groups}
    elif name == "combine_reduce":
        parts, w = args
        T, K, D = parts.shape
        nbytes = (parts.numel() * parts.element_size()
                  + w.numel() * w.element_size() + T * D * parts.element_size())
        t_ops = 2.0 * T * K * D / FP32_FLOP_PER_S
        work = {"tokens": T, "parts": K}
    elif name in ("grouped_swiglu", "grouped_swiglu_db",
                  "gather_swiglu_scatter"):
        if name != "gather_swiglu_scatter":
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
        rows, experts = occupied_rows(counts, G, C, wg.device)
        nbytes = (rows * D * 2 + experts * 3 * D * F * 2 + out_bytes
                  + rows * 8)
        flops = 6.0 * D * F * rows
        t_ops = flops / BF16_FLOP_PER_S
        work = {"occupied_rows": rows, "occupied_experts": experts}
    elif name == "gather_quantize":
        # the table rows the occupied slots name, each read once (a token
        # that fills several slots, as HT's and LL's do, is one read), the
        # indices of the occupied slots and the counts; every slot's bytes
        # and scales written
        x_ext, src, counts = args
        D = x_ext.shape[1]
        n = src.shape[0]
        nb = -(-D // 128)
        rows, table_rows = named_table_rows(x_ext, src, counts)
        nbytes = (table_rows * D * 4 + rows * 4
                  + (0 if counts is None else counts.numel() * 4)
                  + n * D + n * nb * 4)
        t_ops = 4.0 * rows * D / FP32_FLOP_PER_S
        work = {"slots": n, "occupied_slots": rows,
                "table_rows_read": table_rows}
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


def occupied_rows(counts, G: int, C: int, device) -> tuple[int, int]:
    """(occupied rows, groups with one) of G groups of C rows under flat
    (G,) or bucketed (G, B) counts (None: all)."""
    import torch
    cnt = (torch.full((G, 1), C, device=device) if counts is None
           else counts.reshape(G, -1).clamp(max=C // counts.reshape(
               G, -1).shape[1]))
    return int(cnt.sum()), int((cnt.sum(1) > 0).sum())


def named_table_rows(x_ext, src, counts) -> tuple[int, int]:
    """(occupied slots, distinct table rows they name) of a wire gather:
    a token that fills several slots, as HT's and LL's do, is one read."""
    import torch

    from repro_torch.kernels.quantize_pack import _occupied_slots
    occ = _occupied_slots(src, counts)
    return int(occ.sum()), int(torch.unique(src[occ].clamp(
        0, x_ext.shape[0] - 1)).numel())


def ep_bwd_bound(name: str, args, kwargs) -> tuple[float, str, dict]:
    """Least time for one call of an EP backward kernel.  The SwiGLU
    backwards: 16 D F flops an occupied row on the bf16 tensor cores (the
    gate and up products recomputed, 4 D F; dH, dX, dWg, dWu and dWd, 12
    D F), beside the bytes of the occupied rows (token and upstream rows
    read, slot indices and weights), the occupied experts' weights read,
    dX and every expert's weight gradients written.  The wire backwards:
    bytes, as the forwards count them (dequantize_bwd reads q and dy and
    writes a scale a block; gather_quantize_bwd reads the occupied slots'
    scale gradients and the table rows they name, each once, and writes
    the table's gradient), and a few fp32 operations an element."""
    if name in ("grouped_swiglu_bwd", "gather_swiglu_scatter_bwd"):
        if name == "grouped_swiglu_bwd":
            x, wg, wu, wd, counts, dy = args
            G, C, D = x.shape
            row_bytes = 2 * D + dy.element_size() * D
            dx_bytes = x.numel() * x.element_size()
        else:
            x_ext, src, w_slot, wg, wu, wd, counts, dout = args
            D = x_ext.shape[1]
            G = wg.shape[0]
            C = src.shape[0] // G
            row_bytes = 2 * D + 4 * D + 8
            dx_bytes = x_ext.numel() * x_ext.element_size() + src.shape[0] * 4
        E, _, F = wg.shape
        rows, experts = occupied_rows(counts, G, C, wg.device)
        nbytes = (rows * row_bytes + experts * 3 * D * F * 2 + dx_bytes
                  + E * 3 * D * F * 2)
        t_ops = 16.0 * D * F * rows / BF16_FLOP_PER_S
        work = {"occupied_rows": rows, "occupied_experts": experts,
                "flops": 16.0 * D * F * rows}
    elif name == "dequantize_bwd":
        q, scales, dy = args
        nbytes = q.numel() * 5 + scales.numel() * 4
        t_ops = 2.0 * q.numel() / FP32_FLOP_PER_S
        work = {"elements": q.numel()}
    else:
        x_ext, src, counts, d_scales = args
        rows, table_rows = named_table_rows(x_ext, src, counts)
        D = x_ext.shape[1]
        nbytes = (table_rows * D * 4 + rows * (4 + d_scales.shape[1] * 4)
                  + x_ext.numel() * 4)
        t_ops = 3.0 * rows * D / FP32_FLOP_PER_S
        work = {"occupied_slots": rows, "table_rows_read": table_rows}
    t_bytes = nbytes / HBM_BYTES_PER_S
    work.update(bytes=nbytes, bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def decode_live(args, kwargs) -> int:
    """Cache positions a decode_attention call attends: start..pos (an int
    or a 0-d tensor, read here on the host)."""
    k, pos = args[1], int(args[3])
    return min(max(pos - kwargs.get("start", 0) + 1, 0), k.shape[1])


def paged_live(args) -> list:
    """Positions each sequence of a decode_attention_paged call attends:
    those of allocated blocks up to its pos."""
    from repro_torch.kernels.norm_attention import _paged_live
    _, k_pool, _, tables, pos = args
    _, live = _paged_live(tables, pos, k_pool.shape[0], k_pool.shape[1])
    return live.sum(1).tolist()


def norm_attn_bound(name: str, args, kwargs) -> tuple[float, str, dict]:
    """Least time for one RMSNorm / attention call: the larger of its bytes
    (inputs read once, the output written once; for decoding, only the
    live cache rows) over the memory rate and its operations over their
    peak rate (attention: 4 * D FLOP per query-key pair the mask keeps, on
    bf16 tensor cores; RMSNorm: 4 fp32 operations per element)."""
    if name == "rmsnorm":
        x, scale = args[:2]
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        t_ops = 4.0 * x.numel() / FP32_FLOP_PER_S
        work = {"rows": x.numel() // x.shape[-1], "width": x.shape[-1]}
    else:
        q, k, v = args[:3]
        B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
        if name == "flash_attention":
            Sq, Skv = q.shape[1], k.shape[1]
            pairs = (sum(min(i + 1, Skv) for i in range(Sq))
                     if kwargs.get("causal", True) else Sq * Skv)
            kv_rows = B * Skv
        elif name == "decode_attention_paged":
            # live rows summed over the sequences; B * pairs counts each
            # sequence's own
            kv_rows = sum(paged_live(args))
            pairs = kv_rows / B
        else:
            pairs = decode_live(args, kwargs)
            kv_rows = B * pairs
        nbytes = (2 * q.numel() + 2 * kv_rows * k.shape[2] * D) * 2
        t_ops = 4.0 * D * B * H * pairs / BF16_FLOP_PER_S
        work = {"query_key_pairs": B * H * pairs}
        if name == "decode_attention_paged":
            nbytes += args[3].numel() * 4 + args[4].numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    work.update(bytes=nbytes, bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def library_call(name: str, args, kwargs):
    """One PyTorch call computing what kernel ``name`` computes on these
    inputs (the yardstick ``library_ms``; the port never calls it), or
    None.  ``rms_norm`` takes the scale in x's dtype, its fused kernel's
    condition."""
    import torch.nn.functional as F
    if name == "rmsnorm":
        x, scale, eps = args
        w = scale.to(x.dtype)
        return lambda: F.rms_norm(x, (x.shape[-1],), w, eps)
    if name == "flash_attention":
        q, k, v = (a.transpose(1, 2) for a in args)
        causal = kwargs.get("causal", True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    if name == "decode_attention":
        live = decode_live(args, kwargs)
        if live == 0:
            return None
        q = args[0][:, :, None]
        k, v = (a[:, :live].transpose(1, 2) for a in args[1:3])
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True)
    if name == "grouped_matmul":      # the whole buffer, counts ignored
        import torch
        x, w = args[:2]
        return lambda: torch.bmm(x, w)
    if name == "combine_reduce":
        # one batched GEMV; bmm takes one dtype, so the weights are cast to
        # the parts' dtype beforehand (rounded, where they are fp32)
        import torch
        parts, w = args
        wc = w.to(parts.dtype)[:, None, :]
        return lambda: torch.bmm(wc, parts)
    return None


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
    err = rel = 0.0
    for g, r in pairs:
        if tol == "ulp":
            over = (g.float() - r.float()).abs() > ulp(r)
            if over.any():
                raise AssertionError(f"{name}: {int(over.sum())} elements "
                                     "more than one ulp from plain")
        elif tol is None:
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
        if tol in (None, "ulp") or not gf.numel():
            continue
        if name in ROW_KERNELS:
            e_row = (gf - rf).abs().amax(-1)
            scale = rf.abs().amax(-1)
        else:
            e_row, scale = torch.tensor(e), rf.abs().max()
        rel = max(rel, float((e_row / scale.clamp_min(1e-30)).max()))
        bad = e_row > tol * scale
        if bad.any():
            i = int(bad.flatten().nonzero()[0])
            raise AssertionError(
                f"{name}: |err| {float(e_row.flatten()[i])} > {tol} * "
                f"{float(scale.flatten()[i])} in output row {i} of "
                f"{bad.numel()} ({int(bad.sum())} rows over; max |err| {e} "
                f"against max |plain| {float(rf.abs().max())})")
    bound_ms, bound_by, work = bound(name, args, kwargs)
    ms = cuda_ms(lambda: cuda(*args, **kwargs))
    lib = library_call(name, args, kwargs)
    dev_ms = device_ms(lambda: cuda(*args, **kwargs),
                       floor_ms=hbm_floor_ms(work["bytes"]))
    case = {"shapes": [list(a.shape) for a in args if hasattr(a, "shape")],
            "max_abs_err": err, "max_rel_err": rel, "ms": ms,
            "device_ms": dev_ms, "device_traces": device_ms.last,
            "plain_ms": cuda_ms(lambda: plain(*args, **kwargs)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "library_ms": cuda_ms(lib) if lib is not None else None,
            "library_device_ms": device_ms(lib) if lib is not None else None,
            "work": work}
    if name in COLD_ARGS:
        case.update(cold_device_ms(name, args, kwargs))
    return case


def cold_device_ms(name, args, kwargs) -> dict:
    """Kernel ``name`` and its library call on the device, cold: each call
    on the next of ``COLD_CACHES`` sets of the call's large inputs
    (``COLD_ARGS``, seeded N(0, 1) of their shapes), whose sum does not fit
    the card's 50 MB L2: at qwen3's shapes 272 MB of decode caches (a
    decode step's 36 layers do not fit it either), 336 MB of ln1 rows, 175
    MB of paged pools (333 blocks of 16 rows, K and V), 805 MB of prefill
    q, k and v, and at the combine shape 168 MB of parts.  Repeated calls on one input, as
    ``device_ms`` makes them, find part of it in L2."""
    import torch

    from repro_torch.kernels import ops
    cuda = ops.KERNELS[name][0]
    g = torch.Generator(device=args[0].device).manual_seed(3)
    sets = [tuple(torch.randn(a.shape, generator=g, device=a.device,
                              dtype=a.dtype) if i in COLD_ARGS[name] else a
                  for i, a in enumerate(args))
            for _ in range(COLD_CACHES)]
    libs = [library_call(name, a, kwargs) for a in sets]
    kernel = device_ms(lambda: [cuda(*a, **kwargs) for a in sets], n=5)
    library = (device_ms(lambda: [f() for f in libs], n=5)
               if libs[0] is not None else None)
    return {"cold_device_ms": kernel and kernel / COLD_CACHES,
            "library_cold_device_ms": library and library / COLD_CACHES}


def check_kernel(name, rec, launches, extra=(), lead=0) -> dict:
    """Every kind of call the main path made to kernel ``name`` (and the
    ``extra`` (args, kwargs) cases).  Case ``lead`` stands for the kernel
    in the kernels line, with its device times (warm, and for the kernels
    of ``COLD_ARGS`` cold) beside them: an index into the recorded cases,
    then the extra ones (by default the first recorded call), or a key on
    a recorded case's arguments, whose largest case leads."""
    if not rec.cases:
        raise RuntimeError(f"{name}: the main path never called it")
    recorded = list(rec.cases.values())
    cases = [check_case(name, a, kw) for a, kw in [*recorded, *extra]]
    if callable(lead):
        lead = max(range(len(recorded)), key=lambda i: lead(recorded[i][0]))
    src, replaces = KERNEL_INFO[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            **{k: cases[lead][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "device_ms", "library_device_ms",
                                           "cold_device_ms",
                                           "library_cold_device_ms")
               if k in cases[lead]},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "tolerance": KERNEL_TOL[name], "cases": cases}


def add_cases(entry: dict, cases, path=None, launches=None) -> list:
    """Holds kernel ``entry["name"]`` (an entry of the kernels line) also
    on the (args, kwargs) ``cases`` another path recorded: their errors
    join the entry's.  With ``path``, each new case is tagged with it and
    with that path's ``launches`` of the kernel, and the kernels line
    lists it (``path_cases``).  Returns the new cases."""
    import torch
    with torch.inference_mode():
        more = [check_case(entry["name"], a, kw) for a, kw in cases]
    if path is not None:
        for c in more:
            c.update(path=path, launches=launches)
    entry["cases"] += more
    for k in ("max_abs_err", "max_rel_err"):
        entry[k] = max([entry[k], *(c[k] for c in more)])
    return more


# a tagged case's numbers in the kernels line (the phase's kernel lines
# hold the rest)
PATH_CASE_KEYS = ("path", "launches", "ms", "device_ms", "cold_device_ms",
                  "bound_ms", "bound_by", "plain_ms", "library_device_ms",
                  "library_cold_device_ms", "max_abs_err")


def path_cases(entry: dict) -> list:
    """The cases of a kernels-line entry that ``add_cases`` tagged with a
    path: the first argument's shape and their numbers, to 6 significant
    digits."""
    def short(v):
        return float(f"{v:.6g}") if isinstance(v, float) else v
    return [{"shape": c["shapes"][0],
             **{k: short(c[k]) for k in PATH_CASE_KEYS if k in c}}
            for c in entry["cases"] if "path" in c]


# device activities by kind, from their names: (kind, name fragments)
DEVICE_KINDS = (("scan kernels", ("scan_fwd_kernel", "scan_bwd_kernel")),
                # decode_kernel: both decoders' one body, <rep, SliceRows>
                # the contiguous one, <rep, TableRows> the paged one
                ("attention and norm kernels", (
                    "flash_fwd_kernel", "decode_kernel", "rmsnorm_row")),
                ("wire backward kernels", ("gather_quantize_bwd",
                                           "dequantize_bwd")),
                ("wire kernels", ("gather_quantize", "dequantize_kernel")),
                # before the forwards: the backward's passes are the tile
                # loop's too, and their names hold "swiglu_tiles::Args"
                ("EP backward kernels", ("swiglu_bwd::",)),
                ("EP kernels", ("swiglu_tiles",)),
                ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
                ("copies and casts", ("copy", "Memcpy", "Memset")),
                ("reductions", ("reduce", "Reduce", "softmax", "Softmax")),
                ("elementwise", ("elementwise",)))


def device_kind(name: str) -> str:
    for kind, frags in DEVICE_KINDS:
        if any(f in name for f in frags):
            return kind
    return "other"


def bwd_passes(device_by_name: dict) -> dict:
    """The SwiGLU backwards' device time per call by pass, from a profile's
    ``device_by_name`` (``profile_step(..., by_name=True)``) over calls
    that each launch every pass once: each kernel of ``csrc/swiglu_bwd.cu``
    by its name there (``pass<swiglu_bwd::dw_up>`` -> ``dw_up``; the
    prepasses ``gather_rows``, ``compact_rows``), the mean of its records
    (a late trace loses a few; ``device_ms``) and their number."""
    import re
    out = {}
    for name, (ms, n) in device_by_name.items():
        m = re.search(r"swiglu_bwd::(\w+)(?:>|\()", name)
        if m and n:
            d = out.setdefault(m.group(1), {"device_ms": 0.0, "records": 0})
            d["device_ms"] = (d["device_ms"] * d["records"] + ms) / (
                d["records"] + n)
            d["records"] += n
    return out


def profile_step(what: str, step, by_name: bool = False) -> dict:
    """``step()`` once under torch.profiler: the device's busy share of the
    step's wall time (the union of the device activities' intervals: the
    kernels, copies and fills the card ran), the device time by kind of
    activity, the device activities with the most time, and the host
    operators with the most self time (``by_name``: also every device
    activity's time and calls, by name).  Host operators (``aten::mm``,
    ...) also carry the device time of the kernels they launch; only device
    rows count as device time here."""
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
    by_kind: dict = {}
    for us, k, c in dev_rows:
        kind = by_kind.setdefault(device_kind(k), {"device_ms": 0.0,
                                                   "calls": 0})
        kind["device_ms"] += us / 1e3
        kind["calls"] += c
    busy_ms = busy_us / 1e3
    named = ({"device_by_name": {k: [us / 1e3, c] for us, k, c in dev_rows}}
             if by_name else {})
    return {"phase": "profile", "what": what, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if spans else None,
            "device_busy_share": (busy_ms / (wall * 1e3)) if spans else None,
            "device_activities": len(spans),
            "device_ms_by_kind": by_kind,
            "top_device": [{"name": k[:80], "device_ms": us / 1e3,
                            "calls": c} for us, k, c in dev_rows[:8]],
            "top_host_self": [{"name": k[:80], "host_ms": us / 1e3,
                               "calls": c} for us, k, c in host_rows[:8]],
            **named}


def profile_gap(prof, base) -> dict:
    """Where ``prof``'s device time exceeds ``base``'s, two profiles of
    the same step taken ``by_name`` (their by-name rows are dropped): the
    busy time, each kind, and each activity whose time differs by 5 us or
    more, largest first."""
    a, b = prof.pop("device_by_name"), base.pop("device_by_name")
    kinds = set(prof["device_ms_by_kind"]) | set(base["device_ms_by_kind"])
    rows = []
    for name in set(a) | set(b):
        (ms_a, n_a), (ms_b, n_b) = a.get(name, (0.0, 0)), b.get(name, (0.0, 0))
        if abs(ms_a - ms_b) >= 0.005:
            rows.append({"name": name[:120], "kind": device_kind(name),
                         "device_ms": ms_a, "base_device_ms": ms_b,
                         "calls": n_a, "base_calls": n_b})
    rows.sort(key=lambda r: r["base_device_ms"] - r["device_ms"])
    return {"device_busy_ms": prof["device_busy_ms"] - base["device_busy_ms"],
            "device_ms_by_kind": {
                k: prof["device_ms_by_kind"].get(k, {}).get("device_ms", 0.0)
                - base["device_ms_by_kind"].get(k, {}).get("device_ms", 0.0)
                for k in sorted(kinds)},
            "activities": rows}


def profile_serve(cfg, cfg_fp8, params, prompts, dist) -> list:
    """Profiles of one batched HT prefill, one LL decode step, and one LL
    decode step replayed from its CUDA graph, on the fp32 wire; then one
    replayed LL decode step on the fp8 wire (``cfg_fp8``), with where its
    device time exceeds the fp32 one's (``vs_fp32_replayed``)."""
    import torch

    from repro_torch.launch.serve import capture_decode_step
    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape
    tok = prompts[:, -1:]
    out = []
    for c, wire in ((cfg, "fp32"), (cfg_fp8, "fp8")):
        cache = Z.init_cache(c, B, S + 3, dtype=Z.compute_dtype(c),
                             device=prompts.device)
        with torch.inference_mode():
            replay, _ = capture_decode_step(c, params, cache, prompts[:, :1],
                                            dist=dist)
        if wire == "fp32":
            out.append(profile_step("one HT prefill (batch 4 x 256)",
                                    lambda: Z.prefill(c, params, cache,
                                                      prompts, dist=dist)))
            out.append(profile_step("one LL decode step (batch 4)",
                                    lambda: Z.decode_step(c, params, cache,
                                                          tok, S, dist=dist)))
        out.append(profile_step(f"one LL decode step replayed from its CUDA "
                                f"graph (batch 4, {wire} wire)",
                                lambda: replay(tok, S), by_name=True))
        del replay, cache
    out[-1]["vs_fp32_replayed"] = profile_gap(out[-1], out[-2])
    return out


def ht_kept_choices(cfg, dist, p, x):
    """Which routed choices of ``x``'s tokens one-level HT keeps at the
    configured capacity, from the plan's keep masks: a (token, rank group)
    entry the source's dedup'd dispatch drops loses all its choices, and a
    choice that arrives at its expert past the expert's capacity is lost
    alone.  Returns the ranks' tokens (R, T, D), their routing (top_idx,
    top_w) and the (R, T, K) keep mask, and the dropped count per rank as
    ``dispatch_combine_ht`` counts it (entries plus choices)."""
    import torch

    from repro_torch.core import ep
    from repro_torch.core import plan as planlib
    from repro_torch.core.moe import make_ep_spec, to_ranks
    from repro_torch.core.routing import RouterParams, route
    spec = make_ep_spec(cfg, dist, mode="ht", dtype=x.dtype)
    if spec.two_level or spec.chunks != 1:
        raise NotImplementedError("the restricted oracle follows one-level "
                                  "HT in one chunk")
    t = to_ranks(dist, x)
    rout = route(cfg.moe, RouterParams(p["router_w"], p.get("router_b")), t,
                 cfg.moe.n_experts)
    R, T, K = rout.top_idx.shape
    P, eps, cf = spec.degree, spec.experts_per_shard, spec.capacity_factor
    valid = rout.top_idx >= 0
    group = torch.where(valid, rout.top_idx // eps, -1).long()
    C = ep._cap(T * (1.0 - (1.0 - 1.0 / P) ** K), cf, hard_max=T)
    _, entry, rank_tg, keep_tg, d1 = planlib.dedup_entry_table(group, valid,
                                                              P, C)
    g = group.clamp(min=0)
    keep1 = valid & torch.gather(keep_tg, 2, g)
    # the receiving rank's entries: source p's slot c is row p * C + c, and
    # choice k of a token rides in column k of its entry for that group
    src = torch.arange(R, device=x.device)[:, None, None].expand(R, T, K)
    row = src * C + torch.gather(rank_tg, 2, g).long()
    recv = torch.full((P, P * C, K), -1, dtype=torch.int64, device=x.device)
    kk = torch.arange(K, device=x.device).expand(R, T, K)
    recv[g[keep1], row[keep1], kk[keep1]] = (rout.top_idx.long() % eps)[keep1]
    N = P * C
    pl = planlib.make_world_plan(recv, eps, ep._cap(T * K / eps, cf,
                                                    hard_max=N * K))
    keep = keep1.clone()
    keep[keep1] = pl.keep[g[keep1], row[keep1], kk[keep1]]
    return t, rout.top_idx, rout.top_w, keep, d1 + pl.n_dropped


def restricted_oracle(cfg, dist, p, x):
    """The dense oracle ``moe_ref`` over the choices HT keeps at the
    configured capacity (``ht_kept_choices``: a dropped choice weighs 0),
    laid back out as x (B, S, D); and the HT dropped fraction the same plan
    gives."""
    import torch

    from repro_torch.core.ep import moe_ref
    from repro_torch.core.moe import from_ranks
    t, top_idx, top_w, keep, dropped = ht_kept_choices(cfg, dist, p, x)
    R, T, K = top_idx.shape
    w = torch.where(keep, top_w.float(), 0.0)
    y = torch.stack([moe_ref(t[r], top_idx[r], w[r], p["w_gate"],
                             p["w_up"], p["w_down"]) for r in range(R)])
    frac = float((dropped / max(T * K, 1)).float().mean())
    return from_ranks(dist, y, x.shape[0], x.shape[1]), frac


def restricted_check(cfg, dist, p, x) -> dict:
    """HT at the configured capacity (the routed part of ``moe_apply``)
    against :func:`restricted_oracle`: max error over max |oracle|, and
    both dropped fractions, which must agree."""
    from repro_torch.core.moe import moe_apply
    y, aux = moe_apply(cfg, dist, p, x, mode="ht")
    ref, frac = restricted_oracle(cfg, dist, p, x)
    err = float((y.float() - ref.float()).abs().max()) / float(
        ref.float().abs().max())
    return {"rel_err": err, "dropped": float(aux["dropped"]),
            "dropped_by_plan": frac}


def moe_served(cfg, params, prompts, dist) -> tuple[dict, "torch.Tensor"]:
    """HT at the served shape.  One fp32 prefill records every MoE layer's
    input (batch x prompt tokens), its dropped fraction and its routing
    imbalance; returns the phase line and layer 0's recorded input.  Then,
    for layer 0 and the layer that dropped most, the routed part of
    ``moe_apply`` (HT) runs again on that input: at the configured capacity
    factor it must drop what the prefill dropped and match the dense oracle
    restricted to the choices the plan keeps (``restricted_check``), and
    with the capacity factor raised until no choice can drop it must match
    the dense oracle ``moe_ref``."""
    from repro_torch.core.moe import moe_apply
    from repro_torch.models import blocks
    from repro_torch.models import model_zoo as Z

    seen = []

    def record(c, d, p, x, **kw):
        y, aux = moe_apply(c, d, p, x, **kw)
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
        at_cf = restricted_check(cfg, dist, p, x)
        y, aux_all = moe_apply(cfg_all, dist, p, x, mode="ht")
        scale = float(y_ref.float().abs().max())
        err = float((y.float() - y_ref.float()).abs().max()) / scale
        checks.append({"layer": layer, "dropped_at_cf": at_cf["dropped"],
                       "dropped_in_prefill": drops[layer],
                       "dropped_by_plan": at_cf["dropped_by_plan"],
                       "rel_err_at_cf_restricted": at_cf["rel_err"],
                       "dropped_at_cf_all": float(aux_all["dropped"]),
                       "rel_err_at_cf_all": err, "tol": MOE_TOL["fp32"]})
        if at_cf["dropped"] != drops[layer]:
            raise AssertionError(f"layer {layer}: HT dropped "
                                 f"{at_cf['dropped']} on replay, "
                                 f"{drops[layer]} in prefill")
        if (abs(at_cf["dropped_by_plan"] - at_cf["dropped"]) > 1e-6
                or not at_cf["rel_err"] <= MOE_TOL["fp32"]):
            raise AssertionError(f"layer {layer} at the configured capacity:"
                                 f" {at_cf} against the restricted oracle")
        if float(aux_all["dropped"]) != 0.0 or not err <= MOE_TOL["fp32"]:
            raise AssertionError(f"layer {layer} at the served shape: rel "
                                 f"err {err}, dropped {aux_all['dropped']}")
    return {"phase": "moe_served", "tokens": B * S, "mode": "ht",
            "wire": cfg.moe.wire_dtype,
            "capacity_factor": cfg.moe.capacity_factor,
            "capacity_factor_all": cf_all,
            "dropped_per_layer": drops,
            "imbalance_per_layer": [i for _, _, i in seen],
            "checks": checks}, seen[0][0]


def last_prefill_logits(cfg, params, prompts, dist):
    """The logits at the last prompt position two ways over the EP world:
    through one decode step a position (the per-token prefill) and through
    one batched HT prefill with every capacity lifted, so that neither can
    drop a choice; with both ``aux``."""
    import torch

    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape
    cf_all = float(params["blocks"][0]["moe"]["w_gate"].shape[0]
                   / cfg.moe.top_k)
    cfg_all = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf_all))
    with torch.inference_mode():
        cache = Z.init_cache(cfg, B, S, dtype=Z.compute_dtype(cfg),
                             device=prompts.device)
        for t in range(S):
            step, cache, aux = Z.decode_step(cfg, params, cache,
                                             prompts[:, t:t + 1], t,
                                             dist=dist)
        cache = Z.init_cache(cfg, B, S, dtype=Z.compute_dtype(cfg),
                             device=prompts.device)
        batched, _, aux_b = Z.prefill(cfg_all, params, cache, prompts,
                                      dist=dist, moe_mode="ht")
    return step, batched, aux, aux_b


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / float(ref.abs().max())


def serve_local_per_token(cfg, params, prompts, dist) -> dict:
    """``generate`` with its default rule over the EP world (a model axis):
    the prompt runs through decode steps (LL), as the reference serves
    ``--mesh local``; batch 4, prompt 16, 4 generated, the kernels' launch
    counts set to 0 just before and read just after.  The logits at the
    last prompt position against the batched HT prefill's with every
    capacity lifted are reported; in bf16 the two paths round apart (LL
    and HT expert kernels, decode and flash attention), and over 24 layers
    of top-4 routing a rounding can flip a choice, so they are held to
    ``SERVE_PLAIN_TOL`` in fp32 instead (:func:`per_token_fp32`)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate

    B, S, n_gen = prompts.shape[0], SERVE_LOCAL_PROMPT, SERVE_LOCAL_GEN
    short = prompts[:, :S]
    cudas = {n: c for n, (c, _) in ops.KERNELS.items()}
    res, launches = counted(cudas, lambda: generate(cfg, params, short, n_gen,
                                                    dist=dist))
    launches = graph_launches(launches, res)
    for n in ("grouped_swiglu", "rmsnorm", "decode_attention"):
        if launches[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched on the "
                                 "per-token prefill path")
    if res["ttft_s"] is not None or res["batched_prefill"]:
        raise AssertionError("generate took the batched prefill over a "
                             "world with a model axis")
    if (res["tokens"].shape != (B, n_gen)
            or not torch.isfinite(res["logits"]).all()):
        raise AssertionError("serve_local_per_token: wrong shape or "
                             "non-finite logits")
    step, batched, aux, aux_b = last_prefill_logits(cfg, params, short, dist)
    both = eager_vs_graph(cfg, params, short, n_gen, dist,
                          batched_prefill=False)
    return {"phase": "serve_local_per_token", "model": "qwen2_moe_a2_7b",
            "width": "full", "layers": cfg.n_layers, "ep_world": "model=4",
            "batch": B, "prompt": S, "generated": n_gen,
            "total_s": res["total_s"], "tokens_per_s": res["tokens_per_s"],
            "decode_tokens_per_s": res["decode_tokens_per_s"],
            "ttft_s": res["ttft_s"], "prefill_dropped": res["prefill_dropped"],
            "decode_dropped": res["decode_dropped"], "launches": launches,
            "cuda_graph": res["cuda_graph"], "capture_s": res["capture_s"],
            "graph_replays": res["graph_replays"], "eager_vs_graph": both,
            "first_tokens": res["tokens"][0].tolist(),
            "bf16_last_prefill_rel_err": rel_err(step, batched),
            "bf16_argmax_agree": float((step.argmax(-1) == batched.argmax(-1))
                                       .float().mean()),
            "last_step_dropped": float(aux["dropped"]),
            "batched_dropped_at_cf_all": float(aux_b["dropped"])}


def fp32_in_place(tree) -> None:
    """Every floating tensor of a parameter tree to fp32, a leaf at a time,
    handing each level's freed memory back, so that the fp32 model (57 GB
    for qwen2-moe) fits where the bf16 one (28.6 GB) was."""
    import torch
    for k in list(tree.keys() if isinstance(tree, dict)
                  else range(len(tree))):
        v = tree[k]
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and v.dtype != torch.float32:
                tree[k] = v.float()
        else:
            fp32_in_place(v)
        del v
    torch.cuda.empty_cache()


def per_token_fp32(cfg, params, prompts, dist) -> dict:
    """The per-token prefill's last logits against the batched HT
    prefill's with every capacity lifted, at full width and depth in fp32
    through the plain versions (the kernels take bf16 only): the two paths
    compute the same function, so they agree to fp32 roundings, within
    ``SERVE_PLAIN_TOL`` of their largest.  Turns ``params`` into fp32 in
    place: the serving model is not used after it."""
    from repro_torch.kernels import ops
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fp32_in_place(params)
    originals = dict(ops.KERNELS)
    ops.KERNELS.update({n: (p, p) for n, (_, p) in originals.items()})
    try:
        step, batched, aux, aux_b = last_prefill_logits(
            cfg32, params, prompts[:, :SERVE_LOCAL_PROMPT], dist)
    finally:
        ops.KERNELS.update(originals)
    line = {"phase": "serve_local_per_token_fp32", "dtype": "float32",
            "through": "plain versions", "layers": cfg.n_layers,
            "prompt": SERVE_LOCAL_PROMPT,
            "last_prefill_rel_err": rel_err(step, batched),
            "tol": SERVE_PLAIN_TOL,
            "argmax_agree": float((step.argmax(-1) == batched.argmax(-1))
                                  .float().mean()),
            "last_step_dropped": float(aux["dropped"]),
            "batched_dropped_at_cf_all": float(aux_b["dropped"])}
    if (not line["last_prefill_rel_err"] <= SERVE_PLAIN_TOL
            or line["batched_dropped_at_cf_all"] != 0.0
            or line["last_step_dropped"] != 0.0):
        raise AssertionError(f"per-token prefill against batched: {line}")
    return line


def counted(cudas: dict, fn):
    """``fn()`` with the launch counts of the CUDA wrappers ``cudas``
    ({name: wrapper}) set to 0 just before and read just after: (result,
    {name: launches})."""
    for c in cudas.values():
        c.launches = 0
    out = fn()
    return out, {n: c.launches for n, c in cudas.items()}


def record_last_decode(rec, plain) -> list:
    """Stands ``rec``, decode_attention's Recorder, behind a hook that also
    keeps the arguments of the last call, not copied: a list that holds
    ``((q, k, v, pos), kwargs)``.  Under a captured decode step the last
    call Python sees is the capture, whose arguments are the graph's
    buffers: after the last replay they hold the last step's query, the
    last layer's cache and the position.  Nothing writes the cache rows
    that call read after it."""
    from repro_torch.kernels import ops
    last = []

    def hook(*args, **kwargs):
        last[:] = [(args, kwargs)]
        return rec(*args, **kwargs)
    ops.KERNELS["decode_attention"] = (hook, plain)
    return last


def prefill_ln1(B: int, S: int, d_model: int):
    """A ``check_kernel`` lead for rmsnorm: the prefill's (B, S, d_model)
    norms (ln1 first) over the decode step's, which the capture made
    first, and over the (B, S, heads, 128) q/k norms."""
    return lambda a: (tuple(a[0].shape) == (B, S, d_model)) * a[0].numel()


def decode_cases(last, first: int) -> tuple:
    """decode_attention's cases beyond its recorded ones (the capture's
    warm-up at pos 0, on a cache the prefill had not filled): the last
    decode call's inputs at its position, at ``first`` (the first decode
    step's position, the prompt's length: the prefill filled the rows
    before it), at 0 and at S - 1, each position a new 0-d int32 on the
    card."""
    import torch
    (q, k, v, pos), kw = last[0]
    return tuple(((q, k, v, torch.full((), p, dtype=torch.int32,
                                       device=q.device)), kw)
                 for p in (int(pos), first, 0, k.shape[1] - 1))


def graph_launches(launches: dict, *results) -> dict:
    """The launches of a counted window that ran ``generate`` (``results``:
    its returns): each wrapper counts its launch once, where Python calls
    it, so a captured decode step's kernels were counted once at capture;
    every replay launched them again."""
    out = dict(launches)
    for r in results:
        for n, k in (r.get("captured_launches") or {}).items():
            if n in out:
                out[n] += k * (r["graph_replays"] - 1)
    return out


def eager_vs_graph(cfg, params, prompts, n_gen, dist=None,
                   batched_prefill: bool = True) -> dict:
    """The greedy tokens of ``prompts`` through the eager decode step and
    through its captured graph (``serve.capture_decode_step``), which must
    agree bit for bit.  With a batched prefill both decode from one
    prefill, each on its own copy of the cache (the HT prefill's fp32
    atomics add in any order, so two prefills may differ in their last
    bits); without, each path runs the prompt through its own steps, as
    ``generate`` does under a model axis."""
    import torch

    from repro_torch.launch.serve import capture_decode_step
    from repro_torch.models import model_zoo as Z

    B, S = prompts.shape
    max_len = S + n_gen
    dt = Z.compute_dtype(cfg)
    with torch.inference_mode():
        cache_e, cache_g = (Z.init_cache(cfg, B, max_len, dtype=dt,
                                         device=prompts.device)
                            for _ in range(2))
        graph_step, captured = capture_decode_step(cfg, params, cache_g,
                                                   prompts[:, :1], dist=dist)

        def eager_step(tok, t):
            logits, _, aux = Z.decode_step(cfg, params, cache_e, tok, t,
                                           dist=dist)
            return logits, aux
        if batched_prefill:
            logits, _, _ = Z.prefill(cfg, params, cache_e, prompts,
                                     dist=dist, moe_mode="ht")
            for ce, cg in zip(cache_e, cache_g):
                cg["k"].copy_(ce["k"])
                cg["v"].copy_(ce["v"])
            first = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        tokens, last = {}, {}
        for name, step in (("eager", eager_step), ("graph", graph_step)):
            if batched_prefill:
                tok, out, t_start = first, [first], S
            else:
                tok, out, t_start = prompts[:, :1], [], S - 1
                for t in range(S - 1):
                    step(tok, t)
                    tok = prompts[:, t + 1:t + 2]
            for t in range(t_start, max_len - 1):
                logits, _ = step(tok, t)
                tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
                out.append(tok)
            tokens[name], last[name] = torch.cat(out, 1), logits
    torch.cuda.synchronize()
    line = {"tokens": list(tokens["eager"].shape),
            "batched_prefill": batched_prefill,
            "replays": graph_step.replays,
            "captured_launches": {n: k for n, k in captured.items() if k},
            "bit_identical": torch.equal(tokens["eager"], tokens["graph"]),
            "last_logits_bit_identical": torch.equal(last["eager"],
                                                     last["graph"]),
            "first_tokens": tokens["graph"][0].tolist()}
    if not line["bit_identical"]:
        raise AssertionError(f"eager and graph decode differ: "
                             f"{tokens['eager'][0].tolist()} against "
                             f"{tokens['graph'][0].tolist()}")
    return line


def decode_graph_check(q, k, v, positions) -> dict:
    """``decode_attention_cuda`` captured once in a CUDA graph with ``pos``
    in a static buffer and replayed at each of ``positions``, each replay's
    output against the plain version at that position, row by row within
    ``KERNEL_TOL``.  A kernel that left its arrival counters set would not
    merge on the second replay."""
    import torch

    from repro_torch.kernels import norm_attention as na
    pos_s = torch.zeros((), dtype=torch.int32, device=q.device)
    na.decode_attention_cuda(q, k, v, pos_s)          # first launch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s = na.decode_attention_cuda(q, k, v, pos_s)
    tol = KERNEL_TOL["decode_attention"]
    errs = []
    for p in positions:
        pos_s.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        ref = na.decode_attention_plain(q, k, v, p).float()
        e_row = (out_s.float() - ref).abs().amax(-1)
        rel = float((e_row / ref.abs().amax(-1).clamp_min(1e-30)).max())
        errs.append(rel)
        if not torch.isfinite(out_s.float()).all() or not rel <= tol:
            raise AssertionError(f"decode_attention replayed at pos {p}: "
                                 f"row rel err {rel} > {tol}")
    return {"positions": list(positions), "max_row_rel_err": errs,
            "tol": tol}


def recording(names, weights=frozenset()):
    """Recorders standing in for the CUDA wrappers of kernels ``names``
    (keeping ``weights`` by reference), and a function that puts the
    wrappers back."""
    from repro_torch.kernels import ops
    originals = {n: ops.KERNELS[n] for n in names}
    recs = {n: Recorder(c, weights) for n, (c, _) in originals.items()}
    for n, (_, plain) in originals.items():
        ops.KERNELS[n] = (recs[n], plain)
    return recs, lambda: ops.KERNELS.update(originals)


def with_env(var: str, value, fn):
    """``fn()`` with environment variable ``var`` set to ``value`` (None:
    unset), restored after."""
    import os
    old = os.environ.pop(var, None)
    if value is not None:
        os.environ[var] = value
    try:
        return fn()
    finally:
        os.environ.pop(var, None)
        if old is not None:
            os.environ[var] = old


def ht_unfused(cfg, params, x, dist) -> tuple[dict, list]:
    """HT at the served shape (layer 0's recorded MoE input, 1024 tokens
    over the EP world of 4) through a plain ``fn(tokens, counts)`` without
    ``.fused``: once with ``REPRO_SWIGLU_DB=1`` (the double-buffered
    kernel), once without (the grouped kernel), then the fused path.  The
    three must drop the same choices and agree; the first launches
    ``grouped_swiglu_db``, the second does not.  Then ``grouped_matmul``
    (``x @ w_gate``) is driven on the buffer the first run gathered, and
    both kernels are held to their plain versions on it."""
    import torch

    from repro_torch.core.ep import dispatch_combine_ht
    from repro_torch.core.moe import _expert_fn, make_ep_spec
    from repro_torch.core.routing import RouterParams, route
    from repro_torch.kernels import ops

    p = params["blocks"][0]["moe"]
    spec = make_ep_spec(cfg, dist, mode="ht", dtype=x.dtype)
    R = spec.degree
    B, S, D = x.shape
    t = x.reshape(R, B * S // R, D)
    rout = route(cfg.moe, RouterParams(w=p["router_w"],
                                       bias=p.get("router_b")), t,
                 cfg.moe.n_experts)
    fused = _expert_fn(p["w_gate"], p["w_up"], p["w_down"])

    def plain(tokens, counts):
        return fused(tokens, counts)

    def run(fn):
        out = dispatch_combine_ht(spec, t, rout.top_idx, rout.top_w, fn)
        torch.cuda.synchronize()
        return out

    cudas = {n: ops.KERNELS[n][0] for n in ("grouped_swiglu_db",
                                            "grouped_swiglu",
                                            "gather_swiglu_scatter")}
    recs, restore = recording(("grouped_swiglu_db",))
    try:
        res_db, l_db = with_env("REPRO_SWIGLU_DB", "1",
                                lambda: counted(cudas, lambda: run(plain)))
    finally:
        restore()
    res_gs, l_gs = with_env("REPRO_SWIGLU_DB", None,
                            lambda: counted(cudas, lambda: run(plain)))
    res_f, l_f = counted(cudas, lambda: run(fused))
    if not (l_db["grouped_swiglu_db"] > 0 and l_gs["grouped_swiglu_db"] == 0
            and l_gs["grouped_swiglu"] > 0
            and l_f["gather_swiglu_scatter"] > 0):
        raise AssertionError(f"ht_unfused launches: db run {l_db}, plain run "
                             f"{l_gs}, fused run {l_f}")
    ref = res_f.out.float()
    scale = float(ref.abs().max())
    tol = KERNEL_TOL["gather_swiglu_scatter"]
    checks = {}
    for what, res in (("db", res_db), ("grouped", res_gs)):
        if not torch.equal(res.aux["dropped"], res_f.aux["dropped"]):
            raise AssertionError(f"ht_unfused {what}: dropped "
                                 f"{res.aux['dropped'].tolist()}, fused "
                                 f"{res_f.aux['dropped'].tolist()}")
        diff = (res.out.float() - ref).abs()
        # gather_swiglu_scatter's tolerance, and one bf16 ulp of each
        # element: both outputs round to bf16 after fp32 sums that differ
        # by the unfused path's rounding of the expert output to bf16
        over = diff > tol * scale + ulp(res_f.out)
        checks[what] = {"max_abs_err": float(diff.max()),
                        "rel_err": float(diff.max()) / scale,
                        "elements_over": int(over.sum())}
        if over.any() or not torch.isfinite(res.out).all():
            raise AssertionError(f"ht_unfused {what} vs fused: {checks[what]}")
    times = {
        "db_ms": with_env("REPRO_SWIGLU_DB", "1", lambda: cuda_ms(
            lambda: run(plain), n=5, warmup=1)),
        "grouped_ms": cuda_ms(lambda: run(plain), n=5, warmup=1),
        "fused_ms": cuda_ms(lambda: run(fused), n=5, warmup=1)}
    # the grouped GEMM on the buffer the db run gathered: x @ w_gate
    (buf, wg, _, _, counts), _ = next(iter(recs["grouped_swiglu_db"].cases
                                           .values()))
    gm_cuda = {"grouped_matmul": ops.KERNELS["grouped_matmul"][0]}
    gm_recs, restore = recording(("grouped_matmul",))
    try:
        y, l_gm = counted(gm_cuda,
                          lambda: ops.grouped_matmul(buf, wg, counts))
    finally:
        restore()
    if l_gm["grouped_matmul"] <= 0 or not torch.isfinite(y).all():
        raise AssertionError("grouped_matmul was not launched or gave a "
                             "non-finite output")
    launches = {"grouped_swiglu_db": l_db["grouped_swiglu_db"], **l_gm}
    kernels = [check_kernel("grouped_swiglu_db", recs["grouped_swiglu_db"],
                            launches),
               check_kernel("grouped_matmul", gm_recs["grouped_matmul"],
                            launches)]
    line = {"phase": "ht_unfused", "tokens": B * S, "ep_world": R,
            "buffer": list(buf.shape), "occupied_rows": int(counts.sum()),
            "dropped": res_f.aux["dropped"].tolist(),
            "launches": {"db_run": l_db, "grouped_run": l_gs,
                         "fused_run": l_f, "grouped_matmul": l_gm},
            "tol": tol, "tol_plus_ulp": True, "checks": checks, **times}
    return line, kernels


def combine_phase(cfg, params, x, dist) -> tuple[dict, dict]:
    """``ops.combine_reduce`` at the served prefill's combine shape: layer
    0's 1024 tokens, each with its 4 experts' outputs (bf16, computed per
    expert from the weights, h rounded to bf16 as the kernels round it) as
    parts, and the router's weights in fp32.  The combined output must
    match the routed part of the dense oracle ``moe_ref`` within
    ``MOE_TOL["fp32"]``, and the kernel its plain version to one ulp."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.ep import moe_ref
    from repro_torch.core.routing import RouterParams, route
    from repro_torch.kernels import ops

    p = params["blocks"][0]["moe"]
    t = x.reshape(-1, x.shape[-1])
    rout = route(cfg.moe, RouterParams(w=p["router_w"],
                                       bias=p.get("router_b")), t,
                 cfg.moe.n_experts)
    idx, w = rout.top_idx, rout.top_w.to(torch.float32)
    T, K = idx.shape
    parts = torch.zeros((T, K, t.shape[1]), dtype=t.dtype, device=t.device)
    f32 = torch.float32
    for e in range(p["w_gate"].shape[0]):
        ti, ki = (idx == e).nonzero(as_tuple=True)
        if ti.numel():
            xe = t[ti].to(f32)
            h = (F.silu(xe @ p["w_gate"][e].to(f32)) * (
                xe @ p["w_up"][e].to(f32))).to(t.dtype).to(f32)
            parts[ti, ki] = (h @ p["w_down"][e].to(f32)).to(t.dtype)
    cuda = {"combine_reduce": ops.KERNELS["combine_reduce"][0]}
    recs, restore = recording(("combine_reduce",))
    try:
        out, launches = counted(cuda, lambda: ops.combine_reduce(parts, w))
    finally:
        restore()
    if launches["combine_reduce"] <= 0:
        raise AssertionError("combine_reduce was not launched")
    y_ref = moe_ref(t, idx, w, p["w_gate"], p["w_up"], p["w_down"]).float()
    err = float((out.float() - y_ref).abs().max()) / float(
        y_ref.abs().max())
    if out.shape != (T, t.shape[1]) or not err <= MOE_TOL["fp32"]:
        raise AssertionError(f"combine_reduce vs moe_ref: rel err {err}")
    line = {"phase": "combine_reduce", "tokens": T, "parts": K,
            "d_model": t.shape[1], "parts_dtype": str(parts.dtype),
            "weights_dtype": str(w.dtype), "launches": launches,
            "rel_err_vs_moe_ref": err, "tol": MOE_TOL["fp32"]}
    return line, check_kernel("combine_reduce", recs["combine_reduce"],
                              launches)


def scan_bound(name: str, args, save_states: bool = False
               ) -> tuple[float, str, dict]:
    """Least time for one scan call (forward, or backward from the chunk
    states): the larger of its bytes (fp32 inputs read once, outputs
    written once; a forward that saves the chunk states for the backward,
    ``save_states``, as every training call does, writes them too) over
    the memory rate and its operations, each type over its own rate: the
    fp32 arithmetic over the fp32 rate, the exponentials over the SFU rate
    (the two pipes run side by side, so the slower one bounds)."""
    from repro_torch.kernels.mamba_scan import n_chunks
    x, _, A, _, _, _ = args[:6]
    Bt, S, Di = x.shape
    N = A.shape[1]
    elems = Bt * S * Di
    small = Di * N + Di                                   # A, D
    if name == "mamba_scan":
        nbytes = 4 * (3 * elems + 2 * Bt * S * N + small)  # x, dt, y; B, C
        if save_states:
            nbytes += 4 * Bt * n_chunks(S) * Di * N
        ops, exps = SCAN_FWD_OPS * elems * N, SCAN_FWD_EXPS * elems * N
    else:
        nc = args[6].shape[1]
        # x, dt, dy in and dx, ddt out; the chunk states; B, C in and
        # dB, dC out; A, D in and dA, dD out
        nbytes = 4 * (5 * elems + Bt * nc * Di * N + 4 * Bt * S * N
                      + 2 * small)
        ops, exps = SCAN_BWD_OPS * elems * N, SCAN_BWD_EXPS * elems * N
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fp32, t_exp = ops / FP32_FLOP_PER_S, exps / SFU_OP_PER_S
    t_ops = max(t_fp32, t_exp)
    work = {"bytes": nbytes, "bytes_ms": t_bytes * 1e3, "fp32_ops": ops,
            "fp32_ms": t_fp32 * 1e3, "exponentials": exps,
            "exp_ms": t_exp * 1e3}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def check_scan(rec, launches: dict) -> list:
    """``mamba_scan`` and ``mamba_scan_bwd`` on each kind of call the
    training path made to the scan, against the plain version (forward)
    and autograd through it (backward, seeded dy); both timed."""
    import torch

    from repro_torch.kernels import mamba_scan as ms
    if not rec.cases:
        raise RuntimeError("mamba_scan: the training path never called it")
    fwd_cases, bwd_cases = [], []
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    for args, _ in rec.cases.values():
        with torch.no_grad():
            y, states = ms._scan_fwd(*args, save_states=True)
            ref, ref_states = ms.mamba_scan_plain(*args, with_states=True)
        torch.cuda.synchronize()
        # y, and the states saved at every chunk boundary, each against its
        # plain value within the tolerance of its own largest
        errs = {}
        for what, g, r in (("y", y, ref), ("states", states, ref_states)):
            err, scale = float((g - r).abs().max()), float(r.abs().max())
            errs[what] = (err, scale)
            tol = KERNEL_TOL["mamba_scan"]
            if not torch.isfinite(g).all() or err > tol * scale:
                raise AssertionError(f"mamba_scan {what}: max |err| {err} > "
                                     f"{tol} * {scale}")
        err, scale = errs["y"]
        del y, ref, ref_states
        # the timed calls save the states, as every training call does
        bound_ms, bound_by, work = scan_bound("mamba_scan", args,
                                              save_states=True)
        with torch.no_grad():
            fwd_cases.append({
                "max_abs_err": err, "max_abs_ref": scale,
                "states_max_abs_err": errs["states"][0],
                "states_max_abs_ref": errs["states"][1],
                "ms": cuda_ms(lambda: ms._scan_fwd(*args, save_states=True)),
                "device_ms": device_ms(
                    lambda: ms._scan_fwd(*args, save_states=True),
                    floor_ms=hbm_floor_ms(work["bytes"])),
                "device_traces": device_ms.last,
                "plain_ms": cuda_ms(lambda: ms.mamba_scan_plain(*args), n=5,
                                    warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by, "work": work,
                "shape": list(args[0].shape)})
        gen = torch.Generator(device=args[0].device).manual_seed(2)
        dy = torch.randn(args[0].shape, generator=gen, device=args[0].device)
        got = ms.mamba_scan_bwd_cuda(*args, states, dy)
        ins = [a.detach().requires_grad_(True) for a in args]
        y_plain = ms.mamba_scan_plain(*ins)
        ref = torch.autograd.grad(y_plain, ins, dy, retain_graph=True)
        torch.cuda.synchronize()
        per = {}
        for n, g, r in zip(names, got, ref):
            e, sc = float((g - r).abs().max()), float(r.abs().max())
            per[n] = {"max_abs_err": e, "max_abs_ref": sc}
            if not torch.isfinite(g).all() or e > KERNEL_TOL["mamba_scan_bwd"] * sc:
                raise AssertionError(f"mamba_scan_bwd {n}: max |err| {e} > "
                                     f"{KERNEL_TOL['mamba_scan_bwd']} * {sc}")
        del got, ref
        bargs = (*args, states)
        bound_ms, bound_by, work = scan_bound("mamba_scan_bwd", bargs)
        bwd_cases.append({
            "max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "per_gradient": per,
            "ms": cuda_ms(lambda: ms.mamba_scan_bwd_cuda(*args, states, dy)),
            "device_ms": device_ms(
                lambda: ms.mamba_scan_bwd_cuda(*args, states, dy),
                floor_ms=hbm_floor_ms(work["bytes"])),
            "device_traces": device_ms.last,
            # the plain version's backward alone, its graph built once
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(
                y_plain, ins, dy, retain_graph=True), n=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work})
        del y_plain, ins, states, dy
        gc.collect()
        torch.cuda.empty_cache()
    out = []
    for name, cases in (("mamba_scan", fwd_cases), ("mamba_scan_bwd",
                                                    bwd_cases)):
        src, replaces = KERNEL_INFO[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    **{k: cases[0][k] for k in ("ms", "device_ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by")},
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "library_ms": None, "tolerance": KERNEL_TOL[name],
                    "cases": cases})
    return out


def train_setup():
    """The training path's (config, hyper-parameters, batch):
    falcon-mamba-7b at full width and ``TRAIN_LAYERS`` layers,
    ``TRAIN_STEPS`` AdamW steps, one seeded batch of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens (numpy)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.training.train_loop import HParams

    cfg = dataclasses.replace(get_config("falcon_mamba_7b"),
                              n_layers=TRAIN_LAYERS)
    hp = HParams(peak_lr=3e-4, warmup=1, total_steps=TRAIN_STEPS)
    # every step trains on the same batch: a step along the gradients must
    # then lower the loss on the batch they came from, whatever five steps
    # on fresh batches would generalise
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size,
                                   batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                   seed=0), 0)
    return cfg, hp, batch


def train_steps(cfg, hp, batch, state, dev) -> tuple:
    """``hp.total_steps`` steps of ``train_loop`` on ``batch`` from
    ``state``: (state, history, seconds of each step)."""
    from repro_torch.training.train_loop import Watchdog, train_loop
    wd = Watchdog()
    state, hist = train_loop(cfg, hp, None, lambda step: batch,
                             steps=hp.total_steps, state=state, watchdog=wd,
                             log_every=0, device=dev)
    return state, hist, list(wd.history)


def train_phase(dev) -> tuple[list, "Recorder", dict]:
    """The training path (``train_setup``): 5 AdamW steps on batch 4 x 1024
    through ``train_loop``; then one more step under the profiler, and one
    optimizer update timed.  Returns (phase lines, the scan's Recorder,
    launches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import apply_updates, tree_leaves, tree_map
    from repro_torch.training.train_loop import init_state, train_step

    cfg, hp, batch = train_setup()
    B, S, STEPS = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    original = ops.KERNELS["mamba_scan"]
    rec = Recorder(original[0])
    ops.KERNELS["mamba_scan"] = (rec, original[1])
    counters = {"mamba_scan": ms.mamba_scan_cuda,
                "mamba_scan_bwd": ms.mamba_scan_bwd_cuda}
    for c in counters.values():
        c.launches = 0
    try:
        state, hist, secs = train_steps(cfg, hp, batch, state, dev)
        launches = {n: c.launches for n, c in counters.items()}
    finally:
        ops.KERNELS["mamba_scan"] = original
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    for n, k in launches.items():
        if k <= 0:
            raise AssertionError(f"kernel {n} was not launched on the "
                                 "training path")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    lines = [{"phase": "train", "model": "falcon_mamba_7b", "width": "full",
              "d_model": cfg.d_model, "d_inner": 2 * cfg.d_model,
              "vocab": cfg.vocab_size, "layers": cfg.n_layers,
              "layers_published": get_config("falcon_mamba_7b").n_layers,
              "params": n_params, "batch": B, "seq": S, "steps": STEPS,
              "optimizer": "adamw", "peak_lr": hp.peak_lr,
              "warmup": hp.warmup, "remat": cfg.remat,
              "steps_detail": [{"step": i, "loss": l, "grad_norm": g,
                                "seconds": t} for i, (l, g, t) in
                               enumerate(zip(losses, gnorms, secs))],
              "tokens_per_s_steps_2_5": (B * S * (STEPS - 1)
                                         / sum(secs[1:STEPS])),
              "init_params_s": init_s, "peak_mem_gb": peak_gb,
              "launches": launches}]
    holder = [state]

    def step():
        holder[0], _ = train_step(cfg, hp, None, holder[0], batch)

    prof = profile_step(f"one train step (falcon_mamba_7b, {cfg.n_layers} "
                        f"layers, batch {B} x {S})", step)
    prof["phase"] = "train_profile"
    # the optimizer's share of a step: one update of every parameter (zero
    # gradients, lr 0: the same bytes moved as a real update)
    params, opt = holder[0]
    zeros = tree_map(torch.zeros_like, params)
    prof["adamw_update_ms"] = cuda_ms(lambda: apply_updates(
        params, zeros, opt, lr=torch.tensor(0.0)), n=3, warmup=1)
    lines.append(prof)
    return lines, rec, launches


def ep_train_setup():
    """The EP training path's (config, hyper-parameters, batch, EP world):
    qwen2-moe at full width and ``EP_TRAIN_LAYERS`` layers, HT on the fp32
    wire, ``EP_TRAIN_STEPS`` AdamW steps on one seeded batch of
    ``EP_TRAIN_BATCH`` x ``EP_TRAIN_SEQ`` tokens, an EP world of 4."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.training.train_loop import HParams

    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"),
                              n_layers=EP_TRAIN_LAYERS)
    hp = HParams(peak_lr=3e-4, warmup=1, total_steps=EP_TRAIN_STEPS,
                 moe_mode="ht")
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size,
                                   batch=EP_TRAIN_BATCH,
                                   seq_len=EP_TRAIN_SEQ, seed=0), 0)
    return cfg, hp, batch, make_dist_ctx(cfg, model=4)


def train_ep_phase(dev) -> tuple[list, dict, dict]:
    """The expert-parallel training path (``ep_train_setup``): 5 HT steps
    through ``train_loop`` (the fused HT kernel and its backward), then 2
    steps with LL (``grouped_swiglu`` and its backward) and 2 HT steps on
    the fp8 wire (the wire kernels and their backwards) on the same state,
    each run's launch counts set to 0 just before and read just after; one
    more HT step under the profiler, and one AdamW update timed.  The
    first calls of each kind of the four EP kernels and their backward
    kernels are recorded.  Returns (phase lines, their Recorders, their
    launches over the three runs)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import apply_updates, tree_leaves, tree_map
    from repro_torch.training.train_loop import (Watchdog, init_state,
                                                 train_loop, train_step)

    cfg, hp, batch, dist = ep_train_setup()
    B, S, STEPS = EP_TRAIN_BATCH, EP_TRAIN_SEQ, EP_TRAIN_STEPS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    names = EP_KERNELS + EP_BWD_KERNELS
    cudas = {n: ops.KERNELS[n][0] for n in names}
    recs, restore = recording(names)
    runs = {}
    try:
        wd = Watchdog()
        (state, hist), runs["ht"] = counted(cudas, lambda: train_loop(
            cfg, hp, dist, lambda step: batch, steps=STEPS, state=state,
            watchdog=wd, log_every=0, device=dev))
        secs = list(wd.history)
        more = []
        for what, c, h in (
                ("ll", cfg, dataclasses.replace(hp, moe_mode="ll")),
                ("fp8", dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, wire_dtype="fp8")), hp)):
            def steps(c=c, h=h):
                out = []
                for _ in range(EP_TRAIN_MORE_STEPS):
                    t1 = time.perf_counter()
                    holder[0], m = train_step(c, h, dist, holder[0], batch)
                    torch.cuda.synchronize()
                    out.append({"loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"]),
                                "dropped": float(m["dropped"]),
                                "seconds": time.perf_counter() - t1})
                return out
            holder = [state]
            detail, runs[what] = counted(cudas, steps)
            state = holder[0]
            more.append({"run": what, "moe_mode": h.moe_mode,
                         "wire": c.moe.wire_dtype, "steps_detail": detail,
                         "launches": runs[what]})
    finally:
        restore()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    needed = {"ht": ("gather_swiglu_scatter", "gather_swiglu_scatter_bwd"),
              "ll": ("grouped_swiglu", "grouped_swiglu_bwd"),
              "fp8": ("gather_quantize", "dequantize", "gather_quantize_bwd",
                      "dequantize_bwd")}
    for run, ks in needed.items():
        for k in ks:
            if runs[run][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by the "
                                     f"{run} training steps")
    extra = [d for m in more for d in m["steps_detail"]]
    if not all(map(math.isfinite, losses + gnorms
                   + [d[k] for d in extra for k in ("loss", "grad_norm")])):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{gnorms} {extra}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    launches = {k: sum(r[k] for r in runs.values()) for k in names}
    lines = [{"phase": "train-qwen2moe-ep", "model": "qwen2_moe_a2_7b",
              "width": "full", "d_model": cfg.d_model,
              "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
              "d_expert": cfg.moe.d_expert, "d_shared": cfg.moe.d_shared,
              "vocab": cfg.vocab_size, "layers": cfg.n_layers,
              "layers_published": get_config("qwen2_moe_a2_7b").n_layers,
              "params": n_params, "ep_world": "model=4", "moe_mode": "ht",
              "wire": cfg.moe.wire_dtype,
              "capacity_factor": cfg.moe.capacity_factor, "batch": B,
              "seq": S, "steps": STEPS, "optimizer": "adamw",
              "peak_lr": hp.peak_lr, "warmup": hp.warmup, "remat": cfg.remat,
              "steps_detail": [{"step": i, "loss": h["loss"],
                                "grad_norm": h["grad_norm"],
                                "dropped": h["dropped"], "seconds": t}
                               for i, (h, t) in enumerate(zip(hist, secs))],
              "tokens_per_s_steps_2_5": (B * S * (STEPS - 1)
                                         / sum(secs[1:STEPS])),
              "init_params_s": init_s, "peak_mem_gb": peak_gb,
              "launches": runs["ht"]},
             {"phase": "train_qwen2moe_ep_more", "runs": more}]
    holder = [state]
    del state

    def step():
        holder[0], _ = train_step(cfg, hp, dist, holder[0], batch)

    prof = profile_step(f"one HT train step (qwen2_moe_a2_7b, {cfg.n_layers} "
                        f"layers, batch {B} x {S}, EP world 4)", step,
                        by_name=True)
    prof["phase"] = "train_qwen2moe_ep_profile"
    # the HT backward's passes over the step's calls (one a layer)
    prof["ep_backward_passes"] = bwd_passes(prof.pop("device_by_name"))
    params, opt = holder[0]
    zeros = tree_map(torch.zeros_like, params)
    prof["adamw_update_ms"] = cuda_ms(lambda: apply_updates(
        params, zeros, opt, lr=torch.tensor(0.0)), n=3, warmup=1)
    lines.append(prof)
    return lines, recs, launches


def autograd_grads(name: str, args, kwargs) -> tuple:
    """The gradients ``name`` (an EP backward kernel) computes, by
    ``torch.autograd.grad`` through the plain forward on the same inputs,
    in fp32 (for the SwiGLU kernels: the exact gradient of the function,
    where autograd through the bf16 forward would also sum a duplicated
    token's slot gradients in bf16)."""
    import torch

    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import quantize_pack as qp

    def grad(fwd, ins, at, dy):
        ins = [a.detach().float().requires_grad_(True) if i in at else a
               for i, a in enumerate(ins)]
        return torch.autograd.grad(fwd(*ins), [ins[i] for i in at],
                                   dy.float())
    if name == "grouped_swiglu_bwd":
        return grad(gm.grouped_swiglu_plain, args[:5], (0, 1, 2, 3), args[5])
    if name == "gather_swiglu_scatter_bwd":
        return grad(gm.gather_swiglu_scatter_plain, args[:7],
                    (0, 2, 3, 4, 5), args[7])
    if name == "dequantize_bwd":
        return grad(qp.dequantize_plain, args[:2], (1,), args[2])
    return grad(lambda x, s, c: qp.gather_quantize_plain(
        x, s, c, **kwargs)[1], args[:3], (0,), args[3])


def check_ep_bwd(recs: dict, launches: dict) -> list:
    """Each EP backward kernel on every kind of call the training phase
    made, against its plain backward and timed (``check_kernel``), and
    against ``torch.autograd.grad`` through the plain forward
    (``autograd_grads``), each gradient within ``KERNEL_TOL`` of its
    largest."""
    import torch

    from repro_torch.kernels import ops
    out = []
    for name in EP_BWD_KERNELS:
        entry = check_kernel(name, recs[name], launches)
        cuda = ops.KERNELS[name][0]
        if name in ("grouped_swiglu_bwd", "gather_swiglu_scatter_bwd"):
            # the lead (first) call's device time by pass, over 5 calls
            args, kwargs = next(iter(recs[name].cases.values()))
            entry["pass_device_ms"] = bwd_passes(profile_step(
                name, lambda: [cuda(*args, **kwargs) for _ in range(5)],
                by_name=True)["device_by_name"])
        rels = []
        for (args, kwargs), case in zip(recs[name].cases.values(),
                                        entry["cases"]):
            got = cuda(*args, **kwargs)
            got = got if isinstance(got, tuple) else (got,)
            ref = autograd_grads(name, args, kwargs)
            torch.cuda.synchronize()
            per = []
            for g, r in zip(got, ref):
                err = float((g.float() - r).abs().max())
                scale = float(r.abs().max())
                per.append(err / max(scale, 1e-30))
                if not err <= KERNEL_TOL[name] * scale:
                    raise AssertionError(
                        f"{name}: gradient {len(per) - 1} against autograd "
                        f"through the plain forward: |err| {err} > "
                        f"{KERNEL_TOL[name]} * {scale}")
            case["autograd_rel_err"] = per
            rels += per
            del got, ref
        entry["autograd_max_rel_err"] = max(rels)
        out.append(entry)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def paged_pools(k, v, pos, bs):
    """Block pools and tables holding rows 0..pos[b] of the contiguous
    caches k / v (B, S, Hkv, D) for each sequence b: a ``KVBlockPool``
    grows the sequences round-robin, one block each a step, so their blocks
    interleave; sequence 1 is released and grown again (LIFO: its blocks
    come back in the same order); tables end in -1; every pool row no live
    position reads (8 never allocated blocks, the rows past pos in each
    last block) is NaN.  Returns (k_pool, v_pool, tables, pos, pool)."""
    import torch

    from repro_torch.serving.kv_cache import KVBlockPool
    B, _, Hkv, D = k.shape
    n_live = [p + 1 for p in pos]
    pool = KVBlockPool(n_blocks=sum(-(-n // bs) for n in n_live) + 8,
                       block_size=bs)
    for step in range(-(-max(n_live) // bs)):
        for b in range(B):
            if step * bs < n_live[b]:
                pool.grow(b, min((step + 1) * bs, n_live[b]))
    table_1 = pool.block_table(1)
    pool.release(1)
    pool.grow(1, n_live[1])
    pool.assert_consistent()
    if pool.block_table(1) != table_1:
        raise AssertionError("KVBlockPool: a released sequence grown again "
                             "did not get its blocks back in LIFO order")
    nb = max(len(pool.block_table(b)) for b in range(B)) + 2
    tables = pool.block_tables(range(B), width=nb, device=k.device)
    shape = (pool.n_blocks, bs, Hkv, D)
    k_pool = torch.full(shape, float("nan"), dtype=k.dtype, device=k.device)
    v_pool = torch.full_like(k_pool, float("nan"))
    for b in range(B):
        rows = torch.arange(n_live[b], device=k.device)
        blk = tables[b].long()[rows // bs]
        k_pool[blk, rows % bs] = k[b, rows]
        v_pool[blk, rows % bs] = v[b, rows]
    posv = torch.tensor(pos, dtype=torch.int32, device=k.device)
    return k_pool, v_pool, tables, posv, pool


def paged_graph_check(q, k_pool, v_pool, tables, posv,
                      replay_pos=PAGED_REPLAY_POS) -> dict:
    """``decode_attention_paged_cuda`` captured once in a CUDA graph on
    these pools at their positions ``posv``, then replayed twice: with the
    table rows reordered (``PAGED_REPLAY_ORDER``) and ``replay_pos``
    written in place (each at most the position of the sequence whose rows
    it takes over), and back at the captured ones; each replay's output
    against the plain version on what the buffers then hold, row by row
    within ``KERNEL_TOL``."""
    import torch

    from repro_torch.kernels import norm_attention as na
    tab_s, pos_s = tables.clone(), posv.clone()
    na.decode_attention_paged_cuda(q, k_pool, v_pool, tab_s, pos_s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s = na.decode_attention_paged_cuda(q, k_pool, v_pool, tab_s,
                                               pos_s)
    tol = KERNEL_TOL["decode_attention_paged"]
    errs = []
    captured = tuple(posv.tolist())
    for order, pos in ((PAGED_REPLAY_ORDER, replay_pos),
                       (tuple(range(len(captured))), captured)):
        tab_s.copy_(tables[list(order)])
        pos_s.copy_(torch.tensor(pos, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = na.decode_attention_paged_plain(q, k_pool, v_pool, tab_s,
                                              pos_s).float()
        e_row = (out_s.float() - ref).abs().amax(-1)
        rel = float((e_row / ref.abs().amax(-1).clamp_min(1e-30)).max())
        errs.append(rel)
        if not torch.isfinite(out_s.float()).all() or not rel <= tol:
            raise AssertionError(f"decode_attention_paged replayed at pos "
                                 f"{pos}: row rel err {rel} > {tol}")
    return {"replays": [{"table_rows": list(PAGED_REPLAY_ORDER),
                         "pos": list(replay_pos)},
                        {"table_rows": list(range(len(captured))),
                         "pos": list(captured)}],
            "max_row_rel_err": errs, "tol": tol}


def paged_decode(q, k, v, pos=PAGED_POS, replay_pos=PAGED_REPLAY_POS
                 ) -> tuple[dict, "Recorder", dict, tuple]:
    """``ops.decode_attention_paged`` on a decode step's query and last
    layer's cache (qwen3-4b's; serve-dense-wide's), copied into block
    pools (``paged_pools``) at the ragged positions ``pos``; the kernel
    captured in a CUDA graph there and replayed at other positions and
    tables (``paged_graph_check``); then, with every position at the
    largest of ``pos``, against the contiguous ``decode_attention`` kernel
    on the same rows.  Returns (the phase line, the kernel's Recorder, its
    launches, that last call's (args, kwargs))."""
    import torch

    from repro_torch.kernels import norm_attention as na
    from repro_torch.kernels import ops

    k_pool, v_pool, tables, posv, pool = paged_pools(k, v, pos, PAGED_BLOCK)
    cuda = {"decode_attention_paged": ops.KERNELS["decode_attention_paged"][0]}
    recs, restore = recording(("decode_attention_paged",))
    try:
        out, launches = counted(cuda, lambda: ops.decode_attention_paged(
            q, k_pool, v_pool, tables, posv))
    finally:
        restore()
    torch.cuda.synchronize()
    if (launches["decode_attention_paged"] <= 0 or out.shape != q.shape
            or not torch.isfinite(out).all()):
        raise AssertionError("paged_decode: no launch, or a wrong or "
                             "non-finite output")
    graph = paged_graph_check(q, k_pool, v_pool, tables, posv, replay_pos)
    # one pos for all four: the contiguous kernel on the same rows
    pos_all = max(pos)
    same = (q, *paged_pools(k, v, (pos_all,) * len(pos), PAGED_BLOCK)[:4])
    got = na.decode_attention_paged_cuda(*same)
    cont = na.decode_attention_cuda(q, k, v, torch.full(
        (), pos_all, dtype=torch.int32, device=q.device))
    torch.cuda.synchronize()
    e_row = (got.float() - cont.float()).abs().amax(-1)
    rel = float((e_row / cont.float().abs().amax(-1).clamp_min(1e-30)).max())
    if not rel <= KERNEL_TOL["decode_attention_paged"]:
        raise AssertionError(f"paged vs contiguous decoding: row rel err {rel}")
    line = {"phase": "paged_decode", "batch": q.shape[0], "heads": q.shape[1],
            "kv_heads": k.shape[2], "head_dim": q.shape[2],
            "block": PAGED_BLOCK, "pos": list(pos),
            "pool_blocks": pool.n_blocks, "table_width": tables.shape[1],
            "table_heads": tables[:, :4].tolist(), "launches": launches,
            "graph": graph,
            "vs_contiguous": {"pos": pos_all, "max_row_rel_err": rel,
                              "bitwise_equal": bool(torch.equal(got, cont))}}
    return line, recs["decode_attention_paged"], launches, (same, {})


def serve_qwen3(dev) -> list:
    """The dense GQA serving path (phases 11-12): qwen3-4b at full width and
    depth through ``generate``, its kernels' launches counted; the logits
    against the plain versions' on a short input; a profiled prefill and
    decode step; then the three kernels on their recorded inputs.  Returns
    their entries of the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("qwen3_4b")
    B, S, N_GEN = QWEN3_BATCH, QWEN3_PROMPT, QWEN3_GEN
    t0 = time.perf_counter()
    params = Z.init_params(cfg, seed=0, device=dev,
                           dtype=Z.compute_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    # warm-up at the served shape: first launches, library loads, and the
    # allocator's growth to the prefill's activations, which TTFT would
    # otherwise carry
    generate(cfg, params, prompts, 2)
    torch.cuda.synchronize()

    res, launches, recorders, peak_gb, last_decode = serve_counted(
        cfg, params, prompts, N_GEN, NORM_ATTN_KERNELS)
    emit({"phase": "serve-qwen3", "model": "qwen3_4b", "width": "full",
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "params": n_params, "batch": B, "prompt": S, "generated": N_GEN,
          "ttft_s": res["ttft_s"], "total_s": res["total_s"],
          "tokens_per_s": res["tokens_per_s"],
          "decode_tokens_per_s": res["decode_tokens_per_s"],
          "cuda_graph": res["cuda_graph"], "capture_s": res["capture_s"],
          "graph_replays": res["graph_replays"],
          "launches": launches, "first_tokens": res["tokens"][0].tolist(),
          "init_params_s": init_s, "peak_mem_gb": peak_gb})
    eager = generate(cfg, params, prompts, N_GEN, cuda_graph=False)
    emit({"phase": "serve_qwen3_eager_vs_graph",
          "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
          "eager_ttft_s": eager["ttft_s"],
          "graph_decode_tokens_per_s": res["decode_tokens_per_s"],
          "generate_tokens_equal": torch.equal(eager["tokens"],
                                               res["tokens"]),
          **eager_vs_graph(cfg, params, prompts, N_GEN)})

    # the same path through the plain versions, on 4 x 256 tokens: a
    # prefill and one decode step of the token the kernels' run chose
    short = prompts[:, :256]

    def prefill_and_step(tok=None):
        with torch.inference_mode():
            cache = Z.init_cache(cfg, B, 257, dtype=Z.compute_dtype(cfg),
                                 device=dev)
            first, cache, _ = Z.prefill(cfg, params, cache, short)
            if tok is None:
                tok = torch.argmax(first[:, :cfg.vocab_size], -1)[:, None]
            nxt, _, _ = Z.decode_step(cfg, params, cache, tok, 256)
        return first, nxt, tok

    got = prefill_and_step()
    originals = {n: ops.KERNELS[n] for n in NORM_ATTN_KERNELS}
    ops.KERNELS.update({n: (p, p) for n, (_, p) in originals.items()})
    try:
        ref = prefill_and_step(got[2])
    finally:
        ops.KERNELS.update(originals)
    agree = {}
    for g, r, what in zip(got, ref, ("prefill", "decode")):
        err = float((g - r).abs().max()) / float(r.abs().max())
        agree[what] = {"rel_err": err, "argmax_agree": float(
            (g.argmax(-1) == r.argmax(-1)).float().mean())}
        if not err <= SERVE_PLAIN_TOL:
            raise AssertionError(f"serve-qwen3 {what} logits through the "
                                 f"kernels: rel err {err} to the plain path")
    emit({"phase": "serve_qwen3_plain", "tokens": [B, 256],
          "tol": SERVE_PLAIN_TOL, **agree})

    for prof in profile_decode(cfg, params, prompts,
                               f"batch {B}, pos {S}", prefill=True):
        prof["phase"] = "serve_qwen3_profile"
        emit(prof)

    kernels = []
    with torch.inference_mode():
        for n in NORM_ATTN_KERNELS:
            extra, lead = (), 0
            if n == "decode_attention":  # the last step (leading), S, 0, S-1
                extra = decode_cases(last_decode, S)
                lead = len(recorders[n].cases)
            if n == "rmsnorm":               # the prefill's ln1 leads
                lead = prefill_ln1(B, S, cfg.d_model)
            if n == "flash_attention":       # and serve-fp32's prefill shape
                g = torch.Generator(device=dev).manual_seed(2)
                extra = ((tuple(torch.randn(
                    (4, 256, 16, 128), generator=g, device=dev,
                    dtype=torch.bfloat16) for _ in range(3)),
                    {"causal": True}),)
            kernels.append(check_kernel(n, recorders[n], launches, extra,
                                        lead))
            emit({"phase": "kernel", **kernels[-1]})
        (q, k, v, pos), _ = last_decode[0]
        emit({"phase": "decode_graph", "path": "qwen3_4b",
              **decode_graph_check(q, k, v, (0, int(pos), k.shape[1] - 1))})
        line, rec, paged_launches, same = paged_decode(q, k, v)
        emit(line)
        paged = check_kernel("decode_attention_paged", rec, paged_launches,
                             extra=(same,))
        emit({"phase": "kernel", **paged})
        kernels.append(paged)
    return kernels


def serve_counted(cfg, params, prompts, n_gen, names, dist=None,
                  batched_prefill=None):
    """``generate`` (its ``batched_prefill`` as given) with the kernels
    ``names`` recorded (:class:`Recorder`) and their launch counts set to 0
    just before and read just after (a captured kernel's at capture times
    the replays), each > 0; the tokens of the right shape, inside the
    vocab, the logits finite.  Returns
    (result, launches, recorders, peak device GB, the last decode_attention
    call's arguments as :func:`record_last_decode` keeps them, or None)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.optim.adamw import tree_leaves
    cudas = {n: ops.KERNELS[n][0] for n in names}
    recs, restore = recording(names, frozenset(
        t.data_ptr() for t in tree_leaves(params)))
    last = (record_last_decode(recs["decode_attention"],
                               ops.KERNELS["decode_attention"][1])
            if "decode_attention" in names else None)
    torch.cuda.reset_peak_memory_stats()
    try:
        res, launches = counted(cudas, lambda: generate(
            cfg, params, prompts, n_gen, dist=dist,
            batched_prefill=batched_prefill))
    finally:
        restore()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = graph_launches(launches, res)
    for n, k in launches.items():
        if k <= 0:
            raise AssertionError(f"kernel {n} was not launched serving "
                                 f"{cfg.arch_id}")
    toks = res["tokens"]
    if (toks.shape != (prompts.shape[0], n_gen)
            or not torch.isfinite(res["logits"]).all()
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"serving {cfg.arch_id} produced a wrong shape, "
                             "non-finite logits or a token outside the vocab")
    return res, launches, recs, peak_gb, last


def plain_check(cfg, params, prompts, names, dist=None) -> dict:
    """The prompts through eager decode steps with the kernels ``names``
    and again through their plain versions: every step's logits within
    ``SERVE_PLAIN_TOL`` of the plain path's largest.  The plain run takes
    the MoE routers' choices (``top_idx``; the weights from its own
    probabilities) that the kernels' run made: the two round apart in bf16,
    and a router whose k-th and (k+1)-th experts lie that close would
    otherwise send a token to another expert, which is no kernel's error.
    How many choices its own routers would have made otherwise is
    reported (``routing_choices_differing``)."""
    import torch

    from repro_torch.core import moe as tmoe
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape
    route, taken, differing = tmoe.route, [], []

    def record(mcfg, rp, t, n):
        out = route(mcfg, rp, t, n)
        taken.append(out.top_idx)
        return out

    def replay(mcfg, rp, t, n):
        out = route(mcfg, rp, t, n)
        top = taken[len(differing)]
        differing.append(int((out.top_idx != top).sum()))
        w = torch.gather(out.probs, -1, top.long())
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return out._replace(top_idx=top, top_w=w.to(out.top_w.dtype))

    def run():
        cache = Z.init_cache(cfg, B, S, dtype=Z.compute_dtype(cfg),
                             device=prompts.device)
        out = []
        with torch.inference_mode():
            for t in range(S):
                logits, _, _ = Z.decode_step(cfg, params, cache,
                                             prompts[:, t:t + 1], t,
                                             dist=dist)
                out.append(logits)
        return out
    originals = {n: ops.KERNELS[n] for n in names}
    try:
        tmoe.route = record
        got = run()
        tmoe.route = replay
        ops.KERNELS.update({n: (p, p) for n, (_, p) in originals.items()})
        ref = run()
    finally:
        tmoe.route = route
        ops.KERNELS.update(originals)
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    line = {"kernels": list(names), "steps": S, "tol": SERVE_PLAIN_TOL,
            "max_rel_err": max(errs), "last_rel_err": errs[-1],
            "argmax_agree": float(torch.stack(
                [(g.argmax(-1) == r.argmax(-1)).float()
                 for g, r in zip(got, ref)]).mean()),
            "router_calls": len(taken),
            "routing_choices_differing": sum(differing)}
    if not line["max_rel_err"] <= SERVE_PLAIN_TOL:
        raise AssertionError(f"{cfg.arch_id}: logits through the kernels "
                             f"against the plain versions: {line}")
    return line


def profile_decode(cfg, params, prompts, what: str, dist=None,
                   prefill: bool = False) -> list:
    """One eager decode step and one replayed from its CUDA graph, at
    position S (the prompts' length, the prompt's last token fed again),
    under torch.profiler; with ``prefill``, first one prefill of the
    prompts."""
    import torch

    from repro_torch.launch.serve import capture_decode_step
    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape
    tok = prompts[:, -1:]
    cache = Z.init_cache(cfg, B, S + 1, dtype=Z.compute_dtype(cfg),
                         device=prompts.device)
    with torch.inference_mode():
        replay, _ = capture_decode_step(cfg, params, cache, prompts[:, :1],
                                        dist=dist)

    def run_prefill():
        with torch.inference_mode():
            Z.prefill(cfg, params, cache, prompts)

    def eager():
        with torch.inference_mode():
            Z.decode_step(cfg, params, cache, tok, S, dist=dist)
    steps = [(f"one prefill (batch {B} x {S})", run_prefill)] if prefill else []
    steps += [(f"one decode step ({what})", eager),
              (f"one decode step replayed from its CUDA graph ({what})",
               lambda: replay(tok, S))]
    return [profile_step(w, step) for w, step in steps]


def same_tokens(cfg, eager: dict, res: dict) -> bool:
    """The timed replayed ``generate``'s tokens against the eager one's,
    bit for bit: a per-token path has no HT atomics, so nothing may
    differ."""
    import torch
    if not torch.equal(eager["tokens"], res["tokens"]):
        raise AssertionError(f"{cfg.arch_id}: the replayed generate's tokens "
                             "differ from the eager generate's")
    return True


def step_bytes(params, cache, batch: int) -> int:
    """Bytes a decode step must move at least: every parameter read once
    (of the embedding only the batch's rows), every recurrent state read
    and written once (a KV cache's live rows aside)."""
    from repro_torch.optim.adamw import tree_leaves
    n = sum(t.numel() * t.element_size() for k, t in params.items()
            if k not in ("embed", "blocks"))
    n += sum(t.numel() * t.element_size()
             for t in tree_leaves(params["blocks"]))
    emb = params["embed"]
    n += batch * emb.shape[1] * emb.element_size()
    n += sum(2 * t.numel() * t.element_size() for c in cache
             for k, t in c.items() if k in ("conv", "ssm"))
    return n


def serve_falcon_mamba(dev) -> list:
    """falcon-mamba-7b at full width and all 64 layers served through
    ``generate``: the prompt through replayed decode steps, then greedy
    decode; rmsnorm's launches counted; the eager step's tokens/s, and
    the tokens of both steps bit for bit; every prompt step's logits
    through the kernel against the plain version's; one decode step eager
    and
    replayed under the profiler.  Returns rmsnorm's recorded (args,
    kwargs) cases (its D 4096 decode rows), for the kernel's checks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("falcon_mamba_7b")
    B, S, N_GEN = FALCON_BATCH, FALCON_PROMPT, FALCON_GEN
    t0 = time.perf_counter()
    params = Z.init_params(cfg, seed=0, device=dev,
                           dtype=Z.compute_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    # warm-up: first launches, library loads, the allocator's growth
    generate(cfg, params, prompts[:, :8], 2)
    torch.cuda.synchronize()
    res, launches, recs, peak_gb, _ = serve_counted(cfg, params, prompts,
                                                    N_GEN, ("rmsnorm",))
    eager = generate(cfg, params, prompts, N_GEN, cuda_graph=False)
    both = eager_vs_graph(cfg, params, prompts, N_GEN, batched_prefill=False)
    nbytes = step_bytes(params, Z.init_cache(cfg, B, 1, device=dev), B)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    step_ms = 1e3 * B / res["decode_tokens_per_s"]
    d, di, dtr, n = mamba_dims(cfg)
    emit({"phase": "serve-falcon-mamba", "model": "falcon_mamba_7b",
          "width": "full", "layers": cfg.n_layers, "d_model": d,
          "d_inner": di, "dt_rank": dtr, "d_state": n,
          "d_conv": cfg.mamba.d_conv, "vocab": cfg.vocab_size,
          "params": n_params, "param_gb": param_gb, "batch": B, "prompt": S,
          "generated": N_GEN, "prompt_steps": S - 1,
          "prompt_s": res["prompt_s"],
          "prompt_steps_per_s": (S - 1) / res["prompt_s"],
          "eager_prompt_steps_per_s": (S - 1) / eager["prompt_s"],
          "decode_tokens_per_s": res["decode_tokens_per_s"],
          "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
          "replayed_step_ms": step_ms, "step_bytes": nbytes,
          "step_bound_ms": bound_ms, "step_bound_share": bound_ms / step_ms,
          "decode_tokens_per_s_cap": B / bound_ms * 1e3,
          "total_s": res["total_s"], "tokens_per_s": res["tokens_per_s"],
          "cuda_graph": res["cuda_graph"], "capture_s": res["capture_s"],
          "graph_replays": res["graph_replays"],
          "captured_launches": {k: v for k, v in
                                res["captured_launches"].items() if v},
          "launches": launches,
          "generate_tokens_equal": same_tokens(cfg, eager, res),
          "eager_vs_graph": both, "first_tokens": res["tokens"][0].tolist(),
          "init_params_s": init_s, "peak_mem_gb": peak_gb})
    emit({"phase": "serve_falcon_mamba_plain",
          **plain_check(cfg, params, prompts, ("rmsnorm",))})
    for prof in profile_decode(cfg, params, prompts, f"batch {B}, pos {S}"):
        prof["phase"] = "serve_falcon_mamba_profile"
        emit(prof)
    return list(recs["rmsnorm"].cases.values())


def jamba_reduced_cfg():
    """The jamba hybrid at its published widths, its first
    ``JAMBA_LAYERS`` layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("jamba_1_5_large_398b"),
                               n_layers=JAMBA_LAYERS)


def serve_jamba_reduced(dev) -> None:
    """The jamba hybrid at its published widths, its first 5 layers
    (attention, Mamba and MoE layers, each with its own cache), served
    through ``generate`` over an EP world of 4, on the fp32 and the fp8
    wire: the prompt through replayed decode steps (LL), then greedy
    decode; each run's kernels' launches counted; the eager and replayed
    tokens bit for bit; every prompt step's logits through the kernels
    against the plain versions'; one decode step profiled; the kernels on
    the fp8 run's recorded inputs against their plain versions."""
    import torch

    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.optim.adamw import tree_leaves

    cfg = jamba_reduced_cfg()
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, wire_dtype="fp8"))
    dist = make_dist_ctx(cfg, model=4)
    B, S, N_GEN = JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Z.init_params(cfg, seed=0, device=dev,
                           dtype=Z.compute_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    # a decode step reads the weights outside the experts once and, of
    # each MoE layer, the experts its batch's B x top_k choices occupy:
    # from top_k (all on the same ones) to min(E, B x top_k)
    m = cfg.moe
    moe = [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]
    expert_bytes = 3 * cfg.d_model * m.d_expert * 2
    dense = step_bytes(params, Z.init_cache(cfg, B, 1, device=dev), B) \
        - len(moe) * m.n_experts * expert_bytes
    bound_ms = [(dense + len(moe) * e * expert_bytes) / HBM_BYTES_PER_S * 1e3
                for e in (m.top_k, min(m.n_experts, B * m.top_k))]
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    for c in (cfg, cfg8):
        generate(c, params, prompts[:, :4], 2, dist=dist)
    torch.cuda.synchronize()
    kinds = ["attention" if cfg.is_attn_layer(i) else "mamba"
             for i in range(cfg.n_layers)]
    _, di, dtr, n = mamba_dims(cfg)
    recs = None
    for c, wire in ((cfg, "fp32"), (cfg8, "fp8")):
        names = JAMBA_KERNELS if wire == "fp8" else JAMBA_KERNELS[:3]
        res, launches, r, peak_gb, last = serve_counted(
            c, params, prompts, N_GEN, names, dist)
        eager = generate(c, params, prompts, N_GEN, dist=dist,
                         cuda_graph=False)
        both = eager_vs_graph(c, params, prompts, N_GEN, dist,
                              batched_prefill=False)
        if wire == "fp8":
            recs, fp8_launches, last_decode = r, launches, last
        step_ms = 1e3 * B / res["decode_tokens_per_s"]
        emit({"phase": "serve-jamba-reduced", "model": "jamba_1_5_large_398b",
              "width": "full", "layers": cfg.n_layers, "layer_kinds": kinds,
              "moe_layers": moe, "d_model": cfg.d_model,
              "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.head_dim_, "d_inner": di, "dt_rank": dtr,
              "d_state": n, "d_ff": cfg.d_ff, "d_expert": m.d_expert,
              "experts": m.n_experts, "top_k": m.top_k,
              "vocab": cfg.vocab_size, "params": n_params,
              "param_gb": param_gb, "ep_world": "model=4", "wire": wire,
              "batch": B, "prompt": S, "generated": N_GEN,
              "prompt_steps_per_s": (S - 1) / res["prompt_s"],
              "decode_tokens_per_s": res["decode_tokens_per_s"],
              "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
              "replayed_step_ms": step_ms,
              "step_bound_ms_range": bound_ms,
              "total_s": res["total_s"], "capture_s": res["capture_s"],
              "graph_replays": res["graph_replays"],
              "decode_dropped": res["decode_dropped"],
              "prefill_dropped": res["prefill_dropped"],
              "launches": launches,
              "generate_tokens_equal": same_tokens(c, eager, res),
              "eager_vs_graph": both,
              "first_tokens": res["tokens"][0].tolist(),
              "init_params_s": init_s, "init_peak_mem_gb": init_peak_gb,
              "peak_mem_gb": peak_gb})
        emit({"phase": "serve_jamba_reduced_plain", "wire": wire,
              **plain_check(c, params, prompts, names, dist)})
        del r, res, eager
    for prof in profile_decode(cfg, params, prompts, f"batch {B}, pos "
                               f"{S}, fp32 wire", dist):
        prof["phase"] = "serve_jamba_reduced_profile"
        emit(prof)
    with torch.inference_mode():
        for n in JAMBA_KERNELS:
            extra, lead = (), 0
            if n == "decode_attention":     # the last step (rep 8) leads
                extra = decode_cases(last_decode, S - 1)
                lead = len(recs[n].cases)
            emit({"phase": "kernel", "path": "jamba_1_5_large_398b (5 layers)",
                  **check_kernel(n, recs[n], fp8_launches, extra, lead)})


def placement_checks(cfg, params, x, dist) -> dict:
    """One MoE layer (layer 0) under replicated expert placements, at the
    served HT shape (``x``: the prefill's recorded input, batch x prompt
    tokens) and at the LL shape (one decode step: the batch's last tokens,
    held by every rank): ``greedy_placement`` of the layer's routed load on
    the served prompts over ``MOONSHOT_PHYSICAL`` slots, and two replicas
    an expert (``replicate_uniform``).  The expert function gathers its
    weights through ``phys_to_logical``; the capacity is lifted so that
    nothing drops (a physical slot takes at most T choices from a source).
    Each is held to the logical dense oracle ``moe_ref`` within
    ``MOE_TOL["fp32"]`` and must launch its kernel (HT
    ``gather_swiglu_scatter``, LL ``grouped_swiglu``).  The identity
    placement against none: LL bit for bit, HT (whose fp32 atomics add in
    any order) the same plan statistics bit for bit and outputs within
    ``gather_swiglu_scatter``'s tolerance plus an ulp."""
    import torch

    from repro_torch.core import ep
    from repro_torch.core import plan as planlib
    from repro_torch.core.moe import _expert_fn, make_ep_spec, to_ranks
    from repro_torch.core.routing import RouterParams, route
    from repro_torch.kernels import ops

    p = params["blocks"][0]["moe"]
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    E, K = wg.shape[0], cfg.moe.top_k
    rp = RouterParams(p["router_w"], p.get("router_b"))
    shapes = {"ht": to_ranks(dist, x), "ll": to_ranks(dist, x[:, -1:])}
    routes = {m: route(cfg.moe, rp, t, cfg.moe.n_experts)
              for m, t in shapes.items()}
    load = planlib.expert_load(routes["ht"].top_idx, E)
    refs = {m: ep.moe_ref(t.reshape(-1, t.shape[-1]),
                          routes[m].top_idx.reshape(-1, K),
                          routes[m].top_w.reshape(-1, K), wg, wu, wd)
            for m, t in shapes.items()}
    runs = {"ll": ep.dispatch_combine_ll, "ht": ep.dispatch_combine_ht}
    kernel = {"ll": "grouped_swiglu", "ht": "gather_swiglu_scatter"}
    cudas = {n: ops.KERNELS[n][0] for n in kernel.values()}

    def run(mode, placement, fn):
        n_phys = E if placement is None else placement.n_physical
        spec = dataclasses.replace(
            make_ep_spec(cfg, dist, mode=mode, dtype=x.dtype),
            capacity_factor=n_phys / K,
            placement=None if placement is None else placement.key())
        t, r = shapes[mode], routes[mode]
        return counted(cudas, lambda: runs[mode](spec, t, r.top_idx,
                                                 r.top_w, fn))
    cases = []
    for name, pl in (("greedy", planlib.greedy_placement(
            load, MOONSHOT_PHYSICAL, math.prod(dist.ep_sizes))),
            ("uniform2", planlib.replicate_uniform(E, 2))):
        p2l = torch.as_tensor(pl.phys_to_logical, device=x.device).long()
        fn = _expert_fn(wg[p2l], wu[p2l], wd[p2l])
        for mode in ("ht", "ll"):
            res, launches = run(mode, pl, fn)
            ref = refs[mode].float()
            out = res.out.reshape(ref.shape).float()
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            case = {"placement": name, "mode": mode,
                    "physical_slots": pl.n_physical,
                    "replicas_max": int(pl.n_replicas.max()),
                    "tokens": int(ref.shape[0]), "rel_err": err,
                    "tol": MOE_TOL["fp32"],
                    "dropped": float(res.aux["dropped"].max()),
                    "load_phys": res.aux["load_phys"].tolist(),
                    "imbalance": float(res.aux["imbalance"]),
                    "launches": launches,
                    "ms": cuda_ms(lambda: run(mode, pl, fn), n=5, warmup=1)}
            cases.append(case)
            if (not err <= MOE_TOL["fp32"] or case["dropped"] != 0.0
                    or len(case["load_phys"]) != pl.n_physical
                    or launches[kernel[mode]] <= 0):
                raise AssertionError(f"placement {name} {mode}: {case}")
        del fn, p2l
    ident = planlib.identity_placement(E)
    fn = _expert_fn(wg, wu, wd)
    identity = {}
    for mode in ("ht", "ll"):
        (a, _), (b, _), (c, _) = (run(mode, None, fn), run(mode, ident, fn),
                                  run(mode, None, fn))
        same = torch.equal(a.out, b.out)
        stats = all(torch.equal(a.aux[k], b.aux[k]) for k in
                    ("dropped", "occupancy", "load_phys", "imbalance"))
        diff = (a.out.float() - b.out.float()).abs()
        spread = float((a.out.float() - c.out.float()).abs().max())
        scale = float(a.out.float().abs().max())
        over = diff > KERNEL_TOL["gather_swiglu_scatter"] * scale + ulp(a.out)
        identity[mode] = {"bit_identical": same, "stats_bit_identical": stats,
                          "max_abs_diff": float(diff.max()),
                          "two_runs_without_max_abs_diff": spread}
        if not stats or (mode == "ll" and not same) or over.any():
            raise AssertionError(f"identity placement {mode}: "
                                 f"{identity[mode]}")
    return {"phase": "placement", "model": cfg.arch_id, "layer": 0,
            "experts": E, "top_k": K, "ep_world": math.prod(dist.ep_sizes),
            "routed_load": load.tolist(), "cases": cases,
            "identity_vs_none": identity}


def serve_moonshot(dev) -> None:
    """moonshot-v1-16b-a3b at full width and all 48 layers, served as
    serve-fp32 serves qwen2-moe (``MOONSHOT_*``): the batched HT prefill
    and the replayed LL decode step over an EP world of 4, each kernel's
    launches counted; eager and replayed decode bit for bit from one
    prefill; the decode steps through the kernels against their plain
    versions (``plain_check``); the MoE layer against the dense oracle over
    HT's kept choices (``moe_served``); the placements
    (``placement_checks``); one prefill and one decode step profiled; and
    the five kernels on the recorded inputs against their plain
    versions."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("moonshot_v1_16b_a3b")
    dist = make_dist_ctx(cfg, model=4)
    B, S, N_GEN = MOONSHOT_BATCH, MOONSHOT_PROMPT, MOONSHOT_GEN
    bwd = {n: ops.KERNELS[n][0] for n in EP_BWD_KERNELS}
    bwd_before = {n: c.launches for n, c in bwd.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Z.init_params(cfg, seed=0, device=dev,
                           dtype=Z.compute_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    generate(cfg, params, prompts[:, :32], 2, dist=dist, batched_prefill=True)
    torch.cuda.synchronize()
    res, launches, recs, peak_gb, last = serve_counted(
        cfg, params, prompts, N_GEN, MOONSHOT_KERNELS, dist,
        batched_prefill=True)
    eager = generate(cfg, params, prompts, N_GEN, dist=dist,
                     batched_prefill=True, cuda_graph=False)
    both = eager_vs_graph(cfg, params, prompts, N_GEN, dist)
    m = cfg.moe
    emit({"phase": "serve-moonshot", "model": cfg.arch_id, "width": "full",
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.head_dim_, "experts": m.n_experts,
          "top_k": m.top_k, "d_expert": m.d_expert, "d_shared": m.d_shared,
          "vocab": cfg.vocab_size, "params": n_params, "param_gb": param_gb,
          "ep_world": "model=4", "wire": m.wire_dtype, "batch": B,
          "prompt": S, "generated": N_GEN,
          "tokens_per_s": res["tokens_per_s"],
          "decode_tokens_per_s": res["decode_tokens_per_s"],
          "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
          "ttft_s": res["ttft_s"], "eager_ttft_s": eager["ttft_s"],
          "total_s": res["total_s"], "capture_s": res["capture_s"],
          "graph_replays": res["graph_replays"],
          "prefill_dropped": res["prefill_dropped"],
          "prefill_dropped_per_layer": res["prefill_dropped_per_layer"],
          "decode_dropped": res["decode_dropped"], "launches": launches,
          "eager_vs_graph": both, "first_tokens": res["tokens"][0].tolist(),
          "init_params_s": init_s, "init_peak_mem_gb": init_peak_gb,
          "peak_mem_gb": peak_gb, "card": nvidia_smi()})
    if not peak_gb < 80.0:
        raise AssertionError(f"moonshot peak memory {peak_gb} GB")
    del eager
    emit({"phase": "serve_moonshot_plain",
          **plain_check(cfg, params, prompts[:, :MOONSHOT_PLAIN_STEPS],
                        MOONSHOT_KERNELS, dist)})
    served, x0 = moe_served(cfg, params, prompts, dist)
    emit({**served, "model": cfg.arch_id})
    emit(placement_checks(cfg, params, x0, dist))
    del x0
    cache = Z.init_cache(cfg, B, S + 1, dtype=Z.compute_dtype(cfg),
                         device=dev)
    with torch.inference_mode():
        prof = profile_step(f"one HT prefill (batch {B} x {S})",
                            lambda: Z.prefill(cfg, params, cache, prompts,
                                              dist=dist))
    prof["phase"] = "serve_moonshot_profile"
    emit(prof)
    del cache
    for prof in profile_decode(cfg, params, prompts, f"batch {B}, pos {S}",
                               dist):
        prof["phase"] = "serve_moonshot_profile"
        emit(prof)
    with torch.inference_mode():
        for n in MOONSHOT_KERNELS:
            extra, lead = (), (lambda a: a[0].numel())
            if n == "decode_attention":     # the last step leads
                extra = decode_cases(last, S)
                lead = len(recs[n].cases)
            elif n == "flash_attention":
                lead = 0
            emit({"phase": "kernel", "path": f"{cfg.arch_id} ({cfg.n_layers} layers)",
                  **check_kernel(n, recs[n], launches, extra, lead)})
    served_bwd = {n: c.launches - bwd_before[n] for n, c in bwd.items()}
    if any(served_bwd.values()):
        raise AssertionError(f"serving moonshot launched backward kernels: "
                             f"{served_bwd}")


def dense_plain_check(cfg, params, prompts) -> dict:
    """One prefill of ``prompts`` and one decode step of the token the
    kernels' run chose, through the kernels and through their plain
    versions: the last prefill logits and the step's within
    ``SERVE_PLAIN_TOL`` of the plain path's largest."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape

    def prefill_and_step(tok=None):
        with torch.inference_mode():
            cache = Z.init_cache(cfg, B, S + 1, dtype=Z.compute_dtype(cfg),
                                 device=prompts.device)
            first, cache, _ = Z.prefill(cfg, params, cache, prompts)
            if tok is None:
                tok = torch.argmax(first[:, :cfg.vocab_size], -1)[:, None]
            nxt, _, _ = Z.decode_step(cfg, params, cache, tok, S)
        return first, nxt, tok

    got = prefill_and_step()
    originals = {n: ops.KERNELS[n] for n in NORM_ATTN_KERNELS}
    ops.KERNELS.update({n: (p, p) for n, (_, p) in originals.items()})
    try:
        ref = prefill_and_step(got[2])
    finally:
        ops.KERNELS.update(originals)
    line = {"tokens": [B, S], "tol": SERVE_PLAIN_TOL}
    for g, r, what in zip(got, ref, ("prefill", "decode")):
        err = rel_err(g, r)
        line[what] = {"rel_err": err, "argmax_agree": float(
            (g.argmax(-1) == r.argmax(-1)).float().mean())}
        if not err <= SERVE_PLAIN_TOL:
            raise AssertionError(f"{cfg.arch_id} {what} logits through the "
                                 f"kernels: rel err {err} to the plain path")
    return line


def serve_dense_wide(dev, kernels) -> None:
    """The four dense configs the earlier slices left out (``DENSE_WIDE``),
    one at a time, each freed before the next, served at full width
    through ``generate`` (qwen2-72b at ``DENSE_LAYERS``): its kernels'
    launches counted; eager and replayed tokens bit for bit; the prefill
    and one decode step against the plain versions (``dense_plain_check``);
    the recorded RMSNorm, flash attention and flash decoding calls (and
    the last decode step's) against their plain versions, timed, joining
    the kernels line's entries (``kernels``) as cases of their path; for
    ``DENSE_PAGED``, paged decoding on the last cache, the same way."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim.adamw import tree_leaves

    entries = {k["name"]: k for k in kernels}
    B, S, N_GEN = DENSE_BATCH, DENSE_PROMPT, DENSE_GEN
    t_phase = time.perf_counter()
    for arch in DENSE_WIDE:
        t_model = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=DENSE_LAYERS.get(
            arch, full.n_layers))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = Z.init_params(cfg, seed=0, device=dev,
                               dtype=Z.compute_dtype(cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = tree_leaves(params)
        n_params = sum(t.numel() for t in leaves)
        param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
        del leaves
        gen = torch.Generator().manual_seed(0)
        prompts = torch.randint(0, cfg.vocab_size, (B, S),
                                generator=gen).to(dev)
        # warm-up at the served shape: first launches and the allocator's
        # growth to the prefill's activations, which TTFT would carry
        generate(cfg, params, prompts, 2)
        torch.cuda.synchronize()
        res, launches, recs, peak_gb, last = serve_counted(
            cfg, params, prompts, N_GEN, NORM_ATTN_KERNELS)
        eager = generate(cfg, params, prompts, N_GEN, cuda_graph=False)
        same_tokens(cfg, eager, res)
        emit({"phase": "serve-dense-wide", "model": arch, "width": "full",
              "layers": cfg.n_layers, "layers_published": full.n_layers,
              "d_model": cfg.d_model, "heads": cfg.n_heads,
              "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
              "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
              "qkv_bias": cfg.qkv_bias, "params": n_params,
              "param_gb": param_gb, "batch": B, "prompt": S,
              "generated": N_GEN, "ttft_s": res["ttft_s"],
              "total_s": res["total_s"], "tokens_per_s": res["tokens_per_s"],
              "decode_tokens_per_s": res["decode_tokens_per_s"],
              "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
              "eager_ttft_s": eager["ttft_s"],
              "eager_replayed_tokens_equal": True,
              "capture_s": res["capture_s"],
              "graph_replays": res["graph_replays"], "launches": launches,
              "first_tokens": res["tokens"][0].tolist(),
              "init_params_s": init_s, "peak_mem_gb": peak_gb})
        if not peak_gb < 80.0:
            raise AssertionError(f"{arch}: peak memory {peak_gb} GB")
        del eager, res
        emit({"phase": "serve_dense_wide_plain", "model": arch,
              **dense_plain_check(cfg, params,
                                  prompts[:, :DENSE_PLAIN_TOKENS])})
        path = f"{arch} ({cfg.n_layers} layers)"
        recorded = {n: list(recs[n].cases.values())
                    for n in NORM_ATTN_KERNELS}
        recorded["decode_attention"] += list(decode_cases(last, S)[:1])
        del recs
        for n in NORM_ATTN_KERNELS:
            more = add_cases(entries[n], recorded[n], path, launches[n])
            emit({"phase": "kernel", "name": n, "path": path,
                  "cases": more})
        if arch in DENSE_PAGED:
            (q, k, v, _), _ = last[0]
            with torch.inference_mode():
                line, rec, paged_launches, same = paged_decode(
                    q, k, v, DENSE_PAGED_POS, DENSE_PAGED_REPLAY_POS)
            emit({**line, "path": path})
            more = add_cases(entries["decode_attention_paged"],
                             [*rec.cases.values(), same], path,
                             paged_launches["decode_attention_paged"])
            emit({"phase": "kernel", "name": "decode_attention_paged",
                  "path": path, "cases": more})
            del q, k, v, rec, same
        del recorded, last, params, prompts
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "serve_dense_wide_model_seconds", "model": arch,
              "seconds": time.perf_counter() - t_model})
    emit({"phase": "serve_dense_wide_seconds",
          "seconds": time.perf_counter() - t_phase})


def train_musicgen_prefix(dev) -> dict:
    """Training with a frontend prefix: musicgen-large at full width and
    ``PREFIX_TRAIN_LAYERS`` layers, ``PREFIX_TRAIN_STEPS`` AdamW steps
    through ``train_loop`` on one seeded batch of ``PREFIX_TRAIN_BATCH``
    sequences, each its 64 prefix embeddings before ``PREFIX_TRAIN_SEQ``
    text tokens.  The training path runs its attention and norms as the
    model's tensor code, as the reference's training does: the serving
    kernels' launches must stay 0.  Every loss and grad norm finite, the
    last loss below the first."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.train_loop import HParams, init_state

    full = get_config("musicgen_large")
    cfg = dataclasses.replace(full, n_layers=PREFIX_TRAIN_LAYERS)
    B, S, STEPS = PREFIX_TRAIN_BATCH, PREFIX_TRAIN_SEQ, PREFIX_TRAIN_STEPS
    P = cfg.frontend_prefix
    hp = HParams(peak_lr=3e-4, warmup=1, total_steps=STEPS)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, batch=B,
                                   seq_len=S, seed=0, prefix_len=P,
                                   d_model=cfg.d_model), 0)
    if batch["prefix"].shape != (B, P, cfg.d_model):
        raise AssertionError(f"prefix batch {batch['prefix'].shape}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    serving = {n: ops.KERNELS[n][0] for n in NORM_ATTN_KERNELS}
    (state, hist, secs), launches = counted(
        serving, lambda: train_steps(cfg, hp, batch, state, dev))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if any(launches.values()):
        raise AssertionError(f"the training path launched serving kernels: "
                             f"{launches}")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return {"phase": "train-musicgen-prefix", "model": "musicgen_large",
            "width": "full", "d_model": cfg.d_model, "heads": cfg.n_heads,
            "head_dim": cfg.head_dim_, "layers": cfg.n_layers,
            "layers_published": full.n_layers, "params": n_params,
            "batch": B, "prefix": P, "seq": S, "positions": P + S,
            "steps": STEPS, "optimizer": "adamw", "peak_lr": hp.peak_lr,
            "remat": cfg.remat,
            "steps_detail": [{"step": i, "loss": l, "grad_norm": g,
                              "seconds": t} for i, (l, g, t) in
                             enumerate(zip(losses, gnorms, secs))],
            "step_s_steps_2_5": sum(secs[1:STEPS]) / (STEPS - 1),
            "tokens_per_s_steps_2_5": B * S * (STEPS - 1) / sum(
                secs[1:STEPS]),
            "positions_per_s_steps_2_5": B * (P + S) * (STEPS - 1) / sum(
                secs[1:STEPS]),
            "serving_kernel_launches": launches,
            "init_params_s": init_s, "peak_mem_gb": peak_gb}


def rdma_launch_check(launches: dict) -> None:
    """The serve-rdma window's launches: every kernel of ``RDMA_KERNELS``
    more than 0 times, every one of ``RDMA_IDLE_KERNELS`` exactly 0."""
    missing = [n for n in RDMA_KERNELS if not launches.get(n, 0) > 0]
    stray = {n: launches.get(n) for n in RDMA_IDLE_KERNELS
             if launches.get(n) != 0}
    if missing or stray:
        raise AssertionError(f"serve-rdma launches {launches}: not launched "
                             f"{missing}, launched but must not be {stray}")


def substrate_counters(world) -> dict:
    """A substrate world's counters after a run: commands pushed, quiesce
    drains, dispatch messages and bytes, every message delivered, the wire
    bytes and the event clock (all deterministic with inline proxies)."""
    tl = world.timeline
    return {"cmds": int(tl["cmds_per_step"]),
            "drains": int(tl["drains_per_step"]),
            "dispatch_msgs": int(tl["dispatch_msgs"]),
            "dispatch_payload_bytes": int(tl["dispatch_payload_bytes"]),
            "dispatch_wire_bytes": int(tl["dispatch_wire_bytes"]),
            "msgs": int(world.net.delivered),
            "wire_bytes": int(world.net.wire_bytes_moved),
            "clock_us": float(world.net.clock_us)}


def same_world(cpu, card, what: str, tol: float) -> dict:
    """The CPU world's run against the card's on one routing, each a pair
    (counters, output): the counters equal key for key and the outputs
    within ``tol`` of the CPU output's largest, or raise.  Returns the
    card's counters with the outputs' relative error."""
    import numpy as np
    (c_cpu, y_cpu), (c_card, y_card) = cpu, card
    if c_cpu != c_card:
        diff = {k: (c_cpu.get(k), c_card.get(k))
                for k in set(c_cpu) | set(c_card)
                if c_cpu.get(k) != c_card.get(k)}
        raise AssertionError(f"{what}: the substrate's counters differ "
                             f"between the CPU and the card run: {diff}")
    err = float(np.abs(y_cpu - y_card).max() / np.abs(y_cpu).max())
    if not err <= tol:
        raise AssertionError(f"{what}: the card run's output is {err} of "
                             f"the CPU's largest from it (tol {tol})")
    return {**c_card, "out_rel_err": err, "out_tol": tol}


def host_profile(fn, top: int = 8) -> dict:
    """``fn()`` once under cProfile: its seconds, and the ``top``
    functions by own time (file:line name, own s, calls)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.runcall(fn)
    seconds = time.perf_counter() - t
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"profiled_s": seconds, "top_own": [
        {"fn": f"{Path(f).name}:{line} {name}", "own_s": st[2],
         "calls": st[1]} for (f, line, name), st in rows]}


class SubstrateCalls:
    """Stands in for the ``grouped_swiglu`` CUDA wrapper while the
    substrate serves: calls it, keeps the inputs of its first call with
    bucketed (E, R) counts (LL's grouped barrier) and of its first with
    flat (E,) counts (HT's (source, chunk) buckets), the weights by
    reference, and brackets every call on the card in CUDA events, so
    that ``take_ms`` gives the device time of the calls since the last
    take."""

    def __init__(self, fn, weights=frozenset()):
        self.fn, self.weights = fn, weights
        self.cases, self.events, self.calls = {}, [], 0

    def __call__(self, x, wg, wu, wd, counts=None):
        import torch
        kind = None if counts is None else ("ll" if counts.dim() == 2
                                            else "ht")
        if kind is not None and kind not in self.cases:
            self.cases[kind] = (tuple(
                a if a is None or a.data_ptr() in self.weights
                else a.detach().clone() for a in (x, wg, wu, wd, counts)),
                {})
        self.calls += 1
        if not x.is_cuda:
            return self.fn(x, wg, wu, wd, counts)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        y = self.fn(x, wg, wu, wd, counts)
        end.record()
        self.events.append((start, end))
        return y

    def take_ms(self) -> float:
        import torch
        if not self.events:
            return 0.0
        self.events[-1][1].synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        self.events = []
        return ms

    def path_cases(self) -> list:
        """The recorded (args, kwargs): LL's first call, then HT's."""
        missing = [k for k in ("ll", "ht") if k not in self.cases]
        if missing:
            raise AssertionError(f"the substrate never called grouped_swiglu "
                                 f"with {missing} counts")
        return [self.cases["ll"], self.cases["ht"]]


def pinned_prefill(cfg_a, cfg_b, params, prompts, dist) -> dict:
    """The last prefill logits of ``prompts`` through ``cfg_a`` (its MoE
    routers' choices recorded) and through ``cfg_b`` twice: with the
    routers' choices of the ``cfg_a`` run (``top_idx`` laid out over the
    ranks as ``cfg_b``'s path lays out its tokens; the weights from its
    own probabilities, as ``plain_check`` pins them) and free.  In bf16
    two paths round apart, and a router whose k-th and (k+1)-th experts
    lie that close sends a token elsewhere, which is no error of either
    path; ``routing_choices_differing`` counts the choices ``cfg_b``'s
    own routers would have made otherwise."""
    import torch

    from repro_torch.core import moe as tmoe
    from repro_torch.models import model_zoo as Z
    B, S = prompts.shape
    route, taken, differing = tmoe.route, [], []

    def record(mcfg, rp, t, n):
        out = route(mcfg, rp, t, n)
        taken.append(out.top_idx.reshape(B, S, -1))
        return out

    def replay(mcfg, rp, t, n):
        out = route(mcfg, rp, t, n)
        top = taken[len(differing)]
        top = (tmoe.to_ranks(dist, top) if out.top_idx.dim() == 3
               else top.reshape(out.top_idx.shape))
        # a choice another router would not make (their order aside)
        differing.append(int((out.top_idx.sort(-1).values
                              != top.sort(-1).values).sum()))
        w = torch.gather(out.probs, -1, top.long())
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return out._replace(top_idx=top, top_w=w.to(out.top_w.dtype))

    def prefill(c):
        cache = Z.init_cache(c, B, S, dtype=Z.compute_dtype(c),
                             device=prompts.device)
        with torch.inference_mode():
            logits, _, aux = Z.prefill(c, params, cache, prompts, dist=dist,
                                       moe_mode="ht")
        if float(aux["dropped"]) != 0.0:
            raise AssertionError(f"{c.moe.ep_backend}: the prefill dropped "
                                 "choices")
        return logits
    try:
        tmoe.route = record
        a = prefill(cfg_a)
        tmoe.route = replay
        b = prefill(cfg_b)
    finally:
        tmoe.route = route
    free = prefill(cfg_b)
    return {"rel_err": rel_err(a, b), "argmax_agree": float(
                (a.argmax(-1) == b.argmax(-1)).float().mean()),
            "unpinned_rel_err": rel_err(a, free),
            "unpinned_argmax_agree": float(
                (a.argmax(-1) == free.argmax(-1)).float().mean()),
            "router_calls": len(taken),
            "routing_choices_differing": sum(differing)}


def layer_times(rows: list, n_layers: int) -> list:
    """Per MoE layer, from ``rows`` of (host s, kernel device ms, calls) in
    call order (the prefill's layers, then each decode step's): the
    prefill's numbers and the decode steps' means."""
    out = []
    for i in range(n_layers):
        dec = rows[n_layers + i::n_layers]
        h, k, c = rows[i]
        out.append({"layer": i, "prefill_host_s": h, "prefill_kernel_ms": k,
                    "prefill_kernel_calls": c,
                    "decode_host_s": (sum(r[0] for r in dec) / len(dec)
                                      if dec else None),
                    "decode_kernel_ms": (sum(r[1] for r in dec) / len(dec)
                                         if dec else None)})
    return out


def serve_rdma(dev, kernels) -> None:
    """serve-rdma: qwen2-moe at full width and all 24 layers served through
    ``generate`` with ``moe.ep_backend = "simulated_rdma"`` over an EP
    world of 4 (``RDMA_*``): every MoE layer's dispatch and combine run on
    the host transport substrate, its experts through the
    ``grouped_swiglu`` kernel, the decode steps eagerly.  Checks the
    launches (``rdma_launch_check``), layer 0's MoE output against the
    dense oracle, the last prefill logits against the collectives' with
    every capacity lifted and the same routing choices
    (``pinned_prefill``), the substrate's counters on the CPU against the
    card run's on layer 0's routing, and every kernel of the path against
    its plain version on the inputs a second, instrumented fp32 run
    recorded: the cases join the kernels' entries of the kernels line as
    cases of this path.  TTFT, tokens/s and the launches come from the
    uninstrumented runs."""
    import resource

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import moe as moe_mod
    from repro_torch.core.backend import get_backend
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import blocks
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    base = get_config("qwen2_moe_a2_7b")

    def with_moe(**kw):
        return dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                                 **kw))
    cfg = with_moe(ep_backend="simulated_rdma")
    cfg_fp8 = with_moe(ep_backend="simulated_rdma", wire_dtype="fp8")
    dist = make_dist_ctx(cfg, model=4)
    B, S = RDMA_BATCH, RDMA_PROMPT
    t0 = time.perf_counter()
    params = Z.init_params(cfg, seed=0, device=dev,
                           dtype=Z.compute_dtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    generate(cfg, params, prompts[:, :8], 2, dist=dist, batched_prefill=True)
    torch.cuda.synchronize()

    # the served run, uninstrumented: TTFT, tokens/s and the launches
    names = RDMA_KERNELS + RDMA_IDLE_KERNELS
    cudas = {n: ops.KERNELS[n][0] for n in names}
    for c in cudas.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = generate(cfg, params, prompts, RDMA_GEN, dist=dist,
                   batched_prefill=True)
    launches32 = {n: c.launches for n, c in cudas.items()}
    res8 = generate(cfg_fp8, params, prompts, RDMA_GEN_FP8, dist=dist,
                    batched_prefill=True)
    launches = {n: c.launches for n, c in cudas.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rdma_launch_check(launches)
    for r, n_gen in ((res, RDMA_GEN), (res8, RDMA_GEN_FP8)):
        if (r["tokens"].shape != (B, n_gen)
                or not torch.isfinite(r["logits"]).all()
                or not ((r["tokens"] >= 0)
                        & (r["tokens"] < cfg.vocab_size)).all()):
            raise AssertionError("serve-rdma: wrong shape, a token outside "
                                 "the vocab, or non-finite logits")
        if r["cuda_graph"] or r["graph_replays"]:
            raise AssertionError("serve-rdma: a host backend must decode "
                                 "eagerly")

    # the fp32 run again, instrumented: every kernel of the path recorded,
    # each MoE layer's host seconds and its grouped_swiglu calls' device ms
    weights = frozenset(t.data_ptr() for t in tree_leaves(params))
    original = ops.KERNELS["grouped_swiglu"]
    rec = SubstrateCalls(original[0], weights)
    rows, seen = [], []
    moe_apply = blocks.moe_apply

    def timed_moe(c, d, p, x, **kw):
        # the first call is the prefill's layer 0: its input is kept; the
        # synchronize leaves the attention's kernels out of the host time
        if not seen:
            seen.append(x.clone())
        torch.cuda.synchronize()
        t = time.perf_counter()
        n0 = rec.calls
        y, aux = moe_apply(c, d, p, x, **kw)
        host = time.perf_counter() - t
        rows.append((host, rec.take_ms(), rec.calls - n0))
        return y, aux

    recs, restore = recording(NORM_ATTN_KERNELS, weights)
    ops.KERNELS["grouped_swiglu"] = (rec, original[1])
    blocks.moe_apply = timed_moe
    try:
        res_i = generate(cfg, params, prompts, RDMA_GEN, dist=dist,
                         batched_prefill=True)
    finally:
        restore()
        ops.KERNELS["grouped_swiglu"] = original
        blocks.moe_apply = moe_apply
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    emit({"phase": "serve-rdma", "model": cfg.arch_id, "width": "full",
          "layers": cfg.n_layers, "ep_world": "model=4",
          "ep_backend": cfg.moe.ep_backend, "batch": B, "prompt": S,
          "generated": RDMA_GEN, "generated_fp8": RDMA_GEN_FP8,
          "ttft_s": res["ttft_s"],
          "eager_decode_tokens_per_s": res["decode_tokens_per_s"],
          "tokens_per_s": res["tokens_per_s"], "total_s": res["total_s"],
          "fp8_ttft_s": res8["ttft_s"],
          "fp8_eager_decode_tokens_per_s": res8["decode_tokens_per_s"],
          "instrumented_ttft_s": res_i["ttft_s"],
          "instrumented_eager_decode_tokens_per_s":
              res_i["decode_tokens_per_s"],
          "instrumented_tokens_equal": torch.equal(res_i["tokens"],
                                                   res["tokens"]),
          "cuda_graph": res["cuda_graph"],
          "prefill_dropped": res["prefill_dropped"],
          "decode_dropped": res["decode_dropped"],
          "launches_fp32": launches32, "launches": launches,
          "first_tokens": res["tokens"][0].tolist(),
          "init_params_s": init_s, "peak_mem_gb": peak_gb,
          "peak_rss_gb": rss_gb, "card": nvidia_smi()})
    emit({"phase": "serve_rdma_layers", "wire": "fp32", "instrumented": True,
          "per_layer": layer_times(rows, cfg.n_layers),
          "prefill_host_s": sum(r[0] for r in rows[:cfg.n_layers]),
          "prefill_kernel_ms": sum(r[1] for r in rows[:cfg.n_layers]),
          "decode_host_s": sum(r[0] for r in rows[cfg.n_layers:]),
          "decode_kernel_ms": sum(r[1] for r in rows[cfg.n_layers:])})

    # layer 0's MoE output through the substrate against the dense oracle
    x0 = seen[0]
    p0 = {k: v for k, v in params["blocks"][0]["moe"].items()
          if k != "shared"}
    checks = []
    with torch.inference_mode():
        y_ref, _ = moe_mod.moe_apply(cfg, None, p0, x0, mode="ref")
        scale = float(y_ref.float().abs().max())
        for c in (cfg, cfg_fp8):
            for mode in ("ht", "ll"):
                y, aux = moe_mod.moe_apply(c, dist, p0, x0, mode=mode)
                err = float((y.float() - y_ref.float()).abs().max()) / scale
                wire = c.moe.wire_dtype
                checks.append({"mode": mode, "wire": wire, "rel_err": err,
                               "tol": MOE_TOL[wire],
                               "dropped": float(aux["dropped"])})
                if not err <= MOE_TOL[wire] or float(aux["dropped"]) != 0.0:
                    raise AssertionError(f"serve-rdma layer 0 {mode}/{wire}"
                                         f": {checks[-1]}")

    # the last prefill logits against the collectives' HT prefill, every
    # capacity lifted (no choice dropped), on the same weights and the
    # same routing choices
    cf_all = float(p0["w_gate"].shape[0] / cfg.moe.top_k)
    cfg_coll = with_moe(capacity_factor=cf_all)
    pinned = pinned_prefill(cfg, cfg_coll, params, prompts, dist)
    if not pinned["rel_err"] <= SERVE_PLAIN_TOL:
        raise AssertionError(f"serve-rdma: last prefill logits against the "
                             f"collectives: {pinned}")

    # the substrate on layer 0's routing: the CPU port's world against the
    # card run's, HT at the prefill shape and LL at decode's; then the HT
    # call on the card once more under cProfile, for where its host time
    # goes
    from repro_torch.core.routing import RouterParams, route
    with torch.inference_mode():
        t = x0.reshape(-1, x0.shape[-1])
        rout = route(cfg.moe, RouterParams(p0["router_w"],
                                           p0.get("router_b")), t,
                     cfg.moe.n_experts)
        xs = t.float().cpu().numpy()
        ti = rout.top_idx.cpu().numpy()
        tw = rout.top_w.float().cpu().numpy()
        w_cpu = {k: p0[k].cpu() for k in ("w_gate", "w_up", "w_down")}
        counters = {}
        for mode in ("ht", "ll"):
            spec = moe_mod.make_ep_spec(cfg, dist, mode=mode)
            # HT: the prompt's tokens; LL: a decode step's, one a rank
            n_tok = xs.shape[0] if mode == "ht" else spec.degree
            got = {}
            for where, w in (("cpu", w_cpu), ("card", p0)):
                be = get_backend("simulated_rdma")
                th = time.perf_counter()
                out = be.dispatch_combine(
                    spec, xs[:n_tok], ti[:n_tok], tw[:n_tok],
                    moe_mod._host_expert_fn(w["w_gate"], w["w_up"],
                                            w["w_down"]))
                got[where] = (substrate_counters(be.last_world), out.out,
                              time.perf_counter() - th)
            counters[mode] = {
                **same_world(got["cpu"][:2], got["card"][:2],
                             f"layer 0 {mode}", MOE_TOL[cfg.moe.wire_dtype]),
                "tokens": int(n_tok),
                "cpu_s": got["cpu"][2], "card_s": got["card"][2]}
        del w_cpu
        spec = moe_mod.make_ep_spec(cfg, dist, mode="ht")
        fn = moe_mod._host_expert_fn(p0["w_gate"], p0["w_up"], p0["w_down"])
        profile = host_profile(lambda: get_backend(
            "simulated_rdma").dispatch_combine(spec, xs, ti, tw, fn))
    emit({"phase": "serve_rdma_checks", "layer0": checks,
          "last_prefill": pinned, "tol": SERVE_PLAIN_TOL,
          "capacity_factor_collectives": cf_all,
          "substrate": counters})
    emit({"phase": "serve_rdma_host_profile", "mode": "ht", "layer": 0,
          "tokens": int(xs.shape[0]), **profile})

    # every kernel of the path on the inputs the instrumented run recorded
    # (the substrate's two kinds of grouped_swiglu call; the 64-token
    # prefill's attention and norms, the decode steps') against its plain
    # version, joining the kernel's entry as cases of this path
    recorded = {"grouped_swiglu": rec.path_cases(),
                **{n: list(recs[n].cases.values())
                   for n in NORM_ATTN_KERNELS}}
    for n, cases in recorded.items():
        if not cases:
            raise AssertionError(f"serve-rdma: {n} was never recorded")
        entry = next(k for k in kernels if k["name"] == n)
        more = add_cases(entry, cases, path=RDMA_PATH, launches=launches[n])
        emit({"phase": "kernel", "path": RDMA_PATH,
              **{k: v for k, v in entry.items() if k != "cases"},
              "rdma_launches": launches[n], "cases": more})
    emit({"phase": "serve_rdma_seconds",
          "seconds": time.perf_counter() - t_phase})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2

    from repro_torch.kernels import build

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

    from repro_torch.kernels import ops
    bwd = {n: ops.KERNELS[n][0] for n in EP_BWD_KERNELS}
    for c in bwd.values():
        c.launches = 0
    kernels = serve_phases(dev)
    # the serving model and the recorded EP inputs have left the card
    gc.collect()
    torch.cuda.empty_cache()
    rmsnorm_cases = serve_falcon_mamba(dev)
    gc.collect()
    torch.cuda.empty_cache()
    serve_jamba_reduced(dev)
    gc.collect()
    torch.cuda.empty_cache()
    serve_moonshot(dev)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += serve_qwen3(dev)
    # rmsnorm's entry holds falcon-mamba's D 4096 decode rows too
    rms = next(k for k in kernels if k["name"] == "rmsnorm")
    add_cases(rms, rmsnorm_cases)
    emit({"phase": "kernel", "path": "qwen3_4b, and falcon_mamba_7b's "
          "decode rows",
          **{k: v for k, v in rms.items() if k != "cases"},
          "cases": rms["cases"][-len(rmsnorm_cases):]})
    gc.collect()
    torch.cuda.empty_cache()
    serve_dense_wide(dev, kernels)
    served = {n: c.launches for n, c in bwd.items()}
    emit({"phase": "serve_backward_launches", **served})
    if any(served.values()):
        raise AssertionError(f"the serving paths launched backward kernels: "
                             f"{served}")
    gc.collect()
    torch.cuda.empty_cache()
    emit(train_musicgen_prefix(dev))
    gc.collect()
    torch.cuda.empty_cache()
    lines, scan_rec, scan_launches = train_phase(dev)
    for line in lines:
        emit(line)
    gc.collect()
    torch.cuda.empty_cache()
    scan_kernels = check_scan(scan_rec, scan_launches)
    for k in scan_kernels:
        emit({"phase": "kernel", **k})
    kernels += scan_kernels
    del scan_rec
    gc.collect()
    torch.cuda.empty_cache()
    lines, ep_recs, ep_launches = train_ep_phase(dev)
    for line in lines:
        emit(line)
    gc.collect()
    torch.cuda.empty_cache()
    ep_kernels = check_ep_bwd(ep_recs, ep_launches)
    for k in ep_kernels:
        emit({"phase": "kernel", "path": "qwen2_moe_a2_7b training", **k})
    # the forwards at the training shapes, held in their serving entries
    for n in EP_KERNELS:
        cases = list(ep_recs.pop(n).cases.values())
        if not cases:
            raise RuntimeError(f"{n}: the training path never called it")
        entry = next(k for k in kernels if k["name"] == n)
        add_cases(entry, cases)
        emit({"phase": "kernel", "path": "qwen2_moe_a2_7b training",
              **{k: v for k, v in entry.items() if k != "cases"},
              "training_launches": ep_launches[n],
              "cases": entry["cases"][-len(cases):]})
        del cases
        gc.collect()
        torch.cuda.empty_cache()
    kernels += ep_kernels
    gc.collect()
    torch.cuda.empty_cache()
    serve_rdma(dev, kernels)

    emit({"kernels": [{**{k: v for k, v in kk.items()
                          if k not in ("tolerance", "cases", "max_rel_err")},
                       **({"path_cases": path_cases(kk)}
                          if path_cases(kk) else {})}
                      for kk in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def serve_phases(dev) -> list:
    """The serving path and its checks (phases 3-7); returns the EP
    kernels' entries of the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.moe import moe_apply
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo as Z

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
    generate(cfg, params, prompts[:, :32], 2, dist=dist, batched_prefill=True)
    generate(cfg_fp8, params, prompts[:, :32], 2, dist=dist,
             batched_prefill=True)
    torch.cuda.synchronize()

    # the EP kernels, and the norm and attention kernels the serving blocks
    # share with qwen3 (here MHA: 16 heads, 16 kv heads)
    originals = {n: ops.KERNELS[n] for n in EP_KERNELS + NORM_ATTN_KERNELS}
    recorders = {n: Recorder(c) for n, (c, _) in originals.items()}
    for n, (c, p) in originals.items():
        ops.KERNELS[n] = (recorders[n], p)
    last_decode = record_last_decode(recorders["decode_attention"],
                                     originals["decode_attention"][1])
    cudas = {n: c for n, (c, _) in originals.items()}
    for c in cudas.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        res = generate(cfg, params, prompts, N_GEN, dist=dist,
                       batched_prefill=True)
        after_fp32 = graph_launches({n: c.launches for n, c in cudas.items()},
                                    res)
        res8 = generate(cfg_fp8, params, prompts, N_GEN_FP8, dist=dist,
                        batched_prefill=True)
        launches = graph_launches({n: c.launches for n, c in cudas.items()},
                                  res, res8)
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
              "cuda_graph": r["cuda_graph"], "capture_s": r["capture_s"],
              "graph_replays": r["graph_replays"],
              "launches": counts, "first_tokens": r["tokens"][0].tolist(),
              "init_params_s": init_s, "peak_mem_gb": peak_gb})

    # the same fp32 serve once more, outside the counted window: its
    # tokens/s beside the first run's shows the run-to-run spread
    rep = generate(cfg, params, prompts, N_GEN, dist=dist,
                   batched_prefill=True)
    emit({"phase": "serve_repeat", "wire": "fp32",
          "tokens_per_s": rep["tokens_per_s"],
          "decode_tokens_per_s": rep["decode_tokens_per_s"],
          "ttft_s": rep["ttft_s"], "capture_s": rep["capture_s"]})
    # the eager step beside the captured one: tokens/s, and the tokens
    for c, wire, n_gen in ((cfg, "fp32", N_GEN), (cfg_fp8, "fp8", N_GEN_FP8)):
        eager = generate(c, params, prompts, n_gen, dist=dist,
                         batched_prefill=True, cuda_graph=False)
        emit({"phase": "serve_eager_vs_graph", "wire": wire,
              "eager_decode_tokens_per_s": eager["decode_tokens_per_s"],
              "eager_ttft_s": eager["ttft_s"],
              "graph_decode_tokens_per_s": (res if wire == "fp32" else res8)[
                  "decode_tokens_per_s"],
              **eager_vs_graph(c, params, prompts, n_gen, dist)})
    emit(serve_local_per_token(cfg, params, prompts, dist))
    for prof in profile_serve(cfg, cfg_fp8, params, prompts, dist):
        emit(prof)
    served, x0 = moe_served(cfg, params, prompts, dist)
    emit(served)
    line, new_kernels = ht_unfused(cfg, params, x0, dist)
    emit(line)
    line, cr_kernel = combine_phase(cfg, params, x0, dist)
    emit(line)
    new_kernels.append(cr_kernel)
    del x0

    # ------------------------------------------- EP kernels vs plain -----
    # the prefill's HT call leads where the path makes one (the largest
    # first argument); the capture's LL calls came first
    kernels = [check_kernel(n, recorders[n], launches,
                            lead=lambda a: a[0].numel()) for n in EP_KERNELS]
    kernels += new_kernels
    for k in kernels:
        emit({"phase": "kernel", **k})
    # the norm and attention kernels at this path's shapes; the kernels
    # line carries their entries from the qwen3 path
    with torch.inference_mode():
        for n in NORM_ATTN_KERNELS:
            extra, lead = (), 0
            if n == "decode_attention":   # the last step leads
                extra = decode_cases(last_decode, S)
                lead = len(recorders[n].cases)
            emit({"phase": "kernel", "path": "qwen2_moe_a2_7b",
                  **check_kernel(n, recorders[n], launches, extra, lead)})
        (q, k, v, pos), _ = last_decode[0]
        emit({"phase": "decode_graph", "path": "qwen2_moe_a2_7b",
              **decode_graph_check(q, k, v, (0, int(pos), k.shape[1] - 1))})

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
    del p, x, y_ref
    emit(per_token_fp32(cfg, params, prompts, dist))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
