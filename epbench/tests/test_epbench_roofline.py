"""The frozen arithmetic against hand counts at two shapes: qwen2-moe's
served LL decode dispatch and the reference's served HT layer, (4, 1024,
4) over 16 experts a rank."""
from __future__ import annotations

import math

import pytest
import torch

from epbench import common, roofline

D, F = 2048, 1408
H = roofline.HBM_BYTES_PER_S


def test_grouped_swiglu_ll_decode():
    # 64 experts x (4 ranks x 32 slots); 60 experts hold 32 rows, 4 none
    x = torch.zeros(64, 128, D, dtype=torch.bfloat16)
    w = torch.zeros(64, D, F, dtype=torch.bfloat16)
    wd = torch.zeros(64, F, D, dtype=torch.bfloat16)
    counts = torch.full((64, 4), 8, dtype=torch.int32)
    counts[60:] = 0
    t, work = roofline.kernel_bound("grouped_swiglu", (x, w, w, wd, counts))
    rows = 60 * 32
    nbytes = rows * D * 2 + 60 * 3 * D * F * 2 + 64 * 128 * D * 2 + rows * 8
    assert work["rows"] == rows and work["experts"] == 60
    assert work["bytes"] == nbytes
    assert math.isclose(t, nbytes / H)           # bound by the weights


def test_gather_swiglu_scatter_served_ht():
    # HT at (4, 1024, 4): 16 experts a rank, 64 in all, capacity 128
    T, E, C = 4 * 1024, 64, 128
    x_ext = torch.zeros(T + 1, D, dtype=torch.bfloat16)
    src = torch.zeros(E * C, dtype=torch.int64)
    w_slot = torch.zeros(E * C)
    w = torch.zeros(E, D, F, dtype=torch.bfloat16)
    wd = torch.zeros(E, F, D, dtype=torch.bfloat16)
    counts = torch.full((E,), 100, dtype=torch.int32)
    counts[0] = 500                  # clamped to the capacity
    t, work = roofline.kernel_bound(
        "gather_swiglu_scatter", (x_ext, src, w_slot, w, w, wd, counts))
    rows = 63 * 100 + 128
    nbytes = rows * D * 2 + E * 3 * D * F * 2 + T * D * 4 + rows * 8
    assert work["rows"] == rows and work["bytes"] == nbytes
    assert math.isclose(t, max(nbytes / H, 6.0 * D * F * rows / 989e12))
    tb, wb = roofline.kernel_bound(
        "gather_swiglu_scatter_bwd",
        (x_ext, src, w_slot, w, w, wd, counts, torch.zeros(T, D)))
    nb = (rows * (2 * D + 4 * D + 8) + E * 3 * D * F * 2
          + (T + 1) * D * 2 + E * C * 4 + E * 3 * D * F * 2)
    assert wb["bytes"] == nb and wb["flops"] == 16.0 * D * F * rows
    assert math.isclose(tb, max(nb / H, 16.0 * D * F * rows / 989e12))


def test_wire_kernels():
    x_ext = torch.zeros(11, 256)
    src = torch.tensor([0, 1, 1, 10, 3, 3, 3, 10])   # 2 buckets of 4
    counts = torch.tensor([3, 2])
    t, work = roofline.kernel_bound("gather_quantize",
                                    (x_ext, src, counts))
    # occupied slots 0, 1, 2 | 4, 5 -> rows {0, 1} and {3}: 3 table rows
    assert work["rows"] == 5 and work["table_rows"] == 3
    assert work["bytes"] == 3 * 256 * 4 + 5 * 4 + 2 * 4 + 8 * 256 + 8 * 2 * 4
    q = torch.zeros(8, 256, dtype=torch.uint8)
    _, wq = roofline.kernel_bound("dequantize", (q, torch.zeros(8, 2)))
    assert wq["bytes"] == 8 * 256 * 5 + 16 * 4


@pytest.mark.parametrize("name,total,active", [
    # hand counts: embedding + head (the head alone active), per layer
    # attention (4 D^2 + biases), experts, shared expert, router, two norms
    ("qwen2_moe_a2_7b",
     151936 * 2048 * 2 + 24 * (4 * 2048 * 2048 + 3 * 2048 + 3 * 2048 * 5632
                               + 2048 * 60 + 2 * 2048 + 60 * 3 * 2048 * 1408),
     151936 * 2048 + 24 * (4 * 2048 * 2048 + 3 * 2048 + 3 * 2048 * 5632
                           + 2048 * 60 + 2 * 2048 + 4 * 3 * 2048 * 1408))])
def test_param_counts_and_model_flops(name, total, active):
    from repro_torch.configs import get_config
    conf = common.config_file(name)
    cfg = common.model_config(conf, {})
    assert roofline.param_counts(cfg) == (total, active)
    # the port charges the embedding's lookup as active parameters
    reg = get_config(name)
    assert (total, active + 151936 * 2048) == (reg.param_count(),
                                               reg.active_param_count())
    assert roofline.model_flops(cfg, 4096, "train") == 6.0 * active * 4096
    assert roofline.model_flops(cfg, 128, "forward") == 2.0 * active * 128
    cfg4 = common.model_config(conf, {"layers": 4})
    assert roofline.param_counts(cfg4)[1] == 151936 * 2048 + 4 * (
        (active - 151936 * 2048) // 24)


def test_decode_step_bytes_counts_every_expert_once():
    cfg = common.model_config(common.config_file("qwen2_moe_a2_7b"), {})
    b = roofline.decode_step_bytes(cfg, 128, 255, 60)
    weights = 24 * (4 * 2048 * 2048 + 3 * 2048 + 3 * 2048 * 5632
                    + 60 * 3 * 2048 * 1408) * 2 \
        + 24 * (2048 * 60 * 4 + 2 * 2048 * 4)
    kv = 24 * 128 * 257 * 2 * 2048 * 2
    head = 2048 * 152064 * 2 + 128 * 2048 * 2 + 2048 * 4
    assert b == weights + kv + head + 128 * 152064 * 4
