"""The MLA cell's files at a tiny size on the CPU: the plain reference
(``reference/mla.py``, non-absorbed) against the port's absorbed decode
through the LL dispatch, its capacity and the fp8 wire; the fp8 control
and the planted faults read far over the program's own reading, and the
card's readings in the limits file lie either side of the limit; the
frozen arithmetic (``roofline_mla.py``) against hand counts; the
weights repeat."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from epbench import common, faults, roofline_mla, weights, weights_mla
from epbench import run as R
from epbench.common import model_config
from epbench.reference import mla as RM

CELL = "moonlight-decode-ll-fp8"
# a tiny MLA model: latent 32, RoPE 8, nope 16, v 16; one dense layer,
# two MoE layers of 12 experts (16 padded), top 3, sigmoid scores
MLA_PORT = {"arch_id": "tiny_mla", "n_layers": 3, "d_model": 64,
            "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "d_ff": 128,
            "vocab_size": 512, "qkv_bias": False, "rope_theta": 1e4,
            "norm_eps": 1e-5, "tie_embeddings": False, "kv_lora_rank": 32,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
            "first_k_dense": 1,
            "moe": {"n_experts": 12, "top_k": 3, "n_shared_experts": 2,
                    "d_expert": 32, "d_shared": 64, "moe_every": 1,
                    "aux_loss_weight": 0.01, "router_aux_free_bias": True,
                    "scoring": "sigmoid", "routed_scale": 2.446}}
TINY = dict(batch=8, prompt_len=4, gen_len=8)


def setup(traffic):
    cfg = dataclasses.replace(model_config({"port": MLA_PORT}, traffic),
                              dtype="float32")
    return cfg, RM.sizes(MLA_PORT, traffic)


def fp32_params(cfg, seed):
    p = weights_mla.make_params(cfg, seed, "cpu", torch.bfloat16)
    return torch.utils._pytree.tree_map(lambda t: t.to(torch.float32), p)


@pytest.mark.parametrize("wire", ["fp32", "fp8"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_decode_steps_match_the_reference(wire, cf):
    """The port's absorbed decode steps over an EP world of 4 against the
    reference's full non-absorbed forward, every position's logits."""
    from repro_torch.distributed.sharding import make_dist_ctx
    from repro_torch.models import model_zoo as Z
    tr = {"ep_world": 4, "wire_dtype": wire, "ll_capacity_factor": cf}
    cfg, sz = setup(tr)
    params = fp32_params(cfg, 5)
    # 32 slots an expert at least: 128 x 3 choices over 16 experts
    # overflow some
    B, L = (6, 7) if cf > 1 else (128, 3)
    tokens = torch.randint(0, 512, (B, L), generator=torch.Generator()
                           .manual_seed(1))
    cache = Z.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    dist = make_dist_ctx(cfg, model=4)
    got, dropped = [], []
    with torch.inference_mode():
        for t in range(L):
            logits, _, aux = Z.decode_step(cfg, params, cache,
                                           tokens[:, t:t + 1], t, dist=dist,
                                           moe_mode="ll")
            got.append(logits[:, :512])
            dropped.append(float(aux["dropped"]))
    got = torch.stack(got, 1)
    ref = RM.head(params, RM.hidden(params, tokens, sz, "ll"), sz)
    off = ((got - ref).abs() > 2e-4 + 2e-4 * ref.abs()).any(-1)
    # the absorbed and the non-absorbed forms differ by fp32 round-off
    # before the wire, so now and then the fp8 wire rounds one dispatched
    # value to the other side of an e4m3 step (2^-3 of it): that position's
    # logits move by under 2e-3 (one position of 42 at seed 5)
    assert int(off.sum()) <= (1 if wire == "fp8" else 0), off.nonzero()
    assert torch.allclose(got, ref, atol=2e-3, rtol=2e-3), \
        (got - ref).abs().max()
    # the latent rows the steps wrote are the reference's
    with torch.no_grad():
        h = RM.M.rmsnorm(params["embed"][tokens].float(),
                         params["blocks"][0]["ln1"], sz["eps"])
        rows = RM.latent_rows(h, RM.layer_weights(params["blocks"][0]), sz)
    assert torch.allclose(cache[0]["latent"], rows, atol=1e-5, rtol=1e-5)
    if cf < 1:
        assert max(dropped) > 0       # the capacity rule was exercised


def tiny_run(fault: str = "", control: bool = False):
    c, _, traffic, limits = R.prepare(CELL, common.benchmark())
    traffic = dict(traffic, **TINY)
    ctx = R.make_context(c, {"port": MLA_PORT}, traffic, torch.device("cpu"),
                         2 ** 31 + 99, 0.2, False, control=control)
    undo = faults.plant(fault) if fault else None
    try:
        rec = common.load_module("traffic", traffic["driver"]).run(ctx)
    finally:
        if undo:
            undo()
    return rec, limits


# At the tiny size the numbers lie on another scale than the cell's: a
# 512-token vocabulary's best logit stands ~3 spreads above a random one
# (163,840 tokens: ~4.5), and three layers leave bf16's rounding a
# ``mean_gap`` of ~0.01, where 27 read 1.0 (PERF.md 2).  So here each
# fault and the control are held to the program's own readings at this
# size: some number at least 10 (the control 3) times the program's.
NUMBERS = {"mean_gap", "latent_err"}


@pytest.fixture(scope="module")
def program_checks():
    rec, _ = tiny_run()
    return rec["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged",
                                   "token_altered", "exchange_skipped"])
def test_fault_is_not_correct(fault, program_checks):
    rec, limits = tiny_run(fault)
    assert set(rec["checks"]) == set(limits) == NUMBERS
    assert any(rec["checks"][n] >= 10 * program_checks[n] for n in NUMBERS), \
        (rec["checks"], program_checks)
    if fault == "state_unchanged":       # the latent rows never written
        assert rec["checks"]["latent_err"] == pytest.approx(1.0)


def test_control_is_not_correct(program_checks):
    rec, limits = tiny_run(control=True)
    # the same seed serves the same finished cycle; the rows latent_err
    # reads are the cycle's the window closed in, which the clock decides,
    # so the control is held to this run's own reading of them
    assert rec["checks"]["mean_gap"] == program_checks["mean_gap"]
    for n in NUMBERS:
        assert rec["control"][n] >= 3 * rec["checks"][n], rec


@pytest.mark.parametrize("number", sorted(NUMBERS))
def test_the_card_readings_lie_either_side_of_the_limit(number):
    """The limits file's readings (the card's): the program's largest
    under the limit, the control's smallest over it, each with room."""
    lim = common.limits_file(CELL)[number]
    assert lim["lower"] * 1.2 < lim["limit"] < lim["upper"] / 1.2


def test_roofline_mla_hand_counts():
    from repro_torch.configs import get_config
    cfg = get_config("moonlight_16b_a3b")
    # 27 layers of one 576-value bf16 row
    assert cfg.n_layers * roofline_mla.cache_row_bytes(cfg) == 31_104
    # a layer's MLA: wq 2048 x 16 x 192, w_dkv 2048 x 576, kv_norm 512,
    # w_ukv 512 x 16 x 256, wo 16 x 128 x 2048
    attn = 6_291_456 + 1_179_648 + 512 + 2_097_152 + 4_194_304
    dense = attn + 3 * 2048 * 11_264 + 2 * 2048
    moe_rest = attn + 3 * 2048 * 2816 + 2048 * 64 + 2 * 2048
    expert = 3 * 2048 * 1408
    embed = 163_840 * 2048
    total = 2 * embed + dense + 26 * (moe_rest + 64 * expert)
    active = embed + dense + 26 * (moe_rest + 6 * expert)
    assert roofline_mla.param_counts(cfg) == (total, active)
    assert (total, active) == (15_960_106_496, 2_579_228_160)
    assert cfg.param_count() == total
    # the absorbed attention: 2 x 16 heads x 512 positions x (576 + 512)
    assert roofline_mla.attention_flops(cfg, 511) == 2 * 16 * 512 * 1088
    assert roofline_mla.decode_step_flops(cfg, 2, 0) == 2 * (
        2 * active + 27 * 2 * 16 * 1088)
    # one call at batch 128, pos 1023: bytes bound
    nbytes = (128 * 1024 * 576 + 2 * 128 * 16 * 576 - 128 * 16 * 64) * 2
    assert roofline_mla.mla_kernel_bound(128, 16, 1023, 576, 512) == \
        pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_step_bytes_hand_count():
    from repro_torch.configs import get_config
    cfg = get_config("moonlight_16b_a3b")
    got = roofline_mla.decode_step_bytes(cfg, 128, 511.0, 64.0)
    experts = 26 * 64 * 3 * 2048 * 1408 * 2
    assert experts == 28_789_702_656
    # a layer: its MLA in bf16 but kv_norm (fp32), two fp32 norms
    layer = (13_763_072 - 512) * 2 + 512 * 4 + 2 * 2048 * 4
    dense = 3 * 2048 * 11_264 * 2
    moe = 3 * 2048 * 2816 * 2 + 2048 * 64 * 4      # shared, fp32 router
    rows = 27 * 128 * (511 + 2) * 1152             # live rows, the new one
    head = 2048 * 163_840 * 2 + 128 * 2048 * 2 + 2048 * 4
    logits = 128 * 163_840 * 4
    assert got == 27 * layer + dense + 26 * moe + experts + rows + head + \
        logits
    assert 33.3e9 < got < 33.6e9


def test_weights_repeat_and_have_the_layout():
    cfg, _ = setup({"ep_world": 4})
    a = weights_mla.make_params(cfg, 2 ** 33 + 1, "cpu", torch.bfloat16)
    b = weights_mla.make_params(cfg, 2 ** 33 + 1, "cpu", torch.bfloat16)
    la, lb = weights.leaves(a), weights.leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert set(a["blocks"][0]) == {"ln1", "ln2", "attn", "mlp"}
    assert set(a["blocks"][1]) == {"ln1", "ln2", "attn", "moe"}
    assert a["blocks"][2]["attn"]["kv_norm"].dtype == torch.float32
    assert a["blocks"][2]["moe"]["router_w"].dtype == torch.float32
    assert tuple(a["blocks"][1]["attn"]["w_ukv"].shape) == (32, 4, 32)
    # the port's own parameters have the same leaves and shapes
    from repro_torch.models import model_zoo as Z
    port = Z.init_params(cfg, seed=0, device="cpu")
    shapes = {p: tuple(t.shape) for p, t in weights.leaves(port)}
    assert shapes == {p: tuple(t.shape) for p, t in la}
