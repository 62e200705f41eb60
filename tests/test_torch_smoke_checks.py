"""The checks ``chip_smoke.py`` makes on the card, run on the CPU at a
reduced size, so that the checks themselves are tested: HT at its
configured capacity (with drops) against the dense oracle restricted to
the choices the plan keeps; the launch accounting and decode cases of
a captured decode step; and serve-rdma's helpers: its launch
expectations, the CPU-against-card comparison of the substrate's counters
and output, its host profile, and the recorder of the substrate's
grouped_swiglu calls whose cases join the kernel's entry; serve-engine's
helpers: its config at qwen2-moe's widths and its requests, drive_engine's
per-step rows, the launch check, the CPU-against-card comparison of the
engine's state and outputs, the recorder of its (1, n, D) calls and the
run summary; the lint phase; and the checks of train-elastic (the cross
entropy at two EP degrees, the launch counts, the spread of the losses,
the roofline share), distributed (the compression bounds and bytes, the
collectives bit for bit) and examples (their mains and kernels)."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.moe import moe_apply  # noqa: E402
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402


def _layer(cf: float, skew: float):
    cfg = dataclasses.replace(reduced_config(
        get_config("qwen2_moe_a2_7b"), n_layers=1, d_model=64, n_experts=8),
        dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    params = Z.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    p = {k: v for k, v in params["blocks"][0]["moe"].items() if k != "shared"}
    p["router_b"] = p["router_b"].clone()
    p["router_b"][0] += skew          # expert 0 takes most tokens: it drops
    return cfg, p


@pytest.mark.parametrize("model,S", [(4, 64), (2, 64), (4, 63)])
def test_restricted_oracle_holds_ht_at_its_capacity(model, S):
    """fp32 on the CPU: the HT output at the configured capacity equals the
    restricted oracle up to summation order, and the plan's dropped count
    is HT's; the unrestricted oracle misses by more than the card's
    tolerance, so a check that ignored the drops would fail.  S = 63 does
    not split over the model ranks: the tokens are replicated."""
    cfg, p = _layer(cf=1.0, skew=2.0)
    x = torch.randn((2, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(S))
    dist = make_dist_ctx(cfg, model=model)
    res = chip_smoke.restricted_check(cfg, dist, p, x)
    assert res["dropped"] > 0.05
    assert res["dropped_by_plan"] == pytest.approx(res["dropped"], abs=1e-6)
    assert res["rel_err"] <= 1e-5
    y, _ = moe_apply(cfg, dist, p, x, mode="ht")
    full, _ = moe_apply(cfg, None, p, x, mode="ref")
    miss = float((y - full).abs().max() / full.abs().max())
    assert miss > chip_smoke.MOE_TOL["fp32"]


def test_restricted_oracle_catches_a_lost_choice(monkeypatch):
    """A fault the check must see: HT losing the weight of one kept choice
    per rank (its combine weights zeroed for token 0's first choice)."""
    from repro_torch.core import ep
    cfg, p = _layer(cf=1.0, skew=2.0)
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    dist = make_dist_ctx(cfg, model=4)
    real = ep.dispatch_combine_ht

    def faulty(spec, x_, top_idx, top_w, fn):
        top_w = top_w.clone()
        top_w[:, 0, 0] = 0.0
        return real(spec, x_, top_idx, top_w, fn)
    # the backend imports it from ep at each call
    monkeypatch.setattr(ep, "dispatch_combine_ht", faulty)
    res = chip_smoke.restricted_check(cfg, dist, p, x)
    assert res["rel_err"] > chip_smoke.MOE_TOL["fp32"]


def test_graph_launches_counts_every_replay():
    """A wrapper counts once where Python calls it: at capture for a
    captured step, whose replays each launched it again."""
    counted = {"rmsnorm": 9 + 3 * 9, "decode_attention": 3 * 2,
               "flash_attention": 2}
    res = {"captured_launches": {"rmsnorm": 9, "decode_attention": 2,
                                 "flash_attention": 0},
           "graph_replays": 7}
    eager = {"captured_launches": None, "graph_replays": 0}
    assert chip_smoke.graph_launches(counted, res, eager) == {
        "rmsnorm": 36 + 6 * 9, "decode_attention": 6 + 6 * 2,
        "flash_attention": 2}
    assert chip_smoke.graph_launches(counted, eager) == counted


def test_decode_cases_are_device_positions():
    """The last decode call's inputs at its position, at the first decode
    step's, 0 and S - 1, each a new 0-d int32 on the query's device;
    ``decode_live`` reads either an int or such a tensor."""
    q, k = torch.zeros((2, 4, 8)), torch.zeros((2, 10, 2, 8))
    last = [((q, k, k, torch.tensor(6, dtype=torch.int32)), {})]
    cases = chip_smoke.decode_cases(last, 4)
    assert [int(a[3]) for a, _ in cases] == [6, 4, 0, 9]
    assert all(a[3].dtype == torch.int32 and a[3].dim() == 0
               and a[3] is not last[0][0][3] for a, _ in cases)
    assert [chip_smoke.decode_live(a, kw) for a, kw in cases] == [
        7, 5, 1, 10]
    assert chip_smoke.decode_live((q, k, k, 20), {"start": 15}) == 6


def test_prefill_ln1_leads_rmsnorm():
    """The capture records the decode step's norms before the prefill's:
    the lead key picks the prefill's (B, S, d_model) call over them and
    over the wider (B, S, heads, 128) q/k norms."""
    rec = chip_smoke.Recorder(lambda *a: None)
    for shape in ((2, 1, 16), (2, 1, 4, 8), (2, 6, 16), (2, 6, 4, 8)):
        rec(torch.zeros(shape), torch.ones(shape[-1]), 1e-6)
    key = chip_smoke.prefill_ln1(2, 6, 16)
    cases = list(rec.cases.values())
    best = max(range(len(cases)), key=lambda i: key(cases[i][0]))
    assert tuple(cases[best][0][0].shape) == (2, 6, 16)


@pytest.mark.parametrize("save_states,ms_,by", [(True, 0.2005, "bytes"),
                                                (False, 0.1284, "operations")])
def test_scan_bound_counts_the_saved_states(save_states, ms_, by):
    """The forward's bound at the trained shape (4, 1024, 8192): a call
    that saves the chunk states for the backward, as every training call
    does, also writes (4, 128, 8192, 16) fp32 (268.4 MB beside x, dt and
    y's 402.7 MB), and its bytes then bound it, above the exponentials'
    0.128 ms; without them the exponentials bound it."""
    Bt, S, Di, N = 4, 1024, 8192, 16
    meta = dict(device="meta")
    args = (torch.empty((Bt, S, Di), **meta), torch.empty((Bt, S, Di), **meta),
            torch.empty((Di, N), **meta), torch.empty((Bt, S, N), **meta),
            torch.empty((Bt, S, N), **meta), torch.empty((Di,), **meta))
    bound_ms, bound_by, work = chip_smoke.scan_bound(
        "mamba_scan", args, save_states=save_states)
    assert bound_by == by
    assert bound_ms == pytest.approx(ms_, rel=2e-3)
    states_bytes = 4 * Bt * (S // 8) * Di * N
    assert work["bytes"] - 4 * (3 * Bt * S * Di + 2 * Bt * S * N
                                + Di * N + Di) == (
        states_bytes if save_states else 0)
    assert work["exp_ms"] == pytest.approx(0.1284, rel=2e-3)


@pytest.mark.parametrize("dense", [True, False])
def test_gather_quantize_bound_reads_each_named_row_once(dense):
    """The wire's send half reads each table row its occupied slots name
    once, however many slots name it: the HT dispatch sends a token once to
    every rank its choices reach and fills the rest with the scratch row,
    the LL one once a choice.  Every slot's bytes and scales are written."""
    T, D, n = 8, 256, 64
    x_ext = torch.zeros((T + 1, D))
    src = torch.arange(n) % (T + 1)                 # each row named ~7 times
    counts = None if dense else torch.tensor([16, 0, 3, 1], dtype=torch.int32)
    bound_ms, bound_by, work = chip_smoke.bound(
        "gather_quantize", (x_ext, src, counts), {})
    occ = n if dense else 20
    named = T + 1 if dense else len(set((src[:16].tolist() + src[32:35].tolist()
                                          + src[48:49].tolist())))
    assert work["occupied_slots"] == occ
    assert work["table_rows_read"] == named
    nbytes = (named * D * 4 + occ * 4 + (0 if dense else 16)
              + n * D + n * 2 * 4)
    assert work["bytes"] == nbytes
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("pos", [0, 511, 1023])
def test_mla_bound_and_library_call(pos):
    """mla_decode's bound in chip_smoke is the benchmark's frozen one (the
    live rows, q and the output over the memory rate, at the cell's batch
    and rows), and its library call (SDPA over the live rows, each row
    every head's key, its first 512 values the value) computes what the
    plain version does."""
    from epbench import roofline_mla
    from repro_torch.kernels import mla
    B, S = 128, 1024
    q = torch.zeros((B, 16, 576), dtype=torch.bfloat16)
    cache = torch.zeros((B, S, 576), dtype=torch.bfloat16)
    kw = {"scale": 192 ** -0.5, "v_dim": 512}
    bound_ms, bound_by, work = chip_smoke.bound(
        "mla_decode", (q, cache, torch.tensor(pos, dtype=torch.int32)), kw)
    assert bound_by == "bytes"
    assert work["live_rows"] == B * (pos + 1)
    assert bound_ms == pytest.approx(
        roofline_mla.mla_kernel_bound(B, 16, pos, 576, 512) * 1e3, rel=1e-12)
    g = torch.Generator().manual_seed(pos)
    q = torch.randn((2, 16, 576), generator=g)
    cache = torch.randn((2, 40, 576), generator=g)
    p = torch.tensor(min(pos, 39), dtype=torch.int32)
    got = chip_smoke.library_call("mla_decode", (q, cache, p), kw)()
    want = mla.mla_decode_plain(q, cache, p, **kw)
    assert torch.allclose(got[:, :, 0], want, atol=1e-5, rtol=1e-5)


def test_profile_gap_splits_the_difference_by_activity():
    """profile_gap: the busy time, each kind and each activity of one
    profile against another of the same step, largest excess first,
    activities within 5 us left out, the by-name rows dropped."""
    def prof(busy, kinds, named):
        return {"device_busy_ms": busy,
                "device_ms_by_kind": {k: {"device_ms": v, "calls": 1}
                                      for k, v in kinds.items()},
                "device_by_name": named}
    fp8 = prof(14.7, {"wire kernels": 0.42, "copies and casts": 3.9},
               {"gather_quantize_kernel": [0.11, 24],
                "dequantize_kernel": [0.31, 24], "copy_kernel": [3.9, 900],
                "same": [1.0, 3], "close": [0.5, 1]})
    fp32 = prof(13.5, {"copies and casts": 2.8, "other": 0.2},
                {"copy_kernel": [2.8, 800], "index_kernel": [0.2, 24],
                 "same": [1.0, 3], "close": [0.503, 1]})
    gap = chip_smoke.profile_gap(fp8, fp32)
    assert "device_by_name" not in fp8 and "device_by_name" not in fp32
    assert gap["device_busy_ms"] == pytest.approx(1.2)
    assert gap["device_ms_by_kind"] == pytest.approx(
        {"wire kernels": 0.42, "copies and casts": 1.1, "other": -0.2})
    names = [r["name"] for r in gap["activities"]]
    assert names == ["copy_kernel", "dequantize_kernel",
                     "gather_quantize_kernel", "index_kernel"]
    assert gap["activities"][0]["kind"] == "copies and casts"
    assert gap["activities"][1]["kind"] == "wire kernels"


CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _bwd_pass_tags():
    """The pass tags of csrc/swiglu_bwd.cu, each the name of its kernel."""
    import re
    text = (CSRC / "swiglu_bwd.cu").read_text()
    return re.findall(r"struct (\w+) \{ static constexpr int kEpi", text)


def test_device_kinds_tell_the_swiglu_backward_from_the_forwards():
    """DEVICE_KINDS books the SwiGLU backward's kernels, which run the tile
    loop of the forwards (``swiglu_tiles::Args`` in their names), as "EP
    backward kernels", and the forwards' as "EP kernels", by the names the
    profiler gives them; bwd_passes splits the backward by pass."""
    tags = _bwd_pass_tags()
    assert tags == ["dhu", "up", "dx", "dx_add", "dw_up", "dw_down"]
    maps = ", ".join(["CUtensorMap_st"] * 4)
    bwd = [f"void swiglu_bwd::pass<swiglu_bwd::{t}>({maps}, "
           f"swiglu_tiles::Args)" for t in tags]
    bwd.append("void swiglu_bwd::gather_rows(__nv_bfloat16 const*, int "
               "const*, float const*, int const*, float const*, "
               "__nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, int, int, "
               "int, int)")
    bwd.append("void swiglu_bwd::compact_rows(__nv_bfloat16 const*, "
               "__nv_bfloat16 const*, int const*, __nv_bfloat16*, "
               "__nv_bfloat16*, int*, int*, __nv_bfloat16*, int, int, int, "
               "int, int)")
    fwd = [f"void swiglu_tiles::tile_kernel<{e}, {g}>(CUtensorMap_st, "
           f"CUtensorMap_st, CUtensorMap_st, swiglu_tiles::Args)"
           for e, g in ((0, "false"), (0, "true"), (1, "false"),
                        (2, "false"))]
    for name in bwd:
        assert chip_smoke.device_kind(name) == "EP backward kernels", name
    for name in fwd:
        assert chip_smoke.device_kind(name) == "EP kernels", name
    for name in ("void (anonymous namespace)::gather_quantize_bwd_kernel("
                 "float const*, int const*, int const*, float const*, "
                 "float*, int, int, int, int)",
                 "void (anonymous namespace)::dequantize_bwd_kernel("
                 "unsigned char const*, float const*, float*, int, int, "
                 "int, int)"):
        assert chip_smoke.device_kind(name) == "wire backward kernels"
    # 4 calls, a record of some lost: each pass's mean over its records
    by_name = {n: [0.5 * (i + 1), 4 - i % 2] for i, n in enumerate(bwd + fwd)}
    passes = chip_smoke.bwd_passes(by_name)
    assert list(passes) == tags + ["gather_rows", "compact_rows"]
    for i, t in enumerate(tags + ["gather_rows", "compact_rows"]):
        assert passes[t] == {
            "device_ms": pytest.approx(0.5 * (i + 1) / (4 - i % 2)),
            "records": 4 - i % 2}


def _plant_faults():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "scripts" / "plant_faults.py"
    spec = importlib.util.spec_from_file_location("plant_faults", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLANT = _plant_faults()


@pytest.mark.parametrize("fault", sorted(PLANT.FAULTS))
def test_planted_fault_anchor_occurs_once(fault):
    """Each fault of scripts/plant_faults.py replaces text that occurs
    exactly once in its file (its run() refuses anything else, but only
    on the card), and the replacement changes the file."""
    path, old, new = PLANT.FAULTS[fault]
    text = (Path(__file__).resolve().parents[1] / path).read_text()
    assert text.count(old) == 1
    assert old != new


def test_placement_checks_hold_a_reduced_moonshot(monkeypatch):
    """``placement_checks`` on the CPU (fp32, the plain versions standing
    in for the kernels, no timing): a reduced moonshot layer (top 6 of 16
    experts) under the greedy placement of its routed load and two
    replicas an expert, at the HT and LL shapes, within the oracle's
    tolerance, nothing dropped, a load per physical slot; the identity
    placement bit for bit with none.  The kernel launches it requires come
    from the CUDA wrappers, so they are stubbed to count here."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(reduced_config(
        get_config("moonshot_v1_16b_a3b"), n_layers=1, d_model=64,
        n_experts=16), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=6))
    params = Z.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, n=20, warmup=3: 0.0)
    monkeypatch.setattr(chip_smoke, "MOONSHOT_PHYSICAL", 20)
    for n in ("grouped_swiglu", "gather_swiglu_scatter"):
        cuda, plain = ops.KERNELS[n]

        def counting(*a, plain=plain, cuda=cuda, **kw):
            cuda.launches += 1
            return plain(*a, **kw)
        monkeypatch.setitem(ops.KERNELS, n, (cuda, counting))
    line = chip_smoke.placement_checks(cfg, params, x,
                                       make_dist_ctx(cfg, model=4))
    assert [(c["placement"], c["mode"]) for c in line["cases"]] == [
        ("greedy", "ht"), ("greedy", "ll"), ("uniform2", "ht"),
        ("uniform2", "ll")]
    for c in line["cases"]:
        assert c["rel_err"] <= 1e-5 and c["dropped"] == 0.0
        assert len(c["load_phys"]) == c["physical_slots"]
    assert all(v["bit_identical"] for v in line["identity_vs_none"].values())


def test_path_cases_lists_only_tagged_cases():
    """``add_cases`` tags the cases of a path (serve-dense-wide's models);
    the kernels line lists those, their numbers only."""
    entry = {"cases": [{"ms": 1.0, "shapes": [[4, 1]], "device_traces": []},
                       {"ms": 0.0123456789, "path": "musicgen_large (48 layers)",
                        "shapes": [[4, 1024, 32, 64], [4, 1024, 32, 64]],
                        "launches": 7, "device_traces": [{"calls": 10}],
                        "work": {"bytes": 1}}]}
    assert chip_smoke.path_cases(entry) == [
        {"shape": [4, 1024, 32, 64], "path": "musicgen_large (48 layers)",
         "launches": 7, "ms": 0.0123457}]
    assert chip_smoke.path_cases({"cases": entry["cases"][:1]}) == []


def test_dense_wide_cuts_and_positions():
    """qwen2-72b is cut to the 32 layers that fit the card with room for
    the cache (30.58B parameters, 61.2 GB in bf16); the paged cases'
    positions lie in the last decode step's cache, and each replayed
    position is at most that of the sequence whose table row it takes
    over, so no NaN row of the pools is ever live."""
    cut = dataclasses.replace(get_config("qwen2_72b"),
                              n_layers=chip_smoke.DENSE_LAYERS["qwen2_72b"])
    assert round(cut.param_count() / 1e9, 2) == 30.58
    assert 2 * cut.param_count() / 1e9 < 62
    for arch in chip_smoke.DENSE_WIDE:
        if arch not in chip_smoke.DENSE_LAYERS:
            assert 2 * get_config(arch).param_count() / 1e9 < 40
    last = chip_smoke.DENSE_PROMPT + chip_smoke.DENSE_GEN - 2
    assert max(chip_smoke.DENSE_PAGED_POS) == last
    for new, old in zip(chip_smoke.DENSE_PAGED_REPLAY_POS,
                        chip_smoke.PAGED_REPLAY_ORDER):
        assert 0 <= new <= chip_smoke.DENSE_PAGED_POS[old]


@pytest.mark.parametrize("arch", ["musicgen_large", "internvl2_26b"])
def test_dense_plain_check_on_the_cpu(arch):
    """``dense_plain_check`` on a reduced config on the CPU, where the
    kernels' plain versions stand in on both sides: the prefill and the
    decode step agree exactly, within the limit."""
    cfg = dataclasses.replace(reduced_config(get_config(arch), d_model=64),
                              dtype="float32")
    params = Z.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(0))
    line = chip_smoke.dense_plain_check(cfg, params, prompts)
    assert line["tokens"] == [2, 12]
    for what in ("prefill", "decode"):
        assert line[what]["rel_err"] == 0.0
        assert line[what]["argmax_agree"] == 1.0


# ------------------------------------------------------------ serve-rdma --
def test_rdma_launch_expectations():
    """serve-rdma's launch check: its four kernels each > 0, the three the
    substrate must not reach each exactly 0; any miss raises."""
    ok = {"grouped_swiglu": 96, "flash_attention": 24,
          "decode_attention": 264, "rmsnorm": 600,
          "gather_swiglu_scatter": 0, "gather_quantize": 0, "dequantize": 0}
    chip_smoke.rdma_launch_check(ok)
    for n in chip_smoke.RDMA_KERNELS:
        with pytest.raises(AssertionError, match=n):
            chip_smoke.rdma_launch_check({**ok, n: 0})
    for n in chip_smoke.RDMA_IDLE_KERNELS:
        with pytest.raises(AssertionError, match=n):
            chip_smoke.rdma_launch_check({**ok, n: 1})
    with pytest.raises(AssertionError, match="dequantize"):
        chip_smoke.rdma_launch_check({k: v for k, v in ok.items()
                                      if k != "dequantize"})


def _rdma_layer():
    cfg = dataclasses.replace(reduced_config(
        get_config("qwen2_moe_a2_7b"), n_layers=1, d_model=64, n_experts=8),
        dtype="float32")
    params = Z.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    p = {k: v for k, v in params["blocks"][0]["moe"].items() if k != "shared"}
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    return cfg, p, x


@pytest.mark.parametrize("mode", ["ht", "ll"])
def test_substrate_counters_compare(mode):
    """The CPU-against-card comparison: two runs of the substrate on one
    routing give equal counters and outputs (relative error 0); a run whose
    expert outputs are doubled keeps the counters and is caught by its
    output, and a world whose traffic differs (another wire) by its
    counters."""
    from repro_torch.core import moe as moe_mod
    from repro_torch.core.backend import get_backend
    from repro_torch.core.routing import RouterParams, route
    cfg, p, x = _rdma_layer()
    dist = make_dist_ctx(cfg, model=4)
    t = x.reshape(-1, cfg.d_model)
    rout = route(cfg.moe, RouterParams(p["router_w"], p.get("router_b")), t,
                 cfg.moe.n_experts)
    args = (t.numpy(), rout.top_idx.numpy(), rout.top_w.numpy())
    spec = moe_mod.make_ep_spec(cfg, dist, mode=mode)
    fn = moe_mod._host_expert_fn(p["w_gate"], p["w_up"], p["w_down"])

    def run(s, f):
        be = get_backend("simulated_rdma")
        out = be.dispatch_combine(s, *args, f)
        return chip_smoke.substrate_counters(be.last_world), out.out
    tol = chip_smoke.MOE_TOL["fp32"]
    got = [run(spec, f) for f in
           (fn, fn, lambda toks, counts=None: fn(toks, counts) * 2.0)]
    c0 = got[0][0]
    assert c0["cmds"] > 0 and c0["msgs"] > 0
    assert c0["drains"] >= 1 and c0["wire_bytes"] > 0
    same = chip_smoke.same_world(got[0], got[1], mode, tol)
    assert same == {**got[1][0], "out_rel_err": 0.0, "out_tol": tol}
    assert got[2][0] == c0
    with pytest.raises(AssertionError, match="output"):
        chip_smoke.same_world(got[0], got[2], mode, tol)
    other = run(dataclasses.replace(spec, wire_dtype="fp8"), fn)
    with pytest.raises(AssertionError, match="dispatch_wire_bytes"):
        chip_smoke.same_world(got[0], other, mode, tol)


def test_host_profile_lists_own_time():
    """serve-rdma's host profile: the call's seconds and its functions by
    own time, the heaviest first."""
    import numpy as np

    def work():
        np.sort(np.random.default_rng(0).random(200_000))
    prof = chip_smoke.host_profile(work, top=3)
    assert prof["profiled_s"] > 0 and 1 <= len(prof["top_own"]) <= 3
    own = [r["own_s"] for r in prof["top_own"]]
    assert own == sorted(own, reverse=True)
    assert all(r["calls"] >= 1 and ":" in r["fn"] for r in prof["top_own"])


def test_substrate_calls_recorder_cases():
    """The recorder of the substrate's grouped_swiglu calls keeps LL's
    first call (bucketed counts) and HT's (flat counts), in that order,
    whatever order they came in; the weights by reference, the rest
    copied; it raises when a kind is missing.  The kept inputs reproduce
    the recorded call's output through the plain version."""
    from repro_torch.core import moe as moe_mod
    from repro_torch.kernels import grouped_matmul as gm
    cfg, p, x = _rdma_layer()
    weights = frozenset(p[k].data_ptr() for k in ("w_gate", "w_up",
                                                  "w_down"))
    rec = chip_smoke.SubstrateCalls(gm.grouped_swiglu_plain, weights)
    from repro_torch.kernels import ops
    original = ops.KERNELS["grouped_swiglu"]
    ops.KERNELS["grouped_swiglu"] = (original[0], rec)  # CPU runs "plain"
    try:
        with torch.no_grad():
            with pytest.raises(AssertionError, match="ll"):
                moe_mod.moe_apply(cfg, None, p, x, mode="ht",
                                  backend="simulated_rdma")
                rec.path_cases()
            moe_mod.moe_apply(cfg, None, p, x, mode="ll",
                              backend="simulated_rdma")
    finally:
        ops.KERNELS["grouped_swiglu"] = original
    (ll, _), (ht, _) = rec.path_cases()
    E = p["w_gate"].shape[0]
    assert ll[4].shape == (E, 4) and ht[4].shape == (E,)
    assert ll[1] is p["w_gate"] and ht[3] is p["w_down"]
    assert rec.calls > 2
    for args in (ll, ht):
        assert int(args[4].sum()) > 0
        y = gm.grouped_swiglu_plain(*args)
        assert y.shape == args[0].shape and torch.isfinite(y).all()


def test_layer_times_summary():
    rows = [(0.5, 2.0, 4), (0.25, 1.0, 3),        # prefill, 2 layers
            (0.1, 0.2, 1), (0.3, 0.4, 1),         # decode step 1
            (0.2, 0.6, 1), (0.1, 0.2, 1)]         # decode step 2
    out = chip_smoke.layer_times(rows, 2)
    assert [o["layer"] for o in out] == [0, 1]
    assert out[0]["prefill_host_s"] == 0.5 and out[1]["prefill_kernel_calls"] == 3
    assert out[0]["decode_host_s"] == pytest.approx(0.15)
    assert out[1]["decode_kernel_ms"] == pytest.approx(0.3)


@pytest.mark.parametrize("model,S", [(4, 8), (4, 6)])
def test_pinned_prefill_lays_the_choices_out_per_rank(model, S):
    """serve-rdma's prefill comparison: the substrate's routing choices
    (its tokens row-major) replayed in the collectives' run (their tokens
    laid out over the ranks, the sequence split when the ranks divide it,
    else replicated); in fp32 the two agree to summation order and no
    router would have chosen otherwise.  A wrong layout would mix tokens'
    choices and miss by far more."""
    cfg = dataclasses.replace(reduced_config(
        get_config("qwen2_moe_a2_7b"), n_layers=2, d_model=64, n_experts=8),
        dtype="float32")
    rdma = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_backend="simulated_rdma"))
    coll = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = Z.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (4, S),
                            generator=torch.Generator().manual_seed(S))
    res = chip_smoke.pinned_prefill(rdma, coll, params, prompts,
                                    make_dist_ctx(cfg, model=model))
    assert res["router_calls"] == cfg.n_layers
    assert res["routing_choices_differing"] == 0
    assert res["rel_err"] <= 1e-5 and res["unpinned_rel_err"] <= 1e-5
    assert res["argmax_agree"] == 1.0


# ---------------------------------------------------------- serve-engine --
def _tiny_engine_cfg(**over):
    """serve-engine's config cut to a CPU test's size (2 layers, 8 experts,
    d_model 64), the phase's geometry kept."""
    return chip_smoke.engine_config(**{"n_layers": 2, "n_experts": 8,
                                       "d_model": 64, "d_ff": 32,
                                       "token_budget": 16,
                                       "prefill_chunk": 8, **over})


def test_engine_config_takes_qwen2_moe_widths():
    from repro.serving import EngineConfig as RConfig
    cfg = chip_smoke.engine_config()
    m = get_config("qwen2_moe_a2_7b")
    assert (cfg.n_layers, cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff) \
        == (24, 60, 4, 2048, 1408) == (m.n_layers, m.moe.n_experts,
                                       m.moe.top_k, m.d_model,
                                       m.moe.d_expert)
    assert (cfg.ep_degree, cfg.token_budget, cfg.prefill_chunk,
            cfg.block_size, cfg.n_blocks, cfg.nonmoe_us, cfg.step_mode) == (
        4, 32, 16, 16, 512, 12.0, "pipelined")
    b = chip_smoke.engine_config(wire_dtype="fp8", replicas_per_expert=2,
                                 route_alpha=1.0)
    assert b.n_experts * b.replicas_per_expert == 120
    # the reference's config takes the same fields and checks
    RConfig(**dataclasses.asdict(b))
    from repro_torch.serving import poisson_arrivals
    reqs = chip_smoke.engine_requests(chip_smoke.ENGINE_STREAM)
    assert reqs == poisson_arrivals(2000.0, 32, seed=7, prompt_len=(24, 48),
                                    gen_len=(8, 32))
    assert chip_smoke.engine_requests(16) == reqs[:16]
    assert (chip_smoke.ENGINE_REQUESTS, chip_smoke.ENGINE_B_REQUESTS) == (
        16, 8)


def _driven(over=None, n=6, steps=1 << 30):
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(_tiny_engine_cfg(**(over or {})), device="cpu")
    rows = chip_smoke.drive_engine(eng, chip_smoke.engine_requests(n),
                                   max_steps=steps)
    return eng, rows


def test_drive_engine_rows_and_summary():
    """drive_engine's rows, one a step: host seconds, the wrapper's launches
    (0 on the CPU, where the plain version runs), the executor's launched
    experts (at most a layer's experts times the layers); the summary's
    event-clock stats are the engine's."""
    eng, rows = _driven()
    st = eng.stats()
    assert len(rows) == st["steps"] and st["sched_completed"] == 6
    assert all(r["host_s"] > 0 and r["launches"] == 0
               and 0 < r["experts"] <= 2 * 8 and r["device_ms"] is None
               for r in rows)
    summ = chip_smoke.engine_summary(eng, rows)
    assert summ["steps"] == len(rows)
    assert summ["event_clock"]["tokens_per_s"] == st["tokens_per_s"]
    assert summ["event_clock"]["kv_high_water"] == st["kv_high_water"]
    assert summ["host_s_per_step_max"] >= summ["host_s_per_step_median"]
    assert summ["kernel_event_ms_per_step_median"] is None
    # a step run under the profiler counts in the launches, not in the
    # host seconds
    rows[0]["profiled"], rows[0]["host_s"] = True, 1e9
    again = chip_smoke.engine_summary(eng, rows)
    assert again["host_s_per_step_max"] < 1e9
    assert again["grouped_swiglu_launches"] == summ["grouped_swiglu_launches"]
    part, rows2 = _driven(steps=2)
    assert len(rows2) == 2 and part.stats()["steps"] == 2
    assert [r["experts"] for r in rows2] == [r["experts"] for r in rows[:2]]


def test_engine_launch_check():
    rows = [{"launches": 7, "experts": 7}, {"launches": 3, "experts": 3}]
    ok = {"grouped_swiglu": 10, "gather_swiglu_scatter": 0,
          "grouped_swiglu_db": 0}
    chip_smoke.engine_launch_check(rows, ok)
    with pytest.raises(AssertionError, match="executor"):
        chip_smoke.engine_launch_check(
            [rows[0], {"launches": 2, "experts": 3}], ok)
    with pytest.raises(AssertionError, match="executor"):
        chip_smoke.engine_launch_check(
            rows + [{"launches": 0, "experts": 0}], ok)
    with pytest.raises(AssertionError, match="only grouped_swiglu"):
        chip_smoke.engine_launch_check(rows, {**ok, "grouped_swiglu_db": 1})
    with pytest.raises(AssertionError, match="only grouped_swiglu"):
        chip_smoke.engine_launch_check(rows, {**ok, "grouped_swiglu": 11})


def test_same_engine_compares_state_and_outputs():
    """Two CPU engines after the same steps hold the same state and
    outputs; one step more, or outputs moved by more than the tolerance,
    is caught."""
    import numpy as np
    a, _ = _driven(steps=2)
    b, _ = _driven(steps=2)
    tol = chip_smoke.MOE_TOL["fp32"]
    pair = lambda e: (chip_smoke.engine_state(e), e.last_outs)  # noqa: E731
    same = chip_smoke.same_engine(pair(a), pair(b), tol)
    assert same["steps"] == 2 and same["last_layer_rel_err"] == 0.0
    c, _ = _driven(steps=3)
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.same_engine(pair(a), pair(c), tol)
    moved = [o.copy() for o in b.last_outs]
    moved[-1] = moved[-1] + 2 * tol * np.abs(moved[-1]).max()
    with pytest.raises(AssertionError, match="outputs"):
        chip_smoke.same_engine(pair(a), (chip_smoke.engine_state(b), moved),
                               tol)
    # an earlier layer's outputs are not the ones held
    early = [o + 1.0 for o in b.last_outs[:-1]] + [b.last_outs[-1]]
    chip_smoke.same_engine(pair(a), (chip_smoke.engine_state(b), early), tol)


def test_engine_calls_recorder_cases():
    """The recorder of the engine's grouped_swiglu calls: one call an
    expert with rows, each (1, n, D); it keeps copies of the first call's
    inputs, the first with one row and the one with the most rows, whose
    plain output reproduces the call's."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops
    original = ops.KERNELS["grouped_swiglu"]
    rec = chip_smoke.EngineCalls(original[1])
    ops.KERNELS["grouped_swiglu"] = (original[0], rec)   # CPU runs "plain"
    try:
        eng, rows = _driven()
    finally:
        ops.KERNELS["grouped_swiglu"] = original
    assert rec.calls == sum(r["experts"] for r in rows)
    assert set(rec.cases) == {"first", "most_rows", "one_row"}
    (first, _), (one, _), (most, _) = (rec.cases[k] for k in
                                       ("first", "one_row", "most_rows"))
    assert one[0].shape == (1, 1, 64) and first[0].shape[0] == 1
    assert most[0].shape[1] >= first[0].shape[1] > 0
    assert most[1].shape == (1, 64, 32) and most[4] is None
    assert most[1].data_ptr() != eng._wg.data_ptr()      # a copy
    assert len(rec.path_cases()) == 3
    for args in (first, one, most):
        y = gm.grouped_swiglu_plain(*args)
        assert y.shape == args[0].shape and torch.isfinite(y).all()


def test_lint_phase_clean_and_failing(tmp_path):
    line = chip_smoke.lint_phase()
    assert line["phase"] == "lint" and line["findings"] == []
    assert line["files"] > 50
    (tmp_path / "k.cu").write_text(
        "__global__ void k(const float* x, const int* cnt, float* y) {\n"
        "  y[threadIdx.x] = x[threadIdx.x];\n}\n")
    with pytest.raises(AssertionError, match="LNT-CU-OCC"):
        chip_smoke.lint_phase(tmp_path)


# ------------------------------------------ train-elastic, distributed --
def test_loss_agreement_limit():
    """The cross entropies of two EP degrees agree within a share of the
    first; past it, or non-finite, they fail."""
    tol = chip_smoke.ELASTIC_LOSS_TOL
    assert chip_smoke.loss_agreement(2.0, 2.0, tol) == 0.0
    assert chip_smoke.loss_agreement(2.0, 2.0 * (1 + tol / 2), tol) \
        == pytest.approx(tol / 2)
    with pytest.raises(AssertionError, match="differ by"):
        chip_smoke.loss_agreement(2.0, 2.0 * (1 + 2 * tol), tol)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.loss_agreement(2.0, float("nan"), tol)
    # a flipped bf16 rounding moves a value by 2^-8 of itself: the limit
    # sits below one such move of the whole loss
    assert tol < 2.0 ** -8


def test_losses_at_degrees_agree_in_fp32():
    """``losses_at_degrees`` on a reduced qwen2-moe in fp32 (the plain
    versions): every capacity lifted, nothing dropped, the cross entropy
    at EP 4 and EP 2 equal within fp32 rounding, well inside
    ``ELASTIC_LOSS_TOL``; the aux losses differ (a per-rank statistic)."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    cfg = dataclasses.replace(reduced_config(
        get_config("qwen2_moe_a2_7b"), n_layers=2, d_model=64,
        n_experts=8), dtype="float32")
    params = Z.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = synth_batch(DataConfig(vocab_size=512, batch=2, seq_len=32,
                                   seed=0), 0)
    at = chip_smoke.losses_at_degrees(
        cfg, params, batch, (make_dist_ctx(cfg, model=4),
                             make_dist_ctx(cfg, model=2)), 64)
    assert at["cf"] == 16 / cfg.moe.top_k
    assert chip_smoke.loss_agreement(at[4][0], at[2][0], 1e-6) <= 1e-6
    assert at[4][1] != at[2][1]


def test_require_launches_and_within_spread():
    chip_smoke.require_launches({"a": 3, "b": 1}, ("a", "b"), "run")
    with pytest.raises(AssertionError, match=r"\['b'\] were not launched"):
        chip_smoke.require_launches({"a": 3, "b": 0}, ("a", "b"), "run")
    with pytest.raises(AssertionError, match=r"\['c'\]"):
        chip_smoke.require_launches({"a": 3}, ("a", "c"), "run")
    # the last losses before a re-mesh fall 3.0, 2.5, 2.2 (spread 0.8)
    assert chip_smoke.within_spread(2.0, [3.0, 2.5, 2.2]) == {
        "gap": pytest.approx(0.2), "spread": pytest.approx(0.8)}
    assert chip_smoke.within_spread(2.9, [3.0, 2.5, 2.2])["gap"] <= 0.8
    for bad in (3.1, 1.3, float("nan")):
        with pytest.raises(AssertionError, match="spread"):
            chip_smoke.within_spread(bad, [3.0, 2.5, 2.2])


def test_roofline_share_counts_six_n_active_tokens():
    """6 N_active tokens over a step's seconds at the bf16 peak: at
    qwen2-moe's full width and 4 layers, 0.967B active parameters."""
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"), n_layers=4)
    r = chip_smoke.roofline_share(cfg, 0.5, 4, 1024)
    assert r["model_flops"] == 6.0 * cfg.active_param_count() * 4096
    assert 0.96e9 < cfg.active_param_count() < 0.97e9
    assert r["ideal_s"] == pytest.approx(r["model_flops"] / 989e12)
    assert r["peak_share"] == pytest.approx(r["ideal_s"] / 0.5)


def test_compression_checks_bounds():
    """The reference test's bounds hold for the compressed mean and fail
    for a mean past them, or a second round that undoes the feedback."""
    from repro_torch.distributed.compression import ef_compressed_mean
    g = torch.randn((4, 4 * 256 * 4), generator=torch.Generator()
                    .manual_seed(0))
    true = g.mean(0)
    mean, res = ef_compressed_mean(g)
    mean2, _ = ef_compressed_mean(g, res)
    out = chip_smoke.compression_checks(mean, mean2, true)
    assert 0 < out["max_abs_err"] < out["limit"]
    assert out["two_round_mean_err"] <= out["ef_limit"]
    with pytest.raises(AssertionError, match="out of bounds"):
        chip_smoke.compression_checks(mean + 1.0, mean2, true)
    # a second round farther from the true mean than the first fails
    worse = mean + 1.2 * (mean - true)
    with pytest.raises(AssertionError, match="out of bounds"):
        chip_smoke.compression_checks(mean, worse, true)


def test_ring_bytes_counts_the_wire():
    b = chip_smoke.ring_bytes(4, 1 << 26)
    chunk = (1 << 26) // 4
    assert b["int8_reduce_scatter"] == 12 * (chunk + chunk // 256 * 4)
    assert b["fp32_all_gather"] == 12 * chunk * 4
    assert b["fp32_ring_all_reduce"] == 2 * b["fp32_all_gather"]
    assert b["reduce_scatter_ratio"] == pytest.approx(4 / (1 + 4 / 256))


def test_sp_checks_pass_and_catch_a_wrong_order(monkeypatch):
    """The collectives' bit-for-bit checks pass on the port and fail when
    the reduce-scatter sums its ranks in another order."""
    from repro_torch.distributed import collectives as col
    g = torch.Generator().manual_seed(1)
    cfg = reduced_config(get_config("qwen2_moe_a2_7b"), n_layers=1)
    dist = make_dist_ctx(cfg, model=4)
    x, ct = (torch.randn((2, 16, 8), generator=g) for _ in range(2))
    parts = torch.randn((1, 4, 2, 16, 8), generator=g)
    chip_smoke.sp_checks(dist, x, ct, parts)

    def reversed_order(xs):
        G, M, b, S, D = xs.shape
        parts = xs.reshape(G, M, b, M, S // M, D)
        acc = parts[:, M - 1]
        for j in range(M - 2, -1, -1):
            acc = acc + parts[:, j]
        return acc.permute(0, 2, 1, 3, 4).contiguous()
    monkeypatch.setattr(col, "reduce_scatter_seq", reversed_order)
    with pytest.raises(AssertionError, match="not bit for bit"):
        chip_smoke.sp_checks(dist, x, ct, parts)


def test_examples_and_their_kernels():
    """Every example the examples phase runs has a ``main`` taking an
    argument list, its arguments parse, and the kernels it must launch
    are registered kernels with an entry in the kernels line."""
    import importlib

    from repro_torch.kernels import ops
    assert set(chip_smoke.EXAMPLE_KERNELS) == {
        "quickstart", "serve_decode", "train_moe_e2e", "elastic_restart"}
    for ex, names in chip_smoke.EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"repro_torch.examples.{ex}")
        assert callable(mod.main)
        assert all(n in ops.KERNELS and n in chip_smoke.KERNEL_INFO
                   for n in names)
    assert set(chip_smoke.EXAMPLE_ARGS) <= set(chip_smoke.EXAMPLE_KERNELS)


def test_elastic_example_summary_holds_the_reference_counts():
    """examples: elastic_restart's summary reports its step counts and
    raises unless they are 60, 120 and the restored step 60."""
    from repro_torch.distributed.elastic import ElasticPlan
    plan = ElasticPlan((4,), (2,), ("model",), 4, 2, [])
    hist = [{"loss": 1.0}]
    res = {"plan": plan, "restored_step": 60, "hist1": hist * 60,
           "hist2": hist * 120}
    got = chip_smoke.example_summary("elastic_restart", res)
    assert got["steps"] == [60, 120] and got["restored_step"] == 60
    for bad in ({"hist2": hist * 60}, {"hist1": hist * 59},
                {"restored_step": 30}):
        with pytest.raises(AssertionError, match="elastic_restart ran"):
            chip_smoke.example_summary("elastic_restart", {**res, **bad})


def test_surface_phase_on_the_cpu():
    """surface: every package name imports, and make_world_plan is
    recorded once a dispatch at the four (shape, routing) cases and held
    to itself on the CPU (on the card: the card's plan to the CPU's); the
    skewed HT table drops."""
    line = chip_smoke.surface_phase(torch.device("cpu"))
    assert line["exported"] == {"core": 25, "optim": 5, "training": 7,
                                "data": 4, "distributed": 2}
    wp = line["make_world_plan"]
    assert set(wp) == {"ll", "ll_skewed", "ht", "ht_skewed"}
    B, S, P = (chip_smoke.SURFACE_BATCH, chip_smoke.SURFACE_PROMPT,
               chip_smoke.SURFACE_EP)
    assert wp["ll"]["table"] == [P, B, 4]         # decode: every rank, B rows
    assert wp["ht"]["n_groups"] == 64 // P        # a rank's experts
    assert all(v["bit_for_bit"] for v in wp.values())
    assert wp["ht_skewed"]["n_dropped"] > 0
    assert wp["ht_skewed"]["kept"] + wp["ht_skewed"]["n_dropped"] == (
        wp["ht_skewed"]["valid"])
    assert S * B // P * 4 <= wp["ht"]["valid"]


# ------------------------------------------- the LL exchange's checks ---
def _ll_plan_case(wire="fp32", skew=True, factor=1, seed=0):
    """(spec, x (4, 64, 256) bf16, logical top (4, 64, 2), weights, C, the
    LL plan over physical slots) over 8 experts, an EP world of 4 at
    capacity factor 1 (``skew``: expert 0 hot, so that choices drop)."""
    from repro_torch.core import ep
    from repro_torch.core import plan as planlib
    R, T, K, E, D = 4, 64, 2, 8, 256
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((R, T, E), generator=g)
    if skew:
        logits[..., 0] += 4.0
    w, top = torch.softmax(logits, -1).topk(K, dim=-1)
    placement = (planlib.replicate_uniform(E, factor).key() if factor > 1
                 else None)
    spec = ep.EPSpec(axes=("model",), sizes=(R,), n_experts=E, top_k=K,
                     capacity_factor=1.0, dtype=torch.bfloat16, mode="ll",
                     wire_dtype=wire, placement=placement)
    x = torch.randn((R, T, D), generator=g).to(torch.bfloat16)
    phys = top.to(torch.int32)
    if placement is not None:
        phys = planlib.split_to_physical_world(spec.placement_obj(), phys)
    C = ep._cap(T * K / spec.n_physical, 1.0, hard_max=T * K)
    return spec, x, top.to(torch.int32), w, C, ep._ll_plan(spec, phys, C)


@pytest.mark.parametrize("wire,factor", [("fp32", 1), ("fp8", 1),
                                         ("int8", 1), ("fp32", 2)])
def test_all_to_all_ll_exchange_meets_dispatch_combine_ll(wire, factor):
    """The oracle chip_smoke's ll-exchange phase holds the card to, on the
    CPU: the receive layout gives the expert function the rows and counts
    of the all-to-all composition bit for bit, and the output within one
    bf16 rounding (the phase's own limit), with choices dropped."""
    from repro_torch.core import ep
    spec, x, top, w, C, pl = _ll_plan_case(wire, factor=factor)
    if factor == 1:
        assert (pl.valid & ~pl.keep).any()
    seen = []

    def grab(rows, counts):
        seen.append((rows.clone(), counts.clone()))
        return rows
    got = ep.dispatch_combine_ll(spec, x, top, w, grab).out
    ref = chip_smoke.all_to_all_ll_exchange(spec, x, top, w,
                                        chip_smoke.ll_identity)
    assert torch.equal(seen[0][0].view(torch.int16),
                       ref.recv.view(torch.int16))
    assert torch.equal(seen[0][1], ref.counts)
    g, r = got.float(), ref.out.float()
    assert float(((g - r).abs() / (r.abs() + 1e-5 * 2.0 ** 7
                                   * r.abs().max())).max()) <= 2.0 ** -7


@pytest.mark.parametrize("factor", [1, 2])
def test_gather_rows_library_call_is_the_same_function(factor):
    """The yardstick beside the row gather, the table with a zero row
    appended and indexed by the receive-order table, gives the plain
    version's rows bit for bit: every slot past its count names the zero
    row."""
    from repro_torch.kernels import gather_rows as gr
    spec, x, _, _, C, pl = _ll_plan_case(factor=factor)
    table = x.reshape(-1, x.shape[-1])
    counts = pl.cnt_recv.reshape(-1)
    lib = chip_smoke.library_call("gather_rows", (table, pl.src_recv, counts),
                                  {})
    want = gr.gather_rows_plain(table, pl.src_recv, counts)
    assert torch.equal(lib().view(torch.int16), want.view(torch.int16))
    assert chip_smoke.library_call(
        "gather_rows", (table, pl.src_recv, counts, counts), {}) is None


@pytest.mark.parametrize("name", ["gather_rows", "dequantize",
                                  "combine_reduce", "combine_reduce_bwd"])
def test_ll_bounds_count_the_rows_each_form_moves(name):
    """chip_smoke's bound for the LL exchange's calls: the occupied (or
    live) rows read, every row written in its dtype, and the tables."""
    from repro_torch.kernels import quantize_pack as qp
    from repro_torch.core import ep
    spec, x, _, w, C, pl = _ll_plan_case("fp8")
    R, T, D = x.shape
    K = spec.top_k
    counts = pl.cnt_recv.reshape(-1)
    n = pl.src_recv.shape[0]
    occ = int(counts.clamp(max=n // counts.numel()).sum())
    kept = int((pl.sel_recv >= 0).sum())
    rows = torch.randn((n, D)).to(torch.bfloat16)
    wt = w.reshape(R * T, K).float()
    if name == "gather_rows":
        args, kw = (x.reshape(-1, D), pl.src_recv, counts), {}
        want = (occ + n) * D * 2 + n * 4 + counts.numel() * 4
    elif name == "dequantize":
        q, s = qp.gather_quantize_plain(ep._ext(x, torch.float32),
                                        pl.src_recv, counts, wire_dtype="fp8")
        args, kw = (q, s, counts, torch.bfloat16), {}
        want = occ * (D + s.shape[1] * 4) + n * D * 2 + counts.numel() * 4
        # without counts, as before: a byte read and fp32 written a value
        assert chip_smoke.bound(name, (q, s, None, torch.float32), {})[2][
            "bytes"] == q.numel() * 5 + s.numel() * 4
    elif name == "combine_reduce":
        args, kw = (rows, wt), {"sel": pl.sel_recv, "out_dtype": x.dtype}
        want = kept * D * 2 + R * T * K * 8 + R * T * D * 2
    else:
        dout = torch.randn((R * T, D)).to(torch.bfloat16)
        args, kw = (rows, wt, pl.sel_recv, dout), {}
        want = (R * T * D * 2 + (kept + n) * D * 2 + R * T * K * 12 + n * 8)
    ms, by, work = chip_smoke.bound(name, args, kw)
    assert work["bytes"] == want and by == "bytes"
    assert ms == pytest.approx(want / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_recorder_keeps_one_case_a_shape_of_tensor_keywords():
    """A keyword tensor (the combine's ``sel``) keys a case by its shape,
    not by the object, and a dtype argument keys it too; each case keeps
    copies of its tensors."""
    rec = chip_smoke.Recorder(lambda *a, **k: None)
    a = torch.zeros(4, 2)
    for _ in range(3):
        rec(a, torch.float32, sel=torch.zeros(4, 2, dtype=torch.int32))
    rec(a, torch.bfloat16, sel=torch.zeros(4, 2, dtype=torch.int32))
    rec(a, torch.float32, sel=torch.zeros(5, 2, dtype=torch.int32))
    assert len(rec.cases) == 3
    (args, kw), = [c for k, c in rec.cases.items() if k[1][0][1] == (5, 2)]
    assert args[0] is not a and kw["sel"].shape == (5, 2)


def test_autograd_grads_combine_reduce_bwd_meets_the_plain_backward():
    """The gathered combine's backward by autograd through the plain
    forward in fp32 against ``combine_reduce_bwd_plain``: the rows'
    gradient one bf16 rounding apart, the weights' to fp32 sums; both
    within the kernel's limit, and a -1 slot's weight gradient zero."""
    from repro_torch.kernels import combine_reduce as cr
    spec, x, _, w, C, pl = _ll_plan_case()
    R, T, D = x.shape
    n = pl.src_recv.shape[0]
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((n, D), generator=g).to(torch.bfloat16)
    dout = torch.randn((R * T, D), generator=g).to(torch.bfloat16)
    args = (rows, w.reshape(R * T, -1).float(), pl.sel_recv, dout)
    ref = chip_smoke.autograd_grads("combine_reduce_bwd", args, {})
    got = cr.combine_reduce_bwd_plain(*args)
    tol = chip_smoke.KERNEL_TOL["combine_reduce_bwd"]
    for a, b in zip(got, ref):
        assert float((a.float() - b).abs().max()) <= tol * float(
            b.abs().max())
    assert (ref[1][pl.sel_recv < 0] == 0).all() and (pl.sel_recv < 0).any()


def test_ll_decode_launches_wants_one_a_layer_a_step():
    """The served decode's LL launches: one a MoE layer a step of the
    wire's kernel and of the combine; an extra launch fails."""
    from repro_torch.launch.serve import WARMUP_STEPS
    cfg = reduced_config(get_config("qwen2_moe_a2_7b"), n_layers=3)
    L = 3
    res = {"graph_replays": 5, "captured_launches": {
        "gather_rows": L, "combine_reduce": L, "dequantize": 0}}
    res8 = {"graph_replays": 2, "captured_launches": {
        "gather_rows": 0, "combine_reduce": L, "dequantize": L}}
    after = {"gather_rows": L * (WARMUP_STEPS + 5),
             "combine_reduce": L * (WARMUP_STEPS + 5), "dequantize": 7}
    both = {"gather_rows": after["gather_rows"],
            "combine_reduce": after["combine_reduce"]
            + L * (WARMUP_STEPS + 2), "dequantize": 20}
    chip_smoke.ll_decode_launches(cfg, res, res8, after, both)
    with pytest.raises(AssertionError, match="one a MoE layer"):
        chip_smoke.ll_decode_launches(cfg, res, res8, after,
                                      {**both, "gather_rows": both[
                                          "gather_rows"] + 1})
