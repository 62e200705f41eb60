"""The checks ``chip_smoke.py`` makes on the card, run on the CPU at a
reduced size, so that the checks themselves are tested: HT at its
configured capacity (with drops) against the dense oracle restricted to
the choices the plan keeps; the launch accounting and decode cases of
a captured decode step; and serve-rdma's helpers: its launch
expectations, the CPU-against-card comparison of the substrate's counters
and output, its host profile, and the recorder of the substrate's
grouped_swiglu calls whose cases join the kernel's entry."""
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
