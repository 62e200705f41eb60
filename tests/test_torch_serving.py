"""The port's serving engine (``repro_torch.serving``) against the
reference's (``repro.serving``) on the same seeds, each test of the
reference's ``tests/test_serving.py`` mirrored:

- the arrival processes equal request for request;
- the scheduler's microbatches, counters and latency percentiles equal;
- ``ServingEngine(cfg, device="cpu")`` against ``repro.serving.ServingEngine``
  in the three step modes, on the fp32/fp8/int8 wires, with one and two
  replicas an expert (Zipf-skewed routing, the LoadBalancer path): every
  key of ``stats()`` equal but the output digest (rtol 1e-5), every step's
  per-layer outputs within 1e-5, and the idle jump, the stall error and
  the session slots' verification as in the reference;
- the executor's tensor-weights branch (the engine's expert launch through
  ``ops.grouped_swiglu``) on CPU tensors against its numpy branch: outputs
  within 1e-5, the event clock and every counter equal; the paths that take
  numpy weights only refuse tensors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as R  # noqa: E402
import repro_torch.serving as S  # noqa: E402
from repro.core.backend import get_backend as r_get_backend  # noqa: E402
from repro.core.ep import EPSpec as REPSpec  # noqa: E402
from repro.core.transport.simulator import NetConfig as RNet  # noqa: E402
from repro_torch.analysis.verify import verify_session_slots  # noqa: E402
from repro_torch.core.backend import get_backend as t_get_backend  # noqa: E402
from repro_torch.core.ep import EPSpec as TEPSpec  # noqa: E402
from repro_torch.core.transport import ep_executor as t_ep  # noqa: E402
from repro_torch.core.transport.simulator import NetConfig as TNet  # noqa: E402

pytestmark = pytest.mark.timeout(120)


def _req_tuple(reqs):
    return [(r.rid, r.arrival_us, r.prompt_len, r.max_new_tokens)
            for r in reqs]


def _to_ref(reqs):
    return [R.Request(*t) for t in _req_tuple(reqs)]


# ------------------------------------------------------ arrival processes --
@pytest.mark.parametrize("kind,seed", [
    ("poisson", 5), ("poisson", 6), ("bursty", 1), ("bursty", 9),
    ("curve", 2), ("curve", 4)])
def test_arrivals_equal(kind, seed):
    def make(mod):
        if kind == "poisson":
            return mod.poisson_arrivals(1000.0, 32, seed=seed,
                                        prompt_len=(6, 20), gen_len=(3, 8),
                                        start_us=7.0, rid0=3)
        if kind == "bursty":
            return mod.bursty_arrivals(2000.0, 64, seed=seed,
                                       burst_factor=4.0, burst_len=8)
        return mod.load_curve_arrivals(
            [(10_000.0, 2000.0), (10_000.0, 0.0), (10_000.0, 2000.0)],
            seed=seed)
    got, want = make(S), make(R)
    assert _req_tuple(got) == _req_tuple(want) and got
    assert all(isinstance(r, S.Request) for r in got)
    ts = [r.arrival_us for r in got]
    assert ts == sorted(ts)


def test_request_checks_lengths():
    with pytest.raises(AssertionError):
        S.Request(0, 0.0, prompt_len=0, max_new_tokens=1)


# -------------------------------------------------------------- scheduler --
def _drive(mod, cfg_kw, pool_kw, script):
    """Run a scheduler through ``script``: (time, requests to add) per step;
    each step schedules, and completes what it scheduled one µs later.
    Returns every microbatch's slices, the counters, the latency stats and
    the pool's counters."""
    pool = mod.KVBlockPool(**pool_kw)
    sched = mod.Scheduler(mod.SchedulerConfig(**cfg_kw), pool)
    trace = []
    for t, adds in script:
        for a in adds:
            sched.add(mod.Request(*a))
        mb = sched.schedule(float(t))
        if mb is None:
            trace.append(None)
            continue
        trace.append([dataclasses.astuple(s) for s in mb.slices])
        trace.append(sched.complete_step(mb, float(t) + 1.0))
        pool.assert_consistent()
    return (trace, dict(sched.counters), sched.latency_stats(),
            (pool.allocs, pool.frees, pool.high_water, pool.n_used),
            sorted(sched.finished), sorted(sched.running))


def _script(seed, n_steps=60):
    rng = np.random.default_rng(seed)
    out, rid = [], 0
    for t in range(n_steps):
        adds = []
        for _ in range(int(rng.integers(0, 3)) if t < n_steps // 2 else 0):
            adds.append((rid, float(t), int(rng.integers(1, 30)),
                         int(rng.integers(1, 9))))
            rid += 1
        out.append((2 * t, adds))
    return out


@pytest.mark.parametrize("case", [
    "chunked_prefill_then_decode", "decode_before_prefill",
    "admission_blocks", "random_roomy", "random_tight", "max_running"])
def test_scheduler_equal(case):
    cfg_kw, pool_kw = dict(token_budget=16, prefill_chunk=8), dict(
        n_blocks=64, block_size=4)
    if case == "chunked_prefill_then_decode":
        script = [(0, [(0, 0.0, 20, 3)])] + [(t, []) for t in range(1, 6)]
    elif case == "decode_before_prefill":
        cfg_kw = dict(token_budget=8, prefill_chunk=8)
        script = [(0, [(0, 0.0, 4, 4)]), (2, [(1, 0.0, 8, 2)]),
                  (4, []), (6, []), (8, [])]
    elif case == "admission_blocks":
        pool_kw = dict(n_blocks=2, block_size=4)
        script = [(0, [(0, 0.0, 8, 2), (1, 0.0, 8, 2)]), (2, []), (4, [])]
    elif case == "random_roomy":
        script = _script(1)
    elif case == "random_tight":
        cfg_kw = dict(token_budget=12, prefill_chunk=5)
        pool_kw = dict(n_blocks=12, block_size=4)
        script = _script(2)
    else:
        cfg_kw = dict(token_budget=16, prefill_chunk=4, max_running=3)
        script = _script(3)
    got = _drive(S, cfg_kw, pool_kw, script)
    assert got == _drive(R, cfg_kw, pool_kw, script)
    if case == "admission_blocks":
        assert got[1]["admission_blocked"] >= 1 and got[1]["decode_stalls"]
    if case == "chunked_prefill_then_decode":
        assert [len(s) if s else 0 for s in got[0][::2]][:3] == [1, 1, 1]
        assert got[1]["completed"] == 1 and got[3][3] == 0


def test_seq_state_cache_len():
    st = S.SeqState(S.Request(0, 0.0, 10, 4), admitted_us=0.0, prefilled=10,
                    generated=3)
    assert st.cache_len == 12
    with pytest.raises(AssertionError):
        S.SchedulerConfig(token_budget=4, prefill_chunk=8)


# ----------------------------------------------------------------- engine --
def _cfg_kw(**over):
    kw = dict(n_layers=2, n_experts=8, top_k=2, d_model=16, d_ff=32,
              ep_degree=4, token_budget=16, prefill_chunk=8, block_size=8,
              n_blocks=64, step_mode="pipelined", nonmoe_us=10.0, seed=0)
    kw.update(over)
    return kw


def _reqs(mod, n=6, rate=100_000.0, seed=11):
    return mod.poisson_arrivals(rate, n, seed=seed, prompt_len=(6, 20),
                                gen_len=(3, 8))


def _capture(backend):
    """Record every ``dispatch_step``'s per-layer outputs."""
    outs, inner = [], backend.dispatch_step

    def step(*a, **kw):
        res = inner(*a, **kw)
        outs.append([np.array(o) for o in res[0]])
        return res
    backend.dispatch_step = step
    return outs


def _run_pair(cfg_over, n=6, seed=11, reqs=None):
    kw = _cfg_kw(**cfg_over)
    r = R.ServingEngine(R.EngineConfig(**kw))
    t = S.ServingEngine(S.EngineConfig(**kw), device="cpu")
    r_outs, t_outs = _capture(r.backend), _capture(t.backend)
    r.submit_all(_to_ref(reqs) if reqs else _reqs(R, n=n, seed=seed))
    t.submit_all(reqs if reqs else _reqs(S, n=n, seed=seed))
    sr, st = r.run(), t.run()
    return (t, st, t_outs), (r, sr, r_outs)


def _assert_engines_equal(port, ref):
    (t, st, t_outs), (r, sr, r_outs) = port, ref
    assert st.keys() == sr.keys()
    assert {k: st[k] for k in st} == {k: sr[k] for k in sr}
    np.testing.assert_allclose(t.output_digest, r.output_digest, rtol=1e-5)
    assert len(t_outs) == len(r_outs) == st["steps"] > 0
    for a, b in zip(t_outs, r_outs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.last_outs[-1], r_outs[-1][-1], rtol=1e-5,
                               atol=1e-5)
    assert t.clock_us == r.clock_us
    assert t.sched.latency_stats() == r.sched.latency_stats()


@pytest.mark.parametrize("over", [
    dict(), dict(step_mode="serial"), dict(step_mode="per_layer"),
    dict(wire_dtype="fp8"), dict(wire_dtype="int8"),
    dict(step_mode="serial", wire_dtype="fp8"),
    dict(step_mode="per_layer", wire_dtype="int8"),
    dict(replicas_per_expert=2, route_alpha=1.2),
    dict(replicas_per_expert=2, route_alpha=0.8, step_mode="serial",
         wire_dtype="fp8"),
    dict(replicas_per_expert=2, route_alpha=1.2, step_mode="per_layer",
         wire_dtype="int8"),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_engine_equal(over):
    n = 10 if over.get("replicas_per_expert", 1) > 1 else 6
    port, ref = _run_pair(over, n=n, seed=13 if n == 10 else 11)
    _assert_engines_equal(port, ref)
    t, st, _ = port
    assert st["sched_completed"] == n
    assert st["kv_allocs"] == st["kv_frees"] and t.pool.n_used == 0
    if over.get("replicas_per_expert", 1) > 1:
        assert t.lb is not None and t.spec.n_experts == 16
        if over["route_alpha"] == 1.2:
            assert st["rebalances"] >= 1       # zipf skew trips it


def test_engine_weights_and_determinism():
    """The weights are the reference's draw, held as fp32 CPU tensors; two
    port engines on one config agree bit for bit."""
    kw = _cfg_kw()
    r = R.ServingEngine(R.EngineConfig(**kw))
    t = S.ServingEngine(S.EngineConfig(**kw), device="cpu")
    for a, b in ((t._wg, r._wg), (t._wu, r._wu), (t._wd, r._wd)):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
    (t1, s1, o1), _ = _run_pair({})
    (t2, s2, o2), _ = _run_pair({})
    assert s1 == s2 and t1.output_digest == t2.output_digest
    for a, b in zip(o1, o2):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_engine_session_vs_naive_identical_schedule():
    rs = {m: _run_pair(dict(step_mode=m))[0][:2]
          for m in ("pipelined", "serial", "per_layer")}
    keys = [k for k in rs["pipelined"][1] if k.startswith("sched_")]
    for key in keys + ["kv_allocs", "kv_frees", "kv_high_water"]:
        assert rs["pipelined"][1][key] == rs["per_layer"][1][key], key
        assert rs["serial"][1][key] == rs["per_layer"][1][key], key
    L = rs["pipelined"][0].cfg.n_layers
    assert rs["pipelined"][1]["drains"] == rs["pipelined"][1]["steps"]
    assert rs["serial"][1]["drains"] == rs["serial"][1]["steps"] * L
    assert rs["pipelined"][1]["elapsed_us"] < rs["per_layer"][1]["elapsed_us"]


def test_engine_clean_quiesce_and_verified_session_slots():
    (t, _, _), _ = _run_pair({})
    (world,) = t.backend._sessions.values()
    assert not world.net.pending
    findings = verify_session_slots(world._slots,
                                    n_channels=world.n_channels,
                                    counter_stride=world._counter_stride)
    assert not findings, findings


def test_engine_fp8_wire_dispatch_shrinks_bytes():
    (_, s32, _), _ = _run_pair({})
    (_, s8, _), _ = _run_pair(dict(wire_dtype="fp8"))
    assert s8["sched_generated_tokens"] == s32["sched_generated_tokens"]
    assert 0 < s8["dispatch_wire_bytes"] < s32["dispatch_wire_bytes"]
    assert s8["dispatch_msgs"] == s32["dispatch_msgs"]
    assert s8["elapsed_us"] < s32["elapsed_us"]


def test_engine_idle_gap_jumps_clock_to_arrival():
    reqs = [S.Request(0, 0.0, 4, 2), S.Request(1, 500_000.0, 4, 2)]
    port, ref = _run_pair({}, reqs=reqs)
    _assert_engines_equal(port, ref)
    t, s, _ = port
    assert s["sched_completed"] == 2 and s["elapsed_us"] > 500_000.0
    assert t.sched.finished[1].first_token_us >= 500_000.0


def test_engine_stall_detection():
    for mod, extra in ((S, {"device": "cpu"}), (R, {})):
        eng = mod.ServingEngine(mod.EngineConfig(**_cfg_kw(
            n_blocks=1, block_size=2, prefill_chunk=8)), **extra)
        eng.submit(mod.Request(0, 0.0, prompt_len=8, max_new_tokens=2))
        with pytest.raises(RuntimeError, match="stalled"):
            eng.run()


def test_engine_config_checks_as_the_reference():
    for bad in (dict(token_budget=18), dict(step_mode="async"),
                dict(n_experts=6, replicas_per_expert=1)):
        for mod in (S, R):
            with pytest.raises(AssertionError):
                mod.EngineConfig(**_cfg_kw(**bad))


def test_engine_refuses_cuda_without_a_card(monkeypatch):
    """A CUDA device with no card raises; there is no fallback to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.ServingEngine(S.EngineConfig(**_cfg_kw()))
    with pytest.raises(ValueError, match="no expert kernel"):
        S.ServingEngine(S.EngineConfig(**_cfg_kw()), device="meta")


def test_engine_max_steps_and_stats_midway():
    kw = _cfg_kw()
    r = R.ServingEngine(R.EngineConfig(**kw))
    t = S.ServingEngine(S.EngineConfig(**kw), device="cpu")
    r.submit_all(_reqs(R))
    t.submit_all(_reqs(S))
    a, b = t.run(max_steps=3), r.run(max_steps=3)
    assert a["steps"] == 3 and {k: a[k] for k in a} == {k: b[k] for k in b}


# ------------------------------------- the executor's tensor-weights branch --
def _problem(seed, R_, E, K, D, F, Tl):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R_, Tl, D)).astype(np.float32)
    ti = np.stack([np.stack([rng.choice(E, K, replace=False)
                             for _ in range(Tl)]) for _ in range(R_)])
    ti = ti.astype(np.int32)
    ti[rng.random(ti.shape) < 0.1] = -1
    tw = rng.random((R_, Tl, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    w = [(rng.standard_normal(sh) * 0.2).astype(np.float32)
         for sh in ((E, D, F), (E, D, F), (E, F, D))]
    return x, ti, tw, w


def _world_state(world):
    tl = {k: v for k, v in world.timeline.items()
          if k not in ("token_completion_us",)}
    return (tl, world.net.clock_us, world.net.delivered,
            world.net.wire_bytes_moved,
            [dict(p.stats) for p in world.proxies],
            np.asarray(world.timeline["token_completion_us"]).tolist())


@pytest.mark.parametrize("wire", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("net", ["rc", "srd"])
def test_tensor_weights_branch_matches_numpy(wire, net):
    """``EPWorld.run`` with per-expert weights as CPU tensors launches each
    expert through ``ops.grouped_swiglu`` (its plain version here) and
    matches the numpy branch within 1e-5, with the event clock, the
    timeline, the launches and every counter equal."""
    R_, E, K, D, F, Tl = 2, 8, 2, 16, 8, 6
    x, ti, tw, w = _problem(3, R_, E, K, D, F, Tl)
    got = {}
    for kind in ("numpy", "tensor"):
        ws = w if kind == "numpy" else [torch.from_numpy(a) for a in w]
        world = t_ep.EPWorld(n_ranks=R_, n_experts=E, top_k=K, d=D,
                             capacity=Tl * K, wire_dtype=wire,
                             net_cfg=TNet(mode=net, seed=4))
        got[kind] = world.run(x, ti, tw, *ws), _world_state(world)
    np.testing.assert_allclose(got["tensor"][0], got["numpy"][0], rtol=1e-5,
                               atol=1e-5)
    assert got["tensor"][1] == got["numpy"][1]
    assert len(got["tensor"][1][0]["compute_start_us"]) > 0


def test_tensor_expert_launch_calls_grouped_swiglu_per_expert(monkeypatch):
    """The branch stages only expert e's received rows, as one (1, n, D)
    group in the weights' dtype, over ``w[e:e+1]``: one
    ``ops.grouped_swiglu`` call a launched expert."""
    from repro_torch.kernels import ops
    calls, inner = [], ops.grouped_swiglu

    def spy(x, wg, wu, wd, counts=None):
        calls.append((tuple(x.shape), x.dtype, tuple(wg.shape), counts))
        return inner(x, wg, wu, wd, counts)
    monkeypatch.setattr(ops, "grouped_swiglu", spy)
    R_, E, K, D, F, Tl = 2, 8, 2, 16, 8, 6
    x, ti, tw, w = _problem(5, R_, E, K, D, F, Tl)
    world = t_ep.EPWorld(n_ranks=R_, n_experts=E, top_k=K, d=D,
                         capacity=Tl * K)
    world.run(x, ti, tw, *(torch.from_numpy(a) for a in w))
    launched = len(world.timeline["compute_start_us"])
    assert len(calls) == launched
    rows = np.bincount(ti[ti >= 0], minlength=E)
    assert sorted(c[0][1] for c in calls) == sorted(rows[rows > 0].tolist())
    assert all(c[0][0] == 1 and c[0][2] == D and c[1] == torch.float32
               and c[2] == (1, D, F) and c[3] is None for c in calls)


@pytest.mark.parametrize("mode", ["pipelined", "serial", "per_layer"])
def test_dispatch_step_with_tensor_weights(mode):
    """``dispatch_step`` with tensor weights against the reference's with
    numpy weights: outputs within 1e-5, the step's span and stats equal,
    twice (the second step reuses the session)."""
    R_, E, K, D, F, T, L = 2, 8, 2, 16, 8, 6, 3
    rng = np.random.default_rng(60)
    xs = [rng.standard_normal((T, D)).astype(np.float32) for _ in range(L)]
    tis = [np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
           .astype(np.int32) for _ in range(L)]
    tis[1][0] = -1
    tws = [np.full((T, K), 1.0 / K, np.float32) for _ in range(L)]
    w = [(rng.standard_normal(sh) * 0.2).astype(np.float32)
         for sh in ((E, D, F), (E, D, F), (E, F, D))]
    kw = dict(axes=("ep",), sizes=(R_,), n_experts=E, top_k=K, mode="ll")
    got = {}
    for side, get, spec, ws, net in (
            ("port", t_get_backend, TEPSpec(**kw),
             [torch.from_numpy(a) for a in w], TNet),
            ("ref", r_get_backend, REPSpec(**kw), w, RNet)):
        be = get("simulated_rdma",
                 session_layers=L if mode != "per_layer" else 0,
                 net_cfg=net(mode="srd", seed=2))
        got[side] = [be.dispatch_step(spec, xs, tis, tws, *ws,
                                      nonmoe_fwd_us=4.0, mode=mode)
                     for _ in range(2)]
    for (op, ep, sp), (orf, er, sr) in zip(got["port"], got["ref"]):
        for a, b in zip(op, orf):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert ep == er and sp == sr


def test_numpy_only_paths_refuse_tensor_weights():
    R_, E, K, D, F, Tl = 2, 8, 2, 16, 8, 6
    x, ti, tw, w = _problem(7, R_, E, K, D, F, Tl)
    wt = [torch.from_numpy(a) for a in w]
    world = t_ep.EPWorld(n_ranks=R_, n_experts=E, top_k=K, d=D,
                         capacity=Tl * K)
    with pytest.raises(TypeError, match="barrier-mode"):
        world.run(x, ti, tw, *wt, overlap=False)
    world = t_ep.EPWorld(n_ranks=R_, n_experts=E, top_k=K, d=D,
                         capacity=Tl * K)
    with pytest.raises(TypeError, match="HT bucket partials"):
        world.run_ht(x, ti, tw, *wt)
