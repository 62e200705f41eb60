"""The port's EP executor and ``simulated_rdma`` backend against the
reference's on the same seeded routing: LL and HT, RC and SRD, the fp32,
fp8 and int8 wires, replicated placements and persistent sessions.

- The command streams are byte-identical to the reference's.
- With the numpy expert function (or the per-expert weights) the outputs
  match bit for bit, and so do the event clock (``net.clock_us``, every
  delivery-time counter of the timeline, each token's completion time),
  the wire accounting, the proxies' counters and the symmetric memories,
  with inline proxies (deterministic).
- ``dispatch_step``'s outputs, ``elapsed_us`` and stats are equal in all
  three modes.
- Seeded forms of the reference's conformance fuzz properties
  (``tests/test_transport_fuzz.py``) run against the port: the dense
  oracle, clean quiesce, scalar vs columnar vs coalesced drains; with
  hypothesis at small ``max_examples``.  Threaded proxies are stopped in
  ``finally`` and each threaded test has its own time limit.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import plan as r_plan  # noqa: E402
from repro.core.backend import get_backend as r_get_backend  # noqa: E402
from repro.core.ep import EPSpec as REPSpec  # noqa: E402
from repro.core.transport import ep_executor as r_ep  # noqa: E402
from repro.core.transport.simulator import NetConfig as RNet  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.backend import get_backend as t_get_backend  # noqa: E402
from repro_torch.core.ep import EPSpec as TEPSpec  # noqa: E402
from repro_torch.core.transport import ep_executor as t_ep  # noqa: E402
from repro_torch.core.transport.simulator import NetConfig as TNet  # noqa: E402

pytestmark = pytest.mark.timeout(120)

SIDES = {"port": (t_ep, TNet), "ref": (r_ep, RNet)}


def _problem(seed, R, E, K, D, F, Tl, pad=0.0):
    """Seeded world: x (R, Tl, D), routing (R, Tl, K) with distinct experts
    a row (``pad`` of the choices -1), normalised weights and per-expert
    SwiGLU weights, all fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, Tl, D)).astype(np.float32)
    ti = np.stack([np.stack([rng.choice(E, K, replace=False)
                             for _ in range(Tl)]) for _ in range(R)])
    ti = ti.astype(np.int32)
    if pad:
        ti[rng.random(ti.shape) < pad] = -1
    tw = rng.random((R, Tl, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    wg, wu, wd = ((rng.standard_normal(sh) * 0.2).astype(np.float32)
                  for sh in ((E, D, F), (E, D, F), (E, F, D)))
    return x, ti, tw, wg, wu, wd


def _plain(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(u) for u in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _state(w):
    """Everything observable of a world after a run: the timeline (event
    clock counters, completion times), the network's clock and byte
    accounting, each proxy's counters and symmetric memory."""
    return {"timeline": {k: _plain(v) for k, v in w.timeline.items()},
            "clock_us": w.net.clock_us, "delivered": w.net.delivered,
            "bytes": w.net.bytes_moved, "hdr": w.net.hdr_bytes_moved,
            "wire": w.net.wire_bytes_moved,
            "stats": [dict(p.stats) for p in w.proxies],
            "mem": [p.mem.data.tobytes() for p in w.proxies],
            "counters": [p.mem.counters.tolist() for p in w.proxies]}


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


# --------------------------------------------------------- streams -------
def _streams(mod, ti, E, eps, wdt, D=16, nc=8):
    R, Tl, K = ti.shape
    cap = Tl * K
    wb = t_plan.wire_layout(D, wdt).token_bytes
    recv0 = Tl * wb
    out0 = recv0 + R * eps * cap * wb
    ret0 = out0 + R * eps * cap * 4 * D
    return mod.build_command_streams(ti, E, eps, cap, 4 * D, nc, 0, recv0,
                                     ret0, wire_bytes=wb, out0=out0)


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("eps", [1, 4, 65])
@pytest.mark.parametrize("wdt", ["fp32", "fp8", "int8"])
def test_command_streams_byte_identical(wdt, eps, factor):
    """Every packed stream (writes, fences, combines), its pushers and
    channels, the entry -> expert key, the guard table, ``ret_pos`` and the
    plan's counts/keep; with a replicated placement the physical table
    from the port's split equals the reference's first."""
    R, K, Tl = 2, 3, 9
    E = eps * R
    _, ti, *_ = _problem(eps * 10 + factor, R, E, min(K, E), 8, 8, Tl,
                         pad=0.1)
    if factor > 1:
        pl_r = r_plan.replicate_uniform(E, factor)
        pl_t = t_plan.replicate_uniform(E, factor)
        phys_r = r_plan.split_to_physical_world(pl_r, ti)
        phys_t = t_plan.split_to_physical_world(
            pl_t, torch.from_numpy(ti)).numpy()
        np.testing.assert_array_equal(phys_t, phys_r)
        ti, E, eps = phys_r, E * factor, eps * factor
    got, ref = _streams(t_ep, ti, E, eps, wdt), _streams(r_ep, ti, E, eps,
                                                           wdt)
    for name in ("writes", "write_pusher", "write_channel", "fences",
                 "fence_pusher", "fence_channel", "combines",
                 "combine_pusher", "combine_channel", "entry_expert",
                 "ret_pos"):
        g, r = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
        if name in ("writes", "fences", "combines"):
            assert g.tobytes() == r.tobytes(), name
    for g, r in zip(got.guard_table, ref.guard_table):
        np.testing.assert_array_equal(g, r)
    for name in ("counts", "valid", "keep"):
        np.testing.assert_array_equal(getattr(got.plan, name),
                                      getattr(ref.plan, name), err_msg=name)
    valid = ref.plan.valid
    np.testing.assert_array_equal(np.where(valid, got.plan.rank, 0),
                                  np.where(valid, ref.plan.rank, 0))
    assert int(got.plan.n_dropped) == int(ref.plan.n_dropped)


# ------------------------------------------------------ EPWorld runs -----
def _world(side, R, E, K, D, F, Tl, mode, wdt, seed, **kw):
    mod, Net = SIDES[side]
    return mod.EPWorld(n_ranks=R, n_experts=E, top_k=K, d=D, f=F,
                       capacity=Tl * K,
                       net_cfg=Net(mode=mode, seed=seed, reorder_window=32),
                       wire_dtype=wdt, **kw)


def _expert_fn(side, wg, wu, wd):
    mod = SIDES[side][0]
    return lambda toks, counts=None: mod.np_grouped_swiglu(
        toks, wg, wu, wd, counts=counts)


def _run_both(proto, mode, wdt, seed, generic, n_chunks=1, R=4, eps=2,
              K=3, D=16, F=12, Tl=6, pad=0.1, **kw):
    E = eps * R
    x, ti, tw, wg, wu, wd = _problem(seed, R, E, K, D, F, Tl, pad=pad)
    outs, worlds = {}, {}
    for side in SIDES:
        w = _world(side, R, E, K, D, F, Tl, mode, wdt, seed, **kw)
        fn = dict(expert_fn=_expert_fn(side, wg, wu, wd)) if generic else {}
        args = (x, ti, tw) if generic else (x, ti, tw, wg, wu, wd)
        if proto == "ll":
            outs[side] = w.run(*args, **fn)
        else:
            outs[side] = w.run_ht(*args, n_chunks=n_chunks, **fn)
        worlds[side] = w
    return outs, worlds, (x, ti, tw, wg, wu, wd)


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("wdt", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_ll_run_equal(mode, wdt, generic):
    """LL over the substrate: per-expert overlap (weights) and the grouped
    barrier (a generic expert_fn with (E, R) bucket counts)."""
    outs, worlds, _ = _run_both("ll", mode, wdt, 11, generic)
    assert outs["port"].dtype == np.float32
    np.testing.assert_array_equal(outs["port"], outs["ref"])
    _assert_same_state(_state(worlds["port"]), _state(worlds["ref"]))


@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("wdt", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_ht_run_equal(mode, wdt, n_chunks):
    """HT: chunked, dedup'd dispatch and the hierarchical reduce, with the
    per-expert weights and through a generic expert_fn (one call a (src,
    chunk) bucket with flat counts)."""
    for generic in (False, True):
        outs, worlds, _ = _run_both("ht", mode, wdt, 12 + n_chunks, generic,
                                    n_chunks=n_chunks)
        np.testing.assert_array_equal(outs["port"], outs["ref"])
        _assert_same_state(_state(worlds["port"]), _state(worlds["ref"]))
        assert worlds["port"].ht_dropped == worlds["ref"].ht_dropped == 0


@pytest.mark.parametrize("proto", ["ll", "ht"])
def test_scalar_drain_equal(proto):
    """The scalar TransferCmd drain (``columnar=False``, the conformance
    oracle) and the uncoalesced columnar drain, port against reference."""
    for kw in (dict(columnar=False), dict(coalesce=False)):
        outs, worlds, _ = _run_both(proto, "srd", "fp32", 21, False, **kw)
        np.testing.assert_array_equal(outs["port"], outs["ref"])
        _assert_same_state(_state(worlds["port"]), _state(worlds["ref"]))


def _specs(R, E, K, mode, wdt="fp32", placement=None, chunks=1):
    kw = dict(axes=("sim",), sizes=(R,), n_experts=E, top_k=K, mode=mode,
              wire_dtype=wdt, placement=placement, chunks=chunks)
    return {"port": TEPSpec(**kw), "ref": REPSpec(**kw)}


def _backend_run(side, spec, x, ti, tw, fn, **kw):
    get = t_get_backend if side == "port" else r_get_backend
    be = get("simulated_rdma", **kw)
    res = be.dispatch_combine(spec, x, ti, tw, fn)
    return be, res


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("net", ["rc", "srd"])
@pytest.mark.parametrize("proto", ["ll", "ht"])
def test_backend_replicated_placement_equal(proto, net, factor):
    """``dispatch_combine`` under a replicated placement (the logical
    routing split over physical slots per source rank before the streams
    are built): outputs, the physical load and imbalance, and the world's
    state."""
    R, E, K, D, F, Tl = 2, 8, 2, 16, 8, 8
    x, ti, tw, wg, wu, wd = _problem(30 + factor, R, E, K, D, F, Tl)
    pl = r_plan.greedy_placement(np.bincount(ti.reshape(-1), minlength=E),
                                 E * factor, R)
    p2l = np.asarray(pl.phys_to_logical)
    specs = _specs(R, E, K, proto, placement=pl.key())
    got = {}
    for side in SIDES:
        be, res = _backend_run(
            side, specs[side], x.reshape(R * Tl, D), ti.reshape(R * Tl, K),
            tw.reshape(R * Tl, K), _expert_fn(side, wg[p2l], wu[p2l],
                                              wd[p2l]),
            net_cfg=SIDES[side][1](mode=net, seed=3))
        got[side] = (res, _state(be.last_world))
    (rp, sp), (rr, sr) = got["port"], got["ref"]
    np.testing.assert_array_equal(rp.out, rr.out)
    np.testing.assert_array_equal(rp.aux["load_phys"], rr.aux["load_phys"])
    assert float(rp.aux["imbalance"]) == float(rr.aux["imbalance"])
    _assert_same_state(sp, sr)
    oracle = r_ep.EPWorld.oracle(x, ti, tw, wg, wu, wd).reshape(R * Tl, D)
    np.testing.assert_allclose(rp.out, oracle, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("proto", ["ll", "ht"])
def test_session_layers_equal(proto):
    """A persistent session (one world, per-layer slots, registration
    once): two layers over two steps through ``dispatch_combine`` with
    ``session_layers=2``, the cursor wrapping to a new step."""
    R, E, K, D, F, Tl = 2, 8, 2, 16, 8, 4
    probs = [_problem(40 + l, R, E, K, D, F, Tl) for l in range(2)]
    specs = _specs(R, E, K, proto)
    runs = {}
    for side in SIDES:
        get = t_get_backend if side == "port" else r_get_backend
        be = get("simulated_rdma", session_layers=2,
                 net_cfg=SIDES[side][1](mode="srd", seed=5))
        outs, states = [], []
        for _step in range(2):
            for x, ti, tw, wg, wu, wd in probs:
                res = be.dispatch_combine(
                    specs[side], x.reshape(-1, D), ti.reshape(-1, K),
                    tw.reshape(-1, K), _expert_fn(side, wg, wu, wd))
                outs.append(res.out)
                states.append(_state(be.last_world))
        runs[side] = outs, states
    for a, b in zip(runs["port"][0], runs["ref"][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs["port"][1], runs["ref"][1]):
        _assert_same_state(a, b)


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("runner", ["run_step_serial", "run_step_pipelined"])
def test_step_runners_equal(runner, mirror):
    """The session's step runners (layer-serialized, and pipelined with one
    drain a step), with and without the mirrored backward streams."""
    R, E, K, D, F, Tl, L = 2, 8, 2, 16, 8, 4, 3
    probs = [_problem(50 + l, R, E, K, D, F, Tl) for l in range(L)]
    _, _, _, wg, wu, wd = probs[0]
    got = {}
    for side in SIDES:
        w = _world(side, R, E, K, D, F, Tl, "srd", "fp32", 9, session=True,
                   n_layers=L, mirror=mirror)
        outs = []
        for _step in range(2):
            w.begin_step()
            outs += getattr(w, runner)(
                [p[0] for p in probs], [p[1] for p in probs],
                [p[2] for p in probs], wg, wu, wd, nonmoe_fwd_us=3.0,
                nonmoe_bwd_us=5.0)
        got[side] = outs, _state(w)
    for a, b in zip(got["port"][0], got["ref"][0]):
        np.testing.assert_array_equal(a, b)
    _assert_same_state(got["port"][1], got["ref"][1])


@pytest.mark.parametrize("mode", ["pipelined", "serial", "per_layer"])
def test_dispatch_step_equal(mode):
    """``SimulatedRDMABackend.dispatch_step``: per-layer outputs, the
    step's event-clock span and the aggregated counters, twice (the second
    step reuses the session)."""
    R, E, K, D, F, T, L = 2, 8, 2, 16, 8, 6, 3
    rng = np.random.default_rng(60)
    xs = [rng.standard_normal((T, D)).astype(np.float32) for _ in range(L)]
    tis = [np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
           .astype(np.int32) for _ in range(L)]
    tis[1][0] = -1                             # a padding row
    tws = [np.full((T, K), 1.0 / K, np.float32) for _ in range(L)]
    wg, wu, wd = ((rng.standard_normal(sh) * 0.2).astype(np.float32)
                  for sh in ((E, D, F), (E, D, F), (E, F, D)))
    specs = _specs(R, E, K, "ll")
    got = {}
    for side in SIDES:
        get = t_get_backend if side == "port" else r_get_backend
        be = get("simulated_rdma",
                 session_layers=L if mode != "per_layer" else 0,
                 net_cfg=SIDES[side][1](mode="srd", seed=2))
        got[side] = [be.dispatch_step(specs[side], xs, tis, tws, wg, wu, wd,
                                      nonmoe_fwd_us=4.0, mode=mode)
                     for _ in range(2)]
    for (op, ep, sp), (orf, er, sr) in zip(got["port"], got["ref"]):
        for a, b in zip(op, orf):
            np.testing.assert_array_equal(a, b)
        assert ep == er and sp == sr
        assert ep > 0 and sp["cmds_per_step"] > 0


def test_rendezvous_and_setup_equal():
    specs_b = {s: (t_get_backend if s == "port" else r_get_backend)(
        "simulated_rdma", net_cfg=SIDES[s][1](mode="srd", seed=1))
        for s in SIDES}
    w = {s: _world(s, 4, 16, 2, 64, 8, 4, "srd", "fp8", 1) for s in SIDES}
    assert specs_b["port"]._rendezvous_us(4, 448) == \
        specs_b["ref"]._rendezvous_us(4, 448)
    assert specs_b["port"]._setup_us(w["port"]) == \
        specs_b["ref"]._setup_us(w["ref"])


# --------------------------------------------- threaded proxies ----------
@pytest.mark.timeout(60)
@pytest.mark.parametrize("proto", ["ll", "ht"])
def test_threaded_world_matches_reference(proto):
    """Worker threads drain the FIFOs concurrently with the event-clock
    pump; their batching is not deterministic, but the output must equal
    the reference's inline run bit for bit (the order of a token's sums is
    fixed by the plan, not by delivery)."""
    R, E, K, D, F, Tl = 2, 8, 2, 8, 8, 6
    x, ti, tw, wg, wu, wd = _problem(70, R, E, K, D, F, Tl)
    ref = _world("ref", R, E, K, D, F, Tl, "srd", "fp32", 4)
    want = (ref.run(x, ti, tw, wg, wu, wd) if proto == "ll"
            else ref.run_ht(x, ti, tw, wg, wu, wd, n_chunks=2))
    w = _world("port", R, E, K, D, F, Tl, "srd", "fp32", 4,
               use_threads=True, n_threads=2)
    try:
        got = (w.run(x, ti, tw, wg, wu, wd) if proto == "ll"
               else w.run_ht(x, ti, tw, wg, wu, wd, n_chunks=2))
    finally:
        for p in w.proxies:
            p.stop()
    np.testing.assert_array_equal(got, want)
    _quiesce_clean(w)


# ------------------------------------- the fuzz properties, on the port --
EPS_GRID = (1, 63, 64)
WIRE_TOL = {"fp32": 0.0, "fp8": 0.2, "int8": 0.05}


def _quiesce_clean(w):
    assert w.net.pending == 0
    for p in w.proxies:
        assert p.error is None and not p.busy
        for cb in p.ctrl.values():
            assert cb.n_held == 0
            assert all(not h for h in cb._arrived.values())


def _fuzz_world(mode, proto, eps, seed, wdt="fp32", **kw):
    """The reference fuzz harness's randomized world, on the port: R = 2,
    random K, Tl, SRD window and chunks from ``seed``."""
    rng = np.random.default_rng(seed)
    R, D = 2, 8
    E = eps * R
    K = int(rng.integers(1, 4))
    Tl = int(rng.integers(4, 9))
    window = int(rng.choice([1, 16, 128]))
    x = rng.standard_normal((R, Tl, D)).astype(np.float32)
    ti = rng.integers(0, E, size=(R, Tl, K)).astype(np.int32)
    tw = rng.random((R, Tl, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    wg, wu, wd = ((rng.standard_normal(sh) * 0.2).astype(np.float32)
                  for sh in ((E, D, D), (E, D, D), (E, D, D)))
    w = t_ep.EPWorld(n_ranks=R, n_experts=E, top_k=K, d=D, f=D,
                     capacity=Tl * K, wire_dtype=wdt,
                     net_cfg=TNet(mode=mode, seed=seed,
                                  reorder_window=window), **kw)
    try:
        out = (w.run(x, ti, tw, wg, wu, wd) if proto == "ll" else
               w.run_ht(x, ti, tw, wg, wu, wd,
                        n_chunks=int(rng.integers(1, 5))))
    finally:
        for p in w.proxies:
            p.stop()
    return out, r_ep.EPWorld.oracle(x, ti, tw, wg, wu, wd), w


def _conformance(mode, proto, eps, seed, wdt="fp32"):
    """The dense oracle within the wire's tolerance (fp32: the reference
    fuzz's 1e-4 relative) and a clean quiesce."""
    out, ref, w = _fuzz_world(mode, proto, eps, seed, wdt)
    if wdt == "fp32":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(out - ref).max() <= WIRE_TOL[wdt] * (
            np.abs(ref).max() + 1e-9)
    _quiesce_clean(w)


def _drains_agree(mode, proto, eps, seed, wdt="fp32"):
    """Scalar vs columnar vs columnar + coalesced drains on the port:
    identical outputs and memories, identical apply logs without
    coalescing, the same apply multisets and no more messages with it."""
    runs = {}
    for name, kw in (("scalar", dict(columnar=False, coalesce=False)),
                     ("columnar", dict(coalesce=False)),
                     ("coalesced", {})):
        out, _, w = _fuzz_world(mode, proto, eps, seed, wdt, **kw)
        logs = {(p.rank, s): tuple(cb.applied_log)
                for p in w.proxies for s, cb in sorted(p.ctrl.items())}
        runs[name] = (out, [p.mem.data.copy() for p in w.proxies], logs,
                      w.net.delivered)
        _quiesce_clean(w)
    o_s, m_s, l_s, d_s = runs["scalar"]
    for name in ("columnar", "coalesced"):
        o, m, l, d = runs[name]
        np.testing.assert_array_equal(o, o_s)
        for a, b in zip(m, m_s):
            np.testing.assert_array_equal(a, b)
        if name == "columnar":
            assert l == l_s and d == d_s
        else:
            assert d <= d_s and set(l) == set(l_s)
            for k in l_s:
                assert sorted(l[k]) == sorted(l_s[k])


@pytest.mark.parametrize("eps", EPS_GRID)
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_port_conformance_seeded(mode, eps):
    for proto in ("ll", "ht"):
        for seed in (0, 1):
            _conformance(mode, proto, eps, seed)


@pytest.mark.parametrize("wdt", ["fp8", "int8"])
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_port_wire_conformance_seeded(mode, wdt):
    for proto in ("ll", "ht"):
        _conformance(mode, proto, 4, 3, wdt)


@pytest.mark.parametrize("wdt", ["fp32", "fp8"])
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_port_drains_agree_seeded(mode, wdt):
    for proto in ("ll", "ht"):
        _drains_agree(mode, proto, 64 if wdt == "fp32" else 4, 3, wdt)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("proto", ["ll", "ht"])
def test_port_conformance_threaded(proto):
    out, ref, w = _fuzz_world("srd", proto, 64, 2, use_threads=True,
                              n_threads=2)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    _quiesce_clean(w)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       mode=st.sampled_from(["rc", "srd"]),
       proto=st.sampled_from(["ll", "ht"]),
       eps=st.sampled_from(EPS_GRID),
       wdt=st.sampled_from(["fp32", "fp8", "int8"]))
def test_port_conformance_property(seed, mode, proto, eps, wdt):
    _conformance(mode, proto, eps, seed, wdt)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       mode=st.sampled_from(["rc", "srd"]),
       proto=st.sampled_from(["ll", "ht"]))
def test_port_drains_agree_property(seed, mode, proto):
    _drains_agree(mode, proto, 4, seed)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       mode=st.sampled_from(["rc", "srd"]),
       proto=st.sampled_from(["ll", "ht"]),
       wdt=st.sampled_from(["fp32", "fp8", "int8"]))
def test_port_equals_reference_property(seed, mode, proto, wdt):
    """Hypothesis form of the bit-for-bit agreement with the reference."""
    outs, worlds, _ = _run_both(proto, mode, wdt, seed, bool(seed % 2),
                                n_chunks=1 + seed % 3, R=2, eps=3)
    np.testing.assert_array_equal(outs["port"], outs["ref"])
    _assert_same_state(_state(worlds["port"]), _state(worlds["ref"]))


def test_dataclass_fields_equal():
    """The port's EPWorld takes the reference's fields, in its order."""
    assert [f.name for f in dataclasses.fields(t_ep.EPWorld)] == \
        [f.name for f in dataclasses.fields(r_ep.EPWorld)]
