"""The port's expert-level elasticity (``repro_torch.distributed.elastic``:
``LoadBalancer``, ``migrate_expert_weights``, ``MigrationStats``) and
``fault.RecoveryPolicy`` against the reference's on the same inputs: every
placement decision, window, imbalance and degraded placement equal, the
migrated tables and statistics equal (coalescing, same-rank copies, the
checkpoint restore, RC and SRD), and the degraded-rank drill of the
reference's ``tests/test_rebalance.py`` through the port's world."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as r_plan  # noqa: E402
from repro.core.transport.simulator import NetConfig as RNet  # noqa: E402
from repro.distributed import elastic as r_el  # noqa: E402
from repro.distributed import fault as r_fault  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.transport.ep_executor import (  # noqa: E402
    EPWorld, np_grouped_swiglu)
from repro_torch.core.transport.simulator import NetConfig as TNet  # noqa: E402
from repro_torch.distributed import elastic as t_el  # noqa: E402
from repro_torch.distributed import fault as t_fault  # noqa: E402

pytestmark = pytest.mark.timeout(120)

SIDES = {"port": (t_el, t_plan, TNet), "ref": (r_el, r_plan, RNet)}


def _placement(p):
    return (np.asarray(p.phys_to_logical), np.asarray(p.logical_to_phys),
            np.asarray(p.n_replicas))


def _same_placement(a, b):
    for x, y in zip(_placement(a), _placement(b)):
        np.testing.assert_array_equal(x, y)


# ================================================== LoadBalancer policy ==
def _lb_trace(side, kw, loads):
    """Each observation's (maybe_replace placement key or None, imbalance,
    window) on one side."""
    el = SIDES[side][0]
    lb = el.LoadBalancer(**kw)
    out = [(lb.placement.key(), lb.imbalance())]
    for load in loads:
        lb.observe(load)
        new = lb.maybe_replace()
        out.append((None if new is None else new.key(), lb.imbalance(),
                    lb.window_load().tolist(), lb.placement.key()))
    return lb, out


@pytest.mark.parametrize("kw", [
    dict(n_logical=8, n_ranks=4, slots_per_rank=3),
    dict(n_logical=8, n_ranks=4, slots_per_rank=2, interval=1,
         threshold=1.25),
    dict(n_logical=8, n_ranks=4, slots_per_rank=4, interval=4,
         threshold=1.0),
    dict(n_logical=8, n_ranks=4, slots_per_rank=4, interval=1,
         threshold=1.0),
    dict(n_logical=4, n_ranks=2, slots_per_rank=2, window=2),
    dict(n_logical=60, n_ranks=4, slots_per_rank=30),
], ids=["initial", "balanced", "cadence", "hot", "window", "qwen2_moe"])
def test_load_balancer_decisions_equal(kw):
    """The reference's LoadBalancer tests' configurations, driven with
    balanced, skewed, shifting and Zipf loads: every decision, imbalance,
    window and placement equal to the reference's."""
    E = kw["n_logical"]
    rng = np.random.default_rng(E)
    zipf = 1.0 / np.arange(1, E + 1) ** 1.2
    loads = [np.ones(E), np.r_[100.0, np.ones(E - 1)],
             np.r_[100.0, np.ones(E - 1)], np.r_[50.0, np.ones(E - 1)],
             np.r_[50.0, np.ones(E - 1)]]
    loads += [np.bincount(rng.choice(E, 64, p=zipf / zipf.sum()),
                          minlength=E).astype(np.int32) for _ in range(8)]
    loads += [np.zeros(E), rng.permutation(E).astype(np.float64)]
    (t_lb, t), (r_lb, r) = (_lb_trace(s, kw, loads) for s in SIDES)
    assert t == r
    assert all(isinstance(step[1], float) for step in t)
    _same_placement(t_lb.placement, r_lb.placement)


def test_imbalance_is_float64_at_a_tie():
    """The window imbalance is the float64 max/mean the reference computes:
    a load whose float32 max/mean rounds to the threshold (1.0) still
    re-places on both sides, as the reference's float64 value is above
    it."""
    load = np.array([1.0 + 2.0 ** -30, 1.0, 1.0 - 2.0 ** -30])
    assert np.float32(load.max()) / np.float32(load.mean()) == 1.0
    got = {}
    for side in SIDES:
        el, plan, _ = SIDES[side]
        lb = el.LoadBalancer(n_logical=3, n_ranks=3, slots_per_rank=1,
                             interval=1, threshold=1.0,
                             placement=plan.placement_from_table([2, 1, 0]))
        lb.observe(load)
        got[side] = (lb.imbalance(), lb.maybe_replace())
    assert got["port"][0] == got["ref"][0] > 1.0
    assert got["port"][1].key() == got["ref"][1].key() == (0, 1, 2)


@pytest.mark.parametrize("n_logical,n_ranks,spr,dead", [
    (8, 4, 2, 2), (8, 4, 2, 0), (8, 4, 3, 3), (60, 4, 15, 1)])
def test_degrade_equal(n_logical, n_ranks, spr, dead):
    got = {}
    for side in SIDES:
        lb = SIDES[side][0].LoadBalancer(n_logical=n_logical, n_ranks=n_ranks,
                                         slots_per_rank=spr)
        lb.observe(np.arange(1, n_logical + 1, dtype=np.float64))
        p = lb.degrade(dead_rank=dead)
        got[side] = (lb.n_ranks, lb.slots_per_rank, p)
    (tn, ts, tp), (rn, rs, rp) = got["port"], got["ref"]
    assert (tn, ts) == (rn, rs) == (n_ranks - 1, ts)
    _same_placement(tp, rp)
    assert set(np.asarray(tp.phys_to_logical)) == set(range(n_logical))
    eps = tp.n_physical // tn
    assert np.asarray(tp.logical_to_phys).max() < tn * eps


def test_degrade_refuses_a_bad_rank():
    lb = t_el.LoadBalancer(n_logical=4, n_ranks=2, slots_per_rank=2)
    with pytest.raises(AssertionError):
        lb.degrade(dead_rank=2)


# ===================================================== weight migration ==
def _migrate(side, holdings, new_fn, w_full, **kw):
    el, plan, net = SIDES[side]
    if "net_cfg" in kw:
        kw = {**kw, "net_cfg": net(**kw["net_cfg"])}
    return el.migrate_expert_weights(holdings, new_fn(plan), w_full, **kw)


@pytest.mark.parametrize("case", [
    "coalesced", "same_rank", "restore", "rc", "srd", "degraded"])
def test_migration_tables_and_stats_equal(case):
    """The reference's migration tests: the tables (every slot's row the
    logical expert's, byte for byte) and the MigrationStats equal."""
    rng = np.random.default_rng(3)
    kw = {}
    if case == "coalesced":
        e, wb = 8, 1024
        new_fn = lambda pl: pl.replicate_uniform(e, 2)  # noqa: E731
        holdings = [[0, 1], [2, 3], [4, 5], [6, 7]]
        kw = dict(chunk_bytes=128)
    elif case == "same_rank":
        e, wb = 4, 256
        new_fn = lambda pl: pl.identity_placement(e)  # noqa: E731
        holdings = [[0, 1], [2, 3]]
    elif case == "restore":
        e, wb = 4, 512
        new_fn = lambda pl: pl.identity_placement(e)  # noqa: E731
        holdings = [[0, 1], []]
    elif case == "degraded":
        e, wb = 8, 3 * 4 * 16 * 12
        new_fn = lambda pl: pl.greedy_placement(  # noqa: E731
            np.arange(1.0, 9.0), 9, 3)
        holdings = [[0, 1], [2, 3], [6, 7]]
        kw = dict(chunk_bytes=256)
    else:
        e, wb = 6, 768
        new_fn = lambda pl: pl.greedy_placement(  # noqa: E731
            np.array([9.0, 1, 1, 1, 1, 1]), 12, 3)
        holdings = [[0, 1], [2, 3], [4, 5]]
        kw = dict(chunk_bytes=64, net_cfg=dict(mode=case, seed=1,
                                               reorder_window=16))
    w_full = rng.integers(0, 256, size=(e, wb), dtype=np.uint8)
    (tt, ts), (rt, rs) = (_migrate(s, holdings, new_fn, w_full, **kw)
                          for s in SIDES)
    np.testing.assert_array_equal(tt, rt)
    assert isinstance(ts, t_el.MigrationStats)
    assert ts == t_el.MigrationStats(**vars(rs))
    new = new_fn(t_plan)
    eps = new.n_physical // len(holdings)
    for p in range(new.n_physical):
        r, s = divmod(p, eps)
        np.testing.assert_array_equal(tt[r, s],
                                      w_full[int(new.phys_to_logical[p])])
    if case == "coalesced":
        assert ts.sub_writes == ts.wire_slots * (wb // 128)
        assert ts.msgs < ts.sub_writes and ts.restored_slots == 0
    if case == "same_rank":
        assert ts.wire_slots == 0 and ts.local_slots == e
    if case in ("restore", "degraded"):
        assert ts.restored_slots >= 1


def _pack_rows(wg, wu, wd):
    e = wg.shape[0]
    flat = np.concatenate([wg.reshape(e, -1), wu.reshape(e, -1),
                           wd.reshape(e, -1)], axis=1).astype(np.float32)
    return np.ascontiguousarray(flat).view(np.uint8).reshape(e, -1)


def _unpack_tables(tables, d, f):
    r, eps, wb = tables.shape
    rows = tables.reshape(r * eps, wb).view(np.float32)
    n = d * f
    return (rows[:, :n].reshape(-1, d, f), rows[:, n:2 * n].reshape(-1, d, f),
            rows[:, 2 * n:].reshape(-1, f, d))


def test_degraded_rank_drill():
    """Rank 2 of 4 dies at step 1 (FailureInjector); the survivors re-place
    its experts through the LoadBalancer's shared path, migrate the weights
    over the substrate, and the recovered world quiesces cleanly and agrees
    with the dense oracle; the RecoveryPolicy allows the restart."""
    R0, E, K, D, F, T = 4, 8, 2, 16, 12, 24
    rng = np.random.default_rng(11)
    wg, wu, wd = (rng.standard_normal(sh).astype(np.float32) / np.sqrt(sh[1])
                  for sh in ((E, D, F), (E, D, F), (E, F, D)))
    w_full = _pack_rows(wg, wu, wd)
    x = rng.standard_normal((T, D)).astype(np.float32)
    ti = rng.integers(0, E, size=(T, K)).astype(np.int32)
    tw = rng.random((T, K)).astype(np.float32)
    tw /= tw.sum(1, keepdims=True)
    want = EPWorld.oracle(x.reshape(1, T, D), ti.reshape(1, T, K),
                          tw.reshape(1, T, K), wg, wu, wd).reshape(T, D)
    inj = t_fault.FailureInjector(at_steps=(1,))
    policy = t_fault.RecoveryPolicy(max_restarts=1)
    lb = t_el.LoadBalancer(n_logical=E, n_ranks=R0, slots_per_rank=E // R0,
                           placement=t_plan.identity_placement(E))
    ranks, eps0, w_now = R0, E // R0, (wg, wu, wd)
    for step in range(3):
        if inj(step):
            assert policy.should_restart()
            new = lb.degrade(dead_rank=2)
            ranks = lb.n_ranks
            holdings = [[r * eps0 + i for i in range(eps0)]
                        for r in range(R0) if r != 2]
            tables, st = t_el.migrate_expert_weights(holdings, new, w_full,
                                                     chunk_bytes=256)
            assert st.restored_slots >= 1
            w_now = _unpack_tables(tables, D, F)
            assert w_now[0].shape[0] == new.n_physical
        world = EPWorld(n_ranks=ranks, n_experts=lb.placement.n_physical,
                        top_k=K, d=D, capacity=(T // ranks) * K,
                        net_cfg=TNet(mode="srd", seed=7))
        tis = t_plan.split_to_physical_world(
            lb.placement, torch.from_numpy(ti.reshape(ranks, T // ranks, K)))
        got = world.run(x.reshape(ranks, T // ranks, D), tis.numpy(),
                        tw.reshape(ranks, T // ranks, K),
                        expert_fn=lambda t, counts=None: np_grouped_swiglu(
                            t, *w_now, counts=counts)).reshape(T, D)
        assert not world.net.pending
        assert not any(p.busy for p in world.proxies)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert inj.fired == {1} and ranks == R0 - 1
    assert not policy.should_restart()


# ======================================================= RecoveryPolicy ==
@pytest.mark.parametrize("max_restarts", [0, 1, 3])
def test_recovery_policy_equal(max_restarts):
    t = t_fault.RecoveryPolicy(max_restarts=max_restarts)
    r = r_fault.RecoveryPolicy(max_restarts=max_restarts)
    got = [(t.should_restart(), t.restarts) for _ in range(5)]
    assert got == [(r.should_restart(), r.restarts) for _ in range(5)]
    assert [ok for ok, _ in got] == [i < max_restarts for i in range(5)]
    assert t_fault.RecoveryPolicy() == t_fault.RecoveryPolicy(3, 0)
