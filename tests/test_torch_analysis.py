"""The port's protocol verifier and race detector
(``repro_torch.analysis``) against the reference's: ``verify`` on the
generated streams (no findings) and on the reference's planted mutants
(the same finding ids from both), and the lockset detector clean on the
port's threaded world, flagging the lock-removal mutant, and uninstalling
its constructor wrappers."""
import importlib
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis import invariants as r_inv  # noqa: E402
from repro.core.plan import wire_layout  # noqa: E402
from repro.core.transport import ep_executor as r_ep  # noqa: E402
from repro.core.transport import fifo as r_fifo  # noqa: E402
from repro.core.transport.simulator import NetConfig as RNet  # noqa: E402
from repro_torch.analysis import CATALOG, verify, verify_or_raise  # noqa: E402
from repro_torch.analysis import racecheck as t_race  # noqa: E402
from repro_torch.core.transport import ep_executor as t_ep  # noqa: E402
from repro_torch.core.transport import fifo as t_fifo  # noqa: E402
from repro_torch.core.transport.simulator import NetConfig as TNet  # noqa: E402
from repro_torch.core.transport.wire_format import ProtocolError  # noqa: E402

pytestmark = pytest.mark.timeout(60)

# the packages export the function ``verify``, which shadows the module
t_verify_mod = importlib.import_module("repro_torch.analysis.verify")
r_verify_mod = importlib.import_module("repro.analysis.verify")

SIDES = {"port": (t_ep, t_fifo, t_verify_mod, TNet),
         "ref": (r_ep, r_fifo, r_verify_mod, RNet)}


def test_catalog_equal():
    assert CATALOG.keys() == r_inv.CATALOG.keys()
    for rid, rule in CATALOG.items():
        ref = r_inv.CATALOG[rid]
        assert (rule.id, rule.title, rule.statement) == \
            (ref.id, ref.title, ref.statement)


def _ll_cs(ep, wdt="fp32", eps=4, seed=0, R=2, Tl=6, K=2, D=8, ti=None,
           nc=4):
    """A clean LL CommandStreams in EPWorld's memory layout."""
    rng = np.random.default_rng(seed)
    E = eps * R
    if ti is None:
        ti = rng.integers(0, E, size=(R, Tl, K)).astype(np.int32)
    R, Tl, K = ti.shape
    cap = Tl * K
    wb = wire_layout(D, wdt).token_bytes
    recv0 = Tl * wb
    ret0 = recv0 + R * eps * cap * wb
    return ep.build_command_streams(ti, E, eps, cap, 4 * D, nc, 0, recv0,
                                    ret0, wire_bytes=wb)


def _repack(fifo, words, **mut):
    c = fifo.unpack_cmds(np.asarray(words).reshape(-1, 4))
    f = {k: np.array(getattr(c, k)) for k in
         ("op", "dst_rank", "channel", "src_off", "dst_off", "length",
          "value", "flags")}
    for k, v in mut.items():
        if isinstance(v, tuple):
            f[k][v[0]] = v[1]
        else:
            f[k] = v
    return fifo.pack_cmds(f["op"], f["dst_rank"], f["channel"], f["src_off"],
                          f["dst_off"], f["length"], f["value"], f["flags"])


@pytest.mark.parametrize("wdt", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_verify_accepts_generated_streams(mode, wdt):
    for eps, seed in ((1, 0), (4, 1), (64, 2), (65, 3)):
        for side, (ep, _, vm, Net) in SIDES.items():
            cs = _ll_cs(ep, wdt, eps=eps, seed=seed)
            findings = vm.verify(cs, net_cfg=Net(mode=mode, seed=seed),
                                 n_channels=4)
            assert findings == [], (side, [str(f) for f in findings])


def _mutant(name, ep, fifo, vm, Net):
    """One of the reference fuzz harness's planted mutants, built on the
    given side's streams; returns its findings."""
    cs = _ll_cs(ep)
    rp = lambda words, **m: _repack(fifo, words, **m)  # noqa: E731
    if name == "epv001":
        return vm.verify(cs._replace(writes=rp(cs.writes, channel=(0, 8))),
                         n_channels=8)
    if name == "epv002":
        return vm.verify(cs._replace(fences=rp(cs.fences,
                                               src_off=(0, 2 ** 21))),
                         n_channels=4)
    if name == "epv003":
        return vm.verify_stream(fifo.pack_cmds(int(fifo.Op.ATOMIC), 1, 0,
                                               70000, 3, 0, 0))
    if name == "epv004":
        b, e, g = cs.guard_table
        return vm.verify(cs._replace(guard_table=(b, np.asarray(e) * 2, g)),
                         n_channels=4)
    if name == "epv005":
        ti = np.array([[[0, 64], [64, 3], [0, 7], [1, 2]],
                       [[65, 129], [5, 6], [70, 100], [8, 9]]], np.int32)
        cs = _ll_cs(ep, eps=65, ti=ti)
        b, e, g = cs.guard_table
        fences = rp(cs.fences, dst_off=np.asarray(fifo.unpack_cmds(
            np.asarray(cs.fences).reshape(-1, 4)).dst_off) % 64)
        return vm.verify(cs._replace(guard_table=(b, e, np.asarray(g) % 64),
                                     fences=fences), n_channels=4)
    if name == "epv006":
        cs = _ll_cs(ep, "fp8")
        c = fifo.unpack_cmds(np.asarray(cs.writes).reshape(-1, 4))
        ext = int(np.max(cs.guard_table[1]))
        return vm.verify(cs._replace(writes=rp(
            cs.writes, length=(0, int(c.length[0]) + ext))), n_channels=4)
    if name == "epv007":
        c = fifo.unpack_cmds(np.asarray(cs.fences).reshape(-1, 4))
        return vm.verify(cs._replace(fences=rp(
            cs.fences, src_off=(0, int(c.src_off[0]) + 1))), n_channels=4)
    if name == "epv008":
        return vm.verify(net_cfg=Net(mode="srd", reorder_window=600))
    if name == "epv009":
        a = ep.SessSlot(send0=0, recv0=64, mid0=128, ret0=192, end=256,
                        guard0=0, ch0=0, ncl=2)
        b = ep.SessSlot(send0=200, recv0=264, mid0=328, ret0=392, end=456,
                        guard0=0, ch0=0, ncl=2)
        return vm.verify_session_slots([a, b], n_channels=4,
                                       counter_stride=128)
    if name == "epv010":
        return vm.verify(cs._replace(writes=rp(
            cs.writes, op=(0, int(fifo.Op.BARRIER)))), n_channels=4)
    if name == "epv012":
        return vm.verify(cs._replace(combines=rp(
            cs.combines, dst_off=(0, int(np.min(cs.guard_table[0]))))),
            n_channels=4)
    raise KeyError(name)


MUTANTS = {"epv001": "EPV-001", "epv002": "EPV-002", "epv003": "EPV-003",
           "epv004": "EPV-004", "epv005": "EPV-005", "epv006": "EPV-006",
           "epv007": "EPV-007", "epv008": "EPV-008", "epv009": "EPV-009",
           "epv010": "EPV-010", "epv012": "EPV-012"}


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_planted_mutants_same_findings(name):
    """Each planted mutant draws the same findings (rule ids, in order,
    and messages) from the port as from the reference, including the rule
    the catalog assigns it."""
    got = _mutant(name, *SIDES["port"])
    ref = _mutant(name, *SIDES["ref"])
    assert [f.rule for f in got] == [f.rule for f in ref]
    assert [f.message for f in got] == [f.message for f in ref]
    assert MUTANTS[name] in {f.rule for f in got}


def test_verify_or_raise_names_rule_ids():
    cs = _ll_cs(t_ep)
    bad = cs._replace(writes=_repack(t_fifo, cs.writes,
                                     op=(0, int(t_fifo.Op.BARRIER))))
    with pytest.raises(ProtocolError, match="EPV-010"):
        verify_or_raise(bad, n_channels=4)
    assert verify(cs, n_channels=4) == []


def test_verifier_live_in_port_world():
    """The port's EPWorld calls the port's verifier when it builds streams
    and lays out a session: a planted fault in the verifier's input (a
    reorder window at the unwrap bound) stops the run before traffic."""
    rng = np.random.default_rng(0)
    R, E, K, D, Tl = 2, 4, 2, 8, 4
    x = rng.standard_normal((R, Tl, D)).astype(np.float32)
    ti = rng.integers(0, E, (R, Tl, K)).astype(np.int32)
    tw = np.full((R, Tl, K), 0.5, np.float32)
    w3 = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((E, D, 8), (E, D, 8), (E, 8, D))]
    w = t_ep.EPWorld(n_ranks=R, n_experts=E, top_k=K, d=D, f=8,
                     capacity=Tl * K, net_cfg=TNet(mode="rc", seed=0))
    w.run(x, ti, tw, *w3)                     # clean: verifies and runs
    w.net_cfg = TNet(mode="srd", seed=0)
    w.net_cfg.reorder_window = 600            # past the unwrap bound
    with pytest.raises(ProtocolError, match="EPV-008"):
        w.run(x, ti, tw, *w3)


# ------------------------------------------------------------ racecheck --
def _spsc_workload(ch, n=200):
    words = t_fifo.pack_cmds(1, np.zeros(n, np.int64), 0, np.arange(n),
                             np.arange(n), 8, 0)
    got, stop = [], threading.Event()

    def consumer():
        while len(got) < n and not stop.is_set():
            out = ch.pop_all()
            if out is None:
                ch.wait_nonempty(0.01)
            else:
                got.extend(out.tolist())
    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    try:
        done = 0
        while done < n:
            done += ch.try_push_batch(words[done:done + 7])
            ch.check_completion_batch([max(0, done - 1)])
            _ = ch.pcie_reads
        t.join(timeout=10)
    finally:
        stop.set()
        t.join(timeout=2)
    assert len(got) == n


def test_racecheck_clean_on_port_fifo():
    with t_race.RaceChecker() as rc:
        ch = t_fifo.FifoChannel(16)
        _spsc_workload(ch)
    assert rc.findings() == [], [str(f) for f in rc.findings()]


def test_racecheck_flags_lock_removal_mutant():
    with t_race.RaceChecker() as rc:
        ch = t_fifo.FifoChannel(16)
        rc.instrument(ch, strip_locks=True)
        _spsc_workload(ch)
    rules = {f.rule for f in rc.findings()}
    flagged = {f.where[1] for f in rc.findings()}
    assert rules == {"RACE-LOCKSET"}
    assert "_head" in flagged or "_tail" in flagged, flagged


@pytest.mark.timeout(60)
def test_racecheck_clean_on_port_threaded_world():
    """The port's threaded path (worker proxies draining FIFOs while the
    event-clock pump runs) with zero candidate races, and its output equal
    to the reference's inline run."""
    rng = np.random.default_rng(0)
    R, eps, K, D, Tl = 2, 2, 2, 8, 4
    E = eps * R
    x = rng.standard_normal((R, Tl, D)).astype(np.float32)
    ti = rng.integers(0, E, size=(R, Tl, K)).astype(np.int32)
    tw = np.full((R, Tl, K), 1.0 / K, np.float32)
    w3 = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((E, D, 8), (E, D, 8), (E, 8, D))]
    with t_race.RaceChecker() as rc:
        w = t_ep.EPWorld(n_ranks=R, n_experts=E, top_k=K, d=D, f=8,
                         capacity=Tl * K, net_cfg=TNet(mode="srd", seed=0),
                         use_threads=True, n_threads=2)
        try:
            out = w.run(x, ti, tw, *w3)
        finally:
            for p in w.proxies:
                p.stop()
    ref = r_ep.EPWorld(n_ranks=R, n_experts=E, top_k=K, d=D, f=8,
                       capacity=Tl * K, net_cfg=RNet(mode="srd", seed=0))
    np.testing.assert_array_equal(out, ref.run(x, ti, tw, *w3))
    assert rc.findings() == [], [str(f) for f in rc.findings()]


def test_racecheck_uninstalls_cleanly():
    """Inside the window the port's three constructors are wrapped; after
    it they are the originals again, and new objects are untracked."""
    from repro_torch.core.transport.proxy import Proxy
    from repro_torch.core.transport.simulator import Network
    before = (t_fifo.FifoChannel.__init__, Network.__init__, Proxy.__init__)
    with t_race.RaceChecker():
        assert t_fifo.FifoChannel.__init__ is not before[0]
        assert Network.__init__ is not before[1]
        assert Proxy.__init__ is not before[2]
    assert (t_fifo.FifoChannel.__init__, Network.__init__,
            Proxy.__init__) == before
    ch = t_fifo.FifoChannel(4)
    assert type(ch) is t_fifo.FifoChannel


def test_tracked_fields_exist_on_port():
    from repro_torch.core.transport.proxy import Proxy, SymmetricMemory
    from repro_torch.core.transport.simulator import Network
    ch = t_fifo.FifoChannel(4)
    for f in t_race.TRACKED_FIELDS["FifoChannel"]:
        assert hasattr(ch, f), f
    net = Network(TNet(mode="rc", seed=0), n_ranks=1)
    for f in t_race.TRACKED_FIELDS["Network"]:
        assert hasattr(net, f), f
    p = Proxy(rank=0, net=net, mem=SymmetricMemory(
        data=np.zeros(1024, np.uint8), counters=np.zeros(8, np.int64)))
    for f in t_race.TRACKED_FIELDS["Proxy"]:
        assert hasattr(p, f), f
