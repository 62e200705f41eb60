"""The port's transport substrate leaves (``repro_torch.core.transport``)
against the reference's (``repro.core.transport``) on the same seeded
inputs: packed command words and their columns, FIFO flow control and its
``pcie_reads``, the immediate-data codec, guard-table resolves, control
buffer release order under the same delivery orders, the network's event
clock and byte accounting under the same ``NetConfig`` seeds, the row
codecs' bytes and ``plan.receive_bucket_table``.  Every comparison is
exact: the port is a copy of host code, so nothing may differ by a bit."""
import dataclasses
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import plan as np_plan  # noqa: E402
from repro.core.transport import codec as r_codec  # noqa: E402
from repro.core.transport import fifo as r_fifo  # noqa: E402
from repro.core.transport import semantics as r_sem  # noqa: E402
from repro.core.transport import simulator as r_sim  # noqa: E402
from repro.core.transport import wire_format as r_wf  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.transport import codec as t_codec  # noqa: E402
from repro_torch.core.transport import fifo as t_fifo  # noqa: E402
from repro_torch.core.transport import semantics as t_sem  # noqa: E402
from repro_torch.core.transport import simulator as t_sim  # noqa: E402
from repro_torch.core.transport import wire_format as t_wf  # noqa: E402

pytestmark = pytest.mark.timeout(60)


def _fields(rng, n):
    return (rng.integers(1, 6, n), rng.integers(0, 1 << 12, n),
            rng.integers(0, 256, n), rng.integers(0, 1 << 32, n),
            rng.integers(0, 1 << 32, n), rng.integers(0, 1 << 20, n),
            rng.integers(0, 1 << 12, n), rng.integers(0, 256, n))


def test_wire_format_constants_equal():
    names = [n for n in dir(r_wf) if n.isupper()]
    assert names
    for n in names:
        assert getattr(t_wf, n) == getattr(r_wf, n), n
    assert issubclass(t_wf.ProtocolError, Exception)


def _cmd(c):
    return tuple(int(v) for v in dataclasses.astuple(c))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_cmds_words_equal(seed):
    """Packed (N, 4) uint32 words, column for column and the scalar
    TransferCmd's 128 bits."""
    f = _fields(np.random.default_rng(seed), 257)
    got, ref = t_fifo.pack_cmds(*f), r_fifo.pack_cmds(*f)
    assert got.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    for i in range(0, 257, 37):
        args = [int(a[i]) for a in f]
        args[0] = t_fifo.Op(args[0])
        tc = t_fifo.TransferCmd(*args)
        args[0] = r_fifo.Op(int(args[0]))
        rc = r_fifo.TransferCmd(*args)
        np.testing.assert_array_equal(tc.pack(), rc.pack())
        assert _cmd(t_fifo.TransferCmd.unpack(ref[i])) == _cmd(
            r_fifo.TransferCmd.unpack(ref[i]))


@pytest.mark.parametrize("seed", [3, 4])
def test_unpack_cmds_columns_equal(seed):
    words = r_fifo.pack_cmds(*_fields(np.random.default_rng(seed), 129))
    got, ref = t_fifo.unpack_cmds(words), r_fifo.unpack_cmds(words)
    assert got._fields == ref._fields
    for name in ref._fields:
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def _fifo_script(mod, seed):
    """One seeded push / try_push / pop / pop_all script on ``mod``'s
    FifoChannel; returns everything observable after each step."""
    rng = np.random.default_rng(seed)
    ch = mod.FifoChannel(k_max_inflight=8)
    log = []
    tail = 0
    for step in range(60):
        a = int(rng.choice(4, p=[0.35, 0.35, 0.2, 0.1]))   # fills up
        if a == 0:
            idx = ch.try_push(mod.TransferCmd(mod.Op.WRITE, 0, 0, step, 0,
                                              16, 0))
            tail += idx is not None
            log.append(("try_push", idx))
        elif a == 1:
            n = int(rng.integers(1, 6))
            words = mod.pack_cmds(int(mod.Op.WRITE), 0, 0,
                                  np.arange(step, step + n), 0, 16, 0)
            k = ch.try_push_batch(words)
            tail += k
            log.append(("try_push_batch", k, n))
        elif a == 2:
            got = ch.pop()
            log.append(("pop", None if got is None else
                        (got[0], got[1].src_off)))
        else:
            got = ch.pop_all()
            log.append(("pop_all", None if got is None else got.tolist()))
        log.append((ch.inflight, ch.pcie_reads,
                    ch.check_completion_batch(
                        np.arange(max(0, tail - 8), tail)).tolist()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fifo_flow_control_and_pcie_reads_equal(seed):
    """The bounded ring's flow control (full-ring refusals, inflight, the
    completion probe) and its cached-head 'PCIe' read count, step for step
    over one seeded script."""
    got, ref = _fifo_script(t_fifo, seed), _fifo_script(r_fifo, seed)
    assert got == ref
    assert any((e[0] == "try_push" and e[1] is None)
               or (e[0] == "try_push_batch" and e[1] < e[2])
               for e in ref if isinstance(e[0], str)), "the ring never filled"


def test_fifo_spsc_threaded_order():
    """The port's ring with a real consumer thread: no loss, no dup, in
    order, never more than kMaxInflight in flight."""
    ch = t_fifo.FifoChannel(k_max_inflight=8)
    recv, stop = [], threading.Event()

    def consumer():
        while len(recv) < 200 and not stop.is_set():
            got = ch.pop()
            if got is not None:
                recv.append(got[1].src_off)
    th = threading.Thread(target=consumer, daemon=True)
    th.start()
    try:
        for i in range(200):
            ch.push(t_fifo.TransferCmd(t_fifo.Op.WRITE, 0, 0, i, 0, 16, 0),
                    timeout=5.0)
            assert ch.inflight <= 8
        th.join(timeout=5)
    finally:
        stop.set()
        th.join(timeout=2)
    assert recv == list(range(200))


def test_imm_codec_equal():
    rng = np.random.default_rng(5)
    for kind in (r_sem.ImmKind.WRITE, r_sem.ImmKind.SEQ_ATOMIC,
                 r_sem.ImmKind.BARRIER, r_sem.ImmKind.FENCE_ATOMIC):
        wide = kind == r_sem.ImmKind.FENCE_ATOMIC
        for _ in range(200):
            ch = int(rng.integers(0, 8))
            seq = 0 if wide else int(rng.integers(0, 2048))
            val = int(rng.integers(0, 1 << (21 if wide else 16)))
            ref = r_sem.pack_imm(kind, ch, seq, val)
            got = t_sem.pack_imm(t_sem.ImmKind(int(kind)), ch, seq, val)
            assert got == ref
            u = t_sem.unpack_imm(ref)
            assert tuple(int(v) for v in u) == tuple(
                int(v) for v in r_sem.unpack_imm(ref))


def test_guard_table_resolves_equal():
    rng = np.random.default_rng(6)
    regs = [(100, 50, 7), (0, 100, 3), (1000, 8, 9), (400, 200, 12)]
    tg, rg = t_sem.GuardTable(), r_sem.GuardTable()
    offs = rng.integers(0, 1200, 300)
    for b, e, g in regs:
        tg.register(b, e, g)
        rg.register(b, e, g)
        np.testing.assert_array_equal(tg.resolve_batch(offs),
                                      rg.resolve_batch(offs))
        assert [tg.resolve(int(o)) for o in offs] == \
            [rg.resolve(int(o)) for o in offs]
    with pytest.raises(t_wf.ProtocolError):
        tg.register(140, 20, 11)          # overlaps [100, 150)
    with pytest.raises(r_wf.ProtocolError):
        rg.register(140, 20, 11)


def _events(rng, sem, n_buckets=4, bucket_bytes=32, n_channels=3):
    """A seeded stream of writes (registered and not), seq atomics and
    satisfiable fences, as the reference's fuzz harness makes them, with
    ``sem``'s immediate codec."""
    events, next_seq, bw = [], [0] * n_channels, [0] * n_buckets
    for _ in range(int(rng.integers(4, 40))):
        ch = int(rng.integers(0, n_channels))
        seq = next_seq[ch]
        next_seq[ch] += 1
        if rng.random() < 0.75:
            if rng.random() < 0.25:
                off = n_buckets * bucket_bytes + 17 + int(rng.integers(0, 64))
            else:
                g = int(rng.integers(0, n_buckets))
                off = g * bucket_bytes + int(rng.integers(0, bucket_bytes))
                bw[g] += 1
            events.append(("w", sem.pack_imm(sem.ImmKind.WRITE, ch, seq, 0),
                           off))
        else:
            events.append(("s", sem.pack_imm(
                sem.ImmKind.SEQ_ATOMIC, ch, seq,
                int(rng.integers(0, 1 << 16))), None))
    for g in range(n_buckets):
        if bw[g] and rng.random() < 0.8:
            need = int(rng.integers(1, bw[g] + 1))
            events.append(("f", sem.pack_imm(sem.ImmKind.FENCE_ATOMIC, 0, 0,
                                             need), g))
    return events


def _messages(rng, sem, events):
    """Wire messages from a sent event stream, as the columnar proxy makes
    them: runs of consecutive same-channel writes (random lengths) in one
    message, every other event a message of its own."""
    msgs, run = [], []
    for kind, imm, off in events:
        ch = sem.unpack_imm(imm)[1] if kind == "w" else None
        if run and (kind != "w" or run[0][0] != ch or len(run) >= run[0][3]):
            msgs.append(("w", [(i, o) for _, i, o, _ in run]))
            run = []
        if kind == "w":
            run.append((ch, imm, off, int(rng.integers(1, 8))))
        else:
            msgs.append((kind, imm, off))
    if run:
        msgs.append(("w", [(i, o) for _, i, o, _ in run]))
    return msgs


def _replay(sem, seed, batched):
    """Deliver one seeded stream's wire messages in one seeded order through
    ``sem``'s ControlBuffer (a run of writes through ``on_write_batch`` when
    ``batched``, else write by write); returns what it released, in order,
    and its state."""
    rng = np.random.default_rng(seed)
    msgs = _messages(rng, sem, _events(rng, sem))
    guards = sem.GuardTable()
    for g in range(4):
        guards.register(g * 32, 32, g)
    cb = sem.ControlBuffer(guards=guards)
    released = []
    for i in rng.permutation(len(msgs)):
        m = msgs[i]
        if m[0] == "w" and batched and len(m[1]) > 1:
            cb.on_write_batch(np.array([imm for imm, _ in m[1]], np.uint32),
                              np.array([off for _, off in m[1]], np.int64))
            released.append(("wb", int(i)))
        elif m[0] == "w":
            for imm, off in m[1]:
                cb.on_write(imm, lambda i=i: released.append(("w", int(i))),
                            off)
        elif m[0] == "s":
            cb.on_atomic(m[1], lambda i=i: released.append(("s", int(i))))
        else:
            cb.on_atomic(m[1], lambda i=i: released.append(("f", int(i))),
                         guard=m[2])
    return (released, list(cb.applied_log), dict(cb.writes_seen),
            list(cb.next_seq), cb.n_held)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_control_buffer_release_order_equal(seed, batched):
    """Fence release and per-channel sequence order: the same seeded
    stream in the same seeded delivery order releases the same atomics in
    the same order, with the same per-guard write counts, in both."""
    got, ref = _replay(t_sem, seed, batched), _replay(r_sem, seed, batched)
    assert got == ref
    assert ref[-1] == 0                   # everything released


def _net_run(sim, mode, seed, batch):
    """Seeded traffic through ``sim``'s Network: writes of mixed sizes and
    zero-byte immediates over three ranks, sent one by one or in batches,
    with a Timer; returns the delivery log and the clock's accounting."""
    rng = np.random.default_rng(seed)
    cfg = sim.NetConfig(mode=mode, seed=seed, reorder_window=16)
    net = sim.Network(cfg, 3, threadsafe=False)
    log = []
    for r in range(3):
        net.register(r, lambda m, r=r: log.append(
            (r, m.src, m.kind, m.dst_off, m.size, m.deliver_t)))
    msgs = []
    for i in range(60):
        src, dst = (int(v) for v in rng.choice(3, 2, replace=False))
        if rng.random() < 0.7:
            n = int(rng.integers(1, 4096))
            msgs.append(sim.Message(src=src, dst=dst, qp=i % 4, kind="write",
                                    dst_off=i * 8192,
                                    payload=np.zeros(n, np.uint8), imm=i))
        else:
            msgs.append(sim.Message(src=src, dst=dst, qp=i % 4, kind="imm",
                                    dst_off=i, payload=None, imm=i))
    net.call_at(3.0, lambda: log.append(("timer", net.clock_us)))
    if batch:
        for k in range(0, 60, 13):
            net.send_batch(msgs[k:k + 13])
    else:
        for m in msgs:
            net.send(m)
    while net.pending:
        net.deliver_ready()
    return (log, net.clock_us, net.delivered, net.bytes_moved,
            net.hdr_bytes_moved, net.wire_bytes_moved)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mode", ["rc", "srd"])
def test_network_clock_and_bytes_equal(mode, seed, batch):
    """The event clock (every delivery's time and order, the Timer's) and
    ``wire_bytes_moved`` under the same NetConfig seed, RC and SRD."""
    got = _net_run(t_sim, mode, seed, batch)
    ref = _net_run(r_sim, mode, seed, batch)
    assert got == ref
    assert ref[2] == 60 and ref[5] > ref[3] > 0


@pytest.mark.parametrize("wdt", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("d", [8, 200, 2048])
def test_codec_bytes_equal(wdt, d):
    """The row codecs' wire bytes (quantized payload and inline scales) and
    their fp32 decode, bit for bit; fp8 without ``ml_dtypes`` in the
    port."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((33, d)) * rng.choice([1e-3, 1.0, 300.0],
                                                   (33, 1))).astype(np.float32)
    x[3] = 0.0                                        # an all-zero row
    tc, rc = t_codec.get_codec(wdt), r_codec.get_codec(wdt)
    assert tc.name == rc.name and tc.wire_bytes(d) == rc.wire_bytes(d)
    assert tuple(tc.layout(d)) == tuple(rc.layout(d))
    got, ref = tc.encode(x), rc.encode(x)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    dg, dr = tc.decode(ref, d), rc.decode(ref, d)
    assert dg.dtype == dr.dtype == np.float32
    np.testing.assert_array_equal(dg, dr)
    assert t_codec.WIRE_DTYPES == r_codec.WIRE_DTYPES


def test_get_codec_unknown_raises():
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        t_codec.get_codec("bf16")


@pytest.mark.parametrize("args", [(8, 0, 64, None, 0), (5, 1000, 96, 80, 40),
                                  (1, 7, 16, 16, 3)])
def test_receive_bucket_table_equal(args):
    got, ref = t_plan.receive_bucket_table(*args), \
        np_plan.receive_bucket_table(*args)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
