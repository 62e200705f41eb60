"""``repro_torch.tracing`` on the CPU: span paths, totals and rings, the
profiled bucket and the profiler's ranges, counters, gauges, suspension,
snapshots; the spans the port places in the EP layer and the train step;
and the benchmark's four readers of them (``epbench/metrics``), on a
hand-built registry state."""
import importlib
import json
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch import tracing

ROOT = Path(__file__).resolve().parents[1]
READERS = ("graph_launch_ms.decode", "graph_nodes.decode",
           "optimizer_share.train", "dispatch_combine_share.train")


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def spans():
    return tracing.snapshot()["spans"]


def test_paths_nest():
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("b"):
        pass
    assert set(spans()) == {"a", "a/b", "a/b/c", "a/d", "b"}


def test_host_totals_and_counts_add_up():
    for _ in range(3):
        with tracing.span("outer"):
            for _ in range(2):
                with tracing.span("inner"):
                    time.sleep(0.002)
    s = spans()
    outer, inner = s["outer"]["unprofiled"], s["outer/inner"]["unprofiled"]
    assert outer["count"] == 3 and inner["count"] == 6
    assert inner["host_ms"] >= 6 * 2.0
    assert outer["host_ms"] >= inner["host_ms"]
    assert inner["host_median_ms"] >= 2.0
    agg = tracing._aggs[("outer/inner", "unprofiled")]
    assert sum(agg.host_ring) == pytest.approx(inner["host_ms"] * 1e6)
    # no CUDA here: no device interval
    assert inner["device_count"] == 0 and "device_median_ms" not in inner


def test_duration_rings_stay_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 8)
    for _ in range(20):
        with tracing.span("r"):
            pass
    agg = tracing._aggs[("r", "unprofiled")]
    assert agg.count == 20 and len(agg.host_ring) == 8
    assert spans()["r"]["unprofiled"]["host_ms"] == pytest.approx(
        agg.host_ns * 1e-6)


def test_span_under_profiler_is_a_range_in_the_profiled_bucket():
    """A span closed under the profiler is a range of its name in the
    trace (a host range, not a user annotation the profiler would mirror
    on the device) and lands in the profiled bucket alone; spans after it
    land in ``after_profiler`` until a reset."""
    from torch.profiler import ProfilerActivity, profile
    with tracing.span("quiet"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("tracing.loud"):
            torch.ones(4).sum()
    with tracing.span("quiet"):
        pass
    ranges = [e for e in prof.events() if e.name == "tracing.loud"]
    assert len(ranges) == 1 and not ranges[0].is_user_annotation
    s = spans()
    assert set(s["tracing.loud"]) == {"profiled"}
    assert s["tracing.loud"]["profiled"]["count"] == 1
    assert {b: v["count"] for b, v in s["quiet"].items()} == {
        "unprofiled": 1, "after_profiler": 1}
    tracing.reset()
    with tracing.span("quiet"):
        pass
    assert set(spans()["quiet"]) == {"unprofiled"}


def test_counters_and_gauges():
    tracing.count("c")
    tracing.count("c", 4)
    tracing.gauge("g", 7)
    tracing.gauge("g", 9)
    snap = tracing.snapshot()
    assert snap["counters"] == {"c": 5} and snap["gauges"] == {"g": 9}


def test_suspended_records_nothing():
    with tracing.suspended():
        with tracing.span("hidden"):
            pass
        with tracing.suspended():
            pass
        with tracing.span("still_hidden"):
            pass
    with tracing.span("seen"):
        pass
    assert set(spans()) == {"seen"}


def test_reset_forgets_everything():
    with tracing.span("a"):
        pass
    tracing.count("c")
    tracing.gauge("g", 1)
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {} and \
        snap["gauges"] == {}


def test_snapshot_is_idempotent_and_serialisable():
    from repro_torch.kernels import build, ops
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    tracing.count("c")
    first = tracing.snapshot()
    assert tracing.snapshot() == first
    assert json.loads(json.dumps(first)) == first
    assert first["launches"] == ops.launch_counts()
    assert first["build_seconds"] == build.last_build_seconds


def test_span_whose_body_raises_records_nothing():
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("boom")
    assert spans() == {}
    # nothing stays open: the next span is outermost again
    with tracing.span("next"):
        pass
    assert set(spans()) == {"next"}


def test_other_thread_nests_under_the_open_span():
    """A thread with no span of its own open (autograd's worker during
    ``loss.backward()``) nests under the span the process opened last."""
    def work():
        with tracing.span("worker"):
            with tracing.span("inner"):
                pass
    with tracing.span("train.backward"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert set(spans()) == {"train.backward", "train.backward/worker",
                            "train.backward/worker/inner"}


def test_device_timing_samples_each_root_path():
    """The device is timed on the last of every ``SAMPLE`` occurrences of
    each outermost path, and on every span nested in those."""
    seen = {"a": [], "b": []}
    for _ in range(2 * tracing.SAMPLE):
        for root in ("a", "b"):
            with tracing.span(root):
                with tracing.span("inner"):
                    seen[root].append(tracing._timed)
    one = [False] * (tracing.SAMPLE - 1) + [True]
    assert seen == {"a": one * 2, "b": one * 2}


def _spec(sizes, mode):
    from repro_torch.core.ep import EPSpec
    axes = ("pod", "model")[-len(sizes):]
    return EPSpec(axes=axes, sizes=sizes, n_experts=8, top_k=2,
                  dtype=torch.float32, mode=mode)


@pytest.mark.parametrize("sizes,mode,plans", [((2,), "ll", 1),
                                              ((2,), "ht", 1),
                                              ((2, 2), "ht", 2)])
def test_ep_phases_are_spans_never_nested(sizes, mode, plans):
    """Each EP mode records ``ep.plan``, ``ep.dispatch``, ``ep.experts``
    and ``ep.combine`` side by side (HT over two levels: a plan and a
    dispatch a level, a combine a level)."""
    from repro_torch.core import ep
    from repro_torch.core.moe import expert_fn
    spec = _spec(sizes, mode)
    R, T, D, F = spec.degree, 8, 16, 24
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, T, D, generator=g)
    idx = torch.stack([torch.randperm(8, generator=g)[:2]
                       for _ in range(R * T)]).reshape(R, T, 2).to(
        torch.int32)
    w = torch.rand(R, T, 2, generator=g)
    ws = [torch.randn(8, D, F, generator=g), torch.randn(8, D, F, generator=g),
          torch.randn(8, F, D, generator=g)]
    run = ep.dispatch_combine_ll if mode == "ll" else ep.dispatch_combine_ht
    run(spec, x, idx, w, expert_fn(*ws))
    counts = {p: b["unprofiled"]["count"] for p, b in spans().items()}
    assert counts == {"ep.plan": plans, "ep.dispatch": plans,
                      "ep.experts": 1, "ep.combine": 1}


def test_train_step_records_every_phase():
    """A reduced qwen2-moe train step over an EP world of 2 (HT): the five
    train spans, and the MoE layer's spans under the forward and under the
    backward's per-layer recompute."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.distributed.sharding import make_dist_ctx
    T = importlib.import_module("repro_torch.training.train_loop")
    cfg = reduced_config(get_config("qwen2_moe_a2_7b"), n_layers=2,
                         d_model=128, vocab=512)
    state = T.init_state(cfg, seed=0, device="cpu")
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                   seq_len=16, seed=1), 0)
    T.train_step(cfg, T.HParams(warmup=1, total_steps=3, moe_mode="ht"),
                 make_dist_ctx(cfg, model=2), state, batch)
    s = spans()
    for p in ("train.step", "train.step/train.forward",
              "train.step/train.backward", "train.step/train.optimizer",
              "train.step/train.router_bias"):
        assert s[p]["unprofiled"]["count"] == 1
    for phase in ("forward", "backward"):
        for name in ("moe.route", "ep.plan", "ep.dispatch", "ep.experts",
                     "ep.combine"):
            got = s[f"train.step/train.{phase}/{name}"]["unprofiled"]
            assert got["count"] == cfg.n_layers
    assert s["train.step/train.forward/moe.shared"]["unprofiled"][
        "count"] == cfg.n_layers


# ---- the benchmark's readers ----------------------------------------------
def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}",
        ROOT / "epbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _agg(device_ms=(), host_ms=(1.0,)):
    """A path's aggregate as the spans would leave it."""
    a = tracing._Agg()
    for ms in host_ms:
        a.count += 1
        a.host_ns += round(ms * 1e6)
        a.host_ring.append(round(ms * 1e6))
    for ms in device_ms:
        a.add_device(ms)
    return a


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_slice(name):
    with tracing.span("train.step"):
        pass
    tracing.gauge("serve.graph_nodes", 5)
    assert _reader(name).read({}) is None


def test_readers_on_a_hand_built_registry():
    A = tracing._aggs
    A[("serve.step/serve.graph_launch", "unprofiled")] = _agg(
        host_ms=(0.2, 0.9, 0.3, 0.5, 0.4))
    A[("serve.step/serve.graph_launch", "profiled")] = _agg(
        host_ms=(9.0, 11.0))
    A[("train.step", "unprofiled")] = _agg(device_ms=(300.0, 100.0))
    A[("train.step", "profiled")] = _agg(device_ms=(900.0,))
    A[("train.step/train.optimizer", "unprofiled")] = _agg(
        device_ms=(120.0, 40.0))
    A[("train.step/train.optimizer", "profiled")] = _agg(device_ms=(10.0,))
    A[("train.step/train.forward/ep.plan", "unprofiled")] = _agg(
        device_ms=(10.0, 10.0))
    A[("train.step/train.forward/ep.dispatch", "unprofiled")] = _agg(
        device_ms=(6.0,))
    A[("train.step/train.backward/ep.combine", "unprofiled")] = _agg(
        device_ms=(4.0,))
    A[("train.step/train.forward/ep.experts", "unprofiled")] = _agg(
        device_ms=(50.0,))
    A[("train.step/train.backward/ep.plan", "profiled")] = _agg(
        device_ms=(70.0,))
    A[("train.step/train.backward/ep.plan", "after_profiler")] = _agg(
        device_ms=(90.0,))
    A[("train.step", "after_profiler")] = _agg(device_ms=(700.0,))
    A[("serve.step/serve.graph_launch", "after_profiler")] = _agg(
        host_ms=(2.0, 2.0, 2.0))
    A[("ep.plan", "unprofiled")] = _agg(device_ms=(500.0,))
    tracing.gauge("serve.graph_nodes", 5021)
    rec = {"slice": {"steps": 2}}
    got = {n: _reader(n).read(rec) for n in READERS}
    assert got["graph_launch_ms.decode"] == pytest.approx(0.4)
    assert got["graph_nodes.decode"] == 5021
    assert got["optimizer_share.train"] == pytest.approx(100 * 160 / 400)
    assert got["dispatch_combine_share.train"] == pytest.approx(
        100 * 30 / 400)


def test_readers_read_nothing_where_the_spans_are_missing():
    rec = {"slice": {"steps": 2}}
    assert all(_reader(n).read(rec) is None for n in READERS)
