"""The port's plan layer and wire codec against the reference's numpy
dialect: plans bit-identical, codec bytes identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as np_plan  # noqa: E402
from repro.core.transport import codec as np_codec  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.transport import codec as tcodec  # noqa: E402


def _table(seed, T, K, G, pad=0.2, dup=True):
    """Random (T, K) routing table with -1 pads, skew (overflow) and,
    optionally, duplicate groups within a row."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(G, 0.3))            # skewed: some groups hot
    t = rng.choice(G, size=(T, K), p=p).astype(np.int32)
    if not dup:
        t = np.stack([rng.choice(G, K, replace=False, p=p)
                      for _ in range(T)]).astype(np.int32)
    t[rng.random((T, K)) < pad] = -1
    return t


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,T,K,G,cap", [(0, 37, 4, 8, 6), (1, 64, 2, 16, 4),
                                            (2, 5, 3, 3, 2), (3, 128, 4, 64, 3)])
def test_make_plan_bit_identical(seed, T, K, G, cap):
    tab = _table(seed, T, K, G)
    ref = np_plan.make_plan(tab, G, cap)
    got = tplan.make_plan(_t(tab), G, cap)
    for name in ("rank", "counts", "valid", "keep"):
        r, g = getattr(ref, name), getattr(got, name).numpy()
        if name == "rank":        # rank is only meaningful for valid rows
            r, g = np.where(ref.valid, r, 0), np.where(ref.valid, g, 0)
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert int(got.n_dropped) == int(ref.n_dropped)
    assert int(ref.n_dropped) > 0 or seed == 2   # overflow is exercised


@pytest.mark.parametrize("seed", [0, 1])
def test_make_world_plan_equals_stacked_plans(seed):
    R, T, K, G, cap = 3, 20, 3, 8, 4
    tabs = np.stack([_table(seed * 10 + r, T, K, G) for r in range(R)])
    got = tplan.make_world_plan(_t(tabs), G, cap)
    ref = np_plan.make_world_plan(tabs, G, cap)
    np.testing.assert_array_equal(got.counts.numpy(), ref.counts)
    np.testing.assert_array_equal(got.keep.numpy(), ref.keep)
    # a rank's own drop count, as the rank-stacked EP layers take it
    per_rank = (got.valid & ~got.keep).reshape(R, -1).sum(1)
    for r in range(R):
        one = np_plan.make_plan(tabs[r], G, cap)
        np.testing.assert_array_equal(np.where(one.valid, got.rank[r].numpy(), 0),
                                      np.where(one.valid, one.rank, 0))
        assert int(per_rank[r]) == int(one.n_dropped)


@pytest.mark.parametrize("seed,cap", [(0, 4), (1, 4), (0, 60)])
def test_make_world_plan_equals_the_reference(seed, cap):
    """Every field of the reference's ``WorldPlan``, the world's scalar
    ``n_dropped`` included; capacity 60 holds every choice (no drops)."""
    R, T, K, G = 3, 20, 3, 8
    tabs = np.stack([_table(seed * 10 + r, T, K, G) for r in range(R)])
    got = tplan.make_world_plan(_t(tabs), G, cap)
    ref = np_plan.make_world_plan(tabs, G, cap)
    assert isinstance(got, tplan.WorldPlan)
    assert got._fields == ref._fields
    for name in ("rank", "counts", "valid", "keep"):
        r, g = getattr(ref, name), getattr(got, name).numpy()
        assert g.shape == r.shape, name
        if name == "rank":        # rank is only meaningful for valid rows
            r, g = np.where(ref.valid, r, 0), np.where(ref.valid, g, 0)
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert got.n_dropped.dim() == 0 and np.ndim(ref.n_dropped) == 0
    assert int(got.n_dropped) == int(ref.n_dropped)
    assert (int(ref.n_dropped) == 0) == (cap == 60)


@pytest.mark.parametrize("seed,T,K,G,cap", [(0, 40, 4, 4, 9), (1, 33, 3, 2, 30),
                                            (2, 64, 4, 8, 5)])
def test_dedup_entry_table_bit_identical(seed, T, K, G, cap):
    tab = _table(seed, T, K, G)
    ref = np_plan.dedup_entry_table(tab, tab >= 0, G, cap)
    got = tplan.dedup_entry_table(_t(tab), _t(tab >= 0), G, cap)
    for r, g, name in zip(ref[:4], got[:4],
                          ("first", "entry_valid", "rank_tg", "keep_tg")):
        if name == "rank_tg":
            r, g = np.where(ref[1], r, 0), np.where(ref[1], g.numpy(), 0)
        else:
            g = g.numpy()
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert int(got[4]) == int(ref[4])
    # rank-stacked form: every rank planned independently
    tabs = np.stack([tab, _table(seed + 7, T, K, G)])
    st = tplan.dedup_entry_table(_t(tabs), _t(tabs >= 0), G, cap)
    for r in range(2):
        one = np_plan.dedup_entry_table(tabs[r], tabs[r] >= 0, G, cap)
        np.testing.assert_array_equal(st[3][r].numpy(), one[3])
        assert int(st[4][r]) == int(one[4])


@pytest.mark.parametrize("counts_shape", [(6,), (6, 2)])
def test_occupancy_mask_and_small_helpers(counts_shape):
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 9, counts_shape).astype(np.int32)
    np.testing.assert_array_equal(
        tplan.occupancy_mask(_t(counts), 6, 8).numpy(),
        np_plan.occupancy_mask(counts, 6, 8))
    for T, c in [(12, 5), (7, 3), (0, 4), (16, 4)]:
        assert tplan.effective_chunks(T, c) == np_plan.effective_chunks(T, c)
    for d, w in [(200, "fp8"), (256, "int8"), (64, "fp32")]:
        assert tplan.wire_layout(d, w) == tuple(np_plan.wire_layout(d, w))
    tab = _table(5, 30, 4, 16)
    np.testing.assert_array_equal(tplan.expert_load(_t(tab), 16).numpy(),
                                  np_plan.expert_load(tab, 16))
    load = np_plan.expert_load(tab, 16)
    assert float(tplan.load_imbalance(_t(load))) == pytest.approx(
        np_plan.load_imbalance(load), rel=1e-6)


def test_call_expert_fn_contract():
    calls = []

    def counts_aware(tokens, counts):
        calls.append((tokens, counts))
        return tokens

    assert tplan.call_expert_fn(counts_aware, 1, 2) == 1
    tplan.call_expert_fn(lambda *a: calls.append(a), 3, 4)
    assert calls == [(1, 2), (3, 4)]


@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("D", [200, 256])
def test_codec_bytes_equal_numpy(wire, D):
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((33, D)) * rng.uniform(0.01, 50, (33, 1))
         ).astype(np.float32)
    x[3] = 0.0                                      # all-zero row: zero scales
    x[5, :128] = 0.0
    q_ref, s_ref = np_codec.quantize_blocked(x, wire)
    q, s = tcodec.quantize_blocked(_t(x), wire)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(q_ref).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(
        tcodec.dequantize_blocked(q, s).numpy(),
        np_codec.dequantize_blocked(q_ref, s_ref))
