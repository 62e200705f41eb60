"""Replicated expert placement in the port against the reference.

The placement tables (``Placement``, ``placement_from_table``,
``identity_placement``, ``replicate_uniform``, ``greedy_placement``) equal
``repro.core.plan``'s exactly; the port's splits of a routing tensor equal
the reference's numpy splits, and the world split equals the per-source
splits stacked.  LL and HT dispatch under ``replicate_uniform`` factors 1,
2 and 4 and under a greedy placement match the reference's
``jax_collectives`` dispatch with the same placement (P = 1 in process, P
= 4 in one fake-device subprocess through ``dist_runner``) and the logical
dense oracle ``moe_ref``; the expert function's row blocks are physical
slots, whose weights both sides gather through ``phys_to_logical``.  An
identity placement gives the bits of no placement."""
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, PartitionSpec as P  # noqa: E402

from repro.core import moe as jmoe  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.backend import get_backend as jget_backend  # noqa: E402
from repro.core.ep import EPSpec as JSpec  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.core.ep import EPSpec, moe_ref  # noqa: E402

E, D, F, K = 8, 160, 24, 3
RTOL, ATOL = 3e-4, 3e-5       # tests/test_backends.py:80
CF = 8.0                      # no drops (tests/test_backends.py:169)
LOADS = np.array([100.0, 40, 10, 5, 2, 1, 1, 1])


def _placements(n_ranks: int) -> dict:
    """name -> (the reference's Placement, the port's): uniform factors 1,
    2 and 4, and greedy over 12 slots from skewed loads."""
    return {f"rep{f}": (jplan.replicate_uniform(E, f),
                        planlib.replicate_uniform(E, f)) for f in (1, 2, 4)
            } | {"greedy": (jplan.greedy_placement(LOADS, 12, n_ranks),
                            planlib.greedy_placement(LOADS, 12, n_ranks))}


def _same_placement(got, ref):
    for k in ("phys_to_logical", "logical_to_phys", "n_replicas"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.is_identity == ref.is_identity
    assert got.key() == ref.key()
    assert (got.n_physical, got.n_logical) == (ref.n_physical, ref.n_logical)


@pytest.mark.parametrize("make", [
    "identity", "uniform1", "uniform2", "uniform4", "table",
    "greedy8x4", "greedy12x4", "greedy16x4", "greedy12x3", "greedy10x2",
    "greedy80x4", "greedy_zero_loads"])
def test_placement_tables_match_reference(make):
    loads = LOADS
    if make == "identity":
        got, ref = planlib.identity_placement(E), jplan.identity_placement(E)
    elif make.startswith("uniform"):
        f = int(make[-1])
        got, ref = planlib.replicate_uniform(E, f), jplan.replicate_uniform(
            E, f)
    elif make == "table":
        p2l = np.array([0, 2, 1, 0, 2, 1, 3], np.int32)
        got, ref = (planlib.placement_from_table(p2l),
                    jplan.placement_from_table(p2l))
    else:
        if make == "greedy_zero_loads":
            loads, n_phys, n_ranks = np.zeros(E), 12, 4
        else:
            n_phys, n_ranks = map(int, make[6:].split("x"))
            if n_phys == 80:      # moonshot's 64 experts over 80 slots
                loads = np.random.default_rng(3).lognormal(0, 0.6, 64)
        got = planlib.greedy_placement(torch.from_numpy(loads), n_phys,
                                       n_ranks)
        ref = jplan.greedy_placement(loads, n_phys, n_ranks)
    _same_placement(got, ref)


def _table(rng, shape, n=E):
    ti = rng.integers(0, n, shape).astype(np.int32)
    ti[rng.random(shape) < 0.1] = -1                    # pads pass through
    return ti


@pytest.mark.parametrize("name", ["rep1", "rep2", "rep4", "greedy"])
def test_split_to_physical_matches_reference(name):
    jpl, tpl = _placements(4)[name]
    ti = _table(np.random.default_rng(5), (64, K))
    got = planlib.split_to_physical(tpl, torch.from_numpy(ti))
    np.testing.assert_array_equal(got.numpy(),
                                  jplan.split_to_physical(jpl, ti))
    assert got.dtype == torch.int32
    if tpl.is_identity:        # the identity split is no split at all
        t = torch.from_numpy(ti)
        assert planlib.split_to_physical(tpl, t) is t


@pytest.mark.parametrize("name", ["rep1", "rep2", "rep4", "greedy"])
def test_split_to_physical_world_equals_stacked(name):
    jpl, tpl = _placements(4)[name]
    ti = _table(np.random.default_rng(9), (4, 16, K))
    got = planlib.split_to_physical_world(tpl, torch.from_numpy(ti)).numpy()
    for r in range(4):
        np.testing.assert_array_equal(got[r],
                                      jplan.split_to_physical(jpl, ti[r]))
    np.testing.assert_array_equal(got, jplan.split_to_physical_world(jpl, ti))


def _inputs(seed, R, T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R * T, D)).astype(np.float32)
    ti = _table(rng, (R * T, K))
    tw = rng.random((R * T, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    return x, ti, tw


def _weights(seed=100):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.2).astype(np.float32)
            for s in ((E, D, F), (E, D, F), (E, F, D))]


def _port(R, mode, placement, x, ti, tw, w):
    """The port's dispatch with ``placement`` (a Placement or None), the
    expert weights gathered to its physical slots."""
    p2l = (np.arange(E) if placement is None
           else placement.phys_to_logical)
    spec = EPSpec(axes=("model",), sizes=(R,), n_experts=E, top_k=K,
                  capacity_factor=CF, dtype=torch.float32, mode=mode,
                  placement=None if placement is None else placement.key())
    fn = tmoe._expert_fn(*[torch.from_numpy(a[p2l]) for a in w])
    res = get_backend("torch_collectives").dispatch_combine(
        spec, *[torch.from_numpy(a).reshape(R, -1, *a.shape[1:])
                for a in (x, ti, tw)], fn)
    return res


def _check(res, ref, placement, x, ti, tw, w):
    """Against the reference's results ``ref`` and the logical oracle."""
    out = res.out.reshape(-1, D).numpy()
    np.testing.assert_allclose(out, ref["out"], rtol=RTOL, atol=ATOL)
    n_phys = E if placement is None else placement.n_physical
    assert tuple(res.aux["load_phys"].shape) == (n_phys,)
    np.testing.assert_array_equal(res.aux["load_phys"].numpy(),
                                  ref["load_phys"])
    np.testing.assert_allclose(float(res.aux["imbalance"]),
                               float(ref["imbalance"]), rtol=1e-6)
    assert (res.aux["dropped"] == 0).all()
    dense = moe_ref(*[torch.from_numpy(a) for a in (x, ti, tw, *w)])
    np.testing.assert_allclose(out, dense.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rep1", "rep2", "rep4", "greedy"])
@pytest.mark.parametrize("mode", ["ll", "ht"])
def test_dispatch_p1_placement_matches_jax_collectives(mode, name):
    jpl, tpl = _placements(1)[name]
    x, ti, tw = _inputs(7, 1, 24)
    w = _weights()
    p2l = jpl.phys_to_logical
    jspec = JSpec(axes=("model",), sizes=(1,), n_experts=E, top_k=K,
                  capacity_factor=CF, dtype=jnp.float32, mode=mode,
                  placement=jpl.key())
    jb = jget_backend("jax_collectives")
    mesh = jax.make_mesh((1,), ("model",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:1])

    def island(x, ti, tw, wg, wu, wd):
        r = jb.dispatch_combine(jspec, x, ti, tw, jmoe._expert_fn(wg, wu, wd))
        return r.out, r.aux["load_phys"], r.aux["imbalance"]

    out = jax.jit(jax.shard_map(island, mesh=mesh, in_specs=(P(),) * 6,
                                out_specs=(P(),) * 3, check_vma=False))(
        x, ti, tw, *[a[p2l] for a in w])
    ref = dict(zip(("out", "load_phys", "imbalance"),
                   (np.asarray(o) for o in out)))
    _check(_port(1, mode, tpl, x, ti, tw, w), ref, tpl, x, ti, tw, w)


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("mode", ["ll", "ht"])
def test_identity_placement_bit_identical_to_none(mode, R):
    x, ti, tw = _inputs(13, R, 16)
    w = _weights()
    got = _port(R, mode, planlib.identity_placement(E), x, ti, tw, w)
    ref = _port(R, mode, None, x, ti, tw, w)
    assert torch.equal(got.out, ref.out)
    for k in ("dropped", "occupancy", "load_phys", "imbalance"):
        assert torch.equal(got.aux[k], ref.aux[k]), k


_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.core import moe as jmoe
    from repro.core.backend import get_backend
    from repro.core.ep import EPSpec
    data = np.load(sys.argv[1], allow_pickle=True)
    cases = data["cases"].item()
    w = [data["wg"], data["wu"], data["wd"]]
    jb = get_backend("jax_collectives")
    mesh = jax.make_mesh((4,), ("model",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:4])
    out = {}
    for name, (mode, p2l) in cases.items():
        spec = EPSpec(axes=("model",), sizes=(4,), n_experts=%(E)d,
                      top_k=%(K)d, capacity_factor=%(CF)r, dtype=jnp.float32,
                      mode=mode, placement=tuple(int(v) for v in p2l))
        def island(x, ti, tw, wg, wu, wd, spec=spec):
            r = jb.dispatch_combine(spec, x, ti, tw,
                                    jmoe._expert_fn(wg, wu, wd))
            return r.out, r.aux["load_phys"], r.aux["imbalance"].reshape(1)
        res = jax.jit(jax.shard_map(island, mesh=mesh,
            in_specs=(P("model"),) * 3 + (P("model", None, None),) * 3,
            out_specs=(P("model"), P(), P()), check_vma=False))(
            data["x"], data["ti"], data["tw"], *[a[p2l] for a in w])
        for k, v in zip(("out", "load_phys", "imbalance"), res):
            out[name + "/" + k] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("PLACEMENT-JAX-OK")
""") % {"E": E, "K": K, "CF": CF}

P4_CASES = {f"{mode}-{name}": (mode, name) for mode in ("ll", "ht")
            for name in ("rep1", "rep2", "rep4", "greedy")}


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory, dist_runner):
    """The reference's dispatch of every P = 4 case, from one subprocess
    with 8 fake CPU devices (the same inputs for all cases)."""
    d = tmp_path_factory.mktemp("placement")
    x, ti, tw = _inputs(21, 4, 16)
    w = _weights()
    pls = _placements(4)
    cases = {c: (mode, pls[name][0].phys_to_logical)
             for c, (mode, name) in P4_CASES.items()}
    np.savez(d / "in.npz", cases=np.array(cases, dtype=object), x=x, ti=ti,
             tw=tw, wg=w[0], wu=w[1], wd=w[2])
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'in.npz')!r}, "
              f"{str(d / 'out.npz')!r}]\n" + _JAX_SCRIPT)
    assert "PLACEMENT-JAX-OK" in dist_runner(script, n_devices=8,
                                              timeout=600)
    res = np.load(d / "out.npz")
    return (x, ti, tw), w, {k: res[k] for k in res.files}


@pytest.mark.timeout(900)
@pytest.mark.parametrize("case", list(P4_CASES))
def test_dispatch_p4_placement_matches_jax_collectives(jax_p4, case):
    (x, ti, tw), w, jres = jax_p4
    mode, name = P4_CASES[case]
    tpl = _placements(4)[name][1]
    ref = {k: jres[f"{case}/{k}"] for k in ("out", "load_phys", "imbalance")}
    ref["imbalance"] = ref["imbalance"][0]
    _check(_port(4, mode, tpl, x, ti, tw, w), ref, tpl, x, ti, tw, w)
