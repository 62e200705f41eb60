"""The port's EP dispatch/combine over the rank-stacked world against the
reference's ``jax_collectives`` backend on the same numpy inputs (fp32).

P = 1 runs in process on a (1,) mesh; every P > 1 case — one-level P in
{2, 4} and two-level (pod, model) = (2, 2), LL and HT, fp32/fp8/int8
wires, plus skewed tables that drop — runs in ONE subprocess with fake
CPU devices, whose results the parametrized tests below compare.  Both
sides run the real expert function of their ``moe`` module (the jnp refs
on the JAX side, the plain versions here); the ``-plain`` cases hand HT a
plain ``fn(tokens, counts)`` without ``.fused`` on both sides, so that HT
gathers an expert buffer and scatters the outputs itself, and the
``-onearg`` and ``-scale`` cases hand both sides an expert_fn of an older
form, ``fn(tokens)`` or ``fn(tokens, scale=1.0)`` (``FORMS``)."""
import dataclasses
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.backend import get_backend as jget_backend  # noqa: E402
from repro.core.ep import EPSpec as JSpec  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.backend import (available_backends,  # noqa: E402
                                      get_backend)
from repro_torch.core.ep import EPSpec, moe_ref  # noqa: E402
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

from chip_smoke import all_to_all_ll_exchange  # noqa: E402

E, D, F = 8, 160, 24          # D = 160: two wire blocks, the second ragged
RTOL, ATOL = 3e-4, 3e-5       # tests/test_backends.py:80

# name -> (sizes, axes, mode, wire, capacity_factor, chunks, T/rank, K, skew)
CASES = {}
for _sizes, _axes in (((2,), ("model",)), ((4,), ("model",)),
                      ((2, 2), ("pod", "model"))):
    for _mode in ("ll", "ht"):
        for _wire in ("fp32", "fp8", "int8"):
            CASES[f"{'x'.join(map(str, _sizes))}-{_mode}-{_wire}"] = (
                _sizes, _axes, _mode, _wire, 2.0, 1, 8, 2, False)
CASES["4-ll-skew-drops"] = ((4,), ("model",), "ll", "fp32", 1.0, 1, 32, 3, True)
CASES["4-ht-skew-drops"] = ((4,), ("model",), "ht", "fp32", 1.0, 1, 32, 3, True)
CASES["2x2-ht-skew-drops"] = ((2, 2), ("pod", "model"), "ht", "int8", 1.0, 1,
                              32, 3, True)
CASES["2-ht-chunks2-fp8"] = ((2,), ("model",), "ht", "fp8", 2.0, 2, 16, 2,
                             False)
# HT through a plain expert_fn (no ``.fused``): one- and two-level
CASES["2-ht-plain-fp32"] = ((2,), ("model",), "ht", "fp32", 2.0, 1, 8, 2,
                            False)
CASES["2x2-ht-plain-fp8"] = ((2, 2), ("pod", "model"), "ht", "fp8", 2.0, 1,
                             8, 2, False)
CASES["2x2-ht-plain-skew-drops"] = ((2, 2), ("pod", "model"), "ht", "fp32",
                                    1.0, 1, 32, 3, True)
# expert_fns of the older one-argument forms, told apart by signature
# (``fn(tokens)``, and ``fn(tokens, scale=1.0)`` whose second parameter is
# not the counts): both compute over the full buckets
CASES["4-ll-onearg"] = ((4,), ("model",), "ll", "fp32", 2.0, 1, 8, 2, False)
CASES["4-ht-onearg-skew-drops"] = ((4,), ("model",), "ht", "fp32", 1.0, 1,
                                   32, 3, True)
CASES["4-ll-scale-skew-drops"] = ((4,), ("model",), "ll", "fp32", 1.0, 1, 32,
                                  3, True)
CASES["4-ht-scale"] = ((4,), ("model",), "ht", "fp32", 2.0, 1, 8, 2, False)
# name -> the form of expert_fn both sides hand the backend
FORMS = {n: next((f for f in ("plain", "onearg", "scale") if f"-{f}" in n),
                 "fused") for n in CASES}


def _inputs(seed, R, T, K, skew):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R * T, D)).astype(np.float32)
    if skew:      # one hot expert takes half of all choices
        p = np.full(E, 0.5 / (E - 1))
        p[0] = 0.5
        ti = rng.choice(E, size=(R * T, K), p=p).astype(np.int32)
    else:
        ti = rng.integers(0, E, (R * T, K)).astype(np.int32)
    ti[rng.random((R * T, K)) < 0.1] = -1                 # pads
    tw = rng.random((R * T, K)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    return x, ti, tw


def _weights(seed=100):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.2).astype(np.float32)
            for s in ((E, D, F), (E, D, F), (E, F, D))]


def _as_form(fn, form):
    """The expert_fn ``fn`` in one of the forms a caller may pass: as it is
    (``fused``), without its ``.fused`` (``plain``), as a one-argument fn
    (``onearg``), or as ``fn(tokens, scale=1.0)`` (``scale``)."""
    if form == "plain":
        return lambda tokens, counts: fn(tokens, counts)
    if form == "onearg":
        return lambda tokens: fn(tokens)

    def scaled(tokens, scale=1.0):
        return fn(tokens) * scale
    return scaled if form == "scale" else fn


def _port(sizes, axes, mode, wire, cf, chunks, K, x, ti, tw, w,
          form="fused"):
    R = int(np.prod(sizes))
    spec = EPSpec(axes=axes, sizes=sizes, n_experts=E, top_k=K,
                  capacity_factor=cf, chunks=chunks, dtype=torch.float32,
                  mode=mode, wire_dtype=wire)
    t = [torch.from_numpy(a) for a in (x, ti, tw)]
    fn = tmoe.expert_fn(*[torch.from_numpy(a) for a in w])
    res = get_backend("torch_collectives").dispatch_combine(
        spec, t[0].reshape(R, -1, D), t[1].reshape(R, -1, K),
        t[2].reshape(R, -1, K), _as_form(fn, form))
    return {"out": res.out.reshape(-1, D).numpy(),
            "dropped": res.aux["dropped"].numpy(),
            "occupancy": res.aux["occupancy"].numpy(),
            "load_phys": res.aux["load_phys"].numpy()}


def _compare(got, ref):
    np.testing.assert_allclose(got["out"], ref["out"], rtol=RTOL, atol=ATOL)
    # the same counts over the same totals; XLA divides by a constant total
    # as a reciprocal multiply, so the fractions may differ in the last bit
    for k in ("dropped", "occupancy"):
        np.testing.assert_allclose(got[k].astype(np.float32),
                                   np.asarray(ref[k], np.float32).reshape(-1),
                                   rtol=2e-7, atol=0, err_msg=k)
    np.testing.assert_array_equal(got["load_phys"], ref["load_phys"])


def test_registry():
    assert available_backends() == ["simulated_rdma", "torch_collectives"]
    with pytest.raises(KeyError):
        get_backend("no_such_transport")
    # a placement is taken: the identity one reads as none, a replicated
    # one sizes the physical slots
    ident = EPSpec(axes=("model",), sizes=(2,), n_experts=8, top_k=2,
                   placement=tuple(range(8)))
    assert ident.placement_obj() is None and ident.n_physical == 8
    rep = EPSpec(axes=("model",), sizes=(2,), n_experts=8, top_k=2,
                 placement=tuple(range(8)) * 2)
    assert rep.n_physical == 16 and rep.physical_per_shard == 8
    assert rep.placement_obj().n_logical == 8


@pytest.mark.parametrize("wire", ["fp32", "fp8", "int8"])
@pytest.mark.parametrize("mode", ["ll", "ht"])
def test_ep_p1_matches_jax_collectives(mode, wire):
    K, T = 3, 24
    x, ti, tw = _inputs(7, 1, T, K, skew=False)
    w = _weights()
    jspec = JSpec(axes=("model",), sizes=(1,), n_experts=E, top_k=K,
                  dtype=jnp.float32, mode=mode, wire_dtype=wire)
    jb = jget_backend("jax_collectives")
    mesh = jax.make_mesh((1,), ("model",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:1])

    def island(x, ti, tw, wg, wu, wd):
        r = jb.dispatch_combine(jspec, x, ti, tw, jmoe._expert_fn(wg, wu, wd))
        return (r.out, r.aux["dropped"], r.aux["occupancy"],
                r.aux["load_phys"])

    out = jax.jit(jax.shard_map(island, mesh=mesh, in_specs=(P(),) * 6,
                                out_specs=(P(),) * 4, check_vma=False))(
        x, ti, tw, *w)
    ref = dict(zip(("out", "dropped", "occupancy", "load_phys"),
                   (np.asarray(o) for o in out)))
    got = _port((1,), ("model",), mode, wire, 2.0, 1, K, x, ti, tw, w)
    _compare(got, ref)
    if wire == "fp32":   # and both agree with the dense oracle
        dense = moe_ref(*[torch.from_numpy(a) for a in (x, ti, tw, *w)])
        np.testing.assert_allclose(got["out"], dense.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_ep_p1_ht_plain_expert_fn_matches_jax_collectives(wire):
    """HT with a plain ``fn(tokens, counts)`` (no ``.fused``) gathers an
    expert buffer, calls it with flat counts and scatters the weighted
    outputs, as the reference's unfused branch (ep.py:359-366)."""
    K, T = 3, 24
    x, ti, tw = _inputs(11, 1, T, K, skew=False)
    w = _weights()
    jspec = JSpec(axes=("model",), sizes=(1,), n_experts=E, top_k=K,
                  dtype=jnp.float32, mode="ht", wire_dtype=wire)
    jb = jget_backend("jax_collectives")
    mesh = jax.make_mesh((1,), ("model",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:1])
    seen = []

    def island(x, ti, tw, wg, wu, wd):
        jfn = jmoe._expert_fn(wg, wu, wd)

        def fn(tokens, counts):
            seen.append((tokens.shape, counts.shape))
            return jfn(tokens, counts)
        r = jb.dispatch_combine(jspec, x, ti, tw, fn)
        return (r.out, r.aux["dropped"], r.aux["occupancy"],
                r.aux["load_phys"])

    out = jax.jit(jax.shard_map(island, mesh=mesh, in_specs=(P(),) * 6,
                                out_specs=(P(),) * 4, check_vma=False))(
        x, ti, tw, *w)
    ref = dict(zip(("out", "dropped", "occupancy", "load_phys"),
                   (np.asarray(o) for o in out)))
    got = _port((1,), ("model",), "ht", wire, 2.0, 1, K, x, ti, tw, w,
                form="plain")
    _compare(got, ref)
    # the reference's fn saw an (eps, Ce, D) buffer and flat counts
    assert len(seen) == 1 and len(seen[0][0]) == 3 and len(seen[0][1]) == 1
    fused = _port((1,), ("model",), "ht", wire, 2.0, 1, K, x, ti, tw, w)
    _compare(got, fused)


@pytest.mark.parametrize("sizes,axes,cf,skew", [
    ((1,), ("model",), 2.0, False), ((4,), ("model",), 2.0, False),
    ((2, 2), ("pod", "model"), 2.0, False),
    ((2, 2), ("pod", "model"), 1.0, True)])
def test_ep_ht_plain_expert_fn_matches_fused(sizes, axes, cf, skew):
    """The port's HT through a plain expert_fn against its fused path on
    the same inputs: outputs within rtol 3e-4 (the plain fn's output is a
    separate fp32 tensor, summed into the entries in another order), drops
    and occupancy equal; the plain fn gets (R * eps, Ce, D) and flat
    counts."""
    R, K, T = int(np.prod(sizes)), 3, 32
    x, ti, tw = _inputs(5, R, T, K, skew)
    w = _weights()
    calls = []
    fn = tmoe.expert_fn(*[torch.from_numpy(a) for a in w])

    def plain(tokens, counts):
        calls.append((tuple(tokens.shape), tuple(counts.shape)))
        return fn(tokens, counts)
    spec = EPSpec(axes=axes, sizes=sizes, n_experts=E, top_k=K,
                  capacity_factor=cf, dtype=torch.float32, mode="ht")
    t = [torch.from_numpy(a) for a in (x, ti, tw)]
    args = (spec, t[0].reshape(R, T, D), t[1].reshape(R, T, K),
            t[2].reshape(R, T, K))
    be = get_backend("torch_collectives")
    got, ref = be.dispatch_combine(*args, plain), be.dispatch_combine(*args,
                                                                       fn)
    np.testing.assert_allclose(got.out.numpy(), ref.out.numpy(), rtol=RTOL,
                               atol=ATOL)
    for k in ("dropped", "occupancy"):
        np.testing.assert_array_equal(got.aux[k].numpy(), ref.aux[k].numpy())
    assert (got.aux["dropped"] > 0).any() == skew
    eps = E // R
    assert len(calls) == 1 and calls[0][0][0] == R * eps
    assert calls[0][0][2] == D and calls[0][1] == (R * eps,)


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
    forms = data["forms"].item()
    w = [data["wg"], data["wu"], data["wd"]]
    jb = get_backend("jax_collectives")
    out = {}
    for name, (sizes, axes, mode, wire, cf, chunks, T, K, skew) in cases.items():
        R = int(np.prod(sizes))
        mesh = jax.make_mesh(sizes, axes, axis_types=(AxisType.Auto,) * len(axes),
                             devices=jax.devices()[:R])
        spec = EPSpec(axes=axes, sizes=sizes, n_experts=%(E)d, top_k=K,
                      capacity_factor=cf, chunks=chunks, dtype=jnp.float32,
                      mode=mode, wire_dtype=wire)
        ep_p = axes if len(axes) > 1 else axes[0]
        def island(x, ti, tw, wg, wu, wd, name=name):
            f = jmoe._expert_fn(wg, wu, wd)
            form = forms[name]
            if form == "plain":          # no .fused: HT's unfused branch
                fn = lambda tokens, counts: f(tokens, counts)
            elif form == "onearg":
                fn = lambda tokens: f(tokens)
            elif form == "scale":
                def fn(tokens, scale=1.0):
                    return f(tokens) * scale
            else:
                fn = f
            r = jb.dispatch_combine(spec, x, ti, tw, fn)
            return (r.out, r.aux["dropped"].reshape(1),
                    jnp.float32(r.aux["occupancy"]).reshape(1),
                    r.aux["load_phys"])
        res = jax.jit(jax.shard_map(island, mesh=mesh,
            in_specs=(P(axes),) * 3 + (P(ep_p, None, None),) * 3,
            out_specs=(P(axes), P(axes), P(axes), P()), check_vma=False))(
            data[name + "/x"], data[name + "/ti"], data[name + "/tw"], *w)
        for k, v in zip(("out", "dropped", "occupancy", "load_phys"), res):
            out[name + "/" + k] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("EP-JAX-OK")
""") % {"E": E}


@pytest.fixture(scope="module")
def jax_multi_rank(tmp_path_factory, dist_runner):
    """Inputs for every P > 1 case, and the JAX results from one
    ``run_distributed`` subprocess with 8 fake CPU devices."""
    d = tmp_path_factory.mktemp("ep")
    w = _weights()
    arrays = {"cases": np.array(CASES, dtype=object),
              "forms": np.array(FORMS, dtype=object), "wg": w[0], "wu": w[1],
              "wd": w[2]}
    inputs = {}
    for i, (name, c) in enumerate(CASES.items()):
        R = int(np.prod(c[0]))
        inputs[name] = _inputs(i, R, c[6], c[7], c[8])
        for k, a in zip(("x", "ti", "tw"), inputs[name]):
            arrays[f"{name}/{k}"] = a
    np.savez(d / "in.npz", **arrays)
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'in.npz')!r}, "
              f"{str(d / 'out.npz')!r}]\n" + _JAX_SCRIPT)
    assert "EP-JAX-OK" in dist_runner(script, n_devices=8, timeout=600)
    res = np.load(d / "out.npz")
    return inputs, w, {k: res[k] for k in res.files}


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", list(CASES))
def test_ep_multi_rank_matches_jax_collectives(jax_multi_rank, name):
    inputs, w, jres = jax_multi_rank
    sizes, axes, mode, wire, cf, chunks, T, K, skew = CASES[name]
    got = _port(sizes, axes, mode, wire, cf, chunks, K, *inputs[name], w,
                form=FORMS[name])
    ref = {k: jres[f"{name}/{k}"] for k in ("out", "dropped", "occupancy",
                                            "load_phys")}
    _compare(got, ref)
    if skew:
        assert (got["dropped"] > 0).any()      # the skewed cases do drop
    else:
        assert (got["dropped"] == 0).all()


# a reduced jamba whose scan period (4 layers: attention, Mamba + MoE,
# Mamba, Mamba + MoE) holds two MoE layers, two periods; one sequence of
# 256 tokens, so each of the 2 EP ranks holds 128 (the seq split of the
# reference's model axis and the port's row split agree), at capacity
# factor 1 so that HT drops
_DROP_CFG = dict(n_layers=8, d_model=64, vocab=512)


def _drop_cfg(get, reduce):
    cfg = reduce(get("jamba_1_5_large_398b"), **_DROP_CFG)
    return dataclasses.replace(cfg, attn_every=4, dtype="float32",
                               moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=1.0))


_FORWARD_SCRIPT = textwrap.dedent("""
    import dataclasses
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import make_dist_ctx
    from repro.models import model_zoo as Z
    cfg = reduced_config(get_config("jamba_1_5_large_398b"), **%(kw)r)
    cfg = dataclasses.replace(cfg, attn_every=4, dtype="float32",
                              moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=1.0))
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:2])
    params = Z.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.asarray(%(tokens)r, np.int32)
    dist = make_dist_ctx(cfg, mesh)
    with jax.set_mesh(mesh):
        _, aux = jax.jit(lambda p, t: Z.forward(cfg, p, t, dist=dist))(
            params, tokens)
    print("DROPPED", repr(float(aux["dropped"])))
""")


def test_forward_dropped_reads_as_the_reference(dist_runner):
    """``forward``'s ``dropped`` is the reference's: the MoE layers'
    fractions summed within each scan period, then the mean over periods
    (model_zoo.py:97-122).  With two MoE layers a period that is twice the
    mean over MoE layers, so the two readings differ wherever HT drops."""
    tokens = np.random.default_rng(0).integers(0, 512, (1, 256)).tolist()
    out = dist_runner(_FORWARD_SCRIPT % {"kw": _DROP_CFG, "tokens": tokens},
                      n_devices=2, timeout=600)
    ref = float(out.split("DROPPED")[-1])
    jcfg = _drop_cfg(jget_config, jreduced)
    cfg = _drop_cfg(get_config, reduced_config)
    params = params_from_jax(cfg, jax.tree.map(
        np.asarray, JZ.init_params(jcfg, jax.random.PRNGKey(0))), device="cpu")
    assert sum(cfg.is_moe_layer(i) for i in range(4)) == 2
    with torch.no_grad():
        _, aux = Z.forward(cfg, params, torch.tensor(tokens),
                           dist=make_dist_ctx(cfg, model=2))
    assert ref > 0
    np.testing.assert_allclose(float(aux["dropped"]), ref, rtol=1e-6)


# ------------------------------------- the LL exchange's receive layout ---
# name -> (sizes, axes, wire, capacity_factor, T/rank, K, skew, placement
# factor, dtype): one and two levels, the three wires, drops, replicated
# placement (E physical slots = factor x logical)
LAYOUT_CASES = {
    "2-fp32": ((2,), ("model",), "fp32", 2.0, 8, 2, False, 1, "bf16"),
    "4-fp32-f32": ((4,), ("model",), "fp32", 2.0, 8, 2, False, 1, "f32"),
    "4-fp8": ((4,), ("model",), "fp8", 2.0, 8, 2, False, 1, "bf16"),
    "4-int8": ((4,), ("model",), "int8", 2.0, 8, 2, False, 1, "f32"),
    "2x2-fp32": ((2, 2), ("pod", "model"), "fp32", 2.0, 8, 2, False, 1,
                 "bf16"),
    "2x2-fp8": ((2, 2), ("pod", "model"), "fp8", 2.0, 8, 2, False, 1,
                "bf16"),
    "4-skew-drops-fp32": ((4,), ("model",), "fp32", 1.0, 32, 3, True, 1,
                          "bf16"),
    "4-skew-drops-int8": ((4,), ("model",), "int8", 1.0, 32, 3, True, 1,
                          "bf16"),
    "4-placement-fp32": ((4,), ("model",), "fp32", 2.0, 16, 3, True, 2,
                         "bf16"),
    "2x2-placement-fp8": ((2, 2), ("pod", "model"), "fp8", 1.0, 16, 3, True,
                          2, "bf16"),
}


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_ll_receive_layout_rebuilds_the_all_to_all(name):
    """The LL plan's receive-order tables with the plain row gather (or
    ``gather_quantize`` and ``dequantize`` with counts) rebuild the
    receive buffer of the composition through the all-to-all (send
    gather, all-to-all, layout transpose:
    ``chip_smoke.all_to_all_ll_exchange``, the oracle the card is held to
    too) bit for bit, zeros at and past every count; the gathered
    ``combine_reduce_plain`` over the expert rows where they lie equals the
    (T, K, D) form on the rows that composition gathered, bit for bit; and
    the drops are the plan's."""
    from repro_torch.core import ep
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import combine_reduce as cr
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.kernels import quantize_pack as qp
    sizes, axes, wire, cf, T, K, skew, factor, dt = LAYOUT_CASES[name]
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    R = int(np.prod(sizes))
    x, ti, tw = _inputs(400 + list(LAYOUT_CASES).index(name), R, T, K, skew)
    placement = (planlib.replicate_uniform(E, factor).key() if factor > 1
                 else None)
    spec = EPSpec(axes=axes, sizes=sizes, n_experts=E, top_k=K,
                  capacity_factor=cf, dtype=dtype, mode="ll",
                  wire_dtype=wire, placement=placement)
    xt = torch.from_numpy(x).reshape(R, T, D).to(dtype)
    logical = torch.from_numpy(ti).reshape(R, T, K)
    top = logical
    if spec.placement_obj() is not None:
        top = planlib.split_to_physical_world(spec.placement_obj(), top)
    En, P = spec.n_physical, spec.degree
    C = ep._cap(T * K / En, cf, hard_max=T * K)
    pl = ep._ll_plan(spec, top, C)
    noise = torch.randn((En, P * C, D), generator=torch.Generator()
                        .manual_seed(7))

    def experts(rows, counts):
        return (rows.float() * 1.5 + noise).to(dtype)
    w = torch.from_numpy(tw).reshape(R * T, K)
    want, want_cnt, parts = all_to_all_ll_exchange(spec, xt, logical,
                                                   w.reshape(R, T, K),
                                                   experts)[1:]
    assert torch.equal(pl.cnt_recv, want_cnt)
    counts = pl.cnt_recv.reshape(-1)
    if wire == "fp32":
        got = gr.gather_rows_plain(xt.reshape(R * T, D).to(dtype),
                                   pl.src_recv, counts)
    else:
        q, sc = qp.gather_quantize_plain(ep._ext(xt, torch.float32),
                                         pl.src_recv, counts, wire_dtype=wire)
        got = qp.dequantize_plain(q, sc, counts, dtype)
    got = got.reshape(En, P * C, D)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    occ = planlib.occupancy_mask(pl.cnt_recv, En, P * C)
    assert (got[~occ] == 0).all() and (~occ).any()
    assert int(occ.sum()) == int(pl.keep.sum())
    # the combine: the expert rows where they lie against the all-to-all's
    # gathered (T, K, D) parts
    out_e = experts(got, pl.cnt_recv)
    fused = cr.combine_reduce_plain(out_e.reshape(-1, D), w, pl.sel_recv,
                                    out_dtype=dtype)
    assert torch.equal(_bits(fused), _bits(cr.combine_reduce_plain(parts, w)))
    # the skewed tables drop; replicas of the hot expert take its load
    dropped = (pl.valid & ~pl.keep).any()
    assert bool(dropped) == (skew and factor == 1)
    assert bool(((pl.sel_recv < 0).reshape(R, T * K) == ~pl.keep).all())
