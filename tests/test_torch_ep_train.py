"""Expert-parallel training against the reference, on the CPU.

The four EP kernels' plain backward functions (``grouped_swiglu``,
``gather_swiglu_scatter``, ``dequantize``, ``gather_quantize``) against
``torch.autograd.grad`` through their plain forwards, and against
``jax.vjp`` of the reference's oracles: ``kernels/ref.py``'s
``grouped_swiglu_ref`` and ``gather_swiglu_scatter_ref``, and the wire as
``core/ep.py::_quantized_a2a`` chains it (``gather_quantize_ref``, the
bytes bitcast to ``uint8`` and back, ``dequantize_ref``), whose gradient
flows through the fp32 block scales alone.  Then ``loss_fn``'s loss and
every gradient of a reduced qwen2-moe whose router sends every token to
expert 0 (so HT and LL drop) for LL on the fp32 and fp8 wires, and HT on
the fp8 and int8 wires,
over EP worlds model = 2 and (pod 2, model 2), and three ``train_loop``
steps over model = 2, against the reference in ONE subprocess with 4 fake
CPU devices.  Everything in fp32."""
import dataclasses
import importlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels import quantize_pack as jqp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import ep as tep  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import quantize_pack as qp  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
# the module: the package's name train_loop is the function
T = importlib.import_module("repro_torch.training.train_loop")  # noqa: E402

E, C, D, F = 4, 12, 40, 24
# fp32 on both sides, sums in other orders: each gradient within this
# share of its largest element
RTOL = 2e-5
COUNTS = {"none": None, "flat": np.array([0, 5, 12, 7]),
          "bucketed": np.array([[0, 3, 1], [4, 4, 0], [2, 0, 0], [1, 4, 3]])}


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (what, err,
                                                         np.abs(ref).max())


def _weights(rng, E_=E, D_=D, F_=F):
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((E_, D_, F_), (E_, D_, F_), (E_, F_, D_))]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


# --------------------------------------------------- the SwiGLU kernels --
def _grouped_case(kind, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    cnt = COUNTS[kind]
    return x, _weights(rng), None if cnt is None else cnt.astype(np.int32), dy


@pytest.mark.parametrize("kind", list(COUNTS))
def test_grouped_swiglu_bwd_matches_autograd(kind):
    x, ws, cnt, dy = _grouped_case(kind)
    tx, *tws, tc, tdy = _t(x, *ws, cnt, dy)
    ins = [t.clone().requires_grad_(True) for t in (tx, *tws)]
    ref = torch.autograd.grad(gm.grouped_swiglu_plain(*ins, tc), ins, tdy)
    got = gm.grouped_swiglu_bwd_plain(tx, *tws, tc, tdy)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-5, i)


@pytest.mark.parametrize("kind", list(COUNTS))
def test_grouped_swiglu_bwd_matches_jax_vjp(kind):
    """Flat counts and LL's (E, B) sub-bucket counts; rows past them get
    zero gradients, as the reference's masked input gives."""
    x, ws, cnt, dy = _grouped_case(kind)
    jc = None if cnt is None else jnp.asarray(cnt)
    _, vjp = jax.vjp(lambda *a: jref.grouped_swiglu_ref(*a, counts=jc),
                     *map(jnp.asarray, (x, *ws)))
    ref = vjp(jnp.asarray(dy))
    got = gm.grouped_swiglu_bwd_plain(*_t(x, *ws, cnt, dy))
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, what=i)
    if cnt is not None:
        from repro_torch.core.plan import occupancy_mask
        dead = ~occupancy_mask(torch.from_numpy(cnt), E, C)
        assert (got[0][dead] == 0).all()


def _gss_case(with_counts, seed=2):
    """A (T+1, D) table (zero scratch row T), slots naming tokens at
    random with one token in 9 slots and some on the scratch row."""
    rng = np.random.default_rng(seed)
    Tn = 15
    x = rng.standard_normal((Tn + 1, D)).astype(np.float32)
    x[Tn] = 0
    src = rng.integers(0, Tn + 1, E * C).astype(np.int32)
    src[:9] = 4
    src[C:C + 3] = Tn
    w = rng.random(E * C).astype(np.float32)
    cnt = np.array([3, 12, 0, 8], np.int32) if with_counts else None
    dout = rng.standard_normal((Tn, D)).astype(np.float32)
    return x, src, w, _weights(rng), cnt, dout


@pytest.mark.parametrize("with_counts", [False, True])
def test_gather_swiglu_scatter_bwd_matches_autograd(with_counts):
    x, src, w, ws, cnt, dout = _gss_case(with_counts)
    tx, ts, tw, *tws, tc, td = _t(x, src, w, *ws, cnt, dout)
    ins = [t.clone().requires_grad_(True) for t in (tx, tw, *tws)]
    out = gm.gather_swiglu_scatter_plain(ins[0], ts, ins[1], *ins[2:], tc)
    ref = torch.autograd.grad(out, ins, td)
    got = gm.gather_swiglu_scatter_bwd_plain(tx, ts, tw, *tws, tc, td)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-5, i)


@pytest.mark.parametrize("with_counts", [False, True])
def test_gather_swiglu_scatter_bwd_matches_jax_vjp(with_counts):
    """Duplicate sources sum, slots past their count (and their weights)
    get nothing, the scratch row's upstream is zero."""
    x, src, w, ws, cnt, dout = _gss_case(with_counts)
    jc = None if cnt is None else jnp.asarray(cnt)
    js = jnp.asarray(src)
    _, vjp = jax.vjp(
        lambda xe, ww, *wts: jref.gather_swiglu_scatter_ref(
            xe, js, ww, *wts, counts=jc), *map(jnp.asarray, (x, w, *ws)))
    ref = vjp(jnp.asarray(dout))
    got = gm.gather_swiglu_scatter_bwd_plain(*_t(x, src, w, *ws, cnt, dout))
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, what=i)
    if with_counts:
        assert (got[1].reshape(E, C)[2] == 0).all()     # an empty expert
        assert all((g[2] == 0).all() for g in got[2:])


# ------------------------------------------------------------- the wire --
WIRES = ["fp8", "int8"]
DW = 300     # three scale blocks, the last ragged


def _wire_case(with_counts, seed=3):
    """A table with an all-zero block (row 1's first), a tied absmax (row
    2's first block holds +m and -m, row 3's m three times), a zero row
    and the scratch row, named by 4 buckets of 6 slots."""
    rng = np.random.default_rng(seed)
    Tn = 9
    x = rng.standard_normal((Tn + 1, DW)).astype(np.float32) * 2
    x[0] = 0
    x[1, :128] = 0
    x[2, :128] = np.clip(x[2, :128], -1, 1)
    x[2, 5], x[2, 77] = 3.0, -3.0
    x[3, :128] = np.clip(x[3, :128], -1, 1)
    x[3, [0, 64, 127]] = 2.5
    x[Tn] = 0
    src = rng.integers(0, Tn + 1, 24).astype(np.int32)
    src[:8] = [0, 1, 2, 3, Tn, 2, 3, 1]
    cnt = np.array([6, 2, 0, 5], np.int32) if with_counts else None
    dy = rng.standard_normal((24, DW)).astype(np.float32)
    return x, src, cnt, dy


def _jax_wire_chain(x, src, cnt, wire):
    """The reference's wire as ``_quantized_a2a`` chains it: the bytes
    cross bitcast to uint8, the scales as fp32."""
    jc = None if cnt is None else jnp.asarray(cnt)

    def chain(xe):
        q, sc = jqp.gather_quantize_ref(xe, jnp.asarray(src), jc,
                                        wire_dtype=wire)
        qw = lax.bitcast_convert_type(lax.bitcast_convert_type(q, jnp.uint8),
                                      q.dtype)
        return jqp.dequantize_ref(qw, sc)
    return chain


def _port_wire_chain(x, src, cnt, wire):
    """The port's plain wire as ``core/ep.py::_quantized_a2a`` chains it."""
    q, sc = qp.gather_quantize_plain(x, src, cnt, wire_dtype=wire)
    qw = q.view(torch.uint8).view(tep.WIRE_QDTYPE[wire])
    return qp.dequantize_plain(qw, sc)


@pytest.mark.parametrize("wire", WIRES)
def test_dequantize_bwd_matches_autograd_and_jax_vjp(wire):
    x, src, cnt, dy = _wire_case(False)
    q, sc = qp.gather_quantize_plain(*_t(x, src), None, wire_dtype=wire)
    tdy = torch.from_numpy(dy)
    got = qp.dequantize_bwd_plain(q, sc, tdy)
    s_in = sc.clone().requires_grad_(True)
    auto, = torch.autograd.grad(qp.dequantize_plain(q, s_in), s_in, tdy)
    _close(got, auto, 1e-6)
    jq = lax.bitcast_convert_type(jnp.asarray(q.view(torch.uint8).numpy()),
                                  jnp.float8_e4m3fn if wire == "fp8"
                                  else jnp.int8)
    _, vjp = jax.vjp(lambda s: jqp.dequantize_ref(jq, s),
                     jnp.asarray(sc.numpy()))
    _close(got, vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("with_counts", [False, True])
def test_gather_quantize_bwd_matches_autograd_and_jax_vjp(wire, with_counts):
    """The table's gradient from the scales' upstream.  An all-zero block
    gets none: in the wire its scale's gradient is always 0 (its bytes are
    0), so an all-zero block's upstream is 0 here too (the reference's max
    rule would spread a nonzero one over the block's zeros); slots past
    their count get nothing whatever their upstream."""
    x, src, cnt, _ = _wire_case(with_counts)
    tx, ts, tc = _t(x, src, cnt)
    q, sc = qp.gather_quantize_plain(tx, ts, tc, wire_dtype=wire)
    rng = np.random.default_rng(4)
    ds = rng.standard_normal(sc.shape).astype(np.float32)
    blocks = np.pad(np.abs(x[src]), ((0, 0), (0, 3 * 128 - DW)))
    ds[blocks.reshape(len(src), 3, 128).max(-1) == 0] = 0
    got = qp.gather_quantize_bwd_plain(tx, ts, tc, torch.from_numpy(ds),
                                       wire_dtype=wire)
    x_in = tx.clone().requires_grad_(True)
    _, s_auto = qp.gather_quantize_plain(x_in, ts, tc, wire_dtype=wire)
    auto, = torch.autograd.grad(s_auto, x_in, torch.from_numpy(ds))
    _close(got, auto, 1e-6)
    jc = None if cnt is None else jnp.asarray(cnt)
    _, vjp = jax.vjp(lambda xe: jqp.gather_quantize_ref(
        xe, jnp.asarray(src), jc, wire_dtype=wire)[1], jnp.asarray(x))
    _close(got, vjp(jnp.asarray(ds))[0])


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("with_counts", [False, True])
def test_wire_gradient_matches_jax_vjp_at_the_absmax_only(wire, with_counts):
    """The chain's gradient to the table (the port's two plain backwards
    composed) against ``jax.vjp`` of the reference's chain: nonzero only
    at each occupied block's absmax element(s), a tie shared equally, an
    all-zero block and the rows no occupied slot names get nothing; and
    autograd through the port's plain chain gives the same."""
    x, src, cnt, dy = _wire_case(with_counts)
    tx, ts, tc, tdy = _t(x, src, cnt, dy)
    q, sc = qp.gather_quantize_plain(tx, ts, tc, wire_dtype=wire)
    got = qp.gather_quantize_bwd_plain(
        tx, ts, tc, qp.dequantize_bwd_plain(q, sc, tdy), wire_dtype=wire)
    _, vjp = jax.vjp(_jax_wire_chain(x, src, cnt, wire), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(dy))[0])
    _close(got, ref)
    assert np.array_equal(got.numpy() != 0, ref != 0)
    x_in = tx.clone().requires_grad_(True)
    auto, = torch.autograd.grad(_port_wire_chain(x_in, ts, tc, wire), x_in,
                                tdy)
    _close(got, auto, 1e-6)
    # the structure: per (row, block) at most its ties, all of one size
    g = got.numpy()
    occ = np.ones(24, bool) if cnt is None else (
        np.arange(24) % 6 < np.repeat(cnt, 6))
    named = set(src[occ].tolist())
    for r in range(x.shape[0]):
        for b in range(3):
            blk, xb = g[r, 128 * b:128 * (b + 1)], x[r, 128 * b:128 * (b + 1)]
            nz = np.flatnonzero(blk)
            if r not in named or not np.abs(xb).max():
                assert nz.size == 0, (r, b)
                continue
            ties = np.flatnonzero(np.abs(xb) == np.abs(xb).max())
            assert set(nz) <= set(ties), (r, b)
    if 2 in named:
        assert np.count_nonzero(g[2, :128]) == 2
        assert g[2, 5] == -g[2, 77]
    if 3 in named:
        assert np.count_nonzero(g[3, :128]) == 3
        assert g[3, 0] == g[3, 64] == g[3, 127]
    assert not g[0].any() and not g[1, :128].any()


# ------------------------------------------ loss_fn over the EP worlds ----
KW = dict(n_layers=2, d_model=64, n_experts=8, vocab=512)
SKEW = 4.0            # router bias on expert 0: every token selects it
S = 64
WORLDS = [("model2", (1, 2), ("data", "model"), dict(model=2)),
          ("pod2x2", (2, 1, 2), ("pod", "data", "model"),
           dict(model=2, pod=2))]
# (mode, wire): LL on the fp32 and fp8 wires (its dispatch rows through
# the grouped SwiGLU, written into the receive layout), HT on the two
# quantized wires (the fused kernel, the wire)
MODES = [("ll", "fp32"), ("ht", "fp8"), ("ht", "int8"), ("ll", "fp8")]
# batch 2 over model = 2 (64 tokens a rank), 4 over (pod 2, model 2) (2
# sequences a pod, 64 tokens a rank): past LL's capacity floor of 32 at
# the skewed expert, so LL drops too
CASES = [(w[0], m, wire, 2 if w[0] == "model2" else 4)
         for w in WORLDS for m, wire in MODES]
# the loss to fp32 sums; every gradient leaf within GRAD_RTOL of its range.
# A quantized wire is exact on both sides for the same input, but the
# tokens reaching it went through other fp32 sums in each framework, so a
# value lying within a rounding of a code boundary takes the next code:
# 2^-4 of it (fp8) or 1/127 of its block's absmax (int8), which the
# gradients of its expert's weights and its router carry.  LOOSE_RTOL
# allows a few such elements; a gradient through the bytes (the wrong
# rule) moves every leaf below the MoE layer by its whole expert path.
LOSS_RTOL, GRAD_RTOL, LOOSE_RTOL = 1e-5, 2e-5, 2e-3
TRAIN_STEPS = 3
HP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=TRAIN_STEPS, loss_chunk=64)
DATA_KW = dict(vocab_size=512, batch=2, seq_len=S, seed=3)


def _cfg(get, reduce, mode_wire=("ht", "fp32")):
    cfg = dataclasses.replace(reduce(get("qwen2_moe_a2_7b"), **KW),
                              dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, wire_dtype=mode_wire[1]))


_SKEW_SRC = """
def skew(params):
    def f(path, leaf):
        if jax.tree_util.keystr(path).endswith("['router_b']"):
            return leaf.at[..., 0].add(%(skew)r)
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)
""" % {"skew": SKEW}
exec(_SKEW_SRC)     # defines skew() here as in the subprocess


_SCRIPT = textwrap.dedent("""
    import dataclasses, importlib, sys
    from functools import partial
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config, reduced_config
    from repro.data import pipeline as jdata
    from repro.distributed.sharding import make_dist_ctx
    from repro.models import model_zoo as Z
    from repro.optim import adamw
    JT = importlib.import_module("repro.training.train_loop")
    %(skew_src)s
    base = dataclasses.replace(reduced_config(get_config("qwen2_moe_a2_7b"),
                                              **%(kw)r), dtype="float32")
    params = jax.tree.map(np.asarray,
                          skew(Z.init_params(base, jax.random.PRNGKey(0))))
    worlds, cases = %(worlds)r, %(cases)r
    out = {}
    for name, shape, axes, _ in worlds:
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                             devices=jax.devices()[:n])
        with jax.set_mesh(mesh):
            for i, (w, mode, wire, B) in enumerate(cases):
                if w != name:
                    continue
                cfg = dataclasses.replace(base, moe=dataclasses.replace(
                    base.moe, wire_dtype=wire))
                dist = make_dist_ctx(cfg, mesh)
                rng = np.random.default_rng(i)
                toks = rng.integers(0, 512, (B, %(S)d)).astype(np.int32)
                labs = rng.integers(0, 512, (B, %(S)d)).astype(np.int32)
                (loss, m), g = jax.jit(jax.value_and_grad(
                    lambda p: Z.loss_fn(cfg, p, toks, labs, dist=dist,
                                        moe_mode=mode),
                    has_aux=True))(params)
                key = f"{w}/{mode}/{wire}/{B}"
                out[key + "/loss"] = np.asarray(loss)
                out[key + "/dropped"] = np.asarray(m["dropped"])
                for j, leaf in enumerate(jax.tree_util.tree_leaves(g)):
                    out[key + f"/grad{j}"] = np.asarray(leaf)
            if name == "model2":
                dist = make_dist_ctx(base, mesh)
                state = JT.TrainState(params, adamw.init_state(params))
                state, hist = JT.train_loop(
                    base, JT.HParams(**%(hp)r), dist,
                    partial(jdata.synth_batch, jdata.DataConfig(**%(data)r)),
                    steps=%(steps)d, state=state, log_every=0,
                    log_fn=lambda s: None)
                for j, h in enumerate(hist):
                    for k, v in h.items():
                        out[f"train/hist{j}/{k}"] = np.asarray(v)
                for j, leaf in enumerate(jax.tree_util.tree_leaves(
                        state.params)):
                    out[f"train/param{j}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("EP-TRAIN-JAX-OK")
""")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory, dist_runner):
    d = tmp_path_factory.mktemp("ep_train")
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'out.npz')!r}]\n"
              + _SCRIPT % {"skew_src": _SKEW_SRC, "kw": KW, "worlds": WORLDS,
                           "cases": CASES, "S": S, "hp": HP_KW,
                           "data": DATA_KW, "steps": TRAIN_STEPS})
    assert "EP-TRAIN-JAX-OK" in dist_runner(script, n_devices=4, timeout=1200)
    res = np.load(d / "out.npz")
    return {k: res[k] for k in res.files}


@pytest.fixture(scope="module")
def jparams():
    cfg = _cfg(jget_config, jreduced)
    return jax.tree.map(np.asarray, skew(JZ.init_params(
        cfg, jax.random.PRNGKey(0))))


def _world(name):
    return next(w[3] for w in WORLDS if w[0] == name)


def _jax_tree(jparams, flat, prefix):
    treedef = jax.tree_util.tree_structure(jparams)
    return jax.tree_util.tree_unflatten(
        treedef, [flat[f"{prefix}{j}"] for j in range(treedef.num_leaves)])


@pytest.mark.timeout(1200)
@pytest.mark.parametrize("world,mode,wire,B", CASES)
def test_ep_loss_and_grads_match_the_reference(jax_ep, jparams, world, mode,
                                               wire, B):
    """``loss_fn``'s loss, ``dropped`` and every gradient at LL / HT drops,
    the quantized wires' gradient through their scales."""
    cfg = _cfg(get_config, reduced_config, (mode, wire))
    dist = make_dist_ctx(cfg, **_world(world))
    rng = np.random.default_rng(CASES.index((world, mode, wire, B)))
    toks = torch.from_numpy(rng.integers(0, 512, (B, S))).long()
    labs = torch.from_numpy(rng.integers(0, 512, (B, S))).long()
    key = f"{world}/{mode}/{wire}/{B}"
    tp = params_from_jax(cfg, jparams, device="cpu")
    adamw.tree_map(lambda t: t.requires_grad_(True), tp)
    loss, m = Z.loss_fn(cfg, tp, toks, labs, dist=dist, moe_mode=mode)
    loss.backward()
    assert float(m["dropped"]) > 0                  # the capacity drops
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax_ep[key + "/loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["dropped"]),
                               float(jax_ep[key + "/dropped"]), rtol=1e-6)
    ref = params_from_jax(cfg, _jax_tree(jparams, jax_ep, key + "/grad"),
                          device="cpu")
    rtol = GRAD_RTOL if wire == "fp32" else LOOSE_RTOL
    adamw.tree_map(lambda t, r: _close(
        t.grad if t.grad is not None else torch.zeros_like(t), r, rtol,
        tuple(r.shape)), tp, ref)


@pytest.mark.timeout(1200)
def test_ep_train_loop_matches_the_reference(jax_ep, jparams):
    """Three ``train_loop`` steps of HT over model = 2 (the fp32 wire,
    capacity drops, router-bias updates) from the same parameters: the
    same history, and the same parameters after."""
    cfg = _cfg(get_config, reduced_config)
    dist = make_dist_ctx(cfg, model=2)
    tp = params_from_jax(cfg, jparams, device="cpu")
    adamw.tree_map(lambda t: t.requires_grad_(True), tp)
    state = T.TrainState(tp, adamw.init_state(tp))
    state, hist = T.train_loop(
        cfg, T.HParams(**HP_KW), dist,
        lambda step: tdata.synth_batch(tdata.DataConfig(**DATA_KW), step),
        steps=TRAIN_STEPS, state=state, log_every=0, log_fn=lambda s: None,
        device="cpu")
    assert len(hist) == TRAIN_STEPS
    for j, h in enumerate(hist):
        ref = {k[len(f"train/hist{j}/"):]: float(v) for k, v in jax_ep.items()
               if k.startswith(f"train/hist{j}/")}
        assert set(h) == set(ref), set(h) ^ set(ref)
        for k in ref:
            np.testing.assert_allclose(h[k], ref[k], rtol=2e-5, atol=1e-7,
                                       err_msg=f"step {j} {k}")
    after = params_from_jax(cfg, _jax_tree(jparams, jax_ep, "train/param"),
                            device="cpu")
    # Adam moves every weight by about lr a step whatever its gradient's
    # size, so a gradient that rounds to another sign moves it 2 lr apart;
    # a leaf that starts at zero (the attention biases) holds nothing but
    # such moves, so the relative limit holds the leaves whose range is
    # well past them
    reach = 2 * TRAIN_STEPS * HP_KW["peak_lr"]
    adamw.tree_map(lambda g, r: np.testing.assert_allclose(
        g.detach().numpy(), r.numpy(), rtol=0, atol=reach), state.params,
        after)
    adamw.tree_map(lambda g, r: _close(g.detach(), r, 1e-3, tuple(r.shape))
                   if float(r.abs().max()) > 10 * reach else None,
                   state.params, after)


# ------------------------------------------ the autograd Functions ------
@pytest.mark.parametrize("mode,wire", [("ht", "fp32"), ("ll", "fp32"),
                                       ("ht", "fp8"), ("ht", "int8"),
                                       ("ll", "fp8")])
def test_ep_kernel_functions_give_the_plain_gradients(monkeypatch, mode,
                                                      wire):
    """The card's path on the CPU: ``ops`` takes each EP kernel's autograd
    Function (as it does for a CUDA input under grad), the plain forward
    and plain backward standing in for the two kernels, counted.
    ``loss_fn`` over model = 2 (layers recomputed under checkpoint, the
    wire's bytes marked non-differentiable) then gives the loss and every
    gradient of autograd through the plain path, and each Function's
    backward runs once a layer."""
    from repro_torch.kernels import ops
    cfg = _cfg(get_config, reduced_config, (mode, wire))
    dist = make_dist_ctx(cfg, model=2)
    jp = jax.tree.map(np.asarray, skew(JZ.init_params(
        _cfg(jget_config, jreduced), jax.random.PRNGKey(0))))
    rng = np.random.default_rng(5)
    toks, labs = (torch.from_numpy(rng.integers(0, 512, (2, S))).long()
                  for _ in range(2))

    def grads():
        tp = params_from_jax(cfg, jp, device="cpu")
        adamw.tree_map(lambda t: t.requires_grad_(True), tp)
        loss, _ = Z.loss_fn(cfg, tp, toks, labs, dist=dist, moe_mode=mode)
        loss.backward()
        return float(loss.detach()), adamw.tree_map(
            lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
            tp)
    ref_loss, ref = grads()

    calls = {}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call
    for n in ops.TRAIN:
        for k in (n, ops.TRAIN[n][1]):
            monkeypatch.setitem(ops.KERNELS, k, (counting(
                k, ops.KERNELS[k][1]), ops.KERNELS[k][1]))

    def pick(name, *tensors):
        cuda, _ = ops.KERNELS[name]
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in tensors) and name in ops.TRAIN:
            return ops.train_function(name, cuda)
        return cuda
    monkeypatch.setattr(ops, "_pick", pick)
    got_loss, got = grads()
    fwd = "gather_swiglu_scatter" if mode == "ht" else "grouped_swiglu"
    # each layer's forward twice (the recompute), its backward once
    assert calls[fwd] == 2 * cfg.n_layers
    assert calls[fwd + "_bwd"] == cfg.n_layers
    if wire != "fp32":
        assert calls["dequantize_bwd"] == calls["gather_quantize_bwd"] > 0
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-6)
    adamw.tree_map(lambda g, r: _close(g, r, 1e-5, tuple(r.shape)), got, ref)
