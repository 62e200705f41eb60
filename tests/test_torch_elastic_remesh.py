"""The mesh-restart half of elastic EP (``repro_torch.distributed.elastic``:
``ElasticPlan``, ``plan_remesh``, ``reshard_state``; ``DistCtx.ep_degree``
and ``sharding.ep_split_leaves``) against the reference's, on the CPU.

``plan_remesh`` against the reference for reduced qwen2-moe, moonshot,
jamba and falcon-mamba over several old and new worlds (the reference's
meshes stood in by objects holding their axis names and shapes, which is
all its functions read), both raising on the same cases; ``reshard_state``
keeping every leaf bit for bit and the optimizer step; then, in ONE
subprocess with 4 fake CPU devices, the reference's 3 ``train_loop``
steps on mesh (data 1, model 4), the re-mesh to (1, 2), and 3 more steps,
against the port's at EP 4 then EP 2 from the same parameters, and both
sides' losses at the two degrees on one state; and a checkpoint round trip
across the re-mesh, bit for bit.  Everything in fp32."""
import dataclasses
import importlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.distributed import elastic as r_el  # noqa: E402
from repro.distributed import sharding as r_sh  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed import elastic as t_el  # noqa: E402
from repro_torch.distributed.sharding import (ep_split_leaves,  # noqa: E402
                                              make_dist_ctx)
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
# the module: the package's name train_loop is the function
T = importlib.import_module("repro_torch.training.train_loop")  # noqa: E402

pytestmark = pytest.mark.timeout(300)

ARCHS = ("qwen2_moe_a2_7b", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b",
         "falcon_mamba_7b")


class _Mesh:
    """What the reference's ``make_dist_ctx``, ``plan_remesh`` and
    ``DistCtx.ep_degree`` read of a mesh: its axis names, its shape by
    name and its device array's shape."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.devices = np.empty(shape)


def _worlds(pod, model):
    """(the port's world, the reference's mesh): ("model",) or ("pod",
    "model"), the reference's with a data axis of 1."""
    if pod > 1:
        return dict(model=model, pod=pod), _Mesh((pod, 1, model),
                                                 ("pod", "data", "model"))
    return dict(model=model), _Mesh((1, model), ("data", "model"))


def _cfgs(arch, **kw):
    return (reduced_config(get_config(arch), **kw),
            jreduced(jget_config(arch), **kw))


def _plan(side, cfg, old, new):
    if side == "ref":
        return r_el.plan_remesh(cfg, r_sh.make_dist_ctx(cfg, old), new)
    return t_el.plan_remesh(cfg, make_dist_ctx(cfg, **old),
                            make_dist_ctx(cfg, **new))


# (old (pod, model), new (pod, model)): shrinks, grows, two-level
REMESH = [((1, 4), (1, 2)), ((1, 8), (1, 4)), ((1, 2), (1, 1)),
          ((1, 1), (1, 4)), ((2, 2), (1, 2)), ((1, 4), (2, 2)),
          ((2, 4), (2, 2))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("old,new", REMESH)
def test_plan_remesh_matches_the_reference(arch, old, new):
    """The plan's shapes, axes, EP degrees and notes equal the
    reference's; the port's shapes are its world's sizes, the reference's
    its mesh's, so they are compared with the data axis of 1 dropped."""
    tcfg, jcfg = _cfgs(arch)
    (t_old, r_old), (t_new, r_new) = _worlds(*old), _worlds(*new)
    tp = _plan("port", tcfg, t_old, t_new)
    rp = _plan("ref", jcfg, r_old, r_new)
    assert (tp.ep_degree_old, tp.ep_degree_new, tp.notes) == (
        rp.ep_degree_old, rp.ep_degree_new, rp.notes)

    def no_data(names, shape):
        return tuple(n for a, n in zip(names, shape) if a != "data")
    assert tp.new_axis_names == no_data(rp.new_axis_names,
                                        rp.new_axis_names)
    assert tp.new_shape == no_data(rp.new_axis_names, rp.new_shape)
    assert tp.old_shape == no_data(r_old.axis_names, rp.old_shape)
    assert isinstance(tp, t_el.ElasticPlan)
    assert tp.ep_degree_new == make_dist_ctx(tcfg, **t_new).ep_degree


@pytest.mark.parametrize("arch,kw,new,match", [
    # 60 experts padded to 64 onto a world of 3
    ("qwen2_moe_a2_7b", None, (1, 3), "padded experts 64 not divisible"),
    # 8 experts padded to 16 onto (pod 2, model 3)
    ("moonshot_v1_16b_a3b", {}, (2, 3), "padded experts 16 not divisible"),
    # no MoE: d_model 64 against a model axis of 3
    ("falcon_mamba_7b", {}, (1, 3), "d_model must divide the model axis"),
    # experts divide (16 over 8); d_model 36 does not
    ("qwen2_moe_a2_7b", {"d_model": 36}, (1, 8),
     "d_model must divide the model axis"),
])
def test_plan_remesh_raises_as_the_reference(arch, kw, new, match):
    if kw is None:
        tcfg, jcfg = get_config(arch), jget_config(arch)
    else:
        tcfg, jcfg = _cfgs(arch, **kw)
    (t_old, r_old), (t_new, r_new) = _worlds(1, 4), _worlds(*new)
    with pytest.raises(ValueError, match=match) as te:
        _plan("port", tcfg, t_old, t_new)
    with pytest.raises(ValueError, match=match) as re_:
        _plan("ref", jcfg, r_old, r_new)
    assert str(te.value) == str(re_.value)


def test_ep_degree_matches_the_reference():
    for arch in ARCHS:
        tcfg, jcfg = _cfgs(arch)
        for world in [(1, 1), (1, 2), (1, 4), (1, 8), (2, 2), (2, 4)]:
            t, r = _worlds(*world)
            assert make_dist_ctx(tcfg, **t).ep_degree == \
                r_sh.make_dist_ctx(jcfg, r).ep_degree, (arch, world)


def _state(arch, seed=0, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch), **kw),
                              dtype="float32")
    return cfg, T.init_state(cfg, seed=seed, device="cpu")


def test_ep_split_leaves_names_the_routed_experts():
    """The routed experts' three weights, in the parameters and both
    moments, at 16 / P experts a rank; a factored second moment (jamba's
    adafactor) and the shared expert are not split; a degree that does
    not divide them raises."""
    cfg, state = _state("qwen2_moe_a2_7b")
    leaves = ep_split_leaves(make_dist_ctx(cfg, model=4), state)
    expected = {f"{top}/blocks/{i}/moe/{w}"
                for top in ("params", "opt/mu", "opt/nu")
                for i in range(cfg.n_layers)
                for w in ("w_gate", "w_up", "w_down")}
    assert set(leaves) == expected
    D, F = cfg.d_model, cfg.moe.d_expert
    assert leaves["params/blocks/0/moe/w_gate"] == (4, D, F)
    assert leaves["opt/nu/blocks/1/moe/w_down"] == (4, F, D)
    assert ep_split_leaves(None, state)["params/blocks/0/moe/w_up"] == (
        16, D, F)
    with pytest.raises(ValueError, match="not divisible by the EP degree 3"):
        ep_split_leaves(make_dist_ctx(cfg, model=3), state)
    jcfg, jstate = _state("jamba_1_5_large_398b")
    assert jcfg.optimizer == "adafactor"
    jl = ep_split_leaves(make_dist_ctx(jcfg, model=2), jstate)
    assert jl and all(k.startswith(("params/", "opt/mu/")) for k in jl)
    _, fstate = _state("falcon_mamba_7b")
    assert ep_split_leaves(make_dist_ctx(jcfg, model=2), fstate) == {}


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "jamba_1_5_large_398b"])
def test_reshard_state_keeps_every_leaf(arch):
    """Without a device every leaf stays the same tensor; on the device it
    is already on, too; moved (to the meta device), every leaf keeps its
    shape, dtype and ``requires_grad``, and ``opt.step`` stays on the CPU
    as it was.  A degree that does not divide the experts raises."""
    cfg, state = _state(arch)
    step = state.opt.step
    leaves = adamw.tree_leaves(state.params) + adamw.tree_leaves(
        state.opt.mu) + adamw.tree_leaves(state.opt.nu)
    copies = [t.detach().clone() for t in leaves]
    new = make_dist_ctx(cfg, model=2)
    for device in (None, "cpu"):
        st2, d2 = t_el.reshard_state(cfg, state, new, device=device)
        assert d2 is new and st2.opt.step is step
        got = adamw.tree_leaves(st2.params) + adamw.tree_leaves(
            st2.opt.mu) + adamw.tree_leaves(st2.opt.nu)
        assert all(a is b for a, b in zip(got, leaves))
        assert all(torch.equal(a, c) for a, c in zip(got, copies))
    st3, _ = t_el.reshard_state(cfg, state, new, device="meta")
    got = adamw.tree_leaves(st3.params) + adamw.tree_leaves(
        st3.opt.mu) + adamw.tree_leaves(st3.opt.nu)
    assert all(g.device.type == "meta" and g.shape == t.shape
               and g.dtype == t.dtype and g.requires_grad == t.requires_grad
               for g, t in zip(got, leaves))
    assert st3.opt.step is step and step.device.type == "cpu"
    with pytest.raises(ValueError, match="EP degree 3"):
        t_el.reshard_state(cfg, state, make_dist_ctx(cfg, model=3))


# ================================= train, re-mesh, train: vs reference ==
KW = dict(n_layers=2, d_model=64, n_experts=8, vocab=512)
STEPS = 3
HP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=2 * STEPS, loss_chunk=64)
DATA_KW = dict(vocab_size=512, batch=2, seq_len=64, seed=5)


def _cfg(get, reduce):
    return dataclasses.replace(reduce(get("qwen2_moe_a2_7b"), **KW),
                               dtype="float32")


_SCRIPT = textwrap.dedent("""
    import dataclasses, importlib, sys
    from functools import partial
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config, reduced_config
    from repro.data import pipeline as jdata
    from repro.distributed.elastic import plan_remesh, reshard_state
    from repro.distributed.sharding import make_dist_ctx
    from repro.models import model_zoo as Z
    from repro.optim import adamw
    JT = importlib.import_module("repro.training.train_loop")
    cfg = dataclasses.replace(reduced_config(get_config("qwen2_moe_a2_7b"),
                                             **%(kw)r), dtype="float32")
    params = jax.tree.map(np.asarray, Z.init_params(cfg, jax.random.PRNGKey(0)))
    dc = jdata.DataConfig(**%(data)r)
    hp = JT.HParams(**%(hp)r)

    def mesh(m):
        return jax.make_mesh((1, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:m])

    out = {}
    mesh4, mesh2 = mesh(4), mesh(2)
    with jax.set_mesh(mesh4):
        dist4 = make_dist_ctx(cfg, mesh4)
        state = JT.TrainState(params, adamw.init_state(params))
        state, hist1 = JT.train_loop(cfg, hp, dist4, partial(jdata.synth_batch,
                                                             dc),
                                     steps=%(steps)d, state=state,
                                     log_every=0, log_fn=lambda s: None)
    plan = plan_remesh(cfg, dist4, mesh2)
    out["plan/ep"] = np.array([plan.ep_degree_old, plan.ep_degree_new])
    state, dist2 = reshard_state(cfg, state, mesh2)
    mid = jax.tree.map(np.asarray, state.params)
    # the two degrees on one state, every capacity lifted
    lifted = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16 / cfg.moe.top_k))
    b = jdata.synth_batch(dc, 0)
    for m, msh in ((4, mesh4), (2, mesh2)):
        with jax.set_mesh(msh):
            d = make_dist_ctx(lifted, msh)
            loss, met = jax.jit(lambda p: Z.loss_fn(
                lifted, p, b["tokens"], b["labels"], dist=d,
                moe_mode="ht", loss_chunk=64))(mid)
            for k in ("xent", "aux_loss", "dropped"):
                out[f"lifted/{m}/{k}"] = np.asarray(met[k])
            out[f"lifted/{m}/loss"] = np.asarray(loss)
    with jax.set_mesh(mesh2):
        state, hist2 = JT.train_loop(
            cfg, hp, dist2, lambda s: jdata.synth_batch(dc, s + %(steps)d),
            steps=%(steps)d, state=state, log_every=0, log_fn=lambda s: None)
    for name, hist in (("ep4", hist1), ("ep2", hist2)):
        for j, h in enumerate(hist):
            for k, v in h.items():
                out[f"{name}/hist{j}/{k}"] = np.asarray(v)
    for j, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
        out[f"param{j}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("REMESH-JAX-OK")
""")


@pytest.fixture(scope="module")
def jax_remesh(tmp_path_factory, dist_runner):
    d = tmp_path_factory.mktemp("remesh")
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'out.npz')!r}]\n"
              + _SCRIPT % {"kw": KW, "data": DATA_KW, "hp": HP_KW,
                           "steps": STEPS})
    assert "REMESH-JAX-OK" in dist_runner(script, n_devices=4, timeout=900)
    res = np.load(d / "out.npz")
    return {k: res[k] for k in res.files}


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, JZ.init_params(
        _cfg(jget_config, jreduced), jax.random.PRNGKey(0)))


def _batches(start=0):
    dc = tdata.DataConfig(**DATA_KW)
    return lambda step: tdata.synth_batch(dc, start + step)


def _port_state(cfg, jparams):
    tp = params_from_jax(cfg, jparams, device="cpu")
    adamw.tree_map(lambda t: t.requires_grad_(True), tp)
    return T.TrainState(tp, adamw.init_state(tp))


def _close_hist(hist, ref, prefix):
    assert len(hist) == STEPS
    for j, h in enumerate(hist):
        want = {k[len(f"{prefix}/hist{j}/"):]: float(v)
                for k, v in ref.items() if k.startswith(f"{prefix}/hist{j}/")}
        assert set(h) == set(want), set(h) ^ set(want)
        for k in want:
            np.testing.assert_allclose(h[k], want[k], rtol=2e-5, atol=1e-7,
                                       err_msg=f"{prefix} step {j} {k}")


@pytest.mark.timeout(900)
def test_train_remesh_train_matches_the_reference(jax_remesh, jparams):
    """3 HT steps at EP 4, ``plan_remesh`` and ``reshard_state`` to EP 2,
    3 more: each step's loss, grad norm and every other metric within
    ``tests/test_torch_ep_train.py``'s train-loop tolerance of the
    reference's, and the parameters after within its limits."""
    cfg = _cfg(get_config, reduced_config)
    dist4, dist2 = make_dist_ctx(cfg, model=4), make_dist_ctx(cfg, model=2)
    hp = T.HParams(**HP_KW)
    state, hist1 = T.train_loop(cfg, hp, dist4, _batches(),
                                steps=STEPS, state=_port_state(cfg, jparams),
                                log_every=0, log_fn=lambda s: None,
                                device="cpu")
    plan = t_el.plan_remesh(cfg, dist4, dist2)
    assert [plan.ep_degree_old, plan.ep_degree_new] == \
        jax_remesh["plan/ep"].tolist() == [4, 2]
    assert plan.notes == ["experts/shard: 4 -> 8"]
    state, dist2 = t_el.reshard_state(cfg, state, dist2)
    assert int(state.opt.step) == STEPS
    state, hist2 = T.train_loop(cfg, hp, dist2, _batches(STEPS), steps=STEPS,
                                state=state, log_every=0,
                                log_fn=lambda s: None, device="cpu")
    _close_hist(hist1, jax_remesh, "ep4")
    _close_hist(hist2, jax_remesh, "ep2")
    treedef = jax.tree_util.tree_structure(jparams)
    after = params_from_jax(cfg, jax.tree_util.tree_unflatten(
        treedef, [jax_remesh[f"param{j}"]
                  for j in range(treedef.num_leaves)]), device="cpu")
    # as test_torch_ep_train: Adam moves a weight by about lr a step
    # whatever its gradient's size, so a gradient that rounds to another
    # sign moves it 2 lr apart
    reach = 2 * 2 * STEPS * HP_KW["peak_lr"]
    adamw.tree_map(lambda g, r: np.testing.assert_allclose(
        g.detach().numpy(), r.numpy(), rtol=0, atol=reach), state.params,
        after)


@pytest.mark.timeout(900)
def test_loss_at_both_degrees_on_one_state(jax_remesh, jparams):
    """On the state after 3 steps at EP 4, with every capacity lifted
    (nothing dropped): the cross entropy at EP 4 and at EP 2 agree within
    fp32 rounding, the router's aux loss (a per-rank statistic, averaged
    over the ranks) does not, and each degree's loss, cross entropy and
    aux loss equal the reference's at that degree."""
    cfg = _cfg(get_config, reduced_config)
    state, _ = T.train_loop(cfg, T.HParams(**HP_KW), make_dist_ctx(
        cfg, model=4), _batches(), steps=STEPS,
        state=_port_state(cfg, jparams), log_every=0, log_fn=lambda s: None,
        device="cpu")
    lifted = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16 / cfg.moe.top_k))
    b = tdata.synth_batch(tdata.DataConfig(**DATA_KW), 0)
    toks, labs = (torch.as_tensor(b[k]).long() for k in ("tokens", "labels"))
    got = {}
    with torch.no_grad():
        for m in (4, 2):
            loss, met = Z.loss_fn(lifted, state.params, toks, labs,
                                  dist=make_dist_ctx(lifted, model=m),
                                  moe_mode="ht", loss_chunk=64)
            got[m] = {"loss": float(loss), "xent": float(met["xent"]),
                      "aux_loss": float(met["aux_loss"]),
                      "dropped": float(met["dropped"])}
            for k, v in got[m].items():
                np.testing.assert_allclose(
                    v, float(jax_remesh[f"lifted/{m}/{k}"]), rtol=1e-5,
                    atol=1e-7, err_msg=f"EP {m} {k}")
    assert got[4]["dropped"] == got[2]["dropped"] == 0.0
    np.testing.assert_allclose(got[4]["xent"], got[2]["xent"], rtol=1e-6)
    assert got[4]["aux_loss"] != got[2]["aux_loss"]


def test_checkpoint_round_trip_across_the_remesh(tmp_path):
    """Save at EP 4, restore into a fresh ``init_state`` (another seed),
    re-shard to EP 2: the next step's loss and metrics are bit for bit
    those of the run that kept its state in memory."""
    cfg = _cfg(get_config, reduced_config)
    dist4, dist2 = make_dist_ctx(cfg, model=4), make_dist_ctx(cfg, model=2)
    hp = T.HParams(**HP_KW)
    state, _ = T.train_loop(cfg, hp, dist4, _batches(), steps=2,
                            log_every=0, log_fn=lambda s: None,
                            device="cpu")
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state, 2)
    restored, step = ckpt.restore_latest(T.init_state(cfg, seed=7,
                                                      device="cpu"))
    assert step == 2 and int(restored.opt.step) == 2
    outs = []
    for st in (state, restored):
        st, _ = t_el.reshard_state(cfg, st, dist2)
        _, m = T.train_step(cfg, hp, dist2, st, _batches(2)(0))
        outs.append({k: v for k, v in m.items() if v.dim() == 0})
    kept, back = outs
    assert set(kept) == set(back)
    for k in kept:
        assert torch.equal(kept[k], back[k]), k

