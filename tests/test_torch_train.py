"""The port's training slice against the reference on the same numpy
inputs: ``loss_fn``'s loss and every gradient (reduced falcon-mamba,
jamba, qwen2-moe, qwen3-4b and qwen3-1.7b with its tied head, fp32, no
mesh; internvl2-26b and musicgen-large with their frontend prefix), the
optimizer (full and factored), the schedule, the synthetic data bit for
bit, three ``train_loop`` steps from the same parameters (with a prefix
too); and the loop's own behaviour: checkpoint round trip, recovery from
an injected failure, the watchdog, the CLI on the CPU."""
import dataclasses
import importlib
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.configs as jcfgs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import cosine_with_warmup as jcosine  # noqa: E402
JT = importlib.import_module("repro.training.train_loop")  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
import repro_torch.configs as cfgs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.fault import FailureInjector  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import cosine_with_warmup  # noqa: E402
# the module: the package's name train_loop is the function
T = importlib.import_module("repro_torch.training.train_loop")  # noqa: E402

ARCHS = ["falcon_mamba_7b", "jamba_1_5_large_398b", "qwen2_moe_a2_7b",
         "qwen3_4b", "qwen3_1_7b"]
# the configs' own compute dtype, on the two with Mamba layers (jamba: also
# attention, MLP and MoE layers)
BF16_ARCHS = ["falcon_mamba_7b", "jamba_1_5_large_398b"]
# bf16, two layers forward and back: each gradient leaf lands within 8
# bf16 ulps (2^-7 of the range each) of the reference's; the loss, an fp32
# mean of fp32 token losses over bf16 logits, within one bf16 rounding.
# No tolerance tells a port that computes in fp32 from one in bf16 (the
# two bf16 computations lie as far apart as bf16 from fp32); the scan's
# inputs show where the port rounded
BF16_GRAD_TOL, BF16_LOSS_RTOL = 2.0 ** -4, 2.0 ** -9


def _cfgs(arch, vocab=512, dtype="float32"):
    kw = dict(n_layers=2, d_model=64, vocab=vocab)
    return (dataclasses.replace(jreduced(jget_config(arch), **kw),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config(arch), **kw),
                                dtype=dtype))


def _torch_params(cfg, np_tree):
    p = params_from_jax(cfg, np_tree, device="cpu")
    adamw.tree_map(lambda t: t.requires_grad_(True), p)
    return p


def _close_tree(got, ref, rtol, name=""):
    """Every leaf of a port tree against the same leaf of a JAX tree
    converted with ``params_from_jax``: max |err| <= rtol * max |ref|."""
    def cmp(g, r):
        g = g.detach() if g.grad is None or not g.requires_grad else g.grad
        scale = max(float(r.abs().max()), 1e-30)
        err = float((g - r).abs().max())
        assert err <= rtol * scale, (name, tuple(r.shape), err, scale)
    adamw.tree_map(cmp, got, ref)


# ------------------------------------------------------------- loss_fn --
@pytest.mark.parametrize("arch,dtype",
                         [(a, "float32") for a in ARCHS]
                         + [(a, "bfloat16") for a in BF16_ARCHS])
def test_loss_and_grads_match_jax(arch, dtype, monkeypatch):
    """Loss and every gradient leaf against jax.value_and_grad, both sides
    computing in ``dtype`` from the same fp32 parameters.  fp32: sums in
    another order, 2e-5 of each leaf's range.  bf16: the tolerances above;
    the gradients come back fp32, and every scan call (recomputed ones
    too) took fp32 x, B and C that were computed in bf16."""
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labs = rng.integers(0, 512, (2, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JZ.loss_fn(jcfg, p, toks, labs), has_aux=True)(jp)
    tp = _torch_params(cfg, jax.tree.map(np.asarray, jp))
    calls, real_scan = [], ops.mamba_scan
    monkeypatch.setattr(ops, "mamba_scan", lambda *a: calls.append(
        [t.detach().clone() for t in a]) or real_scan(*a))
    loss, m = Z.loss_fn(cfg, tp, torch.from_numpy(toks).long(),
                        torch.from_numpy(labs).long())
    loss.backward()
    loss_rtol = 1e-6 if dtype == "float32" else BF16_LOSS_RTOL
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=loss_rtol)
    np.testing.assert_allclose(float(m["aux_loss"].detach()),
                               float(jm["aux_loss"]),
                               rtol=max(loss_rtol, 1e-5), atol=1e-8)
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jg), device="cpu")

    def grad_or_zero(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)
    grads = adamw.tree_map(grad_or_zero, tp)
    assert all(g.dtype == torch.float32 for g in adamw.tree_leaves(grads))
    _close_tree(grads, ref, 2e-5 if dtype == "float32" else BF16_GRAD_TOL,
                arch)
    if dtype == "bfloat16":
        # held in fp32, x, B and C hold only bf16 values (computed in fp32,
        # almost no element would)
        assert calls and all(torch.equal(t, t.to(torch.bfloat16).float())
                             for c in calls for t in (c[0], c[3], c[4]))
    if arch == "jamba_1_5_large_398b":          # both kinds of layer
        assert set(tp["blocks"][0]) == {"ln1", "ln2", "attn", "mlp"}
        assert set(tp["blocks"][1]) == {"ln1", "ln2", "mamba", "moe"}


# the frontend-prefix models: internvl2's patch and musicgen's frame
# embeddings (reduced: 4 prefix positions)
PREFIX_ARCHS = ["internvl2_26b", "musicgen_large"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PREFIX_ARCHS)
def test_loss_and_grads_with_prefix_match_jax(arch, dtype):
    """A batch with prefix embeddings: concatenated before the tokens in
    the activation dtype, positions over both, the prefix positions
    dropped before the cross entropy.  Loss and every gradient against
    jax.value_and_grad at test_loss_and_grads_match_jax's tolerances."""
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    assert cfg.frontend_prefix == jcfg.frontend_prefix == 4
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, (2, 12)).astype(np.int32)
    labs = rng.integers(0, 512, (2, 12)).astype(np.int32)
    labs[0, 3] = -1                                 # an unlabelled token
    prefix = rng.standard_normal((2, cfg.frontend_prefix, 64)).astype(
        np.float32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JZ.loss_fn(jcfg, p, toks, labs, prefix), has_aux=True)(jp)
    tp = _torch_params(cfg, jax.tree.map(np.asarray, jp))
    loss, m = Z.loss_fn(cfg, tp, torch.from_numpy(toks).long(),
                        torch.from_numpy(labs).long(),
                        torch.from_numpy(prefix))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-6 if dtype == "float32"
                               else BF16_LOSS_RTOL)
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jg), device="cpu")
    grads = adamw.tree_map(lambda t: t.grad, tp)
    _close_tree(grads, ref, 2e-5 if dtype == "float32" else BF16_GRAD_TOL,
                arch)
    # the prefix counts: the loss without it differs
    no_prefix, _ = Z.loss_fn(cfg, tp, torch.from_numpy(toks).long(),
                             torch.from_numpy(labs).long())
    assert float(no_prefix.detach()) != float(loss.detach())


def test_causal_skip_attention_matches_jax():
    """``causal_skip`` (the hierarchical causal decomposition) against the
    reference's, and against plain blocked causal attention, with four
    blocks so that two levels run; GQA 4 heads over 2."""
    from repro.models.layers import flash_attention_blocked as jfab
    from repro_torch.models.layers import flash_attention_blocked as tfab
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(jfab(q, k, v, q_block=4, kv_block=4, causal_skip=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tfab(tq, tk, tv, q_block=4, kv_block=4, causal_skip=True).numpy()
    plain = tfab(tq, tk, tv, q_block=4, kv_block=4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- optimizer --
@pytest.mark.parametrize("factored", [False, True])
def test_apply_updates_matches_jax(factored):
    """Two steps of AdamW (full or factored second moment; the factored
    leaves are >= 128 x 128) with the global-norm clip engaged."""
    rng = np.random.default_rng(7)
    shapes = {"w": (128, 160), "b": (160,), "m": (2, 128, 130), "s": (3, 64)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    jp, js = dict(params), jadamw.init_state(params, factored=factored)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw.init_state(tp, factored=factored)
    for g in grads:
        jp, js, jm = jadamw.apply_updates(jp, g, js, lr=1e-2,
                                          factored=factored)
        tp, ts, tm = adamw.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
            lr=torch.tensor(1e-2), factored=factored)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 2
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    jnu = jax.tree.map(np.asarray, js.nu)
    if factored:
        assert set(ts.nu["w"]) == {"row", "col"} and set(ts.nu["b"]) == {"full"}
    for k in shapes:
        if factored:
            for kk, v in ts.nu[k].items():
                np.testing.assert_allclose(v.numpy(), jnu[k][kk], rtol=1e-5)
        else:
            np.testing.assert_allclose(ts.nu[k].numpy(), jnu[k], rtol=1e-5)


def test_cosine_with_warmup_matches_jax():
    for warmup, total in ((3, 15), (1, 5), (0, 10)):
        for step in range(total + 3):
            got = float(cosine_with_warmup(step, peak_lr=3e-4, warmup=warmup,
                                           total=total))
            ref = float(jcosine(step, peak_lr=3e-4, warmup=warmup,
                                total=total))
            np.testing.assert_allclose(got, ref, rtol=1e-6)


# ---------------------------------------------------------------- data --
@pytest.mark.parametrize("prefix", [0, 3])
def test_synth_batch_bit_for_bit(prefix):
    kw = dict(vocab_size=65_024, batch=3, seq_len=40, seed=5,
              prefix_len=prefix, d_model=8)
    jdc, tdc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    it = tdata.data_iterator(tdc, start_step=2)
    for step in (0, 1, 2, 7):
        ref, got = jdata.synth_batch(jdc, step), tdata.synth_batch(tdc, step)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  jdata.synth_batch(jdc, 2)["tokens"])


@pytest.mark.parametrize("arch", list(jcfgs.ARCH_IDS))
def test_make_data_config_matches_the_reference(arch):
    """Every shape cell of the arch, and explicit batch / seq overrides:
    the same DataConfig field by field (a frontend prefix comes out of the
    sequence)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert cfgs.cells_for(cfg) == jcfgs.cells_for(jcfg)
    for name in cfgs.cells_for(cfg):
        cell, jcell = cfgs.SHAPES[name], jcfgs.SHAPES[name]
        for kw in (dict(), dict(batch=3, seq=1100, seed=7)):
            got = tdata.make_data_config(cfg, cell, **kw)
            ref = jdata.make_data_config(jcfg, jcell, **kw)
            assert isinstance(got, tdata.DataConfig)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)
            assert got.seq_len + got.prefix_len == kw.get("seq",
                                                          cell.seq_len)


# ---------------------------------------------------------- train loop --
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "jamba_1_5_large_398b"])
def test_train_loop_matches_jax(arch):
    """Three steps of ``train_loop`` from the same parameters: the same
    history and the same parameters after (jamba: adafactor, router-bias
    updates)."""
    jcfg, cfg = _cfgs(arch)
    hp_kw = dict(peak_lr=1e-3, warmup=1, total_steps=3, loss_chunk=16)
    dc_kw = dict(vocab_size=cfg.vocab_size, batch=2, seq_len=16, seed=3)
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(2))
    np_params = jax.tree.map(np.asarray, jp)      # the JAX step donates jp
    jstate = JT.TrainState(jp, jadamw.init_state(
        jp, factored=(jcfg.optimizer == "adafactor")))
    jstate, jhist = JT.train_loop(
        jcfg, JT.HParams(**hp_kw), None,
        partial(jdata.synth_batch, jdata.DataConfig(**dc_kw)), steps=3,
        state=jstate, log_every=0, log_fn=lambda s: None)
    tp = _torch_params(cfg, np_params)
    tstate = T.TrainState(tp, adamw.init_state(
        tp, factored=(cfg.optimizer == "adafactor")))
    tstate, thist = T.train_loop(
        cfg, T.HParams(**hp_kw), None,
        partial(tdata.synth_batch, tdata.DataConfig(**dc_kw)), steps=3,
        state=tstate, log_every=0, log_fn=lambda s: None, device="cpu")
    assert len(thist) == len(jhist) == 3
    for g, r in zip(thist, jhist):
        assert set(g) == set(r), (set(g) ^ set(r))
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=2e-5, atol=1e-7,
                                       err_msg=k)
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params),
                          device="cpu")
    # Adam moves every weight by about lr a step whatever its gradient's
    # size, so a gradient that rounds to another sign moves it 2 lr apart
    adamw.tree_map(lambda g, r: np.testing.assert_allclose(
        g.detach().numpy(), r.numpy(), rtol=0, atol=2 * 3 * 1e-3), tstate.params,
        ref)
    _close_tree(tstate.params, ref, 1e-3, arch)


@pytest.mark.parametrize("arch", PREFIX_ARCHS)
def test_train_loop_with_prefix_matches_jax(arch):
    """Three ``train_loop`` steps on batches that carry the config's
    frontend prefix (the launchers' ``DataConfig(prefix_len=
    cfg.frontend_prefix)``): the same history and parameters after, at
    test_train_loop_matches_jax's tolerances."""
    jcfg, cfg = _cfgs(arch)
    hp_kw = dict(peak_lr=1e-3, warmup=1, total_steps=3, loss_chunk=8)
    dc_kw = dict(vocab_size=cfg.vocab_size, batch=2, seq_len=12, seed=4,
                 prefix_len=cfg.frontend_prefix, d_model=cfg.d_model)
    assert "prefix" in tdata.synth_batch(tdata.DataConfig(**dc_kw), 0)
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jp)
    jstate = JT.TrainState(jp, jadamw.init_state(jp))
    jstate, jhist = JT.train_loop(
        jcfg, JT.HParams(**hp_kw), None,
        partial(jdata.synth_batch, jdata.DataConfig(**dc_kw)), steps=3,
        state=jstate, log_every=0, log_fn=lambda s: None)
    tp = _torch_params(cfg, np_params)
    tstate = T.TrainState(tp, adamw.init_state(tp))
    tstate, thist = T.train_loop(
        cfg, T.HParams(**hp_kw), None,
        partial(tdata.synth_batch, tdata.DataConfig(**dc_kw)), steps=3,
        state=tstate, log_every=0, log_fn=lambda s: None, device="cpu")
    assert len(thist) == len(jhist) == 3
    for g, r in zip(thist, jhist):
        assert set(g) == set(r), (set(g) ^ set(r))
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=2e-5, atol=1e-7,
                                       err_msg=k)
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params),
                          device="cpu")
    adamw.tree_map(lambda g, r: np.testing.assert_allclose(
        g.detach().numpy(), r.numpy(), rtol=0, atol=2 * 3 * 1e-3),
        tstate.params, ref)
    _close_tree(tstate.params, ref, 1e-3, arch)


def _small_cfg(arch="falcon_mamba_7b"):
    return reduced_config(get_config(arch), n_layers=2, d_model=32, vocab=256)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "qwen2_moe_a2_7b"])
def test_make_train_step_is_train_step(arch):
    """The bound step gives the same loss, metrics and parameters, bit for
    bit, as ``train_step`` from the same state and batch."""
    cfg = _small_cfg(arch)
    hp = T.HParams(peak_lr=1e-3, total_steps=4, warmup=1, loss_chunk=16)
    batch = tdata.synth_batch(tdata.DataConfig(
        vocab_size=cfg.vocab_size, batch=2, seq_len=16, seed=4), 0)
    a = T.init_state(cfg, seed=1, device="cpu")
    b = T.init_state(cfg, seed=1, device="cpu")
    step = T.make_train_step(cfg, hp, None)
    for _ in range(2):
        a, ma = step(a, batch)
        b, mb = T.train_step(cfg, hp, None, b, batch)
        assert set(ma) == set(mb)
        for k in ma:
            assert torch.equal(torch.as_tensor(ma[k]),
                               torch.as_tensor(mb[k])), k
    la, lb = adamw.tree_leaves(a.params), adamw.tree_leaves(b.params)
    assert len(la) == len(lb) > 0
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), i
    assert int(a.opt.step) == int(b.opt.step) == 2


def test_training_refuses_what_is_not_ported():
    """Settings the port does not train with raise rather than do nothing:
    parameters in another dtype than fp32."""
    cfg = _small_cfg()
    with pytest.raises(NotImplementedError, match="param_dtype"):
        T.init_state(dataclasses.replace(cfg, param_dtype="bfloat16"),
                     device="cpu")


def test_checkpoint_round_trip(tmp_path):
    cfg = _small_cfg("jamba_1_5_large_398b")     # factored second moment
    state = T.init_state(cfg, seed=0, device="cpu")
    adamw.tree_map(lambda t: t.detach().normal_(), state.opt.nu)
    ck = Checkpointer(tmp_path, keep=2)
    for step in (5, 10, 15):
        ck.save(state, step)
    assert ck.list_steps() == [10, 15]             # retention keeps 2
    other = T.init_state(cfg, seed=1, device="cpu")
    got, step = ck.restore_latest(other)
    assert step == 15 and int(got.opt.step) == int(state.opt.step)
    adamw.tree_map(lambda g, r: torch.testing.assert_close(g, r, rtol=0,
                                                           atol=0),
                   got.params, state.params)
    adamw.tree_map(lambda g, r: torch.testing.assert_close(g, r, rtol=0,
                                                           atol=0),
                   got.opt.nu, state.opt.nu)
    assert all(t.requires_grad for t in adamw.tree_leaves(got.params))
    # a checkpoint without its manifest (a crash mid-write) is skipped
    (tmp_path / "step_000000015" / "MANIFEST.json").unlink()
    assert ck.restore_latest(other)[1] == 10


def test_failure_recovery_resumes_from_checkpoint(tmp_path):
    """As the reference's test: a failure at step 7 restores the step-5
    checkpoint and replays steps 5 and 6 on the same batches."""
    cfg = _small_cfg()
    hp = T.HParams(peak_lr=1e-3, total_steps=10, warmup=2, loss_chunk=16)
    dc = tdata.DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                          seed=1)
    inj = FailureInjector(at_steps=(7,))
    logs = []
    _, hist = T.train_loop(cfg, hp, None, partial(tdata.synth_batch, dc),
                           steps=10, checkpointer=Checkpointer(tmp_path),
                           ckpt_every=5, log_every=0, fail_injector=inj,
                           log_fn=logs.append, device="cpu")
    assert any("simulated failure at step 7" in l for l in logs)
    assert inj.fired == {7}
    assert len(hist) == 12                        # 10 steps + 2 replayed
    # steps 5 and 6 ran twice, from the same restored state and batches
    for a, b in ((5, 7), (6, 8)):
        assert hist[a]["loss"] == hist[b]["loss"]


def test_watchdog_flags_stragglers():
    wd = T.Watchdog(deadline_s=100.0, straggler_factor=2.0)
    for i in range(10):
        assert wd.observe(i, 1.0) is None
    ev = wd.observe(10, 5.0)
    assert ev is not None and ev.kind == "straggler"
    ev2 = wd.observe(11, 1000.0)
    assert ev2.kind == "failure"
    assert [e.kind for e in wd.events] == ["straggler", "failure"]


@pytest.mark.parametrize("arch,extra", [
    ("falcon_mamba_7b", []),
    ("jamba_1_5_large_398b", ["--fail-at", "2", "--ckpt-every", "1"]),
    ("qwen2_moe_a2_7b", ["--mesh", "local", "--local-model-axis", "2"]),
    ("musicgen_large", []),           # batches with a frontend prefix
])
def test_train_cli_cpu(arch, extra, tmp_path, capsys):
    if "--fail-at" in extra:
        extra = extra + ["--ckpt-dir", str(tmp_path)]
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--d-model", "32",
            "--log-every", "1", "--history-out", str(tmp_path / "h.json"),
            *extra]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] finished: loss" in out and "over 3 steps" in out
    assert (tmp_path / "h.json").exists()
