"""Serving Mamba models against the reference on the same numpy inputs:
``mamba_decode_step`` over 8 consecutive steps (outputs, conv history and
ssm state), reduced falcon-mamba-7b and the reduced jamba hybrid
(attention, Mamba and MoE layers) through ``decode_step`` at every prompt
and generated position, jamba also over an EP world of 2 (the JAX side in
a fake-device subprocess), the per-layer caches ``init_cache`` makes,
``reset_cache``, ``generate`` and the serve CLI on the CPU, and the
refusal of a batched prefill on a Mamba layer."""
import contextlib
import dataclasses
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core.moe as jmoe  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
import repro_torch.core.moe as tmoe  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

# the slices' tolerances (test_torch_decode_pos.py::SLICE_TOL): max error
# over the reference's largest |value|
SLICE_TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ("falcon_mamba_7b", "jamba_1_5_large_398b")
# jamba reduced: period 2 (attention + MLP, then Mamba + MoE), 2 periods
LAYERS = {"falcon_mamba_7b": 2, "jamba_1_5_large_398b": 4}
B, S, GEN = 2, 6, 4          # batch, prompt, generated tokens


def _cfgs(arch, dtype="float32"):
    kw = dict(n_layers=LAYERS[arch], d_model=64, vocab=512)
    return (dataclasses.replace(jreduced(jget_config(arch), **kw),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config(arch), **kw),
                                dtype=dtype))


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.float().numpy() - ref).max()
                 / np.abs(ref).max())


@contextlib.contextmanager
def _routes(module, sink: list):
    """Each MoE layer's router call through ``module.route`` (the JAX or
    the port's ``core.moe``) appended to ``sink`` as (top_idx, router
    logits over the real experts) in numpy."""
    orig = module.route

    def f32(a):
        if isinstance(a, torch.Tensor):
            return a.float().numpy()
        return np.asarray(a, np.float32)

    def spy(mcfg, rp, t, n):
        out = orig(mcfg, rp, t, n)
        logits = f32(t) @ f32(rp.w)
        sink.append((np.asarray(out.top_idx), logits[..., :n]))
        return out
    module.route = spy
    try:
        yield
    finally:
        module.route = orig


def _toks():
    return np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)


def _reference(arch, dtype):
    """The JAX prompt through S - 1 decode steps, then GEN greedy ones,
    as the reference's serve runs a Mamba model (eager and unrolled, so
    that the routers' choices can be read).  Returns the numpy params, the
    tokens fed at each step, each step's logits and its router calls."""
    jcfg, _ = _cfgs(arch, dtype)
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(0))
    toks = _toks()
    jc = JZ.init_cache(jcfg, B, S + GEN, dtype=JDT[dtype])
    fed, logits, routes = [], [], []
    tok = toks[:, :1]
    for t in range(S + GEN - 1):
        fed.append(tok)
        routes.append([])
        with _routes(jmoe, routes[-1]):
            out, jc = JZ.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                     jnp.int32(t), unroll=True)
        logits.append(np.asarray(out, np.float32))
        tok = (toks[:, t + 1:t + 2] if t + 1 < S else
               np.argmax(logits[-1][:, :jcfg.vocab_size], -1)[:, None]
               .astype(np.int32))
    return jax.tree.map(np.asarray, jp), fed, logits, routes


@pytest.fixture(scope="module")
def references():
    return {(a, d): _reference(a, d) for a in ARCHS
            for d in ("float32", "bfloat16")}


# ------------------------------------------------------ mamba_decode_step --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_jax(dtype):
    """8 consecutive steps from a zero cache: each step's output, conv
    history and ssm state against the reference's, the port's cache
    updated in place (the same tensors at the same addresses)."""
    jcfg, cfg = _cfgs("falcon_mamba_7b", dtype)
    jp32 = JM.mamba_init(jcfg, jax.random.PRNGKey(3))
    jp = JZ.cast_params({"mamba": jp32}, JDT[dtype])["mamba"]
    p = Z.cast_params({"mamba": {k: torch.from_numpy(np.array(v))
                                 for k, v in jp32.items()}},
                      TDT[dtype])["mamba"]
    jc = JM.mamba_init_cache(jcfg, B, JDT[dtype])
    tc = TM.mamba_init_cache(cfg, B, TDT[dtype], device="cpu")
    assert tc.conv.dtype == TDT[dtype] and tc.ssm.dtype == torch.float32
    ptrs = (tc.conv.data_ptr(), tc.ssm.data_ptr())
    xs = np.random.default_rng(1).standard_normal(
        (8, B, 1, cfg.d_model)).astype(np.float32)
    for i in range(8):
        jx = jnp.asarray(xs[i], JDT[dtype])
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dtype])
        jy, jc = JM.mamba_decode_step(jcfg, jp, jx, jc)
        with torch.inference_mode():
            ty, out = TM.mamba_decode_step(cfg, p, tx, tc)
        assert out is tc and (tc.conv.data_ptr(), tc.ssm.data_ptr()) == ptrs
        for got, ref in ((ty, jy), (tc.conv, jc.conv), (tc.ssm, jc.ssm)):
            assert got.shape == ref.shape
            assert _rel(got, ref) <= SLICE_TOL[dtype], (i, tuple(ref.shape))


def test_mamba_conv_history_shifts_by_one_token():
    """The conv history after a step is the last d_conv - 1 inputs, oldest
    first: the shift reads a new tensor, not the cache it writes."""
    _, cfg = _cfgs("falcon_mamba_7b")
    p = Z.init_params(cfg, seed=0, device="cpu")["blocks"][0]["mamba"]
    tc = TM.mamba_init_cache(cfg, B, torch.float32, device="cpu")
    xs = torch.randn((5, B, 1, cfg.d_model),
                     generator=torch.Generator().manual_seed(0))
    seen = []
    with torch.inference_mode():
        for x in xs:
            seen.append(x[:, 0] @ p["in_proj"])
            TM.mamba_decode_step(cfg, p, x, tc)
            dc = cfg.mamba.d_conv - 1
            want = torch.stack(([torch.zeros_like(seen[0])] * dc + seen)[-dc:],
                               dim=1)
            assert torch.equal(tc.conv, want)


# ---------------------------------------------------------- decode_step ---
def _port_steps(arch, dtype, np_params, fed, dist=None):
    """The port's decode steps on the reference's tokens, ``pos`` a 0-d
    int32 each step.  Returns each step's logits and router calls."""
    _, cfg = _cfgs(arch, dtype)
    params = Z.cast_params(params_from_jax(cfg, np_params, device="cpu"),
                           TDT[dtype])
    cache = Z.init_cache(cfg, B, S + GEN, dtype=TDT[dtype], device="cpu")
    logits, routes = [], []
    with torch.inference_mode():
        for t, tok in enumerate(fed):
            routes.append([])
            with _routes(tmoe, routes[-1]):
                out, cache, _ = Z.decode_step(
                    cfg, params, cache, torch.from_numpy(tok).long(),
                    torch.tensor(t, dtype=torch.int32), dist=dist)
            logits.append(out)
    return logits, routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(references, arch, dtype):
    """Every prompt and generated position: the logits within SLICE_TOL of
    the reference's largest and the same greedy token, sequence by
    sequence.  In bf16 a discrete choice that the two frameworks'
    roundings may turn either way is exempt: a sequence whose MoE routing
    differs from the reference's at a step, where the router's choice was
    decided by less than the tolerance of its logits' range, and a greedy
    token whose top two reference logits lie within the logits' allowed
    error of each other.  The port is fed the reference's tokens, so the
    next step starts level again.  In fp32 no choice may differ, and in
    bf16 at most one (step, sequence) in eight is exempt."""
    np_params, fed, ref, ref_routes = references[(arch, dtype)]
    got, routes = _port_steps(arch, dtype, np_params, fed)
    tol = SLICE_TOL[dtype]
    exempt = 0
    for t, (g, r) in enumerate(zip(got, ref)):
        assert len(routes[t]) == len(ref_routes[t])
        for b in range(B):
            flips = [(tl, ti) for (ti, tl), (ri, _) in
                     zip(routes[t], ref_routes[t])
                     if not np.array_equal(ti[b], ri[b])]
            if flips:
                assert dtype == "bfloat16", (t, b)
                for logits, top in flips:
                    lg = np.sort(logits[b])[::-1]
                    k = top.shape[-1]
                    assert lg[k - 1] - lg[k] <= tol * (lg[0] - lg[-1]), (t, b)
                exempt += 1
                continue
            gb, rb = g[b].float().numpy(), r[b]
            err = tol * np.abs(r).max()
            assert np.abs(gb - rb).max() <= err, (t, b)
            if t + 1 >= S and gb[:512].argmax() != rb[:512].argmax():
                # a generated position: the greedy tokens may differ only
                # where the reference's top two logits lie within twice
                # the error the two logits may each have
                assert dtype == "bfloat16", (t, b)
                top2 = np.sort(rb[:512])[-2:]
                assert top2[1] - top2[0] <= 2 * err, (t, b)
                exempt += 1
    assert exempt <= len(ref) * B // 8


_EP_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    from functools import partial
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import make_dist_ctx
    from repro.models import model_zoo as Z
    cfg = dataclasses.replace(reduced_config(get_config(
        "jamba_1_5_large_398b"), **%(kw)r), dtype="float32")
    B, S, GEN = %(B)d, %(S)d, %(GEN)d
    toks = np.asarray(%(toks)r, np.int32)
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:2])
    dist = make_dist_ctx(cfg, mesh)
    params = Z.init_params(cfg, jax.random.PRNGKey(0))
    cache = Z.init_cache(cfg, B, S + GEN, dtype=jnp.float32)
    out = {}
    with jax.set_mesh(mesh):
        step = jax.jit(partial(Z.decode_step, cfg, dist=dist, moe_mode="ll"))
        tok = toks[:, :1]
        for t in range(S + GEN - 1):
            out[f"fed{t}"] = np.asarray(tok)
            logits, cache = step(params, cache, jnp.asarray(tok),
                                 jnp.int32(t))
            out[f"logits{t}"] = np.asarray(logits)
            tok = (toks[:, t + 1:t + 2] if t + 1 < S else np.asarray(
                jnp.argmax(logits[:, :cfg.vocab_size], -1))[:, None]
                .astype(np.int32))
    np.savez(sys.argv[1], **out)
    print("JAMBA-EP-JAX-OK")
""")


def test_jamba_decode_over_an_ep_world_of_2_matches_jax(references, tmp_path,
                                                        dist_runner):
    """The reference's decode steps over a (data 1, model 2) mesh of fake
    devices (its KV cache sharded over the model axis, LL dispatch across
    the two ranks) against the port's over its rank-stacked world of 2, in
    fp32: the logits at every step within SLICE_TOL, the same tokens."""
    arch = "jamba_1_5_large_398b"
    script = (f"import sys\nsys.argv[1:] = [{str(tmp_path / 'o.npz')!r}]\n"
              + _EP_SCRIPT % {"kw": dict(n_layers=LAYERS[arch], d_model=64,
                                         vocab=512),
                              "B": B, "S": S, "GEN": GEN,
                              "toks": _toks().tolist()})
    assert "JAMBA-EP-JAX-OK" in dist_runner(script, n_devices=2, timeout=900)
    res = np.load(tmp_path / "o.npz")
    n = S + GEN - 1
    fed = [res[f"fed{t}"] for t in range(n)]
    np_params = references[(arch, "float32")][0]
    _, cfg = _cfgs(arch)
    got, routes = _port_steps(arch, "float32", np_params, fed,
                              dist=make_dist_ctx(cfg, model=2))
    assert all(len(r) == LAYERS[arch] // 2 for r in routes)
    for t in range(n):
        assert _rel(got[t], res[f"logits{t}"]) <= SLICE_TOL["float32"], t
        if S <= t + 1 < n:             # the reference's greedy token
            assert np.array_equal(got[t][:, :512].argmax(-1).numpy(),
                                  fed[t + 1][:, 0]), t


# ------------------------------------------------------------ the caches --
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_gives_each_layer_its_own_kind(arch):
    """At the published widths and depth (on the meta device: nothing is
    allocated): an attention layer holds K and V of (B, S_max, Hkv, hd) in
    the cache dtype and no recurrent state; a Mamba layer its conv history
    (B, d_conv - 1, d_inner) in the cache dtype and its ssm state (B,
    d_inner, d_state) in fp32, and no KV cache."""
    cfg = get_config(arch)
    cache = Z.init_cache(cfg, 4, 96, dtype=torch.bfloat16, device="meta")
    assert len(cache) == cfg.n_layers
    di, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    kinds = []
    for i, c in enumerate(cache):
        if cfg.is_attn_layer(i):
            assert set(c) == {"k", "v"}
            for t in c.values():
                assert t.shape == (4, 96, cfg.n_kv_heads, cfg.head_dim_)
                assert t.dtype == torch.bfloat16
        else:
            assert set(c) == {"conv", "ssm"}
            assert c["conv"].shape == (4, cfg.mamba.d_conv - 1, di)
            assert c["conv"].dtype == torch.bfloat16
            assert c["ssm"].shape == (4, di, n)
            assert c["ssm"].dtype == torch.float32
        kinds.append(set(c))
    n_attn = sum(k == {"k", "v"} for k in kinds)
    assert n_attn == {"falcon_mamba_7b": 0, "jamba_1_5_large_398b": 9}[arch]


def test_init_params_casts_each_expert_weight_as_made():
    """``init_params(dtype=...)`` makes a MoE layer's expert weights in
    ``dtype`` one at a time (the fp32 peak one weight, not the layer),
    with the values of an fp32 init cast afterwards, bit for bit; the
    router, norms and the Mamba layers' fp32 leaves stay fp32."""
    _, cfg = _cfgs("jamba_1_5_large_398b")
    got = Z.init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    ref = Z.cast_params(Z.init_params(cfg, seed=3, device="cpu"),
                        torch.bfloat16)
    moe = [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]
    assert moe
    for i in moe:
        m = got["blocks"][i]["moe"]
        for k in ("w_gate", "w_up", "w_down"):
            assert m[k].dtype == torch.bfloat16
        assert m["router_w"].dtype == torch.float32

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    same(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_cache_gives_a_fresh_cache(arch):
    """After a few steps, ``reset_cache`` zeroes every tensor in place (the
    same tensors), and the steps that follow give the logits of a cache
    that ``init_cache`` made, bit for bit."""
    _, cfg = _cfgs(arch)
    params = Z.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_toks()).long()

    def run(cache):
        out = []
        with torch.inference_mode():
            for t in range(S):
                logits, _, _ = Z.decode_step(cfg, params, cache,
                                             toks[:, t:t + 1], t)
                out.append(logits)
        return out
    used = Z.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    run(used)
    before = [{n: t for n, t in c.items()} for c in used]
    assert any(bool(t.any()) for c in used for t in c.values())
    assert Z.reset_cache(used) is used
    for c, b in zip(used, before):
        for n, t in c.items():
            assert t is b[n] and not t.any()
    fresh = run(Z.init_cache(cfg, B, S, dtype=torch.float32, device="cpu"))
    for a, b in zip(run(used), fresh):
        assert torch.equal(a, b)


# ------------------------------------------------- prefill and generate ---
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_mamba_as_the_reference(arch):
    """A batched prefill has no post-prompt recurrent state: ``prefill``
    refuses a Mamba model and ``block_prefill`` a Mamba layer, with the
    reference's reasons."""
    jcfg, cfg = _cfgs(arch)
    toks = _toks()
    with pytest.raises(AssertionError,
                       match="mamba prefill goes through decode_step"):
        JZ.prefill(jcfg, JZ.init_params(jcfg, jax.random.PRNGKey(0)),
                   JZ.init_cache(jcfg, B, S, dtype=jnp.float32),
                   jnp.asarray(toks))
    params = Z.init_params(cfg, seed=0, device="cpu")
    cache = Z.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="mamba prefill goes through decode_step"):
        Z.prefill(cfg, params, cache, torch.from_numpy(toks).long())
    i = next(i for i in range(cfg.n_layers) if not cfg.is_attn_layer(i))
    x = torch.zeros((B, S, cfg.d_model))
    pos = torch.arange(S)[None].expand(B, S)
    with pytest.raises(NotImplementedError, match="per-token decode loop"):
        TB.block_prefill(cfg, None, params["blocks"][i], x, cache[i], pos)
    jp = jax.tree.map(lambda a: a[0], JZ.init_params(
        jcfg, jax.random.PRNGKey(0))["blocks"][f"slot{i}"])
    with pytest.raises(NotImplementedError, match="per-token decode loop"):
        JB.block_prefill(jcfg, None, jp, jnp.zeros((B, S, cfg.d_model)),
                         JB.block_init_cache(jcfg, i, B, S, jnp.float32),
                         jnp.asarray(pos.numpy()))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_gives_the_reference_tokens(references, arch):
    """``generate`` on the CPU takes the per-token prefill for a Mamba
    model (no TTFT) and gives the reference's greedy tokens, fp32."""
    np_params, fed, _, _ = references[(arch, "float32")]
    _, cfg = _cfgs(arch)
    params = params_from_jax(cfg, np_params, device="cpu")
    res = serve.generate(cfg, params, torch.from_numpy(_toks()).long(), GEN)
    assert not res["batched_prefill"] and res["ttft_s"] is None
    assert not res["cuda_graph"]
    want = np.concatenate(fed[S:], axis=1)       # the greedy tokens fed
    assert res["tokens"].shape == (B, GEN)
    assert np.array_equal(res["tokens"][:, :GEN - 1].numpy(), want)
    assert torch.isfinite(res["logits"]).all()


@pytest.mark.parametrize("arch,extra", [
    ("falcon_mamba_7b", []),
    ("jamba_1_5_large_398b", []),
    ("jamba_1_5_large_398b", ["--mesh", "local", "--local-model-axis", "2"]),
])
def test_serve_cli_cpu_mamba(arch, extra, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", *extra]
    assert serve.main(argv) == 0
    assert "[serve] generated 8 tokens" in capsys.readouterr().out
