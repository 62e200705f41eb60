"""The port's MoE token layout and ``--mesh local`` serving against the
reference on a fake-device mesh.

The reference shards a MoE layer's (B, S) tokens as ``P(bd, sq, None)``:
the batch over "pod", the sequence over "model" when S > 1 and divisible,
else replicated on the model ranks.  With B > 1 that puts other tokens on
each rank than a row-major split, and once capacity drops, the drops, the
outputs and the gradients differ.  A reduced qwen2-moe whose router bias
sends every token to expert 0 (so HT and LL drop) runs ``forward``,
``loss_fn`` with its gradients, and one LL decode step of 40 tokens a
rank in ONE subprocess with 4 fake CPU devices, over model = 2 and (pod
2, model 2); the port runs the same on its rank-stacked world.  Then the
reference's ``serve --mesh local`` (prefill through decode steps) against
the port's ``generate`` with the same flags."""
import dataclasses
import re
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

KW = dict(n_layers=2, d_model=64, n_experts=8, vocab=512)
SKEW = 4.0            # router bias on expert 0: every token selects it
S = 64                # prompt length: 64 or 128 tokens a rank over model 2
DECODE_B = 40         # decode tokens a rank (replicated), > LL's floor of 32
# (name, mesh shape, mesh axes, port world kwargs)
WORLDS = [("model2", (1, 2), ("data", "model"), dict(model=2)),
          ("pod2x2", (2, 1, 2), ("pod", "data", "model"),
           dict(model=2, pod=2))]
# forward/loss cases: (world, B, S).  None where S does not split over the
# model axis: the reference then replicates the tokens, and once HT drops
# at an expert, the source that arrives first keeps its capacity, so the
# replicas' outputs differ, and its later layers mix them; the port reads
# the first replica (``moe.from_ranks``)
CASES = [(w[0], B, S) for w in WORLDS for B in (2, 4)]
# fp32 on both sides, sums in other orders
RTOL, ATOL, GRAD_RTOL = 2e-4, 2e-4, 2e-5


def _cfg(get, reduce):
    return dataclasses.replace(reduce(get("qwen2_moe_a2_7b"), **KW),
                               dtype="float32")


_SKEW_SRC = """
def skew(params):
    def f(path, leaf):
        if jax.tree_util.keystr(path).endswith("['router_b']"):
            return leaf.at[..., 0].add(%(skew)r)
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)
""" % {"skew": SKEW}
exec(_SKEW_SRC)     # defines skew() here as in the subprocess


def _inputs(B, S_, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (B, S_)).astype(np.int32),
            rng.integers(0, 512, (B, S_)).astype(np.int32))


_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    from functools import partial
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import make_dist_ctx
    from repro.models import model_zoo as Z
    %(skew_src)s
    cfg = dataclasses.replace(reduced_config(get_config("qwen2_moe_a2_7b"),
                                             **%(kw)r), dtype="float32")
    params = skew(Z.init_params(cfg, jax.random.PRNGKey(0)))
    worlds = %(worlds)r
    cases = %(cases)r
    out = {}
    for name, shape, axes, _ in worlds:
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                             devices=jax.devices()[:n])
        dist = make_dist_ctx(cfg, mesh)
        with jax.set_mesh(mesh):
            for i, (w, B, S) in enumerate(cases):
                if w != name:
                    continue
                rng = np.random.default_rng(i)
                toks = rng.integers(0, 512, (B, S)).astype(np.int32)
                labs = rng.integers(0, 512, (B, S)).astype(np.int32)
                x, aux = jax.jit(lambda p, t: Z.forward(cfg, p, t, dist=dist))(
                    params, toks)
                (loss, m), g = jax.jit(jax.value_and_grad(
                    lambda p: Z.loss_fn(cfg, p, toks, labs, dist=dist),
                    has_aux=True))(params)
                key = f"{name}/{B}/{S}"
                out[key + "/hidden"] = np.asarray(x)
                out[key + "/dropped"] = np.asarray(aux["dropped"])
                out[key + "/loss"] = np.asarray(loss)
                out[key + "/loss_dropped"] = np.asarray(m["dropped"])
                for j, leaf in enumerate(jax.tree_util.tree_leaves(g)):
                    out[key + f"/grad{j}"] = np.asarray(leaf)
        if name == "model2":
            toks = np.random.default_rng(99).integers(
                0, 512, (%(decode_b)d, 1)).astype(np.int32)
            cache = Z.init_cache(cfg, %(decode_b)d, 4, dtype=jnp.float32)
            step = jax.jit(partial(Z.decode_step, cfg, dist=dist, moe_mode="ll"))
            logits, _ = step(params, cache, jnp.asarray(toks), jnp.int32(0))
            out["decode/logits"] = np.asarray(logits)
    np.savez(sys.argv[1], **out)
    print("LAYOUT-JAX-OK")
""")


@pytest.fixture(scope="module")
def jax_layout(tmp_path_factory, dist_runner):
    d = tmp_path_factory.mktemp("layout")
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'out.npz')!r}]\n"
              + _SCRIPT % {"skew_src": _SKEW_SRC,
                           "kw": KW, "worlds": WORLDS, "cases": CASES,
                           "decode_b": DECODE_B})
    assert "LAYOUT-JAX-OK" in dist_runner(script, n_devices=4, timeout=900)
    res = np.load(d / "out.npz")
    return {k: res[k] for k in res.files}


@pytest.fixture(scope="module")
def jparams():
    cfg = _cfg(jget_config, jreduced)
    return jax.tree.map(np.asarray, skew(JZ.init_params(
        cfg, jax.random.PRNGKey(0))))


def _world(name):
    return next(w[3] for w in WORLDS if w[0] == name)


def test_token_layout_follows_the_reference():
    cfg = _cfg(get_config, reduced_config)
    m2, p22 = make_dist_ctx(cfg, model=2), make_dist_ctx(cfg, model=2, pod=2)
    assert tmoe.token_layout(m2, 4, 64) == (1, 2)     # sequence over model
    assert tmoe.token_layout(m2, 4, 63) == (1, 1)     # replicated
    assert tmoe.token_layout(m2, 4, 1) == (1, 1)      # decode: replicated
    assert tmoe.token_layout(p22, 4, 64) == (2, 2)    # batch over pod too
    assert tmoe.token_layout(p22, 3, 64) == (1, 2)    # pods hold the batch
    x = torch.arange(4 * 6 * 1.0).reshape(4, 6, 1)
    t = tmoe.to_ranks(p22, x)
    # rank (pod 1, model 0): rows 2-3, positions 0-2, row-major
    assert t[2, :, 0].tolist() == [12, 13, 14, 18, 19, 20]
    assert torch.equal(tmoe.from_ranks(p22, t, 4, 6), x)
    t = tmoe.to_ranks(m2, x[:, :1])                   # S = 1: replicas
    assert torch.equal(t[0], t[1]) and t.shape == (2, 4, 1)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("world,B,S_", CASES)
def test_forward_and_grads_match_the_reference_layout(jax_layout, jparams,
                                                      world, B, S_):
    """``forward``'s hidden states (so its logits) and ``dropped``, and
    ``loss_fn``'s loss, ``dropped`` and every gradient, at HT drops."""
    cfg = _cfg(get_config, reduced_config)
    dist = make_dist_ctx(cfg, **_world(world))
    i = CASES.index((world, B, S_))
    toks, labs = _inputs(B, S_, i)
    key = f"{world}/{B}/{S_}"
    params = params_from_jax(cfg, jparams, device="cpu")
    with torch.no_grad():
        x, aux = Z.forward(cfg, params, torch.from_numpy(toks).long(),
                           dist=dist)
    assert float(aux["dropped"]) > 0               # HT does drop here
    np.testing.assert_allclose(float(aux["dropped"]),
                               float(jax_layout[key + "/dropped"]), rtol=1e-6)
    np.testing.assert_allclose(x.numpy(), jax_layout[key + "/hidden"],
                               rtol=RTOL, atol=ATOL)
    head = params["lm_head"].numpy()
    np.testing.assert_allclose(x.numpy() @ head,
                               jax_layout[key + "/hidden"] @ head,
                               rtol=RTOL, atol=ATOL)

    tp = params_from_jax(cfg, jparams, device="cpu")
    adamw.tree_map(lambda t: t.requires_grad_(True), tp)
    loss, m = Z.loss_fn(cfg, tp, torch.from_numpy(toks).long(),
                        torch.from_numpy(labs).long(), dist=dist)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax_layout[key + "/loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["dropped"]),
                               float(jax_layout[key + "/loss_dropped"]),
                               rtol=1e-6)
    treedef = jax.tree_util.tree_structure(jparams)
    n = treedef.num_leaves
    jg = jax.tree_util.tree_unflatten(
        treedef, [jax_layout[key + f"/grad{j}"] for j in range(n)])
    ref = params_from_jax(cfg, jg, device="cpu")

    def cmp(t, r):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        scale = max(float(r.abs().max()), 1e-30)
        assert float((g - r).abs().max()) <= GRAD_RTOL * scale, tuple(r.shape)
    adamw.tree_map(cmp, tp, ref)


def test_decode_step_over_32_tokens_a_rank_matches(jax_layout, jparams):
    """One LL decode step of 40 tokens: the reference replicates them on
    both model ranks, 40 a rank, past LL's capacity floor of 32, so the
    skewed router's expert drops 8 of each rank's choices; a row-major
    split (20 a rank) would drop none and give other logits."""
    cfg = _cfg(get_config, reduced_config)
    params = params_from_jax(cfg, jparams, device="cpu")
    toks = np.random.default_rng(99).integers(0, 512, (DECODE_B, 1))
    cache = Z.init_cache(cfg, DECODE_B, 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, _, aux = Z.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks).long(), 0,
                                       dist=make_dist_ctx(cfg, model=2))
    assert float(aux["dropped"]) > 0
    np.testing.assert_allclose(logits.numpy(), jax_layout["decode/logits"],
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------- serve --mesh local --
_SERVE_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    import repro.configs as C
    from repro.launch import serve
    from repro.models import model_zoo as Z
    # the CLI's reduced config and its cache in fp32, as the port's fp32
    # run keeps them, so that no greedy choice turns on a bf16 rounding
    _reduced, _cache = C.reduced_config, Z.init_cache
    C.reduced_config = lambda *a, **k: dataclasses.replace(
        _reduced(*a, **k), dtype="float32")
    Z.init_cache = lambda *a, **k: _cache(*a, dtype=jnp.float32)
    argv = %(argv)r
    serve.main(argv)
    cfg = C.reduced_config(C.get_config("qwen2_moe_a2_7b"), n_layers=2,
                           d_model=128, vocab=512)
    key = jax.random.PRNGKey(0)
    params = Z.init_params(cfg, key)
    prompts = jax.random.randint(key, (%(B)d, %(P)d), 0, cfg.vocab_size)
    np.savez(sys.argv[1], prompts=np.asarray(prompts),
             **{str(i): np.asarray(l) for i, l in
                enumerate(jax.tree_util.tree_leaves(params))})
    print("SERVE-JAX-OK")
""")
SERVE_B, SERVE_P, SERVE_GEN = 2, 8, 4


def test_serve_mesh_local_gives_the_reference_tokens(tmp_path, dist_runner):
    """``serve --mesh local --local-model-axis 2`` of the reference prefills
    through S - 1 decode steps (its dist has a model axis); the port's
    ``generate`` with a model axis takes the same branch by default and
    gives the same tokens."""
    argv = ["--arch", "qwen2_moe_a2_7b", "--reduced", "--mesh", "local",
            "--local-model-axis", "2", "--batch", str(SERVE_B),
            "--prompt-len", str(SERVE_P), "--gen", str(SERVE_GEN)]
    script = (f"import sys\nsys.argv[1:] = [{str(tmp_path / 'p.npz')!r}]\n"
              + _SERVE_SCRIPT % {"argv": argv, "B": SERVE_B, "P": SERVE_P})
    out = dist_runner(script, n_devices=2, timeout=900)
    assert "SERVE-JAX-OK" in out
    ref_first = [int(v) for v in re.search(
        r"first sequence: \[([^\]]*)\]", out).group(1).split(",")]
    data = np.load(tmp_path / "p.npz")
    cfg = dataclasses.replace(reduced_config(
        get_config("qwen2_moe_a2_7b"), n_layers=2, d_model=128, vocab=512),
        dtype="float32")
    jcfg = dataclasses.replace(jreduced(
        jget_config("qwen2_moe_a2_7b"), n_layers=2, d_model=128, vocab=512),
        dtype="float32")
    treedef = jax.tree_util.tree_structure(
        JZ.init_params(jcfg, jax.random.PRNGKey(0)))
    leaves = [data[str(i)] for i in range(treedef.num_leaves)]
    params = params_from_jax(cfg, jax.tree_util.tree_unflatten(treedef,
                                                               leaves),
                             device="cpu")
    res = serve.generate(cfg, params, torch.from_numpy(data["prompts"]).long(),
                         SERVE_GEN, dist=make_dist_ctx(cfg, model=2))
    assert res["ttft_s"] is None                 # no batched prefill ran
    assert res["tokens"].shape == (SERVE_B, SERVE_GEN)
    assert res["tokens"][0].tolist() == ref_first
