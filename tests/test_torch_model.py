"""The port's serving slice against the reference: a reduced qwen2-moe
model, and a reduced moonshot-v1-16b-a3b that keeps its top-6 routing over
16 experts (JAX parameters converted with ``params_from_jax``), prefill
and decode over the port's rank-stacked EP world, and match the JAX
package's ``prefill``/``decode_step`` without a mesh (the dense MoE
oracle); the serve CLI runs on the CPU; and neither the package nor
``chip_smoke`` imports JAX or the JAX package."""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed.sharding import make_dist_ctx  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# fp32 on both sides; the EP path adds in another order than the oracle
RTOL, ATOL = 2e-4, 2e-4


def _cfgs(arch="qwen2_moe_a2_7b", n_experts=8, top_k=None):
    """(the reference's, the port's) reduced ``arch`` in fp32; ``top_k``
    set after ``reduced_config``, which caps it at 2."""
    kw = dict(n_layers=2, d_model=64, n_experts=n_experts, vocab=512)
    out = []
    for get, reduce in ((jget_config, jreduced), (get_config,
                                                  reduced_config)):
        c = reduce(get(arch), **kw)
        if top_k is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                               top_k=top_k))
        out.append(dataclasses.replace(c, dtype="float32"))
    return tuple(out)


# moonshot-v1-16b-a3b keeps its top-6 routing: 16 experts, 4 a rank in an
# EP world of 4, a token's choices on up to 4 ranks
MOONSHOT = dict(arch="moonshot_v1_16b_a3b", n_experts=16, top_k=6)


def _jax_steps(jcfg):
    """JAX params and the reference prefill + 4 greedy decode steps."""
    B, S, n_dec = 4, 8, 4
    params = JZ.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    cache = JZ.init_cache(jcfg, B, S + n_dec + 1, dtype=jnp.float32)
    logits, cache = JZ.prefill(jcfg, params, cache, jnp.asarray(tokens))
    steps = [np.asarray(logits)]
    for i in range(n_dec):
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)[:, None].astype(
            jnp.int32)
        logits, cache = JZ.decode_step(jcfg, params, cache, tok, S + i)
        steps.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), tokens, steps


@pytest.fixture(scope="module")
def jax_run():
    return _jax_steps(_cfgs()[0])


@pytest.fixture(scope="module")
def jax_run_moonshot():
    return _jax_steps(_cfgs(**MOONSHOT)[0])


def _dist(cfg, world):
    return {"none": None, "model2": make_dist_ctx(cfg, model=2),
            "model4": make_dist_ctx(cfg, model=4),
            "pod2x2": make_dist_ctx(cfg, model=2, pod=2)}[world]


@pytest.mark.parametrize("world", ["none", "model2", "pod2x2"])
def test_prefill_decode_match_jax(jax_run, world):
    np_params, tokens, ref_steps = jax_run
    _, cfg = _cfgs()
    params = params_from_jax(cfg, np_params, device="cpu")
    assert len(params["blocks"]) == 2 and params["blocks"][1]["moe"][
        "w_gate"].shape == (16, 64, 64)           # 8 real experts in 16
    _prefill_decode_close(cfg, params, tokens, ref_steps, _dist(cfg, world))


@pytest.mark.parametrize("world", ["none", "model4", "pod2x2"])
def test_moonshot_prefill_decode_match_jax(jax_run_moonshot, world):
    """Reduced moonshot: top 6 of 16 experts (HT dedups a token's six
    choices to at most 4 rank entries, LL fills 6 slots a token), no
    shared expert, an untied head."""
    np_params, tokens, ref_steps = jax_run_moonshot
    _, cfg = _cfgs(**MOONSHOT)
    assert cfg.moe.top_k == 6 and cfg.moe.d_shared == 0
    assert not cfg.tie_embeddings
    params = params_from_jax(cfg, np_params, device="cpu")
    moe = params["blocks"][0]["moe"]
    assert moe["w_gate"].shape == (16, 64, 64) and "shared" not in moe
    _prefill_decode_close(cfg, params, tokens, ref_steps, _dist(cfg, world))


def _prefill_decode_close(cfg, params, tokens, ref_steps, dist):
    """The port's prefill and greedy decode steps against the reference's
    logits, each step's token the reference's; nothing dropped."""
    B, S = tokens.shape
    cache = Z.init_cache(cfg, B, S + len(ref_steps), dtype=torch.float32,
                         device="cpu")
    logits, cache, aux = Z.prefill(cfg, params, cache,
                                   torch.from_numpy(tokens), dist=dist)
    drops = [float(aux["dropped"])]
    got = [logits.numpy()]
    for i in range(len(ref_steps) - 1):
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        ref_tok = np.argmax(ref_steps[i][:, :cfg.vocab_size], -1)
        np.testing.assert_array_equal(tok[:, 0].numpy(), ref_tok)
        logits, cache, aux = Z.decode_step(cfg, params, cache, tok, S + i,
                                           dist=dist)
        drops.append(float(aux["dropped"]))
        got.append(logits.numpy())
    for g, r in zip(got, ref_steps):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    assert drops == [0.0] * len(drops)


def test_cast_params_keeps_fp32_names():
    _, cfg = _cfgs()
    p = Z.init_params(cfg, seed=1, device="cpu", dtype=torch.bfloat16)
    blk = p["blocks"][0]
    assert p["embed"].dtype == p["lm_head"].dtype == torch.bfloat16
    assert p["final_ln"].dtype == blk["ln1"].dtype == torch.float32
    assert blk["moe"]["router_w"].dtype == torch.float32
    assert blk["moe"]["router_b"].dtype == torch.float32
    assert blk["moe"]["w_gate"].dtype == torch.bfloat16
    assert blk["moe"]["shared"]["w_down"].dtype == torch.bfloat16
    assert blk["attn"]["bq"].dtype == torch.bfloat16


@pytest.mark.parametrize("extra", [["--wire-dtype", "fp32"],
                                   ["--wire-dtype", "fp8"],
                                   ["--wire-dtype", "int8"],
                                   ["--mesh", "none"]])
def test_serve_cli_cpu(extra, capsys):
    argv = ["--arch", "qwen2_moe_a2_7b", "--reduced", "--device", "cpu",
            "--mesh", "local", "--local-model-axis", "2", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", *extra]
    assert serve.main(argv) == 0
    assert "[serve] generated 8 tokens" in capsys.readouterr().out


def test_serve_generate_reports():
    _, cfg = _cfgs()
    params = Z.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    res = serve.generate(cfg, params, prompts, 3,
                         dist=make_dist_ctx(cfg, model=2))
    assert res["tokens"].shape == (2, 3)
    assert res["prefill_dropped"] == 0.0 and res["decode_dropped"] == 0.0
    assert res["prefill_dropped_per_layer"] == [0.0] * cfg.n_layers
    assert torch.isfinite(res["logits"]).all()


def test_port_imports_no_jax():
    """Every module of repro_torch, and chip_smoke, import without JAX or
    the JAX package in the process; and the transport substrate runs
    without them too (an fp8 row through the port's codec, and a small
    EPWorld over the fp8 wire, LL and HT), so that a lazy ``ml_dtypes``
    import would show."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np
        sys.path[:0] = [%r, %r]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        from repro_torch.core.transport import EPWorld, NetConfig, get_codec
        rng = np.random.default_rng(0)
        c = get_codec("fp8")
        row = rng.standard_normal((1, 200)).astype(np.float32)
        back = c.decode(c.encode(row), 200)
        assert back.shape == (1, 200) and np.abs(back - row).max() < 0.2
        R, E, K, D, Tl = 2, 4, 2, 8, 3
        x = rng.standard_normal((R, Tl, D)).astype(np.float32)
        ti = np.array([[[0, 1], [2, 3], [1, 2]], [[3, 0], [0, 2], [1, 3]]],
                      np.int32)
        tw = np.full((R, Tl, K), 0.5, np.float32)
        w3 = [(rng.standard_normal(s) * 0.2).astype(np.float32)
              for s in ((E, D, 8), (E, D, 8), (E, 8, D))]
        w = EPWorld(n_ranks=R, n_experts=E, top_k=K, d=D, f=8,
                    capacity=Tl * K, net_cfg=NetConfig(mode="srd", seed=0),
                    wire_dtype="fp8")
        for out in (w.run(x, ti, tw, *w3), w.run_ht(x, ti, tw, *w3)):
            assert out.shape == (R, Tl, D) and np.isfinite(out).all()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                            "repro"))
        assert not bad, bad
        print("IMPORTS-OK", len(names))
    """) % (str(ROOT / "src"), str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTS-OK" in proc.stdout
