"""The port's serving slice against the reference: a reduced qwen2-moe
model (JAX parameters converted with ``params_from_jax``) prefills and
decodes over the port's rank-stacked EP world, and matches the JAX
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


def _cfgs():
    kw = dict(n_layers=2, d_model=64, n_experts=8, vocab=512)
    j = dataclasses.replace(jreduced(jget_config("qwen2_moe_a2_7b"), **kw),
                            dtype="float32")
    t = dataclasses.replace(reduced_config(get_config("qwen2_moe_a2_7b"), **kw),
                            dtype="float32")
    return j, t


@pytest.fixture(scope="module")
def jax_run():
    """JAX params and the reference prefill + 4 greedy decode steps."""
    jcfg, _ = _cfgs()
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


@pytest.mark.parametrize("world", ["none", "model2", "pod2x2"])
def test_prefill_decode_match_jax(jax_run, world):
    np_params, tokens, ref_steps = jax_run
    _, cfg = _cfgs()
    dist = {"none": None, "model2": make_dist_ctx(cfg, model=2),
            "pod2x2": make_dist_ctx(cfg, model=2, pod=2)}[world]
    params = params_from_jax(cfg, np_params, device="cpu")
    assert len(params["blocks"]) == 2 and params["blocks"][1]["moe"][
        "w_gate"].shape == (16, 64, 64)           # 8 real experts in 16
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
    the JAX package in the process."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.path[:0] = [%r, %r]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
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
