"""The four dense configs the serving slices left out (phi3-medium-14b,
qwen2-72b, internvl2-26b, musicgen-large) against the reference on the
CPU: every config's fields, parameter counts and shape cells equal the
reference's; reduced prefill + decode of the four match the JAX
``model_zoo`` in fp32 and bf16 with weights through ``params_from_jax``,
each keeping its model's head structure (set after ``reduced_config``,
which gives every model 4 heads); and the serve CLI runs them on the
CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

ALL = list(jconfigs.ARCH_IDS)
DENSE = ["phi3_medium_14b", "qwen2_72b", "internvl2_26b", "musicgen_large"]
# each model's head structure at the reduced width: (query heads, kv heads,
# head dim): phi3 4 query heads a kv head, qwen2-72b 8 (with its q/k/v
# biases), internvl2 6, musicgen MHA at head dim 64
HEADS = {"phi3_medium_14b": (8, 2, 8), "qwen2_72b": (8, 1, 8),
         "internvl2_26b": (12, 2, 8), "musicgen_large": (2, 2, 64)}
# internvl2's vocab is no multiple of 256 (92,553, padded to 92,672): so
# is its reduced one
VOCAB = {"internvl2_26b": 500}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# test_torch_attention.py's SLICE_TOL (test_prefill_decode_match_jax):
# fp32 sums in another order; in bf16 the reference rounds its scores to
# bf16 where the port keeps them fp32, so two layers' logits lie up to 8
# bf16 ulps of their range apart
SLICE_TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}


# the port's own fields, which the JAX package lacks (MLA, leading dense
# layers, the sigmoid router): after the reference's, and at their
# defaults in every configuration the two share
PORT_ONLY = {"kv_lora_rank": 0, "qk_nope_head_dim": 0, "qk_rope_head_dim": 0,
             "v_head_dim": 0, "first_k_dense": 0}
PORT_ONLY_MOE = {"scoring": "softmax", "routed_scale": 1.0}


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["moe"].pop("ep_backend")      # torch_collectives / jax_collectives
    if type(cfg).__module__.startswith("repro_torch"):
        assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
        assert {k: d["moe"].pop(k) for k in PORT_ONLY_MOE} == PORT_ONLY_MOE
    return d


@pytest.mark.parametrize("arch", ALL)
def test_config_matches_reference(arch):
    """Every field, in the reference's order, and the derived counts."""
    got, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(ref)] + list(PORT_ONLY))
    assert ([f.name for f in dataclasses.fields(got.moe)]
            == [f.name for f in dataclasses.fields(ref.moe)]
            + list(PORT_ONLY_MOE))
    assert _fields(got) == _fields(ref)
    assert (got.moe.ep_backend, ref.moe.ep_backend) == ("torch_collectives",
                                                        "jax_collectives")
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert got.padded_experts(4) == ref.padded_experts(4)
    assert got.padded_vocab() == ref.padded_vocab()
    assert got.head_dim_ == ref.head_dim_
    assert configs.cells_for(got) == jconfigs.cells_for(ref)
    for i in range(got.n_layers):
        assert got.is_attn_layer(i) == ref.is_attn_layer(i)
        assert got.is_moe_layer(i) == ref.is_moe_layer(i)
    red = dict(n_layers=3, d_model=96, n_experts=4, vocab=300)
    assert (_fields(configs.reduced_config(got, **red))
            == _fields(jconfigs.reduced_config(ref, **red)))


def test_arch_ids_shapes_and_all_configs_match_reference():
    assert tuple(configs.ARCH_IDS) == tuple(jconfigs.ARCH_IDS)
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    got, ref = configs.all_configs(), jconfigs.all_configs()
    assert list(got) == list(ref)
    assert all(_fields(got[a]) == _fields(ref[a]) for a in ref)
    # the aliases the launchers accept
    assert configs.get_config("qwen2-72b").arch_id == "qwen2_72b"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no_such_model")


@pytest.mark.parametrize("arch,params_b,heads", [
    ("phi3_medium_14b", 14.66, (40, 10, 128)),
    ("qwen2_72b", 72.71, (64, 8, 128)),
    ("internvl2_26b", 19.86, (48, 8, 128)),
    ("musicgen_large", 3.23, (32, 32, 64)),
])
def test_dense_config_shapes(arch, params_b, heads):
    """The shapes the kernels meet at full width: rep 4, 8, 6 at head dim
    128, and MHA at head dim 64; internvl2's and musicgen's frontend
    prefix, which only training carries."""
    cfg = configs.get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_) == heads
    assert round(cfg.param_count() / 1e9, 2) == params_b
    assert cfg.frontend_prefix == {"internvl2_26b": 256,
                                   "musicgen_large": 64}.get(arch, 0)
    assert cfg.qkv_bias == (arch == "qwen2_72b")
    if arch == "internvl2_26b":
        assert cfg.padded_vocab() == 92_672


def _cfgs(arch, dtype):
    h, hkv, hd = HEADS[arch]
    kw = dict(n_layers=2, d_model=64, vocab=VOCAB.get(arch, 512))
    over = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd, dtype=dtype)
    return (dataclasses.replace(jconfigs.reduced_config(
                jconfigs.get_config(arch), **kw), **over),
            dataclasses.replace(configs.reduced_config(
                configs.get_config(arch), **kw), **over))


def _jax_params(jcfg, seed=0):
    """The reference's initial parameters, its zero q/k/v biases (qwen2-72b)
    drawn at random so that they count."""
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(seed))
    attn = jp["blocks"]["slot0"]["attn"]
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        if k in attn:
            attn[k] = jnp.asarray(rng.standard_normal(attn[k].shape) * 0.5,
                                  jnp.float32)
    return jp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_match_jax(arch, dtype):
    """Reduced, the model's head structure kept, through
    ``params_from_jax``: prefill, then 3 decode steps fed the reference's
    greedy tokens; every step's logits within SLICE_TOL of their range."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = _jax_params(jcfg)
    V = cfg.vocab_size
    B, S, n_dec = 2, 12, 3
    toks = np.random.default_rng(0).integers(0, V, (B, S)).astype(np.int32)
    jc = JZ.init_cache(jcfg, B, S + n_dec, dtype=JDT[dtype])
    logits, jc = JZ.prefill(jcfg, jp, jc, jnp.asarray(toks))
    ref, fed = [np.asarray(logits)], []
    for i in range(n_dec):
        tok = jnp.argmax(logits[:, :V], -1)[:, None].astype(jnp.int32)
        fed.append(np.array(tok))
        logits, jc = JZ.decode_step(jcfg, jp, jc, tok, S + i)
        ref.append(np.asarray(logits))

    params = Z.cast_params(params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                           device="cpu"), TDT[dtype])
    attn = params["blocks"][0]["attn"]
    h, hkv, hd = HEADS[arch]
    assert attn["wq"].shape == (64, h, hd) and attn["wk"].shape == (64, hkv,
                                                                    hd)
    assert ("bq" in attn) == (arch == "qwen2_72b")
    assert params["embed"].shape[0] == cfg.padded_vocab() == 512
    cache = Z.init_cache(cfg, B, S + n_dec, dtype=TDT[dtype], device="cpu")
    with torch.inference_mode():
        out, cache, _ = Z.prefill(cfg, params, cache, torch.from_numpy(toks))
        got = [out]
        for i, tok in enumerate(fed):
            out, cache, _ = Z.decode_step(cfg, params, cache,
                                          torch.from_numpy(tok), S + i)
            got.append(out)
    for g, r in zip(got, ref):
        err = float(np.abs(g.numpy() - r).max())
        assert err <= SLICE_TOL[dtype] * float(np.abs(r).max()), err
    if dtype == "float32":
        np.testing.assert_array_equal(np.argmax(got[-1].numpy()[:, :V], -1),
                                      np.argmax(ref[-1][:, :V], -1))


@pytest.mark.parametrize("arch", DENSE)
def test_serve_cli_cpu(arch, capsys):
    """Served on text tokens alone, as the reference's launcher serves
    them (no frontend prefix)."""
    assert serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen",
                           "4"]) == 0
    assert "[serve] generated 8 tokens" in capsys.readouterr().out
