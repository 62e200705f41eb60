"""Decoding with the position on the device, against the reference on the
same numpy inputs: the plain flash decoding with a 0-d int32 ``pos``
against ``decode_attention_pallas`` in interpret mode (and bit for bit
against the same call with an int ``pos``); reduced qwen3-4b and
qwen2-moe (the dense MoE oracle) ``decode_step`` called with a tensor
``pos`` against the JAX ``model_zoo.decode_step`` called with
``jnp.int32(t)``; the chunking of both decode kernels (a contiguous
slice, and whole columns of a paged table), fixed by the shapes alone;
and ``generate``'s ``cuda_graph`` switch on the CPU."""
import dataclasses
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import norm_attention as na  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

# the tolerances of test_decode_attention_plain_matches_pallas (the
# reference's own, tests/test_kernels.py:235-236)
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# and those of the slices' prefill + decode tests: qwen3
# (test_torch_attention.py::SLICE_TOL, of the logits' range) and qwen2-moe
# (test_torch_model.py, fp32)
SLICE_TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}
MOE_RTOL = MOE_ATOL = 2e-4


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        j = jnp.asarray(rng.standard_normal(s).astype(np.float32), JDT[dtype])
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(TDT[dtype])))
    return out


# ------------------------------------------------ plain flash decoding ----
S_DEC, START = 320, 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("pos", [0, 255, 256, 257, START + S_DEC - 1])
def test_decode_plain_tensor_pos_matches_pallas(pos, rep, dtype):
    """A cache slice of global positions [16, 336): pos 0 lies before it
    (nothing live, output 0), 255-257 about a 256-position edge, 335 its
    last position."""
    B, Hkv, D = 2, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        pos * 10 + rep, [(B, Hkv * rep, D), (B, S_DEC, Hkv, D),
                         (B, S_DEC, Hkv, D)], dtype)
    ref = decode_attention_pallas(jq, jk, jv, jnp.int32(pos), bk=64,
                                  start=START, interpret=True)
    tpos = torch.tensor(pos, dtype=torch.int32)
    got = na.decode_attention_plain(tq, tk, tv, tpos, start=START)
    assert torch.equal(got, na.decode_attention_plain(tq, tk, tv, pos,
                                                      start=START))
    assert torch.equal(got, ops.decode_attention(tq, tk, tv, tpos,
                                                 start=START))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])
    if pos < START:
        assert (got == 0).all()


# ----------------------------------------------------------- the chunking --
def _cut(B, S, Hkv, sms, chunk):
    """(blocks, positions the busiest SM streams) at this chunk."""
    blocks = B * Hkv * -(-S // chunk)
    return blocks, -(-blocks // sms) * chunk


@pytest.mark.parametrize("B,S,Hkv,sms,per_sm", [
    (4, 2080, 8, 132, 4),    # qwen3-4b's decode
    (4, 2080, 8, 132, 3),
    (4, 272, 16, 132, 4),    # qwen2-moe's
    (1, 3, 1, 132, 4),       # a slice shorter than one step
    (8, 100000, 8, 132, 1),  # fewer slots than (sequence, kv head) pairs
    (64, 512, 8, 132, 3),
    (2, 4097, 2, 114, 2),
    (1, 300, 2, 132, 4),     # too few positions to give each SM two blocks
])
def test_decode_chunk_balances_the_busiest_sm(B, S, Hkv, sms, per_sm):
    """Whole steps, the slice covered, one wave of resident blocks; two
    blocks an SM where some cut gives that; and no other such cut leaves
    the busiest SM fewer positions."""
    chunk = na.decode_chunk(B, S, Hkv, sms, per_sm)
    ns = -(-S // chunk)
    assert chunk % na.DECODE_STEP == 0 and ns * chunk >= S
    wave = max(sms * per_sm, B * Hkv)
    others = [c for c in range(na.DECODE_STEP, -(-S // na.DECODE_STEP)
                               * na.DECODE_STEP + 1, na.DECODE_STEP)
              if _cut(B, S, Hkv, sms, c)[0] <= wave]
    assert chunk in others
    full = [c for c in others
            if _cut(B, S, Hkv, sms, c)[0] >= min(per_sm, 2) * sms]
    assert (chunk in full) == bool(full)
    busiest = _cut(B, S, Hkv, sms, chunk)[1]
    assert all(_cut(B, S, Hkv, sms, c)[1] >= busiest for c in full or others)


def test_decode_chunk_at_the_served_shapes():
    """qwen3-4b: 32 (sequence, kv head) pairs, 11 chunks of 192 positions
    (352 blocks, at most 3 an SM, where 13 of 160 would put 4 on some and
    4 of 544 would leave one an SM); qwen2-moe: 64 pairs, 5 chunks of 64
    (320 blocks)."""
    assert na.decode_chunk(4, 2080, 8, 132, 4) == 192
    assert na.decode_chunk(4, 272, 16, 132, 4) == 64


@pytest.mark.parametrize("B,nb,bs,Hkv,sms,per_sm", [
    (4, 132, 16, 8, 132, 4),     # qwen3-4b's paged decode
    (4, 132, 16, 8, 132, 3),
    (4, 300, 8, 8, 132, 4),      # a table wider than 256 columns
    (5, 190, 8, 8, 132, 4),
    (5, 26, 64, 1, 132, 4),      # a block wider than a step
    (3, 7, 48, 2, 132, 4),       # a block size that does not divide 32
    (128, 300, 1, 8, 132, 4),    # more pairs than slots: capped columns
    (1, 1, 16, 1, 132, 4),       # one column
    (2, 5000, 16, 2, 114, 2),    # long tables, capped
])
def test_paged_chunk_is_whole_columns(B, nb, bs, Hkv, sms, per_sm):
    """Whole table columns and whole steps, every position a table covers
    covered, at most PAGED_MAX_COLS columns a chunk, and below that cap
    decode_chunk's rule over nb * bs positions.  The rule takes the shapes
    and the card, and nothing of pos or the tables."""
    chunk = na.paged_chunk(B, nb, bs, Hkv, sms, per_sm)
    ns = -(-(nb * bs) // chunk)
    assert chunk % bs == 0 and chunk % na.DECODE_STEP == 0
    assert chunk // bs <= na.PAGED_MAX_COLS and ns * chunk >= nb * bs
    step = math.lcm(na.DECODE_STEP, bs)
    rule = na.decode_chunk(B, nb * bs, Hkv, sms, per_sm, step)
    assert chunk == min(rule, na.PAGED_MAX_COLS * bs // step * step)
    assert list(inspect.signature(na.paged_chunk).parameters) == [
        "B", "nb", "bs", "Hkv", "sms", "per_sm"]


def test_paged_chunk_at_the_served_shape():
    """qwen3-4b's paged decode (chip_smoke.paged_decode): 132 columns of
    16 positions over 32 (sequence, kv head) pairs, 11 chunks of 12
    columns (192 positions), as the contiguous rule cuts its 2080; at 1
    position a block the chunk stops at 256 columns."""
    assert na.paged_chunk(4, 132, 16, 8, 132, 4) == 192
    assert na.paged_chunk(4, 132, 16, 8, 132, 3) == 192
    assert na.paged_chunk(128, 300, 1, 8, 132, 4) == 256


def test_paged_chunk_cap_is_the_kernels_limit():
    """The rule's cap is the table columns the CUDA kernel stages (its
    shared array, the limit its entry point checks), read from the
    source: the two cannot drift apart."""
    src = (Path(na.__file__).resolve().parents[1] / "csrc"
           / "decode_attention_paged.cu").read_text()
    limits = re.findall(r"constexpr int kMaxCols = (\d+);", src)
    assert [int(n) for n in limits] == [na.PAGED_MAX_COLS]


# --------------------------------------------------- decode with pos on ---
# the device, the slice: reduced qwen3-4b and qwen2-moe against JAX
def _cfgs(arch, dtype, **kw):
    kw = dict(n_layers=2, d_model=64, vocab=512, **kw)
    return (dataclasses.replace(jreduced(jget_config(arch), **kw),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config(arch), **kw),
                                dtype=dtype))


def _decode_both(arch, dtype, **kw):
    """The JAX prefill and 3 greedy decode steps, each called with
    ``jnp.int32(t)``; the port's the same, fed the reference's tokens,
    each step with a 0-d int32 ``pos``.  Returns both lists of logits."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(0))
    B, S, n_dec = 2, 12, 3
    toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    jc = JZ.init_cache(jcfg, B, S + n_dec, dtype=JDT[dtype])
    logits, jc = JZ.prefill(jcfg, jp, jc, jnp.asarray(toks))
    ref, fed = [np.asarray(logits)], []
    for i in range(n_dec):
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], -1)[:, None].astype(
            jnp.int32)
        fed.append(np.array(tok))
        logits, jc = JZ.decode_step(jcfg, jp, jc, tok, jnp.int32(S + i))
        ref.append(np.asarray(logits))
    params = Z.cast_params(params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                           device="cpu"), TDT[dtype])
    cache = Z.init_cache(cfg, B, S + n_dec, dtype=TDT[dtype], device="cpu")
    with torch.inference_mode():
        out, cache, _ = Z.prefill(cfg, params, cache, torch.from_numpy(toks))
        got = [out]
        for i, tok in enumerate(fed):
            out, cache, _ = Z.decode_step(
                cfg, params, cache, torch.from_numpy(tok),
                torch.tensor(S + i, dtype=torch.int32))
            got.append(out)
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen3_decode_step_tensor_pos_matches_jax(dtype):
    got, ref = _decode_both("qwen3_4b", dtype)
    for g, r in zip(got, ref):
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= SLICE_TOL[dtype] * float(np.abs(r).max()), err


def test_qwen2_moe_decode_step_tensor_pos_matches_jax():
    """The dense MoE oracle (no EP world), fp32."""
    got, ref = _decode_both("qwen2_moe_a2_7b", "float32", n_experts=8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=MOE_RTOL,
                                   atol=MOE_ATOL)


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen2_moe_a2_7b"])
def test_decode_step_int_and_tensor_pos_agree(arch):
    """An int pos becomes a tensor once, at the top: the two calls give the
    same logits and the same cache, bit for bit."""
    _, cfg = _cfgs(arch, "float32")
    params = Z.init_params(cfg, seed=1, device="cpu")
    B, S = 2, 6
    toks = torch.randint(0, 512, (B, 1), generator=torch.Generator()
                         .manual_seed(1))
    outs = []
    for pos in (4, torch.tensor(4, dtype=torch.int32)):
        cache = Z.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
        with torch.inference_mode():
            logits, cache, _ = Z.decode_step(cfg, params, cache, toks, pos)
        outs.append((logits, cache))
    (l0, c0), (l1, c1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(c0, c1):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_block_decode_writes_only_the_row_at_pos():
    """``block_decode`` writes the new K/V row at the device position
    (``index_copy_``) and leaves every other row as it was."""
    _, cfg = _cfgs("qwen3_4b", "float32")
    params = Z.init_params(cfg, seed=2, device="cpu")
    p = params["blocks"][0]
    g = torch.Generator().manual_seed(2)
    cache = {n: torch.randn((2, 8, cfg.n_kv_heads, cfg.head_dim_),
                            generator=g) for n in ("k", "v")}
    before = {n: t.clone() for n, t in cache.items()}
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    with torch.inference_mode():
        TB.block_decode(cfg, None, p, x, cache,
                        torch.tensor(5, dtype=torch.int32))
    for n in ("k", "v"):
        changed = (cache[n] != before[n]).flatten(2).any(-1)   # (B, S)
        assert changed[:, 5].all() and not changed[:, [0, 1, 2, 3, 4, 6,
                                                       7]].any()


# ------------------------------------------------------ generate's switch --
def test_generate_cuda_graph_on_the_cpu():
    """``cuda_graph`` None means no on the CPU (the eager step); True
    raises; False is the eager step."""
    _, cfg = _cfgs("qwen3_4b", "float32")
    params = Z.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cuda_graph=True"):
        serve.generate(cfg, params, prompts, 3, cuda_graph=True)
    default = serve.generate(cfg, params, prompts, 3)
    eager = serve.generate(cfg, params, prompts, 3, cuda_graph=False)
    for r in (default, eager):
        assert not r["cuda_graph"] and r["capture_s"] is None
        assert r["graph_replays"] == 0 and r["captured_launches"] is None
    assert torch.equal(default["tokens"], eager["tokens"])



def test_captured_step_goes_with_its_last_reference():
    """A captured step (``serve.CapturedStep``) replays its graph with the
    token and position in its static buffers, counts the replays, and
    holds no reference cycle: its graph is destroyed when the step is
    dropped, not by the cyclic collector at a later moment that may fall
    inside another capture (destroying a graph there invalidates it).  A
    call records one ``serve.step`` span and, inside it, one
    ``serve.graph_launch``."""
    import gc
    import weakref

    from repro_torch import tracing

    class Graph:
        replayed = 0

        def replay(self):
            Graph.replayed += 1

    graph = Graph()
    gone = weakref.ref(graph)
    tok_s = torch.zeros((2, 1), dtype=torch.int64)
    pos_s = torch.zeros((), dtype=torch.int32)
    logits_s = torch.arange(8.0).reshape(2, 4)
    step = serve.CapturedStep(graph, tok_s, pos_s, logits_s,
                              {"dropped": torch.zeros(())})
    del graph
    tracing.reset()
    logits, aux = step(torch.tensor([[5], [7]]), 9)
    spans = tracing.snapshot()["spans"]
    tracing.reset()
    assert {p: b["unprofiled"]["count"] for p, b in spans.items()} == {
        "serve.step": 1, "serve.step/serve.graph_launch": 1}
    assert step.replays == 1 and Graph.replayed == 1
    assert tok_s.tolist() == [[5], [7]] and int(pos_s) == 9
    assert torch.equal(logits, logits_s) and logits is not logits_s
    assert set(aux) == {"dropped"}
    gc.disable()
    try:
        del step
        assert gone() is None
    finally:
        gc.enable()
