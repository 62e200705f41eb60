"""The dense-GQA serving slice against the reference on the same numpy
inputs: the plain versions of the RMSNorm, flash attention and flash
decoding kernels against the JAX Pallas kernels in interpret mode,
``_qkv`` with ``qk_norm``, and reduced qwen3-4b and qwen3-1.7b (tied head)
prefill + decode against the JAX ``model_zoo``; and that the three ops
refuse a device they have no kernel for."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model_zoo as Z  # noqa: E402

# the reference's own kernel tolerances (tests/test_kernels.py:235-236)
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype, scale=1.0):
    """Normal numpy arrays times ``scale``, rounded to ``dtype``, as (jax,
    torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = (rng.standard_normal(s) * scale).astype(np.float32)
        j = jnp.asarray(a, JDT[dtype])
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(TDT[dtype])))
    return out


def _close(got, ref, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


def _pad_seq(a, n):
    """Zero rows appended on the sequence axis (1) up to length n."""
    return jnp.pad(a, [(0, 0), (0, n - a.shape[1])] + [(0, 0)] * (a.ndim - 2))


# ---------------------------------------------------------------- RMSNorm --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,eps,x_scale", [
    ((256, 128), 1e-5, 1.0),        # q/k_norm rows
    ((4, 64, 256), 1e-5, 1.0),
    ((3, 2560), 1e-6, 1e-3),        # a wide row, mean(x^2) near eps
])
def test_rmsnorm_plain_matches_pallas(dtype, shape, eps, x_scale):
    """Any x dtype with an fp32 scale, as ``cast_params`` leaves it."""
    (jx, tx), = _inputs(shape[-1], [shape], dtype, x_scale)
    scale = np.random.default_rng(1).standard_normal(shape[-1]).astype(
        np.float32)
    ref = rmsnorm_pallas(jx, jnp.asarray(scale), eps, interpret=True)
    got = ops.rmsnorm(tx, torch.from_numpy(scale), eps)
    assert got.dtype == TDT[dtype]
    _close(got, ref, dtype)


# the launch shapes rmsnorm_cuda picks (threads a row), at 132 SMs
RMSNORM_SERVED = {   # (rows, D): threads a row
    (8192, 2560): 160,   # qwen3-4b prefill ln1: a row a block, 2 vectors a thread
    (262144, 128): 4,    # its q_norm: 4 lanes a row, 4 vectors each
    (65536, 128): 4,     # its k_norm
    (4, 2560): 320,      # the decode step's ln1: a vector a thread
    (128, 128): 16,      # its q_norm: a vector a lane
    (32, 128): 16,       # its k_norm
    (4, 4096): 512,      # falcon-mamba-7b's decode ln1, ln2 and final_ln
}


@pytest.mark.parametrize("rows,D", list(RMSNORM_SERVED))
def test_rmsnorm_threads_per_row_at_the_served_shapes(rows, D):
    from repro_torch.kernels import norm_attention as na
    assert na.rmsnorm_threads_per_row(rows, D, 132) == RMSNORM_SERVED[
        (rows, D)]


@pytest.mark.parametrize("D", [4, 12, 128, 200, 256, 264, 1028, 2048, 2560,
                               4096, 8192, 40000])
@pytest.mark.parametrize("rows", [1, 4, 37, 131, 132, 8192, 262144])
def test_rmsnorm_threads_per_row_is_a_launch_the_kernel_takes(rows, D):
    """Rows of at most ``RMSNORM_ROWS_MAX_VECTORS`` vectors: a power of
    two from 4 to 32 with at most 8 vectors a lane (the rows kernel), never
    more lanes than the row has vectors beyond the first 4; wider rows: a
    multiple of 32 up to ``RMSNORM_ROW_MAX_THREADS`` (one row a block), 2
    vectors a thread, 1 with fewer rows than SMs, until the block is
    full."""
    from repro_torch.kernels import norm_attention as na
    t = na.rmsnorm_threads_per_row(rows, D, 132)
    vecs = na.rmsnorm_vectors(D)
    assert vecs == D // (8 if D % 8 == 0 else 4)
    if vecs <= na.RMSNORM_ROWS_MAX_VECTORS:
        assert t in (4, 8, 16, 32)
        assert -(-vecs // t) <= 8
        assert t == 4 or t // 2 < vecs
    else:
        per = 1 if rows < 132 else 2
        assert t % 32 == 0 and t <= na.RMSNORM_ROW_MAX_THREADS
        assert t == na.RMSNORM_ROW_MAX_THREADS or -(-vecs // t) == per
        assert t >= 32 and (t == 32 or -(-vecs // (t - 32)) > per)


def _rmsnorm_c_constants() -> dict:
    src = (Path(ops.__file__).resolve().parents[1] / "csrc"
           / "rmsnorm.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_rmsnorm_limits_are_the_kernels():
    """The wrapper's two launch limits are the CUDA source's, read from it
    (so the two cannot drift apart): the one-row-a-block kernel's largest
    block, and the widest row the several-rows kernel takes at every lane
    count it allows (its fewest lanes times the vectors a lane holds); and
    the wrapper's rule gives that kernel only lane counts it allows."""
    from repro_torch.kernels import norm_attention as na
    c = _rmsnorm_c_constants()
    assert na.RMSNORM_ROW_MAX_THREADS == c["kRowMaxThreads"]
    assert na.RMSNORM_ROWS_MAX_VECTORS == c["kRowsMinLanes"] * c[
        "kRowsMaxItems"]
    for vecs in range(1, na.RMSNORM_ROWS_MAX_VECTORS + 1):
        for rows in (1, 4, 132, 8192, 262144):
            t = na.rmsnorm_threads_per_row(rows, 8 * vecs, 132)
            assert c["kRowsMinLanes"] <= t <= c["kRowsMaxLanes"]
            assert -(-vecs // t) <= c["kRowsMaxItems"]


# -------------------------------------------------------- flash attention --
FLASH_CASES = {   # name: (B, Sq, Skv, H, Hkv, D, causal)
    "causal-rep1": (2, 128, 128, 4, 4, 32, True),
    "causal-rep2": (1, 128, 128, 4, 2, 32, True),
    "causal-rep4-d128": (1, 128, 128, 8, 2, 128, True),
    "full-rep1": (1, 128, 128, 2, 2, 32, False),
    "full-rep4-sq-ne-skv": (1, 64, 128, 4, 1, 32, False),
    # the kernels' head dims and reps of the dense configs: musicgen-large
    # (MHA, head dim 64), internvl2-26b (6 query heads a kv head)
    "causal-rep1-d64": (2, 128, 128, 4, 4, 64, True),
    "causal-rep6-d64": (1, 128, 128, 6, 1, 64, True),
    "full-rep6-d128": (1, 128, 128, 12, 2, 128, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_plain_matches_pallas(name, dtype):
    B, Sq, Skv, H, Hkv, D, causal = FLASH_CASES[name]
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        Sq + H, [(B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)], dtype)
    ref = flash_attention_pallas(jq, jk, jv, causal=causal, bq=64, bk=64,
                                 interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=causal), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_ragged(dtype):
    """S = 100 against 64-row blocks.  The Pallas kernel reads NaN past the
    end in interpret mode, so the causal case runs it on inputs padded with
    zero rows (keys past S are masked for every real query) and keeps the
    first S rows; the full case, where padded keys would count, is held to
    the reference's softmax oracle ``flash_attention_ref``."""
    B, S, H, Hkv, D = 2, 100, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        7, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    ref = flash_attention_pallas(*(_pad_seq(a, 128) for a in (jq, jk, jv)),
                                 causal=True, bq=64, bk=64,
                                 interpret=True)[:, :S]
    _close(ops.flash_attention(tq, tk, tv, causal=True), ref, dtype)
    ref = jref.flash_attention_ref(jq, jk, jv, causal=False)
    _close(ops.flash_attention(tq, tk, tv, causal=False), ref, dtype)


# --------------------------------------------------------- flash decoding --
DECODE_CASES = {  # name: (B, S, H, Hkv, D, pos, start)
    "pos0": (2, 256, 8, 2, 64, 0, 0),
    "pos-mid-block": (2, 256, 8, 2, 64, 100, 0),
    "pos-last-rep1": (2, 256, 8, 8, 64, 255, 0),
    "rep4-d128": (1, 256, 4, 1, 128, 77, 0),
    "start64": (2, 128, 8, 2, 32, 150, 64),
    "pos-before-start": (1, 128, 4, 2, 32, 10, 64),
    "rep1-d64-last": (2, 256, 4, 4, 64, 255, 0),
    "rep6-d64": (2, 256, 6, 1, 64, 77, 0),
    "rep6-d128": (1, 256, 12, 2, 128, 200, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_attention_plain_matches_pallas(name, dtype):
    B, S, H, Hkv, D, pos, start = DECODE_CASES[name]
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        S + pos, [(B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    ref = decode_attention_pallas(jq, jk, jv, pos, bk=64, start=start,
                                  interpret=True)
    got = ops.decode_attention(tq, tk, tv, pos, start=start)
    _close(got, ref, dtype)
    if pos < start:
        assert (got == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_ragged(dtype):
    """S = 200 against 64-row blocks, the last position live: the Pallas
    kernel runs on the cache padded with zero rows (past pos, so masked)."""
    B, S, H, Hkv, D, pos = 2, 200, 8, 2, 32, 199
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        11, [(B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    ref = decode_attention_pallas(jq, _pad_seq(jk, 256), _pad_seq(jv, 256),
                                  pos, bk=64, interpret=True)
    _close(ops.decode_attention(tq, tk, tv, pos), ref, dtype)


@pytest.mark.parametrize("name,args", [
    ("rmsnorm", lambda t: (t, torch.ones(4, device="meta"))),
    ("flash_attention", lambda t: (t, t, t)),
    ("decode_attention", lambda t: (t[:, 0], t, t, 3)),
])
def test_ops_refuse_a_device_without_kernel(name, args):
    t = torch.empty((1, 8, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        getattr(ops, name)(*args(t))


# ------------------------------------------------------ qk_norm, the slice --
def _cfgs(arch, dtype):
    kw = dict(n_layers=2, d_model=64, vocab=512)
    return (dataclasses.replace(jreduced(jget_config(arch), **kw),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config(arch), **kw),
                                dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_with_qk_norm_matches_jax(dtype):
    """Projections, the per-head RMSNorm of q and k (random scales), RoPE;
    the serving path's ``ops.rmsnorm`` and the training path's
    ``layers.rmsnorm`` give the same."""
    jcfg, cfg = _cfgs("qwen3_4b", dtype)
    ap = JL.attn_init(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    ap = ap._replace(q_norm=jnp.asarray(rng.uniform(0.5, 2, 16), jnp.float32),
                     k_norm=jnp.asarray(rng.uniform(0.5, 2, 16), jnp.float32))
    (jx, tx), = _inputs(5, [(2, 12, 64)], dtype)
    pos = np.arange(3, 15, dtype=np.int32)[None].repeat(2, 0)
    jcast = jax.tree.map(lambda a: a.astype(JDT[dtype]) if a.dtype ==
                         jnp.float32 and a.ndim == 3 else a, ap)
    ref = JL._qkv(jcfg, jcast, jx, jnp.asarray(pos))
    p = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        TDT[dtype] if v.ndim == 3 else torch.float32)
         for k, v in jcast._asdict().items() if v is not None}
    assert set(p) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    tpos = torch.from_numpy(pos)
    for norm in (ops.rmsnorm, L.rmsnorm):
        got = L._qkv(cfg, p, tx, tpos, norm=norm)
        for g, r in zip(got, ref):
            _close(g, r, dtype)


# fp32: the port's attention sums in another order than the reference's
# blocked jnp attention.  bf16: the reference rounds its scores to bf16
# (an einsum in bf16) where the kernels keep them fp32, so the logits of
# two layers lie up to 8 bf16 ulps of their range apart
SLICE_TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen3_1_7b"])
def test_prefill_decode_match_jax(arch, dtype):
    """Reduced qwen3 (qwen3-1.7b ties its head to the embedding) through
    ``params_from_jax``: prefill, then 3 decode steps fed the reference's
    greedy tokens; every step's logits within SLICE_TOL of their range."""
    jcfg, cfg = _cfgs(arch, dtype)
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
        logits, jc = JZ.decode_step(jcfg, jp, jc, tok, S + i)
        ref.append(np.asarray(logits))

    params = Z.cast_params(params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                           device="cpu"), TDT[dtype])
    assert ("lm_head" in params) == (arch == "qwen3_4b")
    assert params["blocks"][0]["attn"]["q_norm"].dtype == torch.float32
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
        np.testing.assert_array_equal(np.argmax(got[-1].numpy()[:, :512], -1),
                                      np.argmax(ref[-1][:, :512], -1))


def test_training_path_takes_no_serving_kernel(monkeypatch):
    """``loss_fn`` with its backward on a reduced qwen3 reaches none of the
    three ops, whose CUDA kernels would refuse a gradient: its norms and
    attention stay in the model's own tensor code, as in the reference
    (the gradients themselves: tests/test_torch_train.py)."""
    _, cfg = _cfgs("qwen3_4b", "float32")

    def refuse(*a, **k):
        raise AssertionError("the training path called a serving kernel")
    for name in ("rmsnorm", "flash_attention", "decode_attention"):
        monkeypatch.setattr(ops, name, refuse)
    params = Z.init_params(cfg, seed=0, device="cpu")
    for t in [params["embed"], *params["blocks"][0]["attn"].values()]:
        t.requires_grad_(True)
    toks = torch.randint(0, 512, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    loss, _ = Z.loss_fn(cfg, params, toks, toks)
    loss.backward()
    assert params["blocks"][0]["attn"]["q_norm"].grad is not None
