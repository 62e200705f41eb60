"""Paged flash decoding and the KV block pool on the CPU, against the
reference on the same numpy inputs: the plain paged version against
``decode_attention_paged(interpret=True)`` on the reference's own cases
(tests/test_kernels.py:338-405), against the contiguous decoding on the
same rows, with poisoned unread blocks and an unallocated block inside
the live prefix (skipped, as the reference's kernel skips it); and the
port's ``KVBlockPool`` driven through the same grow/release calls as the
reference's.  The CUDA kernel is held against the plain version on the
card in ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.decode_attention import decode_attention_paged  # noqa: E402
from repro.serving.kv_cache import KVBlockPool as JPool  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.kv_cache import KVBlockPool  # noqa: E402

# the reference's fp32 tolerance for the paged kernel (test_kernels.py:370)
TOL = dict(rtol=2e-4, atol=2e-4)


def _problem(seed, b, h, hkv, d, bs, nb_pool, nb_seq, pos):
    """Random pools and per-sequence tables whose live prefix points at
    scattered pool blocks, -1 past it (the reference's _paged_problem)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb_pool, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb_pool, bs, hkv, d)).astype(np.float32)
    bt = np.full((b, nb_seq), -1, np.int32)
    posv = np.asarray(pos, np.int32)
    for i in range(b):
        live = posv[i] // bs + 1
        bt[i, :live] = rng.choice(nb_pool, size=live, replace=False)
    return q, kp, vp, bt, posv


def _both(q, kp, vp, bt, pos):
    ref = decode_attention_paged(*map(jnp.asarray, (q, kp, vp, bt, pos)),
                                 interpret=True)
    got = ops.decode_attention_paged(*(torch.from_numpy(np.array(a))
                                       for a in (q, kp, vp, bt, pos)))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("b,h,hkv,d,bs,pos", [
    (2, 4, 2, 32, 8, (19, 5)),        # GQA rep 2, scattered blocks
    (3, 6, 2, 32, 8, (7, 8, 23)),     # pos on and just past a block edge
    (1, 9, 3, 32, 16, (0,)),          # rep 3, one live position
    (4, 8, 2, 32, 16, (40, 63, 17, 0)),   # ragged per-sequence pos
    (2, 4, 4, 64, 16, (50, 3)),       # MHA at head dim 64 (musicgen-large)
    (2, 6, 1, 64, 8, (19, 30)),       # rep 6 at head dim 64
    (2, 12, 2, 128, 16, (40, 17)),    # rep 6 at head dim 128 (internvl2-26b)
])
def test_paged_plain_matches_pallas(b, h, hkv, d, bs, pos):
    got, ref = _both(*_problem(0, b, h, hkv, d, bs, 32, 4, pos))
    np.testing.assert_allclose(got, ref, **TOL)


def test_paged_plain_matches_contiguous():
    """An identity table gives the contiguous decoding of the same rows,
    one sequence (one host pos) at a time."""
    b, h, hkv, d, bs, nb = 2, 4, 2, 32, 8, 4
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (b * nb, bs, hkv, d)).astype(np.float32)) for _ in range(2))
    bt = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    pos = torch.tensor([bs * nb - 1, bs + 2], dtype=torch.int32)
    paged = ops.decode_attention_paged(q, kp, vp, bt, pos)
    kc, vc = kp.reshape(b, nb * bs, hkv, d), vp.reshape(b, nb * bs, hkv, d)
    for i in range(b):
        cont = ops.decode_attention(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                    int(pos[i]))
        torch.testing.assert_close(paged[i], cont[0], rtol=1e-6, atol=1e-6)


def test_paged_plain_ignores_dead_blocks():
    """Pool blocks no live position reads, and rows past pos inside the
    last live block, may hold anything (NaN included): the output does not
    change, and it still matches the reference kernel."""
    q, kp, vp, bt, pos = _problem(2, 2, 4, 2, 32, 8, 16, 4, (9, 3))
    got, ref = _both(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got, ref, **TOL)
    live = np.unique(bt[bt >= 0])
    dead = np.setdiff1d(np.arange(kp.shape[0]), live)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[dead], vp2[dead] = np.nan, np.nan
    for i in range(len(pos)):       # rows past pos in the last live block
        last = bt[i, pos[i] // 8]
        kp2[last, pos[i] % 8 + 1:] = np.nan
        vp2[last, pos[i] % 8 + 1:] = np.nan
    again = ops.decode_attention_paged(*(torch.from_numpy(a) for a in
                                         (q, kp2, vp2, bt, pos))).numpy()
    np.testing.assert_array_equal(again, got)


def test_paged_plain_skips_unallocated_blocks_as_the_kernel_does():
    """A -1 entry inside the live prefix: the reference's kernel skips it
    (decode_attention.py:119) and the port follows the kernel; the
    reference's oracle would read block 0 there.  A sequence with nothing
    live (pos -1, or only -1 entries) gives 0."""
    q, kp, vp, bt, pos = _problem(4, 3, 4, 2, 32, 8, 16, 4, (30, 20, 12))
    bt[0, 1] = -1
    bt[2, :] = -1
    got, ref = _both(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[2] == 0).all()
    pos[1] = -1
    got, ref = _both(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got[1] == 0).all()


def test_paged_bf16_rounds_as_the_contiguous_kernel():
    """In bf16 the plain paged version rounds where the contiguous one
    does (P to v's dtype before PV): the two agree exactly on the same
    rows."""
    rng = np.random.default_rng(6)
    b, h, hkv, d, bs, nb = 2, 8, 2, 64, 16, 5
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(
        np.float32)).bfloat16()
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (b * nb, bs, hkv, d)).astype(np.float32)).bfloat16()
        for _ in range(2))
    bt = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    pos = torch.tensor([70, 70], dtype=torch.int32)
    paged = ops.decode_attention_paged(q, kp, vp, bt, pos)
    cont = ops.decode_attention(q, kp.reshape(b, nb * bs, hkv, d),
                                vp.reshape(b, nb * bs, hkv, d), 70)
    assert paged.dtype == torch.bfloat16 and torch.equal(paged, cont)


def _drive(pool_cls, ops_list):
    """Apply grow/release calls; record tables, counters and the free list
    after each, and whether ``assert_consistent`` holds."""
    pool = pool_cls(n_blocks=12, block_size=4)
    trace = []
    for op, sid, n in ops_list:
        try:
            out = pool.grow(sid, n) if op == "grow" else pool.release(sid)
        except MemoryError:
            out = "exhausted"
        pool.assert_consistent()
        trace.append((out, {k: list(v) for k, v in pool.tables.items()},
                      dict(pool.lengths), list(pool.free), pool.allocs,
                      pool.frees, pool.high_water, pool.n_used,
                      pool.can_grow(0, 16), pool.blocks_needed(1, 9)))
    return pool, trace


OPS = [("grow", 0, 5), ("grow", 1, 3), ("grow", 0, 9), ("grow", 2, 16),
       ("release", 1, 0), ("grow", 1, 9), ("grow", 3, 40),
       ("release", 0, 0), ("grow", 3, 20), ("grow", 2, 17), ("grow", 0, 1)]


def test_kv_block_pool_matches_reference():
    """The same grow/release calls give the same tables, free list,
    counters and answers in both packages, including an exhausted pool;
    and a corrupted pool fails ``assert_consistent`` in both."""
    jpool, jtrace = _drive(JPool, OPS)
    pool, trace = _drive(KVBlockPool, OPS)
    assert trace == jtrace
    assert any(t[0] == "exhausted" for t in trace)
    for p in (jpool, pool):
        p.free.append(p.tables[2][0])        # a block both free and held
        with pytest.raises(AssertionError, match="both free and allocated"):
            p.assert_consistent()


def test_kv_block_pool_tables_tensor():
    """``block_tables`` lays the tables out as the paged kernel reads them:
    int32, one row a sequence, -1 past each table; LIFO reuse shows after
    a release."""
    pool = KVBlockPool(n_blocks=8, block_size=16)
    for step in range(3):                 # round-robin growth interleaves
        for sid in (0, 1):
            pool.grow(sid, 16 * (step + 1))
    assert pool.block_table(0) == [0, 2, 4] and pool.block_table(1) == [1, 3, 5]
    pool.release(0)
    pool.grow(0, 20)                      # the last block freed comes back first
    assert pool.block_table(0) == [0, 2]
    t = pool.block_tables([0, 1], width=4)
    assert t.dtype == torch.int32
    assert t.tolist() == [[0, 2, -1, -1], [1, 3, 5, -1]]
    with pytest.raises(ValueError):
        pool.block_tables([1], width=2)
