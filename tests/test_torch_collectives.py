"""The sequence-parallel collectives over a rank-stacked world
(``repro_torch.distributed.collectives``) against the reference's
``repro.distributed.collectives`` under ``jax.vjp``, on the CPU: forward
and backward of ``sp_gather`` and ``sp_scatter`` over meshes (data 1,
model 4) and (pod 2, data 1, model 2), and their pass-through cases (no
world, no model axis, a sequence the model axis does not divide), the
reference run in ONE subprocess with 4 fake CPU devices; and the
rank-stacked collectives under them against plain concatenations and
sums in rank order."""
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed.sharding import (DistCtx,  # noqa: E402
                                              make_dist_ctx)

pytestmark = pytest.mark.timeout(300)

KW = dict(n_layers=2, d_model=64, n_experts=8, vocab=512)
# (name, the reference's mesh shape and axes, the port's world)
WORLDS = [("model4", (1, 4), ("data", "model"), dict(model=4)),
          ("pod2x2", (2, 1, 2), ("pod", "data", "model"),
           dict(model=2, pod=2))]
# (B, S): divisible, and a sequence the model axis does not divide
# (sp_gather passes it through; the reference's sp_scatter raises there,
# its constraint to the sequence-sharded layout cannot hold it)
SHAPES = [(4, 8), (4, 6), (2, 12)]
D = 3


def _case(world, B, S, fn):
    i = [w[0] for w in WORLDS].index(world) * 100 + B * 10 + S
    rng = np.random.default_rng(i + (fn == "sp_scatter"))
    # values on a coarse grid: sums of up to four of them are exact in
    # fp32 in any order, so the comparison is bit for bit
    return (np.round(rng.standard_normal((2, B, S, D)) * 64) / 64).astype(
        np.float32)


def _cases():
    out = []
    for name, shape, _, _ in WORLDS:
        m = shape[-1]
        for B, S in SHAPES:
            for fn in ("sp_gather", "sp_scatter"):
                if fn == "sp_scatter" and S % m:
                    continue
                out.append((name, B, S, fn))
    return out


CASES = _cases()

_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config, reduced_config
    from repro.distributed import collectives as C
    from repro.distributed.sharding import make_dist_ctx
    cfg = reduced_config(get_config("qwen2_moe_a2_7b"), **%(kw)r)
    data = np.load(sys.argv[2])
    out = {}
    for name, shape, axes, _ in %(worlds)r:
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(axes),
                             devices=jax.devices()[:n])
        dist = make_dist_ctx(cfg, mesh)
        for w, B, S, fn in %(cases)r:
            if w != name:
                continue
            key = f"{w}/{B}/{S}/{fn}"
            x, ct = data[key]
            with jax.set_mesh(mesh):
                y, vjp = jax.vjp(lambda a: getattr(C, fn)(dist, a),
                                 jnp.asarray(x))
                dx, = vjp(jnp.asarray(ct))
            out[key + "/y"] = np.asarray(y)
            out[key + "/dx"] = np.asarray(dx)
        # sp_scatter on a sequence the model axis does not divide raises
        try:
            with jax.set_mesh(mesh):
                C.sp_scatter(dist, jnp.zeros((2, 7, 3)))
            out[name + "/scatter_ragged_raises"] = np.array(False)
        except ValueError:
            out[name + "/scatter_ragged_raises"] = np.array(True)
    np.savez(sys.argv[1], **out)
    print("SP-JAX-OK")
""")


@pytest.fixture(scope="module")
def jax_sp(tmp_path_factory, dist_runner):
    d = tmp_path_factory.mktemp("sp")
    np.savez(d / "in.npz", **{f"{w}/{B}/{S}/{fn}": _case(w, B, S, fn)
                              for w, B, S, fn in CASES})
    script = (f"import sys\nsys.argv[1:] = [{str(d / 'out.npz')!r}, "
              f"{str(d / 'in.npz')!r}]\n"
              + _SCRIPT % {"kw": KW, "worlds": WORLDS, "cases": CASES})
    assert "SP-JAX-OK" in dist_runner(script, n_devices=4, timeout=600)
    res = np.load(d / "out.npz")
    return {k: res[k] for k in res.files}


def _dist(world):
    kw = next(w[3] for w in WORLDS if w[0] == world)
    return make_dist_ctx(reduced_config(get_config("qwen2_moe_a2_7b"), **KW),
                         **kw)


@pytest.mark.parametrize("world,B,S,fn", CASES)
def test_matches_the_reference_under_vjp(jax_sp, world, B, S, fn):
    """Forward and backward bit for bit the reference's under ``jax.vjp``:
    ``sp_gather``'s forward the identity and its backward the model ranks'
    copies of the cotangent summed, ``sp_scatter`` the reverse; a
    sequence the model axis does not divide passes through."""
    x, ct = (torch.from_numpy(a) for a in _case(world, B, S, fn))
    xi = x.clone().requires_grad_(True)
    y = getattr(col, fn)(_dist(world), xi)
    dx, = torch.autograd.grad(y, xi, ct)
    key = f"{world}/{B}/{S}/{fn}"
    np.testing.assert_array_equal(y.detach().numpy(), jax_sp[key + "/y"])
    np.testing.assert_array_equal(dx.numpy(), jax_sp[key + "/dx"])
    M = _dist(world).axis_size("model")
    if S % M:
        assert y is xi                                  # passed through
    elif fn == "sp_gather":
        assert torch.equal(dx, ct * M)
    else:
        assert torch.equal(y.detach(), x * M)


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
def test_scatter_of_a_ragged_sequence(jax_sp, world):
    """Where the reference's sp_scatter raises (a sequence the model axis
    does not divide), the port passes x through, as both pass it through
    in sp_gather."""
    assert bool(jax_sp[world + "/scatter_ragged_raises"])
    x = torch.zeros((2, 7, 3))
    assert col.sp_scatter(_dist(world), x) is x


@pytest.mark.parametrize("fn", ["sp_gather", "sp_scatter"])
def test_pass_through_cases(fn):
    x = torch.randn(2, 8, 3)
    assert getattr(col, fn)(None, x) is x
    pods = DistCtx(ep_axes=(), ep_sizes=(), axes=("pod",), sizes=(2,))
    assert pods.model_axis is None
    assert getattr(col, fn)(pods, x) is x
    # a batch the pods do not divide (the reference's constraint to its
    # batch-sharded layout raises there)
    one = x[:1]
    assert getattr(col, fn)(_dist("pod2x2"), one) is one


@pytest.mark.parametrize("G,M", [(1, 4), (2, 2), (1, 1), (3, 2)])
def test_rank_stacked_collectives(G, M):
    """all_gather_seq: every rank of a group holds its group's shards
    concatenated; reduce_scatter_seq: rank m holds slice m of its group's
    ranks summed in rank order; gather then scatter sums M copies."""
    g = torch.Generator().manual_seed(G * 10 + M)
    b, s, D_ = 2, 3, 5
    xs = torch.randn((G, M, b, s, D_), generator=g)
    full = col.all_gather_seq(xs)
    assert full.shape == (G, M, b, M * s, D_)
    for gi in range(G):
        cat = torch.cat([xs[gi, j] for j in range(M)], 1)
        for m in range(M):
            assert torch.equal(full[gi, m], cat)
    parts = torch.randn((G, M, b, M * s, D_), generator=g)
    rs = col.reduce_scatter_seq(parts)
    assert rs.shape == (G, M, b, s, D_)
    for gi in range(G):
        acc = parts[gi, 0]
        for j in range(1, M):
            acc = acc + parts[gi, j]
        for m in range(M):
            assert torch.equal(rs[gi, m], acc[:, m * s:(m + 1) * s])
    exact = torch.round(xs * 64) / 64
    assert torch.equal(col.reduce_scatter_seq(col.all_gather_seq(exact)),
                       exact * M)
