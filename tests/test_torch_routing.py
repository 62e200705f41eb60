"""The port's router against ``repro.core.routing.route`` on the same
numpy inputs: 60 real experts padded to 64, aux-free bias on selection."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.core.routing import RouterParams as JRP  # noqa: E402
from repro.core.routing import route as jroute  # noqa: E402
from repro.core.routing import update_aux_free_bias as jupdate  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.routing import (RouterParams, route,  # noqa: E402
                                      update_aux_free_bias)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("T,d,k", [(64, 32, 4), (17, 48, 2)])
def test_route_matches_jax(T, d, k, bias):
    rng = np.random.default_rng(T + d)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, 64)) / np.sqrt(d)).astype(np.float32)
    b = ((rng.standard_normal(64) * 0.5).astype(np.float32) if bias
         else None)
    ref = jroute(JMoE(n_experts=60, top_k=k), JRP(jnp.asarray(w),
                 None if b is None else jnp.asarray(b)), jnp.asarray(x), 60)
    got = route(MoEConfig(n_experts=60, top_k=k),
                RouterParams(torch.from_numpy(w),
                             None if b is None else torch.from_numpy(b)),
                torch.from_numpy(x), 60)
    np.testing.assert_array_equal(got.top_idx.numpy(), np.asarray(ref.top_idx))
    assert (got.top_idx.numpy() < 60).all()          # pads never selected
    np.testing.assert_allclose(got.top_w.numpy(), np.asarray(ref.top_w),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(ref.probs),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got.aux_loss), float(ref.aux_loss),
                               rtol=1e-5)


def test_route_rank_stacked_equals_per_rank():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 9, 16)).astype(np.float32))
    p = RouterParams(torch.from_numpy(rng.standard_normal((16, 16)).astype(
        np.float32)), None)
    moe = MoEConfig(n_experts=12, top_k=2)
    st = route(moe, p, x, 12)
    for r in range(4):
        one = route(moe, p, x[r], 12)
        assert torch.equal(st.top_idx[r], one.top_idx)
        torch.testing.assert_close(st.top_w[r], one.top_w)
        torch.testing.assert_close(st.aux_loss[r], one.aux_loss)


@pytest.mark.parametrize("lr", [0.1, 1e-3])
def test_update_aux_free_bias_matches_jax(lr):
    """The sign-rule bias update on the same router output as the
    reference's (tests/test_routing.py:55: expert 0 overloaded, 6 real
    experts of 8): the same new bias, bit for bit; the overloaded expert's
    bias goes down, the least loaded one's up; the pads' stay.  The train
    loop's form (the loads already counted) gives the same bias."""
    rng = np.random.default_rng(55)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 8)) / 4).astype(np.float32)
    w[:, 0] = 5.0                                   # expert 0 overloaded
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    moe = MoEConfig(n_experts=6, top_k=2)
    jp = JRP(jnp.asarray(w), jnp.asarray(b))
    ref = jupdate(jp, jroute(JMoE(n_experts=6, top_k=2), jp,
                             jnp.asarray(x), 6), 6, lr=lr)
    p = RouterParams(torch.from_numpy(w), torch.from_numpy(b))
    out = route(moe, p, torch.from_numpy(x), 6)
    got = update_aux_free_bias(p, out, 6, lr=lr)
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(ref.bias))
    assert float(got.bias[0]) < b[0]
    load = planlib.expert_load(out.top_idx, 8)
    under = int(torch.argmin(load[:6]))
    assert float(got.bias[under]) > b[under]
    np.testing.assert_array_equal(got.bias.numpy()[6:], b[6:])
    by_load = update_aux_free_bias(p, load, 6, lr=lr)
    assert torch.equal(by_load.bias, got.bias)
    assert update_aux_free_bias(p._replace(bias=None), out, 6).bias is None
