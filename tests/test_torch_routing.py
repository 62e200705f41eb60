"""The port's router against ``repro.core.routing.route`` on the same
numpy inputs: 60 real experts padded to 64, aux-free bias on selection."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.core.routing import RouterParams as JRP  # noqa: E402
from repro.core.routing import route as jroute  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.routing import RouterParams, route  # noqa: E402


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
