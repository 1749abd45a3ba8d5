"""Port's convergence diagnostics against the JAX package's on fixed
draws: both are float64 numpy, so they agree to ~1e-6 (rtol 1e-6 /
atol 1e-9 here)."""

import numpy as np
import pytest

from stark_tpu import diagnostics as ref
from stark_tpu_torch import diagnostics as port

RTOL, ATOL = 1e-6, 1e-9


def _draws(chains=4, n=400, event=(3,), seed=0):
    """AR(1) chains with different autocorrelations and one offset chain,
    so R-hat and ESS are away from their trivial values."""
    rs = np.random.RandomState(seed)
    x = np.zeros((chains, n) + event)
    phi = np.linspace(0.2, 0.9, int(np.prod(event))).reshape(event)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + rs.standard_normal((chains,) + event)
    x[0] += 0.3
    return x


@pytest.mark.parametrize(
    "fn", ["split_rhat", "rank_rhat", "ess", "ess_bulk", "ess_tail", "mcse_mean"]
)
@pytest.mark.parametrize("event", [(), (3,), (2, 2)])
def test_diagnostic_matches_reference(fn, event):
    x = _draws(event=event, seed=len(event))
    np.testing.assert_allclose(
        getattr(port, fn)(x), getattr(ref, fn)(x), rtol=RTOL, atol=ATOL
    )


def test_summarize_matches_reference():
    draws = {"a": _draws(event=()), "b": _draws(event=(3,), seed=1)}
    got, want = port.summarize(draws), ref.summarize(draws)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            np.testing.assert_allclose(
                got[name][k], want[name][k], rtol=RTOL, atol=ATOL, err_msg=f"{name}.{k}"
            )


def test_constant_component_has_nan_ess():
    x = _draws()
    x[..., 1] = 2.0
    assert np.isnan(port.ess(x)[1]) and np.isnan(ref.ess(x)[1])
