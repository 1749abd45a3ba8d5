"""Port's Gaussian mixture (BASELINE config 4) against the JAX package.

Inputs are built by the reference from a seed (its ``synth_gmm_data``
and ``gmm_init_1d``) and passed as numpy.  The chain-batched potential
and gradient over a batch of unconstrained points, the split parts
tempering reads (prior potential, log-likelihood) and the per-row
log-likelihood are held to the reference's tolerances
(tests/test_hier_fused.py:80-87): in float32 value rtol 2e-5, gradient
rtol 2e-4 / atol 1e-4; in float64 (x64 scoped to the test) rtol 1e-10.
``gmm_init_1d`` is host numpy on both sides: bitwise equal.
``synth_gmm_data`` draws from torch, which cannot reproduce
``jax.random``: its recipe is checked instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.models import gmm as rgmm
from stark_tpu_torch import prepare_model_data
from stark_tpu_torch.model import flatten_model
from stark_tpu_torch.models import GaussianMixture, gmm_init_1d, synth_gmm_data

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
X64_RTOL = 1e-10


def _inputs(k, n, dtype, seed=0, points=6):
    """(raw data, unconstrained points (points, d)) from the reference:
    its synthetic mixture, its EM init, and points scattered around it."""
    data, _ = rgmm.synth_gmm_data(jax.random.PRNGKey(seed), n, k, spread=4.0)
    x = np.asarray(data["x"]).astype(dtype)
    init = rgmm.gmm_init_1d(x, k)
    rfm = ref_flatten(rgmm.GaussianMixture(k))
    z0 = np.asarray(rfm.unconstrain({kk: jnp.asarray(v) for kk, v in init.items()}))
    rs = np.random.RandomState(seed)
    z = z0[None] + 0.1 * rs.standard_normal((points, z0.size))
    return {"x": x}, z.astype(dtype)


def _reference(k, raw, z):
    """Per point: potential, gradient, prior potential, log-likelihood,
    per-row log-likelihood (the reference is single-chain: vmap)."""
    model = rgmm.GaussianMixture(k)
    rfm = ref_flatten(model)

    @jax.jit
    def one(zz, x):
        data = {"x": x}
        pe, grad = jax.value_and_grad(lambda u: rfm.potential(u, data))(zz)
        params = rfm.constrain(zz)
        return (pe, grad, rfm.potential(zz, None), model.log_lik(params, data),
                model.log_lik_rows(params, data))

    out = jax.vmap(one, in_axes=(0, None))(jnp.asarray(z), jnp.asarray(raw["x"]))
    return [np.asarray(a) for a in out]


def _port(k, raw, z):
    model = GaussianMixture(k)
    fm = flatten_model(model)
    data = prepare_model_data(model, raw, device="cpu")
    zt = torch.as_tensor(z)
    pe, grad = fm.potential_and_grad(zt, data)
    prior, ll = fm.potential_parts(zt, data)
    rows = model.log_lik_rows(fm.constrain(zt), data)
    return [t.detach().numpy() for t in (pe, grad, prior, ll, rows)]


@pytest.mark.parametrize("k", [4, 16])
def test_potential_and_gradient_match_reference_float32(k):
    raw, z = _inputs(k, 3000, np.float32)
    pe, grad, prior, ll, rows = _port(k, raw, z)
    rpe, rgrad, rprior, rll, rrows = _reference(k, raw, z)
    assert pe.dtype == np.float32 and grad.shape == z.shape
    np.testing.assert_allclose(pe, rpe, rtol=VAL_RTOL)
    np.testing.assert_allclose(grad, rgrad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(prior, rprior, rtol=VAL_RTOL, atol=1e-5)
    np.testing.assert_allclose(ll, rll, rtol=VAL_RTOL)
    # the parts are the potential: prior potential minus the likelihood
    np.testing.assert_allclose(prior - ll, pe, rtol=VAL_RTOL)
    assert rows.shape == (z.shape[0], 3000)
    np.testing.assert_allclose(rows, rrows, rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.parametrize("k", [4, 16])
def test_potential_and_gradient_match_reference_float64(k):
    with jax.enable_x64(True):
        raw, z = _inputs(k, 3000, np.float64)
        want = _reference(k, raw, z)
    got = _port(k, raw, z)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=X64_RTOL)


def test_log_lik_rows_reads_a_leading_replica_axis():
    """(R, N) rows for a batch of R points, each row the point's own
    mixture density; log_lik sums them."""
    k = 3
    raw, z = _inputs(k, 50, np.float64, points=5)
    model = GaussianMixture(k)
    fm = flatten_model(model)
    data = prepare_model_data(model, raw, device="cpu")
    params = fm.constrain(torch.as_tensor(z))
    rows = model.log_lik_rows(params, data)
    assert rows.shape == (5, 50)
    np.testing.assert_allclose(model.log_lik(params, data).numpy(), rows.sum(-1).numpy(),
                               rtol=1e-12)
    x = raw["x"]
    for r in range(5):
        w, mu, sd = (params[n][r].numpy() for n in ("weights", "mu", "sigma"))
        dens = (w / (sd * np.sqrt(2 * np.pi)) * np.exp(-0.5 * ((x[:, None] - mu) / sd) ** 2)).sum(1)
        np.testing.assert_allclose(rows[r].numpy(), np.log(dens), rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_gmm_init_1d_bitwise_equal_on_an_uneven_mixture(seed):
    """The reference's tests/test_tempering.py:131 case: N=50,000, K=16,
    spread 4, Dirichlet(5) weights."""
    data, true = rgmm.synth_gmm_data(jax.random.PRNGKey(seed), 50_000, 16, spread=4.0)
    x = np.asarray(data["x"])
    got = gmm_init_1d(x, 16)
    want = rgmm.gmm_init_1d(x, 16)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert np.abs(got["mu"] - np.asarray(true["mu"])).max() < 0.5
    assert np.all(np.diff(got["mu"]) > 0)


def test_synth_gmm_data_follows_the_recipe_and_its_seed():
    k, n, spread = 16, 50_000, 4.0
    data, true = synth_gmm_data(0, n, k, spread=spread)
    assert data["x"].shape == (n,) and data["x"].dtype == np.float32
    assert all(true[name].shape == (k,) and true[name].dtype == np.float32 for name in true)
    mu = spread * np.arange(k, dtype=np.float32)
    np.testing.assert_array_equal(true["mu"], mu - mu.mean())
    assert np.all((true["sigma"] >= 0.5) & (true["sigma"] < 1.0))
    assert np.all(true["weights"] > 0)
    np.testing.assert_allclose(true["weights"].sum(), 1.0, rtol=1e-6)
    assert np.all(np.isfinite(data["x"]))
    # rows follow the weights: the share of rows nearest each mean
    near = np.abs(data["x"][:, None] - true["mu"][None]).argmin(1)
    share = np.bincount(near, minlength=k) / n
    np.testing.assert_allclose(share, true["weights"], atol=0.01)
    again, true_again = synth_gmm_data(0, n, k, spread=spread)
    np.testing.assert_array_equal(again["x"], data["x"])
    for name in true:
        np.testing.assert_array_equal(true_again[name], true[name])
    other, _ = synth_gmm_data(1, n, k, spread=spread)
    assert not np.array_equal(other["x"], data["x"])
    # the EM init recovers every component of the port's mixture too
    init = gmm_init_1d(data["x"], k)
    assert np.abs(init["mu"] - true["mu"]).max() < 0.5
