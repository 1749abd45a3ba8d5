"""The port's Cox proportional hazards and stochastic volatility models
(`stark_tpu_torch.models.survival`, `models.timeseries`) against the
JAX package's, and against brute force in float64.

Inputs come from the reference's recipes, ``prepare_model_data`` and
``flatten_model``, and cross as numpy through `stark_tpu_torch.interop`.
Tolerances: the zoo bands (value rtol 1e-5 / atol 1e-4; gradients
scaled per chain, rtol 1e-4 / atol 2e-5; densities rtol 1e-5 / atol
1e-5; see tests/test_torch_zoo_robust.py); the Breslow sum against an
O(N^2) float64 loop at rtol 5e-5 and the prefix log-sum-exp against
float64 at rtol 2e-5 / atol 2e-5 (tests/test_model_zoo.py:192-254); the
AR(1) scan against a sequential float64 loop at rtol 2e-5 / atol 2e-5
(:131-146); the fill from the right exactly (:284).  Posterior recovery
(slow) at the reference's thresholds (:105-128, :153-167, :231-254).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import survival as rsurv
from stark_tpu.models import timeseries as rts
from stark_tpu_torch import consensus_sample, sample, sghmc_sample
from stark_tpu_torch.model import prepare_model_data
from stark_tpu_torch.models import survival as psurv
from stark_tpu_torch.models import timeseries as pts
from test_torch_zoo_robust import check_against_reference, host

KEY = jax.random.PRNGKey(0)


def _cox_raw(ties=False, shuffle=False, n=300, d=3):
    data, _ = rsurv.synth_survival_data(jax.random.PRNGKey(9), n, d)
    data = host(data)
    if ties:  # day granularity: heavy ties
        data["t"] = (np.ceil(data["t"] * 2.0) / 2.0).astype(np.float32)
    if shuffle:
        perm = np.random.default_rng(0).permutation(n)
        data = {k: v[perm] for k, v in data.items()}
    return data


@pytest.mark.parametrize("ties,shuffle", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_coxph_matches_reference(ties, shuffle):
    """Sorted, tied and unsorted data: the port's stable sort puts the rows
    where the reference's argsort does, and the densities, potential and
    gradient agree."""
    raw = _cox_raw(ties, shuffle)
    if ties:
        assert np.unique(raw["t"]).size < raw["t"].size // 2
    rdata, pdata, _ = check_against_reference(rsurv.CoxPH(3), psurv.CoxPH(3), raw)
    assert np.all(np.diff(pdata["t"].numpy()) <= 0)


def _breslow_float64(prepared, beta):
    x = np.asarray(prepared["x"], np.float64)
    t = np.asarray(prepared["t"], np.float64)
    ev = np.asarray(prepared["event"], np.float64)
    eta = x @ beta
    ref = 0.0
    for i in range(t.shape[0]):
        if ev[i]:
            ref += eta[i] - np.logaddexp.reduce(eta[t >= t[i]])  # ties in the risk set
    return ref


@pytest.mark.parametrize("shuffle", [False, True])
def test_coxph_breslow_ties_match_bruteforce(shuffle):
    """tests/test_model_zoo.py:192-220 on the port: every tied event
    shares the full tied risk set, as an O(N^2) float64 Breslow sum, for
    sorted and unsorted input; and the reference's value."""
    raw = _cox_raw(ties=True, shuffle=shuffle, n=200)
    model = psurv.CoxPH(3)
    prepared = prepare_model_data(model, raw, device="cpu")
    betas = np.random.default_rng(10).standard_normal((3, 3))
    got = model.log_lik({"beta": torch.as_tensor(betas, dtype=torch.float32)}, prepared)
    want = [_breslow_float64({k: v.numpy() for k, v in prepared.items()}, b) for b in betas]
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5)
    rmodel = rsurv.CoxPH(3)
    rprep = ref_prepare(rmodel, raw)
    ref = [float(rmodel.log_lik({"beta": jnp.asarray(b, jnp.float32)}, rprep)) for b in betas]
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5)


def test_prefix_logsumexp_matches_float64_and_reference():
    """tests/test_model_zoo.py:178-189: the prefix log-sum-exp of 257
    values of scale 5 (float32) against float64 and the reference's."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (257,)) * 5.0, np.float64)
    got = torch.logcumsumexp(torch.as_tensor(x, dtype=torch.float32), 0).numpy()
    want = np.array([np.logaddexp.reduce(x[: i + 1]) for i in range(x.shape[0])])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ref = np.asarray(rsurv._cumulative_logsumexp(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_fill_from_right_matches_bruteforce():
    """tests/test_model_zoo.py:284-310 on the port, and the reference's
    own primitive on the same inputs."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(1, 40))
        vals = rng.standard_normal(n).astype(np.float32)
        valid = rng.random(n) < rng.random()  # varying density, 0 included
        got_v = psurv._fill_from_right(torch.as_tensor(vals), torch.as_tensor(valid)).numpy()
        exp_v, exp_h = np.empty(n, np.float32), np.empty(n, bool)
        carry_v, carry_h = 0.0, False
        for i in range(n - 1, -1, -1):
            if valid[i]:
                carry_v, carry_h = vals[i], True
            exp_v[i], exp_h[i] = carry_v, carry_h
        np.testing.assert_array_equal(got_v[exp_h], exp_v[exp_h])
        if trial < 4:  # the reference's primitive too (each length compiles anew)
            ref_v, ref_h = rsurv._fill_from_right_valid(jnp.asarray(vals), jnp.asarray(valid))
            np.testing.assert_array_equal(np.asarray(ref_h), exp_h)
            np.testing.assert_array_equal(got_v[exp_h], np.asarray(ref_v)[exp_h])
    # a chain batch of values against one mask
    vals = rng.standard_normal((3, 9)).astype(np.float32)
    valid = np.array([0, 1, 0, 0, 1, 1, 0, 0, 1], bool)
    got = psurv._fill_from_right(torch.as_tensor(vals), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, vals[:, [1, 1, 4, 4, 4, 5, 8, 8, 8]])


def _refusal(model, data):
    with pytest.raises(NotImplementedError) as e:
        model.data_row_axes(data)
    return str(e.value)


def test_coxph_refuses_row_splits_with_the_reference_message():
    raw = _cox_raw()
    got = _refusal(psurv.CoxPH(3), raw)
    assert got == _refusal(rsurv.CoxPH(3), raw) and "risk-set" in got
    with pytest.raises(NotImplementedError, match="risk-set"):
        sghmc_sample(psurv.CoxPH(3), raw, batch_size=32, chains=1, num_warmup=2, num_samples=2,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="risk-set"):
        consensus_sample(psurv.CoxPH(3), raw, num_shards=2, chains=2, kernel="hmc",
                         num_warmup=2, num_samples=2, device="cpu")


# ------------------------------------------------------------ stochastic volatility


def _sv_raw(t=64):
    data, true = rts.synth_sv_data(KEY, t)
    return host(data), true


def test_sv_matches_reference():
    raw, _ = _sv_raw()
    check_against_reference(rts.StochasticVolatility(64), pts.StochasticVolatility(64), raw,
                            scales=(0.1, 0.3, 0.6, 0.9))


@pytest.mark.parametrize("t", [64, 512])
def test_ar1_path_matches_sequential(t):
    """tests/test_model_zoo.py:131-146 at T=64 and T=512: the log-depth
    scan against a sequential float64 loop, a chain batch of phi at
    once; and the reference's scan."""
    phis = np.array([0.9, 0.99, -0.5, 0.0], np.float32)
    eps = np.random.default_rng(0).normal(size=(4, t)).astype(np.float32)
    got = pts._ar1_path(torch.as_tensor(phis), torch.as_tensor(eps)).numpy()
    for c, phi in enumerate(phis):
        h, acc = np.zeros(t), 0.0
        for i, e in enumerate(eps[c].astype(np.float64)):
            acc = float(phi) * acc + e
            h[i] = acc
        np.testing.assert_allclose(got[c], h, rtol=2e-5, atol=2e-5)
        ref = np.asarray(rts._ar1_path(jnp.asarray(phi), jnp.asarray(eps[c])))
        np.testing.assert_allclose(got[c], ref, rtol=2e-5, atol=2e-5)
    one = pts._ar1_path(torch.tensor(0.9), torch.as_tensor(eps[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_ar1_path_is_log_depth():
    """The scan takes log2 T rounds of whole-tensor operations, not a loop
    over the T steps (which would launch T times per evaluation)."""
    calls = []
    real = torch.cat
    try:
        torch.cat = lambda *a, **k: calls.append(1) or real(*a, **k)
        pts._ar1_path(torch.full((2,), 0.5), torch.ones(2, 512))
    finally:
        torch.cat = real
    assert len(calls) == 9


def test_sv_latent_h_matches_reference():
    model, rmodel = pts.StochasticVolatility(64), rts.StochasticVolatility(64)
    rs = np.random.RandomState(3)
    p = {"eps": rs.standard_normal((3, 64)).astype(np.float32),
         "mu": np.array([-1.0, 0.5, 0.0], np.float32),
         "phi": np.array([0.95, -0.3, 0.999999], np.float32),
         "sigma_h": np.array([0.25, 1.0, 0.1], np.float32)}
    got = model.latent_h({k: torch.as_tensor(v) for k, v in p.items()}).numpy()
    want = np.asarray(jax.vmap(rmodel.latent_h)({k: jnp.asarray(v) for k, v in p.items()}))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    one = model.latent_h({k: torch.as_tensor(v[1]) for k, v in p.items()}).numpy()
    np.testing.assert_allclose(one, got[1], rtol=1e-6)


def test_sv_refuses_row_splits_with_the_reference_message():
    raw, _ = _sv_raw(128)
    got = _refusal(pts.StochasticVolatility(128), raw)
    assert got == _refusal(rts.StochasticVolatility(128), raw) and "minibatched" in got
    # tests/test_model_zoo.py:115-128, and consensus's split too
    with pytest.raises(NotImplementedError, match="minibatched"):
        sghmc_sample(pts.StochasticVolatility(128), raw, batch_size=32, chains=1,
                     num_warmup=10, num_samples=10, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="minibatched"):
        consensus_sample(pts.StochasticVolatility(128), raw, num_shards=2, chains=2,
                         kernel="hmc", num_warmup=2, num_samples=2, device="cpu")


def test_synth_survival_recipe():
    data, true = psurv.synth_survival_data(0, 20_000, 3)
    again, _ = psurv.synth_survival_data(0, 20_000, 3)
    rdata, rtrue = rsurv.synth_survival_data(KEY, 2000, 3)
    assert sorted(data) == sorted(rdata) and sorted(true) == sorted(rtrue)
    for k in data:
        assert data[k].dtype == np.float32 and data[k].shape[0] == 20_000
        np.testing.assert_array_equal(again[k], data[k])
    assert np.all(np.diff(data["t"]) <= 0) and np.all(data["t"] > 0)
    assert abs(data["event"].mean() - 0.7) < 0.01
    # exponential times of hazard exp(x beta): t * exp(x beta) ~ Exp(1)
    np.testing.assert_allclose((data["t"] * np.exp(data["x"] @ true["beta"])).mean(), 1.0,
                               atol=0.03)


def test_synth_sv_recipe():
    data, true = pts.synth_sv_data(0, 512)
    again, _ = pts.synth_sv_data(0, 512)
    rdata, rtrue = rts.synth_sv_data(KEY, 512)
    assert sorted(data) == sorted(rdata) and sorted(true) == sorted(rtrue)
    assert data["y"].shape == true["h"].shape == (512,) and data["y"].dtype == np.float32
    np.testing.assert_array_equal(again["y"], data["y"])
    assert (true["mu"], true["phi"], true["sigma_h"]) == (-1.0, 0.95, 0.25)
    # the path is the AR(1) of the stated parameters: its innovations
    e = (true["h"][1:] - true["mu"]) - 0.95 * (true["h"][:-1] - true["mu"])
    assert abs(e.std() - 0.25) < 0.03
    z = data["y"] / np.exp(true["h"] / 2.0)
    assert abs(z.std() - 1.0) < 0.1


@pytest.mark.slow
@pytest.mark.parametrize("shuffle", [False, True])
def test_cox_ph_recovers_truth(shuffle):
    """tests/test_model_zoo.py:153-167 and :231-254 on the port: N=2048
    (sorted) or 1024 (shuffled), 2 chains, NUTS depth 6: R-hat < 1.05,
    beta within 0.12 (0.15 shuffled)."""
    n, d, budget = (1024, 3, 250) if shuffle else (2048, 4, 300)
    data, true = psurv.synth_survival_data(6, n, d)
    if shuffle:
        perm = np.random.default_rng(0).permutation(n)
        data = {k: v[perm] for k, v in data.items()}
    post = sample(psurv.CoxPH(d), data, chains=2, kernel="nuts", max_tree_depth=6,
                  num_warmup=budget, num_samples=budget, seed=0, device="cpu")
    assert post.max_rhat() < 1.05
    np.testing.assert_allclose(post.draws["beta"].mean((0, 1)), true["beta"],
                               atol=0.15 if shuffle else 0.12)


@pytest.mark.slow
def test_stochastic_volatility_runs_and_recovers_scale():
    """tests/test_model_zoo.py:105-128 on the port: T=512, 2 chains, NUTS
    depth 8, 500 + 500: R-hat < 1.2, mean mu within 0.8 of -1, mean phi
    > 0.7, corr(h_hat, h) > 0.5."""
    data, true = pts.synth_sv_data(4, 512)
    model = pts.StochasticVolatility(512)
    post = sample(model, data, chains=2, kernel="nuts", max_tree_depth=8, num_warmup=500,
                  num_samples=500, seed=0, device="cpu")
    assert post.max_rhat() < 1.2
    assert abs(float(post.draws["mu"].mean()) - (-1.0)) < 0.8
    assert float(post.draws["phi"].mean()) > 0.7
    h_hat = post.functional(model.latent_h).mean((0, 1))
    assert np.corrcoef(h_hat, true["h"])[0, 1] > 0.5
