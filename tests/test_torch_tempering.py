"""Port's parallel tempering (BASELINE config 4) against the JAX package.

The reference runs the whole ladder as one ``lax.scan`` whose keys torch
cannot reproduce, so its pieces are held one at a time against the
reference's own code: ``geometric_ladder`` and ``_betas_from_rho`` to
float32 rounding; the exchange (the reference's ``swap`` closure, rebuilt
from its code object) on given ll, β and uniforms, the permutation and
the accept flags bitwise and the acceptance probabilities to one float32
ulp (XLA's ``exp`` and torch's differ in the last bit on about 5 % of
float32 inputs); and one tempered transition (the reference's scan body,
rebuilt the same way around its own kernels) from the reference's carry
with its per-replica noise and swap uniforms replayed into the port, in
float64 (x64 scoped to the test): positions, caches and per-rung
dual-averaging state within 1e-10, swap flags exact.  The adaptive
ladder's log gaps are held to 1e-7: the reference computes the
Robbins–Monro gain in float32 whatever the dtype, and XLA's float32
``pow`` differs from numpy's in the last bit.

Whole runs are held by their posteriors, as the reference's own tests
hold it (tests/test_tempering.py): both modes of a bimodal location
visited; a dead ladder revived by adaptation (slow); a small GMM whose
cold-rung means lie within 4 MCSE of the reference's (slow).
"""

import os
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.adaptation import da_init as ref_da_init
from stark_tpu.kernels import hmc as rhmc
from stark_tpu.kernels import nuts as rnuts
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.models import gmm as rgmm
from stark_tpu.parallel import tempering as rtemp
from stark_tpu_torch import diagnostics, tempered_sample
from stark_tpu_torch.adaptation import DualAveragingState
from stark_tpu_torch.model import Model, ParamSpec, flatten_model, normal_logpdf
from stark_tpu_torch.models import GaussianMixture, gmm_init_1d
from stark_tpu_torch.parallel import tempering as ptemp
from test_torch_hmc import reference_hmc_noise
from test_torch_nuts import ReplayNoise, reference_nuts_noise

X64_TOL = 1e-10
RHO_ATOL = 1e-7
CHAINS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------- the reference's closures


def _code(name, parent=rtemp.tempered_sample.__code__):
    for c in parent.co_consts:
        if isinstance(c, types.CodeType):
            if c.co_name == name:
                return c
            found = _code(name, c)
            if found is not None:
                return found
    return None


def _closure(name, **env):
    """The reference's nested function ``name`` (inside its
    tempered_sample), with its free variables bound from ``env``."""
    code = _code(name)
    cells = tuple(types.CellType(env[v]) for v in code.co_freevars)
    return types.FunctionType(code, rtemp.__dict__, name, None, cells)


def _ref_swap(num_temps):
    return _closure("swap", gaps_idx=jnp.arange(num_temps - 1), num_gaps=num_temps - 1,
                    num_temps=num_temps)


def _ref_body(model, data, betas, *, kernel, adapt_ladder, target_accept=0.8,
              target_swap=0.35, ladder_adapt_rate=0.4, num_leapfrog=6, max_depth=4):
    """(the scan body, refresh) of the reference's run_chain, one chain."""
    fm = ref_flatten(model)
    prior_pot = _closure("prior_pot", fm=fm)
    loglik = _closure("loglik", fm=fm, model=model, data=data)
    refresh = _closure("refresh", vag_prior=jax.value_and_grad(prior_pot),
                       vag_ll=jax.value_and_grad(loglik))
    kstep = (partial(rnuts.nuts_step, max_depth=max_depth) if kernel == "nuts"
             else partial(rhmc.hmc_step, num_leapfrog=num_leapfrog))
    one = _closure("one_replica_step", kstep=kstep, loglik=loglik, prior_pot=prior_pot,
                   refresh=refresh)
    k = betas.shape[0]
    body = _closure(
        "body", adapt_ladder=adapt_ladder, betas=betas, cold_t0=float(1.0 / betas[0]),
        ladder_adapt_rate=ladder_adapt_rate, num_gaps=k - 1, num_temps=k,
        swap=_ref_swap(k), target_accept=target_accept, target_swap=target_swap,
        v_step=jax.vmap(one),
    )
    return body, refresh


# ------------------------------------------------------------ the ladder


@pytest.mark.parametrize("num_temps,beta_min", [(1, 0.05), (2, 0.05), (5, 0.01), (8, 0.05)])
def test_geometric_ladder_matches_reference(num_temps, beta_min):
    got = ptemp.geometric_ladder(num_temps, beta_min)
    want = np.asarray(rtemp.geometric_ladder(num_temps, beta_min))
    assert got.dtype == torch.float32 and got.shape == (num_temps,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0]) == 1.0
    assert np.all(np.diff(got.numpy()) < 0)


@pytest.mark.parametrize("num_temps", [1, 2, 5, 8])
def test_betas_from_rho_matches_reference(num_temps):
    rho = np.random.RandomState(num_temps).normal(0.0, 1.5, (CHAINS, num_temps - 1))
    rho = rho.astype(np.float32)
    t0 = 1.25
    want = np.asarray(jax.vmap(lambda r: rtemp._betas_from_rho(r, t0))(jnp.asarray(rho)))
    got = ptemp._betas_from_rho(torch.as_tensor(rho), t0).numpy()
    assert got.shape == (CHAINS, num_temps)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[:, 0], np.float32(1.0 / t0))
    assert np.all(np.diff(got, axis=1) < 0)


# ----------------------------------------------------------- the exchange


def _replica_state(rs, num_temps, d, ll_scale):
    z = rs.standard_normal((CHAINS, num_temps, d)).astype(np.float32)
    return rtemp.ReplicaState(
        z=z,
        prior_pe=rs.standard_normal((CHAINS, num_temps)).astype(np.float32),
        prior_grad=rs.standard_normal((CHAINS, num_temps, d)).astype(np.float32),
        ll=(ll_scale * rs.standard_normal((CHAINS, num_temps))).astype(np.float32),
        ll_grad=rs.standard_normal((CHAINS, num_temps, d)).astype(np.float32),
    )


@pytest.mark.parametrize("num_temps", [1, 2, 5, 8])
@pytest.mark.parametrize("parity", [0, 1])
def test_exchange_matches_reference_bitwise(num_temps, parity):
    """Chains with rungs of their own (unequal, per chain): a swap
    gathers within each chain's temperature axis only."""
    rs = np.random.RandomState(10 * num_temps + parity)
    d = 3
    state = _replica_state(rs, num_temps, d, ll_scale=4.0)
    first = parity % 2  # the first active gap
    if first < num_temps - 1:
        # one swap certain to be refused, one certain to be accepted
        state.ll[0, first + 1] = state.ll[0, first] - 1000.0
        state.ll[1, first + 1] = state.ll[1, first] + 50.0
    if num_temps == 8:
        # a pair out of support on both ends (-inf - -inf): the exchange
        # refuses it and reports a NaN acceptance where the gap is active
        state.ll[1, 4:6] = -np.inf
    gaps = np.sort(rs.uniform(0.1, 1.0, (CHAINS, num_temps)), axis=1)
    betas = (1.0 / np.cumsum(gaps, axis=1) * gaps[:, :1]).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(num_temps + 7 * parity), CHAINS)
    new, accept, active, prob = jax.vmap(_ref_swap(num_temps), in_axes=(0, 0, 0, None))(
        keys, jax.tree.map(jnp.asarray, state), jnp.asarray(betas), parity)
    u = jax.vmap(lambda k: jax.random.uniform(k, (num_temps - 1,)))(keys)

    pnew, ex = ptemp.swap(ptemp.ReplicaState(*(torch.as_tensor(x) for x in state)),
                          torch.as_tensor(betas), torch.as_tensor(np.array(u)), parity)
    for got, want in zip(pnew, new):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ex.accept.numpy(), np.asarray(accept))
    np.testing.assert_array_equal(ex.active.numpy(), np.asarray(active))
    prob = np.asarray(prob)
    got = ex.accept_prob.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(prob))
    fin = ~np.isnan(prob)
    np.testing.assert_array_max_ulp(got[fin], prob[fin], maxulp=1)
    if num_temps == 8 and parity == 0:
        assert np.isnan(got[1, 4]) and not ex.accept[1, 4]
    if first < num_temps - 1:
        assert not ex.accept[0, first] and ex.accept[1, first]


def test_ladder_step_ignores_inactive_and_non_finite_gaps():
    rho = torch.zeros(1, 4, dtype=torch.float64)
    ex = ptemp.Exchange(
        accept=torch.tensor([[True, False, False, False]]),
        active=torch.tensor([[True, False, True, True]]),
        accept_prob=torch.tensor([[0.9, 0.0, float("nan"), 0.1]], dtype=torch.float64),
    )
    new = ptemp.ladder_step(rho, ex, rnd=3, rate=0.4, target=0.35).numpy()
    gamma = 0.4 / 4.0 ** 0.6
    np.testing.assert_allclose(new, [[gamma * 0.55, 0.0, 0.0, gamma * -0.25]], rtol=1e-6)


# ------------------------------------------- one transition, in float64


def _gmm_x64(k=3, n=300):
    data, _ = rgmm.synth_gmm_data(jax.random.PRNGKey(0), n, k, spread=4.0)
    x = np.asarray(data["x"]).astype(np.float64)
    return rgmm.GaussianMixture(k), x, rgmm.gmm_init_1d(x, k)


def _port_carry(carry):
    rs, da, rho = carry
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    pda = DualAveragingState(t(da.log_step), t(da.log_avg_step), t(da.h_avg), t(da.mu),
                             int(np.asarray(da.count).flat[0]))
    return ptemp.TemperedCarry(ptemp.ReplicaState(*(t(x) for x in rs)), pda, t(rho))


def _replay(step_key, kernel, d, num_temps, max_depth, do_swap):
    """The reference body's draws for one transition, in the port's
    order: the kernel's noise for the (C * K) replica rows, chain-major,
    then the (C, K - 1) swap uniforms in a swap round."""
    key_step, key_swap = jax.vmap(jax.random.split)(step_key).transpose(1, 0, 2)
    keys = jax.vmap(lambda k: jax.random.split(k, num_temps))(key_step).reshape(-1, 2)
    arrays = (reference_nuts_noise(keys, d, max_depth) if kernel == "nuts"
              else reference_hmc_noise(keys, d))
    if do_swap:
        arrays.append(np.asarray(
            jax.vmap(lambda k: jax.random.uniform(k, (num_temps - 1,)))(key_swap)))
    return ReplayNoise(arrays)


# (warm, swap round, round number): the parities alternate with rounds
_SCHEDULE = ((True, True, 1), (True, False, 1), (True, True, 2), (False, True, 3),
             (False, False, 3))


@pytest.mark.parametrize("kernel,adapt_ladder", [("hmc", False), ("hmc", True),
                                                  ("nuts", False), ("nuts", True)])
def test_tempered_transition_matches_reference_float64(kernel, adapt_ladder):
    max_depth = 4
    betas_np = np.array([1.0, 0.55, 0.2, 0.07])  # unequal rungs
    K = betas_np.size
    with jax.enable_x64(True):
        model, x, init = _gmm_x64()
        data = {"x": jnp.asarray(x)}
        betas = jnp.asarray(betas_np)
        body, refresh = _ref_body(model, data, betas, kernel=kernel, adapt_ladder=adapt_ladder,
                                  max_depth=max_depth)
        rfm = ref_flatten(model)
        d = rfm.ndim
        z0 = np.asarray(rfm.unconstrain({k: jnp.asarray(v, jnp.float64) for k, v in init.items()}))
        rs0 = np.random.RandomState(3)
        z = z0 + 0.02 * rs0.standard_normal((CHAINS, K, d))
        ppe, pgr, ll, llg = jax.vmap(jax.vmap(refresh))(jnp.asarray(z))
        steps = rs0.uniform(0.005, 0.03, (CHAINS, K))
        rho0 = np.log(np.diff(1.0 / betas_np)) + 0.1 * rs0.standard_normal((CHAINS, K - 1))
        carry = (rtemp.ReplicaState(jnp.asarray(z), ppe, pgr, ll, llg),
                 jax.vmap(jax.vmap(ref_da_init))(jnp.asarray(steps)), jnp.asarray(rho0))
        v_body = jax.jit(jax.vmap(body, in_axes=(0, (0, None, None, None, None))))
        step_keys = jax.random.split(jax.random.PRNGKey(5), len(_SCHEDULE) * CHAINS)
        trans = []
        for i, (warm, do_swap, rnd) in enumerate(_SCHEDULE):
            key = step_keys[i * CHAINS:(i + 1) * CHAINS]
            xs = (key, jnp.asarray(do_swap), jnp.asarray(rnd % 2, jnp.int32),
                  jnp.asarray(rnd, jnp.float32), jnp.asarray(warm))
            new, out = v_body(carry, xs)
            trans.append((jax.tree.map(np.asarray, (carry, new, out)),
                          _replay(key, kernel, d, K, max_depth, do_swap)))
            carry = new

    pmodel = GaussianMixture(model.num_components)
    fm = flatten_model(pmodel)
    pdata = {"x": torch.as_tensor(x)}
    parts = ptemp.make_tempered_parts(
        fm, pdata, betas=torch.as_tensor(betas_np), kernel=kernel, num_leapfrog=6,
        max_tree_depth=max_depth, adapt_ladder=adapt_ladder)
    swaps = 0
    for (warm, do_swap, rnd), ((before, after, out), noise) in zip(_SCHEDULE, trans):
        pnew, pout = parts.step(_port_carry(before), noise, warm, do_swap, rnd % 2, rnd)
        assert noise.done()
        want = _port_carry(after)
        for got, ref in zip(pnew.rs, want.rs):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=X64_TOL, atol=X64_TOL)
        for got, ref in zip(pnew.da[:4], want.da[:4]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=X64_TOL, atol=X64_TOL)
        assert pnew.da.count == want.da.count
        np.testing.assert_allclose(pnew.rho.numpy(), want.rho.numpy(), rtol=0, atol=RHO_ATOL)
        z_cold, div, acc, pairs = out
        np.testing.assert_allclose(pout.z_cold.numpy(), z_cold, rtol=X64_TOL, atol=X64_TOL)
        np.testing.assert_array_equal(pout.divergent_cold.numpy(), div)
        np.testing.assert_array_equal(pout.accepted.numpy(), acc)
        np.testing.assert_array_equal(pout.proposed.numpy(), pairs)
        swaps += int(acc.sum())
    assert swaps > 0, "no swap was accepted: the exchange went unchecked"


# --------------------------------------------------- validation, refusal


class BimodalMean(Model):
    """Each row supports theta near +m or -m equally: the simplest
    multimodal posterior (the reference test's model, in torch)."""

    def param_spec(self):
        return {"theta": ParamSpec(())}

    def log_prior(self, p):
        return normal_logpdf(p["theta"], 0.0, 10.0)

    def log_lik(self, p, data):
        m, th = data["m"], p["theta"][:, None]
        a = normal_logpdf(data["x"], th - m, 0.5)
        b = normal_logpdf(data["x"], th + m, 0.5)
        return (torch.logaddexp(a, b) - np.log(2.0)).sum(-1)


def _bimodal_data(seed, n, m):
    """The reference test's data, built with jax.random."""
    x = 0.1 * jax.random.normal(jax.random.PRNGKey(seed), (n,))
    return {"x": np.array(x), "m": np.asarray(m, np.float32)}


def test_validation_and_refusals(monkeypatch):
    data = _bimodal_data(0, 16, 2.0)
    kw = dict(chains=1, num_temps=3, num_warmup=2, num_samples=2, device="cpu")
    with pytest.raises(ValueError, match="likelihood"):
        tempered_sample(BimodalMean(), None, **kw)
    for bad in ([1.0, 0.5, 0.5], [1.0, 0.3, 0.6]):
        with pytest.raises(ValueError, match="strictly decreasing"):
            tempered_sample(BimodalMean(), data, betas=bad, **kw)
        # the reference refuses the same ladders
        with pytest.raises(ValueError, match="strictly decreasing"):
            rtemp.tempered_sample(rgmm.GaussianMixture(2), {"x": jnp.zeros(4)}, betas=bad,
                                  chains=1, num_warmup=1, num_samples=1)
    with pytest.raises(ValueError, match="unknown kernel"):
        tempered_sample(BimodalMean(), data, kernel="chees", **kw)
    with pytest.raises(NotImplementedError, match="A11"):
        tempered_sample(BimodalMean(), data, mesh=object(), **kw)
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_world_size", lambda: 2)
        with pytest.raises(NotImplementedError, match="multi-process.*A11"):
            tempered_sample(BimodalMean(), data, **kw)
    with monkeypatch.context() as m:
        m.setenv("STARK_FAILPOINTS", "tempering.dispatch=crash")
        with pytest.raises(NotImplementedError, match="A12"):
            tempered_sample(BimodalMean(), data, **kw)
    assert "STARK_FAILPOINTS" not in os.environ


def test_one_temperature_runs_without_swaps():
    post = tempered_sample(BimodalMean(), _bimodal_data(0, 16, 2.0), chains=2, num_temps=1,
                           num_leapfrog=4, num_warmup=10, num_samples=10, swap_every=1,
                           device="cpu")
    st = post.sample_stats
    assert post.draws["theta"].shape == (2, 10)
    assert np.all(np.isfinite(post.draws["theta"]))
    assert st["swap_accept_per_pair"].shape == (2, 0)
    np.testing.assert_array_equal(st["swap_accept_rate"], [0.0, 0.0])
    np.testing.assert_array_equal(st["betas_adapted"], np.ones((2, 1), np.float32))
    assert st["step_size_per_temp"].shape == (2, 1)
    # the initial refresh, then 4 leapfrog steps and a refresh a transition
    assert int(st["num_ensemble_grad_evals"]) == 1 + 20 * 5


# ----------------------------------------------------------- whole runs


def test_tempered_visits_both_modes():
    """The reference's tests/test_tempering.py:43-65, on the port: the
    posterior over theta is bimodal at ±m; un-tempered HMC sits at one."""
    post = tempered_sample(
        BimodalMean(), _bimodal_data(0, 64, 4.0), chains=2, num_temps=6, kernel="hmc",
        num_leapfrog=8, num_warmup=300, num_samples=800, swap_every=2, seed=1, device="cpu",
    )
    draws = post.draws["theta"].reshape(-1)
    frac_pos = (draws > 0).mean()
    assert 0.15 < frac_pos < 0.85, f"stuck in one mode: frac_pos={frac_pos}"
    assert post.sample_stats["swap_accept_rate"].min() > 0.05
    assert abs(abs(draws).mean() - 4.0) < 1.0


class GaussLoc(Model):
    """d-dim Gaussian location: at d=16 a geometric ladder to β=1e-2 is
    statistically dead (the reference test's model, in torch)."""

    def __init__(self, d=16):
        self.d = d

    def param_spec(self):
        return {"theta": ParamSpec((self.d,))}

    def log_prior(self, p):
        return normal_logpdf(p["theta"], 0.0, 10.0).sum(-1)

    def log_lik(self, p, data):
        return normal_logpdf(data["x"], p["theta"][:, None, :], 1.0).sum((-2, -1))


@pytest.mark.slow
def test_adaptive_ladder_revives_dead_swaps():
    """The reference's tests/test_tempering.py:92-128, on the port."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (256, 16)))
    kwargs = dict(
        chains=2, num_temps=4, kernel="hmc", num_leapfrog=8, num_warmup=600,
        num_samples=400, swap_every=1, seed=7, betas=ptemp.geometric_ladder(4, beta_min=1e-2),
        device="cpu",
    )
    dead = tempered_sample(GaussLoc(16), {"x": x}, **kwargs)
    live = tempered_sample(GaussLoc(16), {"x": x}, adapt_ladder=True, ladder_adapt_rate=1.0,
                           **kwargs)
    dead_min = dead.sample_stats["swap_accept_per_pair"].min()
    live_min = live.sample_stats["swap_accept_per_pair"].min()
    assert dead_min < 0.02, f"ladder unexpectedly alive: {dead_min}"
    assert live_min > 0.1, f"adaptation failed to revive swaps: {live_min}"
    assert live.sample_stats["betas"].shape == (4,)
    betas = live.sample_stats["betas_adapted"]
    np.testing.assert_allclose(betas[:, 0], 1.0, rtol=1e-6)
    assert np.all(np.diff(betas, axis=1) < 0)
    post_mean = live.draws["theta"].mean(axis=(0, 1))
    expect = x.mean(axis=0) * (256 / (256 + 0.01))
    np.testing.assert_allclose(post_mean, expect, atol=0.08)


@pytest.mark.slow
def test_small_gmm_posterior_matches_reference():
    """A small config 4: GaussianMixture(4) on 2,000 rows, NUTS replicas
    with the adaptive ladder from the EM init, both packages; every
    component's mu, sigma and weight mean within 4 MCSE (the two runs'
    combined) of the reference's."""
    k, n = 4, 2000
    data, true = rgmm.synth_gmm_data(jax.random.PRNGKey(0), n, k, spread=4.0)
    x = np.array(data["x"])
    init = gmm_init_1d(x, k)
    kw = dict(chains=2, num_temps=4, kernel="nuts", max_tree_depth=5, num_warmup=200,
              num_samples=300, swap_every=5, init_params=init, adapt_ladder=True)
    ref = rtemp.tempered_sample(rgmm.GaussianMixture(k), {"x": jnp.asarray(x)}, seed=0, **kw)
    post = tempered_sample(GaussianMixture(k), {"x": x}, seed=0, device="cpu", **kw)
    assert np.all(np.isfinite(post.draws_flat))
    np.testing.assert_allclose(post.sample_stats["betas_adapted"][:, 0], 1.0, rtol=1e-6)
    for name in ("mu", "sigma", "weights"):
        a, b = np.asarray(post.draws[name]), np.asarray(ref.draws[name])
        mcse = np.hypot(diagnostics.mcse_mean(a), diagnostics.mcse_mean(b))
        gap = np.abs(a.mean((0, 1)) - b.mean((0, 1)))
        assert np.all(gap <= 4 * mcse), (name, gap, mcse)
    assert np.abs(post.draws["mu"].mean((0, 1)) - np.asarray(true["mu"])).max() < 0.3
