"""Port's SG-HMC (BASELINE config 5) and Bayesian MLP against the JAX package.

`sghmc_step` from the reference's state with the reference's noise and
minibatch rows (its per-chain keys replayed into the port), with and
without a momentum refresh; the per-chain NaN freeze; the minibatch
gradient with ``lik_scale``, rows gathered along each entry's own axis;
the grad**2 preconditioner `inv_mass_from` at an odd and an even d (the
reference's ``jnp.median`` averages the two middle values); every
schedule array of `sghmc_sample`, exactly, as the reference's run feeds
them to its scans; `BayesianMLP`'s prior, likelihood, forward pass and
potential; `Posterior.functional`.

Every other ported model (its ``log_lik`` reads no per-chain batch,
`Model.chain_batched_lik` False) takes one step per chain on its own
rows, as the reference's ``vmap`` of one chain does: one step of each
against the reference's, rows and noise replayed.

Tolerances: one step from the same state, rtol 1e-5 / atol 1e-6 (float32
arithmetic in the same order on both sides, the gradient through two
autodiffs; the fused models' likelihood kernels' plain versions against
the reference's kernels in interpret mode at rtol 1e-4 / atol 1e-4, the
fused gradient tolerances of tests/test_hier_fused.py:80-87 at this
step's N/batch likelihood scale); the preconditioner and the schedules exact; the BNN's
densities rtol 1e-5 and its gradients rtol 1e-4 / atol 1e-5 (float32
sums over rows in different orders).  The conjugate-normal posterior
check mirrors tests/test_sghmc.py:73-114 at its own thresholds.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu.sghmc as rsghmc
from stark_tpu.kernels import sghmc as rks
from stark_tpu.model import Model as RefModel
from stark_tpu.model import ParamSpec as RefParamSpec
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.models import bnn as rbnn
from stark_tpu.sampler import Posterior as RefPosterior
from stark_tpu_torch import sghmc as psghmc
from stark_tpu_torch import sghmc_sample
from stark_tpu_torch.kernels import sghmc as pks
from stark_tpu_torch.model import Model, ParamSpec, flatten_model, normal_logpdf
from stark_tpu_torch.models import bnn as pbnn
from stark_tpu_torch.sampler import Posterior

STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
DENS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class ReplayNoise:
    """Hands out given arrays in order, checking each request's shape."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape, *_):
        a = np.array(self.arrays.pop(0))
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.as_tensor(a)

    normal = randint = _next

    def done(self):
        return not self.arrays


def _bnn_setup(n=200, d=3, hidden=4, batch=16, chains=3, seed=0):
    rs = np.random.RandomState(seed)
    data = {"x": rs.standard_normal((n, d)).astype(np.float32),
            "y": (rs.rand(n) < 0.5).astype(np.float32)}
    rfm = ref_flatten(rbnn.BayesianMLP(d, hidden), lik_scale=n / batch)
    pfm = flatten_model(pbnn.BayesianMLP(d, hidden), lik_scale=n / batch)
    assert pfm.ndim == rfm.ndim
    z = (0.5 * rs.standard_normal((chains, pfm.ndim))).astype(np.float32)
    return data, rfm, pfm, z


def _step_noise(key, n, batch, d, resample):
    """The draws one reference sghmc_step makes from ``key``, in the
    port's order: the refreshed momentum (when asked), the rows, the
    injected noise."""
    key_grad, key_noise, key_mom = jax.random.split(key, 3)
    out = [np.asarray(jax.random.normal(key_mom, (d,)))] if resample else []
    out.append(np.asarray(jax.random.randint(key_grad, (batch,), 0, n)))
    out.append(np.asarray(jax.random.normal(key_noise, (d,))))
    return out


def _stack_noise(keys, n, batch, d, resample):
    per = [_step_noise(k, n, batch, d, resample) for k in keys]
    return [np.stack(a) for a in zip(*per)]


@pytest.mark.parametrize("resample", [False, True])
def test_sghmc_step_matches_reference(resample):
    n, batch, C = 200, 16, 3
    data, rfm, pfm, z = _bnn_setup(n=n, batch=batch, chains=C)
    d = pfm.ndim
    rs = np.random.RandomState(1)
    r = rs.standard_normal((C, d)).astype(np.float32)
    inv_mass = (0.5 + rs.rand(C, d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    rgrad = rks.make_minibatch_grad(rfm.potential, jax.tree.map(jnp.asarray, data), batch)
    step, fric = 0.01, 2.0

    def one(key, z, r, im):
        return rks.sghmc_step(key, rks.SGHMCState(z, r), rgrad, jnp.float32(step),
                              jnp.float32(fric), im, resample_momentum=resample)

    rst, rinfo, rg = jax.vmap(one)(keys, jnp.asarray(z), jnp.asarray(r), jnp.asarray(inv_mass))
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    pgrad = pks.make_minibatch_grad(pfm.potential, tdata, batch)
    noise = ReplayNoise(_stack_noise(keys, n, batch, d, resample))
    pst, pinfo, pg = pks.sghmc_step(
        noise, pks.SGHMCState(torch.as_tensor(z), torch.as_tensor(r)), pgrad,
        torch.tensor(step), torch.tensor(fric), torch.as_tensor(inv_mass),
        resample_momentum=resample)
    assert noise.done()
    for got, want, what in ((pg, rg, "grad"), (pst.r, rst.r, "r"), (pst.z, rst.z, "z"),
                            (pinfo.kinetic_energy, rinfo.kinetic_energy, "kinetic energy"),
                            (pinfo.grad_norm, rinfo.grad_norm, "grad norm")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=what)
    np.testing.assert_array_equal(pinfo.is_divergent.numpy(), np.asarray(rinfo.is_divergent))


def test_sghmc_step_freezes_each_chain_on_nan():
    """The reference freezes a chain whose position leaves the finite
    numbers (tests/test_sghmc.py:55-70); here per chain of the batch: the
    others move on."""
    z = torch.zeros(3, 2)
    noise = ReplayNoise([np.ones((3, 2), np.float32), np.full((3, 2), 0.5, np.float32)])
    state = pks.sghmc_init(noise, z, torch.ones(3, 2))

    def grad(noise, z):
        g = torch.ones_like(z)
        g[1] = float("nan")
        return g

    new, info, _ = pks.sghmc_step(noise, state, grad, 0.01, 1.0, torch.ones(3, 2))
    assert noise.done()
    assert info.is_divergent.tolist() == [False, True, False]
    assert torch.equal(new.z[1], z[1]) and torch.equal(new.r[1], torch.zeros(2))
    assert torch.all(new.z[[0, 2]] != 0) and torch.all(torch.isfinite(new.z))


class _RefRows(RefModel):
    """One chain, rows on axis 1 of xT and axis 0 of y, a row-less
    entry: y ~ N(xT^T beta + shift, 1)."""

    def param_spec(self):
        return {"beta": RefParamSpec((2,))}

    def log_prior(self, p):
        return jnp.sum(jax.scipy.stats.norm.logpdf(p["beta"]))

    def log_lik(self, p, data):
        mu = data["xT"].T @ p["beta"] + data["shift"]
        return jnp.sum(jax.scipy.stats.norm.logpdf(data["y"], mu, 1.0))


class _PortRows(Model):
    """The same with a per-chain batch: xT (C, 2, B), y (C, B)."""

    def param_spec(self):
        return {"beta": ParamSpec((2,))}

    def log_prior(self, p):
        return normal_logpdf(p["beta"]).sum(-1)

    def log_lik(self, p, data):
        mu = torch.einsum("cd,cdb->cb", p["beta"], data["xT"]) + data["shift"]
        return normal_logpdf(data["y"], mu, 1.0).sum(-1)


def test_minibatch_grad_gathers_every_entry_along_its_row_axis():
    n, batch, C = 90, 12, 4
    rs = np.random.RandomState(4)
    data = {"xT": rs.standard_normal((2, n)).astype(np.float32),
            "y": rs.standard_normal(n).astype(np.float32),
            "shift": np.float32(0.3)}
    axes = {"xT": 1, "y": 0, "shift": -1}
    z = rs.standard_normal((C, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    rfm = ref_flatten(_RefRows(), lik_scale=n / batch)
    rgrad = rks.make_minibatch_grad(rfm.potential, jax.tree.map(jnp.asarray, data), batch,
                                    row_axes=axes)
    want = jax.vmap(rgrad)(keys, jnp.asarray(z))
    pfm = flatten_model(_PortRows(), lik_scale=n / batch)
    tdata = {"xT": torch.as_tensor(data["xT"]), "y": torch.as_tensor(data["y"]),
             "shift": torch.tensor(0.3)}
    pgrad = pks.make_minibatch_grad(pfm.potential, tdata, batch, row_axes=axes)
    idx = np.stack([np.asarray(jax.random.randint(k, (batch,), 0, n)) for k in keys])
    got = pgrad(ReplayNoise([idx]), torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the gather itself: chain c's rows of every entry, chain axis first
    g = pks.gather_rows(tdata["xT"], 1, torch.as_tensor(idx))
    assert g.shape == (C, 2, batch)
    np.testing.assert_array_equal(g[2].numpy(), data["xT"][:, idx[2]])
    # per-chain rows are not one shared batch
    assert not np.array_equal(idx[0], idx[1])


def test_minibatch_grad_is_unbiased():
    """E[minibatch grad] == full-data grad (tests/test_sghmc.py:42-52)."""
    rs = np.random.RandomState(0)
    y = torch.as_tensor((1.5 + rs.standard_normal(64)).astype(np.float32))
    full = flatten_model(NormalMean()).potential_and_grad(torch.tensor([[0.3]]), {"y": y})[1]
    fm = flatten_model(NormalMean(), lik_scale=64 / 8)
    grad_fn = pks.make_minibatch_grad(fm.potential, {"y": y}, 8)
    noise = psghmc.TorchNoise(torch.Generator().manual_seed(1))
    est = grad_fn(noise, torch.full((4000, 1), 0.3)).mean(0)
    np.testing.assert_allclose(est.numpy(), full[0].numpy(), rtol=0.05)


def _ref_inv_mass_from(damping, clip):
    """The reference's ``inv_mass_from`` (a closure inside its
    sghmc_sample), rebuilt from its code."""
    code = next(c for c in rsghmc.sghmc_sample.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "inv_mass_from")
    env = {"precond_damping": damping, "precond_clip": clip}
    cells = tuple(types.CellType(env[v]) for v in code.co_freevars)
    return types.FunctionType(code, rsghmc.__dict__, None, None, cells)


@pytest.mark.parametrize("d", [5, 6, 4225])
def test_inv_mass_from_matches_reference(d):
    rs = np.random.RandomState(d)
    v = np.exp(3.0 * rs.standard_normal((3, d))).astype(np.float32)
    v[0, : d // 2] = 1e-12  # clipping at both ends
    ref = _ref_inv_mass_from(1e-8, 100.0)
    want = np.stack([np.asarray(ref(jnp.asarray(row))) for row in v])
    got = psghmc.inv_mass_from(torch.as_tensor(v), 1e-8, 100.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(psghmc.median_midpoint(torch.as_tensor(v)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(v), axis=-1)))
    if d % 2 == 0:  # torch.median is the lower middle value, not the mean
        assert not np.array_equal(torch.median(torch.as_tensor(v), -1).values.numpy(),
                                  psghmc.median_midpoint(torch.as_tensor(v)).numpy())


class NormalMean(Model):
    """y_i ~ N(mu, 1), mu ~ N(0, prior_sd): conjugate (tests/test_sghmc.py)."""

    chain_batched_lik = True

    def __init__(self, prior_sd=10.0):
        self.prior_sd = prior_sd

    def param_spec(self):
        return {"mu": ParamSpec(())}

    def log_prior(self, p):
        return normal_logpdf(p["mu"], 0.0, self.prior_sd)

    def log_lik(self, p, data):
        y = data["y"]
        mu = p["mu"].unsqueeze(-1)
        return normal_logpdf(y, mu, 1.0).sum(-1)


class _RefNormalMean(RefModel):
    def param_spec(self):
        return {"mu": RefParamSpec(())}

    def log_prior(self, p):
        return jax.scipy.stats.norm.logpdf(p["mu"], 0.0, 10.0)

    def log_lik(self, p, data):
        return jnp.sum(jax.scipy.stats.norm.logpdf(data["y"], p["mu"], 1.0))


@pytest.mark.parametrize("kw", [
    dict(num_warmup=30, num_samples=40, thin=1, resample_every=7, cycles=0),
    dict(num_warmup=25, num_samples=60, thin=2, resample_every=50, cycles=3,
         cycle_collect_frac=0.3),
    dict(num_warmup=10, num_samples=24, thin=1, resample_every=0, cycles=4,
         cycle_collect_frac=0.5),
])
def test_schedules_match_reference_exactly(kw, monkeypatch):
    """Every per-step array the reference's run feeds its scans (refresh
    flags, the cyclic step multiplier) and the kept draw indices, read
    off its own run, against `sghmc_schedules`."""
    seen = {"scan": [], "take": []}
    scan, take = jax.lax.scan, jnp.take

    def rec_scan(f, init, xs, *a, **k):
        seen["scan"].append([np.asarray(x) for x in xs[1:]])
        return scan(f, init, xs, *a, **k)

    def rec_take(a, indices, *args, **k):
        if not isinstance(indices, jax.core.Tracer):
            seen["take"].append(np.asarray(indices))
        return take(a, indices, *args, **k)

    monkeypatch.setattr(jax.lax, "scan", rec_scan)
    monkeypatch.setattr(jnp, "take", rec_take)
    y = np.random.RandomState(0).standard_normal(64).astype(np.float32)
    post = rsghmc.sghmc_sample(_RefNormalMean(), {"y": y}, batch_size=8, chains=1,
                               step_size=1e-3, seed=0, **kw)
    monkeypatch.undo()
    (warm_flags,), (sample_flags, eps_mult) = seen["scan"]
    sched = psghmc.sghmc_schedules(kw["num_warmup"], kw["num_samples"], kw["thin"],
                                   kw["resample_every"], kw["cycles"],
                                   kw.get("cycle_collect_frac", 0.3))
    np.testing.assert_array_equal(sched.warm_flags, warm_flags)
    np.testing.assert_array_equal(sched.sample_flags, sample_flags)
    assert sched.eps_mult.dtype == eps_mult.dtype == np.float32
    np.testing.assert_array_equal(sched.eps_mult, eps_mult)
    np.testing.assert_array_equal(sched.keep, seen["take"][0])
    if kw["cycles"]:
        np.testing.assert_array_equal(sched.cycle_id, post.sample_stats["cycle_id"])
    else:
        assert sched.cycle_id is None and "cycle_id" not in post.sample_stats
    assert post.draws["mu"].shape[1] == sched.keep.size


def test_schedule_refuses_cycles_that_collect_nothing():
    with pytest.raises(ValueError, match="nothing would be collected"):
        psghmc.sghmc_schedules(10, 4, 1, 50, cycles=4, cycle_collect_frac=0.1)


def test_bnn_densities_and_forward_match_reference():
    d, h, C = 5, 7, 4
    rs = np.random.RandomState(2)
    data = {"x": rs.standard_normal((50, d)).astype(np.float32),
            "y": (rs.rand(50) < 0.5).astype(np.float32)}
    rmodel, pmodel = rbnn.BayesianMLP(d, h, weight_scale=1.3), pbnn.BayesianMLP(d, h, 1.3)
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    z = (0.6 * rs.standard_normal((C, pfm.ndim))).astype(np.float32)
    rparams = jax.vmap(rfm.constrain)(jnp.asarray(z))
    pparams = pfm.constrain(torch.as_tensor(z))
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    np.testing.assert_allclose(pmodel.log_prior(pparams).numpy(),
                               np.asarray(jax.vmap(rmodel.log_prior)(rparams)), rtol=DENS_RTOL)
    np.testing.assert_allclose(
        pmodel.log_lik(pparams, tdata).numpy(),
        np.asarray(jax.vmap(rmodel.log_lik, in_axes=(0, None))(rparams, data)), rtol=DENS_RTOL)
    rfwd = jax.vmap(rmodel.forward, in_axes=(0, None))(rparams, data["x"])
    np.testing.assert_allclose(pmodel.forward(pparams, tdata["x"]).numpy(), np.asarray(rfwd),
                               rtol=DENS_RTOL, atol=1e-6)
    # one draw, and a per-chain batch of rows
    one = {k: v[1] for k, v in pparams.items()}
    np.testing.assert_allclose(pmodel.forward(one, tdata["x"]).numpy(), np.asarray(rfwd[1]),
                               rtol=DENS_RTOL, atol=1e-6)
    xb = torch.stack([tdata["x"][:10], tdata["x"][10:20], tdata["x"][:10], tdata["x"][5:15]])
    np.testing.assert_allclose(pmodel.forward(pparams, xb)[1].numpy(),
                               np.asarray(rfwd[1, 10:20]), rtol=DENS_RTOL, atol=1e-6)
    rv, rg = jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None))(
        jnp.asarray(z), jax.tree.map(jnp.asarray, data))
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), tdata)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=DENS_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_synth_bnn_data_recipe():
    data, teacher = pbnn.synth_bnn_data(0, 4000, 6)
    assert data["x"].shape == (4000, 6) and data["y"].shape == (4000,)
    assert data["x"].dtype == data["y"].dtype == np.float32
    assert set(np.unique(data["y"])) == {0.0, 1.0}
    raw = np.tanh(data["x"] @ teacher["w1"]) @ teacher["w2"]
    logits = 2.5 * (raw - raw.mean()) / raw.std()
    # the teacher's own accuracy: the learnable signal the recipe promises
    assert 0.75 < np.mean((logits > 0) == (data["y"] > 0.5)) < 0.95
    again, _ = pbnn.synth_bnn_data(0, 4000, 6)
    np.testing.assert_array_equal(again["y"], data["y"])


def test_functional_matches_reference():
    d, h = 4, 3
    model_r, model_p = rbnn.BayesianMLP(d, h), pbnn.BayesianMLP(d, h)
    rs = np.random.RandomState(3)
    draws = {"w1": rs.standard_normal((2, 5, d, h)).astype(np.float32),
             "b1": rs.standard_normal((2, 5, h)).astype(np.float32),
             "w2": rs.standard_normal((2, 5, h)).astype(np.float32),
             "b2": rs.standard_normal((2, 5)).astype(np.float32)}
    x = rs.standard_normal((7, d)).astype(np.float32)
    want = RefPosterior(draws, {}).functional(lambda p: model_r.forward(p, jnp.asarray(x)))
    got = Posterior(draws, {}).functional(lambda p: model_p.forward(p, torch.as_tensor(x)))
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got, np.asarray(want), rtol=DENS_RTOL, atol=1e-6)


def test_sghmc_sample_runs_on_cpu():
    data, _ = pbnn.synth_bnn_data(1, 600, 4)
    kw = dict(batch_size=32, chains=3, num_warmup=40, num_samples=60, cycles=3,
              step_size=3e-3, friction=5.0, seed=2, device="cpu")
    post = sghmc_sample(pbnn.BayesianMLP(4, hidden=5), data, **kw)
    sched = psghmc.sghmc_schedules(40, 60, 1, 50, 3, 0.3)
    assert post.draws["w1"].shape == (3, sched.keep.size, 4, 5)
    assert post.draws_flat.shape == (3, sched.keep.size, 4 * 5 + 5 + 5 + 1)
    assert np.all(np.isfinite(post.draws_flat))
    st = post.sample_stats
    np.testing.assert_array_equal(st["cycle_id"], sched.cycle_id)
    assert st["kinetic_energy"].shape == (3, sched.keep.size)
    assert st["num_divergent"].shape == (3,) and int(st["num_ensemble_grad_evals"]) == 100
    again = sghmc_sample(pbnn.BayesianMLP(4, hidden=5), data, **kw)
    np.testing.assert_array_equal(again.draws_flat, post.draws_flat)
    with pytest.raises(ValueError, match="batch_size"):
        sghmc_sample(pbnn.BayesianMLP(4, hidden=5), data, **{**kw, "batch_size": 601})
    for bad, item in ((dict(mesh=object()), "A11"), (dict(trace=object()), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            sghmc_sample(pbnn.BayesianMLP(4, hidden=5), data, **kw, **bad)


@pytest.mark.slow
def test_sghmc_conjugate_normal_posterior():
    """tests/test_sghmc.py:73-94 on the port, at its thresholds."""
    y = (2.0 + np.random.RandomState(42).standard_normal(512)).astype(np.float32)
    post = sghmc_sample(NormalMean(), {"y": y}, batch_size=64, chains=4, num_warmup=500,
                        num_samples=2000, step_size=2e-3, friction=5.0, resample_every=50,
                        seed=3, device="cpu")
    prec = 1.0 / 10.0**2 + y.size
    mu_true, var_true = float(y.sum() / prec), 1.0 / prec
    draws = post.draws["mu"]
    assert post.num_divergent == 0
    assert abs(draws.mean() - mu_true) < 0.05
    # variance within 2x: SG-HMC's stationary variance is step-size biased
    assert 0.5 * var_true < draws.var() < 2.0 * var_true


def _c2_cases():
    """C2's six models and the GLMs: (reference model, port model, raw
    data).  Small: N=256 rows, 4 features, 4 groups."""
    from stark_tpu import models as rm
    from stark_tpu_torch import models as pm

    rs = np.random.RandomState(11)
    n, d, g = 256, 4, 4
    x = rs.standard_normal((n, d)).astype(np.float32)
    logit = {"x": x, "y": (rs.rand(n) < 0.5).astype(np.float32),
             "g": rs.randint(0, g, n).astype(np.int32)}
    flat = {"x": x, "y": logit["y"]}
    lmm = {k: np.asarray(v) for k, v in rm.synth_lmm_data(jax.random.PRNGKey(2), n, d, g)[0]
           .items()}
    reg = {"x": x, "y": (x @ rs.standard_normal(d) + 0.5 * rs.standard_normal(n))
           .astype(np.float32)}
    counts = {"x": x, "y": rs.poisson(np.exp(0.3 * x @ rs.standard_normal(d)))
              .astype(np.float32)}
    return {
        "Logistic": (rm.Logistic(d), pm.Logistic(d), flat),
        "FusedLogistic": (rm.FusedLogistic(d), pm.FusedLogistic(d), flat),
        "HierLogistic": (rm.HierLogistic(d, g), pm.HierLogistic(d, g), logit),
        "FusedHierLogistic": (rm.FusedHierLogistic(d, g), pm.FusedHierLogistic(d, g), logit),
        "LinearMixedModel": (rm.LinearMixedModel(d, g), pm.LinearMixedModel(d, g), lmm),
        "FusedLinearMixedModel": (rm.FusedLinearMixedModel(d, g),
                                  pm.FusedLinearMixedModel(d, g), lmm),
        "LinearRegression": (rm.LinearRegression(d), pm.LinearRegression(d), reg),
        "FusedLinearRegression": (rm.FusedLinearRegression(d), pm.FusedLinearRegression(d),
                                  reg),
        "PoissonRegression": (rm.PoissonRegression(d), pm.PoissonRegression(d), counts),
        "FusedPoissonRegression": (rm.FusedPoissonRegression(d),
                                   pm.FusedPoissonRegression(d), counts),
    }


C2_MODELS = ["Logistic", "FusedLogistic", "HierLogistic", "FusedHierLogistic",
             "LinearMixedModel", "FusedLinearMixedModel", "LinearRegression",
             "FusedLinearRegression", "PoissonRegression", "FusedPoissonRegression"]


@pytest.mark.parametrize("name", C2_MODELS)
def test_sghmc_step_per_chain_matches_reference(name):
    """One SG-HMC step of 3 chains, each on its own minibatch, against the
    reference's vmap of one chain: the same rows (along each entry's row
    axis: xT's axis 1 for a fused model) and the same noise."""
    from stark_tpu.model import prepare_model_data as ref_prepare

    rmodel, pmodel, raw = _c2_cases()[name]
    assert not pmodel.chain_batched_lik
    n, batch, C = 256, 16, 3
    rdata = ref_prepare(rmodel, raw)
    pdata = {k: torch.as_tensor(np.array(v)) for k, v in pmodel.prepare_data(raw).items()}
    raxes, paxes = rmodel.data_row_axes(rdata), pmodel.data_row_axes(pdata)
    assert paxes == raxes
    rfm = ref_flatten(rmodel, lik_scale=n / batch)
    pfm = flatten_model(pmodel, lik_scale=n / batch)
    d = pfm.ndim
    rs = np.random.RandomState(1)
    z = (0.3 * rs.standard_normal((C, d))).astype(np.float32)
    r = rs.standard_normal((C, d)).astype(np.float32)
    inv_mass = (0.5 + rs.rand(C, d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    rgrad = rks.make_minibatch_grad(rfm.potential, rdata, batch, row_axes=raxes)

    def one(key, z, r, im):
        return rks.sghmc_step(key, rks.SGHMCState(z, r), rgrad, jnp.float32(0.01),
                              jnp.float32(2.0), im)

    rst, rinfo, rg = jax.jit(jax.vmap(one))(keys, jnp.asarray(z), jnp.asarray(r),
                                            jnp.asarray(inv_mass))
    pgrad = pks.make_minibatch_grad(pfm.potential, pdata, batch, row_axes=paxes,
                                    chain_batched=False)
    noise = ReplayNoise(_stack_noise(keys, n, batch, d, False))
    pst, pinfo, pg = pks.sghmc_step(
        noise, pks.SGHMCState(torch.as_tensor(z), torch.as_tensor(r)), pgrad,
        torch.tensor(0.01), torch.tensor(2.0), torch.as_tensor(inv_mass))
    assert noise.done()
    rtol, atol = (1e-4, 1e-4) if name.startswith("Fused") else (STEP_RTOL, STEP_ATOL)
    for got, want, what in ((pg, rg, "grad"), (pst.r, rst.r, "r"), (pst.z, rst.z, "z"),
                            (pinfo.kinetic_energy, rinfo.kinetic_energy, "kinetic energy")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("name", C2_MODELS)
def test_sghmc_sample_runs_on_every_model(name):
    """sghmc_sample runs on every model the reference runs it on (each
    raised before the chain-by-chain estimator): finite draws, the same
    draws again for the same seed."""
    _, pmodel, raw = _c2_cases()[name]
    kw = dict(batch_size=16, chains=2, num_warmup=5, num_samples=5, seed=1, device="cpu")
    post = sghmc_sample(pmodel, raw, **kw)
    assert post.draws_flat.shape == (2, 5, flatten_model(pmodel).ndim)
    assert np.all(np.isfinite(post.draws_flat))
    again = sghmc_sample(pmodel, raw, **kw)
    np.testing.assert_array_equal(again.draws_flat, post.draws_flat)


def test_bnn_minibatch_gradient_stays_one_batched_call():
    """BayesianMLP reads a per-chain batch (`chain_batched_lik`): its
    estimator is the one batched call it was, bit for bit — every
    chain's rows gathered along axis 0 into (C, B, ...) and one
    autograd pass — and sghmc_sample takes that path."""
    n, batch, C = 200, 16, 3
    data, _, pfm, z = _bnn_setup(n=n, batch=batch, chains=C)
    assert pbnn.BayesianMLP.chain_batched_lik
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    idx = np.random.RandomState(6).randint(0, n, (C, batch))
    got = pks.make_minibatch_grad(pfm.potential, tdata, batch, chain_batched=True)(
        ReplayNoise([idx]), torch.as_tensor(z))
    zz = torch.as_tensor(z).requires_grad_(True)
    batched = {k: pks.gather_rows(v, 0, torch.as_tensor(idx)) for k, v in tdata.items()}
    (want,) = torch.autograd.grad(pfm.potential(zz, batched).sum(), zz)
    assert torch.equal(got, want)
    # chain by chain, the same gradient to float32 roundoff (rows summed
    # in another grouping)
    one = pks.make_minibatch_grad(pfm.potential, tdata, batch, chain_batched=False)(
        ReplayNoise([idx]), torch.as_tensor(z))
    np.testing.assert_allclose(one.numpy(), want.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    seen = []
    real = psghmc.make_minibatch_grad
    try:
        psghmc.make_minibatch_grad = lambda *a, **k: seen.append(k) or real(*a, **k)
        sghmc_sample(pbnn.BayesianMLP(3, hidden=4), data, batch_size=batch, chains=2,
                     num_warmup=2, num_samples=2, device="cpu")
        sghmc_sample(NormalMean(), {"y": data["x"][:, 0]}, batch_size=batch, chains=2,
                     num_warmup=2, num_samples=2, device="cpu")
    finally:
        psghmc.make_minibatch_grad = real
    assert [k["chain_batched"] for k in seen] == [True, True]


def _zoo_cases():
    """The rest of the zoo's row models: (reference model, port model, raw
    data, knob to set).  N=256 rows (IRT: 16 persons x 16 items), 4
    features."""
    from stark_tpu import models as rm
    from stark_tpu_torch import models as pm

    key = jax.random.PRNGKey(6)
    n, d = 256, 4

    def host(data):
        return {k: np.array(v) for k, v in data[0].items()}

    stu = host(rm.synth_studentt_data(key, n, d))
    ordd = host(rm.synth_ordinal_data(key, n, d, num_categories=4))
    irt = host(rm.synth_irt_data(key, 16, 16))
    return {
        "StudentTRegression": (rm.StudentTRegression(d), pm.StudentTRegression(d), stu),
        "FusedStudentTRegression": (rm.FusedStudentTRegression(d),
                                    pm.FusedStudentTRegression(d), stu, "STARK_FUSED_ROBUST"),
        "NegBinomialRegression": (rm.NegBinomialRegression(d), pm.NegBinomialRegression(d),
                                  host(rm.synth_negbinom_data(key, n, d))),
        "HorseshoeRegression": (rm.HorseshoeRegression(d), pm.HorseshoeRegression(d),
                                host(rm.synth_horseshoe_data(key, n, d, num_nonzero=2))),
        "OrderedLogistic": (rm.OrderedLogistic(d, 4), pm.OrderedLogistic(d, 4), ordd),
        "FusedOrderedLogistic": (rm.FusedOrderedLogistic(d, 4), pm.FusedOrderedLogistic(d, 4),
                                 ordd, "STARK_FUSED_ORDINAL"),
        "IRT2PL": (rm.IRT2PL(16, 16), pm.IRT2PL(16, 16), irt),
        # the triples layout (the knob off): the grid refuses minibatches
        "FusedIRT2PL": (rm.FusedIRT2PL(16, 16), pm.FusedIRT2PL(16, 16), irt),
    }


ZOO_ROW_MODELS = ["StudentTRegression", "FusedStudentTRegression", "NegBinomialRegression",
                  "HorseshoeRegression", "OrderedLogistic", "FusedOrderedLogistic", "IRT2PL",
                  "FusedIRT2PL"]


@pytest.mark.parametrize("name", ZOO_ROW_MODELS)
def test_zoo_sghmc_step_per_chain_matches_reference(name, monkeypatch):
    """One SG-HMC step of 3 chains of each of the rest of the zoo's row
    models (the fused ones with their knob on), each chain on its own
    minibatch, against the reference's vmap of one chain: the same rows
    along each entry's row axis and the same noise."""
    from stark_tpu.model import prepare_model_data as ref_prepare

    rmodel, pmodel, raw, *knob = _zoo_cases()[name]
    for k in knob:
        monkeypatch.setenv(k, "1")
    assert not pmodel.chain_batched_lik
    batch, C = 16, 3
    rdata = ref_prepare(rmodel, raw)
    pdata = {k: torch.as_tensor(np.array(v)) for k, v in pmodel.prepare_data(raw).items()}
    raxes, paxes = rmodel.data_row_axes(rdata), pmodel.data_row_axes(pdata)
    assert paxes == raxes
    n = next(v.shape[paxes[k]] for k, v in pdata.items())
    rfm = ref_flatten(rmodel, lik_scale=n / batch)
    pfm = flatten_model(pmodel, lik_scale=n / batch)
    d = pfm.ndim
    rs = np.random.RandomState(1)
    z = (0.3 * rs.standard_normal((C, d))).astype(np.float32)
    r = rs.standard_normal((C, d)).astype(np.float32)
    inv_mass = (0.5 + rs.rand(C, d)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    rgrad = rks.make_minibatch_grad(rfm.potential, rdata, batch, row_axes=raxes)

    def one(key, z, r, im):
        return rks.sghmc_step(key, rks.SGHMCState(z, r), rgrad, jnp.float32(0.01),
                              jnp.float32(2.0), im)

    rst, rinfo, rg = jax.jit(jax.vmap(one))(keys, jnp.asarray(z), jnp.asarray(r),
                                            jnp.asarray(inv_mass))
    pgrad = pks.make_minibatch_grad(pfm.potential, pdata, batch, row_axes=paxes,
                                    chain_batched=False)
    noise = ReplayNoise(_stack_noise(keys, n, batch, d, False))
    pst, pinfo, pg = pks.sghmc_step(
        noise, pks.SGHMCState(torch.as_tensor(z), torch.as_tensor(r)), pgrad,
        torch.tensor(0.01), torch.tensor(2.0), torch.as_tensor(inv_mass))
    assert noise.done()
    rtol, atol = (1e-4, 1e-4) if knob else (STEP_RTOL, STEP_ATOL)
    for got, want, what in ((pg, rg, "grad"), (pst.r, rst.r, "r"), (pst.z, rst.z, "z"),
                            (pinfo.kinetic_energy, rinfo.kinetic_energy, "kinetic energy")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("name", ZOO_ROW_MODELS)
def test_zoo_sghmc_sample_runs_on_every_row_model(name, monkeypatch):
    """sghmc_sample runs on each of the rest of the zoo's row models:
    finite draws, the same draws again for the same seed."""
    _, pmodel, raw, *knob = _zoo_cases()[name]
    for k in knob:
        monkeypatch.setenv(k, "1")
    kw = dict(batch_size=16, chains=2, num_warmup=5, num_samples=5, seed=1, device="cpu")
    post = sghmc_sample(pmodel, raw, **kw)
    assert post.draws_flat.shape == (2, 5, flatten_model(pmodel).ndim)
    assert np.all(np.isfinite(post.draws_flat))
    again = sghmc_sample(pmodel, raw, **kw)
    np.testing.assert_array_equal(again.draws_flat, post.draws_flat)
