"""The port's robust, overdispersed and sparse regressions
(`stark_tpu_torch.models.robust`) and the Student-t fused op
(`ops.robust_fused`) against the JAX package's.

Inputs come from the reference's recipes (``jax.random`` keys), its
``prepare_model_data`` and ``flatten_model``, and cross as numpy through
`stark_tpu_torch.interop`.  Tolerances are the reference's for the fused
zoo (tests/test_zoo_fused.py:87-92): value rtol 1e-5 / atol 1e-4;
gradients scaled by the largest magnitude of the reference's (per chain),
rtol 1e-4 / atol 2e-5.  The log densities (float32, the same formulas)
at rtol 1e-5 / atol 1e-5; the constrained parameters at rtol 1e-6.
With the knob off the fused model is the plain one bit for bit; the
autograd backward of the fused op equals its direct value-and-grad bit
for bit.  Posterior recovery (slow) at the reference's own thresholds
(tests/test_model_zoo.py:24-74).

The helpers here (`check_against_reference`, `points`, `close_scaled`)
serve the other zoo parity files too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import robust as rrob
from stark_tpu.ops import robust_fused as rrf
from chip_smoke import PARITY_BANDS, parity_error
from stark_tpu_torch import sample
from stark_tpu_torch.interop import data_from_reference
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import robust as prob
from stark_tpu_torch.ops import robust_fused as prf
from stark_tpu_torch.parallel import consensus as pcons

VAL_RTOL, VAL_ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5
DENS_RTOL, DENS_ATOL = 1e-5, 1e-5
PARAM_RTOL = 1e-6
C = 4
KEY = jax.random.PRNGKey(0)
KNOB = "STARK_FUSED_ROBUST"


@pytest.fixture(autouse=True)
def _zoo_knobs_unset(monkeypatch):
    for k in ("STARK_FUSED_ROBUST", "STARK_FUSED_ORDINAL", "STARK_FUSED_IRT"):
        monkeypatch.delenv(k, raising=False)


def points(ndim, seed=0, scales=(0.1, 0.4, 0.8, 1.2)):
    """C chains at spreading scales about the origin of the unconstrained
    space: the typical set and excursions."""
    rs = np.random.RandomState(seed)
    return (np.asarray(scales)[:, None] * rs.standard_normal((len(scales), ndim))
            ).astype(np.float32)


def close_scaled(got, want, what):
    """The reference's zoo gradient check, chain by chain: both scaled by
    the largest magnitude of the reference's."""
    got, want = np.asarray(got), np.asarray(want)
    for c in range(want.shape[0]):
        scale = float(np.max(np.abs(want[c]))) + 1e-6
        np.testing.assert_allclose(got[c] / scale, want[c] / scale, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what}, chain {c}")


def host(data):
    return {k: np.array(v) for k, v in data.items()}


def check_against_reference(rmodel, pmodel, raw, seed=0, scales=(0.1, 0.4, 0.8, 1.2)):
    """The port's model against the reference's on the reference's
    prepared data (through interop): the port's own prepare_data gives
    the same arrays; constrained parameters, log_prior and log_lik at C
    points; the potential and its gradient.  -> (reference data, port
    data, points)."""
    rdata = ref_prepare(rmodel, raw)
    pdata = data_from_reference(host(rdata), "cpu")
    own = prepare_model_data(pmodel, host(raw), device="cpu")
    assert sorted(own) == sorted(pdata)
    for k in own:
        np.testing.assert_array_equal(own[k].numpy(), pdata[k].numpy(), err_msg=k)
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    assert pfm.ndim == rfm.ndim
    z = points(pfm.ndim, seed, scales)
    rparams = jax.vmap(rfm.constrain)(jnp.asarray(z))
    pparams = pfm.constrain(torch.as_tensor(z))
    assert sorted(pparams) == sorted(rparams)
    for k in pparams:
        np.testing.assert_allclose(pparams[k].numpy(), np.asarray(rparams[k]), rtol=PARAM_RTOL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(pmodel.log_prior(pparams).numpy(),
                               np.asarray(jax.vmap(rmodel.log_prior)(rparams)),
                               rtol=DENS_RTOL, atol=DENS_ATOL, err_msg="log_prior")
    np.testing.assert_allclose(
        pmodel.log_lik(pparams, pdata).numpy(),
        np.asarray(jax.jit(jax.vmap(rmodel.log_lik, in_axes=(0, None)))(rparams, rdata)),
        rtol=DENS_RTOL, atol=DENS_ATOL, err_msg="log_lik")
    rv, rg = jax.jit(jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None)))(
        jnp.asarray(z), rdata)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
    assert pv.shape == (len(z),) and pg.shape == z.shape
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(pg.numpy(), rg, "potential gradient")
    fused_tag = getattr(rmodel, "fused_tag", lambda: None)()
    assert getattr(pmodel, "fused_tag", lambda: None)() == fused_tag
    return rdata, pdata, z


def _raw(name):
    if "StudentT" in name:
        data, _ = rrob.synth_studentt_data(KEY, 600, 5)
    elif "NegBinomial" in name:
        data, _ = rrob.synth_negbinom_data(jax.random.PRNGKey(1), 600, 4)
    else:
        data, _ = rrob.synth_horseshoe_data(jax.random.PRNGKey(2), 600, 8, num_nonzero=3)
    return host(data)


def _models(name):
    d = _raw(name)["x"].shape[1]
    return getattr(rrob, name)(d), getattr(prob, name)(d)


CASES = [("StudentTRegression", None), ("FusedStudentTRegression", "1"),
         ("FusedStudentTRegression", None), ("NegBinomialRegression", None),
         ("HorseshoeRegression", None)]


@pytest.mark.parametrize("name,knob", CASES)
def test_model_matches_reference(name, knob, monkeypatch):
    if knob:
        monkeypatch.setenv(KNOB, knob)
    rmodel, pmodel = _models(name)
    rdata, _, _ = check_against_reference(rmodel, pmodel, _raw(name))
    assert ("xT" in rdata) == bool(knob)


def test_horseshoe_beta_matches_reference():
    rmodel, pmodel = _models("HorseshoeRegression")
    z = points(flatten_model(pmodel).ndim, seed=4)
    rparams = jax.vmap(ref_flatten(rmodel).constrain)(jnp.asarray(z))
    pparams = flatten_model(pmodel).constrain(torch.as_tensor(z))
    want = np.asarray(jax.vmap(rmodel.beta)(rparams))
    np.testing.assert_allclose(pmodel.beta(pparams).numpy(), want, rtol=1e-6)
    one = {k: v[2] for k, v in pparams.items()}  # one draw, no chain axis
    np.testing.assert_allclose(pmodel.beta(one).numpy(), want[2], rtol=1e-6)


def _op_inputs(seed=1):
    raw = _raw("StudentTRegression")
    rs = np.random.RandomState(seed)
    f32 = np.float32
    params = (rs.standard_normal((C, 5)).astype(f32), rs.uniform(0.3, 1.5, C).astype(f32),
              rs.uniform(1.5, 30.0, C).astype(f32))
    return params, (np.ascontiguousarray(raw["x"].T), raw["y"])


def test_op_value_and_three_gradients_match_reference():
    params, data = _op_inputs()
    t = [torch.as_tensor(a) for a in params + data]
    val, grads = prf.studentt_loglik_value_and_grad(*t)
    assert val.shape == (C,) and [g.shape for g in grads] == [(C, 5), (C,), (C,)]
    for c in range(C):
        rval, rgrads = rrf.studentt_loglik_value_and_grad(
            *[jnp.asarray(p[c]) for p in params], *[jnp.asarray(a) for a in data])
        np.testing.assert_allclose(val[c].numpy(), np.asarray(rval), rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        want = np.concatenate([np.ravel(g) for g in rgrads])
        got = np.concatenate([g[c].reshape(-1).numpy() for g in grads])
        close_scaled(got[None], want[None], f"d/d(beta, sigma, nu), chain {c}")
    # one chain without the chain axis: the same numbers
    v1, g1 = prf.studentt_loglik_value_and_grad(*[p[1] for p in t[:3]], *t[3:])
    np.testing.assert_allclose(v1.numpy(), val[1].numpy(), rtol=1e-6)
    for a, b in zip(g1, grads):
        np.testing.assert_allclose(a.numpy(), b[1].numpy(), rtol=1e-5, atol=1e-5)


def test_op_gradients_match_autograd_of_the_plain_density():
    """Each analytic gradient (the tail weight w = (nu + 1)/(nu + z^2)
    shared by all three) against autograd through the plain density."""
    params, data = _op_inputs(seed=5)
    leaves = [torch.as_tensor(p).requires_grad_(True) for p in params]
    xT, y = (torch.as_tensor(a) for a in data)
    beta, sigma, nu = leaves
    ll = prob._studentt_logpdf(y, nu[:, None], beta @ xT, sigma[:, None]).sum(-1)
    auto = torch.autograd.grad(ll.sum(), leaves)
    val, grads = prf.studentt_loglik_value_and_grad(*[p.detach() for p in leaves], xT, y)
    np.testing.assert_allclose(val.numpy(), ll.detach().numpy(), rtol=VAL_RTOL)
    got = torch.cat([grads[0], grads[1][:, None], grads[2][:, None]], -1)
    want = torch.cat([auto[0], auto[1][:, None], auto[2][:, None]], -1)
    close_scaled(got.numpy(), want.numpy(), "fused against autograd")


def test_backward_equals_direct_and_repeats_bitwise():
    params, data = _op_inputs(seed=2)
    data = [torch.as_tensor(a) for a in data]
    leaves = [torch.as_tensor(p).requires_grad_(True) for p in params]
    val = prf.studentt_loglik(*leaves, *data)
    got = torch.autograd.grad((val * torch.arange(1.0, C + 1)).sum(), leaves)
    dval, dgrads = prf.studentt_loglik_value_and_grad(*[p.detach() for p in leaves], *data)
    assert torch.equal(val.detach(), dval)
    for g, d in zip(got, dgrads):  # a cotangent other than 1 scales each chain's gradient
        w = torch.arange(1.0, C + 1).reshape((C,) + (1,) * (d.ndim - 1))
        assert torch.equal(g, w * d)
    again = prf.studentt_loglik_value_and_grad(*[p.detach() for p in leaves], *data)
    assert torch.equal(again[0], dval) and all(
        torch.equal(a, b) for a, b in zip(again[1], dgrads))


def test_fused_matches_plain_knob_on(monkeypatch):
    """tests/test_zoo_fused.py:73-91 on the port: the fused model (knob
    on) against StudentTRegression's autograd."""
    monkeypatch.setenv(KNOB, "1")
    raw = _raw("StudentTRegression")
    plain, fused = prob.StudentTRegression(5), prob.FusedStudentTRegression(5)
    fp, ff = flatten_model(plain), flatten_model(fused)
    z = torch.as_tensor(points(fp.ndim, seed=4))
    vp, gp = fp.potential_and_grad(z, prepare_model_data(plain, raw, device="cpu"))
    vf, gf = ff.potential_and_grad(z, prepare_model_data(fused, raw, device="cpu"))
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(gf.numpy(), gp.numpy(), "fused against plain")


def test_knob_off_bit_identity():
    raw = _raw("StudentTRegression")
    plain, fused = prob.StudentTRegression(5), prob.FusedStudentTRegression(5)
    assert not prf.fused_robust_enabled() and fused.fused_tag() is None
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    assert sorted(dp) == sorted(df) and "xT" not in df
    assert fused.data_row_axes(df) == plain.data_row_axes(dp) == {k: 0 for k in dp}
    z = torch.as_tensor(points(flatten_model(plain).ndim, seed=7))
    vp, gp = flatten_model(plain).potential_and_grad(z, dp)
    vf, gf = flatten_model(fused).potential_and_grad(z, df)
    assert torch.equal(vp, vf) and torch.equal(gp, gf)


def test_knob_off_after_fused_prepare(monkeypatch):
    monkeypatch.setenv(KNOB, "1")
    raw = _raw("StudentTRegression")
    plain, fused = prob.StudentTRegression(5), prob.FusedStudentTRegression(5)
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    z = torch.as_tensor(points(flatten_model(plain).ndim, seed=3))
    monkeypatch.setenv(KNOB, "0")
    assert "xT" in df and fused.data_row_axes(df)["xT"] == 1 and fused.fused_tag() is None
    v0, g0 = flatten_model(fused).potential_and_grad(z, df)
    vp, gp = flatten_model(plain).potential_and_grad(z, dp)
    np.testing.assert_allclose(v0.numpy(), vp.numpy(), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(g0.numpy(), gp.numpy(), "knob off on the fused layout")


@pytest.mark.parametrize("knob,value,item", [
    ("STARK_FUSED_X_DTYPE", "bf16", "B5"), ("STARK_FUSED_PRECISION", "high", "B6"),
])
def test_unported_knobs_refused(knob, value, item, monkeypatch):
    params, data = _op_inputs()
    t = [torch.as_tensor(a) for a in params + data]
    if knob == "STARK_FUSED_PRECISION":
        # ported (ROADMAP B6): both entries honour the knob, inside the
        # reference's band against highest, and differ from it
        def flat(grads):
            return torch.cat([grads[0], grads[1][:, None], grads[2][:, None]], -1)

        v0, g0 = prf.studentt_loglik_value_and_grad(*t)
        monkeypatch.setenv(knob, value)
        v1, g1 = prf.studentt_loglik_value_and_grad(*t)
        assert torch.equal(prf.studentt_loglik(*t), v1)
        val_rel, grad_rel = parity_error(v0, flat(g0), v1, flat(g1))
        tol_v, tol_g = PARITY_BANDS[value]
        assert val_rel <= tol_v and 0 < grad_rel <= tol_g, (val_rel, grad_rel)
        return
    # ported (ROADMAP B5): both entries stream a bf16 slab, and equal the
    # float32 entries on the rounded X bit for bit
    monkeypatch.setenv(knob, value)
    narrow = t[:3] + [t[3].to(torch.bfloat16)] + t[4:]
    rounded = t[:3] + [narrow[3].float()] + t[4:]
    v, g = prf.studentt_loglik_value_and_grad(*narrow)
    v32, g32 = prf.studentt_loglik_value_and_grad(*rounded)
    assert torch.equal(v, v32) and all(torch.equal(a, b) for a, b in zip(g, g32))
    assert torch.equal(prf.studentt_loglik(*narrow), v32)
    assert not torch.equal(rounded[3], t[3])


def ref_shards(rmodel, raw, shards):
    """The reference's prepared data split into row blocks along its row
    axes, shard axis first (its consensus layout)."""
    rprep = rmodel.prepare_data(raw)
    return jax.tree.map(
        lambda x, ax: jnp.moveaxis(jnp.asarray(x).reshape(
            x.shape[:ax] + (shards, x.shape[ax] // shards) + x.shape[ax + 1:]), ax, 0),
        rprep, rmodel.data_row_axes(rprep))


def check_shard_batch(rmodel, pmodel, raw, seed=8):
    """Consensus Monte Carlo's shard batch (parameters (S, C, ...) against
    S row blocks, one call) at S == C against the reference's vmap over
    shards: each shard's chains score that shard's rows only."""
    S = C
    assert pmodel.shard_batched_lik
    rshard = ref_shards(rmodel, raw, S)
    pshard = pcons.shard_data(pmodel, raw, S, "cpu")
    rfm = ref_flatten(rmodel, prior_scale=1.0 / S)
    pfm = flatten_model(pmodel, prior_scale=1.0 / S)
    z = (0.4 * np.random.RandomState(seed).standard_normal((S, C, pfm.ndim))).astype(np.float32)
    vg = jax.vmap(jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None)),
                  in_axes=(0, 0))
    rv, rg = vg(jnp.asarray(z), rshard)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pshard)
    assert pv.shape == (S, C) and pg.shape == (S, C, pfm.ndim)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(pg.numpy().reshape(S * C, -1), np.asarray(rg).reshape(S * C, -1),
                 "shard-batched gradient")


@pytest.mark.parametrize("name,knob", CASES)
def test_shard_batched_likelihood_matches_reference(name, knob, monkeypatch):
    if knob:
        monkeypatch.setenv(KNOB, knob)
    rmodel, pmodel = _models(name)
    check_shard_batch(rmodel, pmodel, _raw(name))


@pytest.mark.parametrize("name", ["studentt", "negbinom", "horseshoe"])
def test_synth_recipes(name):
    """The port's own recipes: the reference's shapes, dtypes and
    generating process, seeded and repeatable (the streams differ)."""
    n, d = 20_000, 6
    fn = getattr(prob, f"synth_{name}_data")
    data, true = fn(0, n, d)
    again, _ = fn(0, n, d)
    rdata, rtrue = getattr(rrob, f"synth_{name}_data")(KEY, n, d)
    assert sorted(data) == sorted(rdata) == ["x", "y"] and sorted(true) == sorted(rtrue)
    for k in data:
        assert data[k].shape == np.asarray(rdata[k]).shape and data[k].dtype == np.float32
        np.testing.assert_array_equal(again[k], data[k])
    beta = true["beta"]
    assert beta.dtype == np.float32 and beta.shape == (d,)
    resid = data["y"] - data["x"] @ beta
    if name == "studentt":
        assert true["nu"] == 4.0
        # 0.5 t_4: variance 0.25 * 4 / 2 = 0.5, and heavier tails than a normal
        assert abs(resid.var() - 0.5) < 0.06
        assert np.mean(np.abs(resid) > 4 * 0.5) > 0.005
    elif name == "negbinom":
        assert true["phi"] == 2.0 and abs(data["x"].std() - 0.3) < 0.01
        assert np.all(data["y"] == np.round(data["y"])) and data["y"].min() >= 0
        mu = np.exp(data["x"] @ beta)
        # over-dispersed: Var = mu + mu^2 / phi
        var = np.mean((data["y"] - mu) ** 2)
        np.testing.assert_allclose(var, np.mean(mu + mu**2 / 2.0), rtol=0.1)
    else:
        assert set(np.abs(beta[:5])) == {2.0} and not beta[5:].any()
        assert abs(resid.std() - 0.5) < 0.02


@pytest.mark.slow
@pytest.mark.parametrize("name", ["StudentTRegression", "FusedStudentTRegression",
                                  "NegBinomialRegression"])
def test_posterior_recovers_truth(name, monkeypatch):
    """tests/test_model_zoo.py:24-56 on the port, at its thresholds: 2
    chains, NUTS depth 6, 300 + 300, R-hat < 1.05; Student-t beta within
    0.1 and median nu < 15, the negative binomial's beta within 0.15 and
    mean phi in (1, 4); on the port's own recipes."""
    if name.startswith("Fused"):
        monkeypatch.setenv(KNOB, "1")
    if "StudentT" in name:
        data, true = prob.synth_studentt_data(0, 2048, 4, nu=4.0)
        atol = 0.1
    else:
        data, true = prob.synth_negbinom_data(1, 4096, 3, phi=2.0)
        atol = 0.15
    d = data["x"].shape[1]
    post = sample(getattr(prob, name)(d), data, chains=2, kernel="nuts", max_tree_depth=6,
                  num_warmup=300, num_samples=300, seed=0, device="cpu")
    assert post.max_rhat() < 1.05
    np.testing.assert_allclose(post.draws["beta"].mean((0, 1)), true["beta"], atol=atol)
    if "StudentT" in name:
        assert float(np.median(post.draws["nu"])) < 15.0
    else:
        assert 1.0 < float(post.draws["phi"].mean()) < 4.0


@pytest.mark.slow
def test_horseshoe_shrinks_nulls_keeps_signals():
    """tests/test_model_zoo.py:59-81 on the port: N=1024, D=32, four
    signals within 0.25, nulls shrunk below 0.1 (NUTS depth 8, 500 +
    500, 2 chains)."""
    data, true = prob.synth_horseshoe_data(2, 1024, 32, num_nonzero=4, noise=0.5)
    model = prob.HorseshoeRegression(32)
    post = sample(model, data, chains=2, kernel="nuts", max_tree_depth=8, num_warmup=500,
                  num_samples=500, seed=0, device="cpu")
    beta_hat = (post.draws["z"] * post.draws["lam"] * post.draws["tau"][..., None]).mean((0, 1))
    np.testing.assert_allclose(beta_hat[:4], true["beta"][:4], atol=0.25)
    assert np.max(np.abs(beta_hat[4:])) < 0.1
