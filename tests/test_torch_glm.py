"""The port's GLMs (`stark_tpu_torch.models.glm`) and the Poisson fused op
(`ops.glm_fused`) against the JAX package.

Inputs come from the reference's recipes (``jax.random`` keys) and cross
as numpy.  Tolerances are the reference's for the fused GLM
(tests/test_glm_fused.py:45-46): value rtol 1e-5; gradient rtol 1e-4 /
atol 1e-3.  The direct value-and-grad and the autograd backward of the
fused op agree bit for bit (the backward multiplies the saved gradient
by a cotangent of 1); the knob-off path against the plain model at rtol
1e-6 (tests/test_glm_fused.py:88-89; the same arithmetic on another
memory layout of X).  NUTS transitions from the reference's carry:
the plain model in float64 at tests/test_torch_nuts.py's float64
tolerances (rtol 1e-6 / atol 1e-8), the fused model in float32 at the
fused GLM's; decisions exact.  Posterior recovery (slow) at the
reference's own thresholds (tests/test_glm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.kernels import nuts as rnuts
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import glm as rglm
from stark_tpu.ops import glm_fused as rgf
from stark_tpu.ops import precision as rprec
from chip_smoke import PARITY_BANDS, parity_error
from stark_tpu_torch import sample
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import glm as pglm
from stark_tpu_torch.ops import glm_fused as pgf
from stark_tpu_torch.ops import precision as pprec
from stark_tpu_torch.parallel import consensus as pcons
from test_torch_nuts import (
    MAX_DEPTH,
    X64_ATOL,
    X64_RTOL,
    _check_transitions,
    _setup,
    one_torch_thread,  # noqa: F401 (autouse: one intra-op thread)
    reference_transitions,
)

VAL_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
KNOB_RTOL = 1e-6
N, D, C = 512, 6, 4

#: (model name, STARK_FUSED_GLM or None where the knob does not apply)
CASES = [
    ("LinearRegression", None),
    ("FusedLinearRegression", None),
    ("PoissonRegression", None),
    ("FusedPoissonRegression", "1"),
    ("FusedPoissonRegression", "0"),
]


def _raw(name, n=N, d=D):
    if "Linear" in name:
        data, true = rglm.synth_linreg_data(jax.random.PRNGKey(0), n, d)
    else:
        data, true = rglm.synth_poisson_data(jax.random.PRNGKey(1), n, d)
    return {k: np.asarray(v) for k, v in data.items()}, true


def _points(ndim, seed=0):
    """C chains at spreading scales: the typical set and excursions."""
    rs = np.random.RandomState(seed)
    scale = np.array([0.1, 0.4, 0.8, 1.6])[:, None]
    return (scale * rs.standard_normal((C, ndim))).astype(np.float32)


@pytest.mark.parametrize("name,knob", CASES)
def test_potential_and_grad_match_reference(name, knob, monkeypatch):
    if knob is not None:
        monkeypatch.setenv("STARK_FUSED_GLM", knob)
    raw, _ = _raw(name)
    rmodel, pmodel = getattr(rglm, name)(D), getattr(pglm, name)(D)
    rdata = ref_prepare(rmodel, raw)
    pdata = prepare_model_data(pmodel, raw, device="cpu")
    assert sorted(pdata) == sorted(rdata)
    for k in pdata:  # the same layout: X transposed for the fused models
        np.testing.assert_array_equal(pdata[k].numpy(), np.asarray(rdata[k]), err_msg=k)
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    assert pfm.ndim == rfm.ndim
    z = _points(pfm.ndim)
    rv, rg = jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None))(
        jnp.asarray(z), rdata)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if name.startswith("Fused"):
        assert pmodel.fused_tag() == rmodel.fused_tag()


@pytest.mark.parametrize("name", ["LinearRegression", "PoissonRegression"])
def test_fused_matches_plain(name):
    """The fused variant against the plain model of the port, on the same
    points (tests/test_glm_fused.py:34-46)."""
    raw, _ = _raw(name)
    plain, fused = getattr(pglm, name)(D), getattr(pglm, "Fused" + name)(D)
    fp, ff = flatten_model(plain), flatten_model(fused)
    z = torch.as_tensor(_points(fp.ndim, seed=2))
    vp, gp = fp.potential_and_grad(z, prepare_model_data(plain, raw, device="cpu"))
    vf, gf = ff.potential_and_grad(z, prepare_model_data(fused, raw, device="cpu"))
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=VAL_RTOL)
    np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_clip_band_gradient_masked():
    """Rows whose predictor lies beyond ±30 give no gradient, as autograd
    through the clamp (tests/test_glm_fused.py:49-64)."""
    xt = np.array([[1.0, 40.0, -40.0, 2.0]], np.float32)
    y = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    beta = np.ones(1, np.float32)
    _, rgrad = rgf.poisson_loglik_value_and_grad(jnp.asarray(beta), jnp.asarray(xt),
                                                 jnp.asarray(y))
    ll, grad = pgf.poisson_loglik_value_and_grad(torch.as_tensor(beta), torch.as_tensor(xt),
                                                 torch.as_tensor(y))
    b = torch.ones(1, requires_grad=True)
    eta = torch.clamp(b @ torch.as_tensor(xt), -30.0, 30.0)
    yt = torch.as_tensor(y)
    (auto,) = torch.autograd.grad((yt * eta - torch.exp(eta) - torch.lgamma(yt + 1)).sum(), b)
    np.testing.assert_allclose(grad.numpy(), auto.numpy(), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=1e-5)
    assert np.isfinite(float(ll))
    # the band is strict, as the reference's: |eta| == 30 is outside
    eta_raw = torch.tensor([-30.0, -29.5, 0.0, 30.0, 31.0])
    eta, inside = pprec.clip_band(eta_raw, 30.0)
    reta, rinside = rprec.clip_band(jnp.asarray(eta_raw.numpy()), 30.0)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(rinside))
    np.testing.assert_array_equal(eta.numpy(), np.asarray(reta))
    assert inside.tolist() == [0.0, 1.0, 1.0, 0.0, 0.0] and inside.dtype == torch.float32


def test_one_pass_backward_equals_direct_value_and_grad():
    """Autograd through the fused op chains the gradient its forward pass
    saved: exactly the direct entry's, chain by chain and for one chain."""
    raw, _ = _raw("PoissonRegression")
    xT = torch.as_tensor(np.ascontiguousarray(raw["x"].T))
    y = torch.as_tensor(raw["y"])
    beta = torch.as_tensor(0.1 * _points(D, seed=3))
    v_direct, g_direct = pgf.poisson_loglik_value_and_grad(beta, xT, y)
    b = beta.clone().requires_grad_(True)
    v = pgf.poisson_loglik(b, xT, y)
    (g,) = torch.autograd.grad(v.sum(), b)
    assert torch.equal(v.detach(), v_direct) and torch.equal(g, g_direct)
    # one chain, against the reference's custom_vjp
    (g1,) = torch.autograd.grad(pgf.poisson_loglik(b[1], xT, y), b)
    rg = jax.grad(rgf.poisson_loglik)(jnp.asarray(beta[1].numpy()), jnp.asarray(xT.numpy()),
                                      jnp.asarray(raw["y"]))
    np.testing.assert_allclose(g1[1].numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not g1[0].any()
    # a cotangent other than 1 scales the saved gradient
    (g2,) = torch.autograd.grad((pgf.poisson_loglik(b, xT, y) * torch.arange(C)).sum(), b)
    assert torch.equal(g2, torch.arange(C, dtype=torch.float32)[:, None] * g_direct)


def test_knob_off_on_transposed_layout_equals_plain(monkeypatch):
    """STARK_FUSED_GLM=0: autograd on the same transposed data, the plain
    model's potential (tests/test_glm_fused.py:76-89)."""
    raw, _ = _raw("PoissonRegression")
    plain, fused = pglm.PoissonRegression(D), pglm.FusedPoissonRegression(D)
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    assert "xT" in df and "x" not in df
    z = torch.as_tensor(_points(D, seed=7))
    monkeypatch.setenv("STARK_FUSED_GLM", "0")
    assert not pgf.fused_glm_enabled() and fused.fused_tag() is None
    v0, g0 = flatten_model(fused).potential_and_grad(z, df)
    vp, gp = flatten_model(plain).potential_and_grad(z, dp)
    np.testing.assert_allclose(v0.numpy(), vp.numpy(), rtol=KNOB_RTOL)
    np.testing.assert_allclose(g0.numpy(), gp.numpy(), rtol=KNOB_RTOL)
    monkeypatch.setenv("STARK_FUSED_GLM", "1")
    assert pgf.fused_glm_enabled() and fused.fused_tag() == "glm"


@pytest.mark.parametrize("value,default,want", [
    (None, False, False), (None, True, True), ("0", True, False), ("1", False, True),
    ("yes", False, True), ("", False, True),
])
def test_fused_knob_matches_reference(value, default, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("STARK_FUSED_TEST_KNOB", raising=False)
    else:
        monkeypatch.setenv("STARK_FUSED_TEST_KNOB", value)
    got = pprec.fused_knob("STARK_FUSED_TEST_KNOB", default)
    assert got == rprec.fused_knob("STARK_FUSED_TEST_KNOB", default=default) == want


@pytest.mark.parametrize("knob,value,item", [
    ("STARK_FUSED_X_DTYPE", "bf16", "B5"), ("STARK_FUSED_PRECISION", "high", "B6"),
])
def test_unported_knobs_refused(knob, value, item, monkeypatch):
    raw, _ = _raw("PoissonRegression")
    xT = torch.as_tensor(np.ascontiguousarray(raw["x"].T))
    y = torch.as_tensor(raw["y"])
    if knob == "STARK_FUSED_PRECISION":
        # ported (ROADMAP B6): both entries honour the knob, inside the
        # reference's band against highest, and differ from it
        beta = torch.as_tensor(_points(D, seed=3))
        v0, g0 = pgf.poisson_loglik_value_and_grad(beta, xT, y)
        monkeypatch.setenv(knob, value)
        v1, g1 = pgf.poisson_loglik_value_and_grad(beta, xT, y)
        assert torch.equal(pgf.poisson_loglik(beta, xT, y), v1)
        val_rel, grad_rel = parity_error(v0, g0, v1, g1)
        tol_v, tol_g = PARITY_BANDS[value]
        assert val_rel <= tol_v and 0 < grad_rel <= tol_g, (val_rel, grad_rel)
        return
    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match=item):
        pgf.poisson_loglik(torch.zeros(C, D), xT, y)
    with pytest.raises(NotImplementedError, match=item):
        pgf.poisson_loglik_value_and_grad(torch.zeros(C, D), xT, y)
    if knob == "STARK_FUSED_X_DTYPE":  # the layout refuses a narrow X too
        with pytest.raises(NotImplementedError, match=item):
            prepare_model_data(pglm.FusedPoissonRegression(D), raw, device="cpu")


@pytest.mark.parametrize("name", ["LinearRegression", "FusedLinearRegression",
                                  "PoissonRegression", "FusedPoissonRegression"])
def test_shard_batched_likelihood_matches_reference(name):
    """Consensus Monte Carlo's shard batch (parameters (S, C, ...) against
    S row blocks) at S == C, against the reference's vmap over shards:
    each shard's chains score that shard's rows only."""
    S = C
    raw, _ = _raw(name, n=96 * S)
    rmodel, pmodel = getattr(rglm, name)(D), getattr(pglm, name)(D)
    assert pmodel.shard_batched_lik
    rprep = rmodel.prepare_data(raw)
    rshard = jax.tree.map(
        lambda x, ax: jnp.moveaxis(jnp.asarray(x).reshape(
            x.shape[:ax] + (S, x.shape[ax] // S) + x.shape[ax + 1:]), ax, 0),
        rprep, rmodel.data_row_axes(rprep))
    pshard = pcons.shard_data(pmodel, raw, S, "cpu")
    rfm = ref_flatten(rmodel, prior_scale=1.0 / S)
    pfm = flatten_model(pmodel, prior_scale=1.0 / S)
    z = (0.5 * np.random.RandomState(8).standard_normal((S, C, pfm.ndim))).astype(np.float32)
    vg = jax.vmap(jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None)),
                  in_axes=(0, 0))
    rv, rg = vg(jnp.asarray(z), rshard)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pshard)
    assert pv.shape == (S, C) and pg.shape == (S, C, pfm.ndim)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("name", ["linreg", "poisson"])
def test_synth_recipes(name):
    """The port's own recipes: the reference's shapes, dtypes and
    generating process, seeded and repeatable (the streams differ)."""
    n, d = 4000, 3
    if name == "linreg":
        data, true = pglm.synth_linreg_data(0, n, d)
        resid = data["y"] - data["x"] @ true["beta"]
        assert true["sigma"] == 0.5 and abs(resid.std() - 0.5) < 0.03
        again, _ = pglm.synth_linreg_data(0, n, d)
    else:
        data, true = pglm.synth_poisson_data(0, n, d)
        rate = np.exp(data["x"] @ true["beta"])
        assert np.all(data["y"] == np.round(data["y"])) and data["y"].min() >= 0
        assert abs(data["y"].mean() / rate.mean() - 1.0) < 0.05
        assert set(true) == {"beta"} and np.abs(true["beta"]).max() < 1.5
        again, _ = pglm.synth_poisson_data(0, n, d)
    assert data["x"].shape == (n, d) and data["y"].shape == (n,)
    assert data["x"].dtype == data["y"].dtype == true["beta"].dtype == np.float32
    np.testing.assert_array_equal(again["y"], data["y"])


@pytest.mark.parametrize("name,dtype", [("PoissonRegression", np.float64),
                                        ("FusedPoissonRegression", np.float32)])
def test_nuts_transitions_match_reference(name, dtype):
    """Eight NUTS transitions of 4 chains from the reference's carry, its
    randomness replayed: tree depth, evaluations, divergence and
    acceptance exact.  The plain model in float64 on both sides, to rtol
    1e-6 / atol 1e-8; the fused model in float32 (the reference's fused
    op runs its dots in float32 whatever the parameters' type), positions
    and gradients at the fused GLM's gradient tolerance and potentials at
    its value tolerance."""
    raw, _ = _raw(name, n=400, d=4)
    data = {"x": raw["x"].astype(dtype), "y": raw["y"].astype(dtype)}
    if name.startswith("Fused"):
        data = {"xT": np.ascontiguousarray(data["x"].T), "y": data["y"]}
        tols = ((GRAD_RTOL, GRAD_ATOL), (VAL_RTOL, 0.0), (GRAD_RTOL, GRAD_ATOL))
    else:
        tols = ((X64_RTOL, X64_ATOL),) * 3
    rmodel, pmodel = getattr(rglm, name)(4), getattr(pglm, name)(4)
    with jax.enable_x64(dtype == np.float64):
        rpot = ref_flatten(rmodel).bind({k: jnp.asarray(v) for k, v in data.items()})
        rstate, step, mass = _setup(rpot, 4, dtype, seed=5)
        fn = jax.jit(jax.vmap(lambda k, s, e, m: rnuts.nuts_step(k, s, rpot, e, m, MAX_DEPTH)))
        keys = [jax.random.split(k, 4) for k in jax.random.split(jax.random.PRNGKey(5), 8)]
        trans = reference_transitions(fn, rstate, keys, step, mass)
        ppot = flatten_model(pmodel).bind({k: torch.as_tensor(v) for k, v in data.items()})
        depths, _ = _check_transitions(trans, keys, step, mass, ppot, 4, tols)
    assert depths.min() < depths.max()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["LinearRegression", "FusedLinearRegression",
                                  "PoissonRegression", "FusedPoissonRegression"])
def test_posterior_recovers_truth(name):
    """tests/test_glm.py:15-43 on the port, at its thresholds: 2 chains,
    NUTS depth 6, 300 + 300, R-hat < 1.05, beta within 0.1 (linear; sigma
    too) or 0.15 (Poisson) of the truth, on the port's own recipes."""
    if "Linear" in name:
        data, true = pglm.synth_linreg_data(0, 2048, 4)
        atol = 0.1
    else:
        data, true = pglm.synth_poisson_data(1, 2048, 3)
        atol = 0.15
    d = data["x"].shape[1]
    post = sample(getattr(pglm, name)(d), data, chains=2, kernel="nuts", max_tree_depth=6,
                  num_warmup=300, num_samples=300, seed=0, device="cpu")
    assert post.max_rhat() < 1.05
    np.testing.assert_allclose(post.draws["beta"].mean((0, 1)), true["beta"], atol=atol)
    if "Linear" in name:
        assert abs(float(post.draws["sigma"].mean()) - 0.5) < 0.1


@pytest.mark.slow
def test_linreg_card_budget_leaves_both_packages_unconverged(capsys):
    """chip_smoke.py's zoo_linreg budget (8 chains, NUTS depth 6, 50 + 50)
    on synth_linreg_data(0, 200,000, 32), through both packages on the
    CPU: from the random init neither reaches R-hat < 1.1 (sigma and beta
    drift together), so the card leg's R-hat is the budget's, not the
    port's.  Prints both packages' max split R-hat and max |mean beta -
    truth|."""
    import stark_tpu

    data, true = pglm.synth_linreg_data(0, 200_000, 32)
    kw = dict(chains=8, kernel="nuts", max_tree_depth=6, num_warmup=50, num_samples=50,
              seed=0)
    ref = stark_tpu.sample(rglm.LinearRegression(32), data, **kw)
    port = sample(pglm.FusedLinearRegression(32), data, device="cpu", **kw)
    with capsys.disabled():
        for name, post in (("reference", ref), ("port", port)):
            err = np.abs(np.asarray(post.draws["beta"]).mean((0, 1)) - true["beta"]).max()
            print(f"\n{name}: max split R-hat {post.max_rhat():.4f}, max |mean beta - "
                  f"truth| {err:.4f}")
    assert ref.max_rhat() > 1.1 and port.max_rhat() > 1.1
