"""The port's `FusedLMM` and its one-pass fused op (`ops.lmm_fused`)
against the JAX package's.

Inputs come from the reference's `synth_lmm_data` (a ``jax.random`` key)
and cross as numpy.  Tolerances are the reference's for the fused zoo
(tests/test_zoo_fused.py:87-91): value rtol 1e-5 / atol 1e-4; gradients
scaled by their largest magnitude, rtol 1e-4 / atol 2e-5.  With the knob
off the model is `LinearMixedModel`, bit for bit; the autograd backward
equals the direct value-and-grad bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import lmm as rlmm
from stark_tpu.ops import lmm_fused as rlf
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import lmm as plmm
from stark_tpu_torch.ops import lmm_fused as plf

VAL_RTOL, VAL_ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5
N, D, G, Q, C = 600, 5, 16, 2, 4
KNOB = "STARK_FUSED_LMM"


@pytest.fixture(autouse=True)
def _knob_unset(monkeypatch):
    monkeypatch.delenv(KNOB, raising=False)


def _raw():
    data, _ = rlmm.synth_lmm_data(jax.random.PRNGKey(0), N, D, G)
    return {k: np.asarray(v) for k, v in data.items()}


def _points(ndim, seed=0):
    rs = np.random.RandomState(seed)
    scale = np.array([0.1, 0.4, 0.8, 1.2])[:, None]
    return (scale * rs.standard_normal((C, ndim))).astype(np.float32)


def _close_scaled(got, want, what):
    """The reference's gradient check: both scaled by the largest
    magnitude of the reference's."""
    scale = float(np.max(np.abs(want))) + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=what)


def _op_inputs(raw, seed=1):
    """Per-chain parameters of the op (constrained) and its data."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    params = (
        rs.standard_normal((C, D)).astype(f32),
        (0.5 * rs.standard_normal((C, G, Q))).astype(f32),
        rs.standard_normal(C).astype(f32),
        rs.uniform(0.4, 1.5, C).astype(f32),
    )
    data = (np.ascontiguousarray(raw["x"].T), raw["z"], raw["g"], raw["y"])
    return params, data


def test_op_value_and_four_gradients_match_reference():
    raw = _raw()
    params, data = _op_inputs(raw)
    t = [torch.as_tensor(a) for a in params + data]
    val, grads = plf.lmm_loglik_value_and_grad(*t)
    assert val.shape == (C,) and [g.shape for g in grads] == [
        (C, D), (C, G, Q), (C,), (C,)]
    for c in range(C):
        rval, rgrads = rlf.lmm_loglik_value_and_grad(
            *[jnp.asarray(p[c]) for p in params], *[jnp.asarray(a) for a in data])
        np.testing.assert_allclose(val[c].numpy(), np.asarray(rval), rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        for what, got, want in zip(("beta", "u", "intercept", "sigma"), grads, rgrads):
            _close_scaled(got[c].numpy(), want, f"d/d{what}, chain {c}")
    # one chain without the chain axis: the same numbers
    v1, g1 = plf.lmm_loglik_value_and_grad(*[p[2] for p in t[:4]], *t[4:])
    np.testing.assert_allclose(v1.numpy(), val[2].numpy(), rtol=1e-6)
    for a, b in zip(g1, grads):
        np.testing.assert_allclose(a.numpy(), b[2].numpy(), rtol=1e-5, atol=1e-5)


def test_backward_equals_direct_and_repeats_bitwise():
    """Autograd through `lmm_loglik` chains the saved gradients (bit for
    bit the direct entry's) and never reads the data again; a second
    call gives the same bits (the ∂u segment sum is deterministic)."""
    raw = _raw()
    params, data = _op_inputs(raw, seed=2)
    data = [torch.as_tensor(a) for a in data]
    leaves = [torch.as_tensor(p).requires_grad_(True) for p in params]
    val = plf.lmm_loglik(*leaves, *data)
    got = torch.autograd.grad(val.sum(), leaves)
    dval, dgrads = plf.lmm_loglik_value_and_grad(*[p.detach() for p in leaves], *data)
    assert torch.equal(val.detach(), dval)
    assert all(torch.equal(a, b) for a, b in zip(got, dgrads))
    again = plf.lmm_loglik_value_and_grad(*[p.detach() for p in leaves], *data)
    assert torch.equal(again[0], dval) and all(
        torch.equal(a, b) for a, b in zip(again[1], dgrads))


def test_segment_sum_gives_zero_to_ids_without_rows():
    """∂u of a group without rows is exactly 0, as the reference's
    segment_sum gives; the sums of the others match it."""
    raw = _raw()
    keep = raw["g"] % 5 != 3
    raw = {k: v[keep] for k, v in raw.items()}
    params, data = _op_inputs(raw, seed=3)
    _, grads = plf.lmm_loglik_value_and_grad(*[torch.as_tensor(a) for a in params + data])
    empty = np.setdiff1d(np.arange(G), raw["g"])
    assert empty.size and not grads[1][:, empty].any()
    _, rgrads = rlf.lmm_loglik_value_and_grad(
        *[jnp.asarray(p[0]) for p in params], *[jnp.asarray(a) for a in data])
    _close_scaled(grads[1][0].numpy(), rgrads[1], "d/du")


def test_fused_lmm_matches_reference_knob_on(monkeypatch):
    """Knob on: the port's FusedLMM potential and gradient (through beta,
    u_raw, tau, intercept and sigma) against the reference's FusedLMM."""
    monkeypatch.setenv(KNOB, "1")
    raw = _raw()
    rmodel, pmodel = rlmm.FusedLMM(D, G), plmm.FusedLMM(D, G)
    rdata = ref_prepare(rmodel, raw)
    pdata = prepare_model_data(pmodel, raw, device="cpu")
    assert "xT" in pdata and "x" not in pdata and sorted(pdata) == sorted(rdata)
    np.testing.assert_array_equal(pdata["xT"].numpy(), np.asarray(rdata["xT"]))
    assert pmodel.data_row_axes(pdata) == rmodel.data_row_axes(rdata)
    assert pmodel.fused_tag() == rmodel.fused_tag() == "lmm"
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    z = _points(pfm.ndim)
    rv, rg = jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None))(
        jnp.asarray(z), rdata)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL, atol=VAL_ATOL)
    for c in range(C):
        _close_scaled(pg[c].numpy(), rg[c], f"potential gradient, chain {c}")


def test_fused_matches_plain_lmm_knob_on(monkeypatch):
    """tests/test_zoo_fused.py:73-91 on the port: FusedLMM (knob on)
    against LinearMixedModel's autograd."""
    monkeypatch.setenv(KNOB, "1")
    raw = _raw()
    plain, fused = plmm.LinearMixedModel(D, G), plmm.FusedLMM(D, G)
    fp, ff = flatten_model(plain), flatten_model(fused)
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    z = torch.as_tensor(_points(fp.ndim, seed=4))
    vp, gp = fp.potential_and_grad(z, dp)
    vf, gf = ff.potential_and_grad(z, df)
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=VAL_RTOL, atol=VAL_ATOL)
    for c in range(C):
        _close_scaled(gf[c].numpy(), gp[c].numpy(), f"chain {c}")


def test_knob_off_bit_identity():
    """Knob off (the default): FusedLMM is LinearMixedModel — the same
    prepared data, the same row axes, bit-identical potential and
    gradient (tests/test_zoo_fused.py:94-111)."""
    raw = _raw()
    plain, fused = plmm.LinearMixedModel(D, G), plmm.FusedLMM(D, G)
    assert not plf.fused_lmm_enabled() and fused.fused_tag() is None
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    assert sorted(dp) == sorted(df) and "xT" not in df
    assert all(torch.equal(dp[k], df[k]) for k in dp)
    assert fused.data_row_axes(df) == plain.data_row_axes(dp) == {k: 0 for k in dp}
    fp, ff = flatten_model(plain), flatten_model(fused)
    z = torch.as_tensor(_points(fp.ndim, seed=7))
    vp, gp = fp.potential_and_grad(z, dp)
    vf, gf = ff.potential_and_grad(z, df)
    assert torch.equal(vp, vf) and torch.equal(gp, gf)


def test_knob_off_after_fused_prepare(monkeypatch):
    """Data prepared in the fused layout keeps working when the knob
    flips off: autograd on the same layout (tests/test_zoo_fused.py:114)."""
    monkeypatch.setenv(KNOB, "1")
    raw = _raw()
    plain, fused = plmm.LinearMixedModel(D, G), plmm.FusedLMM(D, G)
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    z = torch.as_tensor(_points(flatten_model(plain).ndim, seed=3))
    monkeypatch.setenv(KNOB, "0")
    assert "xT" in df and fused.data_row_axes(df)["xT"] == 1
    v0, g0 = flatten_model(fused).potential_and_grad(z, df)
    vp, gp = flatten_model(plain).potential_and_grad(z, dp)
    np.testing.assert_allclose(v0.numpy(), vp.numpy(), rtol=VAL_RTOL, atol=VAL_ATOL)
    for c in range(C):
        _close_scaled(g0[c].numpy(), gp[c].numpy(), f"chain {c}")
