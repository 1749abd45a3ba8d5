"""Port's model contract against the JAX package: flat layout, bijectors,
the chain-batched potential of the three flagship-family models, and the
data path (prepare + interop).

Potential tolerances are the reference's kernel tolerances (value rtol
2e-5; gradients rtol 2e-4 / atol 1e-4, tests/test_hier_fused.py).
Bijector transforms are elementwise float32 maths: rtol 1e-5 / atol
1e-6, a few float32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu.bijectors as rb
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import logistic as rml
from stark_tpu.tree import make_unflatten as ref_unflatten
from chip_smoke import PARITY_BANDS, parity_error
import stark_tpu_torch.bijectors as pb
from stark_tpu_torch import prepare_model_data
from stark_tpu_torch.interop import data_from_reference
from stark_tpu_torch.model import flatten_model
from stark_tpu_torch.models import logistic as pml
from stark_tpu_torch.tree import make_unflatten

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
BIJ_RTOL, BIJ_ATOL = 1e-5, 1e-6

_BIJECTORS = {
    "identity": (rb.Identity(), pb.Identity(), (3,)),
    "exp": (rb.Exp(), pb.Exp(), (4,)),
    "softplus": (rb.Softplus(), pb.Softplus(), (4,)),
    "interval": (rb.Interval(-1.0, 3.0), pb.Interval(-1.0, 3.0), (4,)),
    "ordered": (rb.Ordered(), pb.Ordered(), (5,)),
    "stick_breaking": (rb.StickBreaking(), pb.StickBreaking(), (4,)),
    "chain": (rb.Chain(rb.Exp(), rb.Softplus()), pb.Chain(pb.Exp(), pb.Softplus()), (3,)),
}


@pytest.mark.parametrize("name", list(_BIJECTORS))
def test_bijector_matches_reference_and_round_trips(name):
    rbij, pbij, shape = _BIJECTORS[name]
    ushape = pbij.unconstrained_shape(shape)
    assert ushape == rbij.unconstrained_shape(shape)
    x = (0.7 * np.random.RandomState(0).standard_normal((6,) + ushape)).astype(np.float32)
    xt = torch.as_tensor(x)
    y = pbij.forward(xt)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(rbij.forward(jnp.asarray(x))), rtol=BIJ_RTOL, atol=BIJ_ATOL
    )
    np.testing.assert_allclose(pbij.inverse(y).numpy(), x, rtol=1e-4, atol=1e-5)
    # fldj: one value per batch element, the reference's event sum
    want = np.stack([np.asarray(rbij.fldj(jnp.asarray(xi))) for xi in x])
    np.testing.assert_allclose(pbij.fldj(xt).numpy(), want, rtol=BIJ_RTOL, atol=1e-5)


def test_make_unflatten_layout_matches_reference():
    shapes = {"a": (2, 3), "b": (), "c": (4,)}
    n_ref, unflat_ref, _ = ref_unflatten(shapes)
    n, unflat, flat = make_unflatten(shapes)
    assert n == n_ref == 11
    z = np.arange(2 * 11, dtype=np.float32).reshape(2, 11)
    got, want = unflat(torch.as_tensor(z)), unflat_ref(jnp.asarray(z))
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(flat(got).numpy(), z)


def _data(n=2500, d=4, groups=12, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "x": rs.standard_normal((n, d)).astype(np.float32),
        "y": (rs.rand(n) < 0.5).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32),
    }


_MODELS = {
    "grouped": (rml.FusedHierLogisticGrouped, pml.FusedHierLogisticGrouped),
    "offset": (rml.FusedHierLogistic, pml.FusedHierLogistic),
    "plain": (rml.HierLogistic, pml.HierLogistic),
}


@pytest.mark.parametrize("name", list(_MODELS))
def test_potential_value_and_grad_match_reference(name):
    """Fixed flat points; the reference's prepared data carried across
    with interop, and the port's own prepare on the same raw data."""
    d, groups = 4, 12
    rmodel, pmodel = (cls(num_features=d, num_groups=groups) for cls in _MODELS[name])
    raw = _data(d=d, groups=groups)
    rdata = ref_prepare(rmodel, raw)
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    assert pfm.ndim == rfm.ndim == d + 2 + groups
    z = (0.5 * np.random.RandomState(1).standard_normal((5, pfm.ndim))).astype(np.float32)
    rv, rg = jax.vmap(jax.value_and_grad(lambda q: rfm.potential(q, rdata)))(jnp.asarray(z))
    for pdata in (
        data_from_reference({k: np.asarray(v) for k, v in rdata.items()}, device="cpu"),
        prepare_model_data(pmodel, raw, device="cpu"),
    ):
        pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(pfm.potential(torch.as_tensor(z), pdata).numpy(),
                                   np.asarray(rv), rtol=VAL_RTOL)


def test_grouped_model_falls_back_to_offset_layout_like_reference():
    """One row per group scattered wide defeats the grouped layout: both
    packages keep the transposed offset layout and the same potential."""
    d = 4
    raw = {
        "x": np.random.RandomState(2).standard_normal((3000, d)).astype(np.float32),
        "y": (np.arange(3000) % 2).astype(np.float32),
        "g": np.arange(3000, dtype=np.int32),
    }
    rmodel = rml.FusedHierLogisticGrouped(num_features=d, num_groups=3000)
    pmodel = pml.FusedHierLogisticGrouped(num_features=d, num_groups=3000)
    rdata = ref_prepare(rmodel, raw)
    pdata = prepare_model_data(pmodel, raw, device="cpu")
    assert "offsets_path" in rdata and pdata["offsets_path"] is True
    assert "gl" not in pdata
    carried = data_from_reference({k: np.asarray(v) for k, v in rdata.items()}, device="cpu")
    assert carried["offsets_path"] is True
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    z = (0.3 * np.random.RandomState(4).standard_normal((2, pfm.ndim))).astype(np.float32)
    rv, rg = jax.vmap(jax.value_and_grad(lambda q: rfm.potential(q, rdata)))(jnp.asarray(z))
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_group_ids_out_of_range_are_refused():
    raw = _data(groups=12)
    with pytest.raises(ValueError, match="group ids"):
        prepare_model_data(pml.FusedHierLogisticGrouped(4, 5), raw, device="cpu")


def test_synth_logistic_data_is_seeded():
    a, ta = pml.synth_logistic_data(3, 500, 4, num_groups=7)
    b, _ = pml.synth_logistic_data(3, 500, 4, num_groups=7)
    assert a["x"].shape == (500, 4) and a["x"].dtype == np.float32
    assert a["y"].dtype == np.float32 and set(np.unique(a["y"])) <= {0.0, 1.0}
    assert a["g"].min() >= 0 and a["g"].max() < 7
    assert ta["beta"].shape == (4,) and ta["alpha"].shape == (7,)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize(
    "var,value",
    [("STARK_FUSED_PRECISION", "high"), ("STARK_FUSED_PRECISION", "default"),
     ("STARK_FUSED_X_DTYPE", "bf16"), ("STARK_FUSED_X_DTYPE", "int8")],
)
def test_unported_knobs_raise_naming_roadmap(var, value, monkeypatch):
    model = pml.FusedHierLogisticGrouped(4, 12)
    if var == "STARK_FUSED_PRECISION":
        # ported (ROADMAP B6): the same call is honoured at the knob, inside
        # the reference's band against highest, and differs from it
        data = prepare_model_data(model, _data(), device="cpu")
        fm = flatten_model(model)
        z = torch.as_tensor(
            (0.3 * np.random.RandomState(5).standard_normal((2, fm.ndim))).astype(np.float32))
        v0, g0 = fm.potential_and_grad(z, data)
        monkeypatch.setenv(var, value)
        v1, g1 = fm.potential_and_grad(z, data)
        val_rel, grad_rel = parity_error(v0, g0, v1, g1)
        tol_v, tol_g = PARITY_BANDS[value]
        assert val_rel <= tol_v and 0 < grad_rel <= tol_g, (val_rel, grad_rel)
        return
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="ROADMAP item B"):
        data = prepare_model_data(model, _data(), device="cpu")
        fm = flatten_model(model)
        fm.potential_and_grad(torch.zeros(1, fm.ndim), data)
