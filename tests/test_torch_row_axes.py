"""Every ported model's row-axis hook (`Model.data_row_axes`) against the
JAX package's, and consensus Monte Carlo on `FusedLinearMixedModel`,
whose transposed X lies with its rows on axis 1.

The hook says along which axis of each prepared entry the data rows
lie; consensus shards and SG-HMC minibatches split the data along it.
Each model prepares the same numpy data in both packages, and the axes
must be equal, or both packages must refuse (the grouped models' global
tile layout, `NotImplementedError` naming the offset-path model).  The
sharded potential is held to the reference's vmap over shards at its
LMM tolerances (value rtol 2e-5; gradient rtol 3e-4 / atol 3e-4,
tests/test_hier_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu import models as rm
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu_torch import consensus_sample, sghmc_sample
from stark_tpu_torch import models as pm
from stark_tpu_torch.model import flatten_model
from stark_tpu_torch.parallel import consensus as pcons
from test_torch_consensus import _ref_to_shards

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 3e-4, 3e-4


def _logistic(groups=0, n=512):
    rs = np.random.RandomState(0)
    out = {"x": rs.standard_normal((n, 4)).astype(np.float32),
           "y": (rs.rand(n) < 0.5).astype(np.float32)}
    if groups:
        out["g"] = rs.randint(0, groups, n).astype(np.int32)
    return out


def _lmm(n=512, groups=8):
    data, _ = rm.synth_lmm_data(jax.random.PRNGKey(0), n, 4, groups)
    return {k: np.asarray(v) for k, v in data.items()}


def _regression(counts=False, n=512):
    rs = np.random.RandomState(1)
    x = rs.standard_normal((n, 4)).astype(np.float32)
    y = rs.poisson(1.0, n) if counts else rs.standard_normal(n)
    return {"x": x, "y": y.astype(np.float32)}


def _scattered(data):
    """One row per group: defeats the grouped layout, so the grouped
    models fall back to the offset path's transposed layout."""
    n = data["y"].shape[0]
    return {**data, "g": np.arange(n, dtype=np.int32)}


#: name -> (reference model, port model, raw data, knob to set)
CASES = {
    "EightSchools": lambda: (rm.EightSchools(), pm.EightSchools(),
                             {k: np.asarray(v) for k, v in pm.eight_schools_data().items()}),
    "Logistic": lambda: (rm.Logistic(4), pm.Logistic(4), _logistic()),
    "FusedLogistic": lambda: (rm.FusedLogistic(4), pm.FusedLogistic(4), _logistic()),
    "HierLogistic": lambda: (rm.HierLogistic(4, 5), pm.HierLogistic(4, 5), _logistic(5)),
    "FusedHierLogistic": lambda: (rm.FusedHierLogistic(4, 5), pm.FusedHierLogistic(4, 5),
                                  _logistic(5)),
    "FusedHierLogisticGrouped": lambda: (rm.FusedHierLogisticGrouped(4, 5),
                                         pm.FusedHierLogisticGrouped(4, 5), _logistic(5)),
    "FusedHierLogisticGrouped offset layout": lambda: (
        rm.FusedHierLogisticGrouped(4, 512), pm.FusedHierLogisticGrouped(4, 512),
        _scattered(_logistic(5))),
    "LinearMixedModel": lambda: (rm.LinearMixedModel(4, 8), pm.LinearMixedModel(4, 8), _lmm()),
    "FusedLinearMixedModel": lambda: (rm.FusedLinearMixedModel(4, 8),
                                      pm.FusedLinearMixedModel(4, 8), _lmm()),
    "FusedLinearMixedModelGrouped": lambda: (rm.FusedLinearMixedModelGrouped(4, 8),
                                             pm.FusedLinearMixedModelGrouped(4, 8), _lmm()),
    "FusedLinearMixedModelGrouped offset layout": lambda: (
        rm.FusedLinearMixedModelGrouped(4, 512), pm.FusedLinearMixedModelGrouped(4, 512),
        _scattered(_lmm())),
    "FusedLMM": lambda: (rm.FusedLMM(4, 8), pm.FusedLMM(4, 8), _lmm()),
    "FusedLMM knob on": lambda: (rm.FusedLMM(4, 8), pm.FusedLMM(4, 8), _lmm(),
                                 "STARK_FUSED_LMM"),
    "GaussianMixture": lambda: (rm.GaussianMixture(3), pm.GaussianMixture(3),
                                {"x": np.random.RandomState(2).standard_normal(300)
                                 .astype(np.float32)}),
    "BayesianMLP": lambda: (rm.BayesianMLP(4, hidden=3), pm.BayesianMLP(4, hidden=3),
                            _logistic()),
    "LinearRegression": lambda: (rm.LinearRegression(4), pm.LinearRegression(4),
                                 _regression()),
    "FusedLinearRegression": lambda: (rm.FusedLinearRegression(4),
                                      pm.FusedLinearRegression(4), _regression()),
    "PoissonRegression": lambda: (rm.PoissonRegression(4), pm.PoissonRegression(4),
                                  _regression(True)),
    "FusedPoissonRegression": lambda: (rm.FusedPoissonRegression(4),
                                       pm.FusedPoissonRegression(4), _regression(True)),
}


def _axes(model, prepared):
    """-> the hook's axes, or the refusal's message."""
    try:
        return model.data_row_axes(prepared)
    except NotImplementedError as e:
        return f"refused: {e}"


@pytest.mark.parametrize("case", list(CASES))
def test_row_axes_match_reference(case, monkeypatch):
    rmodel, pmodel, raw, *knob = CASES[case]()
    for k in knob:
        monkeypatch.setenv(k, "1")
    rprep = rmodel.prepare_data(raw)
    pprep = pmodel.prepare_data(raw)
    if case.endswith("offset layout"):
        assert "offsets_path" in rprep and pprep["offsets_path"] is True
    want, got = _axes(rmodel, rprep), _axes(pmodel, pprep)
    if isinstance(want, str):  # the grouped layout: the same refusal
        assert "gl" in pprep and got == want
        assert "cannot be re-sharded" in got
        return
    # the layout's own markers differ in form (the reference rides static
    # ints in array shapes); every array entry's axis is the reference's
    common = {k for k in rprep if k in pprep}
    assert {k for k in rprep if k not in common} <= {"k_loc", "lt128"}
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    if "xT" in got:
        assert got["xT"] == 1


@pytest.mark.parametrize("model", ["FusedHierLogisticGrouped", "FusedLinearMixedModelGrouped"])
def test_grouped_layout_refuses_to_shard_or_minibatch(model):
    """consensus_sample and sghmc_sample refuse the grouped layout as the
    reference does, naming the offset-path model to use instead."""
    _, pmodel, raw = CASES[model]()
    use = model.replace("Grouped", "")
    with pytest.raises(NotImplementedError, match=f"Use {use} for data-sharded meshes"):
        consensus_sample(pmodel, raw, num_shards=4, chains=2, kernel="hmc", num_warmup=2,
                         num_samples=2, device="cpu")
    with pytest.raises(NotImplementedError, match=f"Use {use}"):
        sghmc_sample(pmodel, raw, batch_size=16, chains=2, num_warmup=2, num_samples=2,
                     device="cpu")


def test_consensus_on_fused_lmm_shards_xT_along_its_rows():
    """consensus_sample(FusedLinearMixedModel(8, 4, 2), num_shards=4,
    chains=2, kernel="hmc") runs on the CPU (it raised a shape error
    when xT was split along its feature axis); each shard's potential
    against the reference's vmap over shards."""
    S, C = 4, 2
    data, _ = rm.synth_lmm_data(jax.random.PRNGKey(3), 64, 8, 4)
    raw = {k: np.asarray(v) for k, v in data.items()}
    rmodel, pmodel = rm.FusedLinearMixedModel(8, 4), pm.FusedLinearMixedModel(8, 4, 2)
    pshard = pcons.shard_data(pmodel, raw, S, "cpu")
    assert pshard["xT"].shape == (S, 8, 16) and pshard["y"].shape == (S, 16)
    rprep = rmodel.prepare_data(raw)
    rshard = jax.tree.map(_ref_to_shards(S), rprep, rmodel.data_row_axes(rprep))
    np.testing.assert_array_equal(pshard["xT"].numpy(), np.asarray(rshard["xT"]))
    rfm = ref_flatten(rmodel, prior_scale=1.0 / S)
    pfm = flatten_model(pmodel, prior_scale=1.0 / S)
    z = (0.4 * np.random.RandomState(5).standard_normal((S, C, pfm.ndim))).astype(np.float32)
    vg = jax.vmap(jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None)),
                  in_axes=(0, 0))
    rv, rg = vg(jnp.asarray(z), rshard)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pshard)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    post = consensus_sample(pmodel, raw, num_shards=S, chains=C, kernel="hmc",
                            num_warmup=5, num_samples=5, seed=0, device="cpu")
    assert post.draws["beta"].shape == (C, 5, 8)
    assert post.draws["u_raw"].shape == (C, 5, 4, 2)
    assert np.all(np.isfinite(post.draws_flat)) and not post.sample_stats["degraded"]


def _zoo_rows(kind, n=512):
    from stark_tpu.models import irt as rirt
    from stark_tpu.models import ordinal as rord
    from stark_tpu.models import robust as rrob
    from stark_tpu.models import survival as rsurv
    from stark_tpu.models import timeseries as rts

    key = jax.random.PRNGKey(4)
    data = {
        "studentt": lambda: rrob.synth_studentt_data(key, n, 4)[0],
        "negbinom": lambda: rrob.synth_negbinom_data(key, n, 4)[0],
        "horseshoe": lambda: rrob.synth_horseshoe_data(key, n, 4, num_nonzero=2)[0],
        "ordinal": lambda: rord.synth_ordinal_data(key, n, 4, num_categories=4)[0],
        "irt": lambda: rirt.synth_irt_data(key, 32, 16)[0],
        "survival": lambda: rsurv.synth_survival_data(key, n, 4)[0],
        "sv": lambda: rts.synth_sv_data(key, 128)[0],
    }[kind]()
    return {k: np.array(v) for k, v in data.items()}


#: the rest of the zoo: name -> (reference model, port model, raw data,
#: knob to set)
ZOO_CASES = {
    "StudentTRegression": lambda: (rm.StudentTRegression(4), pm.StudentTRegression(4),
                                   _zoo_rows("studentt")),
    "FusedStudentTRegression": lambda: (rm.FusedStudentTRegression(4),
                                        pm.FusedStudentTRegression(4), _zoo_rows("studentt")),
    "FusedStudentTRegression knob on": lambda: (
        rm.FusedStudentTRegression(4), pm.FusedStudentTRegression(4), _zoo_rows("studentt"),
        "STARK_FUSED_ROBUST"),
    "NegBinomialRegression": lambda: (rm.NegBinomialRegression(4), pm.NegBinomialRegression(4),
                                      _zoo_rows("negbinom")),
    "HorseshoeRegression": lambda: (rm.HorseshoeRegression(4), pm.HorseshoeRegression(4),
                                    _zoo_rows("horseshoe")),
    "OrderedLogistic": lambda: (rm.OrderedLogistic(4, 4), pm.OrderedLogistic(4, 4),
                                _zoo_rows("ordinal")),
    "FusedOrderedLogistic": lambda: (rm.FusedOrderedLogistic(4, 4),
                                     pm.FusedOrderedLogistic(4, 4), _zoo_rows("ordinal")),
    "FusedOrderedLogistic knob on": lambda: (
        rm.FusedOrderedLogistic(4, 4), pm.FusedOrderedLogistic(4, 4), _zoo_rows("ordinal"),
        "STARK_FUSED_ORDINAL"),
    "IRT2PL": lambda: (rm.IRT2PL(32, 16), pm.IRT2PL(32, 16), _zoo_rows("irt")),
    "FusedIRT2PL": lambda: (rm.FusedIRT2PL(32, 16), pm.FusedIRT2PL(32, 16), _zoo_rows("irt")),
    "FusedIRT2PL knob on (grid)": lambda: (rm.FusedIRT2PL(32, 16), pm.FusedIRT2PL(32, 16),
                                           _zoo_rows("irt"), "STARK_FUSED_IRT"),
    "FusedIRT2PL knob on (ragged triples)": lambda: (
        rm.FusedIRT2PL(32, 16), pm.FusedIRT2PL(32, 16),
        {k: v[1:] for k, v in _zoo_rows("irt").items()}, "STARK_FUSED_IRT"),
    "CoxPH": lambda: (rm.CoxPH(4), pm.CoxPH(4), _zoo_rows("survival")),
    "StochasticVolatility": lambda: (rm.StochasticVolatility(128), pm.StochasticVolatility(128),
                                     _zoo_rows("sv")),
}
#: the cases whose layout couples every row, and the refusal's words
ZOO_REFUSED = {"FusedIRT2PL knob on (grid)": "grid layout", "CoxPH": "risk-set",
               "StochasticVolatility": "minibatched"}


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_zoo_row_axes_match_reference(case, monkeypatch):
    """The rest of the zoo: every entry's row axis equals the reference's,
    or both packages refuse with the same message (the IRT grid, the Cox
    risk sets, the SV path)."""
    rmodel, pmodel, raw, *knob = ZOO_CASES[case]()
    for k in knob:
        monkeypatch.setenv(k, "1")
    rprep, pprep = rmodel.prepare_data(raw), pmodel.prepare_data(raw)
    assert sorted(pprep) == sorted(rprep)
    want, got = _axes(rmodel, rprep), _axes(pmodel, pprep)
    assert got == want
    if case in ZOO_REFUSED:
        assert got.startswith("refused") and ZOO_REFUSED[case] in got
    else:
        assert got == {k: (1 if k == "xT" else 0) for k in pprep}


@pytest.mark.parametrize("case", list(ZOO_REFUSED))
def test_zoo_refusals_through_sghmc_and_consensus(case, monkeypatch):
    """sghmc_sample and consensus_sample refuse the layouts that couple
    every row, with the reference's message."""
    rmodel, pmodel, raw, *knob = ZOO_CASES[case]()
    for k in knob:
        monkeypatch.setenv(k, "1")
    want = _axes(rmodel, rmodel.prepare_data(raw))[len("refused: "):]
    for run in (
        lambda: sghmc_sample(pmodel, raw, batch_size=16, chains=2, num_warmup=2, num_samples=2,
                             device="cpu"),
        lambda: consensus_sample(pmodel, raw, num_shards=4, chains=2, kernel="hmc",
                                 num_warmup=2, num_samples=2, device="cpu"),
    ):
        with pytest.raises(NotImplementedError) as e:
            run()
        assert str(e.value) == want
