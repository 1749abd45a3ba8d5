"""STARK_FUSED_X_DTYPE=bf16|int8|fp8e4m3|fp8e5m2 and STARK_QUANT_PCT in
the port against the JAX package.

The knobs resolve, name their tokens and refuse unknown values as the
reference's do (`ops.precision`).  Packing (`ops.quantize.pack_slab`) is
the reference's byte for byte under absmax calibration; under a
percentile its scales are within one float32 ulp and its bytes equal
wherever the scales are.  The prepared slabs (xT, zT, their scales and
the IRT grid) of every model that streams one are the reference's bit
for bit, and their row axes replicate the scales.  Every fused model's
potential and gradient on the packed data match the reference's at each
dot precision: at highest within tests/test_hier_fused.py:80-87's
tolerances (value rtol 2e-5; gradient rtol 2e-4 / atol 1e-4), at high
and default inside the reference's band (`tests/test_torch_precision`).
The rounded-X convention (tests/test_quantize.py:231-255), the
knob-flip lifecycle (:258-295), the packed IRT grid, consensus and an
SG-HMC step on packed data close the set.  Small sizes throughout: N of a
few hundred, D <= 8, G <= 30.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import glm as rglm
from stark_tpu.models import irt as rirt
from stark_tpu.models import lmm as rlmm
from stark_tpu.models import logistic as rlog
from stark_tpu.models import ordinal as rord
from stark_tpu.models import robust as rrob
from stark_tpu.ops import precision as rprec
from stark_tpu.ops import quantize as rq
from chip_smoke import PARITY_BANDS, parity_error
from stark_tpu_torch.interop import data_from_reference
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import glm as pglm
from stark_tpu_torch.models import irt as pirt
from stark_tpu_torch.models import lmm as plmm
from stark_tpu_torch.models import logistic as plog
from stark_tpu_torch.models import ordinal as pord
from stark_tpu_torch.models import robust as prob
from stark_tpu_torch.ops import hier_fused as phf
from stark_tpu_torch.ops import logistic_fused as plf
from stark_tpu_torch.ops import precision as pprec
from stark_tpu_torch.ops import quantize as pq

XKNOB, PCT, PREC = "STARK_FUSED_X_DTYPE", "STARK_QUANT_PCT", "STARK_FUSED_PRECISION"
NARROW = ("bf16", "int8", "fp8e4m3", "fp8e5m2")
PACKED = ("int8", "fp8e4m3", "fp8e5m2")
VAL_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 2e-4, 1e-4
Q = 2


@pytest.fixture(autouse=True)
def _knobs_unset(monkeypatch):
    for k in (XKNOB, PCT, PREC, "STARK_FUSED_LMM", "STARK_FUSED_ROBUST",
              "STARK_FUSED_ORDINAL", "STARK_FUSED_IRT", "STARK_FUSED_GLM"):
        monkeypatch.delenv(k, raising=False)


def _bits(a) -> bytes:
    """The bytes of a numpy array (any dtype, ml_dtypes included) or a
    tensor (any dtype)."""
    if torch.is_tensor(a):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


def _name(value):
    """The canonical name of a resolved dtype of either package."""
    if isinstance(value, torch.dtype):
        return pprec.X_DTYPE_OF[value]
    return {"float32": "f32", "bfloat16": "bf16", "int8": "int8", "float8_e4m3fn": "fp8e4m3",
            "float8_e5m2": "fp8e5m2"}[jnp.dtype(value).name]


# --- knobs -----------------------------------------------------------------

@pytest.mark.parametrize("value", [None, "f32", "float32", "BF16", "bfloat16", "int8",
                                   "fp8e4m3", "float8_e4m3fn", "fp8e5m2", "float8_e5m2"])
def test_x_dtype_resolves_like_the_reference(value, monkeypatch):
    if value is not None:
        monkeypatch.setenv(XKNOB, value)
    assert _name(pprec.x_stream_dtype()) == _name(rprec.x_stream_dtype())
    assert pprec.x_stream_config() == rprec.x_stream_config()
    assert pprec.X_DTYPE_NAMES == rprec.X_DTYPE_NAMES
    assert pprec.check_knobs() == "highest"


@pytest.mark.parametrize("value", ["f16", "fp8", "", "tf32"])
def test_unknown_x_dtype_raises_the_reference_message(value, monkeypatch):
    monkeypatch.setenv(XKNOB, value)
    with pytest.raises(ValueError) as want:
        rprec.x_stream_dtype()
    with pytest.raises(ValueError) as got:
        pprec.x_stream_dtype()
    assert str(got.value) == str(want.value)
    assert tuple(str(got.value).split("use ")[-1].split("|")) == pprec.X_DTYPE_NAMES
    with pytest.raises(ValueError):
        pprec.check_knobs()


@pytest.mark.parametrize("value", [None, "99.5", "100", "0", "-1", "101", "abc", "50"])
def test_quant_percentile_like_the_reference(value, monkeypatch):
    if value is not None:
        monkeypatch.setenv(PCT, value)
    try:
        want = rprec.quant_percentile()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pprec.quant_percentile()
        assert str(got.value) == str(e)
        return
    assert pprec.quant_percentile() == want


@pytest.mark.parametrize("xdt,pct", [(None, None), ("int8", None), ("int8", "99.9"),
                                     ("bf16", "99.9"), ("fp8e5m2", "97.5"), ("fp8e4m3", "100")])
def test_x_stream_config_tokens(xdt, pct, monkeypatch):
    if xdt is not None:
        monkeypatch.setenv(XKNOB, xdt)
    if pct is not None:
        monkeypatch.setenv(PCT, pct)
    assert pprec.x_stream_config() == rprec.x_stream_config()


def test_card_bands_are_the_reference_tools():
    """The card's bands for narrow X (chip_smoke.X_BANDS) are
    tools/precision_parity.py's: mid for bf16, quant for int8 and fp8."""
    import importlib.util
    from pathlib import Path

    from chip_smoke import X_BANDS

    path = Path(__file__).resolve().parents[1] / "tools" / "precision_parity.py"
    spec = importlib.util.spec_from_file_location("precision_parity_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in NARROW:
        assert X_BANDS[name] == tool.TOLERANCE_BANDS[tool.band_for(name, "highest")]


def test_stream_arg_keeps_narrow_slabs():
    for dt in (torch.bfloat16, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
        t = torch.zeros(2, 3, dtype=dt)
        assert pprec.stream_arg(t) is t and pprec.stream_arg((t, None)) is t
    assert pprec.stream_arg(torch.zeros(2, dtype=torch.float64)).dtype == torch.float32


# --- calibration and packing -----------------------------------------------

def _slab(seed=0, n=777):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((6, n)) * np.array([[0.01], [1.0], [100.0], [1e-4], [3.0], [0.0]])
    x = x.astype(np.float32)
    x[3, 5:] = 0.0  # sparse: its percentile is 0, so it keeps its absmax
    return x


@pytest.mark.parametrize("pct", [None, 99.0, 99.9, 87.6])
@pytest.mark.parametrize("name", PACKED)
def test_pack_slab_is_the_reference_bytes(name, pct):
    x = _slab()
    rqq, rs = rq.pack_slab(jnp.asarray(x), rq.PACKED_DTYPES[name], pct=pct)
    pqq, ps = pq.pack_slab(x, pq.PACKED_DTYPES[name], pct=pct)
    assert pqq.dtype == pq.PACKED_DTYPES[name] and ps.dtype == torch.float32
    rs32, ps32 = np.asarray(rs).view(np.int32), ps.numpy().view(np.int32)
    if pct is None:
        assert _bits(pqq) == _bits(rqq) and _bits(ps) == _bits(rs)
    else:
        assert np.all(np.abs(rs32.astype(np.int64) - ps32) <= 1)
        same = rs32 == ps32
        assert same.sum() >= 4
        rb = np.asarray(rqq).view(np.uint8).reshape(x.shape)
        pb = pqq.view(torch.uint8).numpy()
        np.testing.assert_array_equal(pb[same], rb[same])
    assert float(ps[5]) == 1.0 and not np.any(pq.dequant(pqq, ps)[5].numpy())
    assert _bits(pq.pack_slab(x, pq.PACKED_DTYPES[name], pct=pct)[0]) == _bits(pqq)


def test_pack_slab_reads_the_percentile_knob(monkeypatch):
    x = np.concatenate([np.linspace(-1, 1, 999), [1000.0]]).astype(np.float32)[None]
    q_abs, s_abs = pq.pack_slab(x, torch.int8)
    monkeypatch.setenv(PCT, "99.0")
    q_pct, s_pct = pq.pack_slab(x, torch.int8)
    assert float(s_pct[0]) < float(s_abs[0])
    assert float(pq.dequant(q_pct, s_pct)[0, -1]) == pytest.approx(127 * float(s_pct[0]))
    rqq, rs = rq.pack_slab(jnp.asarray(x), jnp.int8)
    assert _bits(q_pct) == _bits(rqq) and _bits(s_pct) == _bits(rs)


@pytest.mark.parametrize("name", PACKED)
def test_quantize_helpers_match_the_reference(name):
    rs = np.random.RandomState(3)
    x = rs.standard_normal((300, 8)).astype(np.float32)
    beta = rs.standard_normal((3, 8)).astype(np.float32)
    resid = rs.standard_normal((3, 300)).astype(np.float32)
    rqq, rsc = rq.pack_slab(jnp.asarray(x.T), rq.PACKED_DTYPES[name])
    pqq, psc = pq.pack_slab(x.T, pq.PACKED_DTYPES[name])
    np.testing.assert_array_equal(pq.dequant(pqq, psc).numpy(), np.asarray(rq.dequant(rqq, rsc)))
    fwd = np.stack([np.asarray(rq.dequant_dot(jnp.asarray(b), (rqq, rsc))) for b in beta])
    bwd = np.stack([np.asarray(rq.dequant_dot((rqq, rsc), jnp.asarray(r))) for r in resid])
    np.testing.assert_allclose(pq.dequant_dot(torch.as_tensor(beta), (pqq, psc)).numpy(), fwd,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pq.dequant_dot_t((pqq, psc), torch.as_tensor(resid)).numpy(), bwd,
                               rtol=1e-5, atol=1e-5)
    # a float32 slab: the plain dots, bit for bit
    xt = torch.as_tensor(np.ascontiguousarray(x.T))
    assert torch.equal(pq.dequant_dot(torch.as_tensor(beta), xt), torch.as_tensor(beta) @ xt)
    assert torch.equal(pq.dequant_dot_t(xt, torch.as_tensor(resid)),
                       torch.as_tensor(resid) @ xt.T)
    rdata, pdata = {"xT": rqq, "xT_scale": rsc}, {"xT": pqq, "xT_scale": psc}
    np.testing.assert_array_equal(pq.dequant_rows(pdata).numpy(),
                                  np.asarray(rq.dequant_rows(rdata)))
    np.testing.assert_array_equal(pq.fake_quant(x, name), np.asarray(rq.fake_quant(x, name)))
    assert pq.quant_column_error(x, name) == rq.quant_column_error(x, name)
    assert pq.quant_column_error(x, name, pct=99.0) == pytest.approx(
        rq.quant_column_error(x, name, pct=99.0), rel=1e-6)
    for cfg in ("f32", "bf16", name, f"{name}@p99.9"):
        assert pq.predict_x_bytes(300, 8, cfg) == rq.predict_x_bytes(300, 8, cfg)
    assert pq.x_bytes_per_grad(pdata) == rq.x_bytes_per_grad(rdata) == 300 * 8 + 8 * 4
    assert pq.x_bytes_per_grad({"y": torch.ones(3)}) is None


# --- prepared data, interop, row axes ----------------------------------------

def _synth(fn, *args, **kw):
    data, _ = fn(0, *args, **kw)
    return {k: np.asarray(v) for k, v in data.items()}


def _cases():
    """name -> (model maker, reference module, port module, raw data,
    family knob)."""
    from stark_tpu_torch.models import (
        synth_irt_data,
        synth_linreg_data,
        synth_lmm_data,
        synth_logistic_data,
        synth_ordinal_data,
        synth_poisson_data,
        synth_studentt_data,
    )

    logit = lambda: _synth(synth_logistic_data, 600, 4, num_groups=12)
    lmm = lambda: _synth(synth_lmm_data, 600, 3, 20, num_random=Q)
    return {
        "FusedLogistic": (lambda m: m.FusedLogistic(4), rlog, plog, logit, None),
        "FusedHierLogistic": (lambda m: m.FusedHierLogistic(4, 12), rlog, plog, logit, None),
        "FusedHierLogisticGrouped": (lambda m: m.FusedHierLogisticGrouped(4, 12), rlog, plog,
                                     logit, None),
        "FusedLinearRegression": (lambda m: m.FusedLinearRegression(5), rglm, pglm,
                                  lambda: _synth(synth_linreg_data, 600, 5), None),
        "FusedLinearMixedModel": (lambda m: m.FusedLinearMixedModel(3, 20, Q), rlmm, plmm,
                                  lmm, None),
        "FusedLinearMixedModelGrouped": (lambda m: m.FusedLinearMixedModelGrouped(3, 20, Q),
                                         rlmm, plmm, lmm, None),
        "FusedPoissonRegression": (lambda m: m.FusedPoissonRegression(5), rglm, pglm,
                                   lambda: _synth(synth_poisson_data, 600, 5), None),
        "FusedLMM": (lambda m: m.FusedLMM(3, 20, Q), rlmm, plmm, lmm, "STARK_FUSED_LMM"),
        "FusedStudentTRegression": (lambda m: m.FusedStudentTRegression(5), rrob, prob,
                                    lambda: _synth(synth_studentt_data, 600, 5),
                                    "STARK_FUSED_ROBUST"),
        "FusedOrderedLogistic": (lambda m: m.FusedOrderedLogistic(5, 4), rord, pord,
                                 lambda: _synth(synth_ordinal_data, 600, 5, num_categories=4),
                                 "STARK_FUSED_ORDINAL"),
        "FusedIRT2PL": (lambda m: m.FusedIRT2PL(30, 8), rirt, pirt,
                        lambda: _synth(synth_irt_data, 30, 8), "STARK_FUSED_IRT"),
    }


CASES = list(_cases())
SLABS = ("xT", "xT_scale", "zT", "zT_scale", "y_grid")


def _prepared(name, xdt, monkeypatch):
    make, rmod, pmod, raw_fn, knob = _cases()[name]
    if knob:
        monkeypatch.setenv(knob, "1")
    monkeypatch.setenv(XKNOB, xdt)
    raw = raw_fn()
    rmodel, pmodel = make(rmod), make(pmod)
    return rmodel, pmodel, ref_prepare(rmodel, raw), prepare_model_data(pmodel, raw,
                                                                         device="cpu")


@pytest.mark.parametrize("xdt", NARROW)
@pytest.mark.parametrize("name", CASES)
def test_prepared_slabs_are_the_reference_bits(name, xdt, monkeypatch):
    rmodel, pmodel, rdata, pdata = _prepared(name, xdt, monkeypatch)
    keys = [k for k in SLABS if k in rdata]
    assert keys and keys == [k for k in SLABS if k in pdata], (keys, sorted(pdata))
    for k in keys:
        r, p = np.asarray(rdata[k]), pdata[k]
        assert _name(p.dtype) == _name(r.dtype), k
        assert tuple(p.shape) == r.shape and _bits(p) == _bits(r), k
    if xdt != "bf16" and "xT" in keys:
        assert "xT_scale" in keys
    # the reference's prepared data through interop: the same tensors
    via = data_from_reference({k: np.asarray(v) for k, v in rdata.items()}, "cpu")
    for k in keys:
        assert via[k].dtype == pdata[k].dtype and _bits(via[k]) == _bits(pdata[k]), k
    if name in ("FusedHierLogisticGrouped", "FusedLinearMixedModelGrouped", "FusedIRT2PL"):
        return  # global layouts: no row axes
    want = rmodel.data_row_axes(rdata)
    got = pmodel.data_row_axes({k: v for k, v in pdata.items()})
    assert {k: got[k] for k in want} == {k: (-1 if v is None else v) for k, v in want.items()}
    for k in keys:
        if k.endswith("_scale"):
            assert got[k] == -1


_REFERENCE = {}


def _reference_potential(name, xdt, rmodel, rdata, ndim):
    """The reference's potential and gradient at 3 points on its data
    prepared under ``xdt`` (float32 products on the CPU whatever the dot
    precision, so computed once for the three precisions)."""
    if (name, xdt) not in _REFERENCE:
        rfm = ref_flatten(rmodel)
        z = (0.3 * np.random.RandomState(7).standard_normal((3, ndim))).astype(np.float32)
        rv, rg = jax.jit(jax.vmap(jax.value_and_grad(lambda q: rfm.potential(q, rdata))))(
            jnp.asarray(z))
        _REFERENCE[name, xdt] = z, np.asarray(rv), np.asarray(rg)
    return _REFERENCE[name, xdt]


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("xdt", NARROW)
@pytest.mark.parametrize("name", CASES)
def test_fused_potential_matches_the_reference(name, xdt, prec, monkeypatch):
    """Each fused model on narrow data against the reference's at each
    dot precision.  The reference runs its kernels in interpret mode and
    its products on the CPU (float32 whatever the precision), so at high
    and default the port stays inside the reference's band."""
    rmodel, pmodel, rdata, pdata = _prepared(name, xdt, monkeypatch)
    pfm = flatten_model(pmodel)
    z, rv, rg = _reference_potential(name, xdt, rmodel, rdata, pfm.ndim)
    monkeypatch.setenv(PREC, prec)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
    if prec == "highest":
        np.testing.assert_allclose(pv.numpy(), rv, rtol=VAL_RTOL)
        np.testing.assert_allclose(pg.numpy(), rg, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        return
    val_rel, grad_rel = parity_error(rv, rg, pv.numpy(), pg.numpy())
    tol_v, tol_g = PARITY_BANDS[prec]
    assert val_rel <= tol_v and grad_rel <= tol_g, (val_rel, grad_rel)


# --- the plain versions on stored slabs ----------------------------------------

@pytest.mark.parametrize("xdt", NARROW)
def test_plain_versions_widen_the_stored_slab(xdt, monkeypatch):
    """B1-B4's plain versions on a stored slab equal themselves on the
    slab widened to float32, bit for bit (the kernels' contract: widen
    each element, then the float32 pass)."""
    monkeypatch.setenv(XKNOB, xdt)
    raw = _synth(__import__("stark_tpu_torch.models", fromlist=["x"]).synth_lmm_data, 500, 3,
                 20, num_random=Q)
    prep = phf.prepare_grouped(raw, 3 + Q, transpose_keys=("x", "z"))
    t = {k: torch.as_tensor(v) for k, v in prep.items() if not isinstance(v, int)}
    xT, zT = t["xT"], t["zT"]
    assert _name(xT.dtype) == xdt and _name(zT.dtype) == xdt
    rs = torch.Generator().manual_seed(1)
    beta, u, ic = (torch.randn(3, 3, generator=rs), torch.randn(3, 20, Q, generator=rs),
                   torch.randn(3, generator=rs))
    rest = (t["y"], t["gl"], t["first_gid"], prep["lane_tile"])
    for prec in ("highest", "high", "default"):
        a = phf.lmm_grouped_plain(beta, u, ic, xT, zT, *rest, prec)
        b = phf.lmm_grouped_plain(beta, u, ic, xT.float(), zT.float(), *rest, prec)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        y01 = (t["y"] > 1).float()
        a = phf.hier_grouped_plain(beta, u[..., 0], xT, y01, *rest[1:], prec)
        b = phf.hier_grouped_plain(beta, u[..., 0], xT.float(), y01, *rest[1:], prec)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        off = torch.randn(3, xT.shape[1], generator=rs)
        for link in ("bernoulli_logit", "gaussian"):
            a = plf.logistic_batched_plain(beta, xT, y01, off, link, prec)
            b = plf.logistic_batched_plain(beta, xT.float(), y01, off, link, prec)
            assert all(torch.equal(p, q) for p, q in zip(a, b))
    a = plf.logistic_single_plain(beta[0], xT, y01)
    assert all(torch.equal(p, q) for p, q in zip(a, plf.logistic_single_plain(beta[0], xT.float(),
                                                                                y01)))


def test_slab_dtype_not_the_knob_picks_the_stream(monkeypatch):
    with pytest.raises(ValueError, match="f32\\|bf16\\|int8\\|fp8e4m3\\|fp8e5m2"):
        plf.x_code("xT", torch.zeros(2, 2, dtype=torch.float16))
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8),
                     ("fp8e4m3", torch.float8_e4m3fn), ("fp8e5m2", torch.float8_e5m2)):
        monkeypatch.setenv(XKNOB, "f32")  # the knob says nothing of the slab
        assert plf.x_code("xT", torch.zeros(1, dtype=dt)) == (pprec.X_CODES[name], name)
    assert pprec.X_CODES == {"f32": 0, "bf16": 1, "int8": 2, "fp8e4m3": 3, "fp8e5m2": 4}


# --- the rounded-X convention and the knob-flip lifecycle ----------------------

def _close_scaled(got, want):
    scale = float(np.max(np.abs(want))) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("xdt", NARROW)
@pytest.mark.parametrize("name", ["FusedLMM", "FusedHierLogisticGrouped",
                                  "FusedLinearMixedModelGrouped"])
def test_fused_on_packed_is_plain_on_the_dequantized_matrix(name, xdt, monkeypatch):
    """tests/test_quantize.py:231-255 on the port: the fused path on the
    narrow slab equals autograd on the same rounded (dequantized)
    matrix, value rtol 1e-5 / atol 1e-4, gradient scaled rtol 1e-4 /
    atol 2e-5."""
    make, _, pmod, raw_fn, knob = _cases()[name]
    if knob:
        monkeypatch.setenv(knob, "1")
    raw = raw_fn()
    monkeypatch.setenv(XKNOB, xdt)
    fused = make(pmod)
    df = prepare_model_data(fused, raw, device="cpu")
    monkeypatch.setenv(XKNOB, "f32")

    def rounded(x):
        if xdt == "bf16":
            return torch.as_tensor(x).to(torch.bfloat16).float().numpy()
        return pq.fake_quant(x, xdt)

    rraw = {**raw, "x": rounded(raw["x"])}
    if "z" in raw and name == "FusedLinearMixedModelGrouped":
        rraw["z"] = rounded(raw["z"])
    plain = {"FusedLMM": plmm.LinearMixedModel(3, 20, Q),
             "FusedHierLogisticGrouped": plog.HierLogistic(4, 12),
             "FusedLinearMixedModelGrouped": plmm.LinearMixedModel(3, 20, Q)}[name]
    dp = prepare_model_data(plain, rraw, device="cpu")
    fmp, fmf = flatten_model(plain), flatten_model(fused)
    z = torch.as_tensor((0.3 * np.random.RandomState(5).standard_normal((2, fmp.ndim))
                         ).astype(np.float32))
    vp, gp = fmp.potential_and_grad(z, dp)
    vf, gf = fmf.potential_and_grad(z, df)
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=1e-5, atol=1e-4)
    _close_scaled(gf.numpy(), gp.numpy())


def test_knob_flip_lifecycle_packed_data_keeps_working(monkeypatch):
    """tests/test_quantize.py:258-295 on the port: data packed under int8
    stream int8 after the knob flips back to f32, bit for bit; with the
    family knob off the fallback dequantizes the same matrix; preparing
    packed data again leaves it as it is."""
    _, _, _, raw_fn, _ = _cases()["FusedLMM"]
    raw = raw_fn()
    monkeypatch.setenv("STARK_FUSED_LMM", "1")
    monkeypatch.setenv(XKNOB, "int8")
    m = plmm.FusedLMM(3, 20, Q)
    fm = flatten_model(m)
    df = prepare_model_data(m, raw, device="cpu")
    assert df["xT"].dtype == torch.int8 and "xT_scale" in df
    z = torch.as_tensor((0.2 * np.random.RandomState(11).standard_normal((2, fm.ndim))
                         ).astype(np.float32))
    v8, g8 = fm.potential_and_grad(z, df)
    monkeypatch.setenv(XKNOB, "f32")
    v, g = fm.potential_and_grad(z, df)
    assert torch.equal(v, v8) and torch.equal(g, g8)
    monkeypatch.setenv("STARK_FUSED_LMM", "0")
    vfb, gfb = fm.potential_and_grad(z, df)
    np.testing.assert_allclose(vfb.numpy(), v8.numpy(), rtol=1e-5, atol=1e-4)
    _close_scaled(gfb.numpy(), g8.numpy())
    monkeypatch.setenv("STARK_FUSED_LMM", "1")
    monkeypatch.setenv(XKNOB, "int8")
    df2 = prepare_model_data(m, df, device="cpu")
    assert _bits(df2["xT"]) == _bits(df["xT"]) and _bits(df2["xT_scale"]) == _bits(df["xT_scale"])


@pytest.mark.parametrize("xdt", PACKED)
def test_irt_grid_packs_exactly(xdt, monkeypatch):
    """Binary responses pack losslessly, without a scale; the fused grid
    op and the knob-off fallback read the packed grid."""
    make, _, pmod, raw_fn, _ = _cases()["FusedIRT2PL"]
    raw = raw_fn()
    monkeypatch.setenv("STARK_FUSED_IRT", "1")
    monkeypatch.setenv(XKNOB, xdt)
    m = make(pmod)
    df = prepare_model_data(m, raw, device="cpu")
    assert df["y_grid"].dtype == pq.PACKED_DTYPES[xdt] and "y_grid_scale" not in df
    monkeypatch.setenv(XKNOB, "f32")
    plain = pirt.IRT2PL(30, 8)
    dp = prepare_model_data(plain, raw, device="cpu")
    fm, fmp = flatten_model(m), flatten_model(plain)
    z = torch.as_tensor((0.3 * np.random.RandomState(2).standard_normal((2, fm.ndim))
                         ).astype(np.float32))
    vp, _ = fmp.potential_and_grad(z, dp)
    vf, _ = fm.potential_and_grad(z, df)
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=1e-5, atol=1e-4)
    monkeypatch.setenv("STARK_FUSED_IRT", "0")
    vfb, _ = fm.potential_and_grad(z, df)
    np.testing.assert_allclose(vfb.numpy(), vp.numpy(), rtol=1e-5, atol=1e-4)


# --- moving packed slabs: consensus shards, SG-HMC minibatches -----------------

@pytest.mark.parametrize("xdt", ["int8", "fp8e4m3", "bf16"])
def test_consensus_shards_packed_data(xdt, monkeypatch):
    """shard_data splits the packed slab by rows, its scales replicated;
    each shard's potential equals the model on that shard alone; a short
    consensus run on int8 data gives finite draws."""
    from stark_tpu_torch import consensus_sample
    from stark_tpu_torch.models import synth_logistic_data
    from stark_tpu_torch.parallel import consensus as pcons

    raw = _synth(synth_logistic_data, 1200, 4)
    monkeypatch.setenv(XKNOB, xdt)
    m = plog.FusedLogistic(4)
    sharded = pcons.shard_data(m, raw, 3, torch.device("cpu"))
    assert _name(sharded["xT"].dtype) == xdt and tuple(sharded["xT"].shape) == (3, 4, 400)
    if xdt != "bf16":
        assert tuple(sharded["xT_scale"].shape) == (3, 4)
        assert all(torch.equal(sharded["xT_scale"][s], sharded["xT_scale"][0]) for s in range(3))
    whole = prepare_model_data(m, raw, device="cpu")
    fm = flatten_model(m)
    z = torch.as_tensor((0.2 * np.random.RandomState(3).standard_normal((3, 2, fm.ndim))
                         ).astype(np.float32))
    v, _ = fm.potential_and_grad(z, sharded)
    for s in range(3):
        part = {k: (t[:, 400 * s:400 * (s + 1)] if k == "xT" else
                    t if k == "xT_scale" else t[400 * s:400 * (s + 1)])
                for k, t in whole.items()}
        vs, _ = fm.potential_and_grad(z[s], part)
        np.testing.assert_allclose(v[s].numpy(), vs.numpy(), rtol=1e-6, atol=1e-4)
    took = pcons._take_shards(sharded, [2, 0])
    assert _bits(took["xT"][0]) == _bits(sharded["xT"][2])
    if xdt == "int8":
        post = consensus_sample(m, raw, num_shards=3, chains=2, kernel="chees",
                                init_step_size=0.1, map_init_steps=3, num_warmup=4,
                                num_samples=3, seed=0, device="cpu")
        assert np.all(np.isfinite(post.draws_flat))


@pytest.mark.parametrize("xdt", ["int8", "fp8e5m2"])
def test_sghmc_minibatch_gathers_packed_rows(xdt, monkeypatch):
    """An SG-HMC minibatch of packed data: the gathered rows of the slab
    and the whole scales give the plain model's gradient on the same
    dequantized rows."""
    from stark_tpu_torch.kernels.sghmc import gather_rows, make_minibatch_grad
    from stark_tpu_torch.models import synth_linreg_data

    raw = _synth(synth_linreg_data, 500, 5)
    monkeypatch.setenv(XKNOB, xdt)
    m = pglm.FusedLinearRegression(5)
    data = prepare_model_data(m, raw, device="cpu")
    axes = m.data_row_axes(data)
    assert axes["xT_scale"] == -1 and axes["xT"] == 1
    fm = flatten_model(m, lik_scale=500 / 64)
    idx = torch.randint(0, 500, (1, 64), generator=torch.Generator().manual_seed(0))
    batch = gather_rows(data["xT"], 1, idx)[0]
    assert batch.dtype == data["xT"].dtype and tuple(batch.shape) == (5, 64)

    class FixedRows:
        def randint(self, shape, high):
            return idx

    grad = make_minibatch_grad(lambda z, d: fm.potential(z, d), data, 64, row_axes=axes,
                               chain_batched=False)
    z = torch.as_tensor((0.3 * np.random.RandomState(4).standard_normal((1, fm.ndim))
                         ).astype(np.float32))
    g = grad(FixedRows(), z)
    rows = pq.dequant(batch, data["xT_scale"]).T.numpy()
    plain = pglm.LinearRegression(5)
    pdata = prepare_model_data(plain, {"x": rows, "y": raw["y"][idx[0].numpy()]}, device="cpu")
    _, gp = flatten_model(plain, lik_scale=500 / 64).potential_and_grad(z, pdata)
    _close_scaled(g.numpy(), gp.numpy())


def test_adaptation_fingerprint_keys_on_the_callers_data(monkeypatch):
    """The artifact's fingerprint is taken of the caller's raw data, which
    a packed prepare leaves as it was: a warm start ports across X
    dtypes, as the reference's does."""
    from stark_tpu_torch.runner import data_fingerprint

    _, _, _, raw_fn, _ = _cases()["FusedHierLogisticGrouped"]
    raw = raw_fn()
    before = data_fingerprint(raw)
    for xdt in ("f32", *NARROW):
        monkeypatch.setenv(XKNOB, xdt)
        prepare_model_data(plog.FusedHierLogisticGrouped(4, 12), raw, device="cpu")
        assert data_fingerprint(raw) == before
    assert os.environ[XKNOB] == NARROW[-1]
