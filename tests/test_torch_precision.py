"""STARK_FUSED_PRECISION=high|default in the port against the JAX package.

The knob resolves as the reference's does.  `ops.precision.dot` is the
arithmetic of each precision (bf16 operands, one pass or three, float32
sums) and is held to float64 on the same bf16 and hi/lo operands.  The
plain versions of kernels B1, B2 (both links, offsets, the shard axis)
and B4, the zoo's fused ops and the two grouped models' potentials at
``high`` and ``default`` are held to the reference at the same setting:
its Pallas kernels run in interpret mode and its products on the CPU,
where XLA computes every float32 dot exactly whatever the precision, so
the reference gives the float32 result and the port must stay inside
the reference's band of that precision (tools/precision_parity.py:19-21,
metrics :245-249).  At ``highest`` the plain versions stay bitwise what
they were.
"""

import importlib.util
from pathlib import Path

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
from stark_tpu.ops import hier_fused as rhf
from stark_tpu.ops import logistic_fused as rlf
from stark_tpu.ops import precision as rprec
from chip_smoke import PARITY_BANDS, parity_error
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

MODES = ("high", "default")
KNOB = "STARK_FUSED_PRECISION"
Q = 2


def _parity_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "precision_parity.py"
    spec = importlib.util.spec_from_file_location("precision_parity_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bands_are_the_reference_tools():
    tool = _parity_tool()
    for prec in MODES:
        assert PARITY_BANDS[prec] == tool.TOLERANCE_BANDS[tool.band_for("f32", prec)]


@pytest.mark.parametrize("value", [None, "highest", "HIGH", "high", "default", "Default"])
def test_dot_precision_resolves_like_the_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv(KNOB, raising=False)
    else:
        monkeypatch.setenv(KNOB, value)
    names = {jax.lax.Precision.HIGHEST: "highest", jax.lax.Precision.HIGH: "high",
             jax.lax.Precision.DEFAULT: "default"}
    assert pprec.dot_precision() == names[rprec.dot_precision()]
    assert pprec.check_knobs() == pprec.dot_precision()


@pytest.mark.parametrize("value", ["bf16", "tf32", ""])
def test_invalid_precision_raises_the_reference_message(value, monkeypatch):
    monkeypatch.setenv(KNOB, value)
    with pytest.raises(ValueError) as want:
        rprec.dot_precision()
    with pytest.raises(ValueError) as got:
        pprec.dot_precision()
    assert str(got.value) == str(want.value)
    assert "highest|high|default" in str(got.value)


def _operands(seed=0, m=6, k=300, n=5):
    rs = np.random.RandomState(seed)
    a = rs.standard_normal((m, k)).astype(np.float32)
    b = (3.0 * rs.standard_normal((k, n))).astype(np.float32)
    a[0, :10] = [0.0, 1.0, -2.0, 0.5, 3.0, 0.15625, -0.75, 1e-30, 6e4, -7.0]  # some exact in bf16
    return torch.as_tensor(a), torch.as_tensor(b)


def test_bf16_round_is_the_reference_rounding():
    a, _ = _operands()
    want = np.asarray(jnp.asarray(a.numpy()).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(pprec.bf16_round(a).numpy(), want)
    hi, lo = pprec.bf16_split(a)
    assert torch.equal(pprec.bf16_round(hi), hi) and torch.equal(pprec.bf16_round(lo), lo)
    exact = pprec.bf16_round(a) == a
    assert exact[0, :7].all() and torch.all(lo[exact] == 0)
    # hi + lo keeps 16 of float32's 24 bits: within 2^-16 of a
    assert torch.all((hi + lo - a).abs() <= 2.0 ** -16 * a.abs())


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
def test_dot_against_float64_on_the_same_operands(prec):
    a, b = _operands(1)
    got = pprec.dot(a, b, prec).double()
    if prec == "highest":
        assert torch.equal(pprec.dot(a, b, prec), a @ b)
        want = a.double() @ b.double()
        terms = a.double().abs() @ b.double().abs()
    elif prec == "default":
        ar, br = pprec.bf16_round(a).double(), pprec.bf16_round(b).double()
        want, terms = ar @ br, ar.abs() @ br.abs()
    else:
        (ah, al), (bh, bl) = pprec.bf16_split(a), pprec.bf16_split(b)
        ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
        want = ah @ bh + ah @ bl + al @ bh
        terms = ah.abs() @ bh.abs() + ah.abs() @ bl.abs() + al.abs() @ bh.abs()
    # every product of two bf16 values is exact in float32: what is left is
    # the float32 sums' rounding, at most gamma_k of the sum of magnitudes
    k = a.shape[1] * (3 if prec == "high" else 1) + 2
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    assert torch.all((got - want).abs() <= gamma * terms)
    # and the precisions are what they say against the float64 product
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    rel = float(((got - exact).abs() / scale).max())
    assert rel <= {"highest": 1e-6, "high": 1e-4, "default": 2e-2}[prec], rel


def test_dot_operand_and_unknown_precision():
    a, b = _operands(2)
    assert pprec.dot_operand(a, "highest") is a
    assert torch.equal(pprec.dot_operand(a, "default"), pprec.bf16_round(a))
    hi, lo = pprec.bf16_split(a)
    assert torch.equal(pprec.dot_operand(a, "high"), hi + lo)
    # against an exact 0/1 operand the dot is the operand's gather
    onehot = torch.eye(a.shape[1])[:, :7]
    for prec in MODES:
        assert torch.equal(pprec.dot(a, onehot, prec), pprec.dot_operand(a, prec)[:, :7])
    with pytest.raises(ValueError, match="highest"):
        pprec.dot(a, b, "fast")


def _check_band(got, want, prec, nonzero_grad=True):
    """got, want: (value, gradient outputs...), port and reference."""
    v0 = np.array(want[0], np.float64)
    v1 = got[0].double().numpy()
    val_rel, grad_rel = parity_error(v0, v0, v1, v1)[0], 0.0
    for g, w in zip(got[1:], want[1:]):
        grad_rel = max(grad_rel, parity_error(v0, np.array(w), v1, g.numpy())[1])
    tol_v, tol_g = PARITY_BANDS[prec]
    assert val_rel <= tol_v and grad_rel <= tol_g, (val_rel, grad_rel)
    if nonzero_grad:
        assert grad_rel > 0, "the precision changed nothing"


def _grouped_data(n=3000, d=5, groups=20, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.standard_normal((n, d)).astype(np.float32),
            "y": (rs.rand(n) < 0.4).astype(np.float32),
            "g": rs.randint(0, groups, size=n).astype(np.int32)}


def _b1_inputs(chains, d=5, groups=20):
    prep = phf.prepare_grouped(_grouped_data(d=d, groups=groups), d)
    rs = np.random.RandomState(chains)
    beta = (0.5 * rs.standard_normal((chains, d))).astype(np.float32)
    alpha = rs.standard_normal((chains, groups)).astype(np.float32)
    return prep, beta, alpha


def _b1_old_plain(beta, alpha, xT, y, gl, first_gid, lane_tile):
    """B1's plain version before the precisions: the bitwise yardstick
    of highest."""
    g = phf.absolute_groups(gl, first_gid, lane_tile)
    logits = beta @ xT + alpha[:, g]
    val_terms, resid = plf._link_parts(y, logits)
    galpha = torch.zeros_like(alpha).index_add_(1, g, resid)
    return val_terms.sum(-1), resid @ xT.T, galpha


@pytest.mark.parametrize("prec", MODES)
@pytest.mark.parametrize("chains", [1, 5])
def test_plain_b1_at_each_precision_matches_reference(chains, prec, monkeypatch):
    prep, beta, alpha = _b1_inputs(chains)
    monkeypatch.setenv(KNOB, prec)
    want = rhf._grouped_call(
        jnp.asarray(beta), jnp.asarray(alpha), jnp.asarray(prep["xT"]), jnp.asarray(prep["y"]),
        jnp.asarray(prep["gl"]), jnp.asarray(prep["first_gid"]), k_loc=prep["k_loc"],
        lane_tile=prep["lane_tile"], interpret=None)
    t = [torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")]
    args = (torch.as_tensor(beta), torch.as_tensor(alpha), *t, prep["lane_tile"])
    got = phf.hier_grouped(*args)  # the CPU wrapper: the plain version at the knob
    for a, b in zip(got, phf.hier_grouped_plain(*args, prec=prec)):
        assert torch.equal(a, b)
    _check_band(got, want, prec)


def test_plain_b1_at_highest_is_bitwise_the_old_plain_version(monkeypatch):
    monkeypatch.delenv(KNOB, raising=False)
    prep, beta, alpha = _b1_inputs(4)
    t = [torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")]
    args = (torch.as_tensor(beta), torch.as_tensor(alpha), *t, prep["lane_tile"])
    for a, b in zip(phf.hier_grouped(*args), _b1_old_plain(*args)):
        assert torch.equal(a, b)


def _b2_inputs(c, n=3000, d=5, seed=0, shards=None):
    rs = np.random.RandomState(seed)
    lead = (shards,) if shards else ()
    xT = rs.standard_normal(lead + (d, n)).astype(np.float32)
    y = (rs.rand(*lead, n) < 0.4).astype(np.float32)
    beta = (0.5 * rs.standard_normal(lead + (c, d))).astype(np.float32)
    off = rs.standard_normal(lead + (c, n)).astype(np.float32)
    return xT, y, beta, off


def _b2_gaussian_y(y, seed):
    return (y + np.random.RandomState(seed).standard_normal(y.shape)).astype(np.float32)


@pytest.mark.parametrize("prec", MODES)
@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
def test_plain_b2_at_each_precision_matches_reference(with_offsets, link, prec, monkeypatch):
    xT, y, beta, off = _b2_inputs(5, seed=3)
    if link == "gaussian":
        y = _b2_gaussian_y(y, 4)
    off = off if with_offsets else None
    monkeypatch.setenv(KNOB, prec)
    want = rlf._batched_call(
        jnp.asarray(beta), jnp.asarray(xT), jnp.asarray(y),
        None if off is None else jnp.asarray(off), lane_tile=None, interpret=None, link=link)
    args = [torch.as_tensor(beta), torch.as_tensor(xT), torch.as_tensor(y),
            None if off is None else torch.as_tensor(off)]
    got = plf.logistic_batched(*args, link)
    for a, b in zip(got, plf.logistic_batched_plain(*args, link, prec=prec)):
        assert torch.equal(a, b)
    _check_band(got, want, prec)


@pytest.mark.parametrize("prec", ["highest", *MODES])
def test_plain_b2_shard_axis_at_each_precision_is_each_shard_alone(prec, monkeypatch):
    """The shard axis: each shard against the reference's kernel on that
    shard alone (its consensus vmap), and bitwise the port's unsharded
    plain version per shard."""
    s = 3
    xT, y, beta, off = _b2_inputs(4, n=1000, seed=5, shards=s)
    monkeypatch.setenv(KNOB, prec)
    got = plf.logistic_batched(torch.as_tensor(beta), torch.as_tensor(xT), torch.as_tensor(y),
                               torch.as_tensor(off))
    for k in range(s):
        want = rlf._batched_call(jnp.asarray(beta[k]), jnp.asarray(xT[k]), jnp.asarray(y[k]),
                                 jnp.asarray(off[k]), lane_tile=None, interpret=None)
        flat = plf.logistic_batched_plain(torch.as_tensor(beta[k]), torch.as_tensor(xT[k]),
                                          torch.as_tensor(y[k]), torch.as_tensor(off[k]),
                                          prec=prec)
        for a, b in zip(got, flat):
            torch.testing.assert_close(a[k], b, rtol=1e-6, atol=1e-6)
        if prec != "highest":
            _check_band([t[k] for t in got], want, prec)


def test_plain_b2_at_highest_is_bitwise_the_old_plain_version(monkeypatch):
    monkeypatch.delenv(KNOB, raising=False)
    xT, y, beta, off = (torch.as_tensor(a) for a in _b2_inputs(4, seed=6))
    for link in ("bernoulli_logit", "gaussian"):
        logits = beta @ xT + off
        val_terms, resid = plf._link_parts(y, logits, link)
        old = (val_terms.sum(-1), resid @ xT.transpose(-1, -2), resid)
        for a, b in zip(plf.logistic_batched(beta, xT, y, off, link), old):
            assert torch.equal(a, b)


def _b4_inputs(chains, n=4000, d=4, groups=300, seed=5):
    rs = np.random.RandomState(seed)
    raw = {"x": rs.standard_normal((n, d)).astype(np.float32),
           "z": np.concatenate([np.ones((n, 1)), rs.standard_normal((n, Q - 1))],
                               1).astype(np.float32),
           "y": rs.standard_normal(n).astype(np.float32),
           "g": rs.randint(0, groups, size=n).astype(np.int32)}
    prep = phf.prepare_grouped(raw, d + Q, transpose_keys=("x", "z"))
    rs = np.random.RandomState(chains)
    params = ((0.3 * rs.standard_normal((chains, d))).astype(np.float32),
              (0.5 * rs.standard_normal((chains, groups, Q))).astype(np.float32),
              rs.standard_normal(chains).astype(np.float32))
    return prep, params


@pytest.mark.parametrize("prec", MODES)
@pytest.mark.parametrize("chains", [1, 3])
def test_plain_b4_at_each_precision_matches_reference(chains, prec, monkeypatch):
    prep, params = _b4_inputs(chains)
    layout = ("xT", "zT", "y", "gl", "first_gid")
    monkeypatch.setenv(KNOB, prec)
    want = rhf._grouped_lmm_call(
        *(jnp.asarray(p) for p in params), *(jnp.asarray(prep[k]) for k in layout),
        k_loc=prep["k_loc"], lane_tile=prep["lane_tile"], interpret=None)
    args = (*(torch.as_tensor(p) for p in params), *(torch.as_tensor(prep[k]) for k in layout),
            prep["lane_tile"])
    got = phf.lmm_grouped(*args)
    for a, b in zip(got, phf.lmm_grouped_plain(*args, prec=prec)):
        assert torch.equal(a, b)
    _check_band(got, want, prec)


def test_plain_b4_at_highest_is_bitwise_the_old_plain_version(monkeypatch):
    monkeypatch.delenv(KNOB, raising=False)
    prep, params = _b4_inputs(3)
    beta, u, ic = (torch.as_tensor(p) for p in params)
    xT, zT, y, gl, fg = (torch.as_tensor(prep[k]) for k in ("xT", "zT", "y", "gl", "first_gid"))
    g = phf.absolute_groups(gl, fg, prep["lane_tile"])
    mu = ic[:, None] + beta @ xT + torch.einsum("qn,cnq->cn", zT, u[:, g, :])
    resid = y - mu
    gu = torch.zeros_like(u).index_add_(1, g, resid[:, :, None] * zT.T[None])
    old = ((resid * resid).sum(-1), resid.sum(-1), resid @ xT.T, gu)
    for a, b in zip(phf.lmm_grouped(beta, u, ic, xT, zT, y, gl, fg, prep["lane_tile"]), old):
        assert torch.equal(a, b)


def test_a_knob_flipped_between_two_calls_changes_the_second(monkeypatch):
    prep, beta, alpha = _b1_inputs(3)
    t = [torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")]
    args = (torch.as_tensor(beta), torch.as_tensor(alpha), *t, prep["lane_tile"])
    monkeypatch.delenv(KNOB, raising=False)
    first = phf.hier_grouped(*args)
    outs = {}
    for prec in MODES:
        monkeypatch.setenv(KNOB, prec)
        outs[prec] = phf.hier_grouped(*args)
        assert not torch.equal(outs[prec][1], first[1]), prec
    assert not torch.equal(outs["high"][1], outs["default"][1])
    monkeypatch.setenv(KNOB, "highest")
    for a, b in zip(phf.hier_grouped(*args), first):
        assert torch.equal(a, b)


# --- the zoo's fused ops and the grouped models, through their potentials ---

def _synth(port_fn, *args, **kw):
    data, _ = port_fn(0, *args, **kw)
    return {k: np.asarray(v) for k, v in data.items()}


def _zoo_cases():
    from stark_tpu_torch.models import (
        synth_irt_data,
        synth_lmm_data,
        synth_logistic_data,
        synth_ordinal_data,
        synth_poisson_data,
        synth_studentt_data,
    )

    irt = _synth(synth_irt_data, 30, 12)
    keep = np.arange(30 * 12) % 3 != 0
    return {
        "poisson": (lambda m: m.FusedPoissonRegression(6), rglm, pglm,
                    lambda: _synth(synth_poisson_data, 2000, 6), None),
        "lmm": (lambda m: m.FusedLMM(3, 10, Q), rlmm, plmm,
                lambda: _synth(synth_lmm_data, 1500, 3, 10, num_random=Q), "STARK_FUSED_LMM"),
        "student_t": (lambda m: m.FusedStudentTRegression(5), rrob, prob,
                      lambda: _synth(synth_studentt_data, 2000, 5), "STARK_FUSED_ROBUST"),
        "ordinal": (lambda m: m.FusedOrderedLogistic(5, 4), rord, pord,
                    lambda: _synth(synth_ordinal_data, 2000, 5, num_categories=4),
                    "STARK_FUSED_ORDINAL"),
        "irt_grid": (lambda m: m.FusedIRT2PL(30, 12), rirt, pirt, lambda: irt, "STARK_FUSED_IRT"),
        "irt_triples": (lambda m: m.FusedIRT2PL(30, 12), rirt, pirt,
                        lambda: {k: v[keep] for k, v in irt.items()}, "STARK_FUSED_IRT"),
        "hier_grouped": (lambda m: m.FusedHierLogisticGrouped(4, 12), rlog, plog,
                         lambda: _synth(synth_logistic_data, 3000, 4, num_groups=12), None),
        "lmm_grouped": (lambda m: m.FusedLinearMixedModelGrouped(3, 40, Q), rlmm, plmm,
                        lambda: _synth(synth_lmm_data, 2000, 3, 40, num_random=Q), None),
    }


@pytest.mark.parametrize("prec", MODES)
@pytest.mark.parametrize("name", list(_zoo_cases()))
def test_fused_potential_at_each_precision_matches_reference(name, prec, monkeypatch):
    make, rmod, pmod, raw_fn, knob = _zoo_cases()[name]
    if knob:
        monkeypatch.setenv(knob, "1")
    monkeypatch.setenv(KNOB, prec)
    raw = raw_fn()
    rmodel, pmodel = make(rmod), make(pmod)
    rdata = ref_prepare(rmodel, raw)
    pdata = prepare_model_data(pmodel, raw, device="cpu")
    if name == "irt_grid":
        assert "y_grid" in pdata and "y_grid" in rdata
    if name == "irt_triples":
        assert "y_grid" not in pdata
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    z = (0.3 * np.random.RandomState(7).standard_normal((3, pfm.ndim))).astype(np.float32)
    rv, rg = jax.vmap(jax.value_and_grad(lambda q: rfm.potential(q, rdata)))(jnp.asarray(z))
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
    # the IRT triples take no dot: the knob leaves them as they are
    _check_band((pv, pg), (rv, rg), prec, nonzero_grad=name != "irt_triples")
    if name == "irt_triples":
        monkeypatch.setenv(KNOB, "highest")
        hv, hg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
        assert torch.equal(hv, pv) and torch.equal(hg, pg)
