"""The port's ordered logistic and IRT 2PL models (`stark_tpu_torch.models.
ordinal`, `models.irt`) and their fused ops (`ops.ordinal_fused`,
`ops.irt_fused`: the grid and the triples paths) against the JAX
package's.

Inputs come from the reference's recipes, ``prepare_model_data`` and
``flatten_model``, and cross as numpy through `stark_tpu_torch.interop`.
Tolerances are the reference's for the fused zoo (tests/test_zoo_fused.
py:87-92): value rtol 1e-5 / atol 1e-4; gradients scaled by the largest
magnitude of the reference's (per chain), rtol 1e-4 / atol 2e-5; the
densities at rtol 1e-5 / atol 1e-5 (see tests/test_torch_zoo_robust.py).
With the knob off a fused model is its plain model bit for bit; the
autograd backward of a fused op equals its direct value-and-grad bit for
bit, and a second call repeats it (the segment sums are deterministic).
Posterior recovery (slow) at the reference's thresholds
(tests/test_model_zoo.py:84-102, :132-150).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import irt as rirt
from stark_tpu.models import ordinal as rord
from stark_tpu.ops import irt_fused as rif
from stark_tpu.ops import ordinal_fused as rof
from stark_tpu_torch import sample
from stark_tpu_torch.interop import data_from_reference
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import irt as pirt
from stark_tpu_torch.models import ordinal as pord
from stark_tpu_torch.ops import irt_fused as pif
from stark_tpu_torch.ops import ordinal_fused as pof
from test_torch_zoo_robust import (  # noqa: F401 (autouse: zoo knobs unset)
    C,
    VAL_ATOL,
    VAL_RTOL,
    _zoo_knobs_unset,
    check_against_reference,
    check_shard_batch,
    close_scaled,
    host,
    points,
)

KEY = jax.random.PRNGKey(0)
P, I, D, K = 40, 15, 5, 4


def _ordinal_raw():
    data, _ = rord.synth_ordinal_data(KEY, 600, D, num_categories=K)
    return host(data)


def _irt_raw():
    data, _ = rirt.synth_irt_data(KEY, P, I)
    return host(data)


def _ragged(raw):
    """tests/test_zoo_fused.py:250: every third response dropped."""
    keep = np.arange(raw["y"].shape[0]) % 3 != 0
    return {k: v[keep] for k, v in raw.items()}


#: case -> (model name, data, knob to set, expected layout key)
CASES = {
    "OrderedLogistic": ("OrderedLogistic", _ordinal_raw, None, "x"),
    "FusedOrderedLogistic knob on": ("FusedOrderedLogistic", _ordinal_raw,
                                     "STARK_FUSED_ORDINAL", "xT"),
    "FusedOrderedLogistic knob off": ("FusedOrderedLogistic", _ordinal_raw, None, "x"),
    "IRT2PL": ("IRT2PL", _irt_raw, None, "person"),
    "FusedIRT2PL grid": ("FusedIRT2PL", _irt_raw, "STARK_FUSED_IRT", "y_grid"),
    "FusedIRT2PL knob off": ("FusedIRT2PL", _irt_raw, None, "person"),
    "FusedIRT2PL ragged triples": ("FusedIRT2PL", lambda: _ragged(_irt_raw()),
                                   "STARK_FUSED_IRT", "person"),
}


def _models(name):
    if "Ordered" in name:
        return getattr(rord, name)(D, K), getattr(pord, name)(D, K)
    return getattr(rirt, name)(P, I), getattr(pirt, name)(P, I)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_reference(case, monkeypatch):
    name, raw, knob, key = CASES[case]
    if knob:
        monkeypatch.setenv(knob, "1")
    rmodel, pmodel = _models(name)
    rdata, pdata, _ = check_against_reference(rmodel, pmodel, raw())
    assert key in rdata and key in pdata


# ------------------------------------------------------------ ordinal op


def _ordinal_op_inputs(seed=1, gap=None):
    raw = _ordinal_raw()
    rs = np.random.RandomState(seed)
    f32 = np.float32
    cuts = np.sort(rs.uniform(-2.0, 2.0, (C, K - 1)), -1).astype(f32)
    if gap is not None:  # the middle gap below the clamp floor
        cuts[:, 2] = cuts[:, 1] + f32(gap)
    return ((0.5 * rs.standard_normal((C, D))).astype(f32), cuts), (
        np.ascontiguousarray(raw["x"].T), raw["y"])


@pytest.mark.parametrize("gap", [None, 2e-7])
def test_ordinal_op_matches_reference(gap):
    """The direct value-and-grad against the reference's, chain by chain;
    with a cutpoint gap where the clamp saturates, both gradients lose
    the log1p correction the same way (and agree with autograd through
    the port's plain density)."""
    params, data = _ordinal_op_inputs(gap=gap)
    t = [torch.as_tensor(a) for a in params + data]
    val, grads = pof.ordinal_loglik_value_and_grad(*t)
    assert val.shape == (C,) and [g.shape for g in grads] == [(C, D), (C, K - 1)]
    for c in range(C):
        rval, rgrads = rof.ordinal_loglik_value_and_grad(
            *[jnp.asarray(p[c]) for p in params], *[jnp.asarray(a) for a in data])
        np.testing.assert_allclose(val[c].numpy(), np.asarray(rval), rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        want = np.concatenate([np.ravel(g) for g in rgrads])
        got = np.concatenate([g[c].reshape(-1).numpy() for g in grads])
        close_scaled(got[None], want[None], f"d/d(beta, cutpoints), chain {c}")
    leaves = [p.clone().requires_grad_(True) for p in t[:2]]
    plain = pord.OrderedLogistic(D, K).log_lik(
        {"beta": leaves[0], "cutpoints": leaves[1]}, {"xT": t[2], "y": t[3]})
    auto = torch.autograd.grad(plain.sum(), leaves)
    np.testing.assert_allclose(val.numpy(), plain.detach().numpy(), rtol=VAL_RTOL)
    close_scaled(torch.cat(grads, -1).numpy(), torch.cat(auto, -1).numpy(), "against autograd")
    # one chain without the chain axis
    v1, g1 = pof.ordinal_loglik_value_and_grad(t[0][3], t[1][3], *t[2:])
    np.testing.assert_allclose(v1.numpy(), val[3].numpy(), rtol=1e-6)
    for a, b in zip(g1, grads):
        np.testing.assert_allclose(a.numpy(), b[3].numpy(), rtol=1e-5, atol=1e-5)


def test_ordinal_bins_are_exact():
    """A row's cutpoints, taken by a product with its one-hot bin, are
    exactly the reference's gather (the pads included)."""
    (_, cuts), (_, y) = _ordinal_op_inputs(seed=4)
    y = torch.as_tensor(y)
    cpad = pof.pad_cutpoints(torch.as_tensor(cuts))
    lo, up = pof.category_onehots(y, K + 1, torch.float32)
    want = cpad[:, y.long()]
    assert torch.equal(pof.take_bins(cpad, lo), want)
    assert torch.equal(pof.take_bins(cpad, up), cpad[:, y.long() + 1])
    assert float(cpad[0, 0]) == -1e9 and float(cpad[0, -1]) == 1e9


def test_ordinal_backward_equals_direct_and_repeats_bitwise():
    params, data = _ordinal_op_inputs(seed=2)
    data = [torch.as_tensor(a) for a in data]
    leaves = [torch.as_tensor(p).requires_grad_(True) for p in params]
    val = pof.ordinal_loglik(*leaves, *data)
    got = torch.autograd.grad(val.sum(), leaves)
    dval, dgrads = pof.ordinal_loglik_value_and_grad(*[p.detach() for p in leaves], *data)
    assert torch.equal(val.detach(), dval)
    assert all(torch.equal(a, b) for a, b in zip(got, dgrads))
    again = pof.ordinal_loglik_value_and_grad(*[p.detach() for p in leaves], *data)
    assert torch.equal(again[0], dval) and all(
        torch.equal(a, b) for a, b in zip(again[1], dgrads))


# ------------------------------------------------------------ IRT ops


def _irt_params(seed=1):
    rs = np.random.RandomState(seed)
    f32 = np.float32
    return (rs.standard_normal((C, P)).astype(f32), rs.uniform(0.3, 2.5, (C, I)).astype(f32),
            rs.standard_normal((C, I)).astype(f32))


@pytest.mark.parametrize("layout", ["grid", "triples", "ragged"])
def test_irt_ops_match_reference(layout):
    raw = _irt_raw()
    if layout == "ragged":
        raw = _ragged(raw)
    params = _irt_params()
    if layout == "grid":
        data = (raw["y"].reshape(P, I),)
        port, ref = pif.irt_grid_loglik_value_and_grad, rif.irt_grid_loglik_value_and_grad
    else:
        data = (raw["person"], raw["item"], raw["y"])
        port, ref = pif.irt_loglik_value_and_grad, rif.irt_loglik_value_and_grad
    t = [torch.as_tensor(a) for a in params + data]
    val, grads = port(*t)
    assert val.shape == (C,) and [g.shape for g in grads] == [(C, P), (C, I), (C, I)]
    for c in range(C):
        rval, rgrads = ref(*[jnp.asarray(p[c]) for p in params], *[jnp.asarray(a) for a in data])
        np.testing.assert_allclose(val[c].numpy(), np.asarray(rval), rtol=VAL_RTOL,
                                   atol=VAL_ATOL)
        want = np.concatenate([np.ravel(g) for g in rgrads])
        got = np.concatenate([g[c].reshape(-1).numpy() for g in grads])
        close_scaled(got[None], want[None], f"{layout} d/d(theta, a, b), chain {c}")
    v1, g1 = port(*[p[0] for p in t[:3]], *t[3:])  # one chain, no chain axis
    np.testing.assert_allclose(v1.numpy(), val[0].numpy(), rtol=1e-6)
    for a, b in zip(g1, grads):
        np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["grid", "triples"])
def test_irt_backward_equals_direct_and_repeats_bitwise(layout):
    raw = _irt_raw()
    if layout == "grid":
        data = (torch.as_tensor(raw["y"].reshape(P, I)),)
        op, vg = pif.irt_grid_loglik, pif.irt_grid_loglik_value_and_grad
    else:
        data = tuple(torch.as_tensor(raw[k]) for k in ("person", "item", "y"))
        op, vg = pif.irt_loglik, pif.irt_loglik_value_and_grad
    leaves = [torch.as_tensor(p).requires_grad_(True) for p in _irt_params(seed=2)]
    val = op(*leaves, *data)
    got = torch.autograd.grad(val.sum(), leaves)
    dval, dgrads = vg(*[p.detach() for p in leaves], *data)
    assert torch.equal(val.detach(), dval)
    assert all(torch.equal(a, b) for a, b in zip(got, dgrads))
    again = vg(*[p.detach() for p in leaves], *data)
    assert torch.equal(again[0], dval) and all(
        torch.equal(a, b) for a, b in zip(again[1], dgrads))


def test_irt_triples_segment_sums_give_zero_to_ids_without_rows():
    """Persons and items without a response get a gradient of exactly 0
    (the reference's segment_sum), the others the reference's sums."""
    raw = _irt_raw()
    keep = (raw["person"] % 7 != 3) & (raw["item"] != 4)
    raw = {k: v[keep] for k, v in raw.items()}
    params = _irt_params(seed=3)
    data = (raw["person"], raw["item"], raw["y"])
    _, grads = pif.irt_loglik_value_and_grad(*[torch.as_tensor(a) for a in params + data])
    assert not grads[0][:, np.arange(P) % 7 == 3].any()
    assert not grads[1][:, 4].any() and not grads[2][:, 4].any()
    _, rgrads = rif.irt_loglik_value_and_grad(*[jnp.asarray(p[0]) for p in params],
                                              *[jnp.asarray(a) for a in data])
    close_scaled(grads[0][:1].numpy(), np.asarray(rgrads[0])[None], "d/dtheta")


# ------------------------------------------------------------ the fused models


FUSED = {
    "ordinal": ("OrderedLogistic", "FusedOrderedLogistic", _ordinal_raw, "STARK_FUSED_ORDINAL",
                "xT"),
    "irt": ("IRT2PL", "FusedIRT2PL", _irt_raw, "STARK_FUSED_IRT", "y_grid"),
}


@pytest.mark.parametrize("family", list(FUSED))
def test_fused_matches_plain_knob_on(family, monkeypatch):
    """tests/test_zoo_fused.py:73-91 on the port: the fused model (knob
    on) against its plain model's autograd."""
    plain_name, fused_name, raw, knob, _ = FUSED[family]
    monkeypatch.setenv(knob, "1")
    raw = raw()
    (_, plain), (_, fused) = _models(plain_name), _models(fused_name)
    fp, ff = flatten_model(plain), flatten_model(fused)
    z = torch.as_tensor(points(fp.ndim, seed=4))
    vp, gp = fp.potential_and_grad(z, prepare_model_data(plain, raw, device="cpu"))
    vf, gf = ff.potential_and_grad(z, prepare_model_data(fused, raw, device="cpu"))
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(gf.numpy(), gp.numpy(), "fused against plain")


@pytest.mark.parametrize("family", list(FUSED))
def test_knob_off_bit_identity(family):
    plain_name, fused_name, raw, knob, key = FUSED[family]
    raw = raw()
    (_, plain), (_, fused) = _models(plain_name), _models(fused_name)
    assert fused.fused_tag() is None
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    assert sorted(dp) == sorted(df) and key not in df
    assert fused.data_row_axes(df) == plain.data_row_axes(dp) == {k: 0 for k in dp}
    z = torch.as_tensor(points(flatten_model(plain).ndim, seed=7))
    vp, gp = flatten_model(plain).potential_and_grad(z, dp)
    vf, gf = flatten_model(fused).potential_and_grad(z, df)
    assert torch.equal(vp, vf) and torch.equal(gp, gf)


@pytest.mark.parametrize("family", list(FUSED))
def test_knob_off_after_fused_prepare(family, monkeypatch):
    plain_name, fused_name, raw, knob, key = FUSED[family]
    monkeypatch.setenv(knob, "1")
    raw = raw()
    (_, plain), (_, fused) = _models(plain_name), _models(fused_name)
    dp = prepare_model_data(plain, raw, device="cpu")
    df = prepare_model_data(fused, raw, device="cpu")
    assert key in df and fused.fused_tag() == family
    z = torch.as_tensor(points(flatten_model(plain).ndim, seed=3))
    monkeypatch.setenv(knob, "0")
    assert fused.fused_tag() is None
    v0, g0 = flatten_model(fused).potential_and_grad(z, df)
    vp, gp = flatten_model(plain).potential_and_grad(z, dp)
    np.testing.assert_allclose(v0.numpy(), vp.numpy(), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(g0.numpy(), gp.numpy(), "knob off on the fused layout")


def test_irt_ragged_triples_fused(monkeypatch):
    """tests/test_zoo_fused.py:246-263: an incomplete response set keeps
    the triples and still takes the fused op, matching autograd."""
    monkeypatch.setenv("STARK_FUSED_IRT", "1")
    raw = _ragged(_irt_raw())
    plain, fused = pirt.IRT2PL(P, I), pirt.FusedIRT2PL(P, I)
    df = prepare_model_data(fused, raw, device="cpu")
    assert "y_grid" not in df and sorted(df) == ["item", "person", "y"]
    calls = []
    real = pif.irt_loglik
    monkeypatch.setattr(pif, "irt_loglik", lambda *a: calls.append(1) or real(*a))
    z = torch.as_tensor(points(flatten_model(plain).ndim, seed=2))
    vp, gp = flatten_model(plain).potential_and_grad(
        z, prepare_model_data(plain, raw, device="cpu"))
    vf, gf = flatten_model(fused).potential_and_grad(z, df)
    assert calls == [1]
    np.testing.assert_allclose(vf.numpy(), vp.numpy(), rtol=1e-5)
    np.testing.assert_allclose(gf.numpy(), gp.numpy(), rtol=1e-4, atol=1e-4)


def test_irt_grid_layout_refuses_row_split(monkeypatch):
    """tests/test_zoo_fused.py:266-284: the grid pins y_grid's rows to
    theta; its row axes raise the reference's message, the triples keep
    axis 0."""
    monkeypatch.setenv("STARK_FUSED_IRT", "1")
    raw = _irt_raw()
    rmodel, pmodel = _models("FusedIRT2PL")
    df = prepare_model_data(pmodel, raw, device="cpu")
    assert "y_grid" in df
    with pytest.raises(NotImplementedError, match="grid layout") as got:
        pmodel.data_row_axes(df)
    with pytest.raises(NotImplementedError) as want:
        rmodel.data_row_axes(ref_prepare(rmodel, raw))
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("STARK_FUSED_IRT", "0")
    dt = prepare_model_data(pmodel, raw, device="cpu")
    assert pmodel.data_row_axes(dt) == {"person": 0, "item": 0, "y": 0}


def test_prepare_grid_only_on_the_full_person_major_matrix(monkeypatch):
    """The grid is made only from the complete response set in
    person-major order, as the reference's check; any other order or a
    missing response keeps the triples; grid data pass through again."""
    monkeypatch.setenv("STARK_FUSED_IRT", "1")
    raw = _irt_raw()
    grid = pif.prepare_grid(raw, P, I)
    np.testing.assert_array_equal(grid["y_grid"], np.asarray(
        rif.prepare_grid(raw, P, I)["y_grid"]))
    assert pif.prepare_grid(grid, P, I) is grid
    perm = np.random.RandomState(0).permutation(P * I)
    for other in ({k: v[perm] for k, v in raw.items()}, _ragged(raw),
                  {**raw, "item": raw["item"][::-1].copy()}):
        assert pif.prepare_grid(other, P, I) is other
        assert "y_grid" not in rif.prepare_grid(other, P, I)


@pytest.mark.parametrize("name,knob", [("OrderedLogistic", None),
                                       ("FusedOrderedLogistic", "STARK_FUSED_ORDINAL")])
def test_ordinal_shard_batched_likelihood_matches_reference(name, knob, monkeypatch):
    if knob:
        monkeypatch.setenv(knob, "1")
    rmodel, pmodel = _models(name)
    check_shard_batch(rmodel, pmodel, _ordinal_raw())


def test_irt_reads_shards_one_at_a_time():
    """IRT2PL's gathers index a chain's own persons and items, so it does
    not declare a shard-batched likelihood: consensus hands it one shard
    at a time, each against the reference's vmap over shards."""
    rmodel, pmodel = _models("IRT2PL")
    assert not pmodel.shard_batched_lik and not pmodel.chain_batched_lik
    from test_torch_zoo_robust import ref_shards
    from stark_tpu_torch.parallel import consensus as pcons

    S = C
    raw = _irt_raw()
    rshard = ref_shards(rmodel, raw, S)
    pshard = pcons.shard_data(pmodel, raw, S, "cpu")
    rfm = ref_flatten(rmodel, prior_scale=1.0 / S)
    pfm = flatten_model(pmodel, prior_scale=1.0 / S)
    z = (0.4 * np.random.RandomState(9).standard_normal((S, C, pfm.ndim))).astype(np.float32)
    vg = jax.vmap(jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None)),
                  in_axes=(0, 0))
    rv, rg = vg(jnp.asarray(z), rshard)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pshard)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL, atol=VAL_ATOL)
    close_scaled(pg.numpy().reshape(S * C, -1), np.asarray(rg).reshape(S * C, -1), "shards")


def test_synth_ordinal_recipe():
    n, d = 20_000, 4
    data, true = pord.synth_ordinal_data(0, n, d, num_categories=5)
    again, _ = pord.synth_ordinal_data(0, n, d, num_categories=5)
    rdata, rtrue = rord.synth_ordinal_data(KEY, n, d, num_categories=5)
    assert sorted(data) == sorted(rdata) and sorted(true) == sorted(rtrue)
    assert data["x"].dtype == data["y"].dtype == true["cutpoints"].dtype == np.float32
    assert true["cutpoints"].shape == (4,) and np.all(np.diff(true["cutpoints"]) > 0)
    np.testing.assert_array_equal(again["y"], data["y"])
    assert set(np.unique(data["y"])) == {0.0, 1.0, 2.0, 3.0, 4.0}
    # the cutpoints split eta into equal fifths
    eta = data["x"] @ true["beta"]
    shares = np.histogram(eta, bins=np.r_[-np.inf, true["cutpoints"], np.inf])[0] / n
    np.testing.assert_allclose(shares, 0.2, atol=0.002)


def test_synth_irt_recipe():
    data, true = pirt.synth_irt_data(0, 300, 40)
    again, _ = pirt.synth_irt_data(0, 300, 40)
    rdata, rtrue = rirt.synth_irt_data(KEY, 300, 40)
    assert sorted(data) == sorted(rdata) and sorted(true) == sorted(rtrue)
    for k in data:
        assert data[k].dtype == np.asarray(rdata[k]).dtype and data[k].shape == (12_000,)
        np.testing.assert_array_equal(again[k], data[k])
    np.testing.assert_array_equal(data["person"], np.asarray(rdata["person"]))
    np.testing.assert_array_equal(data["item"], np.asarray(rdata["item"]))
    assert np.all(true["a"] > 0) and abs(np.log(true["a"]).std() - 0.5) < 0.2
    p = 1.0 / (1.0 + np.exp(-true["a"][data["item"]] * (true["theta"][data["person"]]
                                                        - true["b"][data["item"]])))
    assert abs(data["y"].mean() - p.mean()) < 0.02


@pytest.mark.slow
@pytest.mark.parametrize("name", ["OrderedLogistic", "FusedOrderedLogistic"])
def test_ordered_logistic_recovers_truth(name, monkeypatch):
    """tests/test_model_zoo.py:84-102 on the port: N=4096, D=3, K=5, 2
    chains, NUTS depth 6, 300 + 300: R-hat < 1.05, beta within 0.2,
    ordered cutpoints within 0.3."""
    monkeypatch.setenv("STARK_FUSED_ORDINAL", "1")
    data, true = pord.synth_ordinal_data(3, 4096, 3, num_categories=5)
    post = sample(getattr(pord, name)(3, 5), data, chains=2, kernel="nuts", max_tree_depth=6,
                  num_warmup=300, num_samples=300, seed=0, device="cpu")
    assert post.max_rhat() < 1.05
    np.testing.assert_allclose(post.draws["beta"].mean((0, 1)), true["beta"], atol=0.2)
    cuts = post.draws["cutpoints"].mean((0, 1))
    assert np.all(np.diff(cuts) > 0)
    np.testing.assert_allclose(cuts, true["cutpoints"], atol=0.3)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["IRT2PL", "FusedIRT2PL"])
def test_irt_2pl_recovers_truth(name, monkeypatch):
    """tests/test_model_zoo.py:132-150 on the port: 60 persons x 20
    items, 2 chains, NUTS depth 7, 400 + 400: R-hat < 1.06, corr(theta)
    and corr(b) > 0.85, every a > 0."""
    monkeypatch.setenv("STARK_FUSED_IRT", "1")
    data, true = pirt.synth_irt_data(5, 60, 20)
    post = sample(getattr(pirt, name)(60, 20), data, chains=2, kernel="nuts", max_tree_depth=7,
                  num_warmup=400, num_samples=400, seed=0, device="cpu")
    assert post.max_rhat() < 1.06
    th = post.draws["theta"].mean((0, 1))
    assert np.corrcoef(th, true["theta"])[0, 1] > 0.85
    assert np.corrcoef(post.draws["b"].mean((0, 1)), true["b"])[0, 1] > 0.85
    assert np.all(post.draws["a"] > 0)
