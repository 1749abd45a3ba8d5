"""Port of the hierarchical linear mixed model (BASELINE config 3) and its
grouped kernel (B4) against the JAX package.

Inputs come from the reference (`synth_lmm_data` with a ``jax.random``
key) and cross as numpy, through `interop` where they are prepared
data.  The grouped layout must be bit-identical; the plain version of
B4 must match the reference's Pallas kernel (`_grouped_lmm_call`,
interpret mode on the CPU); the three models' potentials and gradients
must match the reference's `flatten_model` potentials.  Tolerances are
the reference's for the LMM (tests/test_hier_fused.py): value rtol 2e-5;
gradients rtol 3e-4 / atol 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import lmm as rlmm
from stark_tpu.ops import hier_fused as rhf
from stark_tpu_torch import prepare_model_data, sample
from stark_tpu_torch.interop import data_from_reference
from stark_tpu_torch.model import flatten_model, normal_logpdf
from stark_tpu_torch.models import lmm as plmm
from stark_tpu_torch.ops import hier_fused as phf

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 3e-4, 3e-4
Q = 2


def _ref_data(n, d, groups, seed):
    data, _ = rlmm.synth_lmm_data(jax.random.PRNGKey(seed), n, d, groups)
    return {k: np.asarray(v) for k, v in data.items()}


def _numpy(prep):
    return {k: np.asarray(v) for k, v in prep.items()}


# dense grouping (~8 rows a group) that shrinks the tile, as the
# reference's own LMM test uses; and one row per group, which defeats it
_DENSE = (12_343, 5, 1500)


def test_grouped_layout_bit_identical_and_shrinks_the_tile():
    n, d, groups = _DENSE
    raw = _ref_data(n, d, groups, seed=3)
    want = _numpy(rhf.prepare_grouped(raw, d + Q, transpose_keys=("x", "z")))
    got = phf.prepare_grouped(raw, d + Q, transpose_keys=("x", "z"))
    assert got["lane_tile"] == 128 * want["lt128"].shape[0]
    assert got["k_loc"] == want["k_loc"].shape[0]
    assert got["lane_tile"] < phf.grouped_lane_tile(d + Q)
    assert sorted(set(got) - {"lane_tile", "k_loc"}) == sorted(
        set(want) - {"lt128", "k_loc"}
    )
    for k in ("xT", "zT", "y", "g", "gl", "first_gid"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_grouping_that_defeats_the_layout_falls_back_in_both():
    n, d = 3000, 3
    raw = _ref_data(n, d, 10, seed=1)
    raw["g"] = np.arange(n, dtype=np.int32)  # one row per group
    assert rhf.prepare_grouped(raw, d + Q, transpose_keys=("x", "z")) is None
    assert phf.prepare_grouped(raw, d + Q, transpose_keys=("x", "z")) is None
    rmodel = rlmm.FusedLinearMixedModelGrouped(num_features=d, num_groups=n)
    pmodel = plmm.FusedLinearMixedModelGrouped(d, n)
    rdata = _numpy(ref_prepare(rmodel, raw))
    pdata = prepare_model_data(pmodel, raw, device="cpu")
    assert "offsets_path" in rdata and pdata["offsets_path"] is True
    assert "gl" not in pdata and "xT" in pdata and "z" in pdata
    carried = data_from_reference(rdata, device="cpu")
    assert carried["offsets_path"] is True
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    z = (0.2 * np.random.RandomState(4).standard_normal((2, pfm.ndim))).astype(np.float32)
    rv, rg = jax.vmap(jax.value_and_grad(lambda q: rfm.potential(q, rdata)))(jnp.asarray(z))
    for data in (carried, pdata):
        pv, pg = pfm.potential_and_grad(torch.as_tensor(z), data)
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _b4_params(c, d, groups, seed):
    rs = np.random.RandomState(seed)
    beta = (0.3 * rs.standard_normal((c, d))).astype(np.float32)
    u = (0.5 * rs.standard_normal((c, groups, Q))).astype(np.float32)
    ic = rs.standard_normal(c).astype(np.float32)
    return beta, u, ic


@pytest.mark.parametrize("chains", [1, 3])
def test_plain_b4_matches_reference_kernel(chains):
    n, d, groups = _DENSE
    prep = phf.prepare_grouped(_ref_data(n, d, groups, seed=5), d + Q, transpose_keys=("x", "z"))
    beta, u, ic = _b4_params(chains, d, groups, seed=chains)
    layout = ("xT", "zT", "y", "gl", "first_gid")
    want = rhf._grouped_lmm_call(
        jnp.asarray(beta), jnp.asarray(u), jnp.asarray(ic),
        *(jnp.asarray(prep[k]) for k in layout),
        k_loc=prep["k_loc"], lane_tile=prep["lane_tile"], interpret=None,
    )
    got = phf.lmm_grouped(
        torch.as_tensor(beta), torch.as_tensor(u), torch.as_tensor(ic),
        *(torch.as_tensor(prep[k]) for k in layout), prep["lane_tile"],
    )
    assert [tuple(t.shape) for t in got] == [(chains,), (chains,), (chains, d), (chains, groups, Q)]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


_MODELS = {
    "grouped": (rlmm.FusedLinearMixedModelGrouped, plmm.FusedLinearMixedModelGrouped),
    "offset": (rlmm.FusedLinearMixedModel, plmm.FusedLinearMixedModel),
    "plain": (rlmm.LinearMixedModel, plmm.LinearMixedModel),
}


@pytest.mark.parametrize("name", list(_MODELS))
def test_potential_value_and_grad_match_reference(name):
    """Fixed flat points (C=4); the reference's prepared data carried
    across with interop, and the port's own prepare on the same raw data."""
    d, groups = 4, 300
    rmodel, pmodel = (cls(num_features=d, num_groups=groups) for cls in _MODELS[name])
    raw = _ref_data(3000, d, groups, seed=2)
    rdata = ref_prepare(rmodel, raw)
    rfm, pfm = ref_flatten(rmodel), flatten_model(pmodel)
    assert pfm.ndim == rfm.ndim == 1 + d + groups * Q + Q + 1
    z = (0.3 * np.random.RandomState(1).standard_normal((4, pfm.ndim))).astype(np.float32)
    rv, rg = jax.vmap(jax.value_and_grad(lambda q: rfm.potential(q, rdata)))(jnp.asarray(z))
    carried = data_from_reference(_numpy(rdata), device="cpu")
    own = prepare_model_data(pmodel, raw, device="cpu")
    if name == "grouped":
        assert "gl" in own and "gl" in carried
    for pdata in (carried, own):
        pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pdata)
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_lmm_autograd_backward_is_cotangent_times_forward_grads():
    d, groups, c = 4, 200, 3
    prep = phf.prepare_grouped(_ref_data(2500, d, groups, seed=6), d + Q, transpose_keys=("x", "z"))
    layout = [torch.as_tensor(prep[k]) for k in ("xT", "zT", "y", "gl", "first_gid")]
    beta, u, ic = (torch.as_tensor(a) for a in _b4_params(c, d, groups, seed=8))
    sigma = torch.tensor([0.6, 1.0, 1.4])
    leaves = [t.clone().requires_grad_(True) for t in (beta, u, ic, sigma)]
    val = phf.lmm_grouped_loglik(*leaves, *layout, prep["lane_tile"])
    ct = torch.tensor([1.0, -2.0, 0.5])
    val.backward(ct)
    ssr, sres, gb, gu = phf.lmm_grouped(beta, u, ic, *layout, prep["lane_tile"])
    s = ct / (sigma * sigma)
    torch.testing.assert_close(leaves[0].grad, s[:, None] * gb, rtol=1e-6, atol=0)
    torch.testing.assert_close(leaves[1].grad, s[:, None, None] * gu, rtol=1e-6, atol=0)
    torch.testing.assert_close(leaves[2].grad, s * sres, rtol=1e-6, atol=0)
    # value and sigma against autograd of the plain Normal log-density
    s2 = sigma.clone().requires_grad_(True)
    xT, zT, y, gl, fg = layout
    g = phf.absolute_groups(gl, fg, prep["lane_tile"])
    mu = ic[:, None] + beta @ xT + torch.einsum("qn,cnq->cn", zT, u[:, g, :])
    plain = normal_logpdf(y, mu, s2[:, None]).sum(-1)
    (plain * ct).sum().backward()
    torch.testing.assert_close(val.detach(), plain.detach(), rtol=VAL_RTOL, atol=0)
    torch.testing.assert_close(leaves[3].grad, s2.grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # one chain without the leading axis is the C=1 batch
    one = phf.lmm_grouped_loglik(beta[0], u[0], ic[0], sigma[0], *layout, prep["lane_tile"])
    assert one.shape == () and float(one.detach()) == float(val[0].detach())


@pytest.mark.parametrize(
    "n", [1, 50, 127, 128, 129, 3001, 40_003, 50_687, 50_688, 50_689, 100_000, 100_037]
)
def test_b4_block_split_covers_rows_once_in_whole_subtiles(n):
    """The row split of B4 (csrc/lmm_grouped.cu): every row in exactly one
    block, block edges on sub-tile boundaries, at most B4_BLOCKS blocks
    within one sub-tile of each other, and the same split on every call:
    a function of N alone."""
    nblk, edges = phf.b4_blocks(n)
    assert phf.b4_blocks(n) == (nblk, edges)
    tile = phf.B4_ROW_TILE
    nsub = -(-n // tile)
    assert nblk == min(phf.B4_BLOCKS, nsub) and len(edges) == nblk + 1
    assert edges[0] == 0 and edges[-1] == n
    owner = np.repeat(np.arange(nblk), np.diff(edges))
    assert owner.shape == (n,) and np.all(np.diff(owner) >= 0)  # each row once, in order
    assert all(e % tile == 0 for e in edges[:-1])
    subtiles = [-(-(b - a) // tile) for a, b in zip(edges[:-1], edges[1:])]
    assert min(subtiles) >= 1 and max(subtiles) - min(subtiles) <= 1
    assert sum(subtiles) == nsub


@pytest.mark.parametrize("nblk,c,d,q", [(1, 1, 1, 2), (396, 16, 8, 2), (7, 33, 9, 3)])
def test_b4_scratch_tiles_the_buffer_with_each_partial(nblk, c, d, q):
    """B4's scratch (csrc/lmm_grouped.cu:carve): the partials one after
    another in B4_PARTIALS order, each its own size, nothing between or
    after them."""
    offsets, words = phf.b4_scratch(nblk, c, d, q)
    assert tuple(offsets) == phf.B4_PARTIALS
    sizes = {"gpart": nblk * c * d, "vpart": nblk * c, "rpart": nblk * c,
             "head": nblk * c * q, "tail": nblk * c * q, "blo": nblk, "bhi": nblk}
    o = 0
    for name in phf.B4_PARTIALS:
        assert offsets[name] == o, name
        o += sizes[name]
    assert words == o


def test_lmm_grouped_on_cpu_is_the_plain_version_and_counts_no_launch():
    n, d, groups = _DENSE
    prep = phf.prepare_grouped(_ref_data(n, d, groups, seed=5), d + Q, transpose_keys=("x", "z"))
    args = [torch.as_tensor(a) for a in _b4_params(2, d, groups, seed=2)]
    args += [torch.as_tensor(prep[k]) for k in ("xT", "zT", "y", "gl", "first_gid")]
    before = phf.lmm_grouped.launches
    got = phf.lmm_grouped(*args, prep["lane_tile"])
    want = phf.lmm_grouped_plain(*args, prep["lane_tile"])
    assert phf.lmm_grouped.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_synth_lmm_data_is_seeded():
    a, ta = plmm.synth_lmm_data(3, 500, 4, 30)
    b, _ = plmm.synth_lmm_data(3, 500, 4, 30)
    assert a["x"].shape == (500, 4) and a["z"].shape == (500, Q)
    assert all(a[k].dtype == np.float32 for k in ("x", "z", "y"))
    np.testing.assert_array_equal(a["z"][:, 0], 1.0)
    assert a["g"].min() >= 0 and a["g"].max() < 30
    assert ta["u"].shape == (30, Q) and ta["sigma"] == 0.5
    np.testing.assert_array_equal(ta["tau"], np.asarray([0.8, 0.4], np.float32))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c, _ = plmm.synth_lmm_data(4, 500, 4, 30)
    assert not np.array_equal(a["x"], c["x"])


def test_interop_refuses_keys_it_does_not_know():
    raw = _ref_data(600, 3, 12, seed=0)
    rdata = _numpy(ref_prepare(rlmm.FusedLinearMixedModelGrouped(3, 12), raw))
    carried = data_from_reference(rdata, device="cpu")
    assert set(carried) == {"xT", "zT", "y", "g", "gl", "first_gid", "k_loc", "lane_tile"}
    with pytest.raises(ValueError, match="not one the ported models read"):
        data_from_reference({**rdata, "w": np.zeros(600, np.float32)}, device="cpu")


def test_lmm_sample_end_to_end_on_cpu():
    d, groups, chains = 3, 12, 4
    raw = _ref_data(600, d, groups, seed=9)
    post = sample(
        plmm.FusedLinearMixedModelGrouped(d, groups), raw, kernel="chees",
        chains=chains, num_warmup=20, num_samples=10, map_init_steps=5,
        init_step_size=0.1, seed=0, device="cpu",
    )
    spec = rlmm.FusedLinearMixedModelGrouped(num_features=d, num_groups=groups).param_spec()
    assert set(post.draws) == set(spec)
    for k, ps in spec.items():
        assert post.draws[k].shape == (chains, 10) + tuple(ps.shape), k
        assert np.all(np.isfinite(post.draws[k])), k
    assert np.all(post.draws["sigma"] > 0) and np.all(post.draws["tau"] > 0)


@pytest.mark.slow
def test_lmm_posterior_means_agree_with_reference_within_mcse():
    """Posterior-level parity at small N: the two packages' posterior
    means agree within 4 combined Monte-Carlo standard errors."""
    import stark_tpu

    from stark_tpu_torch import diagnostics as pdiag

    d, groups = 3, 12
    raw = _ref_data(3000, d, groups, seed=4)
    kw = dict(chains=16, num_warmup=300, num_samples=400, init_step_size=0.1,
              map_init_steps=100, seed=2)
    rpost = stark_tpu.chees_sample(rlmm.FusedLinearMixedModelGrouped(d, groups), raw, **kw)
    ppost = sample(plmm.FusedLinearMixedModelGrouped(d, groups), raw, kernel="chees",
                   device="cpu", **kw)
    assert ppost.max_rhat() < 1.05
    for k in ("intercept", "beta", "tau", "sigma"):
        r, p = np.asarray(rpost.draws[k]), ppost.draws[k]
        se = np.sqrt(pdiag.mcse_mean(r) ** 2 + pdiag.mcse_mean(p) ** 2)
        diff = np.abs(r.reshape(-1, *r.shape[2:]).mean(0) - p.reshape(-1, *p.shape[2:]).mean(0))
        assert np.all(diff < 4 * se), (k, diff, se)
