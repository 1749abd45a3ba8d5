"""Port's consensus Monte Carlo (BASELINE config 2) against the JAX package.

The shard split against the reference's own ``to_shards``; the tempered
potential (``prior_scale=1/S``); the shard-batched potential of
`FusedLogistic` (the plain version of kernel B2 on the CPU) against the
reference's nested vmap of its Pallas kernel in interpret mode; one
shard-batched ChEES transition and a warmup of the shard-batched parts
from the reference's carry with its noise, the shards at different
leapfrog counts; the three combines on the same numpy draws; the dead
shard policy.

Tolerances: the fused potential at the reference's fused tolerances
(tests/test_hier_fused.py:80-87): value rtol 2e-5, gradient rtol 2e-4 /
atol 1e-4.  A transition or warmup step from the same state: rtol 1e-4 /
atol 1e-4, as tests/test_torch_chees.py (float32 roundoff of two
summation orders through the integrator).  Combines: rtol 1e-4 / atol
1e-5 (float32 LAPACK on both sides; the full combine inverts d x d
covariances).  The posterior check mirrors tests/test_consensus.py:66-89
at its own thresholds.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu import chees as rchees
from stark_tpu.kernels import chees as rkchees
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.models import logistic as rml
from stark_tpu.parallel import consensus as rcons
from stark_tpu.sampler import SamplerConfig as RefConfig
from stark_tpu_torch import adaptation as padapt
from stark_tpu_torch import chees as pchees
from stark_tpu_torch import consensus_sample
from stark_tpu_torch.kernels import chees as pkchees
from stark_tpu_torch.kernels.base import HMCState
from stark_tpu_torch.model import flatten_model
from stark_tpu_torch.models import logistic as pml
from stark_tpu_torch.parallel import consensus as pcons
from stark_tpu_torch.sampler import SamplerConfig

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
RUN_RTOL, RUN_ATOL = 1e-4, 1e-4
COMBINE_RTOL, COMBINE_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_to_shards(shards):
    """The reference's ``to_shards`` (a closure inside its
    consensus_sample over the local shard count), rebuilt from its code."""
    code = next(c for c in rcons.consensus_sample.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "to_shards")
    cells = tuple(types.CellType(shards) for _ in code.co_freevars)
    return types.FunctionType(code, rcons.__dict__, None, None, cells)


def _data(n=1200, d=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, d)).astype(np.float32)
    beta = rs.standard_normal(d).astype(np.float32)
    y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-x @ beta))).astype(np.float32)
    return {"x": x, "y": y}


@pytest.mark.parametrize("model", ["Logistic", "FusedLogistic"])
def test_shard_split_matches_reference(model):
    S = 4
    raw = _data(n=800, d=3)
    rmodel, pmodel = getattr(rml, model)(3), getattr(pml, model)(3)
    rdata = rmodel.prepare_data(raw)
    raxes = rmodel.data_row_axes(rdata)
    want = jax.tree.map(_ref_to_shards(S), rdata, raxes)
    got = pcons.shard_data(pmodel, raw, S, "cpu")
    assert set(got) == set(want)
    assert pmodel.data_row_axes(pmodel.prepare_data(raw)) == raxes
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].is_contiguous()
    # a row-less entry is repeated for every shard, as the reference does
    np.testing.assert_array_equal(
        pcons.to_shards(np.arange(3.0), -1, S), np.asarray(_ref_to_shards(S)(np.arange(3.0), -1))
    )
    with pytest.raises(ValueError, match="divisible"):
        pcons.to_shards(np.zeros(10), 0, 3)


@pytest.mark.parametrize("prior_scale, lik_scale", [(1.0, 1.0), (0.25, 1.0), (1.0, 7.5)])
def test_flatten_model_scales_match_reference(prior_scale, lik_scale):
    raw = _data(n=300, d=4, seed=1)
    rfm = ref_flatten(rml.Logistic(4), prior_scale=prior_scale, lik_scale=lik_scale)
    pfm = flatten_model(pml.Logistic(4), prior_scale=prior_scale, lik_scale=lik_scale)
    z = (0.7 * np.random.RandomState(2).standard_normal((5, 4))).astype(np.float32)
    rv, rg = jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None))(
        jnp.asarray(z), jax.tree.map(jnp.asarray, raw))
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), {k: torch.as_tensor(v) for k, v in raw.items()})
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-5)
    # the prior alone (no data): the scale applies there too
    np.testing.assert_allclose(
        pfm.potential(torch.as_tensor(z)).numpy(),
        np.asarray(jax.vmap(rfm.potential)(jnp.asarray(z))), rtol=1e-6,
    )


def _sharded_pair(model, S, n, d, seed):
    raw = _data(n=n, d=d, seed=seed)
    rmodel, pmodel = getattr(rml, model)(d), getattr(pml, model)(d)
    rdata = rmodel.prepare_data(raw)
    rshard = jax.tree.map(_ref_to_shards(S), rdata, rmodel.data_row_axes(rdata))
    pshard = pcons.shard_data(pmodel, raw, S, "cpu")
    rfm = ref_flatten(rmodel, prior_scale=1.0 / S)
    pfm = flatten_model(pmodel, prior_scale=1.0 / S)
    return rfm, pfm, rshard, pshard


@pytest.mark.parametrize("S, C", [(1, 3), (3, 4)])
def test_shard_batched_fused_potential_matches_reference_vmap(S, C):
    """The port's (S, C, d) potential of FusedLogistic (plain B2 with the
    shard axis) against vmap over shards of vmap over chains of the
    reference's Pallas-kernel potential (interpret mode on the CPU: one
    pallas_call with a leading shard grid axis)."""
    d = 5
    rfm, pfm, rshard, pshard = _sharded_pair("FusedLogistic", S, 600 * S, d, seed=S)
    z = (0.5 * np.random.RandomState(3).standard_normal((S, C, d))).astype(np.float32)
    vg = jax.vmap(jax.vmap(jax.value_and_grad(rfm.potential), in_axes=(0, None)),
                  in_axes=(0, 0))
    rv, rg = vg(jnp.asarray(z), rshard)
    pv, pg = pfm.potential_and_grad(torch.as_tensor(z), pshard)
    assert pv.shape == (S, C) and pg.shape == (S, C, d)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the same through the plain model (autograd on the rows)
    _, pfm_plain, _, pshard_plain = _sharded_pair("Logistic", S, 600 * S, d, seed=S)
    qv, qg = pfm_plain.potential_and_grad(torch.as_tensor(z), pshard_plain)
    np.testing.assert_allclose(qv.numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(qg.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _per_shard_models():
    from stark_tpu.models import bnn as rbnn
    from stark_tpu_torch.models import bnn as pbnn

    return {
        "BayesianMLP": (rbnn.BayesianMLP(4, hidden=5), pbnn.BayesianMLP(4, hidden=5)),
        "HierLogistic": (rml.HierLogistic(4, 3), pml.HierLogistic(4, 3)),
    }


@pytest.mark.parametrize("model", ["BayesianMLP", "HierLogistic"])
def test_unbatched_likelihood_runs_shard_by_shard(model):
    """A model without a shard-batched likelihood, at S == C (where a
    broadcast would line the shard axis of the data up with the chain
    axis of the parameters), against the reference's vmap over shards:
    each shard's chains score that shard's rows only."""
    S = C = 3
    rmodel, pmodel = _per_shard_models()[model]
    assert not pmodel.shard_batched_lik and pml.FusedLogistic.shard_batched_lik
    raw = _data(n=90 * S, d=4, seed=7)
    raw["g"] = (np.arange(90 * S) % 3).astype(np.int32)
    if model == "BayesianMLP":
        del raw["g"]
    rshard = jax.tree.map(_ref_to_shards(S), rmodel.prepare_data(raw),
                          rmodel.data_row_axes(rmodel.prepare_data(raw)))
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


def _ref_shard_noise(keys, C, d):
    """Per shard, the momenta and uniforms chees_transition derives from
    that shard's key, stacked (S, C, d) and (S, C)."""
    eps, u = zip(*(_one_noise(k, C, d) for k in keys))
    return np.stack(eps), np.stack(u)


def _one_noise(key, C, d):
    key_mom, key_acc = jax.random.split(key)
    ids = jnp.arange(C)
    eps = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(key_mom, i), (d,)))(ids)
    u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key_acc, i)))(ids)
    return np.asarray(eps), np.asarray(u)


class ReplayNoise:
    """Noise source replaying one (eps, u) pair per transition."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.i = 0

    def normal(self, shape):
        eps = self.draws[self.i][0]
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return torch.as_tensor(np.array(eps))

    def uniform(self, shape):
        u = self.draws[self.i][1]
        assert tuple(shape) == u.shape, (shape, u.shape)
        self.i += 1
        return torch.as_tensor(np.array(u))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RUN_RTOL,
                               atol=RUN_ATOL, err_msg=what)


def test_shard_batched_chees_transition_matches_reference():
    """One transition of three shards' ensembles at leapfrog counts 2, 5
    and 9, each shard with its own step size and inverse mass: the port's
    (S, C, d) transition against the reference's chees_transition vmapped
    over shards (its traced per-shard count runs to the largest and holds
    the shards that are done)."""
    S, C, d = 3, 6, 4
    rfm, pfm, rshard, pshard = _sharded_pair("Logistic", S, 300 * S, d, seed=4)
    rs = np.random.RandomState(5)
    z = (0.4 * rs.standard_normal((S, C, d))).astype(np.float32)
    eps = np.array([0.21, 0.12, 0.07], np.float32)
    inv_mass = (0.5 + rs.rand(S, d)).astype(np.float32)
    L = [2, 5, 9]
    keys = jax.random.split(jax.random.PRNGKey(9), S)

    def one(key, z, data, step, im, nl):
        pot = rfm.bind(data)
        pe, g = jax.vmap(pot.value_and_grad)(z)
        st = rkchees.HMCState(z=z, potential_energy=pe, grad=g)
        return st, rkchees.chees_transition(key, st, pot, step, im, nl)

    rst0, (rst, rinfo) = jax.vmap(one)(keys, jnp.asarray(z), rshard, jnp.asarray(eps),
                                       jnp.asarray(inv_mass), jnp.asarray(L, jnp.int32))
    noise = ReplayNoise([_ref_shard_noise(keys, C, d)])
    state = HMCState(torch.as_tensor(z), torch.as_tensor(np.array(rst0.potential_energy)),
                     torch.as_tensor(np.array(rst0.grad)))
    pst, pinfo = pkchees.chees_transition(noise, state, pfm.bind(pshard), torch.as_tensor(eps),
                                          torch.as_tensor(inv_mass), L)
    assert noise.i == 1 and pinfo.num_leapfrog == max(L)
    np.testing.assert_array_equal(pinfo.is_accepted.numpy(), np.asarray(rinfo.is_accepted))
    np.testing.assert_array_equal(pinfo.is_divergent.numpy(), np.asarray(rinfo.is_divergent))
    _close(pst.z, rst.z, "z")
    _close(pst.potential_energy, rst.potential_energy, "pe")
    _close(pst.grad, rst.grad, "grad")
    _close(pinfo.accept_prob, rinfo.accept_prob, "accept_prob")
    _close(pinfo.grad_rel_T, rinfo.grad_rel_T, "grad_rel_T")
    assert pinfo.grad_rel_T.shape == (S,)


def _port_warm_carry(rc):
    """The reference's vmapped warmup carry as the port's shard carry."""
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return pchees.CheesWarmCarry(
        states=HMCState(t(rc.states.z), t(rc.states.potential_energy), t(rc.states.grad)),
        da=padapt.DualAveragingState(t(rc.da.log_step), t(rc.da.log_avg_step), t(rc.da.h_avg),
                                     t(rc.da.mu), int(np.asarray(rc.da.count)[0])),
        adam=pchees.AdamState(t(rc.adam.m), t(rc.adam.v), int(np.asarray(rc.adam.t)[0])),
        log_T=t(rc.log_T),
        wf=padapt.WelfordState(int(np.asarray(rc.wf.count)[0]), t(rc.wf.mean), t(rc.wf.m2)),
        inv_mass=t(rc.inv_mass),
    )


def test_shard_batched_chees_warmup_matches_reference():
    """Every step of a 30-step warmup (a metric window end at step 26, the
    T ascent from step 27) of three shards' ensembles, each step from the
    reference's own carry (teacher forcing, as tests/test_torch_chees.py):
    each shard adapts its own step size, trajectory length and mass, and
    the shards' leapfrog counts part ways."""
    S, C = 3, 8
    rfm, pfm, rshard, pshard = _sharded_pair("Logistic", S, 200 * S, 3, seed=6)
    budget = dict(num_warmup=30, num_samples=0, init_step_size=0.1, map_init_steps=3)
    rcfg, pcfg = RefConfig(kernel="chees", **budget), SamplerConfig(kernel="chees", **budget)
    rparts, pparts = rchees.make_chees_parts(rfm, rcfg), pchees.make_chees_parts(pfm, pcfg)
    aflags, wflags, u_warm, _, idxs = pchees.chees_schedule_arrays(pparts, pcfg)
    z0 = (0.5 * np.random.RandomState(7).standard_normal((S, C, pfm.ndim))).astype(np.float32)
    rc = jax.vmap(rparts.init_carry)(jax.random.split(jax.random.PRNGKey(0), S),
                                     jnp.asarray(z0), rshard)
    pc = pparts.init_carry(torch.as_tensor(z0), pshard)
    _close(pc.states.z, rc.states.z, "MAP-init z")
    _close(pc.states.grad, rc.states.grad, "init grad")
    warm = jax.jit(jax.vmap(rparts.warm_segment, in_axes=(0, 0, None, None, None, None, 0)))
    keys = jax.random.split(jax.random.PRNGKey(11), S * 30).reshape(S, 30, 2)
    parted = False
    for i in range(30):
        sl = slice(i, i + 1)
        pc = _port_warm_carry(rc)
        rc, (rdiv, rleap) = warm(rc, keys[:, sl], jnp.asarray(u_warm[sl]), jnp.asarray(idxs[sl]),
                                 jnp.asarray(aflags[sl]), jnp.asarray(wflags[sl]), rshard)
        noise = ReplayNoise([_ref_shard_noise(keys[:, i], C, pfm.ndim)])
        pc, (pdiv, pleap) = pparts.warm_segment(pc, noise, u_warm[sl], idxs[sl], aflags[sl],
                                                wflags[sl], pshard)
        assert noise.i == 1
        assert pleap == int(np.max(rleap)) and pdiv == int(np.sum(rdiv)), i
        parted |= len(set(np.asarray(rleap).tolist())) > 1
        what = f"warmup step {i}"
        for f in ("log_step", "log_avg_step"):
            _close(getattr(pc.da, f), getattr(rc.da, f), f"{what} {f}")
        _close(pc.states.z, rc.states.z, what + " z")
        _close(pc.log_T, rc.log_T, what + " log_T")
        _close(pc.inv_mass, rc.inv_mass, what + " inv_mass")
        _close(pc.wf.mean, rc.wf.mean, what + " welford mean")
    assert parted, "the shards never ran different leapfrog counts"


def _draws(S=3, C=4, T=50, d=3, seed=0):
    rs = np.random.RandomState(seed)
    mix = rs.standard_normal((S, d, d)).astype(np.float32) * 0.3 + np.eye(d, dtype=np.float32)
    x = rs.standard_normal((S, C, T, d)).astype(np.float32)
    return (np.einsum("sctd,sed->scte", x, mix) + rs.standard_normal((S, 1, 1, d))).astype(
        np.float32)


@pytest.mark.parametrize("how, ref_fn", [
    ("precision_full", rcons._combine_precision_weighted_full),
    ("precision", rcons._combine_precision_weighted),
    ("uniform", lambda x: jnp.mean(x, axis=0)),
])
@pytest.mark.parametrize("T", [50, 2])
def test_combines_match_reference(how, ref_fn, T):
    """Every combine on the same numpy draws; T=2 puts the full combine
    below 2d draws per shard (C*T = 8 < 2d = 10), where it falls back to
    the diagonal one, as the reference does."""
    draws = _draws(T=T, d=5)
    want = np.asarray(ref_fn(jnp.asarray(draws)))
    got = pcons.combine_draws(torch.as_tensor(draws), how).numpy()
    assert got.shape == want.shape == draws.shape[1:]
    np.testing.assert_allclose(got, want, rtol=COMBINE_RTOL, atol=COMBINE_ATOL)
    if how == "precision_full" and T == 2:
        np.testing.assert_array_equal(
            got, pcons.combine_precision_weighted(torch.as_tensor(draws)).numpy())
    with pytest.raises(ValueError, match="unknown combine"):
        pcons.combine_draws(torch.as_tensor(draws), "median")


def test_dead_shard_mask_matches_reference():
    draws = _draws(S=4)
    draws[2, 1, 7, 0] = np.nan
    draws[3, 0, 0, 2] = np.inf
    np.testing.assert_array_equal(pcons.dead_shard_mask(draws), rcons._dead_shard_mask(draws))
    # the port's addition: a chain whose final potential is non-finite
    pe = np.zeros((4, 4), np.float32)
    pe[0, 3] = np.nan
    np.testing.assert_array_equal(pcons.dead_shard_mask(draws, pe), [True, False, True, True])


def _poisoned(n=512, d=3, shards=4, dead=1):
    raw = _data(n=n, d=d, seed=8)
    raw["y"] = raw["y"].copy()
    per = n // shards
    raw["y"][dead * per:(dead + 1) * per] = np.nan
    return raw


@pytest.mark.parametrize("kernel", ["chees", "hmc"])
def test_poisoned_shard_degrades(kernel):
    """One shard's y NaN: its chains never leave their initial points (the
    draws stay finite; the reference's non-finite-draws test does not see
    it), its potential is NaN; it is restarted once on a new stream, then
    dropped, and the survivors combine to finite draws."""
    kw = (dict(init_step_size=0.1, map_init_steps=2) if kernel == "chees"
          else dict(num_leapfrog=3, init_step_size=0.1))
    post = consensus_sample(pml.FusedLogistic(3), _poisoned(), num_shards=4, chains=4,
                            kernel=kernel, num_warmup=4, num_samples=6, seed=0, device="cpu",
                            **kw)
    st = post.sample_stats
    assert st["degraded"] and st["lost_shards"].tolist() == [1]
    assert st["num_shard_restarts"] == 1 and st["num_shards"] == 4
    assert np.all(np.isfinite(post.draws_flat)) and post.draws_flat.shape == (4, 6, 3)
    assert st["sub_draws_flat"].shape == (4, 4, 6, 3)


@pytest.mark.parametrize("kernel", ["chees", "hmc"])
def test_dead_shard_policies_raise(kernel):
    kw = (dict(init_step_size=0.1) if kernel == "chees"
          else dict(num_leapfrog=3, init_step_size=0.1))
    common = dict(num_shards=4, chains=4, kernel=kernel, num_warmup=4, num_samples=4, seed=0,
                  device="cpu", **kw)
    with pytest.raises(RuntimeError, match=r"shards \[1\] dead after exhausting 0"):
        consensus_sample(pml.Logistic(3), _poisoned(), shard_restarts=0,
                         on_shard_failure="raise", **common)
    every = _data(n=512, d=3, seed=8)
    every["y"] = np.full(512, np.nan, np.float32)
    with pytest.raises(RuntimeError, match="all 4 shards dead"):
        consensus_sample(pml.Logistic(3), every, shard_restarts=0, **common)


def test_consensus_refusals_and_errors():
    raw = _data(n=96, d=3)
    common = dict(num_shards=4, chains=2, num_warmup=2, num_samples=2, device="cpu")
    for kw, item in ((dict(mesh=object()), "A11"), (dict(domains=object()), "A11"),
                     (dict(trace=object()), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            consensus_sample(pml.Logistic(3), raw, **common, **kw)
    with pytest.raises(ValueError, match="dispatch_steps"):
        consensus_sample(pml.Logistic(3), raw, kernel="nuts", dispatch_steps=5, **common)
    with pytest.raises(ValueError, match="divisible"):
        consensus_sample(pml.Logistic(3), _data(n=98, d=3), **common)
    with pytest.raises(ValueError, match="unknown combine"):
        consensus_sample(pml.Logistic(3), raw, combine="median", **common)


def test_chees_dispatch_steps_only_segments():
    raw = _data(n=400, d=3, seed=2)
    kw = dict(num_shards=2, chains=4, kernel="chees", num_warmup=12, num_samples=5,
              init_step_size=0.1, seed=3, device="cpu")
    a = consensus_sample(pml.FusedLogistic(3), raw, **kw)
    b = consensus_sample(pml.FusedLogistic(3), raw, dispatch_steps=4, **kw)
    np.testing.assert_array_equal(a.draws_flat, b.draws_flat)
    assert a.sample_stats["step_size"].shape == (2,)
    assert int(a.sample_stats["num_ensemble_grad_evals"]) > 12


@pytest.mark.slow
def test_consensus_chees_matches_full_posterior():
    """tests/test_consensus.py:66-89 on the port, at its thresholds."""
    from stark_tpu_torch import sample

    raw, true = pml.synth_logistic_data(3, 16384, 4)
    post = consensus_sample(pml.Logistic(4), raw, num_shards=4, chains=8, kernel="chees",
                            num_warmup=250, num_samples=250, init_step_size=0.1,
                            map_init_steps=100, seed=0, device="cpu")
    full = sample(pml.Logistic(4), raw, chains=8, kernel="chees", num_warmup=250,
                  num_samples=250, init_step_size=0.1, seed=0, device="cpu")
    assert post.max_rhat() < 1.05
    m_c = post.draws["beta"].mean((0, 1))
    m_f = full.draws["beta"].mean((0, 1))
    sd_f = full.draws["beta"].std((0, 1))
    np.testing.assert_allclose(m_c, m_f, atol=4 * np.max(sd_f))
    np.testing.assert_allclose(m_c, true["beta"], atol=5 * np.max(sd_f) + 0.05)
