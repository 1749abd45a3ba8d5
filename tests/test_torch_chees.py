"""Port's ChEES sampler against the JAX package.

Piece by piece (Halton, dual averaging, Welford, Adam, the warmup
schedule) and then the sampler's parts as a whole: MAP init, every warmup
transition through a metric window end and the start of the T ascent,
and sampling transitions, with the port fed the SAME noise the reference
draws.  The port's noise source is pluggable; `ReplayNoise` hands it the
momenta and acceptance uniforms the reference derives with ``fold_in``
(stark_tpu/kernels/chees.py).

Tolerances: the schedule arrays, Halton points, leapfrog and divergence
counts are exact.  Per-step arithmetic (DA, Welford, Adam) is float32 in
both: rtol 1e-6.  One transition (up to ~100 leapfrog steps) from the
same state: positions, energies and adaptation state within rtol 1e-4 /
atol 1e-4 — float32 roundoff of two summation orders carried through the
integrator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu import adaptation as radapt
from stark_tpu import chees as rchees
from stark_tpu.kernels import chees as rkchees
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import logistic as rml
from stark_tpu.sampler import SamplerConfig as RefConfig
from stark_tpu_torch import adaptation as padapt
from stark_tpu_torch import chees as pchees
from stark_tpu_torch import chees_sample
from stark_tpu_torch.interop import chain_state_from_reference, data_from_reference
from stark_tpu_torch.kernels import chees as pkchees
from stark_tpu_torch.model import flatten_model
from stark_tpu_torch.models import logistic as pml
from stark_tpu_torch.sampler import SamplerConfig

STEP_RTOL = 1e-6
RUN_RTOL, RUN_ATOL = 1e-4, 1e-4


def test_halton_exact():
    for base, start in ((2, 0), (3, 7), (2, 500)):
        np.testing.assert_array_equal(
            pkchees.halton(64, base, start), rkchees.halton(64, base, start)
        )


@pytest.mark.parametrize("num_warmup", [0, 19, 30, 149, 150, 400, 1000])
def test_warmup_schedule_identical(num_warmup):
    want = radapt.build_warmup_schedule(num_warmup)
    got = padapt.build_warmup_schedule(num_warmup)
    np.testing.assert_array_equal(got.adapt_mass, want.adapt_mass)
    np.testing.assert_array_equal(got.window_end, want.window_end)


def test_dual_averaging_welford_adam_updates():
    rs = np.random.RandomState(0)
    accepts = rs.rand(25).astype(np.float32)
    rda = radapt.da_init(jnp.float32(0.1))
    pda = padapt.da_init(torch.tensor(0.1))
    for a in accepts:
        rda = radapt.da_update(rda, jnp.float32(a), 0.8)
        pda = padapt.da_update(pda, torch.tensor(a), 0.8)
        for f in ("log_step", "log_avg_step", "h_avg", "mu"):
            np.testing.assert_allclose(
                float(getattr(pda, f)), float(getattr(rda, f)), rtol=STEP_RTOL, err_msg=f
            )
    xs = rs.standard_normal((12, 6)).astype(np.float32)
    rwf, pwf = radapt.welford_init(6), padapt.welford_init(6, "cpu")
    for x in xs:
        rwf = radapt.welford_update(rwf, jnp.asarray(x))
        pwf = padapt.welford_update(pwf, torch.as_tensor(x))
    np.testing.assert_allclose(
        padapt.welford_variance(pwf).numpy(), np.asarray(radapt.welford_variance(rwf)),
        rtol=STEP_RTOL,
    )
    # the pooled (C, d) batch merge ChEES uses
    rwb, pwb = radapt.welford_init(6), padapt.welford_init(6, "cpu")
    for batch in xs.reshape(3, 4, 6):
        rwb = rchees._welford_batch(rwb, jnp.asarray(batch))
        pwb = pchees._welford_batch(pwb, torch.as_tensor(batch))
    assert pwb.count == int(rwb.count) == 12
    np.testing.assert_allclose(pwb.mean.numpy(), np.asarray(rwb.mean), rtol=STEP_RTOL, atol=1e-7)
    np.testing.assert_allclose(pwb.m2.numpy(), np.asarray(rwb.m2), rtol=STEP_RTOL)
    # Adam ascent: scalar (log T) and vector (MAP init) forms
    radam = rchees.AdamState(jnp.zeros(6), jnp.zeros(6), jnp.zeros((), jnp.int32))
    padam = pchees.AdamState(torch.zeros(6), torch.zeros(6), 0)
    for g in xs:
        radam, rstep = rchees._adam_ascent(radam, jnp.asarray(g), lr=0.05, b2=0.999)
        padam, pstep = pchees._adam_ascent(padam, torch.as_tensor(g), lr=0.05, b2=0.999)
        np.testing.assert_allclose(pstep.numpy(), np.asarray(rstep), rtol=STEP_RTOL, atol=1e-8)


def _reference_noise(key, chains, d):
    """The momenta normals and acceptance uniforms chees_transition
    derives from ``key`` (split, then fold_in of the chain id)."""
    key_mom, key_acc = jax.random.split(key)
    ids = jnp.arange(chains)
    eps = jax.vmap(
        lambda i: jax.random.normal(jax.random.fold_in(key_mom, i), (d,), jnp.float32)
    )(ids)
    u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key_acc, i)))(ids)
    return np.asarray(eps), np.asarray(u)


class ReplayNoise:
    """Noise source replaying one (eps, u) pair per transition."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.i = 0

    def normal(self, shape):
        eps = self.draws[self.i][0]
        assert tuple(shape) == eps.shape
        return torch.as_tensor(np.array(eps))

    def uniform(self, shape):
        u = self.draws[self.i][1]
        assert tuple(shape) == u.shape
        self.i += 1
        return torch.as_tensor(np.array(u))


def _close(got, want, what, rtol=None, atol=None):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=RUN_RTOL if rtol is None else rtol,
        atol=RUN_ATOL if atol is None else atol, err_msg=what,
    )


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_warm_carry(rc):
    """The reference's warmup carry as the port's (teacher forcing)."""
    return pchees.CheesWarmCarry(
        states=pchees.HMCState(_t(rc.states.z), _t(rc.states.potential_energy),
                               _t(rc.states.grad)),
        da=padapt.DualAveragingState(_t(rc.da.log_step), _t(rc.da.log_avg_step),
                                     _t(rc.da.h_avg), _t(rc.da.mu), int(rc.da.count)),
        adam=pchees.AdamState(_t(rc.adam.m), _t(rc.adam.v), int(rc.adam.t)),
        log_T=_t(rc.log_T),
        wf=padapt.WelfordState(int(rc.wf.count), _t(rc.wf.mean), _t(rc.wf.m2)),
        inv_mass=_t(rc.inv_mass),
    )


def _flagship_family(d=3, groups=6, n=600, seed=5):
    rs = np.random.RandomState(seed)
    raw = {
        "x": rs.standard_normal((n, d)).astype(np.float32),
        "y": (rs.rand(n) < 0.5).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32),
    }
    rmodel = rml.FusedHierLogisticGrouped(d, groups)
    pmodel = pml.FusedHierLogisticGrouped(d, groups)
    rdata = ref_prepare(rmodel, raw)
    pdata = data_from_reference({k: np.asarray(v) for k, v in rdata.items()}, device="cpu")
    return ref_flatten(rmodel), flatten_model(pmodel), rdata, pdata


def test_chees_parts_match_reference_on_shared_noise():
    """Every transition of a 30-step warmup (a metric window end at step
    26, the T ascent from step 27) and 6 sampling steps, each started
    from the reference's own carry (teacher forcing: two float32
    implementations of a chaotic sampler drift apart over many steps, so
    each step is held to the reference from the same state)."""
    chains = 8
    rfm, pfm, rdata, pdata = _flagship_family()
    budget = dict(num_warmup=30, num_samples=6, init_step_size=0.1, map_init_steps=3)
    rcfg, pcfg = RefConfig(kernel="chees", **budget), SamplerConfig(kernel="chees", **budget)
    rparts, pparts = rchees.make_chees_parts(rfm, rcfg), pchees.make_chees_parts(pfm, pcfg)
    assert pparts.warm_cap == rparts.warm_cap

    sched_r = rchees.chees_schedule_arrays(rparts, rcfg)
    sched_p = pchees.chees_schedule_arrays(pparts, pcfg)
    for a, b in zip(sched_p, sched_r):
        np.testing.assert_array_equal(a, np.asarray(b))
    aflags, wflags, u_warm, u_run, idxs = sched_p
    assert wflags[26] and not wflags[:26].any()

    z0 = (0.5 * np.random.RandomState(6).standard_normal((chains, pfm.ndim))).astype(np.float32)
    rc = rparts.init_carry(jax.random.PRNGKey(0), jnp.asarray(z0), rdata)
    pc = pparts.init_carry(torch.as_tensor(z0), pdata)
    _close(pc.states.z, rc.states.z, "MAP-init z")
    _close(pc.states.potential_energy, rc.states.potential_energy, "init pe")
    _close(pc.states.grad, rc.states.grad, "init grad")

    warm = jax.jit(rparts.warm_segment)
    keys = jax.random.split(jax.random.PRNGKey(11), budget["num_warmup"])
    for i in range(budget["num_warmup"]):
        sl = slice(i, i + 1)
        pc = _port_warm_carry(rc)
        rc, (rdiv, rleap) = warm(
            rc, keys[sl], jnp.asarray(u_warm[sl]), jnp.asarray(idxs[sl]),
            jnp.asarray(aflags[sl]), jnp.asarray(wflags[sl]), rdata,
        )
        noise = ReplayNoise([_reference_noise(keys[i], chains, pfm.ndim)])
        pc, (pdiv, pleap) = pparts.warm_segment(
            pc, noise, u_warm[sl], idxs[sl], aflags[sl], wflags[sl], pdata
        )
        assert noise.i == 1
        assert (pleap, pdiv) == (int(rleap), int(rdiv)), i
        what = f"warmup step {i}"
        _close(pc.states.z, rc.states.z, what + " z")
        _close(pc.states.potential_energy, rc.states.potential_energy, what + " pe")
        _close(pc.da.log_step, rc.da.log_step, what + " log_step")
        _close(pc.da.log_avg_step, rc.da.log_avg_step, what + " log_avg_step")
        _close(pc.log_T, rc.log_T, what + " log_T")
        _close(pc.inv_mass, rc.inv_mass, what + " inv_mass")
        _close(pc.wf.mean, rc.wf.mean, what + " welford mean")

    rrun = rparts.finalize(rc)
    sample = jax.jit(rparts.sample_segment)
    keys = jax.random.split(jax.random.PRNGKey(12), budget["num_samples"])
    for i in range(budget["num_samples"]):
        # the reference's sampling carry carried across with interop
        prun = chain_state_from_reference(
            np.asarray(rrun.states.z), np.asarray(rrun.inv_mass),
            float(np.exp(rrun.log_eps)), np.asarray(rrun.log_T),
            potential=pfm.bind(pdata), device="cpu",
        )
        _close(prun.states.potential_energy, rrun.states.potential_energy, "carried pe")
        _close(prun.states.grad, rrun.states.grad, "carried grad")
        sl = slice(i, i + 1)
        rrun, rout = sample(rrun, keys[sl], jnp.asarray(u_run[sl]), rdata)
        noise = ReplayNoise([_reference_noise(keys[i], chains, pfm.ndim)])
        prun, pout = pparts.sample_segment(prun, noise, u_run[sl], pdata)
        np.testing.assert_array_equal(pout[3], np.asarray(rout[3]))  # leapfrog count
        np.testing.assert_array_equal(pout[2], np.asarray(rout[2]))  # divergences
        _close(pout[0], rout[0], f"sample step {i} draws")
        _close(pout[1], rout[1], f"sample step {i} accept_prob")


def test_chees_sample_runs_end_to_end_on_cpu():
    raw, _ = pml.synth_logistic_data(0, 800, 3, num_groups=5)
    post = chees_sample(
        pml.FusedHierLogisticGrouped(3, 5), raw, chains=8, num_warmup=40,
        num_samples=20, map_init_steps=5, seed=1, device="cpu",
    )
    assert post.draws["beta"].shape == (8, 20, 3)
    assert post.draws["alpha_raw"].shape == (8, 20, 5)
    assert all(np.all(np.isfinite(v)) for v in post.draws.values())
    assert np.all(post.draws["sigma_alpha"] > 0)
    st = post.sample_stats
    # every ensemble gradient: the initial state, then MAP steps and
    # warmup leapfrogs (num_warmup_grad_evals) and sampling leapfrogs,
    # the last two reported per chain
    assert int(st["num_ensemble_grad_evals"]) == (
        1 + (int(st["num_warmup_grad_evals"]) + int(st["num_grad_evals"])) // 8
    )
    again = chees_sample(
        pml.FusedHierLogisticGrouped(3, 5), raw, chains=8, num_warmup=40,
        num_samples=20, map_init_steps=5, seed=1, device="cpu",
    )
    np.testing.assert_array_equal(again.draws_flat, post.draws_flat)


def test_init_positions_jitter_a_given_point():
    fm = flatten_model(pml.HierLogistic(2, 3))
    point = {"beta": np.array([0.5, -1.0], np.float32), "alpha0": np.float32(0.2),
             "sigma_alpha": np.float32(2.0), "alpha_raw": np.zeros(3, np.float32)}
    gen = torch.Generator().manual_seed(0)
    z0 = pchees.chees_init_positions(fm, gen, 16, point, "cpu")
    assert z0.shape == (16, fm.ndim)
    centre = fm.unconstrain({k: torch.as_tensor(v)[None] for k, v in point.items()})[0]
    assert float(centre[3]) == pytest.approx(np.log(2.0))  # sigma_alpha: log
    spread = (z0 - centre).std(0)
    assert torch.all((spread > 0.03) & (spread < 0.3))  # 0.1 jitter
    random = pchees.chees_init_positions(fm, gen, 16, None, "cpu")
    assert float(random.min()) >= -2.0 and float(random.max()) <= 2.0


@pytest.mark.slow
def test_posterior_means_agree_with_reference_within_mcse():
    """Posterior-level parity at small N: the two packages' posterior
    means agree within 4 combined Monte-Carlo standard errors."""
    import stark_tpu

    from stark_tpu_torch import diagnostics as pdiag

    raw, _ = pml.synth_logistic_data(4, 4000, 3, num_groups=5)
    kw = dict(chains=16, num_warmup=300, num_samples=400, init_step_size=0.1,
              map_init_steps=100, seed=2)
    rpost = stark_tpu.chees_sample(rml.FusedHierLogisticGrouped(3, 5), raw, **kw)
    ppost = chees_sample(pml.FusedHierLogisticGrouped(3, 5), raw, device="cpu", **kw)
    assert ppost.max_rhat() < 1.05
    for k in ("beta", "alpha0", "sigma_alpha"):
        r, p = np.asarray(rpost.draws[k]), ppost.draws[k]
        se = np.sqrt(pdiag.mcse_mean(r) ** 2 + pdiag.mcse_mean(p) ** 2)
        diff = np.abs(r.reshape(-1, *r.shape[2:]).mean(0) - p.reshape(-1, *p.shape[2:]).mean(0))
        assert np.all(diff < 4 * se), (k, diff, se)
