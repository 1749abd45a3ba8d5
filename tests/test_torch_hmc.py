"""The port's HMC (`stark_tpu_torch.kernels.hmc`) against the JAX
package's, transition by transition from the reference's own carry,
with the reference's randomness replayed (``split(key)`` into the
momentum normal and the acceptance uniform).  The yardsticks are those
of tests/test_torch_nuts.py: float64 on the unfused model with the
decisions (accept, divergent) exact and rtol 1e-6 / atol 1e-8; float32
on the grouped model at the reference's grouped tolerances."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stark_tpu.kernels import base as rbase
from stark_tpu.kernels import hmc as rhmc
from stark_tpu_torch.kernels import base as pbase
from stark_tpu_torch.kernels import hmc as phmc
from stark_tpu_torch.kernels.chees import TorchNoise
from test_torch_nuts import (
    GRAD_ATOL,
    GRAD_RTOL,
    VAL_RTOL,
    X64_ATOL,
    X64_RTOL,
    ReplayNoise,
    one_torch_thread,  # noqa: F401 (autouse: one intra-op thread)
    RecordingPotential,
    float64_pair,
    grouped_pair,
    reference_transitions,
)

CHAINS, NUM_LEAPFROG = 4, 12


@partial(jax.jit, static_argnums=1)
def _chain_hmc_noise(key, d):
    dtype = jnp.zeros(()).dtype
    key_mom, key_accept = jax.random.split(key)
    return jax.random.normal(key_mom, (d,), dtype), jax.random.uniform(key_accept, ())


def reference_hmc_noise(keys, d):
    return [np.asarray(a) for a in jax.vmap(lambda k: _chain_hmc_noise(k, d))(keys)]


def _t(a):
    return torch.as_tensor(np.array(a))


def _run(rpot, ppot, ndim, dtype, n, seed, tols):
    rs = np.random.RandomState(seed)
    z0 = jnp.asarray((0.4 * rs.standard_normal((CHAINS, ndim))).astype(dtype))
    rstate = jax.jit(jax.vmap(lambda z: rbase.init_state(rpot, z)))(z0)
    # small steps that accept, a larger one that rejects now and then, one
    # that diverges
    step = jnp.asarray(np.array([0.01, 0.05, 0.12, 0.9], dtype))
    mass = jnp.asarray(rs.uniform(0.5, 1.5, (CHAINS, ndim)).astype(dtype))
    fn = jax.jit(jax.vmap(lambda k, s, e, m: rhmc.hmc_step(k, s, rpot, e, m, NUM_LEAPFROG)))
    keys = [jax.random.split(k, CHAINS) for k in jax.random.split(jax.random.PRNGKey(seed), n)]
    (zr, za), (vr, va), (gr, ga) = tols
    accepted = []
    for (before, after, info), k in zip(reference_transitions(fn, rstate, keys, step, mass), keys):
        noise = ReplayNoise(reference_hmc_noise(k, ndim))
        state = pbase.HMCState(_t(before.z), _t(before.potential_energy), _t(before.grad))
        new, pinfo = phmc.hmc_step(noise, state, ppot, _t(step)[:, None], _t(mass), NUM_LEAPFROG)
        assert noise.done()
        np.testing.assert_array_equal(pinfo.is_accepted.numpy(), info.is_accepted)
        np.testing.assert_array_equal(pinfo.is_divergent.numpy(), info.is_divergent)
        np.testing.assert_array_equal(pinfo.num_grad_evals.numpy(), info.num_grad_evals)
        assert pinfo.num_ensemble_grad_evals == NUM_LEAPFROG
        np.testing.assert_allclose(new.z.numpy(), after.z, rtol=zr, atol=za)
        np.testing.assert_allclose(new.potential_energy.numpy(), after.potential_energy,
                                   rtol=vr, atol=va)
        np.testing.assert_allclose(new.grad.numpy(), after.grad, rtol=gr, atol=ga)
        np.testing.assert_allclose(pinfo.energy.numpy(), info.energy, rtol=vr, atol=va)
        np.testing.assert_allclose(pinfo.accept_prob.numpy(), info.accept_prob, rtol=zr, atol=za)
        accepted.append(info.is_accepted)
    return np.array(accepted)


def test_hmc_transitions_match_reference_in_float64():
    rpot, ppot, ndim = float64_pair()
    with jax.enable_x64(True):
        acc = _run(rpot, ppot, ndim, np.float64, 20, 3, ((X64_RTOL, X64_ATOL),) * 3)
    assert acc.any() and not acc.all()


def test_hmc_transitions_match_reference_grouped_float32():
    rpot, ppot, ndim = grouped_pair()
    acc = _run(rpot, ppot, ndim, np.float32, 20, 4,
               ((GRAD_RTOL, GRAD_ATOL), (VAL_RTOL, 0.0), (GRAD_RTOL, GRAD_ATOL)))
    assert acc.any() and not acc.all()


def test_fixed_leapfrog_matches_reference():
    """`leapfrog`: L velocity-Verlet steps, per-chain steps and metric."""
    rpot, ppot, ndim = float64_pair(300, 2, 3)
    rs = np.random.RandomState(5)
    z = rs.standard_normal((3, ndim)) * 0.3
    r = rs.standard_normal((3, ndim))
    step = np.array([0.01, -0.03, 0.05])
    mass = rs.uniform(0.5, 1.5, (3, ndim))
    with jax.enable_x64(True):
        st = jax.vmap(lambda zz: rbase.init_state(rpot, zz))(jnp.asarray(z))
        want = jax.vmap(lambda zz, rr, gg, e, m: rbase.leapfrog(rpot, zz, rr, gg, e, m, 7))(
            st.z, jnp.asarray(r), st.grad, jnp.asarray(step), jnp.asarray(mass))
        want = [np.asarray(a) for a in want]
    got = pbase.leapfrog(ppot, _t(z), _t(r), _t(st.grad), _t(step)[:, None], _t(mass), 7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=X64_RTOL, atol=X64_ATOL)


def test_a_chain_that_leaves_the_finite_numbers_is_rejected_and_never_reaches_the_kernel():
    rpot, ppot, ndim = float64_pair(300, 2, 3)
    pot = RecordingPotential(ppot)
    z = 0.1 * torch.randn(3, ndim, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    state = pbase.init_state(pot, z)
    step = torch.tensor([[0.01], [0.02], [1e308]], dtype=torch.float64)
    new, info = phmc.hmc_step(TorchNoise(torch.Generator().manual_seed(1)), state, pot, step,
                              torch.ones(3, ndim, dtype=torch.float64), 5)
    assert len(pot.seen) == 1 + 5 and all(bool(torch.isfinite(s).all()) for s in pot.seen)
    # from its first step on, chain 2 is held at its start
    assert all(torch.equal(s[2], z[2]) for s in pot.seen[1:])
    assert bool(info.is_divergent[2]) and not bool(info.is_accepted[2])
    assert float(info.accept_prob[2]) == 0.0 and torch.equal(new.z[2], z[2])
