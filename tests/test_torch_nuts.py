"""The port's NUTS (`stark_tpu_torch.kernels.nuts`) against the JAX
package's, transition by transition.

Each transition starts from the reference's own carry (two
implementations of a chaotic sampler drift apart over many transitions,
so each one is held to the reference from the same state) and the port
is fed the reference's randomness: `reference_nuts_noise` rebuilds, from
the reference's key of each chain, the momentum normals, direction,
trajectory-take and leaf-selection uniforms its ``nuts_step`` draws
(``split(key)`` into momentum and loop keys, ``split(key, 4)`` per
doubling, ``split`` per leaf).

Yardstick: U-turn, take and divergence decisions can flip under float32
roundoff, so exact decisions are asked of float64 on both sides (the
unfused `HierLogistic`, x64 scoped to the test by ``jax.enable_x64``):
tree depth, gradient evaluations and the divergent flag exactly; z,
potential, gradient, accept probability and energy to rtol 1e-6 / atol
1e-8.  In float32 the grouped model (B1's plain version against the
reference's grouped path through Pallas interpret mode) is held to the
reference's grouped tolerances (value rtol 2e-5; gradient and position
rtol 2e-4 / atol 1e-4, tests/test_hier_fused.py), decisions equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.kernels import base as rbase
from stark_tpu.kernels import nuts as rnuts
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.model import prepare_model_data as ref_prepare
from stark_tpu.models import logistic as rml
from stark_tpu_torch.interop import data_from_reference
from stark_tpu_torch.kernels import base as pbase
from stark_tpu_torch.kernels import nuts as pnuts
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import logistic as pml

X64_RTOL, X64_ATOL = 1e-6, 1e-8
VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
CHAINS, MAX_DEPTH = 4, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these files' many small eager ops: test
    workers run side by side, and a pool of spinning threads in each of
    them starves the others (a hundredfold slowdown with six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ReplayNoise:
    """A noise source that hands out given arrays in order, checking each
    request's shape: the reference's draws for the port's kernels."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape):
        a = np.array(self.arrays.pop(0))
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.as_tensor(a)

    normal = uniform = _next

    def done(self):
        return not self.arrays


@partial(jax.jit, static_argnums=(1, 2))
def _chain_nuts_noise(key, d, max_depth):
    """One chain's ``nuts_step`` randomness from its key."""
    dtype = jnp.zeros(()).dtype  # float64 under x64
    key_mom, key = jax.random.split(key)
    eps = jax.random.normal(key_mom, (d,), dtype)

    def doubling(key, _):
        key, key_dir, key_sub, key_take = jax.random.split(key, 4)
        right = jax.random.bernoulli(key_dir)

        def leaf(k, _):
            k, key_sel = jax.random.split(k)
            return k, jax.random.uniform(key_sel, ())

        _, u_leaf = jax.lax.scan(leaf, key_sub, None, length=1 << max(max_depth - 1, 0))
        return key, (right, jax.random.uniform(key_take, ()), u_leaf)

    _, (right, u_take, u_leaf) = jax.lax.scan(doubling, key, None, length=max_depth)
    # the port goes right when its direction uniform is below 1/2
    return eps, jnp.where(right, 0.25, 0.75).astype(dtype), u_take, u_leaf


def reference_nuts_noise(keys, d, max_depth):
    """[eps (C, d), u_dir, u_take (C, max_depth), u_leaf (C, max_depth,
    2**(max_depth-1))] for the chains' keys, in the port's draw order."""
    out = jax.vmap(lambda k: _chain_nuts_noise(k, d, max_depth))(keys)
    return [np.asarray(a) for a in out]


def hier_logistic_raw(n=2000, d=4, groups=10, seed=0, dtype=np.float64):
    rs = np.random.RandomState(seed)
    return {
        "x": rs.standard_normal((n, d)).astype(dtype),
        "y": (rs.rand(n) < 0.5).astype(dtype),
        "g": rs.randint(0, groups, n).astype(np.int32),
    }


def float64_pair(n=2000, d=4, groups=10):
    """(reference potential, port potential, ndim) of the unfused
    HierLogistic on float64 data; call the reference inside
    ``jax.enable_x64(True)``."""
    raw = hier_logistic_raw(n, d, groups)
    with jax.enable_x64(True):
        rfm = ref_flatten(rml.HierLogistic(d, groups))
        rpot = rfm.bind({k: jnp.asarray(v) for k, v in raw.items()})
    pmodel = pml.HierLogistic(d, groups)
    ppot = flatten_model(pmodel).bind(prepare_model_data(pmodel, raw, device="cpu"))
    return rpot, ppot, rfm.ndim


def grouped_pair(n=2000, d=4, groups=10):
    """The float32 grouped model on both sides: the reference's prepared
    layout carried across (`interop.data_from_reference`)."""
    raw = hier_logistic_raw(n, d, groups, dtype=np.float32)
    rmodel = rml.FusedHierLogisticGrouped(d, groups)
    rdata = ref_prepare(rmodel, raw)
    assert "gl" in rdata, "the grouped layout fell back"
    pdata = data_from_reference({k: np.asarray(v) for k, v in rdata.items()}, device="cpu")
    rfm = ref_flatten(rmodel)
    return rfm.bind(rdata), flatten_model(pml.FusedHierLogisticGrouped(d, groups)).bind(pdata), rfm.ndim


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_state(rstate):
    return pbase.HMCState(_t(rstate.z), _t(rstate.potential_energy), _t(rstate.grad))


def reference_transitions(step_fn, rstate, keys, *args):
    """Run ``step_fn`` (a jitted vmap of the reference kernel) from each
    returned carry; -> [(state before, state after, info)] as numpy."""
    out = []
    for k in keys:
        new, info = step_fn(k, rstate, *args)
        out.append((jax.tree.map(np.asarray, rstate), jax.tree.map(np.asarray, new),
                    jax.tree.map(np.asarray, info)))
        rstate = new
    return out


def _setup(rpot, ndim, dtype, seed):
    rs = np.random.RandomState(seed)
    z0 = jnp.asarray((0.4 * rs.standard_normal((CHAINS, ndim))).astype(dtype))
    rstate = jax.jit(jax.vmap(lambda z: rbase.init_state(rpot, z)))(z0)
    # step sizes from U-turning trees to a chain that diverges; a
    # per-chain metric
    step = jnp.asarray(np.array([0.02, 0.06, 0.15, 0.9], dtype))
    mass = jnp.asarray(rs.uniform(0.5, 1.5, (CHAINS, ndim)).astype(dtype))
    return rstate, step, mass


def _nuts_transitions(rpot, ndim, dtype, n, seed):
    rstate, step, mass = _setup(rpot, ndim, dtype, seed)
    fn = jax.jit(jax.vmap(lambda k, s, e, m: rnuts.nuts_step(k, s, rpot, e, m, MAX_DEPTH)))
    keys = [jax.random.split(k, CHAINS) for k in jax.random.split(jax.random.PRNGKey(seed), n)]
    return reference_transitions(fn, rstate, keys, step, mass), keys, step, mass


def _check_transitions(trans, keys, step, mass, ppot, ndim, tols):
    (zr, za), (vr, va), (gr, ga) = tols
    depths, leaves = [], []
    for (before, after, info), k in zip(trans, keys):
        noise = ReplayNoise(reference_nuts_noise(k, ndim, MAX_DEPTH))
        new, pinfo = pnuts.nuts_step(noise, _port_state(before), ppot, _t(step)[:, None],
                                     _t(mass), MAX_DEPTH)
        assert noise.done()
        np.testing.assert_array_equal(pinfo.num_grad_evals.numpy(), info.num_grad_evals)
        np.testing.assert_array_equal(
            pnuts.tree_depth_from_leaves(pinfo.num_grad_evals.numpy()),
            rnuts.tree_depth_from_leaves(info.num_grad_evals))
        np.testing.assert_array_equal(pinfo.is_divergent.numpy(), info.is_divergent)
        np.testing.assert_array_equal(pinfo.is_accepted.numpy(), info.is_accepted)
        # the lockstep loop: one ensemble evaluation per leaf of the
        # longest trajectory
        assert pinfo.num_ensemble_grad_evals == int(np.max(info.num_grad_evals))
        np.testing.assert_allclose(new.z.numpy(), after.z, rtol=zr, atol=za)
        np.testing.assert_allclose(new.potential_energy.numpy(), after.potential_energy,
                                   rtol=vr, atol=va)
        np.testing.assert_allclose(new.grad.numpy(), after.grad, rtol=gr, atol=ga)
        np.testing.assert_allclose(pinfo.energy.numpy(), info.energy, rtol=vr, atol=va)
        np.testing.assert_allclose(pinfo.accept_prob.numpy(), info.accept_prob, rtol=zr, atol=za)
        depths.append(rnuts.tree_depth_from_leaves(info.num_grad_evals))
        leaves.append(info.num_grad_evals)
    return np.array(depths), np.array(leaves)


def test_nuts_transitions_match_reference_in_float64():
    """24 transitions of 4 chains, max depth 6, every decision exact."""
    rpot, ppot, ndim = float64_pair()
    with jax.enable_x64(True):
        trans, keys, step, mass = _nuts_transitions(rpot, ndim, np.float64, 24, seed=1)
        tols = ((X64_RTOL, X64_ATOL),) * 3
        depths, leaves = _check_transitions(trans, keys, step, mass, ppot, ndim, tols)
    # the run covers what it must: U-turns short of the limit, the depth
    # limit, a divergence
    assert depths.min() < MAX_DEPTH - 1 and depths.max() == MAX_DEPTH
    assert len(np.unique(leaves)) > 4
    assert any(info.is_divergent.any() for _, _, info in trans)


def test_nuts_transitions_match_reference_grouped_float32():
    """The grouped flagship model, B1's plain version against the
    reference's grouped path: 20 transitions, decisions equal."""
    rpot, ppot, ndim = grouped_pair()
    trans, keys, step, mass = _nuts_transitions(rpot, ndim, np.float32, 20, seed=2)
    tols = ((GRAD_RTOL, GRAD_ATOL), (VAL_RTOL, 0.0), (GRAD_RTOL, GRAD_ATOL))
    depths, _ = _check_transitions(trans, keys, step, mass, ppot, ndim, tols)
    assert depths.min() < depths.max()


@pytest.mark.parametrize("i", range(40))
def test_checkpoint_slots_match_reference_bit_tricks(i):
    idx_min, idx_max, even = pnuts._checkpoint_slots(i)
    j = jnp.int32(i)
    want_max = int(jax.lax.population_count(jnp.right_shift(j, 1)))
    trailing = int(jax.lax.population_count(jnp.bitwise_xor(j, j + 1))) - 1
    assert (idx_min, idx_max, even) == (want_max - trailing + 1, want_max, i % 2 == 0)


def test_tree_depth_from_leaves_matches_reference():
    n = np.array([0, 1, 2, 3, 4, 7, 8, 63, 64, 1023, 1024])
    np.testing.assert_array_equal(pnuts.tree_depth_from_leaves(n), rnuts.tree_depth_from_leaves(n))


class RecordingPotential:
    """Records every batch the kernel is handed."""

    def __init__(self, pot):
        self.pot, self.seen = pot, []

    def value_and_grad(self, z):
        self.seen.append(z.clone())
        return self.pot.value_and_grad(z)


def test_finished_and_diverged_chains_feed_the_kernel_finite_positions():
    """A chain whose step overflows to inf diverges at its first leaf;
    for every later leaf the kernel sees a finite position of that chain,
    and the chain's transition still comes out as the reference's would:
    divergent, one leaf, not moved."""
    raw = hier_logistic_raw(300, 2, 3, dtype=np.float32)
    model = pml.HierLogistic(2, 3)
    fm = flatten_model(model)
    pot = RecordingPotential(fm.bind(prepare_model_data(model, raw, device="cpu")))
    z = 0.1 * torch.randn(3, fm.ndim, generator=torch.Generator().manual_seed(0))
    state = pbase.init_state(pot, z)
    step = torch.tensor([[0.05], [0.05], [1e38]])
    gen = torch.Generator().manual_seed(1)
    from stark_tpu_torch.kernels.chees import TorchNoise

    new, info = pnuts.nuts_step(TorchNoise(gen), state, pot, step, torch.ones(3, fm.ndim), 5)
    assert all(bool(torch.isfinite(s).all()) for s in pot.seen)
    assert len(pot.seen) == 1 + info.num_ensemble_grad_evals
    # chain 2's first leaf left the finite numbers: from then on the
    # kernel is handed its start
    assert all(torch.equal(s[2], z[2]) for s in pot.seen[1:])
    assert bool(info.is_divergent[2]) and int(info.num_grad_evals[2]) == 1
    assert torch.equal(new.z[2], z[2]) and not bool(info.is_accepted[2])
    assert int(info.num_grad_evals[:2].max()) > 1
    assert torch.isfinite(new.z).all()
