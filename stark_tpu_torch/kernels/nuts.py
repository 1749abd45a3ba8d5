"""Iterative multinomial NUTS over a batch of chains — counterpart of
``stark_tpu/kernels/nuts.py``.

The tree doubling is the JAX package's two nested loops with a fixed
``max_depth``: doubling rounds, each building one subtree leaf by leaf
(one leapfrog step per leaf), with the U-turn checks of the
O(max_depth) checkpoint stack (leaf ``i`` even: store its momentum and
the running momentum sum in slot ``popcount(i >> 1)``; leaf ``i`` odd:
close ``trailing_ones(i)`` subtrees whose left edges sit in the slots
below), multinomial selection inside a subtree and biased progressive
sampling between the trajectory and each new subtree.

Where the JAX package ``vmap``s one chain's kernel, this one runs the
(C, d) batch in lockstep, as that ``vmap`` of two ``while_loop``s does:

* every leaf is ONE ensemble potential-gradient evaluation for all C
  chains (one likelihood kernel launch), a chain whose subtree or
  trajectory has ended included; its results are discarded with
  ``torch.where``, and the kernel is handed a finite position of the
  chain for it (`base.guarded_value_and_grad`), so a finished or
  diverged chain never feeds it a non-finite one;
* all chains that are still running share the doubling round and the
  leaf index, so the checkpoint slots are host integers;
* a subtree ends when every chain's subtree has ended, the transition
  when every chain's trajectory has.  Each needs "is any chain still
  running" on the host: it is read after every leaf but a subtree's
  last, and after every doubling round, one device-to-host read each.
  Where it is read changes how many evaluations are made past the end,
  never a value: the draws do not depend on it.

Randomness, drawn once per transition from the noise source, so no leaf
waits on a generator: the momentum normals (C, d), the direction
uniforms (C, max_depth) (right when < 1/2, the JAX package's
``bernoulli``), the trajectory-take uniforms (C, max_depth) and the
leaf-selection uniforms (C, max_depth, 2**(max_depth-1)), indexed by
doubling round and leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import HMCInfo, HMCState, guarded_leapfrog_step, kinetic_energy

_DIVERGENCE_THRESHOLD = 1000.0


def _where(mask, a, b):
    """``torch.where`` with a (C,) mask broadcast over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _is_turning(inv_mass_diag, r_left, r_right, r_sum):
    """The trajectory-level generalized U-turn test, per chain."""
    v_left = inv_mass_diag * r_left
    v_right = inv_mass_diag * r_right
    rho = r_sum - 0.5 * (r_left + r_right)
    return (torch.sum(v_left * rho, -1) <= 0.0) | (torch.sum(v_right * rho, -1) <= 0.0)


class _Subtree(NamedTuple):
    z_far: torch.Tensor  # last leaf generated (outermost edge of the subtree)
    r_far: torch.Tensor
    grad_far: torch.Tensor
    z_prop: torch.Tensor
    pe_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor  # full Hamiltonian at the proposal leaf
    r_sum: torch.Tensor  # sum of leaf momenta (subtree-internal)
    log_weight: torch.Tensor  # logsumexp of (H0 - H_leaf) over leaves
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor


def _subtree_init(z0, r0, grad0, energy0, max_depth):
    """A fresh subtree anchored at the (z0, r0, grad0) edge, and the
    zeroed checkpoint stacks (C, max_depth, d): raw momenta, cumulative
    momentum sums and velocity-scaled momenta."""
    C, d = z0.shape
    f = dict(dtype=z0.dtype, device=z0.device)
    no = torch.zeros(C, dtype=torch.bool, device=z0.device)
    init = _Subtree(
        z_far=z0, r_far=r0, grad_far=grad0,
        z_prop=z0, pe_prop=torch.zeros(C, **f), grad_prop=grad0, energy_prop=energy0,
        r_sum=torch.zeros(C, d, **f),
        log_weight=torch.full((C,), float("-inf"), **f),
        turning=no, diverging=no,
        sum_accept=torch.zeros(C, **f),
        num_leaves=torch.zeros(C, dtype=torch.int32, device=z0.device),
    )
    ckpts = tuple(torch.zeros(C, max_depth, d, **f) for _ in range(3))
    return init, ckpts


def _checkpoint_slots(i: int):
    """(idx_min, idx_max, even) of leaf ``i``: an even leaf stores its
    checkpoint in slot idx_max; an odd one closes the subtrees whose left
    edges sit in slots idx_min..idx_max."""
    idx_max = bin(i >> 1).count("1")
    trailing_ones = bin(i ^ (i + 1)).count("1") - 1
    return idx_max - trailing_ones + 1, idx_max, i % 2 == 0


def _leaf_step(st: _Subtree, ckpts, i: int, u_sel, live, z_hold, *, potential_fn,
               directed_step, inv_mass_diag, energy0):
    """ONE leaf of every live chain's subtree: a leapfrog step (one
    ensemble evaluation), multinomial proposal selection and the
    checkpoint-stack U-turn checks.  A chain that is not ``live`` keeps
    every field a merge reads: its flags, leaf count, accept sum and
    proposal."""
    r_ckpts, s_ckpts, vr_ckpts = ckpts
    z, r, grad, pe = guarded_leapfrog_step(
        potential_fn, st.z_far, st.r_far, st.grad_far, directed_step, inv_mass_diag,
        live, z_hold,
    )
    energy = pe + kinetic_energy(r, inv_mass_diag)
    delta = energy - energy0
    delta = torch.where(torch.isnan(delta), torch.full_like(delta, float("inf")), delta)
    diverging = delta > _DIVERGENCE_THRESHOLD
    log_w = -delta
    accept_leaf = torch.clamp(torch.exp(-delta), max=1.0)

    new_log_weight = torch.logaddexp(st.log_weight, log_w)
    take = live & (u_sel < torch.exp(log_w - new_log_weight))
    r_sum = st.r_sum + r

    idx_min, idx_max, even = _checkpoint_slots(i)
    v_now = r * inv_mass_diag
    if even:
        # written for every chain: a stack is read only by its own
        # chain's later leaves, which only a live chain has
        r_ckpts[:, idx_max] = r
        s_ckpts[:, idx_max] = r_sum
        vr_ckpts[:, idx_max] = v_now
        turning = torch.zeros_like(live)
    else:
        sl = slice(idx_min, idx_max + 1)
        rc, vc = r_ckpts[:, sl], vr_ckpts[:, sl]
        rho = (r_sum[:, None, :] - s_ckpts[:, sl] + rc) - 0.5 * (rc + r[:, None, :])
        turn_each = (torch.sum(vc * rho, -1) <= 0.0) | (
            torch.sum(v_now[:, None, :] * rho, -1) <= 0.0
        )
        turning = turn_each.any(-1)

    st = _Subtree(
        z_far=z, r_far=r, grad_far=grad,
        z_prop=_where(take, z, st.z_prop),
        pe_prop=torch.where(take, pe, st.pe_prop),
        grad_prop=_where(take, grad, st.grad_prop),
        energy_prop=torch.where(take, energy, st.energy_prop),
        r_sum=r_sum,
        log_weight=torch.where(live, new_log_weight, st.log_weight),
        turning=torch.where(live, turning, st.turning),
        diverging=torch.where(live, diverging, st.diverging),
        sum_accept=torch.where(live, st.sum_accept + accept_leaf, st.sum_accept),
        num_leaves=st.num_leaves + live.to(torch.int32),
    )
    return st


def _build_subtree(depth: int, active, z0, r0, grad0, u_leaf, z_hold, potential_fn,
                   directed_step, inv_mass_diag, energy0, max_depth):
    """Up to 2**depth leaves of every ``active`` chain's subtree, one
    leapfrog step past its (z0, r0, grad0) edge; returns (subtree,
    ensemble evaluations)."""
    num_target = 1 << depth
    st, ckpts = _subtree_init(z0, r0, grad0, energy0, max_depth)
    live = active
    i = 0
    while True:
        st = _leaf_step(
            st, ckpts, i, u_leaf[:, i], live, z_hold, potential_fn=potential_fn,
            directed_step=directed_step, inv_mass_diag=inv_mass_diag, energy0=energy0,
        )
        live = live & ~st.turning & ~st.diverging
        i += 1
        # the host read: does any chain's subtree go on?
        if i >= num_target or not bool(live.any()):
            return st, i


class _Traj(NamedTuple):
    z_left: torch.Tensor
    r_left: torch.Tensor
    grad_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    grad_right: torch.Tensor
    z_prop: torch.Tensor
    pe_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor
    r_sum: torch.Tensor
    log_weight: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor


def _traj_init(state: HMCState, r0, energy0) -> _Traj:
    """The single-point trajectory at the start of a transition."""
    C = state.z.shape[0]
    no = torch.zeros(C, dtype=torch.bool, device=state.z.device)
    zero = torch.zeros(C, dtype=state.z.dtype, device=state.z.device)
    return _Traj(
        z_left=state.z, r_left=r0, grad_left=state.grad,
        z_right=state.z, r_right=r0, grad_right=state.grad,
        z_prop=state.z, pe_prop=state.potential_energy, grad_prop=state.grad,
        energy_prop=energy0, r_sum=r0, log_weight=zero, turning=no, diverging=no,
        sum_accept=zero, num_leaves=torch.zeros(C, dtype=torch.int32, device=state.z.device),
    )


def _merge_traj(traj: _Traj, sub: _Subtree, going_right, u_take, active, inv_mass_diag) -> _Traj:
    """Close one doubling round of every ``active`` chain: biased
    progressive sampling between the trajectory and the finished
    subtree, the edge merge and the trajectory-level U-turn test.  A
    chain that is not active keeps its trajectory."""
    ok = active & ~sub.turning & ~sub.diverging
    p_take = torch.exp(torch.clamp(sub.log_weight - traj.log_weight, max=0.0))
    take = ok & (u_take < p_take)

    z_left = _where(going_right, traj.z_left, sub.z_far)
    r_left = _where(going_right, traj.r_left, sub.r_far)
    g_left = _where(going_right, traj.grad_left, sub.grad_far)
    z_right = _where(going_right, sub.z_far, traj.z_right)
    r_right = _where(going_right, sub.r_far, traj.r_right)
    g_right = _where(going_right, sub.grad_far, traj.grad_right)
    r_sum = traj.r_sum + sub.r_sum
    turning_total = _is_turning(inv_mass_diag, r_left, r_right, r_sum)

    def keep(new, old):
        return _where(active, new, old)

    return _Traj(
        z_left=keep(z_left, traj.z_left), r_left=keep(r_left, traj.r_left),
        grad_left=keep(g_left, traj.grad_left),
        z_right=keep(z_right, traj.z_right), r_right=keep(r_right, traj.r_right),
        grad_right=keep(g_right, traj.grad_right),
        z_prop=_where(take, sub.z_prop, traj.z_prop),
        pe_prop=torch.where(take, sub.pe_prop, traj.pe_prop),
        grad_prop=_where(take, sub.grad_prop, traj.grad_prop),
        energy_prop=torch.where(take, sub.energy_prop, traj.energy_prop),
        r_sum=keep(r_sum, traj.r_sum),
        log_weight=keep(torch.logaddexp(traj.log_weight, sub.log_weight), traj.log_weight),
        turning=keep(sub.turning | turning_total, traj.turning),
        diverging=keep(sub.diverging, traj.diverging),
        sum_accept=keep(traj.sum_accept + sub.sum_accept, traj.sum_accept),
        num_leaves=keep(traj.num_leaves + sub.num_leaves, traj.num_leaves),
    )


def tree_depth_from_leaves(num_leaves):
    """Trajectory depth from the per-transition leaf count (host numpy):
    every doubling round before the last generates its full subtree, so
    a trajectory of depth k has 2**(k-1) .. 2**k - 1 leaves and depth =
    floor(log2(num_leaves)) + 1 (0 leaves: depth 0)."""
    n = np.asarray(num_leaves, np.int64)
    return np.where(n > 0, np.floor(np.log2(np.maximum(n, 1))), -1).astype(np.int64) + 1


def nuts_noise(noise, chains: int, ndim: int, max_depth: int):
    """One transition's randomness, in the order it is drawn: momentum
    normals (C, d), direction and trajectory-take uniforms (C, max_depth),
    leaf-selection uniforms (C, max_depth, 2**(max_depth-1))."""
    eps = noise.normal((chains, ndim))
    u_dir = noise.uniform((chains, max_depth))
    u_take = noise.uniform((chains, max_depth))
    u_leaf = noise.uniform((chains, max_depth, 1 << max(max_depth - 1, 0)))
    return eps, u_dir, u_take, u_leaf


def nuts_step(noise, state: HMCState, potential_fn, step_size, inv_mass_diag, max_depth: int = 10):
    """One NUTS transition of every chain: step size (C, 1), inverse mass
    (C, d).  Returns (HMCState, HMCInfo)."""
    C, d = state.z.shape
    eps, u_dir, u_take, u_leaf = nuts_noise(noise, C, d, max_depth)
    r0 = eps * torch.rsqrt(inv_mass_diag)
    energy0 = state.potential_energy + kinetic_energy(r0, inv_mass_diag)

    traj = _traj_init(state, r0, energy0)
    active = torch.ones(C, dtype=torch.bool, device=state.z.device)
    depth = evals = 0
    while depth < max_depth:
        going_right = u_dir[:, depth] < 0.5
        z_edge = _where(going_right, traj.z_right, traj.z_left)
        r_edge = _where(going_right, traj.r_right, traj.r_left)
        g_edge = _where(going_right, traj.grad_right, traj.grad_left)
        directed_step = torch.where(going_right[:, None], step_size, -step_size)
        sub, n = _build_subtree(
            depth, active, z_edge, r_edge, g_edge, u_leaf[:, depth], state.z, potential_fn,
            directed_step, inv_mass_diag, energy0, max_depth,
        )
        evals += n
        traj = _merge_traj(traj, sub, going_right, u_take[:, depth], active, inv_mass_diag)
        active = active & ~traj.turning & ~traj.diverging
        depth += 1
        # the host read: does any chain's trajectory go on?
        if not bool(active.any()):
            break

    new_state = HMCState(z=traj.z_prop, potential_energy=traj.pe_prop, grad=traj.grad_prop)
    num = torch.clamp(traj.num_leaves, min=1).to(traj.sum_accept.dtype)
    info = HMCInfo(
        accept_prob=traj.sum_accept / num,
        is_accepted=(traj.z_prop != state.z).any(-1),
        is_divergent=traj.diverging,
        energy=traj.energy_prop,
        num_grad_evals=traj.num_leaves,
        num_ensemble_grad_evals=evals,
    )
    return new_state, info
