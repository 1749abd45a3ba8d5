"""ChEES-HMC sampling loop — counterpart of ``stark_tpu/chees.py``.

Warmup:
  * step size: dual averaging on the cross-chain mean accept (0.8);
  * trajectory length T: Adam ascent on log T with the per-step ChEES
    gradient, jittered by a Halton sequence, L_t = ceil(u_t T / eps),
    u_t in (0, 2);
  * diagonal mass: pooled cross-(chain x step) Welford, applied at the
    Stan window ends;
  * optional MAP init: Adam descent on the potential before warmup.
Sampling keeps everything frozen except the Halton jitter.

`make_chees_parts` builds the pieces with explicit carries
(init_carry / warm_segment / finalize / sample_segment, and
sample_segment_diag, which also carries the streaming-diagnostics
accumulator), so a test can drive the JAX package's parts and these on
the same inputs; `run_chees` and `chees_sample` compose them into one
run, and the adaptive runner (`runner.py`) drives them block by block.
A warmup segment runs any slice of the schedule from any carry, so the
runner can checkpoint between segments and resume from one.

Where the JAX package runs each segment as one compiled ``lax.scan``,
this module runs eager PyTorch on the device and reads one integer back
to the host per transition: the leapfrog count L, which sets the length
of the Python leapfrog loop.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .adaptation import (
    DualAveragingState,
    WelfordState,
    build_warmup_schedule,
    da_init,
    da_update,
    welford_init,
    welford_variance,
)
from .kernels.base import HMCState, stream_diag_update
from .kernels.chees import TorchNoise, chees_transition, halton, init_ensemble
from .model import Model, flatten_model, prepare_model_data
from .sampler import Posterior, SamplerConfig, constrain_draws


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: int


def _adam_ascent(s: AdamState, grad, lr=0.025, b1=0.9, b2=0.95):
    t = s.t + 1
    m = b1 * s.m + (1.0 - b1) * grad
    v = b2 * s.v + (1.0 - b2) * grad * grad
    # bias corrections in float32, as the JAX package computes them
    # (1 - 0.999**t differs by ~1e-5 relative between f32 and f64)
    tf = np.float32(t)
    mhat = m / float(np.float32(1.0) - np.float32(b1) ** tf)
    vhat = v / float(np.float32(1.0) - np.float32(b2) ** tf)
    step = lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return AdamState(m, v, t), step


def _welford_batch(w: WelfordState, xs: torch.Tensor) -> WelfordState:
    """Merge a (C, d) batch into the accumulator (Chan parallel combine)."""
    bc = xs.shape[0]
    bmean = xs.mean(0)
    bm2 = torch.sum((xs - bmean[None, :]) ** 2, dim=0)
    na, nb = float(w.count), float(bc)
    delta = bmean - w.mean
    tot = na + nb
    mean = w.mean + delta * nb / tot
    m2 = w.m2 + bm2 + delta * delta * na * nb / tot
    return WelfordState(w.count + bc, mean, m2)


class CheesWarmCarry(NamedTuple):
    """Full warmup adaptation state."""

    states: HMCState
    da: DualAveragingState
    adam: AdamState
    log_T: torch.Tensor
    wf: WelfordState
    inv_mass: torch.Tensor


class CheesRunCarry(NamedTuple):
    """Frozen-adaptation sampling state."""

    states: HMCState
    log_eps: torch.Tensor
    log_T: torch.Tensor
    inv_mass: torch.Tensor


class CheesParts(NamedTuple):
    init_carry: Callable  # (z0, data) -> CheesWarmCarry
    warm_segment: Callable  # (carry, noise, us, idxs, aflags, wflags, data)
    finalize: Callable  # (CheesWarmCarry) -> CheesRunCarry
    sample_segment: Callable  # (carry, noise, us, data) -> (carry, outs)
    warm_cap: int
    schedule: Any  # WarmupSchedule for cfg.num_warmup
    # (carry, diag, noise, us, data) -> (carry, diag, outs): sample_segment
    # plus the on-device StreamDiagState, updated from every draw
    sample_segment_diag: Callable


def make_chees_parts(fm, cfg: SamplerConfig) -> CheesParts:
    """Ensemble-level ChEES building blocks with explicit carries."""
    d = fm.ndim
    T0 = cfg.init_traj_length if cfg.init_traj_length is not None else cfg.init_step_size
    sched = build_warmup_schedule(cfg.num_warmup)
    ends = np.flatnonzero(sched.window_end)
    # T ascent starts after the first metric refresh
    t_start = int(ends[0]) + 1 if len(ends) else cfg.num_warmup // 4
    # cap warmup (and sampling) trajectories; see the JAX package's note
    warm_cap = min(cfg.max_leapfrog, 512)
    log_cap = math.log(float(warm_cap))

    def num_steps(u: float, log_T, log_eps) -> int:
        # the one host read per transition
        L = torch.ceil(u * torch.exp(log_T - log_eps)).to(torch.int32)
        return int(torch.clamp(L, 1, warm_cap).item())

    def init_carry(z0: torch.Tensor, data=None) -> CheesWarmCarry:
        potential_fn = fm.bind(data)
        dev = z0.device
        if cfg.map_init_steps > 0:
            # Adam descent toward the mode before warmup: on peaked big-N
            # posteriors a random init is far from the typical set
            adam = AdamState(torch.zeros_like(z0), torch.zeros_like(z0), 0)
            for _ in range(cfg.map_init_steps):
                _, g = potential_fn.value_and_grad(z0)
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                adam, step = _adam_ascent(adam, -g, lr=0.05, b2=0.999)
                z0 = z0 + step
        f32 = dict(device=dev, dtype=torch.float32)
        return CheesWarmCarry(
            states=init_ensemble(potential_fn, z0),
            da=da_init(torch.tensor(cfg.init_step_size, **f32)),
            adam=AdamState(torch.zeros((), **f32), torch.zeros((), **f32), 0),
            log_T=torch.log(torch.tensor(T0, **f32)),
            wf=welford_init(d, dev),
            inv_mass=torch.ones(d, **f32),
        )

    def warm_step(carry: CheesWarmCarry, noise, potential_fn, u, idx, accum, at_window):
        states, da, adam, log_T, wf, inv_mass = carry
        log_eps = da.log_step
        L = num_steps(u, log_T, log_eps)
        states, info = chees_transition(
            noise, states, potential_fn, torch.exp(log_eps), inv_mass, L
        )
        da = da_update(da, info.accept_prob.mean(), cfg.target_accept)
        # chain rule d/dlogT = T d/dT on the criterion-relative gradient
        adam, step = _adam_ascent(adam, info.grad_rel_T * torch.exp(log_T), lr=0.05)
        if idx >= t_start:
            new_log_T = log_T + step
            # one non-finite step must not poison T for the rest of warmup
            log_T = torch.where(torch.isfinite(new_log_T), new_log_T, log_T)
        # keep T inside the regime warmup executes: sampling must never
        # run trajectory lengths no warmup step validated
        log_T = torch.minimum(torch.maximum(log_T, log_eps), log_eps + log_cap)
        if accum:
            wf = _welford_batch(wf, states.z)
        if at_window:
            # window end: apply the pooled variance as the metric, restart
            # the accumulator and the step-size averaging
            inv_mass = welford_variance(wf)
            wf = welford_init(d, inv_mass.device)
            da = da_init(torch.exp(da.log_step))
        carry = CheesWarmCarry(states, da, adam, log_T, wf, inv_mass)
        return carry, info

    def warm_segment(carry, noise, us, idxs, aflags, wflags, data=None):
        """Warmup transitions for the given schedule slice.  Returns
        (carry, (divergences, leapfrog steps))."""
        potential_fn = fm.bind(data)
        n_div = torch.zeros((), dtype=torch.int64, device=carry.inv_mass.device)
        n_leap = 0
        for u, idx, accum, at_window in zip(us, idxs, aflags, wflags):
            carry, info = warm_step(
                carry, noise, potential_fn, float(u), int(idx), bool(accum),
                bool(at_window),
            )
            n_div = n_div + info.is_divergent.sum()
            n_leap += info.num_leapfrog
        return carry, (int(n_div.item()), n_leap)

    def finalize(carry: CheesWarmCarry) -> CheesRunCarry:
        return CheesRunCarry(
            states=carry.states,
            log_eps=carry.da.log_avg_step,
            log_T=carry.log_T,
            inv_mass=carry.inv_mass,
        )

    def sample_loop(carry: CheesRunCarry, diag, noise, us, data):
        """The one sampling loop of both segment variants: the
        accumulator only reads each draw, so the draws are the same bits
        with it or without it."""
        potential_fn = fm.bind(data)
        step_size = torch.exp(carry.log_eps)
        zs, acc, div, nleap = [], [], [], []
        states = carry.states
        for u in us:
            L = num_steps(float(u), carry.log_T, carry.log_eps)
            states, info = chees_transition(
                noise, states, potential_fn, step_size, carry.inv_mass, L
            )
            if diag is not None:
                diag = stream_diag_update(diag, states.z)
            # draws go to the host as they are made, so device memory
            # holds no draw history
            zs.append(states.z.cpu())
            acc.append(info.accept_prob.cpu())
            div.append(info.is_divergent.cpu())
            nleap.append(L)
        carry = CheesRunCarry(states, carry.log_eps, carry.log_T, carry.inv_mass)
        if not zs:
            return carry, diag, None
        outs = (
            torch.stack(zs).numpy(),
            torch.stack(acc).numpy(),
            torch.stack(div).numpy(),
            np.asarray(nleap, np.int64),
        )
        return carry, diag, outs

    def sample_segment(carry: CheesRunCarry, noise, us, data=None):
        """Sampling transitions; returns (carry, outs) with outs the
        host-side step-major (zs, accept_prob, is_divergent, nleap)."""
        carry, _, outs = sample_loop(carry, None, noise, us, data)
        return carry, outs

    def sample_segment_diag(carry: CheesRunCarry, diag, noise, us, data=None):
        """`sample_segment` that also folds every draw into ``diag`` (a
        `kernels.base.StreamDiagState`); returns (carry, diag, outs)."""
        return sample_loop(carry, diag, noise, us, data)

    return CheesParts(
        init_carry=init_carry,
        warm_segment=warm_segment,
        finalize=finalize,
        sample_segment=sample_segment,
        warm_cap=warm_cap,
        schedule=sched,
        sample_segment_diag=sample_segment_diag,
    )


def chees_schedule_arrays(parts: CheesParts, cfg: SamplerConfig):
    """Host-side per-step inputs: (aflags, wflags, u_warm, u_run, idxs)."""
    sched = parts.schedule
    total = cfg.num_samples * cfg.thin
    return (
        np.asarray(sched.adapt_mass),
        np.asarray(sched.window_end),
        (2.0 * halton(cfg.num_warmup)).astype(np.float32),
        (2.0 * halton(total)).astype(np.float32),
        np.arange(cfg.num_warmup),
    )


def chees_init_positions(fm, generator, chains, init_params=None, device=None):
    """Random typical-set draws, or a jittered user-provided point
    (identical chains would zero the ChEES criterion)."""
    if init_params is not None:
        z0 = fm.unconstrain(
            {k: torch.as_tensor(v, device=device)[None] for k, v in init_params.items()}
        ).expand(chains, fm.ndim)
        return z0 + 0.1 * torch.randn(
            (chains, fm.ndim), generator=generator, device=device
        )
    return fm.init_flat(chains, generator, device)


def run_chees(
    fm,
    cfg: SamplerConfig,
    data=None,
    *,
    chains: int,
    seed: int = 0,
    init_params: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    noise=None,
) -> Posterior:
    """One ChEES run on one device.  ``noise`` replaces the default
    `TorchNoise` (tests replay another implementation's draws)."""
    dev = resolve_device(device)
    parts = make_chees_parts(fm, cfg)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if noise is None:
        noise = TorchNoise(generator)
    z0 = chees_init_positions(fm, generator, chains, init_params, dev)
    aflags, wflags, u_warm, u_run, idxs = chees_schedule_arrays(parts, cfg)

    carry = parts.init_carry(z0, data)
    carry, (wdiv, wleap) = parts.warm_segment(
        carry, noise, u_warm, idxs, aflags, wflags, data
    )
    run_carry = parts.finalize(carry)
    run_carry, outs = parts.sample_segment(run_carry, noise, u_run, data)
    return assemble_chees_posterior(fm, cfg, chains, outs, run_carry, wdiv, wleap)


def assemble_chees_posterior(fm, cfg, chains, outs, run_carry, wdiv, wleap) -> Posterior:
    """Build the Posterior from the step-major sampling outputs."""
    if outs is not None:
        zs, acc, div, nleap = outs
    else:  # warmup-only run
        zs = np.zeros((0, chains, fm.ndim), np.float32)
        acc = np.zeros((0, chains), np.float32)
        div = np.zeros((0, chains), bool)
        nleap = np.zeros((0,), np.int64)
    num_divergent = int(div.sum())
    total_leapfrog = int(nleap.sum())
    if cfg.thin > 1:
        zs = zs[cfg.thin - 1:: cfg.thin]
        acc = acc[cfg.thin - 1:: cfg.thin]
        div = div[cfg.thin - 1:: cfg.thin]
    zs = np.swapaxes(zs, 0, 1)  # (chains, draws, d)
    draws = constrain_draws(fm, zs)
    log_eps = float(run_carry.log_eps)
    stats = {
        "accept_prob": acc.T,
        "is_divergent": div.T,
        "num_divergent": np.asarray(num_divergent),
        "num_warmup_divergent": np.asarray(wdiv),
        # per-chain gradient units, as the JAX package reports them
        "num_grad_evals": np.asarray(total_leapfrog * chains),
        "num_warmup_grad_evals": np.asarray((wleap + cfg.map_init_steps) * chains),
        # ensemble evaluations: MAP steps, the initial state, every
        # warmup and sampling leapfrog — one likelihood kernel launch each
        "num_ensemble_grad_evals": np.asarray(
            cfg.map_init_steps + 1 + wleap + total_leapfrog
        ),
        "step_size": np.full((chains,), float(np.exp(log_eps))),
        "traj_length": np.asarray(float(torch.exp(run_carry.log_T))),
        "inv_mass": run_carry.inv_mass.cpu().numpy(),
    }
    return Posterior(draws, stats, flat_model=fm, draws_flat=zs)


def chees_sample(
    model: Model,
    data: Any = None,
    *,
    chains: int = 16,
    num_warmup: int = 500,
    num_samples: int = 1000,
    init_step_size: float = 0.1,
    init_traj_length: Optional[float] = None,
    max_leapfrog: int = 1000,
    target_accept: float = 0.8,
    map_init_steps: int = 0,
    seed: int = 0,
    init_params: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> Posterior:
    """One-call ChEES-HMC on ``device`` (``cuda`` by default); returns a
    Posterior.  ``data`` is the raw dataset (numpy or tensors); it is
    prepared for the model and moved to the device here."""
    dev = resolve_device(device)
    cfg = SamplerConfig(
        kernel="chees",
        num_warmup=num_warmup,
        num_samples=num_samples,
        init_step_size=init_step_size,
        init_traj_length=init_traj_length,
        max_leapfrog=max_leapfrog,
        target_accept=target_accept,
        map_init_steps=map_init_steps,
    )
    data = prepare_model_data(model, data, dev)
    fm = flatten_model(model)
    return run_chees(
        fm, cfg, data, chains=chains, seed=seed, init_params=init_params, device=dev
    )
