"""Sampler frontend: configuration, the per-chain samplers' warmup and
draw loops, the Posterior and `sample` — counterpart of
``stark_tpu/sampler.py``.

``sample`` runs `backends.CudaBackend.run`: the per-chain kernels NUTS
(the default, as in the JAX package) and HMC through the functions
here, the ChEES ensemble through `chees.run_chees`.

The per-chain kernels adapt every chain on its own (Stan's windowed
schedule, per-chain dual averaging and Welford), as the JAX package's
``vmap`` over one chain's loop does; the (C, d) batch moves in lockstep,
one ensemble potential-gradient evaluation (one likelihood kernel
launch) per leapfrog step.  Where the JAX package compiles each loop,
this is one Python loop on the host, `drive_segmented_sampling` over
`make_segmented_warmup` and `make_block_runner` (`make_chain_runner`
binds them): ``dispatch_steps`` only bounds its segments, so a run draws
bitwise alike with or without it.

Random streams: one ``torch.Generator`` each for the initial positions,
the warmup and the sampling transitions (`chain_streams`, the adaptive
runner's streams too), where the JAX package splits keys.  The warmup
stream serves the initial step-size search and then every warmup
transition; the sampling stream every sampling transition.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import diagnostics
from ._device import DeviceLike
from ._unported import refuse
from .adaptation import (
    DualAveragingState,
    WelfordState,
    build_warmup_schedule,
    da_init,
    da_update,
    find_reasonable_step_size,
    welford_init,
    welford_update,
    welford_variance,
)
from .kernels.base import HMCState, init_state, stream_diag_update


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kernel: str = "nuts"  # "nuts" | "hmc" | "chees"
    num_warmup: int = 1000
    num_samples: int = 1000
    thin: int = 1
    target_accept: float = 0.8
    max_tree_depth: int = 10
    num_leapfrog: int = 32  # hmc only
    init_step_size: float = 1.0
    adapt_step_size: bool = True
    adapt_mass: bool = True
    # chees only (the ensemble sampler, `chees.py`):
    init_traj_length: Optional[float] = None
    max_leapfrog: int = 1000
    map_init_steps: int = 0
    # the JAX package's in-loop telemetry heartbeat: ROADMAP A12, refused
    progress_every: Optional[int] = None

    def __post_init__(self):
        if self.progress_every is not None:
            raise NotImplementedError(
                "the in-loop progress heartbeat (progress_every=) is not ported "
                "yet (ROADMAP A12)"
            )


class Posterior:
    """Posterior draws + sample stats for a finished run (numpy, host)."""

    def __init__(self, draws, sample_stats, flat_model=None, draws_flat=None):
        self.draws = draws
        self.sample_stats = sample_stats
        self.flat_model = flat_model
        self.draws_flat = draws_flat

    @property
    def num_chains(self) -> int:
        return next(iter(self.draws.values())).shape[0]

    @property
    def num_samples(self) -> int:
        return next(iter(self.draws.values())).shape[1]

    @property
    def num_divergent(self) -> int:
        if "num_divergent" in self.sample_stats:
            return int(np.sum(self.sample_stats["num_divergent"]))
        return int(np.sum(self.sample_stats.get("is_divergent", 0)))

    def rhat(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.split_rhat(v) for k, v in self.draws.items()}

    def rank_rhat(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.rank_rhat(v) for k, v in self.draws.items()}

    def ess(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.ess(v) for k, v in self.draws.items()}

    def ess_tail(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.ess_tail(v) for k, v in self.draws.items()}

    def summary(self):
        return diagnostics.summarize(self.draws)

    def max_rhat(self) -> float:
        return float(max(np.max(v) for v in self.rhat().values()))

    def min_ess(self) -> float:
        return float(min(np.min(v) for v in self.ess().values()))

    def functional(self, fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor]) -> np.ndarray:
        """``fn(params) -> tensor`` of one draw, applied to every draw:
        (chains, draws, ...), on the host CPU.  The diagnostic space for
        models whose parameters are not identifiable (a neural net's
        hidden units, a mixture's labels): R-hat and ESS of predictions at
        probe inputs instead of weights.  ``fn`` sees one draw's
        parameters (``torch.func.vmap`` over the draws, 1024 at a time to
        bound the host memory of its intermediates)."""
        params = {k: torch.as_tensor(v) for k, v in self.draws.items()}
        c, t = next(iter(params.values())).shape[:2]
        flat = {k: v.reshape((c * t,) + tuple(v.shape[2:])) for k, v in params.items()}
        with torch.no_grad():
            out = torch.func.vmap(fn, chunk_size=1024)(flat)
        return out.reshape((c, t) + tuple(out.shape[1:])).numpy()


def constrain_draws(fm, zs: np.ndarray) -> Dict[str, np.ndarray]:
    """(chains, draws, d) flat draws -> named constrained draws, on the
    host CPU (elementwise; no reason to send the history to the card)."""
    c, s, d = zs.shape
    with torch.no_grad():
        params = fm.constrain(torch.as_tensor(zs.reshape(c * s, d)))
    return {k: v.numpy().reshape((c, s) + tuple(v.shape[1:])) for k, v in params.items()}


# ------------------------------------------------------------ streams


def seed_of(*parts) -> int:
    """A generator seed (< 2**63) from integers: one stream per purpose."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0] >> 1)


def chain_streams(seed: int, device: torch.device):
    """(initial positions, warmup, sampling) generators of a run."""
    return tuple(
        torch.Generator(device=device).manual_seed(seed_of(seed, k)) for k in range(3)
    )


def init_positions(fm, generator, chains: int, init_params=None, device=None) -> torch.Tensor:
    """Every chain at the user's point, or U(-2, 2) in unconstrained
    space (Stan-style; `model.FlatModel.init_flat`)."""
    if init_params is not None:
        z0 = fm.unconstrain(
            {k: torch.as_tensor(v, device=device)[None] for k, v in init_params.items()}
        )
        return z0.expand(chains, fm.ndim).clone()
    return fm.init_flat(chains, generator, device)


# ---------------------------------------------------- per-chain kernels


def make_kernel(cfg: SamplerConfig) -> Callable:
    """step(noise, state, potential_fn=, step_size= (C, 1),
    inv_mass_diag= (C, d)) -> (HMCState, HMCInfo)."""
    if cfg.kernel == "nuts":
        from .kernels.nuts import nuts_step

        def step(noise, state, potential_fn, step_size, inv_mass_diag):
            return nuts_step(noise, state, potential_fn, step_size, inv_mass_diag,
                             max_depth=cfg.max_tree_depth)

        return step
    if cfg.kernel == "hmc":
        from .kernels.hmc import hmc_step

        def step(noise, state, potential_fn, step_size, inv_mass_diag):
            return hmc_step(noise, state, potential_fn, step_size, inv_mass_diag,
                            num_leapfrog=cfg.num_leapfrog)

        return step
    if cfg.kernel == "chees":
        raise ValueError(
            "chees is an ensemble kernel with its own warmup; the backend "
            "routes it through chees.make_chees_parts, not the per-chain loops"
        )
    raise ValueError(f"unknown kernel {cfg.kernel!r}")


class WarmCarry(NamedTuple):
    """Per-chain warmup adaptation state: (C,) step-size averaging,
    (C, d) Welford moments and inverse mass (field names as
    `chees.CheesWarmCarry`'s)."""

    states: HMCState
    da: DualAveragingState
    wf: WelfordState
    inv_mass: torch.Tensor


def _make_warmup_body(cfg: SamplerConfig, kernel):
    """The per-transition warmup update of every warmup loop."""

    def body(carry: WarmCarry, noise, potential_fn, adapt_mass_f: bool, window_end_f: bool):
        state, da, welford, inv_mass = carry
        if cfg.adapt_step_size:
            step_size = torch.exp(da.log_step)
        else:
            step_size = torch.full_like(state.potential_energy, cfg.init_step_size)
        state, info = kernel(noise, state, potential_fn=potential_fn,
                             step_size=step_size[:, None], inv_mass_diag=inv_mass)
        if cfg.adapt_step_size:
            da = da_update(da, info.accept_prob, cfg.target_accept)
        if cfg.adapt_mass:
            if adapt_mass_f:
                welford = welford_update(welford, state.z)
            if window_end_f:
                if welford.count > 1:
                    inv_mass = welford_variance(welford)
                welford = welford_init(state.z.shape, state.z.device, state.z.dtype)
                if cfg.adapt_step_size:
                    da = da_init(torch.exp(da.log_step))
        return WarmCarry(state, da, welford, inv_mass), info

    return body


def _warmup_carry_init(cfg: SamplerConfig, potential_fn, noise, state: HMCState):
    """-> (WarmCarry, ensemble evaluations): unit mass, the step-size
    search's result (or ``init_step_size``)."""
    f = dict(dtype=state.z.dtype, device=state.z.device)
    inv_mass = torch.ones(state.z.shape, **f)
    evals = 0
    if cfg.adapt_step_size:
        step0, evals = find_reasonable_step_size(
            noise, potential_fn, state.z, state.potential_energy, state.grad, inv_mass,
            cfg.init_step_size,
        )
    else:
        step0 = torch.full(state.potential_energy.shape, cfg.init_step_size, **f)
    carry = WarmCarry(state, da_init(step0), welford_init(state.z.shape, **f), inv_mass)
    return carry, evals


class WarmupParts(NamedTuple):
    """Dispatch-bounded warmup with an explicit carry:

      init_carry(noise, z0, data) -> (WarmCarry, evaluations)
      segment(carry, noise, adapt_flags, wend_flags, data)
          -> (WarmCarry, divergences (C,), evaluations)
      finalize(carry) -> step size (C,)

    ``noise`` is the warmup stream; feed ``segment`` slices of
    ``schedule``'s flags in order."""

    init_carry: Callable
    segment: Callable
    finalize: Callable
    schedule: Any


def make_warmup_parts(fm, cfg: SamplerConfig) -> WarmupParts:
    kernel = make_kernel(cfg)
    body = _make_warmup_body(cfg, kernel)

    def init_carry(noise, z0, data=None):
        potential_fn = fm.bind(data)
        return _warmup_carry_init(cfg, potential_fn, noise, init_state(potential_fn, z0))

    def segment(carry: WarmCarry, noise, adapt_flags, wend_flags, data=None):
        potential_fn = fm.bind(data)
        n_div = torch.zeros(carry.states.z.shape[0], dtype=torch.int64, device=carry.states.z.device)
        evals = 0
        for a, w in zip(adapt_flags, wend_flags):
            carry, info = body(carry, noise, potential_fn, bool(a), bool(w))
            n_div = n_div + info.is_divergent.to(torch.int64)
            evals += info.num_ensemble_grad_evals
        return carry, n_div, evals

    def finalize(carry: WarmCarry) -> torch.Tensor:
        if cfg.adapt_step_size:
            return torch.exp(carry.da.log_avg_step)
        return torch.full_like(carry.da.log_avg_step, cfg.init_step_size)

    return WarmupParts(init_carry, segment, finalize, build_warmup_schedule(cfg.num_warmup))


def drive_segmented_warmup(cfg: SamplerConfig, parts: WarmupParts, noise, z0, data, seg: int):
    """The warmup schedule in segments of at most ``seg`` transitions ->
    (state, step size (C,), inverse mass (C, d), divergences (C,),
    ensemble evaluations, the initial state's included)."""
    carry, evals = parts.init_carry(noise, z0, data)
    evals += 1
    aflags = np.asarray(parts.schedule.adapt_mass)
    wflags = np.asarray(parts.schedule.window_end)
    warm_div = torch.zeros(z0.shape[0], dtype=torch.int64, device=z0.device)
    for s in range(0, cfg.num_warmup, max(int(seg), 1)):
        e = min(s + seg, cfg.num_warmup)
        carry, n_div, n = parts.segment(carry, noise, aflags[s:e], wflags[s:e], data)
        warm_div = warm_div + n_div
        evals += n
    return carry.states, parts.finalize(carry), carry.inv_mass, warm_div, evals


def make_segmented_warmup(fm, cfg: SamplerConfig):
    """run(noise, z0, data, seg) -> `drive_segmented_warmup`'s tuple."""
    parts = make_warmup_parts(fm, cfg)

    def run(noise, z0, data, seg):
        return drive_segmented_warmup(cfg, parts, noise, z0, data, seg)

    return run


def _empty_outs(chains, d, torch_dtype):
    """The (zs, accept, divergent, energy, ngrad) of zero transitions."""
    dtype = torch.empty(0, dtype=torch_dtype).numpy().dtype
    return (
        np.zeros((chains, 0, d), dtype), np.zeros((chains, 0), dtype),
        np.zeros((chains, 0), bool), np.zeros((chains, 0), dtype),
        np.zeros((chains, 0), np.int32),
    )


def _transitions(kernel, n, noise, state, potential_fn, step_size, inv_mass, diag=None,
                 stop=None):
    """``n`` sampling transitions, fewer when ``stop()`` (checked after
    each) turns true; every draw and stat goes to the host as it is made
    (the device holds no draw history).  Returns (state, diag, outs,
    ensemble evaluations)."""
    rows = ([], [], [], [], [])
    evals = 0
    for _ in range(n):
        state, info = kernel(noise, state, potential_fn=potential_fn,
                             step_size=step_size[:, None], inv_mass_diag=inv_mass)
        evals += info.num_ensemble_grad_evals
        if diag is not None:
            diag = stream_diag_update(diag, state.z)
        for lst, t in zip(rows, (state.z, info.accept_prob, info.is_divergent, info.energy,
                                 info.num_grad_evals)):
            lst.append(t.cpu())
        if stop is not None and stop():
            break
    if n:
        outs = tuple(torch.stack(r, 1).numpy() for r in rows)  # chain-major (C, n, ...)
    else:
        outs = _empty_outs(state.z.shape[0], state.z.shape[1], state.z.dtype)
    return state, diag, outs, evals


def _thin(outs, thin: int, start: int = 0):
    """Keep global transition t (0-based, ``start`` the block's first)
    when (t + 1) % thin == 0."""
    if thin <= 1:
        return outs
    t = np.arange(start, start + outs[0].shape[1])
    keep = np.flatnonzero((t + 1) % thin == 0)
    return tuple(o[:, keep] for o in outs)


def refuse_ragged_nuts():
    raise NotImplementedError(
        "ragged NUTS (STARK_RAGGED_NUTS=1 / ragged=True, the step-synchronized "
        "scheduler of the JAX package's kernels/nuts_ragged.py) is not ported "
        "yet (ROADMAP A8, ragged NUTS)"
    )


def make_block_runner(fm, cfg: SamplerConfig, block_size: int, ragged: bool = False):
    """One draw block of the segmented loop and the adaptive runner:

      block_run(noise, state, diag, step_size, inv_mass, data, stop=None)
        -> (HMCState, diag, zs, accept, divergent, energy, ngrad, evaluations)

    zs (C, block_size, d) and the (C, block_size) stats on the host;
    evaluations is the block's ensemble evaluations.  ``diag`` is the
    streaming-diagnostics accumulator, or None; it only reads each draw,
    so the draws are the same with it or without it.  ``stop``, checked
    between transitions, ends the block early.  ``ragged`` (the JAX
    package's step-synchronized NUTS) is refused."""
    if ragged:
        refuse_ragged_nuts()
    kernel = make_kernel(cfg)

    def block_run(noise, state, diag, step_size, inv_mass, data=None, stop=None):
        state, diag, outs, evals = _transitions(
            kernel, block_size, noise, state, fm.bind(data), step_size, inv_mass, diag=diag,
            stop=stop,
        )
        return (state, diag, *outs, evals)

    return block_run


def per_chain_stats(accept, divergent, energy, ngrad, step_size, inv_mass, warm_div,
                    num_divergent, evals, warm_evals, dispatch_steps) -> Dict[str, Any]:
    """The JAX package's per-chain ``sample_stats`` (its keys and shapes,
    the dispatch bound annotated as it does) and the port's ensemble
    evaluation counts."""
    return {
        "accept_prob": accept,
        "is_divergent": divergent,
        "energy": energy,
        "num_grad_evals": ngrad,
        "step_size": step_size,
        "inv_mass_diag": inv_mass,
        "num_warmup_divergent": warm_div,
        "num_divergent": num_divergent,
        "dispatch_steps": int(dispatch_steps or 0),
        "dispatch_auto": False,
        # ensemble evaluations: the initial state, the step-size search,
        # every warmup and sampling leapfrog step; one kernel launch each
        "num_ensemble_grad_evals": np.asarray(evals),
        # of which before the first sampling transition
        "num_warmup_ensemble_grad_evals": np.asarray(warm_evals),
    }


def drive_segmented_sampling(fm, cfg: SamplerConfig, seg_warmup, get_block, noise_warm,
                             noise_samp, z0, data, seg: Optional[int]) -> Posterior:
    """Warmup and sampling in segments of at most ``seg`` transitions
    (None: each phase in one), one host loop: ``seg_warmup(noise, z0,
    data, seg)`` and ``get_block(length) -> block_run``
    (`make_block_runner`).  Thinning happens per segment, so the host
    holds only kept draws."""
    chains, d = z0.shape
    total = cfg.num_samples * cfg.thin
    warm_seg = seg or max(cfg.num_warmup, 1)
    samp_seg = seg or max(total, 1)
    state, step_size, inv_mass, warm_div, evals = seg_warmup(noise_warm, z0, data, warm_seg)
    warm_evals = evals
    blocks = [_empty_outs(chains, d, z0.dtype)]
    num_divergent = np.zeros(chains, np.int64)
    for s in range(0, total, samp_seg):
        e = min(s + samp_seg, total)
        state, _, *outs, n = get_block(e - s)(noise_samp, state, None, step_size, inv_mass,
                                              data)
        evals += n
        num_divergent += outs[2].astype(np.int64).sum(axis=1)
        blocks.append(_thin(tuple(outs), cfg.thin, s))
    zs, accept, divergent, energy, ngrad = (np.concatenate(b, axis=1) for b in zip(*blocks))
    stats = per_chain_stats(
        accept, divergent, energy, ngrad, step_size.cpu().numpy(), inv_mass.cpu().numpy(),
        warm_div.cpu().numpy(), num_divergent, evals, warm_evals, seg,
    )
    return Posterior(constrain_draws(fm, zs), stats, flat_model=fm, draws_flat=zs)


def make_chain_runner(fm, cfg: SamplerConfig):
    """run(noise_warm, noise_samp, z0, data, seg=None) -> Posterior: a
    whole per-chain run, `drive_segmented_sampling` over this model's
    warmup and blocks."""
    seg_warmup = make_segmented_warmup(fm, cfg)

    def get_block(length):
        return make_block_runner(fm, cfg, length)

    def run(noise_warm, noise_samp, z0, data=None, seg=None):
        return drive_segmented_sampling(fm, cfg, seg_warmup, get_block, noise_warm,
                                        noise_samp, z0, data, seg)

    return run


def _no_nan(value: torch.Tensor, model_cls, what: str) -> torch.Tensor:
    if torch.isnan(value).any():
        raise FloatingPointError(f"{model_cls.__name__}.{what} gave NaN (debug_nans)")
    return value


def nan_checked(model):
    """A copy of ``model`` whose ``log_prior`` and ``log_lik`` raise
    FloatingPointError as soon as one gives NaN (one device-to-host
    check per evaluation; `sample(debug_nans=True)`)."""
    base = type(model)

    class NanChecked(base):
        def log_prior(self, p):
            return _no_nan(base.log_prior(self, p), base, "log_prior")

        def log_lik(self, p, data):
            return _no_nan(base.log_lik(self, p, data), base, "log_lik")

    NanChecked.__name__ = NanChecked.__qualname__ = base.__name__
    checked = copy.copy(model)
    checked.__class__ = NanChecked
    return checked


def sample(
    model,
    data: Any = None,
    *,
    chains: int = 4,
    seed: int = 0,
    init_params: Optional[Dict[str, Any]] = None,
    backend: Any = None,
    device: DeviceLike = None,
    debug_nans: bool = False,
    trace: Any = None,
    **cfg_kwargs,
):
    """Run MCMC and return a Posterior: NUTS unless ``kernel=`` says
    "hmc" or "chees".  ``backend`` (default: a `backends.CudaBackend` on
    ``device``, ``cuda`` unless the caller asks for the CPU) runs it;
    ``CudaBackend(dispatch_steps=n)`` bounds each host loop segment of a
    per-chain run to ``n`` transitions and draws what the single loop
    draws.

    debug_nans: the first NaN the model's densities give raises, where
    it would otherwise surface later as a frozen chain: a NaN log-prior
    or log-likelihood raises FloatingPointError naming it (`nan_checked`),
    and a NaN in a gradient raises autograd's anomaly-mode RuntimeError,
    which names the operation and the model code that built it.  The
    draws are the same with it on.  ``trace=`` (run telemetry) is refused.
    """
    from .backends import CudaBackend

    if trace is not None:
        refuse("run telemetry (sample(trace=))", "A12")
    if backend is None:
        backend = CudaBackend(device)
    elif device is not None and torch.device(device) != backend.device:
        raise ValueError(f"device={device!r} disagrees with the backend's {backend.device}")
    anomaly = contextlib.nullcontext()
    if debug_nans:
        model = nan_checked(model)
        anomaly = torch.autograd.detect_anomaly(check_nan=True)
    with anomaly:
        return backend.run(
            model, data, SamplerConfig(**cfg_kwargs), chains=chains, seed=seed,
            init_params=init_params,
        )
