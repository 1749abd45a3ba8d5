"""Consensus Monte Carlo — embarrassingly parallel sub-posterior
sampling; counterpart of ``stark_tpu/parallel/consensus.py`` (BASELINE
config 2).

The N-row dataset is split into S contiguous row blocks; shard s samples
the sub-posterior p(theta)^(1/S) L_s(theta) on its own, with no
communication between shards, and the draws are combined at the end in
unconstrained space.  Combines: ``"precision_full"`` (the default; full
covariance precision weights, exact for Gaussian sub-posteriors),
``"precision"`` (diagonal) and ``"uniform"``.

On one card the shards run side by side, as the JAX package's ``vmap``
over shards does:

* ``kernel="chees"``: S ensembles of C chains as one (S, C, d) batch
  through `chees.make_chees_parts`, each shard with its own adaptation
  state and stream;
* ``"nuts"`` / ``"hmc"``: the S*C chains through the per-chain runner,
  whose potential reshapes them to (S, C, d).

Either way a model that declares a shard-batched likelihood
(`Model.shard_batched_lik`: `models.Logistic`, and `models.FusedLogistic`,
every shard's ensemble in one launch of kernel B2) evaluates all shards
in one call; any other model evaluates them one shard at a time.

Randomness: each shard draws from generators of its own (initial
positions, warmup, sampling), seeded from (seed, attempt, shard), so a
shard's draws do not depend on the others' and a restart walks a fresh
stream.

Dead shards: a shard whose draws hold a non-finite value (the JAX
package's test), or whose final potential is non-finite on some chain
(its likelihood cannot be evaluated where the chain stands: poisoned
rows leave the chains at their initial points with finite draws, which
the JAX package's test does not see), is re-sampled with a new stream up
to ``shard_restarts`` times, then dropped (``on_shard_failure=
"degrade"``: the combine reweights over the survivors, and the result
says ``degraded`` and ``lost_shards``) or raised (``"raise"``); every
shard dead always raises.

Not ported: ``mesh=`` and ``domains=`` and multi-process runs (ROADMAP
A11); run telemetry, its per-shard health events and the fault-injection
sites (``trace=``, ``STARK_FAILPOINTS``; ROADMAP A12).  Each is refused.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .._unported import refuse
from ..chees import chees_init_positions, chees_schedule_arrays, make_chees_parts
from ..kernels.chees import TorchNoise
from ..model import FlatModel, Model, flatten_model
from ..ops.quantize import from_numpy_bits, host_leaf, index_rows, to_numpy_bits
from ..sampler import (
    Posterior,
    SamplerConfig,
    constrain_draws,
    init_positions,
    make_chain_runner,
    seed_of,
)

log = logging.getLogger("stark_tpu_torch.consensus")

COMBINES = ("precision_full", "precision", "uniform")


# ------------------------------------------------------------- combines


def combine_precision_weighted(draws: torch.Tensor) -> torch.Tensor:
    """(S, C, T, d) sub-posterior draws -> (C, T, d): diagonal precision
    weights w_s = 1 / var_s from each shard's own draws (over chains and
    draws), theta_t = sum_s w_s theta_{s,t} / sum_s w_s."""
    var = torch.var(draws, dim=(1, 2), correction=1)  # (S, d)
    w = 1.0 / torch.clamp(var, min=1e-12)
    num = torch.einsum("sctd,sd->ctd", draws, w)
    return num / w.sum(0)


def combine_precision_weighted_full(draws: torch.Tensor) -> torch.Tensor:
    """(S, C, T, d) -> (C, T, d): full-covariance combine, theta_t =
    (sum_s W_s)^-1 sum_s W_s theta_{s,t}, W_s the inverse of shard s's
    draw covariance.  Below 2d draws per shard the covariance is too
    ill-conditioned to invert in float32, so the diagonal combine is used;
    the ridge, 1e-4 of the mean variance, survives float32 rounding (1e-8
    would round away).  One factorization of the summed precision serves
    all C*T right-hand sides."""
    S, C, T, d = draws.shape
    if C * T < 2 * d:
        return combine_precision_weighted(draws)
    x = draws.reshape(S, C * T, d)
    xc = x - x.mean(dim=1, keepdim=True)
    cov = torch.einsum("snd,sne->sde", xc, xc) / max(C * T - 1, 1)
    ridge = 1e-4 * torch.diagonal(cov, dim1=1, dim2=2).sum(-1) / d  # (S,)
    eye = torch.eye(d, dtype=draws.dtype, device=draws.device)
    prec = torch.linalg.inv(cov + ridge[:, None, None] * eye)  # (S, d, d)
    num = torch.einsum("sde,scte->ctd", prec, draws)
    sol = torch.linalg.solve(prec.sum(0), num.reshape(-1, d).T)
    return sol.T.reshape(C, T, d)


def combine_draws(draws: torch.Tensor, how: str) -> torch.Tensor:
    """(S, C, T, d) -> (C, T, d) by the named combine (COMBINES)."""
    if how == "precision":
        return combine_precision_weighted(draws)
    if how == "precision_full":
        return combine_precision_weighted_full(draws)
    if how == "uniform":
        return draws.mean(0)
    raise ValueError(f"unknown combine {how!r}; use one of {COMBINES}")


# ----------------------------------------------------------- shard split


def to_shards(x, ax: int, shards: int):
    """Split a leaf's row axis ``ax`` into ``shards`` contiguous blocks and
    move the new shard axis to the front: (..., N, ...) -> (S, ..., N/S,
    ...), shard k the k-th block, contiguous.  A row-less leaf (ax < 0)
    is repeated for every shard.  A bf16 or fp8 slab (a CPU tensor)
    moves by its bits."""
    if isinstance(x, torch.Tensor):
        return from_numpy_bits(to_shards(to_numpy_bits(x), ax, shards), x.dtype)
    x = np.asarray(x)
    if ax < 0:
        return np.ascontiguousarray(np.broadcast_to(x, (shards,) + x.shape))
    n = x.shape[ax]
    if n % shards:
        raise ValueError(f"rows {n} not divisible by the {shards} local shards")
    split = x.reshape(x.shape[:ax] + (shards, n // shards) + x.shape[ax + 1:])
    return np.ascontiguousarray(np.moveaxis(split, ax, 0))


def shard_data(model: Model, data, shards: int, device) -> Dict[str, Any]:
    """The model's prepared data, every leaf with rows split into shards
    (`to_shards` along `Model.data_row_axes`), on ``device``."""
    prepared = model.prepare_data({k: host_leaf(v) for k, v in data.items()})
    axes = model.data_row_axes(prepared)
    out = {}
    for k, v in prepared.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = torch.as_tensor(to_shards(v, axes[k], shards), device=device)
        else:
            out[k] = v
    return out


def _take_shards(sharded, idx) -> Dict[str, Any]:
    index = torch.as_tensor(np.asarray(idx), dtype=torch.long)
    return {k: index_rows(v, 0, index.to(v.device)).contiguous()
            if isinstance(v, torch.Tensor) else v for k, v in sharded.items()}


# --------------------------------------------------------------- streams


class ShardNoise:
    """Momentum normals and uniforms for S shards, each shard's from its
    own `TorchNoise`: a request's leading axis, S for the (S, C, ...)
    ensembles or S*C for the per-chain runner's flat batch, is split into
    S equal blocks, block s drawn from shard s's stream."""

    def __init__(self, generators):
        self.parts = [TorchNoise(g) for g in generators]

    def _draw(self, name, shape):
        each = (shape[0] // len(self.parts),) + tuple(shape[1:])
        return torch.cat([getattr(p, name)(each) for p in self.parts])

    def normal(self, shape):
        return self._draw("normal", shape)

    def uniform(self, shape):
        return self._draw("uniform", shape)


def shard_streams(seed: int, attempt: int, shards, device):
    """(initial positions, warmup, sampling): for each purpose one
    generator per shard id, from (seed, attempt, shard id, purpose)."""
    return tuple(
        [torch.Generator(device=device).manual_seed(seed_of(seed, attempt, int(k), p))
         for k in shards]
        for p in range(3)
    )


# ------------------------------------------------------------- samplers


def _run_chees_shards(fm: FlatModel, cfg: SamplerConfig, sharded, shard_ids, chains,
                      seed, attempt, init_params, dispatch_steps, device):
    """ChEES sub-posterior sampling, every shard's ensemble in one (S, C,
    d) batch.  Returns (draws (S, C, T, d) host, final potential (S, C)
    host, stats, ensemble evaluations)."""
    parts = make_chees_parts(fm, cfg)
    S, C, d = len(shard_ids), chains, fm.ndim
    total = cfg.num_samples * cfg.thin
    g_init, g_warm, g_samp = shard_streams(seed, attempt, shard_ids, device)
    z0 = torch.stack([chees_init_positions(fm, g, C, init_params, device) for g in g_init])
    aflags, wflags, u_warm, u_run, idxs = chees_schedule_arrays(parts, cfg)
    seg = max(int(dispatch_steps), 1) if dispatch_steps else None

    def segments(n):
        step = seg or max(n, 1)
        return [(lo, min(lo + step, n)) for lo in range(0, n, step)]

    carry = parts.init_carry(z0, sharded)
    wdiv, wleap = 0, 0
    noise = ShardNoise(g_warm)
    for lo, hi in segments(cfg.num_warmup):
        carry, (nd, nl) = parts.warm_segment(
            carry, noise, u_warm[lo:hi], idxs[lo:hi], aflags[lo:hi], wflags[lo:hi], sharded
        )
        wdiv += nd
        wleap += nl
    run_carry = parts.finalize(carry)
    noise = ShardNoise(g_samp)
    zs, acc, div, nleap = [np.zeros((0, S, C, d), np.float32)], [], [], [0]
    for lo, hi in segments(total):
        run_carry, outs = parts.sample_segment(run_carry, noise, u_run[lo:hi], sharded)
        zs.append(outs[0])
        acc.append(outs[1])
        div.append(outs[2])
        nleap.append(int(outs[3].sum()))
    zs = np.concatenate(zs)  # (T, S, C, d)
    acc = np.concatenate(acc) if acc else np.zeros((0, S, C), np.float32)
    div = np.concatenate(div) if div else np.zeros((0, S, C), bool)
    if cfg.thin > 1:
        zs = zs[cfg.thin - 1:: cfg.thin]
        acc = acc[cfg.thin - 1:: cfg.thin]
    stats = {
        "accept_prob": acc.transpose(1, 2, 0).reshape(S * C, -1),
        "num_divergent": np.asarray(int(div.sum())),
        "num_warmup_divergent": np.asarray(wdiv),
        "step_size": torch.exp(run_carry.log_eps).cpu().numpy(),  # (S,)
        "traj_length": torch.exp(run_carry.log_T).cpu().numpy(),  # (S,)
    }
    evals = cfg.map_init_steps + 1 + wleap + sum(nleap)
    pe = run_carry.states.potential_energy.cpu().numpy()
    return zs.transpose(1, 2, 0, 3), pe, stats, evals


def shard_batched(fm: FlatModel, chains: int) -> FlatModel:
    """``fm`` with a potential over (S * chains, d) that evaluates it as
    (S, chains, d): the per-chain runner's flat batch, every shard's
    chains in one shard-batched likelihood evaluation."""

    def potential(z, data=None):
        return fm.potential(z.reshape(-1, chains, z.shape[-1]), data).reshape(-1)

    def potential_and_grad(z, data=None):
        pe, g = fm.potential_and_grad(z.reshape(-1, chains, z.shape[-1]), data)
        return pe.reshape(-1), g.reshape(z.shape)

    return dataclasses.replace(fm, potential=potential, potential_and_grad=potential_and_grad)


def _run_chain_shards(fm: FlatModel, cfg: SamplerConfig, sharded, shard_ids, chains,
                      seed, attempt, init_params, dispatch_steps, device):
    """NUTS or HMC sub-posterior sampling: the S*C chains through the
    per-chain runner, each shard's from its own streams.  Returns
    `_run_chees_shards`' tuple."""
    S, C, d = len(shard_ids), chains, fm.ndim
    g_init, g_warm, g_samp = shard_streams(seed, attempt, shard_ids, device)
    z0 = torch.cat([init_positions(fm, g, C, init_params, device) for g in g_init])
    post = make_chain_runner(shard_batched(fm, C), cfg)(
        ShardNoise(g_warm), ShardNoise(g_samp), z0, sharded
    )
    st = post.sample_stats
    zs = post.draws_flat.reshape(S, C, -1, d)
    energy = st["energy"]
    pe = energy[:, -1].reshape(S, C) if energy.shape[1] else np.zeros((S, C), np.float32)
    stats = {
        "accept_prob": st["accept_prob"],
        "num_divergent": np.asarray(st["num_divergent"]),
        "step_size": np.asarray(st["step_size"]),
    }
    return zs, pe, stats, int(st["num_ensemble_grad_evals"])


def dead_shard_mask(draws_sub: np.ndarray, final_pe: Optional[np.ndarray] = None) -> np.ndarray:
    """(S,) bool: shard s is dead when its draws hold a non-finite value
    (a died device program writes NaN, never a partly sane posterior),
    or when a chain's final potential is non-finite (a poisoned shard:
    its chains never left their initial points)."""
    S = draws_sub.shape[0]
    dead = ~np.isfinite(np.asarray(draws_sub).reshape(S, -1)).all(axis=1)
    if final_pe is not None:
        dead |= ~np.isfinite(np.asarray(final_pe).reshape(S, -1)).all(axis=1)
    return dead


# ----------------------------------------------------------------- entry


def consensus_sample(
    model: Model,
    data,
    *,
    num_shards: int,
    chains: int = 2,
    seed: int = 0,
    mesh: Any = None,
    combine: str = "precision_full",
    init_params: Optional[Dict[str, Any]] = None,
    dispatch_steps: Optional[int] = None,
    shard_restarts: int = 1,
    on_shard_failure: str = "degrade",
    domains: Any = None,
    device: DeviceLike = None,
    trace: Any = None,
    **cfg_kwargs,
) -> Posterior:
    """Run consensus Monte Carlo on ``device`` (``cuda`` by default) and
    return the combined Posterior.

    ``chains`` is chains per shard; chain c of the result combines chain
    c of every shard, so R-hat and ESS apply to the combined draws.
    ``cfg_kwargs`` are `SamplerConfig`'s (``kernel="chees"``, budgets,
    ...).  ``dispatch_steps`` (ChEES only, as in the JAX package) splits
    the host loop into segments of at most that many transitions and
    leaves the draws as they are.  ``sample_stats`` holds the per-shard
    step sizes (and for ChEES trajectory lengths) of the first attempt,
    ``num_shards``, ``sub_draws_flat`` (S, C, T, d), ``degraded``,
    ``lost_shards`` and ``num_ensemble_grad_evals`` (every attempt's
    ensemble evaluations: one shard-batched likelihood launch each).
    """
    if mesh is not None:
        refuse("consensus over a device mesh (mesh=)", "A11")
    if domains is not None:
        refuse("hierarchical failure domains (domains=)", "A11")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        refuse("multi-process consensus", "A11")
    if trace is not None:
        refuse("run telemetry and per-shard health events (trace=)", "A12")
    if os.environ.get("STARK_FAILPOINTS"):
        refuse("fault injection (STARK_FAILPOINTS)", "A12")
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}; use one of {COMBINES}")
    if on_shard_failure not in ("degrade", "raise"):
        raise ValueError(f"on_shard_failure must be 'degrade' or 'raise', not "
                         f"{on_shard_failure!r}")
    cfg = SamplerConfig(**cfg_kwargs)
    if cfg.kernel not in ("chees", "nuts", "hmc"):
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    if dispatch_steps is not None and cfg.kernel != "chees":
        raise ValueError(
            "dispatch_steps is only implemented for kernel='chees' in "
            "consensus_sample (the per-chain runner path is monolithic)"
        )
    dev = resolve_device(device)
    fm = flatten_model(model, prior_scale=1.0 / num_shards)
    sharded = shard_data(model, data, num_shards, dev)
    run_shards = _run_chees_shards if cfg.kernel == "chees" else _run_chain_shards

    def attempt_run(shard_ids, attempt):
        sub = sharded if attempt == 0 else _take_shards(sharded, shard_ids)
        return run_shards(fm, cfg, sub, list(shard_ids), chains, seed, attempt,
                          init_params, dispatch_steps, dev)

    draws_sub, final_pe, stats_extra, evals = attempt_run(range(num_shards), 0)
    dead = dead_shard_mask(draws_sub, final_pe)
    attempt = 0
    while dead.any() and attempt < shard_restarts:
        attempt += 1
        idx = np.nonzero(dead)[0]
        log.warning("consensus: %d dead shard(s) %s: restart %d/%d", idx.size,
                    idx.tolist(), attempt, shard_restarts)
        new, new_pe, _, n = attempt_run(idx, attempt)
        evals += n
        draws_sub = np.array(draws_sub)
        final_pe = np.array(final_pe)
        draws_sub[idx], final_pe[idx] = new, new_pe
        dead = dead_shard_mask(draws_sub, final_pe)
    lost = np.nonzero(dead)[0]
    degraded = bool(lost.size)
    if degraded:
        if lost.size == num_shards:
            raise RuntimeError(
                f"consensus: all {lost.size} shards dead after {attempt} restart(s): "
                "nothing to combine"
            )
        if on_shard_failure == "raise":
            raise RuntimeError(
                f"consensus: shards {lost.tolist()} dead after exhausting "
                f"{shard_restarts} restart(s)"
            )
        log.warning("consensus DEGRADED: dropping dead shard(s) %s, combining the %d "
                    "survivors (their likelihood factors are missing from the result)",
                    lost.tolist(), num_shards - lost.size)
    alive = torch.as_tensor(draws_sub[~dead])
    combined = combine_draws(alive, combine).numpy()
    stats = {
        **stats_extra,
        "num_shards": num_shards,
        "sub_draws_flat": np.asarray(draws_sub),
        "degraded": degraded,
        "lost_shards": np.asarray(lost, np.int64),
        "num_shard_restarts": attempt,
        "num_ensemble_grad_evals": np.asarray(evals),
    }
    return Posterior(constrain_draws(fm, combined), stats, flat_model=fm,
                     draws_flat=combined)

