"""`CudaBackend` — one device, eager PyTorch around the hand-written
kernels; counterpart of ``stark_tpu/backends/jax_backend.py``.

The device is ``cuda`` unless the caller asks for the CPU (the tests do);
without a card and without ``device="cpu"`` the backend raises when it is
made.  Where the JAX backend jit-compiles each segment, this one hands
the runner plain segment callables with one signature for every sampler
(`AdaptiveParts`): over `chees.make_chees_parts`' for ChEES, over
`sampler.make_warmup_parts`' and `sampler.make_block_runner`'s for the
per-chain kernels NUTS and HMC.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..adaptation import DualAveragingState, WelfordState, da_init
from ..chees import (
    AdamState,
    CheesRunCarry,
    CheesWarmCarry,
    chees_init_positions,
    chees_touchup_arrays,
    make_chees_parts,
    run_chees,
)
from ..kernels.base import HMCState
from ..kernels.chees import TorchNoise, halton
from ..kernels.nuts import tree_depth_from_leaves
from ..model import flatten_model, prepare_model_data
from ..sampler import (
    SamplerConfig,
    WarmCarry,
    chain_streams,
    init_positions,
    make_block_runner,
    make_chain_runner,
    make_warmup_parts,
    refuse_ragged_nuts,
)
from .base import AdaptiveParts, Block


def _refuse_kernel(cfg: SamplerConfig) -> None:
    """What is still unported: ragged NUTS (the JAX package's
    ``STARK_RAGGED_NUTS=1`` knob, which reroutes its NUTS runs)."""
    if cfg.kernel not in ("nuts", "hmc", "chees"):
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    if cfg.kernel == "nuts" and os.environ.get("STARK_RAGGED_NUTS", "0") == "1":
        refuse_ragged_nuts()


def collect(tree):
    """Tensor pytree (tensors, dicts, tuples, NamedTuples, lists) -> the
    same structure of host numpy arrays; other leaves via np.asarray."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: collect(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(collect(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(collect(v) for v in tree)
    return np.asarray(tree)


class CudaBackend:
    """Chains as one (C, d) batch on one device.

    ``dispatch_steps`` (or the ``STARK_DISPATCH_STEPS`` environment
    variable, as in the JAX package): when set, a per-chain run (NUTS,
    HMC) runs its one host loop in segments of at most that many
    transitions, and draws bitwise what it draws unsegmented.  The ChEES
    run is not segmented."""

    def __init__(self, device: DeviceLike = None, dispatch_steps: Optional[int] = None):
        self.device = resolve_device(device)
        if dispatch_steps is None:
            env = os.environ.get("STARK_DISPATCH_STEPS")
            dispatch_steps = int(env) if env else None
        if dispatch_steps is not None and dispatch_steps < 0:
            raise ValueError(f"dispatch_steps must be >= 0, got {dispatch_steps}")
        self.dispatch_steps = dispatch_steps

    def put(self, x) -> torch.Tensor:
        """A host array on this backend's device (no copy when it is
        already there)."""
        return torch.as_tensor(x, device=self.device)

    def run(
        self,
        model,
        data,
        cfg: SamplerConfig,
        *,
        chains: int,
        seed: int,
        init_params: Optional[Dict[str, Any]] = None,
    ):
        """One fixed-budget run; returns a Posterior.  ChEES through
        `chees.run_chees`; NUTS and HMC through `sampler.make_chain_runner`."""
        _refuse_kernel(cfg)
        data = prepare_model_data(model, data, self.device)
        fm = flatten_model(model)
        if cfg.kernel == "chees":
            return run_chees(
                fm, cfg, data, chains=chains, seed=seed, init_params=init_params,
                device=self.device,
            )
        g_init, g_warm, g_samp = chain_streams(seed, self.device)
        z0 = init_positions(fm, g_init, chains, init_params, self.device)
        return make_chain_runner(fm, cfg)(
            TorchNoise(g_warm), TorchNoise(g_samp), z0, data, self.dispatch_steps or None
        )

    def adaptive_parts(self, model, cfg: SamplerConfig, data) -> AdaptiveParts:
        """The segment callables and placement hooks of the adaptive
        runner; the data is prepared once, here, on the device."""
        _refuse_kernel(cfg)
        fm = flatten_model(model)
        data = prepare_model_data(model, data, self.device)
        build = _chees_parts if cfg.kernel == "chees" else _chain_parts
        return AdaptiveParts(
            fm=fm,
            data=data,
            extra=() if data is None else (data,),
            put_chains=self.put,
            collect=collect,
            **build(fm, cfg, self.put, self.device),
        )


# ------------------------------------------------ the runner's segments


def _adaptation_arrays(carry) -> Dict[str, np.ndarray]:
    """A warmup carry's state, step-size averaging and Welford moments
    under the JAX package's checkpoint names (host numpy)."""
    arrays = collect({
        "z": carry.states.z,
        "pe": carry.states.potential_energy,
        "grad": carry.states.grad,
        "inv_mass": carry.inv_mass,
        "da_log_step": carry.da.log_step,
        "da_log_avg_step": carry.da.log_avg_step,
        "da_h_avg": carry.da.h_avg,
        "da_mu": carry.da.mu,
        "wf_mean": carry.wf.mean,
        "wf_m2": carry.wf.m2,
    })
    arrays["wf_count"] = np.asarray(carry.wf.count, np.int32)
    arrays["da_count"] = np.asarray(carry.da.count, np.int32)
    arrays["step_size"] = np.exp(arrays["da_log_step"])
    return arrays


def _adaptation_state(arrays, put):
    """`_adaptation_arrays` back on the device: (state, dual averaging,
    Welford, inverse mass)."""
    return (
        _hmc_state(arrays, put),
        DualAveragingState(
            log_step=put(arrays["da_log_step"]),
            log_avg_step=put(arrays["da_log_avg_step"]),
            h_avg=put(arrays["da_h_avg"]),
            mu=put(arrays["da_mu"]),
            count=int(arrays["da_count"]),
        ),
        WelfordState(count=int(arrays["wf_count"]), mean=put(arrays["wf_mean"]),
                     m2=put(arrays["wf_m2"])),
        put(arrays["inv_mass"]),
    )


def _hmc_state(arrays, put) -> HMCState:
    return HMCState(z=put(arrays["z"]), potential_energy=put(arrays["pe"]), grad=put(arrays["grad"]))


def _state_arrays(states: HMCState, step_size, inv_mass) -> Dict[str, np.ndarray]:
    return collect({"z": states.z, "pe": states.potential_energy, "grad": states.grad,
                    "step_size": step_size, "inv_mass": inv_mass})


def _chees_parts(fm, cfg: SamplerConfig, put, device) -> Dict[str, Any]:
    """ChEES: one adaptation shared by the ensemble; the Halton jitter of
    every warmup and sampling transition is a function of its index, so
    a resumed or re-blocked run walks the same points."""
    parts = make_chees_parts(fm, cfg)
    aflags = np.asarray(parts.schedule.adapt_mass)
    wflags = np.asarray(parts.schedule.window_end)
    u_warm = (2.0 * halton(cfg.num_warmup)).astype(np.float32)

    def positions(generator, chains, init_params):
        return chees_init_positions(fm, generator, chains, init_params, device)

    def init_j(noise, z0, data=None):
        return parts.init_carry(z0, data), cfg.map_init_steps

    def warm_j(carry, noise, start, stop, data=None):
        carry, (n_div, n_leap) = parts.warm_segment(
            carry, noise, u_warm[start:stop], np.arange(start, stop), aflags[start:stop],
            wflags[start:stop], data,
        )
        return carry, n_div, n_leap

    def samp_j(carry, diag, noise, start, length, data=None, stop=None):
        us = (2.0 * halton(length, start=start)).astype(np.float32)
        if diag is None:
            carry, outs = parts.sample_segment(carry, noise, us, data, stop=stop)
        else:
            carry, diag, outs = parts.sample_segment_diag(carry, diag, noise, us, data, stop=stop)
        zs, accept, divergent, n_leap = outs
        n = int(np.sum(n_leap))
        # the block is draw-major (n, chains, d): the gate reads a
        # transposed view, and the draw store takes it back untransposed
        return carry, diag, Block(zs.transpose(1, 0, 2), accept, divergent, n,
                                  n * zs.shape[1], {"grad_eval_basis": "leapfrog"})

    def warm_arrays(carry: CheesWarmCarry):
        arrays = _adaptation_arrays(carry)
        arrays.update(collect({"adam_m": carry.adam.m, "adam_v": carry.adam.v,
                               "log_T": carry.log_T}))
        arrays["adam_t"] = np.asarray(carry.adam.t, np.int32)
        return arrays

    def warm_carry(arrays):
        states, da, wf, inv_mass = _adaptation_state(arrays, put)
        adam = AdamState(m=put(arrays["adam_m"]), v=put(arrays["adam_v"]), t=int(arrays["adam_t"]))
        return CheesWarmCarry(states=states, da=da, adam=adam, log_T=put(arrays["log_T"]), wf=wf,
                              inv_mass=inv_mass)

    def run_arrays(carry: CheesRunCarry):
        arrays = _state_arrays(carry.states, torch.exp(carry.log_eps), carry.inv_mass)
        arrays.update(collect({"log_eps": carry.log_eps, "log_T": carry.log_T}))
        return arrays

    def run_carry(arrays):
        return CheesRunCarry(states=_hmc_state(arrays, put), log_eps=put(arrays["log_eps"]),
                             log_T=put(arrays["log_T"]), inv_mass=put(arrays["inv_mass"]))

    def import_carry(carry: CheesWarmCarry, imported):
        """The carry after the initial evaluation and MAP steps, with the
        imported adaptation: step-size averaging anchored at the imported
        step (mu = log eps, not the cold start's log(10 eps)), and the
        imported trajectory length and inverse mass."""
        log_eps = put(np.asarray(imported["log_eps"], np.float32))
        return carry._replace(
            da=da_init(torch.exp(log_eps), mu=log_eps),
            log_T=put(np.asarray(imported["log_T"], np.float32)),
            inv_mass=put(np.asarray(imported["inv_mass"], np.float32)),
        )

    def touch_j(carry, noise, start, stop, total, data=None):
        us, idxs, aoff, woff = chees_touchup_arrays(total)
        carry, (n_div, n_leap) = parts.warm_segment(
            carry, noise, us[start:stop], idxs[start:stop], aoff[start:stop], woff[start:stop], data,
        )
        return carry, n_div, n_leap

    return dict(init_positions=positions, init_j=init_j, warm_j=warm_j,
                finalize=parts.finalize, samp_j=samp_j, warm_arrays=warm_arrays,
                warm_carry=warm_carry, run_arrays=run_arrays, run_carry=run_carry,
                import_carry=import_carry, touch_j=touch_j)


def _chain_parts(fm, cfg: SamplerConfig, put, device) -> Dict[str, Any]:
    """NUTS and HMC: every chain adapts on its own; the sampling carry is
    (state, step size (C,), inverse mass (C, d))."""
    warm = make_warmup_parts(fm, cfg)
    aflags = np.asarray(warm.schedule.adapt_mass)
    wflags = np.asarray(warm.schedule.window_end)
    basis = "tree_leaves" if cfg.kernel == "nuts" else "leapfrog"

    def positions(generator, chains, init_params):
        return init_positions(fm, generator, chains, init_params, device)

    def warm_j(carry, noise, start, stop, data=None):
        carry, n_div, n = warm.segment(carry, noise, aflags[start:stop], wflags[start:stop], data)
        return carry, int(n_div.sum()), n

    def finalize(carry: WarmCarry):
        return carry.states, warm.finalize(carry), carry.inv_mass

    def samp_j(carry, diag, noise, start, length, data=None, stop=None):
        state, step_size, inv_mass = carry
        state, diag, zs, accept, divergent, _, ngrad, n = make_block_runner(fm, cfg, length)(
            noise, state, diag, step_size, inv_mass, data, stop=stop)
        record = {"grad_eval_basis": basis}
        if cfg.kernel == "nuts":
            depth = tree_depth_from_leaves(ngrad)
            record.update(tree_depth_mean=float(depth.mean()), tree_depth_max=int(depth.max()))
        # per-chain gradient units: every chain's own leaves (NUTS) or
        # leapfrogs (HMC)
        return (state, step_size, inv_mass), diag, Block(zs, accept, divergent, n,
                                                         int(np.sum(ngrad)), record)

    def warm_carry(arrays):
        states, da, wf, inv_mass = _adaptation_state(arrays, put)
        return WarmCarry(states=states, da=da, wf=wf, inv_mass=inv_mass)

    def run_carry(arrays):
        return _hmc_state(arrays, put), put(arrays["step_size"]), put(arrays["inv_mass"])

    return dict(init_positions=positions, init_j=warm.init_carry, warm_j=warm_j,
                finalize=finalize, samp_j=samp_j, warm_arrays=_adaptation_arrays,
                warm_carry=warm_carry, run_arrays=lambda c: _state_arrays(*c),
                run_carry=run_carry)
