"""Model abstraction — counterpart of ``stark_tpu/model.py``.

A model declares its parameters (shapes + constraining bijectors), a
log-prior over the constrained parameters and a log-likelihood summed
over the rows of a dataset.  `flatten_model` turns it into a potential
over a flat unconstrained vector.

Chain batching is explicit: every parameter tensor a model sees carries
a leading chain axis C, and ``log_prior``/``log_lik`` return ``(C,)``.
The potential and its gradient therefore take the whole ensemble at
once, ``(C, d) -> ((C,), (C, d))`` — the form the fused kernels need to
read the data once for all chains.  Consensus Monte Carlo adds a shard
axis in front, ``(S, C, d)`` against data split into S row blocks: the
prior and the bijectors see the S*C rows as one batch, and ``log_lik``
sees parameters with both leading axes when the model declares a
shard-batched likelihood (`Model.shard_batched_lik`), and one shard at
a time otherwise (see `parallel.consensus`).  SG-HMC hands ``log_lik``
every chain's own minibatch in one call when the model reads such a
batch (`Model.chain_batched_lik`), and each chain's alone otherwise (see
`kernels.sghmc.make_minibatch_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .bijectors import Bijector, Identity
from .ops.quantize import host_leaf
from .tree import make_unflatten


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declared shape (constrained space) + constraining bijector."""

    shape: Tuple[int, ...] = ()
    bijector: Bijector = dataclasses.field(default_factory=Identity)


class Model:
    """Subclass and implement param_spec / log_prior / log_lik.

    Parameters arrive with a leading chain axis; both log densities
    return one value per chain.  ``log_lik`` is the sum of the per-row
    terms over the dataset it is handed.
    """

    # True when log_lik also takes parameters (S, C, ...) against data
    # whose every entry has a leading shard axis (rows split into S
    # blocks) and returns (S, C); a model without it is handed the shards
    # one at a time
    shard_batched_lik = False
    # True when log_lik also reads a per-chain batch: every data entry
    # with a leading chain axis, chain c's rows against chain c's
    # parameters (SG-HMC's minibatches); a model without it is handed
    # each chain's minibatch alone
    chain_batched_lik = False

    def param_spec(self) -> Dict[str, ParamSpec]:
        raise NotImplementedError

    def log_prior(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def log_lik(self, params: Dict[str, torch.Tensor], data) -> torch.Tensor:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator):
        """Optional constrained init values with a leading chain axis;
        None -> U(-2, 2) in unconstrained space (Stan-style)."""
        return None

    def prepare_data(self, data: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One-time host-side layout transform on numpy arrays, applied
        by `prepare_model_data` before the data moves to the device."""
        return data

    def data_row_axes(self, data) -> Dict[str, int]:
        """Which axis of each ``prepare_data``-output entry indexes data
        rows: axis 0 everywhere by default.  Entry points that split or
        minibatch rows (consensus shards, SG-HMC minibatches) consult it;
        a model whose layout moves the rows (a transposed ``xT``, rows on
        axis 1) overrides it, and -1 marks an entry without rows, passed
        whole to every shard or batch."""
        return {k: 0 for k in data}


def prepare_model_data(model: Model, data, device: DeviceLike = None):
    """The single data choke point: apply the model's host-side layout
    hook once, then move every array to ``device`` (``cuda`` unless the
    caller asks for the CPU).  A slab prepared as bf16 or fp8, which numpy
    cannot hold, is a CPU tensor on the host and moves as one.  Non-array
    entries (layout ints, markers) pass through."""
    if data is None:
        return None
    dev = resolve_device(device)
    prepared = model.prepare_data({k: host_leaf(v) for k, v in data.items()})
    return {
        k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
        if isinstance(v, np.ndarray)
        else v.to(dev) if isinstance(v, torch.Tensor)
        else v
        for k, v in prepared.items()
    }


class Potential:
    """Potential-energy callable with a fused value-and-grad path over a
    chain ensemble: ``value_and_grad(z (C, d)) -> ((C,), (C, d))``."""

    def __init__(self, value_fn, value_and_grad_fn):
        self._value = value_fn
        self._vag = value_and_grad_fn

    def __call__(self, z):
        return self._value(z)

    def value_and_grad(self, z):
        return self._vag(z)


@dataclasses.dataclass(frozen=True)
class FlatModel:
    """A model compiled down to flat-unconstrained-vector functions."""

    ndim: int
    # potential(z (C, d), data) -> (C,)
    potential: Callable[..., torch.Tensor]
    # potential_and_grad(z (C, d), data) -> ((C,), (C, d))
    potential_and_grad: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    # constrain_with_fldj(z (C, d)) -> (params, fldj (C,))
    constrain_with_fldj: Callable[..., Tuple[Dict[str, torch.Tensor], torch.Tensor]]
    constrain: Callable[[torch.Tensor], Dict[str, torch.Tensor]]
    unconstrain: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    # init_flat(chains, generator, device) -> (chains, d)
    init_flat: Callable[..., torch.Tensor]
    # potential_parts(z (C, d), data) -> (prior potential (C,),
    # log-likelihood (C,)): the potential without the likelihood, and
    # the likelihood it leaves out (parallel tempering scales it per row)
    potential_parts: Callable[..., Tuple[torch.Tensor, torch.Tensor]]

    def bind(self, data=None) -> Potential:
        """Close over a dataset -> a Potential for the kernels."""
        return Potential(
            lambda z: self.potential(z, data),
            lambda z: self.potential_and_grad(z, data),
        )


def flatten_model(model: Model, prior_scale: float = 1.0, lik_scale: float = 1.0) -> FlatModel:
    """Compile a Model into chain-batched flat-vector functions.

    prior_scale: prior tempering exponent (consensus Monte Carlo uses
      1/S); lik_scale: likelihood scale (SG-HMC minibatches use
      N/batch).  At 1.0 (the default) the product is exact, so every
      potential computes what it did without them.
    """
    spec = model.param_spec()
    unc_shapes = {
        k: v.bijector.unconstrained_shape(tuple(v.shape)) for k, v in spec.items()
    }
    ndim, unflatten, flatten = make_unflatten(unc_shapes)

    def constrain_with_fldj(flat):
        unc = unflatten(flat)
        params = {}
        fldj = torch.zeros(flat.shape[0], dtype=flat.dtype, device=flat.device)
        for name, ps in spec.items():
            params[name] = ps.bijector.forward(unc[name])
            fldj = fldj + ps.bijector.fldj(unc[name])
        return params, fldj

    def constrain(flat):
        return constrain_with_fldj(flat)[0]

    def unconstrain(params):
        return flatten(
            {k: spec[k].bijector.inverse(torch.as_tensor(params[k])) for k in spec}
        )

    def log_lik(params, data, lead):
        if len(lead) < 2 or model.shard_batched_lik:
            return model.log_lik(params, data)
        return torch.stack([
            model.log_lik(
                {k: v[s] for k, v in params.items()},
                {k: v[s] if isinstance(v, torch.Tensor) else v for k, v in data.items()},
            )
            for s in range(lead[0])
        ])

    def log_parts(flat, data):
        """(prior log density with the bijectors' fldj, unscaled
        log-likelihood or None), each over the flattened lead axes."""
        lead = flat.shape[:-1]
        # the prior and bijectors see every shard's chains as one batch
        params, fldj = constrain_with_fldj(flat.reshape(-1, ndim))
        lp = prior_scale * model.log_prior(params) + fldj
        if data is None:
            return lp, None
        params = {k: v.reshape(lead + v.shape[1:]) for k, v in params.items()}
        return lp, log_lik(params, data, lead).reshape(lp.shape)

    def potential(flat, data=None):
        lp, ll = log_parts(flat, data)
        if ll is not None:
            lp = lp + lik_scale * ll
        return -lp.reshape(flat.shape[:-1])

    def potential_parts(flat, data):
        lp, ll = log_parts(flat, data)
        lead = flat.shape[:-1]
        return -lp.reshape(lead), ll.reshape(lead)

    def potential_and_grad(flat, data=None):
        with torch.enable_grad():
            z = flat.detach().requires_grad_(True)
            pe = potential(z, data)
            # chains are independent: the gradient of the sum is the
            # per-chain gradient, row by row
            (grad,) = torch.autograd.grad(pe.sum(), z)
        return pe.detach(), grad

    def init_flat(chains: int, generator: torch.Generator, device) -> torch.Tensor:
        init = model.init_params(generator)
        if init is None:
            u = torch.rand(
                (chains, ndim), generator=generator, device=device,
                dtype=torch.float32,
            )
            return 4.0 * u - 2.0
        return unconstrain(init)

    return FlatModel(
        ndim=ndim,
        potential=potential,
        potential_and_grad=potential_and_grad,
        constrain_with_fldj=constrain_with_fldj,
        constrain=constrain,
        unconstrain=unconstrain,
        init_flat=init_flat,
        potential_parts=potential_parts,
    )


def normal_logpdf(x, loc=0.0, scale=1.0):
    """Elementwise N(loc, scale) log-density (the jax.scipy form); scale
    is a number or a tensor (a parameter, e.g. the LMM's sigma)."""
    z = (x - loc) / scale
    log_scale = torch.log(scale) if isinstance(scale, torch.Tensor) else np.log(scale)
    return -0.5 * z * z - 0.5 * np.log(2.0 * np.pi) - log_scale


__all__ = [
    "FlatModel",
    "Model",
    "ParamSpec",
    "Potential",
    "flatten_model",
    "normal_logpdf",
    "prepare_model_data",
]
