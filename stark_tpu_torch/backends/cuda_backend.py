"""`CudaBackend` — one device, eager PyTorch around the hand-written
kernels; counterpart of ``stark_tpu/backends/jax_backend.py``.

The device is ``cuda`` unless the caller asks for the CPU (the tests do);
without a card and without ``device="cpu"`` the backend raises when it is
made.  Where the JAX backend jit-compiles each segment, this one hands
the runner the plain segment callables of `chees.make_chees_parts`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..chees import make_chees_parts, run_chees
from ..model import flatten_model, prepare_model_data
from ..sampler import SamplerConfig
from .base import AdaptiveParts


def _refuse_kernel(cfg: SamplerConfig) -> None:
    if cfg.kernel != "chees":
        raise NotImplementedError(
            f"kernel={cfg.kernel!r} is not ported yet: NUTS and HMC, their "
            "per-chain block path and ragged NUTS are ROADMAP item A8; use "
            "kernel='chees'"
        )


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
    """Chains as one (C, d) ensemble on one device."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

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
        """One fixed-budget run (`chees.run_chees`); returns a Posterior."""
        _refuse_kernel(cfg)
        data = prepare_model_data(model, data, self.device)
        return run_chees(
            flatten_model(model), cfg, data, chains=chains, seed=seed,
            init_params=init_params, device=self.device,
        )

    def adaptive_parts(self, model, cfg: SamplerConfig, data) -> AdaptiveParts:
        """The segment callables and placement hooks of the adaptive
        runner, for ``kernel="chees"``; the data is prepared once, here,
        on the device."""
        _refuse_kernel(cfg)
        fm = flatten_model(model)
        data = prepare_model_data(model, data, self.device)
        parts = make_chees_parts(fm, cfg)

        def bind(fn):
            # every segment callable takes (*args, *extra); bind data=None
            # explicitly for a model without data
            return fn if data is not None else (lambda *a: fn(*a, None))

        return AdaptiveParts(
            fm=fm,
            data=data,
            extra=() if data is None else (data,),
            put_chains=self.put,
            put_rep=self.put,
            collect=collect,
            chees=parts,
            init_j=bind(parts.init_carry),
            warm_j=bind(parts.warm_segment),
            samp_j=bind(parts.sample_segment),
            samp_diag=bind(parts.sample_segment_diag),
        )
