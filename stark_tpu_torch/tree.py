"""Flat-vector <-> named-parameter utilities.

The samplers work on one flat unconstrained vector per chain; a chain
ensemble is a (C, d) tensor.  Conversion to named (and constrained)
parameters happens at the model boundary.  Counterpart of
``stark_tpu/tree.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch


def sizes_from_shapes(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, int]:
    return {k: int(math.prod(s)) if s else 1 for k, s in shapes.items()}


def make_unflatten(
    shapes: Dict[str, Tuple[int, ...]],
) -> Tuple[
    int,
    Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    Callable[[Dict[str, torch.Tensor]], torch.Tensor],
]:
    """Build (total_size, unflatten, flatten) for an ordered dict of shapes.

    The dict insertion order is the flat layout, identical to the JAX
    package's, so flat vectors carry across unchanged.  Leading batch
    axes pass through both directions.
    """
    names = list(shapes.keys())
    sizes = sizes_from_shapes(shapes)
    offsets = {}
    off = 0
    for n in names:
        offsets[n] = off
        off += sizes[n]
    total = off

    def unflatten(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            n: flat[..., offsets[n]: offsets[n] + sizes[n]].reshape(
                flat.shape[:-1] + tuple(shapes[n])
            )
            for n in names
        }

    def flatten(params: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = []
        for n in names:
            x = torch.as_tensor(params[n])
            batch = x.shape[: x.ndim - len(shapes[n])]
            parts.append(x.reshape(tuple(batch) + (sizes[n],)))
        return torch.cat(parts, dim=-1)

    return total, unflatten, flatten
