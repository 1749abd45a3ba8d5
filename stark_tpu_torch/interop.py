"""Carry the JAX package's state across into the port.

The port's counterpart of weight conversion: the reference's prepared
data dict and a flat chain state, both as numpy, become the port's
tensors on a given device.  Parity tests use both so that the two
packages compute on identical inputs.

The reference rides two static layout ints in array SHAPES (a jit
trick): ``k_loc`` is a (k_loc,) dummy and ``lt128`` a (lane_tile/128,)
dummy; the grouped models' fallback layout carries a (0,)-shaped
``offsets_path`` marker.  Here they become plain ints and a flag.  The
arrays the ported models read (`DATA_KEYS`) become tensors; any other
key raises, so nothing the reference prepared is silently dropped.

Slabs prepared under a narrow ``STARK_FUSED_X_DTYPE`` reach numpy as the
``ml_dtypes`` types bfloat16, float8_e4m3fn and float8_e5m2, which the
port does not import: they are carried across by their bits (an int16
or uint8 view) into the torch dtype of the same name.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .chees import CheesRunCarry
from .kernels.chees import init_ensemble
from .ops.quantize import from_numpy_bits


#: array keys of the ported models' prepared data: the rows (x, or its
#: transpose xT), the LMM's random-effect design (z, or zT), the
#: response, the group ids and the grouped layout (gl, first_gid); the
#: IRT triples (person, item) and grid (y_grid); survival times and
#: event flags (t, event)
DATA_KEYS = ("x", "xT", "xT_scale", "z", "zT", "zT_scale", "y", "g", "gl", "first_gid",
             "person", "item", "y_grid", "t", "event")

#: numpy dtype names of the reference's narrow slabs (ml_dtypes) -> the
#: integer view that carries their bits and the port's dtype
_BY_BITS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def data_from_reference(ref_data: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's ``prepare_model_data`` output (numpy leaves) ->
    the port's prepared data dict on ``device``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for k, v in ref_data.items():
        v = np.asarray(v)
        if k == "k_loc":
            out["k_loc"] = int(v.shape[0])
        elif k == "lt128":
            out["lane_tile"] = 128 * int(v.shape[0])
        elif k == "offsets_path":
            out["offsets_path"] = True
        elif k not in DATA_KEYS:
            raise ValueError(
                f"data key {k!r} is not one the ported models read: {DATA_KEYS}"
            )
        elif v.dtype.name in _BY_BITS:
            bits, dtype = _BY_BITS[v.dtype.name]
            out[k] = from_numpy_bits(np.array(v).view(bits), dtype).to(dev)
        else:
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            out[k] = torch.as_tensor(np.array(v), device=dev)
    return out


def chain_state_from_reference(
    z, inv_mass, step_size, log_T, *, potential, device: DeviceLike = None
) -> CheesRunCarry:
    """A flat ChEES chain state from the reference — positions z (C, d),
    inverse mass (d,), step size and log trajectory length — as the
    port's sampling carry; potential energies and gradients are
    evaluated once with ``potential`` (a bound `model.Potential`)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    states = init_ensemble(potential, f32(z))
    return CheesRunCarry(
        states=states,
        log_eps=torch.log(f32(step_size)),
        log_T=f32(log_T),
        inv_mass=f32(inv_mass),
    )
