"""Transition kernels of the port: the per-chain NUTS and HMC, and the
ChEES-HMC ensemble (`kernels.chees`)."""

from .base import HMCInfo, HMCState, init_state
from .hmc import hmc_step
from .nuts import nuts_step

__all__ = [
    "HMCState",
    "HMCInfo",
    "init_state",
    "hmc_step",
    "nuts_step",
]
