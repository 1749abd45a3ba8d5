"""Transition kernels of the port: the per-chain NUTS and HMC, SG-HMC,
and the ChEES-HMC ensemble (`kernels.chees`)."""

from .base import HMCInfo, HMCState, init_state
from .hmc import hmc_step
from .nuts import nuts_step
from .sghmc import SGHMCState, sghmc_init, sghmc_step

__all__ = [
    "HMCState",
    "HMCInfo",
    "SGHMCState",
    "init_state",
    "hmc_step",
    "nuts_step",
    "sghmc_init",
    "sghmc_step",
]
