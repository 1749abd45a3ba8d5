"""Transition kernels of the port (ChEES-HMC in this slice)."""
