"""Execution backends — counterpart of ``stark_tpu/backends``: the
`SamplerBackend` boundary and the one backend of the port, `CudaBackend`
(one device, ``cuda`` unless the caller asks for the CPU)."""

from .base import AdaptiveParts, SamplerBackend
from .cuda_backend import CudaBackend

__all__ = ["AdaptiveParts", "CudaBackend", "SamplerBackend"]
