"""Knob resolution for the fused ops — counterpart of the knob half of
``stark_tpu/ops/precision.py``.

The JAX package honours two process-wide knobs:
``STARK_FUSED_PRECISION`` (highest | high | default) for the kernels'
dot passes and ``STARK_FUSED_X_DTYPE`` (f32 | bf16 | int8 | fp8e4m3 |
fp8e5m2) for the storage type of the streamed design matrix.  The port
runs the kernels' arithmetic as float32 FMAs on the CUDA cores and
streams X as float32: ``highest`` and ``f32``.  Any other value raises
and names the ROADMAP item that brings it, so a knob is never silently
ignored.
"""

from __future__ import annotations

import os

import torch

_PRECISION_PENDING = ("high", "default")
_X_DTYPE_F32 = ("f32", "float32")
_X_DTYPE_PENDING = (
    "bf16", "bfloat16", "int8", "fp8e4m3", "float8_e4m3fn", "fp8e5m2",
    "float8_e5m2",
)


def dot_precision() -> str:
    """Resolved ``STARK_FUSED_PRECISION``; only ``highest`` runs here."""
    name = os.environ.get("STARK_FUSED_PRECISION", "highest").lower()
    if name == "highest":
        return name
    if name in _PRECISION_PENDING:
        raise NotImplementedError(
            f"STARK_FUSED_PRECISION={name!r} is not ported yet: the CUDA "
            "kernels run full float32 FMAs (highest). TF32/3xTF32/BF16 "
            "tensor-core modes are ROADMAP item B6."
        )
    raise ValueError(f"STARK_FUSED_PRECISION={name!r}: use highest|high|default")


def x_stream_dtype() -> torch.dtype:
    """Resolved ``STARK_FUSED_X_DTYPE``; only ``f32`` runs here."""
    name = os.environ.get("STARK_FUSED_X_DTYPE", "f32").lower()
    if name in _X_DTYPE_F32:
        return torch.float32
    if name in _X_DTYPE_PENDING:
        raise NotImplementedError(
            f"STARK_FUSED_X_DTYPE={name!r} is not ported yet: the CUDA "
            "kernels stream X as float32. Narrow X streams (bf16, int8, "
            "fp8) are ROADMAP item B5."
        )
    raise ValueError(
        f"STARK_FUSED_X_DTYPE={name!r}: use f32|bf16|int8|fp8e4m3|fp8e5m2"
    )


def check_knobs() -> None:
    """Raise unless both knobs resolve to what the port runs."""
    dot_precision()
    x_stream_dtype()
