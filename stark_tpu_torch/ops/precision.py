"""Knob resolution for the fused ops — counterpart of the knob half of
``stark_tpu/ops/precision.py`` — and the arithmetic of each dot
precision.

The JAX package honours two process-wide knobs:
``STARK_FUSED_PRECISION`` (highest | high | default) for the kernels'
dot passes and ``STARK_FUSED_X_DTYPE`` (f32 | bf16 | int8 | fp8e4m3 |
fp8e5m2) for the storage type of the streamed design matrix.  The port
runs every precision; it streams X as float32 only, and any other
X dtype raises and names the ROADMAP item that brings it, so a knob is
never silently ignored.

What a precision computes is the reference's own definition
(`dot_precision`): ``highest`` is the float32 product; ``default`` one
bf16 pass, both operands rounded to bf16 (to nearest even) and the
products summed in float32; ``high`` three bf16 passes, each operand a
split into ``a_hi = bf16(a)`` and ``a_lo = bf16(a - a_hi)`` and the
product taken as ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` in float32, in
that order.  `dot` computes it in plain PyTorch: the definition every
kernel (``csrc/``) and every plain version is held to.  A product of
two bf16 values is exact in float32, so a kernel and `dot` differ only
in the order of their float32 sums.  A dot against an exact 0/1 matrix
(a one-hot of group ids, which the kernels take as a gather or a
segment sum) reduces to `dot_operand`: ``a`` rounded to bf16, or
``a_hi + a_lo``, then exact products with 0 and 1.

The scaffold half of the reference's module lives here too: the
``STARK_FUSED_<FAMILY>`` model knobs (`fused_knob`), the clip band of a
link (`clip_band`), the deterministic segment sum of a gradient over
row ids (`segment_sum`) and the one-pass fused-op contract
(`fused_value_and_grad`).  The JAX package keys its jit cache on the
resolved knobs; the port traces nothing, so every fused op reads the
knobs when it is called (`check_knobs` first, then the family knob at
the model's call), and a knob flipped between two calls takes effect
at the next one.
"""

from __future__ import annotations

import inspect
import os
from typing import Callable, Tuple

import torch

#: the values of STARK_FUSED_PRECISION, and the code each has in the C
#: entry points of the kernels (csrc/fused_pass.cuh: kHighest, kHigh,
#: kDefault)
PRECISIONS = {"highest": 0, "high": 1, "default": 2}
_X_DTYPE_F32 = ("f32", "float32")
_X_DTYPE_PENDING = (
    "bf16", "bfloat16", "int8", "fp8e4m3", "float8_e4m3fn", "fp8e5m2",
    "float8_e5m2",
)


def dot_precision() -> str:
    """Resolved ``STARK_FUSED_PRECISION``: ``highest`` (the default),
    ``high`` or ``default``; read at every call."""
    name = os.environ.get("STARK_FUSED_PRECISION", "highest").lower()
    if name not in PRECISIONS:
        raise ValueError(f"STARK_FUSED_PRECISION={name!r}: use highest|high|default")
    return name


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (to nearest even), in ``a``'s dtype."""
    return a.to(torch.bfloat16).to(a.dtype)


def bf16_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_hi, a_lo): a_hi = bf16(a), a_lo = bf16(a - a_hi); a_lo is 0
    where ``a`` is exact in bf16."""
    hi = bf16_round(a)
    return hi, bf16_round(a - hi)


def dot_operand(a: torch.Tensor, prec: str) -> torch.Tensor:
    """What a dot at ``prec`` takes of ``a`` against an exact 0/1
    operand: ``a`` (highest), bf16(a) (default), a_hi + a_lo (high, one
    float32 add: the two passes against the 0/1 operand summed per
    element)."""
    if prec == "highest":
        return a
    if prec == "default":
        return bf16_round(a)
    hi, lo = bf16_split(a)
    return hi + lo


def dot(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` at the dot precision ``prec`` (module docstring): the
    float32 product; one bf16 pass; or three, a_hi b_hi + a_hi b_lo +
    a_lo b_hi in that order.  Batched as ``@`` is."""
    if prec == "highest":
        return a @ b
    if prec == "default":
        return bf16_round(a) @ bf16_round(b)
    if prec != "high":
        raise ValueError(f"unknown dot precision {prec!r}; use one of {sorted(PRECISIONS)}")
    a_hi, a_lo = bf16_split(a)
    b_hi, b_lo = bf16_split(b)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


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


def check_knobs() -> str:
    """Raise unless both knobs resolve to what the port runs; returns
    the resolved dot precision."""
    x_stream_dtype()
    return dot_precision()


def fused_knob(name: str, default: bool = False) -> bool:
    """Boolean ``STARK_FUSED_<FAMILY>`` model knob: unset -> ``default``,
    ``"0"`` -> off, anything else -> on.  It picks the execution path of
    a ``Fused*`` model (the fused op or autograd); read at every call."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val != "0"


def clip_band(eta_raw: torch.Tensor, clip: float):
    """(eta, inside): the linear predictor clipped to [-clip, clip] and
    the float mask, 1 strictly inside the band, that zeroes a saturated
    row's gradient terms (autograd's sensitivity through a clamp there)."""
    eta = torch.clamp(eta_raw, -clip, clip)
    inside = (eta_raw.abs() < clip).to(eta_raw.dtype)
    return eta, inside


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num_segments: int,
                dim: int = -1) -> torch.Tensor:
    """Deterministic sums of ``vals`` over the row ids ``ids`` (N,) along
    ``dim`` (of length N) -> the same shape with ``num_segments`` there;
    an id without rows sums to exactly 0.  One accumulating
    ``index_put_`` for every other index at once: CUDA runs it
    sort-based (the ids sorted stably, each id's run of rows summed in
    that order), so the same inputs give the same bits, where
    ``index_add_`` and ``scatter_add_`` sum with float atomics."""
    rows = vals.movedim(dim, 0)  # (N, ...)
    out = rows.new_zeros((num_segments,) + rows.shape[1:])
    out.index_put_((ids,), rows, accumulate=True)
    return out.movedim(0, dim)


def per_chain(ct: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cotangent (C,) or () times a gradient (C, ...) or (...)."""
    return ct.reshape(ct.shape + (1,) * (g.ndim - ct.ndim)) * g


def fused_value_and_grad(vg: Callable, ndiff: int) -> Tuple[Callable, Callable]:
    """One residual function -> the fused-op contract.

    ``vg(*args) -> (value, grads)`` computes the log-likelihood (one
    value per chain, or a scalar) and the tuple of its gradients with
    respect to the first ``ndiff`` arguments in one pass over the data
    arguments (positions ``ndiff`` onward).  Returns

    * ``op(*args)``: differentiable through a ``torch.autograd.Function``
      whose backward scales the saved gradients by the cotangent and
      never reads the data arguments again (their gradients are None);
    * ``op_value_and_grad(*args) -> (value, grads)``: the direct entry.

    Both call `check_knobs` first, so an X-stream knob the port does not
    run is refused, not ignored.  ``vg`` reads the dot precision itself
    (`dot_precision`) where it takes a dot.
    """
    nargs = len(inspect.signature(vg).parameters)
    if not 0 < ndiff <= nargs:
        raise ValueError(f"ndiff={ndiff} out of range for {nargs}-arg vg")

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            val, grads = vg(*args)
            ctx.save_for_backward(*grads)
            return val

        @staticmethod
        def backward(ctx, ct):
            grads = tuple(per_chain(ct, g) for g in ctx.saved_tensors)
            return grads + (None,) * (nargs - ndiff)

    def op(*args):
        check_knobs()
        return _Op.apply(*args)

    def op_value_and_grad(*args):
        check_knobs()
        with torch.no_grad():
            return vg(*args)

    _Op.__name__ = f"Fused{vg.__name__}"  # names its backward in profiles
    return op, op_value_and_grad
