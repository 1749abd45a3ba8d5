"""Fused chain-batched logistic log-likelihood — counterpart of
``stark_tpu/ops/logistic_fused.py`` (kernel B2, bernoulli_logit link).

``xT`` is the design matrix transposed, (D, N), as the JAX package lays
it out.  `logistic_batched` evaluates, for a (C, D) block of chains in
one pass over X, the log-likelihood value (C,), its beta gradient (C, D)
and — when per-chain row offsets (C, N) are given — the residual
y - sigmoid(logits) (C, N), which the offset-path model sums per group.

On a CUDA tensor it launches ``csrc/logistic_batched.cu``; on a CPU
tensor it runs `logistic_batched_plain`, the same function in plain
PyTorch (the CPU tests' path and the kernel's yardstick on the card).
There is no fallback from one to the other.

`logistic_offset_loglik` and `logistic_loglik` wrap it in
``torch.autograd.Function``s whose backward only rescales the gradients
the forward pass already computed, so X is read once per evaluation.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .precision import check_knobs

#: rows per staged sub-tile in csrc/fused_pass.cuh (kRows)
KERNEL_ROW_TILE = 128
#: target number of row blocks per launch (about two per SM on an H100)
_TARGET_BLOCKS = 256


def row_blocks(n: int) -> Tuple[int, int]:
    """(rows per block, number of blocks) for the CUDA kernels: blocks of
    a multiple of KERNEL_ROW_TILE rows, about _TARGET_BLOCKS of them,
    chosen from N alone so a given shape always sums in the same order."""
    per = -(-n // _TARGET_BLOCKS)
    rows = max(KERNEL_ROW_TILE, -(-per // KERNEL_ROW_TILE) * KERNEL_ROW_TILE)
    return rows, -(-n // rows)


def _link_parts(y, logits):
    """Bernoulli-logit value terms and residual, elementwise."""
    val_terms = y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits)
    return val_terms, y - torch.sigmoid(logits)


def check_kernel_args(named, *, device, dtypes, shapes):
    """Device, dtype, shape and contiguity checks shared by the kernel
    wrappers; raises ValueError naming the offending argument."""
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtypes[name]}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def logistic_batched_plain(beta, xT, y, offsets=None):
    """Plain PyTorch version of kernel B2 (same outputs)."""
    logits = beta @ xT
    if offsets is not None:
        logits = logits + offsets
    val_terms, resid = _link_parts(y, logits)
    val = val_terms.sum(-1)
    gbeta = resid @ xT.T
    if offsets is not None:
        return val, gbeta, resid
    return val, gbeta


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def logistic_batched(
    beta: torch.Tensor,
    xT: torch.Tensor,
    y: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
):
    """Kernel B2: -> (val (C,), gbeta (C, D)[, resid (C, N)]).

    beta (C, D), xT (D, N), y (N,), offsets (C, N) or None; float32.
    """
    check_knobs()
    if beta.device.type == "cpu":
        return logistic_batched_plain(beta, xT, y, offsets)
    if beta.device.type != "cuda":
        raise ValueError(f"logistic_batched runs on cuda or cpu, not {beta.device}")
    c, d = beta.shape
    n = xT.shape[1]
    named = {"beta": beta, "xT": xT, "y": y}
    shapes = {"beta": (c, d), "xT": (d, n), "y": (n,), "offsets": (c, n)}
    if offsets is not None:
        named["offsets"] = offsets
    check_kernel_args(
        named, device=beta.device,
        dtypes={k: torch.float32 for k in shapes}, shapes=shapes,
    )
    rows, nblk = row_blocks(n)
    val = torch.empty(c, device=beta.device, dtype=torch.float32)
    gbeta = torch.empty(c, d, device=beta.device, dtype=torch.float32)
    resid = (
        torch.empty(c, n, device=beta.device, dtype=torch.float32)
        if offsets is not None else None
    )
    scratch = torch.empty(
        nblk * (c * d + 3 * c + 2), device=beta.device, dtype=torch.float32
    )
    fn = _build.function("logistic_batched", "stark_logistic_batched", _ARGTYPES)
    err = fn(
        xT.data_ptr(), y.data_ptr(),
        offsets.data_ptr() if offsets is not None else None,
        beta.data_ptr(), val.data_ptr(), gbeta.data_ptr(),
        resid.data_ptr() if resid is not None else None,
        scratch.data_ptr(), c, d, n, rows, nblk,
        torch.cuda.current_stream(beta.device).cuda_stream,
    )
    _build.check("logistic_batched", err)
    logistic_batched.launches += 1
    if offsets is not None:
        return val, gbeta, resid
    return val, gbeta


#: launches of the CUDA kernel in this process (CPU calls do not count)
logistic_batched.launches = 0


def _as_batch(beta):
    """(D,) -> (1, D); (C, D) unchanged.  Returns (batched, was_single)."""
    return (beta[None], True) if beta.ndim == 1 else (beta, False)


class _LogisticOffsetLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, offsets, xT, y):
        val, gbeta, resid = logistic_batched(
            beta.contiguous(), xT, y, offsets.contiguous()
        )
        ctx.save_for_backward(gbeta, resid)
        return val

    @staticmethod
    def backward(ctx, ct):
        gbeta, resid = ctx.saved_tensors
        return ct[:, None] * gbeta, ct[:, None] * resid, None, None


class _LogisticLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, xT, y):
        val, gbeta = logistic_batched(beta.contiguous(), xT, y)
        ctx.save_for_backward(gbeta)
        return val

    @staticmethod
    def backward(ctx, ct):
        (gbeta,) = ctx.saved_tensors
        return ct[:, None] * gbeta, None, None


def logistic_offset_loglik(beta, offsets, xT, y):
    """Differentiable Bernoulli-logit log-lik of X beta + offsets, per
    chain: beta (C, D) [or (D,)], offsets (C, N) [or (N,)] -> (C,) [or
    ()].  ∂/∂offsets is the residual the kernel already wrote."""
    b, single = _as_batch(beta)
    off = offsets[None] if single else offsets
    val = _LogisticOffsetLoglik.apply(b, off, xT, y)
    return val[0] if single else val


def logistic_loglik(beta, xT, y):
    """Differentiable Bernoulli-logit log-lik of X beta, per chain:
    beta (C, D) [or (D,)] -> (C,) [or ()]."""
    b, single = _as_batch(beta)
    val = _LogisticLoglik.apply(b, xT, y)
    return val[0] if single else val
