"""One-pass fused value-and-grad of the LMM gaussian log-likelihood —
counterpart of ``stark_tpu/ops/lmm_fused.py``.

``mu = intercept + beta @ xT + sum_q z_q u[g, q]``; one pass gives the
value and every parameter gradient (∂beta, ∂u, ∂intercept, ∂sigma), and
the backward only rescales them, so the data are read once per
evaluation.  The reference runs this at the XLA level, not in Pallas,
so here it is plain PyTorch (`ops.precision.fused_value_and_grad`),
its two X products at STARK_FUSED_PRECISION (`ops.precision.dot`), as
the reference passes the knob to them and to nothing else.

The (G, Q) gradient ∂u is a segment sum of ``z_q * resid`` over group
ids that need not be sorted.  ``index_add_`` and ``scatter_add_`` sum
with float atomics on CUDA, so their sums are not repeatable bit for
bit.  Here it is `ops.precision.segment_sum`, an accumulating
``index_put_`` that CUDA runs sort-based: the ids are sorted stably
and each id's run of rows is summed in that order, so the same inputs
give the same bits (on the CPU it sums row by row).

Model side: `models.lmm.FusedLMM` routes through `lmm_loglik` behind
the default-off ``STARK_FUSED_LMM`` knob.
"""

from __future__ import annotations

import math

import torch

from .precision import dot_precision, fused_knob, fused_value_and_grad, segment_sum
from .quantize import dequant_dot, dequant_dot_t

_LOG_2PI = math.log(2.0 * math.pi)


def fused_lmm_enabled() -> bool:
    """The STARK_FUSED_LMM knob (default off: opt-in fused path)."""
    return fused_knob("STARK_FUSED_LMM")


def _lmm_vg(beta, u, intercept, sigma, xT, z, g, y):
    """(ll, (d/dbeta, d/du, d/dintercept, d/dsigma)) in one pass.

    Per chain: beta (C, D), u (C, G, Q) constrained random effects,
    intercept (C,), sigma (C,); or one chain without the C axis.  Data:
    xT (D, N), X transposed, or its packed ``(q, scale)`` pair
    (`quantize.stream_slab`); z (N, Q); g (N,) group ids; y (N,).
    ``ll = sum_i Normal(y_i | intercept + x_i beta + z_i . u[g_i], sigma)``.
    """
    prec = dot_precision()
    eta = dequant_dot(beta, xT, prec) + intercept[..., None] + (z * u[..., g, :]).sum(-1)
    resid = y - eta
    ssr = (resid * resid).sum(-1)
    n = y.shape[-1]
    val = -0.5 * ssr / sigma**2 - n * torch.log(sigma) - 0.5 * n * _LOG_2PI
    inv2 = 1.0 / (sigma * sigma)
    g_beta = inv2[..., None] * dequant_dot_t(xT, resid, prec)
    g_u = inv2[..., None, None] * segment_sum(resid[..., None] * z, g, u.shape[-2], dim=-2)
    g_intercept = inv2 * resid.sum(-1)
    g_sigma = ssr * inv2 / sigma - n / sigma
    return val, (g_beta, g_u, g_intercept, g_sigma)


lmm_loglik, lmm_loglik_value_and_grad = fused_value_and_grad(_lmm_vg, ndiff=4)
lmm_loglik.__doc__ = """Differentiable fused LMM log-lik (one data pass).

Autograd through this op chains the gradients of the forward pass; the
model's non-centred ``u = tau * u_raw`` and the sigma bijector
differentiate through the returned (C, G, Q) and (C,) gradients outside
the op."""
