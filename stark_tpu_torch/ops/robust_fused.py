"""Fused value-and-grad of the Student-t regression log-likelihood —
counterpart of ``stark_tpu/ops/robust_fused.py``.

One pass over the transposed design matrix ``xT`` (D, N) gives the
value and the gradients with respect to beta, sigma and nu.  Every
gradient shares the standardized residual ``z = (y - mu) / sigma`` and
the tail weight ``w = (nu + 1) / (nu + z^2)`` (rows far in the tails get
down-weighted gradients), computed once; the digamma terms of d/dnu are
the same for every row and are evaluated once per chain.  The value is
``jax.scipy.stats.t.logpdf`` summed over rows, in the same
lgamma/log1p decomposition.  The reference leaves the two products to
XLA, outside any Pallas kernel, so here they are ``torch.matmul`` calls
at STARK_FUSED_PRECISION (`ops.precision.dot`) and no hand-written
kernel.

Model side: `models.robust.FusedStudentTRegression` routes through
`studentt_loglik` behind the default-off ``STARK_FUSED_ROBUST`` knob.
"""

from __future__ import annotations

import math

import torch

from .precision import dot_precision, fused_knob, fused_value_and_grad
from .quantize import dequant_dot, dequant_dot_t

_LOG_PI = math.log(math.pi)


def fused_robust_enabled() -> bool:
    """The STARK_FUSED_ROBUST knob (default off: opt-in fused path)."""
    return fused_knob("STARK_FUSED_ROBUST")


def _studentt_vg(beta, sigma, nu, xT, y):
    """(ll, (d/dbeta, d/dsigma, d/dnu)) in one pass over xT.

    Per chain: beta (C, D), sigma and nu (C,) positive (constrained
    space); or one chain without the C axis; or per shard and chain,
    beta (S, C, D), sigma and nu (S, C) against xT (S, D, n), y (S, n).
    xT (D, N) is X transposed (or its packed ``(q, scale)`` pair,
    `quantize.stream_slab`), y (N,).
    ``ll = sum_i StudentT(y_i | nu, x_i beta, sigma)``.
    """
    prec = dot_precision()
    mu = dequant_dot(beta, xT, prec)
    if mu.ndim == 3:
        y = y.unsqueeze(-2)
    n = y.shape[-1]
    s, v = sigma[..., None], nu[..., None]
    z = (y - mu) / s
    z2 = z * z
    log1pq = torch.log1p(z2 / v)
    half_nu = 0.5 * nu
    half_nup1 = half_nu + 0.5
    val = (n * (torch.lgamma(half_nup1) - torch.lgamma(half_nu))
           - (half_nup1[..., None] * log1pq).sum(-1)
           - n * (0.5 * (torch.log(nu) + _LOG_PI) + torch.log(sigma)))
    # tail weight: d ll / d mu_i = w_i z_i / sigma
    w = (v + 1.0) / (v + z2)
    wz2 = (w * z2).sum(-1)
    g_beta = dequant_dot_t(xT, w * z, prec) / s
    g_sigma = (wz2 - n) / sigma
    dg = torch.special.digamma
    g_nu = 0.5 * (n * (dg(half_nup1) - dg(half_nu) - 1.0 / nu) - log1pq.sum(-1) + wz2 / nu)
    return val, (g_beta, g_sigma, g_nu)


studentt_loglik, studentt_loglik_value_and_grad = fused_value_and_grad(_studentt_vg, ndiff=3)
studentt_loglik.__doc__ = """Differentiable fused Student-t log-lik (one
X pass).  Autograd chains the saved gradients of beta, sigma and nu; the
sigma and nu positivity bijectors differentiate outside the op."""
