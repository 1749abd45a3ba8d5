"""Fused value-and-grad of the Poisson GLM log-likelihood — counterpart
of ``stark_tpu/ops/glm_fused.py``.

The likelihood value and its beta-gradient come out of one pass over
the transposed design matrix ``xT`` (D, N): ``eta = beta @ xT`` for
every chain in one product, the clip band, ``mu = exp(eta)``, the value,
and ``grad = resid @ xT.T``.  The backward only rescales the saved
gradient, so X is read once per evaluation.  The reference leaves these
two products to XLA, outside any Pallas kernel, so here they are two
``torch.matmul`` calls at STARK_FUSED_PRECISION (`ops.precision.dot`)
and no hand-written kernel.

Model side: `models.glm.FusedPoissonRegression` routes through
`poisson_loglik` behind ``STARK_FUSED_GLM`` (default on; ``0`` falls
back to autograd on the same transposed layout).
"""

from __future__ import annotations

import torch

from .precision import clip_band, dot_precision, fused_knob, fused_value_and_grad
from .quantize import dequant_dot, dequant_dot_t

#: clip bound of the log-link rate, as models.glm.PoissonRegression's
#: (a warmup excursion must not overflow float32 through exp)
LOG_RATE_CLIP = 30.0


def fused_glm_enabled() -> bool:
    """The STARK_FUSED_GLM knob (default on, as in the JAX package)."""
    return fused_knob("STARK_FUSED_GLM", default=True)


def _poisson_vg(beta, xT, y):
    """(ll, (dll/dbeta,)) of y ~ Poisson(exp(clip(X beta))) in one X pass.

    beta (C, D) or (D,); xT (D, N), X transposed, or its packed
    ``(q, scale)`` pair (`quantize.stream_slab`); y (N,) counts (float)
    -> ll (C,) or (), dll/dbeta shaped like beta.  Per shard: beta (S,
    C, D), xT (S, D, n), y (S, n) -> ll (S, C).  Rows whose predictor
    lies outside the clip band contribute no gradient, as autograd
    through ``torch.clamp`` gives.
    """
    prec = dot_precision()
    eta, inside = clip_band(dequant_dot(beta, xT, prec), LOG_RATE_CLIP)
    if eta.ndim == 3:
        y = y.unsqueeze(-2)
    mu = torch.exp(eta)
    ll = (y * eta - mu - torch.lgamma(y + 1.0)).sum(-1)
    resid = (y - mu) * inside
    return ll, (dequant_dot_t(xT, resid, prec),)


_op, _op_vg = fused_value_and_grad(_poisson_vg, ndiff=1)


def poisson_loglik(beta, xT, y):
    """Differentiable fused Poisson log-lik of exp(clip(X beta)), per
    chain: beta (C, D) [or (D,)] -> (C,) [or ()]; per shard and chain,
    beta (S, C, D), xT (S, D, n), y (S, n) -> (S, C)."""
    return _op(beta, xT, y)


def poisson_loglik_value_and_grad(beta, xT, y):
    """-> (ll, dll/dbeta) in one pass over xT."""
    val, (grad,) = _op_vg(beta, xT, y)
    return val, grad
