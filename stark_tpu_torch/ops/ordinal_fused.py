"""Fused value-and-grad of the ordered-logistic log-likelihood —
counterpart of ``stark_tpu/ops/ordinal_fused.py``.

One (N, D) product, the two cutpoints of each row's category from the
padded vector ``(-1e9, c_1 .. c_{K-1}, 1e9)``, and the all-log-space
category probability ``log[sigmoid(u) - sigmoid(l)] = logsig(u) +
logsig(-l) + log1p(-exp(min(l - u, -eps)))``.  The value and both
gradients come out of one pass: the eta product and the gradient
product share the X stream, and the two cutpoint scatters are one sum
over the padded vector, whose pad entries take what autograd drops at
the constants (the slice discards them).

The per-row partials go through the stable form and its clamp: inside
the band the ``log1p`` correction ``r`` cancels from d/d eta but not
from the two cutpoint partials; where the clamp saturates it is 0 in
both, as autograd through the clamp gives.

A row's cutpoints are taken, and the cutpoint sums made, by products
with the rows' one-hot categories over the K+1 bins: the products sum
exactly one nonzero term per row (so the gather is exact), and the
reduction is a matrix product with no float atomics, so it repeats bit
for bit on the card.  The reference leaves all of this to XLA, so here
it is plain PyTorch and no hand-written kernel.  The two X products run
at STARK_FUSED_PRECISION (`ops.precision.dot`), as the reference passes
the knob to them; the one-hot products stand for the reference's exact
gathers and segment sums and stay float32.

Model side: `models.ordinal.FusedOrderedLogistic` routes through
`ordinal_loglik` behind the default-off ``STARK_FUSED_ORDINAL`` knob.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import dot_precision, fused_knob, fused_value_and_grad
from .quantize import dequant_dot, dequant_dot_t

#: the stable form's clamp on log(1 - e^{l-u}); models.ordinal's exactly
GAP_EPS = -1e-6
#: the pad entries of the cutpoint vector, standing for -inf and +inf
_BIG = 1e9


def fused_ordinal_enabled() -> bool:
    """The STARK_FUSED_ORDINAL knob (default off: opt-in fused path)."""
    return fused_knob("STARK_FUSED_ORDINAL")


def pad_cutpoints(cutpoints):
    """(..., K-1) -> (..., K+1): -1e9, the cutpoints, 1e9."""
    big = cutpoints.new_full(cutpoints.shape[:-1] + (1,), _BIG)
    return torch.cat([-big, cutpoints, big], dim=-1)


def category_onehots(y, num_bins: int, dtype):
    """Each row's lower and upper bins (y and y + 1) one-hot: y (..., N)
    categories -> two (..., N, num_bins) tensors of ``dtype``."""
    yi = y.long()
    return F.one_hot(yi, num_bins).to(dtype), F.one_hot(yi + 1, num_bins).to(dtype)


def take_bins(cpad, onehot):
    """cpad (..., [C,] K+1) at each row's bin -> (..., [C,] N); exact."""
    return cpad @ onehot.transpose(-1, -2)


def log_category_prob(upper, lower):
    """log P(category) from its links u = c_{y+1} - eta, l = c_y - eta,
    with the clamp at GAP_EPS (stable for gaps down to float32 eps)."""
    return (F.logsigmoid(upper) + F.logsigmoid(-lower)
            + torch.log1p(-torch.exp(torch.clamp(lower - upper, max=GAP_EPS))))


def _ordinal_vg(beta, cutpoints, xT, y):
    """(ll, (d/dbeta, d/dcutpoints)) in one pass over xT.

    Per chain: beta (C, D), cutpoints (C, K-1) strictly increasing
    (constrained space); or one chain without the C axis; or per shard
    and chain, (S, C, ...) against xT (S, D, n), y (S, n).  xT (D, N) is
    X transposed; y (N,) categories in {0 .. K-1}.
    """
    prec = dot_precision()
    eta = dequant_dot(beta, xT, prec)
    cpad = pad_cutpoints(cutpoints)
    oh_lo, oh_up = category_onehots(y, cpad.shape[-1], eta.dtype)
    upper = take_bins(cpad, oh_up) - eta
    lower = take_bins(cpad, oh_lo) - eta
    gap = lower - upper
    m = torch.clamp(gap, max=GAP_EPS)
    val = (F.logsigmoid(upper) + F.logsigmoid(-lower) + torch.log1p(-torch.exp(m))).sum(-1)
    # one row's partials through the stable form: d/d upper = sigmoid(-u)
    # + r, d/d lower = -sigmoid(l) - r, with r = e^m / (1 - e^m) the
    # log1p correction's, 0 where the clamp saturates
    e = torch.exp(m)
    r = torch.where(gap < GAP_EPS, e / (1.0 - e), torch.zeros_like(e))
    d_upper = torch.sigmoid(-upper) + r
    d_lower = -torch.sigmoid(lower) - r
    # d eta / d(upper, lower) = -1 each; the r terms cancel in the sum
    d_eta = -(d_upper + d_lower)
    g_beta = dequant_dot_t(xT, d_eta, prec)
    # both cutpoint scatters in one sum over the padded bins
    g_cpad = torch.cat([d_upper, d_lower], -1) @ torch.cat([oh_up, oh_lo], -2)
    return val, (g_beta, g_cpad[..., 1:-1])


ordinal_loglik, ordinal_loglik_value_and_grad = fused_value_and_grad(_ordinal_vg, ndiff=2)
ordinal_loglik.__doc__ = """Differentiable fused ordered-logistic log-lik
(one X pass).  Autograd chains the saved gradients of beta and the
cutpoints; the `Ordered` cutpoint bijector differentiates outside."""
