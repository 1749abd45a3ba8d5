"""Fused value-and-grad of the IRT 2PL log-likelihood — counterpart of
``stark_tpu/ops/irt_fused.py``.

``y ~ Bernoulli(sigmoid(a[item] * (theta[person] - b[item])))`` has no
design matrix.  On (person, item, response) triples autograd gathers
three times on the way in and scatters three times on the way back.
Two layouts, each one pass:

* grid (the fast path): when the triples are the full response matrix
  in person-major order, `prepare_grid` reshapes y to (P, I) once, on
  the host.  There is no gather and no scatter: the logits are a broadcast,
  ``d/dtheta = resid @ a``, and the item gradients come from ``theta @
  resid`` and a column sum: two matrix-vector products and a sum,
  batched over chains;
* triples (the general path): a ragged or incomplete response set keeps
  its index vectors; the pass shares the gathered operands and the
  residual across the three gradients and takes them as three 1-D
  segment sums (`ops.precision.segment_sum`, deterministic on the card).

The reference leaves both to XLA, outside any Pallas kernel, so here
they are plain PyTorch and no hand-written kernel.  The grid's two
products run at STARK_FUSED_PRECISION (`ops.precision.dot`), as the
reference passes the knob to them; the triples take no dot.

Model side: `models.irt.FusedIRT2PL` routes through `irt_grid_loglik`
or `irt_loglik` behind the default-off ``STARK_FUSED_IRT`` knob.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from .precision import (
    dot,
    dot_precision,
    fused_knob,
    fused_value_and_grad,
    segment_sum,
    x_stream_dtype,
)


def fused_irt_enabled() -> bool:
    """The STARK_FUSED_IRT knob (default off: opt-in fused path)."""
    return fused_knob("STARK_FUSED_IRT")


def _bernoulli_terms(logits, y):
    """Per-response log-likelihood y log sigmoid(l) + (1 - y) log sigmoid(-l)."""
    return y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits)


def _irt_vg(theta, a, b, person, item, y):
    """(ll, (d/dtheta, d/da, d/db)) in one pass over the triples.

    Per chain: theta (C, P), a and b (C, I); or one chain without the C
    axis.  person, item (N,) integer ids; y (N,) in {0, 1}.
    """
    da = a[..., item]
    gap = theta[..., person] - b[..., item]
    logits = da * gap
    ll = _bernoulli_terms(logits, y).sum(-1)
    resid = y - logits.sigmoid()  # shared by the three gradients
    ra = resid * da
    num_items = a.shape[-1]
    g_theta = segment_sum(ra, person, theta.shape[-1])
    g_a = segment_sum(resid * gap, item, num_items)
    g_b = -segment_sum(ra, item, num_items)
    return ll, (g_theta, g_a, g_b)


irt_loglik, irt_loglik_value_and_grad = fused_value_and_grad(_irt_vg, ndiff=3)
irt_loglik.__doc__ = """Differentiable fused 2PL log-lik (one pass over the
response triples).  Autograd chains the saved (P,) and (I,) gradients;
the ``a`` positivity bijector differentiates outside the op."""


def _irt_grid_vg(theta, a, b, y):
    """(ll, (d/dtheta, d/da, d/db)) on the dense (P, I) response grid.

    Per chain: theta (C, P), a and b (C, I); or one chain without the C
    axis.  y (P, I) in {0, 1}.  No gathers, no scatters: the residual
    matrix feeds two matrix-vector products and a column sum.
    """
    prec = dot_precision()
    gap = theta[..., :, None] - b[..., None, :]
    logits = a[..., None, :] * gap
    ll = _bernoulli_terms(logits, y).sum((-2, -1))
    resid = y - logits.sigmoid()  # ([C,] P, I)
    colsum = resid.sum(-2)  # ([C,] I)
    g_theta = dot(resid, a[..., :, None], prec).squeeze(-1)
    # sum_p resid[p, i] gap[p, i] = (theta @ resid)[i] - b[i] colsum[i]
    g_a = dot(theta[..., None, :], resid, prec).squeeze(-2) - b * colsum
    g_b = -a * colsum
    return ll, (g_theta, g_a, g_b)


irt_grid_loglik, irt_grid_loglik_value_and_grad = fused_value_and_grad(_irt_grid_vg, ndiff=3)
irt_grid_loglik.__doc__ = """Differentiable fused 2PL log-lik on the dense
(P, I) grid layout: the scatter-free fast path."""


def prepare_grid(data, num_persons: int, num_items: int):
    """One host-side layout check and reshape for the grid path.

    When the triples are exactly the full response matrix in
    person-major order (what `models.irt.synth_irt_data` and any
    complete administration give), replace them with ``y_grid`` (P, I);
    otherwise return the data unchanged, and the op takes the triples.
    Data already prepared keep their layout.
    """
    if "y_grid" in data:
        return data
    person = np.asarray(data["person"])
    item = np.asarray(data["item"])
    n = num_persons * num_items
    if person.shape[0] != n or item.shape[0] != n:
        return data
    if not np.array_equal(person, np.repeat(np.arange(num_persons), num_items)):
        return data
    if not np.array_equal(item, np.tile(np.arange(num_items), num_persons)):
        return data
    x_stream_dtype()  # only float32 streams are ported
    out = {k: v for k, v in data.items() if k not in ("person", "item", "y")}
    out["y_grid"] = np.asarray(data["y"]).reshape(num_persons, num_items)
    return out
