"""Ordered logistic regression: ordinal outcomes with ordered cutpoints —
counterpart of ``stark_tpu/models/ordinal.py``.

Data: {"x": (N, D) float32, "y": (N,) float32 categories in {0 .. K-1}}.
The cutpoints ride the `Ordered` bijector (strictly increasing by
construction), so the category probabilities are always defined.  Two
models share one posterior:

* `OrderedLogistic`: plain autograd;
* `FusedOrderedLogistic`: value and every gradient from the one-pass
  fused op of `ops.ordinal_fused` behind the default-off
  ``STARK_FUSED_ORDINAL`` knob (X transposed once when the knob is on
  at prepare time; with it off, `OrderedLogistic` bit for bit).

Both evaluate a chain batch and a shard batch (parameters (S, C, ...)
against data split into S row blocks, `Model.shard_batched_lik`).
"""

from __future__ import annotations

import numpy as np

from ..bijectors import Ordered, batch_sum
from ..model import Model, ParamSpec, normal_logpdf
from .glm import _rows_xT
from .logistic import KnobGatedFusedMixin


class OrderedLogistic(Model):
    """y in {0 .. K-1} ~ OrderedLogistic(x beta, cutpoints):
    P(y = k) = sigmoid(c_{k+1} - eta) - sigmoid(c_k - eta) with c_0 =
    -inf, c_K = +inf; beta ~ N(0, prior_scale), cutpoints (K-1,)
    strictly increasing ~ N(0, cut_scale)."""

    shard_batched_lik = True

    def __init__(self, num_features: int, num_categories: int,
                 prior_scale: float = 2.5, cut_scale: float = 5.0):
        if num_categories < 2:
            raise ValueError("need at least 2 categories")
        self.num_features = num_features
        self.num_categories = num_categories
        self.prior_scale = prior_scale
        self.cut_scale = cut_scale

    def param_spec(self):
        return {
            "beta": ParamSpec((self.num_features,)),
            "cutpoints": ParamSpec((self.num_categories - 1,), Ordered()),
        }

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))
        return lp + batch_sum(normal_logpdf(p["cutpoints"], 0.0, self.cut_scale))

    def log_lik(self, p, data):
        from ..ops.ordinal_fused import (
            category_onehots,
            log_category_prob,
            pad_cutpoints,
            take_bins,
        )

        eta = p["beta"] @ _rows_xT(data)
        cpad = pad_cutpoints(p["cutpoints"])
        oh_lo, oh_up = category_onehots(data["y"], cpad.shape[-1], eta.dtype)
        return log_category_prob(take_bins(cpad, oh_up) - eta,
                                 take_bins(cpad, oh_lo) - eta).sum(-1)


class FusedOrderedLogistic(KnobGatedFusedMixin, OrderedLogistic):
    """OrderedLogistic with the one-pass fused value-and-grad
    (`ops.ordinal_fused.ordinal_loglik`: beta and the cutpoints from one
    pass over the transposed X) behind ``STARK_FUSED_ORDINAL`` (default
    off)."""

    _FUSED_FAMILY = "ordinal"

    @staticmethod
    def _fused_enabled():
        from ..ops.ordinal_fused import fused_ordinal_enabled

        return fused_ordinal_enabled()

    def _fused_log_lik(self, p, data):
        from ..ops.ordinal_fused import ordinal_loglik

        from ..ops.quantize import stream_slab

        return ordinal_loglik(p["beta"], p["cutpoints"], stream_slab(data), data["y"])


def synth_ordinal_data(seed: int, n: int, d: int, *, num_categories: int = 5):
    """Synthetic ordinal dataset (+ the true parameters), as numpy arrays
    from a seeded generator: x ~ N(0, 1), beta ~ N(0, 1), cutpoints at
    the quantiles of eta = x beta that split it into equal shares, y =
    the number of cutpoints below eta + Logistic(0, 1).  The same recipe
    as the JAX package's; the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, d), dtype=f32)
    beta = rng.standard_normal(d, dtype=f32)
    eta = x @ beta
    cuts = np.quantile(eta, np.linspace(0.0, 1.0, num_categories + 1)[1:-1]).astype(f32)
    noise = rng.logistic(size=n).astype(f32)
    y = np.sum((eta + noise)[:, None] > cuts[None, :], axis=1).astype(f32)
    return {"x": x, "y": y}, {"beta": beta, "cutpoints": cuts}
