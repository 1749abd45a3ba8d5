"""Item-response theory: the 2-parameter-logistic (2PL) model —
counterpart of ``stark_tpu/models/irt.py``.

Data: (person, item, response) triples, {"person": (N,) int32, "item":
(N,) int32, "y": (N,) float32 in {0, 1}}.  Two models share one
posterior:

* `IRT2PL`: plain autograd through the gathers;
* `FusedIRT2PL`: behind the default-off ``STARK_FUSED_IRT`` knob, a
  complete response set is reshaped once to the dense (P, I) grid and
  the value and every gradient come from `ops.irt_fused`'s grid op; a
  ragged set keeps its triples and takes the fused triples op.  With
  the knob off at prepare time it is `IRT2PL` bit for bit; grid data
  keep working after the knob flips off (autograd on the grid).

Parameters carry a leading chain axis (see `model.Model`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bijectors import Exp, batch_sum
from ..model import Model, ParamSpec, normal_logpdf
from .logistic import _bernoulli_logit_loglik


class IRT2PL(Model):
    """y_pi ~ Bernoulli(sigmoid(a_i (theta_p - b_i))): theta ~ N(0, 1)
    (the scale anchor), b ~ N(0, 1), a ~ LogNormal(0, 0.5) (positive
    through the Exp bijector, which keeps the discrimination's sign
    identified)."""

    def __init__(self, num_persons: int, num_items: int):
        self.num_persons = num_persons
        self.num_items = num_items

    def param_spec(self):
        return {
            "theta": ParamSpec((self.num_persons,)),
            "a": ParamSpec((self.num_items,), Exp()),
            "b": ParamSpec((self.num_items,)),
        }

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["theta"])) + batch_sum(normal_logpdf(p["b"]))
        # a ~ LogNormal(0, 0.5): the normal density of log a and its
        # Jacobian -log a (the Exp bijector's fldj covers the transform)
        log_a = torch.log(p["a"])
        return lp + batch_sum(normal_logpdf(log_a, 0.0, 0.5) - log_a)

    def log_lik(self, p, data):
        item = data["item"]
        logits = p["a"][..., item] * (p["theta"][..., data["person"]] - p["b"][..., item])
        return _bernoulli_logit_loglik(logits, data["y"])


class FusedIRT2PL(IRT2PL):
    """IRT2PL with the one-pass fused value-and-grad (`ops.irt_fused`)
    behind ``STARK_FUSED_IRT`` (default off): on the (P, I) grid when
    the knob is on at prepare time and the response set is complete,
    else on the triples."""

    def prepare_data(self, data):
        from ..ops.irt_fused import fused_irt_enabled, prepare_grid

        if fused_irt_enabled():
            return prepare_grid(data, self.num_persons, self.num_items)
        return data

    def fused_tag(self):
        from ..ops.irt_fused import fused_irt_enabled

        return "irt" if fused_irt_enabled() else None

    def data_row_axes(self, data):
        if "y_grid" in data:
            raise NotImplementedError(
                "FusedIRT2PL's dense (P, I) grid layout pins y_grid row k "
                "to person k of the FULL theta vector: rows cannot be "
                "minibatched or split into sub-posteriors (SG-HMC, "
                "consensus, mesh data sharding) — a slice would "
                "misalign persons against theta.  Run those entry "
                "points with STARK_FUSED_IRT=0 (the triples layout "
                "row-splits fine; each triple carries its person id), "
                "or on ragged data, which keeps triples.  Chain "
                "parallelism always applies."
            )
        return super().data_row_axes(data)

    def log_lik(self, p, data):
        from ..ops.irt_fused import fused_irt_enabled, irt_grid_loglik, irt_loglik
        from ..ops.quantize import widen

        theta, a, b = p["theta"], p["a"], p["b"]
        if "y_grid" in data:
            if fused_irt_enabled():
                return irt_grid_loglik(theta, a, b, data["y_grid"])
            # the knob flipped off after a grid prepare: autograd on the grid
            logits = a[..., None, :] * (theta[..., :, None] - b[..., None, :])
            # (a packed grid widened: 0 and 1 are exact)
            return _bernoulli_logit_loglik(logits.flatten(-2), widen(data["y_grid"]).flatten())
        if not fused_irt_enabled():
            return super().log_lik(p, data)
        return irt_loglik(theta, a, b, data["person"], data["item"], data["y"])


def synth_irt_data(seed: int, num_persons: int, num_items: int):
    """The full response matrix as (P * I,) person-major triples (+ the
    true parameters), as numpy arrays from a seeded generator: theta ~
    N(0, 1), a = exp(0.5 N(0, 1)), b ~ N(0, 1), y ~ Bernoulli(sigmoid(a
    (theta - b))).  The same recipe as the JAX package's; the streams
    differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    theta = rng.standard_normal(num_persons, dtype=f32)
    a = np.exp(f32(0.5) * rng.standard_normal(num_items, dtype=f32)).astype(f32)
    b = rng.standard_normal(num_items, dtype=f32)
    person = np.repeat(np.arange(num_persons, dtype=np.int32), num_items)
    item = np.tile(np.arange(num_items, dtype=np.int32), num_persons)
    logits = a[item] * (theta[person] - b[item])
    y = (rng.random(person.shape[0], dtype=f32) < 1.0 / (1.0 + np.exp(-logits))).astype(f32)
    return {"person": person, "item": item, "y": y}, {"theta": theta, "a": a, "b": b}
