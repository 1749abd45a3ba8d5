"""Bayesian 2-layer MLP — BASELINE config 5, counterpart of
``stark_tpu/models/bnn.py``.

Binary classifier with N(0, scale/sqrt(fan_in)) weight priors; the
forward pass is two dense products over the rows, plain ``torch.matmul``
(the JAX package leaves them to XLA, outside any Pallas kernel).

The forward pass reads every batch layout the port hands it: one draw
(w1 (D, H), x (B, D)), a chain batch against shared rows (w1 (C, D, H),
x (N, D)) and a chain batch against each chain's own minibatch (x (C,
B, D), y (C, B): SG-HMC's per-chain minibatches).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import batch_sum
from ..model import Model, ParamSpec, normal_logpdf


class BayesianMLP(Model):
    """y ~ Bernoulli(sigmoid(MLP(x))); 2 layers, tanh hidden."""

    # log_lik reads a per-chain minibatch (x (C, B, D)) in one call
    chain_batched_lik = True

    def __init__(self, num_features: int, hidden: int = 32, weight_scale: float = 1.0):
        self.num_features = num_features
        self.hidden = hidden
        self.weight_scale = weight_scale

    def param_spec(self):
        d, h = self.num_features, self.hidden
        return {
            "w1": ParamSpec((d, h)),
            "b1": ParamSpec((h,)),
            "w2": ParamSpec((h,)),
            "b2": ParamSpec(()),
        }

    def _prior_sds(self):
        d, h = self.num_features, self.hidden
        # float32 roundings of scale / sqrt(fan_in), as the JAX package's
        return (
            float(np.float32(self.weight_scale) / np.sqrt(np.float32(d))),
            1.0,
            float(np.float32(self.weight_scale) / np.sqrt(np.float32(h))),
            1.0,
        )

    def log_prior(self, p):
        s1, sb, s2, sb2 = self._prior_sds()
        lp = batch_sum(normal_logpdf(p["w1"], 0.0, s1))
        lp = lp + batch_sum(normal_logpdf(p["b1"], 0.0, sb))
        lp = lp + batch_sum(normal_logpdf(p["w2"], 0.0, s2))
        return lp + normal_logpdf(p["b2"], 0.0, sb2)

    def forward(self, p, x):
        """Logits: (B,) for one draw; (C, N) or (C, B) for a chain batch."""
        hidden = torch.tanh(x @ p["w1"] + p["b1"].unsqueeze(-2))
        return (hidden @ p["w2"].unsqueeze(-1)).squeeze(-1) + p["b2"].unsqueeze(-1)

    def log_lik(self, p, data):
        logits = self.forward(p, data["x"])
        y = data["y"]
        f = torch.nn.functional.logsigmoid
        return (y * f(logits) + (1.0 - y) * f(-logits)).sum(-1)


def synth_bnn_data(seed: int, n: int, num_features: int, *, hidden: int = 16,
                   logit_scale: float = 2.5):
    """Teacher-MLP synthetic binary classification data, as numpy arrays
    from a seeded generator (the JAX package's recipe; the streams
    differ): x ~ N(0, 1), teacher weights N(0, 1/fan_in), teacher logits
    standardized to sd ``logit_scale`` (Bayes accuracy ~0.85 at the
    default), y ~ Bernoulli(sigmoid(logits)).  Returns (data, teacher)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, num_features), dtype=np.float32)
    w1 = rng.standard_normal((num_features, hidden), dtype=np.float32) / np.float32(
        math.sqrt(num_features))
    w2 = rng.standard_normal(hidden, dtype=np.float32) / np.float32(math.sqrt(hidden))
    raw = np.tanh(x @ w1) @ w2
    logits = logit_scale * (raw - raw.mean()) / max(float(raw.std()), 1e-6)
    u = rng.random(n, dtype=np.float32)
    y = (u < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return {"x": x, "y": y}, {"w1": w1, "w2": w2}
