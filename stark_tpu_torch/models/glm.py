"""Bayesian linear and Poisson regression — counterpart of
``stark_tpu/models/glm.py``.

Data: {"x": (N, D) float32, "y": (N,) float32 (counts for Poisson)}.
Four models, two posteriors:

* `LinearRegression`: y ~ N(x beta, sigma), plain PyTorch autograd;
* `FusedLinearRegression`: X transposed once, value and gradient from
  kernel B2's gaussian link without offsets, one launch per evaluation;
* `PoissonRegression`: y ~ Poisson(exp(clip(x beta, -30, 30))), plain
  autograd;
* `FusedPoissonRegression`: X transposed once, value and gradient from
  the one-pass fused op of `ops.glm_fused` (plain PyTorch, as the
  reference's is XLA's) behind ``STARK_FUSED_GLM`` (default on; ``0``
  takes autograd on the same transposed layout).

Each evaluates a chain batch and a shard batch (parameters (S, C, ...)
against data split into S row blocks, `Model.shard_batched_lik`).
Parameters carry a leading chain axis (see `model.Model`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import Exp, batch_sum
from ..model import Model, ParamSpec, normal_logpdf
from ..ops.quantize import dequant_rows, stream_slab
from .logistic import TransposedXMixin, _fold_scale

_LOG2 = math.log(2.0)
#: clip bound of the log-link rate (ops.glm_fused.LOG_RATE_CLIP)
_LOG_RATE_CLIP = 30.0


def _rows_y(eta, y):
    """y against a predictor (C, N), or (S, C, n) against y (S, n)."""
    return y.unsqueeze(-2) if eta.ndim == 3 else y


def _rows_xT(data):
    """X transposed, (D, N) or (S, D, n), float32, from either layout: the
    cold path of the autograd likelihoods, which widens a bf16 slab and
    dequantizes a packed one (`quantize.dequant_rows`)."""
    if "xT" not in data:
        return data["x"].transpose(-1, -2)
    return dequant_rows(data).transpose(-1, -2)


class LinearRegression(Model):
    """y ~ N(x beta, sigma); beta ~ N(0, prior_scale), sigma ~ HalfNormal(1)."""

    shard_batched_lik = True

    def __init__(self, num_features: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.prior_scale = prior_scale

    def param_spec(self):
        return {
            "beta": ParamSpec((self.num_features,)),
            "sigma": ParamSpec((), Exp()),
        }

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))
        return lp + normal_logpdf(p["sigma"], 0.0, 1.0) + _LOG2

    def log_lik(self, p, data):
        mu = p["beta"] @ _rows_xT(data)
        y = _rows_y(mu, data["y"])
        return normal_logpdf(y, mu, p["sigma"][..., None]).sum(-1)


class FusedLinearRegression(TransposedXMixin, LinearRegression):
    """LinearRegression with value and gradient from kernel B2's gaussian
    link in one pass over the transposed X, without the offset stream."""

    def fused_tag(self):
        return "gaussian"

    def log_lik(self, p, data):
        from ..ops.logistic_fused import gaussian_loglik

        return gaussian_loglik(_fold_scale(p["beta"], data), data["xT"], data["y"], p["sigma"])


def _poisson_rows_loglik(eta, y):
    log_rate = torch.clamp(eta, -_LOG_RATE_CLIP, _LOG_RATE_CLIP)
    y = _rows_y(eta, y)
    return (y * log_rate - torch.exp(log_rate) - torch.lgamma(y + 1.0)).sum(-1)


class PoissonRegression(Model):
    """y ~ Poisson(exp(x beta)); beta ~ N(0, prior_scale).  The log-rate
    is clipped to [-30, 30] before the exp, so a warmup excursion cannot
    overflow float32 (an inf rate would freeze the chain)."""

    shard_batched_lik = True

    def __init__(self, num_features: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.prior_scale = prior_scale

    def param_spec(self):
        return {"beta": ParamSpec((self.num_features,))}

    def log_prior(self, p):
        return batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))

    def log_lik(self, p, data):
        return _poisson_rows_loglik(p["beta"] @ _rows_xT(data), data["y"])


class FusedPoissonRegression(TransposedXMixin, PoissonRegression):
    """PoissonRegression with value and beta-gradient from one pass over
    the transposed X (`ops.glm_fused.poisson_loglik`).  With
    ``STARK_FUSED_GLM=0`` it takes autograd on the same transposed
    layout, so the knob flips the path without preparing the data again;
    the knob is read at every evaluation."""

    def fused_tag(self):
        from ..ops.glm_fused import fused_glm_enabled

        return "glm" if fused_glm_enabled() else None

    def log_lik(self, p, data):
        from ..ops.glm_fused import fused_glm_enabled, poisson_loglik

        if not fused_glm_enabled():
            return super().log_lik(p, data)
        return poisson_loglik(p["beta"], stream_slab(data), data["y"])


def synth_linreg_data(seed: int, n: int, d: int, *, noise: float = 0.5):
    """Synthetic linear-regression dataset (+ the true parameters), as
    numpy arrays from a seeded generator: x ~ N(0, 1), beta ~ N(0, 1),
    y = x beta + noise * N(0, 1).  The same recipe as the JAX package's;
    the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, d), dtype=f32)
    beta = rng.standard_normal(d, dtype=f32)
    y = (x @ beta + f32(noise) * rng.standard_normal(n, dtype=f32)).astype(f32)
    return {"x": x, "y": y}, {"beta": beta, "sigma": noise}


def synth_poisson_data(seed: int, n: int, d: int):
    """Synthetic Poisson-regression dataset (+ the true parameters), as
    numpy arrays from a seeded generator: x ~ N(0, 1), beta ~ 0.3 N(0,
    1), y ~ Poisson(exp(x beta)).  The same recipe as the JAX package's;
    the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, d), dtype=f32)
    beta = (f32(0.3) * rng.standard_normal(d, dtype=f32)).astype(f32)
    y = rng.poisson(np.exp(x @ beta)).astype(f32)
    return {"x": x, "y": y}, {"beta": beta}
