"""Robust, overdispersed and sparse regression — counterpart of
``stark_tpu/models/robust.py``.

Data: {"x": (N, D) float32, "y": (N,) float32 (counts for the negative
binomial)}.  Four models:

* `StudentTRegression`: y ~ StudentT(nu, x beta, sigma), plain autograd;
* `FusedStudentTRegression`: the same posterior, value and every
  gradient from the one-pass fused op of `ops.robust_fused` behind the
  default-off ``STARK_FUSED_ROBUST`` knob (X transposed once when the
  knob is on at prepare time; with it off, `StudentTRegression` bit for
  bit);
* `NegBinomialRegression`: overdispersed counts, log link clipped to
  [-30, 30];
* `HorseshoeRegression`: sparse linear regression under the horseshoe
  prior, non-centred.

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
from .glm import _LOG_RATE_CLIP, _rows_xT, _rows_y
from .logistic import KnobGatedFusedMixin

_LOG2 = math.log(2.0)
_LOG_PI = math.log(math.pi)
_LOG10 = math.log(10.0)


def _half_cauchy_logpdf(x, scale: float):
    """HalfCauchy(scale) log-density of x > 0 (jax.scipy's cauchy + log 2)."""
    u = x / scale
    return -(_LOG_PI + math.log(scale)) - torch.log1p(u * u) + _LOG2


def _studentt_logpdf(y, nu, mu, sigma):
    """jax.scipy.stats.t.logpdf(y, nu, mu, sigma), elementwise."""
    z = (y - mu) / sigma
    half_nu = 0.5 * nu
    norm = (torch.lgamma(half_nu) + 0.5 * torch.log(sigma * sigma * math.pi * nu)
            - torch.lgamma(half_nu + 0.5))
    return -(norm + (half_nu + 0.5) * torch.log1p(z * z / nu))


class StudentTRegression(Model):
    """y ~ StudentT(nu, x beta, sigma) — robust linear regression.

    beta ~ N(0, prior_scale); sigma ~ HalfNormal(1); nu ~ Gamma(2, rate
    0.1) (mean 20: weakly informative over near-normal to heavy tails).
    """

    shard_batched_lik = True

    def __init__(self, num_features: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.prior_scale = prior_scale

    def param_spec(self):
        return {
            "beta": ParamSpec((self.num_features,)),
            "sigma": ParamSpec((), Exp()),
            "nu": ParamSpec((), Exp()),
        }

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))
        lp = lp + normal_logpdf(p["sigma"], 0.0, 1.0) + _LOG2
        # Gamma(a=2, scale=10): (a - 1) log(nu / 10) - nu / 10 - lgamma(2) - log 10
        nu = p["nu"]
        return lp + torch.log(nu / 10.0) - nu / 10.0 - _LOG10

    def log_lik(self, p, data):
        mu = p["beta"] @ _rows_xT(data)
        y = _rows_y(mu, data["y"])
        return _studentt_logpdf(y, p["nu"][..., None], mu, p["sigma"][..., None]).sum(-1)


class FusedStudentTRegression(KnobGatedFusedMixin, StudentTRegression):
    """StudentTRegression with the one-pass fused value-and-grad
    (`ops.robust_fused.studentt_loglik`: beta, sigma and nu from one pass
    over the transposed X) behind ``STARK_FUSED_ROBUST`` (default off)."""

    _FUSED_FAMILY = "robust"

    @staticmethod
    def _fused_enabled():
        from ..ops.robust_fused import fused_robust_enabled

        return fused_robust_enabled()

    def _fused_log_lik(self, p, data):
        from ..ops.robust_fused import studentt_loglik

        from ..ops.quantize import stream_slab

        return studentt_loglik(p["beta"], p["sigma"], p["nu"], stream_slab(data), data["y"])


class NegBinomialRegression(Model):
    """y ~ NegBinomial(mean exp(x beta), concentration phi): Var = mu +
    mu^2 / phi.  beta ~ N(0, prior_scale); phi ~ HalfNormal(5).  The log
    link is clipped to [-30, 30], as PoissonRegression's, so a warmup
    excursion cannot overflow float32."""

    shard_batched_lik = True

    def __init__(self, num_features: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.prior_scale = prior_scale

    def param_spec(self):
        return {
            "beta": ParamSpec((self.num_features,)),
            "phi": ParamSpec((), Exp()),
        }

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))
        return lp + normal_logpdf(p["phi"], 0.0, 5.0) + _LOG2

    def log_lik(self, p, data):
        log_mu = torch.clamp(p["beta"] @ _rows_xT(data), -_LOG_RATE_CLIP, _LOG_RATE_CLIP)
        y = _rows_y(log_mu, data["y"])
        phi = p["phi"][..., None]
        log_phi_mu = torch.log(phi + torch.exp(log_mu))
        return (torch.lgamma(y + phi) - torch.lgamma(phi) - torch.lgamma(y + 1.0)
                + phi * (torch.log(phi) - log_phi_mu) + y * (log_mu - log_phi_mu)).sum(-1)


class HorseshoeRegression(Model):
    """Sparse linear regression under the horseshoe prior, non-centred:
    beta_j = z_j lambda_j tau with z ~ N(0, 1), lambda_j ~ HalfCauchy(1),
    tau ~ HalfCauchy(tau0); y ~ N(x beta, sigma), sigma ~ HalfNormal(1).
    The (z, lambda, tau) form takes the funnel out of the geometry so a
    diagonal mass matrix can adapt to it."""

    shard_batched_lik = True

    def __init__(self, num_features: int, tau0: float = 0.1):
        self.num_features = num_features
        self.tau0 = tau0

    def param_spec(self):
        d = self.num_features
        return {
            "z": ParamSpec((d,)),
            "lam": ParamSpec((d,), Exp()),
            "tau": ParamSpec((), Exp()),
            "sigma": ParamSpec((), Exp()),
        }

    def beta(self, p):
        """The coefficients z * lambda * tau, per chain (or of one draw)."""
        return p["z"] * p["lam"] * p["tau"][..., None]

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["z"]))
        lp = lp + batch_sum(_half_cauchy_logpdf(p["lam"], 1.0))
        lp = lp + _half_cauchy_logpdf(p["tau"], self.tau0)
        return lp + normal_logpdf(p["sigma"], 0.0, 1.0) + _LOG2

    def log_lik(self, p, data):
        mu = self.beta(p) @ _rows_xT(data)
        y = _rows_y(mu, data["y"])
        return normal_logpdf(y, mu, p["sigma"][..., None]).sum(-1)


def synth_studentt_data(seed: int, n: int, d: int, *, nu: float = 4.0, noise: float = 0.5):
    """Synthetic robust-regression dataset (+ the true parameters), as
    numpy arrays from a seeded generator: x ~ N(0, 1), beta ~ N(0, 1),
    y = x beta + noise * StudentT(nu).  The same recipe as the JAX
    package's; the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, d), dtype=f32)
    beta = rng.standard_normal(d, dtype=f32)
    y = (x @ beta + f32(noise) * rng.standard_t(nu, n).astype(f32)).astype(f32)
    return {"x": x, "y": y}, {"beta": beta, "nu": nu}


def synth_negbinom_data(seed: int, n: int, d: int, *, phi: float = 2.0):
    """Synthetic negative-binomial dataset (+ the true parameters): x ~
    0.3 N(0, 1), beta ~ N(0, 1), mu = exp(clip(x beta, -10, 10)), y ~
    Poisson(mu * Gamma(phi, 1) / phi) (the gamma-Poisson mixture).  The
    same recipe as the JAX package's; the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (f32(0.3) * rng.standard_normal((n, d), dtype=f32)).astype(f32)
    beta = rng.standard_normal(d, dtype=f32)
    mu = np.exp(np.clip(x @ beta, -10.0, 10.0))
    rate = mu * rng.gamma(phi, 1.0, n) / phi
    y = rng.poisson(rate).astype(f32)
    return {"x": x, "y": y}, {"beta": beta, "phi": phi}


def synth_horseshoe_data(seed: int, n: int, d: int, *, num_nonzero: int = 5,
                         noise: float = 0.5):
    """Synthetic sparse-regression dataset (+ the true parameters): the
    first ``num_nonzero`` coefficients +-2 (fair signs), the rest exactly
    0; x ~ N(0, 1), y = x beta + noise * N(0, 1).  The same recipe as
    the JAX package's; the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, d), dtype=f32)
    beta = np.zeros(d, f32)
    beta[:num_nonzero] = np.where(rng.random(num_nonzero) < 0.5, 2.0, -2.0)
    y = (x @ beta + f32(noise) * rng.standard_normal(n, dtype=f32)).astype(f32)
    return {"x": x, "y": y}, {"beta": beta}
