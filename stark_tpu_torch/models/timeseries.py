"""Latent time series: stochastic volatility — counterpart of
``stark_tpu/models/timeseries.py``.

Data: {"y": (T,) float32 returns}.  The classic HMC stress test, a
T-dimensional correlated latent field.  The AR(1) latent log-volatility
path is built from non-centred innovations by a log-depth parallel
prefix over (C, T) (`_ar1_path`): log2 T rounds of whole-tensor
operations, not a T-step loop, which would launch T times per
evaluation on the card.  Rows are time steps, so they cannot be
minibatched or split into sub-posteriors; the mesh's time-block path
goes with multi-GPU (ROADMAP A11).  Chain parallelism always applies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import Exp, Interval, batch_sum
from ..model import Model, ParamSpec, normal_logpdf

_LOG2 = math.log(2.0)


def _ar1_path(phi, eps):
    """h_t = phi h_{t-1} + eps_t (h_{-1} = 0) along the last axis: phi
    (...) against eps (..., T).  A Hillis-Steele inclusive scan of the
    affine maps (a, b) under the reference's associative combine (a1,
    b1) then (a2, b2) = (a1 a2, b1 a2 + b2): round k adds to each step
    the one 2^k before it times a_k, which is phi^(2^k) for every step
    it touches (the first 2^k steps take the identity, b + 0), so a is
    one squared number per chain, not a scanned tensor."""
    b, a = eps, phi[..., None]
    t, shift = eps.shape[-1], 1
    while shift < t:
        b_prev = torch.cat([b.new_zeros(eps.shape[:-1] + (shift,)), b[..., :-shift]], -1)
        b = b_prev * a + b
        a = a * a
        shift *= 2
    return b


class StochasticVolatility(Model):
    """y_t ~ N(0, exp(h_t / 2)); h_t = mu + phi (h_{t-1} - mu) + sigma_h e_t.

    Non-centred: the parameters are the innovations e (T,), mu, phi and
    sigma_h.  phi rides an Interval(-1, 1) bijector (stationary by
    construction); the first state is drawn from the stationary
    distribution.  Priors: e ~ N(0, 1), mu ~ N(0, 5), phi ~ 2 Beta(20,
    1.5) - 1 (the Stan manual's, up to a constant), sigma_h ~
    HalfNormal(1).
    """

    def __init__(self, num_steps: int):
        self.num_steps = num_steps

    def param_spec(self):
        return {
            "eps": ParamSpec((self.num_steps,)),
            "mu": ParamSpec(()),
            "phi": ParamSpec((), Interval(-1.0, 1.0)),
            "sigma_h": ParamSpec((), Exp()),
        }

    def data_row_axes(self, data):
        raise NotImplementedError(
            "StochasticVolatility's likelihood couples every y_t through "
            "the latent AR(1) path: rows cannot be minibatched or split "
            "into independent sub-posteriors (SG-HMC, consensus) — a "
            "minibatch cannot know WHICH time steps it holds.  MESH "
            "data-axis sharding IS supported (ShardedBackend): "
            "log_lik_sharded aligns each contiguous y block with its "
            "slice of the latent path.  Chain parallelism always applies."
        )

    def log_prior(self, p):
        phi = p["phi"]
        lp = batch_sum(normal_logpdf(p["eps"]))
        lp = lp + normal_logpdf(p["mu"], 0.0, 5.0)
        lp = lp + 19.0 * torch.log1p(phi) + 0.5 * torch.log1p(-phi)
        return lp + normal_logpdf(p["sigma_h"], 0.0, 1.0) + _LOG2

    def latent_h(self, p):
        """The latent log-volatility path, (C, T) per chain or (T,) of
        one draw."""
        phi, eps = p["phi"], p["eps"]
        # stationary start: the first innovation scaled to sd 1/sqrt(1 - phi^2)
        boost = 1.0 / torch.sqrt(torch.clamp(1.0 - phi * phi, min=1e-6))
        scaled = torch.cat([eps[..., :1] * boost[..., None], eps[..., 1:]], -1)
        return p["mu"][..., None] + p["sigma_h"][..., None] * _ar1_path(phi, scaled)

    def log_lik(self, p, data):
        h = self.latent_h(p)
        return normal_logpdf(data["y"], 0.0, torch.exp(h / 2.0)).sum(-1)


def synth_sv_data(seed: int, num_steps: int, *, mu: float = -1.0, phi: float = 0.95,
                  sigma_h: float = 0.25):
    """Synthetic returns (+ the true parameters and path), as numpy arrays
    from a seeded generator: innovations e ~ N(0, 1), the first scaled to
    the stationary sd, h = mu + sigma_h * AR1(phi, e) (a sequential pass
    in float64), y_t = exp(h_t / 2) N(0, 1).  The same recipe as the JAX
    package's; the streams differ."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(num_steps)
    eps[0] /= np.sqrt(1.0 - phi**2)
    path = np.empty(num_steps)
    acc = 0.0
    for i, e in enumerate(eps):
        acc = phi * acc + e
        path[i] = acc
    h = (mu + sigma_h * path).astype(np.float32)
    y = (np.exp(h / 2.0) * rng.standard_normal(num_steps)).astype(np.float32)
    return {"y": y}, {"mu": mu, "phi": phi, "sigma_h": sigma_h, "h": h}
