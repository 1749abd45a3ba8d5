"""Gaussian mixture model — BASELINE config 4, counterpart of
``stark_tpu/models/gmm.py``.

A 1-D K-component mixture, reparameterized so the kernels see one
unconstrained vector: simplex weights through `StickBreaking`, ordered
component means through `Ordered` (which breaks label switching) and
positive component sds through `Exp`.  The per-row likelihood is an
(R, N, K) logsumexp over the components for a leading chain or replica
axis R, plain PyTorch (the JAX package leaves it to XLA, outside any
Pallas kernel).  Multimodality is what parallel tempering
(`parallel.tempering`) is for; this model is its pairing in config 4.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import Exp, Ordered, StickBreaking
from ..model import Model, ParamSpec, normal_logpdf


class GaussianMixture(Model):
    """1-D K-component GMM with ordered means.

    params: weights (K-simplex), mu (K, ordered ascending), sigma (K, >0),
    each with a leading chain axis.  data: {"x": (N,)}.
    """

    def __init__(self, num_components: int, mu_scale: float = 10.0,
                 dirichlet_alpha: float = 1.0):
        self.num_components = num_components
        self.mu_scale = mu_scale
        self.dirichlet_alpha = dirichlet_alpha

    def param_spec(self):
        k = self.num_components
        return {
            "weights": ParamSpec((k,), StickBreaking()),
            "mu": ParamSpec((k,), Ordered()),
            "sigma": ParamSpec((k,), Exp()),
        }

    def log_prior(self, p):
        a = self.dirichlet_alpha
        # Dirichlet(a, ..., a) up to its (constant) normalizer
        lp = ((a - 1.0) * torch.log(torch.clamp(p["weights"], min=1e-30))).sum(-1)
        lp = lp + normal_logpdf(p["mu"], 0.0, self.mu_scale).sum(-1)
        # half-normal(0, 2) on the component sds
        return lp + (normal_logpdf(p["sigma"], 0.0, 2.0) + math.log(2.0)).sum(-1)

    def log_lik(self, p, data):
        return self.log_lik_rows(p, data).sum(-1)

    def log_lik_rows(self, p, data):
        """(R, N): each row's log-density under each chain's mixture."""
        x = data["x"][:, None]  # (N, 1)
        comp = normal_logpdf(x, p["mu"][..., None, :], p["sigma"][..., None, :])  # (R, N, K)
        log_w = torch.log(torch.clamp(p["weights"], min=1e-30))[..., None, :]
        return torch.logsumexp(comp + log_w, dim=-1)


def gmm_init_1d(x, num_components, *, restarts=8, iters=60, subsample=5000, seed=0):
    """Data-driven constrained init for 1-D mixtures: best-of-restarts EM
    (the JAX package's host numpy, kept here so the port does not import
    it; the same input and seed give the same bits).

    Equal-mass quantile inits lose light components when the true weights
    are uneven, and which component gets lost varies per chain, so R-hat
    then diverges on a mis-allocation mode, not on sampling error.  A
    handful of short EM runs from jittered quantile seeds (best
    log-likelihood wins) resolves the allocation before the kernel ever
    runs; the centers are sorted so the `Ordered` bijector accepts them.
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64).ravel()
    if x.size > subsample:
        x = rng.choice(x, subsample, replace=False)
    n, k = x.size, num_components
    span = x.max() - x.min() + 1e-9
    base_mu = np.quantile(x, (np.arange(k) + 0.5) / k)

    def kmeanspp_seeds():
        # distance^2-weighted seeding reaches light components that
        # equal-mass quantile seeds skip
        seeds = [rng.choice(x)]
        for _ in range(k - 1):
            d2 = np.min((x[:, None] - np.asarray(seeds)[None, :]) ** 2, axis=1)
            seeds.append(rng.choice(x, p=d2 / d2.sum()))
        return np.sort(np.asarray(seeds))

    best = None
    for r in range(restarts):
        mu = base_mu if r == 0 else kmeanspp_seeds()
        w = np.full(k, 1.0 / k)
        var = np.full(k, (span / (4 * k)) ** 2)
        ll = -np.inf
        for _ in range(iters):
            # E-step in log space; guard tiny variances
            var = np.maximum(var, 1e-8)
            logp = (
                np.log(w)[None, :]
                - 0.5 * np.log(2 * np.pi * var)[None, :]
                - 0.5 * (x[:, None] - mu[None, :]) ** 2 / var[None, :]
            )
            m = logp.max(axis=1, keepdims=True)
            p = np.exp(logp - m)
            tot = p.sum(axis=1, keepdims=True)
            ll = float((m.ravel() + np.log(tot.ravel())).sum())
            resp = p / tot  # (n, k)
            nk = np.maximum(resp.sum(axis=0), 1e-6)
            w = nk / n
            mu = (resp * x[:, None]).sum(axis=0) / nk
            var = (resp * (x[:, None] - mu[None, :]) ** 2).sum(axis=0) / nk
        if best is None or ll > best[0]:
            best = (ll, w, mu, np.sqrt(var))

    _, w, mu, sigma = best
    order = np.argsort(mu)
    eps = 1e-3 * span / k
    mu = np.maximum.accumulate(mu[order] + eps * np.arange(k))
    return {
        "weights": (w[order] / w.sum()).astype(np.float32),
        "mu": mu.astype(np.float32),
        "sigma": np.clip(sigma[order], 0.05, None).astype(np.float32),
    }


def synth_gmm_data(seed: int, n: int, num_components: int, *, spread: float = 6.0):
    """A well-separated synthetic mixture and its generating parameters,
    as float32 numpy arrays drawn from a seeded ``torch.Generator`` (the
    JAX package's recipe; the streams differ): means ``spread * arange(K)``
    centred on 0, sds uniform in [0.5, 1.0), Dirichlet(5, ..., 5) weights
    (each a normalized Gamma(5) draw, the sum of five unit exponentials),
    a component per row from the weights, then the row from it.
    Returns (data, truth)."""
    k = num_components
    g = torch.Generator().manual_seed(seed)
    mu = spread * torch.arange(k, dtype=torch.float32)
    mu = mu - mu.mean()
    sigma = 0.5 + 0.5 * torch.rand(k, generator=g)
    gam = -torch.log(1.0 - torch.rand((k, 5), generator=g, dtype=torch.float64)).sum(-1)
    w = gam / gam.sum()
    comp = torch.multinomial(w, n, replacement=True, generator=g)
    x = mu[comp] + sigma[comp] * torch.randn(n, generator=g)
    return {"x": x.numpy()}, {
        "weights": w.to(torch.float32).numpy(), "mu": mu.numpy(), "sigma": sigma.numpy(),
    }
