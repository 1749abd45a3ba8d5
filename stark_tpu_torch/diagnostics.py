"""Convergence diagnostics on collected draws — counterpart of the
post-hoc half of ``stark_tpu/diagnostics.py``.

Host-side numpy in float64 on (chains, draws, *event) arrays: split
R-hat, rank-normalised R-hat (bulk and folded), Geyer ESS (plain, bulk
and tail) and the MCSE of the mean.  The streaming sufficient-statistic
forms serve the adaptive runner and arrive with it (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws, ...) -> (2*chains, draws//2, ...)."""
    c, n = x.shape[0], x.shape[1]
    half = n // 2
    x = x[:, : 2 * half]
    return x.reshape(c, 2, half, *x.shape[2:]).reshape(c * 2, half, *x.shape[2:])


def split_rhat(x) -> np.ndarray:
    """Split-R-hat over (chains, draws, *event). Returns (*event,)."""
    x = np.asarray(x, np.float64)
    x = _split_chains(x)
    m, n = x.shape[0], x.shape[1]
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    between = n * chain_mean.var(axis=0, ddof=1)
    within = chain_var.mean(axis=0)
    var_plus = (n - 1) / n * within + between / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / within)
    return rhat


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Autocovariance along axis 1 for (chains, draws, ...)."""
    n = x.shape[1]
    x = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n]
    return acov / n


# FFT workspace cap for ess() column chunking
_ESS_WORKSPACE_BYTES = 256e6


def _ess_chunk(x: np.ndarray) -> np.ndarray:
    """ESS for split chains (m, n, cols) — fully vectorized over cols."""
    m, n = x.shape[0], x.shape[1]
    acov = _autocov_fft(x)  # (m, n, cols)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean(axis=0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + x.mean(axis=1).var(axis=0, ddof=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus  # (n, cols)
    rho[0] = 1.0
    # Geyer initial positive + monotone sequence over lag pairs:
    #   Gamma_t = rho[2t] + rho[2t+1]; keep the prefix with Gamma_t >= 0,
    #   then enforce monotone non-increase (running min); tau = -1 + 2*sum
    max_pairs = n // 2
    pair = rho[0 : 2 * max_pairs : 2] + rho[1 : 2 * max_pairs : 2]
    valid = np.cumprod(pair >= 0.0, axis=0).astype(bool)
    mono = np.minimum.accumulate(np.where(valid, pair, np.inf), axis=0)
    tau = -1.0 + 2.0 * np.sum(np.where(valid, mono, 0.0), axis=0)
    tau = np.maximum(tau, 1.0 / np.log10(m * n + 10.0))
    out = m * n / tau
    # zero-variance / non-finite components have no defined ESS — NaN, so a
    # stuck parameter fails (not passes) an `ess > target` gate.  Detect
    # constancy via max==min per (chain, component) — exact even when the
    # FFT's mean-subtraction leaves rounding noise on constant data
    const = np.all(x.max(axis=1) == x.min(axis=1), axis=0)
    out[const | ~np.isfinite(var_plus) | (var_plus <= 0.0)] = np.nan
    return out


def ess(x) -> np.ndarray:
    """Effective sample size over (chains, draws, *event), Geyer-truncated.

    Plain (mean-estimand) ESS on split chains; returns (*event,).
    Vectorized over components, processed in column chunks so the FFT
    workspace stays bounded at LMM scale (d ~ 20k+ parameters).
    """
    x = np.asarray(x, np.float64)
    x = _split_chains(x)
    m, n = x.shape[0], x.shape[1]
    event_shape = x.shape[2:]
    x_flat = x.reshape(m, n, -1)
    cols = x_flat.shape[2]
    # complex128 FFT workspace is m * padded_n * chunk * 16B
    size = 2 ** int(np.ceil(np.log2(2 * max(n, 1))))
    chunk = max(1, int(_ESS_WORKSPACE_BYTES / (m * size * 16)))
    out = np.empty(cols)
    for lo in range(0, cols, chunk):
        out[lo : lo + chunk] = _ess_chunk(x_flat[:, :, lo : lo + chunk])
    return out.reshape(event_shape) if event_shape else out[0]


def rank_normalize(x: np.ndarray) -> np.ndarray:
    """Pooled fractional ranks -> normal scores (Vehtari et al. 2021 eq. 14).

    (chains, draws, *event) -> same shape; ranks pool over chains*draws
    per scalar component with average tie-handling, then map through the
    normal quantile function with the (r - 3/8)/(S + 1/4) continuity
    correction.  Makes every rank-based diagnostic invariant to monotone
    transforms and robust to heavy tails.  Components are processed in
    column chunks bounded by the same workspace budget as ``ess`` — the
    ranking scratch would otherwise hold several full float64 copies of
    a d≈20k flagship draw matrix at once.
    """
    from scipy.special import ndtri
    from scipy.stats import rankdata

    x = np.asarray(x, np.float64)
    c, n = x.shape[0], x.shape[1]
    flat = x.reshape(c * n, -1)
    rows = flat.shape[0]
    cols_per_chunk = max(1, int(_ESS_WORKSPACE_BYTES) // (8 * 4 * max(rows, 1)))
    z = np.empty_like(flat)
    for j0 in range(0, flat.shape[1], cols_per_chunk):
        sl = slice(j0, j0 + cols_per_chunk)
        r = rankdata(flat[:, sl], method="average", axis=0)
        z[:, sl] = ndtri((r - 0.375) / (c * n + 0.25))
    return z.reshape(x.shape)


def rank_rhat(x, z_bulk=None) -> np.ndarray:
    """Rank-normalized split-R-hat, the max of the bulk and tail (folded)
    forms — Stan's modern default.  Catches both location disagreements
    (bulk) and scale/tail disagreements (folded) that classic split-R-hat
    on heavy-tailed draws can miss.  (chains, draws, *event) -> (*event,).
    ``z_bulk`` lets a caller that already rank-normalized x (summarize)
    skip that pass.
    """
    x = np.asarray(x, np.float64)
    bulk = split_rhat(rank_normalize(x) if z_bulk is None else z_bulk)
    med = np.median(x.reshape(-1, *x.shape[2:]), axis=0)
    folded = split_rhat(rank_normalize(np.abs(x - med)))
    return np.maximum(bulk, folded)


def ess_bulk(x) -> np.ndarray:
    """Bulk ESS: Geyer ESS of the rank-normalized draws."""
    return ess(rank_normalize(x))


def ess_tail(x, prob: float = 0.05) -> np.ndarray:
    """Tail ESS: min ESS of the two tail-indicator chains (I[x<=q05],
    I[x>=q95]) — the reliability of reported tail quantiles, which bulk
    ESS says nothing about."""
    x = np.asarray(x, np.float64)
    flat = x.reshape(-1, *x.shape[2:])
    qlo = np.quantile(flat, prob, axis=0)
    qhi = np.quantile(flat, 1.0 - prob, axis=0)
    lo = ess((x <= qlo).astype(np.float64))
    hi = ess((x >= qhi).astype(np.float64))
    return np.minimum(lo, hi)


def mcse_mean(x) -> np.ndarray:
    """Monte-Carlo standard error of the posterior mean: sd/sqrt(ESS)."""
    x = np.asarray(x, np.float64)
    flat = x.reshape(-1, *x.shape[2:])
    e = ess(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        return flat.std(axis=0, ddof=1) / np.sqrt(e)


def summarize(draws: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-parameter posterior summary: mean, sd, mcse, 5%/50%/95%,
    classic + rank-normalized R-hat, classic/bulk/tail ESS ("ess" is the
    classic Geyer estimator on the raw draws; "ess_bulk" the Stan-style
    rank-normalized form)."""
    out = {}
    for name, x in draws.items():
        x = np.asarray(x)
        flat = x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
        sd = flat.std(axis=0, ddof=1)
        e = ess(x)  # computed ONCE; mcse derives from it
        z_bulk = rank_normalize(x)  # shared by rank_rhat and ess_bulk
        with np.errstate(divide="ignore", invalid="ignore"):
            mcse = sd / np.sqrt(e)
        out[name] = {
            "mean": flat.mean(axis=0),
            "sd": sd,
            "mcse_mean": mcse,
            "q5": np.quantile(flat, 0.05, axis=0),
            "median": np.quantile(flat, 0.5, axis=0),
            "q95": np.quantile(flat, 0.95, axis=0),
            "rhat": split_rhat(x),
            "rank_rhat": rank_rhat(x, z_bulk=z_bulk),
            "ess": e,
            "ess_bulk": ess(z_bulk),
            "ess_tail": ess_tail(x),
        }
    return out

