"""Convergence diagnostics on collected draws — counterpart of the
post-hoc half of ``stark_tpu/diagnostics.py``.

Host-side numpy in float64 on (chains, draws, *event) arrays: split
R-hat, rank-normalised R-hat (bulk and folded), Geyer ESS (plain, bulk
and tail) and the MCSE of the mean; and the streaming half that the
adaptive runner's stop gate reads: per-chain Welford moments
(`ChainSuffStats`, `rhat_from_suffstats`), the ESS from the on-device
accumulator (`ess_from_suffstats`; `stream_diag_from_draws` is its host
rebuild) and the growing draw buffer of the validation pass
(`DrawHistory`).
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


def rhat_from_suffstats(count, mean, m2):
    """R-hat from per-chain Welford stats; shapes (chains, ...) -> (...).

    Host numpy in float64 (no float32 downcast near the 1.01 threshold).
    Uses the non-split form — chains are assumed independently
    initialized, and the streaming path is only used for early stopping,
    with the final reported R-hat always recomputed split from draws.
    """
    mean = np.asarray(mean, np.float64)
    n = np.asarray(count).astype(mean.dtype)
    if n.ndim < mean.ndim:
        n = n.reshape(n.shape + (1,) * (mean.ndim - n.ndim))
    # errstate: a frozen component (within == 0) yields a quiet NaN, as in
    # split_rhat — not a RuntimeWarning per block
    with np.errstate(divide="ignore", invalid="ignore"):
        chain_var = m2 / (n - 1.0)
        within = chain_var.mean(axis=0)
        between = n.mean(axis=0) * np.var(mean, axis=0, ddof=1)
        n_mean = n.mean(axis=0)
        var_plus = (n_mean - 1.0) / n_mean * within + between / n_mean
        return np.sqrt(var_plus / within)


class ChainSuffStats:
    """Per-chain running Welford moments (count, mean, M2) on the host.

    Updated from each draw block in O(chains*d), so the adaptive runner's
    per-block convergence signal never rescans the accumulated history.
    Merging uses Chan's parallel-combine, so feeding one big block or many
    small ones yields identical statistics.
    """

    def __init__(self, chains: int, ndim: int):
        self.count = np.zeros((chains,), np.int64)
        self.mean = np.zeros((chains, ndim))
        self.m2 = np.zeros((chains, ndim))

    def update(self, block: np.ndarray) -> None:
        """Merge a (chains, block_draws, d) block into the accumulator."""
        block = np.asarray(block, np.float64)
        bc = block.shape[1]
        if bc == 0:
            return
        bmean = block.mean(axis=1)
        bm2 = ((block - bmean[:, None, :]) ** 2).sum(axis=1)
        n = self.count[:, None].astype(np.float64)
        tot = n + bc
        delta = bmean - self.mean
        self.mean += delta * bc / tot
        self.m2 += bm2 + delta * delta * n * bc / tot
        self.count += bc

    def rhat(self) -> np.ndarray:
        """Streaming (non-split) R-hat per component, numpy float64."""
        return np.asarray(
            rhat_from_suffstats(self.count, self.mean, self.m2)
        )


def stream_diag_from_draws(draws, lags: int, chains=None, ndim=None,
                           dtype=np.float32):
    """Host (numpy) rebuild of the on-device streaming accumulator
    (`kernels.base.StreamDiagState`) from a (chains, n, d) draw history.

    Two jobs: (1) the resume path reconstructs the device carry from the
    stored draws, (2) tests hold the device update and this reference to the
    same math.  Returns a dict with the device state's field names, every
    leaf batched over a leading chains axis (the layout the batched
    update carries); sums accumulate in the device dtype so the rebuilt
    state tracks an uninterrupted device run to roundoff.
    """
    draws = np.asarray(draws)
    if draws.ndim != 3:
        raise ValueError(f"expected (chains, n, d) draws, got {draws.shape}")
    c, n, d = draws.shape
    chains = c if chains is None else int(chains)
    ndim = d if ndim is None else int(ndim)
    if n and (c != chains or d != ndim):
        raise ValueError(
            f"draws {draws.shape} != (chains={chains}, n, d={ndim})"
        )
    out = {
        "n": np.full((chains,), n, np.int32),
        "anchor": np.zeros((chains, ndim), dtype),
        "s1": np.zeros((chains, ndim), dtype),
        "s2": np.zeros((chains, ndim), dtype),
        "cross": np.zeros((chains, lags, ndim), dtype),
        "ring": np.zeros((chains, lags, ndim), dtype),
        "head": np.zeros((chains, lags, ndim), dtype),
    }
    if n == 0:
        return out
    anchor = draws[:, 0].astype(dtype)
    y = (draws.astype(dtype) - anchor[:, None, :]).astype(dtype)
    out["anchor"] = anchor
    out["s1"] = y.sum(axis=1, dtype=dtype)
    out["s2"] = (y * y).sum(axis=1, dtype=dtype)
    k = min(lags, n)
    for li in range(min(lags, n - 1)):
        lag = li + 1
        out["cross"][:, li] = (y[:, lag:] * y[:, :-lag]).sum(
            axis=1, dtype=dtype
        )
    # ring: last k draws, most recent first; head: first k draws in order
    out["ring"][:, :k] = y[:, n - k:][:, ::-1]
    out["head"][:, :k] = y[:, :k]
    return out


def ess_from_suffstats(n, anchor, s1, s2, cross, ring, head) -> np.ndarray:
    """Geyer initial-positive-sequence ESS LOWER BOUND from the streaming
    accumulators (`kernels.base.StreamDiagState`, leaves batched over a
    leading chains axis) — the adaptive runner's O(chains*d*L) convergence
    signal, replacing the full-history FFT pass in the hot loop.

    Bias direction: the accumulator truncates the autocovariance at lag L.
    When the Geyer initial-positive pair sequence terminates WITHIN the
    tracked lags, the estimate matches the (non-split) full estimator on
    those lags; when it is still positive at the last tracked pair — the
    chain mixes slower than L lags can resolve — the tail is extended with
    a geometric bound fitted to the last two monotone pairs (rate clipped
    below 1), which over- rather than under-estimates tau, so the returned
    ESS errs LOW and the gate waits instead of stopping early.  Every
    candidate stop is still validated by the full split-form pass
    (runner.py), so this estimator only decides *when to look*.

    Returns (d,) float64; NaN for frozen components (no defined ESS, so a
    stuck parameter fails an ``ess > target`` gate — same convention as
    ``ess``).
    """
    n = np.asarray(n)
    count = int(n.max()) if n.size else 0
    if n.size and count != int(n.min()):
        raise ValueError(f"ragged per-chain counts: {n}")
    anchor = np.asarray(anchor, np.float64)
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    cross = np.asarray(cross, np.float64)
    ring = np.asarray(ring, np.float64)
    head = np.asarray(head, np.float64)
    c, lags, d = cross.shape
    if count < 4:
        return np.full((d,), np.nan)
    # per-chain centered moments -> per-chain autocovariance at lags 0..L
    mean_c = s1 / count  # centered chain mean, (c, d)
    gamma0 = (s2 - count * mean_c**2) / count
    l_eff = min(lags, count - 1)
    ls = np.arange(1, l_eff + 1)[None, :, None]  # (1, L_eff, 1)
    # sums over the lagged/leading windows from the boundary buffers:
    #   sum_{t=l+1..n} y_{t-l} = s1 - (last l draws)   (ring, newest first)
    #   sum_{t=l+1..n} y_t     = s1 - (first l draws)  (head, in order)
    s_head = s1[:, None, :] - np.cumsum(ring[:, :l_eff], axis=1)
    s_tail = s1[:, None, :] - np.cumsum(head[:, :l_eff], axis=1)
    gamma = (
        cross[:, :l_eff]
        - mean_c[:, None, :] * (s_head + s_tail)
        + (count - ls) * mean_c[:, None, :] ** 2
    ) / count  # (c, L_eff, d)
    # cross-chain combine — the non-split analogue of _ess_chunk
    chain_var = gamma0 * count / (count - 1.0)
    mean_var = chain_var.mean(axis=0)  # (d,)
    var_plus = mean_var * (count - 1.0) / count
    if c > 1:
        var_plus = var_plus + (anchor + mean_c).var(axis=0, ddof=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (mean_var[None] - gamma.mean(axis=0)) / var_plus[None]
    rho = np.concatenate([np.ones((1, d)), rho], axis=0)  # lag 0
    max_pairs = (l_eff + 1) // 2
    pair = rho[0 : 2 * max_pairs : 2] + rho[1 : 2 * max_pairs : 2]
    valid = np.cumprod(pair >= 0.0, axis=0).astype(bool)
    mono = np.minimum.accumulate(np.where(valid, pair, np.inf), axis=0)
    tau = -1.0 + 2.0 * np.sum(np.where(valid, mono, 0.0), axis=0)
    # unterminated sequence: conservative geometric tail extension
    if max_pairs >= 2:
        unterminated = valid.all(axis=0)
        g_last, g_prev = mono[-1], mono[-2]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(g_prev > 0, g_last / g_prev, 0.0)
        r = np.clip(r, 0.0, 0.995)
        tail = np.where(unterminated, g_last * r / (1.0 - r), 0.0)
        tau = tau + 2.0 * np.where(np.isfinite(tail), tail, 0.0)
    tau = np.maximum(tau, 1.0 / np.log10(c * count + 10.0))
    out = c * count / tau
    # frozen components: zero within-chain variance everywhere (exact —
    # centered sums make a constant chain's moments identically zero)
    const = np.all(gamma0 <= 0.0, axis=0)
    out[const | ~np.isfinite(var_plus) | (var_plus <= 0.0)] = np.nan
    return out


class DrawHistory:
    """Full draw history in ONE growing preallocated host buffer.

    Each block is appended exactly once (amortized O(1) per element via
    capacity doubling), never re-concatenated per diagnostics pass, and
    the buffer serves:

      * ``view()``  — a zero-copy (chains, n, d) window for full-history
        passes (split-R-hat validation, final collection, checkpoints);
      * ``take(cols)`` — ONE fancy-index copy of the selected components
        (the per-block worst-k ESS subset), O(n·k) instead of a per-block
        list concatenate + allocation.
    """

    def __init__(self, chains: int, ndim: int, dtype=None):
        """``dtype=None`` adopts the first appended block's dtype (the
        device draw dtype)."""
        self.chains = int(chains)
        self.ndim = int(ndim)
        self._buf = None if dtype is None else np.empty(
            (self.chains, 0, self.ndim), dtype
        )
        self._n = 0

    @property
    def rows(self) -> int:
        """Draws accumulated per chain."""
        return self._n

    def __len__(self) -> int:
        return self._n

    def append(self, block: np.ndarray) -> None:
        """Append a (chains, block_draws, d) block (one write; the buffer
        doubles when full, so growth never re-copies per block)."""
        block = np.asarray(block)
        if (
            block.ndim != 3
            or block.shape[0] != self.chains
            or block.shape[2] != self.ndim
        ):
            raise ValueError(
                f"expected (chains={self.chains}, n, d={self.ndim}), "
                f"got {block.shape}"
            )
        if self._buf is None:
            self._buf = np.empty((self.chains, 0, self.ndim), block.dtype)
        need = self._n + block.shape[1]
        if need > self._buf.shape[1]:
            cap = max(need, 2 * self._buf.shape[1], 64)
            grown = np.empty((self.chains, cap, self.ndim), self._buf.dtype)
            grown[:, : self._n] = self._buf[:, : self._n]
            self._buf = grown
        self._buf[:, self._n : need] = block
        self._n = need

    def view(self) -> np.ndarray:
        """(chains, n, d) view of the accumulated draws — NO copy; valid
        until the next ``append`` (growth may reallocate the buffer)."""
        if self._buf is None:
            return np.empty((self.chains, 0, self.ndim), np.float32)
        return self._buf[:, : self._n]

    def take(self, cols) -> np.ndarray:
        """(chains, n, len(cols)) copy of the selected components."""
        return self.view()[:, :, cols]


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

