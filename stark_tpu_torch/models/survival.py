"""Survival analysis: Cox proportional hazards under the Breslow partial
likelihood — counterpart of ``stark_tpu/models/survival.py``.

Data: {"x": (N, D) float32, "t": (N,) survival or censoring times,
"event": (N,) 1 event / 0 censored}.  The partial likelihood couples
each event to its risk set, everyone still at risk at its time.  With
the rows sorted by descending time, the log of the risk set's sum at
row i is a prefix log-sum-exp over rows 0 .. i (``torch.logcumsumexp``,
one pass, no loop over rows), taken at the end of row i's block of
tied times.  The prefix makes the likelihood sequential in the row
order, so rows cannot be minibatched or split into sub-posteriors; the
mesh's cross-shard path goes with multi-GPU (ROADMAP A11).  Chain
parallelism always applies.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bijectors import batch_sum
from ..model import Model, ParamSpec, normal_logpdf


def _fill_from_right(vals, valid):
    """For each i along the last axis, the value at the nearest valid
    index j >= i (where there is none, the last entry's).  The nearest
    valid index is a reversed running minimum of the valid positions
    (one ``torch.cummin``), then one gather."""
    n = valid.shape[-1]
    pos = torch.arange(n, device=valid.device)
    ends = torch.where(valid, pos, torch.full_like(pos, n))
    nearest = torch.cummin(ends.flip(-1), -1).values.flip(-1)
    return vals[..., nearest.clamp(max=n - 1)]


class CoxPH(Model):
    """Breslow partial likelihood with tie-correct risk sets;
    beta ~ N(0, prior_scale).

    ``prepare_data`` sorts the rows by descending time on the host, with
    a stable sort, so tied rows keep the order the JAX package's
    ``jnp.argsort`` gives them and unsorted data come out right.  Every
    member of a block of tied times takes the same denominator, the
    log-sum-exp through the end of its block: the full Breslow risk set.
    """

    def __init__(self, num_features: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.prior_scale = prior_scale

    def param_spec(self):
        return {"beta": ParamSpec((self.num_features,))}

    def prepare_data(self, data):
        order = np.argsort(-np.asarray(data["t"]), kind="stable")
        return {k: np.asarray(v)[order] for k, v in data.items()}

    def data_row_axes(self, data):
        raise NotImplementedError(
            "CoxPH's risk-set prefix scan couples every row to all "
            "longer-surviving rows: rows cannot be minibatched or split "
            "into independent sub-posteriors (SG-HMC, consensus).  MESH "
            "data-axis sharding IS supported — the cross-shard "
            "log_lik_sharded stitches the prefix over the axis (use "
            "ShardedBackend); chain parallelism always applies."
        )

    def log_prior(self, p):
        return batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))

    def log_lik(self, p, data):
        eta = p["beta"] @ data["x"].transpose(-1, -2)  # rows by descending time
        prefix = torch.logcumsumexp(eta, -1)
        t = data["t"]
        # the last row of each run of equal times ends a tie block
        is_end = torch.cat([t[1:] != t[:-1], torch.ones(1, dtype=torch.bool, device=t.device)])
        log_risk = _fill_from_right(prefix, is_end)
        return (data["event"] * (eta - log_risk)).sum(-1)


def synth_survival_data(seed: int, n: int, d: int, *, censor_rate: float = 0.3):
    """Synthetic survival dataset (+ the true parameters), as numpy
    arrays from a seeded generator: x ~ N(0, 1), beta ~ 0.5 N(0, 1),
    exponential times of hazard exp(x beta), each row censored with
    probability ``censor_rate``; rows sorted by descending time (stable),
    as CoxPH's likelihood reads them.  The same recipe as the JAX
    package's; the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, d), dtype=f32)
    beta = (f32(0.5) * rng.standard_normal(d, dtype=f32)).astype(f32)
    t = (rng.standard_exponential(n) / np.exp(x @ beta)).astype(f32)
    event = (rng.random(n) > censor_rate).astype(f32)
    order = np.argsort(-t, kind="stable")
    return {"x": x[order], "t": t[order], "event": event[order]}, {"beta": beta}
