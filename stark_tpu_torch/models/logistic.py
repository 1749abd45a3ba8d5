"""Logistic regression, flat (BASELINE config 2) and hierarchical (the
flagship model) — counterpart of ``stark_tpu/models/logistic.py``.

Data: {"x": (N, D) float32, "y": (N,) 0/1 float32, "g": (N,) int group
ids}.  Two flat models share one posterior:

* `Logistic`: plain PyTorch autograd on the (N, D) rows;
* `FusedLogistic`: X transposed once, value and gradient from kernel B2
  (a chain batch; per shard and chain under consensus Monte Carlo).

Both evaluate a shard batch (parameters (S, C, ...) against data split
into S row blocks) as well as a chain batch.  Three hierarchical models
share another:

* `HierLogistic`: plain PyTorch autograd on the (N, D) rows;
* `FusedHierLogistic`: the offset path — X transposed once, the
  likelihood through kernel B2 with the gathered intercepts as row
  offsets, their gradient through autograd's scatter;
* `FusedHierLogisticGrouped`: rows sorted by group, value and every
  gradient from kernel B1 in one pass; falls back to the offset path's
  layout and kernel when the grouping defeats the layout.

Parameters carry a leading chain axis (see `model.Model`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import Exp, batch_sum
from ..model import Model, ParamSpec, normal_logpdf
from ..ops.quantize import dequant_rows, store_slab

_LOG2 = math.log(2.0)


def _bernoulli_logit_loglik(logits, y):
    f = torch.nn.functional.logsigmoid
    return (y * f(logits) + (1.0 - y) * f(-logits)).sum(-1)


class Logistic(Model):
    """Flat logistic regression: beta ~ N(0, prior_scale),
    y ~ Bernoulli(sigmoid(x beta))."""

    shard_batched_lik = True

    def __init__(self, num_features: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.prior_scale = prior_scale

    def param_spec(self):
        return {"beta": ParamSpec((self.num_features,))}

    def log_prior(self, p):
        return batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))

    def log_lik(self, p, data):
        beta, y = p["beta"], data["y"]
        logits = beta @ data["x"].transpose(-1, -2)
        if beta.ndim == 3:  # shards: y (S, n) against logits (S, C, n)
            y = y.unsqueeze(-2)
        return _bernoulli_logit_loglik(logits, y)


class HierLogistic(Model):
    """Shared coefficients + per-group random intercepts, non-centered:
    alpha_g = alpha0 + sigma_alpha * alpha_raw_g."""

    def __init__(self, num_features: int, num_groups: int, prior_scale: float = 2.5):
        self.num_features = num_features
        self.num_groups = num_groups
        self.prior_scale = prior_scale

    def param_spec(self):
        return {
            "beta": ParamSpec((self.num_features,)),
            "alpha0": ParamSpec(()),
            "sigma_alpha": ParamSpec((), Exp()),
            "alpha_raw": ParamSpec((self.num_groups,)),
        }

    def log_prior(self, p):
        lp = batch_sum(normal_logpdf(p["beta"], 0.0, self.prior_scale))
        lp = lp + normal_logpdf(p["alpha0"], 0.0, 5.0)
        # half-normal(0, 1) scale
        lp = lp + normal_logpdf(p["sigma_alpha"], 0.0, 1.0) + _LOG2
        return lp + batch_sum(normal_logpdf(p["alpha_raw"]))

    @staticmethod
    def _alpha(p):
        return p["alpha0"][:, None] + p["sigma_alpha"][:, None] * p["alpha_raw"]

    def log_lik(self, p, data):
        logits = p["beta"] @ data["x"].T + self._alpha(p)[:, data["g"]]
        return _bernoulli_logit_loglik(logits, data["y"])

    def check_groups(self, g):
        check_group_ids(g, self.num_groups)


def check_group_ids(g, num_groups: int) -> None:
    """Group ids index the per-group parameters on the card: refuse any
    outside [0, num_groups) before they get there."""
    g = np.asarray(g)
    if g.size and (g.min() < 0 or g.max() >= num_groups):
        raise ValueError(
            f"group ids must lie in [0, {num_groups}); got [{g.min()}, {g.max()}]"
        )


def _transpose_x(data):
    """Replace the (N, D) rows with their (D, N) transpose, once, stored at
    the STARK_FUSED_X_DTYPE storage dtype (`store_slab`)."""
    if "xT" in data:
        return data
    out = {k: v for k, v in data.items() if k != "x"}
    store_slab(out, "xT", np.asarray(data["x"], dtype=np.float32).T)
    return out


def _row_axes_xt(data):
    """Rows on axis 1 of the transposed ``xT``, axis 0 elsewhere; an entry
    without rows (a 0-d or empty marker) and a slab's per-column scales
    (``*_scale``, replicated: every row shard dequantizes against the
    same calibration) are -1."""
    def ax(k, v):
        if np.ndim(v) == 0 or np.shape(v)[0] == 0 or k.endswith("_scale"):
            return -1
        return 1 if k == "xT" else 0

    return {k: ax(k, v) for k, v in data.items()}


def _fold_scale(beta, data, key="xT_scale"):
    """A packed slab's scales folded into the parameter operand: ``(s *
    q) . beta == q . (s * beta)``, so a kernel streams the packed bytes
    as they are and autograd carries the scales back to beta's gradient;
    ``beta`` itself when the slab is not packed.  beta (..., D) [or u
    (..., G, Q) against zT's (Q,) scales]; per shard, beta (S, C, D)
    against the shards' scales (S, D)."""
    s = data.get(key)
    if s is None:
        return beta
    return beta * (s.unsqueeze(-2) if s.ndim > 1 else s)


class TransposedXMixin:
    """Layout hooks shared by the fused models: ``prepare_data`` replaces
    the (N, D) rows with their (D, N) transpose once, on the host, and
    ``data_row_axes`` says the rows of ``xT`` lie on its axis 1."""

    def prepare_data(self, data):
        return _transpose_x(data)

    def data_row_axes(self, data):
        return _row_axes_xt(data)


class KnobGatedFusedMixin:
    """Hooks shared by the default-off fused zoo variants (`FusedLMM`):
    the transposed layout only when the family's knob is on at prepare
    time, layout-aware row axes, and a ``log_lik`` that takes the fused
    op, or autograd when the knob is off.  With the knob off at prepare
    time the variant is its parent model; data prepared in the fused
    layout keeps working after the knob flips off (autograd on the
    de-transposed rows).

    Subclasses set ``_FUSED_FAMILY`` and implement ``_fused_enabled()``
    and ``_fused_log_lik(p, data)``.
    """

    _FUSED_FAMILY: str

    @staticmethod
    def _fused_enabled() -> bool:
        raise NotImplementedError

    def prepare_data(self, data):
        if self._fused_enabled():
            return super().prepare_data(_transpose_x(data))
        return super().prepare_data(data)

    def data_row_axes(self, data):
        if "xT" in data:
            return _row_axes_xt(data)
        return super().data_row_axes(data)

    def fused_tag(self):
        """The fused family this model runs, or None on autograd."""
        return self._FUSED_FAMILY if self._fused_enabled() else None

    def log_lik(self, p, data):
        if "xT" not in data:
            return super().log_lik(p, data)
        if not self._fused_enabled():
            # autograd on the rows, dequantized where the slab was packed
            rows = {k: v for k, v in data.items() if k not in ("xT", "xT_scale")}
            return super().log_lik(p, {**rows, "x": dequant_rows(data)})
        return self._fused_log_lik(p, data)

    def _fused_log_lik(self, p, data):
        raise NotImplementedError


class FusedLogistic(TransposedXMixin, Logistic):
    """Logistic with value and gradient from kernel B2 in one pass over
    the transposed X."""

    def log_lik(self, p, data):
        from ..ops.logistic_fused import logistic_loglik

        return logistic_loglik(_fold_scale(p["beta"], data), data["xT"], data["y"])


class FusedHierLogistic(TransposedXMixin, HierLogistic):
    """HierLogistic with the X pass in kernel B2; the intercept gather and
    its scatter-add gradient stay in PyTorch."""

    def prepare_data(self, data):
        if "g" in data:
            self.check_groups(data["g"])
        return super().prepare_data(data)

    def log_lik(self, p, data):
        from ..ops.logistic_fused import logistic_offset_loglik

        return logistic_offset_loglik(
            _fold_scale(p["beta"], data), self._alpha(p)[:, data["g"]], data["xT"], data["y"]
        )


class FusedHierLogisticGrouped(HierLogistic):
    """HierLogistic with the fully fused grouped kernel B1: rows sorted
    by group so the intercepts and their gradient live inside the pass.

    When no tile keeps the group window small (tiny groups scattered
    wide), prepare_data keeps the offset path's transposed layout and
    marks it ``offsets_path``; log_lik then routes through kernel B2.
    """

    def prepare_data(self, data):
        if "gl" in data or "offsets_path" in data:
            return data  # already prepared
        from ..ops.hier_fused import prepare_grouped

        self.check_groups(data["g"])
        out = prepare_grouped(data, int(np.asarray(data["x"]).shape[1]))
        if out is None:
            out = _transpose_x(data)
            out["offsets_path"] = True
        return out

    def data_row_axes(self, data):
        if "gl" not in data:  # the offset path's layout shards like its rows
            return _row_axes_xt(data)
        raise NotImplementedError(
            "FusedHierLogisticGrouped's tile layout is global (first_gid "
            "indexes absolute lane tiles): rows cannot be re-sharded. "
            "Use FusedHierLogistic for data-sharded meshes; chain "
            "parallelism still applies."
        )

    def log_lik(self, p, data):
        alpha = self._alpha(p)
        beta = _fold_scale(p["beta"], data)
        if "gl" not in data:  # fallback layout
            from ..ops.logistic_fused import logistic_offset_loglik

            return logistic_offset_loglik(
                beta, alpha[:, data["g"]], data["xT"], data["y"]
            )
        from ..ops.hier_fused import hier_logistic_loglik

        return hier_logistic_loglik(
            beta, alpha, data["xT"], data["y"], data["gl"],
            data["first_gid"], data["lane_tile"],
        )


def synth_logistic_data(seed: int, n: int, d: int, *, num_groups: int = 0):
    """Synthetic benchmark dataset (+ the true parameters), as numpy
    arrays from a seeded generator: x ~ N(0, 1), beta ~ N(0, 1), group
    intercepts ~ N(0, 0.5^2), y ~ Bernoulli(sigmoid(x beta + alpha[g])).
    The same recipe as the JAX package's; the streams differ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    beta = rng.standard_normal(d, dtype=np.float32)
    logits = x @ beta
    out = {"x": x}
    true = {"beta": beta}
    if num_groups:
        g = rng.integers(0, num_groups, size=n, dtype=np.int32)
        alpha = 0.5 * rng.standard_normal(num_groups, dtype=np.float32)
        logits = logits + alpha[g]
        out["g"] = g
        true["alpha"] = alpha
    u = rng.random(n, dtype=np.float32)
    out["y"] = (u < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return out, true
