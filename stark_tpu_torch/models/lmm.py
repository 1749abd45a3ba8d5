"""Hierarchical linear mixed model — benchmark config 3 (BASELINE.json:9),
counterpart of ``stark_tpu/models/lmm.py``.

Random intercepts and random slopes over G groups, non-centered (u =
tau * u_raw).  Data: {"x": (N, D), "z": (N, Q) random-effects design
(column 0 ones), "g": (N,) int group ids, "y": (N,)}.  Four models
share one posterior:

* `LinearMixedModel`: plain PyTorch autograd on the rows (the oracle);
* `FusedLinearMixedModel`: the offset path — X transposed once, the
  likelihood through kernel B2's gaussian link with offsets = intercept
  + sum_q z_q u[g, q] gathered in PyTorch, their gradient through
  autograd's scatter;
* `FusedLinearMixedModelGrouped`: rows sorted by group, value and every
  gradient from kernel B4 in one pass; falls back to the offset path's
  layout and kernel when the grouping defeats the layout;
* `FusedLMM`: behind the default-off ``STARK_FUSED_LMM`` knob, X
  transposed once and value and every gradient from the one-pass fused
  op of `ops.lmm_fused` (plain PyTorch); with the knob off it is
  `LinearMixedModel`.

Parameters carry a leading chain axis (see `model.Model`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import Exp, batch_sum
from ..model import Model, ParamSpec, normal_logpdf
from ..ops.quantize import stream_slab
from .logistic import (
    KnobGatedFusedMixin,
    TransposedXMixin,
    _fold_scale,
    _row_axes_xt,
    _transpose_x,
    check_group_ids,
)

_LOG2 = math.log(2.0)


class LinearMixedModel(Model):
    def __init__(self, num_features: int, num_groups: int, num_random: int = 2):
        self.num_features = num_features
        self.num_groups = num_groups
        self.num_random = num_random  # Q: intercept + slopes

    def param_spec(self):
        return {
            "intercept": ParamSpec(()),
            "beta": ParamSpec((self.num_features,)),
            "u_raw": ParamSpec((self.num_groups, self.num_random)),
            "tau": ParamSpec((self.num_random,), Exp()),
            "sigma": ParamSpec((), Exp()),
        }

    def log_prior(self, p):
        lp = normal_logpdf(p["intercept"], 0.0, 5.0)
        lp = lp + batch_sum(normal_logpdf(p["beta"], 0.0, 2.5))
        lp = lp + batch_sum(normal_logpdf(p["u_raw"]))
        # half-normal(0, 1) on the random-effect scales and the noise sd
        lp = lp + batch_sum(normal_logpdf(p["tau"], 0.0, 1.0) + _LOG2)
        return lp + normal_logpdf(p["sigma"], 0.0, 1.0) + _LOG2

    @staticmethod
    def _u(p):
        return p["u_raw"] * p["tau"][:, None, :]  # (C, G, Q) non-centered

    def _offsets(self, p, data):
        """intercept + sum_q z_q u[g, q]: (C, N)."""
        u = self._u(p)
        return p["intercept"][:, None] + torch.einsum(
            "nq,cnq->cn", data["z"], u[:, data["g"], :]
        )

    def log_lik(self, p, data):
        mu = p["beta"] @ data["x"].T + self._offsets(p, data)
        return normal_logpdf(data["y"], mu, p["sigma"][:, None]).sum(-1)

    def check_groups(self, g):
        check_group_ids(g, self.num_groups)


class FusedLMM(KnobGatedFusedMixin, LinearMixedModel):
    """LinearMixedModel with the one-pass fused value-and-grad of
    `ops.lmm_fused`, behind the default-off ``STARK_FUSED_LMM`` knob.

    Knob off at prepare time: `LinearMixedModel`'s data and likelihood,
    bit for bit.  Knob on: X transposed once, and the potential's
    gradient costs one pass (∂beta, ∂u, ∂intercept, ∂sigma) in place of
    autograd's forward and backward.  Data prepared in the fused layout
    keeps working after the knob flips off (autograd on the same rows).
    Distinct from `FusedLinearMixedModel` (kernel B2 with offsets) and
    `FusedLinearMixedModelGrouped` (kernel B4).
    """

    _FUSED_FAMILY = "lmm"

    @staticmethod
    def _fused_enabled():
        from ..ops.lmm_fused import fused_lmm_enabled

        return fused_lmm_enabled()

    def _fused_log_lik(self, p, data):
        from ..ops.lmm_fused import lmm_loglik

        return lmm_loglik(
            p["beta"], self._u(p), p["intercept"], p["sigma"],
            stream_slab(data), data["z"], data["g"], data["y"],
        )


class FusedLinearMixedModel(TransposedXMixin, LinearMixedModel):
    """LinearMixedModel with the X pass in kernel B2 (gaussian link); the
    random-effect gather and its scatter-add gradient stay in PyTorch."""

    def prepare_data(self, data):
        if "g" in data:
            self.check_groups(data["g"])
        return super().prepare_data(data)

    def log_lik(self, p, data):
        from ..ops.logistic_fused import gaussian_offset_loglik

        return gaussian_offset_loglik(
            _fold_scale(p["beta"], data), self._offsets(p, data), data["xT"], data["y"],
            p["sigma"]
        )


class FusedLinearMixedModelGrouped(LinearMixedModel):
    """LinearMixedModel with the fully fused grouped kernel B4: rows sorted
    by group, so the random-effect offsets and the (G, Q) u-gradient live
    inside the pass.  At 10k groups over 100k rows the layout shrinks the
    lane tile until each tile's group window is small.

    When no tile keeps the window small, prepare_data keeps the offset
    path's transposed layout and marks it ``offsets_path``; log_lik then
    routes through kernel B2's gaussian link.
    """

    def prepare_data(self, data):
        if "gl" in data or "offsets_path" in data:
            return data  # already prepared
        from ..ops.hier_fused import prepare_grouped

        self.check_groups(data["g"])
        d_eff = self.num_features + self.num_random  # the x and z slabs
        out = prepare_grouped(data, d_eff, transpose_keys=("x", "z"))
        if out is None:
            out = _transpose_x(data)
            out["offsets_path"] = True
        return out

    def data_row_axes(self, data):
        if "gl" not in data:  # the offset path's layout shards like its rows
            return _row_axes_xt(data)
        raise NotImplementedError(
            "FusedLinearMixedModelGrouped's tile layout is global: rows "
            "cannot be re-sharded. Use FusedLinearMixedModel for "
            "data-sharded meshes; chain parallelism still applies."
        )

    def log_lik(self, p, data):
        beta = _fold_scale(p["beta"], data)
        if "gl" not in data:  # fallback layout
            from ..ops.logistic_fused import gaussian_offset_loglik

            return gaussian_offset_loglik(
                beta, self._offsets(p, data), data["xT"], data["y"], p["sigma"]
            )
        from ..ops.hier_fused import lmm_grouped_loglik

        # zT's scales fold into u as xT's into beta: mu's term z_q u[g, q]
        # is (s_q u[g, q]) against the packed z_q
        u = _fold_scale(self._u(p), data, key="zT_scale")
        return lmm_grouped_loglik(
            beta, u, p["intercept"], p["sigma"], data["xT"],
            data["zT"], data["y"], data["gl"], data["first_gid"],
            data["lane_tile"],
        )


def synth_lmm_data(
    seed: int, n: int, num_features: int, num_groups: int, *,
    num_random: int = 2, noise: float = 0.5,
):
    """Synthetic LMM dataset (+ the generating parameters), as numpy
    arrays from a seeded generator: x ~ N(0, 1); z = [1, N(0, 1) ...];
    uniform group ids; beta ~ N(0, 1); tau = [0.8, 0.4, ...]; u = tau *
    N(0, 1); y = 1 + x beta + sum_q z_q u[g, q] + noise * N(0, 1).  The
    same recipe as the JAX package's; the streams differ."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, num_features), dtype=f32)
    z = np.concatenate(
        [np.ones((n, 1), f32), rng.standard_normal((n, num_random - 1), dtype=f32)],
        axis=1,
    )
    g = rng.integers(0, num_groups, size=n, dtype=np.int32)
    beta = rng.standard_normal(num_features, dtype=f32)
    tau = np.asarray([0.8] + [0.4] * (num_random - 1), f32)
    u = tau[None, :] * rng.standard_normal((num_groups, num_random), dtype=f32)
    mu = f32(1.0) + x @ beta + np.sum(z * u[g], axis=-1)
    y = (mu + f32(noise) * rng.standard_normal(n, dtype=f32)).astype(f32)
    data = {"x": x, "z": z, "g": g, "y": y}
    true = {"intercept": 1.0, "beta": beta, "tau": tau, "sigma": noise, "u": u}
    return data, true
