"""8-schools hierarchical normal — BASELINE config 1, counterpart of
``stark_tpu/models/eight_schools.py``.

Non-centered: theta = mu + tau * theta_raw, tau through the `Exp`
bijector.  The classic dataset (Rubin 1981) is the model's data, handed
to ``log_lik`` like any other dataset.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bijectors import Exp, batch_sum
from ..model import Model, ParamSpec, normal_logpdf

Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)


def eight_schools_data():
    return {"y": Y.copy(), "sigma": SIGMA.copy()}


def _cauchy_logpdf(x, scale):
    return -math.log(math.pi * scale) - torch.log1p((x / scale) ** 2)


class EightSchools(Model):
    """Non-centered: theta = mu + tau * theta_raw."""

    def param_spec(self):
        return {
            "mu": ParamSpec(()),
            "tau": ParamSpec((), Exp()),
            "theta_raw": ParamSpec((8,)),
        }

    def log_prior(self, p):
        lp = normal_logpdf(p["mu"], 0.0, 5.0)
        # half-Cauchy(0, 5) on tau (density on the positive half-line)
        lp = lp + _cauchy_logpdf(p["tau"], 5.0) + math.log(2.0)
        return lp + batch_sum(normal_logpdf(p["theta_raw"]))

    def log_lik(self, p, data):
        return self.log_lik_rows(p, data).sum(-1)

    def log_lik_rows(self, p, data):
        theta = p["mu"][:, None] + p["tau"][:, None] * p["theta_raw"]
        return normal_logpdf(data["y"], theta, data["sigma"])
