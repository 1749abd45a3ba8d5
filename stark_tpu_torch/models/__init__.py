"""Model zoo of the port: 8 schools (BASELINE config 1), flat logistic
regression (config 2), the flagship hierarchical logistic family, the
hierarchical linear mixed model (config 3) and its knob-gated fused
variant `FusedLMM`, the Gaussian mixture (config 4), the Bayesian
2-layer MLP (config 5), and Bayesian linear and Poisson regression with
their fused variants."""

from .bnn import BayesianMLP, synth_bnn_data

from .eight_schools import EightSchools, eight_schools_data
from .glm import (
    FusedLinearRegression,
    FusedPoissonRegression,
    LinearRegression,
    PoissonRegression,
    synth_linreg_data,
    synth_poisson_data,
)
from .gmm import GaussianMixture, gmm_init_1d, synth_gmm_data
from .lmm import (
    FusedLMM,
    FusedLinearMixedModel,
    FusedLinearMixedModelGrouped,
    LinearMixedModel,
    synth_lmm_data,
)
from .logistic import (
    FusedHierLogistic,
    FusedHierLogisticGrouped,
    FusedLogistic,
    HierLogistic,
    Logistic,
    synth_logistic_data,
)

__all__ = [
    "BayesianMLP",
    "EightSchools",
    "FusedHierLogistic",
    "FusedHierLogisticGrouped",
    "FusedLMM",
    "FusedLinearMixedModel",
    "FusedLinearMixedModelGrouped",
    "FusedLinearRegression",
    "FusedPoissonRegression",
    "FusedLogistic",
    "GaussianMixture",
    "HierLogistic",
    "LinearMixedModel",
    "LinearRegression",
    "PoissonRegression",
    "Logistic",
    "eight_schools_data",
    "gmm_init_1d",
    "synth_bnn_data",
    "synth_gmm_data",
    "synth_linreg_data",
    "synth_lmm_data",
    "synth_poisson_data",
    "synth_logistic_data",
]
