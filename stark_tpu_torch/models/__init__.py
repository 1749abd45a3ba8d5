"""Model zoo of the port: 8 schools (BASELINE config 1), flat logistic
regression (config 2), the flagship hierarchical logistic family, the
hierarchical linear mixed model (config 3) and its knob-gated fused
variant `FusedLMM`, the Gaussian mixture (config 4), the Bayesian
2-layer MLP (config 5), Bayesian linear and Poisson regression with
their fused variants, and the rest of the reference's zoo: the IRT 2PL
model, ordered logistic, Student-t, negative-binomial and horseshoe
regression (with the knob-gated fused IRT, ordinal and Student-t
variants), Cox proportional hazards and stochastic volatility."""

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
from .irt import FusedIRT2PL, IRT2PL, synth_irt_data
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
from .ordinal import FusedOrderedLogistic, OrderedLogistic, synth_ordinal_data
from .robust import (
    FusedStudentTRegression,
    HorseshoeRegression,
    NegBinomialRegression,
    StudentTRegression,
    synth_horseshoe_data,
    synth_negbinom_data,
    synth_studentt_data,
)
from .survival import CoxPH, synth_survival_data
from .timeseries import StochasticVolatility, synth_sv_data

__all__ = [
    "BayesianMLP",
    "CoxPH",
    "EightSchools",
    "FusedHierLogistic",
    "FusedHierLogisticGrouped",
    "FusedIRT2PL",
    "FusedLMM",
    "FusedLinearMixedModel",
    "FusedLinearMixedModelGrouped",
    "FusedLinearRegression",
    "FusedLogistic",
    "FusedOrderedLogistic",
    "FusedPoissonRegression",
    "FusedStudentTRegression",
    "GaussianMixture",
    "HierLogistic",
    "HorseshoeRegression",
    "IRT2PL",
    "LinearMixedModel",
    "LinearRegression",
    "Logistic",
    "NegBinomialRegression",
    "OrderedLogistic",
    "PoissonRegression",
    "StochasticVolatility",
    "StudentTRegression",
    "eight_schools_data",
    "gmm_init_1d",
    "synth_bnn_data",
    "synth_gmm_data",
    "synth_horseshoe_data",
    "synth_irt_data",
    "synth_linreg_data",
    "synth_lmm_data",
    "synth_logistic_data",
    "synth_negbinom_data",
    "synth_ordinal_data",
    "synth_poisson_data",
    "synth_studentt_data",
    "synth_survival_data",
    "synth_sv_data",
]
