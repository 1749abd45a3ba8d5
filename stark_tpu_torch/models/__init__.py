"""Model zoo of the port: 8 schools (BASELINE config 1), the flagship
hierarchical logistic family and the hierarchical linear mixed model
(BASELINE config 3)."""

from .eight_schools import EightSchools, eight_schools_data
from .lmm import (
    FusedLinearMixedModel,
    FusedLinearMixedModelGrouped,
    LinearMixedModel,
    synth_lmm_data,
)
from .logistic import (
    FusedHierLogistic,
    FusedHierLogisticGrouped,
    HierLogistic,
    synth_logistic_data,
)

__all__ = [
    "EightSchools",
    "FusedHierLogistic",
    "FusedHierLogisticGrouped",
    "FusedLinearMixedModel",
    "FusedLinearMixedModelGrouped",
    "HierLogistic",
    "LinearMixedModel",
    "eight_schools_data",
    "synth_logistic_data",
    "synth_lmm_data",
]
