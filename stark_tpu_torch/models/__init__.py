"""Model zoo of the port: the flagship hierarchical logistic family and
the hierarchical linear mixed model (BASELINE config 3)."""

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
    "FusedHierLogistic",
    "FusedHierLogisticGrouped",
    "FusedLinearMixedModel",
    "FusedLinearMixedModelGrouped",
    "HierLogistic",
    "LinearMixedModel",
    "synth_logistic_data",
    "synth_lmm_data",
]
