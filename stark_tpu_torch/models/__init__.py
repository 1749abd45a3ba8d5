"""Model zoo of the port (the flagship hierarchical logistic family)."""

from .logistic import (
    FusedHierLogistic,
    FusedHierLogisticGrouped,
    HierLogistic,
    synth_logistic_data,
)

__all__ = [
    "FusedHierLogistic",
    "FusedHierLogisticGrouped",
    "HierLogistic",
    "synth_logistic_data",
]
