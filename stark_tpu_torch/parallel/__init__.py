"""Parallel sampling layouts on one card — counterpart of
``stark_tpu/parallel/``: consensus Monte Carlo over data shards
(`consensus_sample`, BASELINE config 2) and parallel tempering
(`tempered_sample`, config 4)."""

from .consensus import consensus_sample
from .tempering import geometric_ladder, tempered_sample

__all__ = ["consensus_sample", "geometric_ladder", "tempered_sample"]
