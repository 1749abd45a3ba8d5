"""Parallel sampling layouts on one card — counterpart of
``stark_tpu/parallel/``: consensus Monte Carlo over data shards
(`consensus_sample`, BASELINE config 2)."""

from .consensus import consensus_sample

__all__ = ["consensus_sample"]
