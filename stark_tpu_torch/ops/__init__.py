"""Fused likelihood ops: each wraps a hand-written CUDA kernel
(``stark_tpu_torch/csrc``) with its plain PyTorch version beside it."""
