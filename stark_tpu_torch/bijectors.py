"""Constraining bijectors (unconstrained R^k -> constrained support).

Counterpart of ``stark_tpu/bijectors.py``.  Conventions:
  forward(x):  unconstrained -> constrained
  inverse(y):  constrained  -> unconstrained
  fldj(x):     log|det d forward / dx| summed over the event, one value
               per batch element
  unconstrained_shape(shape): event shape in unconstrained space

Every array carries a leading batch (chain) axis: ``x`` is
``(C,) + event_shape`` and ``fldj`` returns ``(C,)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading batch (chain) axis (a batch of
    no rows too)."""
    return t.reshape(t.shape[0], math.prod(t.shape[1:])).sum(-1)


class Bijector:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def fldj(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def unconstrained_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return shape


class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def fldj(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


class Exp(Bijector):
    """Positive reals via y = exp(x)."""

    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def fldj(self, x):
        return batch_sum(x)


class Softplus(Bijector):
    """Positive reals via y = log1p(exp(x))."""

    def forward(self, x):
        return torch.logaddexp(x, torch.zeros_like(x))

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def fldj(self, x):
        return batch_sum(F.logsigmoid(x))


class Interval(Bijector):
    """(a, b) via y = a + (b-a) * sigmoid(x)."""

    def __init__(self, low: float, high: float):
        self.low = float(low)
        self.high = float(high)

    def forward(self, x):
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y):
        u = (y - self.low) / (self.high - self.low)
        return torch.log(u) - torch.log1p(-u)

    def fldj(self, x):
        w = math.log(self.high - self.low)
        return batch_sum(w + F.logsigmoid(x) + F.logsigmoid(-x))


class Ordered(Bijector):
    """Strictly increasing vectors over the last axis."""

    def forward(self, x):
        first = x[..., :1]
        rest = torch.exp(x[..., 1:])
        return torch.cat([first, rest], dim=-1).cumsum(dim=-1)

    def inverse(self, y):
        first = y[..., :1]
        rest = torch.log(torch.diff(y, dim=-1))
        return torch.cat([first, rest], dim=-1)

    def fldj(self, x):
        return batch_sum(x[..., 1:])


class StickBreaking(Bijector):
    """K-simplex over the last axis from K-1 unconstrained coordinates
    (Stan-style, with the log(K-1-k) offset so x = 0 is the uniform
    point)."""

    @staticmethod
    def _offset(km1, like):
        return torch.log(
            torch.arange(km1, 0, -1, dtype=like.dtype, device=like.device)
        )

    def forward(self, x):
        z = torch.sigmoid(x - self._offset(x.shape[-1], x))
        log1mz = torch.log1p(-z)
        log_rem = torch.cat(
            [torch.zeros_like(log1mz[..., :1]), torch.cumsum(log1mz, dim=-1)],
            dim=-1,
        )
        y_head = z * torch.exp(log_rem[..., :-1])
        y_tail = torch.exp(log_rem[..., -1:])
        return torch.cat([y_head, y_tail], dim=-1)

    def inverse(self, y):
        offset = self._offset(y.shape[-1] - 1, y)
        rem = 1.0 - torch.cat(
            [torch.zeros_like(y[..., :1]), torch.cumsum(y[..., :-2], dim=-1)],
            dim=-1,
        )
        z = y[..., :-1] / rem
        return torch.log(z) - torch.log1p(-z) + offset

    def fldj(self, x):
        xs = x - self._offset(x.shape[-1], x)
        z = torch.sigmoid(xs)
        log1mz = torch.log1p(-z)
        log_rem = torch.cat(
            [
                torch.zeros_like(log1mz[..., :1]),
                torch.cumsum(log1mz[..., :-1], dim=-1),
            ],
            dim=-1,
        )
        return batch_sum(F.logsigmoid(xs) + F.logsigmoid(-xs) + log_rem)

    def unconstrained_shape(self, shape):
        return shape[:-1] + (shape[-1] - 1,)


class Chain(Bijector):
    """Compose bijectors: forward = b_last ∘ ... ∘ b_first."""

    def __init__(self, *bijectors: Bijector):
        self.bijectors = bijectors

    def forward(self, x):
        for b in self.bijectors:
            x = b.forward(x)
        return x

    def inverse(self, y):
        for b in reversed(self.bijectors):
            y = b.inverse(y)
        return y

    def fldj(self, x):
        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for b in self.bijectors:
            total = total + b.fldj(x)
            x = b.forward(x)
        return total

    def unconstrained_shape(self, shape):
        for b in reversed(self.bijectors):
            shape = b.unconstrained_shape(shape)
        return shape
