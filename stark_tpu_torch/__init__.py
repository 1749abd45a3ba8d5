"""stark_tpu_torch — the PyTorch/CUDA port of ``stark_tpu`` for one H100.

Parallel-chain ChEES-HMC over a model's log-posterior, with the
likelihood hot path in hand-written CUDA kernels for Hopper
(``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use).  The
module names follow the JAX package so each counterpart is easy to
find; inside, the idiom is PyTorch: plain functions on tensors, an
explicit ``device`` argument, explicit ``torch.Generator`` streams and a
``torch.autograd.Function`` around each kernel.

Entry points — `sample`, `chees_sample`, the adaptive runner
`sample_until_converged` (blocks until the R-hat/ESS gate passes, with
checkpoints and a draw store) and `supervised_sample` (the runner with
restart from the last healthy checkpoint) — run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card and no explicit CPU device
they raise (see `_device`).

Precision stance: float32 everywhere, no TF32.  This mirrors the JAX
package's ``highest`` matmul default — MCMC needs accurate energies and
gradients for Hamiltonian energy conservation.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import bijectors, diagnostics  # noqa: E402
from .chees import chees_sample  # noqa: E402
from .model import Model, ParamSpec, flatten_model, prepare_model_data  # noqa: E402
from .runner import AdaptiveResult, sample_until_converged  # noqa: E402
from .sampler import Posterior, SamplerConfig, sample  # noqa: E402
from .supervise import supervised_sample  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AdaptiveResult",
    "Model",
    "ParamSpec",
    "Posterior",
    "SamplerConfig",
    "bijectors",
    "chees_sample",
    "diagnostics",
    "flatten_model",
    "prepare_model_data",
    "sample",
    "sample_until_converged",
    "supervised_sample",
]
