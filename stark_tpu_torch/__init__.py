"""stark_tpu_torch — the PyTorch/CUDA port of ``stark_tpu`` for one H100.

Parallel-chain NUTS (the default, as in the JAX package), HMC and the
ChEES-HMC ensemble over a model's log-posterior, with the likelihood hot
path in hand-written CUDA kernels for Hopper (``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use).  The
module names follow the JAX package so each counterpart is easy to
find; inside, the idiom is PyTorch: plain functions on tensors, an
explicit ``device`` argument, explicit ``torch.Generator`` streams and a
``torch.autograd.Function`` around each kernel.

Entry points — `sample`, `chees_sample`, the adaptive runner
`sample_until_converged` (blocks until the R-hat/ESS gate passes, with
checkpoints and a draw store), `supervised_sample` (the runner with
restart from the last healthy checkpoint), `consensus_sample`
(consensus Monte Carlo over data shards), `tempered_sample` (parallel
tempering) and `sghmc_sample` (minibatch SG-HMC) — run on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no explicit
CPU device they raise (see `_device`).

Precision stance: float32 everywhere, no TF32.  This mirrors the JAX
package's ``highest`` matmul default — MCMC needs accurate energies and
gradients for Hamiltonian energy conservation.  ``STARK_FUSED_PRECISION=
high|default`` opts the fused likelihood dots into the reference's three
or one bf16 passes (`ops.precision`).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import bijectors, diagnostics  # noqa: E402
from .chees import chees_sample  # noqa: E402
from .model import Model, ParamSpec, flatten_model, prepare_model_data  # noqa: E402
from .parallel import consensus_sample, geometric_ladder, tempered_sample  # noqa: E402
from .runner import (  # noqa: E402
    AdaptiveResult,
    data_fingerprint,
    load_adapt_state,
    sample_until_converged,
)
from .sampler import Posterior, SamplerConfig, sample  # noqa: E402
from .sghmc import sghmc_sample  # noqa: E402
from .supervise import ChainHealthError, supervised_sample  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AdaptiveResult",
    "ChainHealthError",
    "Model",
    "ParamSpec",
    "Posterior",
    "SamplerConfig",
    "bijectors",
    "chees_sample",
    "consensus_sample",
    "data_fingerprint",
    "diagnostics",
    "flatten_model",
    "geometric_ladder",
    "load_adapt_state",
    "prepare_model_data",
    "sample",
    "sample_until_converged",
    "sghmc_sample",
    "supervised_sample",
    "tempered_sample",
]
