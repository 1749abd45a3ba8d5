"""The port's public surface against the JAX package's: calls that run
on the reference either run on the port or are refused naming their
ROADMAP item, and the names the reference exports import.

* ``sample(debug_nans=True)``: a NaN log density raises
  FloatingPointError, as the reference's test_glm.py:46-67 asks; a NaN
  gradient raises autograd's anomaly error; a healthy run's draws are
  the same with it on.  ``sample(trace=...)`` is refused (A12).
* ``chees_sample(dispatch_steps=...)``: accepted, checked as the
  reference checks it, and the draws bitwise equal without it.
* ``stark_tpu_torch.ChainHealthError`` and the SG-HMC kernel names of
  ``stark_tpu_torch.kernels``.
"""

import numpy as np
import pytest
import torch

import stark_tpu
import stark_tpu.kernels as rkernels
import stark_tpu_torch
import stark_tpu_torch.kernels as pkernels
from stark_tpu_torch import chees_sample, sample
from stark_tpu_torch.model import Model, ParamSpec
from stark_tpu_torch.models import FusedLogistic, HierLogistic, synth_logistic_data


class NaNPrior(Model):
    """log(x) as the log-prior: NaN as soon as x wanders negative
    (tests/test_glm.py:51-60)."""

    def param_spec(self):
        return {"x": ParamSpec(())}

    def log_prior(self, p):
        return torch.log(p["x"])

    def log_lik(self, p, data):
        return torch.zeros_like(p["x"])


class NaNGradient(Model):
    """A finite density whose gradient is NaN at x = 0: sqrt(x^2)."""

    def param_spec(self):
        return {"x": ParamSpec(())}

    def log_prior(self, p):
        return -torch.sqrt(p["x"] * p["x"])

    def log_lik(self, p, data):
        return torch.zeros_like(p["x"])


def test_debug_nans_raises_on_a_nan_density():
    kw = dict(chains=1, kernel="hmc", num_leapfrog=4, num_warmup=50, num_samples=50, seed=0,
              device="cpu")
    with pytest.raises(FloatingPointError, match="NaNPrior.log_prior"):
        sample(NaNPrior(), {"y": np.zeros(4, np.float32)}, debug_nans=True, **kw)
    # without it the NaN potential is absorbed as rejected proposals
    post = sample(NaNPrior(), {"y": np.zeros(4, np.float32)}, **kw)
    assert post.draws["x"].shape == (1, 50)


def test_debug_nans_raises_on_a_nan_gradient():
    with pytest.raises(RuntimeError, match="nan"):
        sample(NaNGradient(), None, chains=1, kernel="hmc", num_leapfrog=2, num_warmup=2,
               num_samples=2, init_params={"x": 0.0}, debug_nans=True,
               device="cpu")


def test_debug_nans_leaves_the_draws_unchanged():
    raw, _ = synth_logistic_data(0, 300, 3, num_groups=4)
    kw = dict(chains=2, num_warmup=20, num_samples=20, max_tree_depth=4, seed=3,
              device="cpu")
    a = sample(HierLogistic(3, 4), raw, **kw)
    b = sample(HierLogistic(3, 4), raw, debug_nans=True, **kw)
    np.testing.assert_array_equal(a.draws_flat, b.draws_flat)


def test_sample_trace_is_refused():
    raw, _ = synth_logistic_data(0, 300, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        sample(FusedLogistic(3), raw, trace=object(), device="cpu")


def test_chees_dispatch_steps_accepted_and_changes_nothing():
    raw, _ = synth_logistic_data(1, 400, 3)
    kw = dict(chains=4, num_warmup=20, num_samples=10, init_step_size=0.1, seed=2,
              device="cpu")
    a = chees_sample(FusedLogistic(3), raw, **kw)
    b = chees_sample(FusedLogistic(3), raw, dispatch_steps=3, **kw)
    np.testing.assert_array_equal(a.draws_flat, b.draws_flat)
    for k in a.sample_stats:
        np.testing.assert_array_equal(np.asarray(a.sample_stats[k]),
                                      np.asarray(b.sample_stats[k]), err_msg=k)
    with pytest.raises(ValueError, match="dispatch_steps must be >= 0"):
        chees_sample(FusedLogistic(3), raw, dispatch_steps=-1, **kw)


def test_chain_health_error_exported_from_the_root():
    from stark_tpu_torch import ChainHealthError
    from stark_tpu_torch.supervise import ChainHealthError as inner

    assert ChainHealthError is inner and issubclass(ChainHealthError, RuntimeError)
    assert "ChainHealthError" in stark_tpu.__all__ and "ChainHealthError" in stark_tpu_torch.__all__


def test_kernels_export_the_reference_names():
    from stark_tpu_torch.kernels import SGHMCState, sghmc_init, sghmc_step
    from stark_tpu_torch.kernels import sghmc as pks

    assert set(rkernels.__all__) <= set(pkernels.__all__)
    assert (SGHMCState, sghmc_init, sghmc_step) == (pks.SGHMCState, pks.sghmc_init,
                                                     pks.sghmc_step)
