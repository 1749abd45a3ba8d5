"""The port's streaming diagnostics against the JAX package's.

The host statistics (Welford moments and R-hat, the accumulator's host
rebuild, the ESS from it, the draw history) are the same float64 numpy
math on the same seeded draws: rtol 1e-6.  The on-device accumulator,
torch against the JAX package's ``stream_diag_update`` under
``lax.scan``, sums float32 in its own order: the JAX package's own band
for its scan against the host rebuild (tests/test_stream_diag.py), rtol
2e-4 / atol 2e-4 on the fields and rtol 1e-3 on the ESS from them.  The
ChEES segment that carries the accumulator gives bitwise the plain
segment's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu import diagnostics as rdiag
from stark_tpu.kernels import base as rbase
from stark_tpu_torch import diagnostics as pdiag
from stark_tpu_torch.chees import chees_init_positions, make_chees_parts
from stark_tpu_torch.kernels import base as pbase
from stark_tpu_torch.kernels.chees import TorchNoise, halton
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import FusedHierLogisticGrouped, synth_logistic_data
from stark_tpu_torch.sampler import SamplerConfig

FIELDS = ("n", "anchor", "s1", "s2", "cross", "ring", "head")
HOST_RTOL = 1e-6
SCAN_RTOL = SCAN_ATOL = 2e-4
ESS_RTOL = 1e-3


def _ar1(seed, phi, chains, n, d, mean=5.0):
    rng = np.random.default_rng(seed)
    x = np.zeros((chains, n, d))
    innov = rng.standard_normal((chains, n, d))
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + innov[:, t] * np.sqrt(1 - phi**2)
    return (x + mean).astype(np.float32)


@pytest.mark.parametrize("phi", [0.0, 0.6, 0.95])
def test_suffstats_and_rhat_match_reference(phi):
    draws = _ar1(1, phi, chains=4, n=300, d=5)
    ref, port = rdiag.ChainSuffStats(4, 5), pdiag.ChainSuffStats(4, 5)
    for lo, hi in ((0, 7), (7, 7), (7, 120), (120, 300)):  # an empty block too
        ref.update(draws[:, lo:hi])
        port.update(draws[:, lo:hi])
        np.testing.assert_array_equal(port.count, ref.count)
        np.testing.assert_allclose(port.mean, ref.mean, rtol=HOST_RTOL)
        np.testing.assert_allclose(port.m2, ref.m2, rtol=HOST_RTOL)
        np.testing.assert_allclose(port.rhat(), ref.rhat(), rtol=HOST_RTOL)
    np.testing.assert_allclose(
        pdiag.rhat_from_suffstats(port.count, port.mean, port.m2),
        np.asarray(rdiag.rhat_from_suffstats(ref.count, ref.mean, ref.m2)),
        rtol=HOST_RTOL,
    )
    # a frozen component gives a quiet NaN in both
    frozen = draws.copy()
    frozen[:, :, 2] = 3.0
    r, p = rdiag.ChainSuffStats(4, 5), pdiag.ChainSuffStats(4, 5)
    r.update(frozen)
    p.update(frozen)
    assert np.isnan(p.rhat()[2]) and np.isnan(r.rhat()[2])


@pytest.mark.parametrize("phi,lags", [(0.0, 50), (0.6, 50), (0.9, 8), (0.99, 50)])
def test_host_rebuild_and_ess_match_reference(phi, lags):
    draws = _ar1(2, phi, chains=4, n=400, d=3)
    ref = rdiag.stream_diag_from_draws(draws, lags)
    port = pdiag.stream_diag_from_draws(draws, lags)
    for k in FIELDS:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(port[k], ref[k], rtol=HOST_RTOL, err_msg=k)
    np.testing.assert_allclose(
        pdiag.ess_from_suffstats(*[port[k] for k in FIELDS]),
        rdiag.ess_from_suffstats(*[ref[k] for k in FIELDS]),
        rtol=HOST_RTOL,
    )
    # fewer draws than lags, and none at all
    short = pdiag.stream_diag_from_draws(draws[:, :5], lags)
    for k in FIELDS:
        np.testing.assert_allclose(short[k], rdiag.stream_diag_from_draws(draws[:, :5], lags)[k],
                                   rtol=HOST_RTOL, err_msg=k)
    empty = pdiag.stream_diag_from_draws(np.zeros((4, 0, 3), np.float32), lags, chains=4, ndim=3)
    assert all(not np.any(v) for v in empty.values())
    assert np.all(np.isnan(pdiag.ess_from_suffstats(*[empty[k] for k in FIELDS])))


def test_ess_from_suffstats_frozen_component_nan():
    draws = _ar1(3, 0.3, chains=3, n=500, d=2)
    draws[:, :, 1] = 7.0
    st = pdiag.stream_diag_from_draws(draws, 50)
    e = pdiag.ess_from_suffstats(*[st[k] for k in FIELDS])
    assert np.isfinite(e[0]) and np.isnan(e[1])


def test_draw_history_matches_reference():
    draws = _ar1(4, 0.5, chains=3, n=150, d=6)
    ref, port = rdiag.DrawHistory(3, 6), pdiag.DrawHistory(3, 6)
    assert port.view().shape == (3, 0, 6)
    for lo, hi in ((0, 40), (40, 41), (41, 150)):
        ref.append(draws[:, lo:hi])
        port.append(draws[:, lo:hi])
        assert port.rows == len(port) == ref.rows
        np.testing.assert_array_equal(port.view(), ref.view())
    cols = np.array([5, 0, 3])
    np.testing.assert_array_equal(port.take(cols), ref.take(cols))
    with pytest.raises(ValueError):
        port.append(np.zeros((2, 4, 6), np.float32))


def _torch_accumulate(draws, lags):
    c, n, d = draws.shape
    s = pbase.stream_diag_init(c, d, lags, device="cpu")
    x = torch.as_tensor(draws)
    for t in range(n):
        s = pbase.stream_diag_update(s, x[:, t])
    return s


@pytest.mark.parametrize("shape,lags", [((3, 37, 5), 8), ((4, 120, 3), 50), ((2, 6, 4), 8)])
def test_torch_accumulator_matches_reference_scan(shape, lags):
    rng = np.random.default_rng(5)
    draws = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    c, n, d = shape

    def run_chain(xs):
        def body(s, x):
            return rbase.stream_diag_update(s, x), None

        s, _ = jax.lax.scan(body, rbase.stream_diag_init(d, lags), xs)
        return s

    ref = jax.vmap(run_chain)(jnp.asarray(draws))
    port = _torch_accumulate(draws, lags)
    host = pdiag.stream_diag_from_draws(draws, lags)
    for k in FIELDS:
        got = getattr(port, k).numpy()
        assert got.shape == np.asarray(getattr(ref, k)).shape, k
        np.testing.assert_allclose(got, np.asarray(getattr(ref, k)), rtol=SCAN_RTOL,
                                   atol=SCAN_ATOL, err_msg=k)
        np.testing.assert_allclose(got, host[k], rtol=SCAN_RTOL, atol=SCAN_ATOL, err_msg=k)
    e_port = pdiag.ess_from_suffstats(*[getattr(port, k).numpy() for k in FIELDS])
    e_ref = rdiag.ess_from_suffstats(*[np.asarray(getattr(ref, k)) for k in FIELDS])
    np.testing.assert_allclose(e_port, e_ref, rtol=ESS_RTOL)


def test_diag_segment_draws_bitwise_equal_plain_segment():
    model = FusedHierLogisticGrouped(3, 4)
    raw, _ = synth_logistic_data(0, 400, 3, num_groups=4)
    data = prepare_model_data(model, raw, device="cpu")
    fm = flatten_model(model)
    cfg = SamplerConfig(num_warmup=30, init_step_size=0.1, map_init_steps=5)
    parts = make_chees_parts(fm, cfg)
    gen = torch.Generator().manual_seed(0)
    carry = parts.init_carry(chees_init_positions(fm, gen, 6, None, "cpu"), data)
    sched = parts.schedule
    carry, _ = parts.warm_segment(
        carry, TorchNoise(gen), (2.0 * halton(30)).astype(np.float32), np.arange(30),
        sched.adapt_mass, sched.window_end, data,
    )
    run = parts.finalize(carry)
    us = (2.0 * halton(12)).astype(np.float32)
    plain_carry, plain = parts.sample_segment(run, TorchNoise(torch.Generator().manual_seed(9)), us, data)
    diag0 = pbase.stream_diag_init(6, fm.ndim, 8, device="cpu")
    diag_carry, diag, outs = parts.sample_segment_diag(
        run, diag0, TorchNoise(torch.Generator().manual_seed(9)), us, data
    )
    for a, b in zip(plain, outs):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(plain_carry.states.z, diag_carry.states.z)
    # the carried accumulator is the one the draws give
    want = _torch_accumulate(np.ascontiguousarray(outs[0].transpose(1, 0, 2)), 8)
    for k in FIELDS:
        assert torch.equal(getattr(diag, k), getattr(want, k)), k
