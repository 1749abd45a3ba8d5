"""The port's per-chain sampler frontend (`stark_tpu_torch.sampler`, the
backend's NUTS/HMC run, the adaptive runner's per-chain branch) and its
adaptation against the JAX package.

* The initial step-size search gives exactly the reference's step sizes
  (every chain's doubling or halving decisions, replayed noise), and one
  warmup segment of per-chain NUTS (dual averaging, Welford, a metric
  window end) matches the reference's to rtol 1e-6 in float64.
* The port's `SamplerConfig` carries the reference's default on every
  field the reference has: the default sampler is NUTS.
* End to end on the CPU: the reference's ``sample_stats`` keys and shapes,
  the single loop and ``dispatch_steps`` bitwise alike, thinning.
* The runner with NUTS: resume bitwise from a warmup and from a sampling
  checkpoint, and a sampling checkpoint laid out as the reference's.
* 8 schools (BASELINE config 1): the potential against the reference's;
  posterior means against the reference's and the published values
  (slow).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
from stark_tpu import adaptation as radapt
from stark_tpu import checkpoint as rckpt
from stark_tpu import sampler as rsampler
from stark_tpu.kernels import base as rbase
from stark_tpu.model import flatten_model as ref_flatten
from stark_tpu.models import eight_schools as res
from stark_tpu.models import logistic as rml
from stark_tpu_torch import adaptation as padapt
from stark_tpu_torch import sample, sample_until_converged
from stark_tpu_torch import sampler as psampler
from stark_tpu_torch.backends import CudaBackend
from stark_tpu_torch.checkpoint import load_checkpoint
from stark_tpu_torch.kernels import base as pbase
from stark_tpu_torch.model import flatten_model, prepare_model_data
from stark_tpu_torch.models import EightSchools, eight_schools_data
from stark_tpu_torch.models import logistic as pml
from test_torch_nuts import (
    X64_ATOL,
    X64_RTOL,
    ReplayNoise,
    one_torch_thread,  # noqa: F401 (autouse: one intra-op thread)
    float64_pair,
    grouped_pair,
    hier_logistic_raw,
    reference_nuts_noise,
)

CHAINS = 4


def _t(a):
    return torch.as_tensor(np.array(a))


def _reference_momenta(keys, d):
    """find_reasonable_step_size's draw: one normal of its key per chain."""
    dtype = jnp.zeros(()).dtype
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (d,), dtype))(keys))


def _step_size_search(rpot, ppot, ndim, dtype, init_step):
    rs = np.random.RandomState(7)
    # spread chains: some double from init_step, some halve
    z = jnp.asarray((rs.standard_normal((6, ndim)) * np.array([0.05, 0.1, 0.5, 1, 2, 3])[:, None])
                    .astype(dtype))
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    st = jax.vmap(lambda zz: rbase.init_state(rpot, zz))(z)
    mass = jnp.ones((6, ndim), dtype)
    want = jax.jit(jax.vmap(lambda zz, pe, g, m, k: radapt.find_reasonable_step_size(
        rpot, zz, pe, g, m, k, init_step)))(st.z, st.potential_energy, st.grad, mass, keys)
    got, evals = padapt.find_reasonable_step_size(
        ReplayNoise([_reference_momenta(keys, ndim)]), ppot, _t(st.z), _t(st.potential_energy),
        _t(st.grad), _t(mass), init_step)
    return got.numpy(), np.asarray(want), evals


@pytest.mark.parametrize("init_step", [1.0, 1e-3])
def test_find_reasonable_step_size_matches_reference_exactly(init_step):
    rpot, ppot, ndim = float64_pair()
    with jax.enable_x64(True):
        got, want, evals = _step_size_search(rpot, ppot, ndim, np.float64, init_step)
    np.testing.assert_array_equal(got, want)
    # powers of two times the start, both ways among the chains at the
    # small start; one evaluation per round after the first
    k = np.log2(want / init_step)
    np.testing.assert_array_equal(k, np.round(k))
    assert evals == 1 + int(np.max(np.abs(k)))
    if init_step < 1:
        assert k.min() < k.max()


def test_find_reasonable_step_size_matches_reference_grouped_float32():
    rpot, ppot, ndim = grouped_pair()
    got, want, _ = _step_size_search(rpot, ppot, ndim, np.float32, 1.0)
    np.testing.assert_array_equal(got, want)


def _port_warm_carry(rc):
    """The reference's vmapped warmup carry as the port's."""
    state, da, wf, mass = rc
    return psampler.WarmCarry(
        pbase.HMCState(_t(state.z), _t(state.potential_energy), _t(state.grad)),
        padapt.DualAveragingState(_t(da.log_step), _t(da.log_avg_step), _t(da.h_avg), _t(da.mu),
                                  int(da.count[0])),
        padapt.WelfordState(int(wf.count[0]), _t(wf.mean), _t(wf.m2)),
        _t(mass),
    )


def test_one_warmup_segment_matches_reference_in_float64():
    """Per-chain NUTS warmup: the carry init (the step-size search) gives
    the reference's step sizes exactly; then, from the reference's carry
    after 30 of 40 warmup transitions, one segment of the last 10 —
    Welford accumulation, the metric window's end at step 35 (metric
    refresh, Welford and dual-averaging restart), dual averaging on —
    matches the reference's to rtol 1e-6.  (A free-running float64 pair
    drifts by about 2.5x per transition: dual averaging scales the
    accept-probability roundoff by 20 sqrt(t); so the segment starts from
    the reference's carry.)"""
    num_warmup, depth, start = 40, 5, 30
    rpot, ppot, ndim = float64_pair()
    raw = hier_logistic_raw()
    pmodel = pml.HierLogistic(4, 10)
    pdata = prepare_model_data(pmodel, raw, device="cpu")
    cfg = dict(kernel="nuts", num_warmup=num_warmup, max_tree_depth=depth)
    sched = radapt.build_warmup_schedule(num_warmup)
    assert np.flatnonzero(sched.window_end).tolist() == [35]
    rs = np.random.RandomState(3)
    parts = psampler.make_warmup_parts(flatten_model(pmodel), psampler.SamplerConfig(**cfg))
    with jax.enable_x64(True):
        rdata = {k: jnp.asarray(v) for k, v in raw.items()}
        rfm = ref_flatten(rml.HierLogistic(4, 10))
        init_carry, segment, finalize = rsampler.make_warmup_parts(rfm, rsampler.SamplerConfig(**cfg))
        z0 = jnp.asarray(0.4 * rs.standard_normal((CHAINS, ndim)))
        kinit = jax.random.split(jax.random.PRNGKey(4), CHAINS)
        rcarry = jax.jit(jax.vmap(init_carry, in_axes=(0, 0, None)))(kinit, z0, rdata)
        noise = ReplayNoise([_reference_momenta(kinit, ndim)])
        carry, _ = parts.init_carry(noise, _t(z0), pdata)
        np.testing.assert_array_equal(carry.da.log_step.numpy(), np.asarray(rcarry[1].log_step))
        wkeys = jax.random.split(jax.random.PRNGKey(5), num_warmup * CHAINS).reshape(
            num_warmup, CHAINS, -1)
        seg = jax.jit(jax.vmap(segment, in_axes=(1, None, None, 0, 0, 0, 0, None)))
        flags = (jnp.asarray(sched.adapt_mass), jnp.asarray(sched.window_end))
        rmid = seg(wkeys[:start], flags[0][:start], flags[1][:start], *rcarry, rdata)[:4]
        rstate, rda, rwf, rmass, rdiv = seg(wkeys[start:], flags[0][start:], flags[1][start:],
                                            *rmid, rdata)
        rstep = jax.vmap(finalize)(rda)
        draws = []
        for t in range(start, num_warmup):
            draws += reference_nuts_noise(wkeys[t], ndim, depth)
    noise = ReplayNoise(draws)
    carry, n_div, evals = parts.segment(_port_warm_carry(rmid), noise, sched.adapt_mass[start:],
                                        sched.window_end[start:], pdata)
    assert noise.done() and evals >= num_warmup - start

    def close(got, want, what):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=X64_RTOL,
                                   atol=X64_ATOL, err_msg=what)

    np.testing.assert_array_equal(n_div.numpy(), np.asarray(rdiv))
    for f in ("log_step", "log_avg_step", "h_avg", "mu"):
        close(getattr(carry.da, f), getattr(rda, f), f)
    assert carry.da.count == int(rda.count[0]) == num_warmup - 35 - 1
    assert carry.wf.count == int(rwf.count[0]) == 0
    close(carry.wf.mean, rwf.mean, "welford mean")
    close(carry.wf.m2, rwf.m2, "welford m2")
    close(carry.inv_mass, rmass, "inverse mass")
    assert not np.allclose(np.asarray(rmass), np.asarray(rmid[3]))  # the window refreshed it
    close(carry.states.z, rstate.z, "z")
    close(parts.finalize(carry), rstep, "step size")
    # and the Welford moments just before the window closed
    mid, _, _ = parts.segment(_port_warm_carry(rmid), ReplayNoise(draws[:4 * 5]),
                              sched.adapt_mass[start:35], sched.window_end[start:35], pdata)
    with jax.enable_x64(True):
        want = seg(wkeys[start:35], flags[0][start:35], flags[1][start:35], *rmid, rdata)[2]
    assert mid.wf.count == int(want.count[0]) == int(sched.adapt_mass[:35].sum())
    close(mid.wf.mean, want.mean, "welford mean at step 34")
    close(mid.wf.m2, want.m2, "welford m2 at step 34")


def test_config_defaults_are_the_reference_defaults():
    """Every field of the reference's SamplerConfig is the port's, with
    the same default: plain ``sample(model, data)`` runs NUTS in both."""
    ref = {f.name: f.default for f in dataclasses.fields(rsampler.SamplerConfig)}
    port = {f.name: f.default for f in dataclasses.fields(psampler.SamplerConfig)}
    assert {k: port.get(k, "missing") for k in ref} == ref
    assert psampler.SamplerConfig().kernel == "nuts"


def test_progress_every_is_refused():
    with pytest.raises(NotImplementedError, match="A12"):
        psampler.SamplerConfig(progress_every=10)
    with pytest.raises(NotImplementedError, match="A12"):
        sample(EightSchools(), eight_schools_data(), device="cpu", progress_every=5)


def _tiny(kernel, **kw):
    raw, _ = pml.synth_logistic_data(0, 600, 2, num_groups=3)
    kw = {"device": "cpu", "num_samples": 12, **kw}
    return sample(pml.FusedHierLogisticGrouped(2, 3), raw, chains=3, num_warmup=30, seed=5,
                  kernel=kernel, max_tree_depth=4, num_leapfrog=5, **kw)


@pytest.fixture(scope="module")
def reference_stats():
    """The reference's per-chain sample_stats on 8 schools."""
    post = stark_tpu.sample(res.EightSchools(), res.eight_schools_data(), chains=3,
                            num_warmup=20, num_samples=12, seed=0, max_tree_depth=4)
    return post.sample_stats


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_sample_end_to_end_with_the_reference_stats(kernel, reference_stats):
    post = _tiny(kernel)
    st = post.sample_stats
    assert set(reference_stats) <= set(st)
    assert set(st) - set(reference_stats) == {"num_ensemble_grad_evals",
                                              "num_warmup_ensemble_grad_evals"}
    d = post.draws_flat.shape[2]
    for k, v in reference_stats.items():
        want = np.shape(v)
        if len(want) and want[-1] == 10:  # the per-chain metric: 8 schools' d
            want = want[:-1] + (d,)
        assert np.shape(st[k]) == want, k
    assert post.draws["beta"].shape == (3, 12, 2)
    assert all(np.all(np.isfinite(v)) for v in post.draws.values())
    assert st["dispatch_steps"] == 0 and st["dispatch_auto"] is False
    ngrad = st["num_grad_evals"]
    if kernel == "hmc":
        assert np.all(ngrad == 5)
    assert int(st["num_ensemble_grad_evals"]) > int(st["num_warmup_ensemble_grad_evals"])
    # the lockstep loop makes at least the longest chain's evaluations
    samp = int(st["num_ensemble_grad_evals"]) - int(st["num_warmup_ensemble_grad_evals"])
    assert samp >= ngrad.max(axis=0).sum()


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_dispatch_steps_draws_bitwise_what_the_single_loop_draws(kernel):
    whole = _tiny(kernel)
    for steps in (7, 100):
        seg = _tiny(kernel, backend=CudaBackend("cpu", dispatch_steps=steps))
        np.testing.assert_array_equal(seg.draws_flat, whole.draws_flat)
        for k in ("accept_prob", "energy", "num_grad_evals", "step_size", "inv_mass_diag",
                  "num_divergent", "num_ensemble_grad_evals"):
            np.testing.assert_array_equal(seg.sample_stats[k], whole.sample_stats[k], err_msg=k)
        assert seg.sample_stats["dispatch_steps"] == steps


def test_thinning_keeps_every_thin_th_transition():
    whole = _tiny("nuts", backend=CudaBackend("cpu", dispatch_steps=5))
    thin = _tiny("nuts", thin=2, num_samples=6)
    np.testing.assert_array_equal(thin.draws_flat, whole.draws_flat[:, 1::2])
    np.testing.assert_array_equal(thin.sample_stats["num_divergent"],
                                  whole.sample_stats["num_divergent"])
    again = _tiny("nuts", thin=2, num_samples=6, backend=CudaBackend("cpu", dispatch_steps=5))
    np.testing.assert_array_equal(again.draws_flat, thin.draws_flat)


def test_chain_runner_is_the_one_segmented_loop():
    model = pml.FusedHierLogisticGrouped(2, 3)
    raw, _ = pml.synth_logistic_data(0, 600, 2, num_groups=3)
    fm = flatten_model(model)
    cfg = psampler.SamplerConfig(num_warmup=20, num_samples=15, max_tree_depth=4)
    data = prepare_model_data(model, raw, device="cpu")
    from stark_tpu_torch.kernels.chees import TorchNoise

    run = psampler.make_chain_runner(fm, cfg)
    posts = []
    for seg in (None, 4):
        g0, g1, g2 = psampler.chain_streams(1, torch.device("cpu"))
        posts.append(run(TorchNoise(g1), TorchNoise(g2), fm.init_flat(3, g0, "cpu"), data, seg))
    whole, seg4 = posts
    np.testing.assert_array_equal(seg4.draws_flat, whole.draws_flat)
    assert whole.draws_flat.shape == (3, 15, fm.ndim)
    assert (whole.sample_stats["dispatch_steps"], seg4.sample_stats["dispatch_steps"]) == (0, 4)
    np.testing.assert_array_equal(whole.sample_stats["num_divergent"],
                                  whole.sample_stats["is_divergent"].sum(1))
    # the backend's run is this runner on `chain_streams`' generators
    ref = sample(model, raw, chains=3, seed=1, num_warmup=20, num_samples=15, max_tree_depth=4,
                 device="cpu")
    np.testing.assert_array_equal(ref.draws_flat, whole.draws_flat)


def test_ragged_nuts_is_refused(monkeypatch):
    fm = flatten_model(EightSchools())
    with pytest.raises(NotImplementedError, match="A8, ragged NUTS"):
        psampler.make_block_runner(fm, psampler.SamplerConfig(), 10, ragged=True)
    monkeypatch.setenv("STARK_RAGGED_NUTS", "1")
    with pytest.raises(NotImplementedError, match="A8, ragged NUTS"):
        sample(EightSchools(), eight_schools_data(), device="cpu", num_warmup=2, num_samples=2)
    # HMC has no ragged form: the knob leaves it alone
    sample(EightSchools(), eight_schools_data(), kernel="hmc", device="cpu", num_warmup=2,
           num_samples=2, num_leapfrog=2)


# ------------------------------------------------------------- the runner

RUN = dict(chains=4, block_size=10, max_blocks=3, min_blocks=3, rhat_target=0.0, num_warmup=40,
           kernel="nuts", max_tree_depth=5, device="cpu")


def _paths(tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    return dict(checkpoint_path=str(d / "c.npz"), draw_store_path=str(d / "d.stkr"),
                metrics_path=str(d / "m.jsonl"))


def _records(path, event):
    return [r for r in map(json.loads, open(path)) if r["event"] == event]


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_runner_draws_what_sample_draws_and_resumes_bitwise_from_a_block(tmp_path, kernel):
    kw = dict(RUN, kernel=kernel, num_leapfrog=6)
    whole = sample_until_converged(EightSchools(), eight_schools_data(), seed=3, **kw,
                                   **_paths(tmp_path, "whole"))
    # the runner's streams are `sample`'s: the same draws, block by block
    ref = sample(EightSchools(), eight_schools_data(), seed=3, num_samples=30,
                 **{k: v for k, v in kw.items() if k not in ("block_size", "max_blocks",
                                                               "min_blocks", "rhat_target")})
    np.testing.assert_array_equal(whole.draws_flat, ref.draws_flat)
    assert int(whole.sample_stats["num_ensemble_grad_evals"]) == int(
        ref.sample_stats["num_ensemble_grad_evals"])
    assert [r["grad_eval_basis"] for r in whole.history] == [
        "tree_leaves" if kernel == "nuts" else "leapfrog"] * 3
    assert sum(r["block_grad_evals"] for r in whole.history) == int(
        ref.sample_stats["num_grad_evals"].sum())
    if kernel == "nuts":
        from stark_tpu_torch.kernels.nuts import tree_depth_from_leaves

        depth = tree_depth_from_leaves(ref.sample_stats["num_grad_evals"])
        lo = 0
        for r in whole.history:
            hi = r["draws_per_chain"]
            assert r["tree_depth_max"] == int(depth[:, lo:hi].max())
            assert r["tree_depth_mean"] == pytest.approx(depth[:, lo:hi].mean())
            lo = hi
    else:
        assert "tree_depth_max" not in whole.history[0]
    p = _paths(tmp_path, "cut")
    first = sample_until_converged(EightSchools(), eight_schools_data(), seed=3,
                                   time_budget_s=0.0, **kw, **p)
    assert first.budget_exhausted and len(first.history) == 1
    resumed = sample_until_converged(EightSchools(), eight_schools_data(), seed=3,
                                     resume_from=p["checkpoint_path"], **kw, **p)
    np.testing.assert_array_equal(resumed.draws_flat, whole.draws_flat)


class FaultyWarmup(CudaBackend):
    """Raises in the ``fail_at``-th warmup segment (1-based)."""

    def __init__(self, fail_at):
        super().__init__("cpu")
        self.fail_at = fail_at

    def adaptive_parts(self, model, cfg, data):
        ap = super().adaptive_parts(model, cfg, data)
        calls = {"n": 0}

        def warm(*a):
            calls["n"] += 1
            if calls["n"] == self.fail_at:
                raise RuntimeError("injected warmup fault")
            return ap.warm_j(*a)

        return ap._replace(warm_j=warm)


def test_runner_resumes_nuts_bitwise_from_a_warmup_checkpoint(tmp_path):
    kw = {k: v for k, v in RUN.items() if k != "device"}
    whole = sample_until_converged(EightSchools(), eight_schools_data(), seed=4, device="cpu",
                                   **kw, **_paths(tmp_path, "whole"))
    p = _paths(tmp_path, "cut")
    with pytest.raises(RuntimeError, match="injected warmup fault"):
        sample_until_converged(EightSchools(), eight_schools_data(), seed=4,
                               backend=FaultyWarmup(3), **kw, **p)
    arrays, meta = load_checkpoint(p["checkpoint_path"])
    assert meta["phase"] == "warmup" and meta["warm_done"] == 20 and meta["kernel"] == "nuts"
    for k in ("da_log_step", "da_mu", "da_count", "wf_count", "wf_m2", "key", "key_warm"):
        assert k in arrays, k
    assert arrays["step_size"].shape == (4,) and arrays["inv_mass"].shape == (4, 10)
    resumed = sample_until_converged(EightSchools(), eight_schools_data(), seed=4, device="cpu",
                                     resume_from=p["checkpoint_path"], **kw, **p)
    np.testing.assert_array_equal(resumed.draws_flat, whole.draws_flat)
    done = _records(p["metrics_path"], "warmup_done")
    assert len(done) == 1 and done[0]["resumed_from_step"] == 20
    (whole_done,) = _records(str(tmp_path / "whole" / "m.jsonl"), "warmup_done")
    assert done[0]["step_size"] == whole_done["step_size"]
    assert done[0]["warmup_grad_evals"] == whole_done["warmup_grad_evals"]


def test_sampling_checkpoint_is_laid_out_as_the_reference_one(tmp_path):
    """The port's per-chain sampling checkpoint holds the reference's
    arrays with the reference's shapes, dtypes and metadata keys (the
    reference's own per-chain checkpoint is the yardstick), and each
    package loads the other's file."""
    ckpt = str(tmp_path / "p.npz")
    kw = dict(chains=4, block_size=10, max_blocks=2, min_blocks=2, rhat_target=0.0,
              num_warmup=20, max_tree_depth=4, seed=1)
    sample_until_converged(EightSchools(), eight_schools_data(), device="cpu",
                           checkpoint_path=ckpt, **kw)
    rpath = str(tmp_path / "r.npz")
    stark_tpu.sample_until_converged(res.EightSchools(), res.eight_schools_data(),
                                     checkpoint_path=rpath, **kw)
    arrays, meta = load_checkpoint(ckpt)
    rarrays, rmeta = rckpt.load_checkpoint(rpath)
    assert sorted(arrays) == sorted(rarrays)
    for k in arrays:
        if k == "key":  # a torch generator's state where the reference keeps a key
            continue
        assert arrays[k].shape == rarrays[k].shape, k
        assert arrays[k].dtype == rarrays[k].dtype, k
    assert sorted(meta) == sorted(rmeta) and meta["kernel"] == rmeta["kernel"] == "nuts"
    back, back_meta = rckpt.load_checkpoint(ckpt)
    assert back_meta == meta and all(np.array_equal(back[k], arrays[k]) for k in arrays)
    again, _ = load_checkpoint(rpath)
    assert all(np.array_equal(again[k], rarrays[k]) for k in rarrays)


# ------------------------------------------------------------- 8 schools


def test_eight_schools_potential_matches_reference():
    z = np.random.RandomState(0).standard_normal((5, 10)).astype(np.float32)
    rfm = ref_flatten(res.EightSchools())
    rpot = rfm.bind(res.eight_schools_data())
    want_v, want_g = jax.vmap(rpot.value_and_grad)(jnp.asarray(z))
    model = EightSchools()
    pot = flatten_model(model).bind(prepare_model_data(model, eight_schools_data(), device="cpu"))
    v, g = pot.value_and_grad(torch.as_tensor(z))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-5)
    assert list(model.param_spec()) == list(res.EightSchools().param_spec())


@pytest.mark.slow
def test_eight_schools_posterior_matches_reference_and_published_values():
    """The verify recipe's run (4 chains, 500 warmup, 500 draws, NUTS at
    the default depth): means within 4 combined MCSE of the reference's,
    and near the published mu 4.4, tau 3.6."""
    from stark_tpu_torch import diagnostics as pdiag

    kw = dict(chains=4, num_warmup=500, num_samples=500, seed=1)
    rpost = stark_tpu.sample(res.EightSchools(), res.eight_schools_data(), **kw)
    ppost = sample(EightSchools(), eight_schools_data(), device="cpu", **kw)
    assert ppost.max_rhat() < 1.01
    assert ppost.num_divergent < 0.01 * 4 * 500
    for k in ("mu", "tau", "theta_raw"):
        r, p = np.asarray(rpost.draws[k]), ppost.draws[k]
        se = np.sqrt(pdiag.mcse_mean(r) ** 2 + pdiag.mcse_mean(p) ** 2)
        diff = np.abs(r.reshape(-1, *r.shape[2:]).mean(0) - p.reshape(-1, *p.shape[2:]).mean(0))
        assert np.all(diff < 4 * se), (k, diff, se)
    s = ppost.summary()
    assert abs(float(s["mu"]["mean"]) - 4.4) < 4 * float(s["mu"]["mcse_mean"])
    assert abs(float(s["tau"]["mean"]) - 3.6) < 4 * float(s["tau"]["mcse_mean"])
