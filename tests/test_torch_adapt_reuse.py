"""Adaptation reuse in the port's runner (`adapt_path`,
`adapt_export_path`), on the CPU, against the JAX package where the two
can meet.

`load_adapt_state` gives the reference's results and reasons on the same
files (the cases of tests/test_adapt_reuse.py, a corrupt file added); the
artifact crosses between the packages in both directions (a data-free
model, whose fingerprint is "none" in both); the imported start
positions equal the reference runner's bitwise (numpy on both sides);
one touch-up, from the reference's carry with its randomness replayed,
matches the reference's at tests/test_torch_chees.py's tolerances.  The
rest runs the port alone on 8 schools with a budget of seconds; the
reference's convergence runs are ported as slow tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
from stark_tpu import chees as rchees
from stark_tpu import checkpoint as rckpt
from stark_tpu import runner as rrunner
from stark_tpu.adaptation import da_init as ref_da_init
from stark_tpu.backends.jax_backend import JaxBackend
from stark_tpu.sampler import SamplerConfig as RefConfig
from stark_tpu_torch import data_fingerprint, load_adapt_state, runner, sample_until_converged
from stark_tpu_torch import chees as pchees
from stark_tpu_torch.backends import CudaBackend
from stark_tpu_torch.backends.cuda_backend import _chees_parts
from stark_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from stark_tpu_torch.kernels.chees import halton
from stark_tpu_torch.models import EightSchools, eight_schools_data
from stark_tpu_torch.sampler import SamplerConfig
from test_torch_chees import (
    ReplayNoise,
    _close,
    _flagship_family,
    _port_warm_carry,
    _reference_noise,
)
from test_torch_runner import RefScaledNormal, ScaledNormal

ARR = {"z": np.zeros((4, 3), np.float32), "log_eps": np.zeros((), np.float32),
       "log_T": np.zeros((), np.float32), "inv_mass": np.ones(3, np.float32)}


def _records(path, event=None):
    recs = [json.loads(line) for line in open(path)]
    return [r for r in recs if event is None or r["event"] == event]


# ---------------------------------------------------------------- artifact


def _both(path, **kw):
    """(port's, reference's) load_adapt_state on one file."""
    args = dict(kernel="chees", model_name="M", ndim=3)
    args.update(kw)
    return load_adapt_state(path, **args), rrunner.load_adapt_state(path, **args)


def _same_outcome(port, ref):
    (pa, pr), (ra, rr) = port, ref
    assert pr == rr
    assert (pa is None) == (ra is None)
    if pa is not None:
        assert sorted(pa) == sorted(ra)
        for k in pa:
            np.testing.assert_array_equal(pa[k], ra[k])


def test_load_adapt_state_gives_the_references_results_and_reasons(tmp_path):
    p = str(tmp_path / "a.npz")
    port, ref = _both(p)
    assert port == (None, None)  # no file: no reason
    _same_outcome(port, ref)

    save_checkpoint(p, ARR, {"kernel": "chees", "model": "M", "data_fp": "abc"})
    port, ref = _both(p)
    assert port[0] is not None and port[1] is None
    _same_outcome(port, ref)
    for kw in (dict(ndim=4), dict(model_name="Other"), dict(kernel="nuts")):
        port, ref = _both(p, **kw)
        assert port[0] is None and port[1].startswith("mismatch: kernel=chees model=M ndim=3")
        _same_outcome(port, ref)
    # the dataset: another fingerprint, and one the artifact lacks
    port, ref = _both(p, data_fp="abc")
    assert port[0] is not None
    _same_outcome(port, ref)
    port, ref = _both(p, data_fp="def")
    assert port[0] is None and "different dataset" in port[1]
    _same_outcome(port, ref)
    save_checkpoint(p, ARR, {"kernel": "chees", "model": "M"})
    port, ref = _both(p, data_fp="abc")
    assert port[0] is None and "data_fp=None" in port[1]
    _same_outcome(port, ref)

    # a warmup checkpoint (no log_eps) is rejected, not a crash
    save_checkpoint(p, {"z": ARR["z"], "inv_mass": ARR["inv_mass"]},
                    {"kernel": "chees", "model": "M", "phase": "warmup"})
    port, ref = _both(p)
    assert port[0] is None and port[1] == "missing arrays: ['log_eps', 'log_T']"
    _same_outcome(port, ref)

    with open(p, "wb") as f:
        f.write(b"not an npz file")
    port, ref = _both(p)
    assert port[0] is None and port[1]
    _same_outcome(port, ref)


def test_data_fingerprint_edges():
    fp = data_fingerprint
    a = {"x": np.ones((4, 2)), "y": np.zeros(4)}
    assert fp(a) == fp(a) == fp({"y": np.zeros(4), "x": np.ones((4, 2))})
    assert fp(None) == "none"
    assert fp(a) != fp({"x": np.ones((2, 4)), "y": np.zeros(4)})  # shape
    assert fp(a) != fp({"x": np.ones((4, 2), np.float32), "y": np.zeros(4)})  # dtype
    assert fp(a) != fp({"x": np.ones((4, 2)), "y": np.zeros(4) + 1e-9})  # values
    assert fp(a) != fp({"x": np.ones((4, 2)), "z": np.zeros(4)})  # keys
    assert fp(a) != fp([np.ones((4, 2)), np.zeros(4)]) != fp((np.ones((4, 2)), np.zeros(4)))
    assert fp({"x": None}) != fp({"x": np.zeros(())})
    assert isinstance(fp({"x": np.ones(3), "meta": object()}), str)
    # a CPU tensor is the same buffer as the numpy array
    t = {"x": torch.arange(12.0).reshape(4, 3), "g": torch.arange(4, dtype=torch.int32),
         "m": torch.tensor([True, False])}
    n = {k: v.numpy() for k, v in t.items()}
    assert fp(t) == fp(n)
    # a large leaf: the strided 64 KiB sample, the same for a tensor and
    # its array, and it still sees a shift of the whole array
    big = np.arange(1_000_000, dtype=np.float64)
    assert fp({"x": big}) == fp({"x": big.copy()}) == fp({"x": torch.from_numpy(big)})
    assert fp({"x": big}) != fp({"x": big + 1.0})


def test_artifacts_cross_between_the_packages(tmp_path):
    """The reference's runner writes an artifact the port loads (no data,
    so both fingerprints are "none"), and the port's runner writes one
    the reference loads and imports."""
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    small = dict(chains=4, kernel="chees", init_step_size=0.5, num_warmup=10, block_size=5,
                 max_blocks=0, seed=0)
    stark_tpu.sample_until_converged(RefScaledNormal(), adapt_export_path=ref_path, **small)
    arrays, reason = load_adapt_state(ref_path, kernel="chees", model_name="RefScaledNormal",
                                      ndim=3, data_fp=data_fingerprint(None))
    assert reason is None and arrays["z"].shape == (4, 3)

    sample_until_converged(ScaledNormal(), adapt_export_path=port_path, device="cpu", **small)
    arrays, meta = rckpt.load_checkpoint(port_path)
    assert meta == {"kernel": "chees", "model": "ScaledNormal", "num_warmup": 10,
                    "data_fp": "none"}
    assert {k: arrays[k].dtype for k in arrays} == {k: np.dtype(np.float32) for k in ARR}
    got, reason = rrunner.load_adapt_state(port_path, kernel="chees", model_name="ScaledNormal",
                                           ndim=3, data_fp=rrunner.data_fingerprint(None))
    assert reason is None
    # a dataset's fingerprints differ between the packages: an artifact
    # of one is another dataset to the other
    data = eight_schools_data()
    assert data_fingerprint(data) != rrunner.data_fingerprint(data)


class _Captured(Exception):
    pass


def _first_put(parts):
    """The parts with a put_chains that records its first argument (the
    start positions) and ends the run there."""
    seen = []

    def put(x):
        seen.append(np.asarray(x))
        raise _Captured

    return parts._replace(put_chains=put), seen


class _RefCapture(JaxBackend):
    def adaptive_parts(self, model, cfg, data):
        ap, self.seen = _first_put(super().adaptive_parts(model, cfg, data))
        return ap


class _PortCapture(CudaBackend):
    def adaptive_parts(self, model, cfg, data):
        ap, self.seen = _first_put(super().adaptive_parts(model, cfg, data))
        return ap


@pytest.mark.parametrize("chains", [3, 5, 11])
def test_import_starts_equal_the_references_bitwise(tmp_path, chains):
    """Fewer, as many and more chains than the artifact's 5: the
    reference's runner and the port's start the imported run at the
    same bits."""
    path = str(tmp_path / "a.npz")
    rs = np.random.RandomState(0)
    z = rs.standard_normal((5, 3)).astype(np.float32)
    z[:, 2] = 1.5  # a dimension without spread takes the 0.05 scale
    save_checkpoint(path, dict(ARR, z=z), {"kernel": "chees", "model": "ScaledNormal",
                                           "data_fp": "none"})
    kw = dict(chains=chains, kernel="chees", adapt_path=path, num_warmup=10, seed=4)
    ref = _RefCapture()
    with pytest.raises(_Captured):
        # the reference names models by class: give its model the port's name
        stark_tpu.sample_until_converged(type("ScaledNormal", (RefScaledNormal,), {})(),
                                         backend=ref, **kw)
    port = _PortCapture("cpu")
    with pytest.raises(_Captured):
        sample_until_converged(ScaledNormal(), backend=port, **kw)
    want = runner.import_starts(z, chains, 4)
    np.testing.assert_array_equal(ref.seen[0], want)
    np.testing.assert_array_equal(port.seen[0], want)
    assert want.shape == (chains, 3) and want.dtype == np.float32
    assert np.unique(want, axis=0).shape[0] == chains  # tiled copies separate


def test_touchup_matches_the_reference_on_its_carry():
    """The imported carry, then each touch-up transition from the
    reference's carry with its noise replayed: the same leapfrog counts
    and divergences, states and step-size averaging within the run
    tolerances, and log T and the inverse mass exactly the imported
    ones."""
    chains, total = 8, 6
    rfm, pfm, rdata, pdata = _flagship_family()
    budget = dict(num_warmup=30, init_step_size=0.1, map_init_steps=2)
    rparts = rchees.make_chees_parts(rfm, RefConfig(kernel="chees", **budget))
    ap = _chees_parts(pfm, SamplerConfig(kernel="chees", **budget), torch.as_tensor,
                      torch.device("cpu"))
    rs = np.random.RandomState(3)
    z0 = (0.5 * rs.standard_normal((chains, pfm.ndim))).astype(np.float32)
    imported = {"log_eps": np.float32(np.log(0.05)), "log_T": np.float32(np.log(0.6)),
                "inv_mass": (0.5 + rs.rand(pfm.ndim)).astype(np.float32)}

    rc = rparts.init_carry(jax.random.PRNGKey(0), jnp.asarray(z0), rdata)
    ls = jnp.asarray(imported["log_eps"])
    rc = rc._replace(da=ref_da_init(jnp.exp(ls), mu=ls), log_T=jnp.asarray(imported["log_T"]),
                     inv_mass=jnp.asarray(imported["inv_mass"]))
    # the port's hook on the carry before the import (another step-size
    # prior and T) gives the reference's imported carry
    pc = ap["import_carry"](_port_warm_carry(rc._replace(
        da=rc.da._replace(mu=rc.da.mu + 1.0), log_T=rc.log_T + 1.0)), imported)
    for f in ("log_step", "log_avg_step", "h_avg", "mu"):
        _close(getattr(pc.da, f), getattr(rc.da, f), "imported da " + f, rtol=1e-6, atol=0)
    assert pc.da.count == 0

    us, idxs, aoff, woff = pchees.chees_touchup_arrays(total)
    np.testing.assert_array_equal(us, (2.0 * halton(total)).astype(np.float32))
    assert (idxs == -1).all() and not aoff.any() and not woff.any()
    warm = jax.jit(rparts.warm_segment)
    keys = jax.random.split(jax.random.PRNGKey(21), total)
    for i in range(total):
        sl = slice(i, i + 1)
        pc = _port_warm_carry(rc)
        rc, (rdiv, rleap) = warm(rc, keys[sl], jnp.asarray(us[sl]), jnp.asarray(idxs[sl]),
                                 jnp.asarray(aoff[sl]), jnp.asarray(woff[sl]), rdata)
        noise = ReplayNoise([_reference_noise(keys[i], chains, pfm.ndim)])
        pc, pdiv, pleap = ap["touch_j"](pc, noise, i, i + 1, total, pdata)
        assert noise.i == 1
        assert (pleap, pdiv) == (int(rleap), int(rdiv)), i
        what = f"touch-up step {i}"
        _close(pc.states.z, rc.states.z, what + " z")
        _close(pc.states.potential_energy, rc.states.potential_energy, what + " pe")
        _close(pc.da.log_step, rc.da.log_step, what + " log_step")
        _close(pc.da.log_avg_step, rc.da.log_avg_step, what + " log_avg_step")
        assert pc.log_T.numpy() == imported["log_T"], what
        np.testing.assert_array_equal(pc.inv_mass.numpy(), imported["inv_mass"], err_msg=what)
        assert pc.wf.count == 0, what


# ------------------------------------------------------------ the runner

# 8 schools with ChEES at a budget of seconds: 150 warmup, a 30-step touch-up
FAST = dict(chains=8, kernel="chees", init_step_size=0.1, num_warmup=150, max_leapfrog=64,
            block_size=20, min_blocks=1, max_blocks=2, rhat_target=0.0, device="cpu")


def _warm(path):
    (rec,) = _records(path, "warmup_done")
    return rec


def test_export_then_import_on_eight_schools(tmp_path):
    apath = str(tmp_path / "adapt.npz")
    m1, m2 = tmp_path / "m1.jsonl", tmp_path / "m2.jsonl"
    first = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                   metrics_path=str(m1), seed=0, **FAST)
    arrays, meta = load_checkpoint(apath)
    assert meta["data_fp"] == data_fingerprint(eight_schools_data())
    assert meta["kernel"] == "chees" and meta["model"] == "EightSchools"
    assert meta["num_warmup"] == 150 and sorted(arrays) == sorted(ARR)
    assert "adapt_imported" not in _warm(m1)
    before = open(apath, "rb").read()

    second = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                    metrics_path=str(m2), seed=7, map_init_steps=0, **FAST)
    warm = _warm(m2)
    assert warm["adapt_imported"] is True
    assert open(apath, "rb").read() == before
    recs = _records(m2)
    assert recs[0] == {"event": "adapt_export_skipped", "reason": "imported"}
    assert warm["warmup_grad_evals"] < 0.6 * _warm(m1)["warmup_grad_evals"]
    # the touch-up's evaluations are the call's before sampling
    sampled = sum(r["block_grad_evals"] for r in second.history) // 8
    assert int(second.sample_stats["num_ensemble_grad_evals"]) == (
        1 + warm["warmup_grad_evals"] // 8 + sampled)
    assert np.all(np.isfinite(second.draws_flat)) and second.draws_flat.shape == (8, 40, 10)
    assert np.all(np.isfinite(first.draws_flat))


def test_a_mismatched_artifact_falls_back_and_is_overwritten(tmp_path):
    from stark_tpu_torch.models import Logistic, synth_logistic_data

    apath = str(tmp_path / "adapt.npz")
    sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath, seed=0,
                           **FAST)
    data, _ = synth_logistic_data(0, 256, 3)
    m = tmp_path / "m.jsonl"
    kw = dict(FAST, chains=4)
    sample_until_converged(Logistic(num_features=3), data, adapt_path=apath, seed=1,
                           metrics_path=str(m), **kw)
    (rej,) = _records(m, "adapt_import_rejected")
    assert rej["reason"].startswith("mismatch: kernel=chees model=EightSchools ndim=10")
    assert "adapt_imported" not in _warm(m)
    assert load_checkpoint(apath)[1]["model"] == "Logistic"
    # another dataset of the same model and width is rejected too
    other, _ = synth_logistic_data(1, 256, 3)
    m3 = tmp_path / "m3.jsonl"
    sample_until_converged(Logistic(num_features=3), other, adapt_path=apath, seed=2,
                           metrics_path=str(m3), **kw)
    assert "different dataset" in _records(m3, "adapt_import_rejected")[0]["reason"]
    m4 = tmp_path / "m4.jsonl"
    sample_until_converged(Logistic(num_features=3), other, adapt_path=apath, seed=3,
                           map_init_steps=0, metrics_path=str(m4), **kw)
    assert _warm(m4)["adapt_imported"] is True


class _PoisonedWarmup(CudaBackend):
    """A warmup that ends in non-finite positions."""

    def adaptive_parts(self, model, cfg, data):
        ap = super().adaptive_parts(model, cfg, data)

        def finalize(carry):
            run = ap.finalize(carry)
            states = run.states._replace(z=run.states.z * float("nan"))
            return run._replace(states=states)

        return ap._replace(finalize=finalize)


def test_non_finite_state_is_not_exported(tmp_path):
    apath, m = str(tmp_path / "adapt.npz"), tmp_path / "m.jsonl"
    kw = dict(FAST, max_blocks=0)
    del kw["device"]
    sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                           backend=_PoisonedWarmup("cpu"), metrics_path=str(m), **kw)
    assert not os.path.exists(apath)
    assert _records(m, "adapt_export_skipped") == [
        {"event": "adapt_export_skipped", "reason": "non-finite warmup state"}]


def test_export_path_apart_from_the_import(tmp_path):
    """A pinned artifact is imported and never written; a fresh warmup
    exports to ``adapt_export_path`` only."""
    pinned, cache = str(tmp_path / "pinned.npz"), str(tmp_path / "cache.npz")
    sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=pinned,
                           adapt_export_path=cache, seed=0, **dict(FAST, max_blocks=0))
    assert not os.path.exists(pinned) and os.path.exists(cache)
    os.replace(cache, pinned)
    before = open(pinned, "rb").read()
    m = tmp_path / "m.jsonl"
    sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=pinned,
                           adapt_export_path=cache, seed=1, metrics_path=str(m),
                           **dict(FAST, max_blocks=0))
    assert _warm(m)["adapt_imported"] is True
    assert open(pinned, "rb").read() == before and not os.path.exists(cache)


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_per_chain_kernels_neither_import_nor_export(tmp_path, kernel):
    apath = str(tmp_path / "adapt.npz")
    kw = dict(chains=2, kernel=kernel, num_warmup=20, max_tree_depth=3, num_leapfrog=4,
              block_size=5, max_blocks=1, rhat_target=0.0, device="cpu", seed=0)
    m = tmp_path / "m.jsonl"
    plain = sample_until_converged(EightSchools(), eight_schools_data(), **kw)
    post = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                  metrics_path=str(m), **kw)
    assert not os.path.exists(apath)
    assert {r["event"] for r in _records(m)} == {"warmup_done", "block"}
    np.testing.assert_array_equal(post.draws_flat, plain.draws_flat)
    # an artifact on disk is not read either
    save_checkpoint(apath, dict(ARR, z=np.zeros((2, 10), np.float32),
                                inv_mass=np.ones(10, np.float32)),
                    {"kernel": kernel, "model": "EightSchools"})
    again = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath, **kw)
    np.testing.assert_array_equal(again.draws_flat, plain.draws_flat)


# ------------------------------------------- the reference's convergence runs

CONV = dict(chains=8, kernel="chees", block_size=100, min_blocks=1, max_blocks=6,
            ess_target=300.0, init_step_size=0.1, device="cpu")


@pytest.mark.slow
def test_adapt_export_then_import_converges(tmp_path):
    apath = str(tmp_path / "adapt.npz")
    m1, m2 = tmp_path / "m1.jsonl", tmp_path / "m2.jsonl"
    res1 = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                  metrics_path=str(m1), seed=0, **CONV)
    assert res1.converged and os.path.exists(apath)
    before = open(apath, "rb").read()
    res2 = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                  metrics_path=str(m2), seed=7, map_init_steps=0, **CONV)
    warm = _warm(m2)
    assert warm.get("adapt_imported") is True and res2.converged
    assert open(apath, "rb").read() == before
    assert abs(float(np.mean(res1.draws["mu"])) - float(np.mean(res2.draws["mu"]))) < 1.0
    assert warm["warmup_grad_evals"] < 0.6 * _warm(m1)["warmup_grad_evals"]


@pytest.mark.slow
def test_adapt_import_chain_count_mismatch_converges(tmp_path):
    apath = str(tmp_path / "adapt.npz")
    assert sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                  seed=0, **CONV).converged
    res = sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath,
                                 map_init_steps=0, seed=3, **dict(CONV, chains=12))
    assert res.converged


@pytest.mark.slow
def test_adapt_import_rejected_on_mismatch_converges(tmp_path):
    from stark_tpu_torch.models import Logistic, synth_logistic_data

    apath = str(tmp_path / "adapt.npz")
    sample_until_converged(EightSchools(), eight_schools_data(), adapt_path=apath, seed=0,
                           **CONV)
    data, _ = synth_logistic_data(0, 512, 3)
    kw = dict(CONV, chains=4, ess_target=200.0)
    m = tmp_path / "m.jsonl"
    res2 = sample_until_converged(Logistic(num_features=3), data, adapt_path=apath, seed=1,
                                  metrics_path=str(m), **kw)
    assert _records(m, "adapt_import_rejected") and "adapt_imported" not in _warm(m)
    assert res2.converged
    m3 = tmp_path / "m3.jsonl"
    sample_until_converged(Logistic(num_features=3), data, adapt_path=apath, seed=2,
                           map_init_steps=0, metrics_path=str(m3), **kw)
    assert _warm(m3)["adapt_imported"] is True
