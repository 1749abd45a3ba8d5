"""The port's adaptive runner (`stark_tpu_torch.runner`) on the CPU.

Against the JAX package where the streams can match: checkpoint files
load in both directions, and the stop gate (`runner.StopGate`) fed the
JAX package's stored draws at its block boundaries reads what the JAX
runner read — max R-hat and the validation pass to rtol 1e-6 (the same
float64 math on the same draws), the streaming min ESS to rtol 1e-3 (the
band of the accumulator's float32 sums, tests/test_stream_diag.py), the
same next block lengths and the same stop block.  Against the port's own
uninterrupted run where they cannot: a resumed run gives bitwise its
draws, from a sample-phase and from a warmup-phase checkpoint.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stark_tpu
from stark_tpu import checkpoint as rckpt
from stark_tpu.model import Model as RefModel
from stark_tpu.model import ParamSpec as RefParamSpec
from stark_tpu_torch import runner, sample_until_converged, supervised_sample
from stark_tpu_torch.backends import AdaptiveParts, CudaBackend, SamplerBackend
from stark_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from stark_tpu_torch.drawstore import read_draws
from stark_tpu_torch.kernels.base import stream_diag_init, stream_diag_update
from stark_tpu_torch.model import Model, ParamSpec
from stark_tpu_torch.models import FusedHierLogisticGrouped, synth_logistic_data

SCALES = (1.0, 2.0, 0.5)


class ScaledNormal(Model):
    """Independent normals with scales 1/SCALES: a target with a known
    answer and a metric worth adapting."""

    def param_spec(self):
        return {"x": ParamSpec((3,))}

    def log_prior(self, p):
        return -0.5 * torch.sum((p["x"] * torch.tensor(SCALES)) ** 2, dim=-1)

    def log_lik(self, p, data):
        return torch.zeros(p["x"].shape[0])


class RefScaledNormal(RefModel):
    def param_spec(self):
        return {"x": RefParamSpec((3,))}

    def log_prior(self, p):
        return -0.5 * jnp.sum((p["x"] * jnp.array(SCALES)) ** 2)

    def log_lik(self, p, data):
        return jnp.zeros(())


# rhat_target=0: the gate never passes, the run spends its draw budget
BUDGET = dict(chains=6, block_size=20, max_blocks=3, min_blocks=3, rhat_target=0.0,
              num_warmup=60, kernel="chees", init_step_size=0.5, device="cpu")


def _paths(tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    return dict(checkpoint_path=str(d / "c.npz"), draw_store_path=str(d / "d.stkr"),
                metrics_path=str(d / "m.jsonl"))


def _records(path, event=None):
    recs = [json.loads(line) for line in open(path)]
    return [r for r in recs if event is None or r["event"] == event]


def test_converges_writing_metrics_checkpoint_and_draw_store(tmp_path):
    p = _paths(tmp_path, "run")
    post = sample_until_converged(
        ScaledNormal(), chains=8, block_size=40, max_blocks=10, num_warmup=100,
        kernel="chees", init_step_size=0.5, seed=0, device="cpu", **p,
    )
    assert post.converged and not post.budget_exhausted
    recs = _records(p["metrics_path"])
    assert recs[0]["event"] == "warmup_done"
    blocks = [r for r in recs if r["event"] == "block"]
    assert blocks == post.history
    last = blocks[-1]
    # a stop is validated by the full pass
    assert last["full_max_rhat"] < 1.01 and last["full_min_ess"] > 400.0
    assert all("full_max_rhat" not in r or r is last or r["full_max_rhat"] >= 1.01
               or r["full_min_ess"] <= 400.0 for r in blocks)
    for key in ("t_dispatch_s", "t_diag_s", "t_store_s", "t_ckpt_s", "diag_bytes_to_host"):
        assert last[key] >= 0, key
    stored, chains, dim = read_draws(p["draw_store_path"])
    assert (chains, dim) == (8, 3)
    np.testing.assert_array_equal(stored.transpose(1, 0, 2), post.draws_flat)
    arrays, meta = load_checkpoint(p["checkpoint_path"])
    assert meta["blocks_done"] == len(blocks) and meta["draw_rows"] == post.draws_flat.shape[1]
    # the JAX package loads the port's checkpoint
    rarrays, rmeta = rckpt.load_checkpoint(p["checkpoint_path"])
    assert rmeta == meta and sorted(rarrays) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(rarrays[k], arrays[k])
    # posterior sds near 1/SCALES
    sd = post.draws_flat.reshape(-1, 3).std(0)
    np.testing.assert_allclose(sd, 1.0 / np.array(SCALES), rtol=0.25)
    assert int(post.sample_stats["num_ensemble_grad_evals"]) > 1


def test_port_loads_a_reference_checkpoint(tmp_path):
    path = str(tmp_path / "r.npz")
    arrays = {"z": np.arange(6, dtype=np.float32).reshape(2, 3), "key": np.array([0, 7], np.uint32)}
    rckpt.save_checkpoint(path, arrays, {"blocks_done": 2, "history": [{"block": 1}]})
    got, meta = load_checkpoint(path)
    assert meta == {"blocks_done": 2, "history": [{"block": 1}]}
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
        assert got[k].dtype == arrays[k].dtype
    with pytest.raises(ValueError, match="reserved"):
        save_checkpoint(path, {"__stark_meta_json__": np.zeros(1)}, {})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_resume_from_sample_phase_checkpoint_is_bitwise(tmp_path):
    whole = sample_until_converged(ScaledNormal(), seed=3, **BUDGET, **_paths(tmp_path, "whole"))
    p = _paths(tmp_path, "cut")
    # a zero time budget stops after the first block's checkpoint
    first = sample_until_converged(ScaledNormal(), seed=3, time_budget_s=0.0, **BUDGET, **p)
    assert first.budget_exhausted and len(first.history) == 1
    assert _records(p["metrics_path"], "budget_exhausted")
    resumed = sample_until_converged(ScaledNormal(), seed=3, resume_from=p["checkpoint_path"],
                                     **BUDGET, **p)
    np.testing.assert_array_equal(resumed.draws_flat, whole.draws_flat)
    gate_fields = ("block", "draws_per_chain", "max_rhat", "min_ess")
    assert [resumed.history[0][k] for k in gate_fields] == [first.history[0][k] for k in gate_fields]
    assert [r["draws_per_chain"] for r in resumed.history] == [
        r["draws_per_chain"] for r in whole.history]
    np.testing.assert_array_equal(read_draws(p["draw_store_path"])[0],
                                  whole.draws_flat.transpose(1, 0, 2))


class FaultyBackend(CudaBackend):
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


def test_resume_from_warmup_phase_checkpoint_is_bitwise(tmp_path):
    kw = {k: v for k, v in BUDGET.items() if k != "device"}
    whole = sample_until_converged(ScaledNormal(), seed=4, device="cpu", **kw,
                                   **_paths(tmp_path, "whole"))
    p = _paths(tmp_path, "cut")
    with pytest.raises(RuntimeError, match="injected warmup fault"):
        sample_until_converged(ScaledNormal(), seed=4, backend=FaultyBackend(3), **kw, **p)
    arrays, meta = load_checkpoint(p["checkpoint_path"])
    assert meta["phase"] == "warmup" and meta["warm_done"] == 40
    for k in ("da_log_step", "da_mu", "da_count", "adam_t", "wf_count", "wf_m2", "key", "key_warm"):
        assert k in arrays, k
    resumed = sample_until_converged(ScaledNormal(), seed=4, device="cpu",
                                     resume_from=p["checkpoint_path"], **kw, **p)
    np.testing.assert_array_equal(resumed.draws_flat, whole.draws_flat)
    done = _records(p["metrics_path"], "warmup_done")
    assert len(done) == 1 and done[0]["resumed_from_step"] == 40


def test_resume_without_reseed_repeats_and_reseed_branches(tmp_path):
    p = _paths(tmp_path, "base")
    del p["draw_store_path"]  # the draws ride in the checkpoint
    sample_until_converged(ScaledNormal(), seed=0, time_budget_s=0.0, **BUDGET, **p)
    common = dict(BUDGET, resume_from=p["checkpoint_path"], checkpoint_path=None)
    a = sample_until_converged(ScaledNormal(), **common)
    b = sample_until_converged(ScaledNormal(), reseed=1, **common)
    c = sample_until_converged(ScaledNormal(), **common)
    np.testing.assert_array_equal(a.draws_flat, c.draws_flat)
    first = a.history[0]["draws_per_chain"]
    np.testing.assert_array_equal(a.draws_flat[:, :first], b.draws_flat[:, :first])
    assert not np.array_equal(a.draws_flat[:, first:], b.draws_flat[:, first:])


def test_stream_on_and_off_give_the_same_draws_checkpoints_and_store(tmp_path):
    out = {}
    for stream in (True, False):
        p = _paths(tmp_path, f"s{stream}")
        post = sample_until_converged(ScaledNormal(), seed=1, stream_diag=stream, **BUDGET, **p)
        arrays, meta = load_checkpoint(p["checkpoint_path"])
        out[stream] = (post, arrays, meta, open(p["draw_store_path"], "rb").read())
    on, off = out[True], out[False]
    np.testing.assert_array_equal(on[0].draws_flat, off[0].draws_flat)
    assert sorted(on[1]) == sorted(off[1])
    for k in on[1]:
        np.testing.assert_array_equal(on[1][k], off[1][k])
    assert on[3] == off[3]
    assert "diag_bytes_to_host" in on[0].history[-1]
    assert "diag_bytes_to_host" not in off[0].history[-1]


def test_adaptive_budget_draws_the_fixed_march_total(tmp_path):
    fixed = sample_until_converged(ScaledNormal(), seed=2, adaptive_blocks=False, **BUDGET)
    adaptive = sample_until_converged(ScaledNormal(), seed=2, adaptive_blocks=True, **BUDGET)
    assert [r["draws_per_chain"] for r in fixed.history] == [20, 40, 60]
    assert adaptive.draws_flat.shape == fixed.draws_flat.shape
    assert [r["draws_per_chain"] for r in adaptive.history] == [10, 30, 60]
    # the draws depend on the transition index only, not on the blocks
    np.testing.assert_array_equal(adaptive.draws_flat, fixed.draws_flat)


def test_gate_validates_every_stop():
    """Every chain drifts the same way: the streaming (non-split) R-hat
    sees nothing, the split R-hat of the validation pass does, so the
    gate backs off instead of stopping."""
    rng = np.random.default_rng(0)
    chains, n, d = 8, 200, 2
    trend = np.linspace(0.0, 3.0, n)[None, :, None]
    draws = (rng.standard_normal((chains, n, d)) + trend).astype(np.float32)
    gate = runner.StopGate(chains, d, block_size=50, max_blocks=4, min_blocks=2,
                           rhat_target=1.05, ess_target=0.0, stream_diag=False,
                           adaptive_blocks=False)
    recs = []
    for lo in range(0, n, 50):
        rec, converged = gate.observe(draws[:, lo:lo + 50])
        recs.append(rec)
        assert not converged
    assert recs[-1]["max_rhat"] < 1.05  # the streaming reading alone would stop
    checked = [r["block"] for r in recs if "full_max_rhat" in r]
    assert checked == [2, 3, 4]  # back-off: blocks_done + max(1, blocks_done // 4)
    assert all(recs[b - 1]["full_max_rhat"] >= 1.05 for b in checked)


def test_gate_matches_reference_runner_on_its_draws(tmp_path):
    store, metrics = str(tmp_path / "r.stkr"), str(tmp_path / "r.jsonl")
    kw = dict(chains=8, block_size=40, max_blocks=12, min_blocks=2, rhat_target=1.01,
              ess_target=1200.0)
    ref = stark_tpu.sample_until_converged(
        RefScaledNormal(), num_warmup=100, kernel="chees", init_step_size=0.5, seed=0,
        draw_store_path=store, metrics_path=metrics, **kw,
    )
    blocks = _records(metrics, "block")
    assert len(blocks) >= 3
    draws = np.ascontiguousarray(read_draws(store, mmap=False)[0].transpose(1, 0, 2))
    gate = runner.StopGate(8, 3, **{k: v for k, v in kw.items() if k != "chains"})
    diag = stream_diag_init(8, 3, device="cpu")
    x = torch.as_tensor(draws)
    lo, stop = 0, None
    for rec in blocks:
        hi = rec["draws_per_chain"]
        assert gate.next_block_len() == hi - lo, rec["block"]
        for t in range(lo, hi):
            diag = stream_diag_update(diag, x[:, t])
        got, converged = gate.observe(draws[:, lo:hi], tuple(v.numpy() for v in diag))
        assert got["block"] == rec["block"] and got["draws_per_chain"] == hi
        np.testing.assert_allclose(got["max_rhat"], rec["max_rhat"], rtol=1e-6)
        np.testing.assert_allclose(got["min_ess"], rec["min_ess"], rtol=1e-3)
        assert ("full_max_rhat" in got) == ("full_max_rhat" in rec), rec["block"]
        if "full_max_rhat" in rec:
            for k in ("full_max_rhat", "full_min_ess", "full_max_rank_rhat"):
                np.testing.assert_allclose(got[k], rec[k], rtol=1e-6, err_msg=k)
        if converged:
            stop = rec["block"]
            break
        lo = hi
    assert ref.converged and stop == blocks[-1]["block"]


def test_backend_takes_the_card_unless_told_otherwise(monkeypatch):
    """(The entry points' own case is in tests/test_torch_isolation.py.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CudaBackend()
    assert CudaBackend("cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="disagrees"):
        sample_until_converged(ScaledNormal(), backend=CudaBackend("cpu"), device="cuda")


@pytest.mark.parametrize("kw,item", [
    (dict(sync_blocks=False), "A6"), (dict(adapt_path="x.npz"), "A6"),
    (dict(adapt_export_path="x.npz"), "A6"), (dict(trace=object()), "A12"),
    (dict(profile_dir="p"), "A12"), (dict(kernel="nuts"), "A8"),
])
def test_unported_options_are_refused(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        sample_until_converged(ScaledNormal(), device="cpu", num_warmup=2, max_blocks=1, **kw)


def test_flagship_model_through_the_backend_and_the_supervisor(tmp_path):
    backend = CudaBackend(device="cpu")
    assert isinstance(backend, SamplerBackend)
    model = FusedHierLogisticGrouped(3, 4)
    raw, _ = synth_logistic_data(0, 600, 3, num_groups=4)
    ap = backend.adaptive_parts(model, runner.SamplerConfig(num_warmup=10), raw)
    assert isinstance(ap, AdaptiveParts) and ap.data["xT"].device.type == "cpu"
    post = supervised_sample(
        model, raw, workdir=str(tmp_path / "w"), backend=backend, chains=6, block_size=10,
        max_blocks=2, rhat_target=0.0, num_warmup=30, map_init_steps=5, init_step_size=0.1,
    )
    assert post.draws["beta"].shape == (6, 20, 3)
    assert all(np.all(np.isfinite(v)) for v in post.draws.values())
    stored = read_draws(str(tmp_path / "w" / "draws.stkr"))[0]
    np.testing.assert_array_equal(stored.transpose(1, 0, 2), post.draws_flat)
    _, meta = load_checkpoint(str(tmp_path / "w" / "chain.ckpt.npz"))
    assert meta["blocks_done"] == len(post.history)
