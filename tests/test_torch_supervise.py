"""The port's supervised restart (`stark_tpu_torch.supervise`): the
single-process cases of the JAX package's tests/test_supervise.py on the
port, on the CPU; `backoff_delay` and `classify_fault` against the JAX
package's on the same inputs.  The stall class arrives with the watchdog
(ROADMAP A12)."""

import json
import os

import numpy as np
import pytest
import torch

import stark_tpu_torch
from stark_tpu import supervise as rsup
from stark_tpu_torch import runner, supervise
from stark_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from stark_tpu_torch.drawstore import DrawStore, read_draws
from stark_tpu_torch.model import Model, ParamSpec
from stark_tpu_torch.supervise import (
    ChainHealthError,
    RestartBudget,
    backoff_delay,
    check_finite_state,
    checkpoint_health,
    checkpoint_is_healthy,
    classify_fault,
    quarantine_path,
    supervised_sample,
)


class StdNormal2(Model):
    def param_spec(self):
        return {"x": ParamSpec((2,))}

    def log_prior(self, p):
        return -0.5 * torch.sum(p["x"] ** 2, dim=-1)

    def log_lik(self, p, data):
        return torch.zeros(p["x"].shape[0])


SAMPLE_KW = dict(chains=6, block_size=30, max_blocks=20, rhat_target=1.05, ess_target=100.0,
                 num_warmup=80, kernel="chees", init_step_size=0.5, device="cpu")
POISONED = {"z": np.full((6, 2), np.nan, np.float32), "pe": np.zeros(6, np.float32),
            "step_size": np.ones((), np.float32), "inv_mass": np.ones(2, np.float32),
            "key": np.zeros(16, np.uint8)}


def _lines(wd):
    return [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]


def test_check_finite_state():
    good = {"z": np.zeros((2, 3)), "pe": np.ones(2), "step_size": np.ones(2)}
    check_finite_state(good)
    with pytest.raises(ChainHealthError, match="step_size"):
        check_finite_state(dict(good, step_size=np.array([0.1, np.nan])))
    # the CARRIED grad seeds the next leapfrog half-step: must be finite
    with pytest.raises(ChainHealthError, match="grad"):
        check_finite_state(dict(good, grad=np.array([np.inf])))
    # warmup-phase adaptation state is watched too
    with pytest.raises(ChainHealthError, match="wf_m2"):
        check_finite_state(dict(good, wf_m2=np.array([np.nan])))


def test_checkpoint_health_and_its_reason(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"z": np.zeros((2, 2)), "pe": np.zeros(2)}, {})
    assert checkpoint_is_healthy(p) and checkpoint_health(p) == (True, None)
    save_checkpoint(p, {"z": np.full((2, 2), np.nan), "pe": np.zeros(2)}, {})
    ok, reason = checkpoint_health(p)
    assert not ok and reason.startswith("poisoned_state:") and "'z'" in reason
    with open(p, "wb") as f:
        f.write(b"not an npz")
    ok, reason = checkpoint_health(p)
    assert not ok and reason.startswith("corrupt_checkpoint:")
    assert not checkpoint_is_healthy(str(tmp_path / "missing.npz"))


def test_supervised_clean_run(tmp_path):
    wd = str(tmp_path / "run")
    post = supervised_sample(StdNormal2(), workdir=wd, seed=0, **SAMPLE_KW)
    assert post.converged
    assert os.path.exists(os.path.join(wd, "chain.ckpt.npz"))
    assert not any(r["event"] == "restart" for r in _lines(wd))
    stored, _, _ = read_draws(os.path.join(wd, "draws.stkr"))
    np.testing.assert_array_equal(stored.transpose(1, 0, 2), post.draws_flat)


def _flaky(monkeypatch, calls):
    """The first attempt runs one block for real (its checkpoint lands),
    then faults."""
    real = runner.sample_until_converged

    def flaky(model, data=None, **kw):
        calls["n"] += 1
        calls["resumes"].append(kw.get("resume_from"))
        calls["reseeds"].append(kw.get("reseed"))
        if calls["n"] == 1:
            real(model, data, **dict(kw, time_budget_s=0.0))
            raise RuntimeError("injected device fault")
        return real(model, data, **kw)

    monkeypatch.setattr(runner, "sample_until_converged", flaky)


def test_supervised_restart_resumes_from_checkpoint(tmp_path, monkeypatch):
    wd = str(tmp_path / "run")
    calls = {"n": 0, "resumes": [], "reseeds": []}
    _flaky(monkeypatch, calls)
    post = supervised_sample(StdNormal2(), workdir=wd, seed=0, max_restarts=2, **SAMPLE_KW)
    assert post.converged
    assert calls["n"] == 2
    assert calls["resumes"][0] is None and calls["resumes"][1] is not None
    assert calls["reseeds"] == [None, 1]
    restarts = [r for r in _lines(wd) if r["event"] == "restart"]
    assert len(restarts) == 1
    assert "injected device fault" in restarts[0]["error"]
    assert restarts[0]["fault"] == "transient"
    assert restarts[0]["resumed_from_checkpoint"] is False
    assert post.history[0]["block"] == 1 and len(post.history) >= 2


def test_supervised_restart_without_reseed_is_bitwise(tmp_path, monkeypatch):
    kw = dict(SAMPLE_KW, rhat_target=0.0, max_blocks=3, block_size=20)
    whole = supervised_sample(StdNormal2(), workdir=str(tmp_path / "whole"), seed=5, **kw)
    _flaky(monkeypatch, {"n": 0, "resumes": [], "reseeds": []})
    wd = str(tmp_path / "run")
    post = supervised_sample(StdNormal2(), workdir=wd, seed=5, reseed_on_restart=False, **kw)
    assert sum(r["event"] == "restart" for r in _lines(wd)) == 1
    np.testing.assert_array_equal(post.draws_flat, whole.draws_flat)


def test_supervised_discards_poisoned_checkpoint(tmp_path):
    wd = str(tmp_path / "run")
    os.makedirs(wd)
    ckpt = os.path.join(wd, "chain.ckpt.npz")
    save_checkpoint(ckpt, POISONED, {"blocks_done": 3, "kernel": "chees"})
    post = supervised_sample(StdNormal2(), workdir=wd, seed=0, **SAMPLE_KW)
    assert post.converged
    assert os.path.exists(ckpt + ".bad")  # quarantined, not silently reused
    reason = json.load(open(ckpt + ".bad.reason.json"))
    assert reason["reason"].startswith("poisoned_state:")
    assert post.history[0]["block"] == 1  # a fresh run from block 0


def test_cold_start_quarantines_stale_draw_store(tmp_path):
    wd = str(tmp_path / "run")
    os.makedirs(wd)
    store = os.path.join(wd, "draws.stkr")
    with DrawStore(store, 6, 2) as ds:
        ds.append(np.full((6, 7, 2), 99.0, np.float32))
    save_checkpoint(os.path.join(wd, "chain.ckpt.npz"), POISONED, {"blocks_done": 1, "kernel": "chees"})
    post = supervised_sample(StdNormal2(), workdir=wd, seed=0, **SAMPLE_KW)
    assert post.converged
    assert os.path.exists(store + ".bad")
    stored, _, _ = read_draws(store, mmap=False)
    assert stored.shape[0] == post.draws_flat.shape[1]  # no 7-draw stale block
    assert not np.any(stored == 99.0)


def test_resume_truncates_orphaned_store_rows(tmp_path):
    ckpt, store = str(tmp_path / "state.npz"), str(tmp_path / "draws.stkr")
    kw = dict(SAMPLE_KW, rhat_target=0.0, adaptive_blocks=False, block_size=25)
    stark_tpu_torch.sample_until_converged(
        StdNormal2(), seed=0, max_blocks=2, checkpoint_path=ckpt, draw_store_path=store,
        **{k: v for k, v in kw.items() if k != "max_blocks"},
    )
    # the crash window: one more block in the store, no checkpoint for it
    with DrawStore(store, 6, 2) as ds:
        ds.append(np.full((6, 25, 2), 7.7, np.float32))
    post = stark_tpu_torch.sample_until_converged(
        StdNormal2(), resume_from=ckpt, draw_store_path=store,
        **{k: v for k, v in dict(kw, max_blocks=3).items()},
    )
    assert post.draws_flat.shape[1] == 75  # 2 resumed blocks + 1 new
    assert not np.any(post.draws_flat == 7.7)
    assert not np.any(read_draws(store, mmap=False)[0] == 7.7)
    _, meta = load_checkpoint(ckpt)
    assert meta["blocks_done"] == 2  # the resumed run wrote none


def _always_fails(monkeypatch, msg):
    def fails(model, data=None, **kw):
        raise RuntimeError(msg)

    monkeypatch.setattr(runner, "sample_until_converged", fails)


def test_supervised_gives_up_after_max_restarts(tmp_path, monkeypatch):
    wd = str(tmp_path / "run")
    _always_fails(monkeypatch, "permanent fault")
    with pytest.raises(RuntimeError, match="permanent fault"):
        supervised_sample(StdNormal2(), workdir=wd, seed=0, max_restarts=2, **SAMPLE_KW)
    assert sum(1 for r in _lines(wd) if r["event"] == "restart") == 3


def test_supervised_restart_window_bounds_rate(tmp_path, monkeypatch):
    wd = str(tmp_path / "run")
    _always_fails(monkeypatch, "crash loop")
    with pytest.raises(RuntimeError, match="crash loop"):
        supervised_sample(StdNormal2(), workdir=wd, seed=0, max_restarts=1,
                          restart_window_s=3600.0, backoff_base_s=0.01, **SAMPLE_KW)
    rs = [r for r in _lines(wd) if r["event"] == "restart"]
    assert len(rs) == 2  # failure 2 overflows max_restarts=1 in the window
    assert all(r["fault"] == "transient" for r in rs)
    assert rs[0]["backoff_s"] > 0 and rs[-1]["backoff_s"] == 0


def test_supervised_refuses_what_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="A12"):
        supervised_sample(StdNormal2(), workdir=str(tmp_path), stall_timeout_s=5.0, device="cpu",
                          kernel="chees")
    monkeypatch.setenv("STARK_RAGGED_NUTS", "1")
    with pytest.raises(NotImplementedError, match="A8"):
        supervised_sample(StdNormal2(), workdir=str(tmp_path / "w"), device="cpu",
                          kernel="nuts", num_warmup=2)
    assert not os.path.exists(tmp_path / "w" / "metrics.jsonl")  # no restart burnt


@pytest.mark.parametrize("exc", [ChainHealthError("nan"), RuntimeError("cuda"), OSError("disk"),
                                 ValueError("x")])
def test_classify_fault_taxonomy(exc):
    want = rsup.classify_fault(rsup.ChainHealthError("nan") if isinstance(exc, ChainHealthError)
                               else exc)
    assert classify_fault(exc) == want
    assert want == ("poisoned_state" if isinstance(exc, ChainHealthError) else "transient")


@pytest.mark.parametrize("fault", ["transient", "poisoned_state"])
@pytest.mark.parametrize("base_s,cap_s", [(0.0, 60.0), (1.0, 60.0), (5.0, 4.0), (0.3, 1e9)])
def test_backoff_delay_matches_reference(fault, base_s, cap_s):
    for attempt in range(0, 12):
        for seed in (0, 7, 123):
            assert backoff_delay(fault, attempt, base_s=base_s, cap_s=cap_s, seed=seed) == \
                rsup.backoff_delay(fault, attempt, base_s=base_s, cap_s=cap_s, seed=seed)


def test_restart_budget_lifetime_and_window():
    b = RestartBudget(2)
    for t in (0.0, 1.0):
        b.record_failure(t)
        assert not b.exhausted(t)
    b.record_failure(2.0)
    assert b.exhausted(2.0)
    w = RestartBudget(2, window_s=10.0)
    for t in (0.0, 1.0, 2.0):
        w.record_failure(t)
    assert w.exhausted(2.0)
    w2 = RestartBudget(2, window_s=10.0)
    for t in (0.0, 3600.0, 7200.0):
        w2.record_failure(t)
        assert not w2.exhausted(t)


def test_restart_budget_window_boundary():
    w = RestartBudget(1, window_s=10.0)
    w.record_failure(0.0)
    w.record_failure(10.0)  # exactly at the edge of failure #1's window
    assert w.in_window(10.0) == 2 and w.exhausted(10.0)
    assert w.in_window(10.0 + 1e-6) == 1 and not w.exhausted(10.0 + 1e-6)
    assert w.in_window(10.0) == 1  # pruning is permanent
    inf = RestartBudget(1, window_s=None)
    inf.record_failure(0.0)
    assert not inf.exhausted(1e9)
    inf.record_failure(1e9)
    assert inf.exhausted(1e12)
    zero = RestartBudget(0, window_s=10.0)
    zero.record_failure(5.0)
    assert zero.exhausted(5.0)


def test_quarantine_path_numbers_its_copies(tmp_path):
    p = str(tmp_path / "a.npz")
    for i in range(3):
        open(p, "w").write(str(i))
        dst = quarantine_path(p, reason=f"r{i}" if i == 2 else None)
    assert sorted(os.listdir(tmp_path)) == ["a.npz.bad", "a.npz.bad2", "a.npz.bad3",
                                            "a.npz.bad3.reason.json"]
    assert dst.endswith(".bad3") and open(dst).read() == "2"


def test_append_record_is_one_json_line_each(tmp_path):
    p = str(tmp_path / "m.jsonl")
    supervise._append_record(p, {"event": "restart", "attempt": 1})
    supervise._append_record(p, {"event": "restart", "attempt": 2})
    assert [json.loads(line)["attempt"] for line in open(p)] == [1, 2]
