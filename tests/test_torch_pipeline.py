"""The port's pipelined block loop (`runner.sample_until_converged`,
``sync_blocks``), on the CPU.

The contract of the JAX package's tests/test_pipeline.py: with the
overlap on (the default) and off (``sync_blocks=True`` or
``STARK_SYNC_BLOCKS=1``) the draws, the metrics history (but its timing
fields), the checkpoint's arrays and accounting meta and the draw
store's bytes are bitwise the same, for ChEES, NUTS and HMC, with
adaptive and with fixed blocks.  A stop at block k throws the block the
main thread was driving away: its evaluations are counted apart, and
nothing of it reaches the result, the store or a checkpoint.  A fault
in the worker reaches the main thread (and the supervisor) as in the
serial loop; a worker that stalls ends the call within a bounded time.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from stark_tpu_torch import runner, sample_until_converged, supervised_sample
from stark_tpu_torch.backends import CudaBackend
from stark_tpu_torch.checkpoint import load_checkpoint
from stark_tpu_torch.drawstore import read_draws
from stark_tpu_torch.model import Model, ParamSpec

TIMING = ("wall_s", "t_dispatch_s", "t_diag_s", "t_store_s", "t_ckpt_s", "t_wait_s",
          "t_hidden_s")
ACCOUNTING = ("blocks_done", "block_size", "draw_rows", "num_divergent", "model", "kernel")
SCALES = (1.0, 2.0, 0.5)


class CountedNormal(Model):
    """Independent normals with scales 1/SCALES, counting the potential
    evaluations (one log_prior call each; the model has no data) the way
    a kernel counts its launches."""

    calls = 0

    def param_spec(self):
        return {"x": ParamSpec((3,))}

    def log_prior(self, p):
        CountedNormal.calls += 1
        return -0.5 * torch.sum((p["x"] * torch.tensor(SCALES)) ** 2, dim=-1)

    def log_lik(self, p, data):
        return torch.zeros(p["x"].shape[0])


KERNELS = {
    "chees": dict(kernel="chees", chains=6, init_step_size=0.5, map_init_steps=3),
    "nuts": dict(kernel="nuts", chains=3, max_tree_depth=4),
    "hmc": dict(kernel="hmc", chains=3, num_leapfrog=5),
}


def _strip(history):
    return [{k: v for k, v in r.items() if k not in TIMING} for r in history]


def _run(tmp_path, tag, **kw):
    d = tmp_path / tag
    d.mkdir()
    paths = dict(checkpoint_path=str(d / "c.npz"), draw_store_path=str(d / "d.stkr"),
                 metrics_path=str(d / "m.jsonl"))
    CountedNormal.calls = 0
    post = sample_until_converged(CountedNormal(), device="cpu", **paths, **kw)
    return post, paths, CountedNormal.calls


def _assert_same(a, b):
    (pa, fa, _), (pb, fb, _) = a, b
    np.testing.assert_array_equal(pa.draws_flat, pb.draws_flat)
    assert _strip(pa.history) == _strip(pb.history)
    for k in ("num_divergent", "num_ensemble_grad_evals"):
        assert int(pa.sample_stats[k]) == int(pb.sample_stats[k]), k
    arr_a, meta_a = load_checkpoint(fa["checkpoint_path"])
    arr_b, meta_b = load_checkpoint(fb["checkpoint_path"])
    assert sorted(arr_a) == sorted(arr_b)
    for k in arr_a:
        np.testing.assert_array_equal(arr_a[k], arr_b[k], err_msg=k)
    for k in ACCOUNTING:
        assert meta_a[k] == meta_b[k], k
    assert _strip(meta_a["history"]) == _strip(meta_b["history"])
    assert open(fa["draw_store_path"], "rb").read() == open(fb["draw_store_path"], "rb").read()
    recs = [json.loads(line) for line in open(fa["metrics_path"])]
    assert _strip([r for r in recs if r["event"] == "block"]) == _strip(pa.history)


def _launches(res):
    """Each potential evaluation of the call is counted once, kept or
    thrown away."""
    post, _, calls = res
    st = post.sample_stats
    assert calls == int(st["num_ensemble_grad_evals"]) + int(
        st["num_discarded_ensemble_grad_evals"])


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed"])
@pytest.mark.parametrize("kernel", ["chees", "nuts", "hmc"])
def test_pipelined_equals_serial(tmp_path, kernel, adaptive):
    kw = dict(KERNELS[kernel], num_warmup=30, block_size=10, max_blocks=3, min_blocks=3,
              rhat_target=0.0, adaptive_blocks=adaptive, seed=1)
    pipe = _run(tmp_path, "pipe", sync_blocks=False, **kw)
    serial = _run(tmp_path, "serial", sync_blocks=True, **kw)
    _assert_same(pipe, serial)
    assert pipe[0].draws_flat.shape[1] == 30
    lengths = np.diff([0] + [r["draws_per_chain"] for r in pipe[0].history]).tolist()
    assert lengths == ([5, 10, 15] if adaptive else [10, 10, 10])
    for res in (pipe, serial):
        _launches(res)
        assert int(res[0].sample_stats["num_discarded_ensemble_grad_evals"]) == 0
    for r in serial[0].history:
        assert r["t_wait_s"] == 0.0 and r["t_hidden_s"] == 0.0
    for r in pipe[0].history:
        assert r["t_wait_s"] >= 0.0 and r["t_hidden_s"] >= 0.0


def test_default_is_pipelined_and_the_env_selects_serial(tmp_path, monkeypatch):
    made = []
    real = runner._BlockWorker

    def spy():
        made.append(1)
        return real()

    monkeypatch.setattr(runner, "_BlockWorker", spy)
    kw = dict(KERNELS["hmc"], num_warmup=10, block_size=5, max_blocks=2, rhat_target=0.0,
              seed=0)
    pipe = _run(tmp_path, "default", **kw)
    assert made == [1]
    monkeypatch.setenv("STARK_SYNC_BLOCKS", "1")
    serial = _run(tmp_path, "env", **kw)
    assert made == [1]
    assert all(r["t_wait_s"] == 0.0 for r in serial[0].history)
    _assert_same(pipe, serial)


def _slow_gate(monkeypatch, seconds):
    """Processing that takes ``seconds`` longer a block, so the main
    thread drives part of the next block before the verdict."""
    real = runner.StopGate.observe

    def observe(self, *a, **kw):
        time.sleep(seconds)
        return real(self, *a, **kw)

    monkeypatch.setattr(runner.StopGate, "observe", observe)


@pytest.mark.parametrize("kernel", ["chees", "nuts"])
def test_a_converged_stop_throws_the_speculative_block_away(tmp_path, monkeypatch, kernel):
    _slow_gate(monkeypatch, 0.3)
    kw = dict(KERNELS[kernel], num_warmup=40, block_size=20, max_blocks=20, min_blocks=2,
              rhat_target=1.1, ess_target=20.0, adaptive_blocks=False, seed=2)
    pipe = _run(tmp_path, "pipe", sync_blocks=False, **kw)
    serial = _run(tmp_path, "serial", sync_blocks=True, **kw)
    assert pipe[0].converged and serial[0].converged
    assert len(pipe[0].history) < 20
    _assert_same(pipe, serial)
    _, meta = load_checkpoint(pipe[1]["checkpoint_path"])
    assert meta["draw_rows"] == pipe[0].draws_flat.shape[1]
    assert read_draws(pipe[1]["draw_store_path"])[0].shape[0] == meta["draw_rows"]
    assert int(pipe[0].sample_stats["num_discarded_ensemble_grad_evals"]) > 0
    assert int(serial[0].sample_stats["num_discarded_ensemble_grad_evals"]) == 0
    _launches(pipe)
    _launches(serial)


def test_a_time_budget_stop_equals_serial(tmp_path, monkeypatch):
    _slow_gate(monkeypatch, 0.2)
    kw = dict(KERNELS["chees"], num_warmup=20, block_size=10, max_blocks=5, rhat_target=0.0,
              time_budget_s=0.0, seed=3)
    pipe = _run(tmp_path, "pipe", sync_blocks=False, **kw)
    serial = _run(tmp_path, "serial", sync_blocks=True, **kw)
    for post, paths, _ in (pipe, serial):
        assert post.budget_exhausted and len(post.history) == 1
        recs = [json.loads(line)["event"] for line in open(paths["metrics_path"])]
        assert recs == ["warmup_done", "block", "budget_exhausted"]
    _assert_same(pipe, serial)
    assert int(pipe[0].sample_stats["num_discarded_ensemble_grad_evals"]) > 0
    _launches(pipe)


class PoisonOnce(CudaBackend):
    """The first call's second block ends in NaN positions (a numerical
    fault the health check must catch before block 2's checkpoint)."""

    def __init__(self):
        super().__init__("cpu")
        self.parts_made = 0

    def adaptive_parts(self, model, cfg, data):
        ap = super().adaptive_parts(model, cfg, data)
        self.parts_made += 1
        if self.parts_made > 1:
            return ap
        blocks = {"n": 0}

        def samp_j(carry, *a, **kw):
            carry, diag, blk = ap.samp_j(carry, *a, **kw)
            blocks["n"] += 1
            if blocks["n"] == 2:
                if hasattr(carry, "states"):  # ChEES
                    carry = carry._replace(states=carry.states._replace(z=carry.states.z * np.nan))
                else:  # NUTS, HMC: (state, step size, inverse mass)
                    carry = (carry[0]._replace(z=carry[0].z * np.nan),) + tuple(carry[1:])
            return carry, diag, blk

        return ap._replace(samp_j=samp_j)


@pytest.mark.parametrize("kernel", ["chees", "nuts"])
def test_a_health_fault_in_the_worker_restarts_as_in_serial(tmp_path, kernel):
    out = {}
    for sync in (False, True):
        wd = tmp_path / f"sync{sync}"
        post = supervised_sample(
            CountedNormal(), workdir=str(wd), backend=PoisonOnce(), sync_blocks=sync,
            num_warmup=20, block_size=10, max_blocks=4, rhat_target=0.0, seed=5,
            **KERNELS[kernel],
        )
        recs = [json.loads(line) for line in open(wd / "metrics.jsonl")]
        restarts = [{k: v for k, v in r.items() if k != "ts"} for r in recs
                    if r["event"] == "restart"]
        out[sync] = (post, restarts)
    (pipe, r_pipe), (serial, r_serial) = out[False], out[True]
    assert r_pipe == r_serial and len(r_pipe) == 1
    assert r_pipe[0]["fault"] == "poisoned_state" and r_pipe[0]["attempt"] == 1
    assert "ChainHealthError" in r_pipe[0]["error"]
    np.testing.assert_array_equal(pipe.draws_flat, serial.draws_flat)
    assert _strip(pipe.history) == _strip(serial.history)


def _workers_alive():
    return [t for t in threading.enumerate() if t.name == "stark-block-worker" and t.is_alive()]


def _no_worker_left(within=10.0):
    t_end = time.monotonic() + within
    while _workers_alive() and time.monotonic() < t_end:
        time.sleep(0.05)
    return not _workers_alive()


def _fail_at_block(monkeypatch, block, action):
    real = runner.StopGate.observe

    def observe(self, *a, **kw):
        if self.blocks_done + 1 == block:
            action()
        return real(self, *a, **kw)

    monkeypatch.setattr(runner.StopGate, "observe", observe)


def test_a_worker_that_raises_ends_the_call(tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("gate fault")

    _fail_at_block(monkeypatch, 2, boom)
    kw = dict(KERNELS["chees"], num_warmup=20, block_size=10, max_blocks=5, rhat_target=0.0,
              seed=0)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="gate fault"):
        _run(tmp_path, "raise", **kw)
    assert time.monotonic() - t < 60
    assert _no_worker_left()
    _, meta = load_checkpoint(str(tmp_path / "raise" / "c.npz"))
    assert meta["blocks_done"] == 1  # the last checkpoint is block 1's


def test_a_stalled_worker_ends_the_call_within_the_timeout(tmp_path, monkeypatch):
    monkeypatch.setattr(runner, "BLOCK_VERDICT_TIMEOUT_S", 0.5)
    _fail_at_block(monkeypatch, 2, lambda: time.sleep(3.0))
    kw = dict(KERNELS["hmc"], num_warmup=10, block_size=5, max_blocks=5, rhat_target=0.0,
              seed=0)
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="block 2"):
        _run(tmp_path, "stall", **kw)
    assert time.monotonic() - t < 2.5  # the stall alone is 3 s
    # the stalled step returns, writes nothing more and the thread ends
    assert _no_worker_left()
    _, meta = load_checkpoint(str(tmp_path / "stall" / "c.npz"))
    assert meta["blocks_done"] == 1
    assert read_draws(str(tmp_path / "stall" / "d.stkr"))[0].shape[0] == meta["draw_rows"]
