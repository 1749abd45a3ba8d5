"""chip_smoke.py's checks of kernel B1's tensor-core pass, on the CPU.

The bound's special-function term (the bernoulli link's three
special-function instructions per chain and row), --compare-with's calls
of B1 at each dot precision, and B1's dyadic edge inputs: exact logits in
float32 in any order of their sums, operands that bf16 rounds, and the
wide-logit cases beyond +-30.  The kernels themselves run only on the
card (tests/test_torch_gpu_kernels.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs

# the flagship's B1 call (C=64, D=32, N=1,000,000, G=1000): its bytes as
# chip_smoke counts them, and its products (logits and gradient)
N, D, G = 1_000_000, 32, 1000


def _flagship_bytes(c):
    return 4 * (D * N + N + N + N // 8192 + 2 * c * G + 2 * c * D + c)


@pytest.mark.parametrize("prec,passes", [("high", 3), ("default", 1)])
def test_special_functions_bind_b1_at_64_chains(prec, passes):
    c = 64
    e = cs.bound(_flagship_bytes(c), 2 * 2 * c * D * N * passes, cs.BF16_FLOP_PER_S,
                 sfu=cs.LINK_SFU * c * N, sfu_per_s=cs.H100_SFU_PER_S)
    assert e["term"] == "special functions" and e["bound_by"] == "operations"
    # 192e6 instructions at 16 per SM and clock on 132 SMs at 1.98 GHz
    assert e["bound_ms"] == pytest.approx(1e3 * 192e6 / (132 * 16 * 1.98e9))
    assert 0.0459 < e["bound_ms"] < 0.0460
    assert e["bound_ms"] > 1e3 * _flagship_bytes(c) / cs.HBM_BYTES_PER_S


def test_bytes_still_bind_b1_at_8_chains():
    c = 8
    e = cs.bound(_flagship_bytes(c), 2 * 2 * c * D * N * 3, cs.BF16_FLOP_PER_S,
                 sfu=cs.LINK_SFU * c * N, sfu_per_s=cs.H100_SFU_PER_S)
    assert e["term"] == "bytes" and e["bound_by"] == "bytes"
    assert e["bound_ms"] == pytest.approx(1e3 * _flagship_bytes(c) / cs.HBM_BYTES_PER_S)
    assert e["sfu_ms"] < e["bound_ms"]


def test_bound_without_special_functions_is_bytes_or_products():
    # as before the term: the larger of bytes and products
    e = cs.bound(3.35e9, 67e9 * 2)  # 1 ms of bytes, 2 ms of products
    assert (e["term"], e["bound_by"]) == ("products", "operations")
    assert e["bound_ms"] == pytest.approx(2.0)
    e = cs.bound(3.35e9 * 3, 67e9 * 2)
    assert (e["term"], e["bound_by"]) == ("bytes", "bytes")
    assert e["bound_ms"] == pytest.approx(3.0)
    assert e["sfu"] == 0 and e["sfu_ms"] == 0.0
    assert "special-function" not in cs.fmt_bound(e)
    assert "special functions" in cs.fmt_bound(
        cs.bound(0, 0, sfu=cs.LINK_SFU * 64 * N, sfu_per_s=cs.H100_SFU_PER_S))


def test_rehearsal_counts_special_functions_at_the_h100s_rate():
    run = cs.Run(True)
    assert run.sfu_per_s == cs.H100_SFU_PER_S == 132 * 16 * 1.98e9
    assert cs.link_sfu(run, 64, N) == dict(sfu=3 * 64 * N, sfu_per_s=cs.H100_SFU_PER_S)


@pytest.mark.parametrize("prec", cs.PRECISION_MODES)
@pytest.mark.parametrize("chains", ["", f" C={cs.NUTS_CHAINS}"])
def test_compare_with_times_b1_at_each_precision(prec, chains):
    """B1 at high and default is timed at both chain counts; against a
    parent that already has its tensor-core pass it is expected bitwise
    equal."""
    key = f"B1 {prec}{chains}"
    assert key in cs.SHARED_KERNELS
    assert cs.expected_against_parent(key) == "yes"


def test_compare_with_keeps_every_kernel_it_had():
    for key in ("B1", "B2 offsets=False", "B2 offsets=True", "B2 gaussian offsets=False",
                "B2 gaussian offsets=True", "B2 gaussian (LMM)", "B3 offsets=False",
                "B3 offsets=True", "B4"):
        assert key in cs.SHARED_KERNELS
    assert cs.expected_against_parent("B1") == "yes"
    assert cs.expected_against_parent("B4") == "yes"
    assert len(set(cs.SHARED_KERNELS)) == len(cs.SHARED_KERNELS)


@pytest.fixture(scope="module")
def edge_inputs():
    """Every edge case's inputs, drawn in order from one RandomState(8), as
    chip_smoke.phase_b1_edges draws them."""
    rs = np.random.RandomState(8)
    return [cs.b1_edge_inputs(case, rs) for case in cs.B1_EDGE_CASES]


@pytest.mark.parametrize("i", range(len(cs.B1_EDGE_CASES)))
def test_b1_edge_inputs_have_exact_logits(i, edge_inputs):
    """Every product and alpha lie on one grid (x in steps of 2^-9, beta
    in steps of 2^e, alpha in steps of 2^-11), and the sum of their
    magnitudes stays under 2^24 steps: every logit, and every partial sum
    of it in any order, is exact in float32."""
    _, n, d, groups, c, gaps, scale = cs.B1_EDGE_CASES[i]
    raw, (beta, alpha) = edge_inputs[i]
    x = raw["x"].astype(np.float64)
    # beta's step: 2^e nearest its scale over 512 steps (D <= 32) or 8
    step = 2.0 ** round(np.log2(scale / (512 if d <= 32 else 8)))
    low = 2.0 ** -9 * step
    for a, s in ((x, 2.0 ** -9), (beta, step), (alpha, 2.0 ** -11)):
        assert np.all(np.asarray(a, np.float64) / s == np.round(np.asarray(a, np.float64) / s))
    assert 2.0 ** -11 / low == np.round(2.0 ** -11 / low)
    worst = (np.abs(beta).astype(np.float64) @ np.abs(x).T + np.abs(alpha).max(1)[:, None]).max()
    assert worst < 2.0 ** 24 * low
    assert raw["x"].shape == (raw["g"].shape[0], d) and beta.shape == (c, d)
    assert alpha.shape == (c, groups)
    if gaps is not None:
        assert np.array_equal(raw["g"], cs.sizes_with_gaps(groups, gaps))
    # bf16 rounds x (x_lo is not 0), and beta too where D <= 32 (given
    # enough of its values: one may be exact)
    bf16 = lambda a: torch.as_tensor(a).bfloat16().float().numpy()
    assert np.any(bf16(raw["x"]) != raw["x"])
    if d <= 32 and beta.size >= 32:
        assert np.any(bf16(beta) != beta)
    if scale > 1.0:
        logits = beta.astype(np.float64) @ x.T + alpha[:, raw["g"]]
        assert logits.max() > 30 and logits.min() < -30


def test_b1_edge_cases_cover_every_shared_memory_tier_and_ragged_n():
    shapes = {(c, d) for _, _, d, _, c, _, _ in cs.B1_EDGE_CASES}
    assert (64, 249) in shapes and (128, 126) in shapes and (100, 130) in shapes
    assert {n % 4 for _, n, *_ in cs.B1_EDGE_CASES if n} >= {1, 2, 3}
    assert any(0 < n < 128 for _, n, *_ in cs.B1_EDGE_CASES)
    # chain counts off the n-tiles of 8 and past one 64-chain chunk
    assert {c for *_, c, _, _ in cs.B1_EDGE_CASES} >= {1, 5, 7, 9, 33, 70, 100, 128}
