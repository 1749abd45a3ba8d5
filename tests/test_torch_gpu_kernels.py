"""CUDA kernels B1-B4 against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips inside itself when no CUDA device is
present, so collection is the same on every host.  Run on a machine
with the card:  ``python -m pytest -m gpu tests/test_torch_gpu_kernels.py``.

Tolerances are the JAX package's for these kernels (value rtol 2e-5;
gradients rtol 2e-4 / atol 1e-4; for the LMM kernel B4 gradients rtol
3e-4 / atol 3e-4, tests/test_hier_fused.py): the kernel and the plain
version sum in different orders in float32.  Repeated launches must be bitwise equal
(the kernels reduce in a fixed order, without atomics).
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.ops import hier_fused, logistic_fused

pytestmark = pytest.mark.gpu

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _grouped(n, d, groups, chains, seed=0):
    rs = np.random.RandomState(seed)
    raw = {
        "x": rs.standard_normal((n, d)).astype(np.float32),
        "y": (rs.rand(n) < 0.4).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32),
    }
    prep = hier_fused.prepare_grouped(raw, d)
    dev = _cuda()
    t = {k: torch.as_tensor(prep[k], device=dev) for k in ("xT", "y", "gl", "first_gid")}
    beta = torch.as_tensor(0.3 * rs.standard_normal((chains, d)), dtype=torch.float32, device=dev)
    alpha = torch.as_tensor(rs.standard_normal((chains, groups)), dtype=torch.float32, device=dev)
    return beta, alpha, t, prep["lane_tile"]


def _assert_parity(got, want):
    torch.testing.assert_close(got[0], want[0], rtol=VAL_RTOL, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize(
    "n,d,groups,chains",
    [(3000, 5, 20, 1), (3000, 5, 20, 5), (100_037, 32, 1000, 64),
     (40_000, 8, 4000, 33), (129, 3, 2, 7)],
)
def test_b1_matches_plain_and_repeats_bitwise(n, d, groups, chains):
    beta, alpha, t, lane_tile = _grouped(n, d, groups, chains)
    args = (beta, alpha, t["xT"], t["y"], t["gl"], t["first_gid"], lane_tile)
    before = hier_fused.hier_grouped.launches
    got = hier_fused.hier_grouped(*args)
    again = hier_fused.hier_grouped(*args)
    torch.cuda.synchronize()
    assert hier_fused.hier_grouped.launches == before + 2
    _assert_parity(got, hier_fused.hier_grouped_plain(*args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("n,d,chains", [(3000, 5, 1), (100_037, 32, 32), (129, 3, 40)])
def test_b2_matches_plain_and_repeats_bitwise(n, d, chains, with_offsets):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + chains)
    xT = torch.randn(d, n, device=dev, generator=g)
    y = (torch.rand(n, device=dev, generator=g) < 0.4).float()
    beta = 0.3 * torch.randn(chains, d, device=dev, generator=g)
    off = torch.randn(chains, n, device=dev, generator=g) if with_offsets else None
    before = logistic_fused.logistic_batched.launches
    got = logistic_fused.logistic_batched(beta, xT, y, off)
    again = logistic_fused.logistic_batched(beta, xT, y, off)
    torch.cuda.synchronize()
    assert logistic_fused.logistic_batched.launches == before + 2
    _assert_parity(got, logistic_fused.logistic_batched_plain(beta, xT, y, off))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_b1_autograd_on_the_card():
    beta, alpha, t, lane_tile = _grouped(5000, 4, 30, 6)
    b = beta.clone().requires_grad_(True)
    a = alpha.clone().requires_grad_(True)
    val = hier_fused.hier_logistic_loglik(b, a, t["xT"], t["y"], t["gl"], t["first_gid"], lane_tile)
    val.sum().backward()
    _, gb, ga = hier_fused.hier_grouped_plain(beta, alpha, t["xT"], t["y"], t["gl"], t["first_gid"], lane_tile)
    torch.testing.assert_close(b.grad, gb, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    torch.testing.assert_close(a.grad, ga, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_wrappers_refuse_bad_arguments_instead_of_falling_back():
    beta, alpha, t, lane_tile = _grouped(3000, 5, 20, 4)
    with pytest.raises(ValueError, match="dtype"):
        hier_fused.hier_grouped(beta.double(), alpha, t["xT"], t["y"], t["gl"], t["first_gid"], lane_tile)
    with pytest.raises(ValueError, match="contiguous"):
        logistic_fused.logistic_batched(beta.t().contiguous().t(), t["xT"], t["y"])
    with pytest.raises(ValueError, match="expected cuda"):
        logistic_fused.logistic_batched(beta, t["xT"].cpu(), t["y"])


def _lmm(n, d, q, groups, chains, seed=0):
    rs = np.random.RandomState(seed)
    z = np.concatenate([np.ones((n, 1)), rs.standard_normal((n, q - 1))], axis=1)
    raw = {
        "x": rs.standard_normal((n, d)).astype(np.float32),
        "z": z.astype(np.float32),
        "y": rs.standard_normal(n).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32),
    }
    prep = hier_fused.prepare_grouped(raw, d + q, transpose_keys=("x", "z"))
    assert prep is not None
    dev = _cuda()
    t = {k: torch.as_tensor(prep[k], device=dev)
         for k in ("xT", "zT", "y", "gl", "first_gid")}

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    beta = f32(0.3 * rs.standard_normal((chains, d)))
    u = f32(0.5 * rs.standard_normal((chains, groups, q)))
    ic = f32(rs.standard_normal(chains))
    return (beta, u, ic, t["xT"], t["zT"], t["y"], t["gl"], t["first_gid"],
            prep["lane_tile"])


@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("n,d,groups,chains",
                         [(100_037, 8, 10_000, 16), (20_011, 5, 1500, 40), (300, 3, 30, 1)])
def test_b4_matches_plain_and_repeats_bitwise(n, d, groups, chains, q):
    args = _lmm(n, d, q, groups, chains)
    before = hier_fused.lmm_grouped.launches
    got = hier_fused.lmm_grouped(*args)
    again = hier_fused.lmm_grouped(*args)
    torch.cuda.synchronize()
    assert hier_fused.lmm_grouped.launches == before + 2
    want = hier_fused.lmm_grouped_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=VAL_RTOL, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("n,d,chains", [(100_037, 8, 16), (100_000, 32, 32), (129, 3, 40)])
def test_b2_gaussian_matches_plain_and_counts_apart(n, d, chains, with_offsets):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + chains + 1)
    xT = torch.randn(d, n, device=dev, generator=g)
    y = torch.randn(n, device=dev, generator=g)
    beta = 0.3 * torch.randn(chains, d, device=dev, generator=g)
    off = torch.randn(chains, n, device=dev, generator=g) if with_offsets else None
    lb = logistic_fused.logistic_batched
    before = (lb.launches, lb.gaussian_launches)
    got = lb(beta, xT, y, off, link="gaussian")
    again = lb(beta, xT, y, off, link="gaussian")
    torch.cuda.synchronize()
    assert (lb.launches, lb.gaussian_launches) == (before[0], before[1] + 2)
    _assert_parity(got, logistic_fused.logistic_batched_plain(beta, xT, y, off, link="gaussian"))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("n,d", [(1_000_037, 32), (3000, 5), (20_000, 70), (1, 1)])
def test_b3_matches_plain_and_repeats_bitwise(n, d, with_offsets, link):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + d)
    xT = torch.randn(d, n, device=dev, generator=g)
    if link == "gaussian":
        y = torch.randn(n, device=dev, generator=g)
    else:
        y = (torch.rand(n, device=dev, generator=g) < 0.4).float()
    beta = 0.3 * torch.randn(d, device=dev, generator=g)
    off = torch.randn(n, device=dev, generator=g) if with_offsets else None
    before = logistic_fused.logistic_single.launches
    got = logistic_fused.logistic_single(beta, xT, y, off, link)
    again = logistic_fused.logistic_single(beta, xT, y, off, link)
    torch.cuda.synchronize()
    assert logistic_fused.logistic_single.launches == before + 2
    _assert_parity(got, logistic_fused.logistic_single_plain(beta, xT, y, off, link))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_b3_is_the_route_for_one_chain():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    xT = torch.randn(6, 5000, device=dev, generator=g)
    y = (torch.rand(5000, device=dev, generator=g) < 0.5).float()
    b = (0.2 * torch.randn(6, device=dev, generator=g)).requires_grad_(True)
    before = (logistic_fused.logistic_single.launches, logistic_fused.logistic_batched.launches)
    logistic_fused.logistic_loglik(b, xT, y).backward()
    val, gb = logistic_fused.logistic_loglik_value_and_grad(b.detach(), xT, y)
    assert logistic_fused.logistic_single.launches == before[0] + 2
    assert logistic_fused.logistic_batched.launches == before[1]
    torch.testing.assert_close(b.grad, gb, rtol=0, atol=0)


def test_b4_autograd_on_the_card():
    beta, u, ic, xT, zT, y, gl, fg, lane_tile = _lmm(5000, 4, 2, 400, 6)
    sigma = torch.full((6,), 0.7, device=beta.device)
    leaves = [t.clone().requires_grad_(True) for t in (beta, u, ic, sigma)]
    val = hier_fused.lmm_grouped_loglik(*leaves, xT, zT, y, gl, fg, lane_tile)
    val.sum().backward()
    ssr, sres, gb, gu = hier_fused.lmm_grouped_plain(beta, u, ic, xT, zT, y, gl, fg, lane_tile)
    inv2 = 1.0 / 0.49
    torch.testing.assert_close(leaves[0].grad, inv2 * gb, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(leaves[1].grad, inv2 * gu, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(leaves[2].grad, inv2 * sres, rtol=3e-4, atol=3e-4)


def test_new_wrappers_refuse_bad_arguments():
    args = _lmm(3000, 4, 2, 100, 3)
    with pytest.raises(ValueError, match="dtype"):
        hier_fused.lmm_grouped(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        hier_fused.lmm_grouped(args[0], args[1][:, :, :1].contiguous(), *args[2:])
    xT, y = args[3], args[5]
    with pytest.raises(ValueError, match="one chain"):
        logistic_fused.logistic_single(args[0], xT, y)
    with pytest.raises(ValueError, match="contiguous"):
        logistic_fused.logistic_single(args[0][:, 0], xT, y)
    with pytest.raises(ValueError, match="unknown link"):
        logistic_fused.logistic_batched(args[0], xT, y, link="poisson")
