"""CUDA kernels B1-B4 against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips inside itself when no CUDA device is
present, so collection is the same on every host.  Run on a machine
with the card:  ``python -m pytest -m gpu tests/test_torch_gpu_kernels.py``.

Tolerances are the JAX package's for these kernels (value rtol 2e-5;
gradients rtol 2e-4 / atol 1e-4; for the LMM kernel B4 gradients rtol
3e-4 / atol 3e-4, tests/test_hier_fused.py): the kernel and the plain
version sum in different orders in float32.  Repeated launches must be bitwise equal
(the kernels reduce in a fixed order, without atomics).  B1 runs at each
dot precision (STARK_FUSED_PRECISION): at high and default it is held to
the plain version at that precision in float64 on dyadic inputs, whose
logits are exact, with the bernoulli link's slack (chip_smoke.link_slack):
rows whose resid lies within the link's error of a bf16 rounding boundary
may round apart.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (B1_CHUNK_EDGE_CASES, B2_EDGE_CASES, B2_SHARD_EDGE_CASES, b1_edge_inputs,
                        b1_link_slack, b2_edge_inputs, b2_link_slack, compare_slack,
                        off_16_bytes)
from chip_smoke import sizes_with_gaps as _sizes_with_gaps
from stark_tpu_torch.ops import hier_fused, logistic_fused

pytestmark = pytest.mark.gpu

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
PRECISIONS = ["highest", "high", "default"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _dyadic(rs, shape, k, step):
    """Draws from the grid {-k, ..., k} * step (step a power of two)."""
    return (rs.randint(-k, k + 1, size=shape) * step).astype(np.float32)


def _grouped_case(n, d, groups, chains, seed=0, g=None, beta_scale=0.3, dyadic=False):
    """B1's arguments from rows drawn with a seed; ``g`` (sorted ids, one
    per row) replaces the uniform draw of group ids, ``beta_scale`` sets
    the logits' spread.  ``dyadic``: x in halves of [-1, 1], alpha in
    quarters of [-1, 1], beta on a grid of four steps each way, the step
    the power of two nearest beta_scale / 2.4, so the logits are exact in
    float32."""
    rs = np.random.RandomState(seed)
    n = n if g is None else g.shape[0]
    raw = {
        "x": _dyadic(rs, (n, d), 2, 0.5) if dyadic else rs.standard_normal((n, d)).astype(np.float32),
        "y": (rs.rand(n) < 0.4).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32) if g is None else g,
    }
    prep = hier_fused.prepare_grouped(raw, d)
    assert prep is not None
    dev = _cuda()
    t = {k: torch.as_tensor(prep[k], device=dev) for k in ("xT", "y", "gl", "first_gid")}
    if dyadic:
        beta = _dyadic(rs, (chains, d), 4, 2.0 ** round(np.log2(beta_scale / 2.4)))
        alpha = _dyadic(rs, (chains, groups), 4, 0.25)
    else:
        beta = beta_scale * rs.standard_normal((chains, d))
        alpha = rs.standard_normal((chains, groups))
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return (beta, alpha, t["xT"], t["y"], t["gl"], t["first_gid"], prep["lane_tile"])


def _fine_case(n, d, groups, chains, seed=0, g=None, beta_scale=0.3):
    """B1's arguments on chip_smoke.b1_edge_inputs' dyadic grids (x in
    steps of 2^-9, so that bf16 rounds it and x_lo is not 0; beta's scale
    as ``beta_scale``), whose logits are exact in float32; ``g`` replaces
    the uniform draw of group ids."""
    rs = np.random.RandomState(seed)
    n = n if g is None else g.shape[0]
    raw, (beta, alpha) = b1_edge_inputs(("", n, d, groups, chains, None, beta_scale), rs)
    if g is not None:
        raw["g"] = g
    prep = hier_fused.prepare_grouped(raw, d)
    dev = _cuda()
    t = {k: torch.as_tensor(prep[k], device=dev) for k in ("xT", "y", "gl", "first_gid")}
    return (torch.as_tensor(beta, device=dev), torch.as_tensor(alpha, device=dev), t["xT"],
            t["y"], t["gl"], t["first_gid"], prep["lane_tile"])


def _assert_within_slack(got, args, prec):
    """The kernel at ``prec`` against the plain version at ``prec`` in
    float64: highest's tolerances plus the link's slack."""
    want = _in_float64(functools.partial(hier_fused.hier_grouped_plain, prec=prec), args)
    _, excess = compare_slack("", got, want, b1_link_slack(args, prec), GRAD_RTOL, GRAD_ATOL,
                              quiet=True)
    assert excess <= 0, f"error exceeds its bound by {excess:.4g}"


def _in_float64(plain, args):
    """``plain`` evaluated in float64 on the same inputs (index arrays and
    ints as they are), rounded to float32: the edge cases' yardstick.  The
    float32 plain version's own rounding (cuBLAS over tens of thousands
    of rows) exceeds atol 1e-4 on entries near 0."""
    out = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                  for a in args))
    return [o.float() for o in out]


def _grouped(n, d, groups, chains, seed=0):
    beta, alpha, xT, y, gl, first_gid, lane_tile = _grouped_case(n, d, groups, chains, seed)
    return beta, alpha, {"xT": xT, "y": y, "gl": gl, "first_gid": first_gid}, lane_tile


def _assert_parity(got, want):
    torch.testing.assert_close(got[0], want[0], rtol=VAL_RTOL, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _launch_b1_twice(args, prec):
    """Two launches of B1 at ``prec``, both counted at that precision."""
    hg = hier_fused.hier_grouped
    before = (hg.launches, hg.precision_launches[prec])
    got, again = hg(*args), hg(*args)
    torch.cuda.synchronize()
    assert (hg.launches, hg.precision_launches[prec]) == (before[0] + 2, before[1] + 2)
    return got, again


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize(
    "n,d,groups,chains",
    [(3000, 5, 20, 1), (3000, 5, 20, 5), (100_037, 32, 1000, 64),
     (40_000, 8, 4000, 33), (129, 3, 2, 7)],
)
def test_b1_matches_plain_and_repeats_bitwise(n, d, groups, chains, prec, monkeypatch):
    """Highest on normal inputs against the float32 plain version; high
    and default on dyadic ones (`_fine_case`) within the link's slack:
    on normal inputs a resid within the float32 logits' error of a bf16
    rounding boundary rounds apart, which no slack can know."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", prec)
    if prec == "highest":
        beta, alpha, t, lane_tile = _grouped(n, d, groups, chains)
        args = (beta, alpha, t["xT"], t["y"], t["gl"], t["first_gid"], lane_tile)
    else:
        args = _fine_case(n, d, groups, chains)
    got, again = _launch_b1_twice(args, prec)
    if prec == "highest":
        _assert_parity(got, hier_fused.hier_grouped_plain(*args))
    else:
        _assert_within_slack(got, args, prec)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


_B1_EDGE_CASES = {
    # chain counts off the 64-chain chunk, feature counts off the 32-feature chunk
    **{f"C={c} D={d}": dict(n=3001, d=d, groups=20, chains=c)
       for c in (1, 7, 33, 100) for d in (1, 3, 33)},
    # less than one 128-row sub-tile; N = 1, 2, 3 (mod 4), so rows of xT
    # past the first start off 16-byte alignment
    "N<sub-tile": dict(n=50, d=5, groups=3, chains=9),
    "N=1 mod 4": dict(n=40_001, d=32, groups=300, chains=64),
    "N=2 mod 4": dict(n=40_002, d=7, groups=300, chains=64),
    "N=3 mod 4": dict(n=40_003, d=32, groups=300, chains=70),
    # groups straddling sub-tiles and blocks, one-row groups, ids without rows
    "gaps": dict(n=0, d=32, groups=300, chains=64, g=_sizes_with_gaps(300, 1)),
    "gaps C=33 D=3": dict(n=0, d=3, groups=300, chains=33, g=_sizes_with_gaps(300, 2)),
    # logits beyond +-30 in both directions
    "wide logits": dict(n=20_011, d=32, groups=50, chains=64, beta_scale=8.0),
    "wide logits C=5": dict(n=5003, d=6, groups=10, chains=5, beta_scale=20.0),
    # wide rows: one x buffer (D=128, 160; C=100 in two chunks), then the
    # gradient sums in device memory (D=200, C=128 D=126), up to the widest
    # that fits one block at C=64
    "D=128 C=64": dict(n=20_011, d=128, groups=50, chains=64),
    "D=160 C=64": dict(n=20_011, d=160, groups=50, chains=64),
    "D=130 C=100": dict(n=5003, d=130, groups=30, chains=100),
    "D=200 C=64": dict(n=5003, d=200, groups=30, chains=64),
    "D=126 C=128": dict(n=5003, d=126, groups=30, chains=128),
    "D=249 C=64": dict(n=3001, d=249, groups=20, chains=64),
}


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("case", list(_B1_EDGE_CASES))
def test_b1_edge_cases_match_plain_and_repeat_bitwise(case, prec, monkeypatch):
    """Highest on normal inputs against the float32 plain version; high
    and default on `_fine_case`'s dyadic inputs within the link's slack
    (`test_b1_matches_plain_and_repeats_bitwise`)."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", prec)
    kw = _B1_EDGE_CASES[case]
    args = _grouped_case(**kw) if prec == "highest" else _fine_case(**kw)
    if "beta_scale" in kw:
        logits = args[0] @ args[2]
        assert float(logits.max()) > 30 and float(logits.min()) < -30
    got, again = _launch_b1_twice(args, prec)
    if prec == "highest":
        _assert_parity(got, hier_fused.hier_grouped_plain(*args))
    else:
        _assert_within_slack(got, args, prec)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("case", list(_B1_EDGE_CASES))
def test_b1_edge_cases_match_float64_on_dyadic_inputs(case, prec, monkeypatch):
    """The same cases on dyadic inputs, whose logits are exact in float32,
    held against the plain version at the same precision in float64 (at
    high and default with the link's slack)."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", prec)
    kw = _B1_EDGE_CASES[case]
    args = _grouped_case(**kw, dyadic=True)
    if "beta_scale" in kw:
        logits = args[0] @ args[2]
        assert float(logits.max()) > 30 and float(logits.min()) < -30
    got, again = _launch_b1_twice(args, prec)
    if prec == "highest":
        _assert_parity(got, _in_float64(hier_fused.hier_grouped_plain, args))
    else:
        _assert_within_slack(got, args, prec)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", B1_CHUNK_EDGE_CASES, ids=[c[0] for c in B1_CHUNK_EDGE_CASES])
def test_b1_chunk_edge_cases_match_float64_and_repeat_bitwise(case, monkeypatch):
    """The chunk pass (hier_chunk, highest on float32 X at C <= 32, D <=
    32) on chip_smoke's sweep of its edges, on dyadic inputs whose logits
    are exact, against the plain version in float64 within highest's
    tolerances; two launches bitwise equal, both counted as the chunk
    pass's."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", "highest")
    _, n, d, groups, chains, gaps, scale = case
    args = _fine_case(n, d, groups, chains, seed=n + d + chains,
                      g=None if gaps is None else _sizes_with_gaps(groups, gaps),
                      beta_scale=scale)
    before = hier_fused.hier_grouped.pass_launches["hier_chunk"]
    got, again = _launch_b1_twice(args, "highest")
    assert hier_fused.hier_grouped.pass_launches["hier_chunk"] == before + 2
    if scale > 1:
        logits = args[0] @ args[2]
        assert float(logits.max()) > 30 and float(logits.min()) < -30
    _assert_parity(got, _in_float64(hier_fused.hier_grouped_plain, args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_b1_refuses_widths_beyond_shared_memory():
    args = _grouped_case(n=1000, d=256, groups=10, chains=64)
    before = hier_fused.hier_grouped.launches
    with pytest.raises(ValueError, match="shared memory per block"):
        hier_fused.hier_grouped(*args)
    assert hier_fused.hier_grouped.launches == before


# B2's widest D per shared-memory tier (csrc/logistic_batched.cu:layout):
# at C=32 one tile to D=32, two buffers to 51, one buffer to 273, the
# gradient sums in device memory to 327; at C=64 two buffers to 32, one
# to 206, device memory to 273.  One width further is refused.
_B2_TIER_WIDEST = {32: (32, 51, 273, 327), 64: (32, 206, 273)}
_B2_REFUSED = {32: 328, 64: 274}

# chip_smoke.B2_EDGE_CASES: chain and feature counts off the 32-wide
# chunks and at the edges of the narrow ones (b2_chunk); less than one
# 128-row sub-tile and N = 1, 2, 3 (mod 4), so rows of xT, offsets and
# resid past the first start off 16-byte alignment; more sub-tiles than
# B2's 396 blocks, with chunks of chains, features past one chunk, each
# tier, and b2_chunk's ring taken round; the widest D of each tier
_B2_EDGE_CASES = list(B2_EDGE_CASES)
assert all((1001, d, c) in _B2_EDGE_CASES for c, ds in _B2_TIER_WIDEST.items() for d in ds)


def _dyadic_b2_case(n, d, chains, link, seed):
    """B2's arguments on small dyadic grids (x in halves of [-1, 1], beta
    in eighths of [-1/2, 1/2], offsets in quarters of [-1, 1], a gaussian
    y in quarters of [-2, 2]): the logits are exact in float32, and so is
    every step of the gaussian link, so a wrong or missing row shows at
    any width while float32 rounding does not."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(seed)

    def grid(shape, k, step):
        return torch.randint(-k, k + 1, shape, generator=g, device=dev).float() * step

    xT = grid((d, n), 2, 0.5)
    if link == "gaussian":
        y = grid((n,), 8, 0.25)
    else:
        y = (torch.rand(n, device=dev, generator=g) < 0.4).float()
    return grid((chains, d), 4, 0.125), xT, y, grid((chains, n), 4, 0.25)


@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("n,d,chains", _B2_EDGE_CASES)
def test_b2_edge_cases_match_plain_and_repeat_bitwise(n, d, chains, with_offsets, link):
    """Against the plain version in float64: the float32 plain version's
    own rounding (cuBLAS over tens of thousands of rows) exceeds atol
    1e-4 on entries near 0."""
    beta, xT, y, off = _dyadic_b2_case(n, d, chains, link, seed=n + d + chains)
    off = off if with_offsets else None
    lb = logistic_fused.logistic_batched
    before = (lb.launches, lb.gaussian_launches)
    got = lb(beta, xT, y, off, link=link)
    again = lb(beta, xT, y, off, link=link)
    torch.cuda.synchronize()
    bump = (2, 0) if link == "bernoulli_logit" else (0, 2)
    assert (lb.launches, lb.gaussian_launches) == (before[0] + bump[0], before[1] + bump[1])
    want = _in_float64(logistic_fused.logistic_batched_plain, (beta, xT, y, off, link))
    _assert_parity(got, want)
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


def lmm_arrays(n, d, q, groups, chains, seed=0, g=None, dyadic=False):
    """B4's arguments as numpy arrays, (beta, u, ic, prepared data), from
    rows drawn with a seed; ``g`` (sorted ids, one per row) replaces the
    uniform draw of group ids.  ``dyadic``: x and z's slopes in halves of
    [-1, 1], y in quarters of [-2, 2], beta in eighths of [-1/2, 1/2], u
    and the intercepts in quarters of [-1, 1], so mu and resid are exact
    in float32."""
    rs = np.random.RandomState(seed)
    n = n if g is None else g.shape[0]
    if dyadic:
        z = _dyadic(rs, (n, q - 1), 2, 0.5)
        x, y = _dyadic(rs, (n, d), 2, 0.5), _dyadic(rs, (n,), 8, 0.25)
    else:
        z = rs.standard_normal((n, q - 1))
        x, y = rs.standard_normal((n, d)), rs.standard_normal(n)
    raw = {
        "x": x.astype(np.float32),
        "z": np.concatenate([np.ones((n, 1)), z], axis=1).astype(np.float32),
        "y": y.astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32) if g is None else g,
    }
    prep = hier_fused.prepare_grouped(raw, d + q, transpose_keys=("x", "z"))
    assert prep is not None
    if dyadic:
        beta = _dyadic(rs, (chains, d), 4, 0.125)
        u, ic = _dyadic(rs, (chains, groups, q), 4, 0.25), _dyadic(rs, (chains,), 4, 0.25)
    else:
        beta = 0.3 * rs.standard_normal((chains, d))
        u, ic = 0.5 * rs.standard_normal((chains, groups, q)), rs.standard_normal(chains)
    return (beta.astype(np.float32), u.astype(np.float32), ic.astype(np.float32), prep)


def _lmm(n, d, q, groups, chains, seed=0, g=None, dyadic=False):
    """`lmm_arrays` on the card, in lmm_grouped's argument order."""
    beta, u, ic, prep = lmm_arrays(n, d, q, groups, chains, seed, g, dyadic)
    dev = _cuda()
    t = {k: torch.as_tensor(prep[k], device=dev)
         for k in ("xT", "zT", "y", "gl", "first_gid")}
    beta, u, ic = (torch.as_tensor(a, device=dev) for a in (beta, u, ic))
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


def _ids_between(n, lo, hi, seed):
    """n sorted ids drawn from [lo, hi): ids below lo and from hi on have
    no rows."""
    return np.sort(np.random.RandomState(seed).randint(lo, hi, size=n)).astype(np.int32)


def _sizes_between(groups, lo, hi, seed, long_group=None):
    """Sorted ids, group sizes drawn from [lo, hi); ``long_group`` = (id,
    rows) gives one group that many rows."""
    sizes = np.random.RandomState(seed).randint(lo, hi, size=groups)
    if long_group is not None:
        sizes[long_group[0]] = long_group[1]
    return np.repeat(np.arange(groups, dtype=np.int32), sizes)


# B4's edge cases (csrc/lmm_grouped.cu): ids without rows; groups that
# cross sub-tiles and blocks; chain counts in each instantiation (C <= 8,
# <= 16, <= 32 one tile) and past it; Q = 2, 3; N below one sub-tile and
# N = 1, 2, 3 (mod 4), so rows of xT and zT past the first start off
# 16-byte alignment; each shared-memory tier (csrc/lmm_grouped.cu:layout:
# two buffers, one buffer from D = 9 or at C = 17, Q = 3, the gradient
# sums in device memory, the widest D at C = 64).  Past 396 sub-tiles
# (N > 50,688) blocks take two sub-tiles.
_B4_EDGE_CASES = {
    # every 7th id without rows, every 5th with one row: ids without rows
    # between two groups of one row block get a zero gradient
    "gaps C=16 D=8 Q=2": dict(n=0, d=8, q=2, groups=300, chains=16, g=_sizes_with_gaps(300, 1)),
    "gaps C=33 D=3 Q=3": dict(n=0, d=3, q=3, groups=300, chains=33, g=_sizes_with_gaps(300, 2)),
    # rows only for ids 5 .. G-6
    "ids without rows at both ends": dict(n=0, d=8, q=2, groups=300, chains=16,
                                          g=_ids_between(20_011, 5, 295, 3)),
    # one group of 5000 rows: 40 sub-tiles, over 33 blocks
    "one group over several blocks": dict(n=0, d=8, q=2, groups=400, chains=16,
                                          g=_sizes_between(400, 100, 200, 4, (200, 5000))),
    # groups of 150-250 rows in blocks of two sub-tiles (N about 60,000)
    "groups over sub-tiles": dict(n=0, d=8, q=3, groups=300, chains=17,
                                  g=_sizes_between(300, 150, 250, 5)),
    **{f"C={c} Q={q}": dict(n=3001, d=8, q=q, groups=20, chains=c)
       for c in (1, 16, 17, 33, 64) for q in (2, 3)},
    "N<sub-tile": dict(n=50, d=5, q=2, groups=3, chains=9),
    "N=1 mod 4": dict(n=40_001, d=8, q=2, groups=4000, chains=16),
    "N=2 mod 4": dict(n=40_002, d=3, q=3, groups=300, chains=33),
    "N=3 mod 4": dict(n=40_003, d=9, q=2, groups=4000, chains=64),
    "D=200 C=64": dict(n=3001, d=200, q=2, groups=20, chains=64),
    "D=216 C=64": dict(n=1001, d=216, q=2, groups=20, chains=64),
}
#: B4 at C=64, Q=2 refuses D=217, one past its widest tier (layout)
_B4_REFUSED = (64, 2, 217)


@pytest.mark.parametrize("case", list(_B4_EDGE_CASES))
def test_b4_edge_cases_match_plain_and_repeat_bitwise(case):
    """On dyadic inputs, against the plain version in float64; an id
    without rows gets exactly 0."""
    args = _lmm(**_B4_EDGE_CASES[case], dyadic=True)
    before = hier_fused.lmm_grouped.launches
    got = hier_fused.lmm_grouped(*args)
    again = hier_fused.lmm_grouped(*args)
    torch.cuda.synchronize()
    assert hier_fused.lmm_grouped.launches == before + 2
    want = _in_float64(hier_fused.lmm_grouped_plain, args)
    torch.testing.assert_close(got[0], want[0], rtol=VAL_RTOL, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    groups = hier_fused.absolute_groups(args[6], args[7], args[8])
    empty = torch.ones(args[1].shape[1], dtype=torch.bool, device=groups.device)
    empty[groups] = False
    assert torch.all(got[3][:, empty, :] == 0)


def test_b4_refuses_widths_beyond_shared_memory():
    c, q, d = _B4_REFUSED
    dev = _cuda()
    need, limit = hier_fused.b4_shared_memory(c, d - 1, q, dev.index or 0)
    assert need <= limit
    need, limit = hier_fused.b4_shared_memory(c, d, q, dev.index or 0)
    assert need > limit
    args = _lmm(300, d, q, 10, c)
    before = hier_fused.lmm_grouped.launches
    with pytest.raises(ValueError, match="shared memory per block"):
        hier_fused.lmm_grouped(*args)
    assert hier_fused.lmm_grouped.launches == before


def _parent_b4_widest(c, q):
    """Widest D at which B4 ran before it had a pass of its own, for C=c
    chains and Q=q effects: that pass's layout (csrc/lmm_grouped.cu:
    smem_layout) in one block of 227 KB."""
    cp = -(-c // 32) * 32

    def r4(v):
        return (v + 3) & ~3

    def words(d):
        return (r4(129 * d) + r4(129 * q) + 2 * r4(32 * 129) + 256 + 2 * r4(d * cp)
                + 4 * cp + r4(cp * q) + r4(129) + 8)

    d = 0
    while 4 * words(d + 1) <= 227 * 1024:
        d += 1
    return d


@pytest.mark.parametrize("chains", [1, 16, 33, 64, 128, 256])
def test_b4_runs_every_width_the_parent_ran_at_two_effects(chains):
    """At Q = 2 (random intercepts and slopes); with more effects the
    staged u rows (16 KB per effect at 32 chains) narrow the widest D."""
    dev = _cuda()
    d = _parent_b4_widest(chains, 2)
    need, limit = hier_fused.b4_shared_memory(chains, d, 2, dev.index or 0)
    assert need <= limit, (chains, d, need, limit)


@pytest.mark.parametrize("nblk,c,d,q", [(1, 1, 1, 2), (396, 16, 8, 2), (7, 33, 9, 3)])
def test_b4_scratch_carve_matches_the_kernel(nblk, c, d, q):
    """hier_fused.b4_scratch against the kernel's own carve."""
    import ctypes

    from stark_tpu_torch import _build

    _cuda()
    fn = _build.function("lmm_grouped", "stark_lmm_grouped_scratch",
                         [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 8)()
    assert fn(nblk, c, d, q, out) == 0
    offsets, words = hier_fused.b4_scratch(nblk, c, d, q)
    assert list(out) == [offsets[k] for k in hier_fused.B4_PARTIALS] + [words]


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


def test_b2_wide_logits_match_plain():
    """Logits beyond +-30 in both directions, through the hardware link."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    xT = torch.randn(20, 20_011, device=dev, generator=g)
    y = (torch.rand(20_011, device=dev, generator=g) < 0.4).float()
    beta = 8.0 * torch.randn(64, 20, device=dev, generator=g)
    off = torch.randn(64, 20_011, device=dev, generator=g)
    logits = beta @ xT
    assert float(logits.max()) > 30 and float(logits.min()) < -30
    got = logistic_fused.logistic_batched(beta, xT, y, off)
    _assert_parity(got, logistic_fused.logistic_batched_plain(beta, xT, y, off))


def _parent_pass_widest(c):
    """Widest D at which B2 ran as an instantiation of the shared pass in
    csrc/fused_pass.cuh, before it had a pass of its own, for C=c chains:
    that pass's layout smem_layout(C, D, 0, 1) in one block of 227 KB."""
    cp = -(-c // 32) * 32

    def r4(v):
        return (v + 3) & ~3

    def words(d):
        return (r4(129 * d) + 2 * r4(32 * 129) + 256 + r4(d * cp) + r4(cp * d)
                + 4 * cp + r4(cp) + r4(129) + 8)

    d = 0
    while 4 * words(d + 1) <= 227 * 1024:
        d += 1
    return d


@pytest.mark.parametrize("chains", [1, 32, 33, 64, 128, 256, 512, 1024])
def test_b2_runs_every_width_the_shared_pass_ran(chains):
    dev = _cuda()
    d = _parent_pass_widest(chains)
    need, limit = logistic_fused.b2_shared_memory(chains, d, dev.index or 0)
    assert need <= limit, (chains, d, need, limit)


@pytest.mark.parametrize("chains", [1, 7, 8, 9, 15, 16, 17, 24, 25, 32, 33, 64, 100])
def test_b2_chunk_choice_is_the_python_mirror(chains):
    """The chunk the launcher runs (b2_chunk's 8 or 16 chains and 8, 16 or
    32 features at C <= 16, D <= 32; 32 and 32 past them) is
    logistic_fused.b2_chunks', and the pass it runs at each dot precision
    (b2_chunk; past it b2_pass at highest, b2_mma at high and default)
    and the chains that pass computes (b2_mma's last chunk padded to 8)
    are logistic_fused.b2_route's, which the CPU tests check."""
    import ctypes

    from stark_tpu_torch import _build
    from stark_tpu_torch.ops.precision import PRECISIONS as CODES

    _cuda()
    fn = _build.function("logistic_batched", "stark_logistic_batched_chunks",
                         [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4)
    for prec in PRECISIONS:
        for d in (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 100, 327):
            ch, f, route, padded = (ctypes.c_int() for _ in range(4))
            assert fn(chains, d, CODES[prec], ctypes.byref(ch), ctypes.byref(f),
                      ctypes.byref(route), ctypes.byref(padded)) == 0
            assert (ch.value, f.value) == logistic_fused.b2_chunks(chains, d), (chains, d)
            assert (logistic_fused.B2_ROUTES[route.value], padded.value) == (
                logistic_fused.b2_route(chains, d, prec)), (chains, d, prec)
    ch, f, route, padded = (ctypes.c_int() for _ in range(4))
    assert fn(chains, 8, 7, ctypes.byref(ch), ctypes.byref(f), ctypes.byref(route),
              ctypes.byref(padded)) != 0  # no such precision


@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("chains", sorted(_B2_REFUSED))
def test_b2_refuses_widths_beyond_shared_memory(chains, link):
    dev = _cuda()
    d = _B2_REFUSED[chains]
    need, limit = logistic_fused.b2_shared_memory(chains, d - 1, dev.index or 0)
    assert need <= limit
    xT = torch.zeros(d, 300, device=dev)
    y = torch.zeros(300, device=dev)
    beta = torch.zeros(chains, d, device=dev)
    lb = logistic_fused.logistic_batched
    before = (lb.launches, lb.gaussian_launches)
    with pytest.raises(ValueError, match="shared memory per block"):
        lb(beta, xT, y, torch.zeros(chains, 300, device=dev), link=link)
    assert (lb.launches, lb.gaussian_launches) == before


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


# B2's shard axis (consensus Monte Carlo), chip_smoke.B2_SHARD_EDGE_CASES:
# (S, N, D, C) with one to eight shards, shards below one sub-tile and of
# N = 1, 2, 3 (mod 4) rows, shards of more sub-tiles than their share of
# the blocks or than b2_chunk's ring holds, chain and feature counts off
# the 32-wide chunks and at the edges of the narrow ones, config 2's width
_B2_SHARD_CASES = list(B2_SHARD_EDGE_CASES)


def _dyadic_b2_shards(s, n, d, chains, link, seed):
    parts = [_dyadic_b2_case(n, d, chains, link, seed + k) for k in range(s)]
    return tuple(torch.stack(t) for t in zip(*parts))


@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("s,n,d,chains", _B2_SHARD_CASES)
def test_b2_shard_axis_matches_float64_and_repeats_bitwise(s, n, d, chains, with_offsets, link):
    """Every shard in one launch (one count), against the plain version
    in float64 on dyadic inputs, a second launch bitwise equal."""
    beta, xT, y, off = _dyadic_b2_shards(s, n, d, chains, link, seed=n + d + chains + s)
    off = off if with_offsets else None
    lb = logistic_fused.logistic_batched
    before = (lb.launches, lb.gaussian_launches, lb.shard_launches)
    got = lb(beta, xT, y, off, link=link)
    again = lb(beta, xT, y, off, link=link)
    torch.cuda.synchronize()
    bump = (2, 0) if link == "bernoulli_logit" else (0, 2)
    assert (lb.launches, lb.gaussian_launches, lb.shard_launches) == (
        before[0] + bump[0], before[1] + bump[1], before[2] + 2)
    assert got[0].shape == (s, chains) and got[1].shape == (s, chains, d)
    _assert_parity(got, _in_float64(logistic_fused.logistic_batched_plain, (beta, xT, y, off, link)))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
def test_b2_one_shard_is_the_unsharded_call_bitwise(with_offsets, link):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    n, d, c = 60_003, 16, 8
    xT = torch.randn(1, d, n, device=dev, generator=g)
    y = (torch.rand(1, n, device=dev, generator=g) < 0.4).float()
    beta = 0.3 * torch.randn(1, c, d, device=dev, generator=g)
    off = torch.randn(1, c, n, device=dev, generator=g) if with_offsets else None
    one = logistic_fused.logistic_batched(beta, xT, y, off, link)
    flat = logistic_fused.logistic_batched(beta[0], xT[0], y[0], None if off is None else off[0],
                                           link)
    for a, b in zip(one, flat):
        assert torch.equal(a[0], b)


def test_b2_shard_axis_matches_separate_launches_and_autograd():
    """Eight shards at config 2's chain and feature counts against eight
    unsharded launches (other blocks, so within the tolerances, not
    bitwise), and through the differentiable op."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    s, n, d, c = 8, 20_001, 16, 8
    xT = torch.randn(s, d, n, device=dev, generator=g)
    y = (torch.rand(s, n, device=dev, generator=g) < 0.4).float()
    beta = 0.3 * torch.randn(s, c, d, device=dev, generator=g)
    val, gb = logistic_fused.logistic_batched(beta, xT, y)
    for k in range(s):
        v, gk = logistic_fused.logistic_batched(beta[k], xT[k], y[k])
        torch.testing.assert_close(val[k], v, rtol=VAL_RTOL, atol=0)
        torch.testing.assert_close(gb[k], gk, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    b = beta.clone().requires_grad_(True)
    out = logistic_fused.logistic_loglik(b, xT, y)
    assert out.shape == (s, c)
    (2.0 * out).sum().backward()
    torch.testing.assert_close(b.grad, 2.0 * gb, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        logistic_fused.logistic_batched(beta, xT[:, :, :-1].contiguous(), y)
    with pytest.raises(ValueError, match=r"\(S, C, D\)"):
        logistic_fused.logistic_batched(beta[None], xT, y)


# --- X stored narrow (STARK_FUSED_X_DTYPE, ROADMAP B5) ---------------------

_NARROW = {"bf16": torch.bfloat16, "int8": torch.int8, "fp8e4m3": torch.float8_e4m3fn,
           "fp8e5m2": torch.float8_e5m2}


def _narrow(t, name, scale=4.0):
    """A dyadic slab (halves of [-1, 1]) stored as ``name``, every value
    exact: int8 as round(t * scale), whose 1 / scale the caller folds
    into beta (and u), as a model folds a packed slab's scales."""
    if name == "int8":
        return torch.round(t * scale).to(torch.int8)
    return t.to(_NARROW[name])


def _in_float64_wide(plain, args):
    """`_in_float64` with every narrow slab widened first."""
    return _in_float64(plain, [a.float() if torch.is_tensor(a) and a.dtype in
                               _NARROW.values() else a for a in args])


def _counts(fn, name):
    return fn.x_dtype_launches[name]


def _widened(args):
    """``args`` with every narrow slab widened to float32."""
    return [a.float() if torch.is_tensor(a) and a.dtype in _NARROW.values() else a for a in args]


def _b1_narrow_check(args, prec, name):
    """B1 at ``prec`` on ``args`` (a narrow xT) launched twice, counted by
    dtype and bitwise equal, against its plain version in float64 on the
    widened values: highest's tolerances, at high and default plus the
    link's slack."""
    before = _counts(hier_fused.hier_grouped, name)
    got, again = _launch_b1_twice(args, prec)
    assert _counts(hier_fused.hier_grouped, name) == before + 2
    if prec == "highest":
        _assert_parity(got, _in_float64_wide(hier_fused.hier_grouped_plain, args))
    else:
        _assert_within_slack(got, _widened(args), prec)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("name", list(_NARROW))
@pytest.mark.parametrize("n,d,groups,chains", [(40_003, 32, 300, 64), (3001, 7, 20, 9),
                                               (1027, 33, 12, 70), (50, 5, 3, 9)])
def test_b1_narrow_x_matches_float64_and_repeats_bitwise(n, d, groups, chains, name, prec,
                                                          monkeypatch):
    """B1 on a narrow xT (rows off the 4-element alignment at N = 1, 2, 3
    mod 4, N below a sub-tile, the general kernel past 64 chains or 32
    features) at each dot precision against its plain version in float64
    on the widened values; launches counted by dtype."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", prec)
    beta, alpha, xT, y, gl, fg, lane_tile = _grouped_case(n, d, groups, chains, dyadic=True)
    q = _narrow(xT, name)
    beta = beta / 4.0 if name == "int8" else beta
    _b1_narrow_check((beta, alpha, q, y, gl, fg, lane_tile), prec, name)


@pytest.mark.parametrize("n,d,groups,chains", [(40_003, 32, 300, 64), (3001, 7, 20, 9),
                                               (1027, 33, 12, 70), (20_011, 128, 50, 8)])
def test_b1_narrow_x_at_highest_takes_beta_whole(n, d, groups, chains, monkeypatch):
    """Highest on narrow X with beta and alpha of full float32
    significands (so all three pieces of beta's split are in play), a
    column of beta near 2^-120 and a chain's row near 2^-141 (pieces in
    bf16's subnormal range, a float32 subnormal): the kernel against its
    plain version in float64 within highest's tolerances."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", "highest")
    _, _, xT, y, gl, fg, lane_tile = _grouped_case(n, d, groups, chains, dyadic=True)
    rs = np.random.RandomState(n + d)
    beta = (0.3 * rs.standard_normal((chains, d))).astype(np.float32)
    beta[:, 0] *= np.float32(2.0 ** -120)
    if chains > 1:
        beta[1, :] *= np.float32(2.0 ** -140)
    alpha = rs.standard_normal((chains, groups)).astype(np.float32)
    dev = _cuda()
    for name in ("bf16", "int8"):
        b = torch.as_tensor(beta / 4.0 if name == "int8" else beta, device=dev)
        args = (b, torch.as_tensor(alpha, device=dev), _narrow(xT, name), y, gl, fg, lane_tile)
        _b1_narrow_check(args, "highest", name)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,chains", [(40_003, 32, 64), (3001, 7, 9), (1027, 33, 70)])
def test_b1_narrow_x_off_16_byte_base_is_bitwise_the_aligned_one(n, d, chains, name, prec,
                                                                  monkeypatch):
    """A narrow slab whose base is off 16-byte alignment (a view one
    element into its buffer) keeps the plain loads; its outputs are
    bitwise those of the same values at an aligned base (copied in
    flight through the packed slot), and within the float64 check."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", prec)
    beta, alpha, xT, y, gl, fg, lane_tile = _grouped_case(n, d, 20, chains, dyadic=True)
    q = _narrow(xT, name)
    beta = beta / 4.0 if name == "int8" else beta
    got = _b1_narrow_check((beta, alpha, off_16_bytes(q), y, gl, fg, lane_tile), prec, name)
    aligned = hier_fused.hier_grouped(beta, alpha, q, y, gl, fg, lane_tile)
    assert all(torch.equal(a, b) for a, b in zip(got, aligned))


def test_b1_route_is_the_python_mirror():
    """The pass, tile, compiled n-tiles, narrow staging and shared memory
    the launcher takes for each (C, D, precision, X dtype)
    (csrc/hier_grouped.cu:route) are hier_fused.b1_route's, which the CPU
    tests check; the shared-memory query agrees."""
    import ctypes

    from stark_tpu_torch import _build
    from stark_tpu_torch.ops.precision import PRECISIONS as CODES
    from stark_tpu_torch.ops.precision import X_CODES

    dev = _cuda()
    fn = _build.function("hier_grouped", "stark_hier_grouped_route",
                         [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 5)
    for chains in (1, 4, 7, 8, 9, 16, 17, 32, 33, 64, 65, 100, 128):
        for d in (1, 7, 16, 32, 33, 50, 64, 150, 166, 200, 249):
            for prec in PRECISIONS:
                for name, code in X_CODES.items():
                    out = [ctypes.c_int() for _ in range(5)]
                    assert fn(chains, d, CODES[prec], code, *map(ctypes.byref, out)) == 0
                    mma, one, nt, windows, nbytes = (o.value for o in out)
                    assert (hier_fused.B1_PASSES[mma], bool(one), nt, bool(windows), nbytes) == (
                        hier_fused.b1_route(chains, d, prec, name)), (chains, d, prec, name)
                    need, _ = hier_fused.b1_shared_memory(chains, d, prec, name, dev.index or 0)
                    assert need == nbytes
    out = [ctypes.c_int() for _ in range(5)]
    assert fn(64, 32, 7, 0, *map(ctypes.byref, out)) != 0  # no such precision
    assert fn(64, 32, 0, 9, *map(ctypes.byref, out)) != 0  # no such X dtype


@pytest.mark.parametrize("name", list(_NARROW))
@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("shards,n,d,chains", [(1, 3001, 7, 9), (1, 40_003, 32, 20),
                                               (1, 50, 33, 33), (3, 127, 16, 8),
                                               (2, 3001, 5, 40)])
def test_b2_narrow_x_matches_float64_and_repeats_bitwise(shards, n, d, chains, link, name):
    """B2 (with offsets; with the shard axis at S > 1) on a narrow xT,
    rows off alignment, against float64 on the widened values."""
    dev = _cuda()
    rs = np.random.RandomState(n + d)
    lead = (shards,) if shards > 1 else ()
    t = lambda a: torch.as_tensor(a, device=dev)
    xT = t(_dyadic(rs, lead + (d, n), 2, 0.5))
    y = t(_dyadic(rs, lead + (n,), 8, 0.25) if link == "gaussian"
          else (rs.rand(*lead, n) < 0.4).astype(np.float32))
    beta = t(_dyadic(rs, lead + (chains, d), 4, 0.125))
    off = t(_dyadic(rs, lead + (chains, n), 4, 0.25))
    q = _narrow(xT, name)
    beta = beta / 4.0 if name == "int8" else beta
    before = _counts(logistic_fused.logistic_batched, name)
    got = logistic_fused.logistic_batched(beta, q, y, off, link=link)
    again = logistic_fused.logistic_batched(beta, q, y, off, link=link)
    torch.cuda.synchronize()
    assert _counts(logistic_fused.logistic_batched, name) == before + 2
    want = _in_float64_wide(lambda *a: logistic_fused.logistic_batched_plain(*a, link=link),
                            (beta, q, y, off))
    _assert_parity(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name", list(_NARROW))
@pytest.mark.parametrize("n,d", [(1001, 5), (3, 40), (40_003, 32)])
def test_b3_narrow_x_matches_float64(n, d, name):
    dev = _cuda()
    rs = np.random.RandomState(n)
    xT = torch.as_tensor(_dyadic(rs, (d, n), 2, 0.5), device=dev)
    y = torch.as_tensor((rs.rand(n) < 0.4).astype(np.float32), device=dev)
    beta = torch.as_tensor(_dyadic(rs, (d,), 4, 0.125), device=dev)
    q = _narrow(xT, name)
    beta = beta / 4.0 if name == "int8" else beta
    before = _counts(logistic_fused.logistic_single, name)
    got = logistic_fused.logistic_single(beta, q, y)
    torch.cuda.synchronize()
    assert _counts(logistic_fused.logistic_single, name) == before + 1
    _assert_parity(got, _in_float64_wide(logistic_fused.logistic_single_plain, (beta, q, y)))


@pytest.mark.parametrize("name", list(_NARROW))
@pytest.mark.parametrize("n,d,q,groups,chains", [(40_002, 3, 3, 300, 33),
                                                 (3001, 8, 2, 20, 16), (50, 5, 2, 3, 9)])
def test_b4_narrow_x_and_z_match_float64(n, d, q, groups, chains, name):
    beta, u, ic, xT, zT, *rest = _lmm(n, d, q, groups, chains, dyadic=True)
    qx, qz = _narrow(xT, name), _narrow(zT, name, scale=2.0)
    if name == "int8":
        beta, u = beta / 4.0, u / 2.0
    args = (beta, u, ic, qx, qz, *rest)
    before = _counts(hier_fused.lmm_grouped, name)
    got = hier_fused.lmm_grouped(*args)
    again = hier_fused.lmm_grouped(*args)
    torch.cuda.synchronize()
    assert _counts(hier_fused.lmm_grouped, name) == before + 2
    want = _in_float64_wide(hier_fused.lmm_grouped_plain, args)
    torch.testing.assert_close(got[0], want[0], rtol=VAL_RTOL, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wrappers_refuse_an_unknown_slab_dtype():
    dev = _cuda()
    xT = torch.zeros(3, 100, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="xT has dtype"):
        logistic_fused.logistic_batched(torch.zeros(2, 3, device=dev), xT,
                                        torch.zeros(100, device=dev))


# --- B2 at high and default on the bf16 tensor cores (b2_mma) ---------------

# B2_EDGE_CASES past b2_chunk's (C > 16 or D > 32): b2_mma's shapes at high
# and default, chain counts off its n-tiles of 8 and past one chunk of 32,
# features off its k-steps of 16 and past one chunk of 32, every
# shared-memory tier
_B2_MMA_CASES = [(n, d, c) for n, d, c in B2_EDGE_CASES
                 if logistic_fused.b2_route(c, d, "high")[0] == "b2_mma"]


def _b2_mma_check(args, link, prec, monkeypatch, wide=False):
    """B2 at ``prec`` on ``args`` (dyadic: every logit exact) twice: both
    launches counted at ``prec``, bitwise equal, and against the plain
    version at ``prec`` in float64 within highest's tolerances plus the
    bernoulli link's slack (chip_smoke.b2_link_slack); ``wide``: the slab
    is narrow and the yardstick takes it widened."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", prec)
    lb = logistic_fused.logistic_batched
    before = lb.precision_launches[prec]
    got = lb(*args, link=link)
    again = lb(*args, link=link)
    torch.cuda.synchronize()
    assert lb.precision_launches[prec] == before + 2
    plain = functools.partial(logistic_fused.logistic_batched_plain, link=link, prec=prec)
    want = (_in_float64_wide if wide else _in_float64)(plain, args)
    wide_args = [a.float() if torch.is_tensor(a) and a.dtype in _NARROW.values() else a
                 for a in args]
    _, excess = compare_slack("", got, want, b2_link_slack(wide_args, prec, link), GRAD_RTOL,
                              GRAD_ATOL, quiet=True)
    assert excess <= 0, f"error exceeds its bound by {excess:.4g}"
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("n,d,chains", _B2_MMA_CASES)
def test_b2_mma_edge_cases_match_float64_and_repeat_bitwise(n, d, chains, with_offsets, link,
                                                            prec, monkeypatch):
    """b2_mma on the edge shapes past b2_chunk's, on chip_smoke's grids
    (default: x in steps of 2^-9, which bf16 rounds; high: the coarse
    grid, whose gradient sums are exact in float32 in any order)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(n + d + chains)
    xT, y, beta, off = b2_edge_inputs(n, d, chains, link, gen, dev, fine=prec == "default")
    _b2_mma_check((beta, xT, y, off if with_offsets else None), link, prec, monkeypatch)


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("name", list(_NARROW))
@pytest.mark.parametrize("n", [40_003, 1_000_003])
def test_b2_mma_narrow_x_matches_float64_and_repeats_bitwise(n, name, prec, monkeypatch):
    """b2_mma at C=32, D=32 (the offset path's shape) on a narrow xT,
    with offsets, rows off alignment, against float64 on the widened
    values; launches by dtype."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(n)
    xT, y, beta, off = b2_edge_inputs(n, 32, 32, "bernoulli_logit", gen, dev)
    q = _narrow(xT, name)
    beta = beta / 4.0 if name == "int8" else beta
    before = _counts(logistic_fused.logistic_batched, name)
    _b2_mma_check((beta, q, y, off), "bernoulli_logit", prec, monkeypatch, wide=True)
    assert _counts(logistic_fused.logistic_batched, name) == before + 2


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("s,n,d", [(2, 3001, 33), (3, 40_002, 17), (8, 1001, 32)])
def test_b2_mma_shard_axis_at_33_chains(s, n, d, with_offsets, link, prec, monkeypatch):
    """b2_mma with the shard axis at C=33 (a chunk of 32 and one n-tile
    of 8), one launch for every shard, against float64 on dyadic inputs."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(s + n + d)
    parts = [b2_edge_inputs(n, d, 33, link, gen, dev, fine=prec == "default") for _ in range(s)]
    xT, y, beta, off = (torch.stack(t) for t in zip(*parts))
    lb = logistic_fused.logistic_batched
    before = lb.shard_launches
    _b2_mma_check((beta, xT, y, off if with_offsets else None), link, prec, monkeypatch)
    assert lb.shard_launches == before + 2


# --- B2 on narrow X past b2_chunk: packed X copied in flight through
# b2_mma's slots, highest on the tensor cores by split3 ----------------------


def _b2_narrow_args(n, d, chains, link, name, dev, fine=False, shards=0):
    """b2_edge_inputs' dyadic grids (``shards``: that many stacked) with xT
    stored as ``name`` (int8's 1/4 folded into beta): (beta, xT, y,
    offsets)."""
    gen = torch.Generator(device=dev).manual_seed(n + d + chains + shards)
    if shards:
        parts = [b2_edge_inputs(n, d, chains, link, gen, dev, fine) for _ in range(shards)]
        xT, y, beta, off = (torch.stack(t) for t in zip(*parts))
    else:
        xT, y, beta, off = b2_edge_inputs(n, d, chains, link, gen, dev, fine)
    beta = beta / 4.0 if name == "int8" else beta
    return beta, _narrow(xT, name), y, off


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,chains", _B2_MMA_CASES)
def test_b2_narrow_x_past_the_chunks_matches_float64(n, d, chains, name, prec, monkeypatch):
    """B2 on narrow X at every B2_EDGE_CASES shape past b2_chunk's (b2_mma
    at every precision, highest by split3; the slots where the layout has
    two buffers, plain loads past them), bernoulli with offsets and
    gaussian without, against float64 on the widened values: highest's
    tolerances, at high and default plus the link's slack."""
    dev = _cuda()
    for link, with_off in (("bernoulli_logit", True), ("gaussian", False)):
        beta, q, y, off = _b2_narrow_args(n, d, chains, link, name, dev)
        before = _counts(logistic_fused.logistic_batched, name)
        _b2_mma_check((beta, q, y, off if with_off else None), link, prec, monkeypatch,
                      wide=True)
        assert _counts(logistic_fused.logistic_batched, name) == before + 2


@pytest.mark.parametrize("name", list(_NARROW))
@pytest.mark.parametrize("n,d,chains", [(200_003, 32, 32), (60_001, 100, 32), (3001, 33, 33)])
def test_b2_narrow_x_at_highest_takes_beta_whole(n, d, chains, name, monkeypatch):
    """Highest on narrow X with beta of full float32 significands (all
    three pieces of split3 in play; a column near 2^-120, a chain's row
    near 2^-140) and normal offsets: the kernel against its plain version
    in float64 within highest's tolerances."""
    dev = _cuda()
    _, q, y, _ = _b2_narrow_args(n, d, chains, "bernoulli_logit", name, dev)
    rs = np.random.RandomState(n + d)
    beta = (0.3 * rs.standard_normal((chains, d))).astype(np.float32)
    beta[:, 0] *= np.float32(2.0 ** -120)
    beta[1, :] *= np.float32(2.0 ** -140)
    beta = torch.as_tensor(beta / 4.0 if name == "int8" else beta, device=dev)
    off = torch.as_tensor(rs.standard_normal((chains, n)).astype(np.float32), device=dev)
    _b2_mma_check((beta, q, y, off), "bernoulli_logit", "highest", monkeypatch, wide=True)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("name", ["bf16", "int8", "fp8e4m3"])
@pytest.mark.parametrize("n,d,chains", [(40_003, 32, 32), (3001, 7, 20), (1001, 51, 32),
                                        (1001, 206, 64)])
def test_b2_narrow_x_off_16_byte_base_is_bitwise_the_aligned_one(n, d, chains, name, prec,
                                                                  monkeypatch):
    """A narrow slab whose base is off 16-byte alignment keeps the plain
    loads (and at C=32 the kernel that reads its n-tiles from C); its
    outputs are bitwise those of the same values at an aligned base,
    copied in flight through the packed slots (plain loads past the
    two-buffer tier: D=51 at C=32 has them, D=206 at C=64 not)."""
    dev = _cuda()
    beta, q, y, off = _b2_narrow_args(n, d, chains, "bernoulli_logit", name, dev)
    got = _b2_mma_check((beta, off_16_bytes(q), y, off), "bernoulli_logit", prec, monkeypatch,
                        wide=True)
    aligned = logistic_fused.logistic_batched(beta, q, y, off)
    assert all(torch.equal(a, b) for a, b in zip(got, aligned))
    assert logistic_fused.b2_x_route(chains, d, prec, name, aligned=False)[2:4] == (False, 0)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("s,n,d,chains", [(3, 3001, 7, 32), (2, 1001, 33, 33), (4, 777, 5, 20)])
def test_b2_narrow_x_shards_off_16_bytes_copy_in_flight(s, n, d, chains, name, prec,
                                                        monkeypatch):
    """The shard axis on narrow X at C > 16, each shard's rows starting
    off 16 bytes (S D n elements of 2 or 1 bytes): copied in flight
    against the launch's base, one launch for every shard, against
    float64 on the widened values."""
    dev = _cuda()
    beta, q, y, off = _b2_narrow_args(n, d, chains, "bernoulli_logit", name, dev, shards=s)
    assert (d * n * q.element_size()) % 16
    lb = logistic_fused.logistic_batched
    before = lb.shard_launches
    _b2_mma_check((beta, q, y, off), "bernoulli_logit", prec, monkeypatch, wide=True)
    assert lb.shard_launches == before + 2
    assert logistic_fused.b2_x_route(chains, d, prec, name)[2]


def test_b2_x_route_is_the_python_mirror():
    """The pass, chains, narrow staging, compiled n-tiles and shared memory
    the launcher takes for each (C, D, precision, X dtype, alignment)
    (csrc/logistic_batched.cu:route) are logistic_fused.b2_x_route's,
    which the CPU tests check; the shared-memory query agrees."""
    import ctypes

    from stark_tpu_torch import _build
    from stark_tpu_torch.ops.precision import PRECISIONS as CODES
    from stark_tpu_torch.ops.precision import X_CODES

    dev = _cuda()
    fn = _build.function("logistic_batched", "stark_logistic_batched_route",
                         [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 5)
    for chains in (1, 8, 16, 17, 24, 25, 32, 33, 64, 100):
        for d in (1, 8, 32, 33, 46, 51, 52, 64, 65, 206, 273, 327):
            for prec in PRECISIONS:
                for name, code in X_CODES.items():
                    for aligned in (True, False):
                        out = [ctypes.c_int() for _ in range(5)]
                        assert fn(chains, d, CODES[prec], code, int(aligned),
                                  *map(ctypes.byref, out)) == 0
                        got = (logistic_fused.B2_ROUTES[out[0].value], out[1].value,
                               bool(out[2].value), out[3].value, out[4].value)
                        assert got == logistic_fused.b2_x_route(chains, d, prec, name, aligned), (
                            chains, d, prec, name, aligned)
                    need, _ = logistic_fused.b2_shared_memory(chains, d, dev.index or 0, name)
                    assert need == logistic_fused.b2_x_route(chains, d, prec, name)[4]
    out = [ctypes.c_int() for _ in range(5)]
    assert fn(32, 32, 7, 0, 1, *map(ctypes.byref, out)) != 0  # no such precision
    assert fn(32, 32, 0, 9, 1, *map(ctypes.byref, out)) != 0  # no such X dtype
