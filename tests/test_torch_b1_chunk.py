"""Kernel B1's chunk pass at highest on float32 X (hier_chunk: C <= 32 and
D <= 32, one chunk of 8, 16 or 32 chains), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu_kernels.py).  Here
the bookkeeping around it and the arithmetic it is held to:

- `hier_fused.b1_route`, the mirror of csrc/hier_grouped.cu:route, against
  a table at highest on float32 X, and against the route before the chunk
  pass (kept below as it was) at every (C, D, precision, X dtype) outside
  the chunk's domain;
- the chunk's shared memory against csrc/hier_grouped.cu:layout_chunk's
  header, inside the tier of two blocks an SM;
- the plain version at highest, which the kernel is held to on the card,
  against the reference's `_grouped_call` (interpret mode) at the chain
  counts the chunk pass takes;
- chip_smoke's chunk edge sweep, its --compare-with keys and the probe's
  variants of the chunk pass.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import b1_narrow_probe
import chip_smoke as cs
from stark_tpu.ops import hier_fused as ref
from stark_tpu_torch.ops import hier_fused as phf
from stark_tpu_torch.ops.logistic_fused import x_window_chunks
from stark_tpu_torch.ops.precision import X_DTYPE_NAMES

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
SOURCE = Path(phf.__file__).resolve().parent.parent / "csrc" / "hier_grouped.cu"
PRECISIONS = ("highest", "high", "default")

#: words of layout_chunk at 8, 16 and 32 chains: three x buffers of 32 x
#: 132 words with y and local ids (3 x 4480); two of resid (132 a chain),
#: of the segment starts and count (136) and of the run sums (16 a
#: chain); beta (36 a chain), value partials (8 a chain), the open groups
#: (3 a chain)
CHUNK_WORDS = {ch: 3 * 4480 + 2 * (132 * ch + 136 + 16 * ch) + 36 * ch + 8 * ch + 3 * ch
               for ch in (8, 16, 32)}

CHAINS = (1, 4, 7, 8, 9, 16, 17, 32, 33, 64, 100)
FEATURES = (1, 16, 32, 33)


def _want(c, d):
    """The route at highest on float32 X, by hand: hier_chunk's chunk of
    8, 16 or 32 chains at C <= 32 and D <= 32, hier_pass past them."""
    if c <= 32 and d <= 32:
        ch = 8 if c <= 8 else 16 if c <= 16 else 32
        return ("hier_chunk", True, ch // 8, False, 4 * CHUNK_WORDS[ch])
    return ("hier_pass", c <= 64 and d <= 32, 0, False,
            4 * phf.b1_layout(c, d, "highest", False)[1])


@pytest.mark.parametrize("d", FEATURES)
@pytest.mark.parametrize("c", CHAINS)
def test_route_at_highest_on_float32_x(c, d):
    assert phf.b1_route(c, d, "highest", "f32") == _want(c, d)
    assert phf.b1_chunk_chains(c, d) == (_want(c, d)[2] * 8)


def _parent_route(c, d, prec, x_dtype):
    """csrc/hier_grouped.cu:route before the chunk pass (its Python mirror
    as it was): highest on float32 X is hier_pass at every (C, D)."""
    narrow = x_dtype != "f32"
    mma = prec != "highest" or narrow
    one = -(-c // 64) == 1 and d <= 32
    nt8 = -(-min(c, 64) // 8)
    ntiles = 1 if nt8 <= 1 else 2 if nt8 <= 2 else 4 if nt8 <= 4 else 8
    nbuf, words = phf.b1_layout(c, d, prec, mma)
    windows = False
    if narrow:
        slot = d * x_window_chunks(128, {"bf16": 2}.get(x_dtype, 1)) * 4
        windows = 4 * (words + slot) <= (113 * 1024 if nbuf == 2 else 227 * 1024)
        words += slot if windows else 0
    compiled = ntiles == 1 or (ntiles == 8 and (prec == "default" or narrow))
    nt = ntiles if mma and one and (windows or not narrow) and compiled else 0
    return ("hier_mma" if mma else "hier_pass"), one, nt, windows, 4 * words


@pytest.mark.parametrize("x_dtype", X_DTYPE_NAMES)
@pytest.mark.parametrize("prec", PRECISIONS)
def test_every_case_outside_the_chunk_keeps_the_parents_route(prec, x_dtype):
    inside = 0
    for c in (*range(1, 70), 100, 128, 129, 192, 256):
        for d in range(1, 260, 3):
            got = phf.b1_route(c, d, prec, x_dtype)
            if prec == "highest" and x_dtype == "f32" and c <= 32 and d <= 32:
                assert got[0] == "hier_chunk", (c, d)
                inside += 1
                continue
            assert got == _parent_route(c, d, prec, x_dtype), (c, d)
    assert inside == (32 * 11 if prec == "highest" and x_dtype == "f32" else 0)


def test_the_chunk_refuses_no_width_the_parent_took():
    """Every (C, D) the chunk takes fits two blocks an SM (113 KB a block,
    under the card's 227 KB), so nothing that ran before is refused."""
    for c in range(1, 33):
        for d in range(1, 33):
            assert phf.b1_route(c, d, "highest")[4] <= 113 * 1024
            assert _parent_route(c, d, "highest", "f32")[4] <= 227 * 1024


def test_chunk_words_are_the_headers_and_two_blocks_fit_an_sm():
    text = SOURCE.read_text()
    assert int(re.search(r"constexpr int kStages = (\d+);", text).group(1)) == phf.B1_CHUNK_STAGES
    flat = re.sub(r"\s*//\s*", " ", text)  # the comments' lines run together
    m = re.search(r"([\d,]+) words \(([\d,]+) bytes\) at ch = 8, ([\d,]+) \(([\d,]+)\) at 16, "
                  r"([\d,]+) \(([\d,]+)\) at 32: two blocks an SM \(kTwoPerSm\)", flat)
    assert m, "layout_chunk's header names its sizes"
    nums = [int(g.replace(",", "")) for g in m.groups()]
    for ch, (words, nbytes) in zip((8, 16, 32), zip(nums[::2], nums[1::2])):
        assert phf.b1_chunk_words(ch) == CHUNK_WORDS[ch] == words
        assert 4 * words == nbytes <= 113 * 1024


def test_pass_codes_are_the_c_entrys():
    """stark_hier_grouped_route returns 0, 1, 2 for hier_pass, hier_mma,
    hier_chunk."""
    text = SOURCE.read_text()
    assert "*pass = r.chunk ? 2 : r.mma ? 1 : 0;" in text
    assert phf.B1_PASSES == ("hier_pass", "hier_mma", "hier_chunk")


def _data(n, d, groups, seed):
    rs = np.random.RandomState(seed)
    return {
        "x": rs.standard_normal((n, d)).astype(np.float32),
        "y": (rs.rand(n) < 0.4).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32),
    }


@pytest.mark.parametrize("cap", [None, "256"])
@pytest.mark.parametrize("chains", [4, 8, 32])
def test_plain_b1_at_the_chunks_chain_counts_matches_reference(chains, cap, monkeypatch):
    """The plain version at highest (the card's yardstick for hier_chunk)
    against the reference's grouped kernel at highest, D=32, with a
    ragged last tile at both lane tiles."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", "highest")
    if cap is None:
        monkeypatch.delenv("STARK_GROUPED_LANE_TILE", raising=False)
    else:
        monkeypatch.setenv("STARK_GROUPED_LANE_TILE", cap)
    d, groups = 32, 20
    prep = phf.prepare_grouped(_data(3000, d, groups, chains), d)
    rs = np.random.RandomState(100 + chains)
    beta = (0.3 * rs.standard_normal((chains, d))).astype(np.float32)
    alpha = rs.standard_normal((chains, groups)).astype(np.float32)
    want = ref._grouped_call(
        jnp.asarray(beta), jnp.asarray(alpha), jnp.asarray(prep["xT"]), jnp.asarray(prep["y"]),
        jnp.asarray(prep["gl"]), jnp.asarray(prep["first_gid"]), k_loc=prep["k_loc"],
        lane_tile=prep["lane_tile"], interpret=None)
    t = {k: torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")}
    got = phf.hier_grouped(torch.as_tensor(beta), torch.as_tensor(alpha), t["xT"], t["y"],
                           t["gl"], t["first_gid"], prep["lane_tile"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_cpu_calls_count_no_pass():
    prep = phf.prepare_grouped(_data(500, 5, 4, 0), 5)
    before = dict(phf.hier_grouped.pass_launches)
    t = {k: torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")}
    phf.hier_grouped(torch.zeros(8, 5), torch.zeros(8, 4), t["xT"], t["y"], t["gl"],
                     t["first_gid"], prep["lane_tile"])
    assert phf.hier_grouped.pass_launches == before
    assert set(before) == set(phf.B1_PASSES)


# ---- chip_smoke's chunk edge sweep and --compare-with keys ----


def test_chunk_edge_sweep_covers_the_edges_of_every_chunk():
    cases = cs.B1_CHUNK_EDGE_CASES
    shapes = {(c, d) for _, _, d, _, c, _, _ in cases}
    assert {(c, d) for c in (1, 4, 8, 9, 16, 17, 24, 32) for d in (1, 15, 16, 17, 32)} <= shapes
    assert all(phf.b1_route(c, d, "highest")[0] == "hier_chunk" for c, d in shapes)
    assert {phf.b1_chunk_chains(c, d) for c, d in shapes} == {8, 16, 32}
    ns = [n for _, n, *_ in cases if n]
    assert {n % 4 for n in ns} >= {1, 2, 3} and any(n < 128 for n in ns)
    # a block of more sub-tiles than the ring's buffers
    widest = max(np.diff(phf.b1_blocks(n)[1]).min() for n in ns)
    assert widest >= (phf.B1_CHUNK_STAGES + 1) * phf.B1_ROW_TILE
    assert any(gaps is not None for *_, gaps, _ in cases)
    assert any(scale > 1 for *_, scale in cases)


@pytest.fixture(scope="module")
def chunk_edge_inputs():
    rs = np.random.RandomState(21)  # as phase_b1_edges draws them for the chunk
    return [cs.b1_edge_inputs(case, rs) for case in cs.B1_CHUNK_EDGE_CASES]


@pytest.mark.parametrize("i", range(len(cs.B1_CHUNK_EDGE_CASES)))
def test_chunk_edge_inputs_have_exact_logits(i, chunk_edge_inputs):
    """The sweep's logits are exact in float32 in any order of their sums
    (so the kernel is held to float64 by highest's tolerances alone), and
    the wide-logit cases reach beyond +-30 both ways."""
    raw, (beta, alpha) = chunk_edge_inputs[i]
    _, _, d, groups, c, _, scale = cs.B1_CHUNK_EDGE_CASES[i]
    assert beta.shape == (c, d) and alpha.shape == (c, groups)
    logits = beta.astype(np.float64) @ raw["x"].T.astype(np.float64) + alpha[:, raw["g"]]
    assert np.array_equal(logits.astype(np.float32).astype(np.float64), logits)
    if scale > 1:
        assert logits.max() > 30 and logits.min() < -30


def test_compare_with_times_the_chunk_and_expects_it_not_bitwise():
    assert cs.B1_CHUNK_KEYS == ("B1 C=8", "B1 C=16", "B1 C=32")
    for key in cs.B1_CHUNK_KEYS:
        assert key in cs.SHARED_KERNELS
        assert cs.expected_against_parent(key).startswith("no")
    others = [k for k in cs.SHARED_KERNELS if k not in cs.B1_CHUNK_KEYS]
    assert "B1" in others  # C=64 stays on hier_pass, bitwise the parent's
    assert cs.expected_against_parent("B1") == "yes"
    assert len(set(cs.SHARED_KERNELS)) == len(cs.SHARED_KERNELS)
    assert all(phf.b1_route(int(k.split("=")[1]), cs.D, "highest")[0] == "hier_chunk"
               for k in cs.B1_CHUNK_KEYS)


def test_nuts_legs_chain_count_runs_the_chunk():
    assert phf.b1_route(cs.NUTS_CHAINS, cs.D, "highest") == _want(cs.NUTS_CHAINS, cs.D)
    assert phf.b1_route(64, cs.D, "highest")[0] == "hier_pass"  # the flagship's


@pytest.mark.parametrize("name", [n for n in b1_narrow_probe.VARIANTS if n.startswith("chunk_")])
def test_probe_chunk_variants_edit_this_source(name):
    """b1_narrow_probe's variants of the chunk pass (what PERF.md's
    removal probes timed) are edits of this checkout's source, each
    applying once."""
    assert b1_narrow_probe.variant_source(name) != SOURCE.read_text()
