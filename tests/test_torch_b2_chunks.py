"""Kernel B2's launcher, mirrored in Python, on the CPU: which chunk of
chains and features each (C, D) runs (``csrc/logistic_batched.cu``:
``b2_chunk`` at C <= 16 and D <= 32, ``b2_pass``'s 32-chain chunks past
them), the block split it accepts and refuses, the scratch each launch
takes, and the plain version at the chunks' chain
counts against the JAX package's ``_batched_call`` (Pallas, interpret
mode on the CPU, as ``tests/test_torch_logistic_fused.py`` runs it; the
shard axis as the reference's consensus runs it, under ``vmap``), within
the reference's tolerances: value rtol 2e-5, gradients and residuals
rtol 2e-4 / atol 1e-4.

The kernels themselves run only on the card: their tests are
``tests/test_torch_gpu_kernels.py`` (marked ``gpu``), and the card
checks that the launcher picks this mirror's chunks
(``test_b2_chunk_choice_is_the_python_mirror``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import b2_chunk_probe
from stark_tpu.ops import logistic_fused as ref
from stark_tpu_torch.ops import logistic_fused as port

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4


@pytest.mark.parametrize("c,chains", [(1, 8), (7, 8), (8, 8), (9, 16), (15, 16), (16, 16),
                                      (17, 32), (32, 32), (33, 32), (100, 32)])
@pytest.mark.parametrize("d", [1, 16, 32])
def test_chain_chunk_is_the_smallest_that_holds_c(c, chains, d):
    assert port.b2_chunks(c, d)[0] == chains


@pytest.mark.parametrize("d,features", [(1, 8), (7, 8), (8, 8), (9, 16), (15, 16), (16, 16),
                                        (17, 32), (31, 32), (32, 32)])
@pytest.mark.parametrize("c", [1, 8, 9, 16])
def test_feature_chunk_is_the_smallest_that_holds_d(c, d, features):
    assert port.b2_chunks(c, d)[1] == features


@pytest.mark.parametrize("c,d", [(17, 8), (32, 16), (64, 1), (8, 33), (16, 100), (1, 300)])
def test_wider_shapes_take_the_32_chain_pass(c, d):
    """Past 16 chains or 32 features B2 runs b2_pass's chunks of 32."""
    assert port.b2_chunks(c, d) == (32, 32)


@pytest.mark.parametrize("n,shards,blocks", [
    (1, 1, 1), (127, 1, 1), (128, 1, 1), (129, 1, 2), (50_688, 1, 396), (50_689, 1, 396),
    (1_000_000, 1, 396), (125_000, 8, 49), (125_003, 8, 49), (5, 8, 1), (40_003, 3, 132),
    (1001, 396, 1), (1001, 1000, 1), (100_002, 4, 99),
])
def test_b2_block_split_each_shard_about_one_wave(n, shards, blocks):
    """Each shard's row split is `subtile_split` into at most B2_BLOCKS //
    S blocks (at least one), so a launch stays about one 396-block wave;
    every chunk width runs this split, the launcher refusing any other."""
    nblk, edges = port.b2_blocks(n, shards)
    assert nblk == blocks
    assert nblk * shards <= max(port.B2_BLOCKS, shards)
    assert edges[0] == 0 and edges[-1] == n and len(edges) == nblk + 1
    assert all(e % port.B2_ROW_TILE == 0 for e in edges[:-1])
    sub = [-(-(b - a) // port.B2_ROW_TILE) for a, b in zip(edges[:-1], edges[1:])]
    assert min(sub) >= 1 and max(sub) - min(sub) <= 1


@pytest.mark.parametrize("shards", [0, -1, 65_536])
def test_b2_block_split_refuses_shard_counts_the_grid_cannot_hold(shards):
    """The launcher takes 1 <= S <= 65,535 (the grid's y extent)."""
    with pytest.raises(ValueError, match="shards"):
        port.b2_blocks(1000, shards)


@pytest.mark.parametrize("n,c,d,shards", [(1_000_000, 8, 32, 1), (125_000, 8, 16, 8),
                                          (100_000, 16, 8, 1), (3001, 33, 33, 2), (5, 1, 1, 8)])
def test_b2_scratch_holds_every_blocks_partials(n, c, d, shards):
    """The wrapper's scratch: gpart (blocks, C, D), vpart, head, tail
    (blocks, C) and blo, bhi (blocks,) of every shard's blocks
    (csrc/fused_pass.cuh:carve_scratch)."""
    nblk = port.b2_blocks(n, shards)[0] * shards
    assert port.b2_scratch_words(n, c, d, shards) == nblk * (c * d + 3 * c + 2)


def _inputs(shards, c, d, n, seed):
    rs = np.random.RandomState(seed)
    lead = (shards,) if shards > 1 else ()
    xT = rs.standard_normal(lead + (d, n)).astype(np.float32)
    y = (rs.rand(*lead, n) < 0.4).astype(np.float32)
    beta = (0.5 * rs.standard_normal(lead + (c, d))).astype(np.float32)
    off = rs.standard_normal(lead + (c, n)).astype(np.float32)
    return xT, y, beta, off


def _reference(beta, xT, y, off, link):
    """The reference's kernel, vmapped over a leading shard axis."""
    def call(b, x, yy, o):
        return ref._batched_call(b, x, yy, o, lane_tile=None, interpret=None, link=link)

    args = [jnp.asarray(a) for a in (beta, xT, y)]
    o = None if off is None else jnp.asarray(off)
    if beta.ndim == 2:
        return call(*args, o)
    if o is None:
        return jax.vmap(lambda b, x, yy: call(b, x, yy, None))(*args)
    return jax.vmap(call)(*args, o)


@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("chains", [1, 8, 9, 16, 17, 33])
def test_plain_b2_at_chunk_edges_matches_reference(chains, shards, with_offsets, link):
    d = {1: 7, 8: 16, 9: 9, 16: 17, 17: 32, 33: 8}[chains]
    xT, y, beta, off = _inputs(shards, chains, d, 701, seed=chains + shards)
    off = off if with_offsets else None
    want = _reference(beta, xT, y, off, link)
    t = torch.as_tensor
    got = port.logistic_batched(t(beta), t(xT), t(y), None if off is None else t(off), link)
    assert len(got) == len(want) == (3 if with_offsets else 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("name", sorted(b2_chunk_probe.VARIANTS))
def test_probe_variants_edit_this_source(name):
    """b2_chunk_probe's variant trees (what PERF.md's removal probes
    timed) are edits of this checkout's kernel source, each applying once."""
    cu, py = b2_chunk_probe.variant_sources(name)
    pkg = b2_chunk_probe.REPO / "stark_tpu_torch"
    assert cu != (pkg / "csrc" / "logistic_batched.cu").read_text()
    assert (py != (pkg / "ops" / "logistic_fused.py").read_text()) == (name == "blocks4")
