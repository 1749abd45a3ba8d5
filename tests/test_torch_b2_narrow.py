"""Kernel B2 on narrow X (STARK_FUSED_X_DTYPE=bf16|int8|fp8) past its
narrow chunks, on the CPU.

The kernel runs only on the card (tests/test_torch_gpu_kernels.py).  Here
the arithmetic and the bookkeeping around it:

- the tensor-core pass at highest on narrow X (b2_mma by split3:
  csrc/logistic_batched.cu), emulated in numpy (x times each of beta's
  and resid's three bf16 pieces exact in float32, a k-step of 16 at a
  time), against the JAX reference's `_batched_call` at highest in
  interpret mode, with and without offsets;
- `logistic_fused.b2_x_route`, the mirror of csrc/logistic_batched.cu:
  route, against its table, the header's slot and layout sizes, the
  widths that keep the plain loads and those that keep three blocks an
  SM, and no width refused that B2 took before;
- the windows each warp copies for its rows (copy_windows_of, through
  `x_windows`, the mirror of x_window_copy) and the widening of
  x_window_widen4, for every shard of a launch;
- chip_smoke's --compare-with keys of B2 on narrow X and the bound of the
  split3 route.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke as cs
from stark_tpu.ops import logistic_fused as ref
from stark_tpu_torch.ops import logistic_fused as lf

from test_torch_b1_narrow import (GRAD_ATOL, GRAD_RTOL, VAL_RTOL, _emulated_dot, _funnel_r,
                                  split3)

_NARROW_NP = {"bf16": ml_dtypes.bfloat16, "int8": np.int8,
              "fp8e4m3": ml_dtypes.float8_e4m3fn, "fp8e5m2": ml_dtypes.float8_e5m2}


def _emulated_gradient(resid, x):
    """sum_n resid[c, n] x[d, n] as b2_mma computes it at highest: resid
    (C, N) split in three, x (D, N) exact in bf16; per k-step of 16 rows
    the three pieces' products summed (exact here, then rounded to
    float32) and added to a float32 sum.  -> (C, D) float32."""
    pieces = split3(resid)
    acc = np.zeros((resid.shape[0], x.shape[0]), np.float32)
    for k0 in range(0, x.shape[1], 16):
        xs = x[:, k0:k0 + 16].astype(np.float64).T
        step = sum(p[:, k0:k0 + 16].astype(np.float64) @ xs for p in pieces)
        acc = (acc.astype(np.float64) + step.astype(np.float32)).astype(np.float32)
    return acc


def emulate_b2_split3(beta, x, y, offsets):
    """B2 (bernoulli) at highest on narrow X by b2_mma's split3
    arithmetic, numpy: logits = x . beta by B1's `_emulated_dot` (beta in
    three pieces, a k-step of 16 features at a time) plus the offsets in
    float32; the accurate link in float32; gbeta by `_emulated_gradient`
    over the rows; resid whole."""
    logits = _emulated_dot(x, beta)
    if offsets is not None:
        logits = logits + offsets
    lt, yt = torch.as_tensor(logits), torch.as_tensor(y)
    val = (yt * torch.nn.functional.logsigmoid(lt)
           + (1 - yt) * torch.nn.functional.logsigmoid(-lt)).sum(-1).numpy()
    resid = (yt - torch.sigmoid(lt)).numpy().astype(np.float32)
    return val, _emulated_gradient(resid, x), resid


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("xdt", list(_NARROW_NP))
@pytest.mark.parametrize("n,d,chains", [(3001, 7, 20), (2049, 33, 33)])
def test_split3_arithmetic_holds_highest_against_the_reference(n, d, chains, xdt, with_offsets,
                                                                monkeypatch):
    """b2_mma's split3 route emulated on narrow X with beta of full
    float32 significands stays within highest's tolerances of the
    reference's batched kernel at highest (interpret mode), on the same
    narrow slab (int8's scale folded into beta, as a model folds it), and
    of the same function in float64.  The reference sums in float32 too:
    its gradient is held to the emulation's within highest's tolerances
    plus the reference's own distance from float64 (on int8's values,
    up to 127, it stood 4.5e-4 past highest's tolerance from float64 at
    N = 2049, D = 33, where the emulation stayed 5.2e-4 inside it)."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", "highest")
    rs = np.random.RandomState(n + d + with_offsets)
    x = rs.standard_normal((d, n)).astype(np.float32)
    y = (rs.rand(n) < 0.4).astype(np.float32)
    if xdt == "int8":
        xT = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        fold = 1.0 / 40
    else:
        xT = x.astype(_NARROW_NP[xdt])
        fold = 1.0
    wide = xT.astype(np.float32)
    beta = (0.3 * fold * rs.standard_normal((chains, d))).astype(np.float32)
    beta[0, 0] = np.float32(2.0 ** -120 * 1.2345678)  # pieces in bf16's subnormal range
    off = rs.standard_normal((chains, n)).astype(np.float32) if with_offsets else None
    want = ref._batched_call(jnp.asarray(beta), jnp.asarray(xT), jnp.asarray(y),
                             None if off is None else jnp.asarray(off), lane_tile=None,
                             interpret=None)
    val, gbeta, resid = emulate_b2_split3(beta, wide, y, off)
    np.testing.assert_allclose(val, np.asarray(want[0]), rtol=VAL_RTOL, atol=0)
    if with_offsets:
        np.testing.assert_allclose(resid, np.asarray(want[2]), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # float64: the same function exactly
    logits = beta.astype(np.float64) @ wide.astype(np.float64)
    if off is not None:
        logits = logits + off
    r64 = y - 1.0 / (1.0 + np.exp(-logits))
    g64 = r64 @ wide.T.astype(np.float64)
    bound = GRAD_ATOL + GRAD_RTOL * np.abs(g64)
    assert np.all(np.abs(gbeta - g64) <= bound)
    ref_err = np.abs(np.asarray(want[1], np.float64) - g64)
    assert np.all(np.abs(gbeta - np.asarray(want[1])) <= GRAD_ATOL
                  + GRAD_RTOL * np.abs(np.asarray(want[1])) + ref_err)
    # the emulation is no copy of the float32 dot: the pieces are in play
    assert np.any(split3(beta)[2] != 0) and np.any(split3(resid)[2] != 0)


# ---- the launcher's route (csrc/logistic_batched.cu:route) ----

#: (C, D, precision, X dtype) -> (pass, chains, narrow X through the
#: packed slots, n-tiles compiled in, bytes of shared memory), worked out
#: from csrc/logistic_batched.cu:layout_with by hand: at C=32, D=32 two x
#: buffers of 32 x 132 words, y 2 x 128, resid 2 x 32 x 132, beta 32 x 32,
#: values 64: 18,240 words; with the slots one x buffer less (4,224) and
#: two slots of 32 x 4 x 5 x 4 words (bf16) or 32 x 4 x 3 x 4 (one byte);
#: at C=20 beta takes 32 x 20 + 12 words; at C=33 (two chunks) beta 32 x
#: 36 + 28, values 128, gradient sums 1,056; at D=52 one buffer of 52
#: rows, beta and gradient sums 1,664 each
ROUTES = {
    (32, 32, "highest", "f32"): ("b2_pass", 32, False, 0, 4 * 18_240),
    (32, 32, "high", "f32"): ("b2_mma", 32, False, 4, 4 * 18_240),
    (32, 32, "highest", "bf16"): ("b2_mma", 32, True, 0, 4 * (18_240 - 4224 + 5120)),
    (32, 32, "highest", "int8"): ("b2_mma", 32, True, 0, 4 * (18_240 - 4224 + 3072)),
    (32, 32, "high", "bf16"): ("b2_mma", 32, True, 4, 4 * 19_136),
    (32, 32, "default", "fp8e5m2"): ("b2_mma", 32, True, 4, 4 * 17_088),
    (20, 32, "highest", "bf16"): ("b2_mma", 24, True, 0, 4 * (17_868 - 4224 + 5120)),
    (33, 32, "high", "bf16"): ("b2_mma", 40, True, 0, 4 * (19_516 - 4224 + 5120)),
    (32, 52, "highest", "bf16"): ("b2_mma", 32, False, 0, 4 * 14_608),
    (8, 32, "highest", "bf16"): ("b2_chunk", 8, False, 0, 4 * 11_104),
    (16, 33, "default", "int8"): ("b2_mma", 16, True, 0, None),
}


@pytest.mark.parametrize("key", list(ROUTES))
def test_b2_x_route_is_its_table(key):
    got, want = lf.b2_x_route(*key), ROUTES[key]
    assert got[:4] == want[:4]
    if want[4] is not None:
        assert got[4] == want[4]
    # b2_route keeps its 2-tuple
    assert lf.b2_route(*key) == want[:2]


@pytest.mark.parametrize("xdt", ["bf16", "int8", "fp8e4m3"])
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
def test_a_slab_off_alignment_keeps_the_plain_loads(prec, xdt):
    """The route of a slab whose base is off 16-byte alignment: no slots,
    n-tiles read from C, float32's layout."""
    for c, d in ((32, 32), (20, 32), (33, 40), (100, 7)):
        got = lf.b2_x_route(c, d, prec, xdt, aligned=False)
        assert got[2:4] == (False, 0)
        assert got[4] == lf.b2_x_route(c, d, "high", "f32")[4]


def _parent_bytes(c, d):
    """B2's shared memory on narrow X before the packed slots (float32's
    layout: b2_pass's at highest, b2_mma's at high and default; b2_chunk's
    at its shapes)."""
    return lf.b2_x_route(c, d, "high", "f32")[4]


@pytest.mark.parametrize("xdt", ["bf16", "int8", "fp8e5m2"])
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("chains", [1, 8, 16, 17, 24, 25, 32, 33, 64, 65, 100, 128])
def test_no_width_that_b2_took_is_refused(chains, prec, xdt):
    """Every D that fitted the card's 227 KB a block before still fits;
    the slots are taken only where they keep the layout's two-buffer tier
    (113 KB), and otherwise the layout is float32's."""
    for d in range(1, 400):
        before = _parent_bytes(chains, d)
        route = lf.b2_x_route(chains, d, prec, xdt)
        if before <= 227 * 1024:
            assert route[4] <= 227 * 1024, (chains, d)
        if route[2]:
            assert route[4] <= 113 * 1024, (chains, d)
        else:
            assert route[4] == before, (chains, d)


def test_slot_and_layout_sizes_are_the_headers():
    """csrc/logistic_batched.cu:xslot_words and layout_x's comment: 2,560
    and 1,536 words a slot at D = 32; 19,136 and 17,088 words a block at
    C = 32, D = 32 against float32's 18,240; bf16's keeps three blocks an
    SM (3 x (76,544 + 1,024) of 233,472 bytes)."""
    assert lf.b2_xslot_words(32, "bf16") == 2560 and lf.b2_xslot_words(32, "int8") == 1536
    assert lf.x_window_chunks(lf.B2_WARP_ROWS, 2) == 5
    assert lf.x_window_chunks(lf.B2_WARP_ROWS, 1) == 3
    assert lf.b2_layout_words(32, 32, 2, False) == 18_240
    assert lf.b2_layout_words(32, 32, 2, False, lf.b2_xslot_words(32, "bf16")) == 19_136
    assert lf.b2_layout_words(32, 32, 2, False, lf.b2_xslot_words(32, "fp8e4m3")) == 17_088
    assert 3 * (76_544 + 1024) <= 233_472 < 3 * (76_544 + 1024) + 1024


def _plain_widths(c, xdt):
    """The D (to 400) at which b2_mma takes C=c chains on narrow X with
    plain loads, as ranges."""
    out = []
    for d in range(1, 400):
        r = lf.b2_x_route(c, d, "high", xdt)
        if r[0] == "b2_mma" and r[4] <= 227 * 1024 and not r[2]:
            if out and out[-1][1] == d - 1:
                out[-1][1] = d
            else:
                out.append([d, d])
    return [tuple(r) for r in out]


def test_widths_that_keep_the_plain_loads_are_the_headers():
    """layout_x's comment: the widths whose layout has one buffer (C=17:
    D >= 65; C=25: D >= 62; C=32: D >= 52; C=33: D >= 46; C=64: D >= 33)
    and, on bf16, the two-buffer widths whose slots leave the tier (C=17:
    60-64; C=25: 55-61)."""
    assert _plain_widths(17, "bf16") == [(60, 353)]
    assert _plain_widths(17, "int8") == [(65, 353)]
    assert _plain_widths(25, "bf16") == [(55, 335)]
    assert _plain_widths(25, "int8") == [(62, 335)]
    assert _plain_widths(32, "bf16") == _plain_widths(32, "int8") == [(52, 327)]
    assert _plain_widths(33, "bf16") == [(46, 319)]
    assert _plain_widths(64, "fp8e4m3") == [(33, 273)]


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("xdt", ["bf16", "int8"])
def test_three_blocks_an_sm_at_the_flagships_width(xdt, prec):
    """At C = 25..32, D <= 32 (one tile) every narrow layout keeps three
    blocks an SM, as float32's does; its 4 n-tiles are compiled in at
    high and default, read from C at highest."""
    for c in range(25, 33):
        for d in range(1, 33):
            r = lf.b2_x_route(c, d, prec, xdt)
            assert r[0] == "b2_mma" and r[2] and r[3] == (0 if prec == "highest" else 4)
            assert 3 * (r[4] + 1024) <= 233_472, (c, d)


def test_b2_x_route_refuses_unknown_names():
    with pytest.raises(ValueError, match="dot precision"):
        lf.b2_x_route(32, 32, "bf16")
    with pytest.raises(ValueError, match="X dtype"):
        lf.b2_x_route(32, 32, "high", "float16")


# ---- the windows each warp copies for its rows, and their widening ----


def _widen_segment(slot, head, size, nv, rows=lf.B2_WARP_ROWS):
    """x_window_widen4 for the 8 lanes of a feature row: the segment's
    element bits r = 0 .. rows - 1 as the kernel cuts them out of the
    slot's words (None from nv on, where it writes zeros)."""
    words = np.frombuffer(slot.tobytes(), np.uint32).astype(np.int64)
    out = []
    for r in range(0, rows, 4):
        b = head + r * size
        q, s = b >> 2, (b & 3) * 8
        if size == 2:
            lo = _funnel_r(words[q], words[q + 1], s)
            hi = _funnel_r(words[q + 1], words[q + 2], s)
            e = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
        else:
            v = _funnel_r(words[q], words[q + 1], s)
            e = [(v >> (8 * i)) & 0xFF for i in range(4)]
        out += [int(e[i]) if r + i < nv else None for i in range(4)]
    return out


@pytest.mark.parametrize("size", [1, 2])
@pytest.mark.parametrize("nmod", range(16))
def test_windows_cover_every_row_of_every_shard_and_stay_inside_the_slab(nmod, size):
    """For S = 1..8 shards of N = 0 .. 15 (mod 16) rows (below one
    sub-tile and past it), at the first and the last sub-tile, each warp's
    windows of each feature row of each shard hold its valid elements,
    start 16-byte aligned, read nothing outside the launch's slab and fit
    the warp's kNch windows of the slot; the head is the kernel's
    ((s D + d) N size) mod 16 and steps by 4 N size mod 16 from row d to
    d + 4 (widen_rows_of); the widening recovers every valid element."""
    rs = np.random.RandomState(nmod + 16 * size)
    rows, wr = lf.B2_ROW_TILE, lf.B2_WARP_ROWS
    nch = lf.x_window_chunks(wr, size)
    for shards in range(1, 9):
        n, d_rows = (nmod + 1, 48 + nmod, 300 + nmod)[shards % 3], 5
        slab = rs.randint(0, 256, size=shards * d_rows * n * size, dtype=np.int64).astype(np.uint8)
        step = (4 * n * size) & 15
        for s in range(shards):
            for row0 in sorted({0, (n - 1) // rows * rows}):
                nvalid = min(rows, n - row0)
                for warp in range(rows // wr):
                    nv = min(wr, nvalid - wr * warp)
                    head0 = ((s * d_rows + 0) * n * size) & 15
                    for f in range(d_rows):
                        head = ((s * d_rows + f) * n * size) & 15
                        if f >= 4:
                            assert head == (((s * d_rows + f - 4) * n * size & 15) + step) & 15
                        if nv <= 0:
                            continue
                        off = (s * d_rows + f) * n + row0 + wr * warp
                        wins, h = lf.x_windows(off, nv, size, slab.size)
                        assert h == head and (head0 + f * n * size) % 16 == head
                        assert 1 <= len(wins) <= nch
                        seg = np.full(16 * nch, 0xAB, np.uint8)  # never copied: garbage
                        for j, src, nbytes in wins:
                            assert src % 16 == 0 and 0 <= src and src + nbytes <= slab.size
                            assert 1 <= nbytes <= 16
                            seg[16 * j:16 * j + 16] = 0
                            seg[16 * j:16 * j + nbytes] = slab[src:src + nbytes]
                        got = _widen_segment(seg, head, size, nv)
                        row = slab[off * size:(off + nv) * size]
                        want = (row.view(np.uint16) if size == 2 else row).astype(int).tolist()
                        assert got[:nv] == want and got[nv:] == [None] * (wr - nv)


# ---- chip_smoke's --compare-with keys and the bound of the split3 route ----


def test_compare_with_times_b2_on_narrow_x():
    keys = cs.B2_X_KEYS
    assert len(keys) == 9 and len(set(cs.SHARED_KERNELS)) == len(cs.SHARED_KERNELS)
    assert not set(keys) & set(cs.B2_NARROW_KEYS)  # the narrow chunks' keys are apart
    for prec in ("highest", "high", "default"):
        for xdt in ("bf16", "int8"):
            assert cs.b2_x_key(prec, xdt) in cs.SHARED_KERNELS
        assert cs.b2_x_key(prec, "bf16", False) in cs.SHARED_KERNELS
    assert cs.b2_x_key("high", "int8") == "B2 high int8 offsets=True"
    assert cs.b2_x_key("highest", "bf16", False) == "B2 bf16 offsets=False"
    # every key it had before stays
    for key in ("B1", "B2 offsets=True", *cs.B2_MMA_KEYS, *cs.B2_NARROW_KEYS,
                *cs.B1_NARROW_KEYS, "B3 offsets=False", "B4"):
        assert key in cs.SHARED_KERNELS


@pytest.mark.parametrize("key", cs.B2_X_KEYS)
def test_b2_narrow_keys_are_expected_bitwise_but_at_highest(key):
    """Highest on narrow X now runs on the tensor cores (split3), in
    another order of sums than the parent's b2_pass; high and default
    only move their bytes otherwise, so they are expected bitwise equal."""
    assert cs.b2_split3_route()
    want = cs.expected_against_parent(key)
    if key.startswith(("B2 high", "B2 default")):
        assert want == "yes"
    else:
        assert want.startswith("no")


def test_b2_split3_route_is_taken_past_the_chunks_only():
    assert cs.b2_split3_route(32, 32, "int8") and cs.b2_split3_route(33, 100, "fp8e5m2")
    assert not cs.b2_split3_route(8, 32, "bf16")  # b2_chunk
    assert not cs.b2_split3_route(32, 32, "f32")  # b2_pass


@pytest.mark.parametrize("with_offsets,xdt,term,ms", [
    (True, "bf16", "bytes", 0.0967), (True, "int8", "bytes", 0.0872),
    (False, "bf16", "special functions", 0.0230), (False, "int8", "special functions", 0.0230)])
def test_split3_bound_at_the_offset_paths_shape(with_offsets, xdt, term, ms):
    """The split3 route's bound at C=32, D=32, N=1M (bernoulli): three
    passes of 4.1 GFLOP on the bf16 tensor cores (0.0124 ms) under the
    link's 96M special-function instructions (0.0230 ms); with offsets
    the bytes bind (X at its width, the offsets read and resid written)."""
    c, d, n = 32, 32, 1_000_000
    nbytes = (cs.X_ITEMSIZE[xdt] * d * n
              + 4 * (n + 2 * c * d + c + (2 * c * n if with_offsets else 0)))
    e = cs.bound(nbytes, 2 * 2 * c * d * n * cs.SPLIT3_PASSES, cs.BF16_FLOP_PER_S,
                 sfu=cs.LINK_SFU * c * n, sfu_per_s=cs.H100_SFU_PER_S)
    assert e["term"] == term and e["bound_ms"] == pytest.approx(ms, abs=1e-4)
    assert 1e3 * e["flops"] / cs.BF16_FLOP_PER_S == pytest.approx(0.0124, abs=1e-4)
