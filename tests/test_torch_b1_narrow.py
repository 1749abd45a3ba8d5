"""Kernel B1 on narrow X (STARK_FUSED_X_DTYPE=bf16|int8|fp8), on the CPU.

The kernel runs only on the card (tests/test_torch_gpu_kernels.py).  Here
the arithmetic and the bookkeeping around it:

- `split3`, the three bf16 pieces into which B1's tensor-core pass at
  highest on narrow X cuts beta and resid (csrc/fused_pass.cuh:split3),
  mirrored in numpy: exact over float32 values, every piece a bf16 value;
- that pass's arithmetic emulated in numpy (x times each piece exact in
  float32, a k-step of 16 at a time added to a float32 sum) on narrow X,
  against the JAX reference's `_grouped_call` at highest in interpret mode;
- `hier_fused.b1_route`, the mirror of csrc/hier_grouped.cu:route, against
  its table, and no width refused that B1 took before;
- `hier_fused.x_windows`, the mirror of x_window_copy, with the widening of
  x_window_widen4 replayed byte for byte;
- chip_smoke's --compare-with keys of B1 on narrow X.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke as cs
from stark_tpu.ops import hier_fused as rhf
from stark_tpu_torch.ops import hier_fused as phf

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
TINY = 2.0 ** -133  # bf16's least subnormal
MASK = np.uint32(0xFFFF0000)


def split3(a):
    """csrc/fused_pass.cuh:split3 in numpy: float32 ``a`` -> (p0, p1, p2),
    each the rest so far cut to bf16 toward zero."""
    a = np.asarray(a, np.float32)
    p0 = (a.view(np.uint32) & MASK).view(np.float32)
    r1 = a - p0
    p1 = (r1.view(np.uint32) & MASK).view(np.float32)
    p2 = ((r1 - p1).view(np.uint32) & MASK).view(np.float32)
    return p0, p1, p2


def _split_values():
    rs = np.random.RandomState(3)
    normal = rs.randint(0x00800000, 0x7F800000, size=20_000, dtype=np.int64).astype(np.uint32)
    sub = rs.randint(1, 0x00800000, size=2000, dtype=np.int64).astype(np.uint32)
    vals = np.concatenate([normal, sub]).view(np.float32)
    edges = np.array([0.0, -0.0, np.finfo(np.float32).max, -np.finfo(np.float32).max,
                      np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                      np.float32(2.0 ** -126 * 1.9999999), np.float32(2.0 ** -110 * 1.2345678),
                      np.float32(2.0 ** -111 * 1.2345678), np.float32(2.0 ** 127 * 1.99),
                      np.nextafter(np.float32(1), np.float32(2)), np.float32(1 / 3)],
                     np.float32)
    signs = np.where(rs.rand(vals.size) < 0.5, -1, 1).astype(np.float32)
    return np.concatenate([vals * signs, edges])


def test_split3_is_exact_and_every_piece_is_bf16():
    a = _split_values()
    p0, p1, p2 = split3(a)
    for p in (p0, p1, p2):
        assert np.all(p.view(np.uint32) & np.uint32(0xFFFF) == 0)  # a bf16 value
        assert np.all(np.isfinite(p))
        assert np.array_equal(torch.as_tensor(p).bfloat16().float().numpy(), p)
    total = p0.astype(np.float64) + p1.astype(np.float64) + p2.astype(np.float64)
    exact = np.floor(a.astype(np.float64) / TINY) == a.astype(np.float64) / TINY
    assert np.array_equal(total[exact], a[exact].astype(np.float64))
    # every normal of magnitude >= 2^-110 is a multiple of 2^-133, the
    # largest float32 too (cut toward zero, no piece overflows)
    assert np.all(exact[np.abs(a) >= 2.0 ** -110])
    assert exact[a == np.finfo(np.float32).max].all()
    # the rest lose only their bits under 2^-133
    assert np.all(np.abs(total - a.astype(np.float64)) < TINY)
    assert (~exact).sum() > 1000  # the subnormal range is covered


def test_split3_to_nearest_would_overflow_at_the_top():
    """Why the pieces are cut toward zero: bf16(a) to nearest of the
    largest float32 is infinite."""
    top = np.array([np.finfo(np.float32).max], np.float32)
    assert np.isinf(torch.as_tensor(top).bfloat16().float().numpy()).all()
    assert np.isfinite(split3(top)[0]).all()


def _emulated_dot(x, b):
    """sum_k x[k] b[k] as route (b) computes it: x (K, N) exact in bf16, b
    (M, K) float32 split in three; per k-step of 16, x times each piece
    (exact) summed exactly and added to a float32 sum, pieces in order.
    -> (M, N) float32."""
    pieces = split3(b)
    acc = np.zeros((b.shape[0], x.shape[1]), np.float32)
    for k0 in range(0, x.shape[0], 16):
        xs = x[k0:k0 + 16].astype(np.float64)
        for p in pieces:
            step = p[:, k0:k0 + 16].astype(np.float64) @ xs
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def emulate_b1_split3(beta, alpha, x, y, g):
    """B1 at highest on narrow X by route (b)'s arithmetic, numpy: logits
    = x . beta by `_emulated_dot` plus alpha in float32; the accurate link
    in float32; gbeta = resid . x^T the same way over rows (resid split in
    three); galpha the float32 segment sums of resid whole."""
    logits = _emulated_dot(x, beta) + alpha[:, g]
    lt = torch.as_tensor(logits)
    yt = torch.as_tensor(y)
    val = (yt * torch.nn.functional.logsigmoid(lt)
           + (1 - yt) * torch.nn.functional.logsigmoid(-lt)).sum(-1).numpy()
    resid = (yt - torch.sigmoid(lt)).numpy().astype(np.float32)
    gbeta = _emulated_dot(x.T.copy(), resid)
    galpha = np.zeros_like(alpha)
    np.add.at(galpha.T, g, resid.T)
    return val, gbeta, galpha


_NARROW_NP = {"bf16": ml_dtypes.bfloat16, "int8": np.int8,
              "fp8e4m3": ml_dtypes.float8_e4m3fn, "fp8e5m2": ml_dtypes.float8_e5m2}


@pytest.mark.parametrize("xdt", list(_NARROW_NP))
@pytest.mark.parametrize("n,d,groups,chains", [(3001, 7, 20, 5), (2049, 33, 12, 9)])
def test_split3_arithmetic_holds_highest_against_the_reference(n, d, groups, chains, xdt,
                                                                 monkeypatch):
    """Route (b) emulated on narrow X with beta and alpha of full float32
    significands stays within highest's tolerances of the reference's
    grouped kernel at highest (interpret mode), on the same narrow slab
    (int8's scale folded into beta, as a model folds it)."""
    monkeypatch.setenv("STARK_FUSED_PRECISION", "highest")
    rs = np.random.RandomState(n + d)
    x = rs.standard_normal((n, d)).astype(np.float32)
    g = np.sort(rs.randint(0, groups, size=n)).astype(np.int32)
    y = (rs.rand(n) < 0.4).astype(np.float32)
    lane_tile, k_loc, first_gid, gl = phf.grouped_layout(g, d)
    if xdt == "int8":
        q = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        fold = 1.0 / 40
    else:
        q = x.astype(_NARROW_NP[xdt])
        fold = 1.0
    xT = np.ascontiguousarray(q.T)
    wide = xT.astype(np.float32)
    beta = (0.3 * fold * rs.standard_normal((chains, d))).astype(np.float32)
    beta[0, 0] = np.float32(2.0 ** -120 * 1.2345678)  # pieces in bf16's subnormal range
    alpha = rs.standard_normal((chains, groups)).astype(np.float32)
    want = rhf._grouped_call(jnp.asarray(beta), jnp.asarray(alpha), jnp.asarray(xT),
                             jnp.asarray(y), jnp.asarray(gl), jnp.asarray(first_gid),
                             k_loc=k_loc, lane_tile=lane_tile, interpret=None)
    val, gbeta, galpha = emulate_b1_split3(beta, alpha, wide, y, g)
    np.testing.assert_allclose(val, np.asarray(want[0]), rtol=VAL_RTOL, atol=0)
    np.testing.assert_allclose(gbeta, np.asarray(want[1]), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(galpha, np.asarray(want[2]), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the emulation is no copy of the float32 dot: the pieces are in play
    assert np.any(split3(beta)[2] != 0) and np.any(split3(beta)[1] != 0)


# ---- the launcher's route (csrc/hier_grouped.cu:route) ----

#: (C, D, precision, X dtype) -> (pass, one tile, n-tiles compiled in,
#: narrow X through the slot, bytes of shared memory), worked out from
#: csrc/hier_grouped.cu:layout_with by hand: 19,912 words at the flagship
#: at highest on float32 X (beta's rows take 1,736 fewer at C=8, 868 at C=33;
#: at C=8 highest on float32 X runs hier_chunk, layout_chunk's 16,456); hier_mma
#: adds beta's fragments, 2048 words at high and default and 3072 at
#: highest, and 256 of segment partials; the slot is 32 x 17 x 4 words for
#: bf16 and 32 x 9 x 4 for one byte
ROUTES = {
    (64, 32, "highest", "f32"): ("hier_pass", True, 0, False, 4 * 19_912),
    (64, 32, "high", "f32"): ("hier_mma", True, 0, False, 4 * 22_216),
    (64, 32, "default", "f32"): ("hier_mma", True, 8, False, 4 * 22_216),
    (8, 32, "high", "f32"): ("hier_mma", True, 1, False, 4 * (22_216 - 1736)),
    (8, 32, "highest", "f32"): ("hier_chunk", True, 1, False, 4 * 16_456),
    (64, 32, "highest", "bf16"): ("hier_mma", True, 8, True, 4 * (23_240 + 2176)),
    (64, 32, "highest", "int8"): ("hier_mma", True, 8, True, 4 * (23_240 + 1152)),
    (64, 32, "high", "bf16"): ("hier_mma", True, 8, True, 4 * (22_216 + 2176)),
    (64, 32, "default", "fp8e5m2"): ("hier_mma", True, 8, True, 4 * (22_216 + 1152)),
    (8, 32, "highest", "bf16"): ("hier_mma", True, 1, True, 4 * (23_240 - 1736 + 2176)),
    (33, 32, "high", "bf16"): ("hier_mma", True, 8, True, 4 * (22_216 - 868 + 2176)),
    (8, 33, "high", "bf16"): ("hier_mma", False, 0, False, None),
    (64, 33, "highest", "bf16"): ("hier_mma", False, 0, True, None),
}


@pytest.mark.parametrize("key", list(ROUTES))
def test_b1_route_is_its_table(key):
    got, want = phf.b1_route(*key), ROUTES[key]
    assert got[:4] == want[:4]
    if want[4] is not None:
        assert got[4] == want[4]


def _old_bytes(c, d, prec):
    """B1's shared memory on narrow X before the packed slot and highest's
    tensor-core pass: hier_pass's layout at highest, hier_mma's (4-word
    fragments) at high and default."""
    return 4 * phf.b1_layout(c, d, "high", prec != "highest")[1]


@pytest.mark.parametrize("xdt", ["bf16", "int8", "fp8e4m3"])
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("chains", [1, 8, 9, 33, 64, 65, 100, 128, 129, 192, 256])
def test_no_width_that_b1_took_is_refused(chains, prec, xdt):
    """Every D that fitted the card's 227 KB a block before still fits,
    narrow X's slot taken only where it fits the block's tier."""
    limit = 227 * 1024
    for d in range(1, 400):
        before = _old_bytes(chains, d, prec)
        route = phf.b1_route(chains, d, prec, xdt)
        if before <= limit:
            assert route[4] <= limit, (chains, d)
        if not route[3]:  # no slot: the layout is the one before, bar highest's fragments
            extra = 4 * 1024 if prec == "highest" and route[1] else 0
            assert route[4] == before + extra, (chains, d)


def test_slot_widths_are_the_headers():
    """csrc/hier_grouped.cu:xslot_at's comment names the widths that keep
    plain loads at C = 64, 8 and 33."""
    def plain(c, xdt):
        return [d for d in range(1, 400)
                if phf.b1_route(c, d, "high", xdt)[4] <= 227 * 1024
                and not phf.b1_route(c, d, "high", xdt)[3]]
    assert plain(64, "bf16") == list(range(150, 250))
    assert plain(64, "int8") == [*range(166, 189), *range(212, 250)]
    assert plain(8, "bf16") == [*range(33, 65), *range(227, 350)]
    assert plain(8, "int8") == [*range(50, 65), *range(266, 350)]
    assert plain(33, "bf16") == [*range(33, 38), *range(182, 292)]
    assert plain(33, "int8") == [*range(33, 38), *range(207, 292)]


def test_b1_route_refuses_unknown_names():
    with pytest.raises(ValueError, match="dot precision"):
        phf.b1_route(64, 32, "bf16")
    with pytest.raises(ValueError, match="X dtype"):
        phf.b1_route(64, 32, "high", "float16")


# ---- the windows of x_window_copy and the widening of x_window_widen4 ----


def _funnel_r(lo, hi, s):
    return ((hi << 32 | lo) >> s) & 0xFFFFFFFF


def _widen_row(slot, head, size, nvalid, rows=128):
    """x_window_widen4 for every lane: the row's element bits r = 0 ..
    rows - 1 as the kernel cuts them out of the slot's words (None from
    nvalid on, where the kernel writes zeros)."""
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
        out += [int(e[i]) if r + i < nvalid else None for i in range(4)]
    return out


@pytest.mark.parametrize("size", [1, 2])
@pytest.mark.parametrize("nmod", range(16))
def test_windows_cover_every_row_and_stay_inside_the_slab(nmod, size):
    """For N = 0 .. 15 (mod 16), N below one sub-tile and at the last
    sub-tile (the last block's), each feature row's windows hold its
    valid elements, read nothing outside the slab, fit the slot, and the
    widening recovers every valid element from them."""
    rs = np.random.RandomState(nmod + 16 * size)
    rows, nch = phf.B1_ROW_TILE, phf.x_window_chunks(phf.B1_ROW_TILE, size)
    assert nch == (17 if size == 2 else 9)
    for n in (nmod + 1, 48 + nmod, 1000 + nmod, 4096 + nmod):
        d = 5
        slab = rs.randint(0, 256, size=d * n * size, dtype=np.int64).astype(np.uint8)
        for row0 in sorted({0, (n - 1) // rows * rows, rows if n > rows else 0}):
            nvalid = min(rows, n - row0)
            for f in range(d):
                off = f * n + row0
                wins, head = phf.x_windows(off, nvalid, size, slab.size)
                assert 0 <= head < 16 and (off * size - head) % 16 == 0
                assert len(wins) <= nch and [w[0] for w in wins] == list(range(len(wins)))
                slot = np.full(16 * nch, 0xAB, np.uint8)  # never copied: garbage
                for j, src, nbytes in wins:
                    assert 0 <= src and src + nbytes <= slab.size and 1 <= nbytes <= 16
                    assert src % 16 == 0
                    slot[16 * j:16 * j + 16] = 0
                    slot[16 * j:16 * j + nbytes] = slab[src:src + nbytes]
                # the windows hold [head, head + nvalid * size) of the slot
                assert 16 * len(wins) >= head + nvalid * size
                got = _widen_row(slot, head, size, nvalid)
                row = slab[off * size:(off + nvalid) * size]
                want = (row.view(np.uint16) if size == 2 else row).astype(int).tolist()
                assert got[:nvalid] == want and got[nvalid:] == [None] * (rows - nvalid)


# ---- chip_smoke's --compare-with keys ----


def test_compare_with_times_b1_on_narrow_x():
    keys = cs.B1_NARROW_KEYS
    assert len(keys) == 9 and len(set(cs.SHARED_KERNELS)) == len(cs.SHARED_KERNELS)
    for xdt in ("bf16", "int8"):
        for prec in ("highest", "high", "default"):
            assert cs.b1_narrow_key(prec, xdt) in cs.SHARED_KERNELS
    for prec in ("highest", "high", "default"):
        assert cs.b1_narrow_key(prec, "bf16", cs.NUTS_CHAINS) in cs.SHARED_KERNELS
    assert cs.b1_narrow_key("high", "int8") == "B1 high int8"
    assert cs.b1_narrow_key("highest", "bf16", 8) == "B1 bf16 C=8"
    # every key it had before stays
    for key in ("B1", "B1 high", "B1 high C=8", "B1 default", "B1 default C=8",
                *cs.B2_MMA_KEYS, *cs.B2_NARROW_KEYS, "B3 offsets=False", "B3 offsets=True",
                "B4"):
        assert key in cs.SHARED_KERNELS


@pytest.mark.parametrize("key", cs.B1_NARROW_KEYS)
def test_b1_narrow_keys_are_expected_bitwise_but_at_highest(key):
    """Highest on narrow X runs on the tensor cores (split3); the parent
    commit's B1 ran it there too, and this tree leaves B1 as it was, so
    every B1 key, highest's too, is expected bitwise equal to the
    parent's (only B2 at highest on narrow X moved: its keys are
    tests/test_torch_b2_narrow.py's)."""
    assert cs.b1_split3_route()
    assert cs.expected_against_parent(key) == "yes"
    for other in ("B1", "B1 high", "B1 default C=8", "B4"):
        assert cs.expected_against_parent(other) == "yes"


def test_b1_narrow_bound_on_the_tensor_cores_is_the_link_at_64_chains():
    """With highest on the tensor cores (3 passes of 8.19 GFLOP at 989
    TFLOP/s, 0.025 ms), the link's 0.0459 ms binds at C=64 and the bytes
    at C=8 on bf16 X."""
    n, d = 1_000_000, 32
    for c, term in ((64, "special functions"), (8, "bytes")):
        nbytes = 2 * d * n + 4 * (n + n + n // 8192 + 2 * c * 1000 + 2 * c * d + c)
        e = cs.bound(nbytes, 2 * 2 * c * d * n * cs.SPLIT3_PASSES, cs.BF16_FLOP_PER_S,
                     sfu=cs.LINK_SFU * c * n, sfu_per_s=cs.H100_SFU_PER_S)
        assert e["term"] == term, (c, e)
    assert 1e3 * 3 * 2 * 2 * 64 * d * n / cs.BF16_FLOP_PER_S == pytest.approx(0.0248, abs=1e-4)
