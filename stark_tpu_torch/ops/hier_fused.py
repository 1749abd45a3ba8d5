"""Grouped likelihood passes over group-sorted rows — counterpart of
``stark_tpu/ops/hier_fused.py``: kernels B1 (hierarchical logistic) and
B4 (linear mixed model) and their host-side layout.

Rows are sorted by group once, on the host (`prepare_grouped`), so each
stretch of rows spans few consecutive groups.  The layout is the JAX
package's, bit for bit: the same stable sort, the same ``lane_tile``,
``k_loc``, per-tile ``first_gid`` and per-row local ids ``gl``; the
absolute group of row n is ``first_gid[n // lane_tile] + gl[n]``.
``lane_tile`` and ``k_loc`` are plain ints in the prepared data.

`hier_grouped` evaluates, for C chains in one pass over X, the value
(C,), ∂/∂beta (C, D) and ∂/∂alpha (C, G) without ever forming a (C, N)
array: on a CUDA tensor it launches ``csrc/hier_grouped.cu``, on a CPU
tensor it runs `hier_grouped_plain`.  `hier_logistic_loglik` wraps it in
a ``torch.autograd.Function`` whose backward rescales those gradients.

`lmm_grouped` does the same for the Gaussian LMM with Q random effects
per group: mu = intercept + beta . x + sum_q z_q u[g, q], and one pass
yields the SSR, sum(resid), ∂/∂beta and ∂/∂u (C, G, Q), scale-free
(``csrc/lmm_grouped.cu``; plain version `lmm_grouped_plain`).
`lmm_grouped_loglik` applies sigma outside, as the reference does.

Each kernel splits the rows by its own function of N (`b1_blocks`,
`b4_blocks`) and refuses, before launching, widths whose block would not
fit the card's shared memory (`b1_shared_memory`, `b4_shared_memory`).
Both take their dots at STARK_FUSED_PRECISION, read at each call
(`ops.precision`: one instantiation of each kernel per precision, the
plain versions through `dot` and `dot_operand`); the widths each
admits are the same at every precision.  ``xT`` (and B4's ``zT``) may
be stored as float32, bf16, int8 or fp8 (STARK_FUSED_X_DTYPE,
`ops.quantize`): the kernels read the slab at that width and widen each
element to float32, the plain versions widen the slab; the slab's own
dtype picks what is streamed, and a packed slab's scales are folded into
beta (and u) by the model.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .. import _build
from .logistic_fused import (
    X_ITEMSIZE,
    _link_parts,
    _round4,
    check_kernel_args,
    normal_loglik_from_ssr,
    scratch_words,
    sigma_grad,
    subtile_split,
    x_code,
    x_window_chunks,
    x_windows,
)
from .precision import (
    PRECISIONS,
    X_CODES,
    X_DTYPE_NAMES,
    check_knobs,
    dot,
    dot_operand,
    per_chain,
)
from .quantize import store_slab, widen

# The reference's layout constants, kept so the port builds bit-identical
# layouts: the lane-tile cap, the per-slab element budget it was sized by,
# and the cap on the padded groups per tile.
_LANE_TILE = 8192
_SLAB_BUDGET_ELEMS = (2 * 1024 * 1024) // 4
_K_LOC_MAX = 128


def grouped_lane_tile(d: int) -> int:
    """Default (largest) lane tile of the grouped layout: the largest
    128-multiple whose (d + 2, tile) slab fits the slab budget."""
    rows = d + 2
    return max(128, min(_LANE_TILE, (_SLAB_BUDGET_ELEMS // rows) // 128 * 128))


def grouped_layout(g_sorted: np.ndarray, d: int):
    """Host-side layout from SORTED group ids, identical to the JAX
    package's: (lane_tile, k_loc, first_gid (grid,) int32, gl (N,) int32),
    or None when no tile keeps the group window within _K_LOC_MAX.
    ``STARK_GROUPED_LANE_TILE`` caps the starting tile as it does there.
    """
    g_sorted = np.asarray(g_sorted)
    if g_sorted.ndim != 1 or np.any(np.diff(g_sorted) < 0):
        raise ValueError("grouped_layout requires sorted 1-D group ids")
    n = g_sorted.shape[0]
    lane_tile = grouped_lane_tile(d)
    env_tile = os.environ.get("STARK_GROUPED_LANE_TILE")
    if env_tile:
        cap = int(env_tile)
        if cap % 128 or cap < 256:
            raise ValueError(
                f"STARK_GROUPED_LANE_TILE={cap}: need a 128-multiple >= 256"
            )
        lane_tile = min(lane_tile, cap)
    # floor at 256: below it every grouping would fit and the offset
    # path is the better choice (the reference's rule)
    while lane_tile >= 256:
        first_gid = g_sorted[::lane_tile].astype(np.int32)
        grid = first_gid.shape[0]
        last = g_sorted[np.minimum(np.arange(1, grid + 1) * lane_tile - 1, n - 1)]
        span = int(np.max(last - first_gid)) + 1
        k_loc = -(-span // 8) * 8
        if k_loc <= _K_LOC_MAX:
            gl = (g_sorted - np.repeat(first_gid, lane_tile)[:n]).astype(np.int32)
            return lane_tile, k_loc, first_gid, gl
        lane_tile = (lane_tile // 2) // 128 * 128
    return None


def prepare_grouped(data, d_eff, transpose_keys=("x",)):
    """Sort every leaf by data['g'] (stable), transpose the matrices in
    ``transpose_keys`` to ``<k>T`` (D, N) at the STARK_FUSED_X_DTYPE
    storage dtype (packed ones with their ``<k>T_scale``,
    `quantize.store_slab`), and add the layout (gl, first_gid,
    lane_tile, k_loc).  Numpy in, numpy out (a bf16 or fp8 slab, a CPU
    tensor).  None when `grouped_layout` finds no workable tile."""
    g = np.asarray(data["g"])
    order = np.argsort(g, kind="stable")
    layout = grouped_layout(g[order], d_eff)
    if layout is None:
        return None
    lane_tile, k_loc, first_gid, gl = layout
    out = {
        k: np.asarray(v)[order] for k, v in data.items() if k not in transpose_keys
    }
    for k in transpose_keys:
        store_slab(out, k + "T", np.asarray(data[k], dtype=np.float32)[order].T)
    out["gl"] = gl
    out["first_gid"] = first_gid
    out["k_loc"] = int(k_loc)
    out["lane_tile"] = int(lane_tile)
    return out


def absolute_groups(gl, first_gid, lane_tile):
    """(N,) absolute group id of every row from the layout."""
    n = gl.shape[0]
    tile = torch.arange(n, device=gl.device) // lane_tile
    return first_gid.long()[tile] + gl.long()


def hier_grouped_plain(beta, alpha, xT, y, gl, first_gid, lane_tile, prec="highest"):
    """Plain PyTorch version of kernel B1 at the dot precision ``prec``:
    -> (val (C,), gbeta (C, D), galpha (C, G)).  Its four dots are the
    reference's: beta x and resid x^T (`dot`); alpha and resid against
    the rows' one-hot groups, a gather and a segment sum of
    `dot_operand`.  A stored slab is widened to float32."""
    xT = widen(xT)
    g = absolute_groups(gl, first_gid, lane_tile)
    logits = dot(beta, xT, prec) + dot_operand(alpha, prec)[:, g]
    val_terms, resid = _link_parts(y, logits)
    galpha = torch.zeros_like(alpha).index_add_(1, g, dot_operand(resid, prec))
    return val_terms.sum(-1), dot(resid, xT.T, prec), galpha


#: rows per staged sub-tile of csrc/hier_grouped.cu (b1::kRows)
B1_ROW_TILE = 128
#: most row blocks of one B1 launch: two resident on each of the H100's
#: 132 SMs, so one wave (b1::kBlocks)
B1_BLOCKS = 264


def b1_blocks(n: int):
    """Row split of a B1 launch (`subtile_split`, csrc/hier_grouped.cu)."""
    return subtile_split(n, B1_ROW_TILE, B1_BLOCKS)


# csrc/hier_grouped.cu's constants: chains per chunk (kChains), features
# per gradient chunk (kFeat), the shared tiles' row stride (kLd), the most
# shared memory of a block with two blocks an SM and with one (kTwoPerSm,
# kOnePerSm), and the entries of hier_mma's beta fragments (kBetaFragEntries)
_B1_CHAINS, _B1_FEAT, _B1_LD = 64, 32, B1_ROW_TILE + 4
_B1_TWO_PER_SM, _B1_ONE_PER_SM = 113 * 1024, 227 * 1024
_B1_BETA_FRAG_ENTRIES = 2 * (_B1_CHAINS // 8) * 32
#: B1's passes (csrc/hier_grouped.cu:stark_hier_grouped_route)
B1_PASSES = ("hier_pass", "hier_mma", "hier_chunk")
#: the chain counts of hier_chunk's one chunk (csrc/hier_grouped.cu:chunk_chains)
B1_CHUNK_CHAINS = (8, 16, 32)
#: hier_chunk's ring of x buffers (kStages): the sub-tile whose gradient
#: is taken, the one whose logits are, and one in flight
B1_CHUNK_STAGES = 3


def _b1_layout(c: int, d: int, nbuf: int, gsl_global: bool) -> int:
    """Words of csrc/hier_grouped.cu:layout_with."""
    cp = -(-c // _B1_CHAINS) * _B1_CHAINS
    xrows = -(-d // _B1_FEAT) * _B1_FEAT if nbuf == 2 else d
    words = (nbuf * xrows * _B1_LD + 2 * nbuf * B1_ROW_TILE + _B1_CHAINS * _B1_LD
             + d * _round4(c) + cp - _round4(c) + 5 * cp + _round4(B1_ROW_TILE + 1) + 4)
    if not (cp == _B1_CHAINS and d <= _B1_FEAT) and not gsl_global:
        words += _round4(c * d)
    return words


def b1_chunk_chains(c: int, d: int) -> int:
    """The chains of hier_chunk's one chunk at C=c, D=d: the smallest of
    `B1_CHUNK_CHAINS` that holds c, or 0 past them or past 32 features
    (csrc/hier_grouped.cu:chunk_chains)."""
    if d > _B1_FEAT:
        return 0
    return next((ch for ch in B1_CHUNK_CHAINS if c <= ch), 0)


def b1_chunk_words(ch: int) -> int:
    """Words of hier_chunk's shared memory for a chunk of ``ch`` chains
    (csrc/hier_grouped.cu:layout_chunk): `B1_CHUNK_STAGES` buffers of x
    (32 rows), y and local ids; two (by the sub-tile's parity) of resid
    [c][r], of the segment starts and count and of the run sums
    [run][warp][c]; beta [c][36], the value partials [warp][c], the open
    groups' sums, ids and flags."""
    return (B1_CHUNK_STAGES * (_B1_FEAT * _B1_LD + 2 * B1_ROW_TILE)
            + 2 * (ch * _B1_LD + _round4(B1_ROW_TILE + 1) + 4 + 16 * ch)
            + ch * (_B1_FEAT + 4) + 8 * ch + 3 * ch)


def b1_layout(c: int, d: int, prec: str, mma: bool):
    """(x buffers, words) of a B1 block's shared memory before the narrow
    slot: csrc/hier_grouped.cu:layout, and for hier_mma (``mma``)
    layout_mma, which adds beta's fragments (6 words an entry at highest,
    4 else) and the segment partials in the one-tile case."""
    for nbuf, gsl_global, limit in ((2, False, _B1_TWO_PER_SM), (1, False, _B1_ONE_PER_SM),
                                    (1, True, None)):
        words = _b1_layout(c, d, nbuf, gsl_global)
        if limit is None or 4 * words <= limit:
            break
    if mma and -(-c // _B1_CHAINS) == 1 and d <= _B1_FEAT:
        words += _B1_BETA_FRAG_ENTRIES * (6 if prec == "highest" else 4) + 4 * _B1_CHAINS
    return nbuf, words


def b1_route(c: int, d: int, prec: str, x_dtype: str = "f32"):
    """(pass, one tile, n-tiles compiled in, narrow X through the packed
    slot, bytes of shared memory) that B1 runs at C=c, D=d, the dot
    precision ``prec`` and X stored as ``x_dtype`` (a name of
    `precision.X_DTYPE_NAMES`): csrc/hier_grouped.cu:route.  Highest on
    float32 X is hier_chunk at C <= 32 and D <= 32 (one chunk of 8, 16 or
    32 chains, `b1_chunk_chains`; its n-tiles of 8 chains in the third
    place), else hier_pass; the rest hier_mma.  A narrow slab is copied
    in flight through a slot of D rows of `x_window_chunks` windows where
    the slot fits the block's tier (113 KB with two x buffers, 227 KB
    with one), else loaded plainly.  (A narrow slab whose base is off
    16-byte alignment is loaded plainly, by the kernel that reads its
    n-tiles from C: the launcher sets nt to 0 for it.)"""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown dot precision {prec!r}; use one of {sorted(PRECISIONS)}")
    if x_dtype not in X_DTYPE_NAMES:
        raise ValueError(f"unknown X dtype {x_dtype!r}; use one of {X_DTYPE_NAMES}")
    narrow = x_dtype != "f32"
    mma = prec != "highest" or narrow
    one = -(-c // _B1_CHAINS) == 1 and d <= _B1_FEAT
    ch = 0 if mma else b1_chunk_chains(c, d)
    if ch:
        return B1_PASSES[2], one, ch // 8, False, 4 * b1_chunk_words(ch)
    nt8 = -(-min(c, _B1_CHAINS) // 8)
    ntiles = 1 if nt8 <= 1 else 2 if nt8 <= 2 else 4 if nt8 <= 4 else 8
    nbuf, words = b1_layout(c, d, prec, mma)
    windows = False
    if narrow:
        slot = d * x_window_chunks(B1_ROW_TILE, X_ITEMSIZE[x_dtype]) * 4
        windows = 4 * (words + slot) <= (_B1_TWO_PER_SM if nbuf == 2 else _B1_ONE_PER_SM)
        words += slot if windows else 0
    compiled = ntiles == 1 or (ntiles == 8 and (prec == "default" or narrow))
    nt = ntiles if mma and one and (windows or not narrow) and compiled else 0
    return B1_PASSES[mma], one, nt, windows, 4 * words


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def b1_shared_memory(c: int, d: int, prec: str, x_dtype: str, device: int):
    """(bytes of shared memory one B1 block needs at C=c, D=d, the dot
    precision ``prec`` and X stored as ``x_dtype``, most bytes the card
    ``device`` gives one block), from csrc/hier_grouped.cu."""
    fn = _build.function(
        "hier_grouped", "stark_hier_grouped_smem",
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2,
    )
    need, limit = ctypes.c_int(), ctypes.c_int()
    err = fn(c, d, PRECISIONS[prec], X_CODES[x_dtype], device, ctypes.byref(need),
             ctypes.byref(limit))
    _build.check("hier_grouped", err)
    return need.value, limit.value


def hier_grouped(beta, alpha, xT, y, gl, first_gid, lane_tile: int):
    """Kernel B1: -> (val (C,), gbeta (C, D), galpha (C, G)).

    beta (C, D), alpha (C, G), xT (D, N), y (N,) float32, xT stored as
    float32, bf16, int8 or fp8; gl (N,), first_gid (ceil(N /
    lane_tile),) int32; rows sorted by group.  The dots run at
    STARK_FUSED_PRECISION, read at the call; launches count in
    ``hier_grouped.launches`` and, by precision, by xT's storage dtype
    and by the pass that ran (`b1_route`), in
    ``hier_grouped.precision_launches``, ``hier_grouped.x_dtype_launches``
    and ``hier_grouped.pass_launches``.
    """
    prec = check_knobs()
    if beta.device.type == "cpu":
        return hier_grouped_plain(beta, alpha, xT, y, gl, first_gid, lane_tile, prec)
    if beta.device.type != "cuda":
        raise ValueError(f"hier_grouped runs on cuda or cpu, not {beta.device}")
    c, d = beta.shape
    g_total = alpha.shape[1]
    n = xT.shape[1]
    xcode, xname = x_code("xT", xT)
    check_kernel_args(
        {"beta": beta, "alpha": alpha, "xT": xT, "y": y, "gl": gl,
         "first_gid": first_gid},
        device=beta.device,
        dtypes={"beta": torch.float32, "alpha": torch.float32,
                "xT": xT.dtype, "y": torch.float32, "gl": torch.int32,
                "first_gid": torch.int32},
        shapes={"beta": (c, d), "alpha": (c, g_total), "xT": (d, n),
                "y": (n,), "gl": (n,), "first_gid": (-(-n // lane_tile),)},
    )
    if lane_tile % B1_ROW_TILE:
        raise ValueError(f"lane_tile={lane_tile} is not a multiple of {B1_ROW_TILE}")
    need, limit = b1_shared_memory(c, d, prec, xname, beta.device.index)
    if need > limit:
        raise ValueError(
            f"hier_grouped: C={c} chains of D={d} features need {need} bytes of "
            f"shared memory per block; this card gives a block at most {limit}"
        )
    nblk, _ = b1_blocks(n)
    val = torch.empty(c, device=beta.device, dtype=torch.float32)
    gbeta = torch.empty(c, d, device=beta.device, dtype=torch.float32)
    galpha = torch.empty(c, g_total, device=beta.device, dtype=torch.float32)
    scratch = torch.empty(
        scratch_words(nblk, c, d), device=beta.device, dtype=torch.float32
    )
    fn = _build.function("hier_grouped", "stark_hier_grouped", _ARGTYPES)
    err = fn(
        xT.data_ptr(), y.data_ptr(), gl.data_ptr(), first_gid.data_ptr(),
        beta.data_ptr(), alpha.data_ptr(), val.data_ptr(), gbeta.data_ptr(),
        galpha.data_ptr(), scratch.data_ptr(),
        c, d, n, g_total, lane_tile, nblk, PRECISIONS[prec], xcode,
        torch.cuda.current_stream(beta.device).cuda_stream,
    )
    _build.check("hier_grouped", err)
    hier_grouped.launches += 1
    hier_grouped.precision_launches[prec] += 1
    hier_grouped.x_dtype_launches[xname] += 1
    hier_grouped.pass_launches[_b1_pass(c, d, prec, xname)] += 1
    return val, gbeta, galpha


@functools.lru_cache(maxsize=None)
def _b1_pass(c: int, d: int, prec: str, x_dtype: str) -> str:
    return b1_route(c, d, prec, x_dtype)[0]


#: launches of the CUDA kernel in this process (CPU calls do not count),
#: in all, by dot precision, by xT's storage dtype and by pass
hier_grouped.launches = 0
hier_grouped.precision_launches = dict.fromkeys(PRECISIONS, 0)
hier_grouped.x_dtype_launches = dict.fromkeys(X_DTYPE_NAMES, 0)
hier_grouped.pass_launches = dict.fromkeys(B1_PASSES, 0)


class _HierLogisticLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, alpha, xT, y, gl, first_gid, lane_tile):
        val, gbeta, galpha = hier_grouped(
            beta.contiguous(), alpha.contiguous(), xT, y, gl, first_gid, lane_tile
        )
        ctx.save_for_backward(gbeta, galpha)
        return val

    @staticmethod
    def backward(ctx, ct):
        gbeta, galpha = ctx.saved_tensors
        return ct[:, None] * gbeta, ct[:, None] * galpha, None, None, None, None, None


def hier_logistic_loglik(beta, alpha, xT, y, gl, first_gid, lane_tile: int):
    """Differentiable fused hierarchical Bernoulli-logit log-lik per
    chain: beta (C, D) [or (D,)], alpha (C, G) [or (G,)] -> (C,) [or ()].
    One kernel pass yields the value and both gradients."""
    single = beta.ndim == 1
    if single:
        beta, alpha = beta[None], alpha[None]
    val = _HierLogisticLoglik.apply(beta, alpha, xT, y, gl, first_gid, lane_tile)
    return val[0] if single else val


def lmm_grouped_plain(beta, u, intercept, xT, zT, y, gl, first_gid, lane_tile,
                      prec="highest"):
    """Plain PyTorch version of kernel B4 at the dot precision ``prec``:
    -> (ssr (C,), sum_resid (C,), gbeta (C, D), gu (C, G, Q)).  Its dots
    are the reference's: beta x and resid x^T (`dot`); u and resid z_q
    against the rows' one-hot groups, a gather and a segment sum of
    `dot_operand` (z_q multiplies the gathered u in float32, outside the
    dot, as there).  Stored slabs are widened to float32."""
    xT, zT = widen(xT), widen(zT)
    g = absolute_groups(gl, first_gid, lane_tile)
    mu = (intercept[:, None] + dot(beta, xT, prec)
          + torch.einsum("qn,cnq->cn", zT, dot_operand(u, prec)[:, g, :]))
    _, resid = _link_parts(y, mu, "gaussian")
    gu = torch.zeros_like(u).index_add_(
        1, g, dot_operand(resid[:, :, None] * zT.T[None], prec))
    return (resid * resid).sum(-1), resid.sum(-1), dot(resid, xT.T, prec), gu


#: rows per staged sub-tile of csrc/lmm_grouped.cu (b4::kRows)
B4_ROW_TILE = 128
#: most row blocks of one B4 launch: three resident on each of the H100's
#: 132 SMs, so one wave (b4::kBlocks)
B4_BLOCKS = 396


def b4_blocks(n: int):
    """Row split of a B4 launch (`subtile_split`, csrc/lmm_grouped.cu)."""
    return subtile_split(n, B4_ROW_TILE, B4_BLOCKS)


#: the per-block partials of a B4 launch, in the order
#: csrc/lmm_grouped.cu:carve lays them out in the scratch buffer
B4_PARTIALS = ("gpart", "vpart", "rpart", "head", "tail", "blo", "bhi")


def b4_scratch(nblk: int, c: int, d: int, q: int):
    """(word offset of each of B4_PARTIALS, total words) of B4's scratch
    buffer: gpart (nblk, C, D), vpart and rpart (nblk, C), head and tail
    (nblk, C, Q) float32, blo and bhi (nblk,) int32, one after another
    (csrc/lmm_grouped.cu:carve)."""
    nc = nblk * c
    sizes = (nc * d, nc, nc, nc * q, nc * q, nblk, nblk)
    offsets, o = {}, 0
    for name, size in zip(B4_PARTIALS, sizes):
        offsets[name] = o
        o += size
    return offsets, o


@functools.lru_cache(maxsize=None)
def b4_shared_memory(c: int, d: int, q: int, device: int):
    """(bytes of shared memory one B4 block needs at C=c, D=d, Q=q, most
    bytes the card ``device`` gives one block), from csrc/lmm_grouped.cu."""
    fn = _build.function(
        "lmm_grouped", "stark_lmm_grouped_smem",
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2,
    )
    need, limit = ctypes.c_int(), ctypes.c_int()
    _build.check("lmm_grouped", fn(c, d, q, device, ctypes.byref(need), ctypes.byref(limit)))
    return need.value, limit.value


_LMM_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def lmm_grouped(beta, u, intercept, xT, zT, y, gl, first_gid, lane_tile: int):
    """Kernel B4: -> (ssr (C,), sum_resid (C,), gbeta (C, D), gu (C, G, Q)).

    beta (C, D), u (C, G, Q), intercept (C,), xT (D, N), zT (Q, N), y
    (N,) float32, xT and zT each stored as float32, bf16, int8 or fp8;
    gl (N,), first_gid (ceil(N / lane_tile),) int32; rows sorted by
    group.  The dots run at STARK_FUSED_PRECISION, read at the call;
    launches count as `hier_grouped`'s do (by xT's dtype).
    """
    prec = check_knobs()
    if beta.device.type == "cpu":
        return lmm_grouped_plain(beta, u, intercept, xT, zT, y, gl, first_gid, lane_tile,
                                 prec)
    if beta.device.type != "cuda":
        raise ValueError(f"lmm_grouped runs on cuda or cpu, not {beta.device}")
    c, d = beta.shape
    g_total, q = u.shape[1], u.shape[2]
    n = xT.shape[1]
    f32 = torch.float32
    xcode, xname = x_code("xT", xT)
    zcode, _ = x_code("zT", zT)
    check_kernel_args(
        {"beta": beta, "u": u, "intercept": intercept, "xT": xT, "zT": zT,
         "y": y, "gl": gl, "first_gid": first_gid},
        device=beta.device,
        dtypes={"beta": f32, "u": f32, "intercept": f32, "xT": xT.dtype,
                "zT": zT.dtype, "y": f32, "gl": torch.int32,
                "first_gid": torch.int32},
        shapes={"beta": (c, d), "u": (c, g_total, q), "intercept": (c,),
                "xT": (d, n), "zT": (q, n), "y": (n,), "gl": (n,),
                "first_gid": (-(-n // lane_tile),)},
    )
    if lane_tile % B4_ROW_TILE:
        raise ValueError(f"lane_tile={lane_tile} is not a multiple of {B4_ROW_TILE}")
    need, limit = b4_shared_memory(c, d, q, beta.device.index)
    if need > limit:
        raise ValueError(
            f"lmm_grouped: C={c} chains of D={d} features and Q={q} effects need "
            f"{need} bytes of shared memory per block; this card gives a block at "
            f"most {limit}"
        )
    nblk, _ = b4_blocks(n)
    ssr = torch.empty(c, device=beta.device, dtype=f32)
    sresid = torch.empty(c, device=beta.device, dtype=f32)
    gbeta = torch.empty(c, d, device=beta.device, dtype=f32)
    gu = torch.empty(c, g_total, q, device=beta.device, dtype=f32)
    scratch = torch.empty(b4_scratch(nblk, c, d, q)[1], device=beta.device, dtype=f32)
    fn = _build.function("lmm_grouped", "stark_lmm_grouped", _LMM_ARGTYPES)
    err = fn(
        xT.data_ptr(), zT.data_ptr(), y.data_ptr(), gl.data_ptr(),
        first_gid.data_ptr(), beta.data_ptr(), u.data_ptr(),
        intercept.data_ptr(), ssr.data_ptr(), sresid.data_ptr(),
        gbeta.data_ptr(), gu.data_ptr(), scratch.data_ptr(),
        c, d, q, n, g_total, lane_tile, nblk, PRECISIONS[prec], xcode, zcode,
        torch.cuda.current_stream(beta.device).cuda_stream,
    )
    _build.check("lmm_grouped", err)
    lmm_grouped.launches += 1
    lmm_grouped.precision_launches[prec] += 1
    lmm_grouped.x_dtype_launches[xname] += 1
    return ssr, sresid, gbeta, gu


#: launches of the CUDA kernel in this process (CPU calls do not count),
#: in all, by dot precision and by xT's storage dtype
lmm_grouped.launches = 0
lmm_grouped.precision_launches = dict.fromkeys(PRECISIONS, 0)
lmm_grouped.x_dtype_launches = dict.fromkeys(X_DTYPE_NAMES, 0)


class _LmmGroupedLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, u, intercept, sigma, xT, zT, y, gl, first_gid, lane_tile):
        ssr, sresid, gbeta, gu = lmm_grouped(
            beta.contiguous(), u.contiguous(), intercept.contiguous(), xT, zT,
            y, gl, first_gid, lane_tile,
        )
        n = y.shape[-1]
        ctx.n = n
        ctx.save_for_backward(ssr, sresid, gbeta, gu, sigma)
        return normal_loglik_from_ssr(ssr, n, sigma)

    @staticmethod
    def backward(ctx, ct):
        ssr, sresid, gbeta, gu, sigma = ctx.saved_tensors
        inv2 = 1.0 / (sigma * sigma)
        s = ct * inv2
        return (
            per_chain(s, gbeta), per_chain(s, gu), s * sresid,
            sigma_grad(ct, ssr, ctx.n, sigma, inv2),
            None, None, None, None, None, None,
        )


def lmm_grouped_loglik(beta, u, intercept, sigma, xT, zT, y, gl, first_gid,
                       lane_tile: int):
    """Differentiable fused LMM normal log-lik over group-sorted rows, per
    chain: beta (C, D), u (C, G, Q), intercept (C,), sigma (C,) [or one
    chain without the leading axis] -> (C,) [or ()].  One kernel pass
    yields the value and every gradient; sigma applies outside."""
    single = beta.ndim == 1
    if single:
        beta, u, intercept, sigma = beta[None], u[None], intercept[None], sigma[None]
    val = _LmmGroupedLoglik.apply(
        beta, u, intercept, sigma, xT, zT, y, gl, first_gid, lane_tile
    )
    return val[0] if single else val
