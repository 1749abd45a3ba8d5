"""Fused logistic and gaussian log-likelihood passes — counterpart of
``stark_tpu/ops/logistic_fused.py`` (kernels B2 and B3, both links).

``xT`` is the design matrix transposed, (D, N), as the JAX package lays
it out.  Two kernels evaluate, in one pass over X, the link's value sum,
its beta gradient and — when row offsets are given — the per-row
residual, which the offset-path models chain through their gather:

* `logistic_batched` (B2): a (C, D) block of chains, offsets (C, N);
  or S shards of rows at once (consensus Monte Carlo), each with its own
  (C, D) block: beta (S, C, D), xT (S, D, n), y (S, n), offsets (S, C,
  n), all in one launch;
* `logistic_single` (B3): one chain, beta (D,), offsets (N,).

Links (`_link_parts`): ``bernoulli_logit`` (value = the log-likelihood,
resid = y - sigmoid(logits)) and ``gaussian`` (value = the SSR, resid =
y - logits; scale-free, sigma is applied outside).

On a CUDA tensor each wrapper launches its kernel
(``csrc/logistic_batched.cu``, ``csrc/logistic_single.cu``); on a CPU
tensor it runs the plain PyTorch version beside it (the CPU tests' path
and the kernel's yardstick on the card).  There is no fallback from one
to the other.  B2 splits the rows by `b2_blocks` and refuses, before
launching, widths whose block would not fit the card's shared memory
(`b2_shared_memory`); B3 splits them by `row_blocks`.

B2 takes its two dots at STARK_FUSED_PRECISION, read at each call
(`ops.precision`); B3 takes none, as the reference's single-chain
kernel multiplies on its vector unit, so the knob leaves it as it is.

``xT`` may be stored as float32, bf16, int8 or fp8 (STARK_FUSED_X_DTYPE,
`ops.quantize`); each kernel reads it at that width and widens each
element to float32 (the plain versions widen the slab).  The slab's own
dtype picks what the kernel streams, never the knob; a packed slab's
scales are folded into beta by the model before the call.

`logistic_offset_loglik`, `logistic_loglik`, `gaussian_offset_loglik`
and `gaussian_loglik` wrap them in ``torch.autograd.Function``s whose
backward only rescales the gradients the forward pass already computed,
so X is read once per evaluation.  A chain batch (beta (C, D)) goes to
B2 and one chain (beta (D,)) to B3, as the reference's batching rules
route them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .precision import (
    PRECISIONS,
    X_CODES,
    X_DTYPE_NAMES,
    X_DTYPE_OF,
    check_knobs,
    dot,
    per_chain,
)
from .quantize import widen

#: B3's row blocks are multiples of this many rows
KERNEL_ROW_TILE = 128
#: target number of row blocks per launch (about two per SM on an H100)
_TARGET_BLOCKS = 256


def row_blocks(n: int) -> Tuple[int, int]:
    """(rows per block, number of blocks) for kernel B3: blocks of a
    multiple of KERNEL_ROW_TILE rows, about _TARGET_BLOCKS of them, chosen
    from N alone so a given shape always sums in the same order."""
    per = -(-n // _TARGET_BLOCKS)
    rows = max(KERNEL_ROW_TILE, -(-per // KERNEL_ROW_TILE) * KERNEL_ROW_TILE)
    return rows, -(-n // rows)


#: rows per staged sub-tile of csrc/logistic_batched.cu (b2::kRows)
B2_ROW_TILE = 128
#: most row blocks of one B2 launch: three resident on each of the H100's
#: 132 SMs, so one wave at the flagship's width (b2::kBlocks)
B2_BLOCKS = 396


def subtile_split(n: int, tile: int, most: int):
    """Row split of a launch over n rows in sub-tiles of ``tile`` rows:
    (number of blocks, edges), block b owning rows [edges[b], edges[b +
    1]).  The S = ceil(n / tile) sub-tiles are dealt out as [b*S // B,
    (b+1)*S // B) to B = min(most, S) blocks, so every edge but the last
    is a multiple of ``tile`` and the blocks differ by at most one
    sub-tile.  A function of n alone, computed the same way by the
    kernels, whose launchers refuse any other block count: a shape always
    sums in the same order."""
    nsub = -(-n // tile)
    nblk = min(most, nsub)
    edges = [min(n, (b * nsub // nblk) * tile) for b in range(nblk + 1)]
    return nblk, edges


def b2_blocks(n: int, shards: int = 1):
    """Row split of each shard of a B2 launch over ``shards`` shards of
    n rows (`subtile_split` into at most B2_BLOCKS // shards blocks, so
    the launch stays about one wave; csrc/logistic_batched.cu)."""
    return subtile_split(n, B2_ROW_TILE, max(1, B2_BLOCKS // shards))


#: the links both kernels take, and their code in the C entry points
LINKS = {"bernoulli_logit": 0, "gaussian": 1}
_LOG_2PI = 1.8378770664093453


def _link_code(link: str) -> int:
    if link not in LINKS:
        raise ValueError(f"unknown link {link!r}; use one of {sorted(LINKS)}")
    return LINKS[link]


def _link_parts(y, logits, link="bernoulli_logit"):
    """Elementwise value terms and residual of a link."""
    _link_code(link)
    if link == "gaussian":
        resid = y - logits
        return resid * resid, resid
    val_terms = y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits)
    return val_terms, y - torch.sigmoid(logits)


def scratch_words(nblk: int, c: int, d: int) -> int:
    """float32 words of the per-block partials a launch of B1, B2 or B3
    needs (csrc/fused_pass.cuh:carve_scratch)."""
    return nblk * (c * d + 3 * c + 2)


def x_code(name: str, slab: torch.Tensor):
    """(code in the C entry points, canonical name) of a slab's storage
    dtype (`precision.X_CODES`); ValueError for any other dtype."""
    if slab.dtype not in X_DTYPE_OF:
        raise ValueError(f"{name} has dtype {slab.dtype}; a slab is stored as one of "
                         f"{'|'.join(X_DTYPE_NAMES)}")
    xname = X_DTYPE_OF[slab.dtype]
    return X_CODES[xname], xname


def check_kernel_args(named, *, device, dtypes, shapes):
    """Device, dtype, shape and contiguity checks shared by the kernel
    wrappers; raises ValueError naming the offending argument."""
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtypes[name]}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def logistic_batched_plain(beta, xT, y, offsets=None, link="bernoulli_logit",
                           prec="highest"):
    """Plain PyTorch version of kernel B2 (same outputs), with or
    without the shard axis, its two dots (beta x, resid x^T) at the dot
    precision ``prec`` (`dot`), a stored slab widened to float32."""
    xT = widen(xT)
    logits = dot(beta, xT, prec)
    if offsets is not None:
        logits = logits + offsets
    if beta.ndim == 3:  # shards: y (S, n) against logits (S, C, n)
        y = y.unsqueeze(-2)
    val_terms, resid = _link_parts(y, logits, link)
    val = val_terms.sum(-1)
    gbeta = dot(resid, xT.transpose(-1, -2), prec)
    if offsets is not None:
        return val, gbeta, resid
    return val, gbeta


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def b2_shared_memory(c: int, d: int, device: int):
    """(bytes of shared memory one B2 block needs at C=c, D=d, most bytes
    the card ``device`` gives one block), from csrc/logistic_batched.cu."""
    fn = _build.function(
        "logistic_batched", "stark_logistic_batched_smem",
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2,
    )
    need, limit = ctypes.c_int(), ctypes.c_int()
    _build.check(
        "logistic_batched", fn(c, d, device, ctypes.byref(need), ctypes.byref(limit))
    )
    return need.value, limit.value


def logistic_batched(
    beta: torch.Tensor,
    xT: torch.Tensor,
    y: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
    link: str = "bernoulli_logit",
):
    """Kernel B2: -> (val (C,), gbeta (C, D)[, resid (C, N)]).

    beta (C, D), xT (D, N), y (N,), offsets (C, N) or None; float32, xT
    stored as float32, bf16, int8 or fp8.  With a leading shard axis —
    beta (S, C, D), xT (S, D, n), y (S, n), offsets (S, C, n) — every
    shard in one launch: -> (val (S, C), gbeta
    (S, C, D)[, resid (S, C, n)]).  Launches count in
    ``logistic_batched.launches`` (bernoulli_logit) and
    ``logistic_batched.gaussian_launches`` (gaussian), one per launch
    whatever the number of shards; a launch with a shard axis also counts
    in ``logistic_batched.shard_launches``, and every launch in
    ``logistic_batched.precision_launches`` by its dot precision
    (STARK_FUSED_PRECISION, read at the call) and in
    ``logistic_batched.x_dtype_launches`` by xT's storage dtype.
    """
    prec = check_knobs()
    code = _link_code(link)
    if beta.ndim not in (2, 3):
        raise ValueError(f"logistic_batched takes beta (C, D) or (S, C, D); got "
                         f"{tuple(beta.shape)}")
    if beta.device.type == "cpu":
        return logistic_batched_plain(beta, xT, y, offsets, link, prec)
    if beta.device.type != "cuda":
        raise ValueError(f"logistic_batched runs on cuda or cpu, not {beta.device}")
    lead = tuple(beta.shape[:-2])  # () or (S,)
    s = lead[0] if lead else 1
    c, d = beta.shape[-2:]
    n = xT.shape[-1]
    named = {"beta": beta, "xT": xT, "y": y}
    shapes = {"beta": lead + (c, d), "xT": lead + (d, n), "y": lead + (n,),
              "offsets": lead + (c, n)}
    if offsets is not None:
        named["offsets"] = offsets
    xcode, xname = x_code("xT", xT)
    check_kernel_args(
        named, device=beta.device,
        dtypes={**{k: torch.float32 for k in shapes}, "xT": xT.dtype}, shapes=shapes,
    )
    need, limit = b2_shared_memory(c, d, beta.device.index)
    if need > limit:
        raise ValueError(
            f"logistic_batched: C={c} chains of D={d} features need {need} bytes "
            f"of shared memory per block; this card gives a block at most {limit}"
        )
    nblk, _ = b2_blocks(n, s)
    f32 = dict(device=beta.device, dtype=torch.float32)
    val = torch.empty(lead + (c,), **f32)
    gbeta = torch.empty(lead + (c, d), **f32)
    resid = torch.empty(lead + (c, n), **f32) if offsets is not None else None
    scratch = torch.empty(scratch_words(nblk * s, c, d), **f32)
    fn = _build.function("logistic_batched", "stark_logistic_batched", _ARGTYPES)
    err = fn(
        xT.data_ptr(), y.data_ptr(),
        offsets.data_ptr() if offsets is not None else None,
        beta.data_ptr(), val.data_ptr(), gbeta.data_ptr(),
        resid.data_ptr() if resid is not None else None,
        scratch.data_ptr(), c, d, n, s, nblk, code, PRECISIONS[prec], xcode,
        torch.cuda.current_stream(beta.device).cuda_stream,
    )
    _build.check("logistic_batched", err)
    logistic_batched.precision_launches[prec] += 1
    logistic_batched.x_dtype_launches[xname] += 1
    if link == "gaussian":
        logistic_batched.gaussian_launches += 1
    else:
        logistic_batched.launches += 1
    if lead:
        logistic_batched.shard_launches += 1
    if offsets is not None:
        return val, gbeta, resid
    return val, gbeta


#: launches of the CUDA kernel in this process, per link (CPU calls do
#: not count); shard_launches also counts those with a shard axis,
#: precision_launches every launch by its dot precision and
#: x_dtype_launches by xT's storage dtype
logistic_batched.launches = 0
logistic_batched.gaussian_launches = 0
logistic_batched.shard_launches = 0
logistic_batched.precision_launches = dict.fromkeys(PRECISIONS, 0)
logistic_batched.x_dtype_launches = dict.fromkeys(X_DTYPE_NAMES, 0)


def logistic_single_plain(beta, xT, y, offsets=None, link="bernoulli_logit"):
    """Plain PyTorch version of kernel B3: -> (val (), gbeta (D,)[,
    resid (N,)]), a stored slab widened to float32."""
    xT = widen(xT)
    logits = beta @ xT
    if offsets is not None:
        logits = logits + offsets
    val_terms, resid = _link_parts(y, logits, link)
    gbeta = xT @ resid
    if offsets is not None:
        return val_terms.sum(), gbeta, resid
    return val_terms.sum(), gbeta


_SINGLE_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def logistic_single(
    beta: torch.Tensor,
    xT: torch.Tensor,
    y: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
    link: str = "bernoulli_logit",
):
    """Kernel B3: -> (val (), gbeta (D,)[, resid (N,)]).

    beta (D,), xT (D, N), y (N,), offsets (N,) or None; float32, xT
    stored as float32, bf16, int8 or fp8 (launches by its dtype in
    ``logistic_single.x_dtype_launches``).  It takes no dot (the
    reference's kernel multiplies and sums on its vector unit), so
    STARK_FUSED_PRECISION does not change it.
    """
    check_knobs()
    code = _link_code(link)
    if beta.ndim != 1:
        raise ValueError(f"logistic_single takes one chain, beta (D,); got {tuple(beta.shape)}")
    if beta.device.type == "cpu":
        return logistic_single_plain(beta, xT, y, offsets, link)
    if beta.device.type != "cuda":
        raise ValueError(f"logistic_single runs on cuda or cpu, not {beta.device}")
    (d,) = beta.shape
    n = xT.shape[1]
    named = {"beta": beta, "xT": xT, "y": y}
    shapes = {"beta": (d,), "xT": (d, n), "y": (n,), "offsets": (n,)}
    if offsets is not None:
        named["offsets"] = offsets
    xcode, xname = x_code("xT", xT)
    check_kernel_args(
        named, device=beta.device,
        dtypes={**{k: torch.float32 for k in shapes}, "xT": xT.dtype}, shapes=shapes,
    )
    rows, nblk = row_blocks(n)
    val = torch.empty((), device=beta.device, dtype=torch.float32)
    gbeta = torch.empty(d, device=beta.device, dtype=torch.float32)
    resid = (
        torch.empty(n, device=beta.device, dtype=torch.float32)
        if offsets is not None else None
    )
    scratch = torch.empty(
        scratch_words(nblk, 1, d), device=beta.device, dtype=torch.float32
    )
    fn = _build.function("logistic_single", "stark_logistic_single", _SINGLE_ARGTYPES)
    err = fn(
        xT.data_ptr(), y.data_ptr(),
        offsets.data_ptr() if offsets is not None else None,
        beta.data_ptr(), val.data_ptr(), gbeta.data_ptr(),
        resid.data_ptr() if resid is not None else None,
        scratch.data_ptr(), d, n, rows, nblk, code, xcode,
        torch.cuda.current_stream(beta.device).cuda_stream,
    )
    _build.check("logistic_single", err)
    logistic_single.launches += 1
    logistic_single.x_dtype_launches[xname] += 1
    if offsets is not None:
        return val, gbeta, resid
    return val, gbeta


#: launches of the CUDA kernel in this process (CPU calls do not count),
#: in all and by xT's storage dtype
logistic_single.launches = 0
logistic_single.x_dtype_launches = dict.fromkeys(X_DTYPE_NAMES, 0)


def logistic_loglik_value_and_grad(beta, xT, y):
    """-> (log-lik (), d/dbeta (D,)) of one chain in one pass over xT
    (kernel B3).  beta (D,), xT (D, N) — X transposed — y (N,) in {0, 1}."""
    return logistic_single(beta, xT, y)


def _pass(beta, xT, y, offsets, link):
    """One chain (beta (D,)) -> B3; a chain batch (beta (C, D)) or one
    per shard (beta (S, C, D)) -> B2."""
    beta = beta.contiguous()
    if offsets is not None:
        offsets = offsets.contiguous()
    if beta.ndim == 1:
        return logistic_single(beta, xT, y, offsets, link)
    return logistic_batched(beta, xT, y, offsets, link)


class _LogisticOffsetLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, offsets, xT, y):
        val, gbeta, resid = _pass(beta, xT, y, offsets, "bernoulli_logit")
        ctx.save_for_backward(gbeta, resid)
        return val

    @staticmethod
    def backward(ctx, ct):
        gbeta, resid = ctx.saved_tensors
        return per_chain(ct, gbeta), per_chain(ct, resid), None, None


class _LogisticLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, xT, y):
        val, gbeta = _pass(beta, xT, y, None, "bernoulli_logit")
        ctx.save_for_backward(gbeta)
        return val

    @staticmethod
    def backward(ctx, ct):
        (gbeta,) = ctx.saved_tensors
        return per_chain(ct, gbeta), None, None


def logistic_offset_loglik(beta, offsets, xT, y):
    """Differentiable Bernoulli-logit log-lik of X beta + offsets, per
    chain: beta (C, D) [or (D,)], offsets (C, N) [or (N,)] -> (C,) [or
    ()].  ∂/∂offsets is the residual the kernel already wrote."""
    return _LogisticOffsetLoglik.apply(beta, offsets, xT, y)


def logistic_loglik(beta, xT, y):
    """Differentiable Bernoulli-logit log-lik of X beta, per chain:
    beta (C, D) [or (D,)] -> (C,) [or ()]; per shard and chain, beta (S,
    C, D), xT (S, D, n), y (S, n) -> (S, C), in one B2 launch."""
    return _LogisticLoglik.apply(beta, xT, y)


def normal_loglik_from_ssr(ssr, n, sigma):
    """sum_n log N(y_n | mu_n, sigma) from the sum of squared residuals."""
    return -0.5 * ssr / sigma**2 - n * torch.log(sigma) - 0.5 * n * _LOG_2PI


def sigma_grad(ct, ssr, n, sigma, inv2):
    """Cotangent times ∂/∂sigma of `normal_loglik_from_ssr` (inv2 =
    1 / sigma^2)."""
    return ct * (ssr * inv2 / sigma - n / sigma)


class _GaussianOffsetLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, offsets, xT, y, sigma):
        ssr, xresid, resid = _pass(beta, xT, y, offsets, "gaussian")
        n = y.shape[-1]
        ctx.n = n
        ctx.save_for_backward(xresid, resid, ssr, sigma)
        return normal_loglik_from_ssr(ssr, n, sigma)

    @staticmethod
    def backward(ctx, ct):
        xresid, resid, ssr, sigma = ctx.saved_tensors
        inv2 = 1.0 / (sigma * sigma)
        s = ct * inv2
        return (
            per_chain(s, xresid), per_chain(s, resid), None, None,
            sigma_grad(ct, ssr, ctx.n, sigma, inv2),
        )


class _GaussianLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, beta, xT, y, sigma):
        ssr, xresid = _pass(beta, xT, y, None, "gaussian")
        n = y.shape[-1]
        ctx.n = n
        ctx.save_for_backward(xresid, ssr, sigma)
        return normal_loglik_from_ssr(ssr, n, sigma)

    @staticmethod
    def backward(ctx, ct):
        xresid, ssr, sigma = ctx.saved_tensors
        inv2 = 1.0 / (sigma * sigma)
        return (
            per_chain(ct * inv2, xresid), None, None,
            sigma_grad(ct, ssr, ctx.n, sigma, inv2),
        )


def gaussian_offset_loglik(beta, offsets, xT, y, sigma):
    """Differentiable normal log-lik of y ~ N(X beta + offsets, sigma) in
    one X pass, per chain: beta (C, D) [or (D,)], offsets (C, N) [or
    (N,)], sigma (C,) [or ()] -> (C,) [or ()].  The kernel is scale-free:
    sigma enters outside, and ∂/∂sigma comes from the SSR."""
    return _GaussianOffsetLoglik.apply(beta, offsets, xT, y, sigma)


def gaussian_loglik(beta, xT, y, sigma):
    """Differentiable normal log-lik of y ~ N(X beta, sigma), no offsets:
    no (N,) offset stream in and no residual written back."""
    return _GaussianLoglik.apply(beta, xT, y, sigma)
