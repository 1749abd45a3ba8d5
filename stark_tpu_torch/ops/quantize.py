"""Quantized design-matrix streams — counterpart of
``stark_tpu/ops/quantize.py``: int8 and fp8 X with per-column scales,
the scales folded into the small operand of each dot.

The contract is the JAX package's (its module docstring):

* **Calibration once, when the data are prepared.**  `pack_slab` gives
  each design-matrix column (each row of the transposed (D, N) slab)
  one symmetric scale ``s_d = amax_d / qmax``, ``amax_d`` its absolute
  maximum or, under ``STARK_QUANT_PCT=<p>``, its p-th absolute
  percentile (a column whose percentile is 0 keeps its maximum; an
  all-zero column gets scale 1.0).  int8 rounds half to even; fp8 clips
  to the format's largest finite value and casts to nearest even.  A
  fixed dataset and configuration pack to the same bytes every time,
  and to the JAX package's bytes.
* **The posterior is the model's on the dequantized matrix** ``s * q``:
  quantization is a change of data, made once.
* **No float32 copy of X on a kernel's path.**  The models fold the
  scales into the parameter operand (``(s * q) . beta == q . (s *
  beta)``) and the kernels widen each packed element to float32 where
  they read it.  `dequant_dot` and `dequant_dot_t` are the same fold
  for the zoo's fused ops (plain PyTorch): the scales multiply the
  small operand of the forward dot and the (D,) output of the backward
  one; those ops widen the slab to float32 inside the call, a
  transient copy.
* **Scales ride the data** as ``<k>T_scale`` (float32, (D,)) next to
  the packed ``<k>T``, and are never split by rows: row shards of q
  and the whole scale vector dequantize to the rows of the whole.

The IRT grid's streamed slab is its binary (P, I) response grid, which
packs exactly into every packed dtype, with no scale.

bf16 and fp8 have no numpy dtype, so a prepared slab of those types is
a CPU ``torch.Tensor`` (int8 stays numpy); `to_numpy_bits` and
`from_numpy_bits` carry such a tensor through numpy code by its bits,
and `index_rows` moves fp8 rows as bytes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .precision import dot, quant_percentile, x_stream_config, x_stream_dtype

#: canonical knob name -> packed storage dtype
PACKED_DTYPES = {
    "int8": torch.int8,
    "fp8e4m3": torch.float8_e4m3fn,
    "fp8e5m2": torch.float8_e5m2,
}

#: largest magnitude of each packed dtype, onto which a column's absmax
#: (or percentile) is mapped: 127 for int8 (a symmetric grid), the
#: largest finite value for fp8
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}

#: float dtypes numpy has no counterpart of, and the integer view that
#: carries their bits through numpy
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}


def is_packed_dtype(dtype) -> bool:
    """True for the quantized storage dtypes (int8, fp8)."""
    return dtype in _QMAX


def _percentile(ax: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(ax, pct, axis=-1)`` (linear interpolation) in
    float32, as the JAX package's compiled arithmetic gives it: XLA folds
    the division by 100 into the position, pos = pct * (0.01 * (n - 1))
    in float32, and takes low w_low + high w_high of the two neighbouring
    order statistics as one fused multiply-add (here the exact product
    in float64, then one rounding).  By `torch.kthvalue`, which has no
    size limit (`torch.quantile` refuses rows over 2^24 elements)."""
    n = ax.shape[-1]
    f32 = torch.float32
    pos = torch.tensor(pct, dtype=f32) * (torch.tensor(0.01, dtype=f32)
                                          * torch.tensor(float(n - 1), dtype=f32))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = torch.tensor(1.0, dtype=f32) - w_high
    lo = int(min(max(low.item(), 0), n - 1))
    hi = int(min(max(high.item(), 0), n - 1))
    v_lo = torch.kthvalue(ax, lo + 1, dim=-1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(ax, hi + 1, dim=-1).values
    return (v_lo.double() * w_low.double() + (v_hi * w_high).double()).to(f32)


def pack_slab(xt, dtype, pct: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a (D, N) slab -> ``(q, scale)``: q (D, N) of ``dtype`` and
    scale (D,) float32, per row of the slab (module docstring); ``pct``
    defaults to the ``STARK_QUANT_PCT`` knob.  Computed on the CPU."""
    qmax = _QMAX[dtype]
    if pct is None:
        pct = quant_percentile()
    xt = torch.as_tensor(np.asarray(xt) if not torch.is_tensor(xt) else xt)
    xt = xt.detach().to("cpu", torch.float32).contiguous()
    ax = xt.abs()
    amax = ax.amax(-1) if ax.shape[-1] else ax.new_zeros(ax.shape[:-1])
    if pct is not None:
        # a sparse column's percentile can be exactly 0, which would zero
        # the whole column: such a column keeps its absmax
        pmax = _percentile(ax, pct)
        amax = torch.where(pmax > 0, pmax, amax)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax)).to(torch.float32)
    v = torch.clamp(xt / scale[..., None], -qmax, qmax)
    q = torch.round(v).to(dtype) if dtype == torch.int8 else v.to(dtype)
    return q, scale


def widen(slab: torch.Tensor) -> torch.Tensor:
    """A stored slab (bf16, int8, fp8) as float32, element by element; a
    float32 or float64 slab as it is."""
    return slab if slab.dtype in (torch.float32, torch.float64) else slab.float()


def dequant(q, scale) -> torch.Tensor:
    """The float32 slab ``scale[..., None] * q``: the cold path (the
    knob-off fallbacks, references).  Hot paths use `dequant_dot`."""
    q, scale = torch.as_tensor(q), torch.as_tensor(scale)
    return scale[..., None] * widen(q)


def _split(operand):
    if isinstance(operand, (tuple, list)):
        return operand[0], operand[1]
    return operand, None


def _cols(scale, like):
    """A (..., D) scale aligned with a (..., [C,] D) operand."""
    return scale if like.ndim == scale.ndim else scale.unsqueeze(-2)


def dequant_dot(beta, slab, prec: str = "highest") -> torch.Tensor:
    """The forward dot of a fused op, beta (..., D) against the slab
    (..., D, N) -> (..., N), at the dot precision ``prec``.  A packed
    ``(q, scale)`` slab folds its scales into beta: ``dot(beta * s,
    q)``, a (D,) multiply, not a (D, N) dequantization.  A plain slab is
    widened to float32 as the ops always did, so a float32 slab gives
    the plain ``dot`` bit for bit.  (The JAX package's one
    ``dequant_dot`` takes both directions by ``jnp.dot``'s argument
    order; the port's dots are batched over chains and shards, so each
    direction has its function: `dequant_dot_t`.)"""
    q, s = _split(slab)
    return dot(beta if s is None else beta * _cols(s, beta), widen(q), prec)


def dequant_dot_t(slab, resid, prec: str = "highest") -> torch.Tensor:
    """The backward dot of a fused op, the slab (..., D, N) against resid
    (..., N) -> (..., D) (``q @ resid`` for each chain), at ``prec``.  A
    packed slab folds its scales into the (D,) output: ``s * dot(resid,
    q^T)``."""
    q, s = _split(slab)
    out = dot(resid, widen(q).transpose(-1, -2), prec)
    return out if s is None else out * _cols(s, out)


def stream_slab(data, key: str = "xT"):
    """The slab argument of a fused op: the ``(q, scale)`` pair where
    the slab was packed (``<key>_scale`` present), else the slab."""
    scale = data.get(key + "_scale")
    slab = data[key]
    return (slab, scale) if scale is not None else slab


def dequant_rows(data, key: str = "xT", dtype=None) -> torch.Tensor:
    """The (N, D) row matrix (or (S, n, D) per shard) from a prepared
    slab: the cold path of the fallbacks.  A packed slab dequantizes to
    float32, a bf16 one widens to float32; a float32 one is its
    transposed view (cast to ``dtype`` when given)."""
    scale = data.get(key + "_scale")
    if scale is not None:
        return dequant(data[key], scale).transpose(-1, -2)
    slab = data[key]
    rows = widen(slab).transpose(-1, -2)
    return rows if dtype is None else rows.to(dtype)


def fake_quant(x, name: str, pct: Optional[float] = None):
    """Quantize then dequantize an (N, D) row matrix through `pack_slab`
    (columns scaled): the rounded-X reference of the parity checks.
    numpy in, numpy out; a tensor in, a tensor out."""
    q, scale = pack_slab(torch.as_tensor(np.asarray(x)).T if not torch.is_tensor(x) else x.T,
                         PACKED_DTYPES[name], pct=pct)
    out = dequant(q, scale).T
    if torch.is_tensor(x):
        return out.to(x.device)
    return np.ascontiguousarray(out.numpy())


def quant_column_error(x, name: str, pct: Optional[float] = None) -> float:
    """Largest per-column relative error of packing ``x`` (N, D): max over
    the columns with any signal of max_n |x - x_q| / max_n |x|."""
    x = np.asarray(x, np.float64)
    xq = np.asarray(fake_quant(x.astype(np.float32), name, pct=pct), np.float64)
    amax = np.max(np.abs(x), axis=0)
    err = np.max(np.abs(x - xq), axis=0)
    live = amax > 0
    if not np.any(live):
        return 0.0
    return float(np.max(err[live] / amax[live]))


def predict_x_bytes(n: int, d: int, xcfg: Optional[str] = None) -> int:
    """Bytes one evaluation streams of an (n, d) row matrix prepared
    under the X-stream configuration ``xcfg`` (default: the resolved
    one): the slab at its storage width, plus the float32 scales of a
    packed dtype."""
    if xcfg is None:
        xcfg = x_stream_config()
    name = xcfg.split("@")[0]
    itemsize = {"f32": 4, "bf16": 2}.get(name, 1)
    nbytes = n * d * itemsize
    if name in PACKED_DTYPES:
        nbytes += d * 4
    return int(nbytes)


def _nbytes(a) -> int:
    if torch.is_tensor(a):
        return a.numel() * a.element_size()
    a = np.asarray(a)
    return int(a.size * a.dtype.itemsize)


def x_bytes_per_grad(data) -> Optional[int]:
    """Bytes of the streamed slab (``xT``, or the IRT grid ``y_grid``)
    that one fused evaluation reads, its scales included; None when the
    data hold no prepared slab."""
    if not hasattr(data, "get"):
        return None
    for key in ("xT", "y_grid"):
        slab = data.get(key)
        if slab is None:
            continue
        total = _nbytes(slab)
        scale = data.get(key + "_scale")
        if scale is not None:
            total += _nbytes(scale)
        return int(total)
    return None


# ------------------------------------------------- moving packed slabs


def storage_slab(x: np.ndarray, dtype):
    """A float32 (D, N) slab cast to ``dtype`` (bf16 to nearest even), in
    its host form (`host_leaf`)."""
    return host_leaf(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dtype))


def store_slab(out, key: str, slab) -> None:
    """Store the (D, N) float32 ``slab`` as ``out[key]`` at the
    STARK_FUSED_X_DTYPE storage dtype: as it is (f32), rounded to bf16,
    or packed (int8, fp8) with its per-column scales in ``out[key +
    "_scale"]``.  numpy where numpy has the dtype, else a CPU tensor."""
    xdt = x_stream_dtype()
    if is_packed_dtype(xdt):
        q, scale = pack_slab(slab, xdt)
        out[key], out[key + "_scale"] = host_leaf(q), scale.numpy()
    else:
        out[key] = storage_slab(slab, xdt)


def host_leaf(v):
    """A prepared leaf on the host: numpy where numpy has its dtype, a
    CPU tensor otherwise (bf16, fp8)."""
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return v if v.dtype in _BITS else v.numpy()
    return v


def to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """The bits of a bf16 or fp8 CPU tensor as an integer numpy array."""
    return t.view(_BITS[t.dtype]).numpy()


def from_numpy_bits(a: np.ndarray, dtype) -> torch.Tensor:
    """A tensor of ``dtype`` from the bits `to_numpy_bits` gave."""
    return torch.from_numpy(np.ascontiguousarray(a)).view(dtype)


def index_rows(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, idx)`` for every stored dtype: fp8 rows move
    as bytes."""
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return x.view(torch.uint8).index_select(dim, idx).view(x.dtype)
    return x.index_select(dim, idx)


__all__ = [
    "PACKED_DTYPES",
    "dequant",
    "dequant_dot",
    "dequant_dot_t",
    "dequant_rows",
    "fake_quant",
    "from_numpy_bits",
    "host_leaf",
    "index_rows",
    "is_packed_dtype",
    "pack_slab",
    "predict_x_bytes",
    "quant_column_error",
    "storage_slab",
    "store_slab",
    "stream_slab",
    "to_numpy_bits",
    "widen",
    "x_bytes_per_grad",
]
