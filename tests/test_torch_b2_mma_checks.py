"""Kernel B2's tensor-core pass (``b2_mma``, csrc/logistic_batched.cu) and
chip_smoke.py's checks of it, on the CPU.

Which pass the launcher runs at each (C, D, dot precision) and how many
chains it computes, mirrored in Python (``logistic_fused.b2_route``;
the card holds the launcher to it in
``test_b2_chunk_choice_is_the_python_mirror``); the bound of B2 at the
offset path's shape on the bf16 tensor cores; the ``--compare-with`` keys
of B2 at high and default and what each key is expected to show against
the parent; and the plain version at high and default at ``b2_mma``'s
edges (chain counts off its n-tiles of 8 and past one chunk of 32,
features off its k-steps of 16 and past one chunk of 32) against the
JAX package's ``_batched_call`` (Pallas, interpret mode on the CPU,
where XLA computes every float32 dot exactly whatever the setting), inside
the reference's band of each setting (tools/precision_parity.py:19-23).
The kernel itself runs only on the card (tests/test_torch_gpu_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from stark_tpu.ops import logistic_fused as ref
from stark_tpu_torch.ops import logistic_fused as port

KNOB = "STARK_FUSED_PRECISION"
PRECISIONS = ("highest", "high", "default")

# the offset path's B2 call (C=32, D=32, N=1,000,000, bernoulli): bytes
# as chip_smoke counts them (xT, y, beta read, gbeta written, val; with
# offsets the offsets read and resid written)
C, D, N = 32, 32, 1_000_000


def _bytes(with_offsets):
    return 4 * (D * N + N + 2 * C * D + C + (2 * C * N if with_offsets else 0))


def _expected_route(c, d, prec):
    """The launcher's rule, written out: b2_chunk at C <= 16 and D <= 32
    (chunks of 8 or 16 chains), else b2_pass at highest (chunks of 32) and
    b2_mma at high and default (chunks of 32, the last padded to 8)."""
    if c <= 16 and d <= 32:
        return "b2_chunk", 8 if c <= 8 else 16
    if prec == "highest":
        return "b2_pass", 32 * -(-c // 32)
    return "b2_mma", 32 * (c // 32) + 8 * -(-(c % 32) // 8)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("d", [8, 16, 17, 32, 33, 327])
@pytest.mark.parametrize("c", [1, 8, 16, 17, 24, 25, 32, 33, 64, 100])
def test_route_and_padding_mirror(c, d, prec):
    assert port.b2_route(c, d, prec) == _expected_route(c, d, prec)
    # the chunks are the precision's own business only past b2_chunk
    assert port.b2_chunks(c, d) == ((_expected_route(c, d, prec)[1], 8 if d <= 8 else 16 if
                                     d <= 16 else 32) if c <= 16 and d <= 32 else (32, 32))


@pytest.mark.parametrize("c,padded", [(17, 24), (24, 24), (25, 32), (33, 40), (41, 48),
                                      (100, 104), (128, 128)])
def test_b2_mma_pads_its_last_chunk_to_eight_chains(c, padded):
    """C = 17..24 computes 24 chains, not 32; past 32 the whole chunks
    stay 32 and the last takes n-tiles of 8."""
    for prec in ("high", "default"):
        assert port.b2_route(c, 40, prec) == ("b2_mma", padded)
    assert port.b2_route(c, 40, "highest") == ("b2_pass", 32 * -(-c // 32))


def test_route_refuses_an_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        port.b2_route(32, 32, "fast")
    assert port.B2_ROUTES == ("b2_chunk", "b2_pass", "b2_mma")


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("prec,passes", [("high", 3), ("default", 1)])
def test_bytes_bind_b2_on_the_tensor_cores(prec, passes, with_offsets):
    """At C=32 on the bf16 tensor cores the products (0.0124 ms at high)
    and the link's 3 C N special-function instructions (0.0230 ms) stay
    under the bytes, with and without offsets."""
    e = cs.bound(_bytes(with_offsets), 2 * 2 * C * D * N * passes, cs.BF16_FLOP_PER_S,
                 sfu=cs.LINK_SFU * C * N, sfu_per_s=cs.H100_SFU_PER_S)
    assert (e["term"], e["bound_by"]) == ("bytes", "bytes")
    assert e["bound_ms"] == pytest.approx(1e3 * _bytes(with_offsets) / cs.HBM_BYTES_PER_S)
    assert round(e["sfu_ms"], 4) == 0.0230
    assert 1e3 * 2 * 2 * C * D * N * passes / cs.BF16_FLOP_PER_S < e["sfu_ms"] < e["bound_ms"]
    assert round(e["bound_ms"], 4) == (0.1158 if with_offsets else 0.0394)


def test_b2_on_the_cuda_cores_was_bound_by_its_products_at_high():
    """What b2_pass at high had against it: 6.1e9 FMAs on the FP32 CUDA
    cores, 0.1834 ms, past the 0.0394 ms of bytes without offsets."""
    e = cs.bound(_bytes(False), 2 * 2 * C * D * N * 3)
    assert e["term"] == "products" and round(e["bound_ms"], 4) == 0.1834


@pytest.mark.parametrize("key", cs.B2_MMA_KEYS)
def test_compare_with_times_b2_at_high_and_default(key):
    """B2 at high and default past the narrow chunks is timed; against a
    parent that already has its tensor-core pass (b2_mma) it is expected
    bitwise equal."""
    assert key in cs.SHARED_KERNELS
    assert cs.expected_against_parent(key) == "yes"


def test_b2_mma_keys_are_high_and_default_with_and_without_offsets():
    assert set(cs.B2_MMA_KEYS) == {f"B2 {p} offsets={o}" for p in ("high", "default")
                                   for o in (False, True)}
    assert len(set(cs.SHARED_KERNELS)) == len(cs.SHARED_KERNELS)


#: B2 at highest on narrow X, on the tensor cores since its split3 route
_SPLIT3_KEYS = [k for k in cs.B2_X_KEYS if not k.startswith(("B2 high", "B2 default"))]


@pytest.mark.parametrize("key", [k for k in cs.SHARED_KERNELS
                                 if k not in _SPLIT3_KEYS and k not in cs.B1_CHUNK_KEYS])
def test_every_other_key_is_expected_bitwise_the_parents(key):
    """Against a parent with B1's and B2's tensor-core passes, b2_chunk
    and B1's split3 pass, only B2 at highest on narrow X (split3) and B1
    at highest on float32 X at C <= 32 (hier_chunk) sum in another
    order."""
    assert cs.expected_against_parent(key) == "yes"


def _check_band(got, want, prec):
    """The port's (value, gradients...) against the reference's, inside
    the band of ``prec`` (chip_smoke.PARITY_BANDS, the reference's)."""
    v0 = np.array(want[0], np.float64)
    v1 = got[0].double().numpy()
    val_rel, grad_rel = cs.parity_error(v0, v0, v1, v1)[0], 0.0
    for g, w in zip(got[1:], want[1:]):
        grad_rel = max(grad_rel, cs.parity_error(v0, np.array(w), v1, g.numpy())[1])
    tol_v, tol_g = cs.PARITY_BANDS[prec]
    assert val_rel <= tol_v and grad_rel <= tol_g, (val_rel, grad_rel)


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("link", ["bernoulli_logit", "gaussian"])
@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("d", [15, 16, 17, 33])
@pytest.mark.parametrize("c", [17, 24, 32, 33, 40])
def test_plain_b2_at_mma_edges_matches_reference(c, d, with_offsets, link, prec, monkeypatch):
    rs = np.random.RandomState(100 * c + d)
    n = 701
    xT = rs.standard_normal((d, n)).astype(np.float32)
    y = (rs.standard_normal(n) if link == "gaussian" else rs.rand(n) < 0.4).astype(np.float32)
    beta = (0.5 * rs.standard_normal((c, d))).astype(np.float32)
    off = rs.standard_normal((c, n)).astype(np.float32) if with_offsets else None
    monkeypatch.setenv(KNOB, prec)
    want = ref._batched_call(jnp.asarray(beta), jnp.asarray(xT), jnp.asarray(y),
                             None if off is None else jnp.asarray(off), lane_tile=None,
                             interpret=None, link=link)
    args = [torch.as_tensor(a) if a is not None else None for a in (beta, xT, y, off)]
    got = port.logistic_batched(*args, link)  # the CPU wrapper: the plain version at the knob
    assert port.b2_route(c, d, prec)[0] == "b2_mma"
    assert len(got) == len(want) == (3 if with_offsets else 2)
    for a, b in zip(got, port.logistic_batched_plain(*args, link, prec=prec)):
        assert torch.equal(a, b)
    _check_band(got, want, prec)
