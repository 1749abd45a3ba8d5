"""Port of the chain-batched logistic kernel (B2) against the JAX package.

The plain PyTorch version of B2 must match the reference's Pallas kernel
(`_batched_call`, interpret mode on the CPU) with and without row
offsets, within the reference's tolerances: value rtol 2e-5, gradients
and residuals rtol 2e-4 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.ops import logistic_fused as ref
from stark_tpu_torch.ops import logistic_fused as port

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4


def _inputs(c, n=3000, d=5, seed=0):
    rs = np.random.RandomState(seed)
    xT = rs.standard_normal((d, n)).astype(np.float32)
    y = (rs.rand(n) < 0.4).astype(np.float32)
    beta = (0.5 * rs.standard_normal((c, d))).astype(np.float32)
    off = rs.standard_normal((c, n)).astype(np.float32)
    return xT, y, beta, off


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("chains", [1, 5, 16])
def test_plain_b2_matches_reference_kernel(chains, with_offsets):
    xT, y, beta, off = _inputs(chains, seed=chains)
    off = off if with_offsets else None
    want = ref._batched_call(
        jnp.asarray(beta), jnp.asarray(xT), jnp.asarray(y),
        None if off is None else jnp.asarray(off),
        lane_tile=None, interpret=None,
    )
    got = port.logistic_batched(
        torch.as_tensor(beta), torch.as_tensor(xT), torch.as_tensor(y),
        None if off is None else torch.as_tensor(off),
    )
    assert len(got) == len(want) == (3 if with_offsets else 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL
        )


def test_offset_loglik_autograd_matches_reference():
    """Value and both gradients of the differentiable op, per chain, vs
    the reference's custom_vjp op under vmap (one batched kernel)."""
    xT, y, beta, off = _inputs(4, seed=7)
    ref_vg = jax.vmap(
        jax.value_and_grad(ref.logistic_offset_loglik, argnums=(0, 1)),
        in_axes=(0, 0, None, None),
    )
    rv, (rgb, rgo) = ref_vg(jnp.asarray(beta), jnp.asarray(off),
                            jnp.asarray(xT), jnp.asarray(y))
    b = torch.tensor(beta, requires_grad=True)
    o = torch.tensor(off, requires_grad=True)
    val = port.logistic_offset_loglik(b, o, torch.as_tensor(xT), torch.as_tensor(y))
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(rgb), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(rgo), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_loglik_single_chain_matches_reference():
    xT, y, beta, _ = _inputs(1, seed=9)
    rv, rg = jax.value_and_grad(ref.logistic_loglik)(
        jnp.asarray(beta[0]), jnp.asarray(xT), jnp.asarray(y)
    )
    b = torch.tensor(beta[0], requires_grad=True)
    val = port.logistic_loglik(b, torch.as_tensor(xT), torch.as_tensor(y))
    val.backward()
    assert val.shape == ()
    np.testing.assert_allclose(float(val.detach()), float(rv), rtol=VAL_RTOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [1, 127, 128, 3000, 1_000_000, 1_000_037])
def test_row_blocks_cover_rows_in_whole_subtiles(n):
    rows, nblk = port.row_blocks(n)
    assert rows % port.KERNEL_ROW_TILE == 0
    assert nblk * rows >= n > (nblk - 1) * rows
    assert nblk <= 256
