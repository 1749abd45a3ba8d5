"""Port of the grouped hierarchical kernel (B1) against the JAX package.

The host-side layout must be bit-identical to the reference's; the
plain PyTorch version of B1 must match the reference's Pallas kernel
(`_grouped_call`, run in interpret mode on the CPU as the reference's
own tests run it) within the reference's tolerances: value rtol 2e-5,
gradients rtol 2e-4 / atol 1e-4 (tests/test_hier_fused.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.ops import hier_fused as ref
from stark_tpu_torch.ops import hier_fused as port

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4


def _groupings():
    rs = np.random.RandomState(0)
    return {
        "uniform_50": (np.sort(rs.randint(0, 50, size=10_000)), 8),
        "dense_50_rows": (np.sort(np.arange(40_000) // 50), 63),
        "flagship_like": (np.sort(rs.randint(0, 1000, size=200_000)), 32),
        # one row per group: every tile spans > K_LOC_MAX groups -> None
        "defeats_layout": (np.arange(5_000), 4),
    }


@pytest.mark.parametrize("cap", [None, "256"])
@pytest.mark.parametrize("name", list(_groupings()))
def test_grouped_layout_bit_identical(name, cap, monkeypatch):
    if cap is None:
        monkeypatch.delenv("STARK_GROUPED_LANE_TILE", raising=False)
    else:
        monkeypatch.setenv("STARK_GROUPED_LANE_TILE", cap)
    g, d = _groupings()[name]
    want = ref.grouped_layout(g, d)
    got = port.grouped_layout(g, d)
    if want is None:
        assert got is None
        return
    assert got is not None
    assert got[0] == want[0] and got[1] == want[1]  # lane_tile, k_loc
    for a, b in zip(got[2:], want[2:]):  # first_gid, gl
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _data(n=3000, d=5, groups=20, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "x": rs.standard_normal((n, d)).astype(np.float32),
        "y": (rs.rand(n) < 0.4).astype(np.float32),
        "g": rs.randint(0, groups, size=n).astype(np.int32),
    }


def test_prepare_grouped_bit_identical():
    data = _data()
    want = ref.prepare_grouped(data, 5)
    got = port.prepare_grouped(data, 5)
    assert got["k_loc"] == want["k_loc"].shape[0]
    assert got["lane_tile"] == 128 * want["lt128"].shape[0]
    for k in ("xT", "y", "g", "gl", "first_gid"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _params(c, d, groups, seed):
    rs = np.random.RandomState(seed)
    beta = (0.5 * rs.standard_normal((c, d))).astype(np.float32)
    alpha = rs.standard_normal((c, groups)).astype(np.float32)
    return beta, alpha


@pytest.mark.parametrize("cap", [None, "256"])
@pytest.mark.parametrize("chains", [1, 5, 16])
def test_plain_b1_matches_reference_kernel(chains, cap, monkeypatch):
    """N=3000 leaves a ragged last tile at both lane tiles (8192, 256)."""
    if cap is None:
        monkeypatch.delenv("STARK_GROUPED_LANE_TILE", raising=False)
    else:
        monkeypatch.setenv("STARK_GROUPED_LANE_TILE", cap)
    d, groups = 5, 20
    prep = port.prepare_grouped(_data(d=d, groups=groups), d)
    beta, alpha = _params(chains, d, groups, seed=chains)
    want = ref._grouped_call(
        jnp.asarray(beta), jnp.asarray(alpha), jnp.asarray(prep["xT"]),
        jnp.asarray(prep["y"]), jnp.asarray(prep["gl"]),
        jnp.asarray(prep["first_gid"]), k_loc=prep["k_loc"],
        lane_tile=prep["lane_tile"], interpret=None,
    )
    t = {k: torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")}
    got = port.hier_grouped(
        torch.as_tensor(beta), torch.as_tensor(alpha), t["xT"], t["y"],
        t["gl"], t["first_gid"], prep["lane_tile"],
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL
        )


def test_autograd_backward_is_cotangent_times_forward_grads():
    d, groups, c = 5, 20, 4
    prep = port.prepare_grouped(_data(d=d, groups=groups), d)
    t = {k: torch.as_tensor(prep[k]) for k in ("xT", "y", "gl", "first_gid")}
    beta_np, alpha_np = _params(c, d, groups, seed=3)
    beta = torch.tensor(beta_np, requires_grad=True)
    alpha = torch.tensor(alpha_np, requires_grad=True)
    args = (t["xT"], t["y"], t["gl"], t["first_gid"], prep["lane_tile"])
    val = port.hier_logistic_loglik(beta, alpha, *args)
    ct = torch.tensor([1.0, -2.0, 0.5, 3.0])
    val.backward(ct)
    v, gb, ga = port.hier_grouped(beta.detach(), alpha.detach(), *args)
    torch.testing.assert_close(val.detach(), v, rtol=0, atol=0)
    torch.testing.assert_close(beta.grad, ct[:, None] * gb, rtol=0, atol=0)
    torch.testing.assert_close(alpha.grad, ct[:, None] * ga, rtol=0, atol=0)
    # the single-chain form is the C=1 batch
    one = port.hier_logistic_loglik(beta.detach()[0], alpha.detach()[0], *args)
    assert one.shape == () and float(one) == float(v[0])


def test_kernel_wrapper_refuses_other_devices():
    """Only a CPU tensor takes the plain version; anything that is not
    CPU or CUDA is refused rather than computed somewhere else."""
    beta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.hier_grouped(beta, beta, beta, beta, beta, beta, 256)
