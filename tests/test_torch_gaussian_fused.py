"""Port of the fused likelihood passes' gaussian link (kernel B2) and of
the single-chain kernel (B3), against the JAX package.

The plain PyTorch versions must match the reference's Pallas kernels
(`_batched_call`, `_fused_call`, interpret mode on the CPU as the
reference's own tests run them) for both links, with and without row
offsets, within the reference's tolerances: value rtol 2e-5, gradients
and residuals rtol 2e-4 / atol 1e-4.  The differentiable ops must give
the reference's values and gradients, route one chain to B3 and a chain
batch to B2, and their backward must be the cotangent times the
gradients the forward pass computed, with sigma's gradient that of the
plain Normal log-density.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.ops import logistic_fused as ref
from stark_tpu_torch.model import normal_logpdf
from stark_tpu_torch.ops import logistic_fused as port

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
LINKS = ["bernoulli_logit", "gaussian"]


def _inputs(c, link, n=3000, d=5, seed=0):
    rs = np.random.RandomState(seed)
    xT = rs.standard_normal((d, n)).astype(np.float32)
    if link == "gaussian":
        y = (1.0 + 2.0 * rs.standard_normal(n)).astype(np.float32)
    else:
        y = (rs.rand(n) < 0.4).astype(np.float32)
    beta = (0.5 * rs.standard_normal((c, d))).astype(np.float32)
    off = rs.standard_normal((c, n)).astype(np.float32)
    return xT, y, beta, off


def _assert_outputs(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=VAL_RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("chains", [1, 5, 16])
def test_plain_b2_gaussian_matches_reference_kernel(chains, with_offsets):
    xT, y, beta, off = _inputs(chains, "gaussian", seed=chains)
    off = off if with_offsets else None
    want = ref._batched_call(
        jnp.asarray(beta), jnp.asarray(xT), jnp.asarray(y),
        None if off is None else jnp.asarray(off),
        lane_tile=None, interpret=None, link="gaussian",
    )
    got = port.logistic_batched(
        torch.as_tensor(beta), torch.as_tensor(xT), torch.as_tensor(y),
        None if off is None else torch.as_tensor(off), link="gaussian",
    )
    _assert_outputs([t.numpy() for t in got], want)


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("n,d", [(3000, 5), (8191, 37)])
def test_plain_b3_matches_reference_kernel(n, d, link, with_offsets):
    """N=3000 and 8191 leave ragged last tiles; D=37 is past one
    32-feature register chunk of the CUDA kernel."""
    xT, y, beta, off = _inputs(1, link, n=n, d=d, seed=d)
    off = off[0] if with_offsets else None
    want = ref._fused_call(
        jnp.asarray(beta[0]), jnp.asarray(xT), jnp.asarray(y),
        None if off is None else jnp.asarray(off),
        lane_tile=None, interpret=None, link=link,
    )
    got = port.logistic_single(
        torch.as_tensor(beta[0]), torch.as_tensor(xT), torch.as_tensor(y),
        None if off is None else torch.as_tensor(off), link,
    )
    assert got[0].shape == () and got[1].shape == (d,)
    _assert_outputs([t.numpy() for t in got], want)


def test_public_single_chain_op_matches_reference():
    xT, y, beta, _ = _inputs(1, "bernoulli_logit", seed=11)
    want = ref.logistic_loglik_value_and_grad(
        jnp.asarray(beta[0]), jnp.asarray(xT), jnp.asarray(y)
    )
    got = port.logistic_loglik_value_and_grad(
        torch.as_tensor(beta[0]), torch.as_tensor(xT), torch.as_tensor(y)
    )
    _assert_outputs([t.numpy() for t in got], want)


def test_one_chain_goes_to_b3_and_a_batch_to_b2(monkeypatch):
    """The reference's custom_vmap routing: an un-batched call is the
    single-chain kernel, a chain-batched call the batched one."""
    calls = []
    for name in ("logistic_single", "logistic_batched"):
        fn = getattr(port, name)
        monkeypatch.setattr(
            port, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k)
        )
    xT, y, beta, off = (torch.as_tensor(a) for a in _inputs(3, "gaussian", seed=2))
    sigma = torch.tensor([0.7, 1.1, 0.9])
    port.gaussian_offset_loglik(beta[0], off[0], xT, y, sigma[0])
    port.gaussian_loglik(beta[0], xT, y, sigma[0])
    port.logistic_loglik(beta[0], xT, y)
    port.logistic_offset_loglik(beta[0], off[0], xT, y)
    assert calls == ["logistic_single"] * 4
    calls.clear()
    port.gaussian_offset_loglik(beta, off, xT, y, sigma)
    port.gaussian_loglik(beta, xT, y, sigma)
    port.logistic_loglik(beta, xT, y)
    port.logistic_offset_loglik(beta, off, xT, y)
    assert calls == ["logistic_batched"] * 4


@pytest.mark.parametrize("with_offsets", [False, True])
def test_gaussian_ops_match_reference_under_vmap(with_offsets):
    """Values and every gradient per chain against the reference's
    custom_vjp ops under vmap (one batched kernel pass)."""
    xT, y, beta, off = _inputs(4, "gaussian", seed=7)
    sigma = np.asarray([0.6, 0.9, 1.3, 2.0], np.float32)
    if with_offsets:
        fn = lambda b, o, s: ref.gaussian_offset_loglik(b, o, jnp.asarray(xT), jnp.asarray(y), s)
        args = (beta, off, sigma)
    else:
        fn = lambda b, s: ref.gaussian_loglik(b, jnp.asarray(xT), jnp.asarray(y), s)
        args = (beta, sigma)
    rv, rg = jax.vmap(jax.value_and_grad(fn, argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a) for a in args)
    )
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    xt, yt = torch.as_tensor(xT), torch.as_tensor(y)
    if with_offsets:
        val = port.gaussian_offset_loglik(leaves[0], leaves[1], xt, yt, leaves[2])
    else:
        val = port.gaussian_loglik(leaves[0], xt, yt, leaves[1])
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(rv), rtol=VAL_RTOL)
    for leaf, want in zip(leaves, rg):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("with_offsets", [False, True])
def test_gaussian_backward_is_cotangent_times_forward_grads(with_offsets, single):
    xT, y, beta, off = (torch.as_tensor(a) for a in _inputs(3, "gaussian", seed=4))
    sigma = torch.tensor([0.8, 1.2, 1.7])
    ct = torch.tensor([1.0, -2.0, 0.5])
    if single:
        beta, off, sigma, ct = beta[0], off[0], sigma[0], ct[0]
    b = beta.clone().requires_grad_(True)
    o = off.clone().requires_grad_(True)
    s = sigma.clone().requires_grad_(True)
    if with_offsets:
        val = port.gaussian_offset_loglik(b, o, xT, y, s)
        outs = port._pass(beta, xT, y, off, "gaussian")
    else:
        val = port.gaussian_loglik(b, xT, y, s)
        outs = port._pass(beta, xT, y, None, "gaussian")
    val.backward(ct)
    ssr, xresid = outs[0], outs[1]
    n = y.shape[0]
    inv2 = 1.0 / (sigma * sigma)
    scale = (ct * inv2)[..., None]
    torch.testing.assert_close(
        val.detach(), -0.5 * ssr * inv2 - n * torch.log(sigma) - 0.5 * n * port._LOG_2PI,
        rtol=1e-6, atol=0,
    )
    torch.testing.assert_close(b.grad, scale * xresid, rtol=0, atol=0)
    if with_offsets:
        torch.testing.assert_close(o.grad, scale * outs[2], rtol=0, atol=0)
    # sigma: against autograd of the plain Normal log-density on the rows
    s2 = sigma.clone().requires_grad_(True)
    mu = beta @ xT + (off if with_offsets else 0.0)
    scale_ = s2[..., None] if not single else s2
    (normal_logpdf(y, mu, scale_).sum(-1) * ct).sum().backward()
    torch.testing.assert_close(s.grad, s2.grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_wrappers_refuse_unknown_links_and_batched_single_calls():
    xT, y, beta, _ = (torch.as_tensor(a) for a in _inputs(2, "gaussian"))
    with pytest.raises(ValueError, match="unknown link"):
        port.logistic_batched(beta, xT, y, link="poisson")
    with pytest.raises(ValueError, match="one chain"):
        port.logistic_single(beta, xT, y)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.logistic_single(torch.zeros(3, device="meta"), xT, y)
