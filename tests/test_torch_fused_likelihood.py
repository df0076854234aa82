"""The port's fused Bernoulli log-likelihood (``ops/fused_likelihood.py``)
against the JAX package's op in interpret mode: the forward, the VJP in h1,
w and bias, and the plain backward against interpret-mode ``_bwd_pallas``.
On the CPU the op's wrappers compute their plain versions; the CUDA kernels
themselves are held against those on the card by tests/test_torch_kernels.py
and chip_smoke.py.

Tolerances: both sides run the same fp32 arithmetic in another summation
order (H products per logit, D pixel terms per row; the Pallas kernel pads
pixels to a multiple of 128 and k to the slab of 8 with zeros). The JAX
package's own tests hold its kernel to its reference at rtol 1e-5 and atol
1e-5 to 1e-4 for the values and rtol 1e-4 for the gradients; the port is held
to the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.ops import fused_likelihood as jfl
from iwae_replication_project_tpu.ops.logsumexp import logmeanexp as jlme
from iwae_replication_project_tpu_torch.ops import fused_likelihood as tfl
from iwae_replication_project_tpu_torch.ops.logsumexp import logmeanexp

VALUE_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _problem(k, b, h, d, seed, w_scale=0.2):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(k, b, h), rs.randn(h, d) * w_scale,
              rs.randn(d) * 0.1, rs.rand(b, d) > 0.5]
    return [np.asarray(a, np.float32) for a in arrays]


def _both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _grads(fn, t):
    leaves = [a.clone().requires_grad_(True) for a in t[:3]]
    return torch.autograd.grad(fn(*leaves, t[3]), leaves)


@pytest.mark.parametrize("k,b,h,d,seed,power", [(5, 6, 16, 12, 0, 2),
                                                (3, 4, 8, 1024, 2, 1)])
def test_forward_and_vjp_match_jax(k, b, h, d, seed, power):
    """The JAX tests' problems: (5, 6, 16, 12) with the gradients of
    ``sum(out ** 2)``, and a pixel count past one 128-lane pad block
    (D=1024) with those of ``sum(out)``; the value and the gradients in h1,
    w and bias."""
    t, j = _both(_problem(k, b, h, d, seed, w_scale=0.2 if d < 1024 else 0.1))
    got = tfl.fused_bernoulli_ll(*t)
    want = jfl.fused_bernoulli_ll(*j, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfl._reference_impl(*j)),
                               **VALUE_TOL)
    tg = _grads(lambda *a: torch.sum(tfl.fused_bernoulli_ll(*a) ** power), t)
    jg = jax.grad(lambda a, w, bb: jnp.sum(
        jfl.fused_bernoulli_ll(a, w, bb, j[3], True) ** power),
        argnums=(0, 1, 2))(*j[:3])
    for name, a, w in zip(("dh1", "dw", "dbias"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("k", (1, 3, 7, 17))
@pytest.mark.parametrize("b", (1, 3, 7, 17))
def test_odd_shapes_value_and_bound_gradient(k, b):
    """Every odd k and batch at D=130 (one 128-lane block and a ragged
    tail): the value, and the bound ``mean(logmeanexp(out))`` with its
    gradient in w, against the JAX op in interpret mode (JAX's
    ``test_masked_tiles_odd_shapes_fwd_bwd``)."""
    t, j = _both(_problem(k, b, 16, 130, k * 100 + b))
    np.testing.assert_allclose(tfl.fused_bernoulli_ll(*t).numpy(),
                               np.asarray(jfl.fused_bernoulli_ll(*j, True)),
                               **VALUE_TOL)

    def bound_t(w):
        return torch.mean(logmeanexp(tfl.fused_bernoulli_ll(t[0], w, t[2],
                                                            t[3])))

    def bound_j(w):
        return jnp.mean(jlme(jfl.fused_bernoulli_ll(j[0], w, j[2], j[3],
                                                    True), axis=0))

    w = t[1].clone().requires_grad_(True)
    val = bound_t(w)
    (gw,) = torch.autograd.grad(val, [w])
    np.testing.assert_allclose(float(val.detach()), float(bound_j(j[1])),
                               rtol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jax.grad(bound_j)(j[1])),
                               **GRAD_TOL)


@pytest.mark.parametrize("k,b,d", [(5, 6, 12), (13, 17, 130), (3, 4, 1024)])
def test_bwd_plain_matches_interpret_pallas(k, b, d):
    """dh, dW and db of the plain backward for a given cotangent g against
    the Pallas backward in interpret mode (K padded to the slab of 8, pixels
    to a multiple of 128, whose padding must add nothing)."""
    arrays = _problem(k, b, 16, d, seed=k + b + d)
    g = np.random.RandomState(1).randn(k, b).astype(np.float32)
    t, j = _both(arrays + [g])
    got = tfl._bwd_plain(*t)
    want = jfl._bwd_pallas(*j, interpret=True)
    for name, a, w in zip(("dh", "dW", "db"), got, want):
        assert tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors both wrappers compute their plain versions and count
    no launch; the op takes fp32 only, on every device."""
    t, _ = _both(_problem(3, 5, 8, 12, seed=3))
    g = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    tfl.reset_launch_counts()
    assert torch.equal(tfl.fused_ll_forward(*t), tfl._reference_impl(*t))
    assert all(torch.equal(a, w) for a, w in
               zip(tfl.fused_ll_backward(*t, g), tfl._bwd_plain(*t, g)))
    assert tfl.launch_counts() == {tfl.KERNEL_FWD: 0, tfl.KERNEL_BWD: 0}
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="float32"):
            tfl.fused_bernoulli_ll(t[0].to(dtype), *t[1:])
        with pytest.raises(TypeError, match="float32"):
            tfl.fused_ll_backward(*t, g.to(dtype))


def test_autograd_function_gives_no_gradient_for_x():
    """FusedBernoulliLL returns the plain autograd gradients for h1, w and
    bias through the backward wrapper, and none for the targets."""
    t, _ = _both(_problem(4, 3, 8, 20, seed=4))
    leaves = [a.clone().requires_grad_(True) for a in t[:3]]
    x = t[3].clone().requires_grad_(True)
    g = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    out = tfl.FusedBernoulliLL.apply(*leaves, x)
    got = torch.autograd.grad(out, leaves + [x], g, allow_unused=True)
    assert got[3] is None
    ref = [a.clone().requires_grad_(True) for a in t[:3]]
    want = torch.autograd.grad(tfl._reference_impl(*ref, t[3]), ref, g)
    for a, w in zip(got[:3], want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **GRAD_TOL)
