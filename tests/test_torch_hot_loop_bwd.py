"""The hot loop's backward in the port: the plain version of the backward
kernel (``_bwd_plain``) against the JAX package's interpret-mode Pallas
backward ``_bwd_pallas`` and its XLA backward ``_bwd_reference``, and the
``FusedBlockLL`` autograd Function against ``torch.autograd`` through
``_reference_impl``. The CUDA kernel itself is held against ``_bwd_plain`` on
the card by tests/test_torch_kernels.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.ops import hot_loop as jhl
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from torch_parity import assert_leaves_close

H1, HID = 8, 16

#: k x B grid (a single row, odd shapes, a batch past the 128-row Pallas
#: tile) and pixel counts off and past the 128-lane multiple
KB = [(1, 1), (3, 7), (13, 17), (10, 300)]
PIXELS = [12, 130]

#: per-output tolerance, relative to the output's largest magnitude.
#: Against the Pallas backward (the same rounding points): fp32 differs only
#: in summation order; in bf16 an operand within an fp32 rounding of a bf16
#: midpoint may round to the neighbouring bf16 value on one side only, a
#: change of one bf16 ulp (2^-8 relative) in that operand.
TOL_PALLAS = {None: 1e-5, "bfloat16": 2.0 ** -8}
#: Against the XLA backward and torch.autograd of the plain forward: those
#: round each operand's gradient at the casts instead of rounding the
#: cotangents dl, dy2, dy1 as matmul operands, a 2^-8 relative difference
#: per layer, three layers deep (measured worst 7.2e-3).
TOL_AUTODIFF = {None: 1e-5, "bfloat16": 2e-2}


def _inputs(k, b, d, seed=0):
    rs = np.random.RandomState(seed)
    args = [rs.randn(k, b, H1), rs.randn(H1, HID) * 0.2, rs.randn(HID) * 0.1,
            rs.randn(HID, HID) * 0.2, rs.randn(HID) * 0.1,
            rs.randn(HID, d) * 0.2, rs.randn(d) * 0.1, rs.rand(b, d) > 0.5,
            rs.randn(k, b)]
    return [np.asarray(a, np.float32) for a in args]


def _plain(args, cd):
    return thl._bwd_plain(*(torch.from_numpy(a) for a in args),
                          compute_dtype=torch.bfloat16 if cd else None)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("d", PIXELS)
@pytest.mark.parametrize("k,b", KB)
def test_bwd_plain_matches_interpret_pallas(k, b, d, cd):
    """All seven outputs against the Pallas backward in interpret mode, with
    the tiles the JAX tests use (tk = min(8, k), so k=13 has a ragged k
    tile; a 128-row partial batch tile past 128 rows)."""
    args = _inputs(k, b, d)
    tk, tb = min(8, k), (128 if b > 128 else b)
    want = jhl._bwd_pallas(*(jnp.asarray(a) for a in args), tk=tk, tb=tb,
                           interpret=True, compute_dtype=cd)
    got = _plain(args, cd)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert_leaves_close(got, [np.asarray(w) for w in want], TOL_PALLAS[cd],
                        what=f"k={k} B={b} D={d} {cd}")


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("k,b,d", [(3, 7, 130), (13, 17, 12)])
def test_bwd_plain_matches_jax_bwd_reference(k, b, d, cd):
    """All seven outputs against JAX's XLA backward of the same composition
    (the Pallas path's fallback)."""
    args = _inputs(k, b, d, seed=1)
    want = jhl._bwd_reference(*(jnp.asarray(a) for a in args), cd)
    assert_leaves_close(_plain(args, cd), [np.asarray(w) for w in want],
                        TOL_AUTODIFF[cd], what=f"k={k} B={b} D={d} {cd}")


@pytest.mark.parametrize("cd", [None, torch.bfloat16])
@pytest.mark.parametrize("k,b,d", [(3, 7, 12), (13, 17, 130)])
def test_fused_block_ll_gradients_reach_every_leaf(k, b, d, cd):
    """FusedBlockLL on CPU tensors (plain forward and backward, the wiring
    the card runs with the kernels): h1 and every weight and bias of the
    output block get the gradient torch.autograd gives through the plain
    forward; x gets none."""
    args = [torch.from_numpy(a) for a in _inputs(k, b, d, seed=2)]
    x, g = args[7], args[8]
    leaves = [a.clone().requires_grad_(True) for a in args[:7]]
    out = thl.FusedBlockLL.apply(*leaves, x, cd)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [a.clone().requires_grad_(True) for a in args[:7]]
    ref = thl._reference_impl(*ref_leaves, x, cd)
    want = torch.autograd.grad(ref, ref_leaves, g)
    torch.testing.assert_close(out, ref.detach(), rtol=0, atol=0)
    assert all(gr is not None and gr.abs().sum() > 0 for gr in got)
    assert_leaves_close(got, [w.numpy() for w in want],
                        TOL_AUTODIFF[None if cd is None else "bfloat16"],
                        what=f"k={k} B={b} D={d} {cd}")
    xg = x.clone().requires_grad_(True)
    thl.FusedBlockLL.apply(*leaves, xg, cd).sum().backward()
    assert xg.grad is None


def test_decoder_score_kernel_path_is_the_function(monkeypatch):
    """On the kernel path decoder_score goes through FusedBlockLL, so a
    backward through it runs the backward wrapper: forced here on the CPU,
    where both wrappers compute their plain versions."""
    args = [torch.from_numpy(a) for a in _inputs(3, 5, 12, seed=3)]
    leaves = [a.clone().requires_grad_(True) for a in args[:7]]
    calls = []
    real = thl.fused_backward
    monkeypatch.setattr(thl, "select_path",
                        lambda dev, force=None, widths=None, shape=None:
                        "kernel")
    monkeypatch.setattr(thl, "fused_backward",
                        lambda *a: calls.append(1) or real(*a))
    out_params = {"l1": {"w": leaves[1], "b": leaves[2]},
                  "l2": {"w": leaves[3], "b": leaves[4]},
                  "out": {"w": leaves[5], "b": leaves[6]}}
    score = thl.decoder_score(out_params, args[7], leaves[0])
    assert score.grad_fn is not None and \
        type(score.grad_fn).__name__.startswith("FusedBlockLL")
    score.sum().backward()
    assert calls == [1]
    assert all(p.grad is not None for p in leaves)


def test_backward_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the backward wrapper computes its plain version and
    counts no launch."""
    args = [torch.from_numpy(a) for a in _inputs(3, 5, 12)]
    thl.reset_launch_counts()
    got = thl.fused_backward(*args)
    want = thl._bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert thl.launch_counts() == {thl.KERNEL: 0, thl.KERNEL_BWD: 0}
    with pytest.raises(ValueError, match="compute_dtype"):
        thl.fused_backward(*args, compute_dtype=torch.float16)
