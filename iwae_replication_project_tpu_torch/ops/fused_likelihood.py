"""The fused decoder-head Bernoulli log-likelihood (port of
``ops/fused_likelihood.py``).

    out[k, b] = sum_d x[b, d] * l[k, b, d] - softplus(l[k, b, d]),
    l = h1 @ W + bias

with the ``[k, B, D]`` logits never in device memory. It fuses only the
decoder's last layer: the k-only predecessor of the hot loop
(:mod:`.hot_loop`), which fuses the whole output block. No model path calls
it; :func:`fused_bernoulli_ll` is its entry point, forward and backward.

* forward: :func:`fused_ll_forward`, which launches ``csrc/fused_ll_fwd.cu``
  (replaces the TPU kernel ``_fwd_kernel``/``_fwd_pallas``,
  fused_likelihood.py:206-239 of the JAX package) for CUDA tensors;
* backward: :func:`fused_ll_backward`, which launches ``csrc/fused_ll_bwd.cu``
  (replaces ``_bwd_kernel``/``_bwd_pallas``, :242-300): dh, and dW and db
  summed deterministically over fixed row splits;
* both run every product on the tensor cores in 3xTF32 (``csrc/tc_tf32.cuh``:
  each fp32 operand split into two TF32 parts, three products), which keeps
  fp32 accuracy;
* :class:`FusedBernoulliLL` joins them as the custom VJP's twin
  (:310-349), with no gradient for the binary targets.

Each wrapper launches its kernel for CUDA tensors or raises, and computes
its plain version (:func:`_reference_impl`, :func:`_bwd_plain`) only for CPU
tensors. There is no fall back: the JAX VJP swaps in its XLA backward when
the VMEM estimate says no tile fits, while these kernels stream W and take
every shape whose row tile fits a CTA's shared memory. The TPU's VMEM gate
(``fits_vmem``, ``kernel_usable``, ``IWAE_FUSED_VMEM_BUDGET``) has no
counterpart. The kernels take fp32 inputs only, which is what every JAX
caller passes. Launches are counted per kernel (:func:`launch_counts`).
"""

from __future__ import annotations

import torch

from iwae_replication_project_tpu_torch.ops.distributions import softplus
from iwae_replication_project_tpu_torch.ops import _kernels

#: the kernels this module launches (``csrc/fused_ll_fwd.cu``,
#: ``csrc/fused_ll_bwd.cu``)
KERNEL_FWD = "fused_ll_fwd"
KERNEL_BWD = "fused_ll_bwd"


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last :func:`reset_launch_counts`."""
    return _kernels.launch_counts((KERNEL_FWD, KERNEL_BWD))


def reset_launch_counts() -> None:
    _kernels.reset_launch_counts((KERNEL_FWD, KERNEL_BWD))


# --------------------------------------------------------------------------
# The plain versions
# --------------------------------------------------------------------------

def _reference_impl(h1, w, bias, x):
    """Unfused composition (twin of the JAX ``_reference_impl`` :303-307):
    the parity oracle and the forward kernel's plain version."""
    logits = torch.einsum("kbh,hd->kbd", h1, w) + bias
    return torch.sum(x[None] * logits - softplus(logits), dim=-1)


def _bwd_plain(h1, w, bias, x, g):
    """The backward kernel's plain version (twin of ``_bwd_reference``
    :326-333): ``(dh [k, B, H], dW [H, D], db [D])`` for cotangent `g`."""
    logits = torch.einsum("kbh,hd->kbd", h1, w) + bias
    dlogits = g[..., None] * (x[None] - torch.sigmoid(logits))
    dh = torch.einsum("kbd,hd->kbh", dlogits, w)
    dw = torch.einsum("kbh,kbd->hd", h1, dlogits)
    return dh, dw, torch.sum(dlogits, dim=(0, 1))


# --------------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------------

def _check_fp32(**tensors) -> None:
    """The CPU branch's dtype check (the CUDA branch's is
    :func:`_kernels.check_tensor`): the plain versions take what the kernels
    take."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _check_inputs(h1, w, bias, x, g=None) -> tuple:
    """Validate the kernels' inputs; returns ``(k, B, H, D)``."""
    if h1.device.type != "cuda":
        raise ValueError(f"unsupported device {h1.device}")
    if h1.dim() != 3 or w.dim() != 2:
        raise ValueError(f"h1 must be [k, B, H] and w [H, D], got "
                         f"{tuple(h1.shape)} and {tuple(w.shape)}")
    k, b, h = h1.shape
    d = w.shape[1]
    checks = [("h1", h1, (k, b, h)), ("w", w, (h, d)), ("bias", bias, (d,)),
              ("x", x, (b, d))]
    if g is not None:
        checks.append(("g", g, (k, b)))
    for name, t, shape in checks:
        _kernels.check_tensor(name, t, shape, h1.device)
    return k, b, h, d


def fused_ll_forward(h1, w, bias, x) -> torch.Tensor:
    """``log p(x | h1)`` of the decoder's last layer summed over pixels,
    ``[k, B]``.

    On CUDA tensors this launches ``csrc/fused_ll_fwd.cu`` on the current
    stream (no synchronisation) and counts one launch: the weight prep (fp32
    tiles into a scratch buffer whose size the library states) and the row
    kernel. It raises for anything the kernel does not take. On CPU tensors
    it computes the plain version :func:`_reference_impl`. Either way the
    inputs must be fp32.
    """
    if h1.device.type == "cpu":
        _check_fp32(h1=h1, w=w, bias=bias, x=x)
        with _kernels.plain_region(KERNEL_FWD):
            return _reference_impl(h1, w, bias, x)
    k, b, h, d = _check_inputs(h1, w, bias, x)
    dev = h1.device
    if k * b == 0:
        return torch.zeros((k, b), dtype=torch.float32, device=dev)
    launch, scratch_bytes = _kernels.plan(KERNEL_FWD, (h,), (h, d))
    out = torch.empty((k, b), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    rc = _kernels.launch(dev, launch, h1.data_ptr(), w.data_ptr(),
                         bias.data_ptr(), x.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), k * b, b, h, d)
    if rc != 0:
        raise RuntimeError(f"fused_ll_fwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H={h}, D={d})")
    _kernels.count(KERNEL_FWD)
    return out


def fused_ll_backward(h1, w, bias, x, g) -> tuple:
    """The gradients of :func:`fused_ll_forward` for the ``[k, B]``
    cotangent `g`: ``(dh [k, B, H], dW [H, D], db [D])``.

    On CUDA tensors this launches ``csrc/fused_ll_bwd.cu`` on the current
    stream and counts one launch: the weight prep, the row phase, the
    weight-gradient phase over row splits fixed by the row count and the
    fixed-order sum of the splits, all in a scratch buffer whose size the
    library states; dW and db are views of one contiguous buffer. It
    raises for anything the kernel does not take. On CPU tensors it computes
    the plain version :func:`_bwd_plain`. Either way the inputs must be
    fp32.
    """
    if h1.device.type == "cpu":
        _check_fp32(h1=h1, w=w, bias=bias, x=x, g=g)
        with _kernels.plain_region(KERNEL_BWD):
            return _bwd_plain(h1, w, bias, x, g)
    k, b, h, d = _check_inputs(h1, w, bias, x, g)
    dev = h1.device
    if k * b == 0:
        return (torch.zeros_like(h1),
                torch.zeros((h, d), dtype=torch.float32, device=dev),
                torch.zeros((d,), dtype=torch.float32, device=dev))
    rows = k * b
    launch, scratch_bytes = _kernels.plan(KERNEL_BWD, (h,), (rows, h, d))
    dh = torch.empty_like(h1)
    grads = torch.empty(h * d + d, dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    rc = _kernels.launch(dev, launch, h1.data_ptr(), w.data_ptr(),
                         bias.data_ptr(), x.data_ptr(), g.data_ptr(),
                         dh.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
                         rows, b, h, d)
    if rc != 0:
        raise RuntimeError(f"fused_ll_bwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H={h}, D={d})")
    _kernels.count(KERNEL_BWD)
    return dh, grads[:h * d].view(h, d), grads[h * d:]


class FusedBernoulliLL(torch.autograd.Function):
    """``log p(x | h1)`` of the decoder's last layer with a kernel on both
    sides: forward :func:`fused_ll_forward` (B3), backward
    :func:`fused_ll_backward` (B4); the twin of the JAX custom VJP
    ``fused_bernoulli_ll``/``_fused_fwd``/``_fused_bwd``. The binary targets
    `x` get no gradient. On CPU tensors both sides compute their plain
    versions, so the CPU tests drive the wiring the card runs."""

    @staticmethod
    def forward(ctx, h1, w, bias, x):
        ctx.save_for_backward(h1, w, bias, x)
        return fused_ll_forward(h1, w, bias, x)

    @staticmethod
    def backward(ctx, g):
        dh, dw, db = fused_ll_backward(*ctx.saved_tensors, g.contiguous())
        return dh, dw, db, None


def fused_bernoulli_ll(h1: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """``log p(x | h1)`` summed over pixels, ``[k, B]``, logits never in
    device memory (JAX :310-318).

    Args: ``h1 [k, B, H]`` post-tanh decoder activations; ``w [H, D]``,
    ``bias [D]`` the decoder output layer; ``x [B, D]`` binary targets. All
    fp32; differentiable in `h1`, `w` and `bias`.
    """
    return FusedBernoulliLL.apply(h1.contiguous(), w.contiguous(),
                                  bias.contiguous(), x.contiguous())
