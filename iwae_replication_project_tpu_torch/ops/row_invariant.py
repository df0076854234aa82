"""Row-invariant dense layers and sums for the serving programs.

The JAX serving programs give a row bitwise the same result in every bucket
(JAX ``serving/programs.py:1-11``). On the card two kinds of op broke that:
cuBLAS picks its algorithm per problem shape (another K order, split-K, a
GEMV for one row), and ``torch.sum``'s reduction sizes its thread blocks by
the number of outputs. The serving programs therefore run their dense
layers and their sums over samples, latents and pixels through two kernels
of the port's own, whose per-output arithmetic depends on nothing but that
output's inputs:

* :func:`dense` -- ``csrc/row_dense.cu``: ``act(x W + b)``, fp32 or
  bf16-rounded operands, each output one fixed-order chain over K;
* :func:`fixed_sum` -- ``csrc/row_sum.cu``: a sum over one axis, each
  output added in index order by one thread.

They are not ports of TPU kernels (the XLA programs need no such care). The
choice to use them is the dispatcher's: ``ops/hot_loop.serving_dispatch_
config`` sets ``ModelConfig.row_invariant`` for serving on CUDA, and
``models/`` and ``ops/logsumexp.py`` route on that flag. Training and
evaluation keep cuBLAS and ``torch.sum``: their shapes are fixed per step or
chunk. Each wrapper launches its kernel for CUDA tensors (or raises) and
computes its plain version only for CPU tensors; neither kernel has a
backward, so a CUDA call that autograd would record raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.ops import _kernels

#: the kernels this module launches
KERNEL_DENSE = "row_dense"
KERNEL_SUM = "row_sum"
KERNELS = (KERNEL_DENSE, KERNEL_SUM)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last :func:`reset_launch_counts`."""
    return _kernels.launch_counts(KERNELS)


def reset_launch_counts() -> None:
    _kernels.reset_launch_counts(KERNELS)


def dense_plain(x, w, b, compute_dtype=None, tanh: bool = False):
    """The dense layer's plain composition (``models.mlp.dense_apply``'s, and
    the hot loop's reference): bf16-rounded operands multiplied in fp32
    (JAX's ``jnp.dot`` on bf16 operands with fp32 accumulation), the bias
    added, then tanh."""
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    y = torch.matmul(x, w) + b
    return torch.tanh(y) if tanh else y


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the row-invariant kernels have no backward: they "
                           "serve inference only (the training paths keep "
                           "row_invariant=False)")


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None,
          tanh: bool = False) -> torch.Tensor:
    """``act(x @ w + b)`` over the last axis of `x` (``[..., K]``), `w`
    ``[K, N]``, `b` ``[N]`` -> ``[..., N]``; ``compute_dtype=torch.bfloat16``
    rounds both operands to bf16 first, ``tanh`` applies tanh.

    On CUDA tensors this launches ``csrc/row_dense.cu`` on the current
    stream and counts one launch; it raises for anything the kernel does
    not take. On CPU tensors it computes the plain version."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got "
                         f"{compute_dtype!r}")
    if x.device.type == "cpu":
        return dense_plain(x, w, b, compute_dtype, tanh)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_no_grad(x, w, b)
    if x.dim() < 1 or w.dim() != 2:
        raise ValueError(f"dense needs x [..., K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k, n = w.shape
    dev = x.device
    _kernels.check_tensor("x", x, tuple(x.shape[:-1]) + (k,), dev)
    _kernels.check_tensor("w", w, (k, n), dev)
    _kernels.check_tensor("b", b, (n,), dev)
    m = math.prod(x.shape[:-1])
    y = torch.empty(tuple(x.shape[:-1]) + (n,), dtype=torch.float32,
                    device=dev)
    if m == 0:
        return y
    fn = _kernels.load(KERNEL_DENSE).row_dense
    rc = _kernels.launch(dev, fn, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         y.data_ptr(), m, k, n,
                         int(compute_dtype == torch.bfloat16), int(tanh))
    if rc != 0:
        raise RuntimeError(f"row_dense launch failed with CUDA error {rc} "
                           f"(M={m}, K={k}, N={n})")
    _kernels.count(KERNEL_DENSE)
    return y


def sum_over(x: torch.Tensor, dim: int, fixed_order: bool) -> torch.Tensor:
    """The sum over `dim`: :func:`fixed_sum` when ``fixed_order`` (the
    serving programs on CUDA), else ``torch.sum``."""
    return fixed_sum(x, dim) if fixed_order else torch.sum(x, dim=dim)


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.sum(x, dim)`` with every output summed in index order by one
    thread: on CUDA tensors this launches ``csrc/row_sum.cu`` on the current
    stream and counts one launch (it raises for anything the kernel does not
    take); on CPU tensors it is ``torch.sum``."""
    if x.device.type == "cpu":
        return torch.sum(x, dim=dim)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_no_grad(x)
    if x.dim() == 0:
        raise ValueError("fixed_sum needs at least one axis")
    d = dim % x.dim()
    shape = tuple(x.shape)
    _kernels.check_tensor("x", x, shape, x.device)
    outer, r, inner = (math.prod(shape[:d]), shape[d],
                       math.prod(shape[d + 1:]))
    y = torch.empty(shape[:d] + shape[d + 1:], dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    if r == 0:
        return y.zero_()
    fn = _kernels.load(KERNEL_SUM).row_sum
    rc = _kernels.launch(x.device, fn, x.data_ptr(), y.data_ptr(), outer, r,
                         inner)
    if rc != 0:
        raise RuntimeError(f"row_sum launch failed with CUDA error {rc} "
                           f"(outer={outer}, R={r}, inner={inner})")
    _kernels.count(KERNEL_SUM)
    return y
