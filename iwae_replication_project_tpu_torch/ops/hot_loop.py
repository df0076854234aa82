"""The K-sample hot loop: the decoder output block fused with the Bernoulli
log-likelihood (port of ``ops/hot_loop.py``).

For the 2-layer flagship the decoder output block ``h1 @ W1 -> tanh -> @ W2
-> tanh -> @ W3 -> Bernoulli -> sum over pixels`` holds ~77% of the k-scaled
matmul MACs and most of the activation bytes. Two implementations of that
one function, selected per call:

* ``kernel`` -- :class:`FusedBlockLL`, whose forward is the hand-written
  CUDA kernel ``csrc/hot_loop_fwd.cu`` (replaces the TPU kernel
  ``_fwd_kernel``/``_fwd_pallas``, hot_loop.py:633-695 of the JAX package)
  and whose backward is ``csrc/hot_loop_bwd.cu`` (replaces ``_bwd_kernel``/
  ``_bwd_pallas``, :698-792), taken for CUDA tensors;
* ``reference`` -- the plain PyTorch composition :func:`_reference_impl`,
  the twin of the JAX ``_reference_impl`` (:810-821), differentiated by plain
  autograd, taken for CPU tensors or under an explicit ``"reference"`` pin.

:func:`fused_forward` and :func:`fused_backward` are the kernels' wrappers:
each launches its kernel for CUDA tensors (or raises) and uses its plain
version (:func:`_reference_impl`, :func:`_bwd_plain`) only for CPU tensors.
There is no fall back from the card to a plain version: the backward kernel
streams its weights and takes every shape the forward takes, unlike the JAX
custom VJP, which falls back to the XLA backward when no VMEM tile fits.

Selection is recorded on the port's telemetry registry like the JAX
package's: a ``kernel_path`` gauge (:data:`PATH_CODES`) and per-path counters
``kernel_path/<path>``. Kernel launches are counted separately
(:func:`launch_counts`), so a run can prove the main path went through the
kernel. The JAX package's blocked-scan path, autotuner and int8 scorer are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.ops.distributions import softplus
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry

#: selection outcome -> the ``kernel_path`` gauge value. ``kernel`` keeps the
#: code of the JAX package's ``pallas`` path (2): it is the same fused block.
PATH_CODES = {"reference": 0, "kernel": 2}

#: the kernels this module launches (``csrc/hot_loop_fwd.cu``,
#: ``csrc/hot_loop_bwd.cu``)
KERNEL = "hot_loop_fwd"
KERNEL_BWD = "hot_loop_bwd"

#: largest dynamic shared memory a Hopper CTA may use (bytes)
MAX_SMEM_BYTES = 232448

_count_lock = threading.Lock()
_launches = {KERNEL: 0, KERNEL_BWD: 0}


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last :func:`reset_launch_counts`."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def _record_path(path: str) -> None:
    reg = get_registry()
    reg.counter(f"kernel_path/{path}").inc()
    reg.gauge("kernel_path").set(float(PATH_CODES[path]))


def path_counters() -> dict:
    """``{path: times selected}`` on the default registry."""
    snap = get_registry().snapshot()["counters"]
    return {name.split("/", 1)[1]: int(v) for name, v in snap.items()
            if name.startswith("kernel_path/")}


def select_path(device: torch.device, force: Optional[str] = None) -> str:
    """``kernel`` for CUDA tensors, ``reference`` for CPU tensors or under a
    ``"reference"`` pin. A ``"kernel"`` pin on the CPU is an error: there
    is no kernel there, and serving the plain version under the kernel's
    name would mislabel every stamp."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"hot-loop path {force!r}: expected None | kernel "
                         f"| reference")
    if force == "reference":
        return "reference"
    if torch.device(device).type == "cuda":
        return "kernel"
    if force == "kernel":
        raise ValueError("hot-loop path 'kernel' needs CUDA tensors; the "
                         "CPU runs the reference path")
    return "reference"


def serving_dispatch_config(cfg, *, device: torch.device,
                            force: Optional[str] = None) -> tuple:
    """``(dispatch cfg, path)`` of the serving score program (JAX :469-496).

    Models with ``likelihood="clamp"`` and an explicit ``"reference"``
    force keep `cfg` unchanged (the unfused program); otherwise the choice
    of :func:`select_path` is baked into the config's
    ``fused_likelihood``/``hot_loop_path`` pins. Unlike the JAX gate it
    needs no shape: the kernel takes every serving (k, bucket). `cfg` is
    duck-typed on the ModelConfig fields (ops/ does not import models/).
    """
    if getattr(cfg, "likelihood", None) != "logits" or force == "reference":
        return cfg, "reference"
    path = select_path(device, force)
    if path == "reference":
        return cfg, "reference"
    return dataclasses.replace(cfg, fused_likelihood=True,
                               hot_loop_path=path), path


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _dense(x, w, b, compute_dtype):
    """``models.mlp.dense_apply``'s op sequence (re-stated: ops/ does not
    import models/): bf16-rounded operands multiplied in fp32."""
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    return torch.matmul(x, w) + b


def _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype=None):
    """Unfused composition: the parity oracle and the kernel's plain version.

    ``h1`` ``[k, B, H1]``, ``x`` ``[B, D]`` -> ``[k, B]``.
    """
    y1 = torch.tanh(_dense(h1, w1, b1, compute_dtype))
    y2 = torch.tanh(_dense(y1, w2, b2, compute_dtype))
    logits = _dense(y2, w3, b3, compute_dtype)
    ll = x[None] * logits - softplus(logits)
    return torch.sum(ll, dim=-1)


def _bwd_plain(h1, w1, b1, w2, b2, w3, b3, x, g, compute_dtype=None):
    """The backward kernel's plain version: the gradients of
    :func:`_reference_impl` for the ``[k, B]`` cotangent `g`, written out
    with the JAX ``_bwd_kernel``'s rounding points (:698-746): with bf16 every
    matmul operand is rounded, while the tanh derivatives and the bias sums
    use the unrounded fp32 values.

    Returns ``(dh [k, B, H1], dW1, db1, dW2, db2, dW3, db3)``.
    """
    def op(t):
        return t if compute_dtype is None else t.to(compute_dtype).float()

    k, b, h1_dim = h1.shape
    h = h1.reshape(k * b, h1_dim)
    y1 = torch.tanh(op(h) @ op(w1) + b1)
    y2 = torch.tanh(op(y1) @ op(w2) + b2)
    logits = (op(y2) @ op(w3) + b3).reshape(k, b, -1)
    dl = (g[..., None] * (x[None] - torch.sigmoid(logits))).reshape(k * b, -1)
    dy2 = (op(dl) @ op(w3).T) * (1.0 - y2 * y2)
    dy1 = (op(dy2) @ op(w2).T) * (1.0 - y1 * y1)
    dh = (op(dy1) @ op(w1).T).reshape(k, b, h1_dim)
    return (dh, op(h).T @ op(dy1), dy1.sum(0), op(y1).T @ op(dy2),
            dy2.sum(0), op(y2).T @ op(dl), dl.sum(0))


# --------------------------------------------------------------------------
# The kernel's wrapper
# --------------------------------------------------------------------------

def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got "
                         f"{compute_dtype!r}")


def _check_block(h1, w1, b1, w2, b2, w3, b3, x, g=None) -> tuple:
    """Validate the kernels' inputs; returns ``(k, B, H1, hidden, D)``."""
    if h1.device.type != "cuda":
        raise ValueError(f"unsupported device {h1.device}")
    if h1.dim() != 3:
        raise ValueError(f"h1 must be [k, B, H1], got {tuple(h1.shape)}")
    k, b, h1_dim = h1.shape
    hid, d = w1.shape[1], w3.shape[1]
    checks = [("h1", h1, (k, b, h1_dim)), ("w1", w1, (h1_dim, hid)),
              ("b1", b1, (hid,)), ("w2", w2, (hid, hid)), ("b2", b2, (hid,)),
              ("w3", w3, (hid, d)), ("b3", b3, (d,)), ("x", x, (b, d))]
    if g is not None:
        checks.append(("g", g, (k, b)))
    for name, t, shape in checks:
        _check(name, t, shape, h1.device)
    return k, b, h1_dim, hid, d


def _load_kernel(name: str, h1_dim: int, hid: int):
    """The loaded library of kernel `name`, after checking that its tiles
    fit a Hopper CTA's shared memory at these widths."""
    from iwae_replication_project_tpu_torch.ops import _kernels
    lib = _kernels.load(name)
    smem = getattr(lib, f"{name}_smem_bytes")(h1_dim, hid)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name} needs {smem} bytes of shared memory for "
                         f"H1={h1_dim}, hidden={hid}; a Hopper CTA has "
                         f"{MAX_SMEM_BYTES}")
    return lib


def fused_forward(h1, w1, b1, w2, b2, w3, b3, x,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """The decoder output block's log-likelihood ``[k, B]``.

    On CUDA tensors this launches ``csrc/hot_loop_fwd.cu`` on the current
    stream (no synchronisation) and counts the launch; it raises for
    anything the kernel does not take. On CPU tensors it computes the plain
    version :func:`_reference_impl`.
    """
    _check_dtype(compute_dtype)
    if h1.device.type == "cpu":
        return _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype)
    k, b, h1_dim, hid, d = _check_block(h1, w1, b1, w2, b2, w3, b3, x)
    dev = h1.device
    if k * b == 0:
        return torch.zeros((k, b), dtype=torch.float32, device=dev)
    lib = _load_kernel(KERNEL, h1_dim, hid)
    out = torch.empty((k, b), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hot_loop_fwd(
            h1.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), x.data_ptr(),
            out.data_ptr(), k * b, b, h1_dim, hid, d,
            int(compute_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"hot_loop_fwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H1={h1_dim}, hidden={hid}, D={d})")
    with _count_lock:
        _launches[KERNEL] += 1
    return out


def fused_backward(h1, w1, b1, w2, b2, w3, b3, x, g,
                   compute_dtype: Optional[torch.dtype] = None) -> tuple:
    """The gradients of :func:`fused_forward` for the ``[k, B]`` cotangent
    `g`: ``(dh [k, B, H1], dW1, db1, dW2, db2, dW3, db3)``.

    On CUDA tensors this launches ``csrc/hot_loop_bwd.cu`` (the per-group
    kernel, then the fixed-order sum of its partials) on the current stream
    and counts one launch; the six weight/bias gradients are views of one
    contiguous buffer. It raises for anything the kernel does not take. On
    CPU tensors it computes the plain version :func:`_bwd_plain`.
    """
    _check_dtype(compute_dtype)
    if h1.device.type == "cpu":
        return _bwd_plain(h1, w1, b1, w2, b2, w3, b3, x, g, compute_dtype)
    k, b, h1_dim, hid, d = _check_block(h1, w1, b1, w2, b2, w3, b3, x, g)
    dev = h1.device
    shapes = ((h1_dim, hid), (hid,), (hid, hid), (hid,), (hid, d), (d,))
    sizes = [math.prod(s) for s in shapes]
    if k * b == 0:
        return (torch.zeros_like(h1),) + tuple(
            torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes)
    lib = _load_kernel(KERNEL_BWD, h1_dim, hid)
    rows = k * b
    groups = lib.hot_loop_bwd_groups(rows)
    dh = torch.empty_like(h1)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    slots = torch.empty((groups, sum(sizes)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hot_loop_bwd(
            h1.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), x.data_ptr(),
            g.data_ptr(), dh.data_ptr(), grads.data_ptr(), slots.data_ptr(),
            rows, b, h1_dim, hid, d, groups,
            int(compute_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"hot_loop_bwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H1={h1_dim}, hidden={hid}, D={d})")
    with _count_lock:
        _launches[KERNEL_BWD] += 1
    parts = torch.split(grads, sizes)
    return (dh,) + tuple(p.view(s) for p, s in zip(parts, shapes))


class FusedBlockLL(torch.autograd.Function):
    """``log p(x | h1)`` of the decoder output block with a kernel on both
    sides: forward :func:`fused_forward` (B1), backward
    :func:`fused_backward` (B2). The twin of the JAX custom VJP
    ``_fused_block_ll``/``_fused_fwd``/``_fused_bwd`` (:869-911). The
    binary targets `x` get no gradient. On CPU tensors both sides compute
    their plain versions, so the CPU tests drive the wiring the card runs.

    ``FusedBlockLL.apply(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype)``
    """

    @staticmethod
    def forward(ctx, h1, w1, b1, w2, b2, w3, b3, x, compute_dtype=None):
        ctx.save_for_backward(h1, w1, b1, w2, b2, w3, b3, x)
        ctx.compute_dtype = compute_dtype
        return fused_forward(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        grads = fused_backward(*ctx.saved_tensors, g.contiguous(),
                               ctx.compute_dtype)
        return grads + (None, None)


def decoder_score(out_params, x, h1, *,
                  compute_dtype: Optional[torch.dtype] = None,
                  force_path: Optional[str] = None) -> torch.Tensor:
    """``log p(x | h1)`` summed over pixels -> ``[k, B]`` (JAX :986-1024).

    `out_params` is the output block (``l1``/``l2``/``out`` dense layers),
    `x` ``[B, D]`` binary targets, `h1` the ``[k, B, H1]`` bottom latent.
    """
    w1, b1 = out_params["l1"]["w"], out_params["l1"]["b"]
    w2, b2 = out_params["l2"]["w"], out_params["l2"]["b"]
    w3, b3 = out_params["out"]["w"], out_params["out"]["b"]
    path = select_path(h1.device, force_path)
    _record_path(path)
    if path == "kernel":
        return FusedBlockLL.apply(h1.contiguous(), w1, b1, w2, b2, w3, b3,
                                  x.contiguous(), compute_dtype)
    return _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype)
