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
  ``_bwd_pallas``, :698-792), taken for CUDA tensors. Their bf16 paths run
  the products on the tensor cores (``csrc/tc_bf16.cuh``), their fp32
  paths on the CUDA cores (``csrc/tiles_fp32.cuh``);
* ``reference`` -- the plain PyTorch composition :func:`_reference_impl`,
  the twin of the JAX ``_reference_impl`` (:810-821), differentiated by plain
  autograd, taken for CPU tensors, under an explicit ``"reference"`` pin, and
  on CUDA at widths either kernel refuses (:func:`block_refusal`, from the
  numbers the kernel libraries state), as the JAX ``select_path`` (:918-983)
  leaves the Pallas kernel where no tile fits.

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
import functools
import math
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.ops.distributions import softplus
from iwae_replication_project_tpu_torch.ops.row_invariant import dense_plain
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry

#: selection outcome -> the ``kernel_path`` gauge value. ``kernel`` keeps the
#: code of the JAX package's ``pallas`` path (2): it is the same fused block.
PATH_CODES = {"reference": 0, "kernel": 2}

#: the kernels this module launches (``csrc/hot_loop_fwd.cu``,
#: ``csrc/hot_loop_bwd.cu``)
KERNEL = "hot_loop_fwd"
KERNEL_BWD = "hot_loop_bwd"

def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last :func:`reset_launch_counts`."""
    return _kernels.launch_counts((KERNEL, KERNEL_BWD))


def reset_launch_counts() -> None:
    _kernels.reset_launch_counts((KERNEL, KERNEL_BWD))


def _record_path(path: str) -> None:
    reg = get_registry()
    reg.counter(f"kernel_path/{path}").inc()
    reg.gauge("kernel_path").set(float(PATH_CODES[path]))


def path_counters() -> dict:
    """``{path: times selected}`` on the default registry."""
    snap = get_registry().snapshot()["counters"]
    return {name.split("/", 1)[1]: int(v) for name, v in snap.items()
            if name.startswith("kernel_path/")}


@dataclasses.dataclass(frozen=True)
class BlockLimits:
    """What the two kernel libraries state for one output block's widths:
    each kernel's dynamic shared memory per CTA (``*_smem_bytes``) and
    whether its register budget takes the widths (``*_fits``)."""

    fwd_smem: int
    bwd_smem: int
    fwd_fits: bool
    bwd_fits: bool


def block_refusal(limits: BlockLimits,
                  max_smem: int = _kernels.MAX_SMEM_BYTES) -> Optional[str]:
    """Why the kernel pair cannot take a block with these `limits`, or None
    when both kernels take it: a pure function of the libraries' numbers."""
    for name, smem, fits in ((KERNEL, limits.fwd_smem, limits.fwd_fits),
                             (KERNEL_BWD, limits.bwd_smem, limits.bwd_fits)):
        if not fits:
            return f"{name}: a reduction wider than its register budget"
        if smem > max_smem:
            return (f"{name} needs {smem} bytes of shared memory per CTA; a "
                    f"Hopper CTA has {max_smem}")
    return None


@functools.lru_cache(maxsize=64)
def library_limits(h1_dim: int, hidden: int, bf16: bool) -> BlockLimits:
    """:class:`BlockLimits` as the built libraries state them (building them
    first if needed)."""
    fwd, bwd = _kernels.load(KERNEL), _kernels.load(KERNEL_BWD)
    b = int(bf16)
    return BlockLimits(
        fwd_smem=int(fwd.hot_loop_fwd_smem_bytes(h1_dim, hidden, b)),
        bwd_smem=int(bwd.hot_loop_bwd_smem_bytes(h1_dim, hidden, b)),
        fwd_fits=bool(fwd.hot_loop_fwd_fits(h1_dim, hidden, b)),
        bwd_fits=bool(bwd.hot_loop_bwd_fits(h1_dim, hidden, b)))


def block_widths(cfg) -> tuple:
    """``(H1, hidden, bf16)`` of a ModelConfig's output block (duck-typed:
    ops/ does not import models/), as ``models.iwae.init_params`` sizes it."""
    h1 = cfg.n_latent_dec[-2] if len(cfg.n_latent_dec) > 1 \
        else cfg.n_latent_enc[-1]
    return h1, cfg.n_hidden_dec[-1], cfg.compute_dtype == "bfloat16"


def select_path(device: torch.device, force: Optional[str] = None,
                widths: Optional[tuple] = None) -> str:
    """``kernel`` for CUDA tensors, ``reference`` for CPU tensors or under a
    ``"reference"`` pin. A ``"kernel"`` pin on the CPU is an error: there
    is no kernel there, and serving the plain version under the kernel's
    name would mislabel every stamp.

    With `widths` (``(H1, hidden, bf16)`` of the output block, as
    :func:`block_widths` gives them) a CUDA device takes the kernel only
    where :func:`block_refusal` finds nothing in :func:`library_limits`;
    otherwise ``reference``, and a ``"kernel"`` pin at such widths is an
    error."""
    if force not in (None, "kernel", "reference"):
        raise ValueError(f"hot-loop path {force!r}: expected None | kernel "
                         f"| reference")
    if force == "reference":
        return "reference"
    if torch.device(device).type == "cuda":
        if widths is None:
            return "kernel"
        why = block_refusal(library_limits(*widths))
        if why is None:
            return "kernel"
        if force == "kernel":
            raise ValueError(f"hot-loop path 'kernel' pinned at widths "
                             f"(H1, hidden, bf16)={tuple(widths)} that the "
                             f"kernel refuses: {why}")
        return "reference"
    if force == "kernel":
        raise ValueError("hot-loop path 'kernel' needs CUDA tensors; the "
                         "CPU runs the reference path")
    return "reference"


def serving_dispatch_config(cfg, *, device: torch.device,
                            force: Optional[str] = None,
                            gated: bool = True) -> tuple:
    """``(dispatch cfg, path)`` of a serving program (JAX :469-496).

    On CUDA every serving program takes the row-invariant ops
    (``row_invariant=True``: ``ops/row_invariant``'s dense layers and sums,
    whose per-row arithmetic does not depend on the bucket), so a row's
    result is bitwise the same in every bucket, as the JAX programs promise
    (JAX serving/programs.py:1-11); on the CPU the flag stays as `cfg` has
    it. ``gated=False`` is a program that never runs the decoder block
    (encode, decode): it gets only that flag. For a gated program, models
    with ``likelihood="clamp"`` and an explicit ``"reference"`` force keep
    the unfused composition; otherwise the choice of :func:`select_path`
    at the model's block widths is baked into the config's
    ``fused_likelihood``/``hot_loop_path`` pins. Unlike the JAX gate it
    needs no batch shape: the kernel takes every serving (k, bucket) at the
    widths it takes. `cfg` is duck-typed on the ModelConfig fields (ops/
    does not import models/).
    """
    if torch.device(device).type == "cuda" and not cfg.row_invariant:
        cfg = dataclasses.replace(cfg, row_invariant=True)
    if not gated or getattr(cfg, "likelihood", None) != "logits" \
            or force == "reference":
        return cfg, "reference"
    path = select_path(device, force, widths=block_widths(cfg))
    if path == "reference":
        return cfg, "reference"
    return dataclasses.replace(cfg, fused_likelihood=True,
                               hot_loop_path=path), path


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype=None):
    """Unfused composition: the parity oracle and the kernel's plain version.

    ``h1`` ``[k, B, H1]``, ``x`` ``[B, D]`` -> ``[k, B]``.
    """
    y1 = dense_plain(h1, w1, b1, compute_dtype, tanh=True)
    y2 = dense_plain(y1, w2, b2, compute_dtype, tanh=True)
    logits = dense_plain(y2, w3, b3, compute_dtype)
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
        _kernels.check_tensor(name, t, shape, h1.device)
    return k, b, h1_dim, hid, d


def fused_forward(h1, w1, b1, w2, b2, w3, b3, x,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """The decoder output block's log-likelihood ``[k, B]``.

    On CUDA tensors this launches ``csrc/hot_loop_fwd.cu`` on the current
    stream (no synchronisation) and counts one launch: in bf16 the weight
    prep (bf16 tiles into a scratch buffer whose size the library states)
    and the tensor-core row kernel, in fp32 the CUDA-core kernel. It raises
    for anything the kernel does not take. On CPU tensors it computes the
    plain version :func:`_reference_impl`.
    """
    _check_dtype(compute_dtype)
    if h1.device.type == "cpu":
        return _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype)
    k, b, h1_dim, hid, d = _check_block(h1, w1, b1, w2, b2, w3, b3, x)
    dev = h1.device
    if k * b == 0:
        return torch.zeros((k, b), dtype=torch.float32, device=dev)
    bf16 = int(compute_dtype == torch.bfloat16)
    launch, scratch_bytes = _kernels.plan(KERNEL, (h1_dim, hid, bf16),
                                          (h1_dim, hid, d, bf16))
    out = torch.empty((k, b), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    rc = _kernels.launch(
        dev, launch, h1.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), k * b, b, h1_dim,
        hid, d, bf16)
    if rc != 0:
        raise RuntimeError(f"hot_loop_fwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H1={h1_dim}, hidden={hid}, D={d})")
    _kernels.count(KERNEL)
    return out


def fused_backward(h1, w1, b1, w2, b2, w3, b3, x, g,
                   compute_dtype: Optional[torch.dtype] = None) -> tuple:
    """The gradients of :func:`fused_forward` for the ``[k, B]`` cotangent
    `g`: ``(dh [k, B, H1], dW1, db1, dW2, db2, dW3, db3)``.

    On CUDA tensors this launches ``csrc/hot_loop_bwd.cu`` on the current
    stream and counts one launch: in bf16 the weight prep, the tensor-core
    row phase, the weight-gradient phase over row splits fixed by the row
    count and the fixed-order sum of the splits; in fp32 the per-group
    kernel and the fixed-order sum of its partials, all in a scratch buffer
    whose size the library states. The six weight/bias gradients are views
    of one contiguous buffer. It raises for anything the kernel does not
    take. On CPU tensors it computes the plain version :func:`_bwd_plain`.
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
    bf16 = int(compute_dtype == torch.bfloat16)
    rows = k * b
    launch, scratch_bytes = _kernels.plan(KERNEL_BWD, (h1_dim, hid, bf16),
                                          (rows, h1_dim, hid, d, bf16))
    dh = torch.empty_like(h1)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    rc = _kernels.launch(
        dev, launch, h1.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        x.data_ptr(), g.data_ptr(), dh.data_ptr(), grads.data_ptr(),
        scratch.data_ptr(), rows, b, h1_dim, hid, d, bf16)
    if rc != 0:
        raise RuntimeError(f"hot_loop_bwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H1={h1_dim}, hidden={hid}, D={d})")
    _kernels.count(KERNEL_BWD)
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
    path = select_path(h1.device, force_path,
                       widths=(h1.shape[-1], w1.shape[1],
                               compute_dtype == torch.bfloat16))
    _record_path(path)
    if path == "kernel":
        return FusedBlockLL.apply(h1.contiguous(), w1, b1, w2, b2, w3, b3,
                                  x.contiguous(), compute_dtype)
    return _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype)
