"""The K-sample hot loop: the decoder output block fused with the Bernoulli
log-likelihood (port of ``ops/hot_loop.py``).

For the 2-layer flagship the decoder output block ``h1 @ W1 -> tanh -> @ W2
-> tanh -> @ W3 -> Bernoulli -> sum over pixels`` holds ~77% of the k-scaled
matmul MACs and most of the activation bytes. Three implementations of that
one function, selected per call by :func:`select_path`:

* ``kernel`` -- :class:`FusedBlockLL`, whose forward is the hand-written
  CUDA kernel ``csrc/hot_loop_fwd.cu`` (replaces the TPU kernel
  ``_fwd_kernel``/``_fwd_pallas``, hot_loop.py:633-695 of the JAX package)
  and whose backward is ``csrc/hot_loop_bwd.cu`` (replaces ``_bwd_kernel``/
  ``_bwd_pallas``, :698-792), taken for CUDA tensors. Their bf16 paths run
  the products on the tensor cores (``csrc/tc_bf16.cuh``), their fp32
  paths on the CUDA cores (``csrc/tiles_fp32.cuh``). The bf16 forward's
  tunable tile is its row groups per CTA (``groups``, 1-4 groups of 16
  rows; 0 = the kernel's own rule), which changes no output bit;
* ``blocked_scan`` -- :func:`_blocked_scan_impl` (JAX :824-846): slabs of
  k through the plain composition, each under ``torch.utils.checkpoint``,
  so a forward holds one slab's logits and a backward recomputes them;
* ``reference`` -- the plain PyTorch composition :func:`_reference_impl`,
  the twin of the JAX ``_reference_impl`` (:810-821), differentiated by
  plain autograd.

The order of choice follows the JAX ``select_path`` (:918-983): a pin (the
config's ``hot_loop_path``) or ``IWAE_HOT_LOOP_PATH``, then a measured
``fwd`` winner of ``ops/autotune.py``, then the kernel on CUDA where
:func:`block_refusal` finds nothing in the libraries' numbers, then the
blocked scan where the materialised working set passes
:func:`_scan_threshold`, then the reference. The serving gate
(:func:`serving_dispatch_config`) reads ``serving_row`` winners instead.
A ``kernel`` winner never routes a CPU tensor to a kernel.

:func:`fused_forward` and :func:`fused_backward` are the kernels' wrappers:
each launches its kernel for CUDA tensors (or raises) and uses its plain
version (:func:`_reference_impl`, :func:`_bwd_plain`) only for CPU tensors.
There is no fall back from the card to a plain version: the backward kernel
streams its weights and takes every shape the forward takes, unlike the JAX
custom VJP, which falls back to the XLA backward when no VMEM tile fits.

The int8 serving policy (JAX :500-625): :func:`quantize_out_block` stores
the output block's weights as int8 with one fp32 scale per output channel,
:func:`decoder_score_int8` scores through ``ops/row_invariant.dense_int8``
(``csrc/row_dense.cu``'s int8-weight mode on the card), and
:func:`serving_int8_admit` admits it per (k, bucket) only where the
``serving_int8`` autotune kind measured a win.

Env levers (read at selection time; an unknown value raises):

* ``IWAE_HOT_LOOP_PATH`` -- ``auto`` (default) | ``kernel`` (``pallas``,
  the JAX package's name of the fused path, means the same) |
  ``blocked_scan`` | ``reference``;
* ``IWAE_HOT_LOOP_SCAN_BYTES`` -- the working set above which ``auto``
  takes the blocked scan where the kernel is not taken (default 256 MiB on
  the CPU; none on the card, where device memory absorbs the reference);
* ``IWAE_SERVING_INT8`` -- ``auto`` (default) | ``force`` | ``off``.

Selection is recorded on the port's telemetry registry like the JAX
package's: a ``kernel_path`` gauge (:data:`PATH_CODES`) and per-path counters
``kernel_path/<path>``. Kernel launches are counted separately
(:func:`launch_counts`), so a run can prove the main path went through the
kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.ops import row_invariant as ri_ops
from iwae_replication_project_tpu_torch.ops.distributions import softplus
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry
from iwae_replication_project_tpu_torch.telemetry.spans import REC
from iwae_replication_project_tpu_torch.utils.sizes import (
    largest_divisor_leq,
)

#: selection outcome -> the ``kernel_path`` gauge value. ``kernel`` keeps the
#: code of the JAX package's ``pallas`` path (2): it is the same fused block.
#: ``int8`` is the quantized serving path: only :func:`serving_int8_admit`
#: routes to it.
PATH_CODES = {"reference": 0, "blocked_scan": 1, "kernel": 2, "int8": 3}

#: the values a pin or ``IWAE_HOT_LOOP_PATH`` may take; ``pallas`` is the
#: JAX package's name of the fused path and means ``kernel``
FORCE_VALUES = ("auto", "kernel", "pallas", "blocked_scan", "reference")

#: ``auto``'s threshold (bytes) for the blocked scan over the materialising
#: reference off the card: the reference's working set is ~k*B*(2*hidden +
#: pixels) floats (two hiddens and the logits)
_SCAN_BYTES_DEFAULT = 256 * 1024 * 1024

#: the blocked scan's slab target: ~32 MiB of slab activations
_SCAN_SLAB_BYTES = 32 * 1024 * 1024

#: B1's largest number of 16-row groups per CTA (``csrc/hot_loop_fwd.cu``
#: ``MAX_GROUPS``); the ``groups`` argument takes 0 (the kernel's rule) or
#: 1..MAX_GROUPS
MAX_GROUPS = 4

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


def fwd_groups(rows: int) -> int:
    """The row groups per CTA that B1's bf16 kernel picks for `rows`
    flattened rows when called with ``groups=0`` (``csrc/hot_loop_fwd.cu``
    ``fwd_groups``): one group while the grid of 16-row CTAs still fits the
    card in one wave of two CTAs per SM, else :data:`MAX_GROUPS`."""
    return 1 if -(-rows // 16) <= 2 * ri_ops.SMS else MAX_GROUPS


def _forced_path(force: Optional[str]) -> str:
    """The pin `force`, else ``IWAE_HOT_LOOP_PATH``, else ``auto``, with
    ``pallas`` read as ``kernel``; an unknown value raises (JAX :941-946)."""
    source = "force argument" if force else "IWAE_HOT_LOOP_PATH"
    forced = (force or os.environ.get("IWAE_HOT_LOOP_PATH", "auto")).lower()
    if forced not in FORCE_VALUES:
        raise ValueError(f"{source}={forced!r}: expected "
                         f"{' | '.join(FORCE_VALUES)}")
    return "kernel" if forced == "pallas" else forced


def _scan_threshold(on_card: bool) -> float:
    """The working set (bytes) above which ``auto`` takes the blocked scan
    where the kernel is not taken: ``IWAE_HOT_LOOP_SCAN_BYTES``, else
    256 MiB on the CPU and none on the card (JAX :103-110, the card in the
    TPU's place). A value that is not a number raises ValueError."""
    env = os.environ.get("IWAE_HOT_LOOP_SCAN_BYTES")
    if env:
        try:
            return float(env)
        except ValueError:
            raise ValueError(f"IWAE_HOT_LOOP_SCAN_BYTES={env!r}: expected "
                             f"a number of bytes") from None
    return float("inf") if on_card else float(_SCAN_BYTES_DEFAULT)


def _autotune_winner(kind: str, shape: tuple, widths: tuple,
                     device: torch.device) -> Optional[dict]:
    """The measured winner of `kind` for this block (``ops/autotune.py``),
    or None: no cache, no entry, or an entry keyed on another card, kernel
    source or version."""
    from iwae_replication_project_tpu_torch.ops import autotune

    k, b, d = shape
    h1_dim, hid, bf16 = widths
    return autotune.winner_for(kind, k, b, h1_dim, hid, d,
                               "bfloat16" if bf16 else None, device=device)


def _hand_rule(device: torch.device, forced: str, widths: Optional[tuple],
               shape: Optional[tuple]) -> str:
    """The choice after any winner: the kernel on CUDA where the libraries
    take the widths, then the blocked scan over the threshold, then the
    reference (a ``kernel`` pin the card cannot honour raises)."""
    if forced in ("blocked_scan", "reference"):
        return forced
    on_card = torch.device(device).type == "cuda"
    if on_card:
        why = None if widths is None else block_refusal(
            library_limits(*widths))
        if why is None:
            return "kernel"
        if forced == "kernel":
            raise ValueError(f"hot-loop path 'kernel' pinned at widths "
                             f"(H1, hidden, bf16)={tuple(widths)} that the "
                             f"kernel refuses: {why}")
    elif forced == "kernel":
        raise ValueError("hot-loop path 'kernel' needs CUDA tensors; the "
                         "CPU runs the reference or blocked-scan path")
    if shape is not None and widths is not None:
        k, b, d = shape
        if 4.0 * k * b * (2 * widths[1] + d) > _scan_threshold(on_card):
            return "blocked_scan"
    return "reference"


def select_path(device: torch.device, force: Optional[str] = None,
                widths: Optional[tuple] = None,
                shape: Optional[tuple] = None) -> str:
    """``kernel``, ``blocked_scan`` or ``reference`` for one call (JAX
    :918-983), in this order: a pin `force` or ``IWAE_HOT_LOOP_PATH``
    (:func:`_forced_path`); a measured ``fwd`` winner for the block
    (``ops/autotune.py``; needs `widths` and `shape`) whose path is
    ``blocked_scan`` or ``reference``; the kernel for CUDA tensors where
    :func:`block_refusal` finds nothing in :func:`library_limits` at
    `widths` (``(H1, hidden, bf16)``, as :func:`block_widths` gives them);
    the blocked scan where the working set at `shape` (``(k, B, D)``)
    passes :func:`_scan_threshold`; else the reference.

    A ``"kernel"`` pin on the CPU, or at widths the kernel refuses, is an
    error: there is no kernel there, and serving another path under the
    kernel's name would mislabel every stamp. A ``kernel`` winner only
    leaves the choice to the hand rule, so it never sends a CPU tensor to
    a kernel."""
    forced = _forced_path(force)
    if forced == "auto" and widths is not None and shape is not None:
        win = _autotune_winner("fwd", shape, widths, torch.device(device))
        if win is not None and win.get("path") in ("blocked_scan",
                                                   "reference"):
            return win["path"]
    return _hand_rule(device, forced, widths, shape)


def _winner_groups(kind: str, shape: tuple, widths: tuple,
                   device: torch.device) -> Optional[int]:
    """B1's row groups of a ``kernel`` winner of `kind` (bf16 only: the
    fp32 kernel has no tile), or None."""
    if not widths[2] or torch.device(device).type != "cuda":
        return None
    win = _autotune_winner(kind, shape, widths, device)
    if win is None or win.get("path") != "kernel" or not win.get("groups"):
        return None
    g = int(win["groups"])
    return g if 1 <= g <= MAX_GROUPS else None


def serving_dispatch_config(cfg, k: Optional[int] = None,
                            rows: Optional[int] = None, *,
                            device: torch.device,
                            force: Optional[str] = None,
                            gated: bool = True) -> tuple:
    """``(dispatch cfg, path)`` of a serving program at (k, bucket=`rows`)
    (JAX :469-496).

    Every serving program takes the row-invariant ops
    (``row_invariant=True``: ``ops/row_invariant``'s dense layers and sums,
    whose per-row arithmetic does not depend on the bucket: the kernels on
    CUDA, their fixed-order plain versions on the CPU), so a row's result is
    bitwise the same in every bucket on either device, as the JAX programs
    promise (JAX serving/programs.py:1-11). ``gated=False`` is a program
    that never runs the decoder block
    (encode, decode): it gets only that flag. For a gated program, models
    with ``likelihood="clamp"`` and an explicit ``"reference"`` force keep
    the unfused composition. Otherwise, in the JAX gate's order: the pin
    or ``IWAE_HOT_LOOP_PATH``; with (k, rows) a measured ``serving_row``
    winner (a ``kernel`` winner on CUDA only, where the libraries take the
    widths, its row groups baked into ``hot_loop_tile``); then
    :func:`_hand_rule` at the block's widths and the bucket's working set.
    The choice is baked into the config's ``fused_likelihood``/
    ``hot_loop_path``/``hot_loop_tile`` pins; ``reference`` leaves `cfg`
    unfused. `cfg` is duck-typed on the ModelConfig fields (ops/ does not
    import models/).
    """
    dev = torch.device(device)
    if not cfg.row_invariant:
        cfg = dataclasses.replace(cfg, row_invariant=True)
    if not gated or getattr(cfg, "likelihood", None) != "logits" \
            or force == "reference":
        return cfg, "reference"
    forced = _forced_path(force)
    widths = block_widths(cfg)
    shape = None if k is None or rows is None else (k, rows, cfg.x_dim)
    path, groups = None, None
    if forced == "auto" and shape is not None:
        win = _autotune_winner("serving_row", shape, widths, dev)
        if win is not None and win.get("path") in ("blocked_scan",
                                                   "reference"):
            path = win["path"]
        elif win is not None and win.get("path") == "kernel" \
                and dev.type == "cuda" \
                and block_refusal(library_limits(*widths)) is None:
            path = "kernel"
            groups = _winner_groups("serving_row", shape, widths, dev)
    if path is None:
        path = _hand_rule(dev, forced, widths, shape)
    if path == "reference":
        return cfg, "reference"
    return dataclasses.replace(cfg, fused_likelihood=True,
                               hot_loop_path=path,
                               hot_loop_tile=groups), path


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype=None,
                    row_invariant: bool = False):
    """Unfused composition: the parity oracle and the kernel's plain version.

    ``h1`` ``[k, B, H1]``, ``x`` ``[B, D]`` -> ``[k, B]``. With
    ``row_invariant`` (the serving programs) the dense layers and
    the pixel sum go through ``ops/row_invariant``, so a row's bits do not
    depend on the rows beside it.
    """
    layer = ri_ops.dense if row_invariant else ri_ops.dense_plain
    y1 = layer(h1, w1, b1, compute_dtype, tanh=True)
    y2 = layer(y1, w2, b2, compute_dtype, tanh=True)
    logits = layer(y2, w3, b3, compute_dtype)
    return _pixel_ll(x, logits, row_invariant)


def _pixel_ll(x, logits, row_invariant: bool) -> torch.Tensor:
    """``sum_d x * l - softplus(l)``, row by row under `row_invariant`."""
    sp = ri_ops.rowwise(softplus, logits) if row_invariant \
        else softplus(logits)
    return ri_ops.sum_over(x[None] * logits - sp, -1, row_invariant)


def _blocked_scan_impl(h1, w1, b1, w2, b2, w3, b3, x, *, block_k: int,
                       compute_dtype=None, row_invariant: bool = False):
    """Slabs of k through :func:`_reference_impl` (JAX :824-846).

    The slab height is the largest divisor of k not above `block_k`. With
    autograd on, each slab runs under ``torch.utils.checkpoint``
    (``use_reentrant=False``): the forward keeps one ``[bk, B, D]`` slab
    of logits at a time and the backward recomputes it. Slabs cut k, never
    rows, and every slab runs the same per-row ops, so blocking changes
    memory, not a row's arithmetic (under ``row_invariant`` a row's bits;
    without it the matmul library may sum another way per shape).
    """
    k = h1.shape[0]
    bk = largest_divisor_leq(k, max(int(block_k), 1))

    def slab(h):
        return _reference_impl(h, w1, b1, w2, b2, w3, b3, x, compute_dtype,
                               row_invariant)

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h1, w1, b1, w2, b2, w3, b3)):
        def run(h):
            return torch.utils.checkpoint.checkpoint(slab, h,
                                                     use_reentrant=False)
    else:
        run = slab
    if bk == k:
        return run(h1)
    return torch.cat([run(h1[i:i + bk]) for i in range(0, k, bk)], dim=0)


def _scan_block_k(k: int, b: int, hid: int, n_pixels: int,
                  h1_dim: int = 0, compute_dtype=None,
                  device: Optional[torch.device] = None) -> int:
    """The blocked scan's slab height (JAX :849-863): a measured ``scan``
    winner for the block where one is cached, else the height that holds
    ~32 MiB of slab activations (two hiddens and the logits)."""
    if device is not None:
        win = _autotune_winner(
            "scan", (k, b, n_pixels),
            (h1_dim, hid, compute_dtype in (torch.bfloat16, "bfloat16")),
            torch.device(device))
        if win is not None and win.get("block_k"):
            bk = int(win["block_k"])
            if 1 <= bk <= k:
                return largest_divisor_leq(k, bk)
    per_k = b * (2 * hid + n_pixels) * 4
    return max(1, min(k, _SCAN_SLAB_BYTES // max(per_k, 1)))


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
                  compute_dtype: Optional[torch.dtype] = None,
                  groups: int = 0) -> torch.Tensor:
    """The decoder output block's log-likelihood ``[k, B]``.

    On CUDA tensors this launches ``csrc/hot_loop_fwd.cu`` on the current
    stream (no synchronisation) and counts one launch: in bf16 the weight
    prep (bf16 tiles into a scratch buffer whose size the library states)
    and the tensor-core row kernel, in fp32 the CUDA-core kernel. `groups`
    is the bf16 kernel's 16-row groups per CTA: 0 lets the kernel choose
    (:func:`fwd_groups`), 1..:data:`MAX_GROUPS` pins it (an autotune
    winner); a row's arithmetic is the same at every value. It raises for
    anything the kernel does not take. On CPU tensors it computes the
    plain version :func:`_reference_impl`.
    """
    _check_dtype(compute_dtype)
    if not 0 <= int(groups) <= MAX_GROUPS:
        raise ValueError(f"groups must be 0 (the kernel's rule) or 1..."
                         f"{MAX_GROUPS}, got {groups}")
    if groups and compute_dtype is None:
        raise ValueError("the fp32 kernel has no row groups to pin; pass "
                         "groups=0")
    if h1.device.type == "cpu":
        with _kernels.plain_region(KERNEL):
            return _reference_impl(h1, w1, b1, w2, b2, w3, b3, x,
                                   compute_dtype)
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
        hid, d, bf16, int(groups))
    if rc != 0:
        raise RuntimeError(f"hot_loop_fwd launch failed with CUDA error {rc} "
                           f"(k={k}, B={b}, H1={h1_dim}, hidden={hid}, D={d}, "
                           f"groups={groups})")
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
        with _kernels.plain_region(KERNEL_BWD):
            return _bwd_plain(h1, w1, b1, w2, b2, w3, b3, x, g,
                              compute_dtype)
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

    ``FusedBlockLL.apply(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype,
    groups)`` (`groups` as :func:`fused_forward`'s)
    """

    @staticmethod
    def forward(ctx, h1, w1, b1, w2, b2, w3, b3, x, compute_dtype=None,
                groups=0):
        ctx.save_for_backward(h1, w1, b1, w2, b2, w3, b3, x)
        ctx.compute_dtype = compute_dtype
        return fused_forward(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype,
                             groups)

    @staticmethod
    def backward(ctx, g):
        grads = fused_backward(*ctx.saved_tensors, g.contiguous(),
                               ctx.compute_dtype)
        return grads + (None, None, None)


def decoder_score(out_params, x, h1, *,
                  compute_dtype: Optional[torch.dtype] = None,
                  force_path: Optional[str] = None,
                  force_tile: Optional[int] = None,
                  row_invariant: bool = False) -> torch.Tensor:
    """``log p(x | h1)`` summed over pixels -> ``[k, B]`` (JAX :986-1024).

    `out_params` is the output block (``l1``/``l2``/``out`` dense layers),
    `x` ``[B, D]`` binary targets, `h1` the ``[k, B, H1]`` bottom latent.
    The path is :func:`select_path`'s; `force_path` pins one (the config's
    ``hot_loop_path``), `force_tile` B1's row groups (the config's
    ``hot_loop_tile``; else a ``fwd`` winner's, else the kernel's rule).
    `row_invariant` (the serving programs) runs the blocked scan's
    and the reference's ops through ``ops/row_invariant``.
    """
    w1, b1 = out_params["l1"]["w"], out_params["l1"]["b"]
    w2, b2 = out_params["l2"]["w"], out_params["l2"]["b"]
    w3, b3 = out_params["out"]["w"], out_params["out"]["b"]
    k, b, h1_dim = h1.shape
    hid, d = w1.shape[1], w3.shape[1]
    widths = (h1_dim, hid, compute_dtype == torch.bfloat16)
    path = select_path(h1.device, force_path, widths=widths,
                       shape=(k, b, d))
    _record_path(path)
    if path == "kernel":
        groups = force_tile if force_tile is not None else _winner_groups(
            "fwd", (k, b, d), widths, h1.device)
        # B1's host call, while the span recorder is on
        sp = REC.begin("hot_loop/b1") if REC.on else None
        out = FusedBlockLL.apply(h1.contiguous(), w1, b1, w2, b2, w3, b3,
                                 x.contiguous(), compute_dtype, groups or 0)
        if sp is not None:
            REC.end(sp)
        return out
    if path == "blocked_scan":
        return _blocked_scan_impl(
            h1, w1, b1, w2, b2, w3, b3, x,
            block_k=_scan_block_k(k, b, hid, d, h1_dim, compute_dtype,
                                  h1.device),
            compute_dtype=compute_dtype, row_invariant=row_invariant)
    return _reference_impl(h1, w1, b1, w2, b2, w3, b3, x, compute_dtype,
                           row_invariant)


# --------------------------------------------------------------------------
# The int8 weight-only serving path (JAX :500-625)
# --------------------------------------------------------------------------
#
# The int8 policy stores the output block's matmul weights as int8 with one
# fp32 scale per output channel, quantized once at engine load; biases and
# activations stay fp32 and every product accumulates in fp32. The scale is
# constant along the contraction, so it is applied after the sum. Whether
# the quantized program is faster on the card is measured (the
# ``serving_int8`` autotune kind), never assumed; its numbers are held to
# the fp32 program by ``telemetry/parity.statistical_parity``, not bitwise.

def quantize_out_block(out_params) -> dict:
    """Weight-only symmetric per-output-channel int8 quantization of the
    output block (JAX :518-537): each layer ``{"w": [in, out], "b": [out]}``
    becomes ``{"w_q": [in, out] int8, "scale": [out] f32, "b": [out] f32}``
    with ``scale[j] = max |w[:, j]| / 127`` (1.0 for an all-zero channel)
    and ``w_q = clamp(round(w / scale), -127, 127)``, rounding half to
    even as JAX does. Runs once at engine load."""
    def one(layer):
        w = layer["w"].detach().float()
        amax = w.abs().amax(dim=0)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"w_q": w_q.contiguous(), "scale": scale.contiguous(),
                "b": layer["b"].detach().float().contiguous()}

    return {name: one(out_params[name]) for name in ("l1", "l2", "out")}


def decoder_score_int8(out_q, x, h1, *,
                       row_invariant: bool = False) -> torch.Tensor:
    """``log p(x | h1)`` summed over pixels -> ``[k, B]`` through the
    quantized output block (JAX :549-561): two ``dense_int8`` layers with
    tanh, one without, the logits-form Bernoulli, the pixel sum. On CUDA
    tensors each layer is ``csrc/row_dense.cu``'s int8-weight mode (it
    raises rather than computing its plain version); under `row_invariant`
    the pixel sum is ``row_invariant.fixed_sum``. Records path ``int8``."""
    _record_path("int8")
    l1, l2, lo = out_q["l1"], out_q["l2"], out_q["out"]
    y1 = ri_ops.dense_int8(h1, l1["w_q"], l1["scale"], l1["b"], tanh=True)
    y2 = ri_ops.dense_int8(y1, l2["w_q"], l2["scale"], l2["b"], tanh=True)
    logits = ri_ops.dense_int8(y2, lo["w_q"], lo["scale"], lo["b"])
    return _pixel_ll(x, logits, row_invariant)


#: (autotune entry key, winner store, device) -> the admission verdict
_int8_admit_cache: dict = {}


def serving_int8_admit(k: int, rows: int, h1_dim: int, hid: int,
                       n_pixels: int, *, device: torch.device
                       ) -> Tuple[bool, str]:
    """``(admitted, reason)``: may the int8 program serve (k, bucket=`rows`)
    on `device`? (JAX :567-622.)

    ``IWAE_SERVING_INT8`` decides first: ``force`` admits, ``off`` rejects,
    ``auto`` (or unset) asks the ``serving_int8`` autotune kind, and any
    other value raises. In ``auto`` a cached winner decides. On CUDA with no
    winner the race is measured once, here (``ops/autotune.tune``); a search
    that fails keeps the exact fp32 program and says so. Off the card with
    no winner the answer is no: admission needs a measured win. Verdicts are
    memoized per shape, device and winner store."""
    from iwae_replication_project_tpu_torch.ops import autotune

    env = os.environ.get("IWAE_SERVING_INT8", "auto").lower()
    if env not in ("auto", "force", "off"):
        raise ValueError(f"IWAE_SERVING_INT8={env!r}: expected "
                         f"auto | force | off")
    if env == "force":
        return True, "forced via IWAE_SERVING_INT8=force"
    if env == "off":
        return False, "disabled via IWAE_SERVING_INT8=off"
    dev = torch.device(device)
    memo = (k, rows, h1_dim, hid, n_pixels, str(dev),
            autotune.store_generation())
    hit = _int8_admit_cache.get(memo)
    if hit is not None:
        return hit
    win = autotune.winner_for("serving_int8", k, rows, h1_dim, hid, n_pixels,
                              None, device=dev)
    on_card = dev.type == "cuda"
    if win is None and on_card:
        # no verdict cached: race the two programs now, once; a search that
        # fails leaves the exact fp32 program serving, never a crash
        try:
            win = autotune.tune("serving_int8", k, rows, h1_dim, hid,
                                n_pixels, device=dev)
        except RuntimeError:
            win = None
    if win is None:
        verdict = (False,
                   "autotune measurement failed; serving the exact fp32 "
                   "program" if on_card else
                   "no measured winner and not on the card; int8 admission "
                   "requires a measured win (set IWAE_SERVING_INT8=force "
                   "to override)")
    elif win.get("path") == "int8":
        verdict = (True, f"measured faster than the fp32 program "
                         f"({win.get('measured_ms')} ms against "
                         f"{win.get('runner_up_ms')} ms)")
    elif not any(m["candidate"].startswith("int8")
                 for m in win.get("all_measured", ())):
        verdict = (False, "the int8 candidate failed its measurement; "
                          "serving the exact fp32 program")
    else:
        verdict = (False, f"measured slower than the fp32 program at this "
                          f"shape ({win.get('measured_ms')} ms against "
                          f"{win.get('runner_up_ms')} ms for int8)")
    _int8_admit_cache[memo] = verdict
    return verdict
