"""Row-invariant dense layers and sums for the serving programs.

The JAX serving programs give a row bitwise the same result in every bucket
(JAX ``serving/programs.py:1-11``). On the card two kinds of op broke that:
cuBLAS picks its algorithm per problem shape (another K order, split-K, a
GEMV for one row), and ``torch.sum``'s reduction sizes its thread blocks by
the number of outputs. The serving programs therefore run their dense
layers and their sums over samples, latents and pixels through two kernels
of the port's own, whose per-output arithmetic depends on nothing but that
output's inputs:

* :func:`dense` -- ``csrc/row_dense.cu``: ``act(x W + b)``, each output
  one fixed-order chain over K (bf16-rounded operands on the tensor cores,
  one ``mma.sync`` per k16 step; fp32 one FMA chain on the CUDA cores), on
  an output tile that :func:`dense_plan` picks from (M, N);
* :func:`dense_int8` -- ``csrc/row_dense.cu``'s int8-weight mode, the
  int8 serving policy's layer: ``act((x W_q) * scale + b)`` with ``W_q``
  read as int8 and converted in registers, each output fp32's one FMA
  chain over K, on the same tile menu and plan as fp32;
* :func:`fixed_sum` -- ``csrc/row_sum.cu``: a sum over one axis, each
  output added in index order by one thread from inputs its CTA staged with
  coalesced loads.

They are not ports of TPU kernels (the XLA programs need no such care). The
choice to use them is the dispatcher's: ``ops/hot_loop.serving_dispatch_
config`` sets ``ModelConfig.row_invariant`` for every serving program, and
``models/`` and ``ops/logsumexp.py`` route on that flag. Training and
evaluation keep cuBLAS and ``torch.sum``: their shapes are fixed per step or
chunk. Each wrapper launches its kernel for CUDA tensors (or raises) and
computes its plain version only for CPU tensors; neither kernel has a
backward, so a CUDA call that autograd would record raises.

The CPU has the same hazard: ``torch.matmul`` takes a matrix-vector path
for one row and a blocked one for more, and ``torch.sum`` may split a long
reduction across threads when it has few outputs. So the wrappers' plain
versions on the CPU (:func:`matmul_in_slabs`, :func:`sum_in_slabs`) sum
every output in one fixed order of exactly rounded elementwise adds, whose
bits depend on nothing but that output's inputs. They are slower than the
library and keep their temporaries to a few million elements. The
programs' ``sigmoid`` and ``log1p`` run row by row there
(:func:`rowwise`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.ops import _kernels

#: the kernels every serving program on the card launches
KERNEL_DENSE = "row_dense"
KERNEL_SUM = "row_sum"
KERNELS = (KERNEL_DENSE, KERNEL_SUM)
#: ``csrc/row_dense.cu``'s int8-weight mode, counted under its own name
#: (the int8 serving policy's dispatches alone launch it)
KERNEL_DENSE_INT8 = "row_dense_int8"
COUNTED = KERNELS + (KERNEL_DENSE_INT8,)

#: ``csrc/row_dense.cu``'s menu of output tiles (rows, columns), largest
#: first; the C entry point's ``tile`` is an index into it
DENSE_TILES: Tuple[Tuple[int, int], ...] = ((64, 64), (32, 64), (16, 64),
                                            (16, 32))
#: the H100's SMs: the plan takes the largest tile that gives each a CTA
SMS = 132


def launch_counts() -> dict:
    """``{kernel name: launches}`` of :data:`COUNTED` since the last
    :func:`reset_launch_counts`."""
    return _kernels.launch_counts(COUNTED)


def reset_launch_counts() -> None:
    _kernels.reset_launch_counts(COUNTED)


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


#: the CPU plain versions' temporaries: at most this many fp32 elements
_CPU_TEMP_ELEMS = 1 << 22


def slab_plan(k: int) -> Tuple[int, int]:
    """``(slabs, width)`` of the CPU plain versions' fixed order over `k`
    terms: ``width = ceil(sqrt(k))`` consecutive terms a slab,
    ``ceil(k / width)`` slabs, the last padded with zeros."""
    width = max(1, math.isqrt(max(k, 1) - 1) + 1)
    return -(-k // width), width


def _slab_sum(terms, slabs: int, width: int, shape) -> torch.Tensor:
    """The fixed two-level order: ``part[s] = (t[s, 0] + t[s, 1]) + ...``
    for every slab at once (``terms(j)`` gives term j of each slab,
    ``[..., slabs, N]``), then ``((0 + part[0]) + part[1]) + ...``. Every
    step is one exactly rounded elementwise add, so an output's bits
    depend on its own terms alone."""
    part = None
    for j in range(width):
        t = terms(j)
        part = t.clone() if part is None else part.add_(t)
    acc = part.new_zeros(shape)
    for s in range(slabs):
        acc.add_(part.select(-2, s))
    return acc


def matmul_in_slabs(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (`x` ``[..., K]``, `w` ``[K, N]``) in a fixed order per
    output: the exactly rounded products ``x[..., j] * w[j]`` summed over
    the slabs of :func:`slab_plan` by :func:`_slab_sum`, as separate
    elementwise ops (no fused multiply-add). A row's bits therefore do not
    depend on the rows beside it or on their number; ~3 sqrt(K) ops, rows
    in chunks that keep each temporary under ``_CPU_TEMP_ELEMS``."""
    k, n = w.shape
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    out = x2.new_zeros(m, n)
    if m == 0 or n == 0:
        return out.view(lead + (n,))
    slabs, width = slab_plan(k)
    pad = slabs * width - k
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    xs, ws = x2.view(m, slabs, width), w.reshape(slabs, width, n)
    rows = max(1, _CPU_TEMP_ELEMS // (slabs * n))
    for r0 in range(0, m, rows):
        xr = xs[r0:r0 + rows]
        out[r0:r0 + rows] = _slab_sum(
            lambda j: xr[:, :, j, None] * ws[:, j], slabs, width,
            (xr.shape[0], n))
    return out.view(lead + (n,))


def sum_in_slabs(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` in :func:`matmul_in_slabs`'s fixed order:
    ``row_sum``'s plain version on the CPU."""
    d = dim % x.dim()
    r = x.shape[d]
    xt = x.movedim(d, -1)
    shape = tuple(xt.shape[:-1])
    if r == 0:
        return xt.new_zeros(shape)
    slabs, width = slab_plan(r)
    pad = slabs * width - r
    if pad:
        xt = torch.nn.functional.pad(xt, (0, pad))
    xs = xt.reshape(shape + (slabs, width))
    return _slab_sum(lambda j: xs[..., j, None], slabs, width,
                     shape + (1,))[..., 0]


def dense_in_slabs(x, w, b, compute_dtype=None, tanh: bool = False):
    """``row_dense``'s plain version on the CPU: the operands rounded as
    :func:`dense_plain` rounds them, :func:`matmul_in_slabs`, then the
    bias and tanh. Within rounding of :func:`dense_plain`; a row's bits
    the same in every bucket."""
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    y = matmul_in_slabs(x, w) + b
    return torch.tanh(y) if tanh else y


@functools.lru_cache(maxsize=1024)
def dense_tile(m: int, n: int) -> int:
    """The index in :data:`DENSE_TILES` of ``row_dense``'s output tile for
    an ``[m, K] x [K, n]`` layer: the largest tile whose grid still has a
    CTA for each of the :data:`SMS` SMs, else the smallest (a bucket's few
    rows). A function of (M, N) alone, and the tile changes no output's
    bits (the kernel's note)."""
    for i, (bm, bn) in enumerate(DENSE_TILES):
        if -(-m // bm) * -(-n // bn) >= SMS:
            return i
    return len(DENSE_TILES) - 1


def dense_plan(m: int, n: int) -> Tuple[int, int]:
    """``row_dense``'s output tile (rows, columns) at (M, N)."""
    return DENSE_TILES[dense_tile(m, n)]


def dense_splits(k: int, bf16: bool) -> int:
    """The parts ``row_dense`` cuts K into (one CTA of a cluster each,
    added in part order): bf16 cuts a K of more than four 64-wide slabs
    into ``ceil(slabs / 4)`` parts, at most 8; fp32 never cuts. A function
    of K and the type alone, as the kernel's ``splits``."""
    slabs = -(-k // 64)
    return 1 if not bf16 or slabs <= 4 else min(8, -(-slabs // 4))


def dense_ctas(m: int, n: int, k: int, bf16: bool) -> int:
    """The CTAs of ``row_dense``'s grid at (M, K, N), as planned: the
    tiles of :func:`dense_plan` times :func:`dense_splits`."""
    bm, bn = dense_plan(m, n)
    return -(-m // bm) * -(-n // bn) * dense_splits(k, bf16)


def kernel_ctas(m: int, n: int, k: int, bf16: bool) -> int:
    """The CTAs the kernel library launches at (M, K, N) on the planned
    tile (its ``row_dense_ctas``; builds the library on first use)."""
    return _kernels.load(KERNEL_DENSE).row_dense_ctas(m, n, k, int(bf16),
                                                      dense_tile(m, n))


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
    stream, on the tile :func:`dense_tile` plans, and counts one launch; it
    raises for anything the kernel does not take. On CPU tensors it
    computes the plain version in a fixed order, :func:`dense_in_slabs`."""
    if compute_dtype is not None and compute_dtype is not torch.bfloat16:
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got "
                         f"{compute_dtype!r}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            with _kernels.plain_region(
                    KERNEL_DENSE,
                    flops=2 * math.prod(x.shape[:-1]) * w.numel()):
                return dense_in_slabs(x, w, b, compute_dtype, tanh)
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
    y = x.new_empty(tuple(x.shape[:-1]) + (n,))
    m = math.prod(x.shape[:-1])
    if m == 0:
        return y
    tile = dense_tile(m, n)
    rc = _kernels.launch(dev, _kernels.entry(KERNEL_DENSE), x.data_ptr(),
                         w.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n,
                         compute_dtype is not None, tanh, tile)
    if rc != 0:
        raise RuntimeError(f"row_dense launch failed with CUDA error {rc} "
                           f"(M={m}, K={k}, N={n}, tile "
                           f"{DENSE_TILES[tile]})")
    _kernels.count(KERNEL_DENSE)
    return y


def dense_int8_plain(x, w_q, scale, b, tanh: bool = False,
                     in_slabs: bool = False):
    """The int8 layer's plain composition (the JAX ``_dense_wq``, :540-546):
    ``(x @ w_q.float()) * scale + b``, then tanh; ``in_slabs`` takes the
    product by :func:`matmul_in_slabs` (the CPU's wrapper). The card
    compares the kernel with the library's product."""
    w = w_q.float()
    y = (matmul_in_slabs(x, w) if in_slabs else torch.matmul(x, w)) \
        * scale + b
    return torch.tanh(y) if tanh else y


def dense_int8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               b: torch.Tensor, tanh: bool = False) -> torch.Tensor:
    """``act((x @ w_q) * scale + b)`` over the last axis of `x` (``[..., K]``
    fp32), `w_q` ``[K, N]`` int8, `scale` and `b` ``[N]`` fp32.

    On CUDA tensors this launches ``csrc/row_dense.cu``'s int8-weight mode
    on the current stream, on the tile :func:`dense_tile` plans, and counts
    one launch of ``row_dense_int8``: the weights are read as int8 and
    converted in registers, each output one fp32 FMA chain over K in index
    order, then ``acc * scale[n] + b[n]`` rounded as two operations. It
    raises for anything the kernel does not take (never the plain
    version). On CPU tensors it computes :func:`dense_int8_plain` in a
    fixed order."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            with _kernels.plain_region(
                    KERNEL_DENSE_INT8,
                    flops=2 * math.prod(x.shape[:-1]) * w_q.numel()):
                return dense_int8_plain(x, w_q, scale, b, tanh,
                                        in_slabs=True)
        raise ValueError(f"unsupported device {x.device}")
    _check_no_grad(x, scale, b)
    if x.dim() < 1 or w_q.dim() != 2:
        raise ValueError(f"dense_int8 needs x [..., K] and w_q [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    k, n = w_q.shape
    dev = x.device
    _kernels.check_tensor("x", x, tuple(x.shape[:-1]) + (k,), dev)
    if w_q.device != dev or w_q.dtype != torch.int8 \
            or not w_q.is_contiguous():
        raise ValueError(f"w_q must be a contiguous int8 tensor on {dev}, "
                         f"got {w_q.dtype} on {w_q.device}")
    _kernels.check_tensor("scale", scale, (n,), dev)
    _kernels.check_tensor("b", b, (n,), dev)
    y = x.new_empty(tuple(x.shape[:-1]) + (n,))
    m = math.prod(x.shape[:-1])
    if m == 0:
        return y
    tile = dense_tile(m, n)
    rc = _kernels.launch(dev, _kernels.entry(KERNEL_DENSE, KERNEL_DENSE_INT8),
                         x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                         b.data_ptr(), y.data_ptr(), m, k, n, tanh, tile)
    if rc != 0:
        raise RuntimeError(f"row_dense_int8 launch failed with CUDA error "
                           f"{rc} (M={m}, K={k}, N={n}, tile "
                           f"{DENSE_TILES[tile]})")
    _kernels.count(KERNEL_DENSE_INT8)
    return y


def sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` as ``csrc/row_sum.cu`` adds it, written in torch:
    an fp32 accumulator that starts at 0 and adds ``x.select(dim, r)`` for
    r = 0, 1, ... in order (elementwise adds, so each output's chain is its
    own on any device). The card's tests hold the kernel bitwise to it."""
    d = dim % x.dim()
    acc = x.new_zeros(x.shape[:d] + x.shape[d + 1:])
    for r in range(x.shape[d]):
        acc = acc + x.select(d, r)
    return acc


def rowwise(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` for an elementwise `fn`, with each row's bits independent
    of the rows beside it (rows along axis -2, as ``[k, B, D]`` and
    ``[B, D]`` hold them). On CUDA tensors it is ``fn(t)``: each element
    is one thread's arithmetic. On CPU tensors it applies `fn` to each row
    ``t[..., i, :]`` alone, made contiguous: the CPU's vectorized loops
    compute the elements past the last whole vector of a call by scalar
    code whose ``sigmoid`` and ``log1p`` round differently, and where that
    tail falls moves with the number of rows."""
    if t.device.type != "cpu" or t.dim() < 2:
        return fn(t)
    return torch.stack([fn(t.select(-2, i).contiguous())
                        for i in range(t.shape[-2])], dim=-2)


def sum_over(x: torch.Tensor, dim: int, fixed_order: bool) -> torch.Tensor:
    """The sum over `dim`: :func:`fixed_sum` when ``fixed_order`` (the
    serving programs on CUDA), else ``torch.sum``."""
    return fixed_sum(x, dim) if fixed_order else torch.sum(x, dim=dim)


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.sum(x, dim)`` with every output summed in index order by one
    thread: on CUDA tensors this launches ``csrc/row_sum.cu`` on the current
    stream and counts one launch (it raises for anything the kernel does not
    take); on CPU tensors it is :func:`sum_in_slabs`."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            with _kernels.plain_region(KERNEL_SUM):
                return sum_in_slabs(x, dim)
        raise ValueError(f"unsupported device {x.device}")
    _check_no_grad(x)
    if x.dim() == 0:
        raise ValueError("fixed_sum needs at least one axis")
    d = dim % x.dim()
    shape = tuple(x.shape)
    _kernels.check_tensor("x", x, shape, x.device)
    outer, r, inner = (math.prod(shape[:d]), shape[d],
                       math.prod(shape[d + 1:]))
    y = x.new_empty(shape[:d] + shape[d + 1:])
    if y.numel() == 0:
        return y
    if r == 0:
        return y.zero_()
    rc = _kernels.launch(x.device, _kernels.entry(KERNEL_SUM), x.data_ptr(),
                         y.data_ptr(), outer, r, inner)
    if rc != 0:
        raise RuntimeError(f"row_sum launch failed with CUDA error {rc} "
                           f"(outer={outer}, R={r}, inner={inner})")
    _kernels.count(KERNEL_SUM)
    return y
