"""The sample-level stochastic block with its Normal log-density, fused for
inference: ``csrc/latent_block.cu``'s wrapper and its plain version.

A stochastic block (:func:`mu_std`, which ``models.mlp`` calls
``stochastic_block_apply``) maps ``x`` to ``(mu, std)``: two tanh dense
layers, then the heads ``mu`` and ``std = exp(lstd) + std_floor``. Where it
runs at sample level (``x`` is ``[k, B, d]``: the encoder's ``q(h_i |
h_{i-1})`` for ``i >= 1`` and the prior chain's ``p(h_{i-1} | h_i)``), the
model takes its Normal log-density summed over the latent in the same
breath. Two modes:

* :func:`sample` -- ``h = mu + std * eps`` and ``sum_j log N(h_j; mu_j,
  std_j)``, ``eps`` injected or drawn here exactly as
  ``ops/distributions.normal_sample`` draws it;
* :func:`density` -- ``sum_j log N(t_j; mu_j, std_j)`` of a target ``t``.

On CUDA tensors each is one launch of ``csrc/latent_block.cu`` (the weight
prep and the row kernel, counted as one under :data:`KERNEL`): bf16
operands on the tensor cores, fp32 accumulation, nothing of ``[k, B,
hidden]``, ``mu`` or ``std`` in device memory. The kernel replaces no TPU
kernel. It has no backward, so :func:`takes` sends a block here only where
no gradient is being recorded. On CPU tensors the wrapper computes the
plain version (:func:`sample_plain`, :func:`density_plain`). These are
the model's own composition: ``models/iwae.py`` calls them wherever the
dispatcher does not take a block, so the block's arithmetic is written
once and CPU results are bitwise those of the unfused path.

:func:`takes` is the dispatcher ``models/iwae.py`` asks at each
sample-level block. It counts its decision on the telemetry registry:
``latent_block/kernel`` where the block launches the kernel,
``latent_block/plain`` where the plain arithmetic runs (the unfused path,
or the plain version on the CPU). The library is built and loaded at the
first launch, so a process that never launches it never builds it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops import row_invariant as ri_ops
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry

#: the kernel this module launches (``csrc/latent_block.cu``)
KERNEL = "latent_block"
#: the dispatcher's counters on the telemetry registry
COUNTER_KERNEL = "latent_block/kernel"
COUNTER_PLAIN = "latent_block/plain"

#: the widest reduction (input or hidden width) the kernel holds in
#: registers: ``csrc/latent_block.cu``'s 16 KS (``latent_block_fits``)
MAX_REDUCTION = 128
#: ``csrc/latent_block.cu``'s row groups per CTA and the prepared weights'
#: tile geometry (``csrc/tc_bf16.cuh``: 64-column tiles, row stride 72).
#: :func:`fits` decides without the library, so a process that never
#: launches the kernel never builds it; the card tests hold
#: :func:`smem_bytes` and :func:`fits` to the library's own functions.
GROUPS, WPG, NTILE, TS = 4, 4, 64, 72

Block = Dict[str, Dict[str, torch.Tensor]]


def launch_counts() -> dict:
    """``{KERNEL: launches}`` since the last :func:`reset_launch_counts`."""
    return _kernels.launch_counts((KERNEL,))


def reset_launch_counts() -> None:
    _kernels.reset_launch_counts((KERNEL,))


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(in_dim: int, hid: int, latent: int) -> int:
    """Dynamic shared memory of the kernel's CTA at these widths, as
    ``latent_block_smem_bytes`` states it: the resident bf16 weights in
    their prepared tiles, then per row group two ``[16, AS]`` bf16
    activation buffers and fp32 ``[16, WPG]`` partials, ``[16, IN]`` input
    rows and ``[16, L]`` eps or target rows."""
    h1p, hp = _pad16(in_dim), _pad16(hid)
    nh, nd = -(-hid // NTILE), -(-2 * latent // NTILE)
    weights = (nh * h1p + nh * hp + nd * hp) * TS * 2
    per_group = (2 * 16 * (max(h1p, hp) + 8) * 2
                 + 16 * (WPG + in_dim + latent) * 4)
    return weights + GROUPS * per_group


def fits(in_dim: int, hid: int, latent: int) -> bool:
    """Whether the kernel takes these widths: reductions it holds in
    registers, weights that stay resident in a CTA's shared memory."""
    return (_pad16(max(in_dim, hid)) <= MAX_REDUCTION
            and smem_bytes(in_dim, hid, latent) <= _kernels.MAX_SMEM_BYTES)


def _latent(p: Block) -> int:
    return p["mu"]["w"].shape[1]


def takes(cfg, p: Block, x: torch.Tensor) -> bool:
    """Whether the sample-level block `p` at `x` goes through this module:
    no gradient being recorded, bf16 matmul operands, not the row-invariant
    serving ops, and widths the kernel takes (:func:`fits`). `cfg` is
    duck-typed on ModelConfig's ``matmul_dtype`` and ``row_invariant``
    (ops/ does not import models/). Counts ``latent_block/kernel`` where the
    block will launch the kernel (CUDA tensors), ``latent_block/plain``
    otherwise."""
    use = (not torch.is_grad_enabled()
           and cfg.matmul_dtype == torch.bfloat16
           and not cfg.row_invariant
           and fits(x.shape[-1], p["l1"]["w"].shape[1], _latent(p)))
    launch = use and x.device.type == "cuda"
    get_registry().counter(COUNTER_KERNEL if launch else COUNTER_PLAIN).inc()
    return use


def counters() -> dict:
    """``{"kernel": n, "plain": n}``: the dispatcher's decisions on the
    default registry."""
    snap = get_registry().snapshot()["counters"]
    return {name: int(snap.get(f"latent_block/{name}", 0))
            for name in ("kernel", "plain")}


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def mu_std(p: Block, x, std_floor: float, compute_dtype=None,
           row_invariant: bool = False):
    """``(mu, std)`` of the conditional Gaussian given `x`: two tanh dense
    layers, then the heads, ``std = exp(lstd) + std_floor``; each layer
    ``ops/row_invariant.dense`` with ``row_invariant=True`` (the serving
    programs), else its plain composition. The stochastic block of every
    layer (``models.mlp.stochastic_block_apply`` is this function)."""
    layer = ri_ops.dense if row_invariant else ri_ops.dense_plain
    y = layer(x, p["l1"]["w"], p["l1"]["b"], compute_dtype, True)
    y = layer(y, p["l2"]["w"], p["l2"]["b"], compute_dtype, True)
    mu = layer(y, p["mu"]["w"], p["mu"]["b"], compute_dtype)
    std = torch.exp(layer(y, p["lstd"]["w"], p["lstd"]["b"],
                          compute_dtype)) + std_floor
    return mu, std


def sample_plain(p: Block, x, eps, std_floor: float,
                 compute_dtype=torch.bfloat16, *, row_invariant: bool = False,
                 stop_score: bool = False, generator=None):
    """:func:`sample`'s plain version, and the model's own sample-level
    encoder layer (``models.iwae.encode``, layers ``i >= 1``) wherever the
    dispatcher does not take it: ``h = mu + std * eps`` (`eps` None: drawn
    from `generator` by ``ops/distributions.normal_sample``) and ``sum_j
    log N(h_j; mu_j, std_j)``, summed in ``row_invariant``'s order.
    ``stop_score=True`` detaches mu and std inside the log-density only
    (DReG's and STL's score-term removal)."""
    mu, std = mu_std(p, x, std_floor, compute_dtype, row_invariant)
    h = dist.normal_sample(mu, std, generator=generator, eps=eps)
    if stop_score:
        mu, std = mu.detach(), std.detach()
    return h, ri_ops.sum_over(dist.normal_log_prob(h, mu, std), -1,
                              row_invariant)


def density_plain(p: Block, x, target, std_floor: float,
                  compute_dtype=torch.bfloat16, *,
                  row_invariant: bool = False):
    """:func:`density`'s plain version, and the model's own prior-chain
    term (``models.iwae.log_prior``) wherever the dispatcher does not take
    it: ``sum_j log N(target_j; mu_j, std_j)``, summed in
    ``row_invariant``'s order."""
    mu, std = mu_std(p, x, std_floor, compute_dtype, row_invariant)
    return ri_ops.sum_over(dist.normal_log_prob(target, mu, std), -1,
                           row_invariant)


# --------------------------------------------------------------------------
# The kernel's wrapper
# --------------------------------------------------------------------------

def sample(p: Block, x: torch.Tensor, std_floor: float,
           compute_dtype=torch.bfloat16, *, eps=None,
           generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h [..., L], log q [...])`` of the block `p` at `x` (``[..., IN]``):
    ``h = mu + std * eps`` and ``sum_j log N(h_j; mu_j, std_j)``.

    `eps` injects the standard-normal noise; without it the noise is drawn
    from `generator` with the call ``ops/distributions.normal_sample``
    makes (``torch.randn`` of the shape ``[..., L]``, fp32, on `x`'s
    device), before the block runs, which is the same point in the
    generator's stream. On CUDA tensors this launches the kernel; on CPU
    tensors it computes :func:`sample_plain`."""
    shape = tuple(x.shape[:-1]) + (_latent(p),)
    if eps is None:
        eps = torch.randn(shape, generator=generator, device=x.device,
                          dtype=torch.float32)
    elif tuple(eps.shape) != shape:
        raise ValueError(f"injected noise has shape {tuple(eps.shape)}, "
                         f"expected {shape}")
    if x.device.type == "cpu":
        with _kernels.plain_region(KERNEL):
            return sample_plain(p, x, eps, std_floor, compute_dtype)
    h = torch.empty(shape, dtype=torch.float32, device=x.device)
    return h, _launch(p, x, eps, h, std_floor, compute_dtype)


def density(p: Block, x: torch.Tensor, target: torch.Tensor,
            std_floor: float, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``sum_j log N(target_j; mu_j, std_j)`` -> ``[...]`` of the block `p`
    at `x` (``[..., IN]``), `target` ``[..., L]``. On CUDA tensors this
    launches the kernel; on CPU tensors it computes
    :func:`density_plain`."""
    if x.device.type == "cpu":
        with _kernels.plain_region(KERNEL):
            return density_plain(p, x, target, std_floor, compute_dtype)
    return _launch(p, x, target, None, std_floor, compute_dtype)


def _checked(p: Block, x, noise, device, compute_dtype) -> tuple:
    """Raise for anything the kernel does not take on `device`; returns
    ``(leading shape, IN, hidden, L)``."""
    if compute_dtype is not torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 operands only, got "
                         f"compute_dtype={compute_dtype!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, noise, *_weights(p))):
        raise RuntimeError("the latent block kernel has no backward: it "
                           "serves inference only (models/iwae.py sends a "
                           "block to it only under no_grad)")
    if x.dim() < 1:
        raise ValueError("x must be [..., IN]")
    in_dim, hid, latent = x.shape[-1], p["l1"]["w"].shape[1], _latent(p)
    if not fits(in_dim, hid, latent):
        raise ValueError(f"widths IN={in_dim}, hidden={hid}, L={latent}: "
                         f"the kernel holds reductions up to "
                         f"{MAX_REDUCTION} wide and needs "
                         f"{smem_bytes(in_dim, hid, latent)} bytes of shared "
                         f"memory, of {_kernels.MAX_SMEM_BYTES}")
    lead = tuple(x.shape[:-1])
    checks = [("x", x, lead + (in_dim,)), ("noise", noise, lead + (latent,)),
              ("l1.w", p["l1"]["w"], (in_dim, hid)),
              ("l1.b", p["l1"]["b"], (hid,)),
              ("l2.w", p["l2"]["w"], (hid, hid)),
              ("l2.b", p["l2"]["b"], (hid,))]
    for head in ("mu", "lstd"):
        checks += [(f"{head}.w", p[head]["w"], (hid, latent)),
                   (f"{head}.b", p[head]["b"], (latent,))]
    for name, t, shape in checks:
        _kernels.check_tensor(name, t, shape, device)
    return lead, in_dim, hid, latent


def _launch(p: Block, x, noise, h, std_floor: float, compute_dtype):
    """One launch over the rows of `x`; `noise` is eps (`h` given: the
    sample mode) or the target (`h` None: the density mode)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    lead, in_dim, hid, latent = _checked(p, x, noise, dev, compute_dtype)
    rows = math.prod(lead)
    lp = torch.empty(lead, dtype=torch.float32, device=dev)
    if rows == 0:
        return lp
    # the library is built and loaded here, at the first launch
    launch, scratch_bytes = _kernels.plan(KERNEL, (in_dim, hid, latent),
                                          (in_dim, hid, latent))
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    rc = _kernels.launch(
        dev, launch, x.data_ptr(), p["l1"]["w"].data_ptr(),
        p["l1"]["b"].data_ptr(), p["l2"]["w"].data_ptr(),
        p["l2"]["b"].data_ptr(), p["mu"]["w"].data_ptr(),
        p["mu"]["b"].data_ptr(), p["lstd"]["w"].data_ptr(),
        p["lstd"]["b"].data_ptr(), noise.data_ptr(),
        None if h is None else h.data_ptr(), lp.data_ptr(),
        scratch.data_ptr(), rows, in_dim, hid, latent, int(h is not None),
        float(std_floor))
    if rc != 0:
        raise RuntimeError(f"latent_block launch failed with CUDA error {rc} "
                           f"(rows={rows}, IN={in_dim}, hidden={hid}, "
                           f"L={latent})")
    _kernels.count(KERNEL)
    return lp


def _weights(p: Block):
    return tuple(p[layer][key] for layer in ("l1", "l2", "mu", "lstd")
                 for key in ("w", "b"))
