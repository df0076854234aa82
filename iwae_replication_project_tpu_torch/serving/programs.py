"""The serving programs: batched, yet row-independent (port of
``serving/programs.py``).

A micro-batching engine pads ragged request batches to shape buckets, so a
row's result must not depend on which batch it rides in, on its neighbours or
on the padding. The JAX package gets that from ``vmap`` over a per-row key
``fold_in(base_key, seed)``; here each request row gets its own
``torch.Generator``, seeded only by (engine seed, request seed) through
:func:`row_seed`, and draws its noise in a fixed per-layer order. The noise
is drawn on the host (CPU generators give the same numbers whatever device
then computes) and handed to the batched model functions as injected noise,
so the whole bucket then runs as one batched pass on the device.

All three ops share ``(params, cfg, base_seed, seeds[B], payload[B, d], ...)``
and take optional injected ``noise`` (the tests replay the JAX package's
per-row draws through it):

* score/encode noise: one ``[k, B, n_latent_enc[i]]`` tensor per encoder layer;
* decode noise: one ``[B, n_latent_dec[i]]`` tensor per decoder layer above
  the output block.

The sharded large-k programs (:func:`make_sharded_score_rows`,
:func:`make_sharded_score_adaptive`, JAX :75-169) stream k in fixed
``k_chunk`` blocks over the ``(dp, sp)`` mesh (``parallel/eval.py``'s
per-rank bodies). Row b's block g draws from a generator seeded with
``row_seed(base_seed, seeds[b], g)``, on the program's device: a k=5000
dispatch draws millions of normals, which a host draw would pace. So a
row's value is a pure function of (weights, payload, engine seed, request
seed, k, k_chunk), reduced in an order fixed by (mesh, k_chunk), and draws
on the card and on the CPU differ for the same seed. Their ``noise_fn(g,
seeds) -> [k_chunk, len(seeds), d]`` per layer replaces the draws (the
tests replay JAX's ``fold_in(fold_in(base_key, seed), g)``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.ops.logsumexp import logmeanexp
from iwae_replication_project_tpu_torch.ops.row_invariant import fixed_sum
from iwae_replication_project_tpu_torch.parallel.eval import (
    _safe,
    local_row_adaptive_log_px,
    local_row_streaming_log_px,
    merge_lse_over_sp,
)
from iwae_replication_project_tpu_torch.parallel.mesh import Mesh

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def row_seed(base_seed: int, seed: int, block: Optional[int] = None) -> int:
    """The seed of one request's generator: a pure function of the engine
    seed and the request seed (splitmix64 mixing, 63 bits); with `block`,
    of that row's sample block ``block`` of the sharded programs."""
    z = _splitmix64(_splitmix64(int(base_seed)) ^ int(seed))
    if block is not None:
        z = _splitmix64(z ^ int(block))
    return z >> 1


def noise_shapes(cfg: model.ModelConfig, op: str, k: int = 0) -> List[tuple]:
    """Per-row shapes of `op`'s draws, in draw order."""
    if op in ("score", "encode"):
        return [(k, d) for d in cfg.n_latent_enc]
    if op == "decode":
        return [(d,) for d in cfg.n_latent_dec[:-1]]
    raise ValueError(f"unknown op {op!r}")


def draw_noise(cfg: model.ModelConfig, op: str, base_seed: int,
               seeds: Sequence[int], k: int = 0) -> List[torch.Tensor]:
    """The batch's standard-normal noise, on the host: row b's generator is
    seeded with ``row_seed(base_seed, seeds[b])`` and draws each layer in
    order. score/encode tensors are ``[k, B, d]``, decode ``[B, d]``."""
    shapes = noise_shapes(cfg, op, k)
    per_layer: List[List[torch.Tensor]] = [[] for _ in shapes]
    for seed in seeds:
        g = torch.Generator().manual_seed(row_seed(base_seed, seed))
        for i, shape in enumerate(shapes):
            per_layer[i].append(torch.randn(shape, generator=g))
    dim = 1 if op in ("score", "encode") else 0
    return [torch.stack(rows, dim=dim) for rows in per_layer]


def _noise_on(noise, device):
    return [n.to(device, non_blocking=True) for n in noise]


@torch.inference_mode()
def score_rows(params, cfg: model.ModelConfig, base_seed: int,
               seeds: Sequence[int], x: torch.Tensor, k: int, *,
               noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """Per-request k-sample IWAE log-likelihood estimate ``[B]``:
    ``log p(x_i) ~= logmeanexp_k(log w)``."""
    if noise is None:
        noise = draw_noise(cfg, "score", base_seed, seeds, k)
    log_w = model.log_weights(params, cfg, x, k,
                              eps=_noise_on(noise, x.device))   # [k, B]
    # iwae_per_example's logmeanexp over k, its sum in a fixed order on CUDA
    return logmeanexp(log_w, dim=0, fixed_order=cfg.row_invariant)


@torch.inference_mode()
def encode_rows(params, cfg: model.ModelConfig, base_seed: int,
                seeds: Sequence[int], x: torch.Tensor, k: int, *,
                noise: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Posterior representation per request: the k-sample mean of the
    deepest latent ``[B, n_latent_enc[-1]]``."""
    if noise is None:
        noise = draw_noise(cfg, "encode", base_seed, seeds, k)
    h, _, _ = model.encode(params, cfg, x, k, eps=_noise_on(noise, x.device))
    if cfg.row_invariant:
        return fixed_sum(h[-1], 0) / k
    return torch.mean(h[-1], dim=0)


@torch.inference_mode()
def decode_rows(params, cfg: model.ModelConfig, base_seed: int,
                seeds: Sequence[int], h_top: torch.Tensor, *,
                noise: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Ancestral decode of deepest-latent rows -> pixel probabilities
    ``[B, x_dim]``."""
    if noise is None:
        noise = draw_noise(cfg, "decode", base_seed, seeds)
    eps = [n[None] for n in _noise_on(noise, h_top.device)]     # [1, B, d]
    return model.generate_x(params, cfg, h_top[None], eps=eps)[0]


#: op name -> (program, takes k?)
PROGRAMS = {
    "score": (score_rows, True),
    "encode": (encode_rows, True),
    "decode": (decode_rows, False),
}

def program_bytes(cfg: model.ModelConfig, op: str, k: int,
                  bucket: int) -> int:
    """The executable store's bill of one program at (k, bucket): fp32
    bytes of its static buffers (payload, per-layer noise, output) plus its
    largest live activations, the counterpart of the JAX entries'
    ``peak_bytes``. Live at the peak: every latent sample drawn so far and
    the ``[rows]`` log-density carries, plus the input and output of the
    widest dense layer at the program's rows (``k * bucket`` for score and
    encode; ``bucket`` for decode and the first encoder block). A fused
    decoder block (the hot-loop kernel) keeps its activations on chip and
    adds its ``[rows]`` output."""
    f = 4
    enc = list(zip([cfg.x_dim] + list(cfg.n_latent_enc[:-1]),
                   cfg.n_hidden_enc, cfg.n_latent_enc))
    top_down = list(cfg.n_latent_enc[::-1][:1]) + list(cfg.n_latent_dec)
    dec = list(zip(top_down[:-2], cfg.n_hidden_dec[:-1],
                   cfg.n_latent_dec[:-1]))
    out_block = (top_down[-2], cfg.n_hidden_dec[-1], cfg.x_dim)

    def widest(blocks, rows):
        # a stochastic block's l1, l2 and its two heads
        return max([rows * (i + h) for i, h, _ in blocks]
                   + [rows * (h + h) for _, h, _ in blocks]
                   + [rows * (h + 2 * o) for _, h, o in blocks] + [0])

    if op == "decode":
        rows = bucket
        static = rows * (cfg.n_latent_enc[-1] + sum(cfg.n_latent_dec[:-1])
                         + cfg.x_dim)
        i, h, o = out_block
        peak = max(widest(dec, rows),
                   rows * max(i + h, 2 * h, h + 2 * o))
        return f * (static + peak)
    rows = k * bucket
    static = bucket * cfg.x_dim + rows * sum(cfg.n_latent_enc) + (
        bucket if op == "score" else bucket * cfg.n_latent_enc[-1])
    # the first encoder block runs on the payload rows, before the fan-out
    peak = max(widest(enc[:1], bucket), widest(enc[1:], rows))
    if op == "score":
        i, h, o = out_block
        peak = max(peak, widest(dec, rows), rows if cfg.fused_likelihood
                   else rows * max(i + h, 2 * h, h + 2 * o))
    kept = rows * (sum(cfg.n_latent_enc) + 2)
    return f * (static + peak + kept)


def static_cost(cfg: model.ModelConfig, op: str, k: int,
                bucket: int) -> dict:
    """The static cost record of one program at (k, bucket), the counterpart
    of the JAX store's trace-time ``static_cost`` (the port traces nothing):
    ``flops``, the analytic matmul FLOPs of the program's layers at the
    bucket's rows (``utils/flops.py``'s accounting: score the whole forward,
    encode the encoder, decode the decoder), and ``bytes_accessed_fused``,
    the traffic no schedule avoids: the weights the program reads, at their
    dtype, plus the payload, the injected noise and the output, each read
    or written once. The profiler divides by it (``prof/hbm_frac``,
    ``static_floor_s``)."""
    from iwae_replication_project_tpu_torch.utils.flops import (
        forward_flops,
        output_block_macs,
        stochastic_block_macs,
    )

    def block_params(i, h, o):          # weights and biases
        return stochastic_block_macs(i, h, o) + 2 * h + 2 * o

    enc = list(zip([cfg.x_dim] + list(cfg.n_latent_enc[:-1]),
                   cfg.n_hidden_enc, cfg.n_latent_enc))
    top_down = list(cfg.n_latent_enc[-1:]) + list(cfg.n_latent_dec)
    dec = list(zip(top_down[:-2], cfg.n_hidden_dec[:-1],
                   cfg.n_latent_dec[:-1]))
    i, h, o = top_down[-2], cfg.n_hidden_dec[-1], cfg.x_dim
    out_macs = output_block_macs(i, h, o)
    enc_params = sum(block_params(*b) for b in enc)
    dec_params = sum(block_params(*b) for b in dec) + out_macs + 2 * h + o
    dec_macs = sum(stochastic_block_macs(*b) for b in dec) + out_macs
    w = 4       # weights, payload, noise and output are all stored fp32
    if op == "decode":
        flops = 2.0 * bucket * dec_macs
        weights = dec_params
        io = bucket * (cfg.n_latent_enc[-1] + sum(cfg.n_latent_dec[:-1])
                       + cfg.x_dim)
    else:
        noise = k * bucket * sum(cfg.n_latent_enc)
        payload = bucket * cfg.x_dim
        if op == "score":
            flops = forward_flops(cfg, bucket, k)
            weights = enc_params + dec_params
            io = payload + noise + bucket
        else:
            first = stochastic_block_macs(*enc[0])
            flops = 2.0 * (bucket * first + k * bucket * sum(
                stochastic_block_macs(*b) for b in enc[1:]))
            weights = enc_params
            io = payload + noise + bucket * cfg.n_latent_enc[-1]
    return {"flops": float(flops),
            "bytes_accessed_fused": float(w * (weights + io))}


#: op name -> the program arguments whose leading axis carries the engine's
#: zero-filled padding rows (the JAX audit's contract, :188-203): a padded
#: row must never reach a real row's result
PADDED_ROW_KWARGS = {
    "score": ("seeds", "x"),
    "encode": ("seeds", "x"),
    "decode": ("seeds", "h_top"),
    "score_sharded": ("seeds", "x"),
    "score_adaptive": ("seeds", "x"),
}


# --------------------------------------------------------------------------
# the sharded large-k programs
# --------------------------------------------------------------------------

#: ``noise_fn(g, seeds) -> [k_chunk, len(seeds), d]`` per encoder layer
NoiseFn = Callable[[int, List[int]], List[torch.Tensor]]


def draw_block_noise(cfg: model.ModelConfig, base_seed: int,
                     seeds: Sequence[int], blocks: Sequence[Optional[int]],
                     k_chunk: int, device) -> List[torch.Tensor]:
    """Row b's draws of global block ``blocks[b]`` (zeros for None), drawn
    on `device` from a generator seeded with ``row_seed(base_seed,
    seeds[b], blocks[b])``, layer by layer: ``[k_chunk, B, d]`` per
    encoder layer."""
    dims = cfg.n_latent_enc
    out = [torch.zeros((len(seeds), k_chunk, d), device=device)
           for d in dims]
    gen = torch.Generator(device=device)
    for b, (seed, g) in enumerate(zip(seeds, blocks)):
        if g is None:
            continue
        gen.manual_seed(row_seed(base_seed, seed, g))
        for t in out:
            torch.randn(t.shape[1:], generator=gen, out=t[b])
    # contiguous: the encoder's products on a strided view take another
    # path whose bits depend on the batch size
    return [t.transpose(0, 1).contiguous() for t in out]


def _block_noise(cfg, base_seed: int, seeds: List[int], k_chunk: int,
                 device, noise_fn: Optional[NoiseFn]):
    """The per-rank bodies' ``noise(blocks)``: the device draws, or
    `noise_fn`'s, one call per distinct block."""
    if noise_fn is None:
        return lambda blocks: draw_block_noise(cfg, base_seed, seeds, blocks,
                                               k_chunk, device)

    def replay(blocks):
        out = [torch.zeros((k_chunk, len(seeds), d), device=device)
               for d in cfg.n_latent_enc]
        for g in sorted({b for b in blocks if b is not None}):
            cols = [i for i, b in enumerate(blocks) if b == g]
            for t, e in zip(out, noise_fn(g, [seeds[i] for i in cols])):
                t[:, cols] = e.to(device)
        return out
    return replay


def _local_rows(mesh: Mesh, seeds, x: torch.Tensor):
    """This rank's ``B/dp`` seeds and rows, and where they start."""
    b = x.shape[0] // mesh.dp
    lo = mesh.dp_rank * b
    return [int(s) for s in seeds[lo:lo + b]], x[lo:lo + b], lo


def _gather_rows(mesh: Mesh, local: torch.Tensor, n: int,
                 lo: int) -> torch.Tensor:
    """Every dp row's results on every rank: sp rank 0 of each dp row writes
    its rows into a zero ``[n, ...]`` buffer, summed over the world (the
    identity in a world of one)."""
    if mesh.device_mesh is None:
        return local
    out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    if mesh.sp_rank == 0:
        out[lo:lo + local.shape[0]] = local
    return mesh.all_reduce(out, "sum")


def _check_rows(mesh: Mesh, seeds, x: torch.Tensor) -> None:
    if x.shape[0] % mesh.dp or len(seeds) != x.shape[0]:
        raise ValueError(f"a sharded dispatch needs a multiple of dp="
                         f"{mesh.dp} rows and one seed per row, got "
                         f"{x.shape[0]} rows and {len(seeds)} seeds")


def make_sharded_score_rows(cfg: model.ModelConfig, mesh: Mesh,
                            k_chunk: int = 250):
    """The mesh-sharded large-k ``score`` program (JAX :75-125):
    ``(params, base_seed, seeds[B], x[B, d], k, *, noise_fn=None) -> [B]``
    log p_hat(x) on every rank, the rows over dp and k's blocks over sp,
    the carries merged with one MAX and one SUM over sp. One program serves
    every k: the loop runs ``ceil(ceil(k/k_chunk)/sp)`` blocks a rank and
    masks the ragged tail."""
    @torch.inference_mode()
    def program(params, base_seed: int, seeds, x: torch.Tensor, k: int, *,
                noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
        _check_rows(mesh, seeds, x)
        seeds_l, x_l, lo = _local_rows(mesh, seeds, x)
        noise = _block_noise(cfg, base_seed, seeds_l, k_chunk, x.device,
                             noise_fn)
        st = merge_lse_over_sp(mesh, local_row_streaming_log_px(
            params, cfg, mesh, x_l, int(k), k_chunk, noise))
        log_k = torch.log(torch.full_like(st.s, float(k)))
        return _gather_rows(mesh, torch.log(st.s) + _safe(st.m) - log_k,
                            x.shape[0], lo)
    return program


def make_sharded_score_adaptive(cfg: model.ModelConfig, mesh: Mesh,
                                k_chunk: int = 250):
    """The accuracy-targeted ``score_adaptive`` program (JAX :128-169):
    ``(params, base_seed, seeds[B], x[B, d], k_cap, target_se, ess_floor,
    *, n_real=None, noise_fn=None) -> [B, 3]`` rows of ``(log p_hat,
    achieved se, k_used)`` on every rank, each row stopped at the first
    prefix of its stream whose SE (or ESS) meets the target (<= 0 disables
    one), capped at ``k_cap``; see
    ``parallel.eval.local_row_adaptive_log_px``. Only the first `n_real`
    rows (None: all) hold the loop up."""
    @torch.inference_mode()
    def program(params, base_seed: int, seeds, x: torch.Tensor, k_cap: int,
                target_se: float, ess_floor: float, *,
                n_real: Optional[int] = None,
                noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
        _check_rows(mesh, seeds, x)
        seeds_l, x_l, lo = _local_rows(mesh, seeds, x)
        noise = _block_noise(cfg, base_seed, seeds_l, k_chunk, x.device,
                             noise_fn)
        real = None if n_real is None else int(n_real) - lo
        out = local_row_adaptive_log_px(
            params, cfg, mesh, x_l, int(k_cap), float(target_se),
            float(ess_floor), k_chunk, noise, n_real=real)
        return _gather_rows(mesh, out, x.shape[0], lo)
    return program
