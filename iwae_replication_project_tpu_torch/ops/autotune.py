"""Measured winners for the hot loop's launch shape and path (port of
``ops/autotune.py``).

The dispatcher's hand rules (``ops/hot_loop.select_path``, B1's
``fwd_groups``, the blocked scan's ~32 MiB slab) were chosen from
arithmetic, never searched. This module searches what the dispatcher picks
from and persists what it measures:

* **kinds** (:data:`KINDS`) and their candidates --

  - ``fwd``: the kernel (B1) at 1..4 row groups per CTA in bf16, or its one
    fp32 launch; the blocked scan over the divisor ladder of k; the
    reference. ``serving_row`` is the same menu at a serving (k, bucket),
    with the row-invariant ops where the serving programs run them (CUDA);
  - ``bwd``: the kernel pair (B1 then B2 as launched today: B2's row splits
    fix the order its weight gradients are summed in, which bitwise resume
    and replayed steps depend on, so they are not searched) against the
    blocked scan's and the reference's autograd backward. B2 has no tile to
    tune, so no dispatcher reads this kind: its winner is recorded for the
    operator;
  - ``scan``: the blocked scan's slab height ``block_k`` alone;
  - ``serving_int8``: the int8 row program (``hot_loop.decoder_score_int8``)
    against the exact fp32 program the engine would otherwise serve at that
    (k, bucket). The winner's path (``int8`` or ``reference``) is
    ``hot_loop.serving_int8_admit``'s verdict.

  The B1 groups never change a row's bits (``csrc/hot_loop_fwd.cu``), so a
  measured choice changes speed only. The hand rule's own candidate is
  always in the menu, and its time lands beside the winner's.

* **measurement** -- kernel candidates are measured only on CUDA (the
  counterpart of JAX's "pallas only on TPU"): a CPU search leaves them out.
  On the card each candidate is warmed and captured in a CUDA graph the
  way the executable store captures (``compile_cache.capture_graph``), so
  an engine's in-line race leaves the other engines on the card serving;
  it is timed as the best of ``reps`` runs of 10 replays between CUDA
  events, waiting on those events alone. On the CPU: one warm run, then
  the best of ``reps`` by ``time.perf_counter``. A candidate whose build,
  launch or capture fails is discarded and counted
  (``autotune/probe_failures``); the search goes on. Probes leave the
  kernels' launch counts as they were. Searches take turns in the process,
  so two engines racing one shape at once measure it once. The search is
  ordered by a roofline prior from
  ``utils/flops.py``'s H100 row, the larger of FLOPs over peak and bytes
  over HBM bandwidth (the JAX module's prior reads the jaxpr cost analysis,
  which this package does not have).

* **keys** -- ``kind|k|b|h1|hid|d|dt|arch=sm_XY|dev=<device name>|kv=<digest
  of csrc/>`` in place of the JAX key's chip and VMEM budget: a winner
  measured on another card, another architecture or an earlier kernel
  source never ranks this one, and :data:`AUTOTUNE_VERSION` invalidates the
  whole file.

* **cache** -- a versioned JSON file at the explicit path, else
  ``IWAE_AUTOTUNE_CACHE`` (``off``/``none``/``0``: memory only); with
  neither the winners live in memory only. A warm cache makes :func:`tune`
  a pure lookup: no timed run. A corrupt file warns and the hand rules
  stand.

Consumers: ``hot_loop.select_path`` (``fwd``), ``hot_loop.decoder_score``
(a ``fwd`` kernel winner's groups), ``hot_loop._scan_block_k`` (``scan``),
``hot_loop.serving_dispatch_config`` (``serving_row``) and
``hot_loop.serving_int8_admit`` (``serving_int8``). No cache, no change.

Telemetry (the port's registry): ``autotune/searches``,
``autotune/tune_cache_hits``, ``autotune/probe_compiles`` (candidates
tried), ``autotune/probe_failures``, ``autotune/timed_runs``,
``autotune/lookup_hits``, ``autotune/lookup_misses``,
``autotune/cache_corrupt``, ``autotune/version_mismatch``; spans
``span/autotune/search`` and ``span/autotune/measure``.

CLI: ``python -m iwae_replication_project_tpu_torch.ops.autotune --k 50
--buckets 1,2,4,8,16,32,64 --kinds serving_row,serving_int8 --cache PATH
[--device cpu]`` tunes the flagship's output block (:func:`main`).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.ops import hot_loop as hl
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry
from iwae_replication_project_tpu_torch.telemetry.spans import span
from iwae_replication_project_tpu_torch.utils import compile_cache as cc
from iwae_replication_project_tpu_torch.utils.sizes import (
    largest_divisor_leq,
)

#: bump when the record schema, the candidates or the measurement change
#: incompatibly: every cached winner then misses
AUTOTUNE_VERSION = 1

KINDS = ("fwd", "bwd", "scan", "serving_row", "serving_int8")

#: B1's row-group candidates in bf16
GROUP_CANDIDATES = tuple(range(1, hl.MAX_GROUPS + 1))

#: graph replays per timed run on the card
REPLAYS = 10


# ---------------------------------------------------------------------------
# keys, store, persistence
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def kernel_digest() -> str:
    """A digest of every kernel source and header under ``csrc/``: a winner
    measured on one kernel must not rank a redesigned one."""
    h = hashlib.sha256()
    for p in sorted(_kernels.SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=16)
def _card(index: int) -> Tuple[str, str]:
    major, minor = torch.cuda.get_device_capability(index)
    return f"sm_{major}{minor}", torch.cuda.get_device_name(index)


def device_identity(device) -> Tuple[str, str]:
    """``(arch, device name)`` of the key: ``("sm_90", "NVIDIA H100 ...")``
    for a card, ``("cpu", "cpu")`` for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", "cpu"
    return _card(dev.index if dev.index is not None
                 else torch.cuda.current_device())


def _dtype_name(compute_dtype) -> str:
    if compute_dtype in (None, "float32", torch.float32):
        return "f32"
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return "bfloat16"
    raise ValueError(f"compute_dtype must be None or bfloat16, got "
                     f"{compute_dtype!r}")


def entry_key(kind: str, k: int, b: int, h1_dim: int, hid: int,
              n_pixels: int, compute_dtype, *, device=None,
              arch: Optional[str] = None, dev_name: Optional[str] = None,
              digest: Optional[str] = None) -> str:
    """The cache key: kind, shape, compute dtype, the card's architecture
    and name, and the kernel sources' digest. Each of the last three can be
    given (tests), else comes from `device` and ``csrc/``."""
    if kind not in KINDS:
        raise ValueError(f"unknown autotune kind {kind!r}; choose {KINDS}")
    if arch is None or dev_name is None:
        a, n = device_identity("cpu" if device is None else device)
        arch = a if arch is None else arch
        dev_name = n if dev_name is None else dev_name
    digest = kernel_digest() if digest is None else digest
    return (f"{kind}|k={int(k)}|b={int(b)}|h1={int(h1_dim)}|hid={int(hid)}"
            f"|d={int(n_pixels)}|dt={_dtype_name(compute_dtype)}"
            f"|arch={arch}|dev={dev_name}|kv={digest}")


def cache_path(explicit: Optional[str] = None) -> Optional[str]:
    """Where the winners persist: `explicit`, else ``IWAE_AUTOTUNE_CACHE``
    (``off``/``none``/``0`` = memory only), else None (memory only)."""
    if explicit is not None:
        return explicit
    env = os.environ.get("IWAE_AUTOTUNE_CACHE")
    if env:
        return None if env.strip().lower() in ("off", "none", "0") else env
    return None


def _count(name: str, n: float = 1) -> None:
    get_registry().counter(f"autotune/{name}").inc(n)


#: the process's winner store: the resolved path, its entries, and a
#: generation that moves whenever the entries do (memos key on it)
_store: Dict[str, Any] = {"path": None, "entries": None, "generation": 0}
_store_lock = threading.Lock()
#: one search at a time in the process: a second engine racing a shape
#: that is being searched waits, then finds the first one's winner
_search_lock = threading.Lock()


def _load_entries(path: Optional[str]) -> Dict[str, dict]:
    """Read and validate the winner file. A missing file or another version
    is a quiet miss; a corrupt file warns (the tuning paid for is gone) and
    leaves the hand rules standing (an empty store)."""
    if path is None or not os.path.exists(path):
        return {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or not isinstance(doc.get("entries"),
                                                       dict):
            raise ValueError("not an autotune cache document")
    except (OSError, ValueError) as e:
        _count("cache_corrupt")
        warnings.warn(
            f"autotune cache {path!r} is corrupt ({type(e).__name__}: "
            f"{str(e)[:200]}); falling back to the hand rules -- re-run "
            f"python -m iwae_replication_project_tpu_torch.ops.autotune to "
            f"rebuild it", RuntimeWarning, stacklevel=3)
        return {}
    if doc.get("version") != AUTOTUNE_VERSION:
        _count("version_mismatch")
        return {}
    return dict(doc["entries"])


def get_store(path: Optional[str] = None) -> Dict[str, dict]:
    """The winner entries, read once per resolved path."""
    p = cache_path(path)
    with _store_lock:
        if _store["entries"] is None or _store["path"] != p:
            _store["entries"] = _load_entries(p)
            _store["path"] = p
            _store["generation"] += 1
        return _store["entries"]


def store_generation() -> int:
    """A number that changes whenever the winners may have: a reload, a
    change of path or a new winner."""
    get_store()
    return _store["generation"]


def reload_store() -> None:
    """Drop the in-memory winners so the next lookup reads the file again
    (tests, and operators who tuned in another process)."""
    with _store_lock:
        _store["entries"] = None
        _store["path"] = None
        _store["generation"] += 1


def _save_store(path: str, entries: Dict[str, dict]) -> None:
    """Write the file whole (a temporary file, then a rename): a reader
    never sees a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {"version": AUTOTUNE_VERSION, "entries": entries}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def winner_for(kind: str, k: int, b: int, h1_dim: int, hid: int,
               n_pixels: int, compute_dtype, *, device=None,
               path: Optional[str] = None) -> Optional[dict]:
    """The cached winner record for this exact (kind, shape, dtype, card,
    kernel sources), or None: the dispatcher's consultation point."""
    entries = get_store(path)
    if not entries:
        return None
    rec = entries.get(entry_key(kind, k, b, h1_dim, hid, n_pixels,
                                compute_dtype, device=device))
    _count("lookup_hits" if rec is not None else "lookup_misses")
    return rec


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Candidate:
    """One point of the search: a path and its tuning parameter."""

    path: str                         # kernel | blocked_scan | reference | int8
    groups: Optional[int] = None      # kernel, bf16 only: B1's row groups
    block_k: Optional[int] = None     # blocked_scan only
    estimated_ms: Optional[float] = None   # the roofline prior

    def label(self) -> str:
        if self.path == "kernel":
            return "kernel" if self.groups is None \
                else f"kernel(groups={self.groups})"
        if self.path == "blocked_scan":
            return f"blocked_scan(bk={self.block_k})"
        if self.path == "int8":
            return "int8(weight-only)"
        return "reference"


def _scan_blocks(k: int, extra: Optional[int] = None) -> List[int]:
    """The divisor ladder of k (1, k/8, k/4, k/2, k), plus `extra`."""
    targets = {1, max(1, k // 8), max(1, k // 4), max(1, k // 2), k}
    if extra:
        targets.add(extra)
    return sorted({largest_divisor_leq(k, t) for t in targets})


def _hand_scan_block(k: int, b: int, hid: int, n_pixels: int) -> int:
    return largest_divisor_leq(k, hl._scan_block_k(k, b, hid, n_pixels))


def candidates_for(kind: str, k: int, b: int, h1_dim: int, hid: int,
                   n_pixels: int, compute_dtype=None, *,
                   include_kernel: bool = False) -> List[Candidate]:
    """The search space of one (kind, shape). `include_kernel` is whether
    the kernel candidates can run (CUDA): off the card they are left out,
    since a CPU "kernel" would time its plain version."""
    bf16 = _dtype_name(compute_dtype) == "bfloat16"
    hand_bk = _hand_scan_block(k, b, hid, n_pixels)
    kernels = ([Candidate("kernel", groups=g) for g in GROUP_CANDIDATES]
               if bf16 else [Candidate("kernel")]) if include_kernel else []
    scans = [Candidate("blocked_scan", block_k=bk)
             for bk in _scan_blocks(k, hand_bk)]
    if kind in ("fwd", "serving_row"):
        return kernels + scans + [Candidate("reference")]
    if kind == "bwd":
        return ([Candidate("kernel")] if include_kernel else []) + scans \
            + [Candidate("reference")]
    if kind == "scan":
        return scans
    if kind == "serving_int8":
        return [Candidate("int8"), Candidate("reference")]
    raise ValueError(f"unknown autotune kind {kind!r}; choose {KINDS}")


def hand_rule(kind: str, k: int, b: int, h1_dim: int, hid: int,
              n_pixels: int, compute_dtype=None, *,
              device=None) -> Candidate:
    """The candidate the hand rules pick with no winner: the kernel on CUDA
    at ``hot_loop.fwd_groups``'s groups (bf16), else the threshold's choice;
    the ~32 MiB slab for ``scan``; the fp32 program for ``serving_int8``
    (int8 is never admitted unmeasured)."""
    dev = torch.device("cpu" if device is None else device)
    bf16 = _dtype_name(compute_dtype) == "bfloat16"
    if kind == "scan":
        return Candidate("blocked_scan",
                         block_k=_hand_scan_block(k, b, hid, n_pixels))
    if kind == "serving_int8":
        return Candidate("reference")
    path = hl._hand_rule(dev, "auto", (h1_dim, hid, bf16), (k, b, n_pixels))
    if path == "kernel":
        if kind == "bwd" or not bf16:
            return Candidate("kernel")
        return Candidate("kernel", groups=hl.fwd_groups(k * b))
    if path == "blocked_scan":
        return Candidate("blocked_scan",
                         block_k=_hand_scan_block(k, b, hid, n_pixels))
    return Candidate("reference")


def _prior_ms(kind: str, cand: Candidate, k: int, b: int, h1_dim: int,
              hid: int, n_pixels: int, compute_dtype) -> float:
    """The roofline prior that orders the search: the larger of the block's
    matmul FLOPs over the H100's bf16 peak and the bytes the candidate must
    move over its HBM bandwidth (``utils/flops.py``'s H100 row). The kernel
    keeps its activations on chip; the others write and read two hiddens
    and the logits once per pass; int8 reads its weights as bytes."""
    from iwae_replication_project_tpu_torch.utils.flops import (
        output_block_macs,
        peak_flops_for_card,
        peak_hbm_bytes_for_card,
    )

    peak, _ = peak_flops_for_card("NVIDIA H100 80GB HBM3")
    bw, _ = peak_hbm_bytes_for_card("NVIDIA H100 80GB HBM3")
    rows = k * b
    passes = 3 if kind == "bwd" else 1
    flops = 2.0 * rows * output_block_macs(h1_dim, hid, n_pixels) * passes
    weights = h1_dim * hid + hid * hid + hid * n_pixels
    nbytes = 4.0 * (rows * h1_dim + b * n_pixels + rows) \
        + (1.0 if cand.path == "int8" else 4.0) * weights
    if cand.path != "kernel":
        nbytes += 2 * 4.0 * rows * (2 * hid + n_pixels) * passes
    return 1e3 * max(flops / peak, nbytes / bw)


# ---------------------------------------------------------------------------
# candidate programs and measurement
# ---------------------------------------------------------------------------

def _operands(kind: str, k: int, b: int, h1_dim: int, hid: int,
              n_pixels: int, device, seed: int = 0) -> tuple:
    """Seeded operands at the real shape, on `device`: ``h1 [k, b, H1]``,
    the block's weights and biases, binary ``x [b, D]``; for
    ``serving_int8`` also the quantized block, made outside the timed
    program as the engine makes it once at load."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    arrs = [rs.randn(k, b, h1_dim).astype(f32) * 0.5,
            rs.randn(h1_dim, hid).astype(f32) * 0.2,
            rs.randn(hid).astype(f32) * 0.1,
            rs.randn(hid, hid).astype(f32) * 0.2,
            rs.randn(hid).astype(f32) * 0.1,
            rs.randn(hid, n_pixels).astype(f32) * 0.2,
            rs.randn(n_pixels).astype(f32) * 0.1,
            (rs.rand(b, n_pixels) > 0.5).astype(f32)]
    args = tuple(torch.from_numpy(a).to(device) for a in arrs)
    if kind == "serving_int8":
        w1, b1, w2, b2, w3, b3 = args[1:7]
        args += (hl.quantize_out_block(
            {"l1": {"w": w1, "b": b1}, "l2": {"w": w2, "b": b2},
             "out": {"w": w3, "b": b3}}),)
    return args


def _candidate_fn(kind: str, cand: Candidate, k: int, b: int, h1_dim: int,
                  hid: int, n_pixels: int, compute_dtype,
                  device) -> Callable:
    """The program of one candidate, the functions ``decoder_score``
    dispatches to at the same shape; the serving kinds run the
    row-invariant ops on CUDA, as the serving programs do."""
    cd = torch.bfloat16 if _dtype_name(compute_dtype) == "bfloat16" \
        else None
    ri = torch.device(device).type == "cuda" and kind.startswith("serving")

    def fwd(h1, w1, b1, w2, b2, w3, b3, x, *_):
        if cand.path == "kernel":
            if kind == "bwd":
                return hl.FusedBlockLL.apply(h1, w1, b1, w2, b2, w3, b3, x,
                                             cd, 0)
            return hl.fused_forward(h1, w1, b1, w2, b2, w3, b3, x, cd,
                                    cand.groups or 0)
        if cand.path == "blocked_scan":
            return hl._blocked_scan_impl(h1, w1, b1, w2, b2, w3, b3, x,
                                         block_k=cand.block_k,
                                         compute_dtype=cd, row_invariant=ri)
        return hl._reference_impl(h1, w1, b1, w2, b2, w3, b3, x, cd, ri)

    if kind == "serving_int8":
        fp32_path = hl._hand_rule(torch.device(device), "auto",
                                  (h1_dim, hid, False), (k, b, n_pixels))

        @torch.inference_mode()
        def race(h1, w1, b1, w2, b2, w3, b3, x, out_q):
            if cand.path == "int8":
                return hl.decoder_score_int8(out_q, x, h1, row_invariant=ri)
            if fp32_path == "kernel":
                return hl.fused_forward(h1, w1, b1, w2, b2, w3, b3, x)
            if fp32_path == "blocked_scan":
                return hl._blocked_scan_impl(
                    h1, w1, b1, w2, b2, w3, b3, x,
                    block_k=hl._scan_block_k(k, b, hid, n_pixels),
                    row_invariant=ri)
            return hl._reference_impl(h1, w1, b1, w2, b2, w3, b3, x, None,
                                      ri)
        return race

    if kind == "bwd":
        def bwd(h1, w1, b1, w2, b2, w3, b3, x):
            with torch.enable_grad():
                ps = [t.detach().requires_grad_(True)
                      for t in (h1, w1, b1, w2, b2, w3, b3)]
                return torch.autograd.grad(fwd(*ps, x).sum(), ps)
        return bwd
    return torch.inference_mode()(fwd)


def _time_on_card(fn: Callable, args: tuple, reps: int, device) -> float:
    """Device ms of one call of `fn` on the card: warmed and captured in a
    CUDA graph as the store captures its programs
    (``compile_cache.capture_graph``: one capture at a time, a
    high-priority side stream, ``thread_local`` mode; the serving programs
    and the train step replay graphs, so the host's launch work is not what
    they pay), then the best of `reps` runs of :data:`REPLAYS` replays on
    the caller's stream between CUDA events. It waits on its own events
    alone: other engines on the card go on meanwhile."""
    graph, out, _ = cc.capture_graph(fn, args, device, inference=False)
    try:
        cur = torch.cuda.current_stream(device)
        graph.replay()
        best = float("inf")
        for _ in range(max(int(reps), 1)):
            _count("timed_runs")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(cur)
            for _ in range(REPLAYS):
                graph.replay()
            end.record(cur)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / REPLAYS)
        return best
    finally:
        with cc._capture_lock:
            del graph, out


def _measure_candidate(fn: Callable, args: tuple, reps: int,
                       device=None) -> Optional[float]:
    """The candidate's ms: on the card its device time per call
    (:func:`_time_on_card`), on the CPU one warm run, then the best of
    `reps` runs by ``time.perf_counter``. None when it fails to build,
    launch or be captured (discarded, counted). The kernels' launch counts
    are left as they were: a probe is not a launch of the program."""
    device = torch.device("cpu" if device is None else device)
    _count("probe_compiles")
    with _kernels.recording() as tally:
        try:
            if device.type == "cuda":
                return _time_on_card(fn, args, reps, device)
            fn(*args)
            best = float("inf")
            for _ in range(max(int(reps), 1)):
                _count("timed_runs")
                t0 = time.perf_counter()
                fn(*args)
                best = min(best, 1e3 * (time.perf_counter() - t0))
            return best
        except (RuntimeError, ValueError) as e:
            _count("probe_failures")
            warnings.warn(f"autotune: a candidate failed ({type(e).__name__}"
                          f": {str(e)[:200]}); it is discarded",
                          RuntimeWarning, stacklevel=3)
            return None
        finally:
            _kernels.add_launches(tally, -1)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _search(kind: str, k: int, b: int, h1_dim: int, hid: int,
            n_pixels: int, compute_dtype, dev: torch.device, reps: int,
            include_kernel: bool, measure: Callable) -> dict:
    """Measure every candidate of one (kind, shape) in the prior's order;
    return the winner record (:func:`tune`)."""
    _count("searches")
    hand = hand_rule(kind, k, b, h1_dim, hid, n_pixels, compute_dtype,
                     device=dev)
    with span("autotune/search"):
        cands = candidates_for(kind, k, b, h1_dim, hid, n_pixels,
                               compute_dtype, include_kernel=include_kernel)
        if not cands:
            raise ValueError(f"no candidates for {kind} at k={k} b={b}")
        for c in cands:
            c.estimated_ms = _prior_ms(kind, c, k, b, h1_dim, hid, n_pixels,
                                       compute_dtype)
        cands.sort(key=lambda c: c.estimated_ms)
        args = _operands(kind, k, b, h1_dim, hid, n_pixels, dev)
        measured: List[Tuple[float, Candidate]] = []
        with span("autotune/measure"):
            for c in cands:
                ms = measure(_candidate_fn(kind, c, k, b, h1_dim, hid,
                                           n_pixels, compute_dtype, dev),
                             args, reps)
                if ms is not None:
                    measured.append((float(ms), c))
    if not measured:
        raise RuntimeError(
            f"autotune: every candidate failed for {kind} at k={k} b={b} "
            f"h1={h1_dim} hid={hid} d={n_pixels}")
    measured.sort(key=lambda mc: mc[0])
    best_ms, best = measured[0]
    hand_ms = next((ms for ms, c in measured if c.label() == hand.label()),
                   None)
    arch, dev_name = device_identity(dev)
    return {
        "path": best.path,
        "groups": best.groups,
        "block_k": best.block_k,
        "measured_ms": round(best_ms, 5),
        "estimated_ms": round(best.estimated_ms, 5),
        "runner_up_ms": (round(measured[1][0], 5) if len(measured) > 1
                         else None),
        "hand_rule": hand.label(),
        "hand_rule_ms": None if hand_ms is None else round(hand_ms, 5),
        "candidates": len(cands),
        "measured_candidates": len(measured),
        "arch": arch, "device": dev_name, "kernel_digest": kernel_digest(),
        "all_measured": [
            {"candidate": c.label(), "measured_ms": round(ms, 5),
             "estimated_ms": round(c.estimated_ms, 5)}
            for ms, c in measured],
    }


def tune(kind: str, k: int, b: int, h1_dim: int, hid: int, n_pixels: int,
         *, compute_dtype=None, device=None, reps: int = 3,
         include_kernel: Optional[bool] = None,
         measure: Optional[Callable] = None, path: Optional[str] = None,
         force: bool = False, save: bool = True) -> dict:
    """Search one (kind, shape) on `device` and keep the measured winner.

    A winner already cached for this key returns at once (``cache: "hit"``)
    with no timed run. `measure` replaces the measurement (tests:
    ``(fn, args, reps) -> ms | None``); `force` searches over a cached
    entry; ``save=False`` keeps the winner in memory. Returns the winner
    record, the one :func:`winner_for` serves: its path, groups or
    block_k, measured and estimated ms, the runner-up's ms, the hand
    rule's candidate and ms, and every candidate measured. Searches take
    turns (:data:`_search_lock`)."""
    dev = torch.device("cpu" if device is None else device)
    key = entry_key(kind, k, b, h1_dim, hid, n_pixels, compute_dtype,
                    device=dev)
    if include_kernel is None:
        include_kernel = dev.type == "cuda"
    if measure is None:
        def measure(fn, args, reps):
            return _measure_candidate(fn, args, reps, dev)
    with _search_lock:
        entries = get_store(path)
        if not force and key in entries:
            _count("tune_cache_hits")
            return dict(entries[key], cache="hit")
        record = _search(kind, k, b, h1_dim, hid, n_pixels, compute_dtype,
                         dev, reps, include_kernel, measure)
        with _store_lock:
            entries[key] = record
            _store["generation"] += 1
        p = cache_path(path)
        if save and p is not None:
            _save_store(p, entries)
    return dict(record, cache="tuned")


def dims_for_model(cfg) -> Tuple[int, int, int]:
    """``(h1_dim, hid, n_pixels)`` of a model's output block."""
    h1_dim, hid, _ = hl.block_widths(cfg)
    return h1_dim, hid, cfg.x_dim


def tune_ladder(cfg, ks, buckets, *, train_batch: Optional[int] = None,
                kinds=("serving_row",), compute_dtype=None, device=None,
                reps: int = 3, include_kernel: Optional[bool] = None,
                path: Optional[str] = None, force: bool = False
                ) -> List[dict]:
    """Tune a serving bucket ladder and the train shapes: ``serving_row``
    and ``serving_int8`` over (k, bucket) for k in `ks` and every bucket,
    ``fwd``/``bwd``/``scan`` at (k, `train_batch`). ``serving_int8`` races
    the fp32 program, whatever `compute_dtype`. One row per shape."""
    h1_dim, hid, n_pixels = dims_for_model(cfg)
    rows = []
    for kind in kinds:
        if kind in ("serving_row", "serving_int8"):
            shapes = [(k, bucket) for k in ks for bucket in buckets]
        else:
            if train_batch is None:
                raise ValueError(f"kind {kind!r} needs train_batch")
            shapes = [(k, train_batch) for k in ks]
        cd = None if kind == "serving_int8" else compute_dtype
        for k, b in shapes:
            t0 = time.perf_counter()
            rec = tune(kind, k, b, h1_dim, hid, n_pixels, compute_dtype=cd,
                       device=device, reps=reps,
                       include_kernel=include_kernel, path=path,
                       force=force)
            rows.append({"kind": kind, "k": k, "b": b,
                         "wall_seconds": round(time.perf_counter() - t0, 3),
                         **rec})
    return rows


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    """Tune the flagship output block's kinds over a bucket ladder and the
    train shape, once per card; print one JSON line per shape and a
    summary."""
    import argparse

    from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
    from iwae_replication_project_tpu_torch.utils.device import (
        resolve_device)

    ap = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.ops.autotune",
        description=main.__doc__.splitlines()[0])
    ap.add_argument("--k", type=str, default="50",
                    help="comma-separated k values (default 50)")
    ap.add_argument("--buckets", type=str, default="1,2,4,8,16,32,64",
                    help="serving bucket ladder (serving kinds)")
    ap.add_argument("--kinds", type=str, default="serving_row",
                    help=f"comma-separated kinds from {KINDS} (fwd/bwd/scan "
                         f"tune at --train-batch)")
    ap.add_argument("--train-batch", dest="train_batch", type=int,
                    default=100, help="batch of the fwd/bwd/scan kinds")
    ap.add_argument("--compute-dtype", dest="compute_dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="matmul operand dtype to tune for (default fp32)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs per candidate (best of)")
    ap.add_argument("--cache", type=str, default=None,
                    help="winner file (default IWAE_AUTOTUNE_CACHE, else "
                         "memory only)")
    ap.add_argument("--force", action="store_true",
                    help="search over cached winners")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kinds = tuple(v.strip() for v in args.kinds.split(",") if v.strip())
    unknown = sorted(set(kinds) - set(KINDS))
    if unknown:
        ap.error(f"unknown kinds {unknown}; choose from {KINDS}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the kernels' library directory (cache-setup)
        _kernels.use_build_dir(None)
    cfg = ModelConfig.two_layer(likelihood="logits")
    cd = None if args.compute_dtype in (None, "float32") \
        else args.compute_dtype
    t0 = time.perf_counter()
    rows = tune_ladder(cfg, [int(v) for v in args.k.split(",") if v.strip()],
                       [int(v) for v in args.buckets.split(",")
                        if v.strip()],
                       train_batch=args.train_batch, kinds=kinds,
                       compute_dtype=cd, device=dev, reps=args.reps,
                       path=args.cache, force=args.force)
    for row in rows:
        print(json.dumps(row), flush=True)
    arch, name = device_identity(dev)
    print(json.dumps({
        "metric": "autotune: measured hot-loop winners",
        "shapes_tuned": len(rows),
        "tuned": sum(1 for r in rows if r.get("cache") == "tuned"),
        "cache_hits": sum(1 for r in rows if r.get("cache") == "hit"),
        "cache_path": cache_path(args.cache), "arch": arch, "device": name,
        "version": AUTOTUNE_VERSION,
        "wall_seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
