"""Shape-bucket ladder and the serving boundaries' validators (port of
``serving/buckets.py``: ``BucketLadder``, ``KChunkMenu``, ``as_row(s)``,
``validate_k``, ``validate_model``, ``validate_adaptive_target`` and
``target_class``).

The engine rounds every coalesced batch up to a small ladder of batch sizes
(by default the powers of two up to max_batch; an explicit tuple for the
sharded engine's dp-aligned rungs), so a warm engine sees a closed menu of
shapes, and slices the padding rows off before results leave it. This
module is also the payload host boundary: :func:`as_row` / :func:`as_rows`
turn caller payloads into the engine's float32 row layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


def as_row(row, n_features: int, op: str) -> np.ndarray:
    """One request payload as a flat float32 ``[n_features]`` row; raises
    ValueError when its size does not match the op's feature contract."""
    row = np.asarray(row, np.float32).reshape(-1)
    if row.shape[0] != n_features:
        raise ValueError(f"{op} payload must have {n_features} features, "
                         f"got {row.shape[0]}")
    return row


def as_rows(x) -> Tuple[np.ndarray, bool]:
    """Caller payload as a float32 ``[n, d]`` matrix, plus whether the input
    was a single row (the blocking helpers un-batch the result for those)."""
    x = np.asarray(x, np.float32)
    single = x.ndim == 1
    rows = x[None] if single else x.reshape(x.shape[0], -1)
    return rows, single


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """An ascending tuple of permitted batch sizes (the largest is the
    engine's max coalesced batch)."""

    buckets: Tuple[int, ...]

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("ladder needs at least one bucket")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly ascending, got "
                             f"{self.buckets}")
        if self.buckets[0] < 1:
            raise ValueError("buckets must be >= 1")

    @staticmethod
    def powers_of_two(max_batch: int) -> "BucketLadder":
        """1, 2, 4, ... up to and including `max_batch` (appended as its own
        rung when it is not itself a power of two)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        rungs = []
        b = 1
        while b < max_batch:
            rungs.append(b)
            b *= 2
        rungs.append(max_batch)
        return BucketLadder(tuple(rungs))

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n. Raises for n outside (0, max_batch]."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch size {n} exceeds the ladder's max bucket "
                         f"{self.max_batch}")

    def pad_rows(self, rows: np.ndarray, bucket: int) -> np.ndarray:
        """`rows` ``[n, ...]`` zero-padded to ``[bucket, ...]``. Zero is a
        safe fill for every op: padded rows compute finite values that the
        engine slices off."""
        n = rows.shape[0]
        if n > bucket:
            raise ValueError(f"{n} rows do not fit bucket {bucket}")
        if n == bucket:
            return rows
        out = np.zeros((bucket,) + rows.shape[1:], dtype=rows.dtype)
        out[:n] = rows
        return out


@dataclasses.dataclass(frozen=True)
class KChunkMenu:
    """The ``(batch bucket, k)`` menu of the sharded large-k score path.

    The batch axis keeps the :class:`BucketLadder`'s rungs. The k axis needs
    no rungs: the sharded programs stream k in fixed ``k_chunk`` sample
    blocks, each row's block ``g`` drawn from its own (engine seed, request
    seed, g) generator, with a ragged last block masked, so one program per
    bucket serves every ``k`` in ``[1, k_max]``. ``k_chunk`` is therefore a
    sampling-contract constant (it versions the sample stream and sets the
    per-block working set); ``k_max`` is the admission bound.
    """

    batch: BucketLadder
    k_chunk: int = 250
    k_max: int = 5000

    def __post_init__(self):
        if self.k_chunk < 1:
            raise ValueError(f"k_chunk must be >= 1, got {self.k_chunk}")
        if self.k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {self.k_max}")

    def validate_k(self, k) -> int:
        """`k` as a validated int, or ValueError (the typed bad request)."""
        return validate_k(k, self.k_max)

    def n_chunks(self, k: int) -> int:
        """Sample blocks a k-request spans (the last may be ragged)."""
        return -(-self.validate_k(k) // self.k_chunk)


def validate_model(model, served) -> str:
    """`model` must be a string naming one of the `served` models, else
    ValueError (the typed bad request): a request must never be served by
    the wrong weights."""
    if not isinstance(model, str) or not model:
        raise ValueError(f"model must be a non-empty string, got "
                         f"{type(model).__name__}")
    if model not in served:
        raise ValueError(
            f"unknown model {model!r}; "
            + (f"this serving boundary holds {sorted(served)}" if served
               else "no named models are served here"))
    return model


def validate_k(k, k_max: int) -> int:
    """An int in ``[1, k_max]`` or ValueError (the typed bad request)."""
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
        raise ValueError(f"k must be an integer, got {type(k).__name__}")
    k = int(k)
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} is out of range [1, {k_max}] for this "
                         f"serving path")
    return k


def validate_adaptive_target(target_se, ess_floor, k_cap,
                             k_max: int) -> Tuple[float, float, int]:
    """``(target_se, ess_floor, k_cap)`` of a ``score_adaptive`` request,
    normalized, or ValueError (the typed bad request).

    ``k_cap`` is a k (:func:`validate_k` against ``k_max``); ``target_se``
    and ``ess_floor`` are finite positive reals when given (None disables
    one, normalized to 0.0, the value the program takes); at least one must
    be active (a target-less adaptive request is a fixed-k request under
    the wrong op); an ``ess_floor`` above ``k_cap`` can never be met (ESS
    <= n) and is refused rather than truncated to the cap.
    """
    k_cap = validate_k(k_cap, k_max)

    def norm(name, v):
        if v is None:
            return 0.0
        if isinstance(v, bool) or not isinstance(v, (int, float, np.floating,
                                                     np.integer)):
            raise ValueError(f"{name} must be a number, got "
                             f"{type(v).__name__}")
        v = float(v)
        if not np.isfinite(v) or v <= 0.0:
            raise ValueError(f"{name} must be finite and > 0, got {v!r}")
        return v

    target_se = norm("target_se", target_se)
    ess_floor = norm("ess_floor", ess_floor)
    if target_se == 0.0 and ess_floor == 0.0:
        raise ValueError("an adaptive score request needs a target: give "
                         "target_se > 0 and/or ess_floor > 0 (use the plain "
                         "score op for fixed-k scoring)")
    if ess_floor > k_cap:
        raise ValueError(f"ess_floor={ess_floor:g} can never be reached "
                         f"under k_cap={k_cap} (ESS <= sample count)")
    return target_se, ess_floor, k_cap


def target_class(target_se: float, ess_floor: float) -> str:
    """The coarse class an adaptive request's ``k_used`` is accounted
    under: the active criterion and its decade (``"se:e-2"``,
    ``"ess:e+2"``). An accounting key only, never a program key."""
    if target_se > 0.0:
        return f"se:e{math.floor(math.log10(target_se)):+d}"
    return f"ess:e{math.floor(math.log10(max(ess_floor, 1.0))):+d}"
