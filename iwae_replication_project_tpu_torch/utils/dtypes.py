"""Serving precision policies of the port.

Counterpart of ``utils/dtypes.py`` in the JAX package, reduced to the policy
vocabulary: ``fp32`` (the exact program), ``bf16`` (bf16 matmul operands,
fp32 accumulation) and ``int8`` (the decoder output block's weights stored
as int8 with one fp32 scale per output channel, served where
``ops/hot_loop.serving_int8_admit`` admits it; every other dispatch of such
an engine serves the exact fp32 program).
"""

from __future__ import annotations

from typing import Any

#: the serving precision policies the port serves; ``fp32`` is the default
PRECISIONS = ("fp32", "bf16", "int8")


def validate_precision(precision: Any) -> str:
    """One of :data:`PRECISIONS`, or ValueError (the typed bad request).

    A typo'd policy dies at the first boundary it crosses and
    never becomes a silent fp32 engine.
    """
    if not isinstance(precision, str) or not precision:
        raise ValueError(f"precision must be a non-empty string, got "
                         f"{type(precision).__name__}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; the port serves "
                         f"the precision policies {list(PRECISIONS)}")
    return precision
