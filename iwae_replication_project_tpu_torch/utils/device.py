"""Device resolution for the port's entry points.

Every entry point (the engine, ``zoo.serving_engine``, the serving CLI) takes a
``device`` argument. ``None`` means the card: the port exists to run there, so
a missing CUDA device is an error, never a silent fall back to the CPU. Tests
and CPU runs pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` -> ``cuda``.

    Raises RuntimeError when CUDA is asked for (explicitly or by default) and
    no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (its kernels then use their plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
