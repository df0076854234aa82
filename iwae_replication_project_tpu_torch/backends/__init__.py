"""The facade's eager oracles (port of ``backends/``): ``torch_ref`` behind
``backend="torch"`` and ``tf2_ref`` behind ``backend="tf2"``
(``api.FlexibleModel``). The port's own path, JAX's ``jax_backend``, is
``api.CoreFlexibleModel``.

:func:`epoch_batches` is the oracles' host-side batch stream: the JAX
package's ``data/pipeline.epoch_batches`` (the port's own epochs shuffle
and binarize on the device and do not use it)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def epoch_batches(x: np.ndarray, batch_size: int, epoch: int, seed: int = 0,
                  binarization: str = "none",
                  shuffle: bool = True) -> Iterator[np.ndarray]:
    """``[batch_size, D]`` float32 batches of one pass over `x`: a
    permutation from ``RandomState((seed * 100003 + epoch) % 2**31)``, the
    remainder dropped, and with ``binarization="stochastic"`` each batch
    re-binarized from the same stream (JAX ``data/pipeline.py:28-41``)."""
    n = x.shape[0] - (x.shape[0] % batch_size)
    rs = np.random.RandomState((seed * 100003 + epoch) % (2 ** 31))
    idx = rs.permutation(x.shape[0])[:n] if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        batch = x[idx[start:start + batch_size]]
        if binarization == "stochastic":
            batch = (rs.uniform(size=batch.shape) < batch).astype(np.float32)
        else:
            batch = batch.astype(np.float32, copy=False)
        yield batch
