"""Parameter conversion between the JAX package's tree and the port's.

Both packages use one tree: ``{"enc": (block, ...), "dec": (block, ...),
"out": {"l1", "l2", "out"}}`` with dense layers ``{"w": [in, out], "b":
[out]}``. The JAX side hands its parameters over as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from iwae_replication_project_tpu_torch.utils.device import resolve_device


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None):
    """The tree with every numpy array turned into a float32 tensor on
    `device` (default: the card; see :func:`..utils.device.resolve_device`).
    Dicts, tuples and lists keep their structure."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(v) for key, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(conv(v) for v in node)
        return torch.tensor(np.asarray(node), dtype=torch.float32,
                            device=dev)

    return conv(tree)


def params_to_numpy(tree: Any):
    """Inverse of :func:`params_from_numpy`: float32 numpy arrays on the
    host, same structure."""
    if isinstance(tree, dict):
        return {key: params_to_numpy(v) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().to("cpu", torch.float32).numpy()
