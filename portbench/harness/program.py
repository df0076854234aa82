"""The system under test, the port ``iwae_replication_project_tpu_torch``,
set up as its own experiment runner sets it up: a ``zoo`` preset made an
``ExperimentConfig`` with the configuration file's values, and its
``ModelConfig``, objective and diagnostics on the run's device.
"""

from __future__ import annotations

import dataclasses

from portbench.harness import inputs
from portbench.harness.cell import Cell
from portbench.harness.manifest import BENCH

#: the configuration file's keys that are fields of the port's
#: ``ExperimentConfig``
FIELDS = ("n_hidden_encoder", "n_hidden_decoder", "n_latent_encoder",
          "n_latent_decoder", "loss_function", "k", "batch_size",
          "adam_eps", "likelihood", "compute_dtype", "snr_window")

#: where the port builds and finds its kernels' libraries: a fixed
#: directory inside the checkout, so only a cell's first run builds
BUILD_DIR = BENCH / "_build"


def experiment_config(config: dict):
    from iwae_replication_project_tpu_torch import zoo

    base = zoo.get(config["preset"])
    values = {f: (tuple(config[f]) if isinstance(config[f], list)
                  else config[f]) for f in FIELDS if f in config}
    return dataclasses.replace(base, **values)


def prepare(cell: Cell):
    """Point the port at the benchmark's build directory (on the card)."""
    import torch

    if cell.dry is None:
        torch.set_num_threads(1)
        from iwae_replication_project_tpu_torch.ops import _kernels
        _kernels.use_build_dir(str(BUILD_DIR))
    else:
        patch = cell.dry.get("patch")
        if patch:
            import importlib
            mod, fn = patch.split(":")
            getattr(importlib.import_module(mod), fn)()


def param_tree(weights: dict, widths, requires_grad: bool):
    """The port's parameter tree over fresh copies of the run's weights
    (the program updates its own tensors in place)."""
    own = {n: (t.clone().requires_grad_(True) if requires_grad else t)
           for n, t in weights.items()}
    return own, inputs.program_tree(own, widths)
