"""Experiment zoo: one named preset per published result (port of ``zoo.py``).

The preset table is the JAX package's, name for name; ``serving_engine``
builds a :class:`~.serving.engine.ServingEngine` for a preset with weights
freshly initialised from the preset's seed (checkpoint loading is not ported
yet), and ``train`` runs a preset through the staged training loop.
Architectures: the 1-stochastic-layer model uses two 200-wide deterministic
layers and a 50-d latent; the 2-layer model is the experiment_example.py:48-51
stack.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig

_ARCH_1L = dict(n_hidden_encoder=(200,), n_latent_encoder=(50,),
                n_hidden_decoder=(200,), n_latent_decoder=(784,))
_ARCH_2L = dict(n_hidden_encoder=(200, 100), n_latent_encoder=(100, 50),
                n_hidden_decoder=(100, 200), n_latent_decoder=(100, 784))


def _cfg(dataset: str, layers: int, **kw) -> ExperimentConfig:
    arch = _ARCH_1L if layers == 1 else _ARCH_2L
    return ExperimentConfig(dataset=dataset, **arch, **kw)


def configs() -> Dict[str, ExperimentConfig]:
    zoo: Dict[str, ExperimentConfig] = {}
    # Tables 1 (fixed-bin MNIST) and 2 (stochastic-bin MNIST)
    for table, dataset in (("table1", "binarized_mnist"), ("table2", "mnist")):
        for loss in ("VAE", "IWAE"):
            for L in (1, 2):
                for k in (1, 5, 50):
                    zoo[f"{table}-{loss.lower()}-{L}l-k{k}"] = _cfg(
                        dataset, L, loss_function=loss, k=k)
    # Table 3 (Omniglot)
    for loss in ("VAE", "IWAE"):
        for L in (1, 2):
            for k in (1, 50):
                zoo[f"table3-{loss.lower()}-{L}l-k{k}"] = _cfg(
                    "omniglot", L, loss_function=loss, k=k)
    # Table 4 (Fashion-MNIST)
    for loss in ("VAE", "IWAE"):
        for k in (1, 50):
            zoo[f"table4-{loss.lower()}-1l-k{k}"] = _cfg(
                "fashion_mnist", 1, loss_function=loss, k=k)
    # Table 5: L_alpha
    for alpha in (0.0, 0.25, 0.5):
        zoo[f"table5-alpha{alpha}"] = _cfg(
            "binarized_mnist", 1, loss_function="L_alpha", k=50, alpha=alpha)
    # Table 6: L_median
    zoo["table6-median-k50"] = _cfg("binarized_mnist", 1,
                                    loss_function="L_median", k=50)
    # Table 7: L_power_p
    for p in (0.5, 2.0, 3.0, 5.0):
        zoo[f"table7-power{p}"] = _cfg("binarized_mnist", 1,
                                       loss_function="L_power_p", k=50, p=p)
    # Table 8: CIWAE
    for beta in (0.05, 0.25, 0.5):
        zoo[f"table8-ciwae-beta{beta}"] = _cfg(
            "mnist", 1, loss_function="CIWAE", k=50, beta=beta)
    # Table 9: MIWAE (k1, k2) with k = k1 * k2
    for k1, k2 in ((1, 50), (5, 10), (10, 5), (50, 1)):
        zoo[f"table9-miwae-{k1}x{k2}"] = _cfg(
            "mnist", 1, loss_function="MIWAE", k=k1 * k2, k2=k2)
    # Table 10: objective switching at stage 5 of 8
    zoo["table10-iwae-to-vae-k50"] = _cfg(
        "binarized_mnist", 1, loss_function="IWAE", k=50,
        switch_stage=5, switch_loss="VAE", switch_k=50)
    zoo["table10-iwae-to-vae-k1"] = _cfg(
        "binarized_mnist", 1, loss_function="IWAE", k=50,
        switch_stage=5, switch_loss="VAE", switch_k=1)
    zoo["table10-vae-k50-to-iwae"] = _cfg(
        "binarized_mnist", 1, loss_function="VAE", k=50,
        switch_stage=5, switch_loss="IWAE", switch_k=50)
    zoo["table10-vae-k1-to-iwae"] = _cfg(
        "binarized_mnist", 1, loss_function="VAE", k=1,
        switch_stage=5, switch_loss="IWAE", switch_k=50)
    # extended baseline configs: PIWAE / DReG / STL
    for k1, k2 in ((10, 5), (50, 1)):
        zoo[f"piwae-{k1}x{k2}"] = _cfg("mnist", 1, loss_function="PIWAE",
                                       k=k1 * k2, k2=k2)
    for loss in ("DReG", "STL"):
        zoo[f"{loss.lower()}-k50-fashion"] = _cfg(
            "fashion_mnist", 1, loss_function=loss, k=50)
    # the north-star row
    zoo["northstar-iwae-2l-k50"] = _cfg("binarized_mnist", 2,
                                        loss_function="IWAE", k=50)
    # real-data evidence presets (digits)
    for loss, k in (("VAE", 1), ("IWAE", 50)):
        zoo[f"digits-{loss.lower()}-1l-k{k}"] = _cfg(
            "digits", 1, loss_function=loss, k=k)
        zoo[f"digits-gray-{loss.lower()}-1l-k{k}"] = _cfg(
            "digits_gray", 1, loss_function=loss, k=k)
        zoo[f"digits-scaled-{loss.lower()}-1l-k{k}"] = _cfg(
            "digits", 1, loss_function=loss, k=k, passes_scale=0.2)
    return zoo


def get(name: str) -> ExperimentConfig:
    zoo = configs()
    if name not in zoo:
        import difflib
        hint = difflib.get_close_matches(name, zoo, n=3)
        raise KeyError(f"unknown preset {name!r}"
                       + (f"; did you mean {hint}?" if hint else ""))
    return zoo[name]


def train(config_or_name, *, device=None,
          max_batches_per_pass: Optional[int] = None, **overrides):
    """Train a zoo preset (by name or :class:`ExperimentConfig`) through the
    staged Burda training loop on `device` (None = ``cuda``); `overrides`
    replace config fields (e.g. ``n_stages=2``). Returns ``(state,
    history)`` of :func:`..experiment.run_experiment`."""
    import dataclasses

    from iwae_replication_project_tpu_torch.experiment import run_experiment

    cfg = get(config_or_name) if isinstance(config_or_name, str) \
        else config_or_name
    cfg = dataclasses.replace(cfg, **overrides)
    return run_experiment(cfg, max_batches_per_pass=max_batches_per_pass,
                          device=device)


def serving_engine(config_or_name, *, k: int = None, device=None, **knobs):
    """A :class:`~.serving.engine.ServingEngine` for a zoo preset (by name or
    :class:`ExperimentConfig`) on `device` (None = ``cuda``).

    Weights are freshly initialised from the preset's seed on the host (so
    the same preset gives the same weights on every device): untrained,
    which is what load tests and the synthetic serving profile want. `k`
    defaults to the preset's training k. A config carrying
    ``serving_precision`` serves under it unless ``precision=`` overrides.
    """
    from iwae_replication_project_tpu_torch.models.iwae import init_params
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.utils.device import (
        resolve_device)

    dev = resolve_device(device)
    cfg = get(config_or_name) if isinstance(config_or_name, str) \
        else config_or_name
    if knobs.get("precision") is None and cfg.serving_precision is not None:
        knobs["precision"] = cfg.serving_precision
    model_cfg = cfg.model_config(dev)
    params = init_params(torch.Generator().manual_seed(cfg.seed), model_cfg)
    return ServingEngine(params=params, model_config=model_cfg,
                         k=cfg.k if k is None else k, device=dev, **knobs)
