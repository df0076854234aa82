"""The training step and its state (port of ``training/train_step.py``).

A step draws the model noise from the state's generator (or takes it
injected), computes the objective's gradients through
:func:`..objectives.gradients.objective_value_and_grad`, negates them (the
step maximizes the bound) and applies Adam with the reference's
``eps=1e-4``. The learning rate is a hyperparameter of the optimizer's
param groups, so the Burda schedule changes it between stages while the Adam
moments carry over (JAX :48-58).

The state is mutable: the step updates the parameters and moments in place
(``torch.optim.Adam``), where the JAX step returns a new state. Nothing in
a step synchronises with the host; the loss comes back as a device tensor.

On CUDA a step can be captured in a CUDA graph (``training/epoch.py``), so
there the state is built for it, eager steps included (the two must give
the same bits): Adam is ``capturable`` (its step counts live on the device),
the learning rate is a 0-d device tensor that :func:`set_learning_rate`
fills in place, so a replay reads the stage's rate and one capture serves
every stage, and each parameter's ``.grad`` is a static buffer that
:func:`apply_gradients` overwrites. On the CPU Adam is the plain one with a
float learning rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import (
    ObjectiveSpec,
    objective_value_and_grad,
)
from iwae_replication_project_tpu_torch.utils.device import resolve_device
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves, tree_map

#: Adam of the reference (experiment_example.py:39): Burda's eps
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-4

#: offset between the seed of the weights and the seed of the training
#: stream, so that on the CPU (one generator algorithm for both) the two
#: never share draws
_TRAIN_STREAM = 0x9E3779B9


@dataclasses.dataclass
class TrainState:
    """``params``: the parameter tree, leaves are leaf tensors with
    ``requires_grad``; ``optimizer``: the Adam over those leaves;
    ``generator``: the training stream on the state's device (model noise,
    and shuffles and binarization unless `streams` takes them over);
    ``step``: optimizer steps taken; ``streams``: generators of their own
    for ``"shuffle"`` and ``"binarize"`` draws (a rank of a mesh keeps one
    of each, ``parallel/dp.py``; empty on one device)."""

    params: Any
    optimizer: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    streams: Dict[str, torch.Generator] = dataclasses.field(
        default_factory=dict)
    #: CUDA graphs captured against this state's tensors, keyed by the
    #: epoch function that owns each (``training/epoch.py``); never saved
    graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device


def make_adam(leaves, lr: float = 1e-3, eps: float = ADAM_EPS
              ) -> torch.optim.Adam:
    """Adam over `leaves`; on CUDA the capturable form with the learning
    rate as a 0-d device tensor (see the module note)."""
    leaves = list(leaves)
    dev = leaves[0].device
    if dev.type != "cuda":
        return torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=eps)
    return torch.optim.Adam(
        leaves, lr=torch.tensor(lr, dtype=torch.float32, device=dev),
        betas=ADAM_BETAS, eps=eps, capturable=True)


def create_train_state(seed: int, cfg: model.ModelConfig, output_bias=None,
                       lr: float = 1e-3, device=None,
                       eps: float = ADAM_EPS) -> TrainState:
    """Weights drawn on the host from `seed` (the same weights on every
    device, as ``zoo.serving_engine`` draws them), moved to `device`
    (None = the card), with a fresh Adam and the training generator."""
    dev = resolve_device(device)
    host = model.init_params(torch.Generator().manual_seed(seed), cfg,
                             output_bias=output_bias)
    params = tree_map(lambda t: t.to(dev).requires_grad_(True), host)
    gen = torch.Generator(device=dev).manual_seed(
        (seed + _TRAIN_STREAM) % (2 ** 63))
    return TrainState(params=params,
                      optimizer=make_adam(tree_leaves(params), lr, eps),
                      generator=gen)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Stage-boundary LR update that keeps the Adam moments (on CUDA written
    into the device tensor a captured step reads)."""
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return state


def apply_gradients(state: TrainState, grads) -> None:
    """One Adam step that ascends the bound: the optimizer descends, so it
    is handed the negated gradients (JAX :70-71), written into each
    parameter's static ``.grad`` buffer (made on first use)."""
    for p, g in zip(tree_leaves(state.params), tree_leaves(grads)):
        if p.grad is None:
            p.grad = torch.empty_like(p)
        torch.neg(g, out=p.grad)
    state.optimizer.step()
    state.step += 1


def make_train_step(spec: ObjectiveSpec, cfg: model.ModelConfig,
                    value_and_grad: Optional[Callable] = None
                    ) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """``step(state, batch, eps=None) -> (state, metrics)``.

    `eps` injects the model's noise (one tensor per stochastic layer, as
    ``models.iwae.encode`` takes it); without it the draws come from the
    state's generator. ``metrics`` holds the loss (the negated bound) as a
    device tensor under ``"loss"`` and the objective's name. The step's
    gradients (of the bound, before negation) are in ``metrics["grads"]``
    for callers that accumulate diagnostics.

    `value_and_grad` ``(params, batch, *, generator, eps) -> (bound,
    grads)`` replaces :func:`..objectives.objective_value_and_grad` of
    `spec`: the seam through which ``parallel/dp.py`` hands in the
    mesh's, whose gradients are already reduced over the ranks.
    """
    if value_and_grad is None:
        def value_and_grad(params, batch, *, generator=None, eps=None):
            return objective_value_and_grad(spec, params, cfg, batch,
                                            generator=generator, eps=eps)

    def step(state: TrainState, batch: torch.Tensor,
             eps: Optional[Sequence[torch.Tensor]] = None):
        bound, grads = value_and_grad(state.params, batch,
                                      generator=state.generator, eps=eps)
        apply_gradients(state, grads)
        loss = -bound
        return state, {"loss": loss, spec.name: loss, "grads": grads}

    return step
