"""The library-placed data-parallel step (port of ``parallel/auto.py``).

JAX's counterpart annotates the batch ``P('dp')`` and lets XLA's
partitioner insert the gradient all-reduce. Here it is
``DistributedDataParallel`` over the single-device bound: DDP's reducer
averages the gradients over the dp group during the backward, and Adam
steps on them. Data parallelism only (``sp = 1``): the sample axis needs
the explicit collectives of ``parallel/dp.py``. It serves as a cross-check
of the explicit :func:`..dp.make_parallel_train_step`, which it matches
within fp32 rounding (the two sum the ranks' gradients in another order).

DDP differentiates one scalar per step, so the estimators whose gradient
takes two cotangents on one pass (DReG's and PIWAE's encoder/decoder
split) are refused; STL's single cotangent is its surrogate's gradient.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.objectives import estimators as est
from iwae_replication_project_tpu_torch.parallel.dp import (
    _validate_sharding,
    shard_batch,
)
from iwae_replication_project_tpu_torch.parallel.mesh import AXES, Mesh
from iwae_replication_project_tpu_torch.training.train_step import (
    TrainState,
    make_adam,
)
from iwae_replication_project_tpu_torch.utils.tree import (
    tree_leaves,
    tree_unflatten,
)


class _NegBound(torch.nn.Module):
    """The parameter tree as a module whose forward is the loss to descend
    (the negated bound, or STL's surrogate) and the bound."""

    def __init__(self, params, spec: ObjectiveSpec, cfg: model.ModelConfig):
        super().__init__()
        self.tree = params
        self.leaves = torch.nn.ParameterList(tree_leaves(params))
        self.spec, self.cfg = spec, cfg

    def forward(self, x, generator=None, eps=None):
        params = tree_unflatten(self.tree, list(self.leaves))
        spec = self.spec
        if spec.name == "STL":
            log_w = model.log_weights(params, self.cfg, x, spec.k,
                                      generator=generator, eps=eps,
                                      stop_q_score=True)
            w = torch.softmax(log_w.detach(), dim=0)
            return (-torch.sum(w * log_w) / x.shape[0],
                    est.iwae_bound(log_w.detach()))
        log_w, aux = model.log_weights_and_aux(params, self.cfg, x, spec.k,
                                               generator=generator, eps=eps)
        bound = est.bound_from_log_weights(spec, log_w, aux)
        return -bound, bound.detach()


def make_ddp_train_step(spec: ObjectiveSpec, cfg: model.ModelConfig,
                        mesh: Mesh) -> Tuple[Callable, Callable, Callable]:
    """``(step, place_state, place_batch)``, as JAX's
    ``make_pjit_train_step``: ``place_state(state)`` makes a state's
    parameters the DDP module's (moments carried over), ``place_batch``
    takes this rank's rows of a global batch, and ``step(state, x_local,
    eps=None) -> (state, metrics)`` is one Adam step."""
    if mesh.sp != 1:
        raise ValueError(f"the DDP step is data-parallel only; got "
                         f"sp={mesh.sp}")
    if spec.name in ("DReG", "PIWAE"):
        raise ValueError(f"{spec.name} splits its gradient into two "
                         f"cotangents on one pass; DDP reduces one "
                         f"backward: use make_parallel_train_step")
    _validate_sharding(spec, mesh, None)
    ddp = {}

    def place_state(state: TrainState) -> TrainState:
        old = tree_leaves(state.params)
        new = [torch.nn.Parameter(p.detach()) for p in old]
        opt = make_adam(new, eps=state.optimizer.defaults["eps"])
        opt.load_state_dict(state.optimizer.state_dict())
        state.params = tree_unflatten(state.params, new)
        state.optimizer = opt
        state.graphs.clear()
        module = _NegBound(state.params, spec, cfg)
        ddp["module"] = torch.nn.parallel.DistributedDataParallel(
            module, process_group=mesh.group(AXES.dp),
            device_ids=None if mesh.device.type == "cpu"
            else [mesh.device.index])
        return state

    def step(state: TrainState, x_local: torch.Tensor, eps=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, bound = ddp["module"](x_local, generator=state.generator,
                                    eps=eps)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        bound = mesh.all_reduce(bound.reshape(1), axis=AXES.dp)[0] / mesh.dp
        return state, {"loss": -bound, spec.name: -bound}

    return step, place_state, lambda batch: shard_batch(mesh, batch)
