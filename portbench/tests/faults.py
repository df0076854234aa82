"""Faults planted in the port underneath a run, for the tests that see
``correct`` come out false. Each function patches the port's modules in the
process that calls it (a dry run calls it in every rank through its
``"patch"``)."""

from __future__ import annotations

#: (module, attribute, value before) of every patch, for :func:`restore`
_UNDO = []


def _patch(module, name: str, value) -> None:
    _UNDO.append((module, name, getattr(module, name)))
    setattr(module, name, value)


def restore() -> None:
    """Undo every patch made in this process, newest first."""
    while _UNDO:
        module, name, value = _UNDO.pop()
        setattr(module, name, value)


def unchanged_state() -> None:
    """A training step that returns its state unchanged: no Adam step."""
    from iwae_replication_project_tpu_torch.training import train_step

    def apply_gradients(state, grads):
        state.step += 1
    _patch(train_step, "apply_gradients", apply_gradients)


def half_batch() -> None:
    """The training step's bound and gradients over half of its batch,
    the mean taken over the rest."""
    from iwae_replication_project_tpu_torch.training import train_step
    whole = train_step.objective_value_and_grad

    def half(spec, params, cfg, x, *, generator=None, eps=None):
        h = x.shape[0] // 2
        return whole(spec, params, cfg, x[:h], generator=generator,
                     eps=None if eps is None else [e[:, :h] for e in eps])
    _patch(train_step, "objective_value_and_grad", half)


def altered_answer() -> None:
    """The streamed estimate with two rows' answers swapped where they are
    produced."""
    from iwae_replication_project_tpu_torch.evaluation import metrics
    whole = metrics.streaming_log_px

    def swapped(*a, **kw):
        out = whole(*a, **kw)
        return out[[1, 0] + list(range(2, out.shape[0]))]
    _patch(metrics, "streaming_log_px", swapped)


def half_rows() -> None:
    """The streamed estimate over the first half of the batch's rows, the
    rest given their mean."""
    import torch
    from iwae_replication_project_tpu_torch.evaluation import metrics
    whole = metrics.streaming_log_px

    def half(params, cfg, x, *a, **kw):
        h = x.shape[0] // 2
        out = whole(params, cfg, x[:h], *a, **kw)
        return torch.cat([out, out.mean().expand(x.shape[0] - h)])
    _patch(metrics, "streaming_log_px", half)


def no_exchange() -> None:
    """The merge of the carries over the sp ranks left out: each rank
    finalises its own samples."""
    from iwae_replication_project_tpu_torch.parallel import eval as peval

    def alone(mesh, state):
        return state
    _patch(peval, "merge_lse_over_sp", alone)
