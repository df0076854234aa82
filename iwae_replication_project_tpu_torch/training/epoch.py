"""Training passes over the data (port of ``training/epoch.py``).

The training set stays on the device. The shuffle (``torch.randperm``) and
the stochastic Bernoulli re-binarization draw on the device from the state's
generator, batches are drop-remainder, and the per-step losses are written
into one device tensor: there is no host sync inside a call, and the caller
fetches one tensor per call.

One call runs ``epochs_per_call`` consecutive passes, the counterpart of the
JAX outer ``lax.scan`` (the driver's ``PASS_BLOCK``); the losses of all its
passes come back concatenated. Every step reads its batch through device
buffers: the pass's permutation in a static ``[n_batches, batch_size]``
index buffer, the step's index as a device counter, and its loss goes into
the call's static loss buffer at a device position. So one step is the same
work whatever step it is, and on CUDA it is captured once as a CUDA graph
(the counterpart of the JAX whole-epoch ``lax.scan``) and replayed
``n_batches x epochs_per_call`` times per call, with one eager
``randperm`` per pass outside the graph:

* the graph holds the batch gather, the binarization draw, the model, the
  B1/B2 kernels, the bound, its gradients and Adam; the state's generator is
  registered with it, so each replay draws fresh noise where an eager step
  would;
* the first step of each captured kind that this function runs on a state
  is that pass's real step, run eagerly (the warm-up: kernel builds, Adam's
  state, cuBLAS) before the capture, so no step is hidden and the
  parameters after N steps do not depend on whether a graph ran them. The
  eager path (the CPU, injected draws, or ``cuda_graph=False``) runs the
  same step function step by step;
* the kernel wrappers count launches in Python, which a replay skips, so
  the launches counted while the step was captured are taken back and
  added once per replay (``ops/_kernels.add_launches``);
* a failed capture raises: there is no quiet eager fall back;
* each capture (with its warm-up step) counts as a missed resolution of
  the process's compile-cache counters, and each call that replays only
  steps captured before as a hit (``utils/compile_cache.note_capture``,
  ``note_replay``): the driver's stage rows report them as ``aot_*``.

While the span recorder (``telemetry/spans.REC``) is on, a call records
``train/pass`` per pass (with the CUDA event pair: the pass's device time),
``train/shuffle`` (the ``randperm`` and the index copy), ``train/replay``
per replayed step, ``train/capture`` per capture with its warm-up step and
the child ``train/capture/graph`` around the capture block alone, and
``train/snr_summary`` and ``train/loss_clone`` at the call's end; its
counters ``train/replays``, ``train/captures`` and ``train/eager_steps``
count them. Off, a replay pays one flag test.

A rank of a ``(dp, sp)`` mesh runs this same machinery
(``parallel/dp.make_parallel_epoch_fn``) through two arguments: its
value-and-grad, which reduces the gradients over the ranks before Adam
(``value_and_grad``), and the columns of each batch it takes (``shard``).
The pass's permutation is drawn whole (every rank the same) and only the
rank's columns are kept. The shuffle and the binarization draw from
``state.streams`` where the state has them, else from ``state.generator``.

With a :class:`~..telemetry.diagnostics.DiagnosticsConfig` the pass also
accumulates the first and second gradient moments over its trailing
``snr_window`` steps and returns the gradient-SNR scalars of the call's
last pass next to the losses. Those steps are a second kind of step, which
also folds its gradients into the moments: on CUDA it is captured as a
graph of its own, and the host, which knows the step's place in the pass,
picks the graph to replay, so the steps before the window pay nothing for
the diagnostics.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
    grad_accum_init,
    grad_accum_update,
    grad_snr_summary,
)
from iwae_replication_project_tpu_torch.telemetry.spans import REC, spanned
from iwae_replication_project_tpu_torch.training.train_step import (
    make_train_step,
)
from iwae_replication_project_tpu_torch.utils import compile_cache
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves


class _Buffers:
    """The static tensors a step reads and writes: the training set, the
    pass's batch indices, the step counter within the pass, the position in
    the call's loss buffer, the loss buffer and the SNR accumulators."""

    def __init__(self, state, x_train, n_batches: int, batch_rows: int,
                 n_losses: int, diag_on: bool):
        dev = x_train.device
        self.x = x_train
        self.idx = torch.zeros((n_batches, batch_rows), dtype=torch.int64,
                               device=dev)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses = torch.empty(n_losses, dtype=torch.float32, device=dev)
        self.acc = grad_accum_init(state.params) if diag_on else None


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    #: ``{kernel: launches}`` the wrappers counted while it was captured
    launches: Dict[str, int]


class _StepGraphs:
    """The captured steps of one epoch function, keyed by whether the step
    folds its gradients into the SNR moments. They are bound to the tensors
    of one state and training set: replaying after any of them was replaced
    would write into memory they no longer own, so :meth:`bound_to` checks
    them per call."""

    def __init__(self, bufs: _Buffers, state):
        self.steps: Dict[bool, _Captured] = {}
        self.bufs = bufs
        self.tensors = self._tensors(state)

    @staticmethod
    def _tensors(state) -> list:
        out = []
        for p in tree_leaves(state.params):
            out.append(p.grad)
            out.extend(state.optimizer.state[p].values())
        out.extend(g["lr"] for g in state.optimizer.param_groups)
        return out

    def bound_to(self, state, x_train) -> bool:
        now = self._tensors(state)
        return x_train is self.bufs.x and len(now) == len(self.tensors) \
            and all(a is b for a, b in zip(now, self.tensors))

    def replay(self, state, accumulate: bool) -> None:
        step = self.steps[accumulate]
        sp = REC.begin("train/replay", {"step": state.step}) if REC.on \
            else None
        step.graph.replay()
        state.step += 1
        _kernels.add_launches(step.launches)
        if sp is not None:
            REC.end(sp)
            REC.count("train/replays")


def _binarize_generator(state) -> torch.Generator:
    return state.streams.get("binarize", state.generator)


def make_epoch_fn(spec: ObjectiveSpec, cfg: model.ModelConfig, n_train: int,
                  batch_size: int, stochastic_binarization: bool = False,
                  shuffle: bool = True,
                  diagnostics: Optional[DiagnosticsConfig] = None,
                  epochs_per_call: int = 1,
                  cuda_graph: bool = True, *,
                  value_and_grad: Optional[Callable] = None,
                  shard: Optional[Tuple[int, int]] = None) -> Callable:
    """Build ``epoch(state, x_train) -> (state, losses)``.

    `x_train` is the full ``[n_train, x_dim]`` set on the state's device;
    ``losses`` is a ``[epochs_per_call * (n_train // batch_size)]`` device
    tensor. With `diagnostics` enabled the second value is ``(losses,
    {"diag/grad_snr*": 0-d tensors})`` over the trailing ``min(snr_window,
    n_batches)`` steps of the call's last pass.

    `cuda_graph` False runs the step eagerly on CUDA too (the same step,
    for comparison); the CPU always runs it eagerly.

    For replaying another implementation's draws, ``epoch`` takes them
    injected (one pass per call, always eager): ``perm`` (the ``[n_train]``
    permutation), ``noise`` (per step, the list of encoder noise tensors)
    and ``uniforms`` (per step, the ``[batch_size, x_dim]`` uniforms of the
    binarization: ``batch = (u < batch)``).

    `value_and_grad` replaces the step's (``train_step.make_train_step``);
    `shard` ``(lo, hi)`` makes each step take columns ``lo:hi`` of its
    batch of the pass's permutation (injected ``uniforms`` are then
    ``[hi - lo, x_dim]``).
    """
    n_batches = n_train // batch_size
    if n_batches == 0:
        raise ValueError(f"batch_size={batch_size} exceeds n_train={n_train}")
    if epochs_per_call < 1:
        raise ValueError(f"epochs_per_call={epochs_per_call} must be >= 1")
    diag_on = diagnostics is not None
    window = min(diagnostics.snr_window, n_batches) if diag_on else 0
    first_in_window = n_batches - window
    step = make_train_step(spec, cfg) if value_and_grad is None \
        else make_train_step(spec, cfg, value_and_grad)
    # the step's body without its train/step span: a span inside a captured
    # step would run at capture time only
    step = getattr(step, "__wrapped__", step)
    n_losses = n_batches * epochs_per_call
    lo, hi = shard if shard is not None else (0, batch_size)
    if not 0 <= lo < hi <= batch_size:
        raise ValueError(f"shard {shard} is not a column range of a batch "
                         f"of {batch_size}")

    def run_step(state, b: _Buffers, accumulate: bool, eps=None,
                 u=None) -> None:
        rows = b.idx.index_select(0, b.i).view(-1)
        batch = b.x.index_select(0, rows)
        if stochastic_binarization:
            if u is None:
                u = torch.rand(batch.shape,
                               generator=_binarize_generator(state),
                               device=batch.device)
            batch = (u < batch).to(torch.float32)
        state, metrics = step(state, batch, eps=eps)
        b.losses.index_copy_(0, b.pos, metrics["loss"].reshape(1))
        if accumulate:
            grad_accum_update(b.acc, metrics["grads"])
        b.i.add_(1)
        b.pos.add_(1)

    def capture(state, b: _Buffers, accumulate: bool,
                entry: Optional[_StepGraphs]) -> _StepGraphs:
        """Run one real step of this kind eagerly on a side stream (the
        warm-up), then capture the next such step's work without running
        it; the pair counts as one missed resolution of the process's
        compile-cache counters (``utils/compile_cache.note_capture``)."""
        sp = REC.begin("train/capture", {"accumulate": int(accumulate)})
        if REC.on:
            REC.count("train/captures")
            REC.count("train/eager_steps")
        dev = b.x.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run_step(state, b, accumulate)
        torch.cuda.current_stream(dev).wait_stream(side)
        if entry is None:
            entry = _StepGraphs(b, state)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        if stochastic_binarization and \
                _binarize_generator(state) is not state.generator:
            graph.register_generator_state(_binarize_generator(state))
        before, steps = _kernels.all_launch_counts(), state.step
        inner = REC.begin("train/capture/graph") if REC.on else None
        # no garbage collection inside the capture: a dead reference cycle
        # holding an earlier state's graphs (an optimizer is such a cycle)
        # would destroy them mid-capture, which invalidates the capture
        # (torch.cuda.graph does not collect first)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                run_step(state, b, accumulate)
        finally:
            if collecting:
                gc.enable()
        if inner is not None:
            REC.end(inner)
        state.step = steps  # the capture ran nothing
        after = _kernels.all_launch_counts()
        launches = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        _kernels.add_launches(launches, -1)
        entry.steps[accumulate] = _Captured(graph, launches)
        compile_cache.note_capture(REC.end(sp))
        return entry

    def epoch(state, x_train: torch.Tensor, *,
              perm: Optional[torch.Tensor] = None,
              noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
              uniforms: Optional[Sequence[torch.Tensor]] = None):
        dev = x_train.device
        gen = state.streams.get("shuffle", state.generator)
        injected = perm is not None or noise is not None \
            or uniforms is not None
        if injected and epochs_per_call != 1:
            raise ValueError("injected draws replay one pass per call")
        use_graph = cuda_graph and dev.type == "cuda" and not injected
        entry = state.graphs.get(epoch) if use_graph else None
        if entry is not None and not entry.bound_to(state, x_train):
            entry = None
            del state.graphs[epoch]
        b = entry.bufs if entry is not None else _Buffers(
            state, x_train, n_batches, hi - lo, n_losses, diag_on)
        b.pos.zero_()
        captured = False
        on_card = dev.type == "cuda"
        for _ in range(epochs_per_call):
            sp = REC.begin("train/pass", {"pass": REC.next_seq("train/pass")},
                           device=on_card) if REC.on else None
            shuffling = REC.begin("train/shuffle") if REC.on else None
            if perm is None:
                perm_e = (torch.randperm(n_train, generator=gen, device=dev)
                          if shuffle else torch.arange(n_train, device=dev))
            else:
                perm_e = perm.to(dev)
            b.idx.copy_(perm_e[: n_batches * batch_size]
                        .view(n_batches, batch_size)[:, lo:hi])
            if shuffling is not None:
                REC.end(shuffling)
            b.i.zero_()
            if diag_on:
                torch._foreach_zero_(tree_leaves(b.acc))
            for j in range(n_batches):
                acc = j >= first_in_window
                if entry is not None and acc in entry.steps:
                    entry.replay(state, acc)
                elif use_graph:
                    entry = state.graphs[epoch] = capture(state, b, acc,
                                                          entry)
                    captured = True
                else:
                    if REC.on:
                        REC.count("train/eager_steps")
                    run_step(state, b, acc,
                             eps=None if noise is None else noise[j],
                             u=None if uniforms is None else uniforms[j])
            if sp is not None:
                REC.end(sp)
        if use_graph and not captured:
            compile_cache.note_replay()  # a dispatch of captured steps only
        with REC.section("train/loss_clone"):
            losses = b.losses.clone() if use_graph else b.losses
        if not diag_on:
            return state, losses
        with REC.section("train/snr_summary"):
            summary = grad_snr_summary(*b.acc, window)
        return state, (losses, summary)

    name = f"epoch_{spec.name}_k{spec.k}" if epochs_per_call == 1 \
        else f"epoch_block{epochs_per_call}_{spec.name}_k{spec.k}"
    epoch.__name__ = epoch.__qualname__ = name
    return spanned(epoch, "train/epoch" if epochs_per_call == 1
                   else "train/epoch_block")
