"""The staged experiment driver (port of ``experiment.py``).

For each Burda stage: set the stage's learning rate (the Adam moments carry
over), take the objective in effect (objective switching included), run the
stage's passes, fetch their losses once, evaluate on the test set, log the
stage's row and checkpoint. As in the JAX driver (:87-503):

* passes run in dispatches of :data:`PASS_BLOCK` passes (one
  ``epochs_per_call=PASS_BLOCK`` call of ``training/epoch.py``) while a
  stage has that many left, then one pass per call; on CUDA every call
  replays a captured train step (the CUDA graph of ``training/epoch.py``).
  Unlike the JAX driver the blocks also run under ``max_batches_per_pass``;
* a checkpoint (``utils/checkpoint.py``) is saved after each stage and,
  with ``checkpoint_every_passes``, at the first dispatch boundary that
  many passes after the last save; ``resume`` restores the newest intact
  one and continues at the next stage or mid-stage at the next pass, and
  the resumed run is bitwise the uninterrupted one (the training stream is
  part of the checkpoint, and a call of N passes is N calls of one);
* preemption grace (``preemption_grace``): SIGTERM/SIGINT is absorbed
  (``utils/faults.PreemptionGuard``), the dispatch finishes, a mid-stage
  checkpoint is saved and :class:`TrainingPreempted` raised; :func:`main`
  exits with :data:`PREEMPTED_EXIT_CODE` (75, EX_TEMPFAIL: run the same
  command again). A signal at a stage's last boundary lets the stage finish
  its evaluation and save first;
* each stage's row goes to ``<log_dir>/<run_name>/metrics.jsonl`` and its
  TensorBoard events, the registry's gauges to a ``telemetry`` sub-run when
  diagnostics are on, and the whole history to ``results.pkl``.

The evaluation is the full suite of
:func:`..evaluation.training_statistics` (one fetch) and, with diagnostics
on, :func:`..telemetry.diagnostics.estimator_diagnostics`, fetched with the
grad-SNR scalars of the stage's last dispatch. It draws from its own
generators (:func:`..evaluation.metrics.eval_generator`), never from the
training stream.

**Under a mesh** (any of ``mesh_dp``, ``mesh_sp > 1``, ``multihost``; JAX
:141-150) every rank runs :func:`run_experiment` in a process of its own,
in the process group :func:`main` made: the passes through
``parallel.dp.make_parallel_epoch_fn``, the evaluation through
``parallel.eval.parallel_training_statistics`` (JAX :354-366). Only rank 0
prints, logs and writes ``results.pkl``; checkpoints gather every rank's
generators and rank 0 writes them (``utils/checkpoint.py``). The ranks
agree on a preemption at every dispatch boundary (one MAX ``all_reduce``),
so a signal that reaches one rank stops them all at the same pass. The
estimator diagnostics are skipped under ``multihost``, as in JAX (:382).
Stage figures and the compile cache are not ported (ROADMAP A5, A10).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.data import load_dataset
from iwae_replication_project_tpu_torch.evaluation.metrics import (
    eval_generator,
    training_statistics,
)
from iwae_replication_project_tpu_torch.parallel import (
    make_mesh,
    make_parallel_epoch_fn,
    multihost,
    parallel_train_state,
)
from iwae_replication_project_tpu_torch.parallel.eval import (
    parallel_training_statistics,
)
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    estimator_diagnostics,
)
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry
from iwae_replication_project_tpu_torch.telemetry.spans import span
from iwae_replication_project_tpu_torch.training import (
    burda_stages,
    create_train_state,
    set_learning_rate,
)
from iwae_replication_project_tpu_torch.training.epoch import make_epoch_fn
from iwae_replication_project_tpu_torch.utils.checkpoint import (
    restore_latest,
    save_checkpoint,
)
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.device import resolve_device
from iwae_replication_project_tpu_torch.utils.faults import (
    SITE_TRAIN_PASS,
    PreemptionGuard,
    fault_point,
)
from iwae_replication_project_tpu_torch.utils.logging import MetricsLogger
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq

#: passes per dispatch in the long stages; 27 = 3^3 divides every stage
#: length >= 27 of the 3^(i-1) schedule, so stages 4-8 run entirely in
#: blocks and stages 1-3 (1 + 3 + 9 passes) one pass per dispatch
PASS_BLOCK = 27

#: exit status of a gracefully preempted run (os.EX_TEMPFAIL)
PREEMPTED_EXIT_CODE = 75


class TrainingPreempted(RuntimeError):
    """A SIGTERM/SIGINT was absorbed, the dispatch finished and a checkpoint
    is saved; :func:`main` maps this to :data:`PREEMPTED_EXIT_CODE`."""

    def __init__(self, stage: int, passes_done: int, step: int):
        super().__init__(
            f"preempted at stage {stage}, pass {passes_done} (step {step}); "
            f"checkpoint saved: resume with the same command")
        self.stage = stage
        self.passes_done = passes_done
        self.step = step


def _signal_name(guard) -> str:
    return str(guard.signum) if guard.signum is not None \
        else "(on another rank)"


def _resume(cfg: ExperimentConfig, state, ckpt_dir: str, stages,
            mesh=None, say=print) -> tuple:
    """Restore the newest intact checkpoint into `state`; returns
    ``(start stage, passes already done in it)``."""
    restored = restore_latest(ckpt_dir, state,
                              expect_config_json=cfg.to_json(), mesh=mesh)
    if restored is None:
        # run_name() hashes the science fields, so another config's
        # checkpoints are invisible to resume: name the near misses
        prefix = (f"{cfg.loss_function}-{len(cfg.n_hidden_encoder)}L-"
                  f"k_{cfg.k}-")
        if os.path.isdir(cfg.checkpoint_dir):
            stale = [d for d in os.listdir(cfg.checkpoint_dir)
                     if d.startswith(prefix) and d != cfg.run_name()]
            if stale:
                shown = ", ".join(stale[:3]) + (", ..." if len(stale) > 3
                                                else "")
                say(f"note: no checkpoint under {ckpt_dir}, but "
                    f"{len(stale)} same-prefix run dir(s) exist ({shown}): "
                    f"they belong to a different config hash and will NOT "
                    f"be resumed")
        return 1, 0
    _, _, stage, passes_done = restored
    lengths = {s: n for s, _, n in stages}
    if passes_done is not None and passes_done < lengths.get(stage, 0):
        say(f"resumed from mid-stage checkpoint; continuing at stage "
            f"{stage}, pass {passes_done + 1}")
        return stage, passes_done
    say(f"resumed from checkpoint; continuing at stage {stage + 1}")
    return stage + 1, 0


def run_experiment(cfg: ExperimentConfig,
                   max_batches_per_pass: Optional[int] = None, device=None):
    """Run the staged experiment; returns ``(state, history)``.

    `device` None means the card (a missing card raises); pass ``"cpu"`` to
    run on the CPU, where the kernels use their plain versions. A config
    that asks for a mesh runs on the mesh of the current process group (a
    world of one needs none): each rank calls this, and every rank returns
    the same history.
    `max_batches_per_pass` cuts the training set to that many batches, for
    smoke runs. ``history`` has one dict per stage run here (a resumed run
    skips the stages its checkpoint holds): ``stage``, ``learning_rate``,
    ``objective``, ``k``, ``passes``, ``steps`` (total so far),
    ``pass_losses`` (mean loss of each pass run in this call),
    ``stage_train_seconds`` (host clock over the passes and their one fetch,
    less the mid-stage saves), ``stage_checkpoint_seconds``,
    ``checkpoint_every_passes``, ``stage_passes_timed``, the eval results of
    ``training_statistics`` (the seven scalars, ``LL_pruned``,
    ``nll_chunk``, ``eval_batch``, ``kernel_path``),
    ``number_of_active_units`` and ``number_of_PCA_active_units``,
    ``stage_eval_seconds``, with diagnostics on the ``diag/*`` scalars (the
    estimator diagnostics and the grad SNR of the stage's last pass), and
    ``synthetic_data``, ``raw_means_bias`` and ``bfloat16``.
    """
    dev = resolve_device(device)
    mesh = make_mesh(cfg.mesh_dp, cfg.mesh_sp, device=dev) \
        if cfg.uses_mesh() else None
    if mesh is not None:
        dev = mesh.device
    primary = mesh is None or mesh.rank == 0
    say = print if primary else (lambda *a, **kw: None)
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir,
                      allow_synthetic=cfg.allow_synthetic)
    model_cfg = cfg.model_config(dev)
    stages = burda_stages(cfg.n_stages, cfg.passes_scale)
    state = create_train_state(cfg.seed, model_cfg,
                               output_bias=ds.output_bias, lr=stages[0][1],
                               device=dev, eps=cfg.adam_eps)
    if mesh is not None:
        state = parallel_train_state(mesh, state)
    n_train = len(ds.x_train)
    if max_batches_per_pass is not None:
        n_train = min(n_train, max_batches_per_pass * cfg.batch_size)
    x_train = torch.as_tensor(ds.x_train[:n_train].reshape(n_train, -1),
                              dtype=torch.float32).to(dev)
    n_test = len(ds.x_test)
    x_test = torch.as_tensor(ds.x_test.reshape(n_test, -1),
                             dtype=torch.float32).to(dev)
    eval_batch = min(cfg.eval_batch_size, n_test)
    stoch_bin = ds.binarization == "stochastic"
    diag_cfg = cfg.diagnostics_config()
    epoch_fns = {}  # (objective, passes per call) -> epoch function

    def epoch_fn_for(spec, epochs_per_call):
        key = (spec, epochs_per_call)
        if key not in epoch_fns:
            kw = dict(stochastic_binarization=stoch_bin,
                      diagnostics=diag_cfg, epochs_per_call=epochs_per_call)
            epoch_fns[key] = make_epoch_fn(
                spec, model_cfg, n_train, cfg.batch_size, **kw) \
                if mesh is None else make_parallel_epoch_fn(
                    spec, model_cfg, mesh, n_train, cfg.batch_size, **kw)
        return epoch_fns[key]

    def stop_requested() -> bool:
        """Whether to stop at this boundary; under a process group the
        ranks agree (any rank signalled stops all)."""
        if guard is None:
            return False
        if mesh is None or mesh.device_mesh is None:
            return guard.requested
        flag = torch.tensor([float(guard.requested)], device=dev)
        return bool(mesh.all_reduce(flag, "max").item())

    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.run_name())
    start_stage, start_offset = (_resume(cfg, state, ckpt_dir, stages, mesh,
                                         say)
                                 if cfg.resume else (1, 0))

    # opened lazily: a resumed, already complete run touches no run dir
    logger = telem_logger = None
    history = []
    guard = PreemptionGuard().__enter__() if cfg.preemption_grace else None
    try:
        for stage, lr, passes in stages:
            if stage < start_stage:
                continue
            if logger is None and primary:
                logger = MetricsLogger(cfg.log_dir, run_name=cfg.run_name())
            state = set_learning_rate(state, lr)
            spec = cfg.objective_spec(stage)
            offset = start_offset if stage == start_stage else 0
            done, since_save, ckpt_s = offset, 0, 0.0

            def save_mid_stage():
                nonlocal ckpt_s, since_save
                t_ck = time.perf_counter()
                save_checkpoint(ckpt_dir, state.step, state, stage,
                                config_json=cfg.to_json(),
                                keep=cfg.checkpoint_keep, passes_done=done,
                                mesh=mesh)
                ckpt_s += time.perf_counter() - t_ck
                since_save = 0

            def pass_boundary():
                # the chaos hook, then preemption grace (save the current
                # mid-stage state and stop), then the cadence save; a signal
                # at the stage's last boundary waits for the stage's own save
                fault_point(SITE_TRAIN_PASS, stage=stage, done=done)
                if done < passes and stop_requested():
                    save_mid_stage()
                    say(f"preemption grace: signal {_signal_name(guard)} "
                        f"absorbed; mid-stage checkpoint saved at stage "
                        f"{stage}, pass {done} (step {state.step})")
                    raise TrainingPreempted(stage, done, state.step)
                if cfg.checkpoint_every_passes and done < passes \
                        and since_save >= cfg.checkpoint_every_passes:
                    save_mid_stage()

            t0 = time.perf_counter()
            pass_means, last_diag = [], None
            remaining = passes - offset
            n_blocks = remaining // PASS_BLOCK
            with span("train/stage"):
                for per_call, calls in (
                        (PASS_BLOCK, n_blocks),
                        (1, remaining - n_blocks * PASS_BLOCK)):
                    for _ in range(calls):
                        state, out = epoch_fn_for(spec, per_call)(state,
                                                                  x_train)
                        if diag_cfg is not None:
                            out, last_diag = out
                        pass_means.append(out.view(per_call, -1).mean(1))
                        done += per_call
                        since_save += per_call
                        pass_boundary()
            means = torch.cat(pass_means).cpu()  # the stage's one fetch
            train_s = time.perf_counter() - t0

            row = {"stage": stage, "learning_rate": lr,
                   "objective": spec.name, "k": spec.k, "passes": passes,
                   "steps": state.step,
                   "pass_losses": [float(v) for v in means],
                   "stage_train_seconds": train_s - ckpt_s,
                   "stage_checkpoint_seconds": ckpt_s,
                   "checkpoint_every_passes": float(
                       cfg.checkpoint_every_passes or 0),
                   "stage_passes_timed": float(passes - offset),
                   "synthetic_data": bool(ds.synthetic),
                   "raw_means_bias": ds.bias_source == "raw",
                   "bfloat16": cfg.compute_dtype == "bfloat16"}
            t_eval = time.perf_counter()
            eval_kw = dict(batch_size=eval_batch, nll_k=cfg.nll_k,
                           nll_chunk=cfg.nll_chunk,
                           activity_samples=cfg.activity_samples,
                           generator=eval_generator(cfg.seed, stage, dev))
            with span("eval/statistics"):
                res, res2 = training_statistics(
                    state.params, model_cfg, x_test, cfg.eval_k,
                    **eval_kw) if mesh is None \
                    else parallel_training_statistics(
                        state.params, model_cfg, mesh, x_test, cfg.eval_k,
                        **eval_kw)
            row.update(res)
            row["number_of_active_units"] = res2["number_of_active_units"]
            row["number_of_PCA_active_units"] = \
                res2["number_of_PCA_active_units"]
            if diag_cfg is not None:
                ebs = largest_divisor_leq(n_test, eval_batch)
                diag_vals = {}
                if not cfg.multihost:
                    with span("eval/diagnostics"):
                        diag_vals = estimator_diagnostics(
                            state.params, model_cfg,
                            x_test.reshape(n_test // ebs, ebs, -1),
                            cfg.eval_k, diag_cfg,
                            generator=eval_generator(cfg.seed, 30_000 + stage,
                                                     dev))
                diag_vals.update(last_diag)  # the stage's last pass
                fetched = torch.stack([v.float() for v in diag_vals.values()])
                reg = get_registry()
                for key, v in zip(diag_vals, fetched.cpu().tolist()):
                    row[key] = v
                    reg.gauge(key).set(v)
            row["stage_eval_seconds"] = time.perf_counter() - t_eval
            history.append(row)
            say(f"stage {stage}: lr={lr:.2e} objective {spec.name} "
                f"k={spec.k} passes={passes} steps={state.step} "
                f"loss={row['pass_losses'][-1]:.4f} "
                f"NLL={row['NLL']:.4f} IWAE={row['IWAE']:.4f} "
                f"active={row['number_of_active_units']}", flush=True)

            if logger is not None:
                if diag_cfg is not None:
                    if telem_logger is None:
                        telem_logger = MetricsLogger(logger.dir,
                                                     run_name="telemetry")
                    telem_logger.log_registry(get_registry(),
                                              step=state.step)
                logger.log(row, step=state.step)
                with open(os.path.join(logger.dir, "results.pkl"),
                          "wb") as f:
                    pickle.dump(history, f)

            save_checkpoint(ckpt_dir, state.step, state, stage,
                            config_json=cfg.to_json(),
                            keep=cfg.checkpoint_keep, mesh=mesh)
            if stop_requested():
                say(f"preemption grace: signal {_signal_name(guard)} absorbed; "
                    f"stage {stage} completed and saved (step "
                    f"{state.step})")
                raise TrainingPreempted(stage, passes, state.step)
    finally:
        if guard is not None:
            guard.__exit__(None, None, None)
        for lg in (telem_logger, logger):
            if lg is not None:
                lg.close()
    return state, history


def _run_or_exit(cfg: ExperimentConfig, device) -> None:
    try:
        run_experiment(cfg, device=device)
    except TrainingPreempted as e:
        if multihost.process_info()["process_index"] == 0:
            print(f"exiting {PREEMPTED_EXIT_CODE} (preempted): {e}",
                  flush=True)
        raise SystemExit(PREEMPTED_EXIT_CODE) from None


def _rank_main(rank: int, world: int, cfg_json: str, device,
               init_method: str) -> None:
    """One spawned rank of :func:`main`'s single-host mesh."""
    dev = torch.device("cpu") if resolve_device(device).type == "cpu" \
        else torch.device("cuda", rank)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    multihost.initialize(init_method, world, rank, device=dev)
    try:
        _run_or_exit(ExperimentConfig.from_json(cfg_json), dev)
    finally:
        multihost.shutdown()


def local_world(cfg: ExperimentConfig, device) -> int:
    """The ranks a single-host mesh of `cfg` takes: ``dp x sp``, with dp
    None absorbing the local cards (one rank per card; on the CPU, dp 1)."""
    dev = resolve_device(device)
    sp = cfg.mesh_sp
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dp = cfg.mesh_dp if cfg.mesh_dp is not None else cards // sp
        if dp < 1 or dp * sp > cards:
            raise ValueError(f"mesh {cfg.mesh_dp}x{sp} needs one card per "
                             f"rank; this host has {cards}")
        return dp * sp
    return (cfg.mesh_dp if cfg.mesh_dp is not None else 1) * sp


def main(argv=None):
    """``python -m iwae_replication_project_tpu_torch [flags]``: the JAX
    runner's command line (``utils/config.build_argparser``) plus
    ``--device``; exits :data:`PREEMPTED_EXIT_CODE` when preempted.

    A mesh flag without ``--multihost`` starts one rank per local card
    (on the CPU, ``dp x sp`` ranks) and waits for them; ``--multihost``
    joins this process to a cluster as one rank (``--coordinator``,
    ``--num-processes``, ``--process-id``, or torchrun's environment)."""
    from iwae_replication_project_tpu_torch.utils.config import parse_args

    ns, cfg = parse_args(argv)
    if cfg.multihost:
        multihost.initialize(cfg.coordinator, cfg.num_processes,
                             cfg.process_id, device=ns.device)
        try:
            _run_or_exit(cfg, ns.device)
        finally:
            multihost.shutdown()
        return
    if not cfg.uses_mesh():
        _run_or_exit(cfg, ns.device)
        return
    world = local_world(cfg, ns.device)
    if resolve_device(ns.device).type == "cuda" and \
            cfg.model_config("cuda").fused_likelihood:
        # build the kernels once here, not in every rank at once
        from iwae_replication_project_tpu_torch.ops import _kernels, hot_loop
        _kernels.build([hot_loop.KERNEL, hot_loop.KERNEL_BWD])
    with tempfile.TemporaryDirectory() as d:
        codes = multihost.spawn(
            _rank_main, world,
            (cfg.to_json(), ns.device, f"file://{d}/rendezvous"))
    if any(c == PREEMPTED_EXIT_CODE for c in codes):
        raise SystemExit(PREEMPTED_EXIT_CODE)
    bad = [c for c in codes if c != 0]
    if bad:
        raise SystemExit(f"ranks exited with {codes}")


if __name__ == "__main__":
    main()
