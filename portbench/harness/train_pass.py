"""The general runner of training traffic (``"kind": "train_pass"``).

The traffic file gives ``rate_metric`` (the name of the end-to-end rate
it reports), ``n_train`` (synthetic rows held on the device),
``passes_per_call`` (passes per call of the epoch function) and
``profile_calls`` (epoch calls in the traced sub-window).

Set-up builds one ``TrainState`` from the seed: the weights, Adam
(capturable, the learning rate a device tensor) and the training
generator, as ``training/train_step.create_train_state`` builds them, but
with the benchmark's weights, made on the device. It builds the one epoch
function of ``training/epoch.make_epoch_fn`` that the window calls, with
the SNR diagnostics, and makes its first call on that state and the
window's rows: the warm call. Its first step runs eagerly and each kind of
step is captured on first use, so the warm call covers the shuffle over
every row, the eager steps, the replays of the plain step's graph and of
the accumulating one. It keeps that call's losses, the first step's
gradient as Adam got it (its first moment after one step over ``1 -
beta1``, read by a hook on the optimizer that the first step fires and
the captures find spent) and the weights after the call. The window calls
the same function on the same state until ``--seconds`` have passed, one
synchronize at the end. After the window and the memory reading the
program is freed, and the reference follows the whole warm call in fp32,
step for step on the same rows and draws. Compared are the losses of the
first steps, the first gradient, and each leaf's change over the call.
"""

from __future__ import annotations

import gc
import sys
import time

from portbench.harness import compare, inputs, program, readers, trace
from portbench.harness.cell import Cell, device_info, emit
from portbench.harness.flops import train_step_flops
from portbench.reference import draws
from portbench.reference import iwae as ref
from portbench.reference.iwae import Widths

BETA1 = 0.9

#: the warm call's first steps whose losses are compared; later losses
#: follow the drift of the trajectory more than the precision (the fp8
#: control reads no higher there than the program, ``PERF.md``)
LOSS_STEPS = 3


def warm_call(cell: Cell, dev, seed: int):
    """Set-up up to the window: the state, the window's epoch function
    after its warm call, the rows, and what the warm call left (see the
    module note)."""
    import torch
    from iwae_replication_project_tpu_torch.training.epoch import (
        make_epoch_fn)
    from iwae_replication_project_tpu_torch.training.train_step import (
        TrainState, make_adam)

    c, t = cell.config, cell.traffic
    widths = Widths.from_config(c)
    exp = program.experiment_config(c)
    model_cfg = exp.model_config(dev)
    spec = exp.objective_spec(1)
    B = exp.batch_size
    x_train, = inputs.synthetic_rows(seed, (t["n_train"],), dev)
    w0 = inputs.init_weights(seed, widths, x_train)
    own, tree = program.param_tree(w0, widths, requires_grad=True)
    gen = torch.Generator(device=dev).manual_seed(
        inputs.sub_seed(seed, "train"))
    state = TrainState(params=tree, generator=gen, optimizer=make_adam(
        list(own.values()), c["learning_rate"], exp.adam_eps))
    order = list(own)
    epoch = make_epoch_fn(spec, model_cfg, t["n_train"], B,
                          diagnostics=exp.diagnostics_config(),
                          epochs_per_call=t["passes_per_call"])
    cell.phase("rows, weights, state")

    # no first moment, as when the optimizer never got a gradient: zeros
    first_grad = {n: torch.zeros_like(own[n]) for n in order}
    seen = []

    def after_first_step(opt, args, kwargs):
        if seen:  # spent: the later steps and the captures read nothing
            return
        seen.append(True)
        for n in order:
            first_grad[n] = opt.state[own[n]]["exp_avg"].detach() \
                / (1 - BETA1)
    hook = state.optimizer.register_step_post_hook(after_first_step)
    state, out = epoch(state, x_train)
    hook.remove()
    losses = out[0] if isinstance(out, tuple) else out
    after = {n: own[n].detach().clone() for n in order}
    cell.phase("warm call")
    return dict(state=state, epoch=epoch, x_train=x_train, w0=w0,
                widths=widths, B=B, k=spec.k, losses=losses.tolist(),
                first_grad=first_grad, after=after,
                steps_per_call=(t["n_train"] // B) * t["passes_per_call"])


def _mark(dev):
    """A CUDA event recorded on the stream now (None on the CPU)."""
    if dev.type != "cuda":
        return None
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _report_calls(marks, host) -> None:
    """The window's epoch calls on the device (between CUDA events) and
    on the host (when each call returned), to standard error."""
    if marks[0] is None:
        return
    dev_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    print("window calls, device ms: " + " ".join(f"{v:.1f}" for v in dev_ms)
          + "; host s at each return: " + " ".join(f"{v:.2f}" for v in host),
          file=sys.stderr)


def reference_checks(cell: Cell, seed: int, s: dict, q=ref.exact,
                     rows: int = 0) -> dict:
    """The reference's steps over the warm call's rows and draws: its
    losses, first gradient, change of the weights and quiet leaves. `q`
    and `rows` put a lower precision or a half batch in the reference (the
    control and a fault, for calibration)."""
    c = cell.config
    latents = [lat for _, lat in s["widths"].enc]
    steps = draws.train_passes(inputs.sub_seed(seed, "train"), s["x_train"],
                               cell.traffic["passes_per_call"], s["B"],
                               s["k"], latents)
    r = ref.train_steps(s["w0"], s["widths"], steps, lr=c["learning_rate"],
                        betas=tuple(c["adam_betas"]), eps=c["adam_eps"], q=q,
                        rows=rows)
    quiet = compare.quiet_leaves(r.first_grads)
    change = {n: r.weights[n] - s["w0"][n] for n in r.weights}
    return {"losses": r.losses, "first_grad": r.first_grads,
            "change": change, "quiet": quiet}


def judge(s: dict, r: dict) -> dict:
    """The numbers compared: the worst loss of the warm call's first
    steps, the worst leaf's first gradient and its change over the call."""
    mine = {n: s["after"][n] - s["w0"][n] for n in s["after"]}
    return {"loss_gap": compare.loss_gap(s["losses"][:LOSS_STEPS],
                                         r["losses"][:LOSS_STEPS]),
            "first_grad_gap": compare.leaf_norm_gap(s["first_grad"],
                                                    r["first_grad"]),
            "change_gap": compare.leaf_norm_gap(mine, r["change"],
                                                leave_out=r["quiet"])}


def run(cell: Cell) -> int:
    import torch

    dev = torch.device(cell.device_type)
    program.prepare(cell)
    s = warm_call(cell, dev, cell.seed)
    state, epoch, x_train = s["state"], s["epoch"], s["x_train"]

    def call():
        """One epoch call; its per-step losses (without the SNR
        summary the diagnostics add)."""
        nonlocal state
        state, out = epoch(state, x_train)
        return out[0] if isinstance(out, tuple) else out

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    calls, marks, host = 0, [_mark(dev)], []
    while True:
        bad += (~torch.isfinite(call())).sum()
        calls += 1
        marks.append(_mark(dev))
        host.append(time.perf_counter() - t0)
        if host[-1] >= cell.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    _report_calls(marks, host)
    steps = calls * s["steps_per_call"]
    rows = steps * s["B"]
    metrics = {cell.traffic["rate_metric"]: (rows / window_s, "rows/s"),
               "setup_s": (setup_s, "s")}
    dev_extra, breakdown = {}, None
    if cell.trace:
        n = cell.traffic["profile_calls"]

        def profiled():
            for _ in range(n):
                call()
        tr = trace.record(profiled) if dev.type == "cuda" \
            else trace.DeviceTrace([], [])
        ctx = readers.Context(
            trace=tr, units={"steps": n * s["steps_per_call"]},
            window={"seconds": window_s, "rows": rows,
                    "flops": steps * train_step_flops(s["widths"], s["B"],
                                                      s["k"])},
            widths=s["widths"], hot_loop_shape=(s["k"], s["B"]),
            chips=cell.chips,
            card=torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu")
        metrics = readers.read_all(cell.metrics["per_layer"], ctx)
        dev_extra = {"busy_s": tr.busy_ns / 1e9,
                     "window_s": tr.window_ns / 1e9}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    failed = int(bad) * s["B"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device = dict(device_info(cell, peak), **dev_extra)
    # the rows stay: the reference reads the same ones
    del state, epoch, x_train, call
    s.pop("state"), s.pop("epoch")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref.no_tf32()
    checks = judge(s, reference_checks(cell, cell.seed, s))
    return emit(cell, attempted=rows, failed=failed, metrics=metrics,
                device=device, checks=checks, breakdown=breakdown)

