"""The general runner of k-sample evaluation traffic (``"kind":
"eval_nll"``).

The traffic file gives ``rate_metric`` (the name of the end-to-end rate
it reports), ``n_train`` and ``n_test`` (synthetic rows; the
training rows set the output bias), ``eval_batch`` (rows per batch, all
ranks), ``nll_k`` and ``nll_chunk`` (samples per row and per chunk),
``dp`` and ``sp`` (the mesh: one process per card), ``check_batches``
(batches the reference recomputes) and ``profile_batches`` (batches in the
traced sub-window).

Each rank makes the same rows and weights from the seed on its card. A
batch is the next ``eval_batch`` test rows, looping over the set; its
noise comes from a generator seeded from ``(seed, batch, rank)``. On one
card the batch goes through ``evaluation/metrics.streaming_log_px`` as
``training_statistics`` calls it; on a mesh through
``parallel/eval.parallel_streaming_log_px``, each rank streaming
``nll_k / sp`` samples of its ``eval_batch / dp`` rows and merging the
carries over sp (one MAX, one SUM). The ranks agree after every batch,
over a gloo group on the host, whether the window is over.

After the window rank 0 draws ``check_batches`` of its completed batches
from the seed (the last one always among them) and the reference
recomputes each row's estimate from the same rows, weights and draws, in
fp32; the number compared is the largest gap of a row, in nats.
"""

from __future__ import annotations

import datetime
import gc
import random
import socket
import time

from portbench.harness import compare, inputs, program, readers, trace
from portbench.harness.cell import Cell, device_info, emit
from portbench.harness.flops import forward_flops
from portbench.reference import draws
from portbench.reference import iwae as ref
from portbench.reference.iwae import Widths


#: how long a rank waits for the others to join or to reach a collective
JOIN_TIMEOUT = datetime.timedelta(seconds=180)


def largest_divisor_leq(n: int, cap: int) -> int:
    """The chunk the program streams: the largest divisor of `n` not above
    `cap` (the port's ``utils/sizes.largest_divisor_leq``)."""
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def run(cell: Cell) -> int:
    world = cell.traffic["dp"] * cell.traffic["sp"]
    if world == 1:
        return rank_main(0, 1, cell, None)
    import multiprocessing as mp

    with socket.socket() as s:  # a free port on this host for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, cell, port))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        code = rank_main(0, world, cell, port)
    finally:
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if any(p.exitcode != 0 for p in procs):
        return code or 1
    return code


def rank_main(rank: int, world: int, cell: Cell, port) -> int:
    import torch
    import torch.distributed as dist

    cuda = cell.device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    program.prepare(cell)
    t, c = cell.traffic, cell.config
    mesh = flag_group = None
    if world > 1:
        from iwae_replication_project_tpu_torch.parallel import multihost
        from iwae_replication_project_tpu_torch.parallel.mesh import make_mesh
        multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                             device=dev, timeout=JOIN_TIMEOUT)
        mesh = make_mesh(t["dp"], t["sp"], device=dev)
        flag_group = dist.new_group(backend="gloo")
    try:
        result = _rank(rank, world, cell, dev, mesh, flag_group)
    finally:
        if world > 1:
            dist.destroy_process_group()
    return 0 if result is None else emit(cell, **result)


def _rank(rank, world, cell, dev, mesh, flag_group):
    """Set-up, window, trace and (rank 0) the check; rank 0 returns what
    the result line needs, the others None."""
    import torch
    import torch.distributed as dist
    from iwae_replication_project_tpu_torch.evaluation.metrics import (
        streaming_log_px)
    from iwae_replication_project_tpu_torch.parallel.eval import (
        parallel_streaming_log_px)

    t, c = cell.traffic, cell.config
    widths = Widths.from_config(c)
    model_cfg = program.experiment_config(c).model_config(dev)
    x_train, x_test = inputs.synthetic_rows(
        cell.seed, (t["n_train"], t["n_test"]), dev)
    w = inputs.init_weights(cell.seed, widths, x_train)
    del x_train
    _, tree = program.param_tree(w, widths, requires_grad=False)
    cell.phase("rows, weights" + (", mesh" if mesh is not None else ""))
    B, k, dp, sp = t["eval_batch"], t["nll_k"], t["dp"], t["sp"]
    local = B // dp
    n_batches = t["n_test"] // B
    dp_rank = rank // sp
    gen = torch.Generator(device=dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def batch(b: int):
        at = (b % n_batches) * B + dp_rank * local
        x = x_test[at:at + local]
        gen.manual_seed(inputs.sub_seed(cell.seed, "eval", b, rank))
        if mesh is None:
            return streaming_log_px(tree, model_cfg, x, k, t["nll_chunk"],
                                    generator=gen)
        return parallel_streaming_log_px(tree, model_cfg, mesh, x, k,
                                         t["nll_chunk"], generator=gen)

    def agree(stop: bool) -> bool:
        if flag_group is None:
            return stop
        flag = torch.tensor([1 if stop else 0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=flag_group)
        return bool(flag.item())

    batch(-1)                                  # warm-up: every shape
    sync()
    cell.phase("warm batch")
    agree(False)
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    outs, bad = [], torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        out = batch(len(outs))
        bad += (~torch.isfinite(out)).sum()
        outs.append(out)
        if agree(rank == 0 and time.perf_counter() - t0 >= cell.seconds):
            break
    sync()
    window_s = time.perf_counter() - t0
    rows = len(outs) * B
    metrics = {t["rate_metric"]: (rows / window_s, "rows/s"),
               "setup_s": (setup_s, "s")}
    dev_extra, breakdown = {}, None
    if cell.trace:
        n = t["profile_batches"]
        start = len(outs)

        def profiled():
            for i in range(n):
                batch(start + i)
        tr = trace.record(profiled) if cuda else trace.DeviceTrace([], [])
        chunk = largest_divisor_leq(k // sp, t["nll_chunk"])
        ctx = readers.Context(
            trace=tr, units={"batches": n, "chunks": n * (k // sp) // chunk},
            window={"seconds": window_s, "rows": rows,
                    "flops": rows * forward_flops(widths, 1, k)},
            widths=widths, hot_loop_shape=(chunk, local), chips=world,
            card=torch.cuda.get_device_name(dev) if cuda else "cpu")
        metrics = readers.read_all(cell.metrics["per_layer"], ctx)
        both = torch.tensor([tr.busy_ns / 1e9, tr.window_ns / 1e9],
                            dtype=torch.float64, device=dev)
        if mesh is not None:
            mesh.all_reduce(both, "sum")
        dev_extra = {"busy_s": float(both[0]) / world,
                     "window_s": float(both[1]) / world}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if cuda
                         else 0], dtype=torch.float64, device=dev)
    failed = torch.stack([bad.double()])
    if mesh is not None:
        mesh.all_reduce(peak, "max")
        mesh.all_reduce(failed, "sum")
    if rank != 0:
        return None
    device = dict(device_info(cell, int(peak)), **dev_extra)
    pick = random.Random(inputs.sub_seed(cell.seed, "check"))
    done = len(outs)
    sample = sorted(set(pick.sample(range(done - 1),
                                    min(t["check_batches"] - 1, done - 1))
                        + [done - 1]))
    mine = {b: outs[b] for b in sample}
    del outs, tree
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref.no_tf32()
    gap = max(compare.row_gap(mine[b], reference_rows(cell, w, x_test, b,
                                                      dev))
              for b in sample)
    return dict(attempted=rows, failed=int(failed), metrics=metrics,
                device=device, checks={"row_gap_nats": gap},
                breakdown=breakdown)


def reference_rows(cell: Cell, w: dict, x_test, b: int, dev,
                   q=ref.exact, samples: int = 0):
    """The reference's estimates of the rows rank 0 holds of batch `b`:
    every sample of every sp rank of its dp row, from the same draws.
    `samples` > 0 keeps only the first that many of each rank's (a
    fault, for calibration)."""
    t, widths = cell.traffic, Widths.from_config(cell.config)
    B, sp = t["eval_batch"], t["sp"]
    local = B // t["dp"]
    k_rank = t["nll_k"] // sp
    chunk = largest_divisor_leq(k_rank, t["nll_chunk"])
    keep = (samples or k_rank) // chunk
    at = (b % (t["n_test"] // B)) * B
    x = x_test[at:at + local]
    latents = [lat for _, lat in widths.enc]
    chunks = []
    for r in range(sp):                      # the ranks of dp row 0
        chunks += draws.chunk_draws(inputs.sub_seed(cell.seed, "eval", b, r),
                                    k_rank // chunk, chunk, local, latents,
                                    dev)[:keep]
    return ref.streamed_log_px(w, widths, x, chunks, q)
