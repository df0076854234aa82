#!/usr/bin/env python3
"""Host cost of the hot-loop wrappers (B1 ``fused_forward``, B2
``fused_backward``), of the row-invariant wrappers (``row_invariant.dense``
and ``fixed_sum``) and of the programs that call them, on one NVIDIA GPU,
the flagship's widths:

    python3 scripts/torch_wrapper_host_profile.py [--port-root DIR]
        [--out PATH.json]

For B1 at the serve (k=50, B=64) and train (k=50, B=100) shapes and B2 at
the train shape: the host time to issue one wrapper call (microseconds,
median of 7 rounds of 200 calls, the device not waited for), the time of
one call with 20 issued back to back (CUDA events; where the host work
outlasts the device work the device waits) and the device time alone (a
CUDA-graph replay of 20 calls). Then B1's host time in parts at the serve
shape: the input checks, the output and scratch allocations, and the C
entry point (its launches). Last, the programs around them, timed as
chip_smoke.py's breakdowns time them: one 64-row score dispatch of the
preset ``northstar-iwae-2l-k50`` (noise already on the card) and one train
step (k=50, B=100) on fresh weights, each as the time of one call with 20
(steps: 10) issued back to back, with its host time.

The row-invariant wrappers at every timed shape of ``chip_smoke.py``'s
phase 3d (``ROW_DENSE_SHAPES`` in bf16 and fp32, ``ROW_SUM_SHAPES``): host
us per call, the call back to back and replayed, the library call
(``torch.addmm`` on the rounded operands; ``torch.sum``) both ways, and the
bound, and a digest of the output's bytes (fp32 dense layers and sums must
keep their bits across versions of the kernels). Last, the flagship's 64-row bf16 ``score``, ``encode`` and ``decode``
programs captured into the executable store as the engine captures them,
each replayed 20 times inside ``utils.profiling.trace``: the device us of
every kernel per replay, by name and, for the row-invariant kernels, by
launch in program order; the replay's time by CUDA events beside it.

``--port-root`` imports the port from another checkout (for example the
parent commit, unpacked with ``git archive``), so two versions of the
wrappers are measured by the same code; its kernels build into that
checkout. Prints one line per result and, last, one JSON object (also
written to ``--out``). Without a CUDA device it exits non-zero. It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def programs(torch, cs, host_us) -> dict:
    """The score dispatch and the train step, as described above."""
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.serving.programs import (
        draw_noise, score_rows)
    from iwae_replication_project_tpu_torch.training import train_step as ts

    eng = zoo.serving_engine(cs.PRESET, seed=0, timeout_s=None)
    cfg, _ = eng._kernel_for("score")
    seeds = list(range(64))
    noise = [t.cuda() for t in draw_noise(cfg, "score", 0, seeds, eng.k)]
    x = (torch.rand((64, cfg.x_dim), generator=torch.Generator()
                    .manual_seed(0)) > 0.5).float().cuda()

    def score():
        score_rows(eng._params, cfg, 0, seeds, x, eng.k, noise=noise)

    exp = zoo.get(cs.PRESET)
    model_cfg = exp.model_config("cuda")
    ds = load_dataset(exp.dataset, data_dir=exp.data_dir)
    state = ts.create_train_state(exp.seed, model_cfg,
                                  output_bias=ds.output_bias)
    step = ts.make_train_step(exp.objective_spec(1), model_cfg)
    xt = torch.as_tensor(ds.x_train[:cs.TRAIN_B], dtype=torch.float32).cuda()

    def train():
        step(state, xt)

    return {"score_64": {"ms": cs.time_ms(score, torch),
                         "host_us": host_us(score, torch, 20)},
            "train_step": {"ms": cs.time_ms(train, torch, iters=10),
                           "host_us": host_us(train, torch, 10)}}


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def row_wrappers(torch, cs, ri, host_us) -> dict:
    """The row-invariant wrappers at phase 3d's timed shapes."""
    out = {}
    for dtype in ("bf16", "fp32"):
        cd = torch.bfloat16 if dtype == "bf16" else None
        for i, (m, k, n, tanh, timed) in enumerate(cs.ROW_DENSE_SHAPES):
            if not timed:
                continue
            x, w, b = cs.row_dense_inputs(torch, m, k, n, 100 + i)
            t = cs.row_dense_times(torch, ri, x, w, b, cd, tanh)
            t["host_us"] = host_us(lambda: ri.dense(x, w, b, cd, tanh),
                                   torch)
            t["bound_ms"], t["bound_by"] = cs.dense_bound_ms(m, k, n, dtype)
            t["digest"] = _digest(ri.dense(x, w, b, cd, tanh))
            if hasattr(ri, "dense_plan"):
                t["tile"], t["ctas"] = ri.dense_plan(m, n), \
                    ri.dense_ctas(m, n, k, cd is not None)
            out[f"row_dense {dtype} {m}x{k}x{n}{' tanh' if tanh else ''}"] \
                = t
    for i, (shape, dim) in enumerate(cs.ROW_SUM_SHAPES):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(
            200 + i)).cuda()
        t = cs.row_sum_times(torch, ri, x, dim)
        t["host_us"] = host_us(lambda: ri.fixed_sum(x, dim), torch)
        t["bound_ms"], t["bound_by"] = cs.sum_bound_ms(*cs.sum_dims(shape,
                                                                    dim))
        t["digest"] = _digest(ri.fixed_sum(x, dim))
        out[f"row_sum {list(shape)} dim={dim}"] = t
    for name, t in out.items():
        print(f"{name}: host_us={t['host_us']:.2f} ms={t['ms']:.4f} "
              f"graph_ms={t['graph_ms']:.4f} library_ms="
              f"{t['library_ms']:.4f} library_graph_ms="
              f"{t['library_graph_ms']:.4f} bound_us="
              f"{t['bound_ms'] * 1e3:.4f} ({t['bound_by']}) digest="
              f"{t['digest']}"
              + (f" tile={t['tile']} ctas={t['ctas']}" if "tile" in t
                 else ""), flush=True)
    return out


def _short(name: str) -> str:
    """A kernel's name without its arguments and return type."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\(.*", "", name)[:140]


def replay_traces(torch, cs, ri, iters: int = 20) -> dict:
    """The flagship's 64-row bf16 programs replayed from the store under
    ``utils.profiling.trace``: device us per replay by kernel name and the
    row-invariant kernels' launches in order."""
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc
    from iwae_replication_project_tpu_torch.utils import profiling

    eng = zoo.serving_engine(cs.PRESET, seed=0, precision="bf16",
                             timeout_s=None)
    rng = __import__("numpy").random.RandomState(14)
    out = {}
    with cc.isolated_aot_registry(budget_bytes=None), \
            tempfile.TemporaryDirectory() as tmp:
        for op in ("score", "encode", "decode"):
            k = eng.k if op != "decode" else 0
            d, bucket = eng.row_dims[op], 64
            payload = (rng.rand(bucket, d) > 0.5).astype("float32") \
                if op != "decode" else rng.randn(bucket, d).astype("float32")
            program = eng._program_for(op, k, bucket)
            with eng._launch_context():
                args, kwargs = eng._dispatch_args(op, k, bucket, payload,
                                                  list(range(bucket)))
                fn, tensors, _, _, graph = eng._entry(op, k, bucket, program,
                                                      args, kwargs)
                exe, _ = cc.aot_warm(
                    eng._aot_name(op), fn, tensors,
                    build_key=eng._build_key(op, k, bucket),
                    model=eng.store_label,
                    nbytes=eng._program_nbytes(op, k, bucket), graph=graph,
                    sig=cc.signature(tensors))
                replay_ms = cs.time_ms(lambda: exe(*tensors), torch)
                torch.cuda.synchronize()
                with profiling.trace(tmp) as tr:
                    for _ in range(iters):
                        exe(*tensors)
                    torch.cuda.synchronize()
            with open(tr.path) as f:
                events = json.load(f)["traceEvents"]
            kernels = sorted((e for e in events if e.get("cat") == "kernel"
                              and "dur" in e), key=lambda e: e["ts"])
            by_name, seq = {}, {}
            for e in kernels:
                rec = by_name.setdefault(_short(e["name"]), [0.0, 0])
                rec[0] += e["dur"] / iters
                rec[1] += 1
                for kname in ri.KERNELS:
                    if kname in e["name"]:
                        seq.setdefault(kname, []).append(e["dur"])
            order = {kname: [sum(v[j::len(v) // iters]) / iters
                             for j in range(len(v) // iters)]
                     for kname, v in seq.items() if len(v) % iters == 0}
            out[op] = {
                "replay_ms": replay_ms,
                "device_us_per_replay": sum(v[0] for v in by_name.values()),
                "kernels": {n: {"us": v[0], "launches": v[1] / iters}
                            for n, v in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][0])},
                "in_order_us": order}
            print(f"trace {op}/b64 (bf16, replayed, {iters} replays): "
                  f"replay_ms={replay_ms:.4f} (CUDA events) device_us="
                  f"{out[op]['device_us_per_replay']:.2f} per replay; "
                  + "; ".join(f"{n} {v['us']:.2f} us x{v['launches']:g}"
                              for n, v in out[op]["kernels"].items())
                  + "; in order: " + "; ".join(
                      f"{n} " + ", ".join(f"{u:.2f}" for u in v)
                      for n, v in order.items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-root", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # the inputs and timers
    sys.path.insert(0, str(Path(args.port_root).resolve()))
    import torch

    def host_us(fn, torch, iters=200):
        return cs.host_us(fn, torch, iters=iters, rounds=7)

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from iwae_replication_project_tpu_torch.ops import _kernels
    from iwae_replication_project_tpu_torch.ops import hot_loop as thl
    from iwae_replication_project_tpu_torch.ops import row_invariant as ri

    bf = torch.bfloat16
    out = {"device": cs.nvidia_smi(), "port": str(Path(thl.__file__).parent)}
    print(f"{out['device']}\nport from {out['port']}", flush=True)
    calls = {}
    for name, k, b in (("b1_serve", 50, 64), ("b1_train", 50, 100),
                       ("b2_train", 50, 100)):
        a = cs.hot_loop_inputs(torch, k, b, 100, 200, 784, seed=0)
        g = torch.randn((k, b), generator=torch.Generator().manual_seed(1)
                        ).cuda()
        if name.startswith("b1"):
            def fn():
                thl.fused_forward(*a, compute_dtype=bf)
        else:
            def fn():
                thl.fused_backward(*a, g, compute_dtype=bf)
        calls[name] = {"host_us": host_us(fn, torch),
                       "ms": cs.time_ms(fn, torch),
                       "graph_ms": cs.device_ms(fn, torch)}
        print(f"{name} k={k} B={b}: host_us={calls[name]['host_us']:.2f} "
              f"back_to_back_ms={calls[name]['ms']:.4f} "
              f"graph_ms={calls[name]['graph_ms']:.4f}", flush=True)
    out["calls"] = calls

    # B1's parts at the serve shape
    a = cs.hot_loop_inputs(torch, 50, 64, 100, 200, 784, seed=0)
    dev = a[0].device
    lib = _kernels.load(thl.KERNEL)
    argtypes = _kernels.SIGNATURES[thl.KERNEL][thl.KERNEL][1]
    res = torch.empty((50, 64), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in a] + [res.data_ptr()]
    parts = {"checks": host_us(lambda: thl._check_block(*a), torch),
             "output alloc": host_us(lambda: torch.empty(
                 (50, 64), dtype=torch.float32, device=dev), torch)}
    if argtypes.count(ctypes.c_void_p) == 11:  # a scratch buffer
        nb = lib.hot_loop_fwd_scratch_bytes(100, 200, 784, 1)
        parts["scratch alloc"] = host_us(lambda: torch.empty(
            nb, dtype=torch.uint8, device=dev), torch)
        scratch = torch.empty(nb, dtype=torch.uint8, device=dev)
        ptrs.append(scratch.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts["C entry point"] = host_us(lambda: lib.hot_loop_fwd(
        *ptrs, 3200, 64, 100, 200, 784, 1, stream), torch)
    out["b1_serve_parts_us"] = parts
    print("b1_serve parts (host us): " + ", ".join(
        f"{key} {v:.2f}" for key, v in parts.items()), flush=True)
    out["programs"] = programs(torch, cs, host_us)
    for name, rec in out["programs"].items():
        print(f"{name}: back_to_back_ms={rec['ms']:.4f} "
              f"host_us={rec['host_us']:.1f}", flush=True)
    out["row_wrappers"] = row_wrappers(torch, cs, ri, host_us)
    out["replay_traces"] = replay_traces(torch, cs, ri)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
