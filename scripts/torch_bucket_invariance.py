#!/usr/bin/env python3
"""Which op of a served row changes its bits with the row's bucket, on the
card.

    python3 scripts/torch_bucket_invariance.py [--device cuda] [--rows 3]
                                               [--out PATH.json]

Builds the ``northstar-iwae-2l-k50`` serving programs of the port at full
width (fresh weights from the preset's seed) and serves a few rows, each
alone (bucket 1) and among random neighbours in every bucket 1..64, with
the same per-row noise (``serving.programs.draw_noise``). Every dense
layer's output and every sum of the program (``models/mlp.dense_apply``,
``models/iwae._sum_last``, the fused decoder block, the final reduction
over k or the encoder's mean) is tapped in execution order, and the row's
slice of each is compared bitwise with its bucket-1 slice. For each
(precision, op, path) it reports, per tapped op, in how many buckets the
row's bits differed, and the first op that differed. Two paths:
``plain``, the dispatch config with ``row_invariant=False`` (cuBLAS and
``torch.sum``, the serving path before the row-invariant kernels), and
``row_invariant``, the serving dispatch config on the card. A tapped op
differs also when only its input did; so each op is then run alone
(``isolated``): the same input row in every bucket beside random rows, in
each path, at the serving program's shapes, which names the ops that change
a row's bits by themselves. Prints one JSON object (also written to
``--out``). It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PRESET = "northstar-iwae-2l-k50"


def _tapped(records):
    """Patch the program's dense layers, sums and the fused block so each
    call appends ``(name, row slicer, output)`` to `records`."""
    from iwae_replication_project_tpu_torch.models import iwae, mlp
    from iwae_replication_project_tpu_torch.ops import hot_loop

    dense0, sum0, score0 = mlp.dense_apply, iwae._sum_last, \
        hot_loop.decoder_score

    def dense(p, x, compute_dtype=None, **kw):
        y = dense0(p, x, compute_dtype, **kw)
        k_lead = x.dim() == 3
        records.append((f"dense {tuple(p['w'].shape)}"
                        f"{' tanh' if kw.get('tanh') else ''}",
                        k_lead, y))
        return y

    def sum_last(t, cfg):
        y = sum0(t, cfg)
        records.append((f"sum over last axis of {tuple(t.shape[-1:])}",
                        t.dim() == 3, y))
        return y

    def decoder_score(*a, **kw):
        y = score0(*a, **kw)
        records.append(("decoder block (B1 kernel)", True, y))
        return y

    @contextlib.contextmanager
    def ctx():
        mlp.dense_apply, iwae._sum_last = dense, sum_last
        hot_loop.decoder_score = decoder_score
        try:
            yield
        finally:
            mlp.dense_apply, iwae._sum_last = dense0, sum0
            hot_loop.decoder_score = score0
    return ctx()


def _row(t, k_lead: bool, pos: int):
    return (t[:, pos] if k_lead else t[pos]).detach().cpu()


def run(device: str, n_rows: int, max_bucket: int = 64) -> dict:
    import numpy as np
    import torch

    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.ops.hot_loop import (
        serving_dispatch_config)
    from iwae_replication_project_tpu_torch.serving import programs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"), "cases": []}
    rng = np.random.RandomState(0)
    buckets = tuple(range(1, max_bucket + 1))
    for precision in ("bf16", "fp32"):
        eng = zoo.serving_engine(PRESET, device=dev, precision=precision)
        k = eng.k
        for op in ("score", "encode", "decode"):
            d = eng.row_dims[op]
            pool = (rng.rand(max(buckets) + n_rows, d) > 0.5).astype(
                np.float32) if op != "decode" else rng.randn(
                max(buckets) + n_rows, d).astype(np.float32)
            for path in ("plain", "row_invariant"):
                cfg, _ = serving_dispatch_config(
                    eng.cfg, device=dev, gated=op == "score")
                cfg = dataclasses.replace(
                    cfg, row_invariant=path == "row_invariant")
                fn, takes_k = programs.PROGRAMS[op]
                diffs, names, first_diff = None, None, None
                final_diff = 0
                for r in range(n_rows):
                    ref, ref_out = None, None
                    for b in buckets:
                        pos = (b - 1) // 2
                        others = [j for j in range(n_rows, n_rows + b)][:b]
                        idx = others[:pos] + [r] + others[pos:b - 1]
                        seeds = [1000 + i for i in idx]
                        x = torch.from_numpy(pool[idx]).to(dev)
                        records = []
                        with _tapped(records):
                            args = (eng._params, cfg, 0, seeds, x) + (
                                (k,) if takes_k else ())
                            y = fn(*args)
                        rows = [_row(t, kl, pos) for _, kl, t in records]
                        y_row = y[pos].detach().cpu()
                        if ref is None:
                            ref, ref_out = rows, y_row
                            names = [n for n, _, _ in records]
                            diffs = diffs or [0] * len(names)
                            continue
                        for i, (a, c) in enumerate(zip(rows, ref)):
                            if not torch.equal(a, c):
                                diffs[i] += 1
                        final_diff += int(not torch.equal(y_row, ref_out))
                for i, n in enumerate(names):
                    if diffs[i] and first_diff is None:
                        first_diff = f"#{i} {n}"
                if first_diff is None and final_diff:
                    first_diff = ("the program's last reduction (over k, "
                                  "or the encoder's mean)")
                out["cases"].append({
                    "precision": precision, "op": op, "path": path,
                    "rows": n_rows, "buckets": len(buckets),
                    "result_differs_in": final_diff,
                    "first_op_that_differs": first_diff,
                    "ops": [{"op": f"#{i} {n}", "buckets_differing": c}
                            for i, (n, c) in enumerate(zip(names, diffs))]})
                if dev.type == "cuda":
                    torch.cuda.synchronize()
    out["isolated"] = isolated(dev, buckets)
    return out


def isolated(dev, buckets) -> list:
    """Each op of the flagship's serving programs alone: one fixed input
    row in every bucket beside random rows (at the middle position); per
    (op, precision, path) the number of buckets whose output row differs
    bitwise from bucket 1's."""
    import torch

    from iwae_replication_project_tpu_torch.ops import row_invariant as ri

    g = torch.Generator().manual_seed(1)
    k = 50
    dense = [("dense 784x200 tanh, bucket rows", 784, 200, True, False),
             ("dense 200x100, bucket rows", 200, 100, False, False),
             ("dense 100x100 tanh, k x bucket rows", 100, 100, True, True),
             ("dense 50x100 tanh, bucket rows (decode)", 50, 100, True,
              False),
             ("dense 200x784, bucket rows (decode)", 200, 784, False, False)]
    sums = [("sum over the last axis of [k, bucket, 100]", 100, -1),
            ("sum over k of [k, bucket] (the logsumexp)", None, 0),
            ("sum over k of [k, bucket, 50] (encode's mean)", 50, 0)]
    rows = []
    for name, kin, n, tanh, fan in dense:
        w = (torch.randn((kin, n), generator=g) * kin ** -0.5).to(dev)
        b = (torch.randn((n,), generator=g) * 0.1).to(dev)
        row = torch.randn((k, 1, kin) if fan else (1, kin), generator=g)
        for cd in (torch.bfloat16, None):
            for path in ("plain", "row_invariant"):
                fn = ri.dense_plain if path == "plain" else ri.dense
                ref, diff = None, 0
                for bk in buckets:
                    pos = (bk - 1) // 2
                    x = torch.randn((k, bk, kin) if fan else (bk, kin),
                                    generator=g)
                    if fan:
                        x[:, pos] = row[:, 0]
                    else:
                        x[pos] = row[0]
                    y = fn(x.to(dev), w, b, cd, tanh)
                    y = (y[:, pos] if fan else y[pos]).cpu()
                    if ref is None:
                        ref = y
                    diff += int(not torch.equal(y, ref))
                rows.append({"op": name, "precision": "bf16" if cd else
                             "fp32", "path": path,
                             "buckets_differing": diff})
    for name, d, dim in sums:
        shape = (k, 1, d) if d else (k, 1)
        row = torch.randn(shape, generator=g)
        for path in ("plain", "row_invariant"):
            ref, diff = None, 0
            for bk in buckets:
                pos = (bk - 1) // 2
                x = torch.randn((k, bk) + ((d,) if d else ()), generator=g)
                x[:, pos] = row[:, 0]
                x = x.to(dev)
                y = torch.sum(x, dim=dim) if path == "plain" else \
                    ri.fixed_sum(x, dim)
                y = (y[:, pos] if dim == -1 else y[pos]).cpu()
                if ref is None:
                    ref = y
                diff += int(not torch.equal(y, ref))
            rows.append({"op": name, "precision": "fp32", "path": path,
                         "buckets_differing": diff})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=3)
    ap.add_argument("--max-bucket", dest="max_bucket", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    doc = run(args.device, args.rows, args.max_bucket)
    if args.device == "cuda":
        doc["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for c in doc["cases"]:
        print(f"{c['precision']} {c['op']} {c['path']}: result differs in "
              f"{c['result_differs_in']} of {c['rows'] * (c['buckets'] - 1)}"
              f" (row, bucket) pairs; first op that differs: "
              f"{c['first_op_that_differs']}", flush=True)
    for r in doc["isolated"]:
        print(f"isolated: {r['op']} {r['precision']} {r['path']}: the row "
              f"differs in {r['buckets_differing']} of "
              f"{args.max_bucket - 1} buckets", flush=True)
    text = json.dumps(doc)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
