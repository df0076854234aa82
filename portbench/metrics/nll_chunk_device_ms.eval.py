"""Device time of one k=250 chunk of the streamed NLL
(``evaluation/metrics.streaming_log_px``, ``ops/logsumexp.py``, the model
and B1 under it): every kernel but the collectives, over the chunks of the
profiled sub-window (a rank's own chunks on a mesh)."""

from portbench.harness.readers import Context

UNIT, LAYER, MOVES = "ms", "evaluation", "eval_rows_per_s"


def read(ctx: Context):
    ns = sum(o.end - o.start for o in ctx.trace.kernels
             if "nccl" not in o.name.lower())
    return ctx.per_unit(ns / 1e6, "chunks")
