"""Kernels the device ran per chunk of the streamed NLL, counted in the
device trace (collectives included)."""

from portbench.harness.readers import Context

UNIT, LAYER, MOVES = "kernels", "evaluation", "eval_rows_per_s"


def read(ctx: Context):
    return ctx.per_unit(float(len(ctx.trace.kernels)), "chunks")
