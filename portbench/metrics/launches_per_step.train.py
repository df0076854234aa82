"""Kernels the device ran per training step, counted in the device trace
of the profiled sub-window (not the wrappers' own counters)."""

from portbench.harness.readers import Context

UNIT, LAYER, MOVES = "kernels", "step", "train_rows_per_s"


def read(ctx: Context):
    return ctx.per_unit(float(len(ctx.trace.kernels)), "steps")
