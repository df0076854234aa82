"""The share of the profiled evaluation sub-window in which no operation
ran on the device, in % (rank 0's on a mesh)."""

from portbench.harness.readers import Context, idle_share

UNIT, LAYER, MOVES = "%", "device", "eval_rows_per_s"


def read(ctx: Context):
    return idle_share(ctx)
