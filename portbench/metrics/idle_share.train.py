"""The share of the profiled training sub-window in which no operation ran
on the device, in %."""

from portbench.harness.readers import Context, idle_share

UNIT, LAYER, MOVES = "%", "device", "train_rows_per_s"


def read(ctx: Context):
    return idle_share(ctx)
