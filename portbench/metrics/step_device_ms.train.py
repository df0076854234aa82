"""Device time of the training step: the summed time of every kernel in
the profiled sub-window, over the steps it holds (``training/train_step.py``,
``objectives/gradients.py``, ``models/iwae.py`` and the kernels under them,
replayed from the step's CUDA graph)."""

from portbench.harness.readers import Context

UNIT, LAYER, MOVES = "ms", "step", "train_rows_per_s"


def read(ctx: Context):
    return ctx.per_unit(ctx.trace.device_ns / 1e6, "steps")
