"""The whole training step's share of the card's bf16 peak: the model's
matmul FLOPs per step (the frozen ``train_step_flops``) times the steps of
the unprofiled window, over its seconds and 989 TFLOP/s, in %."""

from portbench.harness.readers import Context, mfu

UNIT, LAYER, MOVES = "%", "whole step", "train_rows_per_s"


def read(ctx: Context):
    return mfu(ctx)
