"""The whole k=5000 pass's share of the bf16 peak of every card it uses:
the frozen ``forward_flops`` of a row at k=5000 times the rows of the
unprofiled window, over its seconds, 989 TFLOP/s and the cards, in %."""

from portbench.harness.readers import Context, mfu

UNIT, LAYER, MOVES = "%", "whole pass", "eval_rows_per_s"


def read(ctx: Context):
    return mfu(ctx)
