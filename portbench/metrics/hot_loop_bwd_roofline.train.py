"""B2 (``csrc/hot_loop_bwd.cu``) in the training step: its least time over
its device time, in % (``portbench/kernels/hot_loop_bwd.py`` counts the
work)."""

from portbench.harness.readers import Context, roofline_share

UNIT, LAYER, MOVES = "%", "kernels", "train_rows_per_s"


def read(ctx: Context):
    return roofline_share(ctx, "hot_loop_bwd")
