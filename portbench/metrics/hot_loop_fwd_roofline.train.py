"""B1 (``ops/hot_loop.py`` -> ``csrc/hot_loop_fwd.cu``) in the training
step, at ``[k, B]`` = (50, 100): its least time over its device time, in %
(``portbench/kernels/hot_loop_fwd.py`` counts the work)."""

from portbench.harness.readers import Context, roofline_share

UNIT, LAYER, MOVES = "%", "kernels", "train_rows_per_s"


def read(ctx: Context):
    return roofline_share(ctx, "hot_loop_fwd")
