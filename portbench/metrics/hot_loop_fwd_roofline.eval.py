"""B1 in the streamed NLL, at the chunk's ``[k, B]`` = (250, 500): its
least time over its device time, in %."""

from portbench.harness.readers import Context, roofline_share

UNIT, LAYER, MOVES = "%", "kernels", "eval_rows_per_s"


def read(ctx: Context):
    return roofline_share(ctx, "hot_loop_fwd")
