"""Device idle time at a pass boundary of ``training/epoch.py``: from the
end of a pass's last replayed step to the start of the next pass's first,
less the device work in between (the SNR summary, the loss buffer's
clone, the next pass's ``randperm`` and index copy), averaged over the
boundaries of the profiled sub-window. A replay is the set of kernels
that share its launch's correlation id; a boundary is a pair of
consecutive replays with operations outside any replay between them."""

from portbench.harness.readers import Context

UNIT, LAYER, MOVES = "ms", "epoch", "train_rows_per_s"


def read(ctx: Context):
    tr = ctx.trace
    replays = tr.graph_replays()
    idle = [tr.idle_ns(a[-1].end, b[0].start)
            for a, b in zip(replays, replays[1:])
            if tr.ops_between(a[-1].end, b[0].start)]
    if not idle:
        return None
    return sum(idle) / len(idle) / 1e6
