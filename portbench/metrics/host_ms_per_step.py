"""The host's milliseconds to enqueue one step, timed right after a
``synchronize()`` so that it does not wait on a full launch queue; the
median over the timed steps."""

import statistics


def read(ctx):
    return statistics.median(ctx.host_ms) if ctx.host_ms else None
