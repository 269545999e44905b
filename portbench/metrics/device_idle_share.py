"""Share of the traced window (steps dispatched ahead, one synchronize at
its end) in which no activity ran on the device, in percent."""


def read(ctx):
    return 100. * (1. - ctx.trace.busy_s() / ctx.trace.window_s)
