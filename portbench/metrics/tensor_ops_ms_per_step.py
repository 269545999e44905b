"""Device milliseconds a step of the activities that are not the
package's own kernels (``portbench/bounds``) nor NCCL's: PyTorch's
elementwise, gather, scatter, reduction and copy kernels on the path."""


def read(ctx):
    t = ctx.trace.seconds('')
    return t * 1e3 / ctx.trace.steps if t else None
