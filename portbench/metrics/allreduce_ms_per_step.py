"""Device milliseconds a step of NCCL's kernels on rank 0: the
all-reduces of the replicated tensors' gradients."""


def read(ctx):
    t = ctx.trace.seconds('nccl')
    return t * 1e3 / ctx.trace.steps if t else None
