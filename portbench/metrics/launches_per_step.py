"""CUDA kernels a step launches: the kernel activities of the traced
window over its steps."""


def read(ctx):
    n = sum(op.kind == 'kernel' for op in ctx.trace.ops)
    return n / ctx.trace.steps if n else None
