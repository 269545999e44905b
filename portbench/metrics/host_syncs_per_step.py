"""The synchronizing CUDA calls of one step, as
``torch.cuda.set_sync_debug_mode('warn')`` reports them."""


def read(ctx):
    return ctx.syncs
