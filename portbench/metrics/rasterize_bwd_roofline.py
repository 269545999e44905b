"""``rasterize_bwd``'s share of its roofline: the least time the H100 could take
for a call (``portbench/bounds/rasterize_bwd.py``) over the device time of every
activity of the call in the traced window, in percent."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, 'rasterize_bwd')
