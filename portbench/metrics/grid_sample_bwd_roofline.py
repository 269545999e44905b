"""``grid_sample_bwd``'s share of its roofline: the least time the H100 could take
for a call (``portbench/bounds/grid_sample_bwd.py``) over the device time of every
activity of the call in the traced window, in percent."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, 'grid_sample_bwd')
