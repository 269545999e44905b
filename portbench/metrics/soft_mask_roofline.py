"""``soft_mask``'s share of its roofline: the least time the H100 could take
for a call (``portbench/bounds/soft_mask.py``) over the device time of every
activity of the call in the traced window, in percent."""

from ..trace import roofline


def read(ctx):
    return roofline(ctx, 'soft_mask')
