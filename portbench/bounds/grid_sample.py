"""Bilinear texture sampling forward (``interleave_kernel`` and
``grid_sample_fwd_kernel``, ``csrc/grid_sample.cu``): one sample a pixel.

Bytes: the texture and the two coordinates a point read once, C samples
a point written. Operations: 10 a point and 11 a channel."""

from .common import OPS_GS_CHANNEL, OPS_GS_POINT

NAMES = ('interleave_kernel', 'grid_sample_fwd_kernel')
MEMSET_BEFORE = ()


def work(b):
    Bt, C, Ht, Wt = b['texture']
    B, H, W = b['face_idx'].shape
    pts = B * H * W
    nbytes = 4 * (Bt * C * Ht * Wt + pts * (2 + C))
    return nbytes, pts * (OPS_GS_POINT + OPS_GS_CHANNEL * C)
