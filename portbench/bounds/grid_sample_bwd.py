"""Bilinear texture sampling backward (``gs_bwd_*`` kernels and the memset
before them, ``csrc/grid_sample.cu``): the texture's gradient and the two
coordinates' gradients of every point.

Bytes: the texture, the coordinates and the cotangent (C) a point read,
the texture's gradient and two coordinate gradients a point written.
Operations: 10 a point and 26 a channel."""

from .common import OPS_GS_BWD_CHANNEL, OPS_GS_POINT

NAMES = ('gs_bwd_point_kernel', 'gs_bwd_scan_kernel', 'gs_bwd_place_kernel',
         'gs_bwd_plan_kernel', 'gs_bwd_sum_kernel')
MEMSET_BEFORE = ('gs_bwd_point_kernel',)


def work(b):
    Bt, C, Ht, Wt = b['texture']
    B, H, W = b['face_idx'].shape
    pts = B * H * W
    nbytes = 4 * (2 * Bt * C * Ht * Wt + pts * (4 + C))
    return nbytes, pts * (OPS_GS_POINT + OPS_GS_BWD_CHANNEL * C)
