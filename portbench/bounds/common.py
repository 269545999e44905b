"""What the kernels' bounds share: the H100's published peaks, the float
operations per unit of work counted from the kernels' formulas, and the
per-pixel count of boxes holding the pixel's centre.

Peaks: NVIDIA's H100 SXM data sheet (dense, without sparsity), at the
700 W limit: HBM 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
"""

import torch

from ..reference.render import MULTIPLIER, box_ranges, pixel_centres

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# rasterize, per (pixel, face) pair: 6 subtractions to the pixel, 3 edge
# functions (2 mul, 1 sub each), the normalisation (3 add), 3 divisions,
# the z interpolation (3 mul, 2 add)
OPS_RASTER_PAIR = 26
# soft mask, per recorded pair: per edge 38 (line coefficients, the foot
# of the perpendicular, its inside test, the distance), per vertex 5, the
# 5-way min, z, exp, 1-p and the product
OPS_SOFT_PAIR = 3 * 38 + 3 * 5 + 5 + 3 + 1 + 2
# rasterize backward, per covered pixel: x0, y0 (10), the 6 differences,
# k1..k3 and the guard (11), the dw table (28), dw/dax.. (12), the 2 sums
# over the D channels (6 per channel), 1/k3^2 (3), the 6 outputs and
# their sums (24); w_i * g_d and its sum (6 per channel)
OPS_RBWD_PIXEL, OPS_RBWD_CHANNEL = 94, 12
# soft-mask backward, per recorded pair: the forward's distance work,
# dLdz (6) and the derivative of the nearest edge (44)
OPS_SOFT_BWD_PAIR = OPS_SOFT_PAIR + 6 + 44
# bilinear grid sample, per point: two floors, the fractions and their
# complements, the tap offsets (10); per channel, forward: 8 products and
# 3 sums; backward: the coordinate terms (4 differences, 6 products, 4
# sums), the 4 tap weights (8 products) and their 4 adds into the texture
OPS_GS_POINT, OPS_GS_CHANNEL, OPS_GS_BWD_CHANNEL = 10, 11, 26


def bound_seconds(nbytes, ops):
    """The least time of a call that reads and writes ``nbytes`` and
    computes ``ops`` float operations: the larger of the two at peak."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def scaled_boxes(face_image, margin=0.):
    """(B, F, 4) boxes of the scaled image coordinates, grown by
    ``margin`` (in image units) on every side."""
    pts = face_image * MULTIPLIER
    m = margin * MULTIPLIER
    return torch.cat([pts.amin(-2) - m, pts.amax(-2) + m], -1)


def pixel_hits(bbox, height, width):
    """(B, H, W) int64: per pixel, the boxes of its batch entry that hold
    its centre (a 2-D difference array over each box's rows and
    columns)."""
    B = bbox.shape[0]
    x0, y0 = pixel_centres(height, width, bbox.dtype, bbox.device)
    r_lo, r_hi, c_lo, c_hi = box_ranges(bbox, x0, y0)
    ok = (c_hi > c_lo) & (r_hi > r_lo)
    diff = torch.zeros((B, height + 1, width + 1), dtype=torch.int64,
                       device=bbox.device)
    b = torch.arange(B, device=bbox.device)[:, None].expand_as(c_lo)[ok]
    ones = torch.ones_like(b)
    for r, c, sign in ((r_lo, c_lo, 1), (r_lo, c_hi, -1), (r_hi, c_lo, -1),
                       (r_hi, c_hi, 1)):
        diff.index_put_((b, r[ok], c[ok]), sign * ones, accumulate=True)
    return diff.cumsum(1).cumsum(2)[:, :height, :width]
