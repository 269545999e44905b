"""``rasterize`` forward: the z-buffer selection and the interpolation of
the winner's features (``csrc/rasterize.cu``), with the binning of the
per-tile face lists it walks (``tile_bins_kernel`` and the memset before
it, ``csrc/tile_lists.cuh``).

Bytes: per face the z, the scaled image coordinates and the box (13
floats) and the features (3 D) read once; per pixel the face id, the 3
weights and the D features written once. Operations: 26 a (pixel, face)
pair, over the pairs that the valid faces' own boxes hold."""

import torch

from .common import OPS_RASTER_PAIR, pixel_hits, scaled_boxes

NAMES = ('rasterize_kernel', 'tile_bins_kernel')
MEMSET_BEFORE = ('tile_bins_kernel',)


def work(b):
    fvi, valid, face_idx, D = (b[k] for k in ('face_image', 'valid',
                                              'face_idx', 'feat_dim'))
    B, F = fvi.shape[:2]
    _, H, W = face_idx.shape
    boxes = scaled_boxes(fvi)
    empty = boxes.new_tensor([float('inf'), float('inf'), -float('inf'),
                              -float('inf')])
    boxes = torch.where(valid[..., None], boxes, empty)
    pairs = int(pixel_hits(boxes, H, W).sum())
    nbytes = 4 * (B * F * (13 + 3 * D) + B * H * W * (4 + D))
    return nbytes, pairs * OPS_RASTER_PAIR
