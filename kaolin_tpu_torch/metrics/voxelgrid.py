"""Voxelgrid metrics. Port of ``kaolin_tpu/metrics/voxelgrid.py``
(reference ``kaolin/metrics/voxelgrid.py:19-50``).
"""

import torch

__all__ = ['iou']


def iou(pred, gt):
    """Intersection-over-union of two (boolean-interpreted) voxelgrids.

    Args:
        pred, gt: (batch_size, X, Y, Z), same shape.

    Returns:
        (batch_size,) float32 IoU.
    """
    if pred.shape != gt.shape:
        raise ValueError(
            f"Expected predicted voxelgrids and ground truth voxelgrids to "
            f"have the same shape, but got {pred.shape} and {gt.shape}.")
    pred = pred.to(torch.bool)
    gt = gt.to(torch.bool)
    intersection = torch.sum(pred & gt, dim=(1, 2, 3)).to(torch.float32)
    union = torch.sum(pred | gt, dim=(1, 2, 3)).to(torch.float32)
    return intersection / union
