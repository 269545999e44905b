"""Rendering metrics: silhouette mask IoU. Port of
``kaolin_tpu/metrics/render.py``."""

from ..tracing import span

__all__ = ['mask_iou']


def mask_iou(lhs_mask, rhs_mask):
    """IoU loss (1 - mean IoU) between two soft segmentation masks.

    Args:
        lhs_mask, rhs_mask: (batch_size, height, width).

    Returns:
        scalar loss.
    """
    batch_size = lhs_mask.shape[0]
    if rhs_mask.shape != lhs_mask.shape:
        raise ValueError(f"mask shapes differ: {tuple(lhs_mask.shape)} vs "
                         f"{tuple(rhs_mask.shape)}")
    with span('kaolin.mask_iou'):
        sil_mul = lhs_mask * rhs_mask
        sil_add = lhs_mask + rhs_mask
        iou_up = sil_mul.reshape(batch_size, -1).sum(dim=1)
        iou_down = (sil_add - sil_mul).reshape(batch_size, -1).sum(dim=1)
        iou_neg = iou_up / (iou_down + 1e-10)
        return 1.0 - iou_neg.mean()
