"""Point-cloud nearest-neighbour metrics: sided and Chamfer distance,
F-score. Port of ``kaolin_tpu/metrics/pointcloud.py``.

The selection (the index of each point's nearest neighbour) runs without
gradients on detached inputs, through ``kernels.nn_distance``: on the card
the pruned kernel when both clouds span several tiles (the JAX package's
size rule), else the brute-force kernel; on the CPU the plain version. The
distance is then recomputed from the gathered winner with plain tensor
ops, so autograd gives the gradient to both clouds through the fixed
assignment (to ``p2`` the backward of a gather, which on the card adds
with atomics in no fixed order).
"""

import torch

from ..kernels.nn_distance import nearest_idx, nearest_idx_pruned

__all__ = ['sided_distance', 'chamfer_distance', 'f_score']

# the JAX package's route to the pruned kernel: 8 of its 512-query tiles
# and 16 of its 1024-reference chunks
_PRUNE_MIN_N1 = 8 * 512
_PRUNE_MIN_N2 = 16 * 1024


def _nearest(p1, p2):
    with torch.no_grad():
        p1, p2 = p1.detach(), p2.detach()
        if p1.shape[1] >= _PRUNE_MIN_N1 and p2.shape[1] >= _PRUNE_MIN_N2:
            return nearest_idx_pruned(p1, p2)
        return nearest_idx(p1, p2)


def sided_distance(p1, p2):
    """Squared distance and index from each point of ``p1`` (B, N1, 3) to
    its closest point of ``p2`` (B, N2, 3).

    Returns:
        (dist (B, N1), idx (B, N1) int32); ``dist`` is differentiable with
        respect to both clouds. Ties keep the lowest index.
    """
    idx = _nearest(p1, p2)
    nearest = torch.gather(p2, 1, idx.long()[..., None].expand(-1, -1, 3))
    d = p1 - nearest
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2], idx


def chamfer_distance(p1, p2, w1=1., w2=1., squared=True):
    """Chamfer distance between two batched point clouds: ``w1`` times the
    mean distance from ``p1`` to ``p2`` plus ``w2`` times the reverse;
    squared distances unless ``squared=False``. Returns (B,)."""
    sdist1 = sided_distance(p1, p2)[0]
    sdist2 = sided_distance(p2, p1)[0]
    if not squared:
        sdist1 = torch.sqrt(sdist1)
        sdist2 = torch.sqrt(sdist2)
    return w1 * sdist1.mean(dim=-1) + w2 * sdist2.mean(dim=-1)


def f_score(gt_points, pred_points, radius=0.01, eps=1e-8):
    """F-score of two point sets (B, N, 3) with a hit radius. Returns
    (B,)."""
    pred_distances = torch.sqrt(sided_distance(gt_points, pred_points)[0])
    gt_distances = torch.sqrt(sided_distance(pred_points, gt_points)[0])
    dtype = gt_points.dtype
    fn = (pred_distances > radius).sum(dim=1).to(dtype)
    fp = (gt_distances > radius).sum(dim=1).to(dtype)
    tp = gt_distances.shape[1] - fp
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * (precision * recall) / (precision + recall + eps)
