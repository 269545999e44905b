"""Pointcloud conversions: to voxelgrids and to SPC. Port of
``kaolin_tpu/ops/conversions/pointcloud.py`` (reference
``kaolin/ops/conversions/pointcloud.py:77-197``).
"""

import numpy as np
import torch

from ..spc.points import _morton_np, quantize_points
from ..spc.points import unbatched_points_to_octree
from ...casts import to_int

__all__ = ['pointclouds_to_voxelgrids', 'unbatched_pointcloud_to_spc']


def _base_points_to_voxelgrids(points, resolution):
    """Scatters normalized [0, 1] points into binary voxelgrids.

    Reference: ``kaolin/ops/conversions/pointcloud.py:22``: rounds (half
    to even) to the (resolution - 1) grid; out-of-range points go to a
    dump slot past the grid and are discarded.
    """
    B = points.shape[0]
    idx = to_int(torch.round(points * (resolution - 1)), torch.int32)
    in_range = torch.all((idx >= 0) & (idx <= resolution - 1), dim=-1)
    flat = (idx[..., 0].long() * resolution + idx[..., 1]) * resolution \
        + idx[..., 2]
    flat = torch.where(in_range, flat, resolution ** 3)
    grid = torch.zeros((B, resolution ** 3 + 1), dtype=torch.float32,
                       device=points.device)
    grid.scatter_(1, flat, 1.)
    return grid[:, :-1].reshape(B, resolution, resolution, resolution)


def pointclouds_to_voxelgrids(pointclouds, resolution, origin=None,
                              scale=None):
    """Voxelizes batched pointclouds into binary occupancy grids.

    Reference: ``kaolin/ops/conversions/pointcloud.py:77``.

    Args:
        pointclouds: (batch_size, num_points, 3).
        resolution (int).
        origin: optional (batch_size, 3); default per-batch min.
        scale: optional (batch_size,); default max extent.

    Returns:
        (batch_size, resolution, resolution, resolution) float32.
    """
    if not isinstance(resolution, int):
        raise TypeError(f"Expected resolution to be int "
                        f"but got {type(resolution)}.")
    if origin is None:
        origin = torch.amin(pointclouds, dim=1)
    if scale is None:
        scale = torch.amax(torch.amax(pointclouds, dim=1) - origin, dim=1)
    normalized = (pointclouds - origin[:, None]) / scale[:, None, None]
    return _base_points_to_voxelgrids(normalized, resolution)


def unbatched_pointcloud_to_spc(pointcloud, level, features=None):
    """Converts an unbatched [-1, 1] pointcloud to an SPC (plus averaged
    per-cell features).

    Reference: ``kaolin/ops/conversions/pointcloud.py:143``. The cells are
    found on the host (numpy) and the octree built by the native library;
    the features are averaged in float64 on their device.

    Returns:
        kaolin_tpu_torch.rep.Spc with ``features`` set (Morton-ordered per
        occupied leaf cell, mean over points in the cell; integer features
        are rounded), its octree on the pointcloud's device.
    """
    from ...rep.spc import Spc
    qpts = quantize_points(pointcloud, level).cpu().numpy()
    morton_all = _morton_np(qpts.reshape(-1, 3))
    unique_m, unique_keys, unique_counts = np.unique(
        morton_all, return_inverse=True, return_counts=True)
    octree = unbatched_points_to_octree(qpts, level, sorted=False).to(
        pointcloud.device)
    lengths = np.array([octree.shape[0]], dtype=np.int32)

    feat = None
    if features is not None:
        dev = features.device
        acc = torch.zeros((unique_m.shape[0], features.shape[1]),
                          dtype=torch.float64, device=dev)
        acc = acc.index_add(0, torch.as_tensor(unique_keys.reshape(-1),
                                               device=dev),
                            features.to(torch.float64))
        feat = acc / torch.as_tensor(unique_counts, dtype=torch.float64,
                                     device=dev)[:, None]
        if not features.is_floating_point():
            feat = torch.round(feat)
        feat = feat.to(features.dtype)
    return Spc(octrees=octree, lengths=lengths, features=feat)
