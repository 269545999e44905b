"""SPC point, Morton and trilinear utilities. Port of
``kaolin_tpu/ops/spc/points.py`` (reference
``kaolin/ops/spc/points.py:35-351``).

Morton layout: bits interleaved as ``x << 2 | y << 1 | z`` per level (z
least significant). The octree is built on the host by the native library
(``csrc/core.cpp``, scene preprocessing with data-dependent shapes), as the
JAX package does; ``_octree_bytes`` is its numpy plain version. Queries
and interpolation are tensor operations on the inputs' device.
"""

import warnings

import numpy as np
import torch

from ...native import points_to_octree_fast
from ...casts import to_int

__all__ = [
    'quantize_points',
    'unbatched_points_to_octree',
    'points_to_morton',
    'morton_to_points',
    'points_to_corners',
    'unbatched_interpolate_trilinear',
    'coords_to_trilinear_coeffs',
    'coords_to_trilinear',
    'create_dense_spc',
]


def quantize_points(x, level):
    """Quantizes [-1, 1] coords to the integer grid [0, 2^level - 1],
    int16."""
    res = 2 ** level
    return to_int(torch.floor(torch.clamp(res * (x + 1.0) / 2.0, 0,
                                          res - 1.)), torch.int16)


def _spread3(v):
    """Spreads 16 bits of v so there are 2 zero bits between each (the
    Morton interleave); works on int64 tensors and numpy arrays."""
    m = v & 0xFFFF
    m = (m | (m << 16)) & 0x0000FF0000FF
    m = (m | (m << 8)) & 0x00F00F00F00F
    m = (m | (m << 4)) & 0x0C30C30C30C3
    m = (m | (m << 2)) & 0x249249249249
    return m


def _compact3(v):
    m = v & 0x249249249249
    m = (m | (m >> 2)) & 0x0C30C30C30C3
    m = (m | (m >> 4)) & 0x00F00F00F00F
    m = (m | (m >> 8)) & 0x0000FF0000FF
    m = (m | (m >> 16)) & 0xFFFF
    return m


def points_to_morton(points):
    """(Quantized) 3D points to Morton codes, int64."""
    shape = points.shape[:-1]
    p = points.reshape(-1, 3).to(torch.int64)
    code = (_spread3(p[:, 0]) << 2) | (_spread3(p[:, 1]) << 1) \
        | _spread3(p[:, 2])
    return code.reshape(shape)


def morton_to_points(morton):
    """Morton codes to (quantized) 3D points, int16."""
    shape = tuple(morton.shape) + (3,)
    m = morton.reshape(-1).to(torch.int64)
    return torch.stack([_compact3(m >> 2), _compact3(m >> 1), _compact3(m)],
                       dim=-1).to(torch.int16).reshape(shape)


def _corner_offsets(dtype, device):
    i = torch.arange(8, device=device)
    return torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1],
                       dim=-1).to(dtype)


def points_to_corners(points):
    """The 8 corners of each voxel (point = corner 0), in Morton corner
    order."""
    return points[..., None, :] + _corner_offsets(points.dtype, points.device)


def _morton_np(points):
    p = np.asarray(points, dtype=np.int64)
    return (_spread3(p[:, 0]) << 2) | (_spread3(p[:, 1]) << 1) \
        | _spread3(p[:, 2])


def _compact3_np(v):
    return _compact3(np.asarray(v, dtype=np.int64))


def _octree_bytes(morton, level):
    """Octree bytes, levels 0..level-1 breadth first, of the sorted unique
    Morton codes ``morton`` at ``level`` (numpy): the plain version of the
    native library's ``points_to_octree``."""
    octree_levels = []
    cur = morton
    for _ in range(level):
        parents = cur >> 3
        child = (cur & 7).astype(np.int64)
        uniq_parents, inverse = np.unique(parents, return_inverse=True)
        bytes_ = np.zeros(uniq_parents.shape[0], dtype=np.uint8)
        np.bitwise_or.at(bytes_, inverse.reshape(-1),
                         (1 << child).astype(np.uint8))
        octree_levels.append(bytes_)
        cur = uniq_parents
    octree_levels.reverse()
    return np.concatenate(octree_levels)


def unbatched_points_to_octree(points, level, sorted=False):
    """Builds the octree byte stream of quantized 3D points on the host,
    with the native library, as the JAX package does
    (``kaolin_tpu/ops/spc/points.py:155``).

    Bytes are breadth-first, levels 0..level-1; bit ``i`` of a byte marks
    occupancy of child octant ``i = x<<2 | y<<1 | z``.

    Returns:
        uint8 tensor of octree bytes, on the points' device.
    """
    pts = points.detach().cpu().numpy() if torch.is_tensor(points) \
        else np.asarray(points)
    device = points.device if torch.is_tensor(points) else 'cpu'
    return torch.as_tensor(points_to_octree_fast(pts.reshape(-1, 3), level),
                           device=device)


def coords_to_trilinear_coeffs(coords, points, level):
    """Trilinear interpolation coefficients with respect to the voxel
    corners, in :func:`points_to_corners`' order."""
    shape = tuple(points.shape[:-1]) + (8,)
    p = points.reshape(-1, 3).to(coords.dtype)
    c = coords.reshape(-1, 3)
    x = (2 ** level) * (c * 0.5 + 0.5) - p
    off = _corner_offsets(coords.dtype, coords.device)
    bx, by, bz = off[:, 0], off[:, 1], off[:, 2]
    wx = bx[None] * x[:, 0:1] + (1 - bx)[None] * (1 - x[:, 0:1])
    wy = by[None] * x[:, 1:2] + (1 - by)[None] * (1 - x[:, 1:2])
    wz = bz[None] * x[:, 2:3] + (1 - bz)[None] * (1 - x[:, 2:3])
    return (wx * wy * wz).reshape(shape)


def unbatched_interpolate_trilinear(coords, pidx, point_hierarchy, trinkets,
                                    feats, level):
    """Trilinear interpolation on an SPC feature grid (differentiable).

    Args:
        coords: (num_coords, num_samples, 3) in [-1, 1].
        pidx: (num_coords,) int indices into the point hierarchy (level
            ``level``), e.g. from :func:`unbatched_query`; -1 for misses
            (result 0).
        point_hierarchy: (num_points, 3) int16.
        trinkets: (num_points, 8) int corner indices into ``feats``.
        feats: (num_feats, feature_dim).
        level: octree level of the query.

    Returns:
        (num_coords, num_samples, feature_dim).
    """
    valid = pidx >= 0
    safe = pidx.clamp(min=0).to(torch.int64)
    voxel = point_hierarchy[safe]                              # (N, 3)
    voxel_b = voxel[:, None, :].to(coords.dtype).expand(coords.shape)
    coeffs = coords_to_trilinear_coeffs(coords, voxel_b, level)  # (N, S, 8)
    corner_feats = feats[trinkets[safe].to(torch.int64)]      # (N, 8, D)
    out = torch.einsum('nsk,nkd->nsd', coeffs, corner_feats)
    return torch.where(valid[:, None, None], out, torch.zeros(
        (), dtype=out.dtype, device=out.device))


def create_dense_spc(level, device='cuda'):
    """A fully-dense SPC octree at ``level``: (octree uint8 on ``device``,
    lengths numpy int32)."""
    length = sum(8 ** l for l in range(level))
    octree = torch.full((length,), 255, dtype=torch.uint8, device=device)
    return octree, np.array([length], dtype=np.int32)


def coords_to_trilinear(coords, points, level=None):
    """Deprecated alias of :func:`coords_to_trilinear_coeffs`."""
    warnings.warn('coords_to_trilinear is deprecated, '
                  'use coords_to_trilinear_coeffs instead',
                  DeprecationWarning)
    return coords_to_trilinear_coeffs(coords, points, level)
