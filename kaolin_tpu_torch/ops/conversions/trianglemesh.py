"""Triangle mesh to voxelgrid conversion. Port of
``kaolin_tpu/ops/conversions/trianglemesh.py`` (reference
``kaolin/ops/conversions/trianglemesh.py:24``).

Each face is sampled on a barycentric lattice fine enough that adjacent
samples fall in neighbouring voxels (the JAX package's replacement for
the reference's edge subdivision), and the samples are scattered into the
grid, on the vertices' device.
"""

import numpy as np
import torch

from .pointcloud import _base_points_to_voxelgrids

__all__ = ['trianglemeshes_to_voxelgrids']


def trianglemeshes_to_voxelgrids(vertices, faces, resolution, origin=None,
                                 scale=None):
    """Converts meshes to surface-occupancy voxelgrids.

    The lattice has ``n`` points an edge, from the longest edge in voxel
    units (one read of the host), clipped to [2, 4 x resolution]: a face
    takes n (n + 1) / 2 samples. Its weights are float64, as the JAX
    package's under 64-bit mode, so the samples are float64.

    Args:
        vertices: (batch_size, num_vertices, 3).
        faces: (num_faces, 3) int.
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
        origin = torch.amin(vertices, dim=1)
    if scale is None:
        scale = torch.amax(torch.amax(vertices, dim=1) - origin, dim=1)
    normalized = (vertices - origin[:, None]) / scale[:, None, None]

    faces = torch.as_tensor(faces, device=vertices.device).long()
    v0 = normalized[:, faces[:, 0]]
    v1 = normalized[:, faces[:, 1]]
    v2 = normalized[:, faces[:, 2]]
    e = torch.maximum(torch.maximum(torch.linalg.norm(v1 - v0, dim=-1),
                                    torch.linalg.norm(v2 - v1, dim=-1)),
                      torch.linalg.norm(v0 - v2, dim=-1))
    n = int(np.ceil(float(torch.max(e)) * resolution * 2)) + 1
    n = min(max(n, 2), 4 * resolution)
    # jnp.linspace(0, 1, n): i / (n - 1), then the end point
    s = torch.cat([torch.arange(n - 1, dtype=torch.float64) / (n - 1),
                   torch.ones(1, dtype=torch.float64)])
    u, v = torch.meshgrid(s, s, indexing='ij')
    keep = (u + v) <= 1.
    u = u[keep].to(vertices.device)
    v = v[keep].to(vertices.device)
    w = 1. - u - v
    samples = (v0[:, :, None] * w[None, None, :, None]
               + v1[:, :, None] * u[None, None, :, None]
               + v2[:, :, None] * v[None, None, :, None])
    B = vertices.shape[0]
    return _base_points_to_voxelgrids(samples.reshape(B, -1, 3), resolution)
