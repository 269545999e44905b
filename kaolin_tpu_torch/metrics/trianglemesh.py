"""Point-to-mesh distance and mesh regularizers. Port of
``kaolin_tpu/metrics/trianglemesh.py``.

The winner face and distance type of each point are selected without
gradients on detached inputs, through ``kernels.p2m_distance`` (the CUDA
kernel on the card, the plain version on the CPU); the distance is then
recomputed from the gathered winner with plain tensor ops, as the JAX
package does, so autograd gives the gradient to the points and the face
vertices (to the faces the backward of a gather, which on the card adds
with atomics in no fixed order).
"""

import torch

from ..kernels.p2m_distance import _cross, _dot, _unit_normal, p2m_select
from ..ops.mesh.mesh import uniform_laplacian
from ..ops.mesh.trianglemesh import average_edge_length

__all__ = [
    'point_to_mesh_distance',
    'average_edge_length',
    'uniform_laplacian_smoothing',
]


def point_to_mesh_distance(pointclouds, face_vertices):
    """Squared distance from each point to the nearest triangle of a mesh.

    Args:
        pointclouds: (batch_size, num_points, 3).
        face_vertices: (batch_size, num_faces, 3, 3).

    Returns:
        (distance (B, N), face_idx (B, N) int32, dist_type (B, N) int32):
        type 0 = face interior, 1-3 = vertex, 4-6 = edge, and sums where
        region flags overlap (e.g. 10), whose distance is recomputed to the
        face's plane as in the JAX package. The distance is differentiable
        with respect to both inputs through the fixed assignment.
    """
    with torch.no_grad():
        idx, types = p2m_select(pointclouds.detach(), face_vertices.detach())
    sel = torch.gather(face_vertices, 1, idx.long()[..., None, None]
                       .expand(-1, -1, 3, 3))
    v1, v2, v3 = sel[..., 0, :], sel[..., 1, :], sel[..., 2, :]
    e21 = v2 - v1
    e32 = v3 - v2
    e13 = v1 - v3
    normals = -_cross(e21, e13)
    uab = _dot(pointclouds - v1, e21) / _dot(e21, e21)
    ubc = _dot(pointclouds - v2, e32) / _dot(e32, e32)
    uca = _dot(pointclouds - v3, e13) / _dot(e13, e13)
    unit_n = _unit_normal(normals)
    plane_pt = pointclouds - unit_n * _dot(pointclouds - v1, unit_n)[..., None]
    t = types[..., None]
    counter_p = torch.where(t == 1, v1,
                torch.where(t == 2, v2,
                torch.where(t == 3, v3,
                torch.where(t == 4, v1 + e21 * uab[..., None],
                torch.where(t == 5, v2 + e32 * ubc[..., None],
                torch.where(t == 6, v3 + e13 * uca[..., None],
                            plane_pt))))))
    d = counter_p - pointclouds
    return _dot(d, d), idx, types


def uniform_laplacian_smoothing(vertices, faces):
    """Uniform-laplacian smoothed vertex positions (the average of each
    vertex's neighbours): ``L @ vertices + vertices`` for ``vertices``
    (B, V, 3). A plain product, as in the JAX package; TF32 is the
    caller's setting (``torch.backends.cuda.matmul.allow_tf32``)."""
    L = uniform_laplacian(vertices.shape[1], faces, device=vertices.device)
    return torch.matmul(L.to(vertices.dtype), vertices) + vertices
