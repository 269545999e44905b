"""Triangle-mesh geometry. Port of ``face_normals`` from
``kaolin_tpu/ops/mesh/trianglemesh.py``."""

import torch

__all__ = ['face_normals']


def face_normals(face_vertices, unit=False):
    """Normals of triangle faces: ``cross(v1 - v0, v2 - v0)``.

    Args:
        face_vertices: (batch_size, num_faces, 3, 3).
        unit: normalize to unit length (with the reference's 1e-10 guard).

    Returns:
        (batch_size, num_faces, 3).
    """
    if face_vertices.shape[-2] != 3:
        raise NotImplementedError(
            "face_normals is only implemented for triangle meshes")
    edges0 = face_vertices[:, :, 1] - face_vertices[:, :, 0]
    edges1 = face_vertices[:, :, 2] - face_vertices[:, :, 0]
    normals = torch.linalg.cross(edges0, edges1, dim=-1)
    if unit:
        length = torch.linalg.norm(normals, dim=2, keepdim=True)
        normals = normals / (length + 1e-10)
    return normals
