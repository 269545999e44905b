"""Vertex preparation for mesh rendering. Port of ``prepare_vertices``
from ``kaolin_tpu/render/mesh/utils.py``."""

import torch
import torch.nn.functional as F

from .. import camera
from ... import ops

__all__ = ['prepare_vertices']


def prepare_vertices(vertices, faces, camera_proj, camera_rot=None,
                     camera_trans=None, camera_transform=None):
    """Moves vertices to camera space, projects them, indexes by faces.

    Give either ``camera_rot`` and ``camera_trans`` or ``camera_transform``.

    Returns:
        (face_vertices_camera (B,F,3,3), face_vertices_image (B,F,3,2),
         face_normals (B,F,3) unit).
    """
    if camera_transform is None:
        if camera_trans is None or camera_rot is None:
            raise ValueError("camera_transform or camera_trans and "
                             "camera_rot must be defined")
        vertices_camera = camera.rotate_translate_points(
            vertices, camera_rot, camera_trans)
    else:
        if camera_trans is not None or camera_rot is not None:
            raise ValueError("camera_trans and camera_rot must be None when "
                             "camera_transform is defined")
        padded = F.pad(vertices, (0, 1), value=1.)
        vertices_camera = torch.matmul(padded, camera_transform)
    vertices_image = camera.perspective_camera(vertices_camera, camera_proj)
    face_vertices_camera = ops.mesh.index_vertices_by_faces(vertices_camera,
                                                            faces)
    face_vertices_image = ops.mesh.index_vertices_by_faces(vertices_image,
                                                           faces)
    normals = ops.mesh.face_normals(face_vertices_camera, unit=True)
    return face_vertices_camera, face_vertices_image, normals
