"""Legacy camera functions used by the DIB-R rendering path.

Port of ``kaolin_tpu/render/camera/legacy.py`` (reference
``kaolin/render/camera/legacy.py:22-159``). Plain tensor math.
"""

import math

import torch

from ...tracing import span

__all__ = [
    'rotate_translate_points',
    'generate_rotate_translate_matrices',
    'generate_transformation_matrix',
    'perspective_camera',
    'generate_perspective_projection',
]


def _match_batch(a, b):
    """Tiles whichever of two (N, 3) tensors has the smaller batch."""
    if a.shape[0] < b.shape[0]:
        a = a.repeat(b.shape[0], 1)
    elif a.shape[0] > b.shape[0]:
        b = b.repeat(a.shape[0], 1)
    return a, b


def rotate_translate_points(points, camera_rot, camera_trans):
    """Applies ``P_new = R * (P_old - T)`` to batched points.

    Args:
        points: (batch_size, num_points, 3).
        camera_rot: (batch_size, 3, 3).
        camera_trans: (batch_size, 3).
    """
    translated = points - camera_trans.reshape(-1, 1, 3)
    return torch.matmul(translated, camera_rot.transpose(-1, -2))


def generate_rotate_translate_matrices(camera_position, look_at,
                                       camera_up_direction):
    """Camera rotation/translation from eye / at / up.

    Returns (rot (B,3,3), trans (B,3)) with rows (camx, camy, -camz).
    """
    camz = look_at - camera_position
    camz = camz / (torch.linalg.norm(camz, dim=1, keepdim=True) + 1e-10)
    camz, camera_up_direction = _match_batch(camz, camera_up_direction)
    camx = torch.linalg.cross(camz, camera_up_direction, dim=1)
    camx = camx / (torch.linalg.norm(camx, dim=1, keepdim=True) + 1e-10)
    camy = torch.linalg.cross(camx, camz, dim=1)
    camy = camy / (torch.linalg.norm(camy, dim=1, keepdim=True) + 1e-10)
    mtx = torch.stack([camx, camy, -camz], dim=1)
    return mtx, camera_position


def generate_transformation_matrix(camera_position, look_at,
                                   camera_up_direction):
    """4x3 camera transformation matrix (``P_cam = [P_world, 1] @ M``)."""
    z_axis = camera_position - look_at
    z_axis = z_axis / torch.linalg.norm(z_axis, dim=1, keepdim=True)
    z_axis, camera_up_direction = _match_batch(z_axis, camera_up_direction)
    x_axis = torch.linalg.cross(camera_up_direction, z_axis, dim=1)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=1, keepdim=True)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=1)
    rot_part = torch.stack([x_axis, y_axis, z_axis], dim=2)
    trans_part = torch.matmul(-camera_position[:, None, :], rot_part)
    return torch.cat([rot_part, trans_part], dim=1)


def perspective_camera(points, camera_proj):
    """Projects camera-space points to the image plane (divide by z').

    Args:
        points: (batch_size, num_points, 3) in camera coordinates.
        camera_proj: (3, 1) projection vector.
    """
    with span('kaolin.perspective_camera'):
        projected = points * camera_proj.reshape(-1, 1, 3)
        return projected[:, :, :2] / projected[:, :, 2:3]


def generate_perspective_projection(fovyangle, ratio=1.0,
                                    dtype=torch.float32, device='cuda'):
    """Perspective projection vector ``[1/(r·tan(fovy/2)), 1/tan(fovy/2), -1]``.

    Shape (3, 1), on ``device``.
    """
    tanfov = math.tan(fovyangle / 2.0)
    return torch.tensor([[1.0 / (ratio * tanfov)], [1.0 / tanfov], [-1.]],
                        dtype=dtype, device=device)
