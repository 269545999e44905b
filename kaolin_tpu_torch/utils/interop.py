"""Numpy interop and the DIB-R demo scene.

``icosphere`` is a numpy copy of the icosphere builder that the repo's
``__graft_entry__._icosphere`` holds, so the port builds the same meshes
without importing the JAX side. ``dibr_params_from_numpy`` turns the DIB-R
parameters, as numpy arrays, into the port's tensors; the parity tests feed
both packages through it.
"""

import math

import numpy as np
import torch

from ..render import camera

__all__ = ['icosphere', 'dibr_params_from_numpy', 'scene']


def icosphere(subdiv=2):
    """Unit icosphere: (verts (V, 3) float32, faces (20 * 4**subdiv, 3)
    int32), numpy."""
    t = (1. + 5 ** 0.5) / 2.
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(v) / np.linalg.norm(v) for v in verts]
    for _ in range(subdiv):
        mid = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (verts[a] + verts[b]) / 2.
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    return (np.stack(verts).astype(np.float32),
            np.array(faces, dtype=np.int32))


def dibr_params_from_numpy(vertices, faces, cam_rot, cam_trans, cam_proj,
                           device='cuda'):
    """DIB-R parameters from numpy arrays to the port's tensors.

    Float arrays keep their dtype (float32 or float64); faces become int64,
    torch's index type. Returns (vertices, faces, cam_rot, cam_trans,
    cam_proj) on ``device``.
    """
    def to(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return (to(vertices), to(faces, torch.int64), to(cam_rot),
            to(cam_trans), to(cam_proj))


def scene(batch_size, subdiv, dtype=torch.float32, device='cuda'):
    """The DIB-R demo scene: ``batch_size`` copies of an icosphere seen by
    cameras on a ring of radius 3, 0.5 above the equator, 45-degree fovy.

    Returns (vertices (B,V,3), faces (F,3) int64, cam_rot (B,3,3),
    cam_trans (B,3), cam_proj (3,1)) on ``device``.
    """
    verts_np, faces_np = icosphere(subdiv)
    angles = np.linspace(0., 2 * np.pi, batch_size, endpoint=False)
    cam_pos = torch.as_tensor(
        np.stack([3 * np.sin(angles), 0.5 * np.ones_like(angles),
                  3 * np.cos(angles)], axis=-1), dtype=dtype, device=device)
    look_at = torch.zeros((batch_size, 3), dtype=dtype, device=device)
    cam_up = torch.tensor([[0., 1., 0.]], dtype=dtype,
                          device=device).repeat(batch_size, 1)
    cam_rot, cam_trans = camera.generate_rotate_translate_matrices(
        cam_pos, look_at, cam_up)
    cam_proj = camera.generate_perspective_projection(
        math.pi / 4., dtype=dtype, device=device)
    verts = torch.as_tensor(verts_np, dtype=dtype, device=device)
    verts = verts[None].repeat(batch_size, 1, 1)
    faces = torch.as_tensor(faces_np, dtype=torch.int64, device=device)
    return verts, faces, cam_rot, cam_trans, cam_proj
