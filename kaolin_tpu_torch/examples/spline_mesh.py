"""Parametric spline meshes: surfaces of revolution / lofted bodies driven
by differentiable spline profiles.

Reference: the fork's parametric fish meshes
(``examples/tutorial/ian_fish_body_mesh.py``, ``ian_fish_fin_mesh.py``,
``ian_cubic_spline_optimizer.py``) — generalized to a spline-lofted body:
a profile curve (radius as a function of axial position) interpolated with
cubic Hermite splines and revolved/scaled into a closed triangle mesh.
The control points are the learnable parameters.
"""

import numpy as np
import torch

from .spline import natural_cubic_spline
from .utils import linspace

__all__ = ['spline_body_mesh', 'make_ring_topology']


def make_ring_topology(n_axial, n_radial):
    """Triangle faces for an (n_axial x n_radial) cylinder-like grid with
    two pole vertices closing the ends. Host-side static topology."""
    faces = []

    def vid(i, j):
        return 2 + i * n_radial + (j % n_radial)
    # pole 0 connects to ring 0
    for j in range(n_radial):
        faces.append([0, vid(0, j + 1), vid(0, j)])
    for i in range(n_axial - 1):
        for j in range(n_radial):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            faces.append([a, b, d])
            faces.append([a, d, c])
    for j in range(n_radial):
        faces.append([1, vid(n_axial - 1, j), vid(n_axial - 1, j + 1)])
    return np.asarray(faces, np.int64)


def spline_body_mesh(ctrl_x, ctrl_ry, ctrl_rz, n_axial=32, n_radial=24,
                     length=1.0):
    """Builds a closed body mesh from spline radius profiles.

    Args:
        ctrl_x: (K,) increasing control-point axial positions in [0, 1].
        ctrl_ry: (K,) vertical radii at the control points (learnable).
        ctrl_rz: (K,) lateral radii at the control points (learnable).
        n_axial, n_radial: surface resolution.
        length: body length.

    Returns:
        (vertices (1, 2 + n_axial*n_radial, 3) tensor on the radii's
        device — differentiable w.r.t. the control radii — and faces
        (F, 3) numpy).
    """
    dev = ctrl_ry.device
    ctrl_x = torch.as_tensor(ctrl_x, dtype=ctrl_ry.dtype, device=dev)
    x0, x1 = float(ctrl_x[0]), float(ctrl_x[-1])
    xs = linspace(x0, x1, n_axial, dev)
    # torch.maximum, as jnp.clip, passes half the gradient at a tie
    ry = natural_cubic_spline(ctrl_x, ctrl_ry, xs)
    ry = torch.maximum(ry, ry.new_full((), 1e-4))
    rz = natural_cubic_spline(ctrl_x, ctrl_rz, xs)
    rz = torch.maximum(rz, rz.new_full((), 1e-4))
    theta = linspace(0., 2. * np.pi, n_radial, dev, endpoint=False)
    x = (xs - 0.5) * length
    ring_y = ry[:, None] * torch.cos(theta)[None, :]
    ring_z = rz[:, None] * torch.sin(theta)[None, :]
    ring_x = x[:, None].expand(ring_y.shape)
    rings = torch.stack([ring_x, ring_y, ring_z], dim=-1).reshape(-1, 3)
    poles = torch.tensor([[(x0 - 0.5) * length, 0., 0.],
                          [(x1 - 0.5) * length, 0., 0.]],
                         dtype=rings.dtype, device=dev)
    vertices = torch.cat([poles, rings], dim=0)[None]
    faces = make_ring_topology(n_axial, n_radial)
    return vertices, faces
