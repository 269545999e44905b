"""Spherical harmonics lighting (9 coefficients, degree 3). Port of
``kaolin_tpu/render/lighting/sh.py``."""

import math

import torch

__all__ = ['project_onto_sh9', 'sh9_irradiance', 'sh9_diffuse']


def project_onto_sh9(directions, device='cuda'):
    """Projects cartesian directions onto degree-3 SH coefficients.

    Args:
        directions: tensor with last dimension 3, or a list of 3 floats
            (made a float32 tensor on ``device``).

    Returns:
        tensor of shape ``directions.shape[:-1] + (9,)``.
    """
    if isinstance(directions, (list, tuple)):
        directions = torch.tensor(directions, dtype=torch.float32,
                                  device=device)
    x = directions[..., 0:1]
    y = directions[..., 1:2]
    z = directions[..., 2:3]
    band0 = torch.full_like(x, 0.28209479177)
    band1_m1 = -0.4886025119 * y
    band1_0 = 0.4886025119 * z
    band1_p1 = -0.4886025119 * x
    band2_m2 = 1.0925484305920792 * (x * y)
    band2_m1 = -1.0925484305920792 * (y * z)
    band2_0 = 0.94617469575 * (z * z) - 0.31539156525
    band2_p1 = -1.0925484305920792 * x * z
    band2_p2 = 0.5462742152960396 * (x * x - y * y)
    return torch.cat([band0, band1_m1, band1_0, band1_p1, band2_m2,
                      band2_m1, band2_0, band2_p1, band2_p2], dim=-1)


def sh9_irradiance(lights, normals):
    """Approximate incident irradiance from one SH lobe of degree 3
    (clamped cosine lobe as SH).

    Args:
        lights: (9,) SH coefficients.
        normals: (num_points, 3).

    Returns:
        (num_points,) irradiance.
    """
    if tuple(lights.shape) != (9,):
        raise ValueError(f'lights must be (9,), got {tuple(lights.shape)}')
    if normals.ndim != 2 or normals.shape[-1] != 3:
        raise ValueError(f'normals must be (N, 3), got '
                         f'{tuple(normals.shape)}')
    bands = project_onto_sh9(normals)
    scale = torch.tensor([math.pi] + [2. * math.pi / 3.] * 3
                         + [math.pi / 4.] * 5, dtype=bands.dtype,
                         device=bands.device)
    bands = bands * scale
    return torch.sum(bands * lights[None, :], dim=-1)


def sh9_diffuse(directions, normals, albedo):
    """Lambertian diffuse radiance from a single SH lobe: ``directions``
    (3,), ``normals`` and ``albedo`` (N, 3)."""
    if tuple(directions.shape) != (3,):
        raise ValueError(f'directions must be (3,), got '
                         f'{tuple(directions.shape)}')
    if normals.ndim != 2 or normals.shape[1] != 3 \
            or normals.shape != albedo.shape:
        raise ValueError('normals and albedo must both be (N, 3)')
    lights = project_onto_sh9(directions)
    irradiance = sh9_irradiance(lights, normals)
    return albedo * irradiance[..., None]
