"""Coordinate-system conversions (spherical <-> cartesian). Port of
``kaolin_tpu/ops/coords.py`` (reference ``kaolin/ops/coords.py:20-61``).
"""

import torch

__all__ = ['spherical2cartesian', 'cartesian2spherical']


def spherical2cartesian(azimuth, elevation, distance=None):
    """Converts spherical coordinates to cartesian.

    Reference convention (``kaolin/ops/coords.py:20``): X toward the
    camera, Z up, Y right: ``x = cos(elevation) * cos(azimuth)``,
    ``y = cos(elevation) * sin(azimuth)``, ``z = sin(elevation)``,
    all scaled by ``distance``.

    Returns:
        (x, y, z) tensors of the input shape.
    """
    if distance is None:
        z = torch.sin(elevation)
        proj = torch.cos(elevation)
    else:
        z = torch.sin(elevation) * distance
        proj = torch.cos(elevation) * distance
    x = proj * torch.cos(azimuth)
    y = proj * torch.sin(azimuth)
    return x, y, z


def cartesian2spherical(x, y, z):
    """Converts cartesian coordinates to spherical
    (azimuth, elevation, distance).

    Reference: ``kaolin/ops/coords.py:44`` (the same X-toward-camera /
    Z-up / Y-right convention as :func:`spherical2cartesian`).
    """
    distance = torch.sqrt(x * x + y * y + z * z)
    elevation = torch.arcsin(z / distance)
    azimuth = torch.arctan2(y, x)
    return azimuth, elevation, distance
