"""Shared helpers for the example apps: spherical-view cameras, vertex
recentering, multiview data loading, and the device and random-draw
rules every example follows.

Reference: ``examples/tutorial/ian_utils.py`` (fork layer).
"""

import glob
import os

import numpy as np
import torch

from .. import io as kio
from ..ops.mesh.trianglemesh import _sample_from_uniforms
from ..render import camera as kcam

__all__ = ['check_device', 'linspace', 'uniform', 'sample_points',
           'get_camera_transform_from_view',
           'get_camera_projection', 'recenter_vertices',
           'load_synthetic_views']


def check_device(device):
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is visible (an example never carries on on the CPU unasked)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device} asked for, but no CUDA card is visible; '
            "pass device='cpu' (--device cpu) to run on the CPU")
    return device


def linspace(start, stop, num, device, endpoint=True, dtype=torch.float32):
    """``num`` evenly spaced values, computed as ``jnp.linspace`` computes
    them (``start * (1 - s) + stop * s`` with ``s = i / div``, the end
    point exact), on ``device``; ``start`` and ``stop`` are numbers, so
    nothing is copied from the host (a copy waits for the card)."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = (num - 1) if endpoint else num
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - step) + stop * step
    if endpoint:
        out = torch.cat([out, out.new_full((1,), stop)])
    return out


def uniform(generator, shape, device, dtype=torch.float32):
    """Uniform [0, 1) draws from a CPU ``torch.Generator``, moved to
    ``device``: the same seed gives the same draws on the card and on the
    CPU. The copy to a card goes from pinned memory without waiting."""
    draws = torch.rand(shape, generator=generator, dtype=dtype)
    if torch.device(device).type == 'cuda':
        draws = draws.pin_memory().to(device, non_blocking=True)
    return draws


def sample_points(vertices, faces, num_samples, generator, areas=None):
    """``ops.mesh.sample_points`` with its uniforms drawn by :func:`uniform`
    (in ``sample_points``' order), so that a seed samples the same points
    on the card and on the CPU; ``generator`` may also be the three
    uniforms themselves, (face (B, S), u (B, S, 1), v (B, S, 1)). Returns
    (points, face choices)."""
    batch, dev = vertices.shape[0], vertices.device
    if isinstance(generator, torch.Generator):
        generator = (
            uniform(generator, (batch, num_samples), dev, vertices.dtype),
            uniform(generator, (batch, num_samples, 1), dev, vertices.dtype),
            uniform(generator, (batch, num_samples, 1), dev, vertices.dtype))
    u_face, u_bary, v_bary = (u.to(dev) for u in generator)
    return _sample_from_uniforms(vertices, faces, u_face, u_bary, v_bary,
                                 areas=areas)


def get_camera_transform_from_view(elev, azim, r=3.0, look_at_height=0.0,
                                   device='cuda'):
    """4x3 camera transform from elevation/azimuth (degrees) and radius.

    Reference: ``ian_utils.py:62``.
    """
    elev = np.deg2rad(elev)
    azim = np.deg2rad(azim)
    x = r * np.sin(elev) * np.sin(azim)
    y = r * np.cos(elev)
    z = r * np.sin(elev) * np.cos(azim)

    def row(*v):
        return torch.tensor([[float(c) for c in v]], dtype=torch.float32,
                            device=device)

    return kcam.generate_transformation_matrix(
        row(x, y, z), row(0., look_at_height, 0.), row(0., 1., 0.))


def get_camera_projection(fovyangle_deg, device='cuda'):
    """(3, 1) projection vector from a vertical fov in degrees
    (``ian_utils.py:92``)."""
    return kcam.generate_perspective_projection(
        float(np.deg2rad(fovyangle_deg)), device=device)


def recenter_vertices(vertices, vertice_shift):
    """Recenters vertices around their mean plus a learnable shift
    (``ian_utils.py:52``)."""
    vertices_min = vertices.amin(dim=1, keepdim=True)
    vertices_max = vertices.amax(dim=1, keepdim=True)
    vertices_mid = (vertices_min + vertices_max) / 2
    return vertices - vertices_mid + vertice_shift


def load_synthetic_views(root_dir, indices=None, device='cuda'):
    """Loads rendered views (rgb + semantic mask + camera) produced in the
    Omniverse Data Generator layout (``ian_utils.py:182-229``).

    Returns:
        list of dicts with 'rgb' (H, W, 3), 'semantic' mask (H, W),
        'metadata' (cam_transform, cam_proj), tensors on ``device``.
    """
    device = check_device(device)
    if indices is None:
        metas = sorted(glob.glob(os.path.join(root_dir, '*_metadata.json')))
        indices = [int(os.path.basename(m).split('_')[0]) for m in metas]
    return [kio.render.import_synthetic_view(root_dir, idx, rgb=True,
                                             semantic=True, device=device)
            for idx in indices]
