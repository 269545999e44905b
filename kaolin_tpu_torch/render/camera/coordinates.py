"""Canonical world coordinate-system bases. Port of
``kaolin_tpu/render/camera/coordinates.py``."""

import torch

__all__ = ['blender_coords', 'opengl_coords']


def blender_coords(device='cuda'):
    """Blender: right-handed, z up. (3, 3) float32."""
    return torch.tensor([[1, 0, 0],
                         [0, 0, 1],
                         [0, -1, 0]], dtype=torch.float32, device=device)


def opengl_coords(device='cuda'):
    """OpenGL convention: right-handed, y up. (3, 3) float32."""
    return torch.tensor([[1, 0, 0],
                         [0, 1, 0],
                         [0, 0, 1]], dtype=torch.float32, device=device)
