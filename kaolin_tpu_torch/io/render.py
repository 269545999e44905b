"""Loader for synthetic views (Omniverse Kaolin App "Data Generator"
format: per-view rgb/depth/semantic files + camera metadata json).

Port of ``kaolin_tpu/io/render.py`` (reference
``kaolin/io/render.py:26-126``). PIL is imported only to read a PNG.
"""

import json
import math
import os

import numpy as np
import torch

from ..render.camera import generate_perspective_projection

__all__ = ['import_synthetic_view']


def import_synthetic_view(root_dir, idx, rgb=True, depth_linear=False,
                          semantic=False, instance=False, normals=False,
                          bbox_2d_tight=False, bbox_2d_loose=False,
                          device='cuda'):
    """Imports one synthetic view; see the reference docstring for the
    full output dictionary description.

    Returns:
        dict with the selected sensors (tensors on ``device``) plus
        'metadata' holding cam_transform (4, 3), cam_proj (3, 1),
        asset_transforms and clipping_range.
    """
    output = {}

    def _import_npy(cat):
        path = os.path.join(root_dir, f'{idx}_{cat}.npy')
        output[cat] = torch.as_tensor(np.load(path), device=device) \
            if os.path.exists(path) else None

    def _import_png(cat):
        path = os.path.join(root_dir, f'{idx}_{cat}.png')
        if os.path.exists(path):
            from PIL import Image
            output[cat] = torch.as_tensor(
                np.array(Image.open(path))[:, :, :3].astype(np.float32)
                / 255., device=device)
        else:
            output[cat] = None

    if rgb:
        _import_png('rgb')
    if depth_linear:
        _import_npy('depth_linear')
    if semantic:
        _import_npy('semantic')
    if instance:
        _import_npy('instance')
    if normals:
        _import_png('normals')

    with open(os.path.join(root_dir, f'{idx}_metadata.json'), 'r') as f:
        fmetadata = json.load(f)
    asset_transforms = torch.tensor(
        fmetadata['asset_transforms'][0][1], dtype=torch.float32,
        device=device)
    cam_transform = torch.tensor(
        fmetadata['camera_properties']['tf_mat'], dtype=torch.float32,
        device=device)
    aspect_ratio = (fmetadata['camera_properties']['resolution']['width']
                    / fmetadata['camera_properties']['resolution']['height'])
    focal_length = fmetadata['camera_properties']['focal_length']
    horizontal_aperture = \
        fmetadata['camera_properties']['horizontal_aperture']
    fov = 2 * math.atan(horizontal_aperture / (2 * focal_length))
    output['metadata'] = {
        'cam_transform': cam_transform[:, :3],
        'asset_transforms': asset_transforms,
        'cam_proj': generate_perspective_projection(fov, aspect_ratio,
                                                    device=device),
        'clipping_range': fmetadata['camera_properties']['clipping_range'],
    }
    if bbox_2d_tight:
        output['bbox_2d_tight'] = fmetadata['bbox_2d_tight']
    if bbox_2d_loose:
        output['bbox_2d_loose'] = fmetadata['bbox_2d_loose']
    return output
