"""Generating per-pixel rays from a camera, for ray-based renderers.

Mirrors reference ``examples/recipes/camera/camera_ray_tracing.py``:
build a pixel grid, lift to camera-space directions with the pinhole
intrinsics, then push to world space with ``inv_transform_rays``.
"""

import argparse
import math

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera, CameraFOV


def generate_pixel_grid(height, width, dtype=torch.float32, device='cuda'):
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing='ij')
    return ys + 0.5, xs + 0.5


def generate_perspective_rays(camera, pixel_grid):
    pixel_y, pixel_x = pixel_grid
    # pixel -> NDC in [-1, 1], y up
    ndc_x = 2.0 * pixel_x / camera.width - 1.0
    ndc_y = 1.0 - 2.0 * pixel_y / camera.height
    aspect = camera.width / camera.height
    tan_half = camera.intrinsics.tan_half_fov(CameraFOV.VERTICAL)
    dir_x = ndc_x * tan_half * aspect
    dir_y = ndc_y * tan_half
    dirs = torch.stack([dir_x, dir_y, -torch.ones_like(dir_x)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dirs = dirs.reshape(-1, 3)
    origins = torch.zeros_like(dirs)
    # camera space -> world space
    return camera.inv_transform_rays(origins[None], dirs[None])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    camera = Camera.from_args(
        eye=torch.tensor([4.0, 4.0, 4.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        fov=30 * math.pi / 180,
        width=16, height=16, device=device,
    )

    ray_orig, ray_dir = generate_perspective_rays(
        camera, generate_pixel_grid(camera.height, camera.width,
                                    device=device))
    print('ray origins shape:', ray_orig.shape)   # (1, H*W, 3)
    print('all origins at camera position:',
          bool(torch.allclose(ray_orig, camera.cam_pos().reshape(1, 1, 3),
                              atol=1e-5)))
    center = ray_dir[0, (16 // 2) * 16 + 16 // 2]
    to_origin = -camera.cam_pos().ravel()
    to_origin = to_origin / torch.linalg.norm(to_origin)
    print('center ray ~ view direction:',
          bool(torch.dot(center, to_origin) > 0.99))


if __name__ == '__main__':
    main()
