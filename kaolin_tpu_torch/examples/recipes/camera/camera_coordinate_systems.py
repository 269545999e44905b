"""Changing the world coordinate system of a camera.

Mirrors reference ``examples/recipes/camera/camera_coordinate_systems.py``.
``change_coordinate_system`` rebases the world axes (e.g. to Blender's
z-up convention); methods return new cameras.
"""

import argparse
import math

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera, blender_coords


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    camera = Camera.from_args(
        eye=torch.tensor([4.0, 4.0, 4.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        fov=30 * math.pi / 180,
        width=800, height=800, device=device,
    )

    print('view matrix (default y-up world):')
    print(camera.view_matrix()[0])

    blender_cam = Camera(camera.extrinsics.change_coordinate_system(
        blender_coords(device=device)), camera.intrinsics)
    print('view matrix (blender z-up world):')
    print(blender_cam.view_matrix()[0])

    restored = Camera(blender_cam.extrinsics.reset_coordinate_system(),
                      blender_cam.intrinsics)
    print('restored matches original:',
          bool(torch.allclose(restored.view_matrix(), camera.view_matrix(),
                              atol=1e-5)))


if __name__ == '__main__':
    main()
