"""Building cameras from explicitly constructed extrinsics + intrinsics.

Mirrors reference ``examples/recipes/camera/camera_init_explicit.py``;
see ``camera_init_simple.py`` for the shorthand ``Camera.from_args``.
"""

import argparse
import math

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import (Camera, CameraExtrinsics,
                                            PinholeIntrinsics,
                                            OrthographicIntrinsics)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    #  Camera 1: from eye/at/up and focal length (perspective)
    eye = torch.tensor([0.0, 0.0, -1.0], device=device)
    at = torch.tensor([0.0, 0.0, 0.0], device=device)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    extrinsics = CameraExtrinsics.from_lookat(eye, at, up, device=device)
    intrinsics = PinholeIntrinsics.from_focal(width=800, height=600,
                                              focal_x=1.0, device=device)
    camera_1 = Camera(extrinsics=extrinsics, intrinsics=intrinsics)
    print('--- Camera 1 ---')
    print(camera_1)

    #  Camera 2: from a camera pose (position + view direction) and fov
    cam_pos = torch.tensor([1.0, 0.0, 0.0], device=device)
    cam_dir = torch.eye(3, device=device)
    extrinsics = CameraExtrinsics.from_camera_pose(cam_pos, cam_dir,
                                                   device=device)
    intrinsics = PinholeIntrinsics.from_fov(width=800, height=600,
                                            fov=math.pi / 4, device=device)
    camera_2 = Camera(extrinsics=extrinsics, intrinsics=intrinsics)
    print('--- Camera 2 ---')
    print(camera_2)

    #  Camera 3: from a 4x4 view matrix, orthographic lens
    view = torch.eye(4, device=device)[None]
    extrinsics = CameraExtrinsics.from_view_matrix(view, device=device)
    intrinsics = OrthographicIntrinsics.from_frustum(
        width=800, height=600, fov_distance=1.0, device=device)
    camera_3 = Camera(extrinsics=extrinsics, intrinsics=intrinsics)
    print('--- Camera 3 ---')
    print(camera_3)


if __name__ == '__main__':
    main()
