"""Inspecting camera properties.

Mirrors reference ``examples/recipes/camera/camera_properties.py``.
"""

import argparse
import math

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera, CameraFOV


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

    print('width / height:', camera.width, camera.height)
    print('lens type:', camera.intrinsics.lens_type)
    print('near / far:', camera.intrinsics.near, camera.intrinsics.far)
    print('batch size:', len(camera))
    print('dtype:', camera.dtype)

    # Pinhole-specific parameters
    print('focal_x:', camera.focal_x)
    print('x0, y0 (principal point offset):', camera.x0, camera.y0)
    print('fov (vertical, degrees):',
          camera.intrinsics.fov(CameraFOV.VERTICAL))
    print('fov (horizontal, degrees):',
          camera.intrinsics.fov(CameraFOV.HORIZONTAL))
    print('tan(fov/2):', camera.intrinsics.tan_half_fov())

    # Extrinsics-derived vectors
    print('camera position:', camera.cam_pos().ravel())
    print('camera forward axis:', camera.cam_forward().ravel())
    print('camera up axis:', camera.cam_up().ravel())
    print('camera right axis:', camera.cam_right().ravel())

    # Raw parameter buffers (flat, differentiable)
    print('extrinsics params shape:', camera.extrinsics.parameters().shape)
    print('intrinsics params shape:', camera.intrinsics.parameters().shape)


if __name__ == '__main__':
    main()
