"""Manipulating a camera: rigid moves (extrinsics) and zoom (intrinsics).

Mirrors reference ``examples/recipes/camera/camera_movement.py``. Unlike
the reference's mutating API, cameras here are immutable: every movement
method returns a NEW camera.
"""

import argparse

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    camera = Camera.from_args(
        eye=torch.tensor([0.0, 0.0, -1.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        width=800, height=600,
        fov=1.0, device=device,
    )

    # Extrinsic rigid transformations (each returns a new CameraExtrinsics)
    ext = camera.extrinsics
    ext = ext.move_forward(10.0)                  # along the camera z axis
    ext = ext.move_right(-5.0)
    ext = ext.move_up(5.0)
    ext = ext.rotate(yaw=0.1, pitch=0.02, roll=1.0)

    # Intrinsic lens transformation: zoom decreases the field of view for
    # pinhole lenses (orthographic lenses scale fov_distance instead)
    intr = camera.intrinsics.zoom(0.1)

    camera = Camera(ext, intr)
    print('camera position after movement:', camera.cam_pos().ravel())
    print('fov after zoom:', camera.intrinsics.fov())


if __name__ == '__main__':
    main()
