"""How to construct pinhole / ortho cameras with ``Camera.from_args``.

Mirrors reference recipe ``examples/recipes/camera/camera_init_simple.py``.
``from_args`` inspects the kwarg set and dispatches to the matching
``from_*`` constructors of the extrinsics and intrinsics classes.
"""

import argparse
import math

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    perspective_camera_1 = Camera.from_args(
        eye=torch.tensor([4.0, 4.0, 4.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        fov=30 * math.pi / 180,   # radians
        width=800, height=800,
        near=1e-2, far=1e2,
        dtype=torch.float64, device=device,
    )
    print('--- Perspective Camera 1 ---')
    print(perspective_camera_1)

    # From an explicit 4x4 world-to-camera view matrix + focal length
    perspective_camera_2 = Camera.from_args(
        view_matrix=torch.eye(4)[None],
        focal_x=1000.,
        width=1600, height=1600, device=device,
    )
    print('--- Perspective Camera 2 ---')
    print(perspective_camera_2)

    # Orthographic: fov_distance selects the ortho frustum scale
    ortho_camera = Camera.from_args(
        eye=torch.tensor([4.0, 4.0, 4.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        width=800, height=800,
        fov_distance=1.0, device=device,
    )
    print('--- Orthographic Camera ---')
    print(ortho_camera)


if __name__ == '__main__':
    main()
