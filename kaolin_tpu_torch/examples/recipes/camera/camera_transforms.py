"""Applying camera transforms directly to vectors.

Mirrors reference ``examples/recipes/camera/camera_transforms.py``.
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

    camera = Camera.from_args(
        eye=torch.tensor([4.0, 4.0, 4.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        fov=30 * math.pi / 180,
        width=800, height=800, device=device,
    )

    print('view-projection matrix (world -> NDC):')
    print(camera.view_projection_matrix()[0])

    print('view matrix (world -> camera):')
    print(camera.view_matrix()[0])

    print('projection matrix (camera -> NDC):')
    print(camera.intrinsics.projection_matrix()[0])

    # Transform a batch of world points end to end
    points = torch.tensor([[0.0, 0.0, 0.0],
                           [1.0, 1.0, 1.0],
                           [-0.5, 0.2, 3.0]], device=device)
    cam_space = camera.extrinsics.transform(points)
    ndc = camera.transform(points)     # extrinsics then intrinsics
    print('camera-space points:')
    print(cam_space)
    print('NDC points:')
    print(ndc)

    # normalize_depth maps camera-space depth to [0, 1]
    print('normalized depths:',
          camera.intrinsics.normalize_depth(cam_space[..., 2]))


if __name__ == '__main__':
    main()
