"""Optimizing camera parameters with gradients.

Mirrors reference ``examples/recipes/camera/cameras_differentiable.py``.
Differentiate through the raw parameter buffer with ``torch.autograd``
and use ``gradient_mask`` to freeze parameter groups (here only the
translation ``t`` of the extrinsics is optimized).
"""

import argparse
import math

import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera, CameraExtrinsics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda')
    device = check_device(ap.parse_args(argv).device)

    cam = Camera.from_args(
        eye=torch.tensor([4.0, 4.0, 4.0]),
        at=torch.tensor([0.0, 0.0, 0.0]),
        up=torch.tensor([0.0, 1.0, 0.0]),
        fov=30 * math.pi / 180,
        width=800, height=800, device=device,
    )

    # Target: a shifted camera observing the same landmarks
    target_ext = cam.extrinsics.translate(
        torch.tensor([0.5, -0.3, 0.2], device=device))
    landmarks = torch.tensor([[0., 0., 0.], [1., 0., 0.],
                              [0., 1., 0.], [0., 0., 1.]], device=device)
    goal = target_ext.transform(landmarks)

    # Only translation is trainable; rotation entries stay frozen
    mask = cam.extrinsics.gradient_mask('t')
    backend = cam.extrinsics.backend

    def loss(params):
        ext = CameraExtrinsics(params, backend=backend)
        return torch.mean((ext.transform(landmarks) - goal) ** 2)

    params = cam.extrinsics.params.detach().clone()
    for step in range(200):
        params.requires_grad_(True)
        g, = torch.autograd.grad(loss(params), params)
        params = (params - 0.5 * g * mask).detach()
        if step % 50 == 0:
            with torch.no_grad():
                print(f'step {step:3d}  loss {float(loss(params)):.6f}')

    final = CameraExtrinsics(params, backend=backend)
    print('optimized camera position:', final.cam_pos().ravel())
    print('target    camera position:', target_ext.cam_pos().ravel())


if __name__ == '__main__':
    main()
