"""Feeding the camera's view-projection matrix to an OpenGL-style shader.

Mirrors reference ``examples/recipes/camera/camera_opengl_shaders.py``.
Like the reference, this recipe is a minimal integration sketch: if
glumpy is not installed a dummy program object stands in, and the recipe
just shows the matrix handoff.
"""

import argparse
import math

import numpy as np
import torch

from kaolin_tpu_torch.examples.utils import check_device
from kaolin_tpu_torch.render.camera import Camera

try:
    from glumpy import gloo
except ImportError:
    class _DummyGloo:
        def Program(self, vertex, fragment):
            return dict()
    gloo = _DummyGloo()

VERTEX = """
uniform mat4 u_viewprojection;
attribute vec3 position;
void main() { gl_Position = u_viewprojection * vec4(position, 1.0); }
"""
FRAGMENT = """
void main() { gl_FragColor = vec4(1.0, 1.0, 1.0, 1.0); }
"""


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

    program = gloo.Program(VERTEX, FRAGMENT)

    # GL expects column-major float32: the matrix goes through the host
    vp = np.asarray(camera.view_projection_matrix()[0].cpu(), np.float32).T
    program['u_viewprojection'] = vp
    print('uploaded view-projection matrix:')
    print(vp)


if __name__ == '__main__':
    main()
