"""Pinhole (perspective) camera intrinsics.

Port of ``kaolin_tpu/render/camera/intrinsics_pinhole.py``. Params per
camera: (x0, y0, focal_x, focal_y), principal-point offsets relative to
the canvas center and focal lengths in pixels. NDC depth ranges [-1, 1],
[0, 1] and reversed-z [1, 0], with the JAX package's sign for [0, 1]
(``V = far / (near - far)``, which maps near to 0 and far to 1).
"""

import math

import torch

from .intrinsics import (CameraIntrinsics, CameraFOV, up_to_homogeneous,
                         down_from_homogeneous)

__all__ = ['PinholeIntrinsics', 'CameraFOV']


class PinholeIntrinsics(CameraIntrinsics):

    PARAM_NAMES = ('x0', 'y0', 'focal_x', 'focal_y')

    # --- constructors ----------------------------------------------------
    @classmethod
    def from_focal(cls, width, height, focal_x, focal_y=None, x0=0., y0=0.,
                   near=1e-2, far=1e2, num_cameras=1, dtype=torch.float32,
                   ndc_min=-1., ndc_max=1., device='cuda'):
        """From focal length in pixels."""
        if focal_y is None:
            focal_y = focal_x
        params = torch.stack([torch.as_tensor(v, dtype=dtype, device=device)
                              for v in (x0, y0, focal_x, focal_y)])
        return cls(width, height, params.repeat(num_cameras, 1), near=near,
                   far=far, ndc_min=ndc_min, ndc_max=ndc_max)

    @classmethod
    def from_fov(cls, width, height, fov, fov_direction=CameraFOV.VERTICAL,
                 x0=0., y0=0., near=1e-2, far=1e2, num_cameras=1,
                 dtype=torch.float32, ndc_min=-1., ndc_max=1., device='cuda'):
        """From a field-of-view angle in radians. ``ndc_min``/``ndc_max``
        select the NDC depth convention ([-1,1], [0,1], or reversed-z
        [1,0])."""
        if fov_direction not in (CameraFOV.HORIZONTAL, CameraFOV.VERTICAL):
            raise ValueError(f'unsupported fov direction {fov_direction}')
        tanHalfAngle = math.tan(fov / 2.)
        aspectScale = width / 2.0 \
            if fov_direction is CameraFOV.HORIZONTAL else height / 2.0
        focal = aspectScale / tanHalfAngle
        return cls.from_focal(width, height, focal, focal, x0, y0, near,
                              far, num_cameras, dtype, ndc_min=ndc_min,
                              ndc_max=ndc_max, device=device)

    # --- parameters ------------------------------------------------------
    @property
    def x0(self):
        return self._get('x0')

    @property
    def y0(self):
        return self._get('y0')

    @property
    def focal_x(self):
        return self._get('focal_x')

    @property
    def focal_y(self):
        return self._get('focal_y')

    def tan_half_fov(self, camera_fov_direction=CameraFOV.VERTICAL):
        if camera_fov_direction is CameraFOV.HORIZONTAL:
            return self.width / (2. * self.focal_x)
        elif camera_fov_direction is CameraFOV.VERTICAL:
            return self.height / (2. * self.focal_y)
        raise ValueError(f'Unsupported CameraFOV direction: '
                         f'{camera_fov_direction}')

    def fov(self, camera_fov_direction=CameraFOV.VERTICAL, in_degrees=True):
        out = 2. * torch.arctan(self.tan_half_fov(camera_fov_direction))
        return torch.rad2deg(out) if in_degrees else out

    @property
    def fov_x(self):
        return self.fov(CameraFOV.HORIZONTAL)

    @property
    def fov_y(self):
        return self.fov(CameraFOV.VERTICAL)

    def zoom(self, amount):
        """Narrows the fov by ``amount`` degrees. Returns a new instance."""
        new_fov = torch.deg2rad(self.fov_y - amount)
        focal = (self.height / 2.) / torch.tan(new_fov / 2.)
        out = self._set('focal_x', focal * self.focal_x / self.focal_y)
        return out._set('focal_y', focal)

    # --- matrices --------------------------------------------------------
    def perspective_matrix(self):
        """(C, 4, 4) camera-to-clip perspective component."""
        zero = torch.zeros_like(self.focal_x)
        one = torch.ones_like(self.focal_x)
        rows = [
            torch.stack([self.focal_x, zero, -self.x0, zero], dim=-1),
            torch.stack([zero, self.focal_y, -self.y0, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1),
        ]
        return torch.stack(rows, dim=1)

    def ndc_matrix(self, left, right, bottom, top, near, far):
        """(1, 4, 4) clip-to-NDC matrix."""
        tx = -(right + left) / (right - left)
        ty = -(top + bottom) / (top - bottom)
        if self.ndc_min == -1 and self.ndc_max == 1:
            U = -2.0 * near * far / (far - near)
            V = -(far + near) / (far - near)
        elif self.ndc_min == 0 and self.ndc_max == 1:
            # solving 0 = -U/(-n) - V, 1 = -U/(-f) - V gives
            # V = far / (near - far), the JAX package's sign
            U = (near * far) / (near - far)
            V = far / (near - far)
        elif self.ndc_min == 1 and self.ndc_max == 0:
            U = (near * far) / (far - near)
            V = near / (far - near)
        else:
            raise NotImplementedError(
                'Perspective Projection does not support NDC range of '
                f'[{self.ndc_min}, {self.ndc_max}]')
        return torch.tensor([[
            [2.0 / (right - left), 0.0, 0.0, -tx],
            [0.0, 2.0 / (top - bottom), 0.0, -ty],
            [0.0, 0.0, U, V],
            [0.0, 0.0, 0.0, -1.0]]], dtype=self.dtype, device=self.device)

    def projection_matrix(self):
        """(C, 4, 4) OpenGL-compatible projection."""
        persp = self.perspective_matrix()
        top = self.height / 2
        right = self.width / 2
        ndc = self.ndc_matrix(-right, right, -top, top, self.near, self.far)
        return ndc @ persp

    def transform(self, vectors):
        """Projects (C?, N, 3) camera-space points to NDC (with
        perspective division)."""
        if vectors.ndim == 2:
            vectors = vectors[None]
        proj = self.projection_matrix()[:, None]
        v = up_to_homogeneous(vectors)[..., None]
        return down_from_homogeneous((proj @ v)[..., 0])

    @property
    def lens_type(self):
        return 'pinhole'
