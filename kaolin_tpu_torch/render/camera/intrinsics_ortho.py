"""Orthographic camera intrinsics.

Port of ``kaolin_tpu/render/camera/intrinsics_ortho.py``. One parameter
per camera: ``fov_distance`` (view scale).
"""

import torch

from .intrinsics import CameraIntrinsics, up_to_homogeneous

__all__ = ['OrthographicIntrinsics']


class OrthographicIntrinsics(CameraIntrinsics):

    PARAM_NAMES = ('fov_distance',)

    @classmethod
    def from_frustum(cls, width, height, fov_distance=1.0, near=1e-2,
                     far=1e2, num_cameras=1, dtype=torch.float32,
                     device='cuda'):
        params = torch.full((num_cameras, 1), fov_distance, dtype=dtype,
                            device=device)
        return cls(width, height, params, near=near, far=far)

    @property
    def fov_distance(self):
        return self._get('fov_distance')

    def zoom(self, amount):
        """Scales fov_distance down (closer view); returns new instance."""
        return self._set('fov_distance',
                         torch.clamp(self.fov_distance - amount, min=1e-6))

    def orthographic_matrix(self, left, right, bottom, top, near, far):
        """(C, 4, 4) orthographic projection."""
        fov = self.fov_distance
        zero = torch.zeros_like(fov)
        one = torch.ones_like(fov)
        W = (right - left) / 2.
        H = (top - bottom) / 2.
        D = far - near
        tx = torch.full_like(fov, -(right + left) / (right - left))
        ty = torch.full_like(fov, -(top + bottom) / (top - bottom))
        tz = torch.full_like(fov, -(far + near) / (far - near))
        rows = [
            torch.stack([2.0 / (fov * W), zero, zero, tx], dim=-1),
            torch.stack([zero, 2.0 / (fov * H), zero, ty], dim=-1),
            torch.stack([zero, zero, -2.0 / D * one, tz], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ]
        return torch.stack(rows, dim=1)

    def projection_matrix(self):
        top = 1.0
        right = 1.0 * self.width / self.height
        return self.orthographic_matrix(-right, right, -top, top,
                                        self.near, self.far)

    def transform(self, vectors):
        if vectors.ndim == 2:
            vectors = vectors[None]
        proj = self.projection_matrix()[:, None]
        v = up_to_homogeneous(vectors)[..., None]
        return (proj @ v)[..., 0][..., :3]

    @property
    def lens_type(self):
        return 'ortho'
