"""Camera intrinsics base: shared lens-parameter management.

Port of ``kaolin_tpu/render/camera/intrinsics.py``. Functional, as the
extrinsics (see :mod:`.extrinsics`): a ``params`` tensor (C, P) and
static image and clip settings; changes return a new instance.
"""

import enum

import numpy as np
import torch

__all__ = ['CameraIntrinsics', 'CameraFOV', 'up_to_homogeneous',
           'down_from_homogeneous']


class CameraFOV(enum.Enum):
    """Camera field-of-view direction."""
    HORIZONTAL = 0
    VERTICAL = 1
    DIAGONAL = 2


def up_to_homogeneous(vectors):
    """Appends w=1 if the last dim is 3."""
    if vectors.shape[-1] == 4:
        return vectors
    return torch.cat([vectors, torch.ones_like(vectors[..., :1])], dim=-1)


def down_from_homogeneous(vectors):
    """Perspective division by the homogeneous coordinate."""
    return vectors[..., :-1] / vectors[..., -1:]


class CameraIntrinsics:
    """Base class for camera lenses (pinhole / orthographic).

    Subclasses hold a per-camera params tensor whose columns are
    ``PARAM_NAMES``.
    """

    PARAM_NAMES = ()          # subclass: ordered names of params columns

    def __init__(self, width, height, params, near=1e-2, far=1e2,
                 ndc_min=-1., ndc_max=1.):
        self.width = int(width)
        self.height = int(height)
        self.params = params
        self.near = float(near)
        self.far = float(far)
        self.ndc_min = float(ndc_min)
        self.ndc_max = float(ndc_max)

    def _replace_params(self, params):
        return type(self)(self.width, self.height, params, near=self.near,
                          far=self.far, ndc_min=self.ndc_min,
                          ndc_max=self.ndc_max)

    def __len__(self):
        return self.params.shape[0]

    @property
    def dtype(self):
        return self.params.dtype

    @property
    def device(self):
        return self.params.device

    def parameters(self):
        """The ``params`` tensor itself (not an iterator)."""
        return self.params

    def _get(self, name):
        return self.params[:, self.PARAM_NAMES.index(name)]

    def _set(self, name, val):
        params = self.params.clone()
        params[:, self.PARAM_NAMES.index(name)] = val
        return self._replace_params(params)

    def normalize_depth(self, depth):
        """Normalizes NDC depth values to [0, 1]. The clip is
        ``jnp.clip(depth, ndc_min, ndc_max)``: its values, and half the
        gradient at a tie."""
        ndc_depth = torch.minimum(
            torch.maximum(depth, depth.new_full((), self.ndc_min)),
            depth.new_full((), self.ndc_max))
        if self.ndc_min == -1 and self.ndc_max == 1:
            return (ndc_depth + 1.) / 2.
        elif self.ndc_min == 1 and self.ndc_max == 0:
            return 1. - ndc_depth
        return ndc_depth

    def gradient_mask(self, *args):
        """Bool mask over params, on their device, for the named lens
        parameters."""
        want = set(args) if args else set(self.PARAM_NAMES)
        mask = np.array([n in want for n in self.PARAM_NAMES])
        return torch.as_tensor(mask, device=self.device).expand(
            self.params.shape)

    @classmethod
    def cat(cls, intrinsics_list):
        first = intrinsics_list[0]
        return first._replace_params(
            torch.cat([i.params for i in intrinsics_list]))

    def __getitem__(self, idx):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return self._replace_params(self.params[idx])

    def allclose(self, other, rtol=1e-5, atol=1e-8):
        return (type(self) is type(other)
                and (self.width, self.height) == (other.width, other.height)
                and bool(torch.allclose(self.params, other.params,
                                        rtol=rtol, atol=atol)))

    # --- interface -------------------------------------------------------
    def projection_matrix(self):
        raise NotImplementedError

    def transform(self, vectors):
        raise NotImplementedError

    def zoom(self, amount):
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}(num_cameras={len(self)}, "
                f"width={self.width}, height={self.height})")
