"""Unified Camera: extrinsics + intrinsics with smart construction.

Port of ``kaolin_tpu/render/camera/camera.py``. ``from_args`` dispatches
on the given keyword set against the ``from_*`` constructors of the
extrinsics and intrinsics classes (found by introspection); unknown
attributes forward to the extrinsics or intrinsics.
"""

import inspect

import torch

from .extrinsics import CameraExtrinsics
from .intrinsics_pinhole import PinholeIntrinsics
from .intrinsics_ortho import OrthographicIntrinsics

__all__ = ['Camera']

_EXTRINSICS_MODULES = [CameraExtrinsics]
_INTRINSICS_MODULES = [PinholeIntrinsics, OrthographicIntrinsics]


def _gather_constructors(*cam_modules):
    ctors = []
    for m in cam_modules:
        ctors.extend(f for name, f in inspect.getmembers(m)
                     if inspect.ismethod(f) and name.startswith('from_'))
    table = {}
    for func in ctors:
        spec = inspect.getfullargspec(func)
        args = [a for a in spec.args if a != 'cls']
        n_def = len(spec.defaults or ())
        mandatory = args[:len(args) - n_def]
        table[frozenset(mandatory)] = (func, args)
    return table


class Camera:
    """A batched camera = extrinsics (pose) + intrinsics (lens)."""

    _extrinsics_constructors = _gather_constructors(*_EXTRINSICS_MODULES)
    _intrinsics_constructors = _gather_constructors(*_INTRINSICS_MODULES)

    def __init__(self, extrinsics, intrinsics):
        if len(extrinsics) != len(intrinsics):
            raise ValueError('extrinsics and intrinsics batch sizes must '
                             'match')
        self.extrinsics = extrinsics
        self.intrinsics = intrinsics

    @classmethod
    def from_args(cls, **kwargs):
        """Smart constructor: picks the extrinsics and intrinsics
        ``from_*`` constructors whose mandatory args are covered by the
        given kwargs. Common arg sets:

        - eye, at, up + width, height + (fov | focal_x): lookat pinhole.
        - view_matrix + width, height + fov_distance: ortho from matrix.

        ``dtype`` and ``device`` go to both.
        """
        keys = set(kwargs.keys())
        shared = {'dtype', 'device'}

        def find(table):
            best = None
            for key, (func, args) in table.items():
                if key <= keys:
                    if best is None or len(key) > len(best[0]):
                        best = (key, func, args)
            return best

        ext = find(cls._extrinsics_constructors)
        intr = find(cls._intrinsics_constructors)
        if ext is None or intr is None:
            raise ValueError(f"could not resolve camera constructors from "
                             f"args {sorted(keys)}")
        _, ext_f, ext_args = ext
        _, intr_f, intr_args = intr
        ext_kwargs = {k: v for k, v in kwargs.items()
                      if k in ext_args or k in shared}
        intr_kwargs = {k: v for k, v in kwargs.items() if k in intr_args}
        extrinsics = ext_f(**ext_kwargs)
        if 'num_cameras' not in intr_kwargs:
            intr_kwargs['num_cameras'] = len(extrinsics)
        intrinsics = intr_f(**intr_kwargs)
        return cls(extrinsics, intrinsics)

    # --- forwarding ------------------------------------------------------
    def __getattr__(self, name):
        # only called when normal lookup fails
        ext = object.__getattribute__(self, 'extrinsics')
        if hasattr(ext, name):
            return getattr(ext, name)
        intr = object.__getattribute__(self, 'intrinsics')
        if hasattr(intr, name):
            return getattr(intr, name)
        raise AttributeError(name)

    def __len__(self):
        return len(self.extrinsics)

    @property
    def width(self):
        return self.intrinsics.width

    @property
    def height(self):
        return self.intrinsics.height

    @property
    def dtype(self):
        return self.extrinsics.dtype

    @property
    def device(self):
        return self.extrinsics.device

    # --- core ------------------------------------------------------------
    def view_projection_matrix(self):
        """(C, 4, 4) world-to-NDC matrix."""
        return self.intrinsics.projection_matrix() \
            @ self.extrinsics.view_matrix()

    def transform(self, vectors):
        """World -> NDC: extrinsics then intrinsics."""
        return self.intrinsics.transform(self.extrinsics.transform(vectors))

    def inv_transform_rays(self, ray_orig, ray_dir):
        return self.extrinsics.inv_transform_rays(ray_orig, ray_dir)

    def gradient_mask(self, *args):
        """(ext_mask, intr_mask) for parameter-group optimization."""
        if not args:
            return (self.extrinsics.gradient_mask(),
                    self.intrinsics.gradient_mask())
        ext_args = [a for a in args if a in ('R', 't')]
        intr_args = [a for a in args
                     if a in self.intrinsics.PARAM_NAMES]
        return (self.extrinsics.gradient_mask(*ext_args) if ext_args else
                torch.zeros_like(self.extrinsics.gradient_mask()),
                self.intrinsics.gradient_mask(*intr_args) if intr_args else
                torch.zeros_like(self.intrinsics.gradient_mask()))

    @classmethod
    def cat(cls, cameras):
        """Concatenates camera batches."""
        return cls(CameraExtrinsics.cat([c.extrinsics for c in cameras]),
                   type(cameras[0].intrinsics).cat(
                       [c.intrinsics for c in cameras]))

    def __getitem__(self, idx):
        return Camera(self.extrinsics[idx], self.intrinsics[idx])

    def allclose(self, other, rtol=1e-5, atol=1e-8):
        return (self.extrinsics.allclose(other.extrinsics, rtol, atol)
                and self.intrinsics.allclose(other.intrinsics, rtol, atol))

    def __repr__(self):
        return (f"Camera(num_cameras={len(self)}, "
                f"extrinsics={self.extrinsics!r}, "
                f"intrinsics={self.intrinsics!r})")
