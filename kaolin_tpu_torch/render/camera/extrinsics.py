"""Batched differentiable camera extrinsics (SE(3) pose).

Port of ``kaolin_tpu/render/camera/extrinsics.py``. As there, the class is
functional: it holds a ``params`` tensor (C, P), which may require grad,
and "mutating" operations return a NEW instance. Two parameter backends:

- ``matrix_se3``: the raw flattened 4x4 view matrix (16 params per camera);
- ``matrix_6dof_rotation``: the first two rows of the rotation (one
  Gram-Schmidt step rebuilds it) + 3 translation params, so gradients stay
  in the space of rigid transformations.

The view matrix is column-major world-to-camera ``[[R | t], [0 | 1]]``
with the camera looking down -z (OpenGL). Constructors take ``device=``,
``'cuda'`` by default.
"""

import numpy as np
import torch

from ...tracing import span

__all__ = ['CameraExtrinsics', 'register_backend']

_BACKENDS = ('matrix_se3', 'matrix_6dof_rotation')
_BACKEND_REGISTRY = {}


def register_backend(name, params_from_mat=None, mat_from_params=None):
    """Registers a custom extrinsics parameter representation.

    Either pass the two conversion functions directly,
    ``params_from_mat(mat (C,4,4)) -> (C,P)`` and
    ``mat_from_params(params (C,P)) -> (C,4,4)`` (both differentiable), or
    use it as a class decorator over a class exposing them as
    staticmethods.
    """
    if params_from_mat is not None or mat_from_params is not None:
        if params_from_mat is None or mat_from_params is None:
            raise ValueError(
                'register_backend needs BOTH params_from_mat and '
                'mat_from_params (or neither, for decorator use)')
        _BACKEND_REGISTRY[name] = (params_from_mat, mat_from_params)
        return None

    def deco(cls):
        _BACKEND_REGISTRY[name] = (cls.params_from_mat,
                                   cls.mat_from_params)
        return cls
    return deco


def _as_tensor(x, dtype, device):
    """``x`` as a tensor of ``dtype`` on ``device``; a tensor keeps its
    autograd graph."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _normalize(v, dim=-1):
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True),
                           min=1e-12)


def _params_from_mat(mat, backend):
    if backend in _BACKEND_REGISTRY:
        return _BACKEND_REGISTRY[backend][0](mat)
    if backend == 'matrix_se3':
        return mat.reshape(-1, 16)
    # 6 DoF: first two ROWS of R (already orthonormal) + translation
    R = mat[:, :3, :3]
    t = mat[:, :3, 3]
    return torch.cat([R[:, 0, :], R[:, 1, :], t], dim=-1)


def _mat_from_params(params, backend):
    if backend in _BACKEND_REGISTRY:
        return _BACKEND_REGISTRY[backend][1](params)
    if backend == 'matrix_se3':
        return params.reshape(-1, 4, 4)
    # Gram-Schmidt
    a1 = params[:, 0:3]
    a2 = params[:, 3:6]
    t = params[:, 6:9]
    b1 = _normalize(a1)
    b1_dot_a2 = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _normalize(a2 - b1_dot_a2 * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    R = torch.stack([b1, b2, b3], dim=1)
    return _compose_mat(R, t[..., None])


def _compose_mat(R, t):
    C = R.shape[0]
    top = torch.cat([R, t], dim=-1)
    bottom = R.new_zeros((1, 1, 4))
    bottom[..., 3] = 1.
    return torch.cat([top, bottom.expand(C, 1, 4)], dim=1)


class CameraExtrinsics:
    """Batched rigid world-to-camera transforms.

    Construct with :meth:`from_lookat`, :meth:`from_camera_pose` or
    :meth:`from_view_matrix`, or from ``params`` and a backend name.
    """

    def __init__(self, params, backend='matrix_se3',
                 base_change_matrix=None):
        if backend not in _BACKENDS and backend not in _BACKEND_REGISTRY:
            raise ValueError(f'unknown extrinsics backend {backend!r}')
        self.params = params
        self.backend = backend
        self._base_change_matrix = base_change_matrix

    # --- constructors ----------------------------------------------------
    @classmethod
    def _from_mat(cls, mat, backend):
        backend = backend or 'matrix_se3'
        return cls(_params_from_mat(mat, backend), backend=backend)

    @classmethod
    def from_view_matrix(cls, view_matrix, dtype=torch.float32, backend=None,
                         device='cuda'):
        """From a column-major world-to-camera (view) matrix (C, 4, 4)."""
        mat = _as_tensor(view_matrix, dtype, device).reshape(-1, 4, 4)
        return cls._from_mat(mat, backend)

    @classmethod
    def from_camera_pose(cls, cam_pos, cam_dir, dtype=torch.float32,
                         backend=None, device='cuda'):
        """From camera position (C, 3) and orientation (C, 3, 3) in world
        coordinates."""
        cam_pos = torch.atleast_2d(_as_tensor(cam_pos, dtype,
                                              device).squeeze())
        cam_dir = _as_tensor(cam_dir, dtype, device)
        if cam_dir.ndim == 2:
            cam_dir = cam_dir[None]
        R = cam_dir.transpose(-1, -2)
        t = -R @ cam_pos[..., None]
        return cls._from_mat(_compose_mat(R, t), backend)

    @classmethod
    def from_lookat(cls, eye, at, up, dtype=None, backend=None,
                    device='cuda'):
        """glm-compatible lookat constructor (right-handed, -z forward).

        ``dtype`` defaults to the dtype of ``eye`` (float32 for non-float
        inputs).
        """
        if dtype is None:
            eye_dt = eye.dtype if isinstance(eye, torch.Tensor) else \
                torch.as_tensor(np.asarray(eye)).dtype
            dtype = eye_dt if eye_dt.is_floating_point else torch.float32
        eye, at, up = (torch.atleast_2d(_as_tensor(a, dtype,
                                                   device).squeeze())
                       for a in (eye, at, up))
        backward = _normalize(at - eye)
        right = _normalize(torch.linalg.cross(backward, up, dim=-1))
        up = torch.linalg.cross(right, backward, dim=-1)
        R = torch.stack([right, up, -backward], dim=1)
        t = -R @ eye[..., None]
        return cls._from_mat(_compose_mat(R, t), backend)

    # --- core accessors --------------------------------------------------
    def view_matrix(self):
        """(C, 4, 4) world-to-camera matrix."""
        return _mat_from_params(self.params, self.backend)

    def inv_view_matrix(self):
        """(C, 4, 4) camera-to-world matrix."""
        Rt = self.R.transpose(-1, -2)
        return _compose_mat(Rt, -Rt @ self.t)

    @property
    def R(self):
        return self.view_matrix()[:, :3, :3]

    @property
    def t(self):
        return self.view_matrix()[:, :3, 3:4]

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

    # --- transforms ------------------------------------------------------
    def transform(self, vectors):
        """World -> camera coordinates; (N, 3) or (C, N, 3) -> (C, N, 3)."""
        with span('kaolin.CameraExtrinsics.transform'):
            if vectors.ndim == 2:
                vectors = vectors[None]
            # products and sums, not a matmul: with an inner size of 3,
            # PyTorch's gemm on the card keeps few blocks busy
            mat = self.view_matrix()
            return (torch.sum(mat[:, None, :3, :3] * vectors[..., None, :],
                              -1) + mat[:, None, :3, 3])

    def inv_transform_rays(self, ray_orig, ray_dir):
        """Camera -> world rays."""
        if ray_orig.ndim == 2:
            ray_orig = ray_orig[None]
        if ray_dir.ndim == 2:
            ray_dir = ray_dir[None]
        Rt = self.R.transpose(-1, -2)[:, None]
        t = self.t[:, None]
        orig = (Rt @ (ray_orig[..., None] - t))[..., 0]
        dirs = (Rt @ ray_dir[..., None])[..., 0]
        return orig, dirs

    # --- camera frame ----------------------------------------------------
    def cam_pos(self):
        return -self.R.transpose(-1, -2) @ self.t

    def cam_right(self):
        return self.R.transpose(-1, -2)[..., :, 0:1]

    def cam_up(self):
        return self.R.transpose(-1, -2)[..., :, 1:2]

    def cam_forward(self):
        return self.R.transpose(-1, -2)[..., :, 2:3]

    # --- functional "mutations" -----------------------------------------
    def _update_mat(self, mat):
        return CameraExtrinsics(_params_from_mat(mat, self.backend),
                                backend=self.backend,
                                base_change_matrix=self._base_change_matrix)

    def translate(self, t):
        """Translates the camera in world space. Returns a new
        CameraExtrinsics."""
        t = _as_tensor(t, self.dtype, self.device)
        if t.shape[-1] != 1:
            t = t[..., None]
        mat = self.view_matrix()
        new_t = mat[:, :3, 3:4] - mat[:, :3, :3] @ t
        return self._update_mat(_compose_mat(mat[:, :3, :3], new_t))

    def rotate(self, yaw=None, pitch=None, roll=None):
        """Rotates in camera space (Tait-Bryan). Returns a new
        CameraExtrinsics."""
        C, dtype, device = len(self), self.dtype, self.device

        def eye():
            return torch.eye(4, dtype=dtype, device=device).repeat(C, 1, 1)

        def rmat(entries):
            m = eye()
            for (i, j), v in entries.items():
                m[:, i, j] = v
            return m

        rot = eye()
        if yaw is not None:
            yaw = _as_tensor(yaw, dtype, device)
            rot = rmat({(0, 0): torch.cos(yaw), (0, 2): -torch.sin(yaw),
                        (2, 0): torch.sin(yaw), (2, 2): torch.cos(yaw)}) @ rot
        if pitch is not None:
            pitch = _as_tensor(pitch, dtype, device)
            rot = rmat({(1, 1): torch.cos(pitch), (1, 2): torch.sin(pitch),
                        (2, 1): -torch.sin(pitch),
                        (2, 2): torch.cos(pitch)}) @ rot
        if roll is not None:
            roll = _as_tensor(roll, dtype, device)
            rot = rmat({(0, 0): torch.cos(roll), (0, 1): -torch.sin(roll),
                        (1, 0): torch.sin(roll),
                        (1, 1): torch.cos(roll)}) @ rot
        return self._update_mat(rot @ self.view_matrix())

    def _move_axis(self, axis, amount):
        mat = self.view_matrix()
        delta = torch.zeros((len(self), 3, 1), dtype=self.dtype,
                            device=self.device)
        delta[:, axis, 0] = _as_tensor(amount, self.dtype, self.device)
        return self._update_mat(
            _compose_mat(mat[:, :3, :3], mat[:, :3, 3:4] - delta))

    def move_right(self, amount):
        return self._move_axis(0, amount)

    def move_up(self, amount):
        return self._move_axis(1, amount)

    def move_forward(self, amount):
        return self._move_axis(2, amount)

    def change_coordinate_system(self, basis_change):
        """Rebases world coordinates: ``R <- R @ basis_change.T``. Returns
        a new CameraExtrinsics."""
        basis_change = _as_tensor(basis_change, self.dtype, self.device)
        prev = self._base_change_matrix
        acc = basis_change if prev is None else prev @ basis_change
        mat = self.view_matrix()
        R = mat[:, :3, :3] @ basis_change.T[None]
        return CameraExtrinsics(
            _params_from_mat(_compose_mat(R, mat[:, :3, 3:4]), self.backend),
            backend=self.backend, base_change_matrix=acc)

    def reset_coordinate_system(self):
        """Reverts accumulated coordinate-system changes."""
        if self._base_change_matrix is None:
            return self
        mat = self.view_matrix()
        R = mat[:, :3, :3] @ self._base_change_matrix[None]
        return CameraExtrinsics(
            _params_from_mat(_compose_mat(R, mat[:, :3, 3:4]), self.backend),
            backend=self.backend, base_change_matrix=None)

    def switch_backend(self, backend_name):
        """Re-parameterizes into another backend."""
        return CameraExtrinsics._from_mat(self.view_matrix(), backend_name)

    def gradient_mask(self, *args):
        """Bool mask over ``params``, on their device, for the requested
        components ('R' and/or 't')."""
        want = set(args) if args else {'R', 't'}
        K = self.params.shape[-1]
        mask = np.zeros(K, dtype=bool)
        if self.backend == 'matrix_se3':
            if 'R' in want:
                mask[[0, 1, 2, 4, 5, 6, 8, 9, 10]] = True
            if 't' in want:
                mask[[3, 7, 11]] = True
        else:
            if 'R' in want:
                mask[0:6] = True
            if 't' in want:
                mask[6:9] = True
        return torch.as_tensor(mask, device=self.device).expand(
            self.params.shape)

    @classmethod
    def cat(cls, extrinsics_list):
        """Concatenates batched extrinsics (same backend)."""
        backend = extrinsics_list[0].backend
        if any(e.backend != backend for e in extrinsics_list):
            raise ValueError('CameraExtrinsics.cat: backends differ')
        return cls(torch.cat([e.params for e in extrinsics_list]),
                   backend=backend)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return CameraExtrinsics(self.params[idx], backend=self.backend,
                                base_change_matrix=self._base_change_matrix)

    def allclose(self, other, rtol=1e-5, atol=1e-8):
        return (self.backend == other.backend
                and bool(torch.allclose(self.params, other.params,
                                        rtol=rtol, atol=atol)))

    def __repr__(self):
        return (f"CameraExtrinsics(num_cameras={len(self)}, "
                f"backend={self.backend!r})")
