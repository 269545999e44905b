"""The Camera API of the PyTorch port against ``kaolin_tpu``'s on the CPU.

The same numpy inputs build the JAX package's cameras and the port's (the
port's constructors take ``device='cpu'``); outputs agree to 1e-10 at
float64 and 1e-5 at float32, relative to the largest entry. The gradient of
``CameraExtrinsics.transform`` to the 6-DoF params is held against
``jax.grad``.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kaolin_tpu.render import camera as jcam
import kaolin_tpu_torch as kt

tcam = kt.render.camera
DTYPES = [np.float64, np.float32]
TOL = {np.float64: 1e-10, np.float32: 1e-5}
BACKENDS = ['matrix_se3', 'matrix_6dof_rotation']
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _close(out, ref, dtype):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    scale = float(np.abs(ref).max()) or 1.
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


def _lookat(dtype, n=3, seed=0):
    rng = np.random.default_rng(seed)
    eye = (rng.standard_normal((n, 3)) * 2 + np.array([0., 0.5, 3.])
           ).astype(dtype)
    at = (rng.standard_normal((n, 3)) * 0.1).astype(dtype)
    up = np.tile(np.array([[0., 1., 0.]], dtype), (n, 1))
    return eye, at, up


def _pair(dtype, backend, ctor='lookat'):
    """The same cameras in both packages."""
    eye, at, up = _lookat(dtype)
    if ctor == 'lookat':
        return (jcam.CameraExtrinsics.from_lookat(
                    jnp.asarray(eye), jnp.asarray(at), jnp.asarray(up),
                    backend=backend),
                tcam.CameraExtrinsics.from_lookat(eye, at, up,
                                                  backend=backend,
                                                  device='cpu'))
    base = jcam.CameraExtrinsics.from_lookat(jnp.asarray(eye),
                                             jnp.asarray(at),
                                             jnp.asarray(up))
    if ctor == 'pose':
        pos = np.asarray(base.cam_pos())[..., 0]
        rot = np.swapaxes(np.asarray(base.R), -1, -2)
        return (jcam.CameraExtrinsics.from_camera_pose(
                    pos, rot, dtype=dtype, backend=backend),
                tcam.CameraExtrinsics.from_camera_pose(
                    pos, rot, dtype=TDTYPE[dtype], backend=backend,
                    device='cpu'))
    mat = np.asarray(base.view_matrix())
    return (jcam.CameraExtrinsics.from_view_matrix(mat, dtype=dtype,
                                                   backend=backend),
            tcam.CameraExtrinsics.from_view_matrix(
                mat, dtype=TDTYPE[dtype], backend=backend, device='cpu'))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('ctor', ['lookat', 'pose', 'view_matrix'])
def test_extrinsics_constructors(dtype, backend, ctor):
    j, t = _pair(dtype, backend, ctor)
    assert t.backend == backend and len(t) == 3
    assert t.parameters() is t.params
    _close(t.params, j.params, dtype)
    _close(t.view_matrix(), j.view_matrix(), dtype)
    _close(t.inv_view_matrix(), j.inv_view_matrix(), dtype)
    for name in ('cam_pos', 'cam_right', 'cam_up', 'cam_forward'):
        _close(getattr(t, name)(), getattr(j, name)(), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('backend', BACKENDS)
def test_extrinsics_transforms(dtype, backend):
    j, t = _pair(dtype, backend)
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((3, 7, 3)).astype(dtype)
    orig = rng.standard_normal((3, 5, 3)).astype(dtype)
    dirs = rng.standard_normal((5, 3)).astype(dtype)
    _close(t.transform(torch.tensor(pts)), j.transform(jnp.asarray(pts)),
           dtype)
    _close(t.transform(torch.tensor(pts[0])),
           j.transform(jnp.asarray(pts[0])), dtype)
    for o, r in zip(t.inv_transform_rays(torch.tensor(orig),
                                         torch.tensor(dirs)),
                    j.inv_transform_rays(jnp.asarray(orig),
                                         jnp.asarray(dirs))):
        _close(o, r, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('backend', BACKENDS)
def test_extrinsics_mutations(dtype, backend):
    j, t = _pair(dtype, backend)
    shift = np.array([0.3, -0.2, 0.5], dtype)
    yaw = np.array([0.1, -0.4, 0.7], dtype)
    basis = np.asarray(jcam.blender_coords(), dtype)
    pairs = [
        (t.translate(shift), j.translate(shift)),
        (t.rotate(yaw=yaw, pitch=0.2, roll=-0.3),
         j.rotate(yaw=yaw, pitch=0.2, roll=-0.3)),
        (t.rotate(pitch=0.5), j.rotate(pitch=0.5)),
        (t.move_right(0.4), j.move_right(0.4)),
        (t.move_up(yaw), j.move_up(yaw)),
        (t.move_forward(-1.5), j.move_forward(-1.5)),
        (t.change_coordinate_system(basis),
         j.change_coordinate_system(basis)),
        (t.change_coordinate_system(basis).reset_coordinate_system(),
         j.change_coordinate_system(basis).reset_coordinate_system()),
        (t.switch_backend('matrix_se3'), j.switch_backend('matrix_se3')),
        (t.switch_backend('matrix_6dof_rotation'),
         j.switch_backend('matrix_6dof_rotation')),
        (t[1], j[1]),
        (tcam.CameraExtrinsics.cat([t, t[:2]]),
         jcam.CameraExtrinsics.cat([j, j[:2]])),
    ]
    for o, r in pairs:
        assert o.backend == r.backend and isinstance(
            o, tcam.CameraExtrinsics)
        _close(o.params, r.params, dtype)
        _close(o.view_matrix(), r.view_matrix(), dtype)
    _close(t.change_coordinate_system(basis).reset_coordinate_system()
           .params, t.params.numpy(), dtype)
    for args in ((), ('R',), ('t',)):
        m = t.gradient_mask(*args)
        assert m.dtype == torch.bool and m.device == t.params.device
        np.testing.assert_array_equal(m.numpy(),
                                      np.asarray(j.gradient_mask(*args)))


@pytest.mark.parametrize('dtype', DTYPES)
def test_6dof_transform_grad(dtype):
    """The gradient of a weighted sum of ``transform`` to the 6-DoF
    params, against ``jax.grad``."""
    j, t = _pair(dtype, 'matrix_6dof_rotation')
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((3, 11, 3)).astype(dtype)
    w = rng.standard_normal((3, 11, 3)).astype(dtype)

    def jf(p):
        cam = jcam.CameraExtrinsics(p, backend='matrix_6dof_rotation')
        return jnp.sum(cam.transform(jnp.asarray(pts)) * w)

    ref = jax.grad(jf)(j.params)
    p = t.params.clone().requires_grad_(True)
    out = tcam.CameraExtrinsics(p, backend='matrix_6dof_rotation').transform(
        torch.tensor(pts))
    g, = torch.autograd.grad((out * torch.tensor(w)).sum(), [p])
    _close(g, ref, dtype)


def test_register_backend():
    """A custom backend (translation only, identity rotation) registered in
    the port's own registry."""
    def mat_from_params(p):
        C = p.shape[0]
        mat = torch.eye(4, dtype=p.dtype).repeat(C, 1, 1)
        mat[:, :3, 3] = p
        return mat

    tcam.register_backend('translation_only', lambda m: m[:, :3, 3],
                          mat_from_params)
    cam = tcam.CameraExtrinsics(torch.tensor([[1., 2., 3.]]),
                                backend='translation_only')
    assert cam.transform(torch.zeros(1, 3)).tolist() == [[[1., 2., 3.]]]
    with pytest.raises(ValueError):
        tcam.register_backend('half', lambda m: m)
    with pytest.raises(ValueError):
        tcam.CameraExtrinsics(torch.zeros(1, 9), backend='nope')


NDC = [(-1., 1.), (0., 1.), (1., 0.)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('ndc', NDC)
@pytest.mark.parametrize('ctor', ['fov', 'focal'])
def test_pinhole(dtype, ndc, ctor):
    kw = dict(near=0.1, far=50., num_cameras=2, ndc_min=ndc[0],
              ndc_max=ndc[1], x0=3., y0=-2.)
    if ctor == 'fov':
        j = jcam.PinholeIntrinsics.from_fov(64, 48, math.pi / 3.,
                                            dtype=dtype, **kw)
        t = tcam.PinholeIntrinsics.from_fov(64, 48, math.pi / 3.,
                                            dtype=TDTYPE[dtype],
                                            device='cpu', **kw)
    else:
        j = jcam.PinholeIntrinsics.from_focal(64, 48, 70., 60., dtype=dtype,
                                              **kw)
        t = tcam.PinholeIntrinsics.from_focal(64, 48, 70., 60.,
                                              dtype=TDTYPE[dtype],
                                              device='cpu', **kw)
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((2, 9, 3)) + np.array([0., 0., -5.])
           ).astype(dtype)
    depth = rng.uniform(-1.5, 1.5, (2, 9)).astype(dtype)
    _close(t.params, j.params, dtype)
    _close(t.projection_matrix(), j.projection_matrix(), dtype)
    _close(t.transform(torch.tensor(pts)), j.transform(jnp.asarray(pts)),
           dtype)
    _close(t.normalize_depth(torch.tensor(depth)),
           j.normalize_depth(jnp.asarray(depth)), dtype)
    _close(t.fov_x, j.fov_x, dtype)
    _close(t.zoom(5.).params, j.zoom(5.).params, dtype)
    assert t.lens_type == 'pinhole'


@pytest.mark.parametrize('dtype', DTYPES)
def test_ortho(dtype):
    j = jcam.OrthographicIntrinsics.from_frustum(64, 48, 2.5, near=0.1,
                                                 far=20., num_cameras=2,
                                                 dtype=dtype)
    t = tcam.OrthographicIntrinsics.from_frustum(
        64, 48, 2.5, near=0.1, far=20., num_cameras=2, dtype=TDTYPE[dtype],
        device='cpu')
    pts = np.random.default_rng(4).standard_normal((2, 6, 3)).astype(dtype)
    _close(t.projection_matrix(), j.projection_matrix(), dtype)
    _close(t.transform(torch.tensor(pts)), j.transform(jnp.asarray(pts)),
           dtype)
    _close(t.zoom(1.).params, j.zoom(1.).params, dtype)
    assert t.lens_type == 'ortho'


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('args', ['lookat_fov', 'view_matrix_ortho'])
def test_camera_from_args(dtype, args):
    """The two argument sets of ``Camera.from_args``'s docstring."""
    eye, at, up = _lookat(dtype)
    if args == 'lookat_fov':
        kw = dict(eye=eye, at=at, up=up, width=64, height=48, fov=0.8)
    else:
        mat = np.asarray(jcam.CameraExtrinsics.from_lookat(
            jnp.asarray(eye), jnp.asarray(at), jnp.asarray(up))
            .view_matrix())
        kw = dict(view_matrix=mat, width=64, height=48, fov_distance=2.)
    j = jcam.Camera.from_args(dtype=dtype, **kw)
    t = tcam.Camera.from_args(dtype=TDTYPE[dtype], device='cpu', **kw)
    assert type(t.intrinsics).__name__ == type(j.intrinsics).__name__
    assert len(t) == len(j) == 3 and t.device.type == 'cpu'
    pts = np.random.default_rng(5).standard_normal((3, 4, 3)).astype(dtype)
    _close(t.extrinsics.params, j.extrinsics.params, dtype)
    _close(t.intrinsics.params, j.intrinsics.params, dtype)
    _close(t.view_projection_matrix(), j.view_projection_matrix(), dtype)
    _close(t.transform(torch.tensor(pts)), j.transform(jnp.asarray(pts)),
           dtype)
    _close(t.cam_pos(), j.cam_pos(), dtype)          # forwarded
    for group in ((), ('R',), ('t', 'fov_distance', 'focal_x')):
        for m, r in zip(t.gradient_mask(*group), j.gradient_mask(*group)):
            np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    both = tcam.Camera.cat([t, t[0]])
    assert len(both) == 4 and both.allclose(tcam.Camera.cat([t, t[0]]))


def test_interop_cameras():
    """The JAX package's params carried across by ``utils.interop``."""
    j, _ = _pair(np.float32, 'matrix_6dof_rotation')
    t = kt.utils.interop.extrinsics_from_numpy(
        np.asarray(j.params), 'matrix_6dof_rotation', device='cpu')
    _close(t.view_matrix(), j.view_matrix(), np.float32)
    ji = jcam.PinholeIntrinsics.from_fov(32, 24, 1.0, near=0.5, far=9.,
                                         ndc_min=0., ndc_max=1.)
    ti = kt.utils.interop.intrinsics_from_numpy(
        np.asarray(ji.params), ji.width, ji.height, ji.lens_type,
        near=ji.near, far=ji.far, ndc_min=ji.ndc_min, ndc_max=ji.ndc_max,
        device='cpu')
    _close(ti.projection_matrix(), ji.projection_matrix(), np.float32)
    _close(tcam.blender_coords(device='cpu'), jcam.blender_coords(),
           np.float32)
    _close(tcam.opengl_coords(device='cpu'), jcam.opengl_coords(),
           np.float32)
