"""XLA's float to integer rule in the PyTorch port, against ``kaolin_tpu``
on the CPU.

``kaolin_tpu_torch.casts.to_int`` is held against ``jnp.astype`` on NaN,
+-inf, values past the integer types' range and fractions of both signs,
for int16, int32 and int64 (from float32 and float64). Then every port
function whose cast was routed through it runs on NaN, +-inf and
out-of-range inputs beside ``kaolin_tpu``: ``grid_sample_2d`` and
``texture_mapping`` (nearest and bilinear, values and gradients),
``pointclouds_to_voxelgrids`` (a NaN point, an inf point, an all-equal
cloud, a one-point cloud), ``quantize_points``, ``unbatched_query``,
``extract_odms`` and the fish example's ``position_by_uv``.

Tolerances: integer and voxel outputs exactly; float32 values to 1e-6 and
gradients to 5e-5 of the largest finite entry, NaN where ``kaolin_tpu``
has NaN (the two packages add the taps' terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from examples import fish as jfish
from kaolin_tpu_torch.casts import to_int
from kaolin_tpu_torch.examples import fish as tfish

VALUES = [np.nan, np.inf, -np.inf, 3e9, -3e9, 0.5, -0.5, -1.5, 2.5, 1e19,
          -1e19, 40000., -40000., 32767.9, -32768.9, 0., -0.]
INT_TYPES = [(jnp.int16, torch.int16), (jnp.int32, torch.int32),
             (jnp.int64, torch.int64)]
TOL_VALUE, TOL_GRAD = 1e-6, 5e-5
MODES = ['nearest', 'bilinear']


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: many small tensor ops, under the suite's
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, tol):
    """Equal NaN positions, the rest within ``tol`` of the largest finite
    entry of ``ref``."""
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    finite = np.isfinite(ref)
    scale = float(np.abs(ref[finite]).max()) if finite.any() else 1.
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * (scale or 1.),
                               equal_nan=True)


@pytest.mark.parametrize('fdtype', [np.float32, np.float64])
@pytest.mark.parametrize('jdt,tdt', INT_TYPES)
def test_to_int_is_xla_convert(fdtype, jdt, tdt):
    v = np.asarray(VALUES, fdtype)
    ref = np.asarray(jnp.asarray(v).astype(jdt))
    out = to_int(torch.from_numpy(v), tdt).numpy()
    np.testing.assert_array_equal(out, ref)


def test_to_int_keeps_integer_casts():
    x = torch.tensor([-70000, 5, 40000], dtype=torch.int64)
    assert torch.equal(to_int(x, torch.int16), x.to(torch.int16))
    b = torch.tensor([True, False])
    assert torch.equal(to_int(b, torch.int32), b.to(torch.int32))


def _sampler_grid():
    """(2, 5, 1, 2) grid coords with NaN, +-inf and out-of-range x and y;
    the rest inside [-1, 1]."""
    rng = np.random.default_rng(3)
    g = rng.uniform(-1., 1., (2, 5, 1, 2)).astype(np.float32)
    g[0, 1, 0, 0] = np.nan
    g[0, 2, 0, 1] = np.nan
    g[0, 3, 0, 0] = np.inf
    g[1, 0, 0, 1] = -np.inf
    g[1, 1, 0, 0] = 7.5
    g[1, 2, 0, 1] = -4.25
    g[1, 3] = np.nan
    return g


def _texture():
    return np.random.default_rng(4).normal(size=(2, 3, 4, 4)).astype(
        np.float32)


def _grad_pair(jfn, tfn, args, cot):
    """(JAX value, JAX grads, port value, port grads) of sum(f * cot)."""
    jargs = [jnp.asarray(a) for a in args]
    jval, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tval = tfn(*targs)
    tgrads = torch.autograd.grad(tval, targs, torch.as_tensor(cot))
    return jval, jgrads, tval, tgrads


@pytest.mark.parametrize('mode', MODES)
def test_grid_sample_2d_nan_inf_coords(mode):
    tex, grid = _texture(), _sampler_grid()
    cot = np.random.default_rng(5).normal(size=(2, 3, 5, 1)).astype(
        np.float32)
    jval, jgrads, tval, tgrads = _grad_pair(
        lambda t, g: kal.render.mesh.grid_sample_2d(t, g, mode, 'xla'),
        lambda t, g: kt.render.mesh.grid_sample_2d(t, g, mode),
        (tex, grid), cot)
    _close(tval, jval, TOL_VALUE)
    assert np.isnan(np.asarray(jval)).any() == (mode == 'bilinear')
    for out, ref in zip(tgrads, jgrads):
        _close(out, ref, TOL_GRAD)


@pytest.mark.parametrize('mode', MODES)
def test_texture_mapping_nan_inf_uvs(mode):
    tex = _texture()
    uv = _sampler_grid().reshape(2, 5, 2) * 0.5 + 0.5
    cot = np.random.default_rng(6).normal(size=(2, 5, 3)).astype(np.float32)
    jval, jgrads, tval, tgrads = _grad_pair(
        lambda u, t: kal.render.mesh.texture_mapping(u, t, mode),
        lambda u, t: kt.render.mesh.texture_mapping(u, t, mode),
        (uv, tex), cot)
    _close(tval, jval, TOL_VALUE)
    for out, ref in zip(tgrads, jgrads):
        _close(out, ref, TOL_GRAD)


VOXEL_CLOUDS = {
    # (points (B, N, 3), origin, scale) -- None for the default
    'nan point': ([[[np.nan, .2, .3], [.5, .5, .5]]], [[0., 0., 0.]], [1.]),
    'inf point': ([[[np.inf, .2, .3], [.5, -np.inf, .5], [.25, .5, .75]]],
                  [[0., 0., 0.]], [1.]),
    'out of range': ([[[1.5, .2, .3], [-.4, .5, .5], [.1, .1, .1]]],
                     [[0., 0., 0.]], [1.]),
    'all equal': ([[[.3, -.2, .7]] * 4], None, None),
    'one point': ([[[.3, -.2, .7]]], None, None),
    'default frame with nan': ([[[np.nan, .2, .3], [.5, .5, .5],
                                 [.1, .9, .4]]], None, None),
}


@pytest.mark.parametrize('case', sorted(VOXEL_CLOUDS))
def test_pointclouds_to_voxelgrids_bad_points(case):
    pts, origin, scale = VOXEL_CLOUDS[case]
    pts = np.asarray(pts, np.float32)
    jkw, tkw = {}, {}
    if origin is not None:
        o, s = np.asarray(origin, np.float32), np.asarray(scale, np.float32)
        jkw = dict(origin=jnp.asarray(o), scale=jnp.asarray(s))
        tkw = dict(origin=torch.as_tensor(o), scale=torch.as_tensor(s))
    ref = np.asarray(kal.ops.conversions.pointclouds_to_voxelgrids(
        jnp.asarray(pts), 4, **jkw))
    out = kt.ops.conversions.pointclouds_to_voxelgrids(
        torch.as_tensor(pts), 4, **tkw).numpy()
    np.testing.assert_array_equal(out, ref)
    assert ref.any()


def test_pointclouds_to_voxelgrids_queue3_voxels():
    """The cases of the fault as it was found: the NaN point marks voxel
    (0, 1, 1) beside (2, 2, 2), an all-equal cloud marks (0, 0, 0)."""
    pts = torch.tensor([[[np.nan, .2, .3], [.5, .5, .5]]])
    vg = kt.ops.conversions.pointclouds_to_voxelgrids(
        pts, 4, origin=torch.zeros(1, 3), scale=torch.ones(1))
    assert torch.nonzero(vg[0]).tolist() == [[0, 1, 1], [2, 2, 2]]
    vg = kt.ops.conversions.pointclouds_to_voxelgrids(
        torch.full((1, 3, 3), .3), 4)
    assert torch.nonzero(vg[0]).tolist() == [[0, 0, 0]]


BAD_COORDS = np.asarray([[np.nan, 0., .5], [np.inf, -np.inf, .1],
                         [3., -5., .99], [-1., 1., 0.], [1e30, -1e30, np.nan]],
                        np.float32)


@pytest.mark.parametrize('level', [1, 3, 10])
def test_quantize_points_bad_coords(level):
    ref = np.asarray(kal.ops.spc.quantize_points(jnp.asarray(BAD_COORDS),
                                                 level))
    out = kt.ops.spc.quantize_points(torch.as_tensor(BAD_COORDS),
                                     level).numpy()
    assert out.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('with_parents', [False, True])
def test_unbatched_query_bad_coords(with_parents):
    """Float query coords with NaN and +-inf: the cell the XLA convert
    gives (NaN to cell 0) or -1 outside."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1., 1., (200, 3)).astype(np.float32)
    level = 3
    jq = kal.ops.spc.quantize_points(jnp.asarray(pts), level)
    joct = kal.ops.spc.unbatched_points_to_octree(jq, level)
    _, _, jexsum = kal.ops.spc.scan_octrees(joct, np.asarray([joct.shape[0]]))
    toct = kt.ops.spc.unbatched_points_to_octree(
        kt.ops.spc.quantize_points(torch.as_tensor(pts), level), level)
    _, _, texsum = kt.ops.spc.scan_octrees(toct, [toct.shape[0]])
    ref = np.asarray(kal.ops.spc.unbatched_query(
        joct, jexsum, jnp.asarray(BAD_COORDS), level, with_parents))
    out = kt.ops.spc.unbatched_query(toct, texsum,
                                     torch.as_tensor(BAD_COORDS), level,
                                     with_parents).numpy()
    np.testing.assert_array_equal(out, ref)


def test_fish_position_by_uv_bad_uvs():
    """NaN and +-inf uvs give NaN rows; uvs outside [0, 1] read the
    clamped rows JAX's gather reads."""
    lod_x, lod_y = 5, 4
    rng = np.random.default_rng(9)
    verts = rng.normal(size=(1, lod_x * lod_y, 3)).astype(np.float32)
    uvs = np.asarray([[np.nan, .5], [np.inf, .2], [-np.inf, .3], [1.5, .5],
                      [-.5, .5], [.5, -3.], [.5, 7.], [.25, .75], [1e10, 0.],
                      [-1e10, 1.]], np.float32)
    ref = np.asarray(jfish.position_by_uv(jnp.asarray(verts), lod_x, lod_y,
                                          jnp.asarray(uvs)))
    out = tfish.position_by_uv(torch.as_tensor(verts), lod_x, lod_y,
                               torch.as_tensor(uvs))
    _close(out, ref, TOL_VALUE)


def test_extract_odms_nan_voxel():
    """A NaN in a float voxel grid: the depth of every row through it is
    NaN before the cast, 0 after XLA's."""
    vg = (np.random.default_rng(10).random((2, 5, 5, 5)) < 0.3).astype(
        np.float32)
    vg[0, 2, 3, 1] = np.nan
    ref = np.asarray(kal.ops.voxelgrid.extract_odms(jnp.asarray(vg)))
    out = kt.ops.voxelgrid.extract_odms(torch.as_tensor(vg)).numpy()
    np.testing.assert_array_equal(out, ref)
