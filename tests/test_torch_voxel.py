"""The port's voxel-grid ops and conversions against ``kaolin_tpu`` on the
CPU: ``ops/voxelgrid.py``, ``metrics/voxelgrid.py`` and the conversions
``pointcloud``, ``trianglemesh``, ``voxelgrid`` (marching cubes, marching
tetrahedra, cubic meshes) and ``mesh`` (``mesh_to_spc``).

The same seeded numpy inputs go to both packages. Bool, integer and
octree outputs must be equal; ``fill`` must equal scipy's
``binary_fill_holes`` (through ``kaolin_tpu``) on a cavity reached only
through a winding corridor, one open to the border, random, empty and
full grids; marching cubes must give ``kaolin_tpu``'s vertices and faces
in its order, bit for bit, and the reference's golden meshes; the window
averages of 0/1 grids are exact (27/27 = 1). Float outputs: 1e-12 at
float64 (marching tetrahedra's vertices, the averaged SPC features),
1e-6 relative at float32 (``downsample`` of fractional grids sums in
another order).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

jv, tv = kal.ops.voxelgrid, kt.ops.voxelgrid
jcv, tcv = kal.ops.conversions, kt.ops.conversions
# the JAX references compiled whole (op by op they take seconds); not
# the window averages: compiled, XLA multiplies by the window's
# reciprocal where the eager call divides
j_odms = jax.jit(jv.extract_odms)
j_project = jax.jit(jv.project_odms, static_argnums=2)
j_pc_to_vg = jax.jit(jcv.pointclouds_to_voxelgrids, static_argnums=1)
FIX = os.path.join(os.path.dirname(__file__), 'fixtures', 'mc_golden.npz')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eq(ref, out):
    ref = np.asarray(ref)
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    np.testing.assert_array_equal(ref, out)


def _grids(seed=0, batch=2, res=9, p=0.45):
    return (np.random.default_rng(seed).random((batch, res, res, res)) < p
            ).astype(np.float32)


def _winding_cavity():
    """A hollow box whose cavity reaches the border only through a
    corridor that turns four times (grid 1), and the same box sealed
    (grid 0)."""
    vg = np.ones((2, 12, 12, 12), np.float32)
    vg[:, 4:8, 4:8, 4:8] = 0.                 # the cavity
    # corridor: out of the cavity along +x, then +y, -x, +z, to the border
    vg[1, 8:10, 5, 5] = 0.
    vg[1, 9, 5:10, 5] = 0.
    vg[1, 2:10, 9, 5] = 0.
    vg[1, 2, 9, 5:12] = 0.
    return vg


def _ball(res, radius):
    ax = np.arange(res) - (res - 1) / 2.
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    return ((X ** 2 + Y ** 2 + Z ** 2) < radius ** 2).astype(np.float32)


def test_fill_matches_scipy():
    full = np.ones((1, 6, 6, 6), np.float32)
    hollow = np.ones((1, 7, 7, 7), np.float32)
    hollow[0, 1:6, 1:6, 1:6] = 0.
    open_box = hollow.copy()
    open_box[0, 3, 3, 0] = 0.                    # a hole to the border
    for vg in (_winding_cavity(), _grids(1), _grids(2, p=0.7),
               np.zeros((2, 5, 6, 7), np.float32), full, hollow, open_box,
               _ball(20, 8)[None] - _ball(20, 5)[None]):
        out = tv.fill(torch.tensor(vg))
        assert out.dtype == torch.bool
        _eq(jv.fill(jnp.asarray(vg)), out)
    winding = tv.fill(torch.tensor(_winding_cavity()))
    assert winding[0, 5, 5, 5] and not winding[1, 5, 5, 5]
    assert not tv.fill(torch.tensor(open_box))[0, 3, 3, 3]


def test_surface_and_downsample():
    full = torch.ones((1, 5, 5, 5))
    wide = tv.extract_surface(full)
    assert not wide[0, 1:4, 1:4, 1:4].any()     # 27/27 windows average 1
    assert wide.sum() == 125 - 27
    for vg in (_grids(3), _ball(12, 4)[None]):
        for mode in ('wide', 'thin'):
            _eq(jv.extract_surface(jnp.asarray(vg), mode),
                tv.extract_surface(torch.tensor(vg), mode))
        for scale in (2, (1, 3, 2)):
            _eq(jv.downsample(jnp.asarray(vg), scale),
                tv.downsample(torch.tensor(vg), scale))
    frac = np.random.default_rng(4).random((2, 6, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(tv.downsample(torch.tensor(frac), 3).numpy(),
                               np.asarray(jv.downsample(jnp.asarray(frac),
                                                        3)), rtol=1e-6)
    with pytest.raises(ValueError):
        tv.extract_surface(full, 'middle')
    with pytest.raises(ValueError):
        tv.downsample(full, 6)


def test_odms_and_iou():
    for vg in (_grids(5, res=8), _ball(8, 3)[None]):
        odms = tv.extract_odms(torch.tensor(vg))
        assert odms.dtype == torch.int64
        _eq(j_odms(jnp.asarray(vg)), odms)
        for votes in (1, 3):
            for base in (None, vg.astype(bool)):
                out = tv.project_odms(
                    odms, None if base is None else torch.tensor(base), votes)
                assert out.dtype == torch.bool
                _eq(j_project(jnp.asarray(odms.numpy()),
                                  None if base is None
                                  else jnp.asarray(base), votes), out)
    a, b = _grids(6), _grids(7)
    iou = kt.metrics.voxelgrid.iou(torch.tensor(a), torch.tensor(b))
    assert iou.dtype == torch.float32
    _eq(kal.metrics.voxelgrid.iou(jnp.asarray(a), jnp.asarray(b)), iou)


def test_pointclouds_to_voxelgrids_half_rounding():
    """x (res - 1) = k + 0.5 rounds to even, as jnp.round; points out of
    the grid are dropped."""
    res = 5
    pc = np.array([[[0.125, 0.375, 0.625], [0.875, 0.875, 0.125],
                    [-0.2, 0.5, 0.5], [0.5, 1.3, 0.5], [1., 1., 1.]]])
    origin, scale = np.zeros((1, 3)), np.ones(1)
    out = tcv.pointclouds_to_voxelgrids(torch.tensor(pc), res,
                                        torch.tensor(origin),
                                        torch.tensor(scale))
    assert out.dtype == torch.float32
    _eq(j_pc_to_vg(jnp.asarray(pc), res, jnp.asarray(origin),
                   jnp.asarray(scale)), out)
    assert out[0, 0, 2, 2] == 1 and out[0, 4, 4, 0] == 1
    assert out.sum() == 3
    for dtype in (np.float64, np.float32):
        pc = np.random.default_rng(8).normal(size=(2, 300, 3)).astype(dtype)
        _eq(j_pc_to_vg(jnp.asarray(pc), 16),
            tcv.pointclouds_to_voxelgrids(torch.tensor(pc), 16))


def test_pointcloud_to_spc():
    rng = np.random.default_rng(9)
    pc = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    for feats in (rng.normal(size=(400, 3)),
                  rng.integers(-50, 50, (400, 2)).astype(np.int32)):
        ref = jcv.unbatched_pointcloud_to_spc(jnp.asarray(pc), 4,
                                              jnp.asarray(feats))
        out = tcv.unbatched_pointcloud_to_spc(torch.tensor(pc), 4,
                                              torch.tensor(feats))
        _eq(ref.octrees, out.octrees)
        _eq(ref.lengths, out.lengths)
        assert out.features.dtype == torch.tensor(feats).dtype
        np.testing.assert_allclose(out.features.numpy(),
                                   np.asarray(ref.features), rtol=0,
                                   atol=1e-12)


def test_trianglemeshes_to_voxelgrids():
    """At float64, where the JAX package's lattice weights (float64 under
    64-bit mode) meet vertices of their own dtype."""
    res = 20
    v, f = kt.utils.interop.icosphere(2)
    verts = np.stack([v, v * [1.2, 0.7, 1.] + 0.1]).astype(np.float64)
    out = tcv.trianglemeshes_to_voxelgrids(torch.tensor(verts),
                                           torch.tensor(f), res)
    assert out.dtype == torch.float32 and out.sum() > 0
    _eq(jcv.trianglemeshes_to_voxelgrids(jnp.asarray(verts), jnp.asarray(f),
                                         res), out)


def test_marching_cubes_golden():
    data = np.load(FIX)
    for name in sorted({k.rsplit('_', 1)[0] for k in data.files}):
        verts, faces = tcv.voxelgrids_to_trianglemeshes(
            torch.tensor(data[f'{name}_vg'][None]))
        _eq(data[f'{name}_v'], verts[0])
        _eq(data[f'{name}_f'], faces[0])


def test_marching_cubes_order_and_batch():
    """kaolin_tpu's vertices and faces, in its order, bit for bit, on
    random, ball and fractional grids at three iso values; empty grids."""
    rng = np.random.default_rng(10)
    grids = [_grids(11, batch=3, res=7), _ball(14, 5)[None],
             rng.random((2, 6, 5, 7)).astype(np.float32),
             np.zeros((2, 3, 3, 3), np.float32)]
    for vg in grids:
        for iso in (0.5, 0.2):
            rv, rf = jcv.voxelgrids_to_trianglemeshes(jnp.asarray(vg), iso)
            ov, of = tcv.voxelgrids_to_trianglemeshes(torch.tensor(vg), iso)
            assert len(ov) == vg.shape[0]
            for a, b, c, d in zip(rv, ov, rf, of):
                assert b.dtype == torch.float32 and d.dtype == torch.int32
                _eq(a, b)
                _eq(c, d)


def test_marching_tets_and_cubic_meshes():
    for vg in (_grids(12, batch=2, res=5), _ball(8, 3)[None],
               np.zeros((1, 3, 3, 3), np.float32)):
        rv, rf = jcv.voxelgrids_to_trianglemeshes(jnp.asarray(vg),
                                                  method='tets')
        ov, of = tcv.voxelgrids_to_trianglemeshes(torch.tensor(vg),
                                                  method='tets')
        for a, b, c, d in zip(rv, ov, rf, of):
            assert b.dtype == torch.float64 and d.dtype == torch.int64
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-12)
            _eq(c, d)
        for trimesh in (True, False):
            rv, rf = jcv.voxelgrids_to_cubic_meshes(jnp.asarray(vg), trimesh)
            ov, of = tcv.voxelgrids_to_cubic_meshes(torch.tensor(vg), trimesh)
            for a, b, c, d in zip(rv, ov, rf, of):
                assert b.dtype == torch.float32
                _eq(a, b)
                _eq(c, d)
    with pytest.raises(ValueError):
        tcv.voxelgrids_to_trianglemeshes(torch.zeros((1, 2, 2, 2)),
                                         method='dual')


def test_mesh_to_spc():
    v, f = kt.utils.interop.icosphere(2)
    verts = np.stack([0.9 * v, 0.5 * v + 0.2])
    for level in (3, 6):
        ref = jcv.mesh_to_spc(jnp.asarray(verts), jnp.asarray(f), level)
        out = tcv.mesh_to_spc(torch.tensor(verts), torch.tensor(f), level)
        _eq(ref.octrees, out.octrees)
        _eq(ref.lengths, out.lengths)
        assert out.octrees.dtype == torch.uint8
        _eq(ref.point_hierarchies, out.point_hierarchies)
