"""The port's batching ops, mesh ops, ``check_sign`` and
``sdf_to_voxelgrids`` against ``kaolin_tpu`` on the CPU.

The same seeded numpy inputs go to both packages. Tolerances: float64
1e-10, float32 1e-5 (XLA on the CPU fuses products into sums where the
port does not). Indices, face picks and booleans must be equal. Sampling:
``jax.random`` and ``torch.Generator`` draw different numbers, so the
parity tests feed the port the uniforms ``kaolin_tpu`` draws from its key;
the picks then agree unless a draw lies within a few ulps of a step of
the cumulative areas, which the two packages may round differently (none
does here). The distribution is checked on its own.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.ops.mesh.trianglemesh import (
    _picks_from_cdf as jax_picks_from_cdf)
from kaolin_tpu_torch.ops.mesh.trianglemesh import (
    _barycentric, _packed_sample_from_uniforms, _picks_from_cdf,
    _sample_from_uniforms)

TOL = {np.float64: 1e-10, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: under the suite's six workers the default
    threads contend for the cores (one case of this file's took 10-20x its
    time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ref, out, dtype):
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _icosphere(subdiv, dtype=np.float32):
    v, f = kt.utils.interop.icosphere(subdiv)
    return v.astype(dtype), f


def _torus(R=0.6, r=0.25, nu=24, nv=12):
    """The torus of ``tests/test_mesh_extended.py``."""
    iu, iv = np.meshgrid(np.arange(nu), np.arange(nv), indexing='ij')
    tu, tv = iu / nu * 2 * np.pi, iv / nv * 2 * np.pi
    verts = np.stack([(R + r * np.cos(tv)) * np.cos(tu),
                      (R + r * np.cos(tv)) * np.sin(tu),
                      r * np.sin(tv)], -1).reshape(-1, 3)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


# ------------------------------------------------------------------- batch

def _ragged(rng, dtype):
    return [rng.standard_normal(s).astype(dtype)
            for s in ((3, 4, 2), (1, 5, 2), (2, 2, 2))]


@pytest.mark.parametrize('dtype', DTYPES)
def test_batch_ops(dtype):
    """Every function of ``ops/batch.py`` against the JAX package's."""
    rng = np.random.default_rng(0)
    arrays = _ragged(rng, dtype)
    jl = [jnp.asarray(a) for a in arrays]
    tl = [torch.tensor(a) for a in arrays]
    jb, tb = kal.ops.batch, kt.ops.batch

    spt = tb.get_shape_per_tensor(tl)
    np.testing.assert_array_equal(jb.get_shape_per_tensor(jl), spt)
    rp, rs = jb.list_to_packed(jl)
    op, os_ = tb.list_to_packed(tl)
    np.testing.assert_array_equal(rs, os_)
    _close(rp, op, dtype)
    for r, o in zip(jb.packed_to_list(rp, rs), tb.packed_to_list(op, os_)):
        _close(r, o, dtype)
    numel = np.prod(spt, axis=1)
    np.testing.assert_array_equal(jb.get_first_idx(numel),
                                  tb.get_first_idx(numel))
    for partial in (None, [-1, 6]):
        np.testing.assert_array_equal(jb.fill_max_shape(spt, partial),
                                      tb.fill_max_shape(spt, partial))
    with pytest.raises(ValueError):
        tb.fill_max_shape(spt, [1, -1])
    rpad, _ = jb.list_to_padded(jl, padding_value=-2., max_shape=[4, -1])
    opad, _ = tb.list_to_padded(tl, padding_value=-2., max_shape=[4, -1])
    assert opad.shape == (3, 4, 5, 2) and opad.dtype == tl[0].dtype
    _close(rpad, opad, dtype)
    for r, o in zip(jb.padded_to_list(rpad, spt), tb.padded_to_list(opad,
                                                                    spt)):
        _close(r, o, dtype)
    _close(jb.packed_to_padded(rp, rs, padding_value=1.),
           tb.packed_to_padded(op, os_, padding_value=1.), dtype)
    _close(jb.padded_to_packed(rpad, spt), tb.padded_to_packed(opad, spt),
           dtype)
    seg = tb.segment_ids_from_numel(numel, device='cpu')
    assert seg.dtype == torch.int32
    np.testing.assert_array_equal(jb.segment_ids_from_numel(numel), seg)
    vals = rng.standard_normal(3).astype(dtype)
    _close(jb.tile_to_packed(jnp.asarray(vals), numel),
           tb.tile_to_packed(torch.tensor(vals), numel), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_packed_simple_sum(dtype):
    rng = np.random.default_rng(1)
    packed = rng.standard_normal((9, 4)).astype(dtype)
    numel = np.array([2, 0, 3, 4])
    ref = kal.ops.reduction.packed_simple_sum(jnp.asarray(packed), numel)
    t = torch.tensor(packed, requires_grad=True)
    out = kt.ops.packed_simple_sum(t, numel)
    assert out.shape == (4,)
    _close(ref, out, dtype)
    out.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))


# ------------------------------------------------------------ mesh geometry

@pytest.mark.parametrize('dtype', DTYPES)
def test_face_areas_and_edge_lengths(dtype):
    rng = np.random.default_rng(2)
    verts = rng.standard_normal((2, 12, 3)).astype(dtype)
    faces = rng.integers(0, 12, (15, 3)).astype(np.int64)
    jv, jf = jnp.asarray(verts), jnp.asarray(faces)
    tv, tf = kt.utils.interop.mesh_from_numpy(verts, faces, device='cpu')
    _close(kal.ops.mesh.face_areas(jv, jf), kt.ops.mesh.face_areas(tv, tf),
           dtype)
    _close(kal.ops.mesh.average_edge_length(jv, jf),
           kt.metrics.trianglemesh.average_edge_length(tv, tf), dtype)
    first = np.array([0, 5, 12])
    nfaces = np.array([4, 3])
    pf = np.concatenate([rng.integers(0, 5, (4, 3)),
                         rng.integers(0, 7, (3, 3))])
    _close(kal.ops.mesh.packed_face_areas(jv[0], first, jnp.asarray(pf),
                                          nfaces),
           kt.ops.mesh.packed_face_areas(tv[0], first, torch.tensor(pf),
                                         nfaces), dtype)


def test_adjacency_and_laplacian():
    v, f = _icosphere(1)
    ref = np.asarray(kal.ops.mesh.adjacency_matrix(v.shape[0], f))
    out = kt.ops.mesh.adjacency_matrix(v.shape[0], torch.tensor(f))
    assert out.device.type == 'cpu' and out.dtype == torch.float32
    np.testing.assert_array_equal(ref, out.numpy())
    ri, rv = kal.ops.mesh.adjacency_matrix(v.shape[0], f, sparse=True)
    oi, ov = kt.ops.mesh.adjacency_matrix(v.shape[0], f, sparse=True,
                                          device='cpu')
    np.testing.assert_array_equal(np.asarray(ri), oi.numpy())
    np.testing.assert_array_equal(np.asarray(rv), ov.numpy())
    # a vertex in no face: its row is 0 off the diagonal
    L = kt.ops.mesh.uniform_laplacian(v.shape[0] + 1, f, device='cpu')
    np.testing.assert_allclose(np.asarray(kal.ops.mesh.uniform_laplacian(
        v.shape[0] + 1, f)), L.numpy(), rtol=1e-7)
    assert float(L[-1].abs().sum()) == 1.


@pytest.mark.parametrize('dtype', DTYPES)
def test_uniform_laplacian_smoothing_and_gradient(dtype):
    v, f = _icosphere(1, dtype)
    rng = np.random.default_rng(3)
    verts = (v + 0.1 * rng.standard_normal(v.shape))[None].astype(dtype)
    w = rng.standard_normal(verts.shape).astype(dtype)

    def loss(x):
        return jnp.sum(kal.metrics.trianglemesh.uniform_laplacian_smoothing(
            x, jnp.asarray(f)) ** 2 * w)

    ref = kal.metrics.trianglemesh.uniform_laplacian_smoothing(
        jnp.asarray(verts), jnp.asarray(f))
    tv, tf = kt.utils.interop.mesh_from_numpy(verts, f, device='cpu')
    tv.requires_grad_(True)
    out = kt.metrics.trianglemesh.uniform_laplacian_smoothing(tv, tf)
    _close(ref, out, dtype)
    (out ** 2 * torch.tensor(w)).sum().backward()
    _close(jax.grad(loss)(jnp.asarray(verts)), tv.grad, dtype)


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize('dtype', DTYPES)
def test_picks_from_cdf_and_barycentric(dtype):
    """The deterministic helpers on the same uniforms; a draw that rounds
    up to the total goes to the last face of positive area."""
    rng = np.random.default_rng(4)
    areas = rng.random((2, 9)).astype(dtype)
    areas[:, 3] = 0.
    areas[:, -2:] = 0.
    cdf = np.cumsum(areas, axis=-1)
    q = rng.random((2, 500)).astype(dtype) * cdf[:, -1:]
    q[:, 0] = cdf[:, -1]
    q[:, 1] = cdf[:, 2]
    ref = np.asarray(jax_picks_from_cdf(jnp.asarray(cdf), jnp.asarray(q)))
    out = _picks_from_cdf(torch.tensor(cdf), torch.tensor(q))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(ref, out.numpy())
    assert not np.isin(out.numpy(), [3, 7, 8]).any()
    u, v = rng.random((2, 2, 30, 1)).astype(dtype)
    s = np.sqrt(u)
    for r, o in zip((1. - s, s * (1. - v), s * v),
                    _barycentric(torch.tensor(u), torch.tensor(v))):
        _close(r, o, dtype)


def _jax_uniforms(key, batch, num_samples, dtype):
    k_face, k_bary = jax.random.split(key)
    k1, k2 = jax.random.split(k_bary)
    return tuple(torch.tensor(np.asarray(x)) for x in (
        jax.random.uniform(k_face, (batch, num_samples), dtype=dtype),
        jax.random.uniform(k1, (batch, num_samples, 1), dtype=dtype),
        jax.random.uniform(k2, (batch, num_samples, 1), dtype=dtype)))


@pytest.mark.parametrize('dtype', DTYPES)
def test_sample_points_matches_jax_on_its_uniforms(dtype):
    v, f = _icosphere(1, dtype)
    rng = np.random.default_rng(5)
    verts = np.stack([v, v * [1.3, 0.75, 1.]]).astype(dtype)
    feats = rng.standard_normal((2, f.shape[0], 3, 2)).astype(dtype)
    key = jax.random.PRNGKey(7)
    rp, rc, rf = kal.ops.mesh.sample_points(
        jnp.asarray(verts), jnp.asarray(f), 300,
        face_features=jnp.asarray(feats), key=key)
    tv, tf = kt.utils.interop.mesh_from_numpy(verts, f, device='cpu')
    op, oc, of = _sample_from_uniforms(
        tv, tf, *_jax_uniforms(key, 2, 300, dtype),
        face_features=torch.tensor(feats))
    np.testing.assert_array_equal(np.asarray(rc), oc.numpy())
    _close(rp, op, dtype)
    _close(rf, of, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_packed_sample_points_matches_jax_on_its_uniforms(dtype):
    rng = np.random.default_rng(6)
    verts = rng.standard_normal((9, 3)).astype(dtype)
    first = np.array([0, 4, 9])
    faces = np.array([[0, 1, 2], [1, 2, 3], [0, 1, 2], [2, 3, 4], [0, 3, 4]])
    nfaces = np.array([2, 3])
    key = jax.random.PRNGKey(8)
    rp, rc = kal.ops.mesh.packed_sample_points(
        jnp.asarray(verts), first, jnp.asarray(faces), nfaces, 200, key=key)
    op, oc = _packed_sample_from_uniforms(
        torch.tensor(verts), first, torch.tensor(faces), nfaces,
        *_jax_uniforms(key, 2, 200, dtype))
    np.testing.assert_array_equal(np.asarray(rc), oc.numpy())
    _close(rp, op, dtype)


def test_sample_points_distribution_and_features():
    """As ``tests/test_mesh_ops.py`` holds the JAX package: the share of
    picks per face follows the areas, points lie on their faces, and the
    interpolated features are the interpolated positions."""
    verts = torch.tensor([[[0., 0., 0.], [4., 0., 0.], [0., 4., 0.],
                           [0., 0., 0.1]]])
    faces = torch.tensor([[0, 1, 2], [0, 1, 3]])
    g = torch.Generator().manual_seed(0)
    pts, choices = kt.ops.mesh.sample_points(verts, faces, 4096, generator=g)
    assert pts.shape == (1, 4096, 3) and choices.dtype == torch.int32
    areas = kt.ops.mesh.face_areas(verts, faces)[0]
    frac = float((choices[0] == 0).double().mean())
    assert abs(frac - float(areas[0] / areas.sum())) < 0.05
    assert float(pts[0][choices[0] == 0][:, 2].abs().max()) < 1e-5
    fv = kt.ops.mesh.index_vertices_by_faces(verts, faces)
    pts, _, pfeat = kt.ops.mesh.sample_points(
        verts, faces, 128, face_features=fv[..., :2], generator=g)
    np.testing.assert_allclose(pts[..., :2].numpy(), pfeat.numpy(),
                               atol=1e-6)
    again = kt.ops.mesh.sample_points(
        verts, faces, 128, generator=torch.Generator().manual_seed(0))
    first = kt.ops.mesh.sample_points(
        verts, faces, 128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again[0], first[0])


def test_packed_sample_points_shapes():
    rng = np.random.default_rng(0)
    verts = torch.tensor(rng.normal(size=(7, 3)))
    first = np.array([0, 4, 7])
    faces = torch.tensor([[0, 1, 2], [0, 1, 2]])
    nfaces = np.array([1, 1])
    pts, choices = kt.ops.mesh.packed_sample_points(
        verts, first, faces, nfaces, 64, generator=torch.Generator())
    assert pts.shape == (2, 64, 3)
    np.testing.assert_array_equal(choices.numpy(), [[0] * 64, [1] * 64])
    assert kt.ops.mesh.packed_face_areas(verts, first, faces,
                                         nfaces).shape == (2,)


# -------------------------------------------------------------- check_sign

def _check_sign_both(verts, faces, points):
    ref = np.asarray(kal.ops.mesh.check_sign(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(points)))
    out = kt.ops.mesh.check_sign(torch.tensor(verts), torch.tensor(faces),
                                 torch.tensor(points))
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(ref, out.numpy())
    return out.numpy()


@pytest.mark.parametrize('dtype', DTYPES)
def test_check_sign_reference_example(dtype):
    verts = np.array([[[0., 0., 0.], [1., 0.5, 1.], [0.5, 1., 1.],
                       [1., 1., 0.5]]], dtype)
    faces = np.array([[0, 3, 1], [0, 1, 2], [0, 2, 3], [3, 2, 1]])
    axis = np.linspace(0.1, 0.9, 3)
    p_x, p_y, p_z = np.meshgrid(axis + 0.01, axis + 0.02, axis + 0.03,
                                indexing='ij')
    points = np.stack([p_x, p_y, p_z], -1).reshape(1, -1, 3).astype(dtype)
    out = _check_sign_both(verts, faces, points)
    expected = np.zeros(27, bool)
    expected[[0, 13, 17, 23, 25]] = True
    np.testing.assert_array_equal(out[0], expected)


@pytest.mark.parametrize('dtype', DTYPES)
def test_check_sign_icosphere(dtype):
    v, f = _icosphere(2, dtype)
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (1, 200, 3))
    out = _check_sign_both(v[None], f, pts.astype(dtype))[0]
    r = np.linalg.norm(pts[0], axis=-1)
    assert out[r < 0.9].all() and not out[r > 1.05].any()


def test_check_sign_torus():
    v, f = _torus()
    pts = np.array([[[0.6, 0., 0.], [0., 0.6, 0.], [0., 0., 0.],
                     [0., 0., 0.2], [1.2, 0., 0.]]], np.float32)
    np.testing.assert_array_equal(_check_sign_both(v[None], f, pts)[0],
                                  [True, True, False, False, False])
    v, f = _torus(nu=48, nv=24)
    pts = np.random.default_rng(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    d = np.sqrt((np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2) - 0.6) ** 2
                + pts[:, 2] ** 2)
    keep = np.abs(d - 0.25) > 0.05
    np.testing.assert_array_equal(
        _check_sign_both(v[None], f, pts[keep][None])[0], d[keep] < 0.25)


# -------------------------------------------------------- sdf_to_voxelgrids

def _sphere(radius):
    def f(points):
        return (points ** 2).sum(1) ** 0.5 - radius
    return f


def test_sdf_to_voxelgrids_reference_example():
    out = kt.ops.conversions.sdf_to_voxelgrids([_sphere(0.5)], init_res=4,
                                               device='cpu')
    ref = kal.ops.conversions.sdf_to_voxelgrids(
        [lambda p: jnp.sum(p ** 2, 1) ** 0.5 - 0.5], init_res=4)
    assert out.dtype == torch.float32 and out.shape == (1, 5, 5, 5)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert int(out.sum()) == 33


def test_sdf_to_voxelgrids_upsampling_matches_dense():
    refined = kt.ops.conversions.sdf_to_voxelgrids(
        [_sphere(0.4), _sphere(0.3)], init_res=8, upsampling_steps=2,
        device='cpu')
    dense = kt.ops.conversions.sdf_to_voxelgrids(
        [_sphere(0.4), _sphere(0.3)], init_res=32, device='cpu')
    ref = kal.ops.conversions.sdf_to_voxelgrids(
        [lambda p: jnp.sum(p ** 2, 1) ** 0.5 - 0.4], init_res=8,
        upsampling_steps=2)
    assert refined.shape == (2, 33, 33, 33)
    assert torch.equal(refined, dense)
    np.testing.assert_array_equal(np.asarray(ref)[0], refined[0].numpy())
    with pytest.raises(TypeError):
        kt.ops.conversions.sdf_to_voxelgrids(_sphere(0.4), device='cpu')
