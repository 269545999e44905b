"""The port's tetrahedral-mesh modules against ``kaolin_tpu`` on the CPU:
``tetrahedron_volume``, ``equivolume`` and ``amips`` with their gradients,
``inverse_vertices_offset``, ``subdivide_tetmesh``, ``marching_tetrahedra``
(vertices, faces, ``tet_idx``), ``marching_tetrahedra_fixed`` and
``tet_grid``.

The same seeded numpy inputs go to both packages. Integer outputs must be
equal; floats within 1e-10 relative at float64 and 1e-5 at float32 (the
XLA CPU backend fuses products into sums, the port does not). The 3x3
inverses and determinants come from each library's own LU routines, which
round in other orders: the inverse and AMIPS are held within 100 times
those tolerances. Gradients within 1e-9 and 1e-4 of the largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

TOL = {np.float64: 1e-10, np.float32: 1e-5}
GRAD_TOL = {np.float64: 1e-9, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


def _tets(dtype, batch=2, num=40, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((batch, num, 1, 3))
    return (base + 0.3 * rng.random((batch, num, 4, 3))).astype(dtype)


def _close(ref, out, dtype):
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _grad_close(ref, out, dtype):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(ref, out.numpy(), rtol=GRAD_TOL[dtype],
                               atol=GRAD_TOL[dtype] * scale)


@pytest.mark.parametrize('dtype', DTYPES)
def test_tetrahedron_volume(dtype):
    tv = _tets(dtype)
    _close(kal.metrics.tetmesh.tetrahedron_volume(jnp.asarray(tv)),
           kt.metrics.tetmesh.tetrahedron_volume(torch.tensor(tv)), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('given_mean', [False, True])
def test_equivolume_and_gradient(dtype, given_mean):
    tv = _tets(dtype, batch=1)
    kw_j = dict(tetrahedrons_mean=jnp.asarray([0.004], dtype)) \
        if given_mean else {}
    kw_t = dict(tetrahedrons_mean=torch.tensor([0.004], dtype=torch.float64
                                               if dtype == np.float64
                                               else torch.float32)) \
        if given_mean else {}
    for pow_ in (2, 4):
        ref = kal.metrics.tetmesh.equivolume(jnp.asarray(tv), pow=pow_,
                                             **kw_j)
        x = torch.tensor(tv, requires_grad=True)
        out = kt.metrics.tetmesh.equivolume(x, pow=pow_, **kw_t)
        assert tuple(out.shape) == ref.shape == (1, 1)
        _close(ref, out, dtype)
        g_ref = jax.grad(lambda v: kal.metrics.tetmesh.equivolume(
            v, pow=pow_, **kw_j).sum())(jnp.asarray(tv))
        g, = torch.autograd.grad(out.sum(), [x])
        _grad_close(g_ref, g, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_amips_and_gradient(dtype):
    tv = _tets(dtype, seed=1)
    rest = _tets(dtype, seed=2)
    inv_ref = kal.ops.mesh.inverse_vertices_offset(jnp.asarray(rest))
    inv = kt.ops.mesh.inverse_vertices_offset(torch.tensor(rest))
    np.testing.assert_allclose(np.asarray(inv_ref), inv.numpy(),
                               rtol=100 * TOL[dtype],
                               atol=100 * TOL[dtype] * float(inv.abs().max()))
    inv_np = np.asarray(inv_ref)
    ref = kal.metrics.tetmesh.amips(jnp.asarray(tv), jnp.asarray(inv_np))
    x = torch.tensor(tv, requires_grad=True)
    out = kt.metrics.tetmesh.amips(x, torch.tensor(inv_np))
    assert tuple(out.shape) == ref.shape == (2, 1)
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=100 * TOL[dtype])
    g_ref = jax.grad(lambda v: kal.metrics.tetmesh.amips(
        v, jnp.asarray(inv_np)).sum())(jnp.asarray(tv))
    g, = torch.autograd.grad(out.sum(), [x])
    _grad_close(g_ref, g, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('with_features', [False, True])
def test_subdivide_tetmesh(dtype, with_features):
    verts, tets = kal.ops.conversions.tet_grid(2)
    verts = np.stack([verts, verts * 1.5]).astype(dtype)
    feats = np.random.default_rng(3).random((2, verts.shape[1], 2)
                                            ).astype(dtype)
    args_j = (jnp.asarray(verts), tets) + ((jnp.asarray(feats),)
                                            if with_features else ())
    args_t = (torch.tensor(verts), torch.tensor(tets)) + (
        (torch.tensor(feats),) if with_features else ())
    ref = kal.ops.mesh.subdivide_tetmesh(*args_j)
    out = kt.ops.mesh.subdivide_tetmesh(*args_t)
    assert len(ref) == len(out) == (3 if with_features else 2)
    _close(ref[0], out[0], dtype)
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    if with_features:
        _close(ref[2], out[2], dtype)


def _sphere_sdf(verts, radius=0.3, centre=(0.02, -0.01, 0.03)):
    return np.linalg.norm(verts - np.asarray(centre), axis=-1) - radius


@pytest.mark.parametrize('res', [4, 7])
def test_tet_grid(res):
    for normalize in (True, False):
        ref = kal.ops.conversions.tet_grid(res, normalize=normalize)
        out = kt.ops.conversions.tet_grid(res, normalize=normalize)
        for r, o in zip(ref, out):
            assert r.dtype == o.dtype
            np.testing.assert_array_equal(r, o)


@pytest.mark.parametrize('dtype', DTYPES)
def test_marching_tetrahedra_and_gradient(dtype):
    verts, tets = kal.ops.conversions.tet_grid(8)
    verts = np.stack([verts, verts * 1.1 + 0.01]).astype(dtype)
    sdf = _sphere_sdf(verts).astype(dtype)
    ref = kal.ops.conversions.marching_tetrahedra(
        jnp.asarray(verts), tets, jnp.asarray(sdf), return_tet_idx=True)
    v = torch.tensor(verts, requires_grad=True)
    s = torch.tensor(sdf, requires_grad=True)
    out = kt.ops.conversions.marching_tetrahedra(v, torch.tensor(tets), s,
                                                 return_tet_idx=True)
    for b in range(2):
        _close(ref[0][b], out[0][b], dtype)
        np.testing.assert_array_equal(np.asarray(ref[1][b]),
                                      out[1][b].numpy())
        np.testing.assert_array_equal(np.asarray(ref[2][b]),
                                      out[2][b].numpy())
        assert out[1][b].shape[0] > 100

    def loss_j(v, s):
        vs, _, _ = kal.ops.conversions.marching_tetrahedra(
            v, tets, s, return_tet_idx=True)
        return sum(jnp.sum(x ** 2) for x in vs)

    gv_ref, gs_ref = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(verts),
                                                     jnp.asarray(sdf))
    loss = sum(torch.sum(x ** 2) for x in out[0])
    gv, gs = torch.autograd.grad(loss, [v, s])
    _grad_close(gv_ref, gv, dtype)
    _grad_close(gs_ref, gs, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_marching_tetrahedra_fixed(dtype):
    verts, tets = kal.ops.conversions.tet_grid(6)
    verts = verts.astype(dtype)
    sdf = _sphere_sdf(verts).astype(dtype)
    ref = kal.ops.conversions.marching_tetrahedra_fixed(
        jnp.asarray(verts), tets, jnp.asarray(sdf))
    v = torch.tensor(verts, requires_grad=True)
    out = kt.ops.conversions.marching_tetrahedra_fixed(v, tets,
                                                       torch.tensor(sdf))
    _close(ref[0], out[0], dtype)
    for r, o in zip(ref[1:], out[1:]):
        assert o.dtype == {np.dtype(bool): torch.bool,
                           np.dtype(np.int32): torch.int32}[r.dtype]
        np.testing.assert_array_equal(np.asarray(r), o.numpy())
    assert bool(out[1].any()) and bool(out[3].any())
    g_ref = jax.grad(lambda x: jnp.sum(kal.ops.conversions
                                       .marching_tetrahedra_fixed(
                                           x, tets, jnp.asarray(sdf))[0]
                                       ** 2))(jnp.asarray(verts))
    g, = torch.autograd.grad(torch.sum(out[0] ** 2), [v])
    _grad_close(g_ref, g, dtype)
