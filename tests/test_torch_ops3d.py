"""The port's small 3D ops against ``kaolin_tpu`` on the CPU:
``ops/coords.py``, ``ops/random.py``, ``ops/gcn.py`` and
``ops/mesh/subdivision.py``.

The same seeded numpy inputs go to both packages, at float64 and float32.
Tolerances, relative to the largest entry: 1e-12 at float64 and 2e-6 at
float32 (values), gradients against ``jax.grad`` 1e-11 and 2e-5 (the
sparse and dense products and the neighbour sums add in other orders).
Subdivision faces must be equal, also on a mesh with boundary edges.
``GraphConv`` runs with the JAX layer's weights carried across
(``utils.interop.load_params``). The random generators are held to their
ranges and to determinism: a ``torch.Generator`` draws other values than
a JAX key, but the numpy draws (``random_shape_per_tensor``,
``random_spc_octrees`` without a key) equal the JAX package's after both
are seeded alike.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import sparse as jsparse

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

TOL = {np.float64: 1e-12, np.float32: 2e-6}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}
GRAD_TOL = {np.float64: 1e-11, np.float32: 2e-5}
DTYPES = (np.float64, np.float32)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ref, out, tol):
    ref = np.asarray(ref, np.float64)
    out = out.detach().to_dense().numpy().astype(np.float64)
    assert ref.shape == out.shape
    scale = max(1., float(np.abs(ref).max(initial=0.)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize('dtype', DTYPES)
def test_coords(dtype):
    rng = np.random.default_rng(0)
    az, el, d = (rng.uniform(-3, 3, (4, 5)).astype(dtype),
                 rng.uniform(-1.5, 1.5, (4, 5)).astype(dtype),
                 rng.uniform(0.5, 3, (4, 5)).astype(dtype))
    for dist in (None, d):
        ref = kal.ops.spherical2cartesian(
            jnp.asarray(az), jnp.asarray(el),
            None if dist is None else jnp.asarray(dist))
        out = kt.ops.spherical2cartesian(
            torch.tensor(az), torch.tensor(el),
            None if dist is None else torch.tensor(dist))
        for r, o in zip(ref, out):
            _close(r, o, TOL[dtype])
    xyz = [rng.normal(size=(6,)).astype(dtype) for _ in range(3)]
    for r, o in zip(kal.ops.cartesian2spherical(*map(jnp.asarray, xyz)),
                    kt.ops.cartesian2spherical(*map(torch.tensor, xyz))):
        _close(r, o, TOL[dtype])


def test_random_seeding_and_numpy_draws():
    jr, tr = kal.ops.random, kt.ops.random
    jr.manual_seed(3)
    tr.manual_seed(3)
    np.testing.assert_array_equal(
        jr.random_shape_per_tensor(5, [2, 1], [7, 9]),
        tr.random_shape_per_tensor(5, [2, 1], [7, 9]))
    ref, ref_len = jr.random_spc_octrees(3, 4)
    out, out_len = tr.random_spc_octrees(3, 4, device='cpu')
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    np.testing.assert_array_equal(ref_len, out_len)
    # get_state / set_state replay both generators
    state = tr.get_state()
    a = tr.random_tensor(0., 1., (5,), device='cpu')
    s = tr.random_shape_per_tensor(2, None, [4, 4])
    tr.set_state(state)
    assert torch.equal(a, tr.random_tensor(0., 1., (5,), device='cpu'))
    np.testing.assert_array_equal(s, tr.random_shape_per_tensor(2, None,
                                                                [4, 4]))
    tr.manual_seed(3)
    b = tr.random_tensor(0., 1., (5,), device='cpu')
    tr.manual_seed(3)
    assert torch.equal(b, tr.random_tensor(0., 1., (5,), device='cpu'))
    with pytest.raises(ValueError):
        tr.random_shape_per_tensor(2)


def test_random_ranges_and_octrees():
    tr = kt.ops.random
    key = tr.get_key()
    assert isinstance(key, torch.Generator)
    for dtype, low, high in ((torch.float32, -2., 3.), (torch.float64, 0., 1.),
                             (torch.int64, -3, 4), (torch.int16, 0, 1),
                             (torch.bool, 0, 1)):
        t = tr.random_tensor(low, high, (400,), dtype, key=key, device='cpu')
        assert t.dtype == dtype and t.shape == (400,)
        if dtype != torch.bool:
            assert t.min() >= low and t.max() <= high
        if not dtype.is_floating_point:
            assert len(torch.unique(t)) == int(high) - int(low) + 1
    az, el = tr.sample_spherical_coords((300,), elevation_low=-0.5,
                                        key=key, device='cpu')
    assert (az >= 0).all() and (az < 2 * np.pi).all()
    assert (el >= -0.5).all() and (el <= np.pi / 2).all()
    octrees, lengths = tr.random_spc_octrees(
        4, 5, key=torch.Generator().manual_seed(7), device='cpu')
    again, _ = tr.random_spc_octrees(
        4, 5, key=torch.Generator().manual_seed(7), device='cpu')
    assert torch.equal(octrees, again) and octrees.dtype == torch.uint8
    # valid octrees: every byte nonzero, the scan finds 5 levels each, and
    # the bytes of each level are the set bits of the one above
    assert (octrees > 0).all() and lengths.sum() == octrees.shape[0]
    max_level, pyramids, _ = kt.ops.spc.scan_octrees(octrees, lengths)
    assert max_level == 5
    np.testing.assert_array_equal(pyramids[:, 1, 5], lengths)
    kt.ops.spc.generate_points(octrees, pyramids,
                               kt.ops.spc.scan_octrees(octrees, lengths)[2])


def _adjacency(num_vertices, faces, dtype):
    idx, val = kt.ops.mesh.adjacency_matrix(num_vertices, torch.tensor(faces),
                                            sparse=True)
    dtype = TORCH[dtype]
    val = torch.rand(val.shape, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64).to(dtype) + 0.5
    eye = torch.arange(num_vertices)
    idx = torch.cat([idx, torch.stack([eye, eye])], 1)
    val = torch.cat([val, torch.ones(num_vertices, dtype=dtype)])
    sparse = torch.sparse_coo_tensor(idx, val, (num_vertices,) * 2)
    dense = sparse.to_dense()
    jsp = jsparse.BCOO((jnp.asarray(val.numpy()), jnp.asarray(idx.T.numpy())),
                       shape=(num_vertices,) * 2)
    return sparse, dense, jsp, jnp.asarray(dense.numpy())


@pytest.mark.parametrize('dtype', DTYPES)
def test_sparse_bmm_and_normalize(dtype):
    v, f = kt.utils.interop.icosphere(1)
    sparse, dense, jsp, jdense = _adjacency(v.shape[0], f, dtype)
    x = np.random.default_rng(2).normal(size=(3, v.shape[0], 5)).astype(dtype)
    ref = kal.ops.gcn.sparse_bmm(jsp, jnp.asarray(x))
    for adj in (sparse, dense):
        _close(ref, kt.ops.gcn.sparse_bmm(adj, torch.tensor(x)), TOL[dtype])
    ref = kal.ops.gcn.normalize_adj(jsp).todense()
    out = kt.ops.gcn.normalize_adj(sparse)
    assert out.is_sparse
    _close(ref, out, TOL[dtype])
    _close(kal.ops.gcn.normalize_adj(jdense),
           kt.ops.gcn.normalize_adj(dense), TOL[dtype])
    _close(np.ones(v.shape[0]), out.to_dense().sum(1), 10 * TOL[dtype])


@pytest.mark.parametrize('self_layer,bias,dtype', [
    (True, True, np.float64), (True, True, np.float32),
    (False, True, np.float64), (True, False, np.float32)])
def test_graph_conv_with_jax_weights(dtype, self_layer, bias):
    v, f = kt.utils.interop.icosphere(1)
    sparse, dense, jsp, jdense = _adjacency(v.shape[0], f, dtype)
    jlayer = kal.ops.gcn.GraphConv(6, 4, self_layer=self_layer, bias=bias)
    params = jlayer.init(jax.random.PRNGKey(1), jnp.dtype(dtype))
    params = {k: np.asarray(p) + (0.1 if k.startswith('bias') else 0.)
              for k, p in params.items()}
    layer = kt.utils.interop.load_params(
        kt.ops.gcn.GraphConv(6, 4, self_layer=self_layer, bias=bias,
                             dtype=TORCH[dtype], device='cpu'), params)
    x = np.random.default_rng(3).normal(size=(2, v.shape[0], 6)).astype(dtype)
    cot = np.random.default_rng(4).normal(size=(2, v.shape[0], 4)).astype(
        dtype)
    for jadj, adj in ((jsp, sparse), (jdense, dense)):
        def loss(p, x):
            y = jlayer.apply(p, x, jadj)
            return jnp.sum(y * cot), y
        (gp, gx), ref = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(p) for k, p in params.items()}, jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        layer.zero_grad()
        out = layer(tx, adj)
        _close(ref, out, TOL[dtype])
        (out * torch.tensor(cot)).sum().backward()
        _close(gx, tx.grad, GRAD_TOL[dtype])
        for name, p in layer.named_parameters():
            _close(gp[name], p.grad, GRAD_TOL[dtype])


def test_graph_conv_init():
    a, b = [kt.ops.gcn.GraphConv(192, 192, generator=torch.Generator()
                                 .manual_seed(5), device='cpu')
            for _ in range(2)]
    assert [n for n, _ in a.named_parameters()] == [
        'weight', 'bias', 'weight_self', 'bias_self']
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, a.weight_self)
    assert a.weight.abs().max() <= 1. / np.sqrt(192) and not a.bias.any()


def _open_grid(n=4):
    """A flat (n x n)-vertex grid of triangles: its outer edges are
    boundary edges."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    v = np.stack([ii, jj, 0.3 * np.sin(ii + jj)], -1).reshape(-1, 3)
    q = (ii[:-1, :-1] * n + jj[:-1, :-1]).reshape(-1)
    f = np.concatenate([np.stack([q, q + n, q + 1], -1),
                        np.stack([q + 1, q + n, q + n + 1], -1)])
    return v, f


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mesh', ['sphere', 'open'])
def test_subdivision(dtype, mesh):
    v, f = kt.utils.interop.icosphere(1) if mesh == 'sphere' else _open_grid()
    rng = np.random.default_rng(6)
    verts = (v + 0.05 * rng.normal(size=v.shape))[None].astype(dtype)
    alpha = rng.uniform(0., 1., (1, v.shape[0])).astype(dtype)
    for a, its in ((None, (1,)), (alpha, (1, 2))):
        for it in its:
            # compiled whole: the topology is numpy on the faces
            rv, rf = jax.jit(lambda x, *a: kal.ops.mesh.subdivide_trianglemesh(
                x, f, it, *a))(jnp.asarray(verts),
                               *([] if a is None else [jnp.asarray(a)]))
            ov, of = kt.ops.mesh.subdivide_trianglemesh(
                torch.tensor(verts), torch.tensor(f), it,
                None if a is None else torch.tensor(a))
            assert of.shape == (f.shape[0] * 4 ** it, 3)
            np.testing.assert_array_equal(np.asarray(rf), of.numpy())
            _close(rv, ov, TOL[dtype])
    cot = rng.normal(size=(1, np.asarray(rv).shape[1], 3)).astype(dtype)
    gv, ga = jax.jit(jax.grad(lambda x, a: jnp.sum(
        kal.ops.mesh.subdivide_trianglemesh(x, f, 2, a)[0] * cot),
        argnums=(0, 1)))(jnp.asarray(verts), jnp.asarray(alpha))
    tx = torch.tensor(verts, requires_grad=True)
    ta = torch.tensor(alpha, requires_grad=True)
    (kt.ops.mesh.subdivide_trianglemesh(tx, torch.tensor(f), 2, ta)[0]
     * torch.tensor(cot)).sum().backward()
    _close(gv, tx.grad, GRAD_TOL[dtype])
    _close(ga, ta.grad, GRAD_TOL[dtype])


def test_subdivision_batch_without_alpha():
    """At batch 2 without alpha the port subdivides each mesh as
    ``kaolin_tpu`` does one at a time (``kaolin_tpu`` raises on the
    batch: its alpha of batch 1 meets the batch's reshape)."""
    v, f = kt.utils.interop.icosphere(1)
    verts = np.stack([v, 1.5 * v + 0.2]).astype(np.float64)
    ov, of = kt.ops.mesh.subdivide_trianglemesh(torch.tensor(verts),
                                                torch.tensor(f), 1)
    ref = jax.jit(lambda x: kal.ops.mesh.subdivide_trianglemesh(x, f, 1))
    for b in range(2):
        rv, rf = ref(jnp.asarray(verts[b:b + 1]))
        _close(rv[0], ov[b], TOL[np.float64])
        np.testing.assert_array_equal(np.asarray(rf), of.numpy())
