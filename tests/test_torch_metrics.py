"""The port's point-cloud and mesh metrics against ``kaolin_tpu`` on the
CPU: nearest-neighbour selection (the plain version, the pruned prepass),
``sided_distance``, ``chamfer_distance``, ``f_score``,
``point_to_mesh_distance`` and config 3's step and mesh fit, in value and
gradient.

The same seeded numpy inputs go to both packages. Indices and types must be
equal. Floats: float64 to 1e-10; float32 to 1e-5 relative (the XLA CPU
backend fuses products into sums, ``fma``, where the port does not, so the
last bits of a distance may differ). That fusion can also flip a choice
between two candidates whose float32 distances lie within an ulp; none of
the seeded float32 inputs below has such a pair.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt
from kaolin_tpu.kernels.nn_distance import (nearest_idx_pallas,
                                            nearest_idx_pruned as jax_pruned)
from kaolin_tpu.kernels.p2m_distance import p2m_select_pallas
from kaolin_tpu.metrics.pointcloud import _nearest_idx
from kaolin_tpu.metrics.trianglemesh import _select_faces
from kaolin_tpu_torch.kernels import nn_distance as kn
from kaolin_tpu_torch.kernels import p2m_distance as kp

TOL = {np.float64: 1e-10, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def _close(ref, out, dtype, scale=1.):
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype] * scale)


def _t(*arrays):
    return kt.utils.interop.pointclouds_from_numpy(*arrays, device='cpu')


def _j(*arrays):
    out = tuple(jnp.asarray(a) for a in arrays)
    return out[0] if len(out) == 1 else out


# ---------------------------------------------------------------- selection

@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n1,n2', [(100, 77), (513, 1025), (2048, 300)])
def test_nearest_idx_plain_matches_xla(dtype, n1, n2):
    rng = np.random.default_rng(3)
    p1 = rng.random((2, n1, 3)).astype(dtype)
    p2 = rng.random((2, n2, 3)).astype(dtype)
    out = kn.nearest_idx_plain(*_t(p1, p2))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(_nearest_idx(*_j(p1, p2))),
                                  out.numpy())
    # the wrappers take the plain version on the CPU
    assert torch.equal(kn.nearest_idx(*_t(p1, p2)), out)
    assert torch.equal(kn.nearest_idx_pruned(*_t(p1, p2)), out)


@pytest.mark.parametrize('dtype', DTYPES)
def test_nearest_idx_plain_duplicate_ties(dtype):
    """Duplicated reference points: ties keep the lowest index."""
    rng = np.random.default_rng(4)
    base = rng.random((1, 40, 3)).astype(dtype)
    p2 = np.concatenate([base, base[:, ::-1], base], axis=1)
    p1 = np.concatenate([base + 1e-3 * rng.standard_normal(base.shape)
                         .astype(dtype), base[:, ::3]], axis=1)
    out = kn.nearest_idx_plain(*_t(p1, p2))
    np.testing.assert_array_equal(np.asarray(_nearest_idx(*_j(p1, p2))),
                                  out.numpy())
    assert int(out[0, 40:].max()) < 40


def test_nearest_idx_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    p1 = rng.random((1, 150, 3)).astype(np.float32)
    p2 = rng.random((1, 1100, 3)).astype(np.float32)
    ref = nearest_idx_pallas(*_j(p1, p2), interpret=True)
    np.testing.assert_array_equal(np.asarray(ref),
                                  kn.nearest_idx_plain(*_t(p1, p2)).numpy())


def test_nearest_idx_pruned_matches_pallas_interpret():
    rng = np.random.default_rng(10)
    p1 = rng.random((1, 600, 3)).astype(np.float32)
    p2 = rng.random((1, 1500, 3)).astype(np.float32)
    ref = jax_pruned(*_j(p1, p2), interpret=True)
    np.testing.assert_array_equal(np.asarray(ref),
                                  kn.nearest_idx_plain(*_t(p1, p2)).numpy())


def _cloud(kind, n, rng):
    if kind == 'uniform':
        return rng.random((1, n, 3))
    if kind == 'clusters':
        pts = rng.random((1, n, 3)) * 0.1
        pts[:, n // 2:] += 5.
        return pts
    s = rng.standard_normal((1, n, 3))
    return s / np.linalg.norm(s, axis=-1, keepdims=True)


def _gap2(q, lo, hi):
    """The pruned kernel's squared gap from points ``q`` to boxes [lo, hi],
    formed as its distance is (float32)."""
    g = torch.maximum(torch.maximum(lo - q, q - hi), torch.zeros_like(q))
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
        + g[..., 2] * g[..., 2]


def _outward(d):
    """The visit rank of an offset d from a start: 0, -1, +1, -2, ... ->
    0, 1, 2, 3, ..."""
    return torch.where(d >= 0, 2 * d, -2 * d - 1)


def _key_range(pts, best, frame):
    """(C1,) int64 bounds [key(L), key(H)] of each tile's walk: the sort
    keys (as references) of the corners of the tile's query box grown by
    h, the least float with h*h above the tile's largest best, each corner
    one float further out; the whole key range where that best is inf."""
    worst = best.amax(dim=1)
    fin = worst < float('inf')
    h = torch.where(fin, worst, 0.).sqrt().clamp(min=1e-18)
    while True:
        low = ~(h * h > torch.where(fin, worst, 0.))
        if not bool(low.any()):
            break
        h = torch.where(low, torch.nextafter(h, torch.tensor(float('inf'))),
                        h)
    lo, span = frame[:, 0:1, :3], frame[:, 1:2, :3]
    corner_l = torch.nextafter(pts.amin(dim=1) - h[:, None],
                               torch.tensor(float('-inf')))
    corner_h = torch.nextafter(pts.amax(dim=1) + h[:, None],
                               torch.tensor(float('inf')))
    klo = kn._keys(corner_l[None], lo, span, 1, 1)[0]
    khi = kn._keys(corner_h[None], lo, span, 1, 1)[0]
    return (torch.where(fin, klo, -(1 << 31)),
            torch.where(fin, khi, (1 << 31) - 1))


def _scan_plain(skeys, qrec, rrec, rbox, frame, n1, n2):
    """The pruned kernel's scan of one batch entry, written out: each tile
    of TQ sorted queries finds its middle query's place c0 among the
    sorted references and visits the chunks 0, -1, +1, -2, ... away from
    c0's; it scans a chunk unless every query's gap to its box exceeds the
    query's best distance so far (the kernel's test against the tile's box
    skips nothing more) or the chunk's keys (its box's w) all lie outside
    the tile's :func:`_key_range` (where the kernel's walk ends), and
    keeps the
    smallest (distance, original index). Returns (indices in the original
    order, chunks scanned, chunks the key range skipped)."""
    C1, C2 = qrec.shape[1] // kn.TQ, rbox.shape[1]
    q = qrec[0].reshape(C1, kn.TQ, 4)
    pts = q[..., :3]
    refs = rrec[0].reshape(C2, kn.CH, 4)
    rorig = refs[..., 3].contiguous().view(torch.int32).long()
    sb = kn._key_bits(1)[0]
    mid = (torch.arange(C1) * kn.TQ + kn.TQ // 2).clamp(max=n1 - 1)
    target = skeys[mid].long() + (1 << (32 - sb))
    c0 = (torch.searchsorted(skeys[n1:n1 + n2].long(), target)
          // kn.CH).clamp(max=C2 - 1)[:, None]
    order = torch.argsort(_outward(torch.arange(C2)[None] - c0), dim=1)
    best = torch.full((C1, kn.TQ), float('inf'))
    bo = torch.full((C1, kn.TQ), kn._PAD_ORIG, dtype=torch.long)
    scanned = beyond = 0
    for v in range(C2):
        c = order[:, v]
        box = rbox[0, c, :, :3]
        gap = _gap2(pts, box[:, None, 0], box[:, None, 1])
        klo, khi = _key_range(pts, best, frame)
        first, last = rbox[0, c, :, 3].contiguous().view(torch.int32).unbind(1)
        out_of_range = (first > khi) | (last < klo)
        need = (~(gap > best)).any(dim=1) & ~out_of_range
        beyond += int(out_of_range.sum())
        d = kn._sq_dist(pts[:, :, None], refs[c][:, None, :, :3])
        dmin = d.amin(dim=-1)
        o = torch.where(d == dmin[..., None], rorig[c][:, None],
                        torch.iinfo(torch.int64).max).amin(dim=-1)
        take = need[:, None] & ((dmin < best) | ((dmin == best) & (o < bo)))
        best = torch.where(take, dmin, best)
        bo = torch.where(take, o, bo)
        scanned += int(need.sum())
    out = torch.zeros(n1, dtype=torch.int32)
    qorig = q[..., 3].contiguous().view(torch.int32).long()
    real = qorig < n1
    win = torch.where((best < float('inf')) & (bo < n2), bo, 0)
    out[qorig[real]] = win[real].to(torch.int32)
    return out, scanned, beyond


@pytest.mark.parametrize('kind', ['uniform', 'clusters', 'sphere'])
def test_pruned_prepass_covers_every_winner(kind):
    """The prepass's chunk boxes never rule out the chunk of a query's
    brute-force winner or of any reference tied with it: the kernel's gap
    from the query, and from its tile's box, to that chunk's box is at most
    the winning distance. The scan over them gives brute force's indices
    and skips chunks, some of them by the sort-key range where the
    kernel's walk ends."""
    rng = np.random.default_rng(11)
    n1, n2 = 2000, 17000
    p1 = _cloud(kind, n1, rng).astype(np.float32)
    p2 = _cloud(kind, n2, rng).astype(np.float32)
    p2[:, n2 - 1000:] = p2[:, :1000]            # exact duplicates
    t1, t2 = _t(p1, p2)
    brute = kn.nearest_idx_plain(t1, t2)[0].long()
    skeys, order, qrec, rrec, rbox, frame = kn.prepass(t1, t2)
    pos1 = torch.empty(n1, dtype=torch.long)
    pos1[order[:n1]] = torch.arange(n1)
    pos2 = torch.empty(n2, dtype=torch.long)
    pos2[order[n1:] - n1] = torch.arange(n2)
    d = kn._sq_dist(t1[0, :, None], t2[0, None])
    win = d.gather(1, brute[:, None])
    tied = d == win
    qi, ri = tied.nonzero(as_tuple=True)
    box = rbox[0, pos2[ri] // kn.CH, :, :3]
    gap = _gap2(t1[0, qi], box[:, 0], box[:, 1])
    assert bool((gap <= win[qi, 0]).all())
    tiles = qrec[0, :, :3].reshape(-1, kn.TQ, 3)
    tile = pos1[qi] // kn.TQ
    tgap = torch.maximum(torch.maximum(box[:, 0] - tiles.amax(dim=1)[tile],
                                       tiles.amin(dim=1)[tile] - box[:, 1]),
                         torch.zeros(()))
    tgap = (tgap[..., 0] * tgap[..., 0] + tgap[..., 1] * tgap[..., 1]) \
        + tgap[..., 2] * tgap[..., 2]
    assert bool((tgap <= gap).all())
    assert int(tied.sum()) > n1                      # the duplicates tie
    scan, scanned, beyond = _scan_plain(skeys, qrec, rrec, rbox, frame, n1,
                                        n2)
    assert torch.equal(scan, brute.to(torch.int32))
    assert scanned < tiles.shape[0] * rbox.shape[1]
    assert beyond > 0


# ------------------------------------------------- sided, chamfer, f-score

@pytest.fixture
def clouds():
    rng = np.random.default_rng(0)
    return rng.normal(size=(2, 57, 3)), rng.normal(size=(2, 83, 3))


@pytest.mark.parametrize('dtype', DTYPES)
def test_sided_distance(clouds, dtype):
    p1, p2 = (c.astype(dtype) for c in clouds)
    rd, ri = kal.metrics.pointcloud.sided_distance(*_j(p1, p2))
    od, oi = kt.metrics.pointcloud.sided_distance(*_t(p1, p2))
    np.testing.assert_array_equal(np.asarray(ri), oi.numpy())
    _close(rd, od, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kw', [{}, {'w1': 0.3, 'w2': 2.}, {'squared': False}])
def test_chamfer_distance(clouds, dtype, kw):
    p1, p2 = (c.astype(dtype) for c in clouds)
    ref = kal.metrics.pointcloud.chamfer_distance(*_j(p1, p2), **kw)
    out = kt.metrics.pointcloud.chamfer_distance(*_t(p1, p2), **kw)
    assert out.shape == (2,)
    _close(ref, out, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('radius', [0.5, 1.0])
def test_f_score(clouds, dtype, radius):
    p1, p2 = (c.astype(dtype) for c in clouds)
    ref = kal.metrics.pointcloud.f_score(*_j(p1, p2), radius=radius)
    out = kt.metrics.pointcloud.f_score(*_t(p1, p2), radius=radius)
    _close(ref, out, dtype)


def test_metrics_with_duplicates():
    rng = np.random.default_rng(12)
    base = rng.random((1, 30, 3))
    p1 = np.concatenate([base, base], axis=1)
    p2 = np.concatenate([base[:, ::-1], base + 0.01], axis=1)
    for fn in ('sided_distance', 'chamfer_distance', 'f_score'):
        ref = getattr(kal.metrics.pointcloud, fn)(*_j(p1, p2))
        out = getattr(kt.metrics.pointcloud, fn)(*_t(p1, p2))
        for r, o in zip(*((ref, out) if isinstance(ref, tuple)
                          else ((ref,), (out,)))):
            np.testing.assert_allclose(np.asarray(r), o.numpy(), rtol=1e-10,
                                       atol=1e-12)


def test_reference_examples():
    """kaolin's documented examples, as ``tests/test_metrics.py`` holds
    the JAX package to them."""
    pc = kt.metrics.pointcloud
    p1, p2 = _t(np.array([[[5.9336, 4.9742, 8.1047]],
                          [[4.1939, 3.3612, 9.5407]]], np.float32),
                np.array([[[1.6998, 0.7719, 2.9987],
                           [0.1812, 8.9342, 10.0285]],
                          [[10.0184, 0.3928, 5.2545],
                           [4.2934, 11.2127, 4.5247]]], np.float32))
    dist, idx = pc.sided_distance(p1, p2)
    np.testing.assert_allclose(dist.numpy(), [[52.4727], [61.1077]],
                               rtol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), [[1], [0]])
    a = np.array([[[8.8977, 4.1709, 1.2839], [8.5640, 7.7767, 9.4214]],
                  [[0.5431, 6.4495, 11.4914], [3.2126, 8.0865, 3.1018]]],
                 np.float32)
    b = np.array([[[6.9340, 6.1152, 3.4435], [0.1032, 9.8181, 11.3350]],
                  [[11.4006, 2.2154, 7.9589], [4.2586, 1.4133, 7.2606]]],
                 np.float32)
    np.testing.assert_allclose(pc.chamfer_distance(*_t(a, b)).numpy(),
                               [72.5838, 151.0809], rtol=1e-4)
    c = np.array([[[9.4863, 4.2249, 0.1712], [8.1783, 8.5310, 8.5119]],
                  [[-0.0020699, 6.4429, 12.3], [3.8386, 8.3585, 4.7662]]],
                 np.float32)
    np.testing.assert_allclose(pc.f_score(*_t(a, c), radius=1).numpy(),
                               [0., 0.5], atol=1e-5)
    np.testing.assert_allclose(pc.f_score(*_t(a, c), radius=1.5).numpy(),
                               [1., 0.5], atol=1e-5)
    pts, tri = _t(np.array([[[0.25, 0.25, 1.0]]], np.float32),
                  np.array([[[[0., 0., 0.], [1., 0., 0.], [0., 1., 0.]]]],
                           np.float32))
    d, i, t = kt.metrics.trianglemesh.point_to_mesh_distance(pts, tri)
    assert (float(d[0, 0]), int(i[0, 0]), int(t[0, 0])) == (1.0, 0, 0)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('squared', [True, False])
def test_chamfer_gradients(clouds, dtype, squared):
    p1, p2 = (c.astype(dtype) for c in clouds)
    w = np.linspace(0.5, 1.5, 2).astype(dtype)

    def loss(a, b):
        return jnp.sum(jnp.asarray(w) * kal.metrics.pointcloud
                       .chamfer_distance(a, b, squared=squared))

    g1, g2 = jax.grad(loss, argnums=(0, 1))(*_j(p1, p2))
    a, b = (x.requires_grad_(True) for x in _t(p1, p2))
    (torch.tensor(w) * kt.metrics.pointcloud.chamfer_distance(
        a, b, squared=squared)).sum().backward()
    _close(g1, a.grad, dtype)
    _close(g2, b.grad, dtype)


# ------------------------------------------------------------ point to mesh

def _grid_mesh():
    g = np.mgrid[0:5, 0:5].reshape(2, -1).T.astype(np.float32)
    verts = np.concatenate([g, np.zeros((25, 1), np.float32)], 1)
    quads = np.array([[i * 5 + j, i * 5 + j + 1, (i + 1) * 5 + j,
                       (i + 1) * 5 + j + 1]
                      for i in range(4) for j in range(4)])
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]])
    return verts, verts[faces]


def _p2m_case(case, dtype):
    rng = np.random.default_rng(5)
    if case == 'random':
        return (rng.random((2, 333, 3)).astype(dtype),
                rng.random((2, 207, 3, 3)).astype(dtype))
    if case == 'grid':
        # points above the vertices and edge midpoints tie exactly; at
        # float64 random probes too. At float32 a probe can sit within an
        # ulp of two faces (one 7.5e-4 from a shared edge: 15.8286428 and
        # 15.8286419), which XLA's fused products rank the other way.
        verts, fv = _grid_mesh()
        mid = verts[:-1] * 0.5 + verts[1:] * 0.5 + [0, 0, 2]
        pts = [verts + [0, 0, 1], mid]
        if dtype == np.float64:
            pts.append(rng.random((400, 3)) * 6 - 1)
        return np.concatenate(pts)[None].astype(dtype), fv[None].astype(dtype)
    pts = rng.random((2, 150, 3)).astype(dtype)
    fv = rng.random((2, 40, 3, 3)).astype(dtype)
    fv[0, 3] = fv[0, 3, :1]                              # a point
    fv[1, 0, 2] = 0.25 * fv[1, 0, 0] + 0.75 * fv[1, 0, 1]   # a segment
    return pts, fv


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['random', 'grid', 'degenerate'])
def test_point_to_mesh_distance(dtype, case):
    pts, fv = _p2m_case(case, dtype)
    rd, ri, rt = kal.metrics.trianglemesh.point_to_mesh_distance(
        *_j(pts, fv), backend='xla')
    od, oi, ot = kt.metrics.trianglemesh.point_to_mesh_distance(*_t(pts, fv))
    np.testing.assert_array_equal(np.asarray(ri), oi.numpy())
    np.testing.assert_array_equal(np.asarray(rt), ot.numpy())
    _close(rd, od, dtype)
    if case == 'grid':
        assert int(ot.max()) > 6
    assert ot.dtype == oi.dtype == torch.int32


def test_p2m_select_matches_pallas_interpret():
    """On the grid mesh, where ``tests/test_metrics.py`` shows the Pallas
    kernel equal to the XLA scan."""
    pts, fv = _p2m_case('grid', np.float32)
    ri, rt = p2m_select_pallas(*_j(pts, fv), interpret=True)
    oi, ot = kp.p2m_select_plain(*_t(pts, fv))
    np.testing.assert_array_equal(np.asarray(ri), oi.numpy())
    np.testing.assert_array_equal(np.asarray(rt), ot.numpy())


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['random', 'degenerate'])
def test_point_to_mesh_gradients(dtype, case):
    """Gradients to the points and the face vertices; where a degenerate
    face's unselected plane branch puts NaN into JAX's gradient, the port
    has the same NaN, and nowhere else."""
    pts, fv = _p2m_case(case, dtype)

    def loss(p, f):
        return jnp.sum(kal.metrics.trianglemesh.point_to_mesh_distance(
            p, f, backend='xla')[0] ** 1.5)

    gp, gf = jax.grad(loss, argnums=(0, 1))(*_j(pts, fv))
    p, f = (x.requires_grad_(True) for x in _t(pts, fv))
    (kt.metrics.trianglemesh.point_to_mesh_distance(p, f)[0] ** 1.5) \
        .sum().backward()
    for r, o in ((gp, p.grad), (gf, f.grad)):
        r, o = np.asarray(r), o.numpy()
        np.testing.assert_array_equal(np.isfinite(r), np.isfinite(o))
        if case == 'random':
            assert np.isfinite(o).all()
        ok = np.isfinite(r)
        np.testing.assert_allclose(r[ok], o[ok], rtol=TOL[dtype],
                                   atol=TOL[dtype])


# -------------------------------------------------------- config 3, small

def _jax_step(p, p2, fv):
    c = kal.metrics.pointcloud.chamfer_distance(p, p2)
    d, _, _ = kal.metrics.trianglemesh.point_to_mesh_distance(p, fv)
    return p + 1e-20 * (c[..., None, None] + jnp.mean(d))


def test_config3_step_small():
    """``bench_suite.py:196-199``'s step at 1 x 2,000 and 1 x 3,000 points
    with 500 faces: the chamfer and point-to-mesh values it folds in."""
    p1, p2, fv = kt.utils.interop.metrics_scene(n1=2000, n2=3000,
                                                num_faces=500, device='cpu')
    j1, j2, jf = _j(p1.numpy(), p2.numpy(), fv.numpy())
    _close(kal.metrics.pointcloud.chamfer_distance(j1, j2),
           kt.metrics.pointcloud.chamfer_distance(p1, p2), np.float32)
    rd, ri, rt = kal.metrics.trianglemesh.point_to_mesh_distance(j1, jf)
    od, oi, ot = kt.metrics.trianglemesh.point_to_mesh_distance(p1, fv)
    np.testing.assert_array_equal(np.asarray(ri), oi.numpy())
    np.testing.assert_array_equal(np.asarray(rt), ot.numpy())
    _close(rd, od, np.float32)
    out = kt.utils.interop.metrics_step(p1, p2, fv)
    assert out.shape == p1.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(_jax_step(j1, j2, jf)),
                                  out.numpy())


FIT_SUBDIV, FIT_TARGET, FIT_SAMPLES, FIT_LAP = 2, 2000, 1500, 0.1


def _jax_uniforms(key, batch, num_samples, dtype):
    """The uniforms ``kaolin_tpu``'s ``sample_points`` draws from ``key``:
    (face, barycentric u, barycentric v)."""
    k_face, k_bary = jax.random.split(key)
    k1, k2 = jax.random.split(k_bary)
    return (jax.random.uniform(k_face, (batch, num_samples), dtype=dtype),
            jax.random.uniform(k1, (batch, num_samples, 1), dtype=dtype),
            jax.random.uniform(k2, (batch, num_samples, 1), dtype=dtype))


def _fit_problem(dtype):
    verts, faces = kt.utils.interop.icosphere(FIT_SUBDIV)
    rng = np.random.default_rng(13)
    s = rng.standard_normal((1, FIT_TARGET, 3))
    target = (s / np.linalg.norm(s, axis=-1, keepdims=True)
              * [1.3, 0.75, 1.]).astype(dtype)
    return verts[None].astype(dtype), faces, target


def _jax_fit_loss(v, faces, target, key):
    pts = kal.ops.mesh.sample_points(v, faces, FIT_SAMPLES, key=key)[0]
    fv = kal.ops.mesh.index_vertices_by_faces(v, faces)
    cham = kal.metrics.pointcloud.chamfer_distance(pts, target)
    p2m = kal.metrics.trianglemesh.point_to_mesh_distance(target, fv)[0]
    lap = kal.metrics.trianglemesh.uniform_laplacian_smoothing(v, faces) - v
    lap = jnp.sum(lap * lap, axis=-1)
    return jnp.mean(cham + jnp.mean(p2m, axis=-1)
                    + FIT_LAP * jnp.mean(lap, axis=-1))


@pytest.mark.parametrize('dtype', DTYPES)
def test_config3_fit_loss_and_gradient(dtype):
    """The mesh fit's loss (icosphere subdivision 2, 2,000 target points,
    samples from JAX's own uniforms) and its gradient to the vertices,
    against ``jax.value_and_grad``."""
    verts, faces, target = _fit_problem(dtype)
    key = jax.random.PRNGKey(3)
    ref, gref = jax.value_and_grad(_jax_fit_loss)(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(target), key)
    uniforms = tuple(torch.tensor(np.asarray(u)) for u in
                     _jax_uniforms(key, 1, FIT_SAMPLES, dtype))
    v, f = kt.utils.interop.mesh_from_numpy(verts, faces, device='cpu')
    v.requires_grad_(True)
    loss = kt.utils.interop.mesh_fit_loss(v, f, _t(target), FIT_SAMPLES,
                                          FIT_LAP, uniforms=uniforms)
    loss.backward()
    _close(ref, loss, dtype)
    _close(gref, v.grad, dtype, scale=float(np.abs(gref).max()))
    assert float(v.grad.abs().max()) > 0.


def test_config3_fit_steps():
    """Three chained ``x - lr * g`` steps of the mesh fit, float64."""
    verts, faces, target = _fit_problem(np.float64)
    jv, jf, jt = jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(target)
    v, f = kt.utils.interop.mesh_from_numpy(verts, faces, device='cpu')
    tt = _t(target)
    lr = 0.05
    for step in range(3):
        key = jax.random.PRNGKey(20 + step)
        jv = jv - lr * jax.grad(_jax_fit_loss)(jv, jf, jt, key)
        uniforms = tuple(torch.tensor(np.asarray(u)) for u in
                         _jax_uniforms(key, 1, FIT_SAMPLES, np.float64))
        v = v.detach().requires_grad_(True)
        g, = torch.autograd.grad(kt.utils.interop.mesh_fit_loss(
            v, f, tt, FIT_SAMPLES, FIT_LAP, uniforms=uniforms), [v])
        v = v - lr * g
    _close(jv, v, np.float64)
