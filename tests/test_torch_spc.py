"""The port's SPC ops against ``kaolin_tpu`` on the CPU: the octree bytes,
``scan_octrees``, ``generate_points``, the Morton, corner and trilinear
ops, ``unbatched_query``, the dual hierarchy and trinkets, ``to_dense``,
``feature_grids_to_spc`` and the ``Spc`` container.

The same seeded numpy inputs go to both packages. Every integer output
must be equal; the trilinear coefficients and interpolation within 1e-12
at float64 and 1e-5 at float32 (the interpolation sums 8 products, which
the two libraries' matrix products add in other orders), their gradients
within 1e-9 and 1e-5 of the largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kaolin_tpu as kal
import kaolin_tpu_torch as kt

TOL = {np.float64: 1e-12, np.float32: 1e-5}
GRAD_TOL = {np.float64: 1e-9, np.float32: 1e-5}
js, ts = kal.ops.spc, kt.ops.spc


def _eq(ref, out):
    ref = np.asarray(ref)
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    assert ref.shape == out.shape
    np.testing.assert_array_equal(ref, out)


def _shell(level, n=3000, seed=0, radius=0.7):
    """Quantized points on a sphere shell (config 5's scene, smaller)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * radius).astype(np.float32)


def _both_spc(level, seed=0):
    pts = _shell(level, seed=seed)
    qj = js.quantize_points(jnp.asarray(pts), level)
    qt = ts.quantize_points(torch.tensor(pts), level)
    _eq(qj, qt)
    assert qt.dtype == torch.int16
    oj = js.unbatched_points_to_octree(qj, level)
    ot = ts.unbatched_points_to_octree(qt, level)
    _eq(oj, ot)
    assert ot.dtype == torch.uint8
    return oj, ot


@pytest.mark.parametrize('level', [1, 3, 6])
def test_octree_scan_and_points(level):
    oj, ot = _both_spc(level)
    lj, pyr_j, ex_j = js.scan_octrees(oj, np.array([oj.shape[0]]))
    lt, pyr_t, ex_t = ts.scan_octrees(ot, np.array([ot.shape[0]]))
    assert lj == lt == level
    _eq(pyr_j, pyr_t)
    _eq(ex_j, ex_t)
    assert ex_t.dtype == torch.int32
    ph_j = js.generate_points(oj, pyr_j, ex_j)
    ph_t = ts.generate_points(ot, pyr_t, ex_t)
    _eq(ph_j, ph_t)
    assert ph_t.dtype == torch.int16
    for lvl in range(level + 1):
        _eq(js.unbatched_get_level_points(ph_j, pyr_j[0], lvl),
            ts.unbatched_get_level_points(ph_t, pyr_t[0], lvl))


def test_batched_scan_and_points():
    """Three octrees of one depth, where both packages agree (on a batch
    of mixed depths ``kaolin_tpu``'s ``generate_points`` reads the wrong
    bytes; ``tests/test_torch_faults.py`` holds the port there)."""
    octs = [_both_spc(4, seed=seed) for seed in (2, 4, 3)]
    cat_j = jnp.concatenate([o[0] for o in octs])
    cat_t = torch.cat([o[1] for o in octs])
    lengths = np.array([o[1].shape[0] for o in octs])
    lj, pyr_j, ex_j = js.scan_octrees(cat_j, lengths)
    lt, pyr_t, ex_t = ts.scan_octrees(cat_t, lengths)
    assert lj == lt == 4
    _eq(pyr_j, pyr_t)
    _eq(ex_j, ex_t)
    _eq(js.generate_points(cat_j, pyr_j, ex_j),
        ts.generate_points(cat_t, pyr_t, ex_t))


def test_uint8_ops():
    vals = np.arange(256, dtype=np.uint8)
    bits_j = kal.ops.spc.uint8_to_bits(jnp.asarray(vals))
    bits_t = kt.ops.spc.uint8_to_bits(torch.tensor(vals))
    _eq(bits_j, bits_t)
    _eq(kal.ops.spc.uint8_bits_sum(jnp.asarray(vals)),
        kt.ops.spc.uint8_bits_sum(torch.tensor(vals)))
    _eq(kal.ops.spc.bits_to_uint8(bits_j), kt.ops.spc.bits_to_uint8(bits_t))


def test_morton_and_corners():
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 1024, (2, 500, 3)).astype(np.int16)
    mj = js.points_to_morton(jnp.asarray(pts))
    mt = ts.points_to_morton(torch.tensor(pts))
    _eq(mj, mt)
    assert mt.dtype == torch.int64
    _eq(js.morton_to_points(mj), ts.morton_to_points(mt))
    _eq(js.points_to_corners(jnp.asarray(pts)),
        ts.points_to_corners(torch.tensor(pts)))


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_trilinear(dtype):
    level = 4
    oj, ot = _both_spc(level)
    _, pyr, ex_j = js.scan_octrees(oj, np.array([oj.shape[0]]))
    ph_j = js.generate_points(oj, pyr, ex_j)
    phd_j, pyrd = js.unbatched_make_dual(ph_j, pyr[0])
    trk_j, _ = js.unbatched_make_trinkets(ph_j, pyr[0], phd_j, pyrd)
    ot_, ph_t, _, ex_t = kt.utils.interop.spc_from_numpy(
        oj, ph_j, pyr[0], ex_j, device='cpu')
    phd_t, _ = ts.unbatched_make_dual(ph_t, pyr[0])
    trk_t, _ = ts.unbatched_make_trinkets(ph_t, pyr[0], phd_t, pyrd)
    rng = np.random.default_rng(2)
    coords = rng.uniform(-0.9, 0.9, (300, 4, 3)).astype(dtype)
    pidx_j = js.unbatched_query(oj, ex_j, jnp.asarray(coords[:, 0]), level)
    pidx_t = ts.unbatched_query(ot_, ex_t, torch.tensor(coords[:, 0]), level)
    _eq(pidx_j, pidx_t)
    assert int((pidx_t >= 0).sum()) > 10
    vox = ph_t[pidx_t.clamp(min=0).long()]
    cj = js.coords_to_trilinear_coeffs(
        jnp.asarray(coords[:, 0]), jnp.asarray(vox.numpy()), level)
    ct = ts.coords_to_trilinear_coeffs(torch.tensor(coords[:, 0]), vox, level)
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    feats = rng.random((phd_t.shape[0], 3)).astype(dtype)
    ref = js.unbatched_interpolate_trilinear(
        jnp.asarray(coords), pidx_j, ph_j, trk_j, jnp.asarray(feats), level)
    f = torch.tensor(feats, requires_grad=True)
    out = ts.unbatched_interpolate_trilinear(torch.tensor(coords), pidx_t,
                                             ph_t, trk_t, f, level)
    np.testing.assert_allclose(np.asarray(ref), out.detach().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    g_ref = jax.grad(lambda x: jnp.sum(js.unbatched_interpolate_trilinear(
        jnp.asarray(coords), pidx_j, ph_j, trk_j, x, level) ** 2))(
            jnp.asarray(feats))
    g, = torch.autograd.grad(torch.sum(out ** 2), [f])
    np.testing.assert_allclose(np.asarray(g_ref), g.numpy(),
                               rtol=GRAD_TOL[dtype],
                               atol=GRAD_TOL[dtype] * float(g.abs().max()))
    with pytest.warns(DeprecationWarning):
        ts.coords_to_trilinear(torch.tensor(coords[:, 0]), vox, level)


@pytest.mark.parametrize('with_parents', [False, True])
def test_query(with_parents):
    level = 5
    oj, ot = _both_spc(level)
    _, _, ex_j = js.scan_octrees(oj, np.array([oj.shape[0]]))
    _, _, ex_t = ts.scan_octrees(ot, np.array([ot.shape[0]]))
    rng = np.random.default_rng(3)
    fq = np.concatenate([rng.uniform(-1.1, 1.1, (400, 3)),
                         _shell(level)[:400]]).astype(np.float32)
    iq = rng.integers(-2, 34, (400, 3)).astype(np.int32)
    for q in (fq, iq):
        _eq(js.unbatched_query(oj, ex_j, jnp.asarray(q), level,
                               with_parents=with_parents),
            ts.unbatched_query(ot, ex_t, torch.tensor(q), level,
                               with_parents=with_parents))


@pytest.mark.parametrize('level', [2, 4])
def test_dual_and_trinkets(level):
    oj, _ = _both_spc(level)
    _, pyr, ex_j = js.scan_octrees(oj, np.array([oj.shape[0]]))
    ph_j = js.generate_points(oj, pyr, ex_j)
    _, ph_t, _, _ = kt.utils.interop.spc_from_numpy(oj, ph_j, pyr[0], ex_j,
                                                    device='cpu')
    phd_j, pyrd_j = js.unbatched_make_dual(ph_j, pyr[0])
    phd_t, pyrd_t = ts.unbatched_make_dual(ph_t, pyr[0])
    _eq(phd_j, phd_t)
    _eq(pyrd_j, pyrd_t)
    for r, o in zip(js.unbatched_make_trinkets(ph_j, pyr[0], phd_j, pyrd_j),
                    ts.unbatched_make_trinkets(ph_t, pyr[0], phd_t,
                                               pyrd_t)):
        _eq(r, o)
        assert o.dtype == torch.int32


@pytest.mark.parametrize('use_mask', [False, True])
def test_feature_grids_to_spc_and_to_dense(use_mask):
    rng = np.random.default_rng(4)
    grids = rng.random((2, 3, 5, 7, 6)) * (rng.random((2, 1, 5, 7, 6)) > 0.6)
    masks = rng.random((2, 5, 7, 6)) > 0.5 if use_mask else None
    ref = js.feature_grids_to_spc(jnp.asarray(grids), masks)
    out = ts.feature_grids_to_spc(torch.tensor(grids), masks)
    for r, o in zip(ref, out):
        _eq(r, o)
    oj, lengths, fj = ref
    ot, _, ft = out
    _, pyr_j, ex_j = js.scan_octrees(oj, lengths)
    _, pyr_t, ex_t = ts.scan_octrees(ot, lengths)
    ph_j = js.generate_points(oj, pyr_j, ex_j)
    ph_t = ts.generate_points(ot, pyr_t, ex_t)
    dense_j = js.to_dense(ph_j, pyr_j, fj)
    f = ft.clone().requires_grad_(True)
    dense_t = ts.to_dense(ph_t, pyr_t, f)
    _eq(dense_j, dense_t.detach())
    w = rng.random(dense_t.shape)
    g_ref = jax.grad(lambda x: jnp.sum(js.to_dense(ph_j, pyr_j, x)
                                       * w))(fj)
    g, = torch.autograd.grad(torch.sum(dense_t * torch.tensor(w)), [f])
    _eq(g_ref, g)


def test_spc_container():
    oj, ot = _both_spc(4)
    sj = kal.rep.Spc(oj, [oj.shape[0]])
    st = kt.rep.Spc(ot, [ot.shape[0]])
    assert sj.max_level == st.max_level == 4 and st.batch_size == 1
    _eq(sj.pyramids, st.pyramids)
    _eq(sj.exsum, st.exsum)
    _eq(sj.point_hierarchies, st.point_hierarchies)
    _eq(sj.num_points(3), st.num_points(3))
    dj = kal.rep.Spc.make_dense(2)
    dt = kt.rep.Spc.make_dense(2, device='cpu')
    _eq(dj.octrees, dt.octrees)
    _eq(dj.point_hierarchies, dt.point_hierarchies)
    both = kt.rep.Spc.from_list([ot, ot])
    _eq(kal.rep.Spc.from_list([oj, oj]).point_hierarchies,
        both.point_hierarchies)
    grids = np.random.default_rng(5).random((1, 2, 4, 4, 4))
    fj = kal.rep.Spc.from_features(jnp.asarray(grids))
    ft = kt.rep.Spc.from_features(torch.tensor(grids))
    _eq(fj.features, ft.features)
    feats = np.random.default_rng(6).random((int(st.pyramids[0, 0, 4]), 2))
    _eq(sj.to_dense(jnp.asarray(feats)), st.to_dense(torch.tensor(feats)))


def test_sphere_shell_spc_matches_bench_suite_build():
    """``sphere_shell_spc`` builds config 5's octree as
    ``bench_suite.py`` does, at a smaller size."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(5000, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    q = js.quantize_points(jnp.asarray(dirs * 0.7, jnp.float32), 6)
    oj = js.unbatched_points_to_octree(q, 6)
    _, pyr, ex = js.scan_octrees(oj, np.array([len(np.asarray(oj))]))
    ph = js.generate_points(oj, pyr, ex)
    ot, ph_t, pyr_t, ex_t = kt.utils.interop.sphere_shell_spc(
        level=6, n=5000, device='cpu')
    _eq(oj, ot)
    _eq(ph, ph_t)
    _eq(pyr[0], pyr_t)
    _eq(ex, ex_t)
